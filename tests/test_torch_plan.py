"""The launch plan of the plane GEMMs (``bitserial_matmul.plan``, for the
shift GEMMs and the grouped ones alike): pure Python, held here on the CPU.
The CUDA kernel (``csrc/plane_mma.cuh``) takes the plan as given, so these
are the checks that its K slices cover K exactly, that narrow GEMMs are
split to fill the card, that every launch fits the shared memory of one
H100 block, and that a split names the workspace and counters its slices
are summed through (the kernel refuses a request that differs from its
own layout's)."""
import math

import pytest
import torch

from repro_torch.kernels import bitserial_matmul as bsm

# K x N of full-width qwen3-8b's projections: q/o (4096 x 4096), k/v
# (4096 x 1024), gate/up (4096 x 12288), lm_head (4096 x 152064), down
# (12288 x 4096).  The same five shapes as chip_smoke.GEMM_SHAPES.
SERVING_KN = ((4096, 4096), (4096, 1024), (4096, 12288), (4096, 152064),
              (12288, 4096))
SERVING_M = (1, 4, 8, 16, 40, 64)    # decode batches and prefill buckets
LAYOUTS = [(p, False) for p in (1, 2, 4)] + [(4, True)]


def _slices(pl: bsm.Plan, k: int):
    return [(z * pl.kslice, min(k, (z + 1) * pl.kslice))
            for z in range(pl.splits)]


@pytest.mark.parametrize("p,packed", LAYOUTS)
@pytest.mark.parametrize("k", [32, 96, 4096, 4100, 12288, 12289])
@pytest.mark.parametrize("m,n", [(8, 1024), (17, 152064)])
def test_k_slices_cover_k_once_in_whole_stages(m, k, n, p, packed):
    pl = bsm.plan(m, k, n, p, packed)
    assert pl.bk in (32, 64, 128) and pl.kslice % pl.bk == 0
    sl = _slices(pl, k)
    assert sl[0][0] == 0 and sl[-1][1] == k
    for (a, b), (c, _) in zip(sl, sl[1:]):
        assert b == c                      # contiguous, no overlap
    assert all(b > a for a, b in sl)      # no empty slice
    # Every slice but the last is a whole number of stages; the last holds
    # the ragged end.
    assert all((b - a) % pl.bk == 0 for a, b in sl[:-1])
    assert pl.grid[2] == pl.splits == math.ceil(k / pl.kslice)


@pytest.mark.parametrize("p,packed", LAYOUTS)
@pytest.mark.parametrize("k,n", SERVING_KN)
@pytest.mark.parametrize("m", SERVING_M)
def test_grid_reaches_the_wave_target(m, k, n, p, packed):
    """Every serving shape fills the SMs, and a split never asks for more
    blocks than one wave of resident blocks holds."""
    pl = bsm.plan(m, k, n, p, packed)
    slots = bsm.BLOCKS_PER_SM * bsm.H100_SMS
    tiles = pl.grid[0] * pl.grid[1]
    assert pl.grid[0] == math.ceil(n / bsm.BN)
    assert pl.bm >= m and pl.grid[1] == 1     # one row tile up to 64 rows
    assert tiles * pl.splits >= bsm.H100_SMS
    if tiles >= slots:
        assert pl.splits == 1                 # wide N: no split, no scratch
    else:                                     # narrow N or deep K: split-K
        assert tiles * pl.splits <= slots
        assert pl.kslice // pl.bk >= bsm.MIN_SLICE_STAGES


@pytest.mark.parametrize("m,k,n,p,packed", [
    (8, 4096, 1024, 4, False), (64, 4096, 4096, 4, True),
    (64, 12288, 4096, 2, False), (16, 4096, 12288, 1, False),
    (1, 4100, 1000, 3, False), (40, 256, 1024, 4, True),
    (8, 64, 64, 1, False), (64, 12289, 8192, 4, False)])
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_split_fills_one_wave_in_equal_slices(m, k, n, p, packed, sms):
    """Split-K where the output tiles are fewer than the resident blocks
    (BLOCKS_PER_SM per SM): slices of ceil(stages / (slots // tiles))
    stages, at least MIN_SLICE_STAGES, so the grid is at most one wave;
    every slice but the last has the same length, the last no more."""
    pl = bsm.plan(m, k, n, p, packed, sms)
    slots = bsm.BLOCKS_PER_SM * sms
    tiles = pl.grid[0] * pl.grid[1]
    stages = math.ceil(k / pl.bk)
    per = pl.kslice // pl.bk
    if tiles >= slots:
        assert pl.splits == 1 and per == stages
        return
    assert per == max(bsm.MIN_SLICE_STAGES,
                      math.ceil(stages / (slots // tiles)))
    assert pl.splits <= slots // tiles
    assert 0 < stages - per * (pl.splits - 1) <= per   # the last slice


@pytest.mark.parametrize("p,packed", LAYOUTS + [(3, False), (1, True)])
@pytest.mark.parametrize("m", [1, 17, 33, 200])
@pytest.mark.parametrize("k,n", [(4096, 1024), (12288, 4096)])
def test_shared_memory_fits_one_block(m, k, n, p, packed):
    """The plan's request, which the kernel takes only if it equals its own
    layout's (tests/test_torch_gpu.py holds that on the card)."""
    pl = bsm.plan(m, k, n, p, packed)
    w_tiles = 1 if packed else p
    want = bsm.STAGES * (w_tiles * pl.bk * bsm.BN + pl.bm * (pl.bk + bsm.X_PAD))
    assert pl.smem == want <= bsm.MAX_SMEM
    # Two blocks share an SM (the wave target counts on it): 1 KB of each
    # block's 228 KB is reserved by the hardware.
    assert bsm.BLOCKS_PER_SM * (pl.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("m", [65, 128, 200, 1000])
def test_rows_beyond_64_are_tiled(m):
    pl = bsm.plan(m, 4096, 4096, 4)
    assert pl.bm == 64 and pl.grid[1] == math.ceil(m / 64)


@pytest.mark.parametrize("m,bm", [(1, 16), (16, 16), (17, 32), (32, 32),
                                  (33, 64), (64, 64)])
def test_row_tile_is_the_smallest_that_holds_m(m, bm):
    assert bsm.plan(m, 4096, 4096, 2).bm == bm


def test_plan_refuses_what_the_kernel_does_not_take():
    for bad in ((4, 64, 64, 0), (4, 64, 64, 5), (-1, 64, 64, 1)):
        with pytest.raises(ValueError, match="plan"):
            bsm.plan(*bad)
    pl = bsm.plan(4, 0, 64, 1)               # K = 0: one empty slice
    assert pl.splits == 1 and pl.kslice > 0


def test_alignment_flags():
    x = torch.zeros((4, 64), dtype=torch.int8)
    assert bsm._vec_ok(x, 64, 16) == int(x.data_ptr() % 16 == 0)
    assert bsm._vec_ok(x, 100, 16) == 0 and bsm._vec_ok(x, 100, 4) == \
        int(x.data_ptr() % 4 == 0)
    assert bsm._vec_ok(x.view(-1)[1:], 64, 16) == 0


# The grouped GEMMs' decode batches (max_batch 8, and the kernel-level API's
# larger row counts) at every plane count of the MSB-first prefix.
GROUPED_M = tuple(range(1, 9)) + (16, 17, 40, 64)
GROUPED_LAYOUTS = [(p, packed) for p in (1, 2, 3, 4) for packed in
                   (False, True)]


@pytest.mark.parametrize("p,packed", GROUPED_LAYOUTS)
@pytest.mark.parametrize("k,n", SERVING_KN)
@pytest.mark.parametrize("m", GROUPED_M)
def test_grouped_decode_plans(m, k, n, p, packed):
    """At the grouped GEMMs' decode shapes the plan covers K once in whole
    stages, fits two blocks per SM, and a split names exactly its scratch:
    one ``bm`` x ``BN`` int32 tile per output tile and K slice
    (plane_mma::workspace_ints) and one counter per output tile; an
    unsplit launch needs none."""
    pl = bsm.plan(m, k, n, p, packed)
    sl = _slices(pl, k)
    assert sl[0][0] == 0 and sl[-1][1] == k
    assert all(b == c for (_, b), (c, _) in zip(sl, sl[1:]))
    assert all((b - a) % pl.bk == 0 for a, b in sl[:-1])
    assert all(b > a for a, b in sl)
    w_tiles = 1 if packed else p
    assert pl.smem == bsm.STAGES * (w_tiles * pl.bk * bsm.BN +
                                    pl.bm * (pl.bk + bsm.X_PAD))
    assert bsm.BLOCKS_PER_SM * (pl.smem + 1024) <= 228 * 1024
    tiles = pl.grid[0] * pl.grid[1]
    if pl.splits > 1:
        assert pl.counters == tiles
        assert pl.workspace == pl.splits * tiles * pl.bm * bsm.BN
        # Every output row and column has its place in a slice's tile.
        assert pl.grid[1] * pl.bm >= m and pl.grid[0] * bsm.BN >= n
    else:
        assert pl.counters == pl.workspace == 0
    # The scratch stays small: a split never exceeds one wave of blocks.
    assert pl.workspace * 4 <= bsm.BLOCKS_PER_SM * bsm.H100_SMS * 64 * \
        bsm.BN * 4
