"""``device_ms_per_token``: a profiler started in set-up, the window's
opening and close marked on the device, and the union of every device
operation between the marks; and the per-layer readers of the wall-clock
numbers that it stands in for end to end."""
import time
import types

import numpy as np
import pytest
import torch

import bench_tiny as T
from benchlib import cell, serve, stats, trace
from benchlib.serve import Rec, Window
from benchlib.traffic import Planned, Traffic


class _Event:
    def __init__(self, device, start, end, name="k"):
        self._d, self._s, self._e, self._n = device, start, end, name

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def test_busy_is_the_union_of_the_device_operations_between_the_marks():
    from torch.autograd import DeviceType
    cuda, spin = DeviceType.CUDA, "void spin_kernel(long)"
    dt = trace.DeviceTrace(torch.device("cpu"))

    def trace_of(events):
        dt.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: events)))
    before = [_Event(cuda, -50, -10), _Event(cuda, -5, 3)]
    window = [_Event(cuda, 0, 2, spin), _Event(cuda, 2, 10),
              _Event(DeviceType.CPU, 0, 900), _Event(cuda, 5, 20),
              _Event(cuda, 30, 40), _Event(cuda, 95, 120),
              _Event(cuda, 100, 101, spin)]
    trace_of(before + window + [_Event(cuda, 130, 150)])
    # [0, 20) and [30, 40) and [95, 100): the set-up's and the drain's
    # operations and the marks themselves are left out.
    assert dt.busy_s() == pytest.approx(35e-9)
    assert dt.prof is None
    trace_of(window[1:])
    with pytest.raises(RuntimeError):
        dt.busy_s()


class _Clocked:
    """A window trace that notes when it was started and marked."""

    def __init__(self):
        self.calls = []

    def start(self):
        self.calls.append(("start", time.perf_counter()))

    def mark(self):
        self.calls.append(("mark", time.perf_counter()))


@pytest.mark.parametrize("mix", [T.CLOSED, T.OPEN], ids=["closed", "open"])
def test_the_window_trace_marks_the_window(mix):
    wt = _Clocked()
    eng = serve.build_engine(T.QWEN, mix, 2**31 + 3, torch.device("cpu"))
    drv = serve.Driver(eng, Traffic(mix, 2**31 + 3, T.QWEN["vocab_size"]),
                       window_trace=wt)
    win = drv.run_closed(0.5) if mix["loop"] == "closed" \
        else drv.run_open(0.8, 5.0)
    assert [c for c, _ in wt.calls] == ["start", "mark", "mark"]
    (_, t_start), (_, t_first), (_, t_last) = wt.calls
    assert t_start <= t_first <= win.t_open and win.t_end <= t_last
    assert stats.tokens_in(list(drv.recs.values()), win.t_open,
                           win.t_end) > 0


def _rec(due, times):
    p = Planned(index=0, prompt=np.zeros(4, np.int32), max_new=len(times),
                tier="8/8")
    return Rec(p, due, due, list(times), [1] * len(times))


def test_wall_clock_readers_read_the_window_as_end_to_end_did():
    win = Window(100.0, 110.0, 130.0, {}, {})
    recs = [_rec(100.0 + i, [100.5 + i, 101.0 + i + 0.1 * i])
            for i in range(10)] + [_rec(90.0, [95.0, 105.0, 111.0])]
    ctx = cell.Context({}, {}, recs, win, None, 10.0)
    got = cell.load_reader("tokens_per_s.reason")(ctx)
    assert got == pytest.approx(stats.rate(recs, win))
    tails, _, _ = stats.open_loop(recs, win, 10.0)
    assert cell.load_reader("tpot_p75_ms.rag")(ctx) == \
        pytest.approx(tails["tpot_p75_ms"])


@pytest.mark.parametrize("base", ["decode_step_ms", "decode_mfu",
                                  "device_ops_per_step", "k4_roofline",
                                  "device_idle_share", "decode_host_ms",
                                  "idle_in_blocks_share"])
def test_reason_entries_read_as_their_base(base):
    """Each ``<metric>.reason`` reader is its base metric's reader."""
    import json
    spec = json.loads((T.ROOT / "BENCHMARK.json").read_text())
    names = {m["name"]: m for m in spec["per_layer"]}
    assert names[base + ".reason"]["moves"] == cell.DEVICE_METRIC
    ctx = cell.Context({}, {}, [], None, None, 45.0)
    mine = cell.load_reader(base + ".reason")
    code, want = mine.__code__, cell.load_reader(base).__code__
    assert (code.co_filename, code.co_firstlineno) == \
        (want.co_filename, want.co_firstlineno)
    if base in ("device_ops_per_step", "k4_roofline", "device_idle_share",
                "decode_host_ms", "idle_in_blocks_share"):
        assert mine(ctx) is None        # nothing traced, nothing read
