#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py              # every phase, on one CUDA card

Phases, in order (any failure exits non-zero and prints no result line):

1. build    nvcc builds the six kernels from ``src/repro_torch/kernels/csrc``
            into ``build/kernels/``; prints the build seconds and the card,
            and for every instantiation of the tensor-core core
            ``plane_mma.cuh`` (kernels 3 and 5, and kernels 4 and 6 in
            both layouts) its IMMA and LDGSTS/UTMALDG counts in
            ``cuobjdump -sass`` and ptxas' spill bytes; fails if one has no
            IMMA or no asynchronous copy.  For the register-resident
            instantiations of kernels 1 and 2, their 16-byte loads and
            local-memory accesses; fails unless each thread reads its part
            of the row with one 16-byte load per vector and no local memory.
2. parity   each kernel against its plain PyTorch version, bit-equal,
            tolerance 0.  Kernels 1 and 2: bf16 and f32 input, without and
            with a row gather (a shuffle with a repeated row), M in {1, 5,
            8, 64}, K in {96, 1024, 2048, 4096, 4100, 5120, 8192,
            12288}, widths 2-8 signed and 8 unsigned (kernel 1) and per-row
            qmax 127/7/1 (kernel 2), with zero rows and rows on .5
            boundaries after the divide, two views (rows apart, a
            misaligned base), and phase 4i's f32 K-shards (M 64, K 2048 and
            1024, rows 4096 apart).  The GEMMs at the
            serving shapes (M in {8, 64}; K=4096 -> N in {4096, 1024,
            12288, 152064}; K=12288 -> N=4096; phase 4e's
            ``ARCH_GEMM_SHAPES``) and one ragged shape (M=5,
            K=4100, N=1000).  Kernels 3 and 5 also run M in
            {16, 17, 40} at the serving shapes (prefill buckets, a ragged
            row tile), on fixed-width LSB-first planes of every width 2-8
            (3-bit signed MSB planes at 3, 5, 7) at M = 512 (K x N 4096 x
            12288) and 8 (4096 x 1024), and with kernel 1 (every width, bf16 and f32, K in
            {4096, 12288}) at M in {65, 192, 512}, the rows of a
            ``BatchServeEngine`` prefill (up to 8 prompts of 64): more than
            one 64-row tile.  The packed GEMM runs every stored width
            2/4/6/8 at every even effective width, signed and unsigned; the
            grouped GEMMs run both layouts (the packed one signed and
            unsigned) with three tier groups, and at M in {1, 3, 8, 16, 17,
            40} every tier mix of ``_grouped_layouts`` (one-tier batches of
            Pmax 1-4, two-tier batches of Pmax 2 and 3).  The verify
            layouts of a speculative round (8 slots, k = 4: M = 40 in
            groups of n*(k+1) rows, as ``ServeEngine._group_layout`` makes
            them) run kernel 2 on bf16 rows with the flat row ``perm`` and
            kernels 4 and 6 in both layouts at every serving shape, the LM
            head included.  This phase's launches are the only ones of
            ``grouped_matmul``, which no serving path runs.
3. mixed    serves full-width qwen3-8b (seeded random weights made on the
            card layer by layer, each layer's float weights freed once its
            superplane store is prepared) with tiers 8/8 4/4 2/2 through the
            ``cuda`` backend; counts every kernel launch of that run, then
            replays the same requests through the plain ``decomposed``
            backend on the same store, which must launch no GEMM kernel
            (decode attention, one launch a layer and decode step, runs on
            every backend on the card; its count over the run is
            checked), and requires identical token streams.  In between,
            the same requests are served again with one decode chunk of
            mixed tiers traced by ``torch.profiler`` (CUDA activity): the device-busy
            share of the chunk's wall time, the device operations per step
            and the five that took the most time; the next chunk under
            ``cProfile``, with the calls of ``Tensor.index_select`` and
            ``Tensor.to`` per step.
4. packed   the same weights (same seed) and requests through
            ``ServeEngine(packed=True)``, which prepares the byte-packed
            superplane store itself (one uint8 per weight); its streams must
            equal phase 3's, with the packed GEMM in prefill and the packed
            mode of the grouped GEMM in decode, and no int8-plane GEMM.
            Then the int8 planes of the same codes and the packed store
            serve the requests in turns (planes, packed, packed, planes),
            each with equal streams, for a same-card step-time comparison.
4b. spec    self-speculative decoding and seeded sampling on the phase-3
            model (full-width qwen3-8b, 36 layers, seed 0, int8 planes,
            max_batch 8, the same 9 requests).  (a) greedy: requests with
            uid % 3 != 2 speculate (draft tier 2/2, k = 4), the rest decode
            plainly in the same batches; the streams must equal phase 3's,
            no weight is prepared again, and kernels 1-4 launch.  (b)
            sampled (temperature 0.8, top-k 40, seed = uid), without and
            with speculation.  Prints the spec stats, the acceptance rate,
            decode tokens/s beside phase 3's, the launches of kernels 2
            and 4 per speculative round (draft and verify), and the device
            operations of the plain torch sampling and acceptance code
            (``torch.profiler``).  Then, at 4
            layers of the same width: each of those three runs again on
            ``cuda`` and on the plain ``decomposed`` backend (which must
            launch no GEMM kernel) with equal streams, the sampled run
            without speculation at max_batch 3 with equal streams, and the
            verify window position by position against sequential decode steps,
            logits and arena bit-equal, for both stores.
4c. tiers   per-request KV precision on the phase-3 model (full-width
            qwen3-8b, 36 layers, seed 0, int8 planes, max_batch 8, the
            same 9 requests), schedule 8/8 4/4 2/2 with ``kv_tiers`` {8/8:
            bf16, 4/4: 8, 2/2: 4}: ONE mixed byte-lane KV arena.  (a) The
            mixed run's streams must equal the union of one
            ``BatchServeEngine(tier=t)`` run per tier on the same store,
            each at its tier's KV precision; (b) ``mixed_tiers=False`` must
            give them too, with no mixed chunk and a tier switch; no weight
            is prepared again; the serialized run and every batch run
            (one-tier batches) launch kernels 1 and 3 and no other.  Prints decode tokens/s and mean step ms
            beside phase 3's, the arena bytes beside phase 3's bf16 arena,
            each kernel's launches and one traced decode chunk (device
            operations per step, busy share).  Then at 4 layers of the same
            width: (c) uid 0 (8/8, bf16 KV) moves to 2/2 (int4) and uid 1
            (4/4, int8) to 8/8 after 4 tokens; the arena must equal
            ``migrate_kv_tier`` applied on the card to a copy taken before,
            a fresh engine continuing from that copy must give the same
            streams, and the migrations' ms (CUDA events) are printed; (a)
            to (c) replayed on the plain ``decomposed`` backend launch
            nothing and give equal streams.
4d. overload preemption, spill and resume on the phase-4c model and
            schedule (full-width qwen3-8b, 36 layers, seed 0, int8 planes,
            the mixed KV arena, max_batch 8, the same 9 requests).  (a)
            After the first round uid 0 moves to 2/2 (its bf16 lanes
            requantized to int4), then uids 0, 1 (int8; written to a
            temporary spill dir), 2 (int4) and 3 (bf16) are preempted and
            resume in other slots.  The streams must equal a run with the
            same migration and no preemption (which must take no telemetry
            hook and make no device sync) and, but uid 0's, phase 4c's;
            every prefill launches kernels 1 and 3 only (145 and 253), every
            resume nothing; the spill dir ends empty.  Prints the snapshot
            bytes and the ms of each preemption (the host copy), resume,
            and the spill's write and read.  (c) The same with
            ``Telemetry(profile=True)``: equal streams; prints the
            profiler's decode-chunk wall and device seconds and
            ``decode_dispatch_count`` of every layout, which must be 434;
            writes the Prometheus text and the Chrome trace to the
            git-ignored ``build/overload/``.  (b) ``SLOPolicy(preempt, shed,
            tenant_weights={"a": 2.0}, time_slice=2)`` on the shape of the
            reference command line's overload stream (12 requests, two
            tenants), on (d)'s 4-layer int8-plane model (the policy prices
            tiers relative to each other, alike at any depth): every
            FINISHED stream equals an uninterrupted run's, with sheds and
            time-slice preemptions; prints the counters.
            (d) At 4 layers, for both stores: (a) and (c) on ``cuda`` and on
            the plain ``decomposed`` backend, which must launch no GEMM
            kernel, with equal streams.
4e. archs   the SSM, hybrid and MoE layers, seeded torch weights, tiers
            8/8 4/4 2/2, max_batch 8, 9 requests of 16 tokens (prompts of
            16-64).  (a) mamba2-1.3b at full width and depth (48 layers):
            the int8-plane store (its quantized-weight count must equal the
            shapes' 1,342,701,568), greedy speculation (uid % 3 != 2, draft
            2/2, k = 4) and one preemption of an SSM slot mid-decode
            (resumed prefill-free in another slot, launching nothing) must
            reproduce its streams, and so must the packed store of the same
            seed; ``decode_dispatch_count`` must equal the count derived
            from the code (194).  (b) llama4-scout at full width, its depth
            cut to 4 of 48 layers (``reduced: num_layers 48→4``: the store
            of all 48 would not fit one card): int8 planes, then the packed
            store, with equal streams and 366 launches per decode step.
            (c) Against the plain ``decomposed`` replay (equal streams, no
            launch): the reduced jamba (attention, Mamba, MLP and MoE
            layers), plain and speculative (speculative == plain), with a
            spilled hybrid snapshot restored; llama4 at one layer of full
            width.  Prints the store bytes, peak memory, step ms, tokens/s,
            launches, snapshot bytes and dispatch counts.
4f. autoprec the paper's hardware model and the precision search.  (a)
            The simulators on the card: ``pe_array_matmul`` (the 64x64
            array, bit-serial through the split-path CSA tree),
            ``bitserial_mac`` (Eq. (1)) and kernel 3 on the LSB-first
            planes of ``decompose_weights`` must equal the exact int64
            product at B=8, R=4096, C=1024 for (w, a) in {(8, 8), (6, 8),
            (4, 4), (2, 2)}, signed and unsigned; prints the simulator's
            ``PEArrayStats`` and ``peak_tops``, the modeled 28 nm array's
            (not a speed of the card).  Kernels 1, 3 and 4 against their
            plain versions at the path's shapes (M = 288 and 160 in groups
            of 32, M = 32).  (b) The command line
            ``repro_torch.launch.autoprec.main`` on full-width qwen3-8b
            (36 layers, 8 names x widths 2, 4, 6, calibration 2 x 2 x 16
            from seed 1, one-pass blocks of 8, ``--eval-top 6``,
            ``--device cuda``): its profile is 6 forwards of 288 rows, each
            145 launches of kernel 1 and 253 of kernel 4 (every probe runs
            8-bit activations: one quantization config, so kernel 1, not
            kernel 2); kernels 2 and 3 must not launch.  Prints the
            seconds, launches and peak memory of its profile, search and
            joint measurement (of up to six points spread over the front,
            blocks of 4: 160 rows).  Its relaxation on the card must equal
            the CPU's; the file it writes to the git-ignored
            ``build/autoprec/`` must load to its schedule (the weights are
            random, so only the mechanics are checked).  (c) On a store of
            the same seed, batched must equal sequential (kernels 1 and 3
            only) bit for bit on q_proj, down_proj and the head at widths 2
            and 4.  (f) The command line's schedule (tiers auto and base)
            serves phase 3's nine requests from memory and from the loaded
            file on that store, with no preparation: equal streams; then
            ``repro_torch.launch.serve.main --schedule-file`` serves the
            file and its streams must equal that store's run of the same
            requests.  At 4 layers, (d) the ``cuda`` profile and joint
            divergences must equal the plain ``decomposed`` ones bit for
            bit, and (f) the served streams the plain replay's.
4g. train   QAT training through the port's command line
            ``repro_torch.launch.train.main``.  (a) The reference's own
            flags at qwen3-8b's full width (d 4096, d_ff 12288, vocab
            151936), depth cut 36 -> 4 (``--layers 4``: f32 AdamW moments
            of 36 layers would not fit one card), seq 256, batch 8, w4a8
            fake_quant, 30 steps on the card, ``--lr 3e-4`` (the default
            scaled to the width; see ``TRAIN_FULL_ARGV``): prints every step's ms
            (the median after the first), tokens/s, peak memory, the
            first and last five losses, the grad norm and the share of the
            dense bf16 bound 6 * N * tokens at the data-sheet peak; the
            mean loss of the last 5 steps must be below the first 5's.
            (b) ``examples/train_qat.py``'s "full" preset (d 640, 16
            layers, vocab 32768, seq 256, batch 16, ``--accum 4``), 16
            steps with ``--ckpt-every 8`` under ``build/train/``; then
            ``step_16`` removed and the same flags again: the run
            auto-resumes at step 8, and its params, moments and step must
            equal the uninterrupted run's bit for bit.  (c) The reduced
            qwen3-8b (AdamW) and the default ConvNet (SGD, unsigned
            activations) take 4 steps on the card and on the CPU from one
            initialisation: losses and weights within the tolerances
            stated at ``TRAIN_LOSS_ATOL``.  (d) (a)'s trained weights
            prepared into the superplane store serve phase 3's nine
            requests at tiers 8/8 4/4 2/2 (kernels 1-4) with streams equal
            to the plain ``decomposed`` replay on the same store; their
            launches are the kernel line's ``train`` counts.
4h. tp      tensor-parallel serving over torch.distributed, every rank a
            process started by ``launch.mesh.spawn_ranks``; ranks share
            this one card, so the group is gloo and every gather stages
            through host memory (step times time loopback, not NVLink).
            (c) First, in this process: the attention core on each
            rank's heads (2 and 4 ranks, KV heads sharded and the MQA
            head replicated; decode against bf16, int8 and mixed arenas,
            prefill at every prompt bucket of phase 3 and at 2048 tokens)
            must equal the same heads of the whole call bit for bit (a
            rank's decode runs the kernel on its heads alone, its prefill
            at the whole head count, its heads among zero heads); prints
            decode attention's ms unsharded and for one of 2 ranks.  (a)
            full-width, full-depth qwen3-8b on 2 ranks, int8 planes, tiers 8/8 4/4 2/2: each rank
            builds the full store in turn and keeps its shard before the
            next builds; phase 3's nine requests give phase 3's streams on
            every rank, kernels 1-4 launch (their counts per rank are the
            kernel line's ``tp``), ``decode_dispatch_count`` equals the
            unsharded graph's (434) at a three-tier and a one-tier layout,
            and one decode step's code and output bytes on the wire equal
            ``decode_wire_stats``; prints each rank's store bytes, build
            and serving peaks, launches and decode-step ms.  (b) 4 ranks at
            2 layers, both stores, kv_tiers {8/8: bf16, 4/4: 8, 2/2: 4}:
            uid 0 migrated to 2/2, then uids 1 (spilled) and 2 preempted
            and resumed prefill-free (no launch), a sampled run
            (temperature 0.8, top-k 40) and a ``Telemetry(profile=True)``
            run (rank 0 records) each equal the unsharded engine's run on
            the same weights.  A rank's failure fails the phase.
4i. dist    the distributed training blocks over torch.distributed: 4
            ranks from ``launch.mesh.spawn_ranks`` share this card over
            gloo (every collective stages through host memory), on the
            training meshes of ``launch.mesh.make_mesh``.  (a)
            ``tp_matmul.tp_mlp_block`` at qwen3-8b's MLP widths (d 4096, f
            12288, seeded bf16 weights, 64 rows of f32 x) on a (4,)
            "model" mesh and on the 2-rank "model" lines of a (2, 2) mesh:
            the wire's codes and scales (kernel 1 on each K-shard, K 1024
            and 2048) must equal the plain quantizer's bit for bit, y must
            be within the reference test's 5 % of the f32 MLP and within
            ``DIST_TP_CPU_ULPS`` bf16 ulps of the same call on the CPU, and
            the bytes gathered and reduced per token must equal
            ``collective_bytes_per_token``.  (c) ``pipeline.run_pipeline``
            over a (4,) "stage" mesh, each stage one full-width qwen3-8b
            decoder layer from the w8a8 superplane store (kernels 1 and
            3), 6 microbatches of [2, 128, 4096] bf16: equal bit for bit
            to rank 0's sequential run of the same layers one microbatch at
            a time; the launches of (a) and (c) on all ranks are the kernel
            line's ``dist`` counts (kernels 1 and 3 only).  (b)
            compressed data-parallel gradients on the 2-rank "dp" line of a
            (2, 2) mesh: full-width qwen3-8b cut to one layer, each rank's
            half-batch gradient (``train.step.value_and_grad``, SyntheticLM,
            w4a8 ``fake_quant``; the ranks take turns), then
            ``compressed_psum_tree`` at bits 8 and 2, 2 rounds each with
            error feedback: the means and residuals of one projection and
            one norm equal the same calls on the CPU bit for bit every
            round, the embedding's in each width's first round (a host
            replay of its 0.62 G entries takes 10-18 s a round), the first
            8-bit mean is within 5 % of the f32 mean; prints the bytes
            handed to the all-reduces.  (d) the
            params and AdamW state of phase 4g's model (full width, 4
            layers) under the (2, 2) ("data", "model") training rules:
            each rank builds the whole in turn and keeps its blocks
            (``shard_tree``), holding exactly the rules' reckoning
            (``block_bytes``); ``gather_tree`` of every leaf's blocks,
            gathered to rank 0, equals the whole bit for bit.  Prints the
            per-device parameter bytes of the full qwen3-8b, llama4-scout
            and grok-1 trees on both production meshes, reckoned from
            shapes (meta tensors), not measured.
4j. dryrun  the dry-run and roofline tools (``launch.dryrun``,
            ``launch.roofline``), on meta tensors in this process: (a) two
            production cells, qwen3-8b decode_32k on 16 x 16 and
            mamba2-1.3b long_500k on 2 x 16 x 16 with --kv-bits 8, and
            their roofline table at the H100's data-sheet peaks (a
            reckoning, not a measurement); (b) phase 4g's train shape
            (full-width qwen3-8b cut to 4 layers, seq 256 x batch 8, w4a8
            ``fake_quant``, f32 moments) on a 1 x 1 mesh: the meta flop
            count must equal ``FlopCounterMode`` over one real step on
            this card, and 4g's measured step ms is printed against the
            roofline's bound (flops at peak, the least bytes a step
            moves, collectives) as a share, beside the eager op trace's
            bytes (not a bound); the same equality for (c) one
            ``decomposed`` decode step of the reduced qwen3-8b (batch 8,
            cache 128) and (d) its prefill of 2 x 3072 tokens, three
            flash-attention K/V blocks.  Each card step is the meta
            cell's own, built on the card by ``dryrun.build_cell``.
            (c)'s card step launches decode attention once a layer, whose
            products ``FlopCounterMode`` cannot see: the plain version's
            (4 * B * H * Smax * Dh a layer, the count on meta) are added
            to the card's.  No other hand-written kernel (asserted).
4k. examples the five example scripts of the port
            (``examples/*_torch.py``).  (a) Each one's ``main`` on the card
            at its published size, as a user runs it, held against its
            replay on the plain ``decomposed`` backend on the card (which
            must launch no GEMM kernel): quickstart's int32 accumulators and
            outputs at w2/w3/w4/w6/w8 (kernels 1 and 3 on the fixed-width
            Table-I planes: w3 is one signed 3-bit plane, w6 three)
            bit-equal; serve_quantized (reduced qwen3-8b, w4a8, int8 KV,
            8 streamed requests) and long_context_ssm (reduced mamba2-1.3b,
            256 greedy steps at batch 2: kernel 3 at M = 2) with equal
            streams; precision_sweep (60 steps of w8a8 QAT, then six
            policies' serve-mode CE at M = 512 rows a projection) with its
            six CEs bit-equal; train_qat's ci preset (no kernel:
            ``fake_quant``) finishes, and with its last checkpoint removed
            resumes from step 30 to the same state bit for bit.  (b) The
            sweep's evaluation at qwen3-8b's full width (d_model 4096, the
            head 4096 x 152064), depth cut 36 -> 4 as in 4g, seeded
            weights with no QAT (the CEs are of an untrained model), seq 32
            x batch 16 (M = 512): each policy's CE equal to the plain
            replay's bit for bit, its seconds and peak memory printed; and
            kernel 3 on the fixed-width planes of an MLP projection and the
            head at every width against its plain version.  The launches of
            (a)'s mains and (b)'s ``cuda`` evaluations are the kernel
            line's ``examples`` counts: kernels 1 and 3 (and decode
            attention, serve_quantized's decode steps).
5. fixed    the quickstart form, --w-bits 4 with the int8 KV cache and
            then the int4 one (--kv-bits 8, 4; LSB-first planes), at full
            width with the depth cut to 4 layers; for each, the ``cuda``
            engine's streams must equal the ``decomposed`` one's and the
            packed ``cuda`` engine's.
6. times    median CUDA-event time of each kernel at its serving shapes
            (kernels 2 and 4 also at the verify window, M = 40 in the
            three-tier verify layout; kernels 3 and 5 also at M in {65,
            192, 512}, P = 4 and 1),
            and at phase 4e's shapes (kernels 1 and 2 at K = 2048, 5120
            and 8192; the GEMMs at mamba2's in/out projections and llama4's
            expert projections, ``ARCH_GEMM_SHAPES``),
            with a cold L2 cache (as a decode step finds the weights) and
            the call enqueued before the card reaches it (a spin first),
            beside its bound on this card (the GEMMs' operations counted
            once per weight MAC, x times the weight the planes compose,
            whatever the plane count), its plain version's time and,
            where one PyTorch call computes the same function, that call's;
            and an empty kernel's time, the launch floor.  Phase 4f's
            shapes: kernel 4 at M = 288 (nine groups of 32, one probe
            group at 1, 2 or 3 planes; K x N 4096 x 12288 and the head)
            and M = 160, kernels 1 and 2 at M = 288, kernel 3 at M = 32.
            Phase 4i's wire quantizer: kernel 1 on f32 K-shards (K 2048
            and 1024) of 64 rows 4096 wide, and kernels 1 and 2 at
            K = 1024.  Phase 4k's sweep: kernel 3 on fixed-width planes
            (w2, w3, w4, w6, w8: P = 1, 1, 2, 3, 4) at M = 512, K x N =
            4096 x 12288 and the head (4096 x 152064), beside
            ``torch._int_mm`` on the recomposed weight.
7. attention the decode-attention kernel (kernel 7; it replaces no TPU
            kernel) at the benchmark's qwen3-8b arenas: reason-decode's
            (64 slots of 2048) and rag-prefill's (32 of 3328), 32 query
            heads of 128 over 8 KV heads, slot lengths drawn as the mixes
            in ``bench/traffic/`` draw them.  Against its plain version
            (``KVCache.read`` + ``layers._decode_core``) within the
            tolerance its sums' order sets, every storage mode at
            reason's arena; then timed on the bf16 arena (the cells') with
            a cold L2, beside its byte bound (each slot's K and V up to its
            length read once), the plain version's ms and
            ``scaled_dot_product_attention``'s (the library yardstick; the
            port never calls it).  Prints phase 3's decode-attention
            launches against its decode steps (one a layer and step).

The script takes no arguments.  The last line of standard output is
``{"ok": true, "device": {...}}``; the one before it the card's name and
power limit, and the one before that the kernel summary.
"""
from __future__ import annotations

import gc
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
# name -> (source in the repo, TPU kernel it replaces)
KERNELS = {
    "act_quant": ("src/repro_torch/kernels/csrc/act_quant.cu",
                  "src/repro/kernels/act_quant.py:46"),
    "act_quant_rows": ("src/repro_torch/kernels/csrc/act_quant.cu",
                       "src/repro/kernels/act_quant.py:91"),
    "bitserial_matmul": ("src/repro_torch/kernels/csrc/bitserial_matmul.cu",
                         "src/repro/kernels/bitserial_matmul.py:84"),
    "grouped_dequant_matmul": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                               "src/repro/kernels/grouped_matmul.py:203"),
    "packed_bitserial_matmul": ("src/repro_torch/kernels/csrc/bitserial_matmul.cu",
                                "src/repro/kernels/bitserial_matmul.py:169"),
    "grouped_matmul": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                       "src/repro/kernels/grouped_matmul.py:164"),
}
# The phase whose run gives each kernel's launches in the summary line.
PATH_OF = {"act_quant": "mixed", "act_quant_rows": "mixed",
           "bitserial_matmul": "mixed", "grouped_dequant_matmul": "mixed",
           "packed_bitserial_matmul": "packed", "grouped_matmul": "parity"}
GEMM_SHAPES = ((4096, 4096), (4096, 1024), (4096, 12288), (4096, 152064),
               (12288, 4096))
# (K, N) of phase 4e's projections: mamba2-1.3b's in_proj and out_proj,
# a llama4-scout expert's gate/up and down.
ARCH_GEMM_SHAPES = ((2048, 8512), (4096, 2048), (5120, 8192), (8192, 5120))
# Rows of a BatchServeEngine prefill (rows x padded prompt): past one
# 64-row tile, up to 8 x 64.
PREFILL_ROWS = (65, 192, 512)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    import torch
    torch.cuda.synchronize()


# --------------------------------------------------------------- phase 1
def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    secs = time.perf_counter() - t0
    log(f"[build] kernels built in {secs:.1f}s -> {_build.build_info['path']}")
    for src, text in sorted(dict(_build.build_info.get("ptxas", {})).items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")
    _sass_report(_build)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not card:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[build] card: {card}")
    return {"build_seconds": secs, "card": card}


# The core's instantiations, plane_mma::plane_gemm_kernel<BM, BK, kPacked,
# kGrouped>: kernels 3 and 5, and kernels 4 and 6 (one kernel, with or
# without the dequant epilogue) on either layout.
CORE_SYMBOL = re.compile(
    r"plane_gemm_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])E")
CORE_KERNEL = {("0", "0"): "bitserial_matmul",
               ("1", "0"): "packed_bitserial_matmul",
               ("0", "1"): "grouped_(dequant_)matmul",
               ("1", "1"): "grouped_(dequant_)matmul packed"}


def _instance(sym) -> str:
    return (f"{CORE_KERNEL[(sym.group(3), sym.group(4))]}"
            f"<BM={sym.group(1)},BK={sym.group(2)}>")


def _sass_report(build) -> None:
    """Counts, in ``cuobjdump -sass`` of the built library, the int8
    tensor-core MMAs (IMMA) and asynchronous copies (LDGSTS = cp.async,
    UTMALDG = TMA) of every instantiation of the core (kernels 3-6), with
    ptxas' spill bytes; fails if a kernel has no instantiation, or one
    without IMMA or without an asynchronous copy."""
    tool = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", build.build_info["path"]],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr.strip()}")
    _act_quant_sass(res.stdout)
    ops = ("IMMA", "LDGSTS", "UTMALDG")
    counts: dict = {}
    current = None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            sym = CORE_SYMBOL.search(line)
            current = None if sym is None else _instance(sym)
            if current is not None:
                counts[current] = dict.fromkeys(ops, 0)
        elif current is not None:
            for op in re.findall(r"\b(IMMA|LDGSTS|UTMALDG)\b", line):
                counts[current][op] += 1
    # ptxas -v: "Function properties for <symbol>" then the spill line.
    spills: dict = {}
    for log_text in build.build_info.get("ptxas", {}).values():
        lines = log_text.splitlines()
        for i, line in enumerate(lines):
            sym = CORE_SYMBOL.search(line)
            if sym and "Function properties" in line and i + 1 < len(lines):
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", lines[i + 1])
                if spill:
                    spills[_instance(sym)] = int(spill.group(1)) + \
                        int(spill.group(2))
    for name in sorted(counts):
        spill = spills.get(name, "not available (library built earlier)")
        log(f"[build] sass {name}: " + ", ".join(
            f"{op} {counts[name][op]}" for op in ops) + f", spill bytes {spill}")
    for kernel in CORE_KERNEL.values():
        mine = {k: v for k, v in counts.items() if k.startswith(kernel + "<")}
        if not mine:
            raise AssertionError(f"{kernel}: no instantiation in the SASS")
        for name, c in mine.items():
            if c["IMMA"] == 0:
                raise AssertionError(f"{name}: no IMMA in its SASS")
            if c["LDGSTS"] + c["UTMALDG"] == 0:
                raise AssertionError(f"{name}: no asynchronous copy in its "
                                     "SASS")


# Kernels 1 and 2's register-resident instantiations,
# act_quant_vec_kernel<In, QT, K, kPer>: x's type, int8 (a) or uint8 (h),
# K, and the 16-byte loads a thread.
AQ_SYMBOL = re.compile(
    r"act_quant_vec_kernelI\w*?(Bf16|F32)E([ah])Li(\d+)ELi(\d+)E")


def _act_quant_sass(sass: str) -> None:
    """Counts, in each register-resident instantiation of kernels 1 and 2,
    the 16-byte global loads and the local-memory accesses; fails unless
    every x dtype, code type and serving K has one, and each reads its
    row with kPer 16-byte loads a thread and touches no local memory (the
    row stays in registers)."""
    counts: dict = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            sym = AQ_SYMBOL.search(line)
            current = None if sym is None else sym.groups()
            if current is not None:
                counts[current] = {"LDG.128": 0, "LDL/STL": 0}
        elif current is not None:
            counts[current]["LDG.128"] += len(re.findall(r"\bLDG\.E\.128",
                                                         line))
            counts[current]["LDL/STL"] += len(re.findall(r"\b(?:LDL|STL)\b",
                                                         line))
    if len(counts) != 8:
        raise AssertionError(f"act_quant.cu: {len(counts)} register-resident "
                             "instantiations in the SASS, expected 8 (bf16 "
                             "and f32, int8 and uint8, K 4096 and 12288)")
    for (dt, qt, k, per), c in sorted(counts.items()):
        log(f"[build] sass act_quant_vec<{dt}, {'int8' if qt == 'a' else 'uint8'}"
            f", K={k}, kPer={per}>: " + json.dumps(c))
        if c["LDG.128"] != int(per) or c["LDL/STL"]:
            raise AssertionError(f"act_quant_vec<{dt}, K={k}>: expected "
                                 f"{per} 16-byte loads and no local memory")


# --------------------------------------------------------------- phase 2
def _inputs(m: int, k: int, n: int, gen):
    import torch
    from repro_torch.core import decompose
    q8 = torch.randint(-128, 128, (k, n), dtype=torch.int8, device="cuda",
                       generator=gen)
    planes = decompose.decompose_superplanes(q8).contiguous()
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    return x, planes


def _fixed_planes(bits: int, k: int, n: int, gen):
    """LSB-first Table-I planes of random signed ``bits``-bit codes (a
    3-bit signed MSB plane at 3, 5 and 7 bits), as ``prepare_weight``
    stores a fixed-width weight."""
    import torch
    from repro_torch.core import decompose
    lo, hi = decompose.weight_range(bits, True)
    q = torch.randint(lo, hi + 1, (k, n), dtype=torch.int32, device="cuda",
                      generator=gen)
    return decompose.decompose_weights(q, bits).contiguous()


def _mixed_layout(m: int):
    """Three tier groups (8/8, 4/4, 2/2) covering m rows."""
    a = (m + 2) // 3
    b = (m - a + 1) // 2
    return ((a, 4), (b, 2), (m - a - b, 1))


def _grouped_layouts(m: int):
    """Tier mixes of m rows, (rows, planes) per group: one-tier batches of
    Pmax 4, 3, 2, 1; two tiers of Pmax 3 and 2 (from two rows); the
    three-tier mix (from three rows)."""
    out = [((m, p),) for p in (4, 3, 2, 1)]
    if m >= 2:
        a = (m + 1) // 2
        out += [((a, 3), (m - a, 1)), ((a, 2), (m - a, 1))]
    if m >= 3:
        out.append(_mixed_layout(m))
    return out


def _grouped_args(layout, n: int, gen):
    """mult, x_scale, w_scale (one row per group) and row_group of
    ``layout``."""
    import numpy as np
    import torch
    from repro_torch.core import decompose
    m = sum(r for r, _ in layout)
    mult = torch.from_numpy(decompose.prefix_multipliers(layout)).cuda()
    xs = torch.rand((m, 1), device="cuda", generator=gen) * 1e-2 + 1e-4
    base = torch.rand((1, n), device="cuda", generator=gen) * 1e-2 + 1e-5
    ws = torch.cat([base * (1.0, 16.0, 64.0)[g % 3]
                    for g in range(len(layout))])
    rg = torch.from_numpy(np.repeat(np.arange(len(layout), dtype=np.int32),
                                    [r for r, _ in layout])).cuda()
    return mult, xs, ws.contiguous(), rg


# A speculative round of phase 4b: SPEC_SLOTS slots, SPEC_K drafts.
SPEC_SLOTS, SPEC_K = 8, 4
# Slot-tier vectors of a verify (or draft) step: three tiers; one 8/8 slot
# among draft-tier slots; two tiers of 4/4 and 2/2; one tier.
VERIFY_TIER_MIXES = (("8/8", "4/4", "2/2") * 2 + ("8/8", "4/4"),
                     ("8/8",) + ("2/2",) * 7,
                     ("4/4",) * 2 + ("2/2",) * 6,
                     ("8/8",) * 8)
TIER_PLANES = {"8/8": (4, 127.0), "4/4": (2, 7.0), "2/2": (1, 1.0)}


def _verify_layout(tiers):
    """The verify step's tables for one slot-tier vector, as the engine
    makes them (``_group_layout``, then ``ops._quantize_activations_rows``
    with SPEC_K + 1 rows a slot): (rows, planes) per group, the per-row
    qmax column and the flat row perm."""
    import numpy as np
    import torch
    w = SPEC_K + 1
    rank = {t: i for i, t in enumerate(TIER_PLANES)}
    order = sorted(range(len(tiers)), key=lambda s: (rank[tiers[s]], s))
    layout = []
    for s in order:
        if layout and layout[-1][0] == tiers[s]:
            layout[-1][1] += w
        else:
            layout.append([tiers[s], w])
    qmax = torch.tensor([TIER_PLANES[tiers[s]][1] for s in order
                         for _ in range(w)], device="cuda")[:, None]
    perm = torch.from_numpy((np.asarray(order)[:, None] * w +
                             np.arange(w)).reshape(-1)).cuda()
    return (tuple((rows, TIER_PLANES[t][0]) for t, rows in layout), qmax,
            perm)


# Kernel 1's widths in phase 2 (2-8 bits signed, 8 unsigned) and kernel
# 2's per-row qmax, cycled over the rows.
AQ_WIDTHS = tuple((b, True) for b in range(2, 9)) + ((8, False),)
ROWS_QMAX = (127.0, 7.0, 1.0)


def _act_rows(m: int, k: int, qmaxes, signed: bool, gen):
    """f32 [m, k]: normal rows (x3), but every row 4j + 1 holds values
    that land exactly on a .5 boundary after the divide when quantized at
    its ``qmaxes[row % len]`` (amax = qmax / 8, so scale = 1/8 and
    x / scale = n + 1/2), and every row 4j + 3 is zero (scale =
    1e-8 * (1/qmax))."""
    import torch
    x = torch.randn((m, k), device="cuda", generator=gen) * 3.0
    for r in range(1, m, 4):
        q = qmaxes[r % len(qmaxes)]
        n = torch.randint(-int(q) if signed else 0, int(q), (k,),
                          device="cuda", generator=gen)
        x[r] = (n.float() + 0.5) / 8.0
        x[r, 0] = (-q if signed else q) / 8.0
    x[3::4] = 0.0
    return x


def _act_quant_cases(gen):
    """Kernels 1 and 2's parity inputs: yields (x, perm), ``x`` mapping
    each of kernel 1's widths (bits, signed) and "rows" (kernel 2) to its
    input.  M in {1, 5, 8, 64}, K in {96, 1024, 2048, 4096, 4100, 5120,
    8192, 12288} (1024, 2048, 5120 and 8192: the generic path of phases
    4e and 4i), bf16 and f32, without and with ``perm`` (a shuffle with a
    repeated row; int32 for bf16, int64 for f32); then at K = 4096 and
    12288, M = 8, two views: rows 8 elements apart, and a base one element
    past a 16-byte boundary (the generic path); and phase 4i's K-shards:
    f32, M = 64, K = 2048 and 1024, rows 4096 apart."""
    import torch

    def inputs(m, k, dtype, view=lambda t: t):
        x = {(b, s): _act_rows(m, k, [float((1 << (b - 1)) - 1 if s
                                            else (1 << b) - 1)], s, gen)
             for b, s in AQ_WIDTHS}
        x["rows"] = _act_rows(m, k, ROWS_QMAX, True, gen)
        return {key: view(t.to(dtype)) for key, t in x.items()}

    for k in (96, 1024, 2048, 4096, 4100, 5120, 8192, 12288):
        for m in (1, 5, 8, 64):
            for dtype in (torch.float32, torch.bfloat16):
                x = inputs(m, k, dtype)
                yield x, None
                perm = torch.randperm(m, device="cuda", generator=gen)
                perm[-1] = perm[0]
                yield x, perm.to(torch.int32 if dtype == torch.bfloat16
                                 else torch.int64)
    for k in (4096, 12288):
        for dtype in (torch.float32, torch.bfloat16):
            yield inputs(8, k, dtype, lambda t: torch.cat(
                [t, t[:, :8]], dim=1)[:, :k]), None
            yield inputs(8, k, dtype, lambda t: torch.cat(
                [t.new_zeros(1), t.reshape(-1)])[1:].view(8, k)), None
    # Phase 4i's wire quantizer: f32 rows of 64, rank 1's K-shard of a
    # 4096-wide row at n = 2 and 4 (rows 4096 apart, the base K in).
    for k in (2048, 1024):
        yield inputs(64, k, torch.float32, lambda t: torch.cat(
            [t, t, t.new_zeros(64, 4096 - 2 * k)], dim=1)[:, k:2 * k]), None


def phase_parity() -> dict:
    import torch
    from repro_torch.core import decompose
    from repro_torch.kernels import _build
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    _build.reset_launches()
    err = {name: 0.0 for name in KERNELS}
    checks = {name: 0 for name in KERNELS}

    def hold(name: str, got, want) -> None:
        if isinstance(got, tuple):          # (codes, scales) pairs
            for g, w in zip(got, want):
                hold(name, g, w)
            return
        checks[name] += 1
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
        diff = (got.double() - want.double()).abs().max().item() \
            if got.numel() else 0.0
        err[name] = max(err[name], diff)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit-equal to its plain "
                                 f"version (max abs err {diff})")

    for x, perm in _act_quant_cases(gen):
        for bits, signed in AQ_WIDTHS:
            xb = x[bits, signed]
            got = aq.act_quant(xb, bits=bits, signed=signed, perm=perm)
            want = ref.act_quant_ref(xb, bits=bits, signed=signed, perm=perm)
            hold("act_quant", got[0], want[0])
            hold("act_quant", got[1], want[1])
        m = x["rows"].shape[0] if perm is None else perm.shape[0]
        qmax = torch.tensor(ROWS_QMAX, device="cuda").repeat(m)[:m, None]
        got = aq.act_quant_rows(x["rows"], qmax, perm=perm)
        want = ref.act_quant_rows_ref(x["rows"], qmax, perm=perm)
        hold("act_quant_rows", got[0], want[0])
        hold("act_quant_rows", got[1], want[1])
    sync()
    shapes = [(m, k, n) for m in (8, 64)
              for k, n in GEMM_SHAPES + ARCH_GEMM_SHAPES]
    shapes.append((5, 4100, 1000))
    for m, k, n in shapes:
        x, planes = _inputs(m, k, n, gen)
        for p in (1, 2, 3, 4):
            pre = planes[:p]
            for shifts in (decompose.prefix_shifts(p),
                           tuple(2 * c for c in range(p))):
                hold("bitserial_matmul", bsm.bitserial_matmul(x, pre, shifts),
                     ref.bitserial_matmul_ref(x, pre, shifts))
        # The byte-packed store of the same weights; a w-bit store keeps its
        # low w bits.  Unsigned reads take the same bytes.
        packed = ops.pack_planes(planes.flip(0), 8)
        for w_bits in (2, 4, 6, 8):
            wp = packed & ((1 << w_bits) - 1)
            for eff in range(2, w_bits + 1, 2):
                for signed in (True, False):
                    hold("packed_bitserial_matmul",
                         bsm.packed_bitserial_matmul(x, wp, w_bits=w_bits,
                                                     eff_bits=eff,
                                                     signed=signed),
                         ref.packed_bitserial_matmul_ref(x, wp, w_bits, eff,
                                                         signed))
            del wp
        mult, xs, ws, rg = _grouped_args(_mixed_layout(m), n, gen)
        hold("grouped_dequant_matmul",
             gmm.grouped_dequant_matmul(x, planes, mult, xs, ws, rg),
             ref.grouped_dequant_matmul_ref(x, planes, mult, xs, ws, rg))
        hold("grouped_matmul", gmm.grouped_matmul(x, planes, mult),
             ref.grouped_matmul_ref(x, planes, mult))
        for signed in (True, False):
            lay = dict(packed=True, signed=signed)
            hold("grouped_dequant_matmul",
                 gmm.grouped_dequant_matmul(x, packed, mult, xs, ws, rg, **lay),
                 ref.grouped_dequant_matmul_ref(x, packed, mult, xs, ws, rg,
                                                **lay))
            hold("grouped_matmul", gmm.grouped_matmul(x, packed, mult, **lay),
                 ref.grouped_matmul_ref(x, packed, mult, **lay))
        # A fixed 4-bit packed store: two fields, the upper one signed.
        w4 = packed & 0xF
        mult4 = torch.from_numpy(decompose.prefix_multipliers(((m, 2),))).cuda()
        hold("grouped_matmul",
             gmm.grouped_matmul(x, w4, mult4, packed=True, store_planes=2),
             ref.grouped_matmul_ref(x, w4, mult4, packed=True, store_planes=2))
        del x, planes, packed, w4
        sync()
        torch.cuda.empty_cache()
    # Fixed-width planes of every width (shifts 2c), at the sweep's M = 512
    # rows of phase 4k and at a decode step's 8.
    for m, k, n in ((512, 4096, 12288), (8, 4096, 1024)):
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device="cuda",
                          generator=gen)
        for bits in range(2, 9):
            planes = _fixed_planes(bits, k, n, gen)
            shifts = tuple(2 * c for c in range(planes.shape[0]))
            hold("bitserial_matmul", bsm.bitserial_matmul(x, planes, shifts),
                 ref.bitserial_matmul_ref(x, planes, shifts))
        del x, planes
        torch.cuda.empty_cache()
    # The shift GEMMs at the prefill buckets' row counts and a ragged row
    # tile (M = 17), every plane count and truncation.
    for m, k, n in [(m, k, n) for m in (16, 17, 40) for k, n in GEMM_SHAPES]:
        x, planes = _inputs(m, k, n, gen)
        for p in (1, 2, 3, 4):
            for shifts in (decompose.prefix_shifts(p),
                           tuple(2 * c for c in range(p))):
                hold("bitserial_matmul",
                     bsm.bitserial_matmul(x, planes[:p], shifts),
                     ref.bitserial_matmul_ref(x, planes[:p], shifts))
        packed = ops.pack_planes(planes.flip(0), 8)
        for eff in (2, 4, 6, 8):
            for signed in (True, False):
                hold("packed_bitserial_matmul",
                     bsm.packed_bitserial_matmul(x, packed, w_bits=8,
                                                 eff_bits=eff, signed=signed),
                     ref.packed_bitserial_matmul_ref(x, packed, 8, eff,
                                                     signed))
        del x, planes, packed
        sync()
        torch.cuda.empty_cache()
    # Kernels 1, 3 and 5 at the row counts of a BatchServeEngine prefill
    # (rows x padded prompt, up to 8 x 64): more than one 64-row tile.
    for m in PREFILL_ROWS:
        for k in (4096, 12288):
            for dtype in (torch.bfloat16, torch.float32):
                for bits, signed in AQ_WIDTHS:
                    xa = _act_rows(m, k, [float((1 << (bits - 1)) - 1 if signed
                                                else (1 << bits) - 1)],
                                   signed, gen).to(dtype)
                    hold("act_quant", aq.act_quant(xa, bits=bits,
                                                   signed=signed),
                         ref.act_quant_ref(xa, bits=bits, signed=signed))
        for k, n in GEMM_SHAPES:
            x, planes = _inputs(m, k, n, gen)
            if -(-m // bsm.plan(m, k, n, 4).bm) < 2:
                raise AssertionError(f"M={m}: one row tile, expected more")
            for p in (1, 2, 3, 4):
                for shifts in (decompose.prefix_shifts(p),
                               tuple(2 * c for c in range(p))):
                    hold("bitserial_matmul",
                         bsm.bitserial_matmul(x, planes[:p], shifts),
                         ref.bitserial_matmul_ref(x, planes[:p], shifts))
            packed = ops.pack_planes(planes.flip(0), 8)
            del planes
            for eff in (2, 4, 6, 8):
                for signed in (True, False):
                    hold("packed_bitserial_matmul",
                         bsm.packed_bitserial_matmul(x, packed, w_bits=8,
                                                     eff_bits=eff,
                                                     signed=signed),
                         ref.packed_bitserial_matmul_ref(x, packed, 8, eff,
                                                         signed))
            del x, packed
            sync()
            torch.cuda.empty_cache()
    # The grouped GEMMs at every decode batch kind, both layouts.
    for m, k, n in [(m, k, n) for m in (1, 3, 8, 16, 17, 40)
                    for k, n in GEMM_SHAPES]:
        x, planes = _inputs(m, k, n, gen)
        packed = ops.pack_planes(planes.flip(0), 8)
        for layout in _grouped_layouts(m):
            mult, xs, ws, rg = _grouped_args(layout, n, gen)
            pre = planes[:mult.shape[1]]
            for w, lay in ((pre, {}), (packed, dict(packed=True)),
                           (packed, dict(packed=True, signed=False))):
                hold("grouped_dequant_matmul",
                     gmm.grouped_dequant_matmul(x, w, mult, xs, ws, rg, **lay),
                     ref.grouped_dequant_matmul_ref(x, w, mult, xs, ws, rg,
                                                    **lay))
                hold("grouped_matmul", gmm.grouped_matmul(x, w, mult, **lay),
                     ref.grouped_matmul_ref(x, w, mult, **lay))
        del x, planes, packed
        sync()
        torch.cuda.empty_cache()
    # The verify layouts of a speculative round (SPEC_SLOTS slots, window
    # SPEC_K + 1): kernel 2 on bf16 rows through the flat perm, kernels 4
    # and 6 on both layouts at every serving shape (the LM head included).
    m = SPEC_SLOTS * (SPEC_K + 1)
    for k, n in GEMM_SHAPES:
        x, planes = _inputs(m, k, n, gen)
        packed = ops.pack_planes(planes.flip(0), 8)
        xb = (torch.randn((m, k), device="cuda", generator=gen) * 3
              ).to(torch.bfloat16)
        for tiers in VERIFY_TIER_MIXES:
            layout, qmax, perm = _verify_layout(tiers)
            hold("act_quant_rows", aq.act_quant_rows(xb, qmax, perm=perm),
                 ref.act_quant_rows_ref(xb, qmax, perm=perm))
            mult, xs, ws, rg = _grouped_args(layout, n, gen)
            pre = planes[:mult.shape[1]]
            for w, lay in ((pre, {}), (packed, dict(packed=True))):
                hold("grouped_dequant_matmul",
                     gmm.grouped_dequant_matmul(x, w, mult, xs, ws, rg, **lay),
                     ref.grouped_dequant_matmul_ref(x, w, mult, xs, ws, rg,
                                                    **lay))
                hold("grouped_matmul", gmm.grouped_matmul(x, w, mult, **lay),
                     ref.grouped_matmul_ref(x, w, mult, **lay))
        del x, planes, packed, xb
        sync()
        torch.cuda.empty_cache()
    launches = dict(_build.LAUNCHES)
    log("[parity] tolerance 0 (bit-equal): " + ", ".join(
        f"{k}: {checks[k]} cases" for k in KERNELS))
    return {"max_abs_err": err, "launches": launches}


# -------------------------------------------------------- phases 3, 4, 5
def _requests(n: int, vocab: int, max_new: int, tiers, seed: int):
    import numpy as np
    from repro_torch.serve.request import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(0, vocab, size=int(rng.integers(16, 65)),
                                        dtype=np.int64).astype(np.int32),
                    max_new_tokens=max_new,
                    tier=None if tiers is None else tiers[i % len(tiers)])
            for i in range(n)]


def _serve(engine, reqs, label: str) -> dict:
    """Serve ``reqs``, counting the kernel launches of exactly this run."""
    import torch
    from repro_torch.kernels import _build
    torch.cuda.reset_peak_memory_stats()
    sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = engine.run(reqs)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    st = engine.stats
    toks = sum(len(v) for v in out.values())
    res = {
        "requests": len(reqs), "tokens": toks, "wall_s": wall,
        "prefills": st.prefills, "decode_steps": st.decode_steps,
        "decode_chunks": st.decode_chunks,
        "decode_tokens_per_s": st.decode_slot_steps / st.decode_seconds,
        "mean_decode_step_ms": 1e3 * st.decode_seconds / st.decode_steps,
        "decode_s": st.decode_seconds,
        "prefill_s": st.prefill_seconds,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    }
    log(f"[{label}] " + json.dumps(res, sort_keys=True))
    return {"stats": res, "tokens": out}


def _gemm_launches(launches: dict) -> dict:
    """The launches of every kernel but decode attention, which every
    backend runs on the card (the plain backends replace the GEMMs)."""
    return {k: v for k, v in launches.items() if k != "decode_attention"}


def _check_plain(label: str, ref: dict, res: dict) -> None:
    """The plain replay launched no GEMM kernel and gave the same
    streams."""
    if any(_gemm_launches(ref["stats"]["launches"]).values()):
        raise AssertionError(f"{label}: the plain backend launched kernels: "
                             f"{ref['stats']['launches']}")
    if ref["tokens"] != res["tokens"]:
        raise AssertionError(f"{label}: cuda streams differ from the plain "
                             "backend's")
    log(f"[{label}] {len(res['tokens'])} streams identical to the plain "
        "decomposed backend's, which launched no GEMM kernel")


def _check_streams(label: str, out, reqs, vocab: int) -> None:
    for r in reqs:
        toks = out[r.uid]
        if len(toks) != r.max_new_tokens:
            raise AssertionError(f"{label}: uid {r.uid} got {len(toks)} "
                                 f"tokens, wanted {r.max_new_tokens}")
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{label}: uid {r.uid} token out of range")


def _build_model(layers, policy, superplane: bool, seed: int,
                 packed: bool = False, prepare: bool = True,
                 arch: str = "qwen3-8b", reduced: bool = False):
    """``arch`` (qwen3-8b unless named; its reduced config if ``reduced``)
    at full width, ``layers`` deep (None: the config's depth), random
    weights from ``seed``; prepared period by period unless ``prepare`` is
    False (the float weights then go to the engine, which prepares them)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.transformer import LM
    from repro_torch.serve import engine as engine_mod
    cfg = reduced_config(arch) if reduced else get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = LM(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, device="cuda", prepare=None if not prepare else
                        lambda tree, prefix: engine_mod.prepare_tree(
                            tree, policy, prefix=prefix,
                            superplane=superplane, packed=packed))
    sync()
    log(f"[model] {cfg.name} width {cfg.d_model}, {cfg.num_heads} heads, "
        f"{cfg.num_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab}, {cfg.num_layers} layers: initialised"
        f"{f' + prepared (packed={packed})' if prepare else ''} in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    return cfg, model, params


TIERS = {"8/8": (8, 8), "4/4": (4, 4), "2/2": (2, 2)}
MIXED_KW = dict(max_batch=8, max_len=256, decode_chunk=8, device="cuda")


def phase_mixed() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import engine as engine_mod
    tiers, kw = TIERS, MIXED_KW
    sched = uniform_schedule(tiers, backend="cuda")
    cfg, model, params = _build_model(get_config("qwen3-8b").num_layers,
                                      sched.prepare_policy(),
                                      superplane=True, seed=0)
    reqs = _requests(9, cfg.vocab_size, 16, list(tiers), seed=1)
    eng = engine_mod.ServeEngine(model, params, Runtime(
        policy=sched.policy_for(), schedule=sched), **kw)
    calls = engine_mod.PREPARE_CALLS
    res = _serve(eng, reqs, "mixed")
    if engine_mod.PREPARE_CALLS != calls:
        raise AssertionError("prepare_params ran after engine construction")
    _check_streams("mixed", res["tokens"], reqs, cfg.padded_vocab)
    _check_launches("mixed", res["stats"]["launches"],
                    used=[k for k, v in PATH_OF.items() if v == "mixed"],
                    unused=("packed_bitserial_matmul", "grouped_matmul"))
    if eng.stats.mixed_tier_chunks == 0:
        raise AssertionError("no decode chunk mixed tiers")
    attn = res["stats"]["launches"]["decode_attention"]
    if attn != cfg.num_layers * res["stats"]["decode_steps"]:
        raise AssertionError(f"mixed: {attn} decode-attention launches, "
                             f"not one a layer and decode step ("
                             f"{cfg.num_layers} x "
                             f"{res['stats']['decode_steps']})")
    log(f"[mixed] decode attention: {attn} launches = {cfg.num_layers} "
        f"layers x {res['stats']['decode_steps']} decode steps")
    _profile_chunk(eng, reqs)
    del eng
    plain = uniform_schedule(tiers, backend="decomposed")
    ref_eng = engine_mod.ServeEngine(model, params, Runtime(
        policy=plain.policy_for(), schedule=plain), **kw)
    _check_plain("mixed", _serve(ref_eng, reqs, "mixed-plain"), res)
    return {**res["stats"], "streams": res["tokens"]}


def _kernel_name(name: str, width: int = 110) -> str:
    """A device operation's name without its trailing argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i][:width]
    return name[:width]


def _profile_chunk(eng, reqs) -> None:
    """Submits ``reqs`` to the idle ``eng`` again and traces its first two
    decode chunks (all slots filled, tiers mixed).  The first runs under
    ``torch.profiler``, CUDA activity only: prints the device-busy share
    of the chunk's wall time (the union of the device operations'
    intervals over the host clock around the chunk, which ends in a host
    copy) and the five device operations that took the most time.  The
    second runs under ``cProfile``: prints its wall time and the host
    functions with the most self time, and the port's functions with the
    most cumulative time, per decode step.  Each tracer's own cost on the
    host lengthens its chunk; the run is not counted anywhere else."""
    import cProfile
    import dataclasses
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    inner = eng._decode_chunk
    seen: dict = {}

    def traced(rt, n_steps):
        if "host" in seen:
            return inner(rt, n_steps)
        sync()
        t0 = time.perf_counter()
        if "prof" not in seen:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = inner(rt, n_steps)
                seen["wall_ms"] = 1e3 * (time.perf_counter() - t0)
            seen.update(prof=prof, steps=n_steps)
            return out
        host = cProfile.Profile()
        out = host.runcall(inner, rt, n_steps)
        seen.update(host=host, host_steps=n_steps,
                    host_wall_ms=1e3 * (time.perf_counter() - t0))
        return out
    for r in reqs:                 # the same requests under fresh uids
        eng.submit(dataclasses.replace(r, uid=r.uid + len(reqs)))
    mixed = eng.stats.mixed_tier_chunks
    eng._decode_chunk = traced
    try:
        eng.step()                 # admission, then the device-traced chunk
        eng.step()                 # the host-traced chunk
    finally:
        del eng._decode_chunk
    if eng.stats.mixed_tier_chunks != mixed + 2:
        raise AssertionError("profile: a traced chunk did not mix tiers")
    spans, by_name = [], {}
    for e in seen["prof"].events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        name = _kernel_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    busy_us = _busy_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log("[mixed] profile of one decode chunk: " + json.dumps({
        "steps": seen["steps"], "wall_ms": seen["wall_ms"],
        "device_ops_per_step": len(spans) / seen["steps"],
        "device_busy_ms": busy_us / 1e3 if spans else "not measured",
        "device_busy_share": busy_us / 1e3 / seen["wall_ms"]
        if spans else "not measured",
        "top5_device_ms": [[n, us / 1e3] for n, us in top]}))
    stats = pstats.Stats(seen["host"]).stats
    steps = seen["host_steps"]

    def where(func) -> str:
        path, line, name = func
        return f"{pathlib.Path(path).name}:{line}({name})"
    own = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
    cum = sorted(((f, v) for f, v in stats.items() if "repro_torch" in f[0]),
                 key=lambda kv: -kv[1][3])[:12]
    # Calls per step of the two Tensor methods a call site would spend on
    # gathering x and copying it to f32 before kernel 2 (it does neither).
    methods = {name: sum(v[1] for f, v in stats.items()
                         if f[2] == f"<method '{name}' of "
                         "'torch._C.TensorBase' objects>") / steps
               for name in ("index_select", "to")}
    log("[mixed] host profile of the next chunk (cProfile): " + json.dumps({
        "steps": steps, "wall_ms": seen["host_wall_ms"],
        "tensor_calls_per_step": methods,
        "self_ms_per_step": [[where(f), v[1] / steps, 1e3 * v[2] / steps]
                             for f, v in own],
        "cum_ms_per_step": [[where(f), v[1] / steps, 1e3 * v[3] / steps]
                            for f, v in cum]}))


def _busy_us(spans) -> float:
    """The length of the union of device intervals (start, end) in µs."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _check_launches(label: str, launches: dict, used, unused) -> None:
    """Every kernel of ``used`` launched in this run, none of ``unused``."""
    missing = [k for k in used if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels of the path never launched: "
                             f"{missing}")
    stray = [k for k in unused if launches[k] != 0]
    if stray:
        raise AssertionError(f"{label}: kernels off the path launched: "
                             f"{ {k: launches[k] for k in stray} }")


def phase_packed(mixed_streams) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import engine as engine_mod
    sched = uniform_schedule(TIERS, backend="cuda")
    cfg, model, params = _build_model(get_config("qwen3-8b").num_layers,
                                      sched.prepare_policy(), superplane=True,
                                      seed=0, prepare=False)
    reqs = _requests(9, cfg.vocab_size, 16, list(TIERS), seed=1)
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    t0 = time.perf_counter()
    eng = engine_mod.ServeEngine(model, params, rt, packed=True, **MIXED_KW)
    del params                     # the engine holds the packed store only
    sync()
    log(f"[packed] ServeEngine(packed=True) prepared the store in "
        f"{time.perf_counter() - t0:.1f}s")
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    calls = engine_mod.PREPARE_CALLS
    res = _serve(eng, reqs, "packed")
    if engine_mod.PREPARE_CALLS != calls:
        raise AssertionError("prepare_params ran after engine construction")
    _check_streams("packed", res["tokens"], reqs, cfg.padded_vocab)
    _check_launches("packed", res["stats"]["launches"],
                    used=("packed_bitserial_matmul", "act_quant",
                          "act_quant_rows", "grouped_dequant_matmul"),
                    unused=("bitserial_matmul", "grouped_matmul"))
    if res["tokens"] != mixed_streams:
        raise AssertionError("packed: streams differ from the int8-plane "
                             "store's (phase mixed)")
    log(f"[packed] {len(res['tokens'])} streams identical to phase mixed's")
    # Turns on this card: the int8 planes of the same codes against the
    # packed store, alternately (planes, packed, packed, planes).
    stores = {"packed": eng.params, "planes": _unpacked(eng.params)}
    del eng
    turns: dict = {"planes": [], "packed": []}
    for label in ("planes", "packed", "packed", "planes"):
        turn = _serve(engine_mod.ServeEngine(model, stores[label], rt,
                                             **MIXED_KW), reqs, f"turn-{label}")
        if turn["tokens"] != mixed_streams:
            raise AssertionError(f"turn-{label}: streams differ")
        turns[label].append(turn["stats"]["mean_decode_step_ms"])
        gc.collect()
    log("[packed] turns, mean decode-step ms: " + json.dumps(turns))
    return {**res["stats"], "turns_step_ms": turns}


def _unpacked(tree):
    """The int8-plane store holding the same codes as a packed one."""
    import dataclasses

    from repro_torch.kernels import ops
    if isinstance(tree, dict):
        return {k: _unpacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unpacked(v) for v in tree]
    if isinstance(tree, ops.QuantizedWeight) and tree.packed is not None:
        return dataclasses.replace(tree, planes=tree.get_planes().contiguous(),
                                   packed=None)
    return tree


# --------------------------------------------------------------- phase 4b
def _variant(reqs, *, spec: bool, sampled: bool):
    """``reqs`` with uid % 3 != 2 speculating (draft tier 2/2, SPEC_K)
    where ``spec``, and all sampling (temperature 0.8, top-k 40, seed =
    uid) where ``sampled``."""
    import dataclasses

    from repro_torch.spec import SamplingParams, SpecConfig
    return [dataclasses.replace(
        r, spec=SpecConfig("2/2", SPEC_K) if spec and r.uid % 3 != 2
        else None,
        sampling=SamplingParams(0.8, 40, seed=r.uid) if sampled else None)
        for r in reqs]


def _spec_stats(engine) -> dict:
    st = engine.stats
    return {"spec_rounds": st.spec_rounds,
            "spec_draft_steps": st.spec_draft_steps,
            "spec_verify_steps": st.spec_verify_steps,
            "spec_drafted": st.spec_drafted,
            "spec_accepted": st.spec_accepted,
            "spec_emitted": st.spec_emitted,
            "acceptance_rate": st.spec_accepted / max(1, st.spec_drafted),
            "emitted_per_verify_step":
                st.spec_emitted / max(1, st.spec_verify_steps)}


def _count_rounds(engine) -> dict:
    """Counts, per kernel, the launches made inside the engine's
    speculative rounds and, of those, inside its verify steps (wrappers
    on the instance; removed by deleting the two attributes)."""
    from repro_torch.kernels import _build
    counts = {"round": dict.fromkeys(KERNELS, 0),
              "verify": dict.fromkeys(KERNELS, 0)}

    def counted(key, fn):
        def run(*args, **kwargs):
            before = dict(_build.LAUNCHES)
            out = fn(*args, **kwargs)
            for name in KERNELS:
                counts[key][name] += _build.LAUNCHES[name] - before[name]
            return out
        return run
    engine._spec_round = counted("round", engine._spec_round)
    engine.model = _ModelView(engine.model,
                              counted("verify", engine.model.verify_step))
    return counts


class _ModelView:
    """``model`` with its ``verify_step`` replaced (for counting)."""

    def __init__(self, model, verify_step):
        self._model = model
        self.verify_step = verify_step

    def __getattr__(self, name):
        return getattr(self._model, name)


def _emitted_per_s(stats: dict) -> float:
    """Decode-emitted tokens (all but each request's prefill token) over
    the decode seconds."""
    return (stats["tokens"] - stats["prefills"]) / stats["decode_s"]


def _check_same(label: str, got: dict, want: dict, what: str) -> None:
    if got != want:
        bad = sorted(u for u in want if got.get(u) != want[u])
        raise AssertionError(f"{label}: streams differ from {what} "
                             f"(uids {bad})")
    log(f"[{label}] {len(got)} streams identical to {what}")


def _verify_positions(label: str, model, params, rt, seed: int) -> None:
    """On ``model`` (4 layers, full width): prefill SPEC_SLOTS right-padded
    prompts, then the window [t0, 4 random tokens] through ONE verify step
    at the mixed verify layout (and at one tier), against SPEC_K + 1
    sequential decode steps on a copy of the arena: logits of the writing
    rows and the whole arena bit-equal."""
    import numpy as np
    import torch
    b, w = SPEC_SLOTS, SPEC_K + 1
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 65, size=b).astype(np.int32)
    toks = rng.integers(0, model.cfg.vocab_size, size=(b, 64)).astype(np.int32)
    active = torch.tensor([s % 3 != 2 for s in range(b)], device="cuda")
    checked = []
    for tiers in (VERIFY_TIER_MIXES[0], VERIFY_TIER_MIXES[3]):
        caches = model.init_cache(b, 256, device="cuda")
        logits, _ = model.prefill(params, rt.for_tier("8/8"), caches,
                                  tokens=torch.from_numpy(toks).cuda(),
                                  seq_lengths=torch.from_numpy(lens).cuda())
        t0 = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        window = torch.cat([t0[:, None], torch.from_numpy(rng.integers(
            0, model.cfg.vocab_size, size=(b, w - 1)).astype(np.int32)
        ).cuda()], dim=1)
        rank = {t: i for i, t in enumerate(TIER_PLANES)}
        order = sorted(range(b), key=lambda s: (rank[tiers[s]], s))
        groups = []
        for s in order:
            if groups and groups[-1][0] == tiers[s]:
                groups[-1][1] += 1
            else:
                groups.append([tiers[s], 1])
        rt_v = rt.for_groups(tuple((t, n) for t, n in groups),
                             torch.tensor(order, device="cuda"))
        seq = _clone_caches(caches)
        vlogits, _ = model.verify_step(params, rt_v, caches, tokens=window,
                                       active=active)
        for j in range(w):
            lj, _ = model.decode_step(params, rt_v, seq,
                                      tokens=window[:, j:j + 1],
                                      active=active)
            if not torch.equal(vlogits[active, j], lj[active, 0]):
                diff = (vlogits[active, j].float() -
                        lj[active, 0].float()).abs().max().item()
                raise AssertionError(f"{label}: verify position {j} differs "
                                     f"from decode step {j} (max abs "
                                     f"{diff}) at layout {groups}")
        for la, lb in zip(caches, seq):
            for p in la:
                for x, y in zip(vars(la[p]).values(), vars(lb[p]).values()):
                    if x is not None and not torch.equal(x, y):
                        raise AssertionError(f"{label}: verify arena differs "
                                             "from sequential decode's")
        checked.append([list(g) for g in groups])
        del caches, seq
    log(f"[{label}] verify window == {w} sequential decode steps, logits and "
        f"arena bit-equal, layouts {checked}")


def _sampling_device_ops(vocab: int) -> dict:
    """Device operations (``torch.profiler``, CUDA activity) of the plain
    torch sampling code at this run's shapes: one ``sample_tokens`` and
    one ``sampling_probs`` over SPEC_SLOTS rows of ``vocab`` logits (the
    selection of a sampled decode step; a draft step runs both), and the
    acceptance of one round (``accept_counts``, ``correction_tokens``,
    ``emission_window`` at k = SPEC_K)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.spec import sampling as sl
    from repro_torch.spec import speculate as sp
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    b, k = SPEC_SLOTS, SPEC_K
    logits = torch.randn((b, vocab), device="cuda", generator=gen
                         ).to(torch.bfloat16)
    keys = torch.randint(0, 1 << 32, (b, 2), device="cuda", generator=gen)
    draws = torch.arange(b, dtype=torch.int32, device="cuda")
    temp = torch.full((b,), 0.8, device="cuda")
    topk = torch.full((b,), 40, dtype=torch.int32, device="cuda")
    q = torch.softmax(torch.randn((b, k, vocab), device="cuda",
                                  generator=gen), -1)
    p = torch.softmax(torch.randn((b, k + 1, vocab), device="cuda",
                                  generator=gen), -1)
    drafts = torch.randint(0, vocab, (b, k), device="cuda", generator=gen,
                           dtype=torch.int32)

    def accept():
        m = sp.accept_counts(drafts, q, p, keys, draws)
        corr = sp.correction_tokens(q, p, m, keys, draws)
        return sp.emission_window(drafts, corr, m)
    calls = {"sample_tokens": lambda: sl.sample_tokens(
                 logits, keys, draws, temp, topk),
             "sampling_probs": lambda: sl.sampling_probs(logits, temp, topk),
             "acceptance": accept}
    out = {}
    for name, fn in calls.items():
        fn()                                   # warm up
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        out[name] = {"device_ops": len(evs), "device_ms": sum(
            e.time_range.elapsed_us() for e in evs) / 1e3}
    return out


def phase_spec(mixed: dict, card: str) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import engine as engine_mod
    sched = uniform_schedule(TIERS, backend="cuda")
    plain = uniform_schedule(TIERS, backend="decomposed")
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    rt_plain = Runtime(policy=plain.policy_for(), schedule=plain)
    cfg, model, params = _build_model(get_config("qwen3-8b").num_layers,
                                      sched.prepare_policy(),
                                      superplane=True, seed=0)
    reqs = _requests(9, cfg.vocab_size, 16, list(TIERS), seed=1)
    calls = engine_mod.PREPARE_CALLS
    # (a) greedy, speculative and plain slots mixed, at full depth.
    eng = engine_mod.ServeEngine(model, params, rt, **MIXED_KW)
    per_round = _count_rounds(eng)
    greedy = _serve(eng, _variant(reqs, spec=True, sampled=False),
                    "spec-greedy")
    if engine_mod.PREPARE_CALLS != calls:
        raise AssertionError("spec: prepare_params ran after engine "
                             "construction")
    _check_same("spec-greedy", greedy["tokens"], mixed["streams"],
                "phase mixed's (plain greedy decoding)")
    _check_launches("spec-greedy", greedy["stats"]["launches"],
                    used=("act_quant", "act_quant_rows", "bitserial_matmul",
                          "grouped_dequant_matmul"),
                    unused=("packed_bitserial_matmul", "grouped_matmul"))
    stats = _spec_stats(eng)
    if stats["spec_rounds"] == 0:
        raise AssertionError("spec-greedy: no speculative round ran")
    rounds = stats["spec_rounds"]
    launches = {
        name: {"per_round": per_round["round"][name] / rounds,
               "verify_per_round": per_round["verify"][name] / rounds}
        for name in ("act_quant", "act_quant_rows", "bitserial_matmul",
                     "grouped_dequant_matmul")}
    log("[spec-greedy] " + json.dumps({
        **stats, "kernel_launches": launches,
        "decode_emitted_tokens_per_s": _emitted_per_s(greedy["stats"]),
        "mixed_decode_emitted_tokens_per_s": _emitted_per_s(mixed),
        "card": card}))
    del eng
    log("[spec] sampling code on the card, B=8, k=4: " + json.dumps(
        _sampling_device_ops(cfg.padded_vocab)))
    # (b) sampled, without and with speculation, at full depth.
    sampled = {}
    for spec in (False, True):
        label = f"spec-sampled{'-spec' if spec else ''}"
        eng = engine_mod.ServeEngine(model, params, rt, **MIXED_KW)
        run = _serve(eng, _variant(reqs, spec=spec, sampled=True), label)
        _check_streams(label, run["tokens"], reqs, cfg.padded_vocab)
        if spec:
            log(f"[{label}] " + json.dumps(_spec_stats(eng)))
        sampled[spec] = run["tokens"]
        del eng
    if sampled[False] == mixed["streams"]:
        raise AssertionError("spec-sampled: sampled streams equal greedy "
                             "ones")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # At 4 layers: the plain replays, max_batch 3, and the verify window
    # position by position, for both stores.
    for packed in (False, True):
        cfg4, model4, params4 = _build_model(4, sched.prepare_policy(),
                                             superplane=True, seed=0,
                                             packed=packed)
        store = "packed" if packed else "planes"
        log(f"[spec-4] depth cut: 4 of qwen3-8b's 36 layers ({store})")
        _verify_positions(f"spec-4-{store}", model4, params4, rt, seed=7)
        if packed:
            break
        for spec, samp in ((True, False), (False, True), (True, True)):
            label = (f"spec-4-{'spec' if spec else 'plain'}-"
                     f"{'sampled' if samp else 'greedy'}")
            rq = _variant(reqs, spec=spec, sampled=samp)
            run = _serve(engine_mod.ServeEngine(model4, params4, rt,
                                                **MIXED_KW), rq, label)
            _check_plain(label, _serve(engine_mod.ServeEngine(
                model4, params4, rt_plain, **MIXED_KW), rq, label + "-plain"),
                run)
            if samp and not spec:
                small = _serve(engine_mod.ServeEngine(
                    model4, params4, rt, **{**MIXED_KW, "max_batch": 3}), rq,
                    label + "-batch3")
                _check_same(label + "-batch3", small["tokens"], run["tokens"],
                            "max_batch 8's")
        del model4, params4
        gc.collect()
        torch.cuda.empty_cache()
    return {**greedy["stats"], "spec": stats, "launches_per_round": launches}


# --------------------------------------------------------------- phase 4c
KV_TIERS = {"8/8": None, "4/4": 8, "2/2": 4}


def _arena_bytes(caches) -> int:
    return sum(t.numel() * t.element_size()
               for layer in caches for c in layer.values()
               for t in c.tensors())


def _tier_engines(model, params, sched, label: str, kw: dict) -> dict:
    """On ``model``: the mixed-KV engine's run, the per-tier
    ``BatchServeEngine`` runs on the same store (one per tier, each at its
    tier's KV precision) whose union must equal it, and the serialized
    mode's run, which must equal it too, with no mixed chunk and a tier
    switch.  No weight is prepared again.  Returns the runs: "mixed",
    "serialized" and "batch" (tier -> run)."""
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import engine as engine_mod
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    reqs = _requests(9, model.cfg.vocab_size, 16, list(TIERS), seed=1)
    calls = engine_mod.PREPARE_CALLS
    eng = engine_mod.ServeEngine(model, params, rt, **kw)
    mixed = _serve(eng, reqs, label)
    if eng.stats.mixed_tier_chunks == 0:
        raise AssertionError(f"{label}: no decode chunk mixed tiers")
    mixed["arena_bytes"] = _arena_bytes(eng.arena.caches)
    del eng
    batch: dict = {}
    batch_runs: dict = {}
    for tier in TIERS:
        b = engine_mod.BatchServeEngine(
            model, params, rt, max_batch=kw["max_batch"],
            max_len=kw["max_len"], tier=tier, device=kw["device"])
        if b.kv_bits != KV_TIERS[tier]:
            raise AssertionError(f"{label}: batch engine at {tier} keeps KV "
                                 f"at {b.kv_bits}")
        run = _serve(b, [r for r in reqs if r.tier == tier],
                     f"{label}-batch-{tier}")
        batch.update(run["tokens"])
        batch_runs[tier] = run
        del b
    _check_same(label, mixed["tokens"], batch,
                "the per-tier BatchServeEngine runs'")
    ser = engine_mod.ServeEngine(model, params, rt, mixed_tiers=False, **kw)
    serial = _serve(ser, reqs, f"{label}-serialized")
    if ser.stats.mixed_tier_chunks or not ser.stats.tier_switches:
        raise AssertionError(f"{label}-serialized: {ser.stats.mixed_tier_chunks}"
                             f" mixed chunks, {ser.stats.tier_switches} tier "
                             "switches")
    _check_same(f"{label}-serialized", serial["tokens"], mixed["tokens"],
                "the mixed-tier run's")
    if engine_mod.PREPARE_CALLS != calls:
        raise AssertionError(f"{label}: prepare_params ran after engine "
                             "construction")
    return {"mixed": mixed, "serialized": serial, "batch": batch_runs}


def _check_one_tier_launches(label: str, runs: dict) -> None:
    """The serialized run and each per-tier batch run (one-tier batches,
    prefill at M = rows x the longest prompt) launched kernels 1 and 3 and
    none of the others."""
    for name, run in [("serialized", runs["serialized"])] + [
            (f"batch-{t}", r) for t, r in runs["batch"].items()]:
        _check_launches(f"{label}-{name}", run["stats"]["launches"],
                        used=("act_quant", "bitserial_matmul"),
                        unused=("act_quant_rows", "grouped_dequant_matmul",
                                "packed_bitserial_matmul", "grouped_matmul"))


def _clone_caches(caches):
    from repro_torch.models.layers import KVCache
    return [{p: KVCache(*[None if t is None else t.clone() for t in (
        c.k, c.v, c.k_scale, c.v_scale, c.length, c.kv_bits)], modes=c.modes)
        for p, c in layer.items()} for layer in caches]


# Phase 4c's migrations: (uid, new tier); uid 0 is 8/8 (bf16 KV), uid 1
# 4/4 (int8).  They move after their first decode chunk of MIGRATE_CHUNK.
MIGRATIONS = ((0, "2/2"), (1, "8/8"))
MIGRATE_CHUNK = 3


def _migration(label: str, model, params, rt, time_it: bool) -> dict:
    """At ``model``'s depth: serve the 9 requests with a decode chunk of
    MIGRATE_CHUNK and, after the first round (4 tokens each), migrate uid 0
    (8/8, bf16 KV) to 2/2 (int4) and uid 1 (4/4, int8) to 8/8 (bf16).  The
    arena after the migrations must equal ``migrate_kv_tier`` applied on
    the card to a copy taken before them, and a fresh engine that replays
    the first round and takes that copy as its arena must continue with
    the same streams."""
    import torch
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve import slots as slots_lib
    sched = rt.schedule
    kw = {**MIXED_KW, "decode_chunk": MIGRATE_CHUNK}
    reqs = _requests(9, model.cfg.vocab_size, 16, list(TIERS), seed=1)
    sync()
    from repro_torch.kernels import _build
    _build.reset_launches()

    def first_round():
        eng = engine_mod.ServeEngine(model, params, rt, **kw)
        handles = {r.uid: eng.submit(r) for r in reqs}
        eng.step()
        for uid, _ in MIGRATIONS:
            h = handles[uid]
            if h.slot is None or len(h.tokens) != 1 + MIGRATE_CHUNK:
                raise AssertionError(f"{label}: uid {uid} not running with "
                                     f"{1 + MIGRATE_CHUNK} tokens")
        return eng, handles
    eng, handles = first_round()
    copy = _clone_caches(eng.arena.caches)
    ms = {}
    for uid, tier in MIGRATIONS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        sync()
        a.record()
        handles[uid].set_tier(tier)
        b.record()
        b.synchronize()
        ms[f"{uid}:{reqs[uid].tier}->{tier}"] = a.elapsed_time(b)
    if eng.stats.kv_migrations != len(MIGRATIONS):
        raise AssertionError(f"{label}: {eng.stats.kv_migrations} KV "
                             "migrations")
    for uid, tier in MIGRATIONS:
        slots_lib.migrate_kv_tier(copy, handles[uid].slot,
                                  sched.kv_code_for(tier))
    for la, lb in zip(eng.arena.caches, copy):
        for p in la:
            for x, y in zip(la[p].tensors(), lb[p].tensors()):
                if not torch.equal(x, y):
                    raise AssertionError(f"{label}: migrated arena differs "
                                         "from migrate_kv_tier on a copy")
    out = eng.drain()
    launches = dict(_build.LAUNCHES)
    # The fresh engine: the same first round, then the copy as its arena.
    fresh, fh = first_round()
    for la, lb in zip(fresh.arena.caches, copy):
        for p in la:
            for x, y in zip(la[p].tensors(), lb[p].tensors()):
                x.copy_(y)
    for uid, tier in MIGRATIONS:
        fh[uid].request.tier = tier
        fresh.arena.tiers[fh[uid].slot] = tier
    _check_same(f"{label}-resumed", fresh.drain(), out,
                "the migrated engine's continuation")
    if time_it:
        log(f"[{label}] migration ms (CUDA events, one set_tier each): "
            + json.dumps(ms))
    return {"tokens": out, "migration_ms": ms, "launches": launches}


def phase_tiers(mixed: dict, card: str) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.models.layers import Runtime
    sched = uniform_schedule(TIERS, backend="cuda", kv_tiers=KV_TIERS)
    plain = uniform_schedule(TIERS, backend="decomposed", kv_tiers=KV_TIERS)
    cfg, model, params = _build_model(get_config("qwen3-8b").num_layers,
                                      sched.prepare_policy(),
                                      superplane=True, seed=0)
    full = _tier_engines(model, params, sched, "tiers", MIXED_KW)
    res = full["mixed"]
    _check_streams("tiers", res["tokens"], _requests(
        9, cfg.vocab_size, 16, list(TIERS), seed=1), cfg.padded_vocab)
    _check_launches("tiers", res["stats"]["launches"],
                    used=[k for k, v in PATH_OF.items() if v == "mixed"],
                    unused=("packed_bitserial_matmul", "grouped_matmul"))
    _check_one_tier_launches("tiers", full)
    bf16_arena = _arena_bytes(model.init_cache(MIXED_KW["max_batch"],
                                               MIXED_KW["max_len"],
                                               device="cuda"))
    st = res["stats"]
    log("[tiers] " + json.dumps({
        "decode_tokens_per_s": st["decode_tokens_per_s"],
        "mixed_decode_tokens_per_s": mixed["decode_tokens_per_s"],
        "mean_decode_step_ms": st["mean_decode_step_ms"],
        "mixed_mean_decode_step_ms": mixed["mean_decode_step_ms"],
        "serialized_mean_decode_step_ms":
            full["serialized"]["stats"]["mean_decode_step_ms"],
        "arena_bytes": res["arena_bytes"], "mixed_bf16_arena_bytes":
            bf16_arena, "launches": st["launches"], "card": card}))
    _profile_tier_step(model, params, sched)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # At 4 layers: the migration, and (a) to (c) replayed on the plain
    # backend, which must launch no GEMM kernel.
    cfg4, model4, params4 = _build_model(4, sched.prepare_policy(),
                                         superplane=True, seed=0)
    log("[tiers-4] depth cut: 4 of qwen3-8b's 36 layers")
    kw4 = MIXED_KW
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    rt_plain = Runtime(policy=plain.policy_for(), schedule=plain)
    mig = _migration("tiers-4-migrate", model4, params4, rt, time_it=True)
    four = _tier_engines(model4, params4, sched, "tiers-4", kw4)
    _check_one_tier_launches("tiers-4", four)
    plain4 = _tier_engines(model4, params4, plain, "tiers-4-plain", kw4)
    for run in ("mixed", "serialized"):
        _check_plain(f"tiers-4-{run}", plain4[run], four[run])
    for tier in TIERS:
        _check_plain(f"tiers-4-batch-{tier}", plain4["batch"][tier],
                     four["batch"][tier])
    mig_plain = _migration("tiers-4-migrate-plain", model4, params4,
                           rt_plain, time_it=False)
    _check_plain("tiers-4-migrate", {"stats": {"launches":
                                               mig_plain["launches"]},
                                     "tokens": mig_plain["tokens"]}, mig)
    del model4, params4
    return {**st, "streams": res["tokens"],
            "arena_bytes": res["arena_bytes"],
            "bf16_arena_bytes": bf16_arena,
            "migration_ms": mig["migration_ms"]}


def _profile_tier_step(model, params, sched) -> None:
    """One traced decode chunk of the mixed-KV engine (all slots busy, three
    tiers): device operations per step and the device-busy share, as phase
    3 reads them for the bf16 arena."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import engine as engine_mod
    eng = engine_mod.ServeEngine(model, params, Runtime(
        policy=sched.policy_for(), schedule=sched), **MIXED_KW)
    for r in _requests(9, model.cfg.vocab_size, 16, list(TIERS), seed=1):
        eng.submit(r)
    eng._admit_free_slots()
    rt = eng._runtime()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._decode_chunk(rt, 8)
        wall = 1e3 * (time.perf_counter() - t0)
    spans = [(e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us(spans)
    log("[tiers] profile of one decode chunk: " + json.dumps({
        "steps": 8, "wall_ms": wall, "device_ops_per_step": len(spans) / 8,
        "device_busy_share": busy / 1e3 / wall if spans else "not measured"}))


# --------------------------------------------------------------- phase 4d
# Phase 4d's explicit schedule: after the first round, uid 0 (8/8, bf16
# KV) moves to 2/2 (its lanes requantized to int4), then uids 0, 1 (4/4,
# int8; spilled), 2 (2/2, int4) and 3 (8/8, bf16) are preempted.
OVERLOAD_MIGRATE = (0, "2/2")
OVERLOAD_PREEMPTS = (0, 1, 2, 3)
OVERLOAD_SPILLED = 1
# Phase 4d (b)'s policy (the reference command line's --slo --preempt
# --shed, with tenant weights and time slices).
OVERLOAD_POLICY = dict(preempt=True, shed=True, tenant_weights={"a": 2.0},
                       time_slice=2)


def _launch_delta(fn, deltas: list, sync_ms: list = None):
    """``fn`` wrapped to append the kernel launches of each call to
    ``deltas`` (and, given ``sync_ms``, its ms between two syncs)."""
    from repro_torch.kernels import _build

    def wrapped(*args, **kw):
        before = dict(_build.LAUNCHES)
        if sync_ms is not None:
            sync()
            t0 = time.perf_counter()
        out = fn(*args, **kw)
        if sync_ms is not None:
            sync()
            sync_ms.append(1e3 * (time.perf_counter() - t0))
        deltas.append({k: v - before[k] for k, v in _build.LAUNCHES.items()})
        return out
    return wrapped


def _preempt_schedule(model, params, rt, reqs, *, preempt: bool,
                      telemetry=None, timed: bool = False) -> dict:
    """Serve ``reqs`` through phase 4d (a)'s schedule (``preempt`` False:
    the same migration, no preemption).  Records every prefill's and every
    resume's kernel launches, the slots each preempted request left and
    resumed in, and (``timed``) the ms of each preemption (the host copy),
    each resume, the spill's write (preemption + the writer) and read."""
    import tempfile

    from repro_torch.kernels import _build
    from repro_torch.serve import engine as engine_mod
    rec = {"prefill": [], "resume": [], "moves": {}, "nbytes": {},
           "preempt_ms": {}, "resume_ms": [], "read_ms": []}
    with tempfile.TemporaryDirectory() as spill:
        eng = engine_mod.ServeEngine(model, params, rt, spill_dir=spill,
                                     telemetry=telemetry, **MIXED_KW)
        eng._prefill_slot = _launch_delta(eng._prefill_slot, rec["prefill"])
        resume = eng._resume_into

        def resuming(slot, req, sus):
            rec["moves"][req.uid].append(slot)
            return resume(slot, req, sus)
        eng._resume_into = _launch_delta(
            resuming, rec["resume"], rec["resume_ms"] if timed else None)
        eng._unspill = _launch_delta(eng._unspill, [],
                                     rec["read_ms"] if timed else None)
        handles = {r.uid: eng.submit(r) for r in reqs}
        _build.reset_launches()
        eng.step()
        uid, tier = OVERLOAD_MIGRATE
        handles[uid].set_tier(tier)
        for uid in OVERLOAD_PREEMPTS if preempt else ():
            rec["moves"][uid] = [handles[uid].slot]
            eng._spill_dir = spill if uid == OVERLOAD_SPILLED else None
            if timed:
                sync()
            t0 = time.perf_counter()
            rec["nbytes"][uid] = eng.preempt(uid).nbytes
            if uid == OVERLOAD_SPILLED:
                eng._spiller.wait()
            rec["preempt_ms"][uid] = 1e3 * (time.perf_counter() - t0)
        eng._spill_dir = spill
        out = eng.drain()
        rec["launches"] = dict(_build.LAUNCHES)
        rec["spill_left"] = os.listdir(spill)
    rec.update(tokens=out, stats=eng.stats, engine=eng)
    return rec


def _check_schedule(label: str, rec: dict, layers: int,
                    packed: bool = False) -> None:
    """Every fresh admission prefilled through kernels 1 and 3 (5 for the
    packed store) only, their launches for ``layers`` layers and the head;
    every resume launched nothing; every preempted request resumed (one in
    another slot); the spill dir ended empty."""
    st = rec["stats"]
    gemm = "packed_bitserial_matmul" if packed else "bitserial_matmul"
    want = {"act_quant": 4 * layers + 1, gemm: 7 * layers + 1}
    for delta in rec["prefill"]:
        got = {k: v for k, v in delta.items() if v}
        if got != want:
            raise AssertionError(f"{label}: a prefill launched {got}, "
                                 f"wanted {want}")
    for delta in rec["resume"]:
        if any(delta.values()):
            raise AssertionError(f"{label}: a resume launched {delta}")
    if (st.prefills, st.preemptions, st.resumes) != (
            9, len(OVERLOAD_PREEMPTS), len(OVERLOAD_PREEMPTS)):
        raise AssertionError(f"{label}: {st.prefills} prefills, "
                             f"{st.preemptions} preemptions, {st.resumes} "
                             "resumes")
    if not any(m[0] != m[1] for m in rec["moves"].values()):
        raise AssertionError(f"{label}: no request resumed in another slot")
    if rec["spill_left"]:
        raise AssertionError(f"{label}: spill dirs left: "
                             f"{rec['spill_left']}")
    log(f"[{label}] {len(rec['prefill'])} prefills launched {want} each, "
        f"{len(rec['resume'])} resumes launched nothing; slots (from, to): "
        f"{rec['moves']}")


class _SyncSpy:
    """Counts the device syncs made while installed: torch.cuda.synchronize,
    Event.synchronize and Event.elapsed_time."""

    def __enter__(self):
        import torch
        self.calls = 0
        self._saved = [(torch.cuda, "synchronize"),
                       (torch.cuda.Event, "synchronize"),
                       (torch.cuda.Event, "elapsed_time")]
        self._saved = [(o, n, getattr(o, n)) for o, n in self._saved]
        for obj, name, fn in self._saved:
            setattr(obj, name, self._counting(fn))
        return self

    def _counting(self, fn):
        def counted(*a, **k):
            self.calls += 1
            return fn(*a, **k)
        return counted

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def _overload_requests(vocab: int):
    """Phase 4d (b)'s stream, the shape of the reference command line's
    --slo --preempt --shed stream (--requests 12, --max-new 16,
    --decode-chunk 8): every 3rd request urgent (deadline 20 ticks, 4
    tokens, submitted once the clock reaches 16; the last one 48 tokens,
    which no tier serves in time), the others best-effort with 48 tokens;
    tenants "a" and "b" in turn."""
    import numpy as np
    from repro_torch.serve.request import Request
    rng = np.random.default_rng(3)
    urgent = [i for i in range(12) if i % 3 == 2]
    reqs = []
    for i in range(12):
        reqs.append(Request(
            uid=i, prompt=rng.integers(0, vocab, size=int(rng.integers(
                16, 65)), dtype=np.int64).astype(np.int32),
            max_new_tokens=(48 if i not in urgent or i == urgent[-1] else 4),
            tier=list(TIERS)[i % 3], deadline=20.0 if i in urgent else None,
            tenant="ab"[i % 2]))
    return reqs


def _serve_overload(model, params, rt, reqs, policy) -> dict:
    """Submit the best-effort requests, the urgent ones once the clock
    reaches two chunks, and step until idle."""
    from repro_torch.kernels import _build
    from repro_torch.serve import engine as engine_mod
    eng = engine_mod.ServeEngine(model, params, rt, scheduler_policy=policy,
                                 **MIXED_KW)
    held = [r for r in reqs if r.deadline is not None]
    handles = {r.uid: eng.submit(r) for r in reqs if r.deadline is None}
    _build.reset_launches()
    sync()
    t0 = time.perf_counter()
    while eng.has_work or held:
        eng.step()
        if held and (eng.clock >= 2 * MIXED_KW["decode_chunk"]
                     or not eng.has_work):
            handles.update({r.uid: eng.submit(r) for r in held})
            held = []
    sync()
    return {"handles": handles, "stats": eng.stats,
            "wall_s": time.perf_counter() - t0,
            "launches": dict(_build.LAUNCHES)}


def _overload_policy(cfg, model, params, rt, sched, card: str) -> None:
    """Phase 4d (b): the overload policy against an uninterrupted run."""
    import dataclasses

    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.handle import RequestStatus
    from repro_torch.serve.scheduler import SLOPolicy
    oreqs = _overload_requests(cfg.vocab_size)
    policy = SLOPolicy(sched, mac_counts=cfg.quant_layer_macs(),
                       preempt_slack=2.0 * MIXED_KW["decode_chunk"],
                       **OVERLOAD_POLICY)
    over = _serve_overload(model, params, rt, oreqs, policy)
    plain = _serve(engine_mod.ServeEngine(model, params, rt, **MIXED_KW),
                   [dataclasses.replace(r, deadline=None) for r in oreqs],
                   "overload-uninterrupted")["tokens"]
    finished = {u: h.tokens for u, h in over["handles"].items()
                if h.status is RequestStatus.FINISHED}
    _check_same("overload-policy", finished,
                {u: plain[u] for u in finished}, "the uninterrupted run's")
    st = over["stats"]
    counters = {k: getattr(st, k) for k in (
        "preemptions", "resumes", "sheds", "time_slice_preemptions",
        "spill_bytes", "prefills", "decode_steps")}
    if not (st.sheds and st.time_slice_preemptions
            and st.preemptions == st.resumes):
        raise AssertionError(f"overload-policy: counters {counters}")
    log("[overload] policy " + json.dumps({
        **counters, "finished": len(finished),
        "shed_uids": sorted(u for u, h in over["handles"].items()
                            if h.status is RequestStatus.SHED),
        "layers": cfg.num_layers, "wall_s": over["wall_s"], "card": card}))


def phase_overload(tiers: dict, card: str) -> dict:
    """Phase 4d: preemption, spill and resume and the telemetry on the
    phase-4c model and schedule; at 4 layers the plain replays and the
    overload policy."""
    import torch
    from repro_torch import telemetry as telemetry_mod
    from repro_torch.configs import get_config
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.models.layers import Runtime
    from repro_torch.telemetry import Telemetry
    sched = uniform_schedule(TIERS, backend="cuda", kv_tiers=KV_TIERS)
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    layers = get_config("qwen3-8b").num_layers
    cfg, model, params = _build_model(layers, sched.prepare_policy(),
                                      superplane=True, seed=0)
    reqs = _requests(9, cfg.vocab_size, 16, list(TIERS), seed=1)
    # The same migration without preemption, telemetry off: no hook, no
    # sync by the engine.
    hooks = telemetry_mod.HOOK_CALLS
    with _SyncSpy() as spy:
        ref = _preempt_schedule(model, params, rt, reqs, preempt=False)
    if telemetry_mod.HOOK_CALLS != hooks or spy.calls:
        raise AssertionError(
            f"telemetry off: {telemetry_mod.HOOK_CALLS - hooks} hook calls, "
            f"{spy.calls} device syncs")
    log(f"[overload] telemetry off: 0 hook calls, 0 device syncs in a "
        "full-width run")
    moved = OVERLOAD_MIGRATE[0]
    _check_same("overload-migrated", {u: t for u, t in ref["tokens"].items()
                                      if u != moved},
                {u: t for u, t in tiers["streams"].items() if u != moved},
                "phase tiers' (all but the migrated uid)")
    # (a) The preemptions, timed.
    run = _preempt_schedule(model, params, rt, reqs, preempt=True,
                            timed=True)
    _check_same("overload-preempt", run["tokens"], ref["tokens"],
                "the uninterrupted run's")
    _check_schedule("overload-preempt", run, layers)
    _check_launches("overload", run["launches"],
                    used=[k for k, v in PATH_OF.items() if v == "mixed"],
                    unused=("packed_bitserial_matmul", "grouped_matmul"))
    timing = {"snapshot_bytes": run["nbytes"],
              "preempt_ms": {u: ms for u, ms in run["preempt_ms"].items()
                             if u != OVERLOAD_SPILLED},
              "resume_ms": run["resume_ms"],
              "spill_write_ms": run["preempt_ms"][OVERLOAD_SPILLED],
              "spill_read_ms": run["read_ms"], "card": card}
    log("[overload] " + json.dumps(timing))
    # (c) The same with profiled telemetry.
    tele = Telemetry(profile=True)
    prof_run = _preempt_schedule(model, params, rt, reqs, preempt=True,
                                 telemetry=tele)
    _check_same("overload-telemetry", prof_run["tokens"], run["tokens"],
                "the preemption run's without telemetry")
    prof = tele.profiler.snapshot()
    counts = prof["decode_dispatches"]
    step_launches = (4 * layers + 1) + (7 * layers + 1) + layers
    if not counts or set(counts.values()) != {step_launches} or not any(
            label.count("+") == 2 for label in counts):
        raise AssertionError(f"decode_dispatch_count per layout: {counts}, "
                             f"wanted {step_launches} at every layout, a "
                             "three-tier one among them")
    chunk = prof["phases"]["decode_chunk"]
    log("[overload] profiler " + json.dumps({
        "decode_chunks": chunk["calls"],
        "decode_chunk_wall_s": chunk["total_s"],
        "decode_chunk_device_s": chunk["device_s"],
        "device_over_wall": chunk["device_s"] / chunk["total_s"],
        "engine_decode_s": prof_run["stats"].decode_seconds,
        "decode_dispatches": counts, "phases": prof["phases"],
        "card": card}))
    out_dir = ROOT / "build" / "overload"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "metrics.prom").write_text(tele.prometheus())
    tele.write_trace(str(out_dir / "trace.json"))
    log(f"[overload] wrote {out_dir / 'metrics.prom'} and "
        f"{out_dir / 'trace.json'} ({len(tele.tracer.chrome_events())} "
        "events)")
    del ref, prof_run
    launches = run["launches"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (d) At 4 layers, both stores: (a) and (c) on the plain backend launch
    # nothing and give the kernels' streams.
    plain_sched = uniform_schedule(TIERS, backend="decomposed",
                                   kv_tiers=KV_TIERS)
    rt_plain = Runtime(policy=plain_sched.policy_for(), schedule=plain_sched)
    for packed in (False, True):
        label = f"overload-4-{'packed' if packed else 'planes'}"
        cfg4, model4, params4 = _build_model(4, sched.prepare_policy(),
                                             superplane=True, seed=0,
                                             packed=packed)
        if not packed:
            # (b): the scheduler prices tiers relative to each other, the
            # same at any depth of identical layers.
            _overload_policy(cfg4, model4, params4, rt, sched, card)
        runs = {}
        for name, r in (("cuda", rt), ("plain", rt_plain)):
            runs[name] = _preempt_schedule(model4, params4, r, reqs,
                                           preempt=True)
            if name == "cuda":
                _check_schedule(f"{label}-{name}", runs[name], 4, packed)
            t = Telemetry(profile=True)
            again = _preempt_schedule(model4, params4, r, reqs, preempt=True,
                                      telemetry=t)
            _check_same(f"{label}-{name}-telemetry", again["tokens"],
                        runs[name]["tokens"], "the run without telemetry")
            if name == "plain" and any(
                    _gemm_launches(again["launches"]).values()):
                raise AssertionError(f"{label}: the plain run with "
                                     "telemetry launched kernels")
        _check_plain(label, {"stats": {"launches": runs["plain"]["launches"]},
                             "tokens": runs["plain"]["tokens"]},
                     {"tokens": runs["cuda"]["tokens"]})
        del model4, params4, runs
    return {"launches": launches, **timing}


# --------------------------------------------------------------- phase 4e
MAMBA2, LLAMA4, JAMBA = ("mamba2-1.3b", "llama4-scout-17b-a16e",
                         "jamba-1.5-large-398b")
LLAMA4_LAYERS = 4
# Quantized weights of each store, counted from the configs' shapes
# (PERF.md, phase 4e's prediction): mamba2-1.3b at its 48 layers, llama4
# at 4 of its 48 (16 routed experts and the shared one per layer).
ARCH_WEIGHTS = {MAMBA2: 1_342_701_568, LLAMA4: 9_843_507_200}
ARCH_USED = ("act_quant", "act_quant_rows", "bitserial_matmul",
             "grouped_dequant_matmul")
ARCH_USED_PACKED = ("act_quant", "act_quant_rows", "packed_bitserial_matmul",
                    "grouped_dequant_matmul")


def _store_size(params) -> tuple:
    """(quantized weights, store bytes) of a prepared params tree; an
    expert-stacked weight counts every expert."""
    from repro_torch.kernels import ops
    weights = nbytes = 0
    stack = [params]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, list):
            stack.extend(t)
        elif isinstance(t, ops.QuantizedWeight):
            store = t.packed if t.packed is not None else t.planes
            nbytes += store.numel() * store.element_size()
            weights += store.numel() // (1 if t.packed is not None
                                         else store.shape[-3])
    return weights, nbytes


def _dispatches_per_step(cfg) -> int:
    """Kernel launches of one mixed-tier decode step, from the code: two
    (kernel 2's act-quant, kernel 4's GEMM) per projection input and one
    kernel 4 per further projection reading it (q/k/v share one
    act-quant, and so do an MLP's or an expert's gate and up), one decode
    attention per attention layer, plus the head's two.  Every expert
    runs every step (capacity dispatch)."""
    per = {"attn": 7, "mamba": 4, "mlp": 5, None: 0,
           "moe": 5 * cfg.num_experts + (5 if cfg.shared_expert else 0)}
    return cfg.n_periods * sum(per[m] + per[f]
                               for m, f in cfg.period_pattern()) + 2


def _add_launches(total: dict, res: dict) -> None:
    for k, v in res["stats"]["launches"].items():
        total[k] = total.get(k, 0) + v


def _check_dispatches(label: str, eng, cfg) -> int:
    """``decode_dispatch_count`` at a three-tier layout equals the count
    derived from the code."""
    names = list(TIERS)
    groups = eng._group_layout([names[i % len(names)]
                                for i in range(eng.max_batch)])[0]
    n = eng.decode_dispatch_count(groups=groups)
    want = _dispatches_per_step(cfg)
    if n != want:
        raise AssertionError(f"{label}: decode_dispatch_count {n}, the code "
                             f"gives {want}")
    log(f"[{label}] decode_dispatch_count at {groups}: {n} (derived: {want})")
    return n


def _ssm_preempt(model, params, rt, reqs, label: str) -> dict:
    """Serve ``reqs``; after the first round preempt uid 0 (an SSM slot
    mid-decode).  The waiting request takes its slot, so uid 0 resumes
    prefill-free in another one.  Returns the streams, the snapshot bytes,
    the slots left and resumed in, and each resume's kernel launches."""
    from repro_torch.serve import engine as engine_mod
    eng = engine_mod.ServeEngine(model, params, rt, **MIXED_KW)
    deltas, moves = [], []
    resume = eng._resume_into

    def resuming(slot, req, sus):
        moves.append(slot)
        return resume(slot, req, sus)
    eng._resume_into = _launch_delta(resuming, deltas)
    handles = {r.uid: eng.submit(r) for r in reqs}
    eng.step()
    left = handles[0].slot
    sync()
    t0 = time.perf_counter()
    sus = eng.preempt(0)
    preempt_ms = 1e3 * (time.perf_counter() - t0)
    out = eng.drain()
    if moves == [left] or len(moves) != 1:
        raise AssertionError(f"{label}: uid 0 left slot {left}, resumed in "
                             f"{moves}")
    if any(v for d in deltas for v in d.values()):
        raise AssertionError(f"{label}: a resume launched kernels: {deltas}")
    rec = {"nbytes": sus.nbytes, "slots": [left] + moves,
           "preempt_ms": preempt_ms}
    log(f"[{label}] " + json.dumps(rec))
    return {**rec, "tokens": out}


def _arch_plain_replay(label: str, model, params, reqs, spec: bool) -> None:
    """Serve ``reqs`` (``spec``: uid % 3 != 2 speculating) on ``cuda`` and
    on the plain ``decomposed`` backend: equal streams, the plain run
    launching nothing."""
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import engine as engine_mod
    runs = {}
    for backend in ("cuda", "decomposed"):
        sched = uniform_schedule(TIERS, backend=backend)
        eng = engine_mod.ServeEngine(model, params, Runtime(
            policy=sched.policy_for(), schedule=sched), **MIXED_KW)
        runs[backend] = _serve(eng, _variant(reqs, spec=spec, sampled=False),
                               f"{label}-{backend}")
    _check_launches(label, runs["cuda"]["stats"]["launches"], ARCH_USED, ())
    _check_plain(label, runs["decomposed"], runs["cuda"])
    return runs


def phase_archs(card: str) -> dict:
    """Phase 4e: the SSM, hybrid and MoE layers served on the card."""
    import tempfile

    import torch
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import engine as engine_mod
    sched = uniform_schedule(TIERS, backend="cuda")
    rt = Runtime(policy=sched.policy_for(), schedule=sched)
    launches: dict = {}
    res_out: dict = {"card": card}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) mamba2-1.3b, full width and depth: int8 planes, greedy
    # speculation, a preemption, then the packed store.
    cfg, model, params = _build_model(None, sched.prepare_policy(),
                                      superplane=True, seed=0, arch=MAMBA2)
    weights, nbytes = _store_size(params)
    if weights != ARCH_WEIGHTS[MAMBA2]:
        raise AssertionError(f"mamba2: {weights} quantized weights, the "
                             f"shapes give {ARCH_WEIGHTS[MAMBA2]}")
    reqs = _requests(9, cfg.vocab_size, 16, list(TIERS), seed=1)
    eng = engine_mod.ServeEngine(model, params, rt, **MIXED_KW)
    plain = _serve(eng, reqs, "archs-mamba2")
    _check_streams("archs-mamba2", plain["tokens"], reqs, cfg.padded_vocab)
    _check_launches("archs-mamba2", plain["stats"]["launches"], ARCH_USED,
                    ("packed_bitserial_matmul", "grouped_matmul"))
    if eng.stats.mixed_tier_chunks == 0:
        raise AssertionError("archs-mamba2: no decode chunk mixed tiers")
    _add_launches(launches, plain)
    m2 = {"store_weights": weights, "store_bytes": nbytes,
          "dispatches": _check_dispatches("archs-mamba2", eng, cfg),
          "planes": plain["stats"]}
    del eng
    eng = engine_mod.ServeEngine(model, params, rt, **MIXED_KW)
    spec = _serve(eng, _variant(reqs, spec=True, sampled=False),
                  "archs-mamba2-spec")
    _check_same("archs-mamba2-spec", spec["tokens"], plain["tokens"],
                "the plain (non-speculative) streams")
    _add_launches(launches, spec)
    m2["spec"] = {**spec["stats"], **_spec_stats(eng)}
    del eng
    pre = _ssm_preempt(model, params, rt, reqs, "archs-mamba2-preempt")
    _check_same("archs-mamba2-preempt", pre["tokens"], plain["tokens"],
                "the uninterrupted streams")
    m2["preempt"] = {k: pre[k] for k in ("nbytes", "slots", "preempt_ms")}
    del model, params
    free()
    cfg, model, params = _build_model(None, sched.prepare_policy(),
                                      superplane=True, seed=0, arch=MAMBA2,
                                      packed=True)
    m2["packed_store_bytes"] = _store_size(params)[1]
    eng = engine_mod.ServeEngine(model, params, rt, **MIXED_KW)
    packed = _serve(eng, reqs, "archs-mamba2-packed")
    _check_launches("archs-mamba2-packed", packed["stats"]["launches"],
                    ARCH_USED_PACKED, ("bitserial_matmul", "grouped_matmul"))
    _check_same("archs-mamba2-packed", packed["tokens"], plain["tokens"],
                "the int8-plane store's")
    _add_launches(launches, packed)
    m2["packed"] = packed["stats"]
    res_out[MAMBA2] = m2
    del eng, model, params
    free()

    # (b) llama4-scout at full width, cut to LLAMA4_LAYERS layers: planes,
    # then the packed store of the same seed.
    l4: dict = {}
    streams = None
    for store in ("planes", "packed"):
        cfg, model, params = _build_model(
            LLAMA4_LAYERS, sched.prepare_policy(), superplane=True, seed=0,
            arch=LLAMA4, packed=store == "packed")
        if store == "planes":
            log(f"[archs-llama4] reduced: num_layers 48→{LLAMA4_LAYERS}")
        weights, nbytes = _store_size(params)
        if weights != ARCH_WEIGHTS[LLAMA4]:
            raise AssertionError(f"llama4: {weights} quantized weights, the "
                                 f"shapes give {ARCH_WEIGHTS[LLAMA4]}")
        reqs = _requests(9, cfg.vocab_size, 16, list(TIERS), seed=1)
        eng = engine_mod.ServeEngine(model, params, rt, **MIXED_KW)
        res = _serve(eng, reqs, f"archs-llama4-{store}")
        _check_streams(f"archs-llama4-{store}", res["tokens"], reqs,
                       cfg.padded_vocab)
        _check_launches(f"archs-llama4-{store}", res["stats"]["launches"],
                        ARCH_USED if store == "planes" else ARCH_USED_PACKED,
                        ("grouped_matmul",))
        if streams is None:
            streams = res["tokens"]
        _check_same(f"archs-llama4-{store}", res["tokens"], streams,
                    "the int8-plane store's")
        _add_launches(launches, res)
        l4[store] = {**res["stats"], "store_weights": weights,
                     "store_bytes": nbytes,
                     "dispatches": _check_dispatches(
                         f"archs-llama4-{store}", eng, cfg)}
        del eng, model, params
        free()
    res_out[LLAMA4] = l4

    # (c) Against the plain replay: the reduced jamba (attention, Mamba,
    # MLP and MoE layers; plain and speculative, and a spilled hybrid
    # snapshot) and llama4 at one layer of full width.
    cfg, model, params = _build_model(None, sched.prepare_policy(),
                                      superplane=True, seed=0, arch=JAMBA,
                                      reduced=True)
    reqs = _requests(9, cfg.vocab_size, 16, list(TIERS), seed=1)
    jb = {}
    for spec in (False, True):
        runs = _arch_plain_replay(f"archs-jamba-{'spec' if spec else 'plain'}",
                                  model, params, reqs, spec)
        if spec:
            _check_same("archs-jamba-spec", runs["cuda"]["tokens"],
                        jb["plain"]["tokens"], "the plain streams")
        jb["spec" if spec else "plain"] = runs["cuda"]
    with tempfile.TemporaryDirectory() as spill:
        eng = engine_mod.ServeEngine(model, params, rt, spill_dir=spill,
                                     **MIXED_KW)
        handles = {r.uid: eng.submit(r) for r in reqs}
        eng.step()
        sus = eng.preempt(1)
        eng._spiller.wait()
        spilled = os.listdir(spill)
        out = eng.drain()
        if not spilled or os.listdir(spill) or eng.stats.resumes != 1:
            raise AssertionError(f"archs-jamba-spill: spilled {spilled}, "
                                 f"left {os.listdir(spill)}")
        _check_same("archs-jamba-spill", out, jb["plain"]["tokens"],
                    "the uninterrupted streams")
        log(f"[archs-jamba-spill] snapshot {sus.nbytes} B spilled to "
            f"{spilled} and restored; streams equal")
        del eng, handles
    res_out[JAMBA] = {k: v["stats"] for k, v in jb.items()}
    del model, params
    free()
    cfg, model, params = _build_model(1, sched.prepare_policy(),
                                      superplane=True, seed=0, arch=LLAMA4)
    reqs = _requests(4, cfg.vocab_size, 8, list(TIERS), seed=1)
    _arch_plain_replay("archs-llama4-1", model, params, reqs, False)
    del model, params
    free()
    res_out["launches"] = launches
    log("[archs] " + json.dumps({k: v for k, v in res_out.items()
                                 if k != "launches"}, default=str))
    return res_out




# --------------------------------------------------------------- phase 4f
# The simulators' check on the card: (w_bits, a_bits), each with weights
# and activations signed and then unsigned, at B x R x C.
SIM_BITS = ((8, 8), (6, 8), (4, 4), (2, 2))
SIM_SHAPE = (8, 4096, 1024)
# The profile: calibration 2 x 2 x 16 from seed 1 (the CLI's defaults),
# widths 2, 4, 6, one-pass blocks of 8 probes; (c) probes these layers.
PROFILE_CALIB = dict(batches=2, batch=2, seq=16, seed=1)
PROFILE_CHOICES = (2, 4, 6)
PROFILE_NAMES = ("layers.pos0.attn.q_proj", "layers.pos0.mlp.down_proj",
                 "lm_head")
# Every probe and both serving tiers run 8-bit activations, so a grouped
# projection quantizes its input with kernel 1 (one config: the shared
# path of ops.quantize_activations_grouped) and runs kernel 4; kernel 2
# takes mixed activation widths only.
AUTOPREC_BATCHED = ("act_quant", "grouped_dequant_matmul")
AUTOPREC_SEQUENTIAL = ("act_quant", "bitserial_matmul")
AUTOPREC_SERVE = ("act_quant", "bitserial_matmul", "grouped_dequant_matmul")
# Launches of one full-width qwen3-8b forward (as a prefill: 145 and 253).
FORWARD_ACT_QUANTS, FORWARD_GEMMS = 145, 253


def _kernel3_product(a, w, w_bits: int, w_signed: bool):
    """``a @ w`` through kernel 3 on the LSB-first planes of
    ``decompose_weights`` with their shifts.  Kernel 3 reads int8
    activations: an unsigned 8-bit ``a`` splits into lo + 128 * hi (lo in
    [0, 127], hi in {0, 1}), two launches."""
    import torch
    from repro_torch.core import decompose
    from repro_torch.kernels import bitserial_matmul as bsm
    planes = decompose.decompose_weights(w, w_bits,
                                         signed=w_signed).contiguous()
    shifts = decompose.plane_shifts(w_bits, w_signed)
    if int(a.max()) <= 127:
        return bsm.bitserial_matmul(a.to(torch.int8).contiguous(), planes,
                                    shifts)
    lo = (a & 127).to(torch.int8).contiguous()
    hi = (a >> 7).to(torch.int8).contiguous()
    return (bsm.bitserial_matmul(lo, planes, shifts)
            + (bsm.bitserial_matmul(hi, planes, shifts) << 7))


def _simulators() -> list:
    """4f (a): the array simulator, Eq. (1) and kernel 3 against the exact
    int64 product on the same operands."""
    import dataclasses

    import torch
    from repro_torch.core import bitserial, decompose, pe_array
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    b, r, c = SIM_SHAPE
    cfg = pe_array.PEArrayConfig()
    rows = []
    log(f"[autoprec-sim] B={b} R={r} C={c}; stats and TOPS are the paper's "
        f"modeled 28 nm 64x64 array at {cfg.clk_mhz:.0f} MHz (hwmodel), "
        "not a speed of this card")
    for w_bits, a_bits in SIM_BITS:
        for signed in (True, False):
            alo, ahi = decompose.weight_range(a_bits, signed)
            wlo, whi = decompose.weight_range(w_bits, signed)
            a = torch.randint(alo, ahi + 1, (b, r), dtype=torch.int32,
                              device="cuda", generator=gen)
            w = torch.randint(wlo, whi + 1, (r, c), dtype=torch.int32,
                              device="cuda", generator=gen)
            exact = a.cpu().to(torch.int64) @ w.cpu().to(torch.int64)
            sync()
            t0 = time.perf_counter()
            sim, stats = pe_array.pe_array_matmul(
                a, w, w_bits=w_bits, a_bits=a_bits, a_signed=signed,
                w_signed=signed)
            sync()
            sim_s = time.perf_counter() - t0
            mac = bitserial.bitserial_mac(a, w, a_bits, w_bits,
                                          a_signed=signed, w_signed=signed)
            k3 = _kernel3_product(a, w, w_bits, signed)
            for label, got in (("pe_array_matmul", sim),
                               ("bitserial_mac", mac), ("kernel 3", k3)):
                if got.dtype != torch.int32 or not torch.equal(
                        got.cpu().to(torch.int64), exact):
                    raise AssertionError(
                        f"autoprec-sim w{w_bits} a{a_bits} signed={signed}: "
                        f"{label} differs from the exact int64 product")
            row = {"w_bits": w_bits, "a_bits": a_bits, "signed": signed,
                   "stats": dataclasses.asdict(stats),
                   "modeled_macs_per_cycle": stats.macs_per_cycle,
                   "modeled_tops": stats.tops(cfg.clk_mhz),
                   "modeled_peak_tops": pe_array.peak_tops(cfg, w_bits,
                                                           a_bits),
                   "simulator_s_on_card": sim_s}
            log("[autoprec-sim] equal to the exact product (simulator, "
                "Eq. (1), kernel 3): " + json.dumps(row))
            rows.append(row)
    return rows


def _autoprec_parity() -> None:
    """4f: kernels 1, 3 and 4 against their plain versions at the path's
    new shapes (tolerance 0): kernel 4 at the profiler's M = 288 (nine
    groups of 32, one probe group at 1, 2 or 3 planes) and the joint
    measurement's M = 160, kernel 1 at M = 288, kernel 3 at M = 32."""
    import torch
    from repro_torch.core import decompose
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    checked = 0

    def same(label, got, want):
        nonlocal checked
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if not torch.equal(g, w):
                raise AssertionError(f"autoprec-parity {label}: kernel "
                                     "differs from its plain version")
        checked += 1

    for k in (4096, 12288):
        xb = torch.randn((288, k), device="cuda", generator=gen
                         ).to(torch.bfloat16)
        same(f"act_quant M=288 K={k}", aq.act_quant(xb),
             ref.act_quant_ref(xb))
    for m, k, n in ((288, 4096, 12288), (288, 4096, 152064),
                    (160, 4096, 12288)):
        x, planes = _inputs(m, k, n, gen)
        for p in (1, 2, 3):
            layout = tuple((32, p if g == 1 else 4) for g in range(m // 32))
            mult, xs, ws, rg = _grouped_args(layout, n, gen)
            same(f"grouped_dequant_matmul M={m} K={k} N={n} {layout}",
                 gmm.grouped_dequant_matmul(x, planes, mult, xs, ws, rg),
                 ref.grouped_dequant_matmul_ref(x, planes, mult, xs, ws, rg))
        if m == 288:
            for p in (4, 1):
                sh = decompose.prefix_shifts(p)
                same(f"bitserial_matmul M=32 K={k} N={n} P={p}",
                     bsm.bitserial_matmul(x[:32], planes[:p], sh),
                     ref.bitserial_matmul_ref(x[:32], planes[:p], sh))
        del x, planes
        torch.cuda.empty_cache()
    log(f"[autoprec-parity] {checked} kernel calls at the path's shapes "
        "equal their plain versions")


def _profiled(label: str, fn, used, unused) -> tuple:
    """``fn()`` with the launches of exactly this run, its seconds and
    peak memory."""
    import torch
    from repro_torch.kernels import _build
    torch.cuda.reset_peak_memory_stats()
    sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    sync()
    res = {"s": time.perf_counter() - t0, "launches": dict(_build.LAUNCHES),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    _check_launches(label, res["launches"], used=used, unused=unused)
    log(f"[{label}] " + json.dumps(res, sort_keys=True))
    return out, res


def _same_profile(label: str, got, want) -> None:
    if got.kl != want.kl or got.mse != want.mse:
        raise AssertionError(f"{label}: profiles differ:\n{got.kl}\n"
                             f"{want.kl}")
    log(f"[{label}] kl and mse equal bit for bit")


def _staged(module, names, stages: dict):
    """Wrap the functions ``names`` of ``module`` (a command line's own
    references) so that each call records its seconds, launches (a delta
    of the counts, which it leaves running) and peak memory under
    ``stages[name]``; returns the undo."""
    import torch
    from repro_torch.kernels import _build
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def run(*args, **kwargs):
            torch.cuda.reset_peak_memory_stats()
            sync()
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            stages[name] = {
                "s": time.perf_counter() - t0,
                "launches": {k: v - before[k]
                             for k, v in _build.LAUNCHES.items()},
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            return out
        return run
    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))

    def undo():
        for n, fn in saved.items():
            setattr(module, n, fn)
    return undo


def _check_forwards(label: str, launches: dict, forwards: int) -> None:
    """``forwards`` full-width forwards' launches of kernels 1 and 4."""
    want = (forwards * FORWARD_ACT_QUANTS, forwards * FORWARD_GEMMS)
    if (launches["act_quant"], launches["grouped_dequant_matmul"]) != want:
        raise AssertionError(f"{label}: {launches} for {forwards} forwards")


def _serve_cli_requests(n: int, vocab: int, max_new: int, tiers, seed: int):
    """The stream ``launch/serve.py`` submits without ``--slo``: prompts of
    4 + i % 5 tokens from ``seed``, budgets 1 + max_new * (i % 4) // 3,
    tiers round-robin."""
    import numpy as np
    from repro_torch.serve.request import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, vocab, size=4 + i % 5
                                               ).astype(np.int32),
                    max_new_tokens=1 + (max_new * (i % 4)) // 3,
                    tier=tiers[i % len(tiers)])
            for i in range(n)]


def phase_autoprec(card: str) -> dict:
    """Phase 4f: the array simulators on the card, then the hardware-aware
    precision search on full-width qwen3-8b through its command line, the
    schedule file it writes, and serving that file through the serving
    command line."""
    import dataclasses

    import torch
    from repro_torch.autoprec import (load_schedule, measure_divergence,
                                      profile_sensitivity,
                                      random_calibration, relaxed_search,
                                      result_to_meta, schedule_from_results)
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.kernels import _build
    from repro_torch.launch import autoprec as autoprec_cli
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import engine as engine_mod
    out: dict = {"card": card, "simulators": _simulators()}
    _autoprec_parity()
    launches: dict = {}

    def add(res):
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v

    all_kernels = tuple(KERNELS)
    off_batched = [k for k in all_kernels if k not in AUTOPREC_BATCHED]
    path = ROOT / "build" / "autoprec" / "schedule.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    # (b), (e) The command line at full width: profile (8 names x 3 widths
    # = 24 probes, 3 one-pass blocks x 2 calibration batches = 6 forwards
    # of (8 + 1) * 2 * 16 = 288 rows), search, joint measurement of the
    # spread front (blocks of 4: 5 * 2 * 16 = 160 rows), the file.
    argv = ["--arch", "qwen3-8b",
            "--choices", *map(str, PROFILE_CHOICES),
            "--calib-batches", str(PROFILE_CALIB["batches"]),
            "--calib-batch", str(PROFILE_CALIB["batch"]),
            "--calib-len", str(PROFILE_CALIB["seq"]),
            "--seed", "0", "--block", "8",
            "--eval-top", "6", "--backend", "cuda", "--device", "cuda",
            "--out", str(path)]
    log("[autoprec-cli] python -m repro_torch.launch.autoprec "
        + " ".join(argv))
    stages: dict = {}
    undo = _staged(autoprec_cli, ("profile_sensitivity", "search",
                                  "measure_divergence"), stages)
    sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        got = autoprec_cli.main(argv)
    finally:
        undo()
    sync()
    cli = {"s": time.perf_counter() - t0, "launches": dict(_build.LAUNCHES),
           "stages": stages}
    log("[autoprec-cli] " + json.dumps(cli, sort_keys=True))
    _check_launches("autoprec-cli", cli["launches"], AUTOPREC_BATCHED,
                    off_batched)
    add(cli)
    prof, cost = got["profile"], got["cost"]
    front, selected, schedule = got["front"], got["selected"], \
        got["schedule"]
    pts = [r for r in front if r.measured_divergence is not None]
    n_fwd = -(-len(prof.layers) * len(PROFILE_CHOICES) // 8) \
        * PROFILE_CALIB["batches"]
    n_meas = -(-len(pts) // 4) * PROFILE_CALIB["batches"]
    _check_forwards("autoprec-profile", stages["profile_sensitivity"][
        "launches"], n_fwd)
    _check_forwards("autoprec-measure", stages["measure_divergence"][
        "launches"], n_meas)
    if any(stages["search"]["launches"].values()):
        raise AssertionError("autoprec-search launched kernels")
    values = [v for t in (prof.kl, prof.mse) for n in t for v in t[n].values()]
    if not all(v >= 0.0 and v == v and v != float("inf") for v in values):
        raise AssertionError("autoprec-profile: a divergence is negative "
                             "or not finite")
    log("[autoprec-profile] kl " + json.dumps(prof.kl))
    relaxed = {dev: [dataclasses.asdict(r) for r in relaxed_search(
        prof.table, cost, choices=PROFILE_CHOICES, device=dev)]
        for dev in ("cuda", "cpu")}
    if relaxed["cuda"] != relaxed["cpu"]:
        raise AssertionError("autoprec-search: relaxed_search on the card "
                             "differs from the CPU's")
    loaded = load_schedule(str(path))
    if loaded != schedule or list(loaded.tier_names) != ["auto", "base"]:
        raise AssertionError("autoprec: the loaded schedule differs from the "
                             "command line's")
    log("[autoprec-search] " + json.dumps({
        "front": len(front), "relaxed_points": len(relaxed["cuda"]),
        "measured": [result_to_meta(r) for r in pts],
        "uniform8_cycles_per_token": cost.uniform_cycles(8),
        "selected": result_to_meta(selected)}))
    out["profile"] = {**stages["profile_sensitivity"], "forwards": n_fwd,
                      "rows": 9 * 2 * 16, "kl": prof.kl}
    out["search"] = {"search_s": stages["search"]["s"],
                     "measure": {**stages["measure_divergence"],
                                 "forwards": n_meas},
                     "cli_s": cli["s"], "selected": result_to_meta(selected),
                     "uniform8_cycles_per_token": cost.uniform_cycles(8)}
    del got
    gc.collect()
    torch.cuda.empty_cache()
    # (c) Batched against sequential, bit for bit, on a store of the
    # command lines' seed (their calibration is from seed + 1).
    prep = uniform_schedule(TIERS, backend="cuda").prepare_policy()
    cfg, model, params = _build_model(None, prep, superplane=True, seed=0)
    calib = random_calibration(cfg, **PROFILE_CALIB)
    kw = dict(calib=calib, choices=(2, 4), layers=PROFILE_NAMES,
              backend="cuda")
    p_b, res_b = _profiled(
        "autoprec-batched", lambda: profile_sensitivity(
            model, params, batched=True, block=8, **kw), AUTOPREC_BATCHED,
        off_batched)
    p_s, res_s = _profiled(
        "autoprec-sequential", lambda: profile_sensitivity(
            model, params, batched=False, **kw), AUTOPREC_SEQUENTIAL,
        [k for k in all_kernels if k not in AUTOPREC_SEQUENTIAL])
    _same_profile("autoprec-batched-vs-sequential", p_b, p_s)
    add(res_b)
    add(res_s)
    out["batched_s"], out["sequential_s"] = res_b["s"], res_s["s"]
    # (f) Serve it: from memory, then from the loaded file, one store; then
    # the serving command line's requests on the same store.
    reqs = _requests(9, cfg.vocab_size, 16, list(schedule.tier_names),
                     seed=1)
    cli_reqs = _serve_cli_requests(9, cfg.vocab_size, 16,
                                   list(loaded.tier_names), seed=0)
    calls = engine_mod.PREPARE_CALLS
    runs = {}
    for label, sched, rs in (("memory", schedule, reqs),
                             ("file", loaded, reqs),
                             ("cli-requests", loaded, cli_reqs)):
        eng = engine_mod.ServeEngine(model, params, Runtime(
            policy=sched.policy_for(), schedule=sched), **MIXED_KW)
        runs[label] = _serve(eng, rs, f"autoprec-serve-{label}")
        _check_streams(f"autoprec-serve-{label}", runs[label]["tokens"],
                       rs, cfg.padded_vocab)
        _check_launches(f"autoprec-serve-{label}",
                        runs[label]["stats"]["launches"], AUTOPREC_SERVE,
                        ("packed_bitserial_matmul", "grouped_matmul"))
        if eng.stats.mixed_tier_chunks == 0:
            raise AssertionError(f"autoprec-serve-{label}: no decode chunk "
                                 "mixed tiers")
        add(runs[label]["stats"])
        del eng
    if engine_mod.PREPARE_CALLS != calls:
        raise AssertionError("autoprec-serve: prepare_params ran")
    _check_same("autoprec-serve-file", runs["file"]["tokens"],
                runs["memory"]["tokens"], "the in-memory schedule's")
    out["serve"] = runs["memory"]["stats"]
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    serve_argv = ["--arch", "qwen3-8b", "--schedule-file", str(path),
                  "--requests", str(len(cli_reqs)), "--max-new", "16",
                  "--max-batch", str(MIXED_KW["max_batch"]),
                  "--max-len", str(MIXED_KW["max_len"]),
                  "--decode-chunk", str(MIXED_KW["decode_chunk"]),
                  "--seed", "0", "--device", "cuda"]
    log("[autoprec-serve-cli] python -m repro_torch.launch.serve "
        + " ".join(serve_argv))
    sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    served = serve_cli.main(serve_argv)
    sync()
    serve_res = {"s": time.perf_counter() - t0,
                 "launches": dict(_build.LAUNCHES)}
    log("[autoprec-serve-cli] " + json.dumps(serve_res, sort_keys=True))
    _check_launches("autoprec-serve-cli", serve_res["launches"],
                    AUTOPREC_SERVE,
                    ("packed_bitserial_matmul", "grouped_matmul"))
    if engine_mod.PREPARE_CALLS != calls:
        raise AssertionError("autoprec-serve-cli: prepare_params ran")
    _check_same("autoprec-serve-cli", served,
                runs["cli-requests"]["tokens"],
                "the same requests' on the phase's store")
    add(serve_res)
    out["serve_cli"] = serve_res
    del served
    gc.collect()
    torch.cuda.empty_cache()
    # (d) and (f) at 4 layers against the plain replay.
    cfg4, model4, params4 = _build_model(4, prep, superplane=True, seed=0)
    log("[autoprec-4] depth cut: 4 of qwen3-8b's 36 layers")
    p_cuda, res4 = _profiled(
        "autoprec-4-cuda", lambda: profile_sensitivity(
            model4, params4, calib=calib, choices=PROFILE_CHOICES,
            backend="cuda"), AUTOPREC_BATCHED, off_batched)
    add(res4)
    p_plain, _ = _profiled(
        "autoprec-4-plain", lambda: profile_sensitivity(
            model4, params4, calib=calib, choices=PROFILE_CHOICES,
            backend="decomposed"), (), all_kernels)
    _same_profile("autoprec-4-cuda-vs-plain", p_cuda, p_plain)
    joint = {f"pt{i}": r.assignment for i, r in enumerate(pts)}
    m_cuda, res4m = _profiled(
        "autoprec-4-measure", lambda: measure_divergence(
            model4, params4, joint, calib=calib, backend="cuda", block=4),
        AUTOPREC_BATCHED, off_batched)
    add(res4m)
    m_plain, _ = _profiled(
        "autoprec-4-measure-plain", lambda: measure_divergence(
            model4, params4, joint, calib=calib, backend="decomposed",
            block=4), (), all_kernels)
    if m_cuda != m_plain:
        raise AssertionError(f"autoprec-4-measure: {m_cuda} != {m_plain}")
    log("[autoprec-4-measure] joint divergences equal the plain replay's: "
        + json.dumps(m_cuda))
    plain = schedule_from_results([selected], tier_names=["auto"],
                                  backend="decomposed")
    cuda4 = _serve(engine_mod.ServeEngine(model4, params4, Runtime(
        policy=schedule.policy_for(), schedule=schedule), **MIXED_KW),
        reqs, "autoprec-4-serve")
    add(cuda4["stats"])
    _check_plain("autoprec-4-serve", _serve(engine_mod.ServeEngine(
        model4, params4, Runtime(policy=plain.policy_for(), schedule=plain),
        **MIXED_KW), reqs, "autoprec-4-serve-plain"), cuda4)
    out["launches"] = launches
    log("[autoprec] launches " + json.dumps(launches))
    return out


# ------------------------------------------------------------- phase 4g
# (a) The reference's own training flags at qwen3-8b's full width, depth
# cut 36 -> 4 (f32 AdamW moments of all 36 layers would not fit one card),
# with --lr 3e-4: the default 3e-3 scaled by the ratio of the weights'
# init scales (1/sqrt(d_model)) at the reference test's width 64 and at
# 4096 (3.75e-4).  AdamW moves every weight by about lr a step, so the
# default moves a 4096-wide layer's weights by ~20 % of their scale a
# step, and the loss rises instead of falling (in both packages).
TRAIN_FULL_ARGV = ["--arch", "qwen3-8b", "--layers", "4", "--seq-len", "256",
                   "--batch", "8", "--w-bits", "4", "--a-bits", "8",
                   "--steps", "30", "--lr", "3e-4", "--device", "cuda"]
# (b) examples/train_qat.py's "full" preset (~100M parameters), 300 -> 40
# steps, a checkpoint every 20; --steps, --ckpt-every and --ckpt-dir are
# added by the phase.
TRAIN_RESUME_ARGV = ["--arch", "qwen3-8b", "--d-model", "640", "--layers",
                     "16", "--vocab", "32768", "--seq-len", "256", "--batch",
                     "16", "--accum", "4", "--w-bits", "4", "--device",
                     "cuda"]
# Checkpoint at 8, resume from it to 16: the resume path needs a save, a
# removal and a restart, not 40 steps (2.4 s a step with --accum 4).
TRAIN_RESUME_STEPS = (8, 16)
BF16_PEAK_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
# (c) card against CPU, 4 steps from one init: every step's loss within
# TRAIN_LOSS_ATOL; each LM parameter within 4 * sum(lr) + 2 bf16 ulps of
# its magnitude (two AdamW runs part by at most ~lr a step, one rounding
# each), and the card's update (final - initial weights) within
# TRAIN_UPDATE_RTOL of the CPU's in relative L2: twice the two packages'
# own disagreement on one CPU (0.18 for these flags, the jitted reference
# against the port, bf16: tests/test_torch_train.py::
# test_four_steps_track_the_jitted_reference).  AdamW's first step moves every weight by
# +-lr whatever its gradient's size, so a near-zero gradient that rounds
# to the other sign moves it the other way, and QAT's 8-bit activation
# codes flip on .5 boundaries with the summation order: runs that agree
# in every op to a few ulps part this far in 4 steps.  The ConvNet's SGD
# updates within CONV_UPDATE_RTOL (relative L2).
TRAIN_LOSS_ATOL = 2e-2
TRAIN_UPDATE_RTOL = 0.36
CONV_LOSS_RTOL = 1e-3
CONV_UPDATE_RTOL = 0.05
TRAIN_SERVE_USED = ("act_quant", "act_quant_rows", "bitserial_matmul",
                    "grouped_dequant_matmul")


def _recorded_steps(module, records: list):
    """Wrap ``module.make_train_step`` (a command line's own reference) so
    that every step it makes is fenced and records its ms and metrics;
    returns the undo."""
    saved = module.make_train_step

    def make(*args, **kwargs):
        fn = saved(*args, **kwargs)

        def step(state, batch):
            sync()
            t0 = time.perf_counter()
            state, metrics = fn(state, batch)
            sync()
            records.append({"ms": 1e3 * (time.perf_counter() - t0),
                            **{k: float(v) for k, v in metrics.items()},
                            "tokens": int(batch["labels"].numel())})
            return state, metrics
        return step
    module.make_train_step = make
    return lambda: setattr(module, "make_train_step", saved)


def _train_cli(argv, label: str) -> tuple:
    """``launch.train.main(argv)`` with every step recorded; returns (state,
    records, peak GB)."""
    import torch
    from repro_torch.launch import train as train_cli
    log(f"[{label}] python -m repro_torch.launch.train " + " ".join(argv))
    records: list = []
    undo = _recorded_steps(train_cli, records)
    torch.cuda.reset_peak_memory_stats()
    try:
        state = train_cli.main(argv)
    finally:
        undo()
    sync()
    return state, records, torch.cuda.max_memory_allocated() / 1e9


def _leaf_pairs(a, b):
    from repro_torch.train.optimizer import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        raise AssertionError("trees differ in structure")
    return list(zip(la, lb))


def _train_full(card: str) -> dict:
    """(a): 30 steps of full-width qwen3-8b (4 layers) through the command
    line on the card."""
    from repro_torch.train.optimizer import tree_leaves
    state, rec, peak = _train_cli(TRAIN_FULL_ARGV, "train-full")
    params = state["params"]
    n_all = sum(t.numel() for t in tree_leaves(params))
    n_matmul = n_all - params["embed"]["emb"].numel()
    ms = statistics.median(r["ms"] for r in rec[1:])
    tokens = rec[0]["tokens"]
    losses = [r["loss"] for r in rec]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    res = {
        "card": card, "steps": len(rec), "tokens_per_step": tokens,
        "first_step_ms": rec[0]["ms"], "step_ms": ms,
        "step_ms_min": min(r["ms"] for r in rec[1:]),
        "step_ms_max": max(r["ms"] for r in rec[1:]),
        "tokens_per_s": tokens / (ms / 1e3), "peak_mem_gb": peak,
        "params": n_all, "matmul_params": n_matmul,
        "flop_bound_ms": 6 * n_all * tokens / BF16_PEAK_FLOPS * 1e3,
        "flop_bound_ms_matmul": 6 * n_matmul * tokens / BF16_PEAK_FLOPS * 1e3,
        "loss_first5": losses[:5], "loss_last5": losses[-5:],
        "loss_ratio": last / first,
        "grad_norm_first_last": [rec[0]["grad_norm"], rec[-1]["grad_norm"]],
    }
    res["flop_bound_share"] = res["flop_bound_ms"] / ms
    res["flop_bound_share_matmul"] = res["flop_bound_ms_matmul"] / ms
    log("[train-full] " + json.dumps(res, sort_keys=True))
    log(f"[train-full] bound: 6 * N * tokens at the card's data-sheet bf16 "
        f"peak ({BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s, dense, 700 W part): "
        f"{res['flop_bound_ms']:.2f} ms (N = all {n_all} parameters), "
        f"{res['flop_bound_ms_matmul']:.2f} ms (N = the {n_matmul} that "
        f"enter a matmul); the step takes {ms:.1f} ms")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"train-full: non-finite loss {losses}")
    if not last < first:
        raise AssertionError(f"train-full: the loss did not fall: mean of "
                             f"the first 5 {first}, of the last 5 {last}")
    log(f"[train-full] mean loss of the last 5 steps / first 5: "
        f"{res['loss_ratio']:.4f} ("
        f"{'meets' if res['loss_ratio'] < 0.85 else 'misses'} the "
        f"reference test's < 0.85 at reduced size)")
    return {"res": res, "params": params}


def _train_resume() -> dict:
    """(b): the steps straight against half + auto-resume + half, bit for
    bit."""
    import shutil

    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    directory = ROOT / "build" / "train" / "resume"
    shutil.rmtree(directory, ignore_errors=True)
    half, total = TRAIN_RESUME_STEPS
    argv = TRAIN_RESUME_ARGV + ["--steps", str(total), "--ckpt-every",
                                str(half), "--ckpt-dir", str(directory)]
    straight, rec, peak = _train_cli(argv, "train-resume")
    steps = ckpt.list_steps(str(directory))
    ckpt.remove(str(directory), total)
    resumed, rec2, _ = _train_cli(argv, "train-resume")
    differ = [i for i, (a, b) in enumerate(_leaf_pairs(straight, resumed))
              if not torch.equal(a, b)]
    res = {"steps_saved": steps, "resumed_steps": len(rec2),
           "step_ms": statistics.median(r["ms"] for r in rec[1:]),
           "peak_mem_gb": peak, "leaves": len(_leaf_pairs(straight, resumed)),
           "leaves_differing": len(differ)}
    log("[train-resume] " + json.dumps(res, sort_keys=True))
    if steps != [half, total] or len(rec2) != total - half:
        raise AssertionError(f"train-resume: saved {steps}, resumed for "
                             f"{len(rec2)} steps")
    if differ:
        raise AssertionError(f"train-resume: {len(differ)} leaves of the "
                             "resumed state differ from the uninterrupted run")
    log("[train-resume] params, moments and step of the resumed run equal "
        "the uninterrupted run's bit for bit")
    shutil.rmtree(directory, ignore_errors=True)
    return res


def _lm_on(device: str, params, steps: int) -> tuple:
    """``steps`` QAT steps of the reduced qwen3-8b on ``device`` (the
    command line's defaults: w4a8, lr 3e-3, seq 64, batch 8)."""
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.core.policy import uniform_policy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.layers import Runtime
    from repro_torch.models.transformer import LM
    from repro_torch.train import optimizer as optim
    from repro_torch.train.step import make_train_step
    cfg = reduced_config("qwen3-8b")
    ocfg = optim.OptConfig(lr=3e-3, warmup_steps=5, total_steps=steps)
    step = make_train_step(LM(cfg), Runtime(policy=uniform_policy(
        4, 8, backend="fake_quant")), ocfg)
    params = optim.tree_map(lambda t: t.to(device), params)
    state = {"params": params, "opt": optim.init_state(params, ocfg)}
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=8))
    losses, lrs = [], []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    return state["params"], losses, lrs


def _conv_on(device: str, params, steps: int) -> tuple:
    """``steps`` SGD steps (lr 0.05) of the default ConvNet, fake_quant
    w4a8 with unsigned activations, on the synthetic image classes."""
    import numpy as np
    import torch
    from repro_torch.core.policy import uniform_policy
    from repro_torch.models.convnet import ConvNet, ConvNetConfig
    from repro_torch.models.layers import Runtime
    from repro_torch.train import optimizer as optim
    from repro_torch.train.step import value_and_grad
    net = ConvNet(ConvNetConfig())
    rt = Runtime(policy=uniform_policy(4, 8, backend="fake_quant",
                                       a_signed=False))
    rng = np.random.default_rng(0)
    patterns = rng.random((10, 3)).astype(np.float32)

    def loss(p, batch):
        logits = net.apply(p, batch["x"], rt)
        lse = torch.logsumexp(logits, -1)
        ce = torch.mean(lse - logits.gather(1, batch["y"][:, None])[:, 0])
        return ce, {"loss": ce}
    params = optim.tree_map(lambda t: t.to(device), params)
    losses = []
    for _ in range(steps):
        ys = rng.integers(0, 10, size=16)
        xs = rng.normal(size=(16, 32, 32, 3)).astype(np.float32) * 0.1
        xs += patterns[ys][:, None, None, :]
        m, g = value_and_grad(loss, params, {
            "x": torch.from_numpy(xs).to(device),
            "y": torch.from_numpy(ys).to(device)})
        params = optim.tree_map(lambda a, b: a - 0.05 * b, params, g)
        losses.append(float(m["loss"]))
    return params, losses


def _train_card_vs_cpu() -> dict:
    """(c): the reduced qwen3-8b and the ConvNet, 4 steps each on the card
    and on the CPU from the same initial weights (drawn on the CPU)."""
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.models.convnet import ConvNet, ConvNetConfig
    from repro_torch.models.transformer import LM
    gen = torch.Generator()
    gen.manual_seed(0)
    lm0 = LM(reduced_config("qwen3-8b")).init(gen, device="cpu")
    conv0 = ConvNet(ConvNetConfig()).init(gen, device="cpu")
    reduce_bf16 = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    res = {"allow_bf16_reduced_precision_reduction": reduce_bf16,
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    card = MIXED_KW["device"]
    p_gpu, l_gpu, lrs = _lm_on(card, lm0, 4)
    p_cpu, l_cpu, _ = _lm_on("cpu", lm0, 4)
    budget = 4 * sum(lrs)
    worst, num, den = 0.0, 0.0, 0.0
    for (a, b), (_, z) in zip(_leaf_pairs(p_gpu, p_cpu),
                              _leaf_pairs(p_cpu, lm0)):
        a, b, z = a.cpu().float(), b.float(), z.float()
        ulp = torch.clamp_min(b.abs(), 1e-30) * 2.0 ** -7
        diff = (a - b).abs()
        worst = max(worst, float((diff / (budget + 2 * ulp)).max()))
        num += float((diff ** 2).sum())
        den += float(((b - z) ** 2).sum())
    res.update(lm_losses_cuda=l_gpu, lm_losses_cpu=l_cpu,
               lm_max_loss_diff=max(abs(x - y) for x, y in zip(l_gpu, l_cpu)),
               lm_worst_over_budget=worst,
               lm_update_rel_l2=(num / den) ** 0.5)
    c_gpu, cl_gpu = _conv_on(card, conv0, 4)
    c_cpu, cl_cpu = _conv_on("cpu", conv0, 4)
    num = den = 0.0
    for (a, b), (_, z) in zip(_leaf_pairs(c_gpu, c_cpu),
                              _leaf_pairs(c_cpu, conv0)):
        num += float(((a.cpu() - b) ** 2).sum())
        den += float(((b - z) ** 2).sum())
    res.update(conv_losses_cuda=cl_gpu, conv_losses_cpu=cl_cpu,
               conv_max_loss_rel=max(abs(x - y) / abs(y)
                                     for x, y in zip(cl_gpu, cl_cpu)),
               conv_update_rel_l2=(num / den) ** 0.5)
    log("[train-cpu] " + json.dumps(res, sort_keys=True))
    if res["lm_max_loss_diff"] > TRAIN_LOSS_ATOL or worst > 1.0 \
            or res["lm_update_rel_l2"] > TRAIN_UPDATE_RTOL:
        raise AssertionError(f"train-cpu: the LM on the card parts from the "
                             f"CPU's: {res}")
    if res["conv_max_loss_rel"] > CONV_LOSS_RTOL \
            or res["conv_update_rel_l2"] > CONV_UPDATE_RTOL:
        raise AssertionError(f"train-cpu: the ConvNet on the card parts "
                             f"from the CPU's: {res}")
    log(f"[train-cpu] card == CPU within the stated tolerances "
        f"(allow_bf16_reduced_precision_reduction={reduce_bf16})")
    return res


def _train_serve(params) -> dict:
    """(d): the trained full-width weights prepared into the superplane
    store and served at tiers 8/8 4/4 2/2 through kernels 1-4, against the
    plain replay on the same store."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.models.layers import Runtime
    from repro_torch.models.transformer import LM
    from repro_torch.serve import engine as engine_mod
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=4)
    model = LM(cfg)
    sched = uniform_schedule(TIERS, backend="cuda")
    store, _ = engine_mod.prepare_params(params, sched.prepare_policy(),
                                         model, superplane=True)
    del params
    reqs = _requests(9, cfg.vocab_size, 16, list(TIERS), seed=1)
    eng = engine_mod.ServeEngine(model, store, Runtime(
        policy=sched.policy_for(), schedule=sched), **MIXED_KW)
    res = _serve(eng, reqs, "train-serve")
    _check_streams("train-serve", res["tokens"], reqs, cfg.padded_vocab)
    _check_launches("train-serve", res["stats"]["launches"],
                    used=TRAIN_SERVE_USED,
                    unused=("packed_bitserial_matmul", "grouped_matmul"))
    del eng
    plain = uniform_schedule(TIERS, backend="decomposed")
    ref_eng = engine_mod.ServeEngine(model, store, Runtime(
        policy=plain.policy_for(), schedule=plain), **MIXED_KW)
    _check_plain("train-serve", _serve(ref_eng, reqs, "train-serve-plain"),
                 res)
    return res["stats"]


def phase_train(card: str) -> dict:
    """Phase 4g: QAT training on the card through the port's command line,
    its auto-resume, card against CPU, and the trained weights served."""
    full = _train_full(card)
    resume = _train_resume()
    vs_cpu = _train_card_vs_cpu()
    served = _train_serve(full.pop("params"))
    return {"full": full["res"], "resume": resume, "cpu": vs_cpu,
            "serve": served, "launches": served["launches"]}


# ------------------------------------------------------------ phase 4h
TP_FULL_RANKS = 2
TP_RANKS = 4
TP_LAYERS = 2
# Phase 4h (b): after the first round uid 0 moves to 2/2 (bf16 KV lanes to
# int4); uid 1 is preempted through a spill, uid 2 in host memory.
TP_MIGRATE = (0, "2/2")
TP_PREEMPTS = ((1, True), (2, False))
TP_SCENARIOS = ("migrate", "preempt", "sampled", "telemetry")


def _tp_schedule(kv: bool):
    from repro_torch.core.policy import uniform_schedule
    from repro_torch.models.layers import Runtime
    sched = uniform_schedule(TIERS, backend="cuda",
                             kv_tiers=KV_TIERS if kv else None)
    return sched, Runtime(policy=sched.policy_for(), schedule=sched)


def _tp_requests(vocab: int, sampled: bool):
    import dataclasses

    from repro_torch.spec import SamplingParams
    reqs = _requests(9, vocab, 16, list(TIERS), seed=1)
    if sampled:
        reqs = [dataclasses.replace(r, sampling=SamplingParams(0.8, 40,
                                                               seed=r.uid))
                for r in reqs]
    return reqs


def _tp_engine(model, params, scenario: str, *, mesh=None, spill=None):
    """The engine of one phase 4h (b) scenario (kv-tier schedule; a
    profiling telemetry for ``telemetry``)."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.telemetry import Telemetry
    _, rt = _tp_schedule(kv=True)
    tele = Telemetry(profile=True) if scenario == "telemetry" else None
    return ServeEngine(model, params, rt, mesh=mesh, telemetry=tele,
                       spill_dir=spill, **MIXED_KW)


def _tp_scenario(eng, scenario: str, spill=None):
    """One phase 4h (b) run on ``eng``: ``migrate`` (uid 0 to 2/2 after
    the first round), ``preempt`` (the same, then uid 1 through a spill
    and uid 2 in memory, both resumed prefill-free), ``sampled``
    (temperature 0.8, top-k 40, no migration) or ``telemetry`` (as
    ``migrate``, under the engine's profiling telemetry).  Returns
    (streams, each resume's kernel launches)."""
    handles = {r.uid: eng.submit(r) for r in _tp_requests(
        eng.model.cfg.vocab_size, sampled=scenario == "sampled")}
    resumes: list = []
    eng._resume_into = _launch_delta(eng._resume_into, resumes)
    eng.step()
    if scenario != "sampled":
        handles[TP_MIGRATE[0]].set_tier(TP_MIGRATE[1])
    if scenario == "preempt":
        for uid, spilled in TP_PREEMPTS:
            eng._spill_dir = spill if spilled else None
            eng.preempt(uid)
        eng._spill_dir = spill
    return eng.drain(), resumes


def _tp_full(rank: int, mesh) -> dict:
    """Phase 4h (a) on one rank of the 2-rank mesh: full-width, full-depth
    qwen3-8b built one rank at a time (each full store is cut to the
    rank's shard before the next rank builds), phase 3's requests served,
    then one decode step at two layouts for the wire bytes and launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import tp_serve
    from repro_torch.launch.mesh import in_turn
    from repro_torch.serve.engine import ServeEngine
    sched, rt = _tp_schedule(kv=False)

    def build():
        torch.cuda.reset_peak_memory_stats()
        cfg, model, params = _build_model(get_config("qwen3-8b").num_layers,
                                          sched.prepare_policy(),
                                          superplane=True, seed=0)
        eng = ServeEngine(model, params, rt, mesh=mesh, **MIXED_KW)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return cfg, eng, torch.cuda.max_memory_allocated() / 1e9
    cfg, eng, build_peak = in_turn(mesh, build)
    reqs = _requests(9, cfg.vocab_size, 16, list(TIERS), seed=1)
    tp_serve.reset_wire_bytes()
    res = _serve(eng, reqs, f"tp-full-rank{rank}")
    run_wire = dict(tp_serve.WIRE_BYTES)
    names = list(TIERS)
    layouts = {}
    for label, tiers in (("mixed", [names[i % 3] for i in range(8)]),
                         ("8/8", ["8/8"] * 8)):
        groups = eng._group_layout(tiers)[0]
        tp_serve.reset_wire_bytes()
        n = eng.decode_dispatch_count(groups=groups)
        layouts[label] = {
            "groups": groups, "dispatches": n,
            "wire": dict(tp_serve.WIRE_BYTES),
            "stats": tp_serve.decode_wire_stats(
                cfg, eng._tp, tuple((r, TIERS[t][1]) for t, r in groups))}
    return {"tokens": res["tokens"], "stats": res["stats"],
            "build_peak_gb": build_peak,
            "store_bytes": _store_size(eng.params)[1],
            "backend": mesh.backend, "device": str(mesh.device),
            "run_wire": run_wire, "layouts": layouts,
            "dispatches_derived": _dispatches_per_step(cfg)}


def _tp_small(rank: int, mesh, spill: str) -> dict:
    """Phase 4h (b) on one rank of the 4-rank mesh: the TP_LAYERS model,
    each store, every scenario."""
    import torch

    from repro_torch.launch.mesh import in_turn
    sched, _ = _tp_schedule(kv=True)
    free, total = torch.cuda.mem_get_info()
    out = {"card_in_use_gb": (total - free) / 1e9}
    print(f"[tp] rank {rank} (b): card memory in use "
          f"{out['card_in_use_gb']:.2f} GB", file=sys.stderr, flush=True)
    for packed in (False, True):
        def build():
            # Every scenario's engine keeps its shard; then the full store
            # goes, before the next rank builds.
            _, model, params = _build_model(
                TP_LAYERS, sched.prepare_policy(), superplane=True, seed=0,
                packed=packed)
            engines = {sc: _tp_engine(model, params, sc, mesh=mesh,
                                      spill=spill) for sc in TP_SCENARIOS}
            del params
            gc.collect()
            torch.cuda.empty_cache()
            return engines
        engines = in_turn(mesh, build)
        for scenario in TP_SCENARIOS:
            eng = engines.pop(scenario)
            toks, resumes = _tp_scenario(eng, scenario, spill=spill)
            rec = {"tokens": toks, "prefills": eng.stats.prefills,
                   "resumes": eng.stats.resumes, "resume_launches": resumes,
                   "kv_migrations": eng.stats.kv_migrations,
                   "telemetry": eng.telemetry is not None}
            if scenario == "telemetry" and eng.telemetry is not None:
                prof = eng.telemetry.profiler.snapshot()["phases"]
                rec["decode_chunk_calls"] = prof["decode_chunk"]["calls"]
                rec["decode_chunks"] = eng.stats.decode_chunks
            out[(packed, scenario)] = rec
            del eng
        gc.collect()
        torch.cuda.empty_cache()
    out["spill_left"] = os.listdir(spill)
    return out


def _tp_rank(rank: int, spill: str) -> dict:
    """One rank of phase 4h (every rank runs it; ranks off the 2-rank mesh
    wait for (b)).  Quiet: the parent prints what the ranks return."""
    import contextlib
    import io

    import torch

    from repro_torch.launch.mesh import make_serve_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with contextlib.redirect_stdout(io.StringIO()):
        out = {}
        dev = MIXED_KW["device"]
        mesh = make_serve_mesh(TP_FULL_RANKS, device=dev)
        if mesh.member:
            out["full"] = _tp_full(rank, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        out["small"] = _tp_small(rank, make_serve_mesh(TP_RANKS, device=dev),
                                 spill)
    return out


def _head_slices() -> dict:
    """Phase 4h (c): the attention core on each rank's heads equals the
    same heads of the whole computation, bit for bit (decode against a
    bf16, int8 and mixed arena; prefill at every prompt bucket of phase
    3, and a 2048-token prompt: two K/V blocks), at qwen3-8b's shapes for
    2 and 4 ranks, KV heads sharded and replicated (MQA), each rank's call
    given its ``TPConfig`` as ``attention_apply`` gives it (decode runs
    the kernel on the rank's heads alone: its sums' order depends on the
    slot's length only); and decode attention's ms unsharded beside one of
    2 ranks' calls."""
    import torch

    from repro_torch.distributed import tp_serve
    from repro_torch.models import layers
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def heads(t, r, n, dim=2):
        return t.narrow(dim, r * t.shape[dim] // n, t.shape[dim] // n)

    def tp(n, r, kvh):
        return tp_serve.TPConfig(n=n, rank=r, kv_shards=kvh > 1)
    b, s, h, dh = 8, MIXED_KW["max_len"], 32, 128
    cases = 0
    for kvh in (8, 1):
        for kv_bits in (None, 8, (16, 8, 4)):
            cache = layers.KVCache.create(b, s, kvh, dh, kv_bits=kv_bits,
                                          device="cuda")
            cache.update(rnd(b, s, kvh, dh), rnd(b, s, kvh, dh), 0,
                         new_length=torch.randint(
                             5, s - 5, (b,), generator=gen, device="cuda"))
            q = rnd(b, 1, h, dh)
            whole = layers.decode_attention(q, cache)
            for n in (2, 4):
                parts = []
                for r in range(n):
                    sub = cache if kvh == 1 else layers.KVCache(*[
                        None if t is None else heads(t, r, n) if t.ndim == 4
                        else t for t in (cache.k, cache.v, cache.k_scale,
                                         cache.v_scale, cache.length,
                                         cache.kv_bits)], modes=cache.modes)
                    parts.append(layers.decode_attention(
                        heads(q, r, n).contiguous(), sub, tp=tp(n, r, kvh)))
                if not torch.equal(whole, torch.cat(parts, 2)):
                    raise AssertionError(f"tp: decode attention on {n} "
                                         f"ranks' heads (KV heads {kvh}, "
                                         f"kv_bits {kv_bits}) differs")
                cases += 1
        for sq, sk in [(n, s) for n in range(16, 65, 8)] + [(2048, 2048)]:
            q, k, v = rnd(1, sq, h, dh), rnd(1, sk, kvh, dh), rnd(1, sk, kvh,
                                                                 dh)
            whole = layers.flash_attention(q, k, v, causal=True)
            for n in (2, 4):
                parts = [layers.flash_attention(
                    heads(q, r, n).contiguous(),
                    *(t if kvh == 1 else heads(t, r, n).contiguous()
                      for t in (k, v)), causal=True, tp=tp(n, r, kvh))
                    for r in range(n)]
                if not torch.equal(whole, torch.cat(parts, 2)):
                    raise AssertionError(f"tp: prefill attention (sq {sq}) on "
                                         f"{n} ranks' heads differs")
                cases += 1
    cache = layers.KVCache.create(b, s, 8, dh, device="cuda")
    cache.update(rnd(b, s, 8, dh), rnd(b, s, 8, dh), 0,
                 new_length=torch.full((b,), s // 2, device="cuda"))
    q = rnd(b, 1, h, dh)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    ms = _time_ms(lambda: layers.decode_attention(q, cache), flush)
    sub = layers.KVCache(heads(cache.k, 0, 2), heads(cache.v, 0, 2), None,
                         None, cache.length)
    q0 = heads(q, 0, 2).contiguous()
    rank_ms = _time_ms(lambda: layers.decode_attention(q0, sub,
                                                       tp=tp(2, 0, 8)), flush)
    log(f"[tp] (c) {cases} head-slice cases bit-equal; decode attention "
        f"(B {b}, S {s}, 32 heads, 8 KV heads) {ms:.4f} ms unsharded, "
        f"{rank_ms:.4f} ms for one of 2 ranks (decode: the kernel on its "
        f"heads alone, read in place; prefill: among zero heads)")
    return {"cases": cases, "decode_attention_ms": ms,
            "rank_decode_attention_ms": rank_ms}


def phase_tp(mixed: dict, card: str) -> dict:
    """Phase 4h: tensor-parallel serving over torch.distributed; see the
    module docstring."""
    import tempfile

    import torch

    from repro_torch.launch.mesh import spawn_ranks
    slices = _head_slices()
    # (b)'s references: the unsharded engine on the same 4-layer weights.
    sched, _ = _tp_schedule(kv=True)
    want = {}
    for packed in (False, True):
        _, model, params = _build_model(TP_LAYERS, sched.prepare_policy(),
                                        superplane=True, seed=0,
                                        packed=packed)
        for scenario in ("migrate", "sampled"):
            want[(packed, scenario)] = _tp_scenario(
                _tp_engine(model, params, scenario), scenario)[0]
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    spill = tempfile.mkdtemp(dir=ROOT / "build")
    free, total = torch.cuda.mem_get_info()
    log(f"[tp] card memory in use before the ranks start: "
        f"{(total - free) / 1e9:.2f} GB (this process "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    t0 = time.perf_counter()
    ranks = spawn_ranks(TP_RANKS, _tp_rank, spill,
                        device=MIXED_KW["device"])
    secs = time.perf_counter() - t0
    os.rmdir(spill)
    # (a): every rank's streams are phase 3's.
    full = [r["full"] for r in ranks if "full" in r]
    for r, f in enumerate(full):
        _check_same(f"tp-full-rank{r}", f["tokens"], mixed["streams"],
                    "phase 3's")
        _check_launches(f"tp-full-rank{r}", f["stats"]["launches"],
                        used=("act_quant", "act_quant_rows",
                              "bitserial_matmul", "grouped_dequant_matmul"),
                        unused=("packed_bitserial_matmul", "grouped_matmul"))
        for label, lay in f["layouts"].items():
            if lay["dispatches"] != f["dispatches_derived"]:
                raise AssertionError(
                    f"tp-full-rank{r}: decode_dispatch_count at {label} "
                    f"{lay['dispatches']}, the unsharded graph's "
                    f"{f['dispatches_derived']}")
            if lay["wire"]["codes"] != lay["stats"]["quant_gather_bytes"] \
                    or lay["wire"]["outputs"] != \
                    lay["stats"]["out_gather_bytes"]:
                raise AssertionError(
                    f"tp-full-rank{r}: wire bytes at {label} {lay['wire']} "
                    f"against decode_wire_stats {lay['stats']}")
    f0 = full[0]
    log(f"[tp] (a) qwen3-8b, 36 layers, {TP_FULL_RANKS} ranks sharing "
        f"{f0['device']} over {f0['backend']}: streams equal phase 3's on "
        f"every rank; " + json.dumps({
            "per_rank": [{
                "store_bytes": f["store_bytes"],
                "build_peak_gb": f["build_peak_gb"],
                "serve_peak_gb": f["stats"]["peak_mem_gb"],
                "launches": {k: v for k, v in f["stats"]["launches"].items()
                             if v},
                "decode_step_ms_gloo_host_loopback_one_card":
                    f["stats"]["mean_decode_step_ms"],
                "prefill_s": f["stats"]["prefill_s"],
                "run_wire_bytes": f["run_wire"]} for f in full],
            "card": card}))
    for label, lay in f0["layouts"].items():
        log(f"[tp] (a) one decode step at {label} {lay['groups']}: "
            f"{lay['dispatches']} launches (the unsharded graph's), code "
            f"bytes on the wire {lay['wire']['codes']} == decode_wire_stats "
            f"{lay['stats']['quant_gather_bytes']:.0f} (f32 would be "
            f"{lay['stats']['f32_gather_bytes']:.0f}), output bytes "
            f"{lay['wire']['outputs']}")
    # (b): every rank, store and scenario equals the unsharded engine.
    for r, rank in enumerate(ranks):
        small = rank["small"]
        if small["spill_left"]:
            raise AssertionError(f"tp-small-rank{r}: spill dir not empty")
        for packed in (False, True):
            for scenario in TP_SCENARIOS:
                rec = small[(packed, scenario)]
                ref = want[(packed, "sampled" if scenario == "sampled"
                            else "migrate")]
                _check_same(f"tp-small-rank{r}-{scenario}-packed{packed}",
                            rec["tokens"], ref, "the unsharded engine's")
                if scenario != "sampled" and rec["kv_migrations"] != 1:
                    raise AssertionError(f"tp-small-rank{r}: no KV migration")
                if scenario == "preempt" and (
                        rec["resumes"] != 2 or rec["prefills"] != 9
                        or any(any(d.values())
                               for d in rec["resume_launches"])):
                    raise AssertionError(
                        f"tp-small-rank{r}: preemption {rec['resumes']} "
                        f"resumes, {rec['prefills']} prefills, resume "
                        f"launches {rec['resume_launches']}")
                if scenario == "telemetry":
                    if rec["telemetry"] != (r == 0) or (r == 0 and rec[
                            "decode_chunk_calls"] != rec["decode_chunks"]):
                        raise AssertionError(f"tp-small-rank{r}: telemetry "
                                             f"{rec}")
    log(f"[tp] (b) {TP_LAYERS} layers, {TP_RANKS} ranks, planes and packed: "
        f"{', '.join(TP_SCENARIOS)} equal the unsharded engine on every "
        f"rank; {secs:.1f}s for the ranks (start, build, (a), (b))")
    return {"launches": f0["stats"]["launches"], "seconds": secs,
            "slices": slices, "full": [{k: v for k, v in f.items()
                                        if k != "tokens"} for f in full]}


# ------------------------------------------------------------ phase 4i
DIST_RANKS = 4
# (a) qwen3-8b's MLP widths, 64 rows of f32 activations.
DIST_TP = dict(d=4096, f=12288, rows=64)
# (a) the card's y against the same call on the CPU: bf16 GEMMs that sum
# in another order on each device, at most this many bf16 ulps of the
# largest |y| apart.
DIST_TP_CPU_ULPS = 4
# (b) full-width qwen3-8b cut to one layer; 2 data-parallel ranks, each
# half of a batch of 8 x 256 tokens at w4a8 fake_quant; 2 rounds at each
# width (the second carries the first's error feedback).  The leaves also reduced on the CPU: a projection and a norm
# every round; the embedding (0.62 G entries, 10-18 s a round on the
# host) in each width's first round.
DIST_DP = dict(layers=1, seq=256, batch=8, rounds=2)
DIST_DP_CHECKED = ("layers.0.pos0.attn.q_proj.w",
                   "layers.0.pos0.mixer_norm.g")
DIST_DP_FIRST_ROUND = ("embed.emb",)
# (c) one full-width decoder layer a stage, 6 microbatches [2, 128, d].
DIST_PIPE = dict(micro=6, mb=(2, 128))
# (d) phase 4g's model: full width, 4 layers; and the full trees reckoned
# on the production meshes.
DIST_FSDP_LAYERS = 4
DIST_PROD_ARCHS = ("qwen3-8b", "llama4-scout-17b-a16e", "grok-1-314b")
DIST_USED = ("act_quant", "bitserial_matmul")


def _dist_cfg(layers: int):
    """qwen3-8b at full width, ``layers`` deep."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-8b"), num_layers=layers)


def _rank_log(msg: str) -> None:
    print(f"[dist] {msg}", file=sys.stderr, flush=True)


def _dist_tp(mesh) -> dict:
    """(a) ``tp_mlp_block`` over the mesh's "model" lines: the wire against
    the plain quantizer, y against the f32 MLP and against the same call on
    the CPU (gloo moves CPU tensors over the same groups)."""
    import torch

    from repro_torch.distributed import tp_matmul
    from repro_torch.kernels import ref
    d, f, rows = DIST_TP["d"], DIST_TP["f"], DIST_TP["rows"]
    dev, n = mesh.device, mesh.axis_size("model")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn((rows, d), generator=gen, device=dev)
    w_up = (torch.randn((d, f), generator=gen, device=dev)
            / math.sqrt(d)).to(torch.bfloat16)
    w_down = (torch.randn((f, d), generator=gen, device=dev)
              / math.sqrt(f)).to(torch.bfloat16)
    wire: dict = {}
    y = tp_matmul.tp_mlp_block(mesh, x, w_up, w_down, wire=wire)
    k = d // n
    plain = [ref.act_quant_ref(x[:, r * k:(r + 1) * k]) for r in range(n)]
    codes = torch.cat([q for q, _ in plain], -1)
    scales = torch.cat([s for _, s in plain], -1).to(torch.bfloat16)
    want = tp_matmul.gelu(x @ w_up.float()) @ w_down.float()
    cpu_wire: dict = {}
    y_cpu = tp_matmul.tp_mlp_block(mesh, x.cpu(), w_up.cpu(), w_down.cpu(),
                                   wire=cpu_wire)
    ulp = 2.0 ** (math.floor(math.log2(y_cpu.float().abs().max().item()))
                  - 7)
    diff = (y.cpu().float() - y_cpu.float()).abs()
    est = tp_matmul.collective_bytes_per_token(d, f, n)
    return {
        "n": n, "wire_equal_plain": torch.equal(wire["codes"], codes)
        and torch.equal(wire["scales"], scales),
        "cpu_wire_equal": torch.equal(cpu_wire["codes"], codes.cpu())
        and torch.equal(cpu_wire["scales"], scales.cpu()),
        "rel_f32": ((y.float() - want).abs().max()
                    / want.abs().max()).item(),
        "finite": bool(torch.isfinite(y).all()),
        "cpu_max_abs": diff.max().item(), "cpu_ulp": ulp,
        "cpu_differing": (diff > 0).float().mean().item(),
        "gathered_per_token": (wire["codes"].numel()
                               + 2 * wire["scales"].numel()) / rows,
        "reduced_per_token": 2 * wire["partial"].numel() / rows,
        "estimate": est}


def _dist_pipe(mesh) -> dict:
    """(c) ``run_pipeline`` over the 4 stage ranks, each stage one
    full-width decoder layer from the superplane store at w8a8 (kernels 1
    and 3); rank 0 then runs the four layers on one microbatch at a time.
    Returns the launches of (a) and the pipeline too."""
    import torch

    from repro_torch.core.policy import uniform_policy
    from repro_torch.distributed import pipeline
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import in_turn
    from repro_torch.models.layers import Runtime
    stages = mesh.axis_size("stage")
    policy = uniform_policy(8, 8, backend="cuda")

    def build():
        # The layers only: the embedding and the head go before the next
        # rank builds.
        cfg, model, params = _build_model(stages, policy, superplane=True,
                                          seed=3)
        layers = params["layers"]
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return cfg, model, layers
    cfg, model, layers = in_turn(mesh, build)
    rt = Runtime(policy=policy)

    def stage_fn(period, x):
        return model._stack({"layers": [period]}, x, rt)[0]
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(9)
    xs = torch.randn((DIST_PIPE["micro"], *DIST_PIPE["mb"], cfg.d_model),
                     generator=gen, device=mesh.device).to(torch.bfloat16)
    sync()
    t0 = time.perf_counter()
    out = pipeline.run_pipeline(mesh, stage_fn, layers, xs)
    sync()
    res = {"seconds": time.perf_counter() - t0,
           "launches": dict(_build.LAUNCHES),
           "finite": bool(torch.isfinite(out).all())}
    if mesh.rank == 0:
        seq = []
        for mb in xs:
            for period in layers:
                mb = stage_fn(period, mb)
            seq.append(mb)
        res["equal_sequential"] = torch.equal(out, torch.stack(seq))
    return res


def _dist_dp(mesh) -> dict:
    """(b) compressed data-parallel gradients on the "dp" line of ranks 0
    and 1 (the line of rep 0; ranks 2 and 3 only wait): each computes its
    half-batch gradient in turn, then ``compressed_psum_tree`` runs at
    bits 8 and 2 for 2 rounds with error feedback, the checked leaves
    also on the CPU."""
    import torch

    from repro_torch.core.policy import uniform_policy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import comm, compression
    from repro_torch.distributed.sharding_rules import leaf_paths
    from repro_torch.launch.mesh import in_turn
    from repro_torch.models.layers import Runtime
    from repro_torch.models.transformer import LM
    from repro_torch.train.step import make_loss_fn, value_and_grad
    dev = mesh.device
    working = mesh.index("rep") == 0

    def grads():
        if not working:
            return None
        cfg = _dist_cfg(DIST_DP["layers"])
        model = LM(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(4)
        params = model.init(gen, device=dev)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=DIST_DP["seq"],
                                      global_batch=DIST_DP["batch"]))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(
            0, shard=mesh.index("dp"), num_shards=2).items()}
        rt = Runtime(policy=uniform_policy(4, 8, backend="fake_quant"))
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        metrics, g = value_and_grad(make_loss_fn(model, rt), params, batch)
        sync()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return g, float(metrics["loss"]), secs, peak
    turn = in_turn(mesh, grads)
    if not working:
        return {}
    g, loss, grad_s, peak = turn
    group = mesh.group("dp")
    leaves = leaf_paths(g)
    res = {"loss": loss, "grad_s": grad_s, "grad_peak_gb": peak,
           "params": sum(t.numel() for t in leaves.values()), "bits": {}}
    for bits in (8, 2):
        err = compression.init_error_feedback(g)
        checked = {p: leaves[p].cpu()
                   for p in DIST_DP_FIRST_ROUND + DIST_DP_CHECKED}
        cpu_err = compression.init_error_feedback(checked)
        rounds = []
        for i in range(DIST_DP["rounds"]):
            compression.reset_wire_bytes()
            sync()
            t0 = time.perf_counter()
            mean, err = compression.compressed_psum_tree(
                g, err, mesh=mesh, axis_name="dp", bits=bits)
            sync()
            rec = {"seconds": time.perf_counter() - t0,
                   "wire": dict(compression.WIRE_BYTES)}
            t0 = time.perf_counter()
            cpu_mean, cpu_err = compression.compressed_psum_tree(
                checked, cpu_err, mesh=mesh, axis_name="dp", bits=bits)
            means, errs = leaf_paths(mean), leaf_paths(err)
            rec["cpu_equal"] = sorted(
                p for p in checked if torch.equal(means[p].cpu(), cpu_mean[p])
                and torch.equal(errs[p].cpu(), cpu_err[p]))
            rec["cpu_seconds"] = time.perf_counter() - t0
            if i == 0:
                # The embedding's replay ends with its first round.
                checked = {p: checked[p] for p in DIST_DP_CHECKED}
                cpu_err = {p: cpu_err[p] for p in DIST_DP_CHECKED}
            if bits == 8 and i == 0:
                # The f32 mean: each rank's bf16 gradient gathered, summed
                # in f32 (as an f32 all-reduce of two ranks sums), halved.
                rel, t0 = 0.0, time.perf_counter()
                for p, t in leaves.items():
                    both = comm.all_gather_tiled(t[None], 0, group)
                    full = (both[0].float() + both[1].float()) / 2
                    rel = max(rel, ((means[p] - full).abs().max()
                                    / full.abs().max()).item())
                    del both, full
                rec["rel_f32"] = rel
                rec["f32_seconds"] = time.perf_counter() - t0
            rec["finite"] = all(bool(torch.isfinite(t).all())
                                for t in means.values())
            rounds.append(rec)
            del mean, means, errs
            _rank_log(f"rank {mesh.rank} (b) bits {bits} round {i}: {rec}")
        res["bits"][bits] = rounds
        del err
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _dist_fsdp(mesh) -> dict:
    """(d) the params and AdamW state of phase 4g's model under the (2, 2)
    FSDP x TP rules: each rank builds the whole in turn and keeps its
    blocks; then every leaf's blocks are gathered to rank 0, which builds
    the whole again and holds ``gather_tree`` of them against it."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding_rules as rules
    from repro_torch.launch.mesh import in_turn
    from repro_torch.models.transformer import LM
    from repro_torch.train import optimizer as optim
    dev = mesh.device
    model = LM(_dist_cfg(DIST_FSDP_LAYERS))

    def whole():
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        params = model.init(gen, device=dev)
        return {"params": params,
                "opt": optim.init_state(params, optim.OptConfig())}

    def build():
        state = whole()
        specs = rules.tree_shardings(mesh, state)
        blocks = rules.shard_tree(state, specs, mesh=mesh)
        reckoned = rules.block_bytes(state, specs, mesh)
        total = sum(t.numel() * t.element_size()
                    for t in rules.leaf_paths(state).values())
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return blocks, specs, reckoned, total
    t0 = time.perf_counter()
    blocks, specs, reckoned, total = in_turn(mesh, build)
    held = sum(t.numel() * t.element_size()
               for t in rules.leaf_paths(blocks).values())
    ref = rules.leaf_paths(whole()) if mesh.rank == 0 else None
    differ, sharded = [], 0
    for path, b in rules.leaf_paths(blocks).items():
        parts = comm.gather(b, 0, dist.group.WORLD)
        sharded += any(a is not None for a in specs[path])
        if ref is not None:
            got = rules.gather_tree([{"x": p} for p in parts],
                                    {"x": specs[path]}, mesh)["x"]
            if not torch.equal(got, ref[path].cpu()):
                differ.append(path)
    return {"held": held, "reckoned": reckoned, "whole": total,
            "leaves": len(specs), "sharded": sharded, "differ": differ,
            "seconds": time.perf_counter() - t0,
            "checked": ref is not None}


def _dist_rank(rank: int) -> dict:
    """One rank of phase 4i.  Quiet: the parent prints what the ranks
    return."""
    import contextlib
    import io

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = MIXED_KW["device"]
    with contextlib.redirect_stdout(io.StringIO()):
        meshes = {axes: make_mesh(shape, axes, device=dev) for shape, axes in
                  (((4,), ("model",)), ((2, 2), ("data", "model")),
                   ((2, 2), ("rep", "dp")), ((4,), ("stage",)))}
        _build.reset_launches()
        out = {"tp": [_dist_tp(meshes[("model",)]),
                      _dist_tp(meshes[("data", "model")])]}
        _rank_log(f"rank {rank} (a) {out['tp']}")
        out["pipe"] = _dist_pipe(meshes[("stage",)])
        _rank_log(f"rank {rank} (c) {out['pipe']}")
        gc.collect()
        torch.cuda.empty_cache()
        out["dp"] = _dist_dp(meshes[("rep", "dp")])
        gc.collect()
        torch.cuda.empty_cache()
        out["fsdp"] = _dist_fsdp(meshes[("data", "model")])
        _rank_log(f"rank {rank} (d) {out['fsdp']}")
    return out


def _production_bytes() -> dict:
    """(d) the per-device parameter bytes of full trees on the production
    meshes: a reckoning from shapes (meta tensors), not a measurement."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding_rules as rules
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import LM
    out = {}
    for arch in DIST_PROD_ARCHS:
        params = LM(get_config(arch)).init(torch.Generator(), device="meta")
        total = sum(t.numel() * t.element_size()
                    for t in rules.leaf_paths(params).values())
        row = {"whole_bytes": total}
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            row["x".join(map(str, mesh.shape))] = rules.block_bytes(
                params, rules.tree_shardings(mesh, params), mesh)
        out[arch] = row
    return out


def phase_dist(card: str) -> dict:
    """Phase 4i: the distributed training blocks over torch.distributed;
    see the module docstring."""
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    ranks = spawn_ranks(DIST_RANKS, _dist_rank, device=MIXED_KW["device"])
    secs = time.perf_counter() - t0
    # (a)
    for r, rank in enumerate(ranks):
        for tp in rank["tp"]:
            label = f"dist-tp-rank{r}-n{tp['n']}"
            est = tp["estimate"]
            if not (tp["wire_equal_plain"] and tp["cpu_wire_equal"]):
                raise AssertionError(f"{label}: the wire's codes or scales "
                                     "differ from the plain quantizer's")
            if not tp["finite"] or not tp["rel_f32"] < 0.05:
                raise AssertionError(f"{label}: y off the f32 MLP by "
                                     f"{tp['rel_f32']}")
            if tp["cpu_max_abs"] > DIST_TP_CPU_ULPS * tp["cpu_ulp"]:
                raise AssertionError(f"{label}: card against CPU "
                                     f"{tp['cpu_max_abs']}, over "
                                     f"{DIST_TP_CPU_ULPS} bf16 ulps")
            if tp["gathered_per_token"] != est["gather_int8"] or \
                    tp["reduced_per_token"] != est["reduce_scatter_bf16"]:
                raise AssertionError(f"{label}: wire bytes {tp} against "
                                     f"{est}")
    for tp in ranks[0]["tp"]:
        log(f"[dist] (a) tp_mlp_block d {DIST_TP['d']} f {DIST_TP['f']}, "
            f"{DIST_TP['rows']} rows, {tp['n']} ranks: wire codes and "
            f"scales equal the plain quantizer's; rel to the f32 MLP "
            f"{tp['rel_f32']:.5f}; card vs CPU max {tp['cpu_max_abs']} "
            f"({tp['cpu_max_abs'] / tp['cpu_ulp']:.2f} bf16 ulps of max|y|,"
            f" {100 * tp['cpu_differing']:.2f} % of elements differ); bytes "
            f"a token gathered {tp['gathered_per_token']:.0f}, reduced "
            f"{tp['reduced_per_token']:.0f} == collective_bytes_per_token "
            + json.dumps(tp["estimate"]))
    # (c)
    pipe = ranks[0]["pipe"]
    if not pipe.get("equal_sequential") or not all(
            r["pipe"]["finite"] for r in ranks):
        raise AssertionError(f"dist-pipe: the pipeline differs from the "
                             f"sequential run: {pipe}")
    launches = {k: sum(r["pipe"]["launches"][k] for r in ranks)
                for k in KERNELS}
    _check_launches("dist", launches, used=DIST_USED,
                    unused=[k for k in KERNELS if k not in DIST_USED])
    log(f"[dist] (c) run_pipeline: {DIST_RANKS} stages of one full-width "
        f"qwen3-8b layer (w8a8 superplanes), {DIST_PIPE['micro']} "
        f"microbatches of {DIST_PIPE['mb']}: equal to the sequential run "
        f"bit for bit; {pipe['seconds']:.2f}s on rank 0; launches of (a) "
        f"and (c), all ranks: " + json.dumps(launches))
    # (b)
    for r, rank in enumerate(ranks[:2]):
        dp = rank["dp"]
        for bits, rounds in dp["bits"].items():
            for i, rec in enumerate(rounds):
                want = sorted(DIST_DP_CHECKED + (DIST_DP_FIRST_ROUND
                                                 if i == 0 else ()))
                if rec["cpu_equal"] != want or not rec["finite"]:
                    raise AssertionError(f"dist-dp-rank{r}: bits {bits} "
                                         f"round {i}: {rec}")
        if not dp["bits"][8][0]["rel_f32"] < 0.05:
            raise AssertionError(f"dist-dp-rank{r}: 8-bit mean off the f32 "
                                 f"mean by {dp['bits'][8][0]['rel_f32']}")
    dp = ranks[0]["dp"]
    log(f"[dist] (b) qwen3-8b cut to {DIST_DP['layers']} layer, "
        f"{dp['params']} parameters, 2 ranks: loss {dp['loss']:.4f}, "
        f"gradient {dp['grad_s']:.2f}s, peak {dp['grad_peak_gb']:.2f} GB; "
        f"8-bit mean rel to the f32 mean {dp['bits'][8][0]['rel_f32']:.5f};"
        f" means and residuals equal the CPU's bit for bit: "
        f"{DIST_DP_CHECKED} every round, {DIST_DP_FIRST_ROUND} in each "
        "width's first; " + json.dumps(
            {bits: [{k: rec[k] for k in rec if k.endswith(("seconds", "wire"))}
                    for rec in rounds]
             for bits, rounds in dp["bits"].items()}))
    # (d)
    for r, rank in enumerate(ranks):
        fs = rank["fsdp"]
        if fs["held"] != fs["reckoned"] or fs["differ"]:
            raise AssertionError(f"dist-fsdp-rank{r}: {fs}")
    if not ranks[0]["fsdp"]["checked"]:
        raise AssertionError("dist-fsdp: rank 0 did not check the gather")
    fs = ranks[0]["fsdp"]
    prod = _production_bytes()
    log(f"[dist] (d) qwen3-8b, {DIST_FSDP_LAYERS} layers, params + AdamW "
        f"state {fs['whole']} B on a (2, 2) data x model mesh: every rank "
        f"holds its rules' reckoning "
        f"({[r['fsdp']['held'] for r in ranks]} B), gather_tree of the "
        f"blocks equals the whole bit for bit ({fs['leaves']} leaves, "
        f"{fs['sharded']} sharded); {fs['seconds']:.1f}s")
    log("[dist] (d) per-device parameter bytes on the production meshes "
        "(a reckoning from shapes, not a measurement): " + json.dumps(prod))
    log(f"[dist] {secs:.1f}s for the ranks; card {card}")
    return {"launches": launches, "seconds": secs, "production": prod}


# ------------------------------------------------------------ phase 4j
# (a) the production cells dry-run in process.
DRYRUN_CELLS = (("qwen3-8b", "decode_32k", False, None),
                ("mamba2-1.3b", "long_500k", True, 8))
# (c) the reduced decode cell and (d) a reduced prefill whose flash
# attention makes three K/V trips (block_k 1024), each reckoned against
# one real step.
DRYRUN_DECODE = ("qwen3-8b", "decode_32k")
DRYRUN_PREFILL = ("qwen3-8b", 3072, 2)


def _meta_and_card(arch, shape, *, mesh, reduced: bool = False,
                   moment_dtype: str = "bfloat16") -> dict:
    """``dryrun.run_cell`` on meta and ``FlopCounterMode`` over the same
    cell's step built on the card by ``dryrun.build_cell``, plus the
    products of the plain decode attention that the card's kernel
    replaces (two batched products of 2 * B * H * Smax * Dh a layer,
    which ``FlopCounterMode`` counts on meta and cannot see in a
    launch)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    kw = dict(reduced=reduced, mesh=mesh, moment_dtype=moment_dtype)
    t0 = time.perf_counter()
    res = dryrun.run_cell(arch, shape, **kw)
    meta_s = time.perf_counter() - t0
    cell, _ = dryrun.build_cell(arch, shape, multi_pod=False, backend=None,
                                w_bits=4, a_bits=8, kv_bits=None,
                                device="cuda", **kw)
    t0 = time.perf_counter()
    before = _build.LAUNCHES["decode_attention"]
    with FlopCounterMode(display=False) as counter:
        cell.step(*cell.args, **cell.kwargs)
    sync()
    real_s = time.perf_counter() - t0
    attn = _build.LAUNCHES["decode_attention"] - before
    card = counter.get_total_flops()
    if attn:
        cfg = arch if not isinstance(arch, str) else (
            reduced_config(arch) if reduced else get_config(arch))
        card += attn * 4 * res["global_batch"] * cfg.num_heads * \
            res["seq_len"] * cfg.head_dim
    if res["flops"] != card:
        raise AssertionError(f"dryrun: {res['arch']} {res['shape']} counts "
                             f"{res['flops']} flops on meta, {card} on the "
                             f"card ({attn} decode-attention launches)")
    return {"cell": res, "meta_s": meta_s, "real_s": real_s,
            "attention_launches": attn}


def phase_dryrun(train: dict, card: str) -> dict:
    """Phase 4j: the dry-run and roofline tools; see the module
    docstring."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import ShapeSpec
    before = dict(_build.LAUNCHES)
    # (a)
    cells = []
    for arch, shape, multi_pod, kv_bits in DRYRUN_CELLS:
        t0 = time.perf_counter()
        cell = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                               kv_bits=kv_bits)
        log(f"[dryrun] (a) {arch} {shape} {cell['mesh']}: "
            f"{time.perf_counter() - t0:.1f}s on meta " + json.dumps(
                {k: cell[k] for k in ("flops", "bytes_accessed",
                                      "min_bytes_accessed", "memory",
                                      "collectives", "hlo_lines", "lower_s",
                                      "compile_s")}))
        if cell["skipped"] or not cell["flops"] > 0:
            raise AssertionError(f"dryrun: {arch} {shape}: {cell}")
        cells.append(cell)
    for line in roofline.format_table(cells).splitlines():
        log(f"[dryrun] {line}")
    # (b)
    one = Mesh((1, 1), ("data", "model"))
    cfg = dataclasses.replace(get_config("qwen3-8b"),
                              num_layers=int(TRAIN_FULL_ARGV[
                                  TRAIN_FULL_ARGV.index("--layers") + 1]))
    shape = ShapeSpec("train_4g", "train", 256, 8)
    tr = _meta_and_card(cfg, shape, mesh=one, moment_dtype="float32")
    cell = tr["cell"]
    terms = roofline.roofline_terms(cell)
    step_ms = train["step_ms"]
    bound_ms = terms["step_time_bound_s"] * 1e3
    share = bound_ms / step_ms
    log(f"[dryrun] (b) 4g's step (qwen3-8b, {cfg.num_layers} layers, seq "
        f"{shape.seq_len} x batch {shape.global_batch}, w4a8 fake_quant, "
        f"f32 moments): {cell['flops']:.0f} flops on meta "
        f"({tr['meta_s']:.1f}s) == FlopCounterMode over one step on the "
        f"card ({tr['real_s']:.1f}s); roofline bound {bound_ms:.3f} ms "
        f"({terms['dominant']}: compute {terms['compute_s'] * 1e3:.3f} ms, "
        f"least bytes {cell['min_bytes_accessed']:.0f} = "
        f"{terms['min_memory_s'] * 1e3:.3f} ms) against 4g's measured "
        f"{step_ms:.1f} ms: {100 * share:.2f} % of the bound, on {card} "
        f"(data-sheet peaks at 700 W); eager bytes (the op trace, "
        f"unfused; not a bound) {cell['bytes_accessed']:.0f} = "
        f"{terms['memory_s'] * 1e3:.3f} ms; temp peak "
        f"{cell['memory']['temp_size_in_bytes']} B")
    # (c)
    dec = _meta_and_card(*DRYRUN_DECODE, mesh=one, reduced=True)
    log(f"[dryrun] (c) reduced {DRYRUN_DECODE[0]} decomposed decode step, "
        f"batch {dec['cell']['global_batch']}, cache "
        f"{dec['cell']['seq_len']}: {dec['cell']['flops']:.0f} flops on "
        f"meta == FlopCounterMode over one step on the card + the plain "
        f"products of its {dec['attention_launches']} decode-attention "
        f"launches")
    # (d)
    arch, seq, batch = DRYRUN_PREFILL
    pre = _meta_and_card(arch, ShapeSpec("prefill_3k", "prefill", seq, batch),
                         mesh=one, reduced=True)
    log(f"[dryrun] (d) reduced {arch} decomposed prefill, batch {batch} x "
        f"seq {seq} (flash attention: {-(-seq // 1024)} K/V blocks): "
        f"{pre['cell']['flops']:.0f} flops on meta == FlopCounterMode over "
        f"one step on the card")
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    if any(_gemm_launches(launched).values()) or \
            launched["decode_attention"] != dec["attention_launches"]:
        raise AssertionError(f"dryrun: launched kernels {launched}")
    return {"cells": cells, "train": {"flops": cell["flops"],
                                      "bound_ms": bound_ms,
                                      "step_ms": step_ms, "share": share},
            "decode_flops": dec["cell"]["flops"],
            "prefill_flops": pre["cell"]["flops"]}


# ------------------------------------------------------------ phase 4k
EXAMPLES_USED = ("act_quant", "bitserial_matmul")
EXAMPLES_UNUSED = ("act_quant_rows", "grouped_dequant_matmul",
                   "packed_bitserial_matmul", "grouped_matmul")
# (b): qwen3-8b at full width, its depth cut as in phase 4g; seeded weights.
SWEEP_FULL_LAYERS = 4
SWEEP_FULL_SEED = 11


def _example(name: str):
    """``examples/<name>_torch.py`` as a module."""
    import importlib
    path = str(ROOT / "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name + "_torch")


def _on_path(label: str, fn, total: dict):
    """``fn()`` with its launches counted (kernels 1 and 3, and decode
    attention) and added to the path's ``total``."""
    out, res = _profiled(label, fn, EXAMPLES_USED, EXAMPLES_UNUSED)
    for k, v in res["launches"].items():
        total[k] = total.get(k, 0) + v
    return out, res


def _plain(label: str, fn):
    """``fn()`` on the plain ``decomposed`` backend: launches no GEMM
    kernel (decode attention is not in ``KERNELS``)."""
    return _profiled(label, fn, (), tuple(KERNELS))


def _examples_twins(total: dict) -> dict:
    """(a): each twin's ``main`` on the card, against its plain replay."""
    import shutil

    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import LM
    card = MIXED_KW["device"]
    dev = ["--device", card]
    res = {}
    # quickstart: the int32 accumulators of section 4 at w2..w8.
    qs = _example("quickstart")
    got, res["quickstart"] = _on_path("examples-quickstart",
                                      lambda: qs.main(dev), total)
    plain, _ = _plain("examples-quickstart-plain",
                      lambda: qs.run(card, "decomposed"))
    for bits in qs.WIDTHS:
        if not (torch.equal(got["acc"][bits], plain["acc"][bits])
                and torch.equal(got["y"][bits], plain["y"][bits])):
            raise AssertionError(f"quickstart: w{bits}a8 differs from the "
                                 "plain replay")
    log("[examples] quickstart: int32 accumulators and outputs at w"
        f"{'/'.join(map(str, qs.WIDTHS))}a8 bit-equal to the plain replay")
    # serve_quantized and long_context_ssm: equal streams.
    for name, key in (("serve_quantized", "results"),
                      ("long_context_ssm", "tokens")):
        mod = _example(name)
        got, res[name] = _on_path(f"examples-{name}", lambda: mod.main(dev),
                                  total)
        plain, _ = _plain(f"examples-{name}-plain", lambda: mod.run(
            device=card, backend="decomposed"))
        same = (got[key] == plain[key]) if key == "results" \
            else torch.equal(got[key], plain[key])
        if not same:
            raise AssertionError(f"{name}: streams differ from the plain "
                                 "replay")
        log(f"[examples] {name}: streams equal to the plain replay's")
    # precision_sweep (reduced): the six CEs against the plain replay on
    # the trained weights.
    sw = _example("precision_sweep")
    got, res["precision_sweep"] = _on_path(
        "examples-precision_sweep", lambda: sw.main(dev), total)
    model = LM(reduced_config("qwen3-8b"))
    held = sw.batch_on(sw.data_for(model.cfg.vocab_size), sw.HELD_OUT_STEP,
                       torch.device(card))
    plain, _ = _plain("examples-precision_sweep-plain", lambda: sw.evaluate(
        model, got["params"], held, "decomposed", say=lambda _: None))
    ces = {k: v["ce"] for k, v in got["sweep"].items()}
    if ces != {k: v["ce"] for k, v in plain.items()}:
        raise AssertionError(f"precision_sweep: CEs {ces} differ from the "
                             f"plain replay's {plain}")
    res["precision_sweep"].update(ce=ces, train_ce=got["train_ce"])
    log("[examples] precision_sweep: the six CEs bit-equal to the plain "
        f"replay's: {json.dumps(ces)}")
    # train_qat: the ci preset (fake_quant: no kernel), then resumed from
    # its step 30.
    tq = _example("train_qat")
    directory = ROOT / "build" / "examples" / "train_qat"
    shutil.rmtree(directory, ignore_errors=True)
    argv = dev + ["--ckpt-dir", str(directory)]
    first, res["train_qat"] = _plain("examples-train_qat",
                                     lambda: tq.main(argv))
    steps = ckpt.list_steps(str(directory))
    ckpt.remove(str(directory), steps[-1])
    resumed, _ = _plain("examples-train_qat-resumed", lambda: tq.main(argv))
    differ = sum(not torch.equal(a, b) for a, b in
                 _leaf_pairs(first["state"], resumed["state"]))
    if steps != [30, 60] or differ:
        raise AssertionError(f"train_qat: saved {steps}; {differ} leaves of "
                             "the resumed run differ")
    log(f"[examples] train_qat: ci preset saved steps {steps}; resumed from "
        "step 30, its state equals the uninterrupted run's bit for bit")
    shutil.rmtree(directory, ignore_errors=True)
    return res


def _sweep_full(card_name: str, total: dict) -> dict:
    """(b): the sweep's evaluation at qwen3-8b's full width."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import LayerPrecision
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import ops, ref
    sw = _example("precision_sweep")
    card = MIXED_KW["device"]
    cfg, model, params = _build_model(SWEEP_FULL_LAYERS, None,
                                      superplane=False, seed=SWEEP_FULL_SEED,
                                      prepare=False)
    held = sw.batch_on(sw.data_for(cfg.vocab_size), sw.HELD_OUT_STEP,
                       torch.device(card))
    log(f"[examples] (b) full-width sweep: {cfg.name} d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size} (head N = {cfg.padded_vocab}), depth cut "
        f"{get_config('qwen3-8b').num_layers} -> {SWEEP_FULL_LAYERS}, batch "
        f"{sw.BATCH} x seq {sw.SEQ_LEN} = {sw.BATCH * sw.SEQ_LEN} rows a "
        f"projection; seeded weights (seed {SWEEP_FULL_SEED}) with no QAT: "
        "these CEs are of an UNTRAINED model (only the mechanics and the "
        f"equality are checked); {card_name}")
    rows = {}
    for name in sw.policies("cuda"):
        got, rows[name] = _on_path(f"examples-sweep-full {name}",
                                   lambda: sw.evaluate(
                                       model, params, held, "cuda", say=log,
                                       names=(name,)), total)
        plain, rep = _plain(f"examples-sweep-full {name} plain",
                            lambda: sw.evaluate(model, params, held,
                                                "decomposed",
                                                say=lambda _: None,
                                                names=(name,)))
        if got[name]["ce"] != plain[name]["ce"]:
            raise AssertionError(f"sweep-full {name}: CE {got[name]['ce']} "
                                 f"!= plain {plain[name]['ce']}")
        rows[name].update(ce=got[name]["ce"], plain_s=rep["s"])
    # Kernel 3 on the fixed-width planes themselves (a comparison, off the
    # path): 512 rows of kernel-1 codes against the plain version, for an
    # MLP projection and the head at every width.
    gen = torch.Generator(device=card)
    gen.manual_seed(SWEEP_FULL_SEED)
    for label, w in (("layers.0.pos0.mlp.up_proj",
                      params["layers"][0]["pos0"]["mlp"]["up_proj"]["w"]),
                     ("lm_head", params["lm_head"]["w"])):
        w = w.to(torch.float32)
        x = torch.randn((sw.BATCH * sw.SEQ_LEN, w.shape[0]), device=card,
                        generator=gen).to(torch.bfloat16)
        x_q, _ = ops.quantize_activations(x, 8)
        for bits in (8, 6, 4, 3, 2):
            qw = ops.prepare_weight(w, LayerPrecision(bits, 8))
            shifts = tuple(2 * c for c in range(qw.planes.shape[0]))
            if not torch.equal(bsm.bitserial_matmul(x_q, qw.planes, shifts),
                               ref.bitserial_matmul_ref(x_q, qw.planes,
                                                        shifts)):
                raise AssertionError(f"sweep-full: kernel 3 on {label} w{bits}"
                                     " planes differs from its plain version")
            del qw
        log(f"[examples] (b) kernel 3 on {label}'s fixed-width planes "
            f"(K x N = {w.shape[0]} x {w.shape[1]}, M = {x_q.shape[0]}) at "
            "w8/w6/w4/w3/w2 bit-equal to its plain version")
        del w, x, x_q
    del params
    return rows


def phase_examples(card: str) -> dict:
    total: dict = {}
    t = time.perf_counter()
    twins = _examples_twins(total)
    twins_s = time.perf_counter() - t
    t = time.perf_counter()
    full = _sweep_full(card, total)
    full_s = time.perf_counter() - t
    _check_launches("examples", total, EXAMPLES_USED, EXAMPLES_UNUSED)
    log("[examples] launches of the path (the twins' mains and (b)'s cuda "
        f"evaluations): {json.dumps(total, sort_keys=True)}; (a) "
        f"{twins_s:.1f}s, (b) {full_s:.1f}s")
    return {"twins": twins, "sweep_full": full, "twins_s": twins_s,
            "sweep_full_s": full_s, "launches": total}


# --------------------------------------------------------------- phase 5
def phase_fixed() -> dict:
    from repro_torch.core.policy import uniform_policy
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import engine as engine_mod
    policy = uniform_policy(4, 8, backend="cuda")
    cfg, model, params = _build_model(4, policy, superplane=False, seed=2)
    log("[fixed] depth cut: 4 of qwen3-8b's 36 layers")
    reqs = _requests(6, cfg.vocab_size, 16, None, seed=3)
    kw = dict(max_batch=4, max_len=256, decode_chunk=8, device="cuda")
    runs = {}
    # The int8 KV cache, then the int4 one (two codes a byte).
    for kv in (8, 4):
        label = f"fixed-kv{kv}"
        eng = engine_mod.ServeEngine(model, params, Runtime(policy=policy),
                                     kv_bits=kv, **kw)
        runs[kv] = _serve(eng, reqs, label)
        _check_streams(label, runs[kv]["tokens"], reqs, cfg.padded_vocab)
        _check_launches(label, runs[kv]["stats"]["launches"],
                        used=("act_quant", "bitserial_matmul"),
                        unused=("packed_bitserial_matmul", "grouped_matmul"))
        del eng
        ref_eng = engine_mod.ServeEngine(
            model, params, Runtime(policy=policy.with_backend("decomposed")),
            kv_bits=kv, **kw)
        _check_plain(label, _serve(ref_eng, reqs, label + "-plain"),
                     runs[kv])
        del ref_eng
    del params
    gc.collect()                   # engines and handles form cycles
    # The LSB-first packed store of the same weights (kernel 5 at base 0).
    _, model, params = _build_model(4, policy, superplane=False, seed=2,
                                    packed=True)
    for kv in (8, 4):
        label = f"fixed-kv{kv}-packed"
        eng = engine_mod.ServeEngine(model, params, Runtime(policy=policy),
                                     packed=True, kv_bits=kv, **kw)
        packed = _serve(eng, reqs, label)
        _check_launches(label, packed["stats"]["launches"],
                        used=("packed_bitserial_matmul", "act_quant"),
                        unused=("bitserial_matmul", "grouped_matmul"))
        _check_same(label, packed["tokens"], runs[kv]["tokens"],
                    "the int8-plane store's")
        del eng
    if runs[4]["tokens"] == runs[8]["tokens"]:
        log("[fixed] note: the int4 KV streams equal the int8 ones")
    return runs[8]["stats"]


# --------------------------------------------------------------- phase 6
# Device cycles the card spins before each timed call (about 1 ms at the
# H100's clock), so that the host has enqueued the call before the start
# event runs and the time is the device's alone, not the wrapper's.
HEAD_START_CYCLES = 2_000_000


def _time_ms(fn, flush, reps: int = 25, warm: int = 3) -> float:
    """Median CUDA-event ms of ``fn``, the L2 cache flushed before each
    timed call (``flush`` is a buffer larger than it): a decode step reads
    each weight once, so the GEMMs find their weights cold.  A one-byte
    ``flush`` leaves the L2 warm."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HEAD_START_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound_ms(nbytes: float, ops: float) -> tuple:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / INT8_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def phase_times() -> dict:
    import torch
    from repro_torch.core import decompose
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ref
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    rows = []
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    log("[times] each call timed with a cold L2 (256 MB written before it)")
    log("[times] library_ms: torch._int_mm on the recomposed 8-bit weight for "
        "bitserial_matmul and packed_bitserial_matmul at P=4 and M > 16 (it "
        "rejects M <= 16); no single PyTorch call computes act_quant, "
        "act_quant_rows, grouped_matmul or grouped_dequant_matmul")
    log("[times] bound_ms of the GEMMs: operations 2*M*K*N, the weight's MACs "
        "once (the function is x @ the weight its planes compose, one int8 "
        "pass), not once per plane")

    def row(kernel, shape, fn, plain, nbytes, ops, library=None,
            flush=flush):
        ms = _time_ms(fn, flush)
        plain_ms = _time_ms(plain, flush, reps=5, warm=1)
        lib_ms = None
        if library is not None:
            try:
                lib_ms = _time_ms(library, flush)
            except RuntimeError as e:   # the library's own shape check
                log(f"[times] {kernel} {shape}: no library time: {e}")
        bound, by = _bound_ms(nbytes, ops)
        r = {"name": kernel, "shape": shape, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
        log("[times] " + json.dumps(r))
        rows.append(r)

    # The launch floor: an empty kernel, with the same spin and events.
    dev = torch.device("cuda")
    floor = _time_ms(lambda: aq.noop(dev), flush)
    log("[times] " + json.dumps({"launch_floor_ms": floor}))
    log("[times] act_quant rows: bf16 is the call as the main path makes "
        "it (kernel 2 gathering the rows by perm); f32 reads f32 rows; "
        "'gather+cast f32' times index_select, the f32 copy and the f32 "
        "launch, a call site that gathers and widens x before the kernel; "
        "'warm L2' flushes nothing, as a step finds x just written")
    # A one-byte "flush": the inputs stay in L2 from the warm-up calls.
    no_flush = torch.empty(1, dtype=torch.uint8, device="cuda")
    for m, k in ((8, 4096), (64, 4096), (8, 12288), (64, 12288)):
        xb = torch.randn((m, k), device="cuda", generator=gen
                         ).to(torch.bfloat16)
        xf = xb.float()
        perm = torch.randperm(m, device="cuda", generator=gen)
        qmax = torch.full((m, 1), 7.0, device="cuda")
        # x read once, codes and scales written once; kernel 2 also reads
        # qmax and perm.
        out = m * k + m * 4
        row("act_quant", f"M={m} K={k} bits=8 bf16",
            lambda: aq.act_quant(xb), lambda: ref.act_quant_ref(xb),
            2 * m * k + out, 0)
        row("act_quant", f"M={m} K={k} bits=8 f32",
            lambda: aq.act_quant(xf), lambda: ref.act_quant_ref(xf),
            4 * m * k + out, 0)
        row("act_quant_rows", f"M={m} K={k} bf16 perm",
            lambda: aq.act_quant_rows(xb, qmax, perm=perm),
            lambda: ref.act_quant_rows_ref(xb, qmax, perm=perm),
            2 * m * k + out + m * 12, 0)
        row("act_quant_rows", f"M={m} K={k} f32",
            lambda: aq.act_quant_rows(xf, qmax),
            lambda: ref.act_quant_rows_ref(xf, qmax),
            4 * m * k + out + m * 4, 0)
        if m == 8:
            row("act_quant_rows", f"M={m} K={k} gather+cast f32",
                lambda: aq.act_quant_rows(xb.index_select(0, perm).float(),
                                          qmax),
                lambda: ref.act_quant_rows_ref(xb, qmax, perm=perm),
                2 * m * k + out + m * 12, 0)
            row("act_quant_rows", f"M={m} K={k} bf16 perm warm L2",
                lambda: aq.act_quant_rows(xb, qmax, perm=perm),
                lambda: ref.act_quant_rows_ref(xb, qmax, perm=perm),
                2 * m * k + out + m * 12, 0, flush=no_flush)
        else:
            row("act_quant", f"M={m} K={k} bits=8 cast f32",
                lambda: aq.act_quant(xb.float()),
                lambda: ref.act_quant_ref(xb), 2 * m * k + out, 0)
            row("act_quant", f"M={m} K={k} bits=8 bf16 warm L2",
                lambda: aq.act_quant(xb), lambda: ref.act_quant_ref(xb),
                2 * m * k + out, 0, flush=no_flush)
    for m in (8, 64):
        for k, n in GEMM_SHAPES:
            x, planes = _inputs(m, k, n, gen)
            packed = ops.pack_planes(planes.flip(0), 8)
            lib = None
            if m > 16:
                w8 = decompose.recompose_weights(
                    planes.flip(0), 8).to(torch.int8).contiguous()
                lib = (lambda x=x, w8=w8: torch._int_mm(x, w8))
            for p in (4, 2, 1):
                pre = planes[:p]
                sh = decompose.prefix_shifts(p)
                row("bitserial_matmul", f"M={m} K={k} N={n} P={p}",
                    lambda pre=pre, sh=sh: bsm.bitserial_matmul(x, pre, sh),
                    lambda pre=pre, sh=sh: ref.bitserial_matmul_ref(x, pre, sh),
                    m * k + p * k * n + 4 * m * n, 2.0 * m * k * n,
                    lib if p == 4 else None)
                # The packed store reads one byte per weight at any P.
                row("packed_bitserial_matmul", f"M={m} K={k} N={n} P={p}",
                    lambda p=p: bsm.packed_bitserial_matmul(
                        x, packed, w_bits=8, eff_bits=2 * p),
                    lambda p=p: ref.packed_bitserial_matmul_ref(
                        x, packed, 8, 2 * p),
                    m * k + k * n + 4 * m * n, 2.0 * m * k * n,
                    lib if p == 4 else None)
            mult, xs, ws, rg = _grouped_args(_mixed_layout(m), n, gen)
            scales = m * 16 + m * 4 + 3 * n * 4 + m * 4
            for label, w, lay in (("", planes, {}),
                                  (" packed", packed, {"packed": True})):
                wbytes = w.numel()
                row("grouped_dequant_matmul", f"M={m} K={k} N={n} Pmax=4{label}",
                    lambda w=w, lay=lay: gmm.grouped_dequant_matmul(
                        x, w, mult, xs, ws, rg, **lay),
                    lambda w=w, lay=lay: ref.grouped_dequant_matmul_ref(
                        x, w, mult, xs, ws, rg, **lay),
                    m * k + wbytes + scales + 2 * m * n, 2.0 * m * k * n)
                row("grouped_matmul", f"M={m} K={k} N={n} Pmax=4{label}",
                    lambda w=w, lay=lay: gmm.grouped_matmul(x, w, mult, **lay),
                    lambda w=w, lay=lay: ref.grouped_matmul_ref(x, w, mult,
                                                                **lay),
                    m * k + wbytes + m * 16 + 4 * m * n, 2.0 * m * k * n)
            del x, planes, packed, lib
            torch.cuda.empty_cache()
    # The shift GEMMs at a BatchServeEngine prefill's rows (M > 64: more
    # than one row tile), P = 4 and 1, beside torch._int_mm at P = 4.
    for m in PREFILL_ROWS:
        for k, n in GEMM_SHAPES:
            x, planes = _inputs(m, k, n, gen)
            packed = ops.pack_planes(planes.flip(0), 8)
            w8 = decompose.recompose_weights(
                planes.flip(0), 8).to(torch.int8).contiguous()
            lib = (lambda x=x, w8=w8: torch._int_mm(x, w8))
            for p in (4, 1):
                pre = planes[:p]
                sh = decompose.prefix_shifts(p)
                row("bitserial_matmul", f"M={m} K={k} N={n} P={p}",
                    lambda pre=pre, sh=sh: bsm.bitserial_matmul(x, pre, sh),
                    lambda pre=pre, sh=sh: ref.bitserial_matmul_ref(x, pre, sh),
                    m * k + p * k * n + 4 * m * n, 2.0 * m * k * n,
                    lib if p == 4 else None)
                row("packed_bitserial_matmul", f"M={m} K={k} N={n} P={p}",
                    lambda p=p: bsm.packed_bitserial_matmul(
                        x, packed, w_bits=8, eff_bits=2 * p),
                    lambda p=p: ref.packed_bitserial_matmul_ref(
                        x, packed, 8, 2 * p),
                    m * k + k * n + 4 * m * n, 2.0 * m * k * n,
                    lib if p == 4 else None)
            del x, planes, packed, w8, lib
            torch.cuda.empty_cache()
    # The verify window of a speculative round: M = SPEC_SLOTS * (SPEC_K+1)
    # rows in the three-tier verify layout (groups of n * (k+1) rows).
    layout, qmax, perm = _verify_layout(VERIFY_TIER_MIXES[0])
    m = sum(r for r, _ in layout)
    xb = torch.randn((m, 4096), device="cuda", generator=gen
                     ).to(torch.bfloat16)
    row("act_quant_rows", f"M={m} K=4096 bf16 perm verify",
        lambda: aq.act_quant_rows(xb, qmax, perm=perm),
        lambda: ref.act_quant_rows_ref(xb, qmax, perm=perm),
        2 * m * 4096 + m * 4096 + m * 4 + m * 12, 0)
    for k, n in ((4096, 12288), (4096, 152064)):
        x, planes = _inputs(m, k, n, gen)
        packed = ops.pack_planes(planes.flip(0), 8)
        mult, xs, ws, rg = _grouped_args(layout, n, gen)
        pre = planes[:mult.shape[1]].contiguous()
        scales = m * 16 + m * 4 + len(layout) * n * 4 + m * 4
        for label, w, lay in (("", pre, {}),
                              (" packed", packed, {"packed": True})):
            row("grouped_dequant_matmul",
                f"M={m} K={k} N={n} verify {layout}{label}",
                lambda w=w, lay=lay: gmm.grouped_dequant_matmul(
                    x, w, mult, xs, ws, rg, **lay),
                lambda w=w, lay=lay: ref.grouped_dequant_matmul_ref(
                    x, w, mult, xs, ws, rg, **lay),
                m * k + w.numel() + scales + 2 * m * n,
                2.0 * m * k * n)
        del x, planes, packed, pre
        torch.cuda.empty_cache()
    # Phase 4e's new shapes: mamba2-1.3b's in_proj (K = 2048, N = 8512)
    # and out_proj (K = 4096), llama4's experts (K = 5120, N = 8192; down:
    # K = 8192, N = 5120).  Kernels 1 and 2 at K = 2048, 5120 and 8192
    # take the generic path (no register-resident instantiation there).
    for m, k in ((8, 1024), (64, 1024), (8, 2048), (64, 2048), (8, 5120),
                 (64, 5120), (8, 8192), (64, 8192)):
        xb = torch.randn((m, k), device="cuda", generator=gen
                         ).to(torch.bfloat16)
        perm = torch.randperm(m, device="cuda", generator=gen)
        qmax = torch.full((m, 1), 7.0, device="cuda")
        out = m * k + m * 4
        row("act_quant", f"M={m} K={k} bits=8 bf16",
            lambda: aq.act_quant(xb), lambda: ref.act_quant_ref(xb),
            2 * m * k + out, 0)
        row("act_quant_rows", f"M={m} K={k} bf16 perm",
            lambda: aq.act_quant_rows(xb, qmax, perm=perm),
            lambda: ref.act_quant_rows_ref(xb, qmax, perm=perm),
            2 * m * k + out + m * 12, 0)
    # Phase 4i's wire quantizer: kernel 1 on rank 1's f32 K-shard of 64
    # rows 4096 wide (n = 2: K = 2048; n = 4: K = 1024).
    for k in (2048, 1024):
        xw = torch.randn((64, 4096), device="cuda", generator=gen)
        xs_ = xw[:, k:2 * k]
        row("act_quant", f"M=64 K={k} bits=8 f32 tp shard",
            lambda xs_=xs_: aq.act_quant(xs_),
            lambda xs_=xs_: ref.act_quant_ref(xs_),
            4 * 64 * k + 64 * k + 64 * 4, 0)
    for m in (8, 64):
        for k, n in ARCH_GEMM_SHAPES:
            x, planes = _inputs(m, k, n, gen)
            packed = ops.pack_planes(planes.flip(0), 8)
            lib = None
            if m > 16:
                w8 = decompose.recompose_weights(
                    planes.flip(0), 8).to(torch.int8).contiguous()
                lib = (lambda x=x, w8=w8: torch._int_mm(x, w8))
                row("bitserial_matmul", f"M={m} K={k} N={n} P=4",
                    lambda: bsm.bitserial_matmul(
                        x, planes, decompose.prefix_shifts(4)),
                    lambda: ref.bitserial_matmul_ref(
                        x, planes, decompose.prefix_shifts(4)),
                    m * k + 4 * k * n + 4 * m * n, 2.0 * m * k * n, lib)
                row("packed_bitserial_matmul", f"M={m} K={k} N={n} P=4",
                    lambda: bsm.packed_bitserial_matmul(x, packed, w_bits=8,
                                                        eff_bits=8),
                    lambda: ref.packed_bitserial_matmul_ref(x, packed, 8, 8),
                    m * k + k * n + 4 * m * n, 2.0 * m * k * n, lib)
            else:
                mult, xs, ws, rg = _grouped_args(_mixed_layout(m), n, gen)
                scales = m * 16 + m * 4 + 3 * n * 4 + m * 4
                for label, w, lay in (("", planes, {}),
                                      (" packed", packed, {"packed": True})):
                    row("grouped_dequant_matmul",
                        f"M={m} K={k} N={n} Pmax=4{label}",
                        lambda w=w, lay=lay: gmm.grouped_dequant_matmul(
                            x, w, mult, xs, ws, rg, **lay),
                        lambda w=w, lay=lay: ref.grouped_dequant_matmul_ref(
                            x, w, mult, xs, ws, rg, **lay),
                        m * k + w.numel() + scales + 2 * m * n,
                        2.0 * m * k * n)
            del x, planes, packed, lib
            torch.cuda.empty_cache()
    # Phase 4f's shapes.  The one-pass profiler: (8 + 1) groups of 2 x 16
    # rows (M = 288), the base group and seven probes at Pmax 4 and the
    # probed layer's group at 1, 2 or 3 planes; kernel 1 quantizes the 288
    # rows (8-bit activations everywhere: one config), and kernel 2 at the
    # same rows (perm expanded over the 16 positions) stands beside it.
    # The joint measurement: 5 groups of 32 (M = 160).  The sequential
    # profiler: kernel 3 at M = 32 (2 x 16).
    for k in (4096, 12288):
        m = 288
        xb = torch.randn((m, k), device="cuda", generator=gen
                         ).to(torch.bfloat16)
        perm = (torch.randperm(m // 16, device="cuda", generator=gen)
                .reshape(-1, 1) * 16 + torch.arange(16, device="cuda")
                ).reshape(-1)
        qmax = torch.full((m, 1), 127.0, device="cuda")
        out = m * k + m * 4
        row("act_quant", f"M={m} K={k} bits=8 bf16 profile",
            lambda: aq.act_quant(xb), lambda: ref.act_quant_ref(xb),
            2 * m * k + out, 0)
        row("act_quant_rows", f"M={m} K={k} bf16 perm profile",
            lambda: aq.act_quant_rows(xb, qmax, perm=perm),
            lambda: ref.act_quant_rows_ref(xb, qmax, perm=perm),
            2 * m * k + out + m * 12, 0)
    joint = ((32, 4), (32, 1), (32, 2), (32, 3), (32, 4))
    for m, k, n, probe in ((288, 4096, 12288, (1, 2, 3)),
                           (288, 4096, 152064, (1,)),
                           (160, 4096, 12288, (None,))):
        x, planes = _inputs(m, k, n, gen)
        for p in probe:
            layout = joint if p is None else tuple(
                (32, p if g == 1 else 4) for g in range(9))
            mult, xs, ws, rg = _grouped_args(layout, n, gen)
            scales = m * 16 + m * 4 + len(layout) * n * 4 + m * 4
            row("grouped_dequant_matmul",
                f"M={m} K={k} N={n} groups {len(layout)}x32 "
                f"Pmax {[q for _, q in layout]}",
                lambda: gmm.grouped_dequant_matmul(x, planes, mult, xs, ws,
                                                   rg),
                lambda: ref.grouped_dequant_matmul_ref(x, planes, mult, xs,
                                                       ws, rg),
                m * k + planes.numel() + scales + 2 * m * n,
                2.0 * m * k * n)
        del x, planes
        torch.cuda.empty_cache()
    for k, n in ((4096, 12288), (4096, 152064)):
        m = 32
        x, planes = _inputs(m, k, n, gen)
        w8 = decompose.recompose_weights(planes.flip(0), 8).to(
            torch.int8).contiguous()
        lib = (lambda x=x, w8=w8: torch._int_mm(x, w8))
        for p in (4, 1):
            pre = planes[:p]
            sh = decompose.prefix_shifts(p)
            row("bitserial_matmul", f"M={m} K={k} N={n} P={p} sequential",
                lambda pre=pre, sh=sh: bsm.bitserial_matmul(x, pre, sh),
                lambda pre=pre, sh=sh: ref.bitserial_matmul_ref(x, pre, sh),
                m * k + p * k * n + 4 * m * n, 2.0 * m * k * n,
                lib if p == 4 else None)
        del x, planes, w8, lib
        torch.cuda.empty_cache()
    # Phase 4k's sweep: kernel 3 on fixed-width LSB-first planes (w3: one
    # signed 3-bit plane) at M = 512 rows, an MLP projection and the head,
    # beside torch._int_mm on the recomposed weight.
    for k, n in ((4096, 12288), (4096, 152064)):
        m = 512
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device="cuda",
                          generator=gen)
        for bits in (2, 3, 4, 6, 8):
            planes = _fixed_planes(bits, k, n, gen)
            p = planes.shape[0]
            sh = tuple(2 * c for c in range(p))
            w8 = decompose.recompose_weights(planes, bits).to(
                torch.int8).contiguous()
            row("bitserial_matmul", f"M={m} K={k} N={n} w{bits} fixed P={p}",
                lambda planes=planes, sh=sh: bsm.bitserial_matmul(
                    x, planes, sh),
                lambda planes=planes, sh=sh: ref.bitserial_matmul_ref(
                    x, planes, sh),
                m * k + p * k * n + 4 * m * n, 2.0 * m * k * n,
                lambda w8=w8: torch._int_mm(x, w8))
            del planes, w8
            torch.cuda.empty_cache()
        del x
    return {"rows": rows, "launch_floor_ms": floor}


# ------------------------------------------------------------ phase 7
# The benchmark's qwen3-8b cells that run decode attention: (traffic mix,
# max_batch, max_len), and qwen3-8b's heads (query heads, KV heads, size).
ATTN_CELLS = (("reason-decode", 64, 2048), ("rag-prefill", 32, 3328))
ATTN_HEADS = (32, 8, 128)


def _mix_lengths(traffic: str, b: int, smax: int, seed: int):
    """Slot lengths as the benchmark's mix draws its requests
    (``bench/traffic/<traffic>.json``): ``b`` prompts and ``b`` answers at
    the stratified quantiles of their clipped log-normals, shuffled, each
    slot a uniform part of the way through its answer."""
    import numpy as np
    spec = json.loads((ROOT / "bench" / "traffic" / f"{traffic}.json")
                      .read_text())
    rng = np.random.default_rng(seed)
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / b) for i in range(b)])

    def draw(d):
        x = np.clip(np.rint(d["median"] * np.exp(d["sigma"] * z)), d["min"],
                    d["max"]).astype(np.int64)
        return rng.permutation(x)
    n = draw(spec["prompt"]) + np.floor(
        rng.random(b) * draw(spec["output"])).astype(np.int64)
    return np.minimum(n, smax)


def _attention_within(got, q, cache) -> float:
    """Largest |kernel - plain| over its tolerance (must be <= 1): 2^-7
    |plain| + (2^-8 + Smax 2^-23) sum_t p_t |v_t| (each bf16 probability
    may round the other way, the f32 sums reorder, the output rounds)."""
    import torch
    from repro_torch.models import layers
    k, v = cache.read(torch.bfloat16)
    want = layers._decode_core(q, k, v, length=cache.length)
    b, _, h, dh = q.shape
    kvh, smax = k.shape[2], k.shape[1]
    sc = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(b, kvh, -1, dh),
                      k.float()) / dh ** 0.5
    valid = torch.arange(smax, device=q.device)[None] < cache.length[:, None]
    p = torch.softmax(sc.masked_fill(~valid[:, None, None], layers.NEG), -1)
    mag = torch.einsum("bkgs,bskd->bkgd", p, v.float().abs())
    tol = want.float().abs() * 2 ** -7 + \
        mag.reshape(b, 1, h, dh) * (2 ** -8 + smax * 2 ** -23)
    return ((got.float() - want.float()).abs() / tol.clamp_min(1e-30)
            ).max().item()


def phase_attention(mixed: dict) -> dict:
    """Phase 7: the decode-attention kernel at the benchmark's qwen3-8b
    shapes; see the module docstring."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dattn
    from repro_torch.models import layers
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    h, kvh, dh = ATTN_HEADS
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for traffic, b, smax in ATTN_CELLS:
        n = torch.from_numpy(_mix_lengths(traffic, b, smax, 7)).to(
            torch.int32).cuda()
        q = torch.randn((b, 1, h, dh), device="cuda", generator=gen).to(
            torch.bfloat16)
        worst = {}
        for kv_bits in ((None, 8, 4, (16, 8, 4)) if b == 64 else (None,)):
            cache = layers.KVCache.create(b, smax, kvh, dh, kv_bits=kv_bits,
                                          device="cuda")
            if cache.mixed:
                cache.kv_bits.copy_(torch.tensor(
                    [(16, 8, 4)[i % 3] for i in range(b)], dtype=torch.int32))
            cache.update(*(torch.randn((b, smax, kvh, dh), device="cuda",
                                       generator=gen).to(torch.bfloat16)
                           for _ in range(2)), 0, new_length=n)
            before = _build.LAUNCHES["decode_attention"]
            worst[str(kv_bits)] = _attention_within(
                dattn.decode_attention(q, cache), q, cache)
            if _build.LAUNCHES["decode_attention"] != before + 1 or \
                    worst[str(kv_bits)] > 1.0:
                raise AssertionError(f"attention: {traffic} kv_bits "
                                     f"{kv_bits}: {worst}")
        # Timed on a bf16 arena, the cells': at reason's shape the loop
        # ended on the mixed one.
        if cache.mixed:
            cache = layers.KVCache.create(b, smax, kvh, dh, device="cuda")
            cache.update(*(torch.randn((b, smax, kvh, dh), device="cuda",
                                       generator=gen).to(torch.bfloat16)
                           for _ in range(2)), 0, new_length=n)
        ms = _time_ms(lambda: dattn.decode_attention(q, cache), flush)
        plain_ms = _time_ms(lambda: layers._decode_core(
            q, *cache.read(torch.bfloat16), length=cache.length), flush,
            reps=5, warm=1)
        kt, vt = (t.transpose(1, 2).contiguous() for t in (cache.k, cache.v))
        mask = (torch.arange(smax, device="cuda")[None] <
                n[:, None])[:, None, None, :]
        qt = q.transpose(1, 2)
        try:
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                           enable_gqa=True)
            lib = (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
        except TypeError:          # no enable_gqa: heads expanded first
            kt, vt = (t.repeat_interleave(h // kvh, 1) for t in (kt, vt))
            lib = (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        library_ms = _time_ms(lib, flush)
        del kt, vt
        nbytes = int(n.sum()) * kvh * dh * 2 * 2 + 2 * b * h * dh * 2 + 4 * b
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        mean = float(n.float().mean())
        row = {"shape": f"{traffic}: B={b} Smax={smax} H={h} KVH={kvh} "
                        f"Dh={dh} bf16, lengths mean {mean:.1f} max "
                        f"{int(n.max())}",
               "ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "plain_ms": plain_ms, "library_ms": library_ms,
               "share_of_bound": bound_ms / ms, "within": worst}
        log("[attention] " + json.dumps(row))
        rows.append(row)
        del cache, q
        torch.cuda.empty_cache()
    steps = mixed["decode_steps"]
    launches = mixed["launches"]["decode_attention"]
    log(f"[attention] phase 3's run: {launches} launches over {steps} "
        f"decode steps ({launches / steps:.0f} a step)")
    return {"rows": rows, "launches": launches, "decode_steps": steps}


# ------------------------------------------------------------------ main
# The shape each kernel's summary entry reports: its heaviest serving shape
# on the path that runs it (prefill M=64 for act_quant and the shift GEMMs,
# mixed-tier decode M=8 for act_quant_rows and the grouped GEMMs; the packed
# store for grouped_matmul, whose only caller is the kernel-level API).
SUMMARY_SHAPE = {
    "act_quant": "M=64 K=4096 bits=8 bf16",
    "act_quant_rows": "M=8 K=4096 bf16 perm",
    "bitserial_matmul": "M=64 K=4096 N=12288 P=4",
    "grouped_dequant_matmul": "M=8 K=4096 N=12288 Pmax=4",
    "packed_bitserial_matmul": "M=64 K=4096 N=12288 P=4",
    "grouped_matmul": "M=8 K=4096 N=12288 Pmax=4 packed",
}


def main() -> int:
    if len(sys.argv) > 1:
        print("chip_smoke: takes no arguments", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    out = {}
    t0 = time.perf_counter()
    for phase, run in (("build", phase_build), ("parity", phase_parity),
                       ("mixed", phase_mixed),
                       ("packed", lambda: phase_packed(
                           out["mixed"]["streams"])),
                       ("spec", lambda: phase_spec(out["mixed"],
                                                   out["build"]["card"])),
                       ("tiers", lambda: phase_tiers(out["mixed"],
                                                     out["build"]["card"])),
                       ("overload", lambda: phase_overload(
                           out["tiers"], out["build"]["card"])),
                       ("archs", lambda: phase_archs(out["build"]["card"])),
                       ("autoprec", lambda: phase_autoprec(
                           out["build"]["card"])),
                       ("train", lambda: phase_train(out["build"]["card"])),
                       ("tp", lambda: phase_tp(out["mixed"],
                                               out["build"]["card"])),
                       ("dist", lambda: phase_dist(out["build"]["card"])),
                       ("dryrun", lambda: phase_dryrun(
                           out["train"]["full"], out["build"]["card"])),
                       ("examples", lambda: phase_examples(
                           out["build"]["card"])),
                       ("fixed", phase_fixed), ("times", phase_times),
                       ("attention", lambda: phase_attention(out["mixed"]))):
        t = time.perf_counter()
        out[phase] = run()
        sync()
        # Engines and their request handles form reference cycles: collect
        # them so the next phase starts with the card's memory free.
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{phase}] done in {time.perf_counter() - t:.1f}s")
    log(f"[all] {time.perf_counter() - t0:.1f}s")
    by_shape = {(r["name"], r["shape"]): r for r in out["times"]["rows"]}
    kernels = []
    for name, (src, tpu) in KERNELS.items():
        t = by_shape[(name, SUMMARY_SHAPE[name])]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": out[PATH_OF[name]]["launches"][name],
            "path": PATH_OF[name],
            "max_abs_err": out["parity"]["max_abs_err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            "launches_by_path": {path: out[path]["launches"][name]
                                 for path in ("parity", "mixed", "packed",
                                              "spec", "tiers", "overload",
                                              "archs", "autoprec", "train",
                                              "tp", "dist", "examples")}}
        if name.startswith("act_quant"):
            entry["launch_floor_ms"] = out["times"]["launch_floor_ms"]
        if name == "grouped_dequant_matmul":   # its packed mode, on "packed"
            tp = by_shape[(name, SUMMARY_SHAPE[name] + " packed")]
            entry["packed"] = {
                "launches": out["packed"]["launches"][name],
                **{key: tp[key] for key in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "shape")}}
        kernels.append(entry)
    attn = out["attention"]
    kernels.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": None, "launches": attn["launches"], "path": "mixed",
        "decode_steps": attn["decode_steps"], "rows": attn["rows"]})
    print(json.dumps({"kernels": kernels}))
    print(out["build"]["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
