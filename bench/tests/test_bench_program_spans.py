"""The program's spans in a traced run (``benchlib/program.py``, the four
readers of ``bench/metrics/`` that take them, ``bench/spans.py``'s
plumbing): known values on synthetic spans and operations, nothing to read
where the program has no recorder slot, and on the CPU a tiny cell run
through the harness's traced path, the card's trace replaced by a
synthetic one."""
import time

import pytest
import torch

import bench_tiny as T
from benchlib import cell, program, serve, trace

READERS = ["decode_host_ms", "decode_host_ms.rag", "prefill_host_ms.rag",
           "idle_in_blocks_share"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeTrace:
    """A ``DeviceTrace`` stand-in: the stretch and its operations, in us."""

    def __init__(self, t_start, t_stop, ops):
        self.t_start, self.t_stop = t_start, t_stop
        self.ops = [trace.Op("k", a, b) for a, b in ops]

    @property
    def window_us(self):
        return self.t_stop - self.t_start


def _spans(rows):
    """(id, parent, name, start, end) rows as the benchmark's spans."""
    return [trace.Span(name, a, b, {"id": i, "parent": p, "uid": None})
            for i, p, name, a, b in rows]


# One engine step at 0-100 us: admission with one prefill (10-40, its
# first-token wait 35-40), then a chunk of two decode steps (45-90, its
# closing copy 80-90), then the token events (90-98).
ROWS = [
    (1, 0, "step", 0, 100),
    (2, 1, "admit", 5, 42),
    (3, 2, "prefill", 10, 40),
    (4, 3, "embed", 11, 13),
    (5, 3, "attn", 13, 30),
    (6, 5, "linear", 14, 20),
    (7, 3, "head", 30, 34),
    (8, 3, "sync", 35, 40),
    (9, 1, "decode_chunk", 45, 90),
    (10, 9, "decode_step", 46, 62),
    (11, 10, "attn", 47, 55),
    (12, 11, "rope", 48, 50),
    (13, 10, "select", 56, 60),
    (14, 9, "decode_step", 63, 79),
    (15, 14, "mlp", 64, 70),
    (16, 9, "sync", 80, 90),
    (17, 1, "emit", 90, 98),
]
# Gaps of the card (begins in): 0-12 (step, then admit: 12 us in `step`),
# 12-15 (embed), 16-19 (linear), 22-36 (attn), 49-52 (rope), 57-58
# (select), 61-64 (decode_step itself), 66-67 (mlp), 82-95 (sync),
# 99-100 (step).
OPS = [(12, 12), (15, 16), (19, 22), (36, 49), (52, 57), (58, 61),
       (64, 66), (67, 82), (95, 99)]


def _ctx(spans, ops=OPS, t0=0.0, t1=100.0, with_slot=True):
    traced = {"trace": FakeTrace(t0, t1, ops), "spans": []}
    if with_slot:
        traced["program_spans"] = spans
    return cell.Context({}, {}, [], None, traced)


def test_readers_on_synthetic_spans_and_operations():
    ctx = _ctx(_spans(ROWS))
    # The chunk (45 us) less its copy (10), over two decode steps.
    for name in ("decode_host_ms", "decode_host_ms.rag"):
        assert cell.load_reader(name)(ctx) == pytest.approx(17.5e-3)
    # The prefill (30 us) less its first-token wait (5), one prefill.
    assert cell.load_reader("prefill_host_ms.rag")(ctx) == \
        pytest.approx(25e-3)
    # Block gaps: embed 3, linear 3, attn 14, rope 3, select 1, mlp 1 = 25;
    # the rest: step 12 + 1, decode_step 3, sync 13 = 29.
    assert cell.load_reader("idle_in_blocks_share")(ctx) == \
        pytest.approx(100.0 * 25 / 54)


def test_labels_self_time_and_block_table():
    spans = _spans(ROWS)
    label = program.Innermost(spans)
    assert [label(t) for t in (1, 12, 17, 23, 49, 57, 61, 66, 82, 99)] == [
        "host in step", "host in embed", "host in linear", "host in attn",
        "host in rope", "host in select", "host in decode_step",
        "host in mlp", "host in sync", "host in step"]
    assert label(-1) == trace.Labeller.OUTSIDE
    kids = program.children(spans)
    attn = spans[4]
    assert program.self_us(attn, kids[5]) == 17 - 6
    assert program.host_less_sync_us(spans, "prefill") == (25.0, 1)
    table = program.block_table(FakeTrace(0, 100, OPS), spans)
    assert table["decode_steps"] == 2 and table["prefills"] == 1
    assert table["idle_s"] == pytest.approx(54e-6)
    rows = table["blocks"]
    assert rows["attn"]["decode_step_ms"] == pytest.approx(8e-3 / 2)
    assert rows["attn"]["decode_step_self_ms"] == pytest.approx(6e-3 / 2)
    assert rows["attn"]["prefill_ms"] == pytest.approx(17e-3)
    assert rows["attn"]["idle_s"] == pytest.approx(14e-6)
    assert rows["emit"]["decode_step_ms"] == pytest.approx(8e-3 / 2)
    assert rows["sync"]["idle_s"] == pytest.approx(13e-6)


def test_nothing_to_read_without_the_program_spans():
    """An untraced run, a program without the recorder slot (the traced
    dict lacks program spans) and a stretch with no decode step read
    nothing."""
    untraced = cell.Context({}, {}, [], None, None)
    no_slot = _ctx(_spans(ROWS), with_slot=False)
    prefill_only = _ctx(_spans([r for r in ROWS if r[0] <= 8]))
    for name in READERS:
        read = cell.load_reader(name)
        assert read(untraced) is None and read(no_slot) is None
    assert cell.load_reader("decode_host_ms")(prefill_only) is None
    assert cell.load_reader("prefill_host_ms.rag")(prefill_only) == \
        pytest.approx(25e-3)


def test_start_finds_no_slot_in_a_program_without_one(monkeypatch):
    from repro_torch.telemetry import trace as program_trace
    monkeypatch.delattr(program_trace, "CURRENT")
    rec = program.start()
    assert rec is None and program.spans_of(rec) == []
    program.stop(rec)
    assert not hasattr(program_trace, "CURRENT")


@pytest.mark.parametrize("cfg", [T.QWEN, T.MAMBA], ids=["qwen3", "mamba2"])
def test_program_spans_on_the_benchmark_axis(cfg):
    """A tiny engine's spans, recorded through ``program.start`` /
    ``stop``: in us on perf_counter, ids and parents kept, the prefills
    and chunks adding up to the engine's seconds."""
    from repro_torch.telemetry import trace as program_trace
    from benchlib.traffic import Traffic
    eng = serve.build_engine(cfg, T.CLOSED, 2**31 + 5, torch.device("cpu"))
    drv = serve.Driver(eng, Traffic(T.CLOSED, 2**31 + 5, cfg["vocab_size"]))
    t0 = time.perf_counter() * 1e6
    rec = program.start()
    try:
        drv.run_closed(0.5, warm_steps=0)
    finally:
        program.stop(rec)
    t1 = time.perf_counter() * 1e6
    assert program_trace.CURRENT is None
    spans = program.spans_of(rec)
    assert spans and all(t0 <= s.start <= s.end <= t1 for s in spans)
    ids = {s.info["id"] for s in spans}
    assert all(s.info["parent"] in ids or s.info["parent"] == 0
               for s in spans)
    host, n = program.host_less_sync_us(spans, "prefill")
    assert n == eng.stats.prefills
    assert sum(s.end - s.start for s in spans if s.label == "decode_chunk") \
        == pytest.approx(1e6 * eng.stats.decode_seconds, rel=1e-9)


class StretchTrace(FakeTrace):
    """A ``DeviceTrace`` on the CPU: operations of 40 us every 50 us over
    the stretch, anchored on the host's clock."""

    def __init__(self, device):
        super().__init__(0.0, 0.0, [])

    @staticmethod
    def warm(device):
        pass

    def start(self):
        self.t_start = time.perf_counter() * 1e6

    def stop(self):
        self.t_stop = time.perf_counter() * 1e6

    def collect(self):
        t, self.ops = self.t_start, []
        while t < self.t_stop:
            self.ops.append(trace.Op("k", t + 10, min(t + 50, self.t_stop)))
            t += 50


@pytest.mark.parametrize("cfg,mix,name", [
    (T.QWEN, T.CLOSED, "qwen3-8b.reason-decode"),
    (T.QWEN, T.OPEN, "qwen3-8b.rag-prefill"),
    (T.MAMBA, T.CLOSED, "mamba2-1.3b.long-decode")],
    ids=["qwen3-closed", "qwen3-open", "mamba2-closed"])
def test_traced_run_reads_the_program_spans(monkeypatch, cfg, mix, name):
    """``bench/spans.py``'s plumbing through the harness's traced path: the
    recorder filled over the traced stretch only, and each reading that
    applies to the cell a number within its limits."""
    import spans as tool
    monkeypatch.setattr(trace, "DeviceTrace", StretchTrace)
    for attr in ("after_step", "_stop", "result"):
        monkeypatch.setattr(serve.Tracer, attr, getattr(serve.Tracer, attr))
    kept = []
    tool.record_traced_stretch(serve, kept)
    metrics = [m for m in tool.READINGS if name in m["workloads"]]
    mix = dict(mix, trace={"min_chunks": 2, "min_prefills": 1,
                           "max_steps": 6})
    c = cell.Cell("tiny", cfg, mix, T.limits(name), T.E2E,
                  [{"name": "decode_step_ms", "unit": "ms"},
                   {"name": "prefill_ms", "unit": "ms"}] + metrics)
    res = cell.run(c, 2**31 + 11, 1.5, True, torch.device("cpu"),
                   time.perf_counter(), grace_s=5.0)
    from repro_torch.telemetry import trace as program_trace
    assert program_trace.CURRENT is None
    assert len(kept) == 1 and kept[0]["program_spans"]
    stretch = kept[0]["trace"]
    assert all(stretch.t_start <= s.start <= s.end <= stretch.t_stop
               for s in kept[0]["program_spans"])
    got = res["metrics"]
    for m in metrics:
        assert m["name"] in got, (m["name"], got)
    for key, share in got.items():
        if key.startswith("idle_in_blocks_share"):
            assert 0.0 <= share["value"] <= 100.0
    for key in ("decode_host_ms", "decode_host_ms.rag",
                "prefill_host_ms.rag"):
        if key in got:
            assert got[key]["value"] > 0


def test_cost_measurement_alternates_recorded_windows(monkeypatch):
    """``bench/spans.py --trace 0``: windows in turns with the recorder
    empty and filled, spans only from the filled ones, the slot empty
    after."""
    import spans as tool
    from repro_torch.telemetry import trace as program_trace
    monkeypatch.setattr(tool, "TURNS", (0, 1, 1, 0))
    c = cell.Cell("tiny", T.QWEN, T.CLOSED, T.limits(
        "qwen3-8b.reason-decode"), T.E2E, [])
    out = tool.alternate(c, 2**31 + 13, 0.3, torch.device("cpu"))
    assert program_trace.CURRENT is None
    assert [w["recording"] for w in out["windows"]] == [0, 1, 1, 0]
    assert all(w["tokens_per_s"] > 0 and w["decode_step_ms"] > 0
               for w in out["windows"])
    assert out["decode_host_ms"] > 0 and out["span_us"] > 0
    assert out["spans_per_decode_step"] > 0
    table = out["block_table"]
    # One recorder over the filled windows: every parent is one of them.
    rows = table["blocks"]
    assert "decode_step" not in rows and "step" not in rows
    assert rows["linear"]["decode_step_self_ms"] == pytest.approx(
        rows["linear"]["decode_step_ms"])
    assert "idle_s" not in table and table["decode_steps"] > 0
    assert {"attn", "rope", "kv_write", "attn_core", "mlp", "linear", "head",
            "select", "emit"} <= set(table["blocks"])
