"""BENCHMARK.json against the contract's shape: names and units, every
part a file of its own found by name, every per-layer metric reported in
the cells it lists, and the reference importing nothing of the program."""
import ast
import importlib.util
import json
import re

import pytest

import bench_tiny as T

SPEC = json.loads((T.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(SPEC) == KEYS
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((T.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_names_units_and_keys():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_every_part_is_a_file_found_by_name():
    cfgs = {c["name"]: c for c in SPEC["configs"]}
    for c in cfgs.values():
        cfg = json.loads((T.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert w["config"] in cfgs
        assert (T.BENCH / "traffic" / f"{w['traffic']}.json").exists()
        lim = json.loads((T.BENCH / "limits" / f"{w['name']}.json")
                         .read_text())
        assert "gap" in lim["limits"]
    for m in SPEC["per_layer"]:
        path = T.BENCH / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)


def test_each_cell_reports_setup_another_metric_and_a_layer():
    e2e = SPEC["end_to_end"]
    for w in SPEC["workloads"]:
        mine = [m["name"] for m in e2e
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in SPEC["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        assert layers
        for m in layers:
            assert m["moves"] in mine


@pytest.mark.parametrize("module", ["reference.py", "weights.py"])
def test_reference_imports_nothing_of_the_program(module):
    tree = ast.parse((T.BENCH / "benchlib" / module).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    assert tops <= {"__future__", "math", "typing", "numpy", "torch",
                    "benchlib"}


def test_forbidden_modules_compare_whole_top_level_names():
    from benchlib import cell
    assert cell.forbidden_modules(["repro_torch", "repro_torch.serve",
                                   "jaxlibx", "reprox.y", "torch"]) == []
    assert cell.forbidden_modules(["repro.serve.engine", "jax.numpy",
                                   "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]
