"""The command as the driver runs it: without a card it exits non-zero and
prints no result; a run loads neither JAX nor the JAX package."""
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

import bench_tiny as T


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the whole cell")


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "qwen3-8b.reason-decode", "--seed", str(2**31 + 9), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, capture_output=True,
        text=True, timeout=120)


def test_no_card_no_result(no_card):
    res = _run(T.ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in res.stderr


def test_only_the_benchmark_files_no_result(no_card, tmp_path):
    shutil.copy(T.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(T.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(T.BENCH / 'tests')!r}]
        import bench_tiny as T
        import torch
        torch.set_num_threads(1)
        res = T.run(T.QWEN, T.CLOSED, "qwen3-8b.reason-decode",
                    seconds=0.5)
        from benchlib import cell
        print("CORRECT", res["correct"])
        print("FOUND", cell.forbidden_modules())
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=T.ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "CORRECT True" in res.stdout
    assert "FOUND []" in res.stdout
