"""End-to-end training driver example on the PyTorch port: mixed-precision
QAT with checkpoint/auto-resume through the port's launcher (the twin of
``examples/train_qat.py``, whose flags it passes on unchanged, plus
``--device``).  The train step is ``fake_quant`` under ``torch.autograd``:
it launches no hand-written kernel.

Presets:
  ci    tiny model, 60 steps (the default)
  full  ~100M-parameter model, 300 steps (same code path, bigger numbers;
        for the card)

    PYTHONPATH=src python examples/train_qat_torch.py [--preset full]
    PYTHONPATH=src python examples/train_qat_torch.py --device cpu

The checkpoints go to ``--ckpt-dir`` (default: ``repro_train_qat`` in the
temporary directory); a second run with the same directory resumes from
its latest step.
"""
import argparse
import os
import tempfile
from typing import Any, Dict, List, Optional

from repro_torch.launch import train as train_driver


def preset_argv(preset: str, ckpt_dir: str) -> List[str]:
    """The reference's command line for ``preset``."""
    if preset == "full":
        # ~100M params: d_model 640, 16 layers, 32k vocab.
        return ["--arch", "qwen3-8b", "--d-model", "640", "--layers", "16",
                "--vocab", "32768", "--steps", "300", "--seq-len", "256",
                "--batch", "16", "--accum", "4", "--w-bits", "4",
                "--ckpt-dir", ckpt_dir, "--ckpt-every", "50"]
    return ["--arch", "qwen3-8b", "--reduced", "--steps", "60",
            "--seq-len", "48", "--batch", "16", "--w-bits", "4",
            "--lr", "1e-2",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "30"]


def run(preset: str = "ci", ckpt_dir: Optional[str] = None,
        device: str = "cuda", params: Any = None) -> Dict[str, Any]:
    """Train ``preset`` on ``device`` through ``launch.train.main`` from
    ``params`` (default: its seeded initialisation).  Returns ``argv``
    (what the launcher got) and ``state`` (the final train state)."""
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_train_qat")
    argv = preset_argv(preset, ckpt_dir) + ["--device", device]
    return {"argv": argv,
            "state": train_driver.main(argv, init_params=params)}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=("ci", "full"), default="ci")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return run(args.preset, args.ckpt_dir, args.device)


if __name__ == "__main__":
    main()
