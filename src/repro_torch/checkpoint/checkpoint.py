"""Atomic, manifest-versioned checkpoints of nested dicts and lists of
arrays (port of ``repro.checkpoint.checkpoint``; ``restore``'s
``sharding_fn`` keeps a tensor-parallel rank's shard of each leaf).

Layout:    <dir>/step_<N>/manifest.json + leaf_<i>.npy  (one file per leaf)
Atomicity: written to ``step_<N>.tmp``, then ``os.replace``'d: a crash mid-
save leaves only a .tmp dir, which ``list_steps`` and ``restore`` ignore.

The layout is the reference's, byte for byte: leaves in the order
``jax.tree_util.tree_flatten`` gives (dict keys sorted, lists in order),
each named by its ``jax.tree_util.keystr`` path (``['a'][0]``), and bf16
stored as f32 with its dtype recorded.  A :class:`Fields` node stands for
a registered dataclass of the reference (its data fields in declaration
order, named ``.field``).  A checkpoint of the same tree of arrays
therefore restores bit-equal in either package.

Leaves may be numpy arrays or torch tensors (copied to the host at save).
The serving engine spills preempted-slot snapshots through this module
(``ServeEngine(spill_dir=...)``): one step dir per suspended request,
written by an ``AsyncCheckpointer(keep=0)`` (no collection of live spills)
and deleted with :func:`remove` as the request resumes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class Fields(dict):
    """A node that flattens as a ``jax.tree_util.register_dataclass``
    instance does: its entries in insertion order (the data fields'
    declaration order), each named ``.<key>``; a None entry is an empty
    subtree.  The serving engine's spilled snapshots use it for the cache
    dataclasses (``serve.slots.spill_tree``)."""


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in ``jax.tree_util`` order; None is an
    empty subtree, as in jax."""
    if isinstance(tree, Fields):
        out: List[Tuple[str, Any]] = []
        for key, val in tree.items():
            out += _flatten(val, f"{path}.{key}")
        return out
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], f"{path}[{key!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, val in enumerate(tree):
            out += _flatten(val, f"{path}[{i}]")
        return out
    if tree is None:
        return []
    return [(path, tree)]


def _unflatten(tree: Any, leaves: Dict[str, Any], path: str = "") -> Any:
    """``tree`` with every leaf replaced by ``leaves[its path]``."""
    if isinstance(tree, Fields):
        return Fields((key, _unflatten(val, leaves, f"{path}.{key}"))
                      for key, val in tree.items())
    if isinstance(tree, dict):
        return {key: _unflatten(val, leaves, f"{path}[{key!r}]")
                for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(val, leaves, f"{path}[{i}]")
                          for i, val in enumerate(tree))
    if tree is None:
        return None
    return leaves[path]


def _entries(tree: Any) -> List[Tuple[str, str, np.ndarray]]:
    """(keystr path, dtype name, host copy) of every leaf; bf16 (which
    numpy cannot store) is copied as f32 and recorded as bfloat16."""
    out = []
    for path, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            dtype = str(leaf.dtype).replace("torch.", "")
            t = leaf.detach().to("cpu", copy=True)
            arr = (t.to(torch.float32) if t.dtype == torch.bfloat16
                   else t).numpy()
        else:
            arr = np.array(leaf, copy=True)
            dtype = str(arr.dtype)
            if arr.dtype.kind == "V" or dtype == "bfloat16":
                arr = arr.astype(np.float32)
        out.append((path, dtype, arr))
    return out


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _write(directory: str, step: int,
           entries: List[Tuple[str, str, np.ndarray]],
           extra: Optional[Dict[str, Any]]) -> str:
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": [],
                                "extra": extra or {}}
    for i, (path, dtype, arr) in enumerate(entries):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": path, "file": fname,
                                   "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save(directory: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    return _write(directory, step, _entries(tree), extra)


class AsyncCheckpointer:
    """Copy to the host on the caller's thread, write on a worker thread.

    The host copy is complete (device copies included, they are
    synchronous) before the thread starts, so the caller may reuse or
    overwrite the source at once.  ``keep=0`` disables retention GC: every
    step dir stays until :func:`remove`'d, the mode the serving engine's
    spills rely on."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        entries = _entries(tree)

        def work() -> None:
            _write(self.directory, step, entries, extra)
            gc_old(self.directory, keep=self.keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()


def list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def gc_old(directory: str, keep: int = 3) -> None:
    steps = list_steps(directory)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


def remove(directory: str, step: int) -> None:
    """Delete one step dir (and any stale .tmp twin).  A missing step is
    not an error."""
    shutil.rmtree(_step_dir(directory, step), ignore_errors=True)
    shutil.rmtree(_step_dir(directory, step) + ".tmp", ignore_errors=True)


def _as_target(arr: np.ndarray, leaf: Any, device: Any) -> Any:
    """A stored array in the dtype (and for a tensor, on the device) of
    the target's leaf."""
    if isinstance(leaf, torch.Tensor):
        # ascontiguousarray makes a 0-dim array 1-dim: keep the shape.
        t = torch.from_numpy(np.ascontiguousarray(arr)).reshape(arr.shape)
        return t.to(device=device, dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype)


def restore(directory: str, step: int, target: Any,
            device: Any = "cpu",
            sharding_fn: Optional[
                Callable[[str, np.ndarray], np.ndarray]] = None
            ) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``target`` (values replaced).

    ``target`` only contributes the tree, leaf shapes and dtypes.  A torch
    leaf comes back as a tensor on ``device`` (a numpy leaf as numpy).
    ``sharding_fn(path, array)``, checked against the target's shape
    first, returns the part of a loaded leaf this process keeps (a
    tensor-parallel rank's shard; the reference's ``sharding_fn`` places
    it on its mesh).  Returns (tree, the ``extra`` dict saved with it)."""
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    dev = resolve_device(device)
    leaves: Dict[str, Any] = {}
    for p, leaf in _flatten(target):
        entry = by_path.get(p)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {p}")
        arr = np.load(os.path.join(path, entry["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {p}: ckpt {arr.shape} "
                             f"vs target {tuple(leaf.shape)}")
        if sharding_fn is not None:
            arr = sharding_fn(p, arr)
        leaves[p] = _as_target(arr, leaf, dev)
    return _unflatten(target, leaves), manifest["extra"]
