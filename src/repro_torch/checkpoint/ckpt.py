"""Checkpoints in the JAX package's on-disk layout: atomic, async, keep-N.

The counterpart of ``repro/checkpoint/ckpt.py``.  A saved step is a
directory ``step_<n>/`` holding ``shard_0.npz`` -- the leaves of the
tree as ``leaf_0``, ``leaf_1``, ... -- and a ``treedef.json`` sidecar,
written to ``step_<n>.tmp`` and renamed into place, so a preempted
writer never leaves a half-saved step.  ``list_steps`` counts a step as
complete when its sidecar exists.

The layout is byte-compatible with the reference's, so a store written
by one package loads in the other:

* leaves come in ``jax.tree.flatten`` order: NamedTuple fields and
  sequence items in order, dict entries by **sorted** key, ``None``
  holding no leaf;
* an ``MFState`` carries JAX's dtypes on disk: the threefry key as raw
  ``uint32 (2,)`` and the step as a 0-d ``int32``.  The port holds the
  key as int64 and the step as a Python int; :func:`unflatten` gives
  them back in the template's types.

The sidecar's ``treedef`` string describes the structure for a reader;
neither package parses it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.gibbs import MFState
from ..obs import resolve_recorder

SHARD_FILE = "shard_0.npz"     # one process: the reference's process 0
TREEDEF_FILE = "treedef.json"


class Flat(NamedTuple):
    """A tree flattened to host numpy leaves, plus its description."""

    leaves: List[np.ndarray]
    treedef: str


def _host(x) -> np.ndarray:
    """A host copy of one leaf: later in-place updates of the source
    (a sweep that reuses a buffer) cannot reach it."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def _flatten(tree: Any, leaves: List[np.ndarray]) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, MFState):
        leaves.append(_host(tree.key).astype(np.uint32))
        parts = ["key=*"]
        for name in ("factors", "hypers", "noises"):
            parts.append(f"{name}=" + _flatten(getattr(tree, name), leaves))
        leaves.append(np.asarray(int(tree.step), np.int32))
        return "MFState(" + ", ".join(parts) + ", step=*)"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k}: " + _flatten(tree[k], leaves)
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}=" + _flatten(v, leaves)
            for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_flatten(v, leaves) for v in tree)
        if isinstance(tree, list):
            return f"[{inner}]"
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    leaves.append(_host(tree))
    return "*"


def flatten(tree: Any) -> Flat:
    """Host numpy leaves of ``tree`` in ``jax.tree.flatten`` order, with
    JAX's dtypes for an ``MFState`` (see the module docstring)."""
    if isinstance(tree, Flat):
        return tree
    leaves: List[np.ndarray] = []
    desc = _flatten(tree, leaves)
    return Flat(leaves, desc)


def _leaf_like(t: Any, arr: np.ndarray, device) -> Any:
    if hasattr(t, "shape") and tuple(t.shape) != tuple(arr.shape):
        raise ValueError(f"shape mismatch {tuple(t.shape)} vs {arr.shape}")
    if isinstance(t, torch.Tensor):
        want = torch.empty((), dtype=t.dtype).numpy().dtype
        return torch.from_numpy(np.ascontiguousarray(
            arr.astype(want, copy=False))).to(
                t.device if device is None else device)
    if isinstance(t, np.ndarray):
        return arr.astype(t.dtype, copy=False)
    if isinstance(t, bool):
        return bool(arr)
    if isinstance(t, int):
        return int(arr)
    if isinstance(t, float):
        return float(arr)
    return arr


def _unflatten(t: Any, it, device) -> Any:
    if t is None:
        return None
    if isinstance(t, MFState):
        key = _leaf_like(t.key, next(it), device)
        factors = _unflatten(t.factors, it, device)
        hypers = _unflatten(t.hypers, it, device)
        noises = _unflatten(t.noises, it, device)
        return MFState(key, factors, hypers, noises,
                       int(np.asarray(next(it))))
    if isinstance(t, dict):
        vals = {k: _unflatten(t[k], it, device) for k in sorted(t)}
        return {k: vals[k] for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_unflatten(v, it, device) for v in t))
    if isinstance(t, (tuple, list)):
        return type(t)(_unflatten(v, it, device) for v in t)
    return _leaf_like(t, next(it), device)


def unflatten(template: Any, leaves: List[np.ndarray],
              device: Any = None) -> Any:
    """``leaves`` in the structure and types of ``template``; tensors on
    ``device``, or on the template's devices when it is None (a
    template on the ``meta`` device carries shapes and types only)."""
    it = iter(leaves)
    try:
        tree = _unflatten(template, it, device)
    except StopIteration:
        raise ValueError(f"{len(leaves)} leaves are too few for the "
                         "template") from None
    if next(it, None) is not None:
        raise ValueError(f"{len(leaves)} leaves are too many for the "
                         "template")
    return tree


def save_pytree(tree: Any, path: str) -> None:
    """Synchronous atomic save of one tree to ``path`` (a directory)."""
    flat = flatten(tree)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, SHARD_FILE),
             **{f"leaf_{i}": x for i, x in enumerate(flat.leaves)})
    with open(os.path.join(tmp, TREEDEF_FILE), "w") as f:
        json.dump({"treedef": flat.treedef, "n_leaves": len(flat.leaves)},
                  f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_pytree(template: Any, path: str, device: Any = None) -> Any:
    """Load into the structure of ``template`` (shapes must match);
    tensors land on ``device``, by default the template's."""
    with np.load(os.path.join(path, SHARD_FILE)) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    return unflatten(template, leaves, device)


_STEP_RE = re.compile(r"^step_(\d+)$")


def list_steps(directory: str) -> List[int]:
    """Sorted steps with a COMPLETE checkpoint under ``directory``:
    those whose sidecar exists (it is written last, before the atomic
    rename)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := _STEP_RE.match(d))
                  and os.path.exists(os.path.join(directory, d,
                                                  TREEDEF_FILE)))


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return max(steps) if steps else None


class CheckpointManager:
    """Async keep-N checkpoint manager.

    ``save`` copies the tree to host numpy on the calling thread, then
    writes it on a background thread; the next ``save`` or ``wait``
    joins it first (one save in flight).  ``keep=None`` keeps every
    step: the posterior-sample store mode, where ``PredictSession``
    averages all of them.  An exception of a background save is
    re-raised by the next ``save()`` or ``wait()``.
    """

    def __init__(self, directory: str, keep: Optional[int] = 3,
                 recorder: Any = None):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.obs = resolve_recorder(recorder)

    def _raise_pending(self) -> None:
        """Re-raise an exception captured on the saver thread, once."""
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"background checkpoint save into {self.dir!r} failed: "
                f"{err!r}") from err

    def _gc(self) -> None:
        if self.keep is None:
            return
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.dir)
            if (m := _STEP_RE.match(d)))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()
        # on host *before* the thread starts: the sweep that follows may
        # reuse the device buffers
        host = flatten(tree)
        nbytes = sum(int(x.nbytes) for x in host.leaves)

        def work():
            t0 = self.obs.now()
            save_pytree(host, os.path.join(self.dir, f"step_{step}"))
            self._gc()
            self.obs.complete("ckpt/save", t0, cat="ckpt", step=step,
                              bytes=nbytes)
            self.obs.observe("ckpt.save_s", self.obs.now() - t0)
            self.obs.add("ckpt.saves")
            self.obs.add("ckpt.bytes_written", nbytes)

        if blocking:
            work()
        else:
            def guarded():
                try:
                    work()
                except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
                    self._error = e

            self.obs.gauge("ckpt.queue_depth", 1)
            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self.obs.gauge("ckpt.queue_depth", 0)
        self._raise_pending()

    def restore_step(self, template: Any, step: int) -> Any:
        """Load one saved step into the structure of ``template``."""
        self.wait()
        t0 = self.obs.now()
        tree = load_pytree(template,
                           os.path.join(self.dir, f"step_{step}"))
        self.obs.complete("ckpt/restore", t0, cat="ckpt", step=step)
        self.obs.observe("ckpt.restore_s", self.obs.now() - t0)
        self.obs.add("ckpt.restores")
        return tree

    def restore_latest(self, template: Any):
        """(step, tree) of the newest complete checkpoint, or None."""
        self.wait()
        step = latest_step(self.dir)
        if step is None:
            return None
        return step, self.restore_step(template, step)

    def all_steps(self) -> List[int]:
        return list_steps(self.dir)
