"""Worlds of ranks, one process a rank.

    from repro_torch.runtime import run_world
    outs = run_world("my_module:rank_main", 8, device_type="cpu",
                     workdir=d, args=(str(out_dir),))

starts ``world_size`` processes of ``python -m repro_torch.runtime``.
Each one starts its rank with :func:`init_world` (a ``file://``
rendezvous under ``workdir``, so no TCP port is taken; gloo on the CPU,
NCCL on the card with the rank on ``cuda:{LOCAL_RANK}``), calls
``rank_main(rank, world_size, *args)`` and leaves the group.  On the CPU
each rank runs one thread.  A rank that raises fails the world: the
other ranks are stopped and a ``RuntimeError`` carries the failed ranks'
tracebacks; so does a world that outlives ``timeout_s``.  Returns each
rank's standard output.
"""
from __future__ import annotations

import datetime
import importlib
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..obs import clock

_SRC = Path(__file__).resolve().parents[2]


def init_world(device_type: str, rank: int, world_size: int,
               init_method: str, backend: Optional[str] = None,
               timeout_s: float = 300.0) -> None:
    """Join the world as ``rank``: NCCL for ``device_type`` "cuda" (on
    ``cuda:{LOCAL_RANK}``, set as the current device), gloo for "cpu";
    ``backend`` overrides the choice (gloo over CUDA tensors, for two
    ranks on one card)."""
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _tail(path: Path, n: int = 6000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def run_world(target: str, world_size: int, *, workdir,
              device_type: str = "cpu", args: Sequence = (),
              backend: Optional[str] = None, timeout_s: float = 600.0,
              local_ranks: Optional[Sequence[int]] = None,
              extra_paths: Sequence[str] = ()) -> list:
    """Run ``target`` ("module:function") as a world of ``world_size``
    ranks and return each rank's standard output; see the module
    docstring.  ``args`` must be JSON values.  ``local_ranks`` places the
    ranks on cards (default: rank modulo the card count); ``extra_paths``
    go in front of ``sys.path`` in every rank (``src`` is there)."""
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    rendezvous = work / "rendezvous"
    if rendezvous.exists():
        rendezvous.unlink()
    if local_ranks is None:
        n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
        local_ranks = [r % max(n_cards, 1) for r in range(world_size)]
    spec = {"target": target, "world_size": world_size,
            "device_type": device_type, "backend": backend,
            "init_method": "file://" + str(rendezvous.resolve()),
            "args": list(args), "timeout_s": timeout_s}
    spec_path = work / "world.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_SRC), *map(str, extra_paths)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    if device_type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    for rank in range(world_size):
        renv = dict(env, RANK=str(rank), WORLD_SIZE=str(world_size),
                    LOCAL_RANK=str(local_ranks[rank]))
        out, err = work / f"rank{rank}.out", work / f"rank{rank}.err"
        logs.append((out, err))
        with open(out, "wb") as fo, open(err, "wb") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.runtime",
                 str(spec_path), str(rank)],
                stdout=fo, stderr=fe, env=renv))
    deadline = clock.monotonic() + timeout_s
    failed = []
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if clock.monotonic() > deadline:
                raise RuntimeError(
                    f"world of {world_size} ranks ({target}) still running "
                    f"after {timeout_s:.0f} s; ranks not done: "
                    f"{[r for r, c in enumerate(codes) if c is None]}\n"
                    + "\n".join(f"--- rank {r} stderr ---\n"
                                f"{_tail(logs[r][1])}"
                                for r, c in enumerate(codes) if c is None))
            try:
                next(p for p in procs if p.poll() is None).wait(0.05)
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if failed:
        raise RuntimeError(
            f"world of {world_size} ranks ({target}): rank(s) {failed} "
            "failed\n" + "\n".join(
                f"--- rank {r} (exit {procs[r].returncode}) stderr ---\n"
                f"{_tail(logs[r][1])}" for r in failed))
    return [_tail(out, 1 << 20) for out, _ in logs]


def _rank_main(spec_path: str, rank: int) -> int:
    spec = json.loads(Path(spec_path).read_text())
    if spec["device_type"] == "cpu":
        torch.set_num_threads(1)
    try:
        init_world(spec["device_type"], rank, spec["world_size"],
                   spec["init_method"], spec["backend"], spec["timeout_s"])
        module, _, name = spec["target"].partition(":")
        fn = getattr(importlib.import_module(module), name)
        fn(rank, spec["world_size"], *spec["args"])
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- reported, then the exit code
        traceback.print_exc()
        sys.stderr.flush()
        return 1
    return 0
