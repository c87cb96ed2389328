"""``chip_smoke.py``'s ``train dp`` phase on the CPU, at the smoke size.

    PYTHONPATH=src python scripts_dev/train_dp_rehearsal.py

A rehearsal of ``phase_train_dp`` without a card: before anything of
``repro_torch`` resolves a device, this module points the default device
at the CPU, builds every ``DeviceMesh`` on the CPU, turns the
``torch.cuda`` synchronisation and memory calls into no-ops, swaps
``configs.get_config`` for ``get_smoke``, cuts ``TRAIN_SHAPE`` to 4 x 16,
stubs the launch counts and the profiler (no kernel runs on the CPU) and
runs the phase's worlds through this module, so that each rank applies
the same patches.  It checks the phase's control flow, its collectives
and its bitwise checks; it measures nothing.  About 20 s.
"""
import sys
from pathlib import Path

import repro_torch._device as _device

_resolve = _device.resolve_device
_device.resolve_device = lambda d=None: _resolve("cpu" if d is None else d)

import torch  # noqa: E402
import torch.distributed.device_mesh as _dm  # noqa: E402

_mesh_init = _dm.DeviceMesh.__init__


def _cpu_mesh(self, device_type, *a, **k):
    # a subclass would break DTensor's registration of the mesh type
    _mesh_init(self, "cpu", *a, **k)


_dm.DeviceMesh.__init__ = _cpu_mesh
for _name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
    setattr(torch.cuda, _name, lambda *a, **k: None)
torch.cuda.max_memory_allocated = lambda *a, **k: 0
torch.cuda.memory_allocated = lambda *a, **k: 0
torch.cuda.device_count = lambda: 1

import repro_torch.configs as _configs  # noqa: E402

_configs.get_config = _configs.get_smoke
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import chip_smoke as cs  # noqa: E402
import repro_torch.kernels.ops as _ops  # noqa: E402
import repro_torch.runtime as _runtime  # noqa: E402

cs.TRAIN_SHAPE = (4, 16)
_LAYERS = _configs.get_smoke(cs.TRAIN_ARCH).n_layers
cs._dp_launches = lambda label, n: {"flash": 2 * n, "flash_bwd": n}
# the restart's count: DP_RESTART's steps run, each launching what a
# step of the smoke model would on the card
_RUN = cs.DP_RESTART[1] + cs.DP_GLOO_STEPS \
    - cs.DP_RESTART[1] // cs.DP_RESTART[0] * cs.DP_RESTART[0]
_ops.launch_counts = lambda: {"flash": 2 * _LAYERS * _RUN,
                              "flash_bwd": _LAYERS * _RUN}
cs.profile_once = lambda fn, label, sums=None: (fn(), 1.0)[1]
_run_world = _runtime.run_world


def _cpu_world(target, n, **kw):
    kw.update(device_type="cpu", backend=None, local_ranks=None)
    kw["extra_paths"] = [str(HERE)] + list(kw.get("extra_paths", []))
    return _run_world(f"{Path(__file__).stem}:{target.split(':')[1]}", n,
                      **kw)


_runtime.run_world = _cpu_world
train_dp_nccl_rank = cs.train_dp_nccl_rank
train_dp_gloo_rank = cs.train_dp_gloo_rank

if __name__ == "__main__":
    print(cs.phase_train_dp(0))
