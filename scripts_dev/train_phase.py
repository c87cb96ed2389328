"""``chip_smoke.py``'s train phase alone, then the flash CUDA tests.

    python scripts_dev/train_phase.py          # on one H100

Runs ``phase_card`` (the build), ``phase_flash_bwd`` and ``phase_train``
(SmolLM-135M at full width and depth, 30 steps of 8 x 4,096 tokens, the
restart check), then ``python -m pytest -m cuda
tests/test_torch_kernels_cuda.py -k "flash_bwd or lse or attention_fn or
flash"``.  About 140 s on one H100.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts_dev"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

t0 = time.perf_counter()
cs.phase_card()
gen = torch.Generator(device="cuda").manual_seed(0)
entry = cs.phase_flash_bwd(gen)
print(f"flash_bwd phase {time.perf_counter() - t0:.1f} s")
t1 = time.perf_counter()
entry, fl = cs.phase_train(0, entry)
print(f"train phase {time.perf_counter() - t1:.1f} s")
print(entry, fl)
r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "cuda",
                    "-p", "no:cacheprovider", "tests/test_torch_kernels_cuda.py",
                    "-k", "flash_bwd or lse or attention_fn or flash"],
                   cwd=ROOT, capture_output=True, text=True)
print(r.stdout[-3000:], r.stderr[-2000:])
sys.exit(r.returncode)
