"""The port stands alone: no JAX and no ``repro`` in ``src/repro_torch``
or ``chip_smoke.py``, and no quiet CPU run where the card was meant."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import _one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_isolation_covers_the_session_layer_and_the_linter():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES[:-1]}
    assert {"analysis/__init__.py", "analysis/__main__.py",
            "analysis/invariants.py", "data/synthetic.py",
            "core/session.py"} <= names


def test_isolation_covers_the_distributed_layer():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES[:-1]}
    assert {"core/distributed.py", "analysis/contract.py",
            "runtime/__init__.py", "runtime/__main__.py",
            "runtime/fault.py", "runtime/straggler.py",
            "runtime/world.py"} <= names


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    import repro_torch.core as tc
    from repro_torch.configs import get_smoke
    from repro_torch.data import chembl_like
    from repro_torch.launch.serve import BatchedServer, generate
    from repro_torch.models import init_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm = get_smoke("qwen3_4b")
    calls = [
        lambda: init_model(lm),
        lambda: generate(lm, init_model(lm), [[1, 2, 3]], max_new=2),
        lambda: BatchedServer(lm, init_model(lm), slots=2),
        lambda: tc.ModelBuilder(num_latent=4),
        lambda: tc.TrainSession(num_latent=4),
        lambda: tc.from_coo([0], [0], [1.0], (1, 1)),
        lambda: tc.random_sparse(0, (4, 3), 0.5),
        lambda: tc.dense_block(np.zeros((2, 3), np.float32)),
        lambda: tc.from_dense(np.ones((2, 3), np.float32)),
        lambda: tc.ModelDef((), (), 4),
        lambda: tc.make_test_set([0], [0], [0.0]),
        lambda: tc.PredictSession("no-store-needed"),
        lambda: tc.GFASession([np.zeros((4, 3), np.float32)]),
        lambda: tc.smurff(np.zeros((4, 3), np.float32)),
        lambda: chembl_like(0, n_compounds=8, n_proteins=4, density=0.5),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0 and not _printed_result(out.stdout)


def test_chip_smoke_fails_alone(tmp_path, monkeypatch, capsys):
    """Copied out of the checkout it refuses to run, card or no card."""
    import importlib.util
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    spec = importlib.util.spec_from_file_location("lone_chip_smoke", lone)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mod.main([]) != 0
    assert not _printed_result(capsys.readouterr().out)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0 and not _printed_result(out.stdout)
