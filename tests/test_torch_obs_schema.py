"""The port's obs schema audit (``repro_torch.analysis.obsschema``, the
``--obs`` pass of ``python -m repro_torch.analysis``) against the
reference's ``repro.analysis.obsschema`` on the same files.

The files: the trace and metrics that a port ``TrainSession`` with a
recorder exports into ``tmp_path``; three faults seeded into copies of
them (a renamed ``sweep`` span, a dropped ``bytes_on_wire``, histogram
bounds out of order); and the reference's samples under
``results/obs``, which are read and never written.  In each case the
port's findings are the reference's, word for word once each
package's "re-export" hint is cut.

On the CPU a port session builds no kernel and so records no
``session/compile`` span (``test_torch_obs_session.py``), which both
audits report on its trace: that finding is expected on the clean
export.
"""
import json
from pathlib import Path

import pytest

import repro_torch.core as tc
from repro.analysis import obsschema as jschema
from repro_torch.analysis import obsschema as tschema
from repro_torch.analysis.__main__ import main as tmain
from repro_torch.data import chembl_like
from repro_torch.obs import Recorder
from torch_threads import _one_thread  # noqa: F401 (autouse)

SAMPLES = Path(__file__).resolve().parents[1] / "results" / "obs"
NO_COMPILE = "a session trace must carry the 'session/compile' span"


def _same_findings(path):
    """The port's and the reference's findings on ``path``, each with
    its package's hint cut; asserts they are equal and returns them
    without the path that leads each."""
    got = [m.replace(tschema._REGEN, "") for m in
           tschema.obs_schema_findings(path)]
    want = [m.replace(jschema._REGEN, "") for m in
            jschema.obs_schema_findings(path)]
    assert got == want
    assert all(m.startswith(f"{path}: ") for m in got)
    return [m[len(f"{path}: "):] for m in got]


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """A port TrainSession's trace and metrics, with a recorder."""
    d = tmp_path_factory.mktemp("obs")
    mat, test, _ = chembl_like(2, n_compounds=30, n_proteins=20,
                               density=0.4, rank=3, device="cpu")
    rec = Recorder(enabled=True)
    s = tc.TrainSession(num_latent=3, burnin=2, nsamples=3, seed=9,
                        device="cpu", recorder=rec, save_freq=1,
                        save_dir=str(d / "store"))
    s.add_train_and_test(mat, test, noise=tc.AdaptiveGaussian())
    s.run()
    rec.write_trace(str(d / "train_trace.json"))
    rec.write_metrics(str(d / "train_metrics.json"))
    return d


def test_session_exports_match_reference(exports):
    trace = _same_findings(exports / "train_trace.json")
    assert len(trace) == 1 and NO_COMPILE in trace[0]
    assert _same_findings(exports / "train_metrics.json") == []


def _seeded(exports, tmp_path, name, fault):
    doc = json.loads((exports / name).read_text())
    fault(doc)
    out = tmp_path / name
    out.write_text(json.dumps(doc))
    return out


def _rename_sweeps(doc):
    for ev in doc["traceEvents"]:
        if ev["name"] == "sweep":
            ev["name"] = "gibbs_sweep"


def _drop_bytes_on_wire(doc):
    next(ev for ev in doc["traceEvents"]
         if ev["name"] == "sweep")["args"].pop("bytes_on_wire")


def _unordered_buckets(doc):
    h = doc["histograms"]["session.sweep_s"]
    h["bounds"][0], h["bounds"][1] = h["bounds"][1], h["bounds"][0]


@pytest.mark.parametrize("name,fault,expect", [
    ("train_trace.json", _rename_sweeps,
     "a session trace must carry at least one 'sweep' span"),
    ("train_trace.json", _drop_bytes_on_wire,
     "sweep span args.bytes_on_wire must be a contract-derived int"),
    ("train_metrics.json", _unordered_buckets,
     "histogram 'session.sweep_s': bounds must be a non-empty strictly "
     "increasing list"),
], ids=["renamed_span", "dropped_bytes_on_wire", "unordered_buckets"])
def test_seeded_faults_match_reference(exports, tmp_path, name, fault,
                                       expect):
    clean = _same_findings(exports / name)
    got = _same_findings(_seeded(exports, tmp_path, name, fault))
    new = [m for m in got if m not in clean]
    assert len(new) == 1 and expect in new[0], got


@pytest.mark.parametrize("path", sorted(SAMPLES.glob("*.json")),
                         ids=lambda p: p.name)
def test_reference_samples_match_reference(path):
    before = path.read_bytes()
    assert _same_findings(path) == []
    assert path.read_bytes() == before


def test_cli_obs_pass(exports, tmp_path, capsys):
    """``--obs DIR`` alone audits DIR and skips the lint pass: 0 on the
    reference's samples; 1 on a directory with a seeded fault, whose
    ``--json`` records carry the rule ``obs-schema``."""
    assert tmain(["--obs", str(SAMPLES)]) == 0
    capsys.readouterr()
    bad = tmp_path / "bad"
    bad.mkdir()
    broken = json.loads((exports / "train_metrics.json").read_text())
    _unordered_buckets(broken)
    (bad / "train_metrics.json").write_text(json.dumps(broken))
    assert tmain(["--obs", str(bad), "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["count"] == 1
    assert [r["rule"] for r in out["findings"]] == ["obs-schema"]
