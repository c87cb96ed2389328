"""Sweep spans in the port's ``Session`` (the reference's ``REPRO_OBS=1``
path), and the chain's independence of them.

* recorder on and recorder off give bitwise the same run, for one chain
  and for two: traces, every state leaf, diagnostics and every stored
  sample array (the recorder is shared with the checkpoint savers);
* one ``sweep`` span a sweep, with the reference's arguments
  (``sweep``, ``phase``, ``stage``, ``bytes_on_wire`` = 0 on one card,
  and the streaming ``rhat_rmse_train_0`` once it is finite), and the
  ``session.sweep_s``/``session.sweeps``/``session.chains`` metrics;
* ``REPRO_OBS=1`` exports the trace and metrics to ``REPRO_OBS_DIR`` or
  ``save_dir/obs``, and nothing without it;
* on the CPU there is nothing to build, so no ``session/compile`` span
  and ``compile_s`` 0.
"""
import json

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.data import chembl_like
from repro_torch.obs import Recorder
from torch_threads import _one_thread  # noqa: F401 (autouse)


def _train(tmp_path, sub, recorder=None, chains=1, nsamples=4, **kw):
    mat, test, _ = chembl_like(2, n_compounds=30, n_proteins=20,
                               density=0.4, rank=3, device="cpu")
    save = {} if sub is None else dict(save_freq=1,
                                       save_dir=str(tmp_path / sub))
    s = tc.TrainSession(num_latent=3, burnin=2, nsamples=nsamples, seed=9,
                        chains=chains, device="cpu", recorder=recorder,
                        **save, **kw)
    s.add_train_and_test(mat, test, noise=tc.AdaptiveGaussian())
    return s.run()


def _leaves(state):
    out = [state.key, *state.factors]
    out += [h[k] for h in state.hypers for k in sorted(h)]
    out += [n[k] for n in state.noises for k in sorted(n)]
    return out


@pytest.mark.parametrize("chains", [1, 2])
def test_recorder_on_and_off_give_the_same_bits(tmp_path, chains):
    off = _train(tmp_path, "off", Recorder(enabled=False), chains)
    rec = Recorder(enabled=True)
    on = _train(tmp_path, "on", rec, chains)
    assert on.rmse_train_trace == off.rmse_train_trace
    assert on.rmse_test_trace == off.rmse_test_trace
    assert np.array_equal(on.predictions, off.predictions)
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(on.state), _leaves(off.state)))
    if chains > 1:
        for c in range(chains):
            assert on.chain_blocks[c][0].rmse_train_trace == \
                off.chain_blocks[c][0].rmse_train_trace
    for k in on.diagnostics.rhat:   # nan where the draws are too few
        np.testing.assert_array_equal(on.diagnostics.rhat[k],
                                      off.diagnostics.rhat[k])
        np.testing.assert_array_equal(on.diagnostics.ess[k],
                                      off.diagnostics.ess[k])
    on_files = sorted(p.relative_to(tmp_path / "on")
                      for p in (tmp_path / "on").rglob("*.npz"))
    off_files = sorted(p.relative_to(tmp_path / "off")
                       for p in (tmp_path / "off").rglob("*.npz"))
    assert len(on_files) == 4 * chains and on_files == off_files
    for rel in on_files:
        with np.load(tmp_path / "on" / rel) as a, \
                np.load(tmp_path / "off" / rel) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    m = rec.metrics()
    assert m["counters"]["session.sweeps"] == 6.0
    assert m["counters"]["ckpt.saves"] == 4.0 * chains
    assert m["gauges"]["session.chains"] == chains
    assert m["histograms"]["session.sweep_s"]["total"] == 6
    assert "ckpt.save_s" in m["histograms"]
    # a disabled recorder recorded nothing at all
    assert Recorder(enabled=False).metrics() == {
        "format": m["format"], "counters": {}, "gauges": {},
        "histograms": {}}


def test_chain_with_a_recorder_is_the_chain_without_one(tmp_path):
    plain = _train(tmp_path, None)
    traced = _train(tmp_path, None, Recorder(enabled=True))
    assert traced.rmse_train_trace == plain.rmse_train_trace
    assert all(torch.equal(a, b) for a, b in
               zip(_leaves(traced.state), _leaves(plain.state)))


def test_one_sweep_span_a_sweep_with_the_references_args(tmp_path):
    rec = Recorder(enabled=True)
    r = _train(tmp_path, None, rec, chains=2, nsamples=6)
    doc = rec.trace()
    assert doc["repro"]["kind"] == "session"
    sweeps = [e for e in doc["traceEvents"] if e["name"] == "sweep"]
    assert [e["args"]["sweep"] for e in sweeps] == list(range(8))
    assert [e["args"]["phase"] for e in sweeps] == \
        ["burnin"] * 2 + ["sample"] * 6
    assert [e["args"]["stage"] for e in sweeps] == \
        ["first"] + ["steady"] * 7
    assert all(e["args"]["bytes_on_wire"] == 0 and e["cat"] == "session"
               and e["ph"] == "X" and e["dur"] >= 0 for e in sweeps)
    # streaming split-R-hat over rmse_train_0 once it has enough draws
    with_rhat = [e["args"]["sweep"] for e in sweeps
                 if "rhat_rmse_train_0" in e["args"]]
    assert with_rhat and with_rhat[-1] == 7 and min(with_rhat) >= 5
    assert sweeps[-1]["args"]["rhat_rmse_train_0"] == pytest.approx(
        float(r.diagnostics.rhat["rmse_train_0"]))
    assert not [e for e in doc["traceEvents"]
                if e["name"] == "session/compile"]
    assert r.compile_s == 0.0


def test_resumed_run_spans_only_its_own_sweeps(tmp_path):
    _train(tmp_path, "store", nsamples=2)
    rec = Recorder(enabled=True)
    r = _train(tmp_path, "store", rec, nsamples=4)
    assert r.resumed_from is None
    rec2 = Recorder(enabled=True)
    mat, test, _ = chembl_like(2, n_compounds=30, n_proteins=20,
                               density=0.4, rank=3, device="cpu")
    s = tc.TrainSession(num_latent=3, burnin=2, nsamples=5, seed=9,
                        device="cpu", save_freq=1,
                        save_dir=str(tmp_path / "store"), recorder=rec2)
    s.add_train_and_test(mat, test, noise=tc.AdaptiveGaussian())
    r2 = s.run(resume=True)
    assert r2.resumed_from == 6
    sweeps = [e["args"] for e in rec2.trace()["traceEvents"]
              if e["name"] == "sweep"]
    assert [(a["sweep"], a["stage"]) for a in sweeps] == [(6, "first")]
    assert rec2.metrics()["counters"]["ckpt.restores"] == 1.0


def test_repro_obs_exports_to_repro_obs_dir(tmp_path, monkeypatch):
    out = tmp_path / "obs_out"
    monkeypatch.setenv("REPRO_OBS", "1")
    monkeypatch.setenv("REPRO_OBS_DIR", str(out))
    _train(tmp_path, "store")
    doc = json.loads((out / "train_trace.json").read_text())
    met = json.loads((out / "train_metrics.json").read_text())
    assert len([e for e in doc["traceEvents"] if e["name"] == "sweep"]) == 6
    assert met["kind"] == "session"
    assert met["counters"]["session.sweeps"] == 6.0
    assert met["counters"]["ckpt.saves"] == 4.0
    assert not (tmp_path / "store" / "obs").exists()


def test_repro_obs_exports_under_save_dir_without_repro_obs_dir(
        tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_OBS", "1")
    monkeypatch.delenv("REPRO_OBS_DIR", raising=False)
    _train(tmp_path, "store")
    assert (tmp_path / "store" / "obs" / "train_trace.json").is_file()
    assert (tmp_path / "store" / "obs" / "train_metrics.json").is_file()


def test_without_repro_obs_nothing_is_exported(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path / "obs_out"))
    r = _train(tmp_path, "store")
    assert not (tmp_path / "obs_out").exists()
    assert not (tmp_path / "store" / "obs").exists()
    assert r.runtime_s > 0.0


def test_session_result_keeps_scalar_leaves_through_a_store(tmp_path):
    """A 0-d leaf (the noise precision) comes back from a store as a 0-d
    tensor, so a resumed chain carries the shapes of a fresh one."""
    r = _train(tmp_path, "store", nsamples=1)
    p = tc.PredictSession(str(tmp_path / "store"), device="cpu")
    step, st = p.restore_latest()
    assert step == 3
    assert st.noises[0]["alpha"].shape == r.state.noises[0]["alpha"].shape
    assert st.noises[0]["alpha"].dim() == 0
    assert all(torch.equal(a, b) for a, b in
               zip(_leaves(st), _leaves(r.state)))
