"""Model-graph (de)serialization for on-disk posterior samples.

The counterpart of ``repro/core/modelspec.py``.  A session that streams
posterior samples (``save_freq > 0``) writes the sampled ``MFState``s
through ``checkpoint.CheckpointManager`` and one ``model.json`` made
here: the static graph (entities with their priors, blocks with their
noises, ``num_latent``) without the data.  The format is the
reference's, ``repro-mf-model-v1``, so a store written by either
package loads in the other:

* the port writes ``use_pallas`` and ``bf16_gather`` as ``false``; on
  read it ignores ``use_pallas`` (the tensors' device decides the path)
  and refuses ``bf16_gather`` (not ported yet);
* priors and noises are tagged by class name.  A tag the reference
  knows but the port does not yet (``MacauPrior``,
  ``SpikeAndSlabPrior``, ``FixedNormalPrior``, ``ProbitNoise``) raises
  a ValueError that points at ROADMAP A5.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

from .._device import DeviceLike
from .blocks import BlockDef, EntityDef, ModelDef
from .gibbs import MFState, init_state
from .noise import AdaptiveGaussian, FixedGaussian
from .priors import NormalPrior

MODEL_SPEC_FILE = "model.json"
SAMPLES_SUBDIR = "samples"
FORMAT = "repro-mf-model-v1"
# multi-chain stores nest one single-chain store per chain:
# save_dir/chain_<c>/{model.json, samples/}
CHAIN_SUBDIR_PREFIX = "chain_"

PRIOR_TYPES = {cls.__name__: cls for cls in (NormalPrior,)}
NOISE_TYPES = {cls.__name__: cls for cls in (FixedGaussian,
                                             AdaptiveGaussian)}
# types of the reference that the port does not have yet
_LATER_TYPES = ("FixedNormalPrior", "MacauPrior", "SpikeAndSlabPrior",
                "ProbitNoise")


def chain_subdir(c: int) -> str:
    return f"{CHAIN_SUBDIR_PREFIX}{int(c)}"


def chain_count_on_disk(save_dir: str) -> int:
    """Number of ``chain_<c>`` stores under ``save_dir`` (0 = the
    single-chain layout).  Counts a contiguous 0..C-1 run."""
    c = 0
    while os.path.isdir(os.path.join(save_dir, chain_subdir(c))):
        c += 1
    return c


def _to_spec(obj: Any, registry: Dict[str, type], what: str) -> dict:
    name = type(obj).__name__
    if name not in registry:
        raise ValueError(
            f"cannot serialize {what} {name!r}; serializable {what}s: "
            f"{', '.join(sorted(registry))}")
    return {"type": name, **dataclasses.asdict(obj)}


def _from_spec(d: dict, registry: Dict[str, type], what: str):
    d = dict(d)
    name = d.pop("type", None)
    if name in _LATER_TYPES:
        raise ValueError(
            f"the store's {what} {name!r} is not ported yet; the port "
            f"reads {', '.join(sorted(registry))} (see ROADMAP.md, "
            "queue A, item 5)")
    if name not in registry:
        raise ValueError(
            f"unknown {what} type {name!r} in model spec; valid "
            f"{what}s: {', '.join(sorted(registry))}")
    return registry[name](**d)


def model_to_spec(model: ModelDef) -> dict:
    """JSON-safe dict capturing the full static model graph."""
    return {
        "format": FORMAT,
        "num_latent": model.num_latent,
        "use_pallas": False,
        "bf16_gather": False,
        "entities": [
            {"name": e.name, "n_rows": e.n_rows,
             "prior": _to_spec(e.prior, PRIOR_TYPES, "prior")}
            for e in model.entities],
        "blocks": [
            {"row_entity": b.row_entity, "col_entity": b.col_entity,
             "sparse": b.sparse,
             "noise": _to_spec(b.noise, NOISE_TYPES, "noise")}
            for b in model.blocks],
    }


def spec_to_model(spec: dict, device: DeviceLike = None) -> ModelDef:
    """Rebuild the ``ModelDef`` (static graph only, no data payloads)
    on ``device`` (default: the card)."""
    if spec.get("bf16_gather", False):
        raise ValueError(
            "the store was trained with bf16_gather=True, which is not "
            "ported yet (see ROADMAP.md, queue A, item 12)")
    ents = tuple(
        EntityDef(e["name"], int(e["n_rows"]),
                  _from_spec(e["prior"], PRIOR_TYPES, "prior"))
        for e in spec["entities"])
    blocks = tuple(
        BlockDef(int(b["row_entity"]), int(b["col_entity"]),
                 _from_spec(b["noise"], NOISE_TYPES, "noise"),
                 bool(b["sparse"]))
        for b in spec["blocks"])
    return ModelDef(ents, blocks, int(spec["num_latent"]), device)


def state_template(model: ModelDef) -> MFState:
    """An ``MFState`` with the structure and leaf shapes of a live
    chain's: ``init_state`` on the static graph, so the template cannot
    drift from what sessions save.  It lives on the ``meta`` device,
    which holds shapes and types and computes nothing (at 131,072 x 128
    a real template would draw 16.8 M normals); ``load_pytree`` gives
    the values and the device."""
    return init_state(dataclasses.replace(model, device="meta"), None,
                      seed=0)


def save_model_spec(path: str, spec: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(spec, f, indent=1)
    os.replace(tmp, path)


def load_model_spec(path: str) -> dict:
    if not os.path.exists(path):
        raise ValueError(
            f"no model spec at {path}; posterior-sample directories are "
            "written by a Session with save_freq > 0 (TrainSession/"
            "ModelBuilder.session save_dir=...)")
    with open(path) as f:
        return json.load(f)
