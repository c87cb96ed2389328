"""Carry a chain's state and data, or an LM's weights, over from the JAX
package.

``state_from_reference`` and ``data_from_reference`` take the leaves of
``repro``'s ``MFState``/``MFData`` as numpy arrays -- or any objects
with the same fields whose leaves ``numpy.asarray`` accepts -- and
return the port's on a given device: sparse and dense blocks, side
information, and every prior's hyper-state (Macau's ``beta`` and
``beta_prec``, spike-and-slab's ``rho`` and ``tau`` among them).  ``lm_params_from_reference``
takes the reference's LM params tree as nested dicts of such arrays and
returns the port's ``Transformer`` (``train=True``: fp32 masters with
gradients), ``opt_state_from_reference`` its AdamW state by the port's
parameter names, and ``reference_leaf`` reads the leaf of a reference
tree (params, gradients, moments) that a port parameter name stands
for.  The parity tests use them to start both packages from the same
state and weights.  This module imports
nothing of JAX or ``repro``: it reads fields and keys by name.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .core.blocks import DenseBlock
from .core.gibbs import MFData, MFState, with_side_grams
from .core.sparse import PaddedRows, SparseMatrix
from .models import layers as L
from .models.config import LayerSpec, ModelConfig
from .models.mla import MLA
from .models.moe import MoE
from .models.ssm import FP32_LEAVES, Mamba2
from .models.transformer import (ENCODER_SPEC, Encoder, Layer,
                                 Transformer, check_supported)
from .optim import OptState


def _t(x, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(dev)


def state_from_reference(key, factors: Sequence[Any],
                         hypers: Sequence[Dict[str, Any]],
                         noises: Sequence[Dict[str, Any]], step,
                         device: DeviceLike = None) -> MFState:
    """The port's ``MFState`` from the reference's leaves.  ``key`` is
    the raw (2,) uint32 threefry key; it is held as int64."""
    dev = resolve_device(device)
    key = torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64))
    return MFState(
        key.to(dev),
        tuple(_t(np.asarray(f, np.float32), dev) for f in factors),
        tuple({k: _t(np.asarray(v, np.float32), dev) for k, v in h.items()}
              for h in hypers),
        tuple({k: _t(np.asarray(v, np.float32), dev) for k, v in n.items()}
              for n in noises),
        int(np.asarray(step)))


def _padded(p, dev: torch.device) -> PaddedRows:
    return PaddedRows(_t(np.asarray(p.idx, np.int32), dev),
                      _t(np.asarray(p.val, np.float32), dev),
                      _t(np.asarray(p.mask, np.float32), dev),
                      int(p.n_other))


def sparse_from_reference(mat, device: DeviceLike = None) -> SparseMatrix:
    """The port's ``SparseMatrix`` from a reference ``SparseMatrix``."""
    dev = resolve_device(device)
    i32 = {name: _t(np.asarray(getattr(mat, name), np.int32), dev)
           for name in ("coo_i", "coo_j", "coo_rpos", "coo_cpos")}
    f32 = {name: _t(np.asarray(getattr(mat, name), np.float32), dev)
           for name in ("coo_v", "coo_mask")}
    return SparseMatrix(rows=_padded(mat.rows, dev),
                        cols=_padded(mat.cols, dev),
                        shape=tuple(int(s) for s in mat.shape),
                        **i32, **f32)


def dense_from_reference(block, device: DeviceLike = None) -> DenseBlock:
    """The port's ``DenseBlock`` from a reference ``DenseBlock``: both
    orientations copied, a fully observed block's masks as broadcast
    views of one 1.0."""
    dev = resolve_device(device)
    X = _t(np.asarray(block.X, np.float32), dev)
    XT = _t(np.asarray(block.XT, np.float32), dev)
    if block.fully:
        one = torch.ones((), dtype=torch.float32, device=dev)
        return DenseBlock(X, one.expand(X.shape), XT, one.expand(XT.shape),
                          fully=True)
    return DenseBlock(X, _t(np.asarray(block.mask, np.float32), dev), XT,
                      _t(np.asarray(block.maskT, np.float32), dev),
                      fully=False)


def data_from_reference(blocks: Sequence[Any], sides: Sequence[Any],
                        device: DeviceLike = None) -> MFData:
    """The port's ``MFData`` from the reference's blocks (sparse, or
    dense: those with a ``fully`` field) and per-entity side
    information (None or an (N, D) array), with side^T side computed
    once (``with_side_grams``)."""
    dev = resolve_device(device)
    return with_side_grams(MFData(
        tuple(dense_from_reference(b, dev) if hasattr(b, "fully")
              else sparse_from_reference(b, dev) for b in blocks),
        tuple(None if s is None else _t(np.asarray(s, np.float32), dev)
              for s in sides)))


def lm_params_from_reference(params: Dict[str, Any], cfg: ModelConfig,
                             device: DeviceLike = None,
                             train: bool = False) -> Transformer:
    """The port's ``Transformer`` from the reference's params tree
    (``repro.models.init_model``'s, as nested dicts of arrays).

    ``stack/l{i}`` leaves carry the repeats on a leading axis; repeat r
    of pattern entry i becomes layer ``r * len(pattern) + i`` of the
    port's stack, and ``pro{i}`` its prologue layer i.  Projection and
    embedding weights are cast to the compute dtype once here (the
    reference casts them inside every apply; the cast is elementwise,
    so the bits are the same), or with ``train`` held as the
    reference's fp32 masters with ``requires_grad=True``; norm scales
    and MoE routers (read in fp32 by the reference) stay fp32.  An MLA
    layer's ``attn`` leaves (``wq``, ``kv_a``, ``kv_norm``, ``kv_b``,
    ``wo``) make an ``MLA``, a ``mixer`` subtree (``ssm_in``,
    ``conv_w``, ``conv_b``, ``dt_bias``, ``A_log``, ``ssm_D``,
    ``gate_norm``, ``ssm_out``) a ``Mamba2`` (its ``dt_bias``,
    ``A_log`` and ``ssm_D`` in fp32), a ``moe`` subtree (``router``,
    ``experts_*``, ``shared_*``) a ``MoE``, in training as in serving;
    a layer without ``norm2`` (``mlp="none"``) has no MLP.  A norm with
    a ``bias`` is a ``LayerNorm`` (scale and bias fp32), a layer's
    ``norm_cross``/``cross`` its cross block, and an ``encoder``
    subtree (``stack/l0`` with the ``n_encoder_layers`` on its leading
    axis, ``final_norm``) the model's ``Encoder``.  Raises for a layer
    kind the port does not know."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = L.held_dtype(cfg, train)

    def w(x, dtype=dt):
        return _t(np.asarray(x, np.float32), dev).to(dtype)

    def dense(p, dtype=dt):
        return L.Dense(w(p["w"], dtype),
                       w(p["bias"], dtype) if "bias" in p else None)

    def norm(p):
        if "bias" in p:
            return L.LayerNorm(w(p["scale"], torch.float32),
                               w(p["bias"], torch.float32))
        return L.RMSNorm(w(p["scale"], torch.float32))

    def mixer(a, spec: LayerSpec):
        if spec.mixer == "mla":
            return MLA(dense(a["wq"]), dense(a["kv_a"]), norm(a["kv_norm"]),
                       dense(a["kv_b"]), dense(a["wo"]))
        attn = L.Attention(dense(a["wq"]), dense(a["wk"]), dense(a["wv"]),
                           dense(a["wo"]))
        if "q_norm" in a:
            attn.q_norm, attn.k_norm = norm(a["q_norm"]), norm(a["k_norm"])
        return attn

    def mamba(m):
        f32 = {k: w(m[k], torch.float32) for k in FP32_LEAVES}
        return Mamba2(dense(m["ssm_in"]), w(m["conv_w"]), w(m["conv_b"]),
                      f32["dt_bias"], f32["A_log"], f32["ssm_D"],
                      norm(m["gate_norm"]), dense(m["ssm_out"]))

    def layer(p, spec: LayerSpec):
        mix = mamba(p["mixer"]) if spec.mixer == "mamba2" \
            else mixer(p["attn"], spec)
        ffn = {}
        if spec.cross:
            ffn = dict(norm_cross=norm(p["norm_cross"]),
                       cross=mixer(p["cross"], ENCODER_SPEC))
        if spec.mlp == "moe":
            m = p["moe"]
            shared = [dense(m[k]) if k in m else None
                      for k in ("shared_gate", "shared_in", "shared_down")]
            ffn["moe"] = MoE(dense(m["router"], torch.float32),
                             dense(m["experts_gate"]),
                             dense(m["experts_in"]),
                             dense(m["experts_down"]), *shared)
        elif spec.mlp == "dense":
            m = p["mlp"]
            ffn["mlp"] = L.MLP(dense(m["wi"]), dense(m["wdown"]),
                               dense(m["wg"]) if "wg" in m else None)
        if spec.mlp != "none":
            ffn["norm2"] = norm(p["norm2"])
        return Layer(norm(p["norm1"]), mix, window=spec.window, **ffn)

    def repeat(tree, r):
        if isinstance(tree, dict):
            return {k: repeat(v, r) for k, v in tree.items()}
        return np.asarray(tree)[r]

    tok = params["tok"]
    emb = L.Embed(dense(tok["embed"]),
                  dense(tok["unembed"]) if "unembed" in tok else None)
    pro = [layer(params[f"pro{i}"], spec)
           for i, spec in enumerate(cfg.prologue)]
    stack = [layer(repeat(params["stack"][f"l{i}"], r), spec)
             for r in range(cfg.repeats) for i, spec in enumerate(cfg.pattern)]
    encoder = None
    if cfg.is_encoder_decoder:
        enc = params["encoder"]
        encoder = Encoder([layer(repeat(enc["stack"]["l0"], r), ENCODER_SPEC)
                           for r in range(cfg.n_encoder_layers)],
                          norm(enc["final_norm"]))
    model = Transformer(cfg, emb, pro, stack, norm(params["final_norm"]),
                        encoder)
    return model.requires_grad_(train)


def reference_leaf(tree: Dict[str, Any], name: str,
                   cfg: ModelConfig) -> np.ndarray:
    """The leaf of a reference tree shaped like the LM params (the
    params, their gradients, AdamW's moments) that the port's parameter
    ``name`` stands for: ``stack.{j}.<path>`` is repeat ``j //
    len(pattern)`` of ``stack/l{j % len(pattern)}/<path>``,
    ``pro.{i}.<path>`` is ``pro{i}/<path>``, ``encoder.stack.{j}.<path>``
    is repeat j of ``encoder/stack/l0/<path>``, the rest by its path."""
    parts = name.split(".")
    r = None
    if parts[:2] == ["encoder", "stack"]:
        r = int(parts[2])
        parts = ["encoder", "stack", "l0"] + parts[3:]
    elif parts[0] == "stack":
        j = int(parts[1])
        r, i = divmod(j, len(cfg.pattern))
        parts = ["stack", f"l{i}"] + parts[2:]
    elif parts[0] == "pro":
        parts = [f"pro{parts[1]}"] + parts[2:]
    node = tree
    for key in parts:
        node = node[key]
    node = np.asarray(node)
    return node if r is None else node[r]


def opt_state_from_reference(opt_state, model: Transformer) -> OptState:
    """The port's ``OptState`` from the reference's (``m``, ``v`` trees
    shaped like the params, ``step``), by ``model``'s parameter names,
    on ``model``'s device."""
    dev = model.device
    names = [n for n, _ in model.named_parameters()]

    def tree(t):
        return {n: _t(np.asarray(reference_leaf(t, n, model.cfg),
                                 np.float32), dev) for n in names}

    return OptState(tree(opt_state.m), tree(opt_state.v),
                    torch.tensor(int(np.asarray(opt_state.step)),
                                 dtype=torch.int32, device=dev))
