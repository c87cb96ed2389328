"""Transformer assembly for a decoder-only LM: forward, loss and decode.

The counterpart of ``repro/models/transformer.py`` for ``attn`` (GQA
with RoPE, optionally a sliding window), ``mla`` and ``mamba2`` mixers,
each followed by a ``dense`` or ``moe`` MLP or by none (``mlp="none"``:
Mamba2-130M's layers).  The reference stacks its pattern repeats on a
leading axis and scans them; here the layers are one module each, in
the same order: the prologue layers, then pattern x repeats (repeat
major).  ``init_serve_cache`` keeps the reference's ``{"stack", "pro",
"pos"}`` layout with one position counter ``pos`` for the whole batch
(a Python int), and ``caches["stack"][i]`` is layer i's ``{"mixer":
...}``, of its mixer's kind: ``{"k", "v"}`` for attention (a ring
buffer of ``min(window, max_len)`` rows with a window), ``{"c_kv",
"k_rope"}`` for MLA, ``{"conv", "state"}`` for Mamba2, which carries no
position.

MoE layers return the reference's aux losses; ``forward`` returns their
sum over the layers (``lb_loss + 1e-3 z_loss`` each) and ``loss_fn``
adds 1e-2 of it.  Every family trains as the dense ones do: MLA's
prefill attention takes its gradient from the two-width flash backward
(q/k nope + rope wide, v ``v_head_dim``), a windowed layer's from the
flash backward with its window, and Mamba2's from autograd through its
PyTorch scan.  Cross-attention, encoder-decoder models, modality
frontends and the LayerNorm / sinusoidal-position variant belong to
later slices (ROADMAP A10) and raise ``NotImplementedError`` when a
model is built; so does ``encode``, the encoder path.

``forward`` and ``serve_step`` serve, under ``torch.no_grad``, on a
serving model or on a training model (``for_serving`` makes the former
from the latter).
``loss_fn`` trains: it runs the grad-enabled ``_forward``, in which,
with ``remat``, each stacked layer runs under
``torch.utils.checkpoint`` (the reference checkpoints its scan body,
one pattern repeat; the recompute is the same, layer by layer), so
that backward recomputes the layer, flash forward or SSD scan
included.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from .config import LayerSpec, ModelConfig
from .layers import (Attention, Embed, MLP, Params, RMSNorm,
                     apply_attention, apply_mlp, cdtype, embed_tokens,
                     held_dtype, init_attention, init_attn_cache, init_embed,
                     init_mlp, init_rmsnorm, rms_norm, unembed)
from .mla import MLA, apply_mla, init_mla, init_mla_cache
from .moe import MoE, apply_moe, init_moe
from .ssm import FP32_LEAVES, Mamba2, apply_mamba2, init_mamba2, \
    init_mamba2_cache

A10 = "not ported yet (ROADMAP A10)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming ROADMAP A10, for what the port
    does not run yet: every layer must be causal self-attention with
    RoPE (``attn``, with or without a window), MLA or Mamba2, followed
    by a dense or MoE MLP or by none."""
    what = []
    for spec in cfg.prologue + cfg.pattern:
        if spec.mixer not in ("attn", "mla", "mamba2"):
            what.append(f"the {spec.mixer} mixer")
        if spec.mlp not in ("dense", "moe", "none"):
            what.append(f"{spec.mlp} MLP layers")
        if spec.cross:
            what.append("cross-attention")
    if cfg.is_encoder_decoder:
        what.append("encoder-decoder models")
    if cfg.n_frontend_tokens:
        what.append("modality frontends")
    if cfg.use_layernorm or not cfg.use_rope:
        what.append("LayerNorm / sinusoidal positions")
    if what:
        raise NotImplementedError(
            f"{cfg.name}: " + ", ".join(dict.fromkeys(what)) + f" {A10}")


class Layer(nn.Module):
    """``norm1``; the mixer under the reference's key: ``attn`` (an
    ``Attention`` or an ``MLA``) or ``mixer`` (a ``Mamba2``); then
    ``norm2`` and ``mlp`` or ``moe``, or neither (``mlp="none"``).
    ``window`` is an attention layer's sliding window (0: none)."""

    def __init__(self, norm1: RMSNorm, mix: nn.Module,
                 norm2: Optional[RMSNorm] = None, mlp: Optional[MLP] = None,
                 moe: Optional[MoE] = None, *, window: int = 0):
        super().__init__()
        if mlp is not None and moe is not None:
            raise ValueError("a layer holds an mlp or a moe, not both")
        if (norm2 is None) != (mlp is None and moe is None):
            raise ValueError("norm2 comes with an mlp or a moe")
        self.norm1 = norm1
        if isinstance(mix, Mamba2):
            self.attn, self.mixer = None, mix
        else:
            self.attn, self.mixer = mix, None
        self.norm2, self.mlp, self.moe = norm2, mlp, moe
        self.window = int(window)


class Transformer(nn.Module):
    """The decoder: ``tok`` (embed / unembed), ``pro`` and ``stack``
    (one ``Layer`` each), ``final_norm``."""

    def __init__(self, cfg: ModelConfig, tok: Embed, pro: List[Layer],
                 stack: List[Layer], final_norm: RMSNorm):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.tok = tok
        self.pro = nn.ModuleList(pro)
        self.stack = nn.ModuleList(stack)
        self.final_norm = final_norm

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def layers(self) -> List[Layer]:
        """Every layer in order: the prologue's, then the stack's."""
        return list(self.pro) + list(self.stack)


def _init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                device, dtype) -> Layer:
    init_mixer = {"mla": init_mla, "mamba2": init_mamba2}.get(
        spec.mixer, init_attention)
    mix = init_mixer(gen, cfg, device, dtype)
    ffn = {}
    if spec.mlp == "moe":
        ffn = dict(moe=init_moe(gen, cfg, device, dtype))
    elif spec.mlp == "dense":
        ffn = dict(mlp=init_mlp(gen, cfg, device=device, dtype=dtype))
    if ffn:
        ffn["norm2"] = init_rmsnorm(cfg.d_model, device)
    return Layer(init_rmsnorm(cfg.d_model, device), mix, window=spec.window,
                 **ffn)


def init_model(cfg: ModelConfig, seed: int = 0, *,
               device: DeviceLike = None, train: bool = False
               ) -> Transformer:
    """A model of random weights, drawn on ``device`` (the card unless
    given) from a ``torch.Generator`` seeded with ``seed``, with the
    reference's distributions: projections and embeddings normal times
    1/sqrt(fan_in), norm scales 1, biases 0.  Weights are held in the
    compute dtype, frozen, or with ``train`` as fp32 masters with
    ``requires_grad=True`` (the values a serving model of the same seed
    holds before its cast); norm scales, MoE routers and Mamba2's
    ``dt_bias``, ``A_log`` and ``ssm_D`` in fp32.  Raises
    for the families the port does not run yet, before drawing
    anything."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = held_dtype(cfg, train)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    tok = init_embed(gen, cfg, dev, dt)
    pro = [_init_layer(gen, cfg, spec, dev, dt) for spec in cfg.prologue]
    stack = [_init_layer(gen, cfg, spec, dev, dt)
             for _ in range(cfg.repeats) for spec in cfg.pattern]
    model = Transformer(cfg, tok, pro, stack,
                        init_rmsnorm(cfg.d_model, dev))
    return model.requires_grad_(train)


def _apply_layer(lay: Layer, cfg: ModelConfig, x: torch.Tensor, *,
                 cache: Optional[Params]
                 ) -> Tuple[torch.Tensor, Optional[Params],
                            Optional[torch.Tensor]]:
    """-> (x, the mixer's new cache, the layer's aux ``lb_loss + 1e-3
    z_loss`` (None without a MoE))."""
    h = rms_norm(lay.norm1, x, cfg.norm_eps)
    if lay.mixer is not None:
        mix, new_cache = apply_mamba2(lay.mixer, cfg, h, cache=cache)
    elif isinstance(lay.attn, MLA):
        mix, new_cache = apply_mla(lay.attn, cfg, h, cache=cache)
    else:
        mix, new_cache = apply_attention(lay.attn, cfg, h, cache=cache,
                                         window=lay.window)
    x = x + mix
    if lay.norm2 is None:
        return x, new_cache, None
    h = rms_norm(lay.norm2, x, cfg.norm_eps)
    if lay.moe is None:
        return x + apply_mlp(lay.mlp, cfg, h), new_cache, None
    out, aux = apply_moe(lay.moe, cfg, h)
    return x + out, new_cache, aux["lb_loss"] + 1e-3 * aux["z_loss"]


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    return torch.as_tensor(tokens).to(device=device, dtype=torch.int64)


def _stack_layer(lay: Layer, cfg: ModelConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer of the stack without a cache -> (x, aux, 0.0 without a
    MoE): tensors only, for ``torch.utils.checkpoint``."""
    x, _, aux = _apply_layer(lay, cfg, x, cache=None)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _forward(params: Transformer, cfg: ModelConfig, batch: Dict[str, Any],
             remat: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward under autograd -> (logits (B, S, V) in the compute
    dtype, aux fp32 0-d).  aux sums the MoE layers' ``lb_loss + 1e-3
    z_loss`` as the reference does: over the prologue, plus the stack's
    own sum from 0.0 (0.0 without a MoE).  With ``remat`` each stacked
    layer runs under ``torch.utils.checkpoint`` (non-reentrant; the
    prologue's layers do not, as the reference checkpoints only its scan
    body)."""
    dev = params.device
    x = embed_tokens(params.tok, cfg, _tokens(batch["tokens"], dev))
    aux_pro = torch.zeros((), dtype=torch.float32, device=dev)
    for lay in params.pro:
        x, _, aux = _apply_layer(lay, cfg, x, cache=None)
        if aux is not None:
            aux_pro = aux_pro + aux
    aux_stack = torch.zeros((), dtype=torch.float32, device=dev)
    for lay in params.stack:
        if remat:
            # tensors in and out; nothing random runs inside
            x, aux = checkpoint(lambda h, lay=lay: _stack_layer(lay, cfg, h),
                                x, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = _stack_layer(lay, cfg, x)
        aux_stack = aux_stack + aux
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    logits = unembed(params.tok, cfg, x)
    return logits, aux_pro + aux_stack


@torch.no_grad()
def forward(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill / scoring forward -> (logits (B, S, V) in the compute
    dtype, aux: the MoE layers' summed aux losses, 0.0 without MoE).
    ``batch["tokens"]`` (B, S), a tensor or an array.  Attention (GQA
    and MLA's prefill) runs through ``ops.flash_attention``."""
    return _forward(params, cfg, batch, remat=False)


def loss_fn(params: Transformer, cfg: ModelConfig, batch: Dict[str, Any],
            *, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's LM loss -> (loss, {"nll", "aux", "tokens"}):
    fp32 logits, their logsumexp minus the gold logit, averaged over the
    tokens whose ``batch["labels"]`` are >= 0 (at least one), plus
    1e-2 aux.  Differentiable in ``params``' leaves that require grad;
    attention's gradient (GQA's, and MLA's prefill at two widths) is the
    flash_bwd kernel on the card."""
    logits, aux = _forward(params, cfg, batch, remat)
    labels = _tokens(batch["labels"], params.device)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    # a negative label is masked out; it gathers logit 0 in its place
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
    loss = nll + 1e-2 * aux
    return loss, {"nll": nll, "aux": aux, "tokens": mask.sum()}


@torch.no_grad()
def for_serving(params: Transformer) -> Transformer:
    """A frozen serving copy of a training model: projection, embedding
    and conv weights cast to the compute dtype once; norm scales, MoE
    routers and Mamba2's ``dt_bias``, ``A_log`` and ``ssm_D`` fp32.
    ``forward`` and decode give the bits they give on ``params``, whose
    applies cast the fp32 masters on every read."""
    cfg = params.cfg
    serving = copy.deepcopy(params).requires_grad_(False)
    for name, p in serving.named_parameters():
        if not name.endswith((".scale", ".router.w")
                             + tuple(f".{n}" for n in FP32_LEAVES)):
            p.data = p.data.to(cdtype(cfg))
    return serving


def init_serve_cache(params: Transformer, cfg: ModelConfig, batch: int,
                     max_len: int, prefilled: int = 0) -> Params:
    """Zeroed decode caches for every layer, in the compute dtype:
    {"stack": [{"mixer": {"k", "v"}} for attention (``min(window,
    max_len)`` rows with a window), {"mixer": {"c_kv", "k_rope"}} for
    MLA, {"mixer": {"conv", "state"}} for Mamba2] per stacked layer,
    "pro": the same per prologue layer, "pos": ``prefilled``}."""
    dev = params.device

    def one_layer(lay: Layer) -> Params:
        if lay.mixer is not None:
            return {"mixer": init_mamba2_cache(cfg, batch, device=dev)}
        if isinstance(lay.attn, MLA):
            c = init_mla_cache(cfg, batch, max_len, device=dev)
        else:
            c = init_attn_cache(cfg, batch, max_len, lay.window, device=dev)
        c.pop("len")        # the position lives once, in caches["pos"]
        return {"mixer": c}

    return {"stack": [one_layer(lay) for lay in params.stack],
            "pro": [one_layer(lay) for lay in params.pro],
            "pos": int(prefilled)}


@torch.no_grad()
def serve_step(params: Transformer, cfg: ModelConfig, caches: Params,
               tokens) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), new caches).

    Every row of the batch is at position ``caches["pos"]``: one counter
    serves all rows, as in the reference, and a MoE layer routes the B
    tokens of the step as one group.  Attention and MLA layers read the
    position (``len``); a Mamba2 layer carries its state and needs none.
    The cache tensors of ``caches`` are updated in place and carried
    into the returned dict, whose ``pos`` is one more.
    """
    dev = params.device
    x = embed_tokens(params.tok, cfg, _tokens(tokens, dev))
    pos = int(caches["pos"])
    flat = caches["pro"] + caches["stack"]
    new = []
    for lay, c in zip(params.layers(), flat):
        sub = dict(c["mixer"], len=pos)
        x, nc, _ = _apply_layer(lay, cfg, x, cache=sub)
        new.append({"mixer": {k: t for k, t in nc.items() if k != "len"}})
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    logits = unembed(params.tok, cfg, x)
    n_pro = len(caches["pro"])
    return logits, {"stack": new[n_pro:], "pro": new[:n_pro],
                    "pos": pos + 1}
