"""Transformer assembly for a dense decoder-only LM: forward, loss and
decode.

The counterpart of ``repro/models/transformer.py`` for ``attn`` mixers
with ``dense`` MLPs.  The reference stacks its pattern repeats on a
leading axis and scans them; here the layers are one module each, in
the same order: the prologue layers, then pattern x repeats (repeat
major).  ``init_serve_cache`` keeps the reference's
``{"stack", "pro", "pos"}`` layout with one position counter ``pos``
for the whole batch (a Python int), and ``caches["stack"][i]`` is layer
i's ``{"mixer": {"k", "v"}}``.

MLA, Mamba2, MoE, sliding windows (the ring-buffer decode),
cross-attention, encoder-decoder models, modality frontends and the
LayerNorm / sinusoidal-position variant belong to later slices
(ROADMAP A10) and raise ``NotImplementedError`` when a model is built;
so does ``encode``, the encoder path.

``forward`` and ``serve_step`` serve, under ``torch.no_grad``, on a
serving model or on a training model (``for_serving`` makes the former
from the latter).
``loss_fn`` trains: it runs the grad-enabled ``_forward``, in which,
with ``remat``, each stacked layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
scan body, one layer for the dense configs), so that backward
recomputes the layer, flash forward included.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import (Attention, Embed, MLP, Params, RMSNorm,
                     apply_attention, apply_mlp, cdtype, embed_tokens,
                     held_dtype, init_attention, init_attn_cache, init_embed,
                     init_mlp, init_rmsnorm, rms_norm, unembed)

A10 = "not ported yet (ROADMAP A10)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming ROADMAP A10, for what the port
    does not run yet: every layer must be causal self-attention with
    RoPE and no window, followed by a dense MLP."""
    what = []
    for spec in cfg.prologue + cfg.pattern:
        if spec.mixer != "attn":
            what.append(f"the {spec.mixer} mixer")
        if spec.mlp != "dense":
            what.append(f"{spec.mlp} MLP layers")
        if spec.window > 0:
            what.append("sliding-window attention (ring-buffer decode)")
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
    """``norm1``, ``attn``, ``norm2``, ``mlp``."""

    def __init__(self, norm1: RMSNorm, attn: Attention, norm2: RMSNorm,
                 mlp: MLP):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.mlp = norm1, attn, norm2, mlp


class Transformer(nn.Module):
    """The dense decoder: ``tok`` (embed / unembed), ``pro`` and
    ``stack`` (one ``Layer`` each), ``final_norm``."""

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


def _init_layer(gen: torch.Generator, cfg: ModelConfig, device,
                dtype) -> Layer:
    return Layer(init_rmsnorm(cfg.d_model, device),
                 init_attention(gen, cfg, device, dtype),
                 init_rmsnorm(cfg.d_model, device),
                 init_mlp(gen, cfg, device=device, dtype=dtype))


def init_model(cfg: ModelConfig, seed: int = 0, *,
               device: DeviceLike = None, train: bool = False
               ) -> Transformer:
    """A model of random weights, drawn on ``device`` (the card unless
    given) from a ``torch.Generator`` seeded with ``seed``, with the
    reference's distributions: projections and embeddings normal times
    1/sqrt(fan_in), norm scales 1, biases 0.  Weights are held in the
    compute dtype, frozen, or with ``train`` as fp32 masters with
    ``requires_grad=True`` (the values a serving model of the same seed
    holds before its cast); norm scales in fp32.  Raises for the
    families the port does not run yet, before drawing anything."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = held_dtype(cfg, train)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    tok = init_embed(gen, cfg, dev, dt)
    pro = [_init_layer(gen, cfg, dev, dt) for _ in cfg.prologue]
    stack = [_init_layer(gen, cfg, dev, dt)
             for _ in range(cfg.repeats * len(cfg.pattern))]
    model = Transformer(cfg, tok, pro, stack,
                        init_rmsnorm(cfg.d_model, dev))
    return model.requires_grad_(train)


def _apply_layer(lay: Layer, cfg: ModelConfig, x: torch.Tensor, *,
                 cache: Optional[Params]
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    h = rms_norm(lay.norm1, x, cfg.norm_eps)
    mix, new_cache = apply_attention(lay.attn, cfg, h, cache=cache)
    x = x + mix
    x = x + apply_mlp(lay.mlp, cfg, rms_norm(lay.norm2, x, cfg.norm_eps))
    return x, new_cache


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    return torch.as_tensor(tokens).to(device=device, dtype=torch.int64)


def _forward(params: Transformer, cfg: ModelConfig, batch: Dict[str, Any],
             remat: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward under autograd -> (logits (B, S, V) in the compute
    dtype, aux 0.0).  With ``remat`` each stacked layer runs under
    ``torch.utils.checkpoint`` (non-reentrant; the prologue's layers do
    not, as the reference checkpoints only its scan body)."""
    dev = params.device
    x = embed_tokens(params.tok, cfg, _tokens(batch["tokens"], dev))
    for lay in params.pro:
        x, _ = _apply_layer(lay, cfg, x, cache=None)
    for lay in params.stack:
        if remat:
            # a tensor in, a tensor out; nothing random runs inside
            x = checkpoint(lambda h, lay=lay: _apply_layer(
                lay, cfg, h, cache=None)[0], x, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, _ = _apply_layer(lay, cfg, x, cache=None)
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    logits = unembed(params.tok, cfg, x)
    return logits, torch.zeros((), dtype=torch.float32, device=dev)


@torch.no_grad()
def forward(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill / scoring forward -> (logits (B, S, V) in the compute
    dtype, aux 0.0).  ``batch["tokens"]`` (B, S), a tensor or an array.
    Attention runs through ``ops.flash_attention``."""
    return _forward(params, cfg, batch, remat=False)


def loss_fn(params: Transformer, cfg: ModelConfig, batch: Dict[str, Any],
            *, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's LM loss -> (loss, {"nll", "aux", "tokens"}):
    fp32 logits, their logsumexp minus the gold logit, averaged over the
    tokens whose ``batch["labels"]`` are >= 0 (at least one), plus
    1e-2 aux.  Differentiable in ``params``' leaves that require grad;
    attention's gradient is the flash_bwd kernel on the card."""
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
    """A frozen serving copy of a training model: projection and
    embedding weights cast to the compute dtype once, norm scales fp32.
    ``forward`` and decode give the bits they give on ``params``, whose
    applies cast the fp32 masters on every read."""
    cfg = params.cfg
    serving = copy.deepcopy(params).requires_grad_(False)
    for name, p in serving.named_parameters():
        if not name.endswith(".scale"):
            p.data = p.data.to(cdtype(cfg))
    return serving


def init_serve_cache(params: Transformer, cfg: ModelConfig, batch: int,
                     max_len: int, prefilled: int = 0) -> Params:
    """Zeroed decode caches for every layer, in the compute dtype:
    {"stack": [{"mixer": {"k", "v"}}] per stacked layer, "pro": the same
    per prologue layer, "pos": ``prefilled``}."""
    dev = params.device

    def one_layer() -> Params:
        c = init_attn_cache(cfg, batch, max_len, device=dev)
        c.pop("len")        # the position lives once, in caches["pos"]
        return {"mixer": c}

    return {"stack": [one_layer() for _ in params.stack],
            "pro": [one_layer() for _ in params.pro],
            "pos": int(prefilled)}


@torch.no_grad()
def serve_step(params: Transformer, cfg: ModelConfig, caches: Params,
               tokens) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), new caches).

    Every row of the batch is at position ``caches["pos"]``: one counter
    serves all rows, as in the reference.  The K/V tensors of
    ``caches`` are updated in place and carried into the returned dict,
    whose ``pos`` is one more.
    """
    dev = params.device
    x = embed_tokens(params.tok, cfg, _tokens(tokens, dev))
    pos = int(caches["pos"])
    flat = caches["pro"] + caches["stack"]
    new = []
    for lay, c in zip(params.layers(), flat):
        sub = dict(c["mixer"], len=pos)
        x, nc = _apply_layer(lay, cfg, x, cache=sub)
        new.append({"mixer": {"k": nc["k"], "v": nc["v"]}})
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    logits = unembed(params.tok, cfg, x)
    n_pro = len(caches["pro"])
    return logits, {"stack": new[n_pro:], "pro": new[:n_pro],
                    "pos": pos + 1}
