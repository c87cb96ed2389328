"""Transformer assembly: forward, loss, encoder and decode.

The counterpart of ``repro/models/transformer.py`` for ``attn`` (GQA,
with RoPE or with sinusoidal positions, optionally a sliding window),
``mla`` and ``mamba2`` mixers, each followed by a ``dense`` or ``moe``
MLP or by none (``mlp="none"``: Mamba2-130M's layers).  The reference
stacks its pattern repeats on a leading axis and scans them; here the
layers are one module each, in the same order: the prologue layers,
then pattern x repeats (repeat major).  ``init_serve_cache`` keeps the
reference's ``{"stack", "pro", "pos"}`` layout with one position
counter ``pos`` for the whole batch (a Python int), and
``caches["stack"][i]`` is layer i's ``{"mixer": ...}``, of its mixer's
kind: ``{"k", "v"}`` for attention (a ring buffer of ``min(window,
max_len)`` rows with a window), ``{"c_kv", "k_rope"}`` for MLA,
``{"conv", "state"}`` for Mamba2, which carries no position.

Both of the reference's other families run through the same code.  A
model with ``n_frontend_tokens`` (InternVL2) prepends
``batch["frontend"]``'s embeddings to the tokens' and cuts their
positions from the logits.  An encoder-decoder model (Whisper) holds an
``encoder`` (``stack`` of bidirectional attention + GELU MLP layers and
``final_norm``); ``encode`` runs it over ``batch["enc_frames"]``, and
each decoder layer's ``cross`` block attends to its output.  Such a
model decodes through ``encode`` -> ``init_serve_cache(enc_out=)``,
which projects every cross layer's K/V once into
``caches["stack_cross"]`` -> ``serve_step``.  LayerNorm replaces
RMSNorm where ``cfg.use_layernorm``, sinusoidal positions RoPE where
not ``cfg.use_rope``.

MoE layers return the reference's aux losses; ``forward`` returns their
sum over the layers (``lb_loss + 1e-3 z_loss`` each) and ``loss_fn``
adds 1e-2 of it.  Every family trains as the dense ones do: MLA's
prefill attention takes its gradient from the two-width flash backward
(q/k nope + rope wide, v ``v_head_dim``), a windowed layer's from the
flash backward with its window, the encoder's and the cross blocks'
from the flash backward without a causal mask (the cross blocks' k and
v gradients flow back into the encoder), and Mamba2's from autograd
through its PyTorch scan.

``forward`` and ``serve_step`` serve, under ``torch.no_grad``, on a
serving model or on a training model (``for_serving`` makes the former
from the latter).
``loss_fn`` trains: it runs the grad-enabled ``_forward``, in which,
with ``remat``, each stacked layer and each encoder layer runs under
``torch.utils.checkpoint`` (the reference checkpoints its scan bodies,
one pattern repeat or one encoder layer; the recompute is the same,
layer by layer), so that backward recomputes the layer, flash forward
or SSD scan included.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from .config import LayerSpec, ModelConfig
from .layers import (Attention, Embed, LayerNorm, MLP, Params, RMSNorm,
                     _proj, apply_attention, apply_mlp, cdtype,
                     decode_attention, embed_tokens, held_dtype,
                     init_attention, init_attn_cache, init_embed,
                     init_layernorm, init_mlp, init_rmsnorm, layer_norm,
                     rms_norm, sinusoid_pos, unembed)
from .mla import MLA, apply_mla, init_mla, init_mla_cache
from .moe import MoE, apply_moe, init_moe
from .ssm import FP32_LEAVES, Mamba2, apply_mamba2, init_mamba2, \
    init_mamba2_cache

# the encoder's layers: bidirectional attention and the (GELU) MLP
ENCODER_SPEC = LayerSpec(mixer="attn", mlp="dense")
Norm = Union[RMSNorm, LayerNorm]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a layer the port does not know:
    a mixer other than ``attn``, ``mla`` or ``mamba2``, or an MLP other
    than ``dense``, ``moe`` or ``none``.  Every config of the reference
    passes."""
    what = []
    for spec in cfg.prologue + cfg.pattern:
        if spec.mixer not in ("attn", "mla", "mamba2"):
            what.append(f"the {spec.mixer} mixer")
        if spec.mlp not in ("dense", "moe", "none"):
            what.append(f"{spec.mlp} MLP layers")
    if what:
        raise NotImplementedError(
            f"{cfg.name}: " + ", ".join(dict.fromkeys(what))
            + " is not a layer of the reference's models")


def _norm(cfg: ModelConfig):
    """(init, apply) of the model's norm: LayerNorm or RMSNorm."""
    return (init_layernorm, layer_norm) if cfg.use_layernorm \
        else (init_rmsnorm, rms_norm)


class Layer(nn.Module):
    """``norm1``; the mixer under the reference's key: ``attn`` (an
    ``Attention`` or an ``MLA``) or ``mixer`` (a ``Mamba2``); then, in
    a decoder layer of an encoder-decoder model, ``norm_cross`` and
    ``cross`` (an ``Attention`` over the encoder output); then
    ``norm2`` and ``mlp`` or ``moe``, or neither (``mlp="none"``).
    Norms are ``RMSNorm`` or ``LayerNorm``.  ``window`` is an attention
    layer's sliding window (0: none)."""

    def __init__(self, norm1: Norm, mix: nn.Module,
                 norm2: Optional[Norm] = None, mlp: Optional[MLP] = None,
                 moe: Optional[MoE] = None, *, window: int = 0,
                 norm_cross: Optional[Norm] = None,
                 cross: Optional[Attention] = None):
        super().__init__()
        if mlp is not None and moe is not None:
            raise ValueError("a layer holds an mlp or a moe, not both")
        if (norm2 is None) != (mlp is None and moe is None):
            raise ValueError("norm2 comes with an mlp or a moe")
        if (norm_cross is None) != (cross is None):
            raise ValueError("norm_cross comes with cross")
        self.norm1 = norm1
        if isinstance(mix, Mamba2):
            self.attn, self.mixer = None, mix
        else:
            self.attn, self.mixer = mix, None
        self.norm_cross, self.cross = norm_cross, cross
        self.norm2, self.mlp, self.moe = norm2, mlp, moe
        self.window = int(window)


class Encoder(nn.Module):
    """Whisper's encoder: ``stack`` (``n_encoder_layers`` layers of
    bidirectional attention and the MLP) and ``final_norm``."""

    def __init__(self, stack: List[Layer], final_norm: Norm):
        super().__init__()
        self.stack = nn.ModuleList(stack)
        self.final_norm = final_norm


class Transformer(nn.Module):
    """The decoder: ``tok`` (embed / unembed), ``pro`` and ``stack``
    (one ``Layer`` each), ``final_norm``; and for an encoder-decoder
    config its ``encoder``."""

    def __init__(self, cfg: ModelConfig, tok: Embed, pro: List[Layer],
                 stack: List[Layer], final_norm: Norm,
                 encoder: Optional[Encoder] = None):
        super().__init__()
        check_supported(cfg)
        if cfg.is_encoder_decoder != (encoder is not None):
            raise ValueError(f"{cfg.name}: an encoder comes with an "
                             "encoder-decoder config, and only with one")
        self.cfg = cfg
        self.tok = tok
        self.pro = nn.ModuleList(pro)
        self.stack = nn.ModuleList(stack)
        self.final_norm = final_norm
        self.encoder = encoder

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def layers(self) -> List[Layer]:
        """Every decoder layer in order: the prologue's, then the
        stack's."""
        return list(self.pro) + list(self.stack)


def _init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                device, dtype) -> Layer:
    init_n, _ = _norm(cfg)
    init_mixer = {"mla": init_mla, "mamba2": init_mamba2}.get(
        spec.mixer, init_attention)
    mix = init_mixer(gen, cfg, device, dtype)
    extra = {}
    if spec.cross:
        extra = dict(norm_cross=init_n(cfg.d_model, device),
                     cross=init_attention(gen, cfg, device, dtype))
    if spec.mlp == "moe":
        extra["moe"] = init_moe(gen, cfg, device, dtype)
    elif spec.mlp == "dense":
        extra["mlp"] = init_mlp(gen, cfg, device=device, dtype=dtype)
    if spec.mlp != "none":
        extra["norm2"] = init_n(cfg.d_model, device)
    return Layer(init_n(cfg.d_model, device), mix, window=spec.window,
                 **extra)


def init_model(cfg: ModelConfig, seed: int = 0, *,
               device: DeviceLike = None, train: bool = False
               ) -> Transformer:
    """A model of random weights, drawn on ``device`` (the card unless
    given) from a ``torch.Generator`` seeded with ``seed``, with the
    reference's distributions: projections and embeddings normal times
    1/sqrt(fan_in), norm scales 1, biases 0.  Weights are held in the
    compute dtype, frozen, or with ``train`` as fp32 masters with
    ``requires_grad=True`` (the values a serving model of the same seed
    holds before its cast); norm scales and biases, MoE routers and
    Mamba2's ``dt_bias``, ``A_log`` and ``ssm_D`` in fp32.  An
    encoder-decoder config's encoder is drawn after the decoder.  On
    ``device="meta"`` it allocates and draws nothing.  Raises for a
    layer kind the port does not know, before drawing anything."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = held_dtype(cfg, train)
    init_n, _ = _norm(cfg)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(int(seed))
    tok = init_embed(gen, cfg, dev, dt)
    pro = [_init_layer(gen, cfg, spec, dev, dt) for spec in cfg.prologue]
    stack = [_init_layer(gen, cfg, spec, dev, dt)
             for _ in range(cfg.repeats) for spec in cfg.pattern]
    final_norm = init_n(cfg.d_model, dev)
    encoder = None
    if cfg.is_encoder_decoder:
        encoder = Encoder([_init_layer(gen, cfg, ENCODER_SPEC, dev, dt)
                           for _ in range(cfg.n_encoder_layers)],
                          init_n(cfg.d_model, dev))
    model = Transformer(cfg, tok, pro, stack, final_norm, encoder)
    return model.requires_grad_(train)


def _cross_from_cache(p: Attention, cfg: ModelConfig, h: torch.Tensor,
                      ck: Params) -> torch.Tensor:
    """Decode-time cross-attention against the precomputed K/V ``ck``
    ({"k", "v"} (B, Te, KVH, hd)): every encoder row, no mask, in plain
    PyTorch (``decode_attention``), as the reference's
    ``_cross_from_cache``."""
    dt = cdtype(cfg)
    B, S, _ = h.shape
    q = _proj(p.wq, h, cfg.n_heads, cfg.head_dim, dt)
    out = decode_attention(q, ck["k"], ck["v"], ck["k"].shape[1])
    return torch.matmul(out.reshape(B, S, cfg.n_heads * cfg.head_dim),
                        p.wo.w.to(dt))


def _no_cross_cache(cfg: ModelConfig) -> ValueError:
    return ValueError(
        f"{cfg.name}: an encoder-decoder model decodes through encode -> "
        "init_serve_cache(enc_out=) -> serve_step; these caches hold no "
        "cross-attention K/V (caches['stack_cross']), and a cross layer "
        "without them has nothing to attend to")


def _apply_layer(lay: Layer, cfg: ModelConfig, x: torch.Tensor, *,
                 cache: Optional[Params], causal: bool = True,
                 enc: Optional[torch.Tensor] = None,
                 cross_kv: Optional[Params] = None
                 ) -> Tuple[torch.Tensor, Optional[Params],
                            Optional[torch.Tensor]]:
    """-> (x, the mixer's new cache, the layer's aux ``lb_loss + 1e-3
    z_loss`` (None without a MoE)).  A cross block attends to ``enc``
    (the encoder output, in a prefill or in training) or, in decode, to
    its precomputed ``cross_kv``."""
    _, norm = _norm(cfg)
    h = norm(lay.norm1, x, cfg.norm_eps)
    if lay.mixer is not None:
        mix, new_cache = apply_mamba2(lay.mixer, cfg, h, cache=cache)
    elif isinstance(lay.attn, MLA):
        mix, new_cache = apply_mla(lay.attn, cfg, h, cache=cache)
    else:
        mix, new_cache = apply_attention(lay.attn, cfg, h, cache=cache,
                                         window=lay.window, causal=causal,
                                         use_rope=cfg.use_rope)
    x = x + mix
    if lay.cross is not None:
        h = norm(lay.norm_cross, x, cfg.norm_eps)
        if cross_kv is not None:
            mix = _cross_from_cache(lay.cross, cfg, h, cross_kv)
        elif enc is not None:
            mix, _ = apply_attention(lay.cross, cfg, h, causal=False,
                                     kv_src=enc, use_rope=False)
        else:
            raise _no_cross_cache(cfg)
        x = x + mix
    if lay.norm2 is None:
        return x, new_cache, None
    h = norm(lay.norm2, x, cfg.norm_eps)
    if lay.moe is None:
        return x + apply_mlp(lay.mlp, cfg, h), new_cache, None
    out, aux = apply_moe(lay.moe, cfg, h)
    return x + out, new_cache, aux["lb_loss"] + 1e-3 * aux["z_loss"]


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    return torch.as_tensor(tokens).to(device=device, dtype=torch.int64)


def _floats(x, device: torch.device) -> torch.Tensor:
    """Stub embeddings (frontend patches, encoder frames): a tensor or
    an array, on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return torch.as_tensor(x).to(device)


def _stack_layer(lay: Layer, cfg: ModelConfig, x: torch.Tensor,
                 enc: Optional[torch.Tensor] = None, causal: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer without a cache -> (x, aux, 0.0 without a MoE): tensors
    only, for ``torch.utils.checkpoint``."""
    x, _, aux = _apply_layer(lay, cfg, x, cache=None, causal=causal,
                             enc=enc)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _run_stack(layers, cfg: ModelConfig, x: torch.Tensor, remat: bool, *,
               enc: Optional[torch.Tensor] = None, causal: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layers in order, each under ``torch.utils.checkpoint`` with
    ``remat`` (non-reentrant; ``enc`` goes in as an input, so that its
    gradient flows back through the recompute) -> (x, the summed aux
    from 0.0)."""
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for lay in layers:
        if remat:
            # tensors in and out; nothing random runs inside
            x, aux = checkpoint(
                lambda h, e, lay=lay: _stack_layer(lay, cfg, h, e, causal),
                x, enc, use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _stack_layer(lay, cfg, x, enc, causal)
        aux_sum = aux_sum + aux
    return x, aux_sum


def _encode(params: Transformer, cfg: ModelConfig, frames,
            remat: bool) -> torch.Tensor:
    """The encoder under autograd: frames cast to the compute dtype,
    plus sinusoidal positions, the bidirectional stack, the final
    norm."""
    dev = params.device
    x = _floats(frames, dev).to(cdtype(cfg))
    x = x + sinusoid_pos(x.shape[1], cfg.d_model, device=dev)[None] \
        .to(x.dtype)
    x, _ = _run_stack(params.encoder.stack, cfg, x, remat, causal=False)
    _, norm = _norm(cfg)
    return norm(params.encoder.final_norm, x, cfg.norm_eps)


@torch.no_grad()
def encode(params: Transformer, cfg: ModelConfig, frames) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, Te, D), a
    tensor or an array -> (B, Te, D) in the compute dtype.  Its
    self-attention runs ``ops.flash_attention`` without a causal mask."""
    return _encode(params, cfg, frames, remat=False)


def _forward(params: Transformer, cfg: ModelConfig, batch: Dict[str, Any],
             remat: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward under autograd -> (logits (B, S, V) in the compute
    dtype, aux fp32 0-d).  ``batch["frontend"]`` (B, Tf, D), where the
    config has frontend tokens, is cast to the compute dtype and
    prepended to the token embeddings, and its Tf positions are cut
    after the final norm; without RoPE, sinusoidal positions are added
    to the embeddings; an encoder-decoder model encodes
    ``batch["enc_frames"]`` first and hands the output to every cross
    block.  aux sums the MoE layers' ``lb_loss + 1e-3 z_loss`` as the
    reference does: over the prologue, plus the stack's own sum from
    0.0 (0.0 without a MoE).  With ``remat`` each stacked layer and
    each encoder layer runs under ``torch.utils.checkpoint`` (the
    prologue's layers do not, as the reference checkpoints only its
    scan bodies)."""
    dev = params.device
    x = embed_tokens(params.tok, cfg, _tokens(batch["tokens"], dev))
    n_front = 0
    if cfg.n_frontend_tokens and "frontend" in batch:
        front = _floats(batch["frontend"], dev).to(x.dtype)
        n_front = front.shape[1]
        x = torch.cat([front, x], dim=1)
    if not cfg.use_rope:
        x = x + sinusoid_pos(x.shape[1], cfg.d_model, device=dev)[None] \
            .to(x.dtype)
    enc = _encode(params, cfg, batch["enc_frames"], remat) \
        if cfg.is_encoder_decoder else None
    aux_pro = torch.zeros((), dtype=torch.float32, device=dev)
    for lay in params.pro:
        x, _, aux = _apply_layer(lay, cfg, x, cache=None, enc=enc)
        if aux is not None:
            aux_pro = aux_pro + aux
    x, aux_stack = _run_stack(params.stack, cfg, x, remat, enc=enc)
    _, norm = _norm(cfg)
    x = norm(params.final_norm, x, cfg.norm_eps)
    if n_front:
        x = x[:, n_front:]
    logits = unembed(params.tok, cfg, x)
    return logits, aux_pro + aux_stack


@torch.no_grad()
def forward(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill / scoring forward -> (logits (B, S, V) in the compute
    dtype, aux: the MoE layers' summed aux losses, 0.0 without MoE).
    ``batch["tokens"]`` (B, S), a tensor or an array; ``"frontend"``
    (B, Tf, D) for a model with frontend tokens (optional, as in the
    reference) and ``"enc_frames"`` (B, Te, D) for an encoder-decoder
    model.  Attention (GQA, the encoder's, cross-attention and MLA's
    prefill) runs through ``ops.flash_attention``."""
    return _forward(params, cfg, batch, remat=False)


def loss_fn(params: Transformer, cfg: ModelConfig, batch: Dict[str, Any],
            *, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's LM loss -> (loss, {"nll", "aux", "tokens"}):
    fp32 logits, their logsumexp minus the gold logit, averaged over the
    tokens whose ``batch["labels"]`` are >= 0 (at least one), plus
    1e-2 aux.  Differentiable in ``params``' leaves that require grad;
    attention's gradient (GQA's, the encoder's and cross-attention's,
    and MLA's prefill at two widths) is the flash_bwd kernel on the
    card."""
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
    and conv weights and the projections' biases cast to the compute
    dtype once; norm scales, LayerNorm's biases (which the reference
    adds in fp32 before its cast), MoE routers and Mamba2's
    ``dt_bias``, ``A_log`` and ``ssm_D`` fp32.  ``forward`` and decode
    give the bits they give on ``params``, whose applies cast the fp32
    masters on every read."""
    cfg = params.cfg
    serving = copy.deepcopy(params).requires_grad_(False)
    norms = {n for n, m in serving.named_modules()
             if isinstance(m, LayerNorm)}
    for name, p in serving.named_parameters():
        if name.rpartition(".")[0] in norms or name.endswith(
                (".scale", ".router.w")
                + tuple(f".{n}" for n in FP32_LEAVES)):
            continue
        p.data = p.data.to(cdtype(cfg))
    return serving


@torch.no_grad()
def init_serve_cache(params: Transformer, cfg: ModelConfig, batch: int,
                     max_len: int, enc_out: Optional[torch.Tensor] = None,
                     prefilled: int = 0) -> Params:
    """Zeroed decode caches for every layer, in the compute dtype:
    {"stack": [{"mixer": {"k", "v"}} for attention (``min(window,
    max_len)`` rows with a window), {"mixer": {"c_kv", "k_rope"}} for
    MLA, {"mixer": {"conv", "state"}} for Mamba2] per stacked layer,
    "pro": the same per prologue layer, "pos": ``prefilled``}.  With
    ``enc_out`` (B, Te, D), ``encode``'s output, an encoder-decoder
    model's cross layers get their K/V projected once (the reference's
    serving path): ``"stack_cross"``, a list beside ``"stack"``, holds
    {"k", "v"} (B, Te, KVH, hd) for each stacked layer with a cross
    block (None for one without)."""
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

    caches = {"stack": [one_layer(lay) for lay in params.stack],
              "pro": [one_layer(lay) for lay in params.pro],
              "pos": int(prefilled)}
    if cfg.is_encoder_decoder and enc_out is not None:
        dt = cdtype(cfg)
        src = _floats(enc_out, dev).to(dt)

        def cross_kv(p: Attention) -> Params:
            return {"k": _proj(p.wk, src, cfg.n_kv_heads, cfg.head_dim, dt),
                    "v": _proj(p.wv, src, cfg.n_kv_heads, cfg.head_dim, dt)}

        caches["stack_cross"] = [None if lay.cross is None
                                 else cross_kv(lay.cross)
                                 for lay in params.stack]
    return caches


@torch.no_grad()
def serve_step(params: Transformer, cfg: ModelConfig, caches: Params,
               tokens) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), new caches).

    Every row of the batch is at position ``caches["pos"]``: one counter
    serves all rows, as in the reference, and a MoE layer routes the B
    tokens of the step as one group.  Attention and MLA layers read the
    position (``len``); a Mamba2 layer carries its state and needs none.
    Without RoPE the position's sinusoid row is added to the token's
    embedding.  A cross block attends to its layer's
    ``caches["stack_cross"]`` K/V; an encoder-decoder model's caches
    without them raise ValueError (the reference's cross blocks would
    attend the step's token to itself).  The cache tensors of
    ``caches`` are updated in place and carried into the returned dict,
    whose ``pos`` is one more.
    """
    dev = params.device
    x = embed_tokens(params.tok, cfg, _tokens(tokens, dev))
    pos = int(caches["pos"])
    if not cfg.use_rope:
        # the reference slices its max_seq_len-row table with
        # dynamic_slice_in_dim, which clamps the start: past the table a
        # step adds its last row
        row = min(pos, cfg.max_seq_len - 1)
        x = x + sinusoid_pos(1, cfg.d_model, row, device=dev)[None] \
            .to(x.dtype)
    n_pro = len(caches["pro"])
    cross = [None] * n_pro + list(caches.get(
        "stack_cross", [None] * len(caches["stack"])))
    flat = caches["pro"] + caches["stack"]
    new = []
    for lay, c, ck in zip(params.layers(), flat, cross):
        if lay.cross is not None and ck is None:
            raise _no_cross_cache(cfg)
        sub = dict(c["mixer"], len=pos)
        x, nc, _ = _apply_layer(lay, cfg, x, cache=sub, cross_kv=ck)
        new.append({"mixer": {k: t for k, t in nc.items() if k != "len"}})
    _, norm = _norm(cfg)
    x = norm(params.final_norm, x, cfg.norm_eps)
    logits = unembed(params.tok, cfg, x)
    out = {"stack": new[n_pro:], "pro": new[:n_pro], "pos": pos + 1}
    if "stack_cross" in caches:
        out["stack_cross"] = caches["stack_cross"]
    return logits, out
