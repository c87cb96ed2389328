"""Model building blocks of the dense decoder: norms, RoPE, GQA attention,
MLPs, embeddings.

The counterpart of ``repro/models/layers.py`` for the blocks a dense
decoder-only LM serves with.  Each block is a small ``nn.Module`` that
holds the reference's parameter leaves under the same names
(``wq.w``, ``q_norm.scale``, ``wi.w`` ...), and an ``apply_*`` function
that takes it, as the reference's ``apply_*`` takes its params dict.

Weights are held in one of two ways (``held_dtype``).  A serving model
holds them in the compute dtype (``cdtype``), frozen: the reference
keeps fp32 masters and casts them inside every apply; the cast is
elementwise, so casting once when the weights are made or loaded gives
the same bits and saves a read of the fp32 masters (and a write of the
cast) on every call.  A training model (``train=True``) holds the
reference's fp32 masters with ``requires_grad=True``.  Every ``apply_*``
casts each leaf to ``cdtype`` where it reads it, as the reference does:
for a serving model that cast is the tensor itself, so its bits do not
move; for a training model the gradient flows back through the cast
into the fp32 master.  Norm scales stay fp32 either way, as the
reference applies them.

Attention has two modes, as in the reference: a causal prefill/forward
over the whole sequence, which runs the hand-written CUDA kernels on the
card where the reference runs ``chunked_attention`` -- without autograd
``kernels.ops.flash_attention``, and under autograd ``attention_fn``,
whose backward is the flash_bwd kernel; and a decode step against a KV
cache, which stays plain PyTorch, as the reference's
``decode_attention`` is outside any Pallas kernel.  A sliding window
(``window > 0``, Jamba's long-context attention) runs the same kernels
with the window in the prefill, and decodes against a ring buffer of
``min(window, max_len)`` rows.  Whisper's blocks run through the same
code: bidirectional self-attention (``causal=False``) in the encoder,
cross-attention (``kv_src=``: queries from the decoder, keys and values
from the encoder output, ``Sq != Sk``) in a prefill or in training,
attention without RoPE (``use_rope=False``; the model adds sinusoidal
positions, ``sinusoid_pos``, to its inputs instead), LayerNorm and the
GELU MLP with biases.  MLA, MoE and Mamba2 blocks live in ``mla.py``,
``moe.py`` and ``ssm.py``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ModelConfig

Params = Dict[str, Any]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def held_dtype(cfg: ModelConfig, train: bool) -> torch.dtype:
    """The dtype projection and embedding weights are held in: fp32
    masters for training, the compute dtype for serving."""
    return torch.float32 if train else cdtype(cfg)


def _frozen(x: torch.Tensor) -> nn.Parameter:
    """A leaf, frozen; a training model turns every leaf on with
    ``requires_grad_(True)`` once built."""
    return nn.Parameter(x, requires_grad=False)


def _dense(gen: torch.Generator, fan_in: int, *shape, dtype,
           device) -> torch.Tensor:
    """normal * 1/sqrt(fan_in), drawn in fp32 and cast to ``dtype``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(float(1.0 / np.sqrt(fan_in))).to(dtype)


class Dense(nn.Module):
    """One projection: ``w`` (d_in, d_out) and an optional ``bias``."""

    def __init__(self, w: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = _frozen(w)
        self.bias = None if bias is None else _frozen(bias)


class RMSNorm(nn.Module):
    """``scale`` (d,), fp32."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _frozen(scale)


class LayerNorm(nn.Module):
    """``scale`` and ``bias`` (d,), fp32."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.scale = _frozen(scale)
        self.bias = _frozen(bias)


# ---------------------------------------------------------------------------
# norms / positions / rope
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device=None) -> RMSNorm:
    return RMSNorm(torch.ones((d,), dtype=torch.float32, device=device))


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 inside, times the fp32 scale, then cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p.scale
    return out.to(x.dtype)


def init_layernorm(d: int, device=None) -> LayerNorm:
    return LayerNorm(torch.ones((d,), dtype=torch.float32, device=device),
                     torch.zeros((d,), dtype=torch.float32, device=device))


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 inside (the population variance), times the fp32 scale plus
    the fp32 bias, then cast back to x's dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * p.scale + p.bias
    return out.to(x.dtype)


def _sinusoid(start: int, seq: int, d: int) -> np.ndarray:
    pos = np.arange(start, start + seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return emb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _sinusoid_table(seq: int, d: int) -> np.ndarray:
    """A table from position 0, computed once (Whisper's 1,500 x 1,024
    takes tens of ms of host time in numpy), read-only."""
    emb = _sinusoid(0, seq, d)
    emb.setflags(write=False)
    return emb


def sinusoid_pos(seq: int, d: int, start: int = 0,
                 device=None) -> torch.Tensor:
    """(seq, d) fp32 absolute positions ``start .. start + seq - 1``:
    sin then cos of pos / 10000^(2i/d), computed in float64 with numpy
    and cast once, as the reference does, so a row is the same bits
    whatever ``start`` and ``seq`` it was computed with (a decode step
    computes its one row; tables from position 0 are cached)."""
    emb = _sinusoid_table(seq, d) if start == 0 else \
        _sinusoid(start, seq, d)
    return torch.tensor(emb, device=device)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, hd), pos (..., S) int -> rotated, same dtype.
    Half-split rotation with fp32 angles pos * freqs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = pos[..., None].to(torch.float32) * freqs            # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., : hd // 2].to(torch.float32)
    x2 = x[..., hd // 2:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _gqa_scores_softmax_out(q, k, v, scale):
    """q (B,Sq,H,hd), k/v (B,Sk,KVH,hd): fp32 scores and softmax, the
    weights cast to v's dtype for the product with v, as the reference."""
    B, Sq, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    q = q.reshape(B, Sq, KVH, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, v.shape[-1])


def decode_attention(q, k_cache, v_cache, cur_len: int):
    """Single-position decode: q (B,1,H,hd) vs cache (B,Smax,KVH,hd),
    seeing the cache positions below ``cur_len``.

    The reference masks the positions >= cur_len of the whole cache
    (weight exactly 0 after its -1e30 mask); here they are cut off
    instead, which is the same function.  The visible rows are copied
    out contiguous, so a step's arithmetic is the same whatever the
    cache's length (``max_len``): a server and ``generate`` with other
    cache sizes give the same bits.
    """
    n = min(int(cur_len), k_cache.shape[1])
    scale = 1.0 / np.sqrt(q.shape[-1])
    return _gqa_scores_softmax_out(q, k_cache[:, :n].contiguous(),
                                   v_cache[:, :n].contiguous(), scale)


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` (and ``q_norm``/``k_norm``)."""

    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense,
                 q_norm: Optional[RMSNorm] = None,
                 k_norm: Optional[RMSNorm] = None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.q_norm, self.k_norm = q_norm, k_norm


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device=None, dtype=None) -> Attention:
    D, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype or cdtype(cfg), device=device)

    def bias(n):
        return torch.zeros((n,), **kw) if cfg.qkv_bias else None

    p = Attention(Dense(_dense(gen, D, D, H * hd, **kw), bias(H * hd)),
                  Dense(_dense(gen, D, D, KVH * hd, **kw), bias(KVH * hd)),
                  Dense(_dense(gen, D, D, KVH * hd, **kw), bias(KVH * hd)),
                  Dense(_dense(gen, H * hd, H * hd, D, **kw)))
    if cfg.qk_norm:
        p.q_norm = init_rmsnorm(hd, device)
        p.k_norm = init_rmsnorm(hd, device)
    return p


def _proj(p: Dense, x: torch.Tensor, n_heads: int, hd: int,
          dtype: torch.dtype) -> torch.Tensor:
    y = torch.matmul(x, p.w.to(dtype))
    if p.bias is not None:
        y = y + p.bias.to(dtype)
    return y.reshape(*x.shape[:-1], n_heads, hd)


class _FlashAttention(torch.autograd.Function):
    """Attention with the flash kernels: the forward saves q, k, v, out
    and the rows' log-sum-exp, the backward is one flash_bwd call."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out, lse = ops.flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand a strided dout: the entry makes it contiguous
        # for the kernel
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                             **ctx.kw)
        return dq, dk, dv, None, None, None


def attention_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int = 0,
                 q_offset: int = 0) -> torch.Tensor:
    """``ops.flash_attention`` with a gradient: under autograd (an
    operand that requires grad) a ``torch.autograd.Function`` whose
    forward runs ``ops.flash_attention_fwd`` and whose backward runs
    ``ops.flash_attention_bwd`` (the kernels on the card, their plain
    versions on the CPU); otherwise ``ops.flash_attention`` itself.
    Both give the same output bits."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def apply_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
                    cache: Optional[Params] = None, window: int = 0,
                    causal: bool = True,
                    kv_src: Optional[torch.Tensor] = None,
                    use_rope: bool = True
                    ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One attention layer: causal self-attention with RoPE by default;
    with ``window > 0`` a query sees the ``window`` positions up to its
    own.  ``causal=False``: every query sees every key (Whisper's
    encoder).  ``kv_src`` (B, Sk, D): cross-attention, keys and values
    projected from ``kv_src`` (cast to the compute dtype), over the
    whole sequence (the cache is not read; pass ``causal=False``).
    ``use_rope=False``: no rotation, in a prefill and in decode.

    cache: {"k", "v" (B, Smax, KVH, hd), "len" int} -- decode mode.  The
    new K/V rows are written into the cache's tensors in place (the
    reference returns new arrays; updating in place saves a copy of the
    cache a step) at slot ``min(len, Smax - S)``: past the end the
    reference's ``dynamic_update_slice`` clamps its start, so the last
    row is overwritten, and so is it here.  With a window the cache is
    a ring buffer: the slot is ``len mod Smax`` and the step sees
    ``min(len + 1, Smax)`` rows; RoPE has rotated each row by its
    absolute position before the write, so a wrapped buffer needs no
    other mask.  Returns (y, new cache) with ``len + 1``.  Without a
    cache, or with ``kv_src``: the whole sequence from position 0,
    through ``attention_fn`` with ``causal`` and the window.
    """
    dt = cdtype(cfg)
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _proj(p.wq, x, H, hd, dt)
    src = x if kv_src is None else kv_src.to(dt)
    k = _proj(p.wk, src, KVH, hd, dt)
    v = _proj(p.wv, src, KVH, hd, dt)
    if cfg.qk_norm:
        q = rms_norm(p.q_norm, q, cfg.norm_eps)
        k = rms_norm(p.k_norm, k, cfg.norm_eps)

    new_cache = None
    if cache is not None and kv_src is None:
        cur = int(cache["len"])
        if use_rope:
            pos = torch.full((B, S), cur, dtype=torch.int32,
                             device=x.device)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        kc, vc = cache["k"], cache["v"]
        slot = cur % kc.shape[1] if window > 0 else cur
        slot = max(0, min(slot, kc.shape[1] - S))
        kc[:, slot:slot + S] = k.to(kc.dtype)
        vc[:, slot:slot + S] = v.to(vc.dtype)
        # sees min(cur + 1, Smax) rows: a ring buffer's every row once full
        out = decode_attention(q, kc, vc, cur + 1)
        new_cache = {"k": kc, "v": vc, "len": cur + 1}
    else:
        if use_rope:
            pos = torch.arange(S, dtype=torch.int32,
                               device=x.device)[None].expand(B, S)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        out = attention_fn(q, k, v, causal=causal, window=window)

    y = torch.matmul(out.reshape(B, S, H * hd), p.wo.w.to(dt))
    return y, new_cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    window: int = 0, device=None) -> Params:
    """Zeroed {"k", "v", "len": 0}: ``max_len`` rows, or with a window
    ``min(window, max_len)`` (the ring buffer)."""
    size = min(window, max_len) if window > 0 else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    kw = dict(dtype=cdtype(cfg), device=device)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
            "len": 0}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU: ``wi``, ``wg``, ``wdown``; GELU: ``wi``, ``wdown`` with
    biases."""

    def __init__(self, wi: Dense, wdown: Dense, wg: Optional[Dense] = None):
        super().__init__()
        self.wi, self.wdown, self.wg = wi, wdown, wg


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, device=None, dtype=None) -> MLP:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    kw = dict(dtype=dtype or cdtype(cfg), device=device)
    if cfg.mlp_gelu:
        return MLP(Dense(_dense(gen, D, D, Fd, **kw), torch.zeros((Fd,), **kw)),
                   Dense(_dense(gen, Fd, Fd, D, **kw), torch.zeros((D,), **kw)))
    wi = Dense(_dense(gen, D, D, Fd, **kw))
    wg = Dense(_dense(gen, D, D, Fd, **kw))
    return MLP(wi, Dense(_dense(gen, Fd, Fd, D, **kw)), wg)


def apply_mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = cdtype(cfg)
    if cfg.mlp_gelu:
        h = F.gelu(torch.matmul(x, p.wi.w.to(dt)) + p.wi.bias.to(dt),
                   approximate="tanh")
        return torch.matmul(h, p.wdown.w.to(dt)) + p.wdown.bias.to(dt)
    g = torch.matmul(x, p.wg.w.to(dt))
    h = torch.matmul(x, p.wi.w.to(dt))
    return torch.matmul(F.silu(g) * h, p.wdown.w.to(dt))


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """``embed`` (V, D) and, unless tied, ``unembed`` (D, V)."""

    def __init__(self, embed: Dense, unembed: Optional[Dense] = None):
        super().__init__()
        self.embed, self.unembed = embed, unembed


def init_embed(gen: torch.Generator, cfg: ModelConfig, device=None,
               dtype=None) -> Embed:
    kw = dict(dtype=dtype or cdtype(cfg), device=device)
    p = Embed(Dense(_dense(gen, cfg.d_model, cfg.vocab_size, cfg.d_model,
                           **kw)))
    if not cfg.tie_embeddings:
        p.unembed = Dense(_dense(gen, cfg.d_model, cfg.d_model,
                                 cfg.vocab_size, **kw))
    return p


def embed_tokens(p: Embed, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The whole table cast to the compute dtype, then gathered, as the
    reference does: the gradient of repeated tokens accumulates in that
    dtype before it reaches the fp32 master."""
    return p.embed.w.to(cdtype(cfg))[tokens]


def unembed(p: Embed, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = cdtype(cfg)
    w = p.embed.w.to(dt).T if cfg.tie_embeddings else p.unembed.w.to(dt)
    return torch.matmul(x, w)
