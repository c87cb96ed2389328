"""Mamba2 / SSD (state-space duality) block.

The counterpart of ``repro/models/ssm.py``.  The chunked SSD algorithm
computes the recurrence inside a chunk of L positions as an (L x L)
masked product, and carries a small (H, N, P) state across the chunks;
decode keeps a constant-size cache, the conv window and the SSD state.

The reference writes all of it in ``jnp`` with no Pallas kernel, so the
port is PyTorch on tensors: the same float program (the same segment
sums, masked before their exp; every product of the scan in fp32,
whatever the model's dtype), with the order of contractions chosen for
PyTorch's batched matmuls.  On the card those fp32 products stay fp32:
the package turns TF32 off when it is imported.  The scan over the
chunks is a loop over them.  Each leaf keeps the reference's name
(``ssm_in.w``, ``conv_w``, ``conv_b``, ``dt_bias``, ``A_log``,
``ssm_D``, ``gate_norm.scale``, ``ssm_out.w``); ``dt_bias``, ``A_log``
and ``ssm_D``, which the reference reads in fp32, are held in fp32 by a
serving model too, as the norm scales are.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import (Dense, Params, RMSNorm, _dense, _frozen, cdtype,
                     init_rmsnorm, rms_norm)

G = 1  # ssm groups (ngroups=1 for the pool's archs)

# the leaves read in fp32 whatever the compute dtype
FP32_LEAVES = ("dt_bias", "A_log", "ssm_D")


class Mamba2(nn.Module):
    """``ssm_in`` (D, 2 di + 2 N + H), ``conv_w`` (W, di + 2 N),
    ``conv_b``, ``dt_bias``, ``A_log``, ``ssm_D`` (H,), ``gate_norm``
    (di,), ``ssm_out`` (di, D)."""

    def __init__(self, ssm_in: Dense, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, dt_bias: torch.Tensor,
                 A_log: torch.Tensor, ssm_D: torch.Tensor,
                 gate_norm: RMSNorm, ssm_out: Dense):
        super().__init__()
        self.ssm_in = ssm_in
        self.conv_w, self.conv_b = _frozen(conv_w), _frozen(conv_b)
        self.dt_bias, self.A_log = _frozen(dt_bias), _frozen(A_log)
        self.ssm_D = _frozen(ssm_D)
        self.gate_norm, self.ssm_out = gate_norm, ssm_out


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, device=None,
                dtype=None) -> Mamba2:
    """The reference's init: the projections normal * 1/sqrt(fan_in),
    the conv the identity on its last tap, ``A = -[1 .. 16]`` over the
    heads, ``D`` 1, the biases 0."""
    D, di, N, H, W = (cfg.d_model, cfg.d_inner_ssm, cfg.ssm_state,
                      cfg.ssm_heads, cfg.conv_width)
    conv_ch = di + 2 * G * N
    kw = dict(dtype=dtype or cdtype(cfg), device=device)
    f32 = dict(dtype=torch.float32, device=device)
    ssm_in = Dense(_dense(gen, D, D, 2 * di + 2 * G * N + H, **kw))
    conv_w = torch.zeros((W, conv_ch), **kw)
    conv_w[W - 1] = 1.0                               # identity-ish init
    return Mamba2(ssm_in, conv_w, torch.zeros((conv_ch,), **kw),
                  torch.zeros((H,), **f32),
                  torch.log(torch.linspace(1.0, 16.0, H, **f32)),
                  torch.ones((H,), **f32), init_rmsnorm(di, device),
                  Dense(_dense(gen, di, di, D, **kw)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)) at every x (``F.softplus`` returns x itself above
    its threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, width W: xbc (B, S, CH), w (W, CH), b (CH,).

    prev (B, W-1, CH) is the decode carry (zeros without one).  The
    taps are summed in the reference's order in xbc's dtype (each
    product and partial sum rounded there), then biased and put through
    silu.  Returns (out, new_prev), new_prev the last W-1 inputs.
    """
    Wd, S = w.shape[0], xbc.shape[1]
    pad = torch.zeros_like(xbc[:, :Wd - 1]) if prev is None else prev
    full = torch.cat([pad, xbc], dim=1)                  # (B, S+W-1, CH)
    out = full[:, 0:S] * w[0]
    for i in range(1, Wd):
        out = out + full[:, i:i + S] * w[i]
    return F.silu(out + b), full[:, -(Wd - 1):]


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan: x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N),
    all fp32 -> (y (B, S, H, P), final state (B, H, N, P)).

    S must be a multiple of ``chunk`` (the reference's reshape fails
    otherwise); this raises a ValueError naming the chunk, and pads
    nothing.  Within a chunk, y_t = sum_{s<=t} C_t.B_s exp(cum_t -
    cum_s) dt_s x_s with cum the cumulative log-decay dt A; the segment
    sums are masked (-1e30 above the diagonal) before the exp, so that
    no masked branch overflows into the gradient.  The heads are a
    batch axis of the (L x L) products.  Across chunks the state before
    each chunk is carried by a loop, as the reference's ``lax.scan``.
    """
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"SSD: sequence length {S} is not a multiple of "
                         f"the chunk {chunk} (ssm_chunk); the reference's "
                         "reshape refuses it too, and nothing is padded")
    nc, L = S // chunk, chunk
    xh = x.reshape(Bb, nc, L, H, P).permute(0, 1, 3, 2, 4)   # (B,nc,H,L,P)
    dth = dt.reshape(Bb, nc, L, H).permute(0, 1, 3, 2)       # (B,nc,H,L)
    Bc = Bm.reshape(Bb, nc, L, N)
    Cc = Cm.reshape(Bb, nc, L, N)

    la = dth * A[None, None, :, None]                    # log-decay, <= 0
    cum = torch.cumsum(la, dim=-1)                       # (B,nc,H,L)

    # intra-chunk: M[t, s] = C_t.B_s * exp(cum_t - cum_s) * dt_s, s <= t
    CB = torch.einsum("bcln,bcmn->bclm", Cc, Bc)         # (B,nc,L,L)
    seg = cum[..., :, None] - cum[..., None, :]          # (B,nc,H,L,L)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri, seg, -1e30))
    M = CB[:, :, None] * decay * dth[..., None, :]
    y_intra = torch.matmul(M, xh)                        # (B,nc,H,L,P)

    # chunk summaries: S_c = sum_s exp(cum_L - cum_s) dt_s B_s x_s^T
    dec_end = torch.exp(cum[..., -1:] - cum)             # (B,nc,H,L)
    Sc = torch.matmul(Bc.transpose(-1, -2)[:, :, None],
                      (dec_end * dth)[..., None] * xh)   # (B,nc,H,N,P)
    chunk_decay = torch.exp(cum[..., -1])                # (B,nc,H)

    # inter-chunk recurrence: the state before each chunk
    s = (torch.zeros((Bb, H, N, P), dtype=x.dtype, device=x.device)
         if init_state is None else init_state)
    states = []
    for c in range(nc):
        states.append(s)
        s = chunk_decay[:, c, :, None, None] * s + Sc[:, c]
    states = torch.stack(states, dim=1)                  # (B,nc,H,N,P)

    # y_inter[t] = C_t . (exp(cum_t) * S_chunk_in)
    y_inter = torch.exp(cum)[..., None] * torch.matmul(
        Cc[:, :, None], states)                          # (B,nc,H,L,P)
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(Bb, S, H, P)
    return y, s


def apply_mamba2(p: Mamba2, cfg: ModelConfig, xin: torch.Tensor, *,
                 cache: Optional[Params] = None
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One Mamba2 mixer: xin (B, S, D) -> (out (B, S, D), new cache).

    Without a cache, the chunked scan over the whole sequence (chunk
    ``min(ssm_chunk, S)``).  With one, {"conv" (B, W-1, CH), "state"
    (B, H, N, P)} in the compute dtype, one decode step (S must be 1):
    s' = exp(dt A) s + dt B x^T and y = C . s', in fp32; the new conv
    window and s' (rounded to the compute dtype, as the reference stores
    it) are written into the cache's tensors in place and returned.
    """
    dtype = cdtype(cfg)
    B, S, _ = xin.shape
    di, N, H, P = (cfg.d_inner_ssm, cfg.ssm_state, cfg.ssm_heads,
                   cfg.ssm_head_dim)
    if cache is not None and S != 1:
        raise ValueError(f"Mamba2 decode takes one position a step, got {S}")

    zxbcdt = torch.matmul(xin, p.ssm_in.w.to(dtype))
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * G * N]
    dt = softplus(zxbcdt[..., -H:].to(torch.float32)
                  + p.dt_bias.to(torch.float32))
    A = -torch.exp(p.A_log.to(torch.float32))

    prev = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p.conv_w.to(dtype), p.conv_b.to(dtype),
                                 prev)
    x = xbc[..., :di].reshape(B, S, H, P)
    Bm = xbc[..., di: di + G * N].to(torch.float32)
    Cm = xbc[..., di + G * N:].to(torch.float32)
    xf = x.to(torch.float32)

    if cache is None:
        y, _ = _ssd_chunked(xf, dt, A, Bm, Cm, min(cfg.ssm_chunk, S))
        new_cache = None
    else:
        s = cache["state"].to(torch.float32)             # (B,H,N,P)
        da = torch.exp(dt[:, 0, :] * A[None, :])         # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhnp", dt[:, 0, :], Bm[:, 0], xf[:, 0])
        s = da[:, :, None, None] * s + upd
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0], s)[:, None]
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(s)
        new_cache = {"conv": cache["conv"], "state": cache["state"]}

    y = y + p.ssm_D.to(torch.float32)[None, None, :, None] * xf
    y = y.reshape(B, S, di).to(dtype)
    y = rms_norm(p.gate_norm, y * F.silu(z), cfg.norm_eps)
    return torch.matmul(y, p.ssm_out.w.to(dtype)), new_cache


def init_mamba2_cache(cfg: ModelConfig, batch: int, device=None) -> Params:
    """Zeroed {"conv" (B, W-1, di + 2N), "state" (B, H, N, P)} in the
    compute dtype."""
    kw = dict(dtype=cdtype(cfg), device=device)
    conv_ch = cfg.d_inner_ssm + 2 * G * cfg.ssm_state
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch), **kw),
            "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                                  cfg.ssm_head_dim), **kw)}
