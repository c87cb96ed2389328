"""JAX-compatible counter-based random numbers in PyTorch.

The JAX package draws every random number through ``jax.random`` with
the threefry2x32 generator, and its golden chains were pinned with the
NON-partitionable key layout (``jax_threefry_partitionable=False``).
This module reproduces that stream, so a chain of the port can be held
against a chain of the reference one draw at a time:

* keys are explicit ``(..., 2)`` pairs of uint32 values held in int64
  tensors (every result is masked with ``& 0xFFFFFFFF``); there is no
  global generator state;
* ``PRNGKey``, ``split``, ``fold_in`` and the raw bits are bitwise
  equal to ``jax.random``, and so is ``uniform``;
* ``normal`` is ``sqrt(2) * erf_inv(u)`` with XLA's single-precision
  ``erf_inv`` polynomial, and ``gamma`` is JAX's Marsaglia-Tsang
  sampler; both may differ from JAX by a few ulps because ``log``,
  ``log1p``, ``sqrt`` and ``pow`` differ between XLA and torch.

Every function accepts a batch of keys: the leading dimensions of the
key broadcast over the draw, which is how the per-row draws of
``core.gibbs.row_normals`` run as one tensor program.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2 = float(np.float32(np.sqrt(2)))
# the lower end of normal()'s uniform: nextafter(-1, 0) in float32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape):
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry_2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counter pairs ``(x0, x1)`` under key
    ``(k0, k1)``; all four broadcast.  Mirrors
    ``jax._src.prng._threefry2x32_lowering`` (5 groups of 4 rounds)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu"
            ) -> torch.Tensor:
    """The raw key ``jax.random.PRNGKey(seed)``: ``(0, seed)`` as uint32."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` raw 32-bit draws per key, the non-partitionable layout.

    The counters ``0..n-1`` (padded with one 0 to even length) are cut
    into two halves that form the hash's pairs; the two hash outputs are
    concatenated and the padding dropped, as
    ``jax._src.prng.threefry_2x32`` does.  ``key`` (..., 2) -> (..., n).
    """
    m = n + (n % 2)
    counts = torch.zeros(m, dtype=torch.int64, device=key.device)
    counts[:n] = torch.arange(n, dtype=torch.int64, device=key.device)
    k0, k1 = key[..., 0:1], key[..., 1:2]
    h0, h1 = threefry_2x32(k0, k1, counts[: m // 2], counts[m // 2:])
    return torch.cat([h0, h1], dim=-1)[..., :n]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    bits = random_bits(key, 2 * num)
    return bits.reshape(tuple(key.shape[:-1]) + (num, 2))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` may be a tensor of counters,
    giving one key per element: (2,) x data.shape -> (*data.shape, 2)."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & _M32
    h0, h1 = threefry_2x32(key[..., 0], key[..., 1],
                           torch.zeros_like(data), data)
    return torch.stack([h0, h1], dim=-1)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from the top 23 bits, as ``jax.random._uniform``."""
    one = (bits >> 9) | 0x3F800000
    return one.to(torch.int32).view(torch.float32) - 1.0


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as XLA contracts it.

    The float32 product is exact in float64, so only the sum rounds
    twice, which changes the float32 result with odds of about 2**-29.
    """
    return (a.double() * b + c).float()


def uniform(key: torch.Tensor, shape: Shape = (), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32; bitwise equal to JAX."""
    shape = _shape(shape)
    n = math.prod(shape)
    bits = random_bits(key, n).reshape(tuple(key.shape[:-1]) + shape)
    lo = np.float32(minval)
    scale = float(np.float32(maxval) - lo)
    out = _fma(_bits_to_unit(bits), scale, float(lo))
    return torch.clamp_min(out, float(lo))


# XLA's ErfInv32 (M. Giles, "Approximating the erfinv function")
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Single-precision inverse error function, XLA's polynomial."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, float(np.float32(_ERFINV_LT5[i])),
                           float(np.float32(_ERFINV_GE5[i])))

    p = coef(0).float()
    w64 = w.double()
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w64, coef(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32 (``_normal_real``)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erf_inv(u)


def _gamma_one(key: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Marsaglia-Tsang, one draw per (key, alpha) pair, vectorized.

    ``jax._src.random._gamma_one`` is two nested while loops per
    element; here every element runs the same loops under a mask of
    the elements still iterating, which yields each element's own
    sequence of draws.  key (N, 2), alpha (N,) -> (N,).
    """
    f32 = torch.float32
    one_third = float(np.float32(1.0 / 3.0))
    boost_mask = alpha >= 1.0
    alpha_orig = alpha
    alpha = torch.where(boost_mask, alpha, alpha + 1.0)
    d = alpha - one_third
    c = one_third / torch.sqrt(d)

    ks = split(key)
    key, subkey = ks[:, 0], ks[:, 1]
    X = torch.zeros_like(alpha)
    V = torch.ones_like(alpha)
    U = torch.full_like(alpha, 2.0)

    def accepted(X, V, U):
        return ((U < 1.0 - 0.0331 * (X * X))
                | (torch.log(U) < X * 0.5 + d * ((1.0 - V) + torch.log(V))))

    active = ~accepted(X, V, U)
    while bool(active.any()):
        ks = split(key, 3)
        key_n, x_key, u_key = ks[:, 0], ks[:, 1], ks[:, 2]
        # inner loop: x ~ N(0, 1) until v = 1 + c x > 0
        k, x = x_key, torch.zeros_like(alpha)
        v = torch.full_like(alpha, -1.0)
        inner = v <= 0.0
        while bool((inner & active).any()):
            kk = split(k)
            x_new = normal(kk[:, 1])
            v_new = 1.0 + x_new * c
            k = torch.where(inner[:, None], kk[:, 0], k)
            x = torch.where(inner, x_new, x)
            v = torch.where(inner, v_new, v)
            inner = v <= 0.0
        U_new = uniform(u_key)
        key = torch.where(active[:, None], key_n, key)
        X = torch.where(active, x * x, X)
        V = torch.where(active, (v * v) * v, V)
        U = torch.where(active, U_new, U)
        active = active & ~accepted(X, V, U)

    samples = 1.0 - uniform(subkey)
    boost = torch.where(boost_mask, torch.ones((), dtype=f32,
                                               device=alpha.device),
                        torch.pow(samples, 1.0 / alpha_orig))
    return (d * V) * boost


def gamma(key: torch.Tensor, a) -> torch.Tensor:
    """``jax.random.gamma(key, a)`` for a float32 tensor ``a``: one
    split key per element (``_gamma_impl``), then Marsaglia-Tsang."""
    a = torch.as_tensor(a, dtype=torch.float32, device=key.device)
    shape = a.shape
    n = max(1, a.numel())
    keys = split(key, n)
    out = _gamma_one(keys, a.reshape(-1))
    return out.reshape(shape)


_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, its default ``mode="low"``:
    -log(-log(u)) with u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32
    logits: the Gumbel-max trick, argmax(gumbel + logits) over the last
    axis, first index on ties."""
    g = gumbel(key, tuple(logits.shape)).to(logits.device)
    return torch.argmax(g + logits, dim=-1)
