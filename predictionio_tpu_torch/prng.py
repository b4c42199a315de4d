"""The reference's seeded randomness, reproduced in numpy.

The JAX package draws every seeded initial value through ``jax.random``
(threefry-2x32 keys): ALS's initial factors, seqrec's flax init and its
epoch shuffles. Threefry is a pure counter-based hash, so the port draws
the same numbers from the same seed without jax: this module computes
``PRNGKey``, ``split``, ``fold_in``, ``random_bits``, ``uniform``,
``normal``, ``truncated_normal`` and ``permutation`` as jax computes them
with ``jax_threefry_partitionable`` on (its default): counters are the
flat iota split into high and low words, and 32-bit draws are the xor of
the two output words. Keys are ``uint32[..., 2]`` arrays, as jax's raw
keys are.

Bits, keys, permutations and the float32 draws are bitwise equal to
jax's on the CPU: the float32 transforms are XLA's own (its CPU ``log``
and ``log1p`` polynomials, Giles' ``erf_inv``, and the multiply-adds XLA
contracts, emulated by rounding a float64 product-sum once). ``erf``, used
only for ``truncated_normal``'s bounds, is XLA's older rational form: it
gives jax's values at ±√2, the bounds of flax's truncated-normal
initializers, and may round otherwise than jax elsewhere.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence

import numpy as np

__all__ = [
    "PRNGKey", "split", "fold_in", "fold_in_static", "random_bits",
    "uniform", "normal", "truncated_normal", "permutation", "threefry2x32",
]

_U32 = np.uint32
_MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (jax's ``threefry2x32_p``): the two
    counter words ``x0, x1`` hashed under ``key = (k0, k1)``."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, _U32(k0 ^ k1 ^ _U32(0x1BD11BDA)))
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def _as_key(key) -> np.ndarray:
    key = np.asarray(key, _U32)
    if key.shape != (2,):
        raise ValueError(f"a raw threefry key has shape (2,), got {key.shape}")
    return key


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a raw ``uint32[2]`` key: the seed's
    high and low 32-bit words (a 32-bit seed, as jax takes it without x64,
    has a zero high word)."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 32:
        raise OverflowError(f"seed {seed} does not fit 32 bits")
    return np.array([0, seed & _MASK32], _U32)


#: draws are computed this many elements at a time, so every temporary of
#: the float32 transforms stays in cache (the result does not depend on it)
_CHUNK = 1 << 16


def _iota_2x32(start: int, stop: int) -> tuple[np.ndarray, np.ndarray]:
    """The flat counters ``start..stop-1`` as (high, low) 32-bit words."""
    flat = np.arange(start, stop, dtype=np.uint64)
    return ((flat >> np.uint64(32)).astype(_U32),
            (flat & np.uint64(_MASK32)).astype(_U32))


def _draw(key, shape: Sequence[int], transform) -> np.ndarray:
    """``transform`` of jax's partitionable 32-bit draws over ``shape``,
    evaluated chunk by chunk of the flat counter."""
    key = _as_key(key)
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    out = None
    for start in range(0, n, _CHUNK):
        b0, b1 = threefry2x32(key, *_iota_2x32(start, min(n, start + _CHUNK)))
        part = transform(b0 ^ b1)
        if out is None:
            out = np.empty(n, part.dtype)
        out[start:start + len(part)] = part
    if out is None:
        out = transform(np.zeros(0, _U32))
    return out.reshape(shape)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``uint32[num, 2]``."""
    b0, b1 = threefry2x32(_as_key(key), *_iota_2x32(0, num))
    return np.stack([b0, b1], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    b0, b1 = threefry2x32(_as_key(key), np.zeros(1, _U32),
                          np.array([int(data) & _MASK32], _U32))
    return np.array([b0[0], b1[0]], _U32)


def fold_in_static(key, data: Sequence[str | int]) -> np.ndarray:
    """flax's ``_fold_in_static`` (``flax_fix_rng_separator`` off): the
    first four bytes of a SHA-1 over the path's names and counters, folded
    in. An empty path leaves the key as it is."""
    if not data:
        return _as_key(key)
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"Expected int or string, got: {x}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def random_bits(key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    return _draw(key, shape, lambda bits: bits)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as XLA's CPU code contracts it
    (the float64 product of two float32 values is exact)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _uniform(bits: np.ndarray, minval, maxval) -> np.ndarray:
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32)
    floats = floats - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def uniform(key, shape: Sequence[int], minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    exponent 0, minus one, scaled (one fused multiply-add), and clamped
    below at ``minval``."""
    return _draw(key, shape, lambda bits: _uniform(bits, minval, maxval))


# XLA CPU's float32 log: the Cephes polynomial on the mantissa
_LOG_P = tuple(np.float32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))


def _log(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float32)
    f32 = np.float32
    x = np.maximum(np.finfo(np.float32).tiny, v)
    bits = x.view(_U32)
    e = f32(1) + ((bits >> _U32(23)).astype(np.int32) - 0x7F).astype(f32)
    x = ((bits & _U32(0x807FFFFF)) | f32(0.5).view(_U32)).view(f32)
    small = x < f32(0.707106781186547524)
    x = (x - f32(1)) + np.where(small, x, f32(0))
    e = e - np.where(small, f32(1), f32(0))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y, y1, y2 = _fma(x, p[0], p[1]), _fma(x, p[3], p[4]), _fma(x, p[6], p[7])
    y, y1, y2 = _fma(y, x, p[2]), _fma(y1, x, p[5]), _fma(y2, x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, f32(-2.12194440e-4) * e)
    out = (x - f32(0.5) * x2 + y) + f32(0.693359375) * e
    out = np.where(v == 0, f32(-np.inf), out)
    out = np.where(v == np.inf, f32(np.inf), out)
    return np.where(~(v > 0), f32(np.nan), out).astype(f32)


# XLA's float32 log1p: a Cephes rational approximation below sqrt(2) - 1
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1., 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    out = np.empty_like(x)
    small = np.abs(x) < np.float32(0.41421356237309504880)
    xs = x[small]

    def poly(c):
        p = np.zeros_like(xs)
        for a in c:
            p = _fma(p, xs, np.float32(a))
        return p

    x2 = xs * xs
    with np.errstate(divide="ignore", invalid="ignore"):
        out[small] = xs + (np.float32(-0.5) * x2
                           + (xs * x2) * (poly(_LOG1P_NUM)
                                          / poly(_LOG1P_DEN)))
        out[~small] = _log(np.float32(1) + x[~small])
    return out


# XLA's float32 erf_inv (Giles' single-precision approximation)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``, evaluated in float32."""
    x = np.asarray(x, np.float32)
    p = np.empty_like(x)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -_log1p(-x * x)
        lt = w < np.float32(5.0)
        for sel, coef, shifted in (
                (lt, _ERFINV_LT5, lambda w: w - np.float32(2.5)),
                (~lt, _ERFINV_GE5, lambda w: np.sqrt(w) - np.float32(3.0))):
            ws = shifted(w[sel])
            ps = np.full_like(ws, np.float32(coef[0]))
            for a in coef[1:]:
                ps = _fma(ps, ws, np.float32(a))
            p[sel] = ps
        out = p * x
    return np.where(np.abs(x) == np.float32(1.0),
                    x * np.finfo(np.float32).max, out).astype(np.float32)


# XLA's older float32 erf: x * P(x^2) / Q(x^2) on x clamped to [-4, 4]
_ERF_ALPHA = (-2.72614225801306e-10, 2.77068142495902e-08,
              -2.10102402082508e-06, -5.69250639462346e-05,
              -7.34990630326855e-04, -2.95459980854025e-03,
              -1.60960333262415e-02)
_ERF_BETA = (-1.45660718464996e-05, -2.13374055278905e-04,
             -1.68282697438203e-03, -7.37332916720468e-03,
             -1.42647390514189e-02)


def erf(x) -> np.ndarray:
    """XLA's older float32 ``erf``, evaluated in float32 (equal to jax's
    at ±√2; see the module's docstring)."""
    x = np.clip(np.asarray(x, np.float32), np.float32(-4.0), np.float32(4.0))
    x2 = x * x

    def poly(c):
        p = np.float32(c[0])
        for a in c[1:]:
            p = p * x2 + np.float32(a)
        return p

    return (x * poly(_ERF_ALPHA) / poly(_ERF_BETA)).astype(np.float32)


def normal(key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` with
    ``u`` uniform on ``[nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    sqrt2 = np.float32(np.sqrt(2))
    return _draw(key, shape, lambda bits: sqrt2 * erf_inv(
        _uniform(bits, lo, np.float32(1.0))))


def truncated_normal(key, lower: float, upper: float,
                     shape: Sequence[int]) -> np.ndarray:
    """``jax.random.truncated_normal`` in float32: the inverse CDF of a
    uniform draw between ``erf(lower/√2)`` and ``erf(upper/√2)``, clamped
    to the open interval ``(lower, upper)``."""
    sqrt2 = np.float32(np.sqrt(2))
    lower, upper = np.float32(lower), np.float32(upper)
    a, b = erf(lower / sqrt2), erf(upper / sqrt2)
    lo = np.nextafter(lower, np.float32(np.inf))
    hi = np.nextafter(upper, np.float32(-np.inf))
    return _draw(key, shape, lambda bits: np.clip(
        sqrt2 * erf_inv(_uniform(bits, a, b)), lo, hi))


def permutation(key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: jax's sort-based shuffle of
    ``arange(n)``, ``ceil(3 ln n / ln(2**32 - 1))`` rounds of a split and
    a sort by fresh 32-bit keys. XLA's CPU sort of key-value pairs is
    stable, so equal keys keep their current order, as a stable argsort
    keeps them."""
    key = _as_key(key)
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2 ** 32 - 1)))
    for _ in range(rounds):
        key, sub = split(key)
        sort_keys = random_bits(sub, (n,))
        x = x[np.argsort(sort_keys, kind="stable")]
    return x
