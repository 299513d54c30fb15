"""Double-float (f32x2) arithmetic: f64-accurate residuals at f32 speed.

One way to reach the reference's 1e-8 double-precision residual target
(/root/reference/src/solverpetsc.F KSP defaults) with f32 arithmetic only
is compensated f32 pairs:
a value is (hi, lo) with |lo| <= ulp(hi)/2, giving ~2^-48 relative accuracy.
Classic error-free transformations (Knuth TwoSum, Dekker/Veltkamp TwoProd —
no hardware FMA needed) cost a few flops per value, so the double-float
DIA SpMV streams the same bytes as two f32 SpMVs.

Used by solve/refine.py's iterative refinement outer loop (SURVEY §7 'Hard
parts': "f32/bf16 compute with f64 (or compensated/f32x2) accumulation").
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class DF(NamedTuple):
    """A double-float vector/scalar: value = hi + lo (both f32)."""
    hi: jnp.ndarray
    lo: jnp.ndarray


_SPLIT = np.float32(4097.0)   # Veltkamp split constant for f32 (2^12 + 1)


def _two_sum(a, b):
    """Knuth TwoSum: a + b = s + err exactly (6 flops)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Dekker FastTwoSum, requires |a| >= |b|: a + b = s + err exactly."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    """Veltkamp split: a = hi + lo with hi, lo having 12-bit mantissas."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker TwoProd: a * b = p + err exactly (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df_from_f64(x: np.ndarray) -> DF:
    """Host-side f64 -> (hi, lo) f32 pair (lossless to ~2^-48 relative)."""
    hi = np.asarray(x, dtype=np.float32)
    lo = np.asarray(x - hi.astype(np.float64), dtype=np.float32)
    return DF(jnp.asarray(hi), jnp.asarray(lo))


def df_to_f64(x: DF) -> np.ndarray:
    return (np.asarray(x.hi, dtype=np.float64)
            + np.asarray(x.lo, dtype=np.float64))


def df_add(x: DF, y: DF) -> DF:
    s, e = _two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    hi, lo = _quick_two_sum(s, e)
    return DF(hi, lo)


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def df_add_f32(x: DF, a) -> DF:
    s, e = _two_sum(x.hi, a)
    e = e + x.lo
    hi, lo = _quick_two_sum(s, e)
    return DF(hi, lo)


def df_mul_f32(x: DF, a) -> DF:
    """(hi, lo) * a with an exact TwoProd on the hi part."""
    p, e = _two_prod(x.hi, a)
    e = e + x.lo * a
    hi, lo = _quick_two_sum(p, e)
    return DF(hi, lo)


def df_fma(acc: DF, v: DF, x: DF) -> DF:
    """acc + v * x in double-float (the SpMV inner step)."""
    p, e = _two_prod(v.hi, x.hi)
    e = e + v.hi * x.lo + v.lo * x.hi
    return df_add(acc, DF(p, e))


def spmv_dia_df(offsets: Tuple[int, ...], vals: DF, x: DF) -> DF:
    """y = A x with A and x in double-float: D shifted compensated FMAs.

    Same gather-free shifted-slice structure as sparse/dia.py:spmv_dia;
    every multiply uses TwoProd and every accumulate TwoSum, so the result
    matches the f64 SpMV to ~1e-14 relative while streaming f32."""
    n = x.hi.shape[0]
    neg = max(0, -min(offsets))
    pos = max(0, max(offsets))

    def pad(v):
        return jnp.concatenate([
            jnp.zeros((neg,), dtype=v.dtype), v,
            jnp.zeros((pos,), dtype=v.dtype)])

    xp = DF(pad(x.hi), pad(x.lo))
    y = DF(jnp.zeros_like(x.hi), jnp.zeros_like(x.lo))
    for d, o in enumerate(offsets):
        xs = DF(jax.lax.slice_in_dim(xp.hi, neg + o, neg + o + n),
                jax.lax.slice_in_dim(xp.lo, neg + o, neg + o + n))
        y = df_fma(y, DF(vals.hi[d], vals.lo[d]), xs)
    return y


def df_norm2_f32(x: DF) -> jnp.ndarray:
    """||x||_2 to f32 accuracy (plenty for convergence TESTS of a 1e-8
    target — only the residual VALUE needs double-float accuracy)."""
    return jnp.sqrt(jnp.dot(x.hi, x.hi,
                            precision=jax.lax.Precision.HIGHEST)
                    + 2.0 * jnp.dot(x.hi, x.lo,
                                    precision=jax.lax.Precision.HIGHEST))
