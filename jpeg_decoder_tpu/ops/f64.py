"""Native float64 evaluation of the reference's "f64 expression, f32 store"
statements — the EXACT numeric contract on the device.

The reference decoder keeps every intermediate in `float` but spells its
expressions with `double` literals (the reference's `dct.c:296-341`,
`colour_conversion.c:71-74`, `:137-141`; core/numerics.py is the
statement-by-statement model), so each C statement computes in float64 and
rounds once to float32. The `round_*` helpers take and return float32
arrays and evaluate one such statement in float64 in between; the C's
plain float32 operations (`a + b` of two floats) stay float32 in the
caller.

XLA may contract a multiply and a following add into one fused
multiply-add, which skips the product's rounding (the CPU backend does;
the H100 did not in PERF.md's runs). A product that feeds an add is
therefore formed by `mul_const` as the sum of two EXACT products: the
constant is split into a 29-bit head and a tail, each of whose products
with a float32 value fits float64's 53 bits, so the one add that joins
them is the product's only rounding, fused or not.

A float64 chain that must round to float32 in the middle and go on in
float64 (the YCCK composite) rounds with `store`, a reduce_precision, and
not with a convert pair: XLA may drop a float64 -> float32 -> float64
convert round trip when excess precision is allowed.

JAX canonicalises float64 to float32 unless x64 is enabled. The helpers
trace their float64 arithmetic inside `x64()`; the scope ends with the
helper (or the caller's block), so the rest of the program keeps JAX's
default dtypes.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax

F32 = jnp.float32
F64 = jnp.float64


def x64():
    """Scope in which float64 arrays stay float64 while tracing."""
    return jax.enable_x64(True)


def store(x):
    """Round float64 `x` to float32 precision, staying float64 — the C's
    store to `float` inside a float64 chain."""
    return lax.reduce_precision(x, exponent_bits=8, mantissa_bits=23)


def split_const(c: float) -> tuple[float, float]:
    """c = hi + lo exactly, hi with at most 29 significant bits and lo with
    at most 24: hi * x and lo * x are exact in float64 for float32 x."""
    m, e = math.frexp(c)
    hi = math.ldexp(math.trunc(math.ldexp(m, 29)), e - 29)
    return hi, c - hi


def mul_const(x, c: float):
    """round_f64(c * x) for float64 `x` holding a float32 value, immune to
    FMA contraction with whatever add consumes it."""
    hi, lo = split_const(c)
    return hi * x + lo * x


def dot2_const(x, cx: float, y, cy: float):
    """round_f64(round_f64(cx*x) + round_f64(cy*y)) for float64 x, y
    holding float32 values — the C's double sum."""
    return mul_const(x, cx) + mul_const(y, cy)


def round_mul_const(x, c: float):
    """round_f32(c * x) for float32 `x` — one C statement
    `float r = C * x;`. The product feeds no add, so it needs no split."""
    with x64():
        return (c * x.astype(F64)).astype(F32)


def round_dot2_const(x, cx: float, y, cy: float):
    """round_f32(cx*x + cy*y) for float32 x, y — the reference's rotator
    statements (e.g. dct.c:317-318, 327-330)."""
    with x64():
        return dot2_const(x.astype(F64), cx, y.astype(F64), cy).astype(F32)


def round_mul_dot2_const(c: float, x, cx: float, y, cy: float):
    """round_f32(c * (cx*x + cy*y)) for float32 x, y — the nested products
    at dct.c:316-319 (outer 0.707106781 * (inner dot))."""
    with x64():
        inner = dot2_const(x.astype(F64), cx, y.astype(F64), cy)
        return (c * inner).astype(F32)
