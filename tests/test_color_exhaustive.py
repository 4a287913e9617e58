"""Exhaustive byte-level proof behind ops/color.ycbcr_to_rgb's fast path.

The device EXACT contract promises final RGB bytes identical to the
reference's `ycbcr_rgb` (/root/reference/src/colour_conversion.c:30-83),
whose model is: compute each channel as an f64 expression of the byte
inputs, store to f32, then truncate/saturate to uint8
(core/numerics.ycbcr_to_rgb_exact + _store_rgb_reference).

Because every channel is a function of byte inputs, its input domain is
FINITE: R depends on (y, cr) and B on (y, cb) — 65536 pairs each — and G on
(y, cb, cr) — 16.7M triples. These tests enumerate the ENTIRE domain and
check that the plain float32 arithmetic the device uses produces the same
final uint8 as the f64 model for every input, under

  * both store quirks (REFERENCE truncate, CORRECT round-half-up), and
  * every FMA-contraction choice XLA could make on a device (a contracted
    a*b+c rounds once; simulated exactly in f64, since the product of an
    f32 constant and a byte-valued f32 fits f64's 53-bit mantissa).

A pass is a proof, not a sample: there are no other inputs. The f32 bit
patterns DO differ from the f64-store model on ~9% of inputs (1 ulp), but
never across a truncation/rounding boundary.
"""

from __future__ import annotations

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # quick tier: pytest -m 'not slow'

F32, F64 = np.float32, np.float64

# The reference's constants (colour_conversion.c:71-74).
KRV, KGU, KGV, KBU = 1.402, 0.34414, 0.71414, 1.772


def _stores(x32: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(REFERENCE trunc+saturate, CORRECT round-half-up) uint8 stores."""
    t = np.clip(np.trunc(x32), 0, 255).astype(np.uint8)
    r = np.clip(np.floor(x32 + F32(0.5)), 0, 255).astype(np.uint8)
    return t, r


def _assert_bytes_equal(model32: np.ndarray, got32: np.ndarray, what: str):
    mt, mr = _stores(model32)
    gt, gr = _stores(got32)
    assert np.array_equal(mt, gt), f"{what}: trunc-store byte mismatch"
    assert np.array_equal(mr, gr), f"{what}: round-store byte mismatch"


@pytest.mark.parametrize("const", [KRV, KBU], ids=["R_1.402", "B_1.772"])
def test_rb_channels_all_inputs(const):
    """R = y + 1.402*cr and B = y + 1.772*cb over all 65536 byte pairs,
    plain f32 and the FMA-contracted form."""
    y = np.arange(256, dtype=F64)
    x = np.arange(256, dtype=F64) - 128.0
    Y, X = np.meshgrid(y, x, indexing="ij")
    model = (Y + const * X).astype(F32)

    plain = Y.astype(F32) + F32(const) * X.astype(F32)
    _assert_bytes_equal(model, plain, "plain f32")

    # fma(c, x, y): exact product in f64, one rounding to f32.
    fused = (Y + F64(F32(const)) * X).astype(F32)
    _assert_bytes_equal(model, fused, "fma-contracted")


def test_g_channel_all_inputs():
    """G = (y - 0.34414*cb) - 0.71414*cr over ALL 16.7M byte triples, for
    every combination of contracted/uncontracted products."""
    y = np.arange(256, dtype=F64)[:, None, None]
    cb = (np.arange(256, dtype=F64) - 128.0)[None, :, None]
    cr = (np.arange(256, dtype=F64) - 128.0)[None, None, :]
    model = ((y - KGU * cb) - KGV * cr).astype(F32)

    yf = y.astype(F32)
    cbf, crf = cb.astype(F32), cr.astype(F32)
    t1_variants = {
        "mul": yf - F32(KGU) * cbf,                       # round twice
        "fma": (y - F64(F32(KGU)) * cb).astype(F32),      # round once
    }
    for name1, t1 in t1_variants.items():
        g_mul = t1 - F32(KGV) * crf
        g_fma = (t1.astype(F64) - F64(F32(KGV)) * cr).astype(F32)
        _assert_bytes_equal(model, g_mul, f"t1={name1}, g=mul")
        _assert_bytes_equal(model, g_fma, f"t1={name1}, g=fma")


def test_device_color_matches_oracle_on_full_byte_grid():
    """End-to-end: ops/color.ycbcr_to_rgb (the jnp path, on CPU here) vs the
    numerics oracle over a (y, cb, cr) grid covering all byte values in each
    coordinate pair (full 3-D enumeration is the numpy tests above; this
    ties the jnp implementation itself to the oracle)."""
    import jax.numpy as jnp

    from jpeg_decoder_tpu.core import numerics
    from jpeg_decoder_tpu.ops import color as color_ops
    from jpeg_decoder_tpu.utils.config import Quirks

    rng = np.random.default_rng(7)
    # All 65536 (y, cr) pairs with random cb, plus all (cb, cr) with random y.
    a = np.repeat(np.arange(256, dtype=np.uint8), 256)
    b = np.tile(np.arange(256, dtype=np.uint8), 256)
    r1 = rng.integers(0, 256, a.size, dtype=np.uint8)
    y8 = np.concatenate([a, a, r1]).reshape(3, -1)
    cb8 = np.concatenate([b, r1, a]).reshape(3, -1)
    cr8 = np.concatenate([r1, b, b]).reshape(3, -1)

    for quirks in (Quirks.REFERENCE, Quirks.CORRECT):
        got = np.asarray(
            color_ops.ycbcr_to_rgb(
                jnp.asarray(y8), jnp.asarray(cb8), jnp.asarray(cr8),
                exact=True, quirks=quirks,
            )
        )
        yd = y8.astype(F64)
        cbd = cb8.astype(F64) - 128.0
        crd = cr8.astype(F64) - 128.0
        r = (yd + KRV * crd).astype(F32)
        g = ((yd - KGU * cbd) - KGV * crd).astype(F32)
        bch = (yd + KBU * cbd).astype(F32)
        if quirks == Quirks.REFERENCE:
            want = numerics._store_rgb_reference(r, g, bch)
        else:
            want = numerics._store_rgb_correct(r, g, bch)
        assert np.array_equal(got, want), f"jnp path mismatch ({quirks})"
