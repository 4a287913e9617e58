"""Device color pipeline: chroma upsample + color transform + RGB pack.

Replaces the reference's per-pixel host loops (`y_rgb` / `ycbcr_rgb` /
`yccb_rgb`, `/root/reference/src/colour_conversion.c:5-162`) with fused
array programs: a static-index gather for the nearest-neighbor chroma
upsample (the reference's float32-ratio index rule, colour_conversion.c:62-69)
followed by the BT.601 / YCCK arithmetic, fused elementwise.

Numeric contracts mirror ops/idct.py:
  * exact=True  — each C statement "f64 expression stored to f32"
                  (colour_conversion.c:71-74, :137-141) evaluated in native
                  float64 (ops/f64.py), then the compiled binary's
                  store behavior: truncate toward zero, saturate to [0,255]
                  (see core/numerics._store_rgb_reference for why saturation,
                  not the source's clamp-to-256 wrap, is the parity target).
  * exact=False — plain float32; +/-1 LSB.

Upsample index arrays are computed in NumPy at trace time (shapes are
static under jit), so on device the upsample is a pure gather — XLA fuses it
into the elementwise conversion. The "fancy" (libjpeg-style triangular)
upsampler needs a 1-row halo in stripe-parallel mode (SURVEY.md §2);
nearest-neighbor needs none.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.numerics import _nn_index_f32
from ..utils.config import Quirks
from . import f64

F32 = jnp.float32

# BT.601 constants exactly as spelled in the reference
# (colour_conversion.c:71-74).
_K_RV = 1.402
_K_GU = 0.34414
_K_GV = 0.71414
_K_BU = 1.772


def nn_upsample(plane, out_h: int, out_w: int, hsf: int, vsf: int,
                max_hsf: int, max_vsf: int):
    """Nearest-neighbor upsample of one component plane to [out_h, out_w]
    with the reference's (uint32)(i * float32(sf/max_sf)) index rule."""
    rows = _nn_index_f32(out_h, np.float32(vsf) / np.float32(max_vsf))
    cols = _nn_index_f32(out_w, np.float32(hsf) / np.float32(max_hsf))
    return plane[jnp.asarray(rows)[:, None], jnp.asarray(cols)[None, :]]


def fancy_h2x(xf):
    """Horizontal 2x triangular upsample (libjpeg h2v1 convention: the
    nearer-left phase gets the +1 rounding, nearer-right +2). f32 in/out;
    shared with the striped path (parallel/stripes.py)."""
    left = jnp.roll(xf, 1, axis=1).at[:, 0].set(xf[:, 0])
    right = jnp.roll(xf, -1, axis=1).at[:, -1].set(xf[:, -1])
    even = (3.0 * xf + left + 1.0) * 0.25
    odd = (3.0 * xf + right + 2.0) * 0.25
    return jnp.stack([even, odd], axis=2).reshape(xf.shape[0], -1)


def fancy_v2x(xf):
    """Vertical 2x triangular upsample (same rounding convention)."""
    up = jnp.roll(xf, 1, axis=0).at[0].set(xf[0])
    down = jnp.roll(xf, -1, axis=0).at[-1].set(xf[-1])
    even = (3.0 * xf + up + 1.0) * 0.25
    odd = (3.0 * xf + down + 2.0) * 0.25
    return jnp.stack([even, odd], axis=1).reshape(-1, xf.shape[1])


def fancy_upsample(plane, out_h: int, out_w: int, hsf: int, vsf: int,
                   max_hsf: int, max_vsf: int):
    """libjpeg-style triangular (centered 3:1/1:3) upsample for 2x factors;
    falls back to NN for other ratios. Higher quality than the reference's
    NN rule (config.upsample == "fancy"); not a parity target."""
    x = plane.astype(F32)
    eh, ev = hsf, vsf
    if 2 * hsf == max_hsf:
        x = fancy_h2x(x)
        eh = 2 * hsf
    if 2 * vsf == max_vsf:
        x = fancy_v2x(x)
        ev = 2 * vsf
    # The compounding +1/+2 rounding biases of the two passes can reach
    # exactly 256.0 in an all-255 neighborhood (3*255.5 + 255.5 + 2)/4;
    # libjpeg's integer form maxes at 255, so clamp explicitly rather than
    # relying on XLA's saturating cast (NumPy's would wrap to 0).
    x = jnp.clip(jnp.floor(x), 0.0, 255.0).astype(jnp.uint8)
    if eh == max_hsf and ev == max_vsf:
        return x[:out_h, :out_w]  # full-res after upsampling: plain crop
    # Non-2x ratios remain: NN the rest of the way.
    return nn_upsample(x, out_h, out_w, eh, ev, max_hsf, max_vsf)


def _store_rgb(r, g, b, quirks: Quirks):
    """Float channels -> uint8 RGB, matching the compiled reference
    (truncate, saturate) or the spec-sane rounding store."""
    chans = []
    for ch in (r, g, b):
        if quirks == Quirks.REFERENCE:
            q = jnp.trunc(ch)
        else:
            q = jnp.floor(ch + F32(0.5))
        chans.append(jnp.clip(q, 0.0, 255.0).astype(jnp.uint8))
    return jnp.stack(chans, axis=-1)


def _ycbcr_channels_f32(y8, cb8, cr8):
    y = y8.astype(F32)
    cb = cb8.astype(F32) - F32(128.0)
    cr = cr8.astype(F32) - F32(128.0)
    r = y + F32(_K_RV) * cr
    g = y - F32(_K_GU) * cb - F32(_K_GV) * cr
    b = y + F32(_K_BU) * cb
    return r, g, b


def ycbcr_to_rgb(y8, cb8, cr8, exact: bool = True,
                 quirks: Quirks = Quirks.REFERENCE):
    """[H, W] uint8 Y/Cb/Cr (already upsampled) -> [H, W, 3] uint8 RGB
    (ycbcr_rgb, colour_conversion.c:30-83).

    BOTH numeric contracts use the plain float32 channels. This is not an
    approximation: the conversion's inputs are bytes, so every channel has a
    finite input domain — R and B 65536 (y, cr)/(y, cb) pairs, G 16.7M
    (y, cb, cr) triples — and the plain-f32 arithmetic was verified
    EXHAUSTIVELY (tests/test_color_exhaustive.py) to produce the same final
    uint8 as the reference's f64-compute/f32-store chain
    (colour_conversion.c:71-74 modeled by core/numerics.ycbcr_to_rgb_exact)
    for every possible input, under BOTH store quirks (truncate and
    round-half-up) and under EVERY FMA-contraction choice the compiler could
    make for the two G products. The f32 bit patterns differ on ~9% of
    inputs (1 ulp), but no differing pair ever straddles a trunc/round
    boundary — the bytes agree everywhere, so the cheap path IS the exact
    path. (The YCCK composite below keeps the float64 statements, since
    its intermediate f32 values feed further arithmetic.)
    """
    del exact  # proven byte-identical on the full input domain
    return _store_rgb(*_ycbcr_channels_f32(y8, cb8, cr8), quirks)


def gray_to_rgb(y8):
    """[H, W] uint8 -> [H, W, 3] replicate (y_rgb, colour_conversion.c:5-28)."""
    return jnp.repeat(y8[..., None], 3, axis=-1)


def cmyk_to_rgb(c8, m8, y8, k8):
    """Raw Adobe CMYK (APP14 transform=0; stored inverted): the naive
    multiplicative composite R = round(s_c * s_k / 255), as integer math
    ((x + 127) // 255) — byte-identical to libjpeg+Pillow over the full
    (C,K) domain and to core.numerics.cmyk_channels_to_rgb (the host
    mirror). Integer-exact on every backend: no FMA/rounding hazards."""
    k = k8.astype(jnp.int32)
    chans = [
        (((ch.astype(jnp.int32) * k + 127) // 255)).astype(jnp.uint8)
        for ch in (c8, m8, y8)
    ]
    return jnp.stack(chans, axis=-1)


def ycck_to_rgb(y8, cb8, cr8, k8, exact: bool = True,
                quirks: Quirks = Quirks.REFERENCE):
    """4-component YCCK composite (yccb_rgb, colour_conversion.c:85-162):
    YCbCr -> C/M/Y (f32 store), then 255 * (1 - X/255) * (K/255)."""
    if not exact:
        c_, m_, ylw = _ycbcr_channels_f32(y8, cb8, cr8)
        k = k8.astype(F32)
        r = F32(255.0) * (1.0 - c_ / 255.0) * (k / 255.0)
        g = F32(255.0) * (1.0 - m_ / 255.0) * (k / 255.0)
        b = F32(255.0) * (1.0 - ylw / 255.0) * (k / 255.0)
        return _store_rgb(r, g, b, quirks)
    st = f64.store
    with f64.x64():
        # Every statement as core/numerics.ycck_channels_to_rgb spells it:
        # f64 compute, one f32 store (reduce_precision: the chain goes on
        # in f64, see ops/f64.py).
        y = y8.astype(f64.F64)
        cb = cb8.astype(f64.F64) - 128.0
        cr = cr8.astype(f64.F64) - 128.0
        k = k8.astype(f64.F64)
        cmy = (
            st(y + f64.mul_const(cr, _K_RV)),
            st(y - f64.mul_const(cb, _K_GU) - f64.mul_const(cr, _K_GV)),
            st(y + f64.mul_const(cb, _K_BU)),
        )
        r, g, b = (
            st(255.0 * (1.0 - ch / 255.0) * (k / 255.0)).astype(F32)
            for ch in cmy
        )
    return _store_rgb(r, g, b, quirks)
