"""Device encode ops: RGB->YCbCr, subsampling, forward DCT + quantize.

The reference's encode path is a non-functional stub (its fast_2ddct
overwrites its own results, /root/reference/src/dct.c:48-50; the driver does
not compile, jpeg_encoder.c:35-46) — it contributes intent only
(color-convert -> level-shift -> FDCT -> quantize -> zigzag, encode.c:12-74).
This module implements that intent as array programs:

  * the 2-D FDCT of every block at once as [N, 64] @ [64, 64] float32
    matmuls at Precision.HIGHEST (no TF32), with quantization folded into a
    per-table constant matrix;
  * BT.601 forward color transform and box-filter chroma subsampling as
    fused elementwise/reduction programs;
  * all functions shape-polymorphic over the batch dimension, jit-friendly.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import ZIGZAG

F32 = jnp.float32


@functools.lru_cache(maxsize=None)
def dct8_matrix() -> np.ndarray:
    """(8, 8) orthonormal DCT-II basis: row u = c(u)/2 * cos((2x+1)u pi/16)."""
    u = np.arange(8)
    m = 0.5 * np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float64)


@functools.lru_cache(maxsize=None)
def fdct_matrix_zz() -> np.ndarray:
    """[64, 64] float32 K with: coeffs_zigzag = pixels_raster @ K.

    Column z is the zigzag-z DCT coefficient's weight vector; the transpose
    pairing of ops/idct.idct_matrix_zz. Built from the exact separable
    basis: F[u,v] = sum_{x,y} p[x,y] C[u,x] C[v,y].
    """
    c = dct8_matrix()
    k = np.einsum("ux,vy->uvxy", c, c).reshape(64, 64)  # [uv, xy]
    return k[ZIGZAG, :].T.astype(np.float32).copy()  # [xy, zz]


def fdct_quantize(blocks, qtable_natural):
    """[N, 64] raster uint8/f32 pixel blocks -> [N, 64] int32 zigzag
    quantized coefficients.

    Level shift (-128, spec A.3.1), FDCT as one matmul, then quantize
    with round-half-away-from-zero (libjpeg's DESCALE convention).
    """
    qt = np.asarray(qtable_natural, dtype=np.float32)[ZIGZAG]  # zigzag order
    k = jnp.asarray(fdct_matrix_zz() / qt[None, :])
    x = blocks.astype(F32) - F32(128.0)
    f = jnp.dot(x, k, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=F32)
    return (jnp.sign(f) * jnp.floor(jnp.abs(f) + F32(0.5))).astype(jnp.int32)


def plane_to_blocks(plane, blocks_y: int, blocks_x: int):
    """[by*8, bx*8] plane -> [by*bx, 64] raster-order blocks (inverse of
    ops/idct.blocks_to_plane)."""
    return (
        plane.reshape(blocks_y, 8, blocks_x, 8)
        .transpose(0, 2, 1, 3)
        .reshape(blocks_y * blocks_x, 64)
    )


# BT.601 forward constants (inverse of colour_conversion.c:71-74's inverse
# transform; spec-standard luma/chroma weights).
_KR, _KG, _KB = 0.299, 0.587, 0.114


def rgb_to_ycbcr(rgb):
    """[H, W, 3] uint8 -> three [H, W] f32 planes (Y, Cb, Cr), range [0,255].

    Values stay float until after subsampling so the box filter averages
    unquantized chroma (matches libjpeg's ordering)."""
    r = rgb[..., 0].astype(F32)
    g = rgb[..., 1].astype(F32)
    b = rgb[..., 2].astype(F32)
    y = F32(_KR) * r + F32(_KG) * g + F32(_KB) * b
    cb = (b - y) * F32(0.5 / (1.0 - _KB)) + F32(128.0)
    cr = (r - y) * F32(0.5 / (1.0 - _KR)) + F32(128.0)
    return y, cb, cr


def box_subsample(plane, fh: int, fv: int):
    """Average fh x fv pixel boxes (chroma downsample). Input [H, W] f32 with
    H % fv == W % fh == 0 (caller pads first)."""
    if fh == 1 and fv == 1:
        return plane
    h, w = plane.shape
    return plane.reshape(h // fv, fv, w // fh, fh).mean(axis=(1, 3))


def pad_edge(plane, out_h: int, out_w: int):
    """Edge-replicate pad to [out_h, out_w] (libjpeg-style MCU padding —
    avoids ringing at the right/bottom borders)."""
    h, w = plane.shape
    return jnp.pad(plane, ((0, out_h - h), (0, out_w - w)), mode="edge")
