"""Fused dequant + dezigzag + 8x8 IDCT over batches of blocks (device).

The reference runs dequant and IDCT one block at a time inside the entropy
loop (`dequant_data_unit` `/root/reference/src/quant_table.c:131-152`,
`fast_2didct` `dct.c:158-204`). Here the same math is a single array program
over ALL blocks of a component at once — the stage-parallel inversion of the
reference's per-MCU pipeline (SURVEY.md §7) — in two selectable numeric
contracts (utils/config.IdctPrecision):

  * EXACT   — replicates the C decoder's arithmetic bit-for-bit: each C
              statement's "f64 expression of f32 values, stored to f32" is
              evaluated in native float64 and rounded once to float32
              (ops/f64.py). Elementwise; no matmuls. Verified bitwise against
              core/numerics.idct_2d_exact.
  * FLOAT32 — the whole 2-D IDCT (with the AAN constants, row/col pre-scale
              and final 0.25 folded in) as ONE [N, 64] @ [64, 64] matmul in
              float32 at Precision.HIGHEST (no TF32). Within +/-1 LSB of
              EXACT on the final uint8 (float rounding only).

Both paths end with the reference's output quantization: for 8-bit,
trunc(0.25*x + 128) clamped to [0, 255] (dct.c:186-194, CLAMP macros
dct.c:6-7); for 12-bit, +2048 / CLAMP_16 / int16 wrap (dct.c:195-203) and the
12->8 rescale of write_data_unit (decode.c:520-525).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import ZIGZAG, INV_ZIGZAG
from ..utils.config import IdctPrecision
from . import f64

F32 = jnp.float32

# AAN-family constants exactly as spelled in the reference (dct.c:296-341).
_C_SQRT2 = 1.414213562
_C_ISQRT2 = 0.707106781
_C_COS6 = 0.38268343236  # cos(3π/8)
_C_SIN6 = 0.92387953251  # sin(3π/8)
_C_A = 0.8314696123
_C_B = 0.55557023302
_C_C = 0.9807852804
_C_D = 0.19509032201
_C_OUT = _C_SQRT2 * 2  # folded output scale (dct.c:333-340)


def _idct8_exact(v, axis: int):
    """One fast_idct_new pass (dct.c:296-341) along `axis` of float32 `v`
    [N, 8, 8], each statement rounded exactly as the C rounds (see
    core/numerics.py for the statement-by-statement model): products in
    float64 with one float32 store (ops/f64.py), the C's `float OP float`
    in float32, and `* 0.5` of a float32 value, which is exact.

    Passing the axis instead of transposing between the row and column
    passes keeps XLA from fusing each pass into a transpose, where it
    recomputed the butterfly per output element (PERF.md, PR 1)."""
    half = F32(0.5)

    def g(k):
        return jax.lax.index_in_dim(v, k, axis, keepdims=False)

    t0 = f64.round_mul_const(g(0), _C_SQRT2)
    t1 = g(4)
    t2 = g(2)
    t3 = g(6)
    t4 = half * (g(1) - g(7))
    t5 = f64.round_mul_const(g(3), _C_ISQRT2)
    t6 = f64.round_mul_const(g(5), _C_ISQRT2)
    t7 = half * (g(1) + g(7))

    u0 = half * (t0 + t1)
    u1 = half * (t0 - t1)
    u2 = f64.round_mul_dot2_const(_C_ISQRT2, t2, _C_COS6, t3, -_C_SIN6)
    u3 = f64.round_mul_dot2_const(_C_ISQRT2, t2, _C_SIN6, t3, _C_COS6)
    u4 = half * (t4 + t6)
    u5 = half * (-t5 + t7)
    u6 = half * (t4 - t6)
    u7 = half * (t5 + t7)

    w0 = half * (u0 + u3)
    w1 = half * (u1 + u2)
    w2 = half * (u1 - u2)
    w3 = half * (u0 - u3)
    w4 = f64.round_dot2_const(u4, _C_A, u7, -_C_B)
    w5 = f64.round_dot2_const(u5, _C_C, u6, -_C_D)
    w6 = f64.round_dot2_const(u5, _C_D, u6, _C_C)
    w7 = f64.round_dot2_const(u4, _C_B, u7, _C_A)

    outs = [w0 + w7, w1 + w6, w2 + w5, w3 + w4,
            w3 - w4, w2 - w5, w1 - w6, w0 - w7]
    return jnp.stack([f64.round_mul_const(o, _C_OUT) for o in outs], axis=axis)


def _idct8_f64(v: np.ndarray) -> np.ndarray:
    """The same butterfly with no intermediate rounding (NumPy float64) —
    used only to derive the FLOAT32 path's matmul matrix."""
    t0 = _C_SQRT2 * v[..., 0]
    t1, t2, t3 = v[..., 4], v[..., 2], v[..., 6]
    t4 = 0.5 * (v[..., 1] - v[..., 7])
    t5 = _C_ISQRT2 * v[..., 3]
    t6 = _C_ISQRT2 * v[..., 5]
    t7 = 0.5 * (v[..., 1] + v[..., 7])
    u0, u1 = 0.5 * (t0 + t1), 0.5 * (t0 - t1)
    u2 = _C_ISQRT2 * (_C_COS6 * t2 - _C_SIN6 * t3)
    u3 = _C_ISQRT2 * (_C_SIN6 * t2 + _C_COS6 * t3)
    u4, u5 = 0.5 * (t4 + t6), 0.5 * (-t5 + t7)
    u6, u7 = 0.5 * (t4 - t6), 0.5 * (t5 + t7)
    w0, w1 = 0.5 * (u0 + u3), 0.5 * (u1 + u2)
    w2, w3 = 0.5 * (u1 - u2), 0.5 * (u0 - u3)
    w4 = _C_A * u4 - _C_B * u7
    w5 = _C_C * u5 - _C_D * u6
    w6 = _C_D * u5 + _C_C * u6
    w7 = _C_B * u4 + _C_A * u7
    return np.stack(
        [
            _C_OUT * (w0 + w7), _C_OUT * (w1 + w6),
            _C_OUT * (w2 + w5), _C_OUT * (w3 + w4),
            _C_OUT * (w3 - w4), _C_OUT * (w2 - w5),
            _C_OUT * (w1 - w6), _C_OUT * (w0 - w7),
        ],
        axis=-1,
    )


@functools.lru_cache(maxsize=None)
def idct_matrix_zz() -> np.ndarray:
    """[64, 64] float32 K with: pixels = coeffs_zigzag_dequantized @ K.

    Row z is the 2-D IDCT response (including the row/col 1/sqrt2 pre-scale
    of dct.c:164-167 and the final 0.25 of dct.c:189) of the z-th ZIGZAG
    coefficient; columns are raster-order pixels. Derived by pushing the 64
    unit blocks through the f64 butterfly, so the matrix carries exactly the
    reference's literal constants.
    """
    eye = np.zeros((64, 8, 8), dtype=np.float64)
    for z in range(64):
        nat = int(ZIGZAG[z])
        eye[z, nat // 8, nat % 8] = 1.0
    eye[:, 0, :] *= _C_ISQRT2
    eye[:, :, 0] *= _C_ISQRT2
    out = _idct8_f64(eye)  # row pass
    out = np.swapaxes(out, 1, 2)
    out = _idct8_f64(out)  # column pass
    out = np.swapaxes(out, 1, 2)
    return (0.25 * out.reshape(64, 64)).astype(np.float32)


def _quantize_output(pix_shifted, bits12: bool):
    """Reference output store: trunc + clamp (+ the 12->8 rescale).

    pix_shifted: f32 array of 0.25-scaled IDCT values WITHOUT the level
    shift. The C computes r = x + {128, 2048} in f64 — exact, since both
    addends are exactly representable — so floor(x) + shift reproduces the
    trunc boundary exactly (clamping makes trunc == floor on the kept range).
    """
    base = jnp.floor(pix_shifted)
    if not bits12:
        return jnp.clip(base + F32(128.0), 0.0, 255.0).astype(jnp.uint8)
    # 12-bit: CLAMP_16 then (int16_t) wrap (dct.c:195-203), then the
    # write_data_unit rescale (du / 4096.0) * 255.0 truncated to uint8
    # (decode.c:520-525).
    v16 = jnp.clip(base + F32(2048.0), 0.0, 65535.0).astype(jnp.int32)
    v16 = (v16 & 0xFFFF).astype(jnp.int16).astype(F32)
    resc = jnp.trunc(v16 * F32(255.0 / 4096.0)).astype(jnp.int32)
    return (resc & 0xFF).astype(jnp.uint8)


def dequantize_blocks(coeffs_zz, qtable_natural):
    """Dequant + dezigzag: [N, 64] zigzag int32 -> [N, 64] natural f32.

    Mirrors dequant_data_unit (quant_table.c:131-152): natural[ZIGZAG[i]] =
    zz[i] * qt[ZIGZAG[i]]. The f32 cast matches the C's store into the float
    working block (dct.c:161 `cdu`, fed from the int16 du)."""
    qt = jnp.asarray(qtable_natural, dtype=jnp.int32)
    deq_nat = coeffs_zz[..., INV_ZIGZAG] * qt
    return deq_nat.astype(F32)


def idct_exact(coeffs_zz, qtable_natural, bits12: bool = False):
    """EXACT path: [N, 64] zigzag coeffs -> [N, 64] uint8 raster pixels.

    An optimization barrier closes the pre-scale and each pass, so XLA
    materializes the float32 [N, 8, 8] block between them. That keeps each
    pass in its own fusion (per-element recomputation of a fused butterfly
    cost ~4x, PERF.md, PR 1), and every float32 value a float64 statement
    reads then comes out of a barrier, never straight out of a float64 ->
    float32 convert that XLA could fold away."""
    barrier = jax.lax.optimization_barrier
    cdu = dequantize_blocks(coeffs_zz, qtable_natural).reshape(-1, 8, 8)
    # Row/col pre-scale (dct.c:164-167); [0,0] scaled twice.
    cdu = cdu.at[:, 0, :].set(f64.round_mul_const(cdu[:, 0, :], _C_ISQRT2))
    cdu = cdu.at[:, :, 0].set(f64.round_mul_const(cdu[:, :, 0], _C_ISQRT2))
    cdu = barrier(cdu)
    cdu = barrier(_idct8_exact(cdu, axis=2))  # row pass (dct.c:169-171)
    cdu = barrier(_idct8_exact(cdu, axis=1))  # column pass (dct.c:182-184)
    # 0.25 * f32 is exact — plain multiply reproduces the f64 scale.
    return _quantize_output(F32(0.25) * cdu, bits12).reshape(-1, 64)


def idct_matmul(coeffs_zz, qtable_natural, bits12: bool = False):
    """FLOAT32 path: the whole transform as one float32 matmul.

    [N, 64] zigzag coeffs -> [N, 64] uint8 raster pixels. The dequant fold:
    zz[i] * qt[ZIGZAG[i]] scales row i of K, so at trace time the per-table
    matrix is diag(qt_zz) @ K — one constant [64, 64] per quant table.
    """
    qt = jnp.asarray(qtable_natural, dtype=F32)[ZIGZAG]  # qt in zigzag order
    k = jnp.asarray(idct_matrix_zz()) * qt[:, None]
    pix = jnp.dot(
        coeffs_zz.astype(F32), k,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=F32,
    )
    return _quantize_output(pix, bits12)


@functools.lru_cache(maxsize=None)
def idct_matrix_zz_scaled(k: int) -> np.ndarray:
    """[64, k*k] float32 K_k with: pixels_kxk = coeffs_zz_dequantized @ K_k.

    Fractional scaled decode (k in {1, 2, 4}): each 8x8 coefficient block
    yields a k x k pixel tile directly, so a 1/8-scale decode never computes
    the 64 full-resolution pixels it would throw away. The transform is the
    truncated k-point inverse DCT of the k lowest frequencies per axis,

        g = (k/8) * B_k F[:k, :k] B_k^T,
        B_k[x, u] = sqrt(2/k) * c_u * cos((2x+1) u pi / (2k)),  c_0 = 1/sqrt(2)

    normalized so a DC-only block maps to the same constant the full IDCT
    produces (g = F00/8): the k x k tile is the band-limited projection of
    the 8x8 tile, and the retained frequencies are reproduced exactly at
    the reduced sampling grid. At k = 8 this IS the standard 2-D IDCT
    (idct_matrix_zz agrees to float32 rounding; tests/test_scaled.py pins
    it). Row ordering matches idct_matrix_zz: row z is the response of the
    z-th ZIGZAG coefficient; columns are raster-order k x k pixels.

    The reference decoder has no scaled decode — this is a capability the
    reference's users get from libjpeg's scale_num/8 API, provided here as
    one matmul per component.
    """
    if k not in (1, 2, 4, 8):
        raise ValueError(f"scaled IDCT supports k in {{1, 2, 4, 8}}, got {k}")
    x = np.arange(k, dtype=np.float64)[:, None]
    u = np.arange(k, dtype=np.float64)[None, :]
    b = np.sqrt(2.0 / k) * np.cos((2.0 * x + 1.0) * u * np.pi / (2.0 * k))
    b[:, 0] *= 1.0 / np.sqrt(2.0)
    mat = np.zeros((64, k * k), dtype=np.float64)
    for z in range(64):
        nat = int(ZIGZAG[z])
        v_row, u_col = nat // 8, nat % 8
        if v_row >= k or u_col >= k:
            continue  # truncated: frequency above the retained band
        tile = np.outer(b[:, v_row], b[:, u_col])  # [k rows, k cols]
        mat[z] = (k / 8.0) * tile.reshape(-1)
    return mat.astype(np.float32)


def idct_matmul_scaled(coeffs_zz, qtable_natural, k: int, bits12: bool = False):
    """Scaled FLOAT32 path: [N, 64] zigzag coeffs -> [N, k*k] uint8 pixels
    (raster order within each k x k tile). Same dequant fold and output
    quantization as idct_matmul."""
    qt = jnp.asarray(qtable_natural, dtype=F32)[ZIGZAG]
    m = jnp.asarray(idct_matrix_zz_scaled(k)) * qt[:, None]
    pix = jnp.dot(
        coeffs_zz.astype(F32), m,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=F32,
    )
    return _quantize_output(pix, bits12)


def idct_blocks(
    coeffs_zz,
    qtable_natural,
    precision: IdctPrecision = IdctPrecision.EXACT,
    bits12: bool = False,
):
    """Dispatch: [N, 64] zigzag-order int32 coefficients + natural-order
    quant table -> [N, 64] uint8 pixels in raster order."""
    if precision == IdctPrecision.EXACT:
        return idct_exact(coeffs_zz, qtable_natural, bits12)
    return idct_matmul(coeffs_zz, qtable_natural, bits12)


def blocks_to_plane(pixels, blocks_y: int, blocks_x: int, tile: int = 8):
    """[by*bx, tile*tile] raster-order block pixels -> [by*tile, bx*tile]
    plane (tile == 8 for full decode, k for scaled decode).

    The array form of write_data_unit's scatter (decode.c:508-533)."""
    return (
        pixels.reshape(blocks_y, blocks_x, tile, tile)
        .transpose(0, 2, 1, 3)
        .reshape(blocks_y * tile, blocks_x * tile)
    )
