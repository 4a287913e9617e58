"""Bit-exact NumPy replicas of the reference's numeric kernels.

These functions reproduce, to the last bit, the arithmetic of the C decoder's
hot kernels as compiled by gcc for x86-64 (SSE2 semantics: `float` ops are
IEEE binary32, `double` ops IEEE binary64, no excess precision):

  * `idct_2d_exact`   — `fast_2didct` + `fast_idct_new`
                        (`/root/reference/src/dct.c:158-204,296-341`): C
                        stores intermediates in `float` but every expression
                        mixes in `double` literals, so each assignment is
                        "compute in f64, round to f32". We replicate with
                        float64 compute + float32 casts per assignment.
  * `dequantize`      — `dequant_data_unit` (`quant_table.c:131-152`):
                        zigzag-order coefficients * natural-order table.
  * `ycbcr_to_rgb_exact`, `gray_to_rgb_exact`, `ycck_to_rgb_exact` —
                        `colour_conversion.c:5-162` including the
                        nearest-neighbor float-ratio upsample and the
                        clamp-to-256 wrap quirk.

They are vectorized over all blocks/pixels at once, so they double as a fast
"golden" CPU path and as the test oracle for the device kernels.
"""

from __future__ import annotations

import numpy as np

from ..utils.config import Quirks
from .types import FrameHeader, ZIGZAG

F32 = np.float32
F64 = np.float64


def _f32(x: np.ndarray) -> np.ndarray:
    return x.astype(F32)


def _idct8_rows_exact(v: np.ndarray) -> np.ndarray:
    """One `fast_idct_new` pass (dct.c:296-341) over the last axis.

    v: (..., 8) float32. Returns (..., 8) float32, replicating C evaluation
    exactly: a `float OP float` subexpression is a float32 operation (rounds
    to f32), and only the multiply by a double literal promotes to float64
    before the final store rounds back to float32. (Verified bit-for-bit
    against the compiled reference in tests/test_reference_parity.py.)
    """
    d = v.astype(F64)
    # Stage 4 (dct.c:303-310). (du[1] - du[7]) is a float32 subtract; the
    # surrounding * 0.5 is a double multiply (exact), so the f64 detour after
    # the f32 add/sub is bit-identical to the C.
    t0 = _f32(1.414213562 * d[..., 0])
    t1 = v[..., 4]
    t2 = v[..., 2]
    t3 = v[..., 6]
    t4 = _f32(0.5 * (v[..., 1] - v[..., 7]).astype(F64))
    t5 = _f32(0.707106781 * d[..., 3])
    t6 = _f32(0.707106781 * d[..., 5])
    t7 = _f32(0.5 * (v[..., 1] + v[..., 7]).astype(F64))

    # Stage 3 (dct.c:313-320): sums/differences of floats are f32 ops;
    # the two-product expressions for u2/u3 are evaluated fully in double.
    u0 = _f32(0.5 * (t0 + t1).astype(F64))
    u1 = _f32(0.5 * (t0 - t1).astype(F64))
    u2 = _f32(
        0.707106781
        * (0.38268343236 * t2.astype(F64) + -0.92387953251 * t3.astype(F64))
    )
    u3 = _f32(
        0.707106781
        * (0.92387953251 * t2.astype(F64) + 0.38268343236 * t3.astype(F64))
    )
    u4 = _f32(0.5 * (t4 + t6).astype(F64))
    u5 = _f32(0.5 * (-t5 + t7).astype(F64))
    u6 = _f32(0.5 * (t4 - t6).astype(F64))
    u7 = _f32(0.5 * (t5 + t7).astype(F64))

    # Stage 2 (dct.c:323-330)
    w0 = _f32(0.5 * (u0 + u3).astype(F64))
    w1 = _f32(0.5 * (u1 + u2).astype(F64))
    w2 = _f32(0.5 * (u1 - u2).astype(F64))
    w3 = _f32(0.5 * (u0 - u3).astype(F64))
    w4 = _f32(0.8314696123 * u4.astype(F64) + -0.55557023302 * u7.astype(F64))
    w5 = _f32(0.9807852804 * u5.astype(F64) + -0.19509032201 * u6.astype(F64))
    w6 = _f32(0.19509032201 * u5.astype(F64) + 0.9807852804 * u6.astype(F64))
    w7 = _f32(0.55557023302 * u4.astype(F64) + 0.8314696123 * u7.astype(F64))

    # Output butterfly (dct.c:333-340): (w_a +/- w_b) is a float32 op, then
    # one double multiply by the folded constant 1.414213562 * 2.
    s = 1.414213562 * 2
    out = np.empty(v.shape, dtype=F32)
    out[..., 0] = _f32(s * (w0 + w7).astype(F64))
    out[..., 1] = _f32(s * (w1 + w6).astype(F64))
    out[..., 2] = _f32(s * (w2 + w5).astype(F64))
    out[..., 3] = _f32(s * (w3 + w4).astype(F64))
    out[..., 4] = _f32(s * (w3 - w4).astype(F64))
    out[..., 5] = _f32(s * (w2 - w5).astype(F64))
    out[..., 6] = _f32(s * (w1 - w6).astype(F64))
    out[..., 7] = _f32(s * (w0 - w7).astype(F64))
    return out


def idct_2d_exact(coeffs: np.ndarray, bits12: bool = False) -> np.ndarray:
    """`fast_2didct` (dct.c:158-204) over a batch of blocks.

    coeffs: (N, 8, 8) integer array of DEQUANTIZED natural-order coefficients.
    Returns (N, 8, 8) uint8 (8-bit) or int16-wrapped-then-scaled semantics
    left to the caller for 12-bit (returns int32 of the int16-cast value).
    """
    cdu = coeffs.astype(F32)  # (N, 8, 8); exact for |c| < 2^24
    # Scale first row then first column by 1/sqrt(2) (dct.c:164-167); [0,0]
    # is scaled twice, row pass first.
    cdu[:, 0, :] = _f32(0.707106781 * cdu[:, 0, :].astype(F64))
    cdu[:, :, 0] = _f32(0.707106781 * cdu[:, :, 0].astype(F64))

    cdu = _idct8_rows_exact(cdu)  # row pass (dct.c:169-171)
    cdu = np.swapaxes(cdu, 1, 2).copy()  # transpose (dct.c:174-180)
    cdu = _idct8_rows_exact(cdu)  # column pass (dct.c:182-184)
    cdu = np.swapaxes(cdu, 1, 2)  # write-back transpose (dct.c:191,199)

    d = cdu.astype(F64)
    if not bits12:
        r = 0.25 * d + 128.0
        out = np.trunc(np.where(r > 255.0, 255.0, np.where(r < 0.0, 0.0, r)))
        return out.astype(np.uint8)
    # 12-bit path (dct.c:195-203): CLAMP_16 then (int16_t) cast which wraps
    # values >= 32768 (x86 semantics); caller rescales.
    r = 0.25 * d + 2048.0
    r = np.trunc(np.where(r > 65535.0, 65535.0, np.where(r < 0.0, 0.0, r)))
    return (r.astype(np.int64) & 0xFFFF).astype(np.int16).astype(np.int32)


def rescale_12bit(du: np.ndarray) -> np.ndarray:
    """write_data_unit's 12->8 bit rescale (decode.c:520-525):
    (uint8)((du / 4096.0) * 255.0), with C's trunc-toward-zero int conversion
    then byte truncation."""
    v = (du.astype(F64) / 4096.0) * 255.0
    iv = np.trunc(v).astype(np.int64)
    return (iv & 0xFF).astype(np.uint8)


def dequantize(coeffs_zz: np.ndarray, qtable_natural: np.ndarray) -> np.ndarray:
    """`dequant_data_unit` (quant_table.c:131-152): de-zigzag and multiply.

    coeffs_zz: (..., 64) int zigzag-order quantized coefficients.
    qtable_natural: (64,) natural-order table (de-zigzagged at parse time,
    like the reference).
    Returns (..., 64) int32 natural-order dequantized coefficients.

    Note: the reference stores the product into int16 (wraps above 32767);
    well-formed streams never exceed int16 so we keep exact int32.
    """
    natural = np.empty(coeffs_zz.shape, dtype=np.int32)
    natural[..., ZIGZAG] = coeffs_zz
    return natural * qtable_natural.astype(np.int32)


# ---------------------------------------------------------------------------
# Color conversion (colour_conversion.c)
# ---------------------------------------------------------------------------


def _nn_index_f32(n_out: int, ratio_f32: np.float32) -> np.ndarray:
    """(uint32)(i * ratio) with float32 multiply, the reference's
    nearest-neighbor index rule (colour_conversion.c:62-69)."""
    i = np.arange(n_out, dtype=np.uint32).astype(F32)
    return (i * ratio_f32).astype(np.uint32).astype(np.int64)


def _sample_plane_nn(
    plane: np.ndarray,
    comp_stride: int,
    width: int,
    height: int,
    hsf: int,
    vsf: int,
    max_hsf: int,
    max_vsf: int,
) -> np.ndarray:
    """Gather one component plane to full resolution with the reference's NN
    rule. plane: (rows, stride) uint8; returns (height, width)."""
    hratio = F32(hsf) / F32(max_hsf)
    vratio = F32(vsf) / F32(max_vsf)
    rows = _nn_index_f32(height, vratio)
    cols = _nn_index_f32(width, hratio)
    flat = plane.reshape(-1)
    idx = rows[:, None] * comp_stride + cols[None, :]
    return flat[idx]


def _store_rgb_reference(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    """RGB store as the COMPILED reference behaves: truncate toward zero,
    saturate to [0, 255].

    The C source spells a clamp-to-256 that would wrap to 0
    (colour_conversion.c:77-79, `(R > 256.0) ? 256 : R` stored to uint8), but
    the float->uint8 conversion of out-of-range values is UB and gcc 12 -O2
    compiles the loop with saturating vector packs: values > 255 come out as
    255 (verified empirically against the compiled binary in
    tests/test_reference_parity.py). Parity targets the binary's behavior.
    """
    out = np.empty(r.shape + (3,), dtype=np.uint8)
    for i, ch in enumerate((r, g, b)):
        out[..., i] = np.clip(np.trunc(ch), 0.0, 255.0).astype(np.uint8)
    return out


def _store_rgb_correct(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Spec-sane store: round-to-nearest (libjpeg-style), clamp to [0, 255]."""
    out = np.empty(r.shape + (3,), dtype=np.uint8)
    for i, ch in enumerate((r, g, b)):
        out[..., i] = np.clip(np.floor(ch + 0.5), 0.0, 255.0).astype(np.uint8)
    return out


def gray_to_rgb_exact(
    frame: FrameHeader, plane: np.ndarray, quirks: Quirks = Quirks.REFERENCE
) -> np.ndarray:
    """`y_rgb` (colour_conversion.c:5-28). Reference quirk: indexes the plane
    with the IMAGE width as stride (line 20's `i * width + j`), not the
    MCU-padded plane stride — shears images whose width isn't a multiple of 8.
    """
    h, w = frame.height, frame.width
    if quirks == Quirks.REFERENCE:
        flat = plane.reshape(-1)
        idx = np.arange(h, dtype=np.int64)[:, None] * w + np.arange(w)[None, :]
        y = flat[idx]
    else:
        y = plane[:h, :w]
    return np.repeat(y[..., None], 3, axis=-1)


def _ycc_channels(
    frame: FrameHeader, planes: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    h, w = frame.height, frame.width
    mh, mv = frame.max_hsf, frame.max_vsf
    chans = []
    for ci in range(3):
        c = frame.components[ci]
        chans.append(
            _sample_plane_nn(planes[ci], c.stride, w, h, c.hsf, c.vsf, mh, mv)
        )
    return chans[0], chans[1], chans[2]


def ycbcr_to_rgb_exact(
    frame: FrameHeader,
    planes: list[np.ndarray],
    quirks: Quirks = Quirks.REFERENCE,
) -> np.ndarray:
    """`ycbcr_rgb` (colour_conversion.c:30-83): BT.601 with the reference's
    double-precision constants 1.402 / 0.34414 / 0.71414 / 1.772, float32
    storage of R/G/B, NN chroma upsample."""
    y8, cb8, cr8 = _ycc_channels(frame, planes)
    return ycbcr_channels_to_rgb(y8, cb8, cr8, quirks)


def ycbcr_channels_to_rgb(
    y8: np.ndarray, cb8: np.ndarray, cr8: np.ndarray,
    quirks: Quirks = Quirks.REFERENCE,
) -> np.ndarray:
    """The arithmetic half of ycbcr_to_rgb_exact, on already full-resolution
    channels (used by the host fancy-upsample path, models/decoder.py)."""
    y = y8.astype(F64)
    cb = cb8.astype(F64) - 128.0
    cr = cr8.astype(F64) - 128.0
    # C computes in double, stores to float (colour_conversion.c:71-74).
    r = _f32(y + 1.402 * cr)
    g = _f32(y - 0.34414 * cb - 0.71414 * cr)
    b = _f32(y + 1.772 * cb)
    if quirks == Quirks.REFERENCE:
        return _store_rgb_reference(r, g, b)
    return _store_rgb_correct(r, g, b)


def ycck_to_rgb_exact(
    frame: FrameHeader,
    planes: list[np.ndarray],
    quirks: Quirks = Quirks.REFERENCE,
) -> np.ndarray:
    """`yccb_rgb` (colour_conversion.c:85-162): 4-component YCCK composite —
    YCbCr->CMY then scale by K/255."""
    h, w = frame.height, frame.width
    mh, mv = frame.max_hsf, frame.max_vsf
    chans = []
    for ci in range(4):
        c = frame.components[ci]
        chans.append(
            _sample_plane_nn(planes[ci], c.stride, w, h, c.hsf, c.vsf, mh, mv)
        )
    return ycck_channels_to_rgb(chans[0], chans[1], chans[2], chans[3], quirks)


def cmyk_to_rgb_exact(
    frame: FrameHeader,
    planes: list[np.ndarray],
    quirks: Quirks = Quirks.CORRECT,
) -> np.ndarray:
    """Raw Adobe CMYK (APP14 transform=0): samples are stored INVERTED
    (Adobe convention), so with stored values s = 255-C etc. the naive
    multiplicative composite is R = round(s_c * s_k / 255) — verified
    byte-identical to libjpeg+Pillow's CMYK->RGB over the full 256x256
    (C,K) domain ((x+127)//255 == their MULDIV255 rounding everywhere).
    No reference analogue: the C decoder ignores APP14 and always runs
    its YCCK composite (colour_conversion.c:85-162)."""
    del quirks  # integer-exact; no store-rounding quirk applies
    h, w = frame.height, frame.width
    mh, mv = frame.max_hsf, frame.max_vsf
    chans = []
    for ci in range(4):
        c = frame.components[ci]
        chans.append(
            _sample_plane_nn(planes[ci], c.stride, w, h, c.hsf, c.vsf, mh, mv)
        )
    return cmyk_channels_to_rgb(chans[0], chans[1], chans[2], chans[3])


def cmyk_channels_to_rgb(
    c8: np.ndarray, m8: np.ndarray, y8: np.ndarray, k8: np.ndarray,
    quirks: Quirks = Quirks.CORRECT,
) -> np.ndarray:
    """Arithmetic half of cmyk_to_rgb_exact on full-resolution channels."""
    del quirks
    k = k8.astype(np.int32)
    out = [
        ((ch.astype(np.int32) * k + 127) // 255).astype(np.uint8)
        for ch in (c8, m8, y8)
    ]
    return np.stack(out, axis=-1)


def ycck_channels_to_rgb(
    y8: np.ndarray, cb8: np.ndarray, cr8: np.ndarray, k8: np.ndarray,
    quirks: Quirks = Quirks.REFERENCE,
) -> np.ndarray:
    """The arithmetic half of ycck_to_rgb_exact, on already full-resolution
    channels (used by the host fancy-upsample path, models/decoder.py)."""
    y = y8.astype(F64)
    cb = cb8.astype(F64) - 128.0
    cr = cr8.astype(F64) - 128.0
    k = k8.astype(F64)
    # float C/M/Y stored to float32 (colour_conversion.c:137-141)
    c_ = _f32(y + 1.402 * cr).astype(F64)
    m_ = _f32(y - 0.34414 * cb - 0.71414 * cr).astype(F64)
    y_ = _f32(y + 1.772 * cb).astype(F64)
    r = _f32(255.0 * (1.0 - c_ / 255.0) * (k / 255.0))
    g = _f32(255.0 * (1.0 - m_ / 255.0) * (k / 255.0))
    b = _f32(255.0 * (1.0 - y_ / 255.0) * (k / 255.0))
    if quirks == Quirks.REFERENCE:
        return _store_rgb_reference(r, g, b)
    return _store_rgb_correct(r, g, b)
