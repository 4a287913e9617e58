"""Fractional scaled decode (DecodeConfig.scale: libjpeg's scale_num/8).

The reference decoder has no scaled decode; this is a new capability built
on the coefficient-plane IR: a k-point truncated IDCT (k = scale in
{1, 2, 4}) produces a k x k pixel tile per 8x8 block as one matmul
(ops/idct.idct_matrix_zz_scaled), so thumbnails never compute the
full-resolution pixels. Oracles used here, in independence order:

  1. a from-the-formula NumPy cosine-sum evaluation of the truncated
     IDCT, written against the definition (not the matrix builder);
  2. the closed form for scale=1 (DC band only): clip(floor(qt*DC/8)+128);
  3. the standard full-size matrix at k=8 (the transforms must agree);
  4. libjpeg's own scaled decode via PIL's draft mode (loose tolerance:
     libjpeg uses a fixed-point IDCT and its own upsampling);
  5. the area-averaged full decode on smooth content (band-limited
     projection tracks local means).
"""

from __future__ import annotations

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_decoder_tpu.core.types import ZIGZAG
from jpeg_decoder_tpu.models import decoder as decoder_mod
from jpeg_decoder_tpu.ops import idct as idct_ops
from jpeg_decoder_tpu.utils.config import DecodeConfig, IdctPrecision, Quirks
from jpeg_decoder_tpu.utils.errors import JpegConfigError

from .corpus import make_jpeg

F32_CFG = DecodeConfig(idct_precision=IdctPrecision.FLOAT32)


def _cfg(scale: int, **kw) -> DecodeConfig:
    return F32_CFG.replace(scale=scale, **kw)


def _smooth_rgb(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack(
        [(yy * 2) % 256, (xx * 2) % 256, (yy + xx) % 256], -1
    ).astype(np.uint8)


# ---------------------------------------------------------------------------
# Matrix-level: the scaled transform against independent definitions
# ---------------------------------------------------------------------------


def _truncated_idct_reference(coeffs_zz: np.ndarray, k: int) -> np.ndarray:
    """Direct cosine-sum evaluation of the truncated k-point IDCT of one
    zigzag-order [64] coefficient vector -> [k, k] f64. Independent of the
    matrix builder: no basis matrix, no outer products."""
    nat = np.zeros(64)
    nat[ZIGZAG] = coeffs_zz
    nat = nat.reshape(8, 8)
    out = np.zeros((k, k))
    for x in range(k):
        for y in range(k):
            acc = 0.0
            for v in range(k):
                for u in range(k):
                    cv = 1 / np.sqrt(2) if v == 0 else 1.0
                    cu = 1 / np.sqrt(2) if u == 0 else 1.0
                    acc += (
                        cv * cu * nat[v, u]
                        * np.cos((2 * x + 1) * v * np.pi / (2 * k))
                        * np.cos((2 * y + 1) * u * np.pi / (2 * k))
                    )
            out[x, y] = (2.0 / k) * (k / 8.0) * acc
    return out


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_scaled_matrix_matches_cosine_sum(k, rng):
    mat = idct_ops.idct_matrix_zz_scaled(k).astype(np.float64)
    for _ in range(5):
        zz = rng.integers(-512, 512, 64).astype(np.float64)
        got = (zz @ mat).reshape(k, k)
        want = _truncated_idct_reference(zz, k)
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_scaled_matrix_k8_is_the_full_idct():
    """At k=8 the truncated transform IS the standard 2-D IDCT: the
    orthonormal-basis derivation must agree with the AAN-constant-derived
    full matrix (ops/idct.idct_matrix_zz) to float rounding."""
    np.testing.assert_allclose(
        idct_ops.idct_matrix_zz_scaled(8).astype(np.float64),
        idct_ops.idct_matrix_zz().astype(np.float64),
        atol=2e-5,
    )


def test_scaled_matrix_dc_normalization():
    """A DC-only block maps to the constant F00/8 at every scale — the same
    level the full IDCT assigns (dequant folds in later)."""
    zz = np.zeros(64)
    zz[0] = 80.0
    for k in (1, 2, 4):
        tile = zz @ idct_ops.idct_matrix_zz_scaled(k).astype(np.float64)
        np.testing.assert_allclose(tile, 10.0, atol=1e-5)


# ---------------------------------------------------------------------------
# Pipeline-level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale,den", [(1, 8), (2, 4), (4, 2)])
@pytest.mark.parametrize(
    "shape,mode,sub",
    [((64, 96), "L", None), ((64, 96, 3), "RGB", 2), ((41, 67, 3), "RGB", 0)],
)
def test_scaled_output_shape(scale, den, shape, mode, sub, rng):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    kw = {} if sub is None else {"subsampling": sub}
    data = make_jpeg(img, mode, quality=88, **kw)
    out = decoder_mod.decode_rgb(data, _cfg(scale))
    h, w = shape[:2]
    assert out.shape == (-(-h * scale // 8), -(-w * scale // 8), 3)


def test_scale1_grayscale_is_the_dc_closed_form(rng):
    """scale=1: one pixel per block, and the whole pipeline reduces to
    clip(floor(qt[0] * DC / 8) + 128, 0, 255) per block — computable
    directly from the coefficient planes without any IDCT code."""
    img = rng.integers(0, 256, (48, 56), dtype=np.uint8)
    data = make_jpeg(img, "L", quality=85)
    cfg = _cfg(1)
    structure = decoder_mod.parse(data, cfg)
    planes, qts = decoder_mod._entropy_decode(structure, cfg)
    c = structure.frame.components[0]
    dc = planes.plane(0)[..., 0].astype(np.float64)
    qt0 = float(qts[c.qtid][0])
    want = np.clip(np.floor(dc * qt0 / 8.0) + 128.0, 0, 255).astype(np.uint8)
    out = decoder_mod.decode_rgb(data, cfg)
    # 48x56 -> 6x7 output; every block is real (multiple-of-8 dims)
    np.testing.assert_array_equal(out[..., 0], want)
    np.testing.assert_array_equal(out[..., 0], out[..., 1])


@pytest.mark.parametrize("scale,factor", [(4, 2), (2, 4), (1, 8)])
def test_scaled_tracks_area_average_on_smooth_content(scale, factor):
    img = _smooth_rgb(64, 96)
    data = make_jpeg(img, "RGB", quality=92, subsampling=0)
    full = decoder_mod.decode_rgb(data, F32_CFG).astype(np.float64)
    out = decoder_mod.decode_rgb(data, _cfg(scale)).astype(np.float64)
    hh, hw = out.shape[:2]
    ref = full.reshape(hh, factor, hw, factor, 3).mean((1, 3))
    assert np.abs(ref - out).mean() < 1.5
    assert np.abs(ref - out).max() < 8.0


@pytest.mark.parametrize("pil_sub,our_scale", [(0, 4), (2, 4), (0, 2), (2, 2)])
def test_scaled_against_libjpeg_draft(pil_sub, our_scale):
    """Cross-decoder: PIL's draft mode is libjpeg's scaled decode. The two
    engines share the transform definition but not the arithmetic
    (libjpeg: fixed-point IDCT + its own upsampler), so compare loosely."""
    img = _smooth_rgb(80, 112)
    data = make_jpeg(img, "RGB", quality=90, subsampling=pil_sub)
    im = Image.open(io.BytesIO(data))
    den = 8 // our_scale
    im.draft("RGB", (112 // den, 80 // den))
    pil = np.asarray(im.convert("RGB")).astype(np.float64)
    ours = decoder_mod.decode_rgb(data, _cfg(our_scale)).astype(np.float64)
    assert pil.shape == ours.shape
    assert np.abs(pil - ours).mean() < 3.0


def test_scaled_progressive_thumbnail(rng):
    """Scaled decode composes with progressive streams for free — the
    coefficient planes are the shared IR (the reference crashes on
    progressive entirely, decode.c:858-869)."""
    img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    data = make_jpeg(img, "RGB", quality=85, progressive=True)
    base = make_jpeg(img, "RGB", quality=85)
    prog = decoder_mod.decode_rgb(data, _cfg(2)).astype(np.int16)
    seq = decoder_mod.decode_rgb(base, _cfg(2)).astype(np.int16)
    # Same image content through two entropy encodings: thumbnails agree
    # up to the streams' own (identical-coefficient) round trip.
    assert prog.shape == seq.shape == (16, 16, 3)
    assert np.abs(prog - seq).max() <= 1


def test_scaled_batch_decoder(rng):
    """Scale flows through the batched (vmapped) stage unchanged."""
    from jpeg_decoder_tpu.parallel.batch import BatchDecoder

    imgs = [
        rng.integers(0, 256, (32, 48, 3), dtype=np.uint8) for _ in range(3)
    ]
    datas = [make_jpeg(im, "RGB", quality=88, subsampling=2) for im in imgs]
    bd = BatchDecoder(_cfg(4))
    got = bd.decode_batch(datas)
    assert got.shape == (3, 16, 24, 3)
    for i, d in enumerate(datas):
        single = decoder_mod.decode_rgb(d, _cfg(4))
        np.testing.assert_array_equal(got[i], single)


def test_scaled_config_validation():
    with pytest.raises(JpegConfigError):
        DecodeConfig(scale=3)
    with pytest.raises(JpegConfigError):
        DecodeConfig(scale=0)
    # host pixel path has no scaled transform
    with pytest.raises(JpegConfigError):
        img = np.zeros((16, 16), dtype=np.uint8)
        data = make_jpeg(img, "L", quality=85)
        decoder_mod.decode(data, DecodeConfig(scale=4, use_device=False))


def test_scaled_striped_rejected(rng):
    from jpeg_decoder_tpu.parallel import stripes as stripes_mod

    img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    data = make_jpeg(img, "RGB", quality=85)
    with pytest.raises(ValueError, match="full-scale"):
        stripes_mod.decode_striped(data, _cfg(4))


def test_scaled_quirks_variants_run(rng):
    """Both quirk modes and both upsamplers accept scaled configs (the
    pixel-store quirks still apply; the full-res-only stride quirk is
    bypassed)."""
    img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    data = make_jpeg(img, "RGB", quality=85, subsampling=2)
    outs = [
        decoder_mod.decode_rgb(
            data, _cfg(2, quirks=q, upsample=u)
        )
        for q in (Quirks.REFERENCE, Quirks.CORRECT)
        for u in ("nn", "fancy")
    ]
    for o in outs:
        assert o.shape == (10, 10, 3)
    # NN vs fancy may differ slightly; REFERENCE vs CORRECT store rounding
    # differs by <= 1
    a, b = outs[0].astype(np.int16), outs[2].astype(np.int16)
    assert np.abs(a - b).max() <= 1
