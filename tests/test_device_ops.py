"""Device kernel tests: float64 statements, fused dequant+IDCT, color ops.

Each device op is validated against the bit-exact NumPy oracle numerics
(core/numerics.py), which are themselves validated byte-for-byte against the
compiled reference in test_reference_parity.py — so agreement here is
transitive agreement with the C decoder.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jpeg_decoder_tpu.core import numerics
from jpeg_decoder_tpu.core.types import ZIGZAG, standard_luminance_qtable
from jpeg_decoder_tpu.ops import color as color_ops
from jpeg_decoder_tpu.ops import f64
from jpeg_decoder_tpu.ops import idct as idct_ops
from jpeg_decoder_tpu.utils.config import IdctPrecision, Quirks


# ---------------------------------------------------------------------------
# float64 statement helpers (EXACT contract)
# ---------------------------------------------------------------------------


def _f64_statement(fn, *arrays):
    """Run an ops/f64 statement helper jitted (so XLA may fuse) on float32
    inputs, returning its float32 result."""
    return np.asarray(jax.jit(fn)(*[jnp.asarray(a) for a in arrays]))


class TestDf32:
    """The float64 statement helpers (ops/f64.py) that replaced the
    double-float emulation: one f64 evaluation, one f32 store, so they
    match NumPy's f64-then-f32 model with no tolerance at all."""

    def test_round_mul_const_matches_f64(self, rng):
        x = rng.uniform(-4000, 4000, 20000).astype(np.float32)
        for c in (1.414213562, 0.707106781, -0.92387953251, 1.402, -0.71414):
            want = (np.float64(c) * x.astype(np.float64)).astype(np.float32)
            got = _f64_statement(lambda v: f64.round_mul_const(v, c), x)
            np.testing.assert_array_equal(got, want)

    def test_round_dot2_matches_f64(self, rng):
        x = rng.uniform(-2000, 2000, 20000).astype(np.float32)
        y = rng.uniform(-2000, 2000, 20000).astype(np.float32)
        want = (
            0.8314696123 * x.astype(np.float64)
            + -0.55557023302 * y.astype(np.float64)
        ).astype(np.float32)
        got = _f64_statement(
            lambda a, b: f64.round_dot2_const(a, 0.8314696123, b, -0.55557023302),
            x, y,
        )
        np.testing.assert_array_equal(got, want)

    def test_nested_product_matches_f64(self, rng):
        t2 = rng.uniform(-2000, 2000, 20000).astype(np.float32)
        t3 = rng.uniform(-2000, 2000, 20000).astype(np.float32)
        want = (
            0.707106781
            * (0.38268343236 * t2.astype(np.float64)
               - 0.92387953251 * t3.astype(np.float64))
        ).astype(np.float32)
        got = _f64_statement(
            lambda a, b: f64.round_mul_dot2_const(
                0.707106781, a, 0.38268343236, b, -0.92387953251
            ),
            t2, t3,
        )
        np.testing.assert_array_equal(got, want)

    def test_dot2_matches_f64_without_fusion(self, rng):
        # The float64 sum itself, before the f32 store: bit-equal to the
        # unfused round(round(cx*x) + round(cy*y)) even where the backend
        # contracts multiply-adds (a fused form differs in the last f64
        # bit on about half of these inputs).
        x = rng.uniform(-2000, 2000, 20000).astype(np.float32)
        y = rng.uniform(-2000, 2000, 20000).astype(np.float32)
        want = (0.8314696123 * x.astype(np.float64)
                + -0.55557023302 * y.astype(np.float64))
        with f64.x64():
            got = np.asarray(jax.jit(
                lambda a, b: f64.dot2_const(
                    a.astype(f64.F64), 0.8314696123,
                    b.astype(f64.F64), -0.55557023302)
            )(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_array_equal(got, want)

    def test_split_const_is_exact(self):
        for c in (1.414213562, 0.707106781, -0.92387953251, 1.402,
                  0.8314696123, 255.0):
            hi, lo = f64.split_const(c)
            assert hi + lo == c
            assert float(np.float64(hi) * (2.0 ** 29 / 2 ** np.floor(
                np.log2(abs(hi))))).is_integer()

    def test_store_matches_f32_cast(self, rng):
        # reduce_precision to float32 == NumPy's float64 -> float32 cast,
        # ties included (values built to sit exactly on f32 midpoints).
        x = rng.uniform(-1e5, 1e5, 20000)
        mid = (x.astype(np.float32).astype(np.float64)
               + np.spacing(x.astype(np.float32)).astype(np.float64) / 2)
        for v in (x, mid):
            with f64.x64():
                got = np.asarray(
                    f64.store(jnp.asarray(v, dtype=jnp.float64))
                    .astype(jnp.float32)
                )
            np.testing.assert_array_equal(got, v.astype(np.float32))


# ---------------------------------------------------------------------------
# Fused dequant + IDCT
# ---------------------------------------------------------------------------


def _random_blocks(rng, n, lo=-1024, hi=1024):
    blocks = rng.integers(lo, hi, (n, 64)).astype(np.int32)
    # JPEG blocks are sparse in practice; zero a random suffix per block.
    cut = rng.integers(1, 64, n)
    mask = np.arange(64)[None, :] < cut[:, None]
    return np.where(mask, blocks, 0).astype(np.int32)


class TestIdct:
    def _oracle(self, blocks_zz, qt, bits12=False):
        deq = numerics.dequantize(blocks_zz, qt)
        pix = numerics.idct_2d_exact(deq.reshape(-1, 8, 8), bits12=bits12)
        if bits12:
            pix = numerics.rescale_12bit(pix)
        return pix.reshape(-1, 64)

    def test_exact_bitwise_vs_oracle(self, rng):
        qt = standard_luminance_qtable()
        blocks = _random_blocks(rng, 4096)
        want = self._oracle(blocks, qt)
        got = np.asarray(
            idct_ops.idct_blocks(jnp.asarray(blocks), qt, IdctPrecision.EXACT)
        )
        np.testing.assert_array_equal(got, want)

    def test_exact_bitwise_dc_only_and_extremes(self, rng):
        qt = np.ones(64, dtype=np.uint16)
        cases = np.zeros((200, 64), dtype=np.int32)
        cases[:100, 0] = rng.integers(-2048, 2048, 100)  # DC-only
        cases[100:] = rng.integers(-2047, 2048, (100, 64))  # dense extremes
        want = self._oracle(cases, qt)
        got = np.asarray(
            idct_ops.idct_blocks(jnp.asarray(cases), qt, IdctPrecision.EXACT)
        )
        np.testing.assert_array_equal(got, want)

    def test_exact_12bit(self, rng):
        qt = standard_luminance_qtable()
        blocks = _random_blocks(rng, 512, -16384, 16384)
        want = self._oracle(blocks, qt, bits12=True)
        got = np.asarray(
            idct_ops.idct_blocks(
                jnp.asarray(blocks), qt, IdctPrecision.EXACT, bits12=True
            )
        )
        np.testing.assert_array_equal(got, want)

    def test_matmul_within_1lsb(self, rng):
        qt = standard_luminance_qtable()
        blocks = _random_blocks(rng, 4096)
        want = self._oracle(blocks, qt).astype(np.int32)
        got = np.asarray(
            idct_ops.idct_blocks(jnp.asarray(blocks), qt, IdctPrecision.FLOAT32)
        ).astype(np.int32)
        assert np.abs(got - want).max() <= 1

    def test_idct_matrix_is_true_idct(self):
        # The folded matrix must equal the ideal orthonormal 2-D IDCT to the
        # precision of the reference's truncated constants (~1e-9).
        k = idct_ops.idct_matrix_zz().astype(np.float64)
        u = np.arange(8)
        basis = np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
        cu = np.where(u == 0, 1 / np.sqrt(2), 1.0)
        want = np.zeros((64, 64))
        for z in range(64):
            nat = int(ZIGZAG[z])
            uu, vv = nat // 8, nat % 8
            resp = (
                0.25
                * cu[uu] * cu[vv]
                * np.outer(basis[uu], basis[vv])
            )
            want[z] = resp.reshape(64)
        np.testing.assert_allclose(k, want, atol=2e-7)

    def test_blocks_to_plane(self, rng):
        pix = rng.integers(0, 256, (6, 64)).astype(np.uint8)
        plane = np.asarray(idct_ops.blocks_to_plane(jnp.asarray(pix), 2, 3))
        assert plane.shape == (16, 24)
        np.testing.assert_array_equal(
            plane[8:16, 8:16], pix[4].reshape(8, 8)
        )


# ---------------------------------------------------------------------------
# Color ops
# ---------------------------------------------------------------------------


class TestColor:
    def test_nn_upsample_matches_oracle(self, rng):
        plane = rng.integers(0, 256, (24, 32)).astype(np.uint8)
        for (h, w, hsf, vsf, mh, mv) in [
            (40, 60, 1, 1, 2, 2),
            (24, 64, 1, 1, 2, 1),
            (17, 23, 1, 1, 2, 1),
        ]:
            want = numerics._sample_plane_nn(plane, 32, w, h, hsf, vsf, mh, mv)
            got = np.asarray(
                color_ops.nn_upsample(jnp.asarray(plane), h, w, hsf, vsf, mh, mv)
            )
            np.testing.assert_array_equal(got, want)

    def test_ycbcr_exact_vs_oracle(self, rng):
        h, w = 37, 53
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        cb = rng.integers(0, 256, (h, w)).astype(np.uint8)
        cr = rng.integers(0, 256, (h, w)).astype(np.uint8)
        yy = y.astype(np.float64)
        cbf = cb.astype(np.float64) - 128.0
        crf = cr.astype(np.float64) - 128.0
        r = (yy + 1.402 * crf).astype(np.float32)
        g = (yy - 0.34414 * cbf - 0.71414 * crf).astype(np.float32)
        b = (yy + 1.772 * cbf).astype(np.float32)
        want = numerics._store_rgb_reference(r, g, b)
        got = np.asarray(
            color_ops.ycbcr_to_rgb(
                jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), exact=True
            )
        )
        np.testing.assert_array_equal(got, want)

    def test_ycbcr_f32_within_1lsb(self, rng):
        h, w = 37, 53
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        cb = rng.integers(0, 256, (h, w)).astype(np.uint8)
        cr = rng.integers(0, 256, (h, w)).astype(np.uint8)
        exact = np.asarray(
            color_ops.ycbcr_to_rgb(
                jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), exact=True
            )
        ).astype(np.int32)
        fast = np.asarray(
            color_ops.ycbcr_to_rgb(
                jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), exact=False
            )
        ).astype(np.int32)
        assert np.abs(exact - fast).max() <= 1

    def test_ycck_exact_vs_oracle(self, rng):
        h, w = 24, 40
        chans = [
            rng.integers(0, 256, (h, w)).astype(np.uint8) for _ in range(4)
        ]
        yy = chans[0].astype(np.float64)
        cbf = chans[1].astype(np.float64) - 128.0
        crf = chans[2].astype(np.float64) - 128.0
        k = chans[3].astype(np.float64)
        c_ = (yy + 1.402 * crf).astype(np.float32).astype(np.float64)
        m_ = (yy - 0.34414 * cbf - 0.71414 * crf).astype(np.float32).astype(np.float64)
        y_ = (yy + 1.772 * cbf).astype(np.float32).astype(np.float64)
        r = (255.0 * (1.0 - c_ / 255.0) * (k / 255.0)).astype(np.float32)
        g = (255.0 * (1.0 - m_ / 255.0) * (k / 255.0)).astype(np.float32)
        b = (255.0 * (1.0 - y_ / 255.0) * (k / 255.0)).astype(np.float32)
        want = numerics._store_rgb_reference(r, g, b)
        got = np.asarray(
            color_ops.ycck_to_rgb(*[jnp.asarray(c) for c in chans], exact=True)
        )
        np.testing.assert_array_equal(got, want)

    def test_gray(self, rng):
        y = rng.integers(0, 256, (9, 11)).astype(np.uint8)
        got = np.asarray(color_ops.gray_to_rgb(jnp.asarray(y)))
        assert got.shape == (9, 11, 3)
        np.testing.assert_array_equal(got[..., 0], y)
        np.testing.assert_array_equal(got[..., 2], y)

    def test_fancy_upsample_shape_and_range(self, rng):
        plane = rng.integers(0, 256, (16, 16)).astype(np.uint8)
        got = np.asarray(
            color_ops.fancy_upsample(jnp.asarray(plane), 32, 32, 1, 1, 2, 2)
        )
        assert got.shape == (32, 32)
        # Interpolated values stay within the local min/max envelope.
        assert got.min() >= plane.min() and got.max() <= plane.max()


# ---------------------------------------------------------------------------
# Huffman table properties (SURVEY.md §4: LUT vs spec-table cross-check)
# ---------------------------------------------------------------------------


class TestHuffmanProperty:
    def _random_spec(self, rng):
        from jpeg_decoder_tpu.core.types import HuffTableSpec

        # Random valid canonical table: distribute n symbols over lengths
        # without oversubscription (Kraft sum <= 1).
        counts = np.zeros(16, dtype=np.uint8)
        budget = 1.0
        total = 0
        for ln in range(1, 17):
            cap = int(budget * (1 << ln)) - (1 if ln < 16 else 0)
            take = int(rng.integers(0, min(max(cap, 0), 30) + 1))
            counts[ln - 1] = take
            total += take
            budget = (budget - take / (1 << ln))
            if total >= 200:
                break
        if total == 0:
            counts[0] = 1
            total = 1
        symbols = rng.choice(256, total, replace=False).astype(np.uint8)
        return HuffTableSpec(0, 0, counts, symbols)

    def test_flat_lut_equals_canonical_walk(self, rng):
        from jpeg_decoder_tpu.core.huffman import build_canonical, build_flat_lut
        from jpeg_decoder_tpu.utils.errors import JpegEntropyError

        for _ in range(20):
            spec = self._random_spec(rng)
            canon = build_canonical(spec)
            lut = build_flat_lut(canon)
            for _k in range(200):
                peek = int(rng.integers(0, 65536))
                bits = [(peek >> (15 - i)) & 1 for i in range(16)]
                it = iter(bits[1:])
                try:
                    want = canon.decode_walk(bits[0], lambda: next(it))
                except (JpegEntropyError, StopIteration):
                    want = None
                try:
                    got, _ln = lut.decode_peek(peek)
                except JpegEntropyError:
                    got = None
                assert got == want

    def test_encode_decode_table_inverse(self, rng):
        from jpeg_decoder_tpu.core.huffman import (
            build_canonical, build_encode_table, build_flat_lut,
        )

        for _ in range(10):
            spec = self._random_spec(rng)
            enc = build_encode_table(spec)
            lut = build_flat_lut(build_canonical(spec))
            for s in spec.symbols:
                s = int(s)
                size = int(enc.size[s])
                assert size > 0
                peek = (int(enc.code[s]) << (16 - size)) & 0xFFFF
                got, ln = lut.decode_peek(peek)
                assert got == s and ln == size
