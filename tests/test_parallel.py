"""Multi-device tests on the virtual 8-device CPU mesh (conftest forces
XLA_FLAGS=--xla_force_host_platform_device_count=8), validating the mesh /
batch-DP / stripe-SP layers without accelerator hardware (SURVEY.md §4)."""

import numpy as np
import pytest

import jax

from jpeg_decoder_tpu.core import oracle
from jpeg_decoder_tpu.models import decoder, encoder
from jpeg_decoder_tpu.parallel import batch as batch_mod
from jpeg_decoder_tpu.parallel import mesh as mesh_mod
from jpeg_decoder_tpu.parallel import stripes as stripes_mod
from jpeg_decoder_tpu.utils.config import (
    DecodeConfig,
    EncodeConfig,
    EntropyBackend,
)

from . import corpus

CFG = DecodeConfig(entropy_backend=EntropyBackend.NUMPY)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return mesh_mod.make_mesh(n_data=8)


@pytest.fixture(scope="module")
def mesh_stripe8():
    return mesh_mod.make_mesh(n_data=1, n_stripe=8)


class TestBatch:
    def test_batch_matches_single(self, mesh8):
        name, data = corpus.baseline_corpus()[5]  # rgb420_q90
        want = decoder.decode(data, CFG).rgb
        bd = batch_mod.BatchDecoder(CFG, mesh8)
        got = bd.decode_batch([data] * 5)  # 5 % 8 != 0: exercises padding
        assert got.shape == (5,) + want.shape
        for i in range(5):
            np.testing.assert_array_equal(got[i], want)

    def test_batch_distinct_images(self, mesh8):
        rng = np.random.default_rng(17)
        datas = []
        for i in range(8):
            img = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
            datas.append(encoder.encode(img, EncodeConfig(quality=85)))
        bd = batch_mod.BatchDecoder(CFG, mesh8)
        got = bd.decode_batch(datas)
        for i, d in enumerate(datas):
            np.testing.assert_array_equal(got[i], decoder.decode(d, CFG).rgb)

    def test_batch_no_mesh(self):
        name, data = corpus.baseline_corpus()[0]
        want = decoder.decode(data, CFG).rgb
        got = batch_mod.decode_batch([data, data], CFG, mesh=None)
        np.testing.assert_array_equal(got[0], want)

    def test_decode_many_mixed_geometries(self, mesh8):
        rng = np.random.default_rng(3)
        small = encoder.encode(
            rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
            EncodeConfig(quality=85),
        )
        big = encoder.encode(
            rng.integers(0, 256, (64, 48, 3), dtype=np.uint8),
            EncodeConfig(quality=85),
        )
        bd = batch_mod.BatchDecoder(CFG, mesh8)
        out = bd.decode_many([small, big, small])
        assert out[0].shape == (32, 32, 3)
        assert out[1].shape == (64, 48, 3)
        np.testing.assert_array_equal(out[0], out[2])

    def test_batch_rejects_mixed(self, mesh8):
        from jpeg_decoder_tpu.utils.errors import JpegFormatError

        a = corpus.baseline_corpus()[0][1]
        b = corpus.baseline_corpus()[3][1]
        bd = batch_mod.BatchDecoder(CFG, mesh8)
        with pytest.raises(JpegFormatError):
            bd.decode_batch([a, b])


@pytest.mark.slow  # soak tier; quick coverage stays in TestBatch/TestStream
class TestStripes:
    @pytest.mark.parametrize("sub", ["444", "420"])
    def test_striped_matches_single(self, mesh_stripe8, sub):
        rng = np.random.default_rng(41)
        # 8 stripes need mcus_y % 8 == 0: 420 -> 128 rows, 444 -> 64 rows.
        h = 128 if sub == "420" else 64
        img = rng.integers(0, 256, (h, 64, 3), dtype=np.uint8)
        data = encoder.encode(img, EncodeConfig(quality=88, subsampling=sub))
        want = decoder.decode(data, CFG).rgb
        got = stripes_mod.decode_striped(data, CFG, mesh_stripe8)
        np.testing.assert_array_equal(got, want)

    def test_striped_gray(self, mesh_stripe8):
        from jpeg_decoder_tpu.utils.config import Quirks

        rng = np.random.default_rng(43)
        img = rng.integers(0, 256, (64, 64), dtype=np.uint8)
        data = encoder.encode(img, EncodeConfig(quality=90, subsampling="gray"))
        cfg = CFG.replace(quirks=Quirks.CORRECT)
        want = decoder.decode(data, cfg).rgb
        got = stripes_mod.decode_striped(data, cfg, mesh_stripe8)
        np.testing.assert_array_equal(got, want)

    def test_striped_fancy_halo_exchange(self, mesh_stripe8):
        """Fancy upsampling needs the ppermute halo; check stripe output
        equals the single-device fancy path exactly."""
        rng = np.random.default_rng(47)
        img = rng.integers(0, 256, (128, 64, 3), dtype=np.uint8)
        data = encoder.encode(img, EncodeConfig(quality=88, subsampling="420"))
        cfg = CFG.replace(upsample="fancy")
        want = decoder.decode(data, cfg).rgb
        got = stripes_mod.decode_striped(data, cfg, mesh_stripe8)
        np.testing.assert_array_equal(got, want)

    def test_striped_arbitrary_height(self, mesh_stripe8):
        """Non-divisible MCU-row counts decode via padded stripes
        (edge-replicated padding rows, cropped output)."""
        rng = np.random.default_rng(48)
        img = rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)  # 3 MCU rows
        data = encoder.encode(img, EncodeConfig(quality=85, subsampling="444"))
        want = decoder.decode(data, CFG).rgb
        got = stripes_mod.decode_striped(data, CFG, mesh_stripe8)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("h", [112, 123, 128, 200])
    def test_striped_arbitrary_height_420_fancy(self, mesh_stripe8, h):
        """Padded stripes must stay exact for BOTH upsampling rules at the
        real bottom edge. h=112 has no MCU padding inside the planes, so its
        last output row reads the plane's last row's fancy edge."""
        from jpeg_decoder_tpu.utils.config import Quirks

        rng = np.random.default_rng(49)
        img = rng.integers(0, 256, (h, 48, 3), dtype=np.uint8)
        data = encoder.encode(img, EncodeConfig(quality=88, subsampling="420"))
        for cfg in (CFG, CFG.replace(upsample="fancy", quirks=Quirks.CORRECT)):
            want = decoder.decode(data, cfg).rgb
            got = stripes_mod.decode_striped(data, cfg, mesh_stripe8)
            np.testing.assert_array_equal(got, want)

    def test_striped_entropy_segment_groups(self, mesh_stripe8):
        """When DRI covers whole MCU rows, the host entropy stage decodes
        per-stripe segment groups into stripe-local buffers — output must
        stay identical to the whole-image path."""
        import io

        from PIL import Image
        from jpeg_decoder_tpu.io.parser import parse
        from jpeg_decoder_tpu.parallel.stripes import entropy_decode_striped

        rng = np.random.default_rng(50)
        img = rng.integers(0, 256, (200, 64, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img, "RGB").save(
            buf, "JPEG", quality=88, subsampling=2, restart_marker_rows=1
        )
        data = buf.getvalue()
        s = parse(data)
        from jpeg_decoder_tpu.native import runtime as nr

        if not nr.available():
            pytest.skip("native runtime unavailable")
        # striped entropy engages only for the NATIVE backend (the gate
        # honors cfg.entropy_backend — a conformance run configured for
        # ORACLE/NUMPY must not silently get the native decoder)
        ncfg = CFG.replace(entropy_backend=EntropyBackend.NATIVE)
        assert entropy_decode_striped(s, CFG, 8) is None
        striped = entropy_decode_striped(s, ncfg, 8)
        assert striped is not None, "row-aligned DRI should enable striping"
        got = stripes_mod.decode_striped(data, ncfg, mesh_stripe8)
        want = decoder.decode(data, ncfg).rgb
        np.testing.assert_array_equal(got, want)


@pytest.mark.slow  # soak tier; quick coverage stays in TestBatch/TestStream
class TestStreamed:
    """decode_streamed: sequential per-chunk device dispatch (the bounded-
    memory gigapixel path) must be pixel-identical to whole-image decode
    on every geometry, through both entropy routes (chunk-streamed when
    restart rows align, whole-image fallback otherwise)."""

    @pytest.mark.parametrize(
        "sub,h,w,ri",
        [
            ("420", 128, 64, 4),   # aligned DRI -> streamed entropy
            ("420", 123, 64, 0),   # no DRI -> whole-image fallback
            ("444", 64, 48, 6),    # aligned
            ("gray", 77, 40, 5),   # aligned, single component
            ("422", 80, 64, 8),    # aligned, h2x-only sampling
            ("420", 200, 96, 11),  # non-row-aligned DRI -> fallback
        ],
    )
    @pytest.mark.parametrize("n_chunks", [2, 4])
    def test_streamed_matches_single(self, sub, h, w, ri, n_chunks):
        rng = np.random.default_rng(53)
        shape = (h, w) if sub == "gray" else (h, w, 3)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        kw = dict(quality=87, subsampling=sub)
        if ri:
            kw["restart_interval"] = ri
        data = encoder.encode(img, EncodeConfig(**kw))
        want = decoder.decode(data, CFG).rgb
        got = stripes_mod.decode_streamed(data, CFG, n_chunks=n_chunks)
        np.testing.assert_array_equal(got, want)

    def test_streamed_exact_native(self):
        """EXACT precision + native streamed entropy (the gigapixel
        artifact's configuration, scaled down)."""
        from jpeg_decoder_tpu.native import runtime as nr
        from jpeg_decoder_tpu.utils.config import IdctPrecision

        if not nr.available():
            pytest.skip("native runtime unavailable")
        rng = np.random.default_rng(54)
        img = rng.integers(0, 256, (160, 96, 3), dtype=np.uint8)
        data = encoder.encode(
            img,
            EncodeConfig(quality=85, subsampling="420", restart_interval=6),
        )
        cfg = DecodeConfig(
            entropy_backend=EntropyBackend.NATIVE,
            idct_precision=IdctPrecision.EXACT,
        )
        want = decoder.decode(data, cfg).rgb
        got = stripes_mod.decode_streamed(data, cfg, n_chunks=5)
        np.testing.assert_array_equal(got, want)

    def test_streamed_fancy_falls_back(self):
        """Fancy upsampling needs halos: decode_streamed must route to the
        shard_map path and still match the single-device result."""
        rng = np.random.default_rng(55)
        img = rng.integers(0, 256, (128, 64, 3), dtype=np.uint8)
        data = encoder.encode(img, EncodeConfig(quality=88, subsampling="420"))
        cfg = CFG.replace(upsample="fancy")
        want = decoder.decode(data, cfg).rgb
        got = stripes_mod.decode_streamed(data, cfg, n_chunks=4)
        np.testing.assert_array_equal(got, want)

    def test_chunk_stage_compiles_once(self):
        """Every chunk must reuse ONE compiled program (the chunk index is
        traced): recompiling per chunk would make gigapixel decode pay
        n_chunks compiles."""
        rng = np.random.default_rng(56)
        img = rng.integers(0, 256, (128, 64, 3), dtype=np.uint8)
        data = encoder.encode(
            img, EncodeConfig(quality=87, subsampling="420",
                              restart_interval=4)
        )
        stripes_mod.make_chunk_stage.cache_clear()
        stripes_mod.decode_streamed(data, CFG, n_chunks=4)
        info = stripes_mod.make_chunk_stage.cache_info()
        assert info.misses == 1  # one stage built for all 4 chunks
        # ... and that stage lowered exactly once (the chunk index is a
        # traced scalar, not a Python constant baked per chunk):
        from jpeg_decoder_tpu.io.parser import parse
        from jpeg_decoder_tpu.models import decoder as decoder_mod

        s = parse(data, CFG)
        planes, qts = decoder_mod._entropy_decode(s, CFG)
        key = decoder_mod._stage_key(
            s.frame, decoder_mod.qt_by_comp_bytes(s.frame, qts), CFG
        )
        stage = stripes_mod.make_chunk_stage(key, 4)
        assert stage._cache_size() == 1


class TestMesh:
    def test_make_mesh_shapes(self):
        m = mesh_mod.make_mesh(n_data=4, n_stripe=2)
        assert m.shape[mesh_mod.DATA_AXIS] == 4
        assert m.shape[mesh_mod.STRIPE_AXIS] == 2

    def test_make_mesh_too_big(self):
        with pytest.raises(ValueError):
            mesh_mod.make_mesh(n_data=16, n_stripe=2)


class TestStream:
    def test_decode_stream_matches_batch(self, mesh8):
        rng = np.random.default_rng(91)
        datas = [
            encoder.encode(
                rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                EncodeConfig(quality=85),
            )
            for _ in range(20)
        ]
        bd = batch_mod.BatchDecoder(CFG, mesh8)
        want = bd.decode_batch(datas)
        got = np.concatenate(list(bd.decode_stream(datas, batch_size=6)))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    def test_decode_stream_empty(self, mesh8):
        bd = batch_mod.BatchDecoder(CFG, mesh8)
        assert list(bd.decode_stream([])) == []
