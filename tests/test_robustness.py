"""Fault-injection / fuzz tests: malformed input must produce structured
errors or a best-effort image — never a crash, hang, or silent exit.

The reference's failure modes under corruption are live memory errors (no
bounds checks anywhere, bitstream.c:10 — it segfaults on some DRI streams,
see test_reference_parity notes) and silent exit(1)s (decode.c:861,868).
This engine's contract: every byte stream either decodes or raises
JpegError, on every backend.
"""

import numpy as np
import pytest

from jpeg_decoder_tpu.models import decoder
from jpeg_decoder_tpu.utils.config import DecodeConfig, EntropyBackend
from jpeg_decoder_tpu.utils.errors import JpegError

from . import corpus

BACKENDS = [
    EntropyBackend.ORACLE,
    EntropyBackend.NUMPY,
    EntropyBackend.NATIVE,
]


def _try_decode(data, backend):
    cfg = DecodeConfig(entropy_backend=backend, use_device=False)
    try:
        img = decoder.decode(data, cfg)
        assert img.rgb is None or img.rgb.dtype == np.uint8
    except JpegError:
        pass  # structured failure is fine
    except (OverflowError, IndexError, ValueError, ZeroDivisionError) as e:
        pytest.fail(f"unstructured {type(e).__name__}: {e}")


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_truncation_ladder(backend):
    name, data = corpus.baseline_corpus()[5]
    for frac in (0.05, 0.3, 0.6, 0.9, 0.99):
        _try_decode(data[: int(len(data) * frac)], backend)


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_random_byte_corruption(backend):
    rng = np.random.default_rng(1)
    name, data = corpus.baseline_corpus()[6]
    for _ in range(25):
        bad = bytearray(data)
        for _k in range(rng.integers(1, 8)):
            bad[rng.integers(2, len(bad))] = rng.integers(0, 256)
        _try_decode(bytes(bad), backend)


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_random_bit_flips_in_entropy_data(backend):
    rng = np.random.default_rng(2)
    name, data = corpus.dri_corpus()[0][1], corpus.dri_corpus()[0][1]
    data = corpus.dri_corpus()[0][1]
    from jpeg_decoder_tpu.io.parser import parse

    s = parse(data)
    span = s.scans[0].span
    for _ in range(25):
        bad = bytearray(data)
        pos = rng.integers(span.start, span.end)
        bad[pos] ^= 1 << rng.integers(0, 8)
        _try_decode(bytes(bad), backend)


def test_garbage_and_empty_inputs():
    rng = np.random.default_rng(3)
    for data in (b"", b"\x00", b"\xff\xd8", b"\xff\xd8\xff\xd9",
                 bytes(rng.integers(0, 256, 1000, dtype=np.uint8).tobytes())):
        _try_decode(data, EntropyBackend.NUMPY)


def test_progressive_corruption():
    rng = np.random.default_rng(4)
    name, data = corpus.progressive_corpus()[3]
    for _ in range(15):
        bad = bytearray(data)
        for _k in range(3):
            bad[rng.integers(2, len(bad))] = rng.integers(0, 256)
        _try_decode(bytes(bad), EntropyBackend.NATIVE)


def test_exotic_sampling_corruption_agreement():
    """Random exotic-sampling shapes under single-bit corruption: every
    backend that decodes successfully must produce bit-identical pixels,
    and clean decodes must agree with the oracle. (Scaled-down version of
    the 120-shape soak recorded in PERF.md; exercises the
    _block_position/scan_layout wrap math on 411/440/mixed samplings.)"""
    from jpeg_decoder_tpu.io.parser import parse
    from jpeg_decoder_tpu.models import encoder
    from jpeg_decoder_tpu.utils.config import EncodeConfig

    rng = np.random.default_rng(31337)
    cfgs = {b: DecodeConfig(entropy_backend=b, use_device=False)
            for b in BACKENDS}
    for _ in range(10):
        sub = str(rng.choice(["411", "440", "mixed", "422", "420"]))
        h, w = int(rng.integers(17, 90)), int(rng.integers(17, 90))
        ri = int(rng.choice([0, 1, 3]))
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        data = encoder.encode(
            arr, EncodeConfig(quality=88, subsampling=sub, restart_interval=ri)
        )
        clean = {b: decoder.decode(data, c).rgb for b, c in cfgs.items()}
        for b in BACKENDS[1:]:
            assert (clean[b] == clean[BACKENDS[0]]).all(), (sub, h, w, ri, b)
        span = parse(data).scans[0].span
        bad = bytearray(data)
        bad[int(rng.integers(span.start, span.end))] ^= 1 << int(
            rng.integers(0, 8)
        )
        outs = []
        for b, c in cfgs.items():
            try:
                outs.append(decoder.decode(bytes(bad), c).rgb)
            except JpegError:
                pass
        for v in outs[1:]:
            assert (v == outs[0]).all(), (sub, h, w, ri)


@pytest.mark.parametrize(
    "backend", [EntropyBackend.DEVICE],
    ids=lambda b: b.value,
)
@pytest.mark.slow  # corruption soak across device backends
def test_device_backends_corruption(backend):
    """The on-device backends under byte corruption: structured errors or
    best-effort output, never an unstructured crash (round-1 gap: fuzzing
    covered only the host backends)."""
    rng = np.random.default_rng(9)
    name, data = corpus.baseline_corpus()[0]
    cfg = DecodeConfig(entropy_backend=backend, use_device=False)
    for _ in range(8):
        bad = bytearray(data)
        for _k in range(rng.integers(1, 5)):
            bad[rng.integers(2, len(bad))] = rng.integers(0, 256)
        try:
            img = decoder.decode(bytes(bad), cfg)
            assert img.rgb is None or img.rgb.dtype == np.uint8
        except JpegError:
            pass
        except (OverflowError, IndexError, ValueError, ZeroDivisionError) as e:
            pytest.fail(f"unstructured {type(e).__name__}: {e}")


@pytest.mark.parametrize(
    "backend", [EntropyBackend.DEVICE],
    ids=lambda b: b.value,
)
def test_device_backends_truncation_ladder(backend):
    name, data = corpus.baseline_corpus()[0]
    cfg = DecodeConfig(entropy_backend=backend, use_device=False)
    for frac in (0.3, 0.7, 0.95):
        try:
            decoder.decode(data[: int(len(data) * frac)], cfg)
        except JpegError:
            pass
        except (OverflowError, IndexError, ValueError, ZeroDivisionError) as e:
            pytest.fail(f"unstructured {type(e).__name__}: {e}")
