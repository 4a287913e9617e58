"""12-bit extended sequential (SOF1) end-to-end: synthetic streams built
with the writer + entropy packer, decoded through every backend.

Pillow cannot produce 12-bit JPEGs, so the streams are hand-assembled —
which doubles as a writer/packer validation independent of the 8-bit
encoder. The 12-bit numeric rules under test: +2048 level shift / CLAMP_16
/ int16 wrap (reference dct.c:195-203) and the 12->8 rescale
(decode.c:520-525), both already unit-matched to the oracle numerics.
"""

import numpy as np
import pytest

from jpeg_decoder_tpu.core import entropy_encode, huffman, oracle
from jpeg_decoder_tpu.core.types import CoefficientPlanes
from jpeg_decoder_tpu.io import writer
from jpeg_decoder_tpu.io.parser import parse
from jpeg_decoder_tpu.models import decoder
from jpeg_decoder_tpu.utils.config import DecodeConfig, EntropyBackend


def _make_12bit_gray(nb_y=2, nb_x=3, seed=7, restart_interval=0):
    rng = np.random.default_rng(seed)
    n = nb_y * nb_x
    blocks = np.zeros((n, 64), dtype=np.int32)
    # |DC| <= 1023 keeps successive diffs within Annex K's DC categories
    # (<= 11); real 12-bit streams would carry wider custom tables.
    blocks[:, 0] = rng.integers(-1023, 1024, n)
    for i in range(n):
        nz = rng.integers(1, 20)
        pos = rng.choice(np.arange(1, 64), nz, replace=False)
        blocks[i, pos] = rng.integers(-1000, 1000, nz)

    dc_spec = huffman.annex_k_dc_luminance()
    ac_spec = huffman.annex_k_ac_luminance()
    dc_t = huffman.build_encode_table(dc_spec)
    ac_t = huffman.build_encode_table(ac_spec)
    mcu_blocks = [(0, blocks[i]) for i in range(n)]
    entropy = entropy_encode.encode_blocks(
        mcu_blocks, [dc_t], [ac_t], [(0, 0)], 1, restart_interval
    )
    qt = np.full(64, 4, dtype=np.uint16)
    parts = [
        writer.soi(),
        writer.dqt(0, qt),
        writer.sof(nb_x * 8, nb_y * 8, [(1, 1, 1, 0)], precision=12,
                   marker=0xC1),
        writer.dht(dc_spec),
        writer.dht(ac_spec),
    ]
    if restart_interval:
        parts.append(writer.dri(restart_interval))
    parts += [writer.sos([(1, 0, 0)]), entropy, writer.eoi()]
    return b"".join(parts), blocks, qt


def test_12bit_parse_and_coefficients():
    data, blocks, qt = _make_12bit_gray()
    s = parse(data)
    assert s.frame.precision == 12
    planes = CoefficientPlanes(s.frame)
    oracle.decode_sequential_scan(s, s.scans[0], planes)
    np.testing.assert_array_equal(
        planes.plane(0).reshape(-1, 64), blocks
    )


@pytest.mark.parametrize(
    "backend", [EntropyBackend.ORACLE, EntropyBackend.NUMPY,
                EntropyBackend.NATIVE, EntropyBackend.DEVICE]
)
def test_12bit_full_decode_all_backends(backend):
    data, blocks, qt = _make_12bit_gray()
    cfg = DecodeConfig(entropy_backend=backend)
    want = decoder.decode(
        data, DecodeConfig(entropy_backend=EntropyBackend.ORACLE,
                           use_device=False)
    )
    got = decoder.decode(data, cfg)
    np.testing.assert_array_equal(got.rgb, want.rgb)
    assert got.rgb.dtype == np.uint8


def test_12bit_with_restarts():
    data, blocks, qt = _make_12bit_gray(nb_y=4, nb_x=4, restart_interval=4)
    s = parse(data)
    assert s.scans[0].span.num_segments == 4
    planes = CoefficientPlanes(s.frame)
    oracle.decode_sequential_scan(s, s.scans[0], planes)
    np.testing.assert_array_equal(planes.plane(0).reshape(-1, 64), blocks)
