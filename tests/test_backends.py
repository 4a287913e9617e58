"""Entropy backends offered after the TPU-only lockstep kernel went: the
enum, the CLI choices, BatchDecoder on each, and the native build key."""

import numpy as np
import pytest

from jpeg_decoder_tpu import cli
from jpeg_decoder_tpu.models import decoder, encoder
from jpeg_decoder_tpu.parallel.batch import BatchDecoder
from jpeg_decoder_tpu.utils.config import (
    DecodeConfig, EncodeConfig, EntropyBackend,
)


def test_entropy_backends_are_the_four_kept():
    assert {b.value for b in EntropyBackend} == {
        "native", "numpy", "oracle", "device"
    }


def test_cli_backend_choices_exclude_pallas(capsys):
    parser = cli.build_parser()
    args = parser.parse_args(["decode", "in.jpg", "out.png",
                              "--backend", "device"])
    assert args.backend == "device"
    with pytest.raises(SystemExit):
        parser.parse_args(["decode", "in.jpg", "out.png",
                           "--backend", "pallas"])
    assert "pallas" not in capsys.readouterr().err.split("choose from")[-1]


@pytest.fixture(scope="module")
def batch_inputs():
    rng = np.random.default_rng(5)
    cfg = EncodeConfig(quality=85, subsampling="420", restart_interval=2)
    return [
        encoder.encode(rng.integers(0, 256, (48, 64, 3), np.uint8), cfg)
        for _ in range(3)
    ]


@pytest.mark.parametrize("backend", list(EntropyBackend),
                         ids=lambda b: b.value)
def test_batch_decoder_with_each_backend(batch_inputs, backend):
    cfg = DecodeConfig(entropy_backend=backend)
    got = BatchDecoder(cfg).decode_batch(batch_inputs)
    assert got.shape == (3, 48, 64, 3)
    for i, d in enumerate(batch_inputs):
        np.testing.assert_array_equal(got[i], decoder.decode(d).rgb)


def test_native_build_is_keyed_on_the_cpu_target(monkeypatch):
    from jpeg_decoder_tpu.native import build

    monkeypatch.setattr(build, "_cpu_target", lambda: "cpu-a")
    a = build.lib_path()
    monkeypatch.setattr(build, "_cpu_target", lambda: "cpu-b")
    assert build.lib_path() != a
