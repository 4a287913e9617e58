"""Test configuration.

Forces JAX onto a virtual 8-device CPU mesh so every device-kernel and
multi-device sharding test runs without an accelerator (SURVEY.md §4:
multi-host logic must be testable on a CPU mesh). The device path on the
GPU is exercised by `python chip_smoke.py`.
"""

import os

# Must be set before jax backends initialize. Force CPU even when a GPU is
# attached: unit tests need fast compiles and must not reserve the card.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import subprocess
from pathlib import Path

import numpy as np
import pytest

REFERENCE_SRC = Path("/root/reference/src")
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache(monkeypatch):
    """Entry points such as cli.main turn on the persistent compile cache
    in the checkout; in-process tests keep JAX's configuration as it was.
    tests/test_compile_cache.py checks the helper in subprocesses."""
    from jpeg_decoder_tpu.utils import compile_cache

    monkeypatch.setattr(compile_cache, "enable", lambda: None)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def ref_harness(tmp_path_factory):
    """Compile the reference decoder + parity harness once per session.

    Skips (rather than fails) when the reference tree or a C toolchain is
    unavailable, so the suite still runs in environments without them.
    """
    if not REFERENCE_SRC.exists():
        pytest.skip("reference source not available")
    build = tmp_path_factory.mktemp("refbuild")
    tus = [
        "decode.c",
        "bitstream.c",
        "frame_header.c",
        "scan_header.c",
        "quant_table.c",
        "huff_table.c",
        "restart_interval.c",
        "dct.c",
        "colour_conversion.c",
    ]
    srcs = [str(REFERENCE_SRC / t) for t in tus]
    exe = build / "ref_harness"
    cmd = [
        "gcc",
        "-O2",
        "-std=c17",
        "-w",
        f"-I{REFERENCE_SRC}",
        str(REPO / "tests" / "tools" / "ref_harness.c"),
        *srcs,
        "-lm",
        "-o",
        str(exe),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        pytest.skip(f"cannot build reference harness: {e}")
    return exe


def run_reference(exe, jpeg_bytes: bytes, tmpdir: Path):
    """Run the compiled reference on jpeg_bytes.

    Returns (planes, rgb) or None if the reference crashed (it has genuine
    segfault bugs on some DRI streams — see test_reference_parity.py).
    """
    import struct

    inp = tmpdir / "in.jpg"
    out = tmpdir / "out.bin"
    inp.write_bytes(jpeg_bytes)
    r = subprocess.run([str(exe), str(inp), str(out)], capture_output=True)
    if r.returncode != 0:
        return None
    b = out.read_bytes()
    off = 0
    ncs, X, Y, prec = struct.unpack_from("<4I", b, off)
    off += 16
    planes = []
    for _ in range(ncs):
        rows, stride = struct.unpack_from("<2I", b, off)
        off += 8
        planes.append(
            np.frombuffer(b, np.uint8, rows * stride, off).reshape(rows, stride)
        )
        off += rows * stride
    (has_rgb,) = struct.unpack_from("<I", b, off)
    off += 4
    rgb = (
        np.frombuffer(b, np.uint8, Y * X * 3, off).reshape(Y, X, 3)
        if has_rgb
        else None
    )
    return planes, rgb
