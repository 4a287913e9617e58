"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its input
builders and phase comparisons pass at a small size on the virtual CPU
devices (the same code the GPU run executes at 3840x2160)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_to_run_on_cpu():
    r = _run(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_bench_refuses_to_run_on_cpu():
    r = _run(REPO, REPO / "bench.py")
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.fixture(scope="module")
def small():
    # h=112: 7 MCU rows, so four stripes pad the planes (the fancy bottom
    # edge case) and the planes carry no MCU padding of their own.
    return cs.Workload(w=256, h=112, batch=3, entropy_side=64,
                       grid_step=17, wild=cs.all_wild_files()[:2])


def test_input_builders_mark_the_stream(small):
    assert cs.header_has(small.dri, cs.MARKER_DRI)
    nodri = cs.encode_noise(small.w, small.h, cs.SEED)
    assert not cs.header_has(nodri, cs.MARKER_DRI)
    prog = cs.encode_noise(small.w, small.h, cs.SEED, progressive=True)
    assert cs.header_has(prog, cs.MARKER_SOF2)
    assert not cs.header_has(small.dri, cs.MARKER_SOF2)


@pytest.mark.parametrize("name,phase", cs.SINGLE_PHASES,
                         ids=[n for n, _ in cs.SINGLE_PHASES])
def test_single_device_phase(small, name, phase):
    info, cold, warm = phase(small)
    assert isinstance(info, dict) and cold >= 0 and warm >= 0


@pytest.mark.parametrize("phase", [cs.phase_mesh_batch,
                                   cs.phase_mesh_striped],
                         ids=["mesh_batch", "mesh_striped"])
def test_four_device_phase(small, phase):
    info, _cold, _warm = phase(small, 4)
    assert info["devices"] == 4


def test_assertions_catch_a_mismatch():
    import numpy as np

    a = np.zeros((4, 4), np.uint8)
    b = a.copy()
    b[1, 2] = 2
    with pytest.raises(cs.PhaseError):
        cs.assert_equal("x", a, b)
    with pytest.raises(cs.PhaseError):
        cs.assert_within("x", a, b, 1)
    b[1, 2] = 1
    assert cs.assert_within("x", a, b, 1) == 1 / 16
