"""The persistent compile-cache helper (utils/compile_cache.py), checked in
fresh processes: JAX reads its configuration once per process."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = (
    "import jax\n"
    "from jpeg_decoder_tpu.utils import compile_cache\n"
    "print(compile_cache.enable())\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def _probe(env_dir=None):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    returned, configured = r.stdout.strip().splitlines()[-2:]
    return returned, configured


def test_env_var_is_honoured_and_nothing_else_set(tmp_path):
    returned, configured = _probe(tmp_path / "cache")
    assert returned == str(tmp_path / "cache")
    # JAX took the directory from the environment; the helper did not
    # replace it with its own default.
    assert configured == str(tmp_path / "cache")


def test_default_is_the_same_checkout_path_in_two_processes():
    first = _probe()
    second = _probe()
    want = str(REPO / ".jax_cache")
    assert first == second == (want, want)
