"""Persistent XLA compile cache for the entry points that compile programs.

Every geometry and numeric contract compiles its own device program, and a
4K stage compiles in seconds. JAX's persistent cache keeps the compiled
executables across processes; its key includes the cache path, so the path
must not move between runs.

`enable()` is called by the CLI, `chip_smoke.py` and `bench.py` — not on
package import, so a library user keeps control of JAX's configuration.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache (git-ignored): fixed, never built from a temp name,
# a pid or the time.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> Path:
    """Turn on the persistent compile cache and return its directory.

    With JAX_COMPILATION_CACHE_DIR set, JAX already reads it: nothing else
    is set. Otherwise the cache goes to DEFAULT_DIR.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return Path(env)
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return DEFAULT_DIR
