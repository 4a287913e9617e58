"""Build the native runtime (g++ -> libjdt.so), on demand and cached.

The reference ships a broken makefile (missing maxofthree.asm,
/root/reference/makefile:10,52-53) and a vestigial CMakeLists; here the
native build is a single translation unit compiled straight from Python so
`pip install`-style environments need no separate build step. The compiled
library is cached next to the source, keyed by a hash of the sources, the
flags and the host CPU target, and rebuilt automatically whenever any of
them changes.

CLI: python -m jpeg_decoder_tpu.native.build [--force]
"""

from __future__ import annotations

import functools
import hashlib
import os
import subprocess
import sys
from pathlib import Path

from ..utils.logging import get_logger

log = get_logger("native.build")

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ["jdt_entropy.cpp", "jdt_encode.cpp"]

CXX_FLAGS = [
    "-O3",
    "-std=c++17",
    "-fPIC",
    "-shared",
    "-pthread",
    "-Wall",
    "-fno-math-errno",
]


def _pair_shift_flag() -> str:
    """The pair-table window width lives in core/huffman.PAIR_BITS; the
    kernel's index shift must match or every AC probe misdecodes."""
    from ..core.huffman import PAIR_BITS

    return f"-DJDT_PAIR_SHIFT={64 - PAIR_BITS}"


def _march_flags() -> list[str]:
    return [] if os.environ.get("JPEGTPU_PORTABLE_BUILD") else ["-march=native"]


@functools.lru_cache(maxsize=None)
def _cpu_target() -> str:
    """What -march=native resolves to on this host: the compiler's own
    list of enabled target options. A library built for one host's CPU can
    fault with an illegal instruction on another, so this is part of the
    cache key. Falls back to /proc/cpuinfo's model and flags when the
    compiler cannot be asked."""
    try:
        r = subprocess.run(
            ["g++", *_march_flags(), "-Q", "--help=target"],
            capture_output=True, text=True, timeout=60,
        )
        if r.returncode == 0:
            return r.stdout
    except (OSError, subprocess.TimeoutExpired):
        pass
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return ""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(sorted(set(keep)))


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        p = SRC_DIR / name
        if p.exists():
            h.update(p.read_bytes())
    h.update(" ".join([*CXX_FLAGS, _pair_shift_flag(), *_march_flags()]).encode())
    h.update(_cpu_target().encode())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_DIR / f"libjdt-{_source_hash()}.so"


def build(force: bool = False) -> Path | None:
    """Compile if needed; returns the .so path or None on failure."""
    out = lib_path()
    if out.exists() and not force:
        return out
    srcs = [str(SRC_DIR / s) for s in SOURCES if (SRC_DIR / s).exists()]
    if not srcs:
        log.error("no native sources found under %s", SRC_DIR)
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    march = _march_flags()
    # Compile to a process-unique temp path and atomically rename: multiple
    # processes may build concurrently (multi-host serving), and a reader
    # must never dlopen a half-written .so.
    tmp = out.with_suffix(f".tmp.{os.getpid()}")
    cmd = ["g++", *CXX_FLAGS, _pair_shift_flag(), *march, *srcs, "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.error("native build failed to run: %s", e)
        return None
    if r.returncode != 0:
        log.error("native build failed:\n%s", r.stderr[-4000:])
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    # Drop stale HASH-NAMED builds only: the sanitizer pass
    # (tests/tools/sanitize.sh) parks libjdt-asan.so / libjdt-tsan.so in
    # the same directory, and a concurrent production rebuild must not
    # delete them mid-suite.
    import re

    for old in BUILD_DIR.glob("libjdt-*.so"):
        if old != out and re.fullmatch(r"libjdt-[0-9a-f]{16}\.so", old.name):
            try:
                old.unlink()
            except OSError:
                pass
    log.info("built native runtime: %s", out.name)
    return out


if __name__ == "__main__":
    path = build(force="--force" in sys.argv)
    if path is None:
        sys.exit(1)
    print(path)
