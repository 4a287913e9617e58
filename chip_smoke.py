"""Smoke run of the decode and encode path on the GPU, phase by phase.

    python chip_smoke.py             # one card: every single-device phase
    python chip_smoke.py --chips 4   # four cards: the two mesh phases only

Every phase drives the path through the entry points a user calls
(`jt.decode`, `BatchDecoder`, `JpegEncoder`, `decode_striped`) at the
repo's real workload size — 3840x2160 4:2:0 quality-85 noise, one restart
interval per MCU row, plus batches of such images — and compares the
result with a plain reference:

  * pixels: the same stream decoded with DecodeConfig(use_device=False),
    the NumPy oracle pixel path (core/oracle.py, core/numerics.py), which
    shares no code with the device stage;
  * paths whose contract is "within 1 LSB" or "equal up to float rounding":
    the same program jitted on the CPU device in this process.

Inputs are made by this repo's own encoder from fixed seeds, plus the real
photos committed under tests/wild_files/. The script runs in ONE process
(a JAX process reserves most of a card's memory) and refuses to run unless
JAX's default backend is "gpu" — there is no CPU fallback. Findings go to
earlier lines; the last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}, printed
only when every phase passed. A failed phase exits non-zero without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

W, H = 3840, 2160
SEED = 20260816
ROOT = Path(__file__).resolve().parent
WILD_DIR = ROOT / "tests" / "wild_files"

MARKER_DRI = b"\xff\xdd"
MARKER_SOF2 = b"\xff\xc2"


class PhaseError(AssertionError):
    """A phase found a result outside its stated tolerance."""


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def noise_rgb(w: int, h: int, seed: int) -> np.ndarray:
    """Uniform noise, the worst case for the entropy stream."""
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def encode_noise(w: int, h: int, seed: int, *, restart_interval: int = 0,
                 progressive: bool = False) -> bytes:
    """q85 4:2:0 noise JPEG from this repo's encoder (no Pillow)."""
    import jpeg_decoder_tpu as jt

    cfg = jt.EncodeConfig(quality=85, subsampling="420",
                          restart_interval=restart_interval,
                          progressive=progressive)
    return jt.encode(noise_rgb(w, h, seed), cfg)


def header_has(data: bytes, marker: bytes) -> bool:
    """True if `marker` occurs among the segments before the first SOS."""
    sos = data.find(b"\xff\xda")
    return marker in data[: sos if sos >= 0 else len(data)]


@dataclasses.dataclass
class Workload:
    """Sizes of every phase; the defaults are the real workload."""

    w: int = W
    h: int = H
    batch: int = 8
    entropy_side: int = 512
    grid_step: int = 1  # color_grid: every `grid_step`-th byte value
    wild: tuple[Path, ...] = ()

    @property
    def restart_interval(self) -> int:
        return -(-self.w // 16)  # one MCU row of a 4:2:0 frame

    @functools.cached_property
    def dri(self) -> bytes:
        return encode_noise(self.w, self.h, SEED,
                            restart_interval=self.restart_interval)

    @functools.cached_property
    def batch_inputs(self) -> list[bytes]:
        return [
            encode_noise(self.w, self.h, SEED + 1 + i,
                         restart_interval=self.restart_interval)
            for i in range(self.batch)
        ]


def all_wild_files() -> tuple[Path, ...]:
    return tuple(sorted(WILD_DIR.glob("*.jpg"))
                 + sorted((WILD_DIR / "transcoded").glob("*.jpg")))


# ---------------------------------------------------------------------------
# Comparisons and timing
# ---------------------------------------------------------------------------


def assert_equal(what: str, got: np.ndarray, want: np.ndarray) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise PhaseError(f"{what}: shape {got.shape} != {want.shape}")
    if not np.array_equal(got, want):
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        raise PhaseError(
            f"{what}: {int((d > 0).sum())} of {d.size} values differ, "
            f"max {int(d.max())}"
        )


def assert_within(what: str, got: np.ndarray, want: np.ndarray,
                  tol: int = 1) -> float:
    """Max |got - want| <= tol; returns the fraction of values that differ."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise PhaseError(f"{what}: shape {got.shape} != {want.shape}")
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    if d.size and d.max() > tol:
        raise PhaseError(f"{what}: max difference {int(d.max())} > {tol}")
    return float((d > 0).mean()) if d.size else 0.0


def timed(fn):
    """(result, seconds) of one call; `fn` must return host-side data or
    block until its device work is done."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def cold_warm(fn):
    """Call twice: the first call includes compilation. Returns
    (second result, cold seconds, warm seconds)."""
    _, cold = timed(fn)
    out, warm = timed(fn)
    return out, cold, warm


def median_time(fn, reps: int = 5) -> float:
    fn()
    ts = [timed(fn)[1] for _ in range(reps)]
    return float(np.median(ts))


def _cpu_device():
    import jax

    return jax.devices("cpu")[0]


# ---------------------------------------------------------------------------
# Single-device phases. Each returns (info, cold_s, warm_s).
# ---------------------------------------------------------------------------


def _check_vs_host(data: bytes, cfg, img) -> None:
    """A device decode against the use_device=False oracle decode of the
    same stream, bit for bit."""
    import jpeg_decoder_tpu as jt

    ref = jt.decode(data, cfg.replace(use_device=False))
    assert_equal("rgb vs use_device=False", img.rgb, ref.rgb)
    for ci, (p, q) in enumerate(zip(img.planes, ref.planes)):
        assert_equal(f"pixel plane {ci} vs use_device=False", p, q)


def _device_vs_host(data: bytes, cfg):
    """The device decode (cold and warm), checked against the host."""
    import jpeg_decoder_tpu as jt

    img, cold, warm = cold_warm(lambda: jt.decode(data, cfg))
    _check_vs_host(data, cfg, img)
    return img, cold, warm


def stage_ms(data: bytes, cfg) -> float:
    """Warm median of the jitted device stage alone, planes already on
    the device (compile excluded)."""
    import jax

    from jpeg_decoder_tpu.models import decoder

    frame, planes, qts = decoder.host_decode(data, cfg)
    stage = decoder.device_stage_for(frame, qts, cfg)
    dev = [jax.device_put(np.asarray(p)) for p in planes]
    return 1e3 * median_time(
        lambda: jax.block_until_ready(stage(*dev)), reps=9
    )


def fma_contraction() -> dict:
    """Does XLA fuse `a*b + c*d` into an FMA on this device? Inputs are
    chosen so that the unfused result is exactly 0 and a fused one is not
    (a*b is inexact, c*d exact). EXACT is bit-exact either way only if its
    tests pass; this says which case the card is in."""
    import jax
    import jax.numpy as jnp

    from jpeg_decoder_tpu.ops import f64

    def probe(dtype, eps_bits):
        one = np.ones(1024, dtype)
        a = one * (1 + dtype(2.0) ** -eps_bits)
        c = -one * (1 + dtype(2.0) ** -(eps_bits - 1))
        fn = jax.jit(lambda a, b, c, d: a * b + c * d)
        out = np.asarray(fn(a, a, c, one))
        return bool(np.any(out != 0))

    f32 = probe(np.float32, 12)
    with f64.x64():
        f64_fused = probe(np.float64, 27)
    return {"fma_f32": f32, "fma_f64": f64_fused}


def phase_exact_dri(wl: Workload):
    import jpeg_decoder_tpu as jt

    if not header_has(wl.dri, MARKER_DRI):
        raise PhaseError("input has no DRI segment")
    cfg = jt.DecodeConfig()
    _, cold, warm = _device_vs_host(wl.dri, cfg)
    info = {"stage_ms": round(stage_ms(wl.dri, cfg), 3),
            "bytes": len(wl.dri)}
    info.update(fma_contraction())
    return info, cold, warm


def phase_exact_nodri(wl: Workload):
    import jpeg_decoder_tpu as jt

    data = encode_noise(wl.w, wl.h, SEED)
    if header_has(data, MARKER_DRI):
        raise PhaseError("input unexpectedly has a DRI segment")
    _, cold, warm = _device_vs_host(data, jt.DecodeConfig())
    return {"bytes": len(data)}, cold, warm


def phase_exact_progressive(wl: Workload):
    import jpeg_decoder_tpu as jt

    data = encode_noise(wl.w, wl.h, SEED, progressive=True)
    if not header_has(data, MARKER_SOF2):
        raise PhaseError("input is not progressive (no SOF2)")
    _, cold, warm = _device_vs_host(data, jt.DecodeConfig())
    return {"bytes": len(data)}, cold, warm


def phase_wild(wl: Workload):
    """Every wild file under EXACT with both quirk sets and both
    upsamplers. Each (file, config) is its own device program, so the cold
    pass compiles them from a thread pool; the warm pass is serial."""
    import concurrent.futures as cf

    import jpeg_decoder_tpu as jt

    files = wl.wild or all_wild_files()
    if not files:
        raise PhaseError(f"no wild files under {WILD_DIR}")
    jobs = [
        (path, path.read_bytes(), jt.DecodeConfig(quirks=q, upsample=u))
        for path in files
        for q in (jt.Quirks.REFERENCE, jt.Quirks.CORRECT)
        for u in ("nn", "fancy")
    ]

    def device(job):
        return jt.decode(job[1], job[2])

    with cf.ThreadPoolExecutor(max_workers=8) as ex:
        _, cold = timed(lambda: list(ex.map(device, jobs)))
    imgs, warm = timed(lambda: [device(j) for j in jobs])
    for (path, data, cfg), img in zip(jobs, imgs):
        try:
            _check_vs_host(data, cfg, img)
        except PhaseError as e:
            raise PhaseError(
                f"{path.name} {cfg.quirks.value}/{cfg.upsample}: {e}"
            ) from None
    return {"files": len(files), "decodes": len(jobs)}, cold, warm


def phase_color_grid(wl: Workload):
    """The device EXACT YCbCr->RGB over every (y, cb, cr) byte triple (or
    every grid_step-th value per axis) against core/numerics."""
    import jax
    import jax.numpy as jnp

    from jpeg_decoder_tpu.core import numerics
    from jpeg_decoder_tpu.ops import color as color_ops
    from jpeg_decoder_tpu.utils.config import Quirks

    vals = np.arange(0, 256, wl.grid_step, dtype=np.uint8)
    n = vals.size
    y8 = np.broadcast_to(vals[:, None, None], (n, n, n))
    cb8 = np.broadcast_to(vals[None, :, None], (n, n, n))
    cr8 = np.broadcast_to(vals[None, None, :], (n, n, n))
    cold = warm = 0.0
    for quirks in (Quirks.REFERENCE, Quirks.CORRECT):
        fn = jax.jit(functools.partial(
            color_ops.ycbcr_to_rgb, exact=True, quirks=quirks))
        dev = [jnp.asarray(v) for v in (vals, vals, vals)]

        def run():
            y = jnp.broadcast_to(dev[0][:, None, None], (n, n, n))
            cb = jnp.broadcast_to(dev[1][None, :, None], (n, n, n))
            cr = jnp.broadcast_to(dev[2][None, None, :], (n, n, n))
            return np.asarray(fn(y, cb, cr))

        got, c, w_ = cold_warm(run)
        cold += c
        warm += w_
        want = numerics.ycbcr_channels_to_rgb(y8, cb8, cr8, quirks)
        assert_equal(f"color grid {quirks.value}", got, want)
    return {"triples": int(n ** 3)}, cold, warm


def phase_float32(wl: Workload):
    """FLOAT32's contract is the IDCT output: pixel planes within 1 LSB of
    EXACT. The colour transform then scales a 1-LSB luma plus chroma
    difference by up to 1 + 1.772, so RGB may differ by up to 3."""
    import jpeg_decoder_tpu as jt

    exact = jt.decode(wl.dri, jt.DecodeConfig())
    cfg = jt.DecodeConfig(idct_precision=jt.IdctPrecision.FLOAT32)
    img, cold, warm = cold_warm(lambda: jt.decode(wl.dri, cfg))
    info = {}
    for ci, (p, q) in enumerate(zip(img.planes, exact.planes)):
        info[f"plane{ci}_frac_differ"] = assert_within(
            f"FLOAT32 plane {ci} vs EXACT", p, q, 1)
    info["rgb_frac_differ"] = assert_within(
        "FLOAT32 rgb vs EXACT", img.rgb, exact.rgb, 3)
    info["rgb_max_differ"] = int(np.abs(
        img.rgb.astype(np.int64) - exact.rgb.astype(np.int64)).max())
    info["stage_ms"] = round(stage_ms(wl.dri, cfg), 3)
    return info, cold, warm


def phase_scaled(wl: Workload):
    """scale 1, 2, 4 on the device against the same stage jitted on the
    CPU device (the scaled IDCT is a float32 matmul: pixel planes <= 1
    LSB, RGB <= 3)."""
    import jax

    import jpeg_decoder_tpu as jt
    from jpeg_decoder_tpu.models import decoder

    cpu = _cpu_device()
    cold = warm = 0.0
    info = {}
    for scale in (1, 2, 4):
        cfg = jt.DecodeConfig(scale=scale)
        img, c, w_ = cold_warm(lambda: jt.decode(wl.dri, cfg))
        cold += c
        warm += w_
        frame, planes, qts = decoder.host_decode(wl.dri, cfg)
        key = decoder._stage_key(
            frame, decoder.qt_by_comp_bytes(frame, qts), cfg)
        stage = jax.jit(decoder.build_stage_raw(key))
        want, want_planes = stage(
            *[jax.device_put(np.asarray(p), cpu) for p in planes])
        want = np.asarray(want)
        want_planes = [np.asarray(p) for p in want_planes]
        want_shape = (-(-wl.h * scale // 8), -(-wl.w * scale // 8), 3)
        if img.rgb.shape != want_shape:
            raise PhaseError(f"scale {scale}: shape {img.rgb.shape}")
        # The IDCT output (pixel planes) is within 1 LSB; the colour
        # transform scales that by up to 1 + 1.772 in RGB.
        for ci, (p, q) in enumerate(zip(img.planes, want_planes)):
            assert_within(f"scale {scale}/8 plane {ci} vs CPU", p, q, 1)
        info[f"rgb_frac_differ_{scale}_8"] = assert_within(
            f"scale {scale}/8 rgb vs CPU", img.rgb, want, 3)
    return info, cold, warm


def phase_batch(wl: Workload):
    import jpeg_decoder_tpu as jt
    from jpeg_decoder_tpu.models import decoder
    from jpeg_decoder_tpu.parallel.batch import BatchDecoder

    datas = wl.batch_inputs
    bd = BatchDecoder()
    got, cold, warm = cold_warm(lambda: bd.decode_batch(datas))
    for i, d in enumerate(datas):
        assert_equal(f"batch image {i}", got[i], jt.decode(d).rgb)
    _frame, planes, _qts = decoder.host_decode(datas[0])
    coeff_mb = len(datas) * sum(p.nbytes for p in planes) / 1e6
    return {"images": len(datas), "coeff_mb_in": round(coeff_mb, 1),
            "rgb_mb_out": round(got.nbytes / 1e6, 1)}, cold, warm


def phase_encode(wl: Workload):
    """JpegEncoder on the device; its quantized coefficients against the
    same FDCT stage jitted on the CPU device, and the bytes round-tripped
    through jt.decode."""
    import jax
    import jax.numpy as jnp

    import jpeg_decoder_tpu as jt
    from jpeg_decoder_tpu.models import decoder, encoder

    rgb = noise_rgb(wl.w, wl.h, SEED)
    cfg = jt.EncodeConfig(quality=85, subsampling="420",
                          restart_interval=wl.restart_interval)
    enc = encoder.JpegEncoder(cfg)
    data, cold, warm = cold_warm(lambda: enc.encode(rgb))
    qt_l, qt_c = encoder.quality_qtables(85)
    stage, _f, _g = encoder._build_device_stage(
        wl.h, wl.w, "420", (qt_l.tobytes(), qt_c.tobytes()), False)
    dev = [np.asarray(c) for c in stage(jnp.asarray(rgb))]
    cpu = [np.asarray(c)
           for c in stage(jax.device_put(rgb, _cpu_device()))]
    n_diff = n_all = 0
    for ci, (a, b) in enumerate(zip(dev, cpu)):
        assert_within(f"coefficients comp {ci} vs CPU", a, b, 1)
        n_diff += int((a != b).sum())
        n_all += a.size
    # The stream carries exactly the device's coefficients ...
    _frame, planes, _qts = decoder.host_decode(data)
    for ci, (p, c) in enumerate(zip(planes, dev)):
        assert_equal(f"entropy-decoded comp {ci} vs device FDCT", p, c)
    # ... and decodes on the device as on the host.
    img = jt.decode(data)
    if img.rgb.shape != (wl.h, wl.w, 3):
        raise PhaseError(f"round trip shape {img.rgb.shape}")
    ref = jt.decode(data, jt.DecodeConfig(use_device=False))
    assert_equal("round trip vs use_device=False", img.rgb, ref.rgb)
    return {"bytes": len(data), "coeff_frac_differ_cpu": n_diff / n_all,
            "coeff_differ_count": n_diff}, cold, warm


def phase_device_entropy(wl: Workload):
    """EntropyBackend.DEVICE (the XLA while_loop decoder) on a small DRI
    stream against the NATIVE coefficient planes; its rate is the plain
    baseline a GPU entropy kernel has to beat."""
    import jpeg_decoder_tpu as jt
    from jpeg_decoder_tpu.models import decoder

    side = wl.entropy_side
    data = encode_noise(side, side, SEED, restart_interval=-(-side // 16))
    structure = jt.parse(data)
    dev_cfg = jt.DecodeConfig(entropy_backend=jt.EntropyBackend.DEVICE)
    (got, _q), cold, warm = cold_warm(
        lambda: decoder._entropy_decode(structure, dev_cfg))
    want, _q = decoder._entropy_decode(structure, jt.DecodeConfig())
    for ci, (a, b) in enumerate(zip(got, want)):
        assert_equal(f"DEVICE vs NATIVE comp {ci}", a, b)
    return {"side": side, "mp_per_s": side * side / warm / 1e6}, cold, warm


SINGLE_PHASES = [
    ("exact_dri", phase_exact_dri),
    ("exact_nodri", phase_exact_nodri),
    ("exact_progressive", phase_exact_progressive),
    ("wild", phase_wild),
    ("color_grid", phase_color_grid),
    ("float32", phase_float32),
    ("scaled", phase_scaled),
    ("batch", phase_batch),
    ("encode", phase_encode),
    ("device_entropy", phase_device_entropy),
]


# ---------------------------------------------------------------------------
# Mesh phases (--chips 4)
# ---------------------------------------------------------------------------


def phase_mesh_batch(wl: Workload, n: int):
    """BatchDecoder over a data-parallel mesh of n devices against
    single-device decodes of each image."""
    import jpeg_decoder_tpu as jt
    from jpeg_decoder_tpu.parallel import mesh as mesh_mod
    from jpeg_decoder_tpu.parallel.batch import BatchDecoder

    datas = wl.batch_inputs
    bd = BatchDecoder(mesh=mesh_mod.make_mesh(n_data=n))
    got, cold, warm = cold_warm(lambda: bd.decode_batch(datas))
    for i, d in enumerate(datas):
        assert_equal(f"mesh batch image {i}", got[i], jt.decode(d).rgb)
    return {"devices": n, "images": len(datas)}, cold, warm


def phase_mesh_striped(wl: Workload, n: int):
    """decode_striped over n stripes (ppermute halo exchange under fancy
    upsampling) against the one-device decode."""
    import jpeg_decoder_tpu as jt
    from jpeg_decoder_tpu.parallel import mesh as mesh_mod
    from jpeg_decoder_tpu.parallel import stripes

    mesh = mesh_mod.make_mesh(n_data=1, n_stripe=n)
    cold = warm = 0.0
    for upsample in ("fancy", "nn"):
        cfg = jt.DecodeConfig(upsample=upsample)
        got, c, w_ = cold_warm(
            lambda: stripes.decode_striped(wl.dri, cfg, mesh))
        cold += c
        warm += w_
        assert_equal(f"striped {upsample}", got, jt.decode(wl.dri, cfg).rgb)
    return {"devices": n}, cold, warm


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0].strip()


def run_phases(phases, card: str) -> None:
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            info, cold, warm = fn()
        except Exception as e:
            print(f"phase {name}: FAILED after "
                  f"{time.perf_counter() - t0:.1f} s: "
                  f"{type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
            raise
        print(f"phase {name}: ok  cold {cold:.3f} s  warm {warm:.3f} s  "
              f"[{card}]  {json.dumps(info)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=[1, 4],
                    help="4: run only the mesh phases over four cards")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX's default backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    devices = jax.devices()
    if len(devices) < args.chips:
        print(f"--chips {args.chips} needs {args.chips} GPUs, JAX sees "
              f"{len(devices)}", file=sys.stderr)
        return 2

    import jaxlib

    from jpeg_decoder_tpu.native import runtime as native_runtime
    from jpeg_decoder_tpu.utils import compile_cache

    cache_dir = compile_cache.enable()
    card = card_line()
    dev = devices[0]
    print(f"card: {card}; device_kind {dev.device_kind}; jax {jax.__version__}"
          f" jaxlib {jaxlib.__version__}; default_matmul_precision "
          f"{jax.config.jax_default_matmul_precision}; compile cache "
          f"{cache_dir}", flush=True)
    if not native_runtime.available():
        print("native runtime unavailable: the host stage would be the "
              "NumPy fallback", file=sys.stderr)
        return 1

    wl = Workload()
    t0 = time.perf_counter()
    if args.chips == 1:
        phases = [(n, functools.partial(fn, wl)) for n, fn in SINGLE_PHASES]
    else:
        phases = [
            ("mesh_batch", functools.partial(phase_mesh_batch, wl, 4)),
            ("mesh_striped", functools.partial(phase_mesh_striped, wl, 4)),
        ]
    try:
        run_phases(phases, card)
    except Exception:
        return 1
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
