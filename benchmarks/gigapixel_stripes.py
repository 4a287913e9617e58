"""Gigapixel decode demo: one huge scan at bounded memory.

The long-context analogue (SURVEY.md §5): ONE huge scan, entropy-decoded
as stripe-aligned restart-segment groups on the host and dequant+IDCT+
color dispatched per MCU-row chunk. The default engine is the r4
STREAMED path (parallel.stripes.decode_streamed): sequential chunk
dispatch through one compiled program keeps a single chunk's f32
intermediates live, so peak RSS ~ output + one chunk — the r3 shard_map
engine materialized ALL intermediates (19 GB for 0.537 GP) and is kept
as a comparison run. Run on CPU:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/gigapixel_stripes.py [--height 122880]

Add --gpu (parent still under JAX_PLATFORMS=cpu) for an EXACT run of the
chunk programs on the GPU, checked against the CPU EXACT run's digest.

Writes benchmarks/GIGAPIXEL.json with sizes, stage timings, an output
digest (identical across engines and input modes by assertion), and the
peak-RSS comparison of the two input paths:

  * bytes  — whole file read into memory (the r2 behavior);
  * memmap — np.memmap streaming input (models/decoder.decode_file's
    mechanism; reference analogue jpeg_decoder.c:143-177): bytes page in
    lazily and the OS can evict them, so peak RSS is bounded by
    planes + output rather than file + planes + output.

Each decode runs in a SUBPROCESS so ru_maxrss is a clean per-path
high-water mark (the parent's encode allocates the full source image and
would mask it). Correctness of the striped path vs the whole-image path is
covered at test scale by tests/test_parallel.py::TestStripes; this
artifact proves the gigapixel capability (memory-scalable stripes,
arbitrary heights, streaming input).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax


def _decode_child(path: str, input_mode: str, engine: str,
                  device_stage: str = "cpu",
                  precision: str = "float32") -> int:
    """Subprocess body: decode `path`, print one JSON line.

    engine:
      * striped  — the r2/r3 shard_map path: whole-image device program
        over the virtual mesh (materializes ALL f32 intermediates — the
        19 GB peak for 0.537 GP);
      * streamed — sequential per-chunk dispatch
        (parallel.stripes.decode_streamed): peak RSS bounded by the
        output + one chunk, the r3-verdict-item-5 fix.
    """
    from jpeg_decoder_tpu.parallel import mesh as mesh_mod
    from jpeg_decoder_tpu.parallel import stripes
    from jpeg_decoder_tpu.utils.config import DecodeConfig, IdctPrecision

    if input_mode == "memmap":
        data = np.memmap(path, dtype=np.uint8, mode="r")
    else:
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
    cfg = DecodeConfig(
        idct_precision=(
            IdctPrecision.EXACT if precision == "exact"
            else IdctPrecision.FLOAT32
        )
    )
    platform = jax.devices()[0].platform
    if platform != device_stage:
        print(f"device stage {device_stage!r} asked for, JAX found "
              f"{platform!r}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if engine == "streamed":
        rgb = stripes.decode_streamed(data, cfg)
        h, w = int(rgb.shape[0]), int(rgb.shape[1])
        digest_src = rgb[::997]
    else:
        mesh = mesh_mod.make_mesh(n_data=1, n_stripe=len(jax.devices()))
        rgb = stripes.decode_striped(data, cfg, mesh)
        h, w = int(rgb.shape[0]), int(rgb.shape[1])
        digest_src = rgb[::997]
    t_dec = time.perf_counter() - t0
    digest = hashlib.sha256(np.ascontiguousarray(digest_src)).hexdigest()[:16]
    peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    print(json.dumps({
        "input_mode": input_mode,
        "engine": engine,
        "device_stage": device_stage,
        "precision": precision,
        "platform": jax.devices()[0].platform,
        "decode_s": round(t_dec, 2),
        "peak_rss_mb": round(peak_mb, 0),
        "output_digest": digest,
        "h": h, "w": w,
    }))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    # SOF dimension fields are uint16 (spec B.2.2): stay <= 65535/side.
    ap.add_argument("--width", type=int, default=16384)
    ap.add_argument("--height", type=int, default=32768)  # 0.537 GP
    ap.add_argument("--quality", type=int, default=85)
    ap.add_argument("--decode-only", default=None, help="(internal) child")
    ap.add_argument("--input-mode", default="memmap",
                    choices=["memmap", "bytes"])
    ap.add_argument("--engine", default="streamed",
                    choices=["streamed", "striped"])
    ap.add_argument("--device-stage", default="cpu", choices=["cpu", "gpu"],
                    help="(child) platform the chunk device programs must "
                         "run on")
    ap.add_argument("--precision", default="float32",
                    choices=["float32", "exact"])
    ap.add_argument("--skip-striped", action="store_true",
                    help="skip the whole-image shard_map comparison run "
                         "(it needs ~35x the output in RAM)")
    ap.add_argument("--gpu", action="store_true",
                    help="add an EXACT device-stage run on the GPU; its "
                         "digest must match the CPU EXACT run's")
    ap.add_argument("--out", default="GIGAPIXEL.json",
                    help="artifact filename (written next to this script)")
    ap.add_argument("--input", default=None,
                    help="reuse an existing generated stream (the encode "
                         "of the deterministic source takes ~20 min at "
                         "0.5 GP on this host) instead of re-encoding; "
                         "width/height must match the file")
    args = ap.parse_args()
    if args.decode_only:
        return _decode_child(args.decode_only, args.input_mode, args.engine,
                             args.device_stage, args.precision)

    from jpeg_decoder_tpu.models import encoder
    from jpeg_decoder_tpu.io.parser import parse
    from jpeg_decoder_tpu.parallel import stripes
    from jpeg_decoder_tpu.utils.config import (
        DecodeConfig, EncodeConfig, IdctPrecision,
    )

    w, h = args.width, args.height
    px = w * h
    if args.input:
        path = os.path.abspath(args.input)
        file_mb = os.path.getsize(path) / 1e6
        data = np.memmap(path, dtype=np.uint8, mode="r")
        print(f"# reusing {path} ({file_mb:.0f} MB)",
              file=sys.stderr, flush=True)
    else:
        print(f"# generating {w}x{h} ({px/1e9:.3f} GP) 4:2:0 q{args.quality}",
              file=sys.stderr, flush=True)
        rng = np.random.default_rng(20260817)
        tile = rng.integers(0, 256, (512, w, 3), dtype=np.uint8)
        img = np.broadcast_to(tile, (h // 512, 512, w, 3)).reshape(h, w, 3)

        mcus_x = -(-w // 16)
        t0 = time.perf_counter()
        data = encoder.encode(
            img,
            EncodeConfig(quality=args.quality, subsampling="420",
                         restart_interval=mcus_x),
        )
        t_enc = time.perf_counter() - t0
        print(f"# encoded: {len(data)/1e6:.0f} MB in {t_enc:.1f}s",
              file=sys.stderr, flush=True)
        del img
        # Write the stream to disk; decode in subprocesses (clean peak-RSS).
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            ".gigapixel_input.jpg")
        with open(path, "wb") as f:
            f.write(data)
        file_mb = len(data) / 1e6

    cfg = DecodeConfig(idct_precision=IdctPrecision.FLOAT32)
    s = parse(data)  # parse consumes bytes and memmaps alike (decode_file)
    if (s.frame.width, s.frame.height) != (w, h):
        print(f"input is {s.frame.width}x{s.frame.height}, args say {w}x{h}",
              file=sys.stderr)
        return 1
    # Cheap alignment check (the plan does NOT decode anything).
    entropy_striped = stripes._striped_entropy_plan(s, cfg, 16) is not None
    del s, data

    combos = [
        ("streamed", "memmap", "cpu", "float32"),
        ("streamed", "bytes", "cpu", "float32"),
    ]
    if not args.skip_striped:
        combos.append(("striped", "memmap", "cpu", "float32"))
    if args.gpu:
        # EXACT is the tier designed to be bit-identical host==device;
        # FLOAT32's matmul rounding may legitimately differ CPU vs GPU.
        # Pair the GPU run with a CPU EXACT run so the digest check is
        # apples-to-apples.
        combos.append(("streamed", "memmap", "cpu", "exact"))
        combos.append(("streamed", "memmap", "gpu", "exact"))
    runs = {}
    for engine, mode, dstage, prec in combos:
        env = dict(os.environ)
        if dstage == "gpu":  # the child alone opens the card
            env.pop("JAX_PLATFORMS", None)
            env.pop("XLA_FLAGS", None)
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--decode-only", path, "--input-mode", mode,
             "--engine", engine, "--device-stage", dstage,
             "--precision", prec,
             "--width", str(w), "--height", str(h)],
            env=env, capture_output=True, text=True, timeout=3600,
        )
        if r.returncode != 0:
            print(r.stderr[-2000:], file=sys.stderr)
            return 1
        runs[engine, mode, dstage, prec] = json.loads(
            r.stdout.strip().splitlines()[-1]
        )
        print(f"# {engine}/{mode}/{dstage}/{prec}: "
              f"{runs[engine, mode, dstage, prec]}",
              file=sys.stderr, flush=True)
    if not args.input:
        os.unlink(path)

    # Digest equality within each precision tier (FLOAT32 engines/input
    # modes must agree; EXACT must agree across CPU and GPU).
    for prec in ("float32", "exact"):
        digests = {
            r["output_digest"] for k, r in runs.items() if k[3] == prec
        }
        if len(digests) > 1:
            print(f"DIGEST MISMATCH within {prec} runs: {runs}",
                  file=sys.stderr)
            return 1

    m = runs["streamed", "memmap", "cpu", "float32"]
    result = {
        "artifact": "gigapixel_striped_decode",
        "width": w,
        "height": h,
        "gigapixels": round(px / 1e9, 3),
        "file_mb": round(file_mb, 1),
        "engine": "streamed",
        "entropy_striped": bool(entropy_striped),
        "decode_s": m["decode_s"],
        "mp_per_s": round(px / m["decode_s"] / 1e6, 1),
        "peak_rss_mb_memmap": m["peak_rss_mb"],
        "peak_rss_mb_bytes": runs[
            "streamed", "bytes", "cpu", "float32"]["peak_rss_mb"],
        "platform": jax.devices()[0].platform,
        "output_digest": m["output_digest"],
    }
    if ("striped", "memmap", "cpu", "float32") in runs:
        s = runs["striped", "memmap", "cpu", "float32"]
        result["whole_image_comparison"] = {
            "engine": "striped (r3 shard_map, all intermediates live)",
            "decode_s": s["decode_s"],
            "peak_rss_mb": s["peak_rss_mb"],
        }
    if ("streamed", "memmap", "gpu", "exact") in runs:
        t = runs["streamed", "memmap", "gpu", "exact"]
        ce = runs["streamed", "memmap", "cpu", "exact"]
        result["gpu_device_stage"] = {
            "platform": t["platform"],
            "precision": "exact",
            "decode_s": t["decode_s"],
            "peak_rss_mb": t["peak_rss_mb"],
            "digest_matches_cpu_exact":
                t["output_digest"] == ce["output_digest"],
            "cpu_exact_decode_s": ce["decode_s"],
        }
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       args.out)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
