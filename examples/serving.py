"""Serving example: sustained batch decode over a device mesh.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/serving.py

On a GPU host, drop the env vars — the mesh spans the real cards; across
hosts, call parallel.multihost.initialize() first and the same code shards
globally.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

from jpeg_decoder_tpu.models import encoder
from jpeg_decoder_tpu.parallel import batch, mesh
from jpeg_decoder_tpu.utils.config import DecodeConfig, EncodeConfig
from jpeg_decoder_tpu.utils.metrics import GLOBAL_METRICS


def main() -> None:
    rng = np.random.default_rng(0)
    # Simulate a request stream: 64 same-geometry 512x512 photos.
    print("encoding a synthetic request stream...")
    datas = [
        encoder.encode(
            rng.integers(0, 256, (512, 512, 3), dtype=np.uint8),
            EncodeConfig(quality=85, subsampling="420", restart_interval=4),
        )
        for _ in range(64)
    ]

    m = mesh.make_mesh()  # all devices on the data axis
    bd = batch.BatchDecoder(DecodeConfig(), m)

    # decode_stream overlaps host entropy (threads) with device batches.
    t0 = time.perf_counter()
    frames = 0
    for rgb_batch in bd.decode_stream(datas, batch_size=16):
        frames += rgb_batch.shape[0]
    dt = time.perf_counter() - t0
    px = frames * 512 * 512
    print(f"{frames} frames in {dt*1e3:.0f} ms = "
          f"{frames/dt:.1f} frames/s, {px/dt/1e6:.1f} MP/s "
          f"on {len(m.devices.flat)} device(s)")
    print("per-stage metrics:", GLOBAL_METRICS.summary())


def progressive_serving() -> None:
    """Progressive streams: one image is a set of bit-serial scan chains
    and cannot fill the host's cores alone, so the serving axis is ACROSS
    images — host_decode_batch runs several host stages concurrently
    (PERF.md, progressive serving)."""
    import io

    from PIL import Image

    from jpeg_decoder_tpu.models.decoder import PlanePool, host_decode_batch
    from jpeg_decoder_tpu.utils.config import DecodeConfig

    rng = np.random.default_rng(1)
    datas = []
    for _ in range(8):
        buf = io.BytesIO()
        Image.fromarray(
            rng.integers(0, 256, (512, 512, 3), dtype=np.uint8), "RGB"
        ).save(buf, "JPEG", quality=85, subsampling=2, progressive=True)
        datas.append(buf.getvalue())

    # num_threads=1: the per-image scan-DAG buys nothing once images,
    # not scans, fill the cores.
    cfg = DecodeConfig(num_threads=1)
    pool = PlanePool()
    t0 = time.perf_counter()
    n = 0
    for frame, planes, qts in host_decode_batch(datas, cfg, pool):
        pool.release(planes)  # hand planes to the device stage in real use
        n += 1
    dt = time.perf_counter() - t0
    print(f"progressive serving: {n} images, "
          f"{dt/n*1e3:.1f} ms/img host stage aggregate")


if __name__ == "__main__":
    main()
    progressive_serving()
