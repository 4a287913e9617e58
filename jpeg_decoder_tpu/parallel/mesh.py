"""Device mesh construction and sharding helpers.

The reference is strictly single-threaded/single-process (SURVEY.md §2:
no pthreads/MPI/SIMD); all scale-out here is new design. The engine uses
two named mesh axes:

  * "data"   — batch data parallelism: independent JPEGs per device
               (the whole-file unit seam, decode_jpeg_buffer decode.c:138);
  * "stripe" — spatial parallelism: MCU-row stripes of ONE image across
               devices (coordinate seam decode.c:475-486; with
               nearest-neighbor upsampling stripes need zero halo rows,
               with fancy upsampling one — colour_conversion.c:62-69).

Collectives ride the mesh through jax.shard_map + psum/ppermute; on GPUs
XLA hands them to NCCL. The device list is reshaped in order: every GPU of a
host reaches every other at the same NVLink rate, so the mesh follows the
algorithm alone.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
STRIPE_AXIS = "stripe"


def make_mesh(
    n_data: int | None = None,
    n_stripe: int = 1,
    devices=None,
) -> Mesh:
    """Build a ("data", "stripe") mesh over the given (default: all) devices.

    n_data defaults to len(devices) // n_stripe.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_stripe
    need = n_data * n_stripe
    if need > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_stripe} needs {need} devices, have {len(devices)}"
        )
    grid = np.array(devices[:need]).reshape(n_data, n_stripe)
    return Mesh(grid, (DATA_AXIS, STRIPE_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis batch sharding over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def stripe_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (block-row) sharding over the stripe axis."""
    return NamedSharding(mesh, P(STRIPE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
