"""Multi-host (multi-process) initialization and global-mesh helpers.

The reference has no distributed anything (SURVEY.md §2); this engine
scales across hosts with JAX's native runtime: `jax.distributed.initialize`
brings every process into one system, `jax.devices()` becomes the GLOBAL
device list, and the (data, stripe) mesh from parallel/mesh.py spans it.
Collectives then ride the intra-host links (NVLink on GPUs) and the
network across hosts — laid out by XLA from the same shardings used
single-host (nothing here changes the compute code; that is the point of
the design).

Typical launch (one process per host; nothing discovers a GPU cluster, so
the coordinator and ranks are given explicitly):

    from jpeg_decoder_tpu.parallel import multihost, mesh
    multihost.initialize("host0:9876", num_processes=n, process_id=rank)
    m = mesh.make_mesh()                    # global mesh over all devices
    bd = BatchDecoder(cfg, m)               # shard batches over every host

CPU simulation (tests/test_multihost.py drives this with real separate
processes):

    multihost.initialize("localhost:9876", num_processes=2, process_id=i)
"""

from __future__ import annotations

import os

import jax

from ..utils.logging import get_logger

log = get_logger("multihost")

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Join this process into the global JAX runtime.

    Pass the arguments explicitly for GPU and CPU clusters and
    simulations: nothing in a plain GPU machine's environment describes
    the cluster. Safe to call once per process, before any other jax API
    touches the backend.
    """
    global _initialized
    if _initialized:
        log.warning("multihost.initialize called twice; ignoring")
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True
    log.info(
        "process %d/%d up: %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def is_distributed() -> bool:
    return jax.process_count() > 1


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
    }
