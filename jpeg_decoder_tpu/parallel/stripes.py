"""Stripe (spatial) parallelism: one image's decode sharded across devices.

Gigapixel-scan scale-out (SURVEY.md §5 "long-context analogue"): the
coefficient planes of ONE image are sharded by MCU block-rows over the mesh
"stripe" axis; each device runs dequant+IDCT+upsample+color on its stripe
via jax.shard_map. Cross-stripe communication:

  * nearest-neighbor upsampling (the reference's rule,
    /root/reference/src/colour_conversion.c:62-69) — ZERO halo rows: stripes
    are MCU-row aligned, so every output row's chroma source row lives in
    the same stripe;
  * "fancy" (triangular) upsampling — ONE chroma halo row per side,
    exchanged over the stripe axis with lax.ppermute (neighbor traffic
    between devices).

Arbitrary heights: when mcus_y is not divisible by the stripe count, the
block rows are PADDED to the next multiple with copies of the last real
block row, and padded output rows are cropped after the gather. NN sources
for real output rows never reach the padding. The fancy rule's bottom edge
(down == mid on the plane's last real row) is applied explicitly at that
row's global index: the copied block row's first pixel row is not the last
real pixel row.

The host entropy stage can also run stripe-parallel: when the restart
interval covers whole MCU rows (the common DRI layout), each stripe's
segment group decodes independently into a stripe-local buffer — segment
MCU indices are stripe-relative by construction, so the native runtime
writes stripe-local coordinates with only a patched plane height.

Grayscale stripe mode uses the CORRECT addressing path (the REFERENCE
width-stride shear quirk, colour_conversion.c:20, is a global flat gather
and inherently non-local; whole-image mode replicates it).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.numerics import _nn_index_f32
from ..core.types import COEF_DTYPE
from ..io.parser import parse
from ..models import decoder as decoder_mod
from ..ops import color as color_ops
from ..ops import idct as idct_ops
from ..utils.config import DecodeConfig, IdctPrecision
from . import mesh as mesh_mod

F32 = jnp.float32


def _halo_exchange_rows(x, axis_name: str):
    """Exchange one boundary row with stripe neighbors; returns x extended
    by a top and bottom halo row (edge-replicated at the outer borders)."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    down = [(i, (i + 1) % n) for i in range(n)]  # my last row -> next shard's top halo
    up = [(i, (i - 1) % n) for i in range(n)]    # my first row -> prev shard's bottom halo
    top_halo = lax.ppermute(x[-1:], axis_name, down)
    bot_halo = lax.ppermute(x[:1], axis_name, up)
    top_halo = jnp.where(idx == 0, x[:1], top_halo)          # replicate edge
    bot_halo = jnp.where(idx == n - 1, x[-1:], bot_halo)
    return jnp.concatenate([top_halo, x, bot_halo], axis=0)


def _fancy_upsample_v2x_striped(xf, axis_name: str, real_rows: int):
    """Vertical 2x triangular upsample with halo exchange (f32 in/out —
    floats flow between passes exactly like ops/color.fancy_upsample, which
    floors once at the end). `real_rows` is the unpadded plane height: its
    last row replicates itself downward, as the whole-image path does."""
    ext = _halo_exchange_rows(xf, axis_name)  # [rows+2, w]
    up, mid, down = ext[:-2], ext[1:-1], ext[2:]
    rows = xf.shape[0]
    global_row = lax.axis_index(axis_name) * rows + jnp.arange(rows)
    down = jnp.where((global_row == real_rows - 1)[:, None], mid, down)
    even = (3.0 * mid + up + 1.0) * 0.25
    odd = (3.0 * mid + down + 2.0) * 0.25
    return jnp.stack([even, odd], axis=1).reshape(-1, xf.shape[1])


def _padded_mcus_y(mcus_y: int, n_stripes: int) -> int:
    return -(-mcus_y // n_stripes) * n_stripes


@functools.lru_cache(maxsize=64)
def make_shard_fn(key, n_stripes: int):
    """Build the per-stripe device function (the body shard_map maps).

    key is decoder._stage_key's tuple. The returned fn takes per-component
    coefficient STRIPES [by_pad_i/n, bx_i, 64] (block rows padded to a
    multiple of n_stripes with replicated last-row content — see module
    docstring) and returns that stripe's RGB rows [padH/n, W, 3]; it must
    run under a shard_map binding mesh_mod.STRIPE_AXIS (axis_index/ppermute
    are used inside). Reused by decode_striped here and by the combined
    DP x SP step in __graft_entry__.py.
    """
    frame, qt_by_comp, precision, quirks, upsample, scale = key
    if scale != 8:
        raise ValueError("striped decode is full-scale only (scale == 8)")
    comps = frame.components
    bits12 = frame.precision == 12
    exact = precision == IdctPrecision.EXACT
    qtables = [np.frombuffer(q, dtype=np.uint16).copy() for q in qt_by_comp]
    h, w = frame.height, frame.width
    vmax, hmax = frame.max_vsf, frame.max_hsf
    mcus_y_pad = _padded_mcus_y(frame.mcus_y, n_stripes)
    pad_h = mcus_y_pad * 8 * vmax
    hs = pad_h // n_stripes  # output rows per stripe
    mcu_rows_per_stripe = mcus_y_pad // n_stripes

    # Global NN index arrays (the reference's f32-ratio rule), extended over
    # the padded height so every stripe slices the same table. Sources past
    # the real plane land in replicated padding rows — identical content.
    rows_idx = [
        np.asarray(
            _nn_index_f32(pad_h, np.float32(c.vsf) / np.float32(vmax)),
            dtype=np.int32,
        )
        for c in comps
    ]
    cols_idx = [
        np.asarray(
            _nn_index_f32(w, np.float32(c.hsf) / np.float32(hmax)),
            dtype=np.int32,
        )
        for c in comps
    ]

    def shard_fn(*coeff_stripes):
        sidx = lax.axis_index(mesh_mod.STRIPE_AXIS)
        chans = []
        for ci, c in enumerate(comps):
            blocks = coeff_stripes[ci].reshape(-1, 64)
            pix = idct_ops.idct_blocks(blocks, qtables[ci], precision, bits12)
            lby = mcu_rows_per_stripe * c.vsf
            plane = idct_ops.blocks_to_plane(pix, lby, c.blocks_x)
            local_rows = lby * 8

            fancy_ok = (
                upsample == "fancy"
                and (c.hsf == hmax or 2 * c.hsf == hmax)
                and (c.vsf == vmax or 2 * c.vsf == vmax)
                and (2 * c.hsf == hmax or 2 * c.vsf == vmax)
            )
            if fancy_ok:
                up = plane.astype(F32)
                if 2 * c.hsf == hmax:
                    up = color_ops.fancy_h2x(up)
                if 2 * c.vsf == vmax:
                    up = _fancy_upsample_v2x_striped(
                        up, mesh_mod.STRIPE_AXIS, c.blocks_y * 8
                    )
                # One floor at the end; both dims now at full resolution
                # (guaranteed by fancy_ok): crop the stripe-local plane.
                # Clamp like ops/color.fancy_upsample (256.0 is reachable).
                chans.append(
                    jnp.clip(jnp.floor(up), 0.0, 255.0).astype(jnp.uint8)[:hs, :w]
                )
            else:
                # NN gather: global row table sliced to this stripe, made
                # stripe-local (MCU alignment keeps sources in-stripe).
                rows = lax.dynamic_slice(
                    jnp.asarray(rows_idx[ci]), (sidx * hs,), (hs,)
                ) - sidx * local_rows
                rows = jnp.clip(rows, 0, local_rows - 1)
                cols = jnp.asarray(cols_idx[ci])
                chans.append(plane[rows[:, None], cols[None, :]])

        if frame.ncs == 1:
            return color_ops.gray_to_rgb(chans[0])
        if frame.ncs == 3:
            return color_ops.ycbcr_to_rgb(*chans, exact=exact, quirks=quirks)
        return color_ops.ycck_to_rgb(*chans, exact=exact, quirks=quirks)

    return shard_fn


@functools.lru_cache(maxsize=64)
def build_striped_stage(key, mesh: Mesh, n_stripes: int):
    """jit(shard_map) program: coefficient planes (block rows padded to a
    multiple of n_stripes, sharded over "stripe") -> [padH, W, 3] uint8 RGB
    (sharded on rows; crop to frame.height outside)."""
    frame = key[0]
    shard_fn = make_shard_fn(key, n_stripes)
    spec = P(mesh_mod.STRIPE_AXIS)
    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec,) * frame.ncs,
        out_specs=spec,
    )
    return jax.jit(mapped)


def _pad_plane_rows(plane: np.ndarray, by_pad: int) -> np.ndarray:
    """Pad [by, bx, 64] to [by_pad, bx, 64] with copies of the last block
    row (edge-replication semantics; see module docstring)."""
    by = plane.shape[0]
    if by == by_pad:
        return plane
    tail = np.repeat(plane[-1:], by_pad - by, axis=0)
    return np.concatenate([plane, tail], axis=0)


def _striped_entropy_plan(structure, cfg: DecodeConfig, n_stripes: int):
    """Stripe-aligned entropy guards + per-stripe decode closure, shared by
    entropy_decode_striped (all stripes up front, shard_map path) and
    decode_streamed (ONE chunk resident at a time).

    Returns (decode_stripe, lby, qts) — decode_stripe(k, planes) fills the
    caller's zeroed [lby[ci], bx, 64] int16 buffers with stripe k's block
    rows (the native kernel writes only nonzero coefficients, so reused
    buffers must be re-zeroed between calls) — or None when the stream
    shape doesn't support striped entropy.
    """
    from ..native import runtime as nr
    from ..utils.config import EntropyBackend

    frame = structure.frame
    if (
        cfg.entropy_backend != EntropyBackend.NATIVE  # honor the config
        or not nr.available()
        or len(structure.scans) != 1
        or frame.process.name == "PROGRESSIVE_DCT"
    ):
        return None
    scan = structure.scans[0]
    sh = scan.header
    ri = scan.restart_interval
    if sh.nics != frame.ncs or ri == 0 or ri % frame.mcus_x != 0:
        return None  # need whole-MCU-row restart alignment
    total_mcus, params, luts = nr.scan_layout(structure, scan)
    n_segs = nr._check_segments(scan, total_mcus)
    mcu_rows_per_seg = ri // frame.mcus_x
    mcus_y_pad = _padded_mcus_y(frame.mcus_y, n_stripes)
    rows_per_stripe = mcus_y_pad // n_stripes
    if rows_per_stripe % mcu_rows_per_seg:
        return None  # segments must not straddle stripe boundaries
    segs_per_stripe = rows_per_stripe // mcu_rows_per_seg
    bounds = list(scan.span.segment_bounds())
    import os as _os

    total_threads = cfg.num_threads or _os.cpu_count() or 1
    lby = [rows_per_stripe * c.vsf for c in frame.components]
    # Patch per-unit plane block-heights to the stripe-local value; every
    # other column (wrap, width) is row-invariant, so one patched copy
    # serves every stripe.
    local_params = params.copy()
    for u in range(local_params.shape[0]):
        local_params[u, 10] = lby[int(local_params[u, 0])]

    def decode_stripe(k, planes):
        s0 = k * segs_per_stripe
        s1 = min(s0 + segs_per_stripe, n_segs)
        if s0 >= s1:
            return  # stripe entirely in padding rows: stays zero
        local_mcus = min((s1 - s0) * ri, total_mcus - s0 * ri)
        # Stripes decode sequentially, each with the FULL thread budget:
        # the native WorkPool serializes concurrent multi-worker run()
        # calls on run_mutex_, so running stripes concurrently with
        # total/8 threads each would execute them one at a time at 1/8
        # parallelism anyway (r2 advisor finding). Each stripe's segment
        # group is itself segment-parallel, so all cores stay busy.
        nr.decode_scan_native_raw(
            structure, scan, planes,
            cfg.replace(num_threads=total_threads),
            bounds[s0:s1], local_mcus, local_params, luts,
        )

    qts = {tid: qt.values for s in structure.scans
           for tid, qt in s.quant_tables.items()}
    return decode_stripe, lby, qts


def entropy_decode_striped(
    structure,
    cfg: DecodeConfig,
    n_stripes: int,
):
    """Stripe-parallel host entropy decode: each stripe's restart-segment
    group decodes concurrently into a stripe-local buffer (native runtime;
    segment MCU indices are stripe-relative by construction).

    Returns (stripe_planes, qts) where stripe_planes[k][ci] is stripe k's
    [lby, bx, 64] int16 block rows — already padded/replicated so that
    stacking them yields the padded plane — or None when the stream shape
    doesn't support striped entropy (caller falls back to whole-image).
    """
    plan = _striped_entropy_plan(structure, cfg, n_stripes)
    if plan is None:
        return None
    decode_stripe, lby, qts = plan
    frame = structure.frame

    def one_stripe(k):
        planes = [
            np.zeros((lby[ci], c.blocks_x, 64), dtype=COEF_DTYPE)
            for ci, c in enumerate(frame.components)
        ]
        decode_stripe(k, planes)
        return planes

    stripe_planes = [one_stripe(k) for k in range(n_stripes)]

    # Edge-replicate: the stripes covering padding MCU rows got no data for
    # them (local_mcus stops at the real total); fill those block rows with
    # the last decoded row so the padded plane matches _pad_plane_rows.
    real_by = [c.blocks_y for c in frame.components]
    for ci in range(frame.ncs):
        flat_rows = 0
        last_row = None
        for k in range(n_stripes):
            p = stripe_planes[k][ci]
            for r in range(p.shape[0]):
                if flat_rows < real_by[ci]:
                    last_row = p[r]
                else:
                    p[r] = last_row
                flat_rows += 1
    return stripe_planes, qts


@functools.lru_cache(maxsize=64)
def make_chunk_stage(key, n_chunks: int):
    """jit device program for ONE MCU-row chunk of a huge image, the chunk
    index a TRACED scalar so a single compilation serves every chunk:
    (sidx, [lby_ci, bx, 64] coeffs per component) -> [hs, W, 3] uint8 RGB.

    This is the memory-bounding half of the gigapixel path: sequential
    per-chunk dispatch keeps only one chunk's f32 intermediates live (the
    r3 artifact materialized the WHOLE image's — 19 GB peak RSS for
    0.537 GP; the reference streams its INPUT via mmap,
    /root/reference/src/jpeg_decoder.c:143-177 — at gigapixel scale the
    intermediates, not the input, are what must stream). NN upsampling
    only: real output rows' NN chroma sources are chunk-local by MCU-row
    alignment, and output rows in the padding region are cropped by the
    caller, so chunks need no halo and no edge replication (fancy
    upsampling DOES need a neighbor halo — decode_streamed falls back to
    the shard_map path for it).
    """
    frame, qt_by_comp, precision, quirks, upsample, scale = key
    if upsample == "fancy":
        raise ValueError("make_chunk_stage is NN-only (fancy needs halos)")
    if scale != 8:
        raise ValueError("striped decode is full-scale only (scale == 8)")
    comps = frame.components
    bits12 = frame.precision == 12
    exact = precision == IdctPrecision.EXACT
    qtables = [np.frombuffer(q, dtype=np.uint16).copy() for q in qt_by_comp]
    w = frame.width
    vmax, hmax = frame.max_vsf, frame.max_hsf
    mcus_y_pad = _padded_mcus_y(frame.mcus_y, n_chunks)
    pad_h = mcus_y_pad * 8 * vmax
    hs = pad_h // n_chunks  # output rows per chunk
    mcu_rows = mcus_y_pad // n_chunks
    rows_idx = [
        np.asarray(
            _nn_index_f32(pad_h, np.float32(c.vsf) / np.float32(vmax)),
            dtype=np.int32,
        )
        for c in comps
    ]
    cols_idx = [
        np.asarray(
            _nn_index_f32(w, np.float32(c.hsf) / np.float32(hmax)),
            dtype=np.int32,
        )
        for c in comps
    ]

    def chunk_fn(sidx, *coeff_chunks):
        chans = []
        for ci, c in enumerate(comps):
            blocks = coeff_chunks[ci].reshape(-1, 64)
            pix = idct_ops.idct_blocks(blocks, qtables[ci], precision, bits12)
            lby = mcu_rows * c.vsf
            plane = idct_ops.blocks_to_plane(pix, lby, c.blocks_x)
            local_rows = lby * 8
            rows = lax.dynamic_slice(
                jnp.asarray(rows_idx[ci]), (sidx * hs,), (hs,)
            ) - sidx * local_rows
            rows = jnp.clip(rows, 0, local_rows - 1)
            cols = jnp.asarray(cols_idx[ci])
            chans.append(plane[rows[:, None], cols[None, :]])
        if frame.ncs == 1:
            return color_ops.gray_to_rgb(chans[0])
        if frame.ncs == 3:
            return color_ops.ycbcr_to_rgb(*chans, exact=exact, quirks=quirks)
        return color_ops.ycck_to_rgb(*chans, exact=exact, quirks=quirks)

    return jax.jit(chunk_fn)


def decode_streamed(
    data,
    cfg: DecodeConfig | None = None,
    n_chunks: int | None = None,
    sink=None,
):
    """Decode one huge image with BOUNDED peak memory: the device stage
    runs chunk-by-chunk through one compiled program (make_chunk_stage),
    and — when the restart layout is MCU-row aligned — the host entropy
    stage streams the same way, so peak RSS is output + ONE chunk's
    coefficients + ONE chunk's f32 intermediates (+ the memmapped input),
    independent of image height. Returns [H, W, 3] uint8.

    sink(k, rgb_device, r0, take): optional per-chunk consumer replacing
    the host gather — rgb_device is chunk k's on-device [hs, W, 3] uint8
    (rows r0..r0+take are real; the rest is padding). With a sink no
    host output array is allocated and the return value is None: callers
    that only need a device-side reduction (e.g. a digest of each chunk)
    avoid the full device-to-host copy.

    Falls back to decode_striped for fancy upsampling (needs halos) and
    to whole-image host entropy (int16 planes — small next to the f32
    intermediates bounded here) when restart rows don't align with chunks.
    """
    cfg = cfg or DecodeConfig()
    structure = parse(data, cfg)
    frame = structure.frame
    px = frame.height * frame.width
    if n_chunks is None:
        # ~32 MP of output per chunk: big enough to keep the device stage
        # efficient (≈4 4K frames per dispatch), small enough that chunk
        # intermediates stay well under 1 GB.
        n_chunks = max(1, -(-px // (32 << 20)))
    if cfg.upsample == "fancy" or n_chunks == 1:
        if sink is not None:
            raise ValueError(
                "sink requires the chunked path (NN upsampling, >1 chunk)"
            )
        return decode_striped(data, cfg)
    vmax = frame.max_vsf
    mcus_y_pad = _padded_mcus_y(frame.mcus_y, n_chunks)
    hs = mcus_y_pad * 8 * vmax // n_chunks
    mcu_rows = mcus_y_pad // n_chunks

    plan = _striped_entropy_plan(structure, cfg, n_chunks)
    if plan is not None:
        decode_stripe, lby, qts = plan
        bufs = [
            np.zeros((lby[ci], c.blocks_x, 64), dtype=COEF_DTYPE)
            for ci, c in enumerate(frame.components)
        ]
        whole = None
    else:
        whole, qts = decoder_mod._entropy_decode(structure, cfg)

    key = decoder_mod._stage_key(
        frame, decoder_mod.qt_by_comp_bytes(frame, qts), cfg
    )
    stage = make_chunk_stage(key, n_chunks)
    # np.zeros, NOT np.empty: both fault their pages lazily, but on this
    # kernel first-touch write faults into a malloc'd (np.empty) region
    # cost ~45 us each while XLA worker threads concurrently map/unmap
    # their chunk buffers (mmap_lock contention), turning the 100 MB/chunk
    # output copy into 15-26 s; calloc'd (np.zeros) pages fault cheaply.
    # Measured A/B on the 0.537 GP artifact: 4.0 s vs 26.3 s per 4 chunks,
    # 6.5x end-to-end. Allocation itself is lazy either way (zero cost).
    out = (
        None if sink is not None
        else np.zeros((frame.height, frame.width, 3), dtype=np.uint8)
    )
    for k in range(n_chunks):
        if plan is not None:
            for b in bufs:
                b[...] = 0  # the native kernel writes only nonzero coeffs
            decode_stripe(k, bufs)
            chunk_in = bufs
        else:
            chunk_in = []
            for ci, c in enumerate(frame.components):
                lo = k * mcu_rows * c.vsf
                src = whole.plane(ci)[lo: lo + mcu_rows * c.vsf]
                want = mcu_rows * c.vsf
                if src.shape[0] < want:
                    # Padding block rows: zeros are fine — NN sources for
                    # real output rows never point past the real plane,
                    # and padded output rows are cropped below.
                    z = np.zeros(
                        (want - src.shape[0],) + src.shape[1:], COEF_DTYPE
                    )
                    src = np.concatenate([src, z], axis=0)
                chunk_in.append(src)
        rgb_dev = stage(np.int32(k), *[jnp.asarray(p) for p in chunk_in])
        r0 = k * hs
        take = min(hs, frame.height - r0)
        if take <= 0:
            continue  # chunk entirely in padding rows
        if sink is not None:
            sink(k, rgb_dev, r0, take)
        else:
            out[r0: r0 + take] = np.asarray(jax.device_get(rgb_dev))[:take]
    return out


def decode_striped(
    data: bytes,
    cfg: DecodeConfig | None = None,
    mesh: Mesh | None = None,
):
    """Decode one (large) image with its device stage striped over the mesh.

    Arbitrary heights are supported (padded stripes, see module docstring).
    When the restart layout aligns with stripes, the host entropy stage runs
    stripe-parallel too; otherwise it falls back to the whole-image
    segment-parallel path and splits afterwards.
    """
    cfg = cfg or DecodeConfig()
    if mesh is None:
        mesh = mesh_mod.make_mesh(n_data=1, n_stripe=len(jax.devices()))
    n_stripes = mesh.shape[mesh_mod.STRIPE_AXIS]
    structure = parse(data, cfg)
    frame = structure.frame
    mcus_y_pad = _padded_mcus_y(frame.mcus_y, n_stripes)

    striped = entropy_decode_striped(structure, cfg, n_stripes)
    if striped is not None:
        stripe_planes, qts = striped
        dev_inputs = [
            np.concatenate([stripe_planes[k][ci] for k in range(n_stripes)])
            for ci in range(frame.ncs)
        ]
    else:
        planes, qts = decoder_mod._entropy_decode(structure, cfg)
        dev_inputs = [
            _pad_plane_rows(
                planes.plane(ci),
                mcus_y_pad * frame.components[ci].vsf,
            )
            for ci in range(frame.ncs)
        ]

    key = decoder_mod._stage_key(
        frame, decoder_mod.qt_by_comp_bytes(frame, qts), cfg
    )
    stage = build_striped_stage(key, mesh, n_stripes)
    sh = NamedSharding(mesh, P(mesh_mod.STRIPE_AXIS))
    dev_planes = [jax.device_put(p, sh) for p in dev_inputs]
    rgb = np.asarray(jax.device_get(stage(*dev_planes)))
    return rgb[: frame.height]
