"""On-device entropy decode: one lane per restart segment, in lockstep.

The sequence-parallel analogue for JPEG (SURVEY.md §5): a scan's entropy
stream is an arbitrarily long serial sequence, but DC predictors and bit
alignment reset at every restart marker, so each restart segment is an
independent "lane". This module decodes ALL lanes simultaneously on device:
a jax.lax.while_loop whose body advances every lane's Huffman state machine
by one symbol per iteration — SIMD across lanes, serial within a lane —
with flat-LUT symbol resolution and vectorized bit-window gathers.

This replaces the reference's byte-serial single-lane loop (`decode_scan`
/root/reference/src/decode.c:535-663, `next_bit` bitstream.c:61-67) with a
formulation XLA compiles to pure vector gathers/scatters: no host work
after the byte-span prescan, so compressed bytes can ship to the device and
decode entirely there. Throughput scales with the restart-segment count (files
without DRI degrade to one lane — correct, but serial).

Sequential (baseline/extended) scans only; progressive scans fall back to
the host backends (models/decoder.py dispatches per scan).

One dispatch of the while_loop advances every lane by one symbol, so a
lane-count-limited stream pays one loop iteration per symbol of its longest
segment. This backend is therefore a CAPABILITY (decode with zero host
compute, e.g. compressed bytes living in device memory) and a correctness
testbed, not the throughput path; `chip_smoke.py`'s device_entropy phase
prints its rate on the card as the baseline a GPU entropy kernel must
beat.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..core.driver import run_scans
from ..core.types import CoefficientPlanes, JpegStructure
from ..io import bitstream as bsio
from ..io.markers import Encoding
from ..utils.config import DecodeConfig
from ..utils.errors import JpegUnsupportedError
from ..native.runtime import scan_layout, _check_segments

I32 = jnp.int32


def _gather_window32(bytes_arr, byteoff):
    """[L] big-endian 32-bit windows starting at per-lane byte offsets."""
    byteoff = jnp.minimum(byteoff, bytes_arr.shape[1] - 4)  # stay in pad
    idx = byteoff[:, None] + jnp.arange(4, dtype=I32)[None, :]
    b = jnp.take_along_axis(bytes_arr, idx, axis=1).astype(jnp.uint32)
    w = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]
    return w.astype(jnp.uint32)


@functools.lru_cache(maxsize=64)
def _build_decode_loop(
    n_units: int,
    unit_params_bytes: bytes,
    plane_offs: tuple[int, ...],
    total_coeffs: int,
    n_luts: int,
):
    """Compile-time-static loop builder (cached per scan geometry)."""
    up = np.frombuffer(unit_params_bytes, dtype=np.int32).reshape(n_units, 11)
    # columns: plane, scomp, dc_lut, ac_lut, h, v, j, k, wrap, bw, bh
    u_plane = jnp.asarray(up[:, 0])
    u_sci = jnp.asarray(up[:, 1])
    u_dc = jnp.asarray(up[:, 2])
    u_ac = jnp.asarray(up[:, 3])
    u_h = jnp.asarray(up[:, 4])
    u_v = jnp.asarray(up[:, 5])
    u_j = jnp.asarray(up[:, 6])
    u_k = jnp.asarray(up[:, 7])
    u_wrap = jnp.asarray(up[:, 8])
    u_bw = jnp.asarray(up[:, 9])
    u_bh = jnp.asarray(up[:, 10])
    p_off = jnp.asarray(np.asarray(plane_offs, dtype=np.int32))
    OOB = total_coeffs + 64  # out-of-bounds sentinel: scatters drop

    def block_base(m, u):
        """Flat coefficient index of block (mcu m, unit u), or OOB."""
        h, v = u_h[u], u_v[u]
        base = m * h + u_k[u]
        wrap = u_wrap[u]
        bx = base % wrap
        by = (base // wrap) * v + u_j[u]
        ok = (by < u_bh[u]) & (bx < u_bw[u])
        flat = p_off[u_plane[u]] + (by * u_bw[u] + bx) * 64
        return jnp.where(ok, flat, OOB)

    @jax.jit
    def decode(bytes_arr, lut_sym, lut_len, mcu_end, ri, init_flat):
        """bytes_arr: [L, B] uint8 (unstuffed, padded). lut_sym/lut_len:
        [n_luts, 65536] int32. mcu_end: [L] exclusive global-MCU bounds.
        ri: restart interval (0 -> single lane covers everything).
        init_flat: prior coefficient state — scans only update the blocks
        they cover (multi-scan files accumulate across scans)."""
        L = bytes_arr.shape[0]
        lanes = jnp.arange(L, dtype=I32)
        m0 = jnp.where(ri > 0, lanes * ri, 0)

        out = init_flat
        state = dict(
            out=out,
            bitpos=jnp.zeros(L, dtype=I32),
            m=m0,
            u=jnp.zeros(L, dtype=I32),
            ci=jnp.zeros(L, dtype=I32),  # coef index; 0 = expecting DC
            base=jax.vmap(block_base)(m0, jnp.zeros(L, dtype=I32)),
            preds=jnp.zeros((L, 4), dtype=I32),
            done=m0 >= mcu_end,
            bad=jnp.zeros(L, dtype=jnp.bool_),
        )

        def cond(s):
            return jnp.any(~s["done"])

        def body(s):
            active = ~s["done"]
            bitpos = s["bitpos"]
            u = s["u"]
            ci = s["ci"]

            # --- symbol ---------------------------------------------------
            w = _gather_window32(bytes_arr, bitpos >> 3)
            sh = (bitpos & 7).astype(jnp.uint32)
            peek = ((w >> (16 - sh)) & 0xFFFF).astype(I32)
            is_dc = ci == 0
            lut_id = jnp.where(is_dc, u_dc[u], u_ac[u])
            flat_idx = lut_id * 65536 + peek
            sym = lut_sym.reshape(-1)[flat_idx]
            ln = lut_len.reshape(-1)[flat_idx]
            # invalid prefix (ln == 0) or out-of-range DC magnitude would
            # hang/corrupt the lane: force it done and flag the error (the
            # caller raises JpegEntropyError).
            bad = active & ((ln == 0) | (is_dc & (sym > 15)))

            size = jnp.where(is_dc, jnp.minimum(sym, 16), sym & 0xF)
            run = jnp.where(is_dc, 0, sym >> 4)

            # --- extend bits ---------------------------------------------
            pos2 = bitpos + ln
            w2 = _gather_window32(bytes_arr, pos2 >> 3)
            sh2 = (pos2 & 7).astype(jnp.uint32)
            szu = size.astype(jnp.uint32)
            v = jnp.where(
                size > 0,
                ((w2 >> (32 - sh2 - szu)) & ((1 << szu) - 1)).astype(I32),
                0,
            )
            half = jnp.where(size > 0, 1 << jnp.maximum(size - 1, 0), 0)
            ext = jnp.where((size > 0) & (v < half), v - 2 * half + 1, v)

            # --- DC path --------------------------------------------------
            sci = u_sci[u]
            pred_old = jnp.take_along_axis(
                s["preds"], sci[:, None], axis=1
            )[:, 0]
            pred_new = pred_old + ext
            preds = jnp.where(
                (active & is_dc)[:, None],
                s["preds"].at[jnp.arange(s["preds"].shape[0]), sci].set(
                    pred_new
                ),
                s["preds"],
            )

            # --- AC path --------------------------------------------------
            is_eob = (~is_dc) & (sym == 0x00)
            is_zrl = (~is_dc) & (sym == 0xF0)
            ac_write_ci = ci + run
            ci_next = jnp.where(
                is_dc,
                1,
                jnp.where(
                    is_eob, 64,
                    jnp.where(is_zrl, ci + 16, ac_write_ci + 1)
                ),
            )

            # --- coefficient write ---------------------------------------
            # AC index overflow is a malformed stream: flag the lane (the
            # other backends raise JpegEntropyError for the same input).
            bad = bad | (active & (~is_dc) & (size > 0) & (ac_write_ci > 63))
            write_dc = active & is_dc
            write_ac = active & (~is_dc) & (size > 0) & (ac_write_ci <= 63)
            widx = jnp.where(
                write_dc,
                s["base"],
                jnp.where(write_ac, s["base"] + ac_write_ci, OOB),
            )
            wval = jnp.where(is_dc, pred_new, ext)
            out = s["out"].at[widx].set(wval, mode="drop")

            # --- block / MCU / lane advance -------------------------------
            block_done = active & (ci_next >= 64)
            u_next = jnp.where(block_done, u + 1, u)
            mcu_roll = block_done & (u_next >= n_units)
            m_next = jnp.where(mcu_roll, s["m"] + 1, s["m"])
            u_next = jnp.where(mcu_roll, 0, u_next)
            ci_new = jnp.where(block_done, 0, ci_next)
            base_next = jnp.where(
                block_done,
                jax.vmap(block_base)(m_next, u_next),
                s["base"],
            )
            done = s["done"] | (m_next >= mcu_end) | bad

            return dict(
                out=out,
                bitpos=jnp.where(active, pos2 + size, bitpos),
                m=m_next,
                u=u_next,
                ci=ci_new,
                base=base_next,
                preds=preds,
                done=done,
                bad=s["bad"] | bad,
            )

        final = lax.while_loop(cond, body, state)
        return final["out"], jnp.any(final["bad"]), final["bitpos"]

    return decode


def decode_scan_device(structure, scan, planes: CoefficientPlanes, cfg):
    frame = structure.frame
    total_mcus, params, luts = scan_layout(structure, scan)
    n_segs = _check_segments(scan, total_mcus)
    ri = scan.restart_interval

    # Per-lane unstuffed byte buffers, padded to a common length (+8 zeros
    # so 32-bit windows never read past the end).
    segs = []
    for s, e in scan.span.segment_bounds():
        unstuffed, _ = bsio.unstuff(structure.data, s, e)
        segs.append(unstuffed)
    maxlen = max(x.shape[0] for x in segs) + 8
    bytes_arr = np.zeros((n_segs, maxlen), dtype=np.uint8)
    for i, x in enumerate(segs):
        bytes_arr[i, : x.shape[0]] = x

    lut_sym = np.stack([l.lut_symbol.astype(np.int32) for l in luts])
    lut_len = np.stack([l.lut_length.astype(np.int32) for l in luts])

    sizes = [planes.plane(i).size for i in range(frame.ncs)]
    plane_offs = tuple(int(x) for x in np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    total = int(sum(sizes))

    decode = _build_decode_loop(
        params.shape[0], params.tobytes(), plane_offs, total, len(luts)
    )
    if ri > 0:
        mcu_end = np.minimum(
            (np.arange(n_segs, dtype=np.int64) + 1) * ri, total_mcus
        ).astype(np.int32)
    else:
        mcu_end = np.array([total_mcus], dtype=np.int32)

    init_flat = np.concatenate(
        [planes.plane(ci).reshape(-1) for ci in range(frame.ncs)]
    ).astype(np.int32)
    flat_dev, bad_dev, bitpos_dev = decode(
        jnp.asarray(bytes_arr),
        jnp.asarray(lut_sym),
        jnp.asarray(lut_len),
        jnp.asarray(mcu_end),
        ri,
        jnp.asarray(init_flat),
    )
    if bool(jax.device_get(bad_dev)):
        from ..utils.errors import JpegEntropyError

        raise JpegEntropyError(
            "device entropy decode hit an invalid Huffman code or DC range"
        )
    # Truncation check: _gather_window32 clamps past-end reads into zero
    # padding, so a short final segment would otherwise decode fabricated
    # zero bits and "succeed". Apply the same rule as the other backends
    # (FastBitReader.overran / jdt_entropy.cpp BitReader::overran): consuming
    # more than the 7 possible alignment-fill bits past the real unstuffed
    # end means the stream is genuinely short.
    bitpos = np.asarray(jax.device_get(bitpos_dev))
    real_bits = np.array([8 * x.shape[0] for x in segs], dtype=np.int64)
    if np.any(bitpos.astype(np.int64) > real_bits + 7):
        from ..utils.errors import JpegTruncatedError

        raise JpegTruncatedError(
            "entropy data truncated (device decode consumed fabricated bits)"
        )
    flat = np.asarray(jax.device_get(flat_dev))
    pos = 0
    for ci in range(frame.ncs):
        p = planes.plane(ci)
        p[...] = flat[pos : pos + p.size].reshape(p.shape)
        pos += p.size


def entropy_decode(
    structure: JpegStructure,
    cfg: DecodeConfig,
    planes: CoefficientPlanes | None = None,
):
    """All scans -> (CoefficientPlanes, qtid -> table). Sequential scans run
    on device; progressive scans are not supported on this backend."""
    frame = structure.frame
    if frame.process == Encoding.PROGRESSIVE_DCT:
        raise JpegUnsupportedError(
            "device entropy backend does not decode progressive scans; use"
            " the native or numpy backend"
        )
    if planes is None:
        planes = CoefficientPlanes(frame)
    qts = run_scans(
        structure, planes,
        lambda s, scan, p: decode_scan_device(s, scan, p, cfg),
    )
    return planes, qts
