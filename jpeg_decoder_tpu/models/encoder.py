"""The encode pipeline: device color/FDCT stage + host Huffman pack + writer.

A working baseline JPEG encoder — the capability the reference intends but
does not have (its encoder neither compiles nor produces a stream,
/root/reference/src/jpeg_encoder.c:35-46, encode.c:12-74). Structure mirrors
the decoder in reverse:

  device:  pad -> RGB->YCbCr -> box subsample -> level shift ->
           FDCT+quantize as one matmul per component          (ops/fdct.py)
  host:    MCU-interleaved run/size Huffman pack, optional restart
           markers, optional two-pass optimized tables   (core/entropy_encode)
  host:    marker emission                                     (io/writer.py)

Restart markers are this engine's parallelism seam (SURVEY.md §2), so the
encoder can emit them (cfg.restart_interval) to make its own output
segment-parallel-decodable.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core import entropy_encode, huffman
from ..core.types import (
    standard_chrominance_qtable,
    standard_luminance_qtable,
)
from ..io import writer
from ..ops import fdct as fdct_ops
from ..utils.config import EncodeConfig
from ..utils.errors import JpegConfigError

_SAMPLING = {
    "444": ((1, 1), (1, 1), (1, 1)),
    "422": ((2, 1), (1, 1), (1, 1)),
    "420": ((2, 2), (1, 1), (1, 1)),
    # Exotic-but-legal factors (T.81 A.1.1 allows any h,v in 1..4). These
    # exercise the decoder's per-component block wrap math beyond the three
    # common shapes (oracle._block_position / native UnitLayout); Pillow
    # cannot write them, so the in-repo writer is the corpus source.
    "411": ((4, 1), (1, 1), (1, 1)),
    "440": ((1, 2), (1, 1), (1, 1)),
    # Mixed chroma factors: Cb at (2,1), Cr at (1,2) under a (2,2) luma —
    # every component gets a DIFFERENT wrap width and unit count.
    "mixed": ((2, 2), (2, 1), (1, 2)),
}


def quality_qtables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """IJG quality scaling of the Annex K tables (natural order)."""
    if quality < 50:
        scale = 5000 // quality
    else:
        scale = 200 - 2 * quality
    out = []
    for base in (standard_luminance_qtable(), standard_chrominance_qtable()):
        t = (base.astype(np.int64) * scale + 50) // 100
        out.append(np.clip(t, 1, 255).astype(np.uint16))
    return out[0], out[1]


@functools.lru_cache(maxsize=64)
def _build_device_stage(h: int, w: int, subsampling: str,
                        qt_bytes: tuple[bytes, ...], gray: bool):
    """Jitted device program: image -> per-component zigzag coeff planes."""
    qts = [np.frombuffer(q, dtype=np.uint16) for q in qt_bytes]
    if gray:
        factors = ((1, 1),)
    else:
        factors = _SAMPLING[subsampling]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))
    pad_w, pad_h = mcus_x * 8 * hmax, mcus_y * 8 * vmax

    def stage(img):
        if gray:
            plane = img.astype(jnp.float32) if img.ndim == 2 else (
                fdct_ops.rgb_to_ycbcr(img)[0]
            )
            chans = [fdct_ops.pad_edge(plane, pad_h, pad_w)]
        else:
            y, cb, cr = fdct_ops.rgb_to_ycbcr(img)
            chans = [fdct_ops.pad_edge(c, pad_h, pad_w) for c in (y, cb, cr)]
        out = []
        for ci, (fh, fv) in enumerate(factors):
            sub = fdct_ops.box_subsample(chans[ci], hmax // fh, vmax // fv)
            by, bx = mcus_y * fv, mcus_x * fh
            blocks = fdct_ops.plane_to_blocks(sub, by, bx)
            qt = qts[0] if ci == 0 else qts[1]
            zz = fdct_ops.fdct_quantize(blocks, qt)
            # int16 IR (same rationale as the decode side, core/types
            # COEF_DTYPE): quantized 8-bit-precision coefficients are
            # <= 11 bits (T.81 F.1, |S| <= 2048 even at qt=1), and the
            # narrower dtype halves the device->host fetch and the
            # packer's read traffic.
            out.append(zz.astype(jnp.int16).reshape(by, bx, 64))
        return out

    return jax.jit(stage), factors, (mcus_x, mcus_y)


def _unit_layout(factors, n_tables: int) -> tuple[np.ndarray, list[int]]:
    """Per-unit-in-MCU descriptor rows for the plane-direct native packer:
    [units_per_mcu, 8] int32 (comp, fh, fv, j, k, sci, dc_table, ac_table),
    in spec A.2.3 unit order (component, then top-to-bottom/left-to-right
    within the component's sampling region). Returns (unit_params,
    unit_sci)."""
    rows, unit_sci = [], []
    for ci, (fh, fv) in enumerate(factors):
        t = 0 if ci == 0 else n_tables - 1
        for j in range(fv):
            for k in range(fh):
                rows.append((ci, fh, fv, j, k, ci, t, t))
                unit_sci.append(ci)
    return np.asarray(rows, dtype=np.int32), unit_sci


def _mcu_order(coeffs: list[np.ndarray], factors, mcus_x: int, mcus_y: int):
    """Flatten per-component [by, bx, 64] planes into MCU-interleaved unit
    order (spec A.2.3); returns (blocks [n_units_total, 64], per-unit
    scan-component indices within one MCU, units_per_mcu)."""
    per_comp = []
    unit_sci = []
    for ci, (fh, fv) in enumerate(factors):
        c = coeffs[ci]  # (mcus_y*fv, mcus_x*fh, 64)
        # -> (mcus_y, mcus_x, fv, fh, 64) -> (mcu, unit, 64)
        r = (
            c.reshape(mcus_y, fv, mcus_x, fh, 64)
            .transpose(0, 2, 1, 3, 4)
            .reshape(mcus_y * mcus_x, fv * fh, 64)
        )
        per_comp.append(r)
        unit_sci += [ci] * (fv * fh)
    interleaved = np.concatenate(per_comp, axis=1)  # (mcu, units, 64)
    units_per_mcu = interleaved.shape[1]
    return interleaved.reshape(-1, 64), unit_sci, units_per_mcu


class JpegEncoder:
    """Reusable encoder handle (caches the jitted device stage per shape)."""

    def __init__(self, cfg: EncodeConfig | None = None):
        self.cfg = cfg or EncodeConfig()

    @staticmethod
    def _fallback_order(coeffs, factors, mcus_x, mcus_y, n_tables):
        """Materialized MCU-interleaved layout for the Python packer (the
        native path never pays this reshuffle)."""
        blocks, unit_sci, units_per_mcu = _mcu_order(
            coeffs, factors, mcus_x, mcus_y
        )
        table_of_unit = [
            (0, 0) if sci == 0 else (n_tables - 1, n_tables - 1)
            for sci in unit_sci
        ]
        mcu_blocks = [
            (unit_sci[i % units_per_mcu], blocks[i])
            for i in range(blocks.shape[0])
        ]
        return mcu_blocks, table_of_unit, units_per_mcu

    @classmethod
    def _pack(cls, coeffs, factors, mcus_x, mcus_y, dc_tables, ac_tables,
              n_tables, cfg):
        """Entropy pack: plane-direct native C++ (segment-parallel; the MCU
        interleave is ADDRESSED inside the walk over the device stage's
        [by, bx, 64] int16 planes, never materialized as a host reshuffle)
        with a Python fallback (byte-identical; tested in
        test_encoder.py::test_plane_packer_byte_identical)."""
        from ..native import runtime as native_runtime

        if native_runtime.available():
            unit_params, _ = _unit_layout(factors, n_tables)
            try:
                return native_runtime.encode_scan_planes(
                    coeffs, mcus_x, mcus_x * mcus_y, unit_params,
                    dc_tables, ac_tables, cfg.restart_interval,
                )
            except (RuntimeError, ValueError):
                pass  # fall through to the Python packer
        mcu_blocks, table_of_unit, units_per_mcu = cls._fallback_order(
            coeffs, factors, mcus_x, mcus_y, n_tables
        )
        return entropy_encode.encode_blocks(
            mcu_blocks, dc_tables, ac_tables, table_of_unit,
            units_per_mcu, cfg.restart_interval,
        )

    @classmethod
    def _count(cls, coeffs, factors, mcus_x, mcus_y, n_tables, cfg):
        """Symbol-frequency pass for two-pass optimized tables: native
        plane-direct count (count-identical to the Python walk; tested in
        test_encoder.py) with the Python fallback."""
        from ..native import runtime as native_runtime

        if native_runtime.available():
            unit_params, _ = _unit_layout(factors, n_tables)
            try:
                return native_runtime.count_scan_planes(
                    coeffs, mcus_x, mcus_x * mcus_y, unit_params,
                    n_tables, n_tables, cfg.restart_interval,
                )
            except (RuntimeError, ValueError):
                pass
        mcu_blocks, table_of_unit, units_per_mcu = cls._fallback_order(
            coeffs, factors, mcus_x, mcus_y, n_tables
        )
        return entropy_encode.count_symbols(
            mcu_blocks, n_tables, n_tables, table_of_unit,
            units_per_mcu, cfg.restart_interval,
        )

    def _huffman_specs(self, cfg, coeffs, factors, mcus_x, mcus_y, gray):
        n_tables = 1 if gray else 2
        if cfg.huffman == "optimized":
            freq_dc, freq_ac = self._count(
                coeffs, factors, mcus_x, mcus_y, n_tables, cfg
            )
            dc_specs = [
                dataclasses.replace(
                    huffman.optimal_code_lengths(freq_dc[t]),
                    table_class=0, table_id=t,
                )
                for t in range(n_tables)
            ]
            ac_specs = [
                dataclasses.replace(
                    huffman.optimal_code_lengths(freq_ac[t]),
                    table_class=1, table_id=t,
                )
                for t in range(n_tables)
            ]
        else:
            dc_specs = [huffman.annex_k_dc_luminance()]
            ac_specs = [huffman.annex_k_ac_luminance()]
            if not gray:
                dc_specs.append(huffman.annex_k_dc_chrominance())
                ac_specs.append(huffman.annex_k_ac_chrominance())
        return dc_specs, ac_specs

    @staticmethod
    def _geometry(img, cfg):
        """Validate the input array; returns (h, w, gray)."""
        gray = cfg.subsampling == "gray" or img.ndim == 2
        if img.ndim == 2:
            h, w = img.shape
        elif img.ndim == 3 and img.shape[2] == 3:
            h, w = img.shape[:2]
        else:
            raise JpegConfigError(
                f"expected [H,W] gray or [H,W,3] RGB, got {img.shape}"
            )
        if img.dtype != np.uint8:
            raise JpegConfigError("input must be uint8")
        return h, w, gray

    def _assemble_baseline(self, cfg, h, w, gray, coeffs, factors,
                           mcus_x, mcus_y, qts) -> bytes:
        """Tables + entropy pack + marker assembly (spec B.2) for a
        baseline (SOF0) frame from fetched coefficient planes."""
        qt_l, qt_c = qts
        n_tables = 1 if gray else 2
        dc_specs, ac_specs = self._huffman_specs(
            cfg, coeffs, factors, mcus_x, mcus_y, gray
        )
        dc_tables = [huffman.build_encode_table(s) for s in dc_specs]
        ac_tables = [huffman.build_encode_table(s) for s in ac_specs]
        entropy = self._pack(
            coeffs, factors, mcus_x, mcus_y, dc_tables, ac_tables,
            n_tables, cfg,
        )

        parts = [writer.soi(), writer.app0_jfif()]
        parts.append(writer.dqt(0, qt_l))
        if not gray:
            parts.append(writer.dqt(1, qt_c))
        if gray:
            sof_comps = [(1, 1, 1, 0)]
            sos_comps = [(1, 0, 0)]
        else:
            sof_comps = [
                (ci + 1, fh, fv, 0 if ci == 0 else 1)
                for ci, (fh, fv) in enumerate(factors)
            ]
            sos_comps = [(1, 0, 0)] + [
                (ci + 1, n_tables - 1, n_tables - 1) for ci in (1, 2)
            ]
        parts.append(writer.sof(w, h, sof_comps))
        for s in dc_specs + ac_specs:
            parts.append(writer.dht(s))
        if cfg.restart_interval:
            parts.append(writer.dri(cfg.restart_interval))
        parts.append(writer.sos(sos_comps))
        parts.append(entropy)
        parts.append(writer.eoi())
        return b"".join(parts)

    def encode(self, img: np.ndarray) -> bytes:
        cfg = self.cfg
        img = np.asarray(img)
        h, w, gray = self._geometry(img, cfg)

        qt_l, qt_c = quality_qtables(cfg.quality)
        qt_bytes = (qt_l.tobytes(), qt_c.tobytes())
        stage, factors, (mcus_x, mcus_y) = _build_device_stage(
            h, w, cfg.subsampling, qt_bytes, gray
        )
        coeffs = [np.asarray(c) for c in stage(jnp.asarray(img))]
        if cfg.progressive:
            return self._assemble_progressive(
                cfg, h, w, gray, coeffs, factors, (qt_l, qt_c)
            )
        return self._assemble_baseline(
            cfg, h, w, gray, coeffs, factors, mcus_x, mcus_y, (qt_l, qt_c)
        )

    def encode_stream(self, imgs):
        """Pipelined streaming encode: yields JPEG bytes per input image.

        The device FDCT+quantize stage of image k+1 is DISPATCHED (jax
        dispatch is async) before the host packs image k, so in steady
        state the device computes ahead while the host does Huffman
        packing — the encode mirror of parallel/batch.decode_stream.
        Output bytes are identical to per-image encode() calls
        (tested in test_encoder.py::test_encode_stream_matches_encode)."""
        cfg = self.cfg
        pending = None  # (dev_coeffs, h, w, gray, factors, mx, my, qts)

        def finish(p):
            dev_coeffs, h, w, gray, factors, mx, my, qts = p
            coeffs = [np.asarray(c) for c in dev_coeffs]  # sync on image k
            if cfg.progressive:
                return self._assemble_progressive(
                    cfg, h, w, gray, coeffs, factors, qts
                )
            return self._assemble_baseline(
                cfg, h, w, gray, coeffs, factors, mx, my, qts
            )

        qt_l, qt_c = quality_qtables(cfg.quality)
        qt_bytes = (qt_l.tobytes(), qt_c.tobytes())
        for img in imgs:
            img = np.asarray(img)
            h, w, gray = self._geometry(img, cfg)
            stage, factors, (mx, my) = _build_device_stage(
                h, w, cfg.subsampling, qt_bytes, gray
            )
            dev_coeffs = stage(jnp.asarray(img))  # async dispatch (k+1)
            if pending is not None:
                yield finish(pending)  # host pack (k) under device (k+1)
            pending = (dev_coeffs, h, w, gray, factors, mx, my,
                       (qt_l, qt_c))
        if pending is not None:
            yield finish(pending)


def encode(img: np.ndarray, cfg: EncodeConfig | None = None) -> bytes:
    """Encode an RGB/grayscale uint8 array to baseline JPEG bytes."""
    return JpegEncoder(cfg).encode(img)


def _assemble_progressive(self, cfg, h, w, gray, coeffs, factors, qts):
    """Progressive (SOF2) assembly: spectral-selection scan script — one
    interleaved DC scan, then a full-band (ss=1..63) AC scan per component
    (spec G.2; decode counterpart core/oracle.decode_progressive_scan).

    Goes beyond the reference, whose encoder doesn't exist and whose
    progressive decoder is broken — round-tripped against our decoder and
    Pillow in tests/test_progressive_encode.py.
    """
    from ..core import entropy_encode as ee

    qt_l, qt_c = qts
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))
    ncs = 1 if gray else 3
    n_tables = 1 if gray else 2

    # MCU-ordered DC stream + per-unit metadata for the interleaved DC scan.
    blocks, unit_sci, units_per_mcu = _mcu_order(coeffs, factors, mcus_x, mcus_y)
    dcs = blocks[:, 0]
    dc_table_of_unit = [0 if sci == 0 else n_tables - 1 for sci in unit_sci]

    # Per-component non-interleaved AC block sequences (raster over the
    # component's own ceil(x/8) x ceil(y/8) grid, NOT the MCU-padded grid).
    ac_seqs = []
    for ci, (fh, fv) in enumerate(factors):
        cx = -(-w * fh // hmax)
        cy = -(-h * fv // vmax)
        pad_x, pad_y = -(-cx // 8), -(-cy // 8)
        ac_seqs.append(coeffs[ci][:pad_y, :pad_x].reshape(-1, 64))

    # Two-pass optimized tables (EOBn symbols are absent from Annex K).
    freq_dc = [np.zeros(256, dtype=np.int64) for _ in range(n_tables)]
    freq_ac = [np.zeros(256, dtype=np.int64) for _ in range(n_tables)]
    ee.encode_dc_scan(dcs, unit_sci, dc_table_of_unit, None, freq=freq_dc)
    for ci in range(ncs):
        t = 0 if ci == 0 else n_tables - 1
        ee.encode_ac_scan(ac_seqs[ci], 1, 63, None, freq=freq_ac[t])

    def spec_of(freq, table_class, table_id):
        s = huffman.optimal_code_lengths(freq)
        return dataclasses.replace(s, table_class=table_class, table_id=table_id)

    dc_specs = [spec_of(freq_dc[t], 0, t) for t in range(n_tables)]
    ac_specs = [spec_of(freq_ac[t], 1, t) for t in range(n_tables)]
    dc_tables = [huffman.build_encode_table(s) for s in dc_specs]
    ac_tables = [huffman.build_encode_table(s) for s in ac_specs]

    dc_entropy = ee.encode_dc_scan(dcs, unit_sci, dc_table_of_unit, dc_tables)
    ac_entropy = [
        ee.encode_ac_scan(ac_seqs[ci], 1, 63, ac_tables[0 if ci == 0 else n_tables - 1])
        for ci in range(ncs)
    ]

    parts = [writer.soi(), writer.app0_jfif(), writer.dqt(0, qt_l)]
    if not gray:
        parts.append(writer.dqt(1, qt_c))
    if gray:
        sof_comps = [(1, 1, 1, 0)]
    else:
        sof_comps = [
            (ci + 1, fh, fv, 0 if ci == 0 else 1)
            for ci, (fh, fv) in enumerate(factors)
        ]
    parts.append(writer.sof(w, h, sof_comps, marker=0xC2))
    for s in dc_specs + ac_specs:
        parts.append(writer.dht(s))
    # DC scan: all components interleaved, ss=0 se=0.
    if gray:
        dc_sos = [(1, 0, 0)]
    else:
        dc_sos = [(1, 0, 0), (2, n_tables - 1, 0), (3, n_tables - 1, 0)]
    parts.append(writer.sos(dc_sos, ss=0, se=0))
    parts.append(dc_entropy)
    # One full-band AC scan per component.
    for ci in range(ncs):
        cid = ci + 1
        t = 0 if ci == 0 else n_tables - 1
        parts.append(writer.sos([(cid, 0, t)], ss=1, se=63))
        parts.append(ac_entropy[ci])
    parts.append(writer.eoi())
    return b"".join(parts)


JpegEncoder._assemble_progressive = _assemble_progressive
