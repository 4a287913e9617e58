"""Core data model: parsed JPEG structure and the coefficient-plane IR.

The reference keeps this state in C structs scattered across headers
(`FrameHeader` `/root/reference/src/frame_header.h:36-43`, `ScanHeader`
`scan_header.h:11-18`, `QuantTable` `quant_table.h:7-10`, `HuffTable`
`huff_table.h:9-14`, the progressive coefficient `Buffer` `decode.c:20-25`).
Here the same information is immutable dataclasses plus NumPy arrays, and the
central intermediate representation is explicit: per-component zigzag-order
coefficient planes of shape [blocks_y, blocks_x, 64] (int16, COEF_DTYPE), the device-friendly
generalization of the reference's progressive Buffer that we use for *all*
decode paths (SURVEY.md §7 architecture principle).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..io.markers import Encoding

# Natural-order index of the i-th zigzag position; identical table to
# `/root/reference/src/quant_table.c:25-34`, derived here instead of typed in.
def _make_zigzag() -> np.ndarray:
    order = np.empty(64, dtype=np.int32)
    idx = 0
    for s in range(15):  # anti-diagonal index r+c = s
        # Even diagonals are walked up-right (row decreasing), odd diagonals
        # down-left (row increasing), starting from (0,0)->(0,1).
        rng = range(s, -1, -1) if s % 2 == 0 else range(s + 1)
        for r in rng:
            c = s - r
            if r < 8 and c < 8:
                order[idx] = r * 8 + c
                idx += 1
    return order


ZIGZAG = _make_zigzag()  # ZIGZAG[i] = natural index of i-th zigzag coefficient
INV_ZIGZAG = np.argsort(ZIGZAG).astype(np.int32)  # natural -> zigzag position


@dataclasses.dataclass(frozen=True)
class Component:
    """One frame component (reference `Component` frame_header.h:27-34)."""

    id: int  # component identifier byte
    hsf: int  # horizontal sampling factor
    vsf: int  # vertical sampling factor
    qtid: int  # quantization table id
    x: int  # component width  = ceil(X * hsf/hmax)  (frame_header.c:52)
    y: int  # component height = ceil(Y * vsf/vmax)  (frame_header.c:54)

    @property
    def blocks_x(self) -> int:
        """Blocks per row at MCU padding (decode.c:76-78)."""
        pad = 8 * self.hsf
        return ((self.x + pad - 1) // pad) * pad // 8

    @property
    def blocks_y(self) -> int:
        pad = 8 * self.vsf
        return ((self.y + pad - 1) // pad) * pad // 8

    @property
    def stride(self) -> int:
        """MCU-padded plane width in pixels (decode.c:108-110)."""
        return self.blocks_x * 8

    @property
    def rows(self) -> int:
        """MCU-padded plane height in pixels."""
        return self.blocks_y * 8


@dataclasses.dataclass(frozen=True)
class FrameHeader:
    """Parsed SOFn payload (reference FrameHeader frame_header.h:36-43)."""

    process: Encoding
    precision: int  # sample precision: 8 or 12
    width: int  # X
    height: int  # Y (may be 0 until DNL)
    components: tuple[Component, ...]
    # APP14 "Adobe" color-transform byte, attached by the parser for
    # 4-component frames only (0 = raw CMYK stored inverted, 2 = YCCK;
    # None = no Adobe marker). The reference ignores APP14 and always runs
    # its YCCK composite (yccb_rgb, colour_conversion.c:85-162); under
    # Quirks.CORRECT the color stage honors transform=0.
    adobe_transform: int | None = None

    @property
    def ncs(self) -> int:
        return len(self.components)

    @property
    def max_hsf(self) -> int:
        return max(c.hsf for c in self.components)

    @property
    def max_vsf(self) -> int:
        return max(c.vsf for c in self.components)

    @property
    def mcus_x(self) -> int:
        return -(-self.width // (8 * self.max_hsf))

    @property
    def mcus_y(self) -> int:
        return -(-self.height // (8 * self.max_vsf))

    def find_component(self, comp_id: int) -> tuple[int, Component]:
        for i, c in enumerate(self.components):
            if c.id == comp_id:
                return i, c
        from ..utils.errors import JpegFormatError

        raise JpegFormatError(f"no frame component with id {comp_id}")

    def with_height(self, height: int, reference_quirks: bool = True) -> "FrameHeader":
        """DNL redefines Y (frame_header.c:60-75); component dims re-derive
        with the same ceil rule the parser used (float32 under REFERENCE
        quirks, integer ceil otherwise)."""
        max_v = self.max_vsf
        comps = tuple(
            dataclasses.replace(
                c,
                y=(
                    int(
                        np.ceil(
                            np.float32(height)
                            * (np.float32(c.vsf) / np.float32(max_v))
                        )
                    )
                    if reference_quirks
                    else -(-height * c.vsf // max_v)
                ),
            )
            for c in self.components
        )
        return dataclasses.replace(self, height=height, components=comps)


@dataclasses.dataclass(frozen=True)
class ScanComponent:
    """Per-component scan parameters (reference ImageComponent scan_header.h:5-9)."""

    sc: int  # component selector (frame component id)
    dc: int  # DC entropy table id
    ac: int  # AC entropy table id


@dataclasses.dataclass(frozen=True)
class ScanHeader:
    """Parsed SOS payload (reference ScanHeader scan_header.h:11-18)."""

    components: tuple[ScanComponent, ...]
    ss: int  # spectral selection start
    se: int  # spectral selection end
    ah: int  # successive approximation bit high
    al: int  # successive approximation bit low

    @property
    def nics(self) -> int:
        return len(self.components)


@dataclasses.dataclass(frozen=True)
class QuantTable:
    """One DQT table, stored in NATURAL order (the reference de-zigzags at
    parse time, quant_table.c:108-114)."""

    precision: int  # 0 = 8-bit entries, 1 = 16-bit
    values: np.ndarray  # (64,) uint16, natural order

    def __post_init__(self) -> None:
        assert self.values.shape == (64,)


@dataclasses.dataclass(frozen=True)
class HuffTableSpec:
    """One DHT table as transmitted: BITS (16 counts) + HUFFVAL (symbols).

    This is the serialization-level view; decode-side acceleration structures
    (canonical codes, flat LUTs) are built from it in core/huffman.py.
    Reference parse: huff_table.c:165-261.
    """

    table_class: int  # 0 = DC, 1 = AC
    table_id: int  # 0..3
    counts: np.ndarray  # (16,) uint8 — codes per length 1..16
    symbols: np.ndarray  # (sum(counts),) uint8

    def __post_init__(self) -> None:
        assert self.counts.shape == (16,)
        assert int(self.counts.sum()) == self.symbols.shape[0]


@dataclasses.dataclass(frozen=True)
class EntropySpan:
    """Byte range of one scan's entropy-coded data, plus restart cut points.

    The reference discovers restart markers serially during the decode loop
    (`check_marker` bitstream.c:84-134); we gather all RSTn offsets up front
    with a vectorized byte scan — they are the segment-parallel seam.
    """

    start: int  # offset of first entropy byte (just past SOS header)
    end: int  # offset one past the last entropy byte (at next marker)
    restart_offsets: np.ndarray  # (n,) int64 — offsets of the 0xFF of each RSTn
    # Offsets of every stuffed 0xFF in the span (ascending; feeds the
    # native index-driven unstuff). None when the prescan's stuff buffer
    # overflowed — decode falls back to per-segment memchr unstuffing.
    stuff_offsets: np.ndarray | None = None

    @property
    def num_segments(self) -> int:
        return int(self.restart_offsets.shape[0]) + 1

    def segment_bounds(self) -> list[tuple[int, int]]:
        """[(start, end)] of each restart segment's entropy bytes, with the
        2-byte RSTn markers excluded."""
        bounds = []
        s = self.start
        for off in self.restart_offsets.tolist():
            bounds.append((s, off))
            s = off + 2
        bounds.append((s, self.end))
        return bounds

    def segment_bounds_flat(self) -> np.ndarray:
        """segment_bounds() as the flat [2*n_segments] int64 array the
        native runtime consumes, built vectorized (the Python tuple walk
        costs ~35 us per 4K image on the host hot path)."""
        r = self.restart_offsets
        n = r.shape[0] + 1
        flat = np.empty(2 * n, dtype=np.int64)
        flat[0] = self.start
        flat[2::2] = r + 2  # starts: just past each RSTn
        flat[1:-1:2] = r    # ends: at each RSTn
        flat[-1] = self.end
        return flat


@dataclasses.dataclass(frozen=True)
class Scan:
    """One SOS: header + entropy span + table state snapshot at scan time.

    Tables are mutable stream state in JPEG (DHT/DQT/DRI can be redefined
    between scans; the reference keeps them as mutable locals in
    decode_jpeg_buffer decode.c:146-158), so each Scan carries the snapshot
    in force when its SOS appeared.
    """

    header: ScanHeader
    span: EntropySpan
    restart_interval: int
    dc_tables: dict[int, HuffTableSpec]
    ac_tables: dict[int, HuffTableSpec]
    quant_tables: dict[int, QuantTable]


@dataclasses.dataclass(frozen=True)
class JpegStructure:
    """Everything the marker walk learns about one JPEG byte stream."""

    frame: FrameHeader
    scans: tuple[Scan, ...]
    # Raw stream retained for entropy decode (zero-copy views into it).
    data: np.ndarray  # (len,) uint8
    # APPn/COM payloads, for metadata consumers: list of (marker, offset, bytes)
    app_segments: tuple[tuple[int, int, bytes], ...] = ()


#: Coefficient-plane element type. Quantized JPEG coefficients fit int16 for
#: every legal stream (8-bit: DC diff <= 11 bits, AC <= 10; 12-bit: <= 15/14
#: bits — T.81 Tables F.1/F.2), and halving the element size halves both the
#: host entropy stage's write bandwidth and the host->device transfer — the
#: two costs that bound pipeline throughput. Malformed streams that exceed
#: the range wrap identically in NumPy stores and C++ int16_t stores, so
#: cross-backend equality is preserved even on garbage input.
COEF_DTYPE = np.int16


class CoefficientPlanes:
    """The central IR: per-component quantized coefficients in zigzag order.

    Shape per component: [blocks_y, blocks_x, 64] int16 (COEF_DTYPE). This
    generalizes the reference's progressive Buffer (decode.c:20-25,
    allocate_mcus_progressive decode.c:67-93) to all decode paths: sequential
    scans fill it once, progressive scans accumulate into it, and the device
    pipeline consumes it (dequant + IDCT + color) in one fused pass per
    component.
    """

    def __init__(self, frame: FrameHeader):
        self.frame = frame
        self.planes: list[np.ndarray] = [
            np.zeros((c.blocks_y, c.blocks_x, 64), dtype=COEF_DTYPE)
            for c in frame.components
        ]

    def plane(self, i: int) -> np.ndarray:
        return self.planes[i]

    def __iter__(self):
        return iter(self.planes)


@dataclasses.dataclass
class DecodedImage:
    """Final decoded output.

    `planes` are the per-component MCU-padded uint8 planes (the reference's
    `Image` decode.h:12-17); `rgb` is the packed interleaved output after
    color conversion (the reference computes it into an SDL surface,
    jpeg_decoder.c:62-101).

    width/height are the FRAME dimensions. Under scaled decode
    (DecodeConfig.scale < 8) the output is smaller: rgb.shape carries the
    actual ceil(dim * scale / 8) output size.
    """

    frame: FrameHeader
    planes: list[np.ndarray]  # each (rows, stride) uint8 (or uint16 pre-scale)
    rgb: np.ndarray | None = None  # (height, width, 3) uint8

    @property
    def width(self) -> int:
        return self.frame.width

    @property
    def height(self) -> int:
        return self.frame.height


def standard_luminance_qtable() -> np.ndarray:
    """Annex K Table K.1 luminance quantization values, natural order."""
    zz = np.array(
        [16, 11, 10, 16, 24, 40, 51, 61,
         12, 12, 14, 19, 26, 58, 60, 55,
         14, 13, 16, 24, 40, 57, 69, 56,
         14, 17, 22, 29, 51, 87, 80, 62,
         18, 22, 37, 56, 68, 109, 103, 77,
         24, 35, 55, 64, 81, 104, 113, 92,
         49, 64, 78, 87, 103, 121, 120, 101,
         72, 92, 95, 98, 112, 100, 103, 99], dtype=np.uint16)
    return zz


def standard_chrominance_qtable() -> np.ndarray:
    """Annex K Table K.2 chrominance quantization values, natural order."""
    zz = np.array(
        [17, 18, 24, 47, 99, 99, 99, 99,
         18, 21, 26, 66, 99, 99, 99, 99,
         24, 26, 56, 99, 99, 99, 99, 99,
         47, 66, 99, 99, 99, 99, 99, 99,
         99, 99, 99, 99, 99, 99, 99, 99,
         99, 99, 99, 99, 99, 99, 99, 99,
         99, 99, 99, 99, 99, 99, 99, 99,
         99, 99, 99, 99, 99, 99, 99, 99], dtype=np.uint16)
    return zz


def component_dims_reference(
    X: int, Y: int, hsf: Sequence[int], vsf: Sequence[int]
) -> list[tuple[int, int]]:
    """Component dims with the reference's float32 ceil rule
    (frame_header.c:49-56): x = ceil(X * float(h)/hmax), y likewise."""
    hmax, vmax = max(hsf), max(vsf)
    out = []
    for h, v in zip(hsf, vsf):
        x = int(np.ceil(np.float32(X) * (np.float32(h) / np.float32(hmax))))
        y = int(np.ceil(np.float32(Y) * (np.float32(v) / np.float32(vmax))))
        out.append((x, y))
    return out
