"""JPEG marker constants (ITU-T T.81 Table B.1).

Reference parity: the marker dispatch switch in the reference decoder
(`/root/reference/src/decode.c:160-409`) recognizes exactly the markers below.
This module is the single source of truth for marker codes in this engine.
"""

from __future__ import annotations

import enum


class Marker(enum.IntEnum):
    """Second byte of a 0xFF-prefixed JPEG marker."""

    # Start-of-frame markers, non-differential, Huffman coding
    SOF0 = 0xC0  # Baseline DCT
    SOF1 = 0xC1  # Extended sequential DCT
    SOF2 = 0xC2  # Progressive DCT
    SOF3 = 0xC3  # Lossless (sequential)
    # Start-of-frame markers, differential, Huffman coding
    SOF5 = 0xC5
    SOF6 = 0xC6
    SOF7 = 0xC7
    # Start-of-frame markers, arithmetic coding
    JPG = 0xC8
    SOF9 = 0xC9
    SOF10 = 0xCA
    SOF11 = 0xCB
    SOF13 = 0xCD
    SOF14 = 0xCE
    SOF15 = 0xCF

    DHT = 0xC4  # Define Huffman table(s)
    DAC = 0xCC  # Define arithmetic coding conditioning

    RST0 = 0xD0
    RST1 = 0xD1
    RST2 = 0xD2
    RST3 = 0xD3
    RST4 = 0xD4
    RST5 = 0xD5
    RST6 = 0xD6
    RST7 = 0xD7

    SOI = 0xD8  # Start of image
    EOI = 0xD9  # End of image
    SOS = 0xDA  # Start of scan
    DQT = 0xDB  # Define quantization table(s)
    DNL = 0xDC  # Define number of lines
    DRI = 0xDD  # Define restart interval
    DHP = 0xDE  # Define hierarchical progression
    EXP = 0xDF  # Expand reference component(s)

    APP0 = 0xE0
    APP1 = 0xE1
    APP2 = 0xE2
    APP3 = 0xE3
    APP4 = 0xE4
    APP5 = 0xE5
    APP6 = 0xE6
    APP7 = 0xE7
    APP8 = 0xE8
    APP9 = 0xE9
    APP10 = 0xEA
    APP11 = 0xEB
    APP12 = 0xEC
    APP13 = 0xED
    APP14 = 0xEE
    APP15 = 0xEF

    COM = 0xFE  # Comment

    JPG0 = 0xF0
    JPG13 = 0xFD

    TEM = 0x01


SOF_MARKERS = frozenset(
    {
        Marker.SOF0,
        Marker.SOF1,
        Marker.SOF2,
        Marker.SOF3,
        Marker.SOF5,
        Marker.SOF6,
        Marker.SOF7,
        Marker.SOF9,
        Marker.SOF10,
        Marker.SOF11,
        Marker.SOF13,
        Marker.SOF14,
        Marker.SOF15,
    }
)

APP_MARKERS = frozenset(range(Marker.APP0, Marker.APP15 + 1))
RST_MARKERS = frozenset(range(Marker.RST0, Marker.RST7 + 1))


def is_rst(marker: int) -> bool:
    return Marker.RST0 <= marker <= Marker.RST7


def is_app(marker: int) -> bool:
    return Marker.APP0 <= marker <= Marker.APP15


def is_sof(marker: int) -> bool:
    return marker in SOF_MARKERS


class Encoding(enum.Enum):
    """Frame encoding process, mirroring the reference's 14-value enum.

    Reference parity: `Encoding` at `/root/reference/src/frame_header.h:5-23`
    and its string form `encoding_str` at `frame_header.c:132-162`.
    """

    BASELINE_DCT = "BaselineDCT"
    EXTENDED_SEQUENTIAL_DCT = "ExtendedSequentialDCT"
    PROGRESSIVE_DCT = "ProgressiveDCT"
    LOSSLESS = "Lossless"
    DIFFERENTIAL_SEQUENTIAL_DCT = "DifferentialSequentialDCT"
    DIFFERENTIAL_PROGRESSIVE_DCT = "DifferentialProgressiveDCT"
    DIFFERENTIAL_LOSSLESS = "DifferentialLossless"
    EXTENDED_SEQUENTIAL_DCT_ARITHMETIC = "ExtendedSequentialDCTArithmetic"
    PROGRESSIVE_DCT_ARITHMETIC = "ProgressiveDCTArithmetic"
    LOSSLESS_ARITHMETIC = "LosslessArithmetic"
    DIFFERENTIAL_SEQUENTIAL_DCT_ARITHMETIC = "DifferentialSequentialDCTArithmetic"
    DIFFERENTIAL_PROGRESSIVE_DCT_ARITHMETIC = "DifferentialProgressiveDCTArithmetic"
    DIFFERENTIAL_LOSSLESS_ARITHMETIC = "DifferentialLosslessArithmetic"
    UNKNOWN = "Unknown"


SOF_TO_ENCODING = {
    Marker.SOF0: Encoding.BASELINE_DCT,
    Marker.SOF1: Encoding.EXTENDED_SEQUENTIAL_DCT,
    Marker.SOF2: Encoding.PROGRESSIVE_DCT,
    Marker.SOF3: Encoding.LOSSLESS,
    Marker.SOF5: Encoding.DIFFERENTIAL_SEQUENTIAL_DCT,
    Marker.SOF6: Encoding.DIFFERENTIAL_PROGRESSIVE_DCT,
    Marker.SOF7: Encoding.DIFFERENTIAL_LOSSLESS,
    Marker.SOF9: Encoding.EXTENDED_SEQUENTIAL_DCT_ARITHMETIC,
    Marker.SOF10: Encoding.PROGRESSIVE_DCT_ARITHMETIC,
    Marker.SOF11: Encoding.LOSSLESS_ARITHMETIC,
    Marker.SOF13: Encoding.DIFFERENTIAL_SEQUENTIAL_DCT_ARITHMETIC,
    Marker.SOF14: Encoding.DIFFERENTIAL_PROGRESSIVE_DCT_ARITHMETIC,
    Marker.SOF15: Encoding.DIFFERENTIAL_LOSSLESS_ARITHMETIC,
}

# SOF processes the engine can actually decode (reference decodes SOF0/SOF1
# sequential scans and allocates-but-mishandles SOF2; we decode all three).
SUPPORTED_ENCODINGS = frozenset(
    {
        Encoding.BASELINE_DCT,
        Encoding.EXTENDED_SEQUENTIAL_DCT,
        Encoding.PROGRESSIVE_DCT,
    }
)
