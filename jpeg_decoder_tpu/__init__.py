"""jpeg_decoder_tpu — a JPEG engine for accelerators (JAX/XLA + C++ runtime).

A from-scratch re-design of the capabilities of the reference C decoder
(Tommy-Sand/jpeg-decoder) for accelerator hardware:

  * restart-segment-parallel entropy decode (native C++ runtime or NumPy),
  * fused dequant + dezigzag + 8x8 IDCT as XLA device programs over
    device-resident coefficient planes,
  * fused chroma-upsample + YCbCr->RGB color kernel,
  * a working encoder (FDCT + quantize + Huffman pack) — the reference's is
    a non-functional stub,
  * correct progressive decode — the reference's is broken,
  * batch/stripe sharding over jax.sharding Meshes for multi-device scale-out.

Public API:
    decode(data)            -> DecodedImage          (full pipeline)
    decode_oracle(data)     -> DecodedImage          (bit-serial conformance oracle)
    encode(rgb, cfg)        -> bytes                 (baseline JPEG)
    parse(data)             -> JpegStructure         (marker walk only)
"""

from .utils.config import (  # noqa: F401
    DecodeConfig,
    EncodeConfig,
    EntropyBackend,
    IdctPrecision,
    Quirks,
)
from .utils.errors import (  # noqa: F401
    JpegEntropyError,
    JpegError,
    JpegFormatError,
    JpegTruncatedError,
    JpegUnsupportedError,
)
from .core.types import CoefficientPlanes, DecodedImage, FrameHeader, JpegStructure  # noqa: F401
from .io.parser import parse  # noqa: F401
from .core.oracle import decode as decode_oracle  # noqa: F401

__version__ = "0.6.0"


def decode(data, cfg=None):
    """Decode a JPEG byte stream with the full pipeline (host entropy stage +
    device dequant/IDCT/color kernels). See models/decoder.py."""
    from .models.decoder import JpegDecoder

    return JpegDecoder(cfg).decode(data)


def decode_file(path, cfg=None):
    """Decode a JPEG file via a zero-copy np.memmap (streaming input: peak
    RSS bounded by planes + output, not file size). See models/decoder.py."""
    from .models.decoder import decode_file as _df

    return _df(path, cfg)


def encode(rgb, cfg=None):
    """Encode an RGB (or grayscale) uint8 array to baseline JPEG bytes."""
    from .models.encoder import JpegEncoder

    return JpegEncoder(cfg).encode(rgb)


def host_decode_batch(datas, cfg=None, pool=None, max_workers=0):
    """Concurrent host stage (parse + entropy -> coefficient planes) across
    images — the serving form for streams whose per-image parallelism is
    limited (progressive scans are bit-serial chains). Yields
    (frame, planes, qts) in input order. See models/decoder.py."""
    from .models.decoder import host_decode_batch as _b

    return _b(datas, cfg, pool, max_workers)
