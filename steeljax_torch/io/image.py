"""Image IO: LDR via Pillow, Radiance .hdr in numpy, PNG output with the
standard library.

Port of steeljax/io/image.py:18-89.  LDR images load as (H, W, 4) uint8
(raw unorm values; sRGB decoding happens in shading code), HDR images as
(H, W, 3) float32.  The reference writes PNGs through Pillow, which the
machine with the card does not have; `write_png` builds the PNG with zlib
and struct (8-bit RGB or RGBA, no interlace) and uses the reference's clamp
and rounding.  `load_ldr` imports Pillow when it is called.
"""

from __future__ import annotations

import io as _io
import struct
import zlib
from pathlib import Path

import numpy as np


def load_ldr(source: str | Path | bytes) -> np.ndarray:
    """Load an LDR image to (H, W, 4) uint8 RGBA."""
    from PIL import Image

    if isinstance(source, bytes):
        img = Image.open(_io.BytesIO(source))
    else:
        img = Image.open(source)
    return np.asarray(img.convert("RGBA"), np.uint8)


def _rle_scanline(buf: np.ndarray, offset: int, width: int,
                  out: np.ndarray) -> int:
    """Decode one adaptive-RLE scanline (four channel planes) into `out`
    ((width, 4) uint8); returns the offset past it."""
    for c in range(4):
        x = 0
        while x < width:
            count = int(buf[offset])
            offset += 1
            if count > 128:  # a run of one value
                out[x:x + count - 128, c] = buf[offset]
                offset += 1
                x += count - 128
            else:  # literal values
                out[x:x + count, c] = buf[offset:offset + count]
                offset += count
                x += count
    return offset


def load_hdr(path: str | Path) -> np.ndarray:
    """Radiance RGBE (.hdr) loader -> (H, W, 3) float32 linear; flat and
    adaptive-RLE scanlines, -Y +X orientation."""
    data = Path(path).read_bytes()
    # The header ends with an empty line; the resolution line follows.
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError("invalid radiance file: no header terminator")
    header = data[:pos].decode("ascii", "replace")
    if "32-bit_rle_rgbe" not in header and not header.startswith("#?"):
        raise ValueError("not a radiance RGBE file")
    rest = data[pos + 2:]
    nl = rest.find(b"\n")
    dims = rest[:nl].decode("ascii").split()
    if dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"unsupported radiance orientation {dims}")
    height, width = int(dims[1]), int(dims[3])
    buf = np.frombuffer(rest[nl + 1:], np.uint8)

    rgbe = np.zeros((height, width, 4), np.uint8)
    offset = 0
    for y in range(height):
        if (offset + 4 <= len(buf) and buf[offset] == 2
                and buf[offset + 1] == 2
                and ((int(buf[offset + 2]) << 8)
                     | int(buf[offset + 3])) == width):
            offset = _rle_scanline(buf, offset + 4, width, rgbe[y])
        else:
            rgbe[y] = buf[offset:offset + width * 4].reshape(width, 4)
            offset += width * 4

    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.where(exponent == 0, 0.0,
                     np.ldexp(1.0, exponent - 136)).astype(np.float32)
    rgb = (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]
    rgb[exponent == 0] = 0.0
    return rgb


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str | Path, image: np.ndarray) -> None:
    """Write an (H, W, 3|4) image; float inputs are clamped from [0, 1]."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"write_png needs (H, W, 3|4), got {arr.shape}")
    height, width, channels = arr.shape
    color_type = 2 if channels == 3 else 6
    # Each scanline is prefixed by filter type 0 (none).
    raw = np.concatenate(
        [np.zeros((height, 1), np.uint8),
         np.ascontiguousarray(arr).reshape(height, width * channels)],
        axis=1).tobytes()
    header = struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, 0)
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
