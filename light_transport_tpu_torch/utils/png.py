"""PNG images with the standard library only (``zlib`` and ``struct``).

The CLI and the GUI write their renders through :func:`encode_png`, so
neither needs matplotlib or Pillow.  The pixels are ``plt.imsave``'s for
the same float image: clipped to [0, 1], scaled by 255 in the image's own
dtype and truncated to 8 bits, alpha 255 (RGBA, 8 bits a channel).
:func:`decode_png` reads such a file back.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def quantize(img) -> np.ndarray:
    """``(H, W, 3)`` float image (numpy or a tensor on any device) ->
    ``(H, W, 4)`` uint8 RGBA as ``plt.imsave`` quantizes it."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    x = np.clip(np.asarray(img), 0, 1)
    rgba = np.empty(x.shape[:2] + (4,), np.uint8)
    rgba[..., :3] = (x * 255).astype(np.uint8)
    rgba[..., 3] = 255
    return rgba


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """The PNG file of a float image (see :func:`quantize`)."""
    rgba = quantize(img)
    h, w = rgba.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgba.reshape(h, w * 4)], axis=1)  # filter 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img) -> str:
    """Write :func:`encode_png` of ``img`` to ``path``; returns the path."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def decode_png(data: bytes) -> np.ndarray:
    """``(H, W, 4)`` uint8 pixels of a PNG as :func:`encode_png` writes it
    (8-bit RGBA, not interlaced, every row of filter 0)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = hdr
    if (depth, color, interlace) != (8, 6, 0):
        raise ValueError(f"only 8-bit RGBA, not interlaced: {hdr}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, w * 4 + 1)
    if rows[:, 0].any():
        raise ValueError("only rows of filter 0")
    return rows[:, 1:].reshape(h, w, 4).copy()
