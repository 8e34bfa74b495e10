"""Host-side image output — replaces the reference's OpenCV imshow/imwrite
GUI path (reference: src/rfimage.h:142-159) with headless PNG saving.

The PNG codec is the standard library's ``zlib`` + ``struct``: 8-bit
grayscale, one IDAT chunk, filter type 0 on every row."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_u8(img: np.ndarray) -> np.ndarray:
    """Float [0,1] -> u8, matching cv::Mat::convertTo(CV_8U, 255) saturation
    (src/rfimage.h:146): scale, round-half-to-even, clamp; NaN -> 0."""
    x = np.asarray(img, np.float64) * 255.0
    x = np.nan_to_num(x, nan=0.0)
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data))
    )


def save_png(path: str, img: np.ndarray) -> None:
    """Write a float [0,1] image as an 8-bit grayscale PNG at ``path``."""
    arr = to_u8(img)
    h, w = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr], axis=1)  # filter 0
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def load_png(path: str) -> np.ndarray:
    """Read back a PNG written by ``save_png`` as a (H, W) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, depth, color = header[:4]
    if (depth, color) != (8, 0):
        raise ValueError(f"{path}: only 8-bit grayscale PNGs are supported")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only PNG filter type 0 is supported")
    return rows[:, 1:].copy()
