"""Image output (twin of `raytracing_tpu.utils.image`): PNG and NPY
writers of a rendered frame, and a PNG reader.

A frame may be a tensor on any device or a host array; it is quantized
where it lies (`ops.color.to_rgba_frame`) and the u8 frame is copied to
the host explicitly. PIL encodes and decodes where it is installed; the
self-contained encoder (`_write_png_raw`: 8-bit RGBA, one zlib stream, no
row filters) and its decoder (`_read_png_raw`) serve everywhere else.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from raytracing_tpu_torch.ops.color import to_rgba_frame

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def write_png(path: str, rgb) -> None:
    """Write [H, W, 3] float RGB (0..1-ish) to a PNG file."""
    frame = to_rgba_frame(rgb)
    try:
        from PIL import Image
    except ImportError:
        _write_png_raw(path, frame)
        return
    Image.fromarray(frame, mode="RGBA").save(path)


def _write_png_raw(path: str, rgba: np.ndarray) -> None:
    h, w = rgba.shape[:2]
    raw = b"".join(b"\x00" + rgba[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """[H, W, 4] u8 RGBA of a PNG file: PIL where it is installed, else
    `_read_png_raw`."""
    try:
        from PIL import Image
    except ImportError:
        return _read_png_raw(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def _read_png_raw(path: str) -> np.ndarray:
    """Decode what `_write_png_raw` writes: 8-bit RGBA, not interlaced,
    every row unfiltered. Raises ValueError for any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = len(_SIGNATURE), None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or ihdr[2:] != (8, 6, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGBA, non-interlaced PNG "
                         f"(IHDR {ihdr})")
    w, h = ihdr[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         dtype=np.uint8).reshape(h, 1 + 4 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows; only unfiltered rows are "
                         "decoded here")
    return rows[:, 1:].reshape(h, w, 4).copy()


def write_npy(path: str, rgb) -> None:
    """Write the float frame as it is, copied to the host."""
    if isinstance(rgb, torch.Tensor):
        rgb = rgb.detach().cpu().numpy()
    np.save(path, np.asarray(rgb))
