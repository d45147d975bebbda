"""PNG files in numpy and ``zlib`` (the port's stand-in for the JAX
package's ``cv2.imwrite`` and ``cv2.imread`` of PNGs).

``write_png`` takes an image as ``cv2.imwrite`` does: [H, W] grey, or
[H, W, 3] in BGR order (written as RGB), uint8 or uint16 (8- or 16-bit
samples, big-endian in the file).  ``read_png`` reads such a file back in
the same convention (``cv2.IMREAD_UNCHANGED``).  Rows are stored
unfiltered and without interlace; the reader takes what the writer makes
and raises, naming the file, on any other filter, interlace, palette or
alpha.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2}  # channels → PNG colour type (grey, RGB)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """Write a grey or BGR uint8/uint16 image as a PNG at ``path``."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png: uint8 or uint16 images only, got {img.dtype}")
    channels = 1 if img.ndim == 2 else img.shape[2] if img.ndim == 3 else 0
    if channels not in _COLOR_TYPES:
        raise ValueError(f"write_png: [H, W] or [H, W, 3] images only, got {img.shape}")
    h, w = img.shape[:2]
    if channels == 3:
        img = img[..., ::-1]  # BGR → RGB
    rows = np.ascontiguousarray(img, dtype=">u2" if img.dtype == np.uint16 else np.uint8).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1)  # filter 0 a row
    header = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, _COLOR_TYPES[channels], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """A PNG as ``write_png`` writes it → [H, W] or [H, W, 3] (BGR), uint8
    or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3}.get(color)
    if channels is None or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: only 8/16-bit grey or RGB PNGs without interlace are read "
                         f"(colour type {color}, depth {depth}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, -1)
    filters = np.unique(raw[:, 0])
    if filters.size and (filters != 0).any():
        raise ValueError(f"{path}: row filter types {filters.tolist()}; only unfiltered rows are read")
    dtype = np.dtype(">u2") if depth == 16 else np.dtype(np.uint8)
    img = np.ascontiguousarray(raw[:, 1:]).view(dtype).astype(dtype.newbyteorder("="))
    img = img.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else np.ascontiguousarray(img[..., ::-1])
