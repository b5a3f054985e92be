"""Image files (counterpart of wisp_tpu/ops/image/io.py ``write_png``). The PNG writer is
self-contained (zlib and the format's chunks): the card's machine has no PIL."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img) -> None:
    """An HWC image (uint8, or float in [0, 1]; 1, 3 or 4 channels) or an HW one as an
    8-bit PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        colour_type, arr = 0, arr[..., None]
    else:
        colour_type = {3: 2, 4: 6}[arr.shape[-1]]
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))
