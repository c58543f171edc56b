"""Image output: PNG / NumPy / PFM (the JAX package's ``utils/image.py``).

Headless file output in place of the reference's GL display path
(CLRaytracer.cpp:63-81). PFM keeps the linear HDR radiance without an
OpenEXR dependency. Every writer takes a numpy array or a tensor on any
device.
"""

from __future__ import annotations

import numpy as np
import torch


def _numpy(image) -> np.ndarray:
    if isinstance(image, torch.Tensor):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def to_uint8(image) -> np.ndarray:
    """[H, W, 3] float (gamma-encoded, [0,1]-ish) -> uint8, clipped."""
    arr = _numpy(image)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, image) -> str:
    """Write a gamma-encoded [H, W, 3] image as PNG (PIL if available,
    else a minimal pure-Python PNG encoder)."""
    arr = to_uint8(image)
    try:
        from PIL import Image
    except ImportError:
        _write_png_pure(path, arr)
        return path
    Image.fromarray(arr).save(path)
    return path


def _write_png_pure(path: str, arr: np.ndarray) -> None:
    """Minimal RGB8 PNG writer (zlib + struct only)."""
    import struct
    import zlib

    h, w = arr.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def write_pfm(path: str, image) -> str:
    """Write linear radiance as PFM (portable float map: little-endian
    float32, rows bottom to top)."""
    arr = _numpy(image).astype("<f4")
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(np.ascontiguousarray(arr[::-1]).tobytes())
    return path


def write_npy(path: str, image) -> str:
    np.save(path, _numpy(image))
    return path
