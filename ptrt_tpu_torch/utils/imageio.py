"""Image output: PPM (reference-compatible ASCII P3, or binary P6) and a
dependency-free PNG encoder — a copy of ``ptrt_tpu/utils/imageio.py``
(numpy and the standard library only, so the port keeps its own).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def save_ppm(path: str, img: np.ndarray, ascii_p3: bool = True) -> None:
    """img: (H, W, 3) uint8, row 0 = top."""
    img = np.asarray(img, np.uint8)
    h, w, _ = img.shape
    if ascii_p3:
        with open(path, "w") as f:
            f.write(f"P3\n{w} {h}\n255\n")
            flat = img.reshape(-1, 3)
            lines = [" ".join(map(str, px)) for px in flat]
            f.write("\n".join(lines))
            f.write("\n")
    else:
        with open(path, "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode())
            f.write(img.tobytes())


def load_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P6":
        parts = data.split(maxsplit=4)
        w, h = int(parts[1]), int(parts[2])
        raw = parts[4][: w * h * 3]
        return np.frombuffer(raw, np.uint8).reshape(h, w, 3)
    if data[:2] == b"P3":
        toks = data.split()
        w, h = int(toks[1]), int(toks[2])
        vals = np.array(toks[4 : 4 + w * h * 3], np.int32)
        return vals.astype(np.uint8).reshape(h, w, 3)
    raise ValueError("not a PPM file")


def save_png(path: str, img: np.ndarray) -> None:
    """Minimal RGB8 PNG encoder (no filtering)."""
    img = np.asarray(img, np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
