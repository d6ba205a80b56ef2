"""Radiance .hdr (RGBE) decoder and writer — a copy of
``ptrt_tpu/utils/hdr.py`` (numpy only, so the port keeps its own).

Supports the standard 32-bit_rle_rgbe format: both flat scanlines and
new-style RLE.  ``load_hdr`` returns linear float32 (H, W, 3).
"""

from __future__ import annotations

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()

    # header
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = 0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    # resolution line
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution line {res}")
    h = int(res[1])
    w = int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((h, w, 4), np.uint8)
    off = 0

    if w < 8 or w > 0x7FFF:
        flat = buf[: h * w * 4].reshape(h, w, 4)
        rgbe[:] = flat
    else:
        for y in range(h):
            if off + 4 > len(buf):
                raise ValueError("truncated HDR")
            if (buf[off] == 2 and buf[off + 1] == 2
                    and ((int(buf[off + 2]) << 8) | int(buf[off + 3])) == w):
                off += 4
                # new RLE: four separated channel streams
                for c in range(4):
                    x = 0
                    while x < w:
                        count = int(buf[off])
                        off += 1
                        if count > 128:  # run
                            rgbe[y, x: x + count - 128, c] = buf[off]
                            off += 1
                            x += count - 128
                        else:  # literal
                            rgbe[y, x: x + count, c] = buf[off: off + count]
                            off += count
                            x += count
            else:
                # flat scanline (possibly old-style RLE, not handled)
                row = buf[off: off + w * 4].reshape(w, 4)
                rgbe[y] = row
                off += w * 4

    mantissa = rgbe[..., :3].astype(np.float32)
    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.ldexp(1.0, exponent - 128 - 8).astype(np.float32)
    out = mantissa * scale[..., None]
    out[exponent == 0] = 0.0
    return out


def save_hdr(path: str, img: np.ndarray) -> None:
    """Flat (non-RLE) RGBE writer, mostly for tests."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    nz = maxc > 1e-32
    m, e = np.frexp(np.maximum(maxc, 1e-32))
    scale = np.where(nz, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    mant = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    exp = np.where(nz, e + 128, 0).astype(np.uint8)
    rgbe = np.concatenate([mant, exp[..., None]], axis=-1)
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + \
        f"-Y {h} +X {w}\n".encode()
    with open(path, "wb") as f:
        f.write(header)
        f.write(rgbe.astype(np.uint8).tobytes())
