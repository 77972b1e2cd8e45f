"""Radiance RGBE (.hdr) reader/writer in numpy.

Parity with the reference's stbi_loadf / stbi_write_hdr usage
(RTBase/Imaging.h:60-77, 262-271): reads both flat and
RLE-compressed RGBE scanlines, writes RLE scanlines, layout `-Y H +X W`.
"""
from __future__ import annotations

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(.., 4) uint8 RGBE -> (.., 3) float32."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(.., 3) float32 -> (.., 4) uint8 RGBE."""
    maxc = np.maximum(img[..., 0], np.maximum(img[..., 1], img[..., 2]))
    mant, expo = np.frexp(np.maximum(maxc, 1e-32))
    scale = mant * 256.0 / np.maximum(maxc, 1e-32)
    rgbe = np.zeros(img.shape[:-1] + (4,), np.uint8)
    valid = maxc >= 1e-32
    rgb = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., :3] = np.where(valid[..., None], rgb, 0)
    rgbe[..., 3] = np.where(valid, (expo + 128).astype(np.uint8), 0)
    return rgbe


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()
    # Header ends at an empty line, then the resolution line.
    pos = 0
    magic_ok = data.startswith(b"#?")
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if not magic_ok or len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported HDR layout {res!r}")
    height, width = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=pos)
    out = np.empty((height, width, 4), np.uint8)
    i = 0
    for y in range(height):
        if width < 8 or width > 0x7FFF or not (
                buf[i] == 2 and buf[i + 1] == 2
                and int(buf[i + 2]) * 256 + int(buf[i + 3]) == width):
            # Flat (possibly old-style RLE, not emitted by stb) scanlines.
            flat = buf[i:i + width * 4 * (height - y)].reshape(-1, 4)
            out[y:] = flat[: width * (height - y)].reshape(height - y, width, 4)
            i += width * 4 * (height - y)
            break
        i += 4
        for c in range(4):
            x = 0
            while x < width:
                count = int(buf[i]); i += 1
                if count > 128:  # run
                    out[y, x:x + count - 128, c] = buf[i]
                    i += 1
                    x += count - 128
                else:  # literal
                    out[y, x:x + count, c] = buf[i:i + count]
                    i += count
                    x += count
    return _rgbe_to_float(out)


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float32 linear radiance as RLE-compressed .hdr."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    rgbe = _float_to_rgbe(img)
    parts = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
             f"-Y {h} +X {w}\n".encode()]
    use_rle = 8 <= w <= 0x7FFF
    for y in range(h):
        if not use_rle:
            parts.append(rgbe[y].tobytes())
            continue
        parts.append(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
        for c in range(4):
            chan = rgbe[y, :, c]
            x = 0
            buf = bytearray()
            while x < w:
                # find run length at x
                run = 1
                while x + run < w and run < 127 and chan[x + run] == chan[x]:
                    run += 1
                if run >= 4:
                    buf.append(128 + run)
                    buf.append(int(chan[x]))
                    x += run
                else:
                    # literal until next run of >=4, capped at 128 bytes
                    start = x
                    x += run
                    while x < w and x - start < 128:
                        run = 1
                        while x + run < w and run < 4 and chan[x + run] == chan[x]:
                            run += 1
                        if run >= 4 or x - start + run > 128:
                            break
                        x += run
                    n = min(x - start, 128)
                    x = start + n
                    buf.append(n)
                    buf.extend(chan[start:start + n].tobytes())
            parts.append(bytes(buf))
    with open(path, "wb") as f:
        f.write(b"".join(parts))
