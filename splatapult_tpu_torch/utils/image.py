"""PNG image I/O for render outputs (numpy + zlib, no imaging library).

Replaces the reference's libpng loader/off-screen resolve (ref:
src/core/image.cpp:22-158, src/app.cpp:166-212): premultiplied-alpha handling,
optional linear -> sRGB encode on write, straight-alpha PNG output. The codec
covers what render outputs and training targets need: 8-bit, non-interlaced
grey / grey+alpha / RGB / RGBA.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> channels
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def composite_to_rgb(img, background=None, srgb_encode: bool = False):
    """[H, W, 4] premultiplied RGBA -> [H, W, 3] uint8-ready floats in [0, 1].

    ``background`` (RGB) is composited under the image the way the GL
    framebuffer clear color sits under the blended splats.
    """
    img = np.asarray(img, np.float32)
    rgb = img[..., :3]
    alpha = img[..., 3:4]
    if background is not None:
        bg = np.asarray(background, np.float32).reshape(1, 1, 3)
        rgb = rgb + (1.0 - alpha) * bg
    if srgb_encode:
        rgb = np.where(
            rgb <= 0.0031308,
            rgb * 12.92,
            1.055 * np.power(np.clip(rgb, 1e-12, None), 1.0 / 2.4) - 0.055,
        )
    return np.clip(rgb, 0.0, 1.0)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _write_png8(path: str, pixels: np.ndarray) -> None:
    """uint8 [H, W, C] (C in 1..4) -> PNG file, filter type 0 on every row."""
    h, w, c = pixels.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), pixels.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def save_png(path: str, img, background=(0.0, 0.0, 0.0), srgb_encode: bool = False,
             keep_alpha: bool = False) -> None:
    """Write [H, W, 4] premultiplied RGBA (or [H, W, 3] RGB) to a PNG."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[-1] == 4 and keep_alpha:
        alpha = np.clip(img[..., 3], 0.0, 1.0)
        # un-premultiply for straight-alpha PNG
        rgb = np.clip(img[..., :3] / np.maximum(alpha[..., None], 1e-6), 0.0, 1.0)
        if srgb_encode:
            rgb = composite_to_rgb(
                np.concatenate([rgb, np.ones_like(alpha)[..., None]], -1),
                srgb_encode=True,
            )
        out = np.concatenate([rgb, alpha[..., None]], axis=-1)
    elif img.shape[-1] == 4:
        out = composite_to_rgb(img, background=background, srgb_encode=srgb_encode)
    else:
        out = np.clip(img, 0.0, 1.0)
    _write_png8(path, (out * 255.0 + 0.5).astype(np.uint8))


def _unfilter(data: bytes, h: int, w: int, c: int) -> np.ndarray:
    """Undo the per-row PNG filters -> uint8 [H, W, C]."""
    stride = w * c
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per channel
            cur = np.cumsum(line.reshape(w, c), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: sequential in x
            cur = np.zeros(stride, np.int64)
            for i in range(stride):
                a = cur[i - c] if i >= c else 0
                b = prev[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    cc = prev[i - c] if i >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, c)


def _read_png8(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced grey/RGB(A) PNGs are "
            f"supported (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace})")
    c = _CHANNELS[ctype]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, c)
    return pixels[..., 0] if c == 1 else pixels


def load_png(path: str, premultiply: bool = True, flip: bool = False) -> np.ndarray:
    """PNG -> [H, W, C] float32 in [0, 1] ([H, W] for greyscale).

    Parity with the reference loader (ref: src/core/image.cpp:104-158):

    - ``premultiply``: images with an alpha channel (RGBA or LA) get their
      color channels multiplied by alpha (ref Image::MultiplyAlpha,
      src/core/image.cpp:128-158) — the renderer composites against
      *premultiplied* RGBA, so PNG targets must enter in the same space.
      No-op for alpha-less images.
    - ``flip``: the reference copies rows bottom-up because GL textures have
      row 0 at the bottom (src/core/image.cpp:110). This framework's images
      are row-0-top throughout, so the default keeps top-down order;
      pass flip=True for GL-ordered consumers.
    """
    img = _read_png8(path).astype(np.float32) / 255.0
    if flip:
        img = img[::-1].copy()
    if premultiply and img.ndim == 3 and img.shape[-1] in (2, 4):
        img = np.concatenate(
            [img[..., :-1] * img[..., -1:], img[..., -1:]], axis=-1
        )
    return img
