"""PNG reading and writing with ``zlib`` and numpy, without OpenCV.

The decoder reads non-interlaced PNG of bit depth 8 or 16 in every colour
type: grey (0), RGB (2), palette (3), grey + alpha (4) and RGBA (6), with
all five row filters. The rows are unfiltered by the host library's
``png_unfilter`` (C++: the Sub, Average and Paeth filters are serial
along a row). Chunk CRCs are checked.

``imread_gray`` returns what ``cv2.imread(path, IMREAD_GRAYSCALE)`` returns
(libpng's transforms, as OpenCV sets them): 16-bit samples keep their high
byte; colour becomes grey with libpng's fixed-point weights, truncated,
``(9797 R + 19234 G + 3737 B) >> 15`` at 8 bits (a pixel with R = G = B
keeps R), and with rounding, ``(... + 16384) >> 15``, at 16 bits before
the high byte is kept; alpha is dropped; a palette is expanded first.
``imread_unchanged`` returns ``IMREAD_UNCHANGED``'s array: grey as stored
(uint8 or uint16), colour in OpenCV's BGR(A) order, grey + alpha as BGRA.

``write_png`` writes 8- or 16-bit grey ([H, W]), and 8- or 16-bit colour
given in OpenCV's BGR order ([H, W, 3]), every row with filter 0; OpenCV
reads its files back bit for bit.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: chunk {kind!r} is cut short or its "
                             f"CRC does not match")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: the PNG stream ends without IEND")


def read_png(path: str) -> np.ndarray:
    """The image as stored: [H, W] for grey, [H, W, C] otherwise (C = 2, 3
    or 4 in the file's G(A) / RGB(A) order; a palette is expanded to RGB,
    or RGBA if it has transparency), uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    hdr, idat, plte, trns = None, [], None, None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: colour type {ctype} at bit depth {depth} "
                         f"is not supported (bit depths 8 and 16 are)")
    if ctype == 3 and plte is None:
        raise ValueError(f"{path}: palette image without PLTE")
    from .. import host_native
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
        rows = host_native.png_unfilter(raw, H, W * bpp, bpp)
    except (zlib.error, ValueError) as e:
        raise ValueError(f"{path}: {e}") from e
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(H, W, ch)
    else:
        img = rows.reshape(H, W, ch)
    if ctype == 3:
        idx = img[..., 0]
        img = plte[idx]
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            alpha[:len(trns)] = trns[:len(plte)]
            img = np.concatenate([img, alpha[idx][..., None]], axis=-1)
    return img[..., 0] if img.shape[-1] == 1 else img


def imread_gray(path: str) -> np.ndarray:
    """[H, W] uint8, as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``."""
    img = read_png(path)
    sixteen = img.dtype == np.uint16
    if img.ndim == 3 and img.shape[-1] >= 3:
        r, g, b = (img[..., i].astype(np.int64) for i in range(3))
        if sixteen:
            img = (9797 * r + 19234 * g + 3737 * b + 16384) >> 15
        else:
            img = np.where((r == g) & (r == b), r,
                           (9797 * r + 19234 * g + 3737 * b) >> 15)
    elif img.ndim == 3:
        img = img[..., 0]                       # grey + alpha
    if sixteen:
        img = img >> 8
    return np.ascontiguousarray(img, np.uint8)


def imread_unchanged(path: str) -> np.ndarray:
    """As ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: grey as stored, uint8
    or uint16; colour in BGR or BGRA order."""
    img = read_png(path)
    if img.ndim == 3 and img.shape[-1] == 2:            # grey + alpha: BGRA
        img = img[..., [0, 0, 0, 1]]
    elif img.ndim == 3:
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    return np.ascontiguousarray(img)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG bytes of [H, W] grey or [H, W, 3] BGR, uint8 or uint16."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png takes uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        ctype, pix = 0, img[..., None]
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, pix = 2, img[..., ::-1]
    else:
        raise ValueError(f"write_png takes [H, W] or [H, W, 3], not "
                         f"{img.shape}")
    H, W = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    data = np.ascontiguousarray(pix, ">u2" if depth == 16 else np.uint8)
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           data.view(np.uint8).reshape(H, -1)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W] grey or [H, W, 3] BGR (uint8 or uint16) to path, zlib
    level 1 (the fastest: the writer serves test data and overlays)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
