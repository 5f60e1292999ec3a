"""PNG files with numpy and zlib alone: the 8-bit RGB writer behind the map
renders, and a 16-bit greyscale codec for TUM depth images (the
reference reads and writes those with cv2, which the port does without).

The 16-bit codec covers what depth PNGs use: colour type 0 (greyscale), bit
depth 16, big-endian samples, no interlace. The decoder undoes all five
row filters (None, Sub, Up, Average, Paeth), since the tools that wrote the
TUM files choose a filter per row, checks every chunk's CRC, and raises on
anything else (another colour type or bit depth, an interlaced image, a
truncated stream) rather than return an image it did not read.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTERS = ("none", "sub", "up", "average", "paeth")


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _write(path: str, w: int, h: int, bit_depth: int, colour: int,
           rows: np.ndarray) -> None:
    """Signature, IHDR, one zlib IDAT of the filtered rows (each led by
    its filter byte), IEND."""
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE
                 + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth,
                                               colour, 0, 0, 0))
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                 + _chunk(b"IEND", b""))


def write_rgb8(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG of unfiltered rows."""
    h, w, _ = rgb.shape
    _write(path, w, h, 8, 2, np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(img: np.ndarray, types: np.ndarray) -> np.ndarray:
    """(H, W) uint16 -> the (H, 1 + 2W) rows of its PNG stream, row r
    filtered with types[r] (indices into FILTERS), each led by its filter
    byte. A filter reads the unfiltered image only, so every row can take
    its own."""
    h, w = img.shape
    x = img.astype(">u2").view(np.uint8).reshape(h, w, 2).astype(np.int32)
    # a: the byte one pixel left, b: the byte above, c: above-left (0
    # outside the image), all of the unfiltered image
    a = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    b = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]
    c = np.pad(x, ((1, 0), (1, 0), (0, 0)))[:-1, :-1]
    t = np.asarray(types, np.uint8)[:, None, None]
    pred = np.select([t == 1, t == 2, t == 3, t == 4],
                     [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
    filtered = ((x - pred) & 0xFF).astype(np.uint8).reshape(h, 2 * w)
    return np.concatenate([t[:, :, 0], filtered], axis=1)


def write_gray16(path: str, img: np.ndarray) -> None:
    """(H, W) uint16 -> a 16-bit greyscale PNG, every row filtered with Up
    (depth images change little from row to row)."""
    if img.dtype != np.uint16 or img.ndim != 2:
        raise ValueError(f"write_gray16 takes (H, W) uint16, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape
    _write(path, w, h, 16, 0, filter_rows(img, np.full(h, 2)))


def _chunks(buf: bytes):
    """(tag, data) of each chunk, CRCs checked."""
    if buf[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(buf):
        if pos + 12 > len(buf):
            raise ValueError("truncated PNG chunk")
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if len(data) != length or zlib.crc32(tag + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad length or CRC")
        yield tag, data
        pos += 12 + length
        if tag == b"IEND":
            return
    raise ValueError("PNG file without IEND")


def _unfilter(ftypes: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Undo the row filters of (H, W, 2) filtered bytes, row types (H,).
    Rows filtered with None, Sub and Up only are undone a row at a time;
    Average and Paeth need the reconstructed byte to the left as well as
    the row above, so those images are undone along anti-diagonals, every
    pixel of one diagonal at once."""
    h, w, bpp = data.shape
    if ftypes.max() <= 2:
        out = np.empty_like(data)
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            t = ftypes[r]
            if t == 0:
                out[r] = data[r]
            elif t == 1:
                out[r] = np.cumsum(data[r], axis=0, dtype=np.uint8)
            else:
                out[r] = data[r] + prev
            prev = out[r]
        return out
    x = data.astype(np.int32)
    # pixel (r, i) lives at (r + 1, i + 1): row 0 and column 0 are the
    # zeros outside the image
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)
    types = ftypes.astype(np.int32)[:, None]
    for t in range(h + w - 1):
        r = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        i = t - r
        a, b, c = rec[r + 1, i], rec[r, i + 1], rec[r, i]
        ft = types[r]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[r + 1, i + 1] = (x[r, i] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def read_gray16(path: str) -> np.ndarray:
    """A 16-bit greyscale PNG -> (H, W) uint16."""
    with open(path, "rb") as fh:
        buf = fh.read()
    header, idat = None, []
    for tag, data in _chunks(buf):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, compression, filter_method, interlace = header
    if (depth, colour) != (16, 0):
        raise ValueError(f"{path}: bit depth {depth}, colour type {colour}; "
                         "only 16-bit greyscale is read")
    if interlace != 0 or compression != 0 or filter_method != 0:
        raise ValueError(f"{path}: interlace {interlace}, compression "
                         f"{compression}, filter method {filter_method}; "
                         "only non-interlaced standard PNGs are read")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"{path}: bad image data ({exc})") from exc
    if len(raw) != h * (1 + 2 * w):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, expected "
                         f"{h * (1 + 2 * w)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 2 * w)
    if rows[:, 0].max(initial=0) >= len(FILTERS):
        raise ValueError(f"{path}: unknown row filter {rows[:, 0].max()}")
    data = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, 2))
    return data.reshape(h, 2 * w).view(">u2").astype(np.uint16)
