"""Encoded image bytes -> (H, W, 3) uint8, as PIL's
`np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))` gives them.

Counterpart of the image decoding of `lhrs_bot_tpu/serve/api.py`
(`_decode_data_url` and the handler's `decode_b64`), which uses PIL. PNG is
decoded here on `zlib`, so the serving path needs no PIL: 8-bit gray, gray
+ alpha, RGB, RGBA and palette images (palette indices of 1, 2, 4 or 8
bits), all five row filters, every chunk's CRC checked; alpha is dropped
as `convert("RGB")` drops it. Any other format goes through PIL where PIL
can be imported. Interlaced, 16-bit, other unsupported or corrupt files,
and other formats without PIL, raise ValueError (the HTTP handler's 400).
As PIL does, the decoder refuses more than 2 x 89,478,485 pixels, read
from IHDR before anything is inflated; it inflates no more bytes than
IHDR's image holds and refuses a surplus.
"""

from __future__ import annotations

import base64
import io
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type -> samples
# PIL refuses an image above twice Image.MAX_IMAGE_PIXELS
# (DecompressionBombError); so does this decoder, before inflating it
MAX_PIXELS = 2 * 89_478_485


def _chunks(raw: bytes):
    """(type, data) of each chunk after the signature, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos < len(raw):
        if pos + 12 > len(raw):
            raise ValueError("PNG: truncated chunk header")
        (length,) = struct.unpack(">I", raw[pos:pos + 4])
        kind = raw[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(raw):
            raise ValueError(f"PNG: truncated {kind!r} chunk")
        data = raw[pos + 8:end]
        (crc,) = struct.unpack(">I", raw[end:end + 4])
        if zlib.crc32(kind + data) != crc:
            raise ValueError(f"PNG: bad CRC in the {kind!r} chunk")
        yield kind, data
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG: no IEND chunk")


def _wavefront(line: np.ndarray, kind: np.ndarray, above: np.ndarray,
               bpp: int) -> np.ndarray:
    """Reconstruct the (r, stride) filtered rows `line` (filter types
    `kind`, any of the five) below the reconstructed row `above`.

    Average and Paeth chain along a row, so the pixels go along the
    anti-diagonals of (row, pixel), every pixel of a diagonal at once. Two
    strided views make each diagonal a plain slice: V[i, j] = out[i, j -
    i] of the (r + 1, w + 1) output, whose row 0 is `above` and column 0
    zero, and L[y, d] = line[y, d - y]."""
    r, stride = line.shape
    w = stride // bpp
    out = np.zeros((r + 1, w + 1, bpp), np.uint8)
    out[0, 1:] = above.reshape(w, bpp)
    s0, s1, s2 = out.strides
    view = np.lib.stride_tricks.as_strided(
        out, (r + 1, r + w + 1, bpp), (s0 - s1, s1, s2))
    f = line.reshape(r, w, bpp)
    t0, t1, t2 = f.strides
    diag = np.lib.stride_tricks.as_strided(f, (r, r + w - 1, bpp),
                                           (t0 - t1, t1, t2))
    kind = kind.astype(np.intp)[:, None]
    for d in range(r + w - 1):
        lo, hi = max(0, d - w + 1), min(r - 1, d)
        # pixel (y, x) with x + y = d is view[y + 1, d + 2]; its left
        # neighbour view[y + 1, d + 1], above view[y, d + 1], above-left
        # view[y, d]
        a = view[lo + 1:hi + 2, d + 1].astype(np.int16)
        b = view[lo:hi + 1, d + 1].astype(np.int16)
        c = view[lo:hi + 1, d].astype(np.int16)
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.choose(kind[lo:hi + 1], (0, a, b, (a + b) >> 1, paeth))
        view[lo + 1:hi + 2, d + 2] = (diag[lo:hi + 1, d] + pred) & 0xFF
    return out[1:, 1:].reshape(r, stride)


def _unfilter(data: bytes, height: int, stride: int, bpp: int
              ) -> np.ndarray:
    """Undo the five PNG row filters: (height, stride) uint8 rows.

    Each byte is predicted from the reconstructed bytes to its left (bpp
    bytes back), above and above-left, by its row's filter: None 0, Sub
    left, Up above, Average (left + above) >> 1, Paeth. None, Sub (a
    prefix sum mod 256) and Up go a row at a time; the rows from the first
    Average or Paeth row to the last go through `_wavefront`."""
    rows = np.frombuffer(data, np.uint8).reshape(height, stride + 1)
    kind = rows[:, 0]
    if (kind > 4).any():
        raise ValueError(f"PNG: unknown row filter {int(kind.max())}")
    chained = np.flatnonzero(kind >= 3)
    first, last = ((chained[0], chained[-1] + 1) if chained.size
                   else (height, height))
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        if y == first:
            out[first:last] = _wavefront(rows[first:last, 1:],
                                         kind[first:last], prev, bpp)
        if first <= y < last:
            prev = out[y]
            continue
        line = rows[y, 1:]
        if kind[y] == 1:
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind[y] == 2:
            out[y] = line + prev
        else:
            out[y] = line
        prev = out[y]
    return out


def decode_png(raw: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 (see the module docstring)."""
    if not raw.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, data in _chunks(raw):
        if kind == b"IHDR":
            if len(data) != 13:
                raise ValueError("PNG: bad IHDR")
            header = struct.unpack(">IIBBBBB", data)
            if header[0] * header[1] > MAX_PIXELS:
                raise ValueError(f"PNG: {header[0]} x {header[1]} pixels is "
                                 f"more than the {MAX_PIXELS} accepted")
        elif kind == b"PLTE":
            if len(data) % 3:
                raise ValueError("PNG: bad PLTE")
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None or not idat:
        raise ValueError("PNG: no IHDR or no image data")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError("PNG: interlaced images are not supported")
    if color not in _CHANNELS:
        raise ValueError(f"PNG: bad color type {color}")
    if depth != 8 and not (color == 3 and depth in (1, 2, 4)):
        raise ValueError(f"PNG: bit depth {depth} with color type {color} "
                         "is not supported")
    if width == 0 or height == 0:
        raise ValueError("PNG: empty image")
    samples = _CHANNELS[color]
    stride = (width * samples * depth + 7) // 8
    expected = height * (stride + 1)
    try:  # inflate no more than the image holds, and one byte to tell
        data = zlib.decompressobj().decompress(b"".join(idat), expected + 1)
    except zlib.error as exc:
        raise ValueError(f"PNG: corrupt image data ({exc})") from None
    if len(data) > expected:
        raise ValueError(f"PNG: more image data than the {expected} bytes "
                         f"of a {width} x {height} image")
    if len(data) < expected:
        raise ValueError(f"PNG: image data is {len(data)} bytes, expected "
                         f"{expected}")
    rows = _unfilter(data, height, stride, max(1, samples * depth // 8))
    if color == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        idx = rows
        if depth < 8:  # pixel x sits depth bits at bit x * depth of its row
            bit = np.arange(width) * depth
            idx = (rows[:, bit // 8] >> (8 - depth - bit % 8).astype(
                np.uint8)) & ((1 << depth) - 1)
        if idx.max() >= len(palette):
            raise ValueError("PNG: palette index out of range")
        return palette[idx]
    px = rows.reshape(height, width, samples)
    if samples <= 2:  # gray, gray + alpha
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def decode_image(raw: bytes) -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8: PNG here, other formats
    through PIL where it can be imported; ValueError otherwise."""
    if raw.startswith(PNG_SIGNATURE):
        return decode_png(raw)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError("only PNG images can be decoded without PIL"
                         ) from None
    try:
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    except Exception as exc:  # noqa: BLE001 - PIL raises many types
        raise ValueError(f"undecodable image: {exc}") from None


def decode_b64(b64: str) -> np.ndarray:
    """A base64 string of an encoded image -> (H, W, 3) uint8."""
    try:
        raw = base64.b64decode(b64)
    except (ValueError, TypeError) as exc:
        raise ValueError(f"bad base64 image: {exc}") from None
    return decode_image(raw)


def decode_data_url(url: str) -> np.ndarray:
    """data:image/...;base64,XXX -> (H, W, 3) uint8 (OpenAI vision URLs);
    other URLs raise ValueError (the server fetches nothing)."""
    if not url.startswith("data:") or "," not in url:
        raise ValueError("only data: image URLs are supported "
                         "(no egress from the serving host)")
    return decode_b64(url.split(",", 1)[1])
