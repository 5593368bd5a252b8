"""PNG without Pillow: the server's codec (the port's stand-in for the
Pillow calls in vdx/serving/server.py).

The card's machine has no Pillow, so the server encodes its response
frames and decodes a client's video2video frames with the standard
library (``zlib``, ``struct``) and numpy.

* :func:`encode_png` writes an 8-bit RGB PNG with filter type 0 (None)
  on every row, deflated at zlib level 6 (Pillow's default).
* :func:`decode_png` reads 8-bit, non-interlaced PNGs of colour types 0
  (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA) with any
  of the five row filters, and returns what Pillow's ``.convert("RGB")``
  returns: grey repeated into three channels, palette entries looked up,
  alpha dropped. Other bit depths and interlaced files raise
  ``ValueError``. :func:`decode_pngs` decodes a clip's frames together.

Sub and Up need only the row above and a running sum along the row, so
they are undone a row at a time. Average and Paeth depend on the pixel
to the left *after* its own reconstruction, a chain along the row. A
pixel (y, x) needs (y, x - 1), (y - 1, x) and (y - 1, x - 1) only, all
on the two anti-diagonals before its own (x + y = d - 1, d - 2). So
when any row uses Average or Paeth, the frames are reconstructed one
anti-diagonal at a time, every pixel of a diagonal (and every frame of
the same size) in one numpy step: H + W - 1 steps a frame size, each on
basic slices of a skewed copy in which diagonal d is column d.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> bytes a pixel at bit depth 8
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# a client's file larger than this raises, as Pillow's decompression-bomb
# check does (2 x Image.MAX_IMAGE_PIXELS)
MAX_PIXELS = 2 * 89_478_485


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(frame: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 [H, W, 3], got "
                         f"{frame.dtype} {list(frame.shape)}")
    H, W, _ = frame.shape
    raw = np.empty((H, 1 + 3 * W), np.uint8)
    raw[:, 0] = 0  # filter type None
    raw[:, 1:] = frame.reshape(H, 3 * W)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _parse(data: bytes):
    """PNG bytes -> (header fields, palette [256, 3] or None, filtered
    rows uint8 [H, 1 + W * bpp])."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.zeros((256, 3), np.uint8)
            entries = np.frombuffer(body, np.uint8).reshape(-1, 3)[:256]
            palette[:len(entries)] = entries
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    W, H, depth, ctype, compression, filt, interlace = header
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported (bit depth "
                         "8 only)")
    if interlace != 0:
        raise ValueError(f"PNG interlace method {interlace} is not supported "
                         "(non-interlaced files only)")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not one of "
                         f"{sorted(_CHANNELS)}")
    if compression != 0 or filt != 0:
        raise ValueError(f"PNG compression method {compression} / filter "
                         f"method {filt} is not 0")
    if ctype == 3 and palette is None:
        raise ValueError("PNG colour type 3 without a PLTE chunk")
    if W * H > MAX_PIXELS:
        raise ValueError(f"PNG image of {W}x{H} pixels is over the limit of "
                         f"{MAX_PIXELS}")
    bpp = _CHANNELS[ctype]
    size = H * (1 + W * bpp)
    # inflate no more than the header's size (and one byte to tell)
    raw = zlib.decompressobj().decompress(b"".join(idat), size + 1)
    if len(raw) != size:
        raise ValueError(f"PNG image data holds {len(raw)} bytes, the header "
                         f"says {size}")
    return (W, H, ctype, bpp), palette, np.frombuffer(raw, np.uint8).reshape(
        H, 1 + W * bpp)


def _unfilter(rows: np.ndarray, W: int, bpp: int) -> np.ndarray:
    """Filtered rows uint8 [N, H, 1 + W * bpp] of N images of one size ->
    pixel bytes uint8 [N, H, W, bpp]."""
    N, H = rows.shape[:2]
    ftype = rows[:, :, 0]
    if ftype.max() > 4:
        raise ValueError(f"PNG row filter type {int(ftype.max())} is not 0-4")
    filt = rows[:, :, 1:].reshape(N, H, W, bpp)
    if not np.isin(ftype, (3, 4)).any():
        # None, Sub and Up: a row at a time, from the row above
        out = np.empty((N, H, W, bpp), np.uint8)
        above = np.zeros((N, W, bpp), np.uint8)
        for y in range(H):
            f, cur = ftype[:, y], filt[:, y]
            row = cur.copy()
            sub, up = f == 1, f == 2
            if sub.any():
                row[sub] = np.cumsum(cur[sub], axis=1, dtype=np.uint8)
            if up.any():
                row[up] = cur[up] + above[up]
            out[:, y] = above = row
        return out
    # Average or Paeth somewhere: anti-diagonals. In the skewed copies,
    # diagonal first so that each step reads contiguous blocks, pixel
    # (y, x) sits at [x + y, :, y] (filt) and at [x + y + 2, :, y + 1] of
    # ``out`` (zero blocks before, a zero row above): then for diagonal d
    # a = out[d + 1, :, y + 1], b = out[d + 1, :, y], c = out[d, :, y].
    ys, xs = np.divmod(np.arange(H * W), W)
    skew_f = np.zeros((H + W - 1, N, H, bpp), np.int16)
    skew_f[xs + ys, :, ys] = filt.reshape(N, H * W, bpp).transpose(1, 0, 2)
    out = np.zeros((H + W + 1, N, H + 1, bpp), np.int16)
    # each row's filter as 0/1 int16 factors ([N, H, bpp]): numpy's
    # arithmetic selects several times faster than np.where here
    kinds = [np.repeat((ftype == k)[:, :, None], bpp, axis=2).astype(np.int16)
             for k in range(5)]
    has_avg, has_paeth = bool(kinds[3].any()), bool(kinds[4].any())
    for d in range(H + W - 1):
        y0, y1 = max(0, d - W + 1), min(H - 1, d) + 1
        a = out[d + 1, :, y0 + 1:y1 + 1]
        b = out[d + 1, :, y0:y1]
        c = out[d, :, y0:y1]
        k = [m[:, y0:y1] for m in kinds]
        pred = skew_f[d, :, y0:y1] + a * k[1]
        pred += b * k[2]
        if has_avg:
            pred += ((a + b) >> 1) * k[3]
        if has_paeth:
            bc, ac = b - c, a - c
            pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
            paeth = c + bc * (pb <= pc)  # b where pb <= pc, else c
            paeth += (a - paeth) * ((pa <= pb) & (pa <= pc))  # a first
            pred += paeth * k[4]
        np.bitwise_and(pred, 0xFF, out=out[d + 2, :, y0 + 1:y1 + 1])
    pix = out[xs + ys + 2, :, ys + 1]  # [H * W, N, bpp]
    return pix.transpose(1, 0, 2).reshape(N, H, W, bpp).astype(np.uint8)


def _to_rgb(pix: np.ndarray, ctype: int, palette) -> np.ndarray:
    """Pixel bytes [..., bpp] -> RGB uint8 [..., 3] as Pillow's
    ``.convert("RGB")``: grey repeated, palette looked up, alpha dropped."""
    if ctype == 2:
        return pix
    if ctype == 6:
        return np.ascontiguousarray(pix[..., :3])
    if ctype == 3:
        return palette[pix[..., 0]]
    return np.repeat(pix[..., :1], 3, axis=-1)  # 0 grey, 4 grey + alpha


def decode_pngs(blobs: Sequence[bytes]) -> np.ndarray:
    """A clip's PNG frames -> uint8 [F, H, W, 3]; frames of one size and
    colour type are reconstructed together. Frames of different sizes
    raise ``ValueError``, as ``np.stack`` of Pillow's frames would."""
    parsed = [_parse(b) for b in blobs]
    if not parsed:
        raise ValueError("no PNG frames")
    sizes = {(W, H) for (W, H, _, _), _, _ in parsed}
    if len(sizes) != 1:
        raise ValueError(f"PNG frames of different sizes: {sorted(sizes)}")
    (W, H), = sizes
    out = np.empty((len(parsed), H, W, 3), np.uint8)
    groups = {}
    for i, (head, _, _) in enumerate(parsed):
        groups.setdefault(head, []).append(i)
    for (_, _, ctype, bpp), idx in groups.items():
        pix = _unfilter(np.stack([parsed[i][2] for i in idx]), W, bpp)
        for j, i in enumerate(idx):
            out[i] = _to_rgb(pix[j], ctype, parsed[i][1])
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3], as Pillow's
    ``Image.open(...).convert("RGB")``."""
    return decode_pngs([data])[0]
