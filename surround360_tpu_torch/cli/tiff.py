"""Baseline TIFF, read and written with numpy and ``zlib``.

The reference reads and writes TIFF through OpenCV (``cv2.imread`` /
``cv2.imwrite``, which are libtiff); the port has its own codec, written
from the TIFF 6.0 specification.

Read (:func:`read_tiff`): the first image of a classic TIFF, little- or
big-endian; 8- or 16-bit unsigned samples; grey (one sample, photometric
BlackIsZero), RGB (three) or RGBA (four: the extra sample is alpha, as
OpenCV takes it); chunky planar configuration; strips or tiles;
compression none (1), LZW (5), Adobe Deflate (8), Deflate (32946) or
PackBits (32773); predictor none (1) or horizontal differencing (2),
which libtiff writes with LZW and Deflate. Anything else raises a
``ValueError`` that names the tag and its value: JPEG-in-TIFF, float or
signed samples, planar configuration 2, BigTIFF, 1-bit or 12-bit samples,
palette or CMYK images. Samples come back as stored: OpenCV's 8-bit reader
(libtiff's RGBA interface) premultiplies the colours of a file whose alpha
is marked unassociated (ExtraSamples = 2), which OpenCV's writer never
marks. LZW decodes in a Python loop, one code at a time.

Write (:func:`write_tiff`): little-endian, strips, uncompressed or Adobe
Deflate, 8 or 16 bits, grey, RGB or RGBA.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_tiff", "write_tiff"]

TAG_NAMES = {
    256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample", 259: "Compression",
    262: "PhotometricInterpretation", 273: "StripOffsets", 277: "SamplesPerPixel",
    278: "RowsPerStrip", 279: "StripByteCounts", 284: "PlanarConfiguration",
    317: "Predictor", 322: "TileWidth", 323: "TileLength", 324: "TileOffsets",
    325: "TileByteCounts", 338: "ExtraSamples", 339: "SampleFormat",
}
# field type -> (struct code, bytes); RATIONAL and SRATIONAL as two LONGs
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 4),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("i", 4),
          11: ("f", 4), 12: ("d", 8)}
_COUNT_SCALE = {5: 2, 10: 2}
_NONE, _LZW, _ADOBE_DEFLATE, _PACKBITS, _DEFLATE = 1, 5, 8, 32773, 32946
_PHOTOMETRIC = {1: (1,), 2: (3, 4)}  # BlackIsZero: grey; RGB: RGB or RGBA


def _unsupported(tag: int, value, path: str):
    return ValueError(f"unsupported TIFF: {TAG_NAMES.get(tag, 'tag')} ({tag}) = {value}: {path}")


def _read_ifd(blob: bytes, bo: str, offset: int, path: str) -> dict:
    """The tags of the IFD at ``offset``: tag -> tuple of values."""
    if offset + 2 > len(blob):
        raise ValueError(f"TIFF directory offset {offset} past the end of the file: {path}")
    (n,) = struct.unpack_from(bo + "H", blob, offset)
    if offset + 2 + 12 * n > len(blob):
        raise ValueError(f"TIFF directory of {n} entries past the end of the file: {path}")
    tags = {}
    for i in range(n):
        tag, typ, count, _ = struct.unpack_from(bo + "HHII", blob, offset + 2 + 12 * i)
        if typ not in _TYPES:
            continue  # a type this reader has no use for (e.g. IFD8 of a private tag)
        code, size = _TYPES[typ]
        count *= _COUNT_SCALE.get(typ, 1)
        at = offset + 2 + 12 * i + 8
        if count * size > 4:
            (at,) = struct.unpack_from(bo + "I", blob, at)
        if at + count * size > len(blob):
            raise ValueError(f"TIFF tag {tag} points past the end of the file: {path}")
        tags[tag] = struct.unpack_from(f"{bo}{count}{code}", blob, at)
    return tags


def _lzw_decode(data: bytes, path: str) -> bytes:
    """TIFF LZW (section 13): codes most significant bit first, 9 to 12
    bits, the width growing one code early; 256 clears, 257 ends."""
    if data[:2] == b"\x00\x01":
        raise _unsupported(259, "5 with old-style (LSB-first) LZW codes", path)
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, buf, nbits, prev = 9, 0, 0, None
    for byte in data:
        buf = (buf << 8) | byte
        nbits += 8
        while nbits >= width:
            nbits -= width
            code = buf >> nbits
            buf &= (1 << nbits) - 1
            if code == 256:
                del table[258:]
                width, prev = 9, None
                continue
            if code == 257:
                return bytes(out)
            if prev is None:
                entry = table[code]
            else:
                if code < len(table):
                    entry = table[code]
                elif code == len(table):
                    entry = prev + prev[:1]
                else:
                    raise ValueError(f"corrupt LZW data (code {code}): {path}")
                table.append(prev + entry[:1])
                if len(table) + 1 >= 1 << width and width < 12:
                    width += 1
            out += entry
            prev = entry
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    """PackBits (section 9): n < 128 copies n + 1 bytes, n > 128 repeats
    the next byte 257 - n times, 128 is a no-op."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _decompress(chunk: bytes, compression: int, path: str) -> bytes:
    if compression == _NONE:
        return chunk
    if compression == _LZW:
        return _lzw_decode(chunk, path)
    if compression in (_ADOBE_DEFLATE, _DEFLATE):
        return zlib.decompress(chunk)
    return _packbits_decode(chunk)


def _samples(raw: bytes, rows: int, cols: int, spp: int, dtype, predictor: int, path: str):
    """One strip or tile's decoded bytes -> (rows, cols, spp) samples in
    native order, the horizontal differencing undone."""
    need = rows * cols * spp * dtype.itemsize
    if len(raw) < need:
        raise ValueError(f"truncated TIFF image data ({len(raw)} of {need} bytes): {path}")
    out = np.frombuffer(raw, dtype, rows * cols * spp).reshape(rows, cols, spp)
    native = out.astype(dtype.newbyteorder("="))
    if predictor == 2:
        native = np.cumsum(native, axis=1, dtype=native.dtype)
    return native


def read_tiff(path: str) -> np.ndarray:
    """The first image of a TIFF -> (H, W, C) uint8 or uint16 samples in
    file order (grey, RGB or RGBA). See the module docstring for what is
    read; anything else raises ``ValueError``."""
    with open(path, "rb") as f:
        blob = f.read()
    order = blob[:2]
    if order not in (b"II", b"MM") or len(blob) < 8:
        raise ValueError(f"not a TIFF file: {path}")
    bo = "<" if order == b"II" else ">"
    version, offset = struct.unpack_from(bo + "HI", blob, 2)
    if version == 43:
        raise ValueError(f"unsupported TIFF: BigTIFF (version 43): {path}")
    if version != 42:
        raise ValueError(f"not a TIFF file (version {version}): {path}")
    tags = _read_ifd(blob, bo, offset, path)
    for tag in (256, 257):
        if tag not in tags:
            raise ValueError(f"TIFF without {TAG_NAMES[tag]} ({tag}): {path}")
    W, H = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    fmt = tags.get(339, (1,) * spp)
    if set(fmt) != {1}:
        raise _unsupported(339, fmt[0] if len(set(fmt)) == 1 else fmt, path)
    bits = tags.get(258, (1,) * spp)
    if len(set(bits)) != 1 or bits[0] not in (8, 16):
        raise _unsupported(258, bits[0] if len(set(bits)) == 1 else bits, path)
    compression = tags.get(259, (_NONE,))[0]
    if compression not in (_NONE, _LZW, _ADOBE_DEFLATE, _PACKBITS, _DEFLATE):
        raise _unsupported(259, compression, path)
    photometric = tags.get(262, (None,))[0]
    if spp not in _PHOTOMETRIC.get(photometric, ()):
        raise _unsupported(262, f"{photometric} with {spp} samples per pixel", path)
    planar = tags.get(284, (1,))[0]
    if planar != 1 and spp > 1:
        raise _unsupported(284, planar, path)
    predictor = tags.get(317, (1,))[0]
    if predictor not in (1, 2):
        raise _unsupported(317, predictor, path)
    dtype = np.dtype(bo + ("u1" if bits[0] == 8 else "u2"))
    image = np.empty((H, W, spp), dtype.newbyteorder("="))

    def chunk(offsets, counts, i):
        if i >= len(offsets) or i >= len(counts):
            raise ValueError(f"TIFF with too few strips or tiles: {path}")
        start, size = offsets[i], counts[i]
        if start + size > len(blob):
            raise ValueError(f"TIFF strip or tile past the end of the file: {path}")
        return _decompress(blob[start:start + size], compression, path)

    if 322 in tags:  # tiles, padded to whole tiles at the right and bottom
        tw, tl = tags[322][0], tags.get(323, (0,))[0]
        if not tw or not tl or 324 not in tags or 325 not in tags:
            raise ValueError(f"TIFF tiles without TileLength, TileOffsets or "
                             f"TileByteCounts: {path}")
        across = -(-W // tw)
        for i in range(-(-H // tl) * across):
            y, x = (i // across) * tl, (i % across) * tw
            tile = _samples(chunk(tags[324], tags[325], i), tl, tw, spp, dtype, predictor, path)
            image[y:y + tl, x:x + tw] = tile[:H - y, :W - x]
    else:
        if 273 not in tags or 279 not in tags:
            raise ValueError(f"TIFF without StripOffsets or StripByteCounts: {path}")
        rps = min(tags.get(278, (H,))[0], H)
        for i, y in enumerate(range(0, H, rps)):
            rows = min(rps, H - y)
            image[y:y + rows] = _samples(chunk(tags[273], tags[279], i), rows, W, spp,
                                         dtype, predictor, path)
    return image


def write_tiff(path: str, hwc: np.ndarray, compress: bool = True) -> None:
    """(H, W, C) uint8 or uint16 samples, C in {1, 3, 4} (grey, RGB, RGBA)
    -> a little-endian TIFF in strips of about 64 KiB, Adobe Deflate
    (``compress``) or uncompressed, no predictor. RGBA is written as OpenCV
    writes it, without an ExtraSamples tag: libtiff's RGBA reader (which
    OpenCV's 8-bit reader is) would premultiply an alpha marked
    unassociated."""
    if hwc.dtype not in (np.uint8, np.uint16) or hwc.ndim != 3:
        raise ValueError(f"expected (H, W, C) uint8/uint16, got {hwc.shape} {hwc.dtype}")
    H, W, C = hwc.shape
    if C not in (1, 3, 4):
        raise ValueError(f"TIFF takes 1, 3 or 4 channels, got {C}")
    data = np.ascontiguousarray(hwc, hwc.dtype.newbyteorder("<"))
    row_bytes = W * C * data.itemsize
    rps = max(1, min(H, 65536 // max(row_bytes, 1)))
    strips = [data[y:y + rps].tobytes() for y in range(0, H, rps)]
    if compress:
        strips = [zlib.compress(s, 6) for s in strips]
    bits = data.itemsize * 8
    entries = [
        (256, 4, [W]), (257, 4, [H]), (258, 3, [bits] * C),
        (259, 3, [_ADOBE_DEFLATE if compress else _NONE]),
        (262, 3, [1 if C == 1 else 2]), (273, 4, [0] * len(strips)),
        (277, 3, [C]), (278, 4, [rps]),
        (279, 4, [len(s) for s in strips]), (284, 3, [1]), (339, 3, [1] * C),
    ]
    # layout: header, the IFD, the values that do not fit in an entry, strips
    ifd_size = 2 + 12 * len(entries) + 4
    extra_at = 8 + ifd_size

    def packed(typ, values):
        code, _ = _TYPES[typ]
        return struct.pack(f"<{len(values)}{code}", *values)

    extra_size = sum(len(packed(t, v)) for _, t, v in entries if len(packed(t, v)) > 4)
    extra_size += extra_size % 2
    offsets, at = [], extra_at + extra_size
    for s in strips:
        offsets.append(at)
        at += len(s)
    entries[5] = (273, 4, offsets)
    ifd, extra = [struct.pack("<H", len(entries))], []
    cursor = extra_at
    for tag, typ, values in entries:
        blob = packed(typ, values)
        if len(blob) > 4:
            ifd.append(struct.pack("<HHII", tag, typ, len(values), cursor))
            extra.append(blob)
            cursor += len(blob)
        else:
            ifd.append(struct.pack("<HHI", tag, typ, len(values)) + blob.ljust(4, b"\0"))
    ifd.append(struct.pack("<I", 0))
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8))
        f.write(b"".join(ifd))
        f.write(b"".join(extra).ljust(extra_size, b"\0"))
        for s in strips:
            f.write(s)
