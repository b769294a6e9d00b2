"""Baseline JPEG codec (ITU-T T.81) in numpy and torch.

The JAX package writes and reads JPEG through OpenCV (libjpeg); this
package carries its own codec, as it carries its own PNG codec
(``cli/common.py``).

- :func:`write_jpeg` writes what OpenCV writes by default: JFIF, baseline
  sequential, 8-bit, one interleaved scan, the standard (Annex K)
  quantization tables scaled by ``quality`` as libjpeg scales them, the
  standard Huffman tables, 4:2:0 chroma for colour (one component for
  grey), edges replicated up to whole MCUs.
- :func:`read_jpeg` reads baseline and extended sequential Huffman files
  of 8-bit samples: 1 or 3 components, sampling factors up to 2, one or
  several scans, restart markers. Progressive, lossless, hierarchical and
  arithmetic-coded files raise ``ValueError`` naming their SOF marker.

The encoder has no Python loop per block or coefficient: the colour
transform and the DCT are torch operations, and the run-length and
Huffman coding and the bit packing are numpy operations over every
coefficient at once. In the decoder, where a symbol starts depends on
every symbol before it, so the walk along the codes is a Python loop;
it only looks up each symbol's length in a table over the next 16 bits.
The symbols' values, runs and indices, the DC prediction, the
dequantization and the inverse DCT are array operations over all symbols
and blocks at once.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

__all__ = ["read_jpeg", "write_jpeg"]

# ---- the standard tables (T.81 Annex K) ---------------------------------

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
])  # K.1, natural order
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32)  # K.2

_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _zigzag() -> np.ndarray:
    """ZIGZAG[i]: the natural (row-major) index of the i-th coefficient in
    zigzag order."""
    rc = [(r, c) for r in range(8) for c in range(8)]
    rc.sort(key=lambda t: (t[0] + t[1], t[0] if (t[0] + t[1]) % 2 else -t[0]))
    return np.array([r * 8 + c for r, c in rc])


ZIGZAG = _zigzag()


def _dct_matrix() -> torch.Tensor:
    """D with F = D f D^T the orthonormal 8x8 DCT-II of T.81 A.3.3."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    d = np.cos((2 * x + 1) * u * np.pi / 16) / 2.0
    d[0] /= np.sqrt(2.0)
    return torch.from_numpy(d)


def _quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """The luma and chroma tables (natural order) at ``quality``, as
    libjpeg's jpeg_set_quality with force_baseline scales them."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_LUMA_Q, _CHROMA_Q))


def _huffman_codes(bits, vals):
    """Canonical codes (T.81 C.2): (code, length) per symbol value, as
    arrays over 256 symbols (length 0: no code)."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n, count in enumerate(bits, start=1):
        for _ in range(count):
            if c >= 1 << n or k >= len(vals):
                raise ValueError("bad Huffman table")
            code[vals[k]], length[vals[k]] = c, n
            c, k = c + 1, k + 1
        c <<= 1
    return code, length


# ---- encoder -------------------------------------------------------------

def _size_and_bits(v: np.ndarray):
    """JPEG magnitude category and its value bits (F.1.2.1): negative
    values send v - 1 in ``size`` bits."""
    a = np.abs(v)
    size = np.frexp(a.astype(np.float64))[1].astype(np.int64)  # bit length
    bits = np.where(v < 0, v + (np.int64(1) << size) - 1, v)
    return size, bits


def _pack_fields(value: np.ndarray, length: np.ndarray) -> bytes:
    """Concatenate bit fields (each <= 32 bits, MSB first) into bytes,
    padding the last byte with 1-bits (F.1.2.3)."""
    pad = (-int(length.sum())) % 8
    if pad:
        value, length = np.append(value, (1 << pad) - 1), np.append(length, pad)
    value, length = value.astype(np.uint64), length.astype(np.int64)
    end = np.cumsum(length)
    off = end - length
    n_words = int(end[-1]) // 32 + 2
    # a field sits in the 64-bit window of words off // 32 and off // 32 + 1
    shift = (64 - off % 32 - length).astype(np.uint64)
    placed = value << shift
    word = off // 32
    words = (np.bincount(word, weights=(placed >> np.uint64(32)).astype(np.float64),
                         minlength=n_words)
             + np.bincount(word + 1, weights=(placed & np.uint64(0xFFFFFFFF))
                           .astype(np.float64), minlength=n_words))
    out = words.astype(np.uint32).astype(">u4").tobytes()[: int(end[-1]) // 8]
    raw = np.frombuffer(out, np.uint8)
    ff = np.flatnonzero(raw == 0xFF)
    return np.insert(raw, ff + 1, 0).tobytes()  # byte stuffing (F.1.2.3)


def _entropy_code(zz: np.ndarray, table: np.ndarray, comp: np.ndarray, codes) -> bytes:
    """Huffman-code quantized blocks ``zz`` (N, 64) in scan order (zigzag
    coefficients; ``table[i]`` 0 luma / 1 chroma, ``comp[i]`` the
    component for DC prediction)."""
    n = zz.shape[0]
    dc = zz[:, 0].astype(np.int64)
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        idx = np.flatnonzero(comp == c)
        diff[idx] = np.diff(dc[idx], prepend=0)
    (dc_code, dc_len), (ac_code, ac_len) = codes
    size, bits = _size_and_bits(diff)
    dc_val = (dc_code[table, size] << size) | bits
    dc_n = dc_len[table, size] + size

    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[blk, k].astype(np.int64)
    new = blk[1:] != blk[:-1]
    first = np.r_[True, new][: blk.size]
    prev = np.where(first, 0, np.r_[0, k[:-1]][: blk.size])
    run = k - prev - 1
    zrl = run // 16
    t = table[blk]
    size, bits = _size_and_bits(v)
    sym = (run % 16) * 16 + size
    ac_val = (ac_code[t, sym] << size) | bits
    ac_n = ac_len[t, sym] + size
    last = np.zeros(n, np.int64)
    tail = np.r_[new, True][: blk.size]  # nonzero() is row-major
    last[blk[tail]] = k[tail]
    eob = last < 63

    # fields per block: DC, then each coefficient's ZRLs and code, then EOB
    per_coef = 1 + zrl
    w_block = np.bincount(blk, weights=per_coef, minlength=n).astype(np.int64)
    count = 1 + w_block + eob
    start = np.cumsum(count) - count
    csum = np.cumsum(per_coef) - per_coef  # exclusive, over all coefficients
    before = (np.cumsum(w_block) - w_block)[blk]
    pos = start[blk] + 1 + csum - before + zrl
    total = int(count.sum())
    value = np.empty(total, np.int64)
    length = np.empty(total, np.int64)
    value[start], length[start] = dc_val, dc_n
    value[pos], length[pos] = ac_val, ac_n
    zpos = np.repeat(pos - zrl, zrl) + (np.arange(int(zrl.sum()))
                                        - np.repeat(np.cumsum(zrl) - zrl, zrl))
    zt = np.repeat(t, zrl)
    value[zpos], length[zpos] = ac_code[zt, 0xF0], ac_len[zt, 0xF0]
    e = np.flatnonzero(eob)
    epos = start[e] + count[e] - 1
    value[epos], length[epos] = ac_code[table[e], 0], ac_len[table[e], 0]
    return _pack_fields(value, length)


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """(h, w) with h, w multiples of 8 -> (h/8, w/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(payload) + 2) + payload


def write_jpeg(path: str, hwc: np.ndarray, quality: int = 95) -> None:
    """(H, W, C) uint8 samples, C = 1 (grey) or 3 (RGB), or (H, W) grey ->
    a baseline JPEG file."""
    img = np.asarray(hwc)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] not in (1, 3):
        raise ValueError(f"expected (H, W, 1|3) uint8, got {img.shape} {img.dtype}")
    H, W, C = img.shape
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"JPEG dimensions out of range: {W}x{H}")
    mcu = 16 if C == 3 else 8
    x = torch.from_numpy(np.pad(img, ((0, -H % mcu), (0, -W % mcu), (0, 0)), mode="edge"))
    x = x.permute(2, 0, 1).to(torch.float64)
    if C == 3:  # JFIF YCbCr (libjpeg jccolor.c), level-shifted by -128
        r, g, b = x
        planes = [0.299 * r + 0.587 * g + 0.114 * b - 128.0,
                  -0.168735892 * r - 0.331264108 * g + 0.5 * b,
                  0.5 * r - 0.418687589 * g - 0.081312411 * b]
        # 4:2:0: each chroma sample is the mean of its 2x2 luma sites
        planes[1:] = [torch.nn.functional.avg_pool2d(p[None], 2)[0] for p in planes[1:]]
    else:
        planes = [x[0] - 128.0]
    lq, cq = _quant_tables(quality)
    d = _dct_matrix()
    grids = []
    for i, p in enumerate(planes):
        q = torch.from_numpy((lq if i == 0 else cq).reshape(8, 8)).to(torch.float64)
        coef = torch.round(d @ _blocks(p) @ d.T / q).to(torch.int64)
        grids.append(coef.reshape(coef.shape[:2] + (64,))[..., ZIGZAG].numpy())
    if C == 3:
        y, cb, cr = grids
        my, mx = cb.shape[:2]
        # MCU order: Y00 Y01 Y10 Y11 Cb Cr
        ys = y.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
        zz = np.concatenate([ys, cb[:, :, None], cr[:, :, None]], axis=2).reshape(-1, 64)
        table = np.tile([0, 0, 0, 0, 1, 1], my * mx)
        comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    else:
        zz = grids[0].reshape(-1, 64)
        table = comp = np.zeros(zz.shape[0], np.int64)
    tabs = [_DC_LUMA, _DC_CHROMA, _AC_LUMA, _AC_CHROMA]
    built = [_huffman_codes(*t) for t in tabs]
    codes = ((np.stack([built[0][0], built[1][0]]), np.stack([built[0][1], built[1][1]])),
             (np.stack([built[2][0], built[3][0]]), np.stack([built[2][1], built[3][1]])))
    scan = _entropy_code(zz, table, comp, codes)

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    n_tables = 2 if C == 3 else 1
    for tid, t in enumerate((lq, cq)[:n_tables]):
        out.append(_segment(0xDB, bytes([tid]) + t[ZIGZAG].astype(np.uint8).tobytes()))
    comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)] if C == 3 else [(1, 0x11, 0)]
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, H, W, C)
                        + b"".join(bytes(c) for c in comps)))
    for tc, tid, (bits, vals) in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA),
                                  (0, 1, _DC_CHROMA), (1, 1, _AC_CHROMA))[: 2 * n_tables]:
        out.append(_segment(0xC4, bytes([tc << 4 | tid]) + bytes(bits) + bytes(vals)))
    sel = [(1, 0x00), (2, 0x11), (3, 0x11)][:C]
    out.append(_segment(0xDA, bytes([C]) + b"".join(bytes(s) for s in sel)
                        + bytes([0, 63, 0])))
    out += [scan, b"\xff\xd9"]
    with open(path, "wb") as f:
        f.write(b"".join(out))


# ---- decoder -------------------------------------------------------------

_SOF_NAMES = {
    0xC2: "SOF2 (progressive, Huffman)", 0xC3: "SOF3 (lossless, Huffman)",
    0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)", 0xC9: "SOF9 (sequential, arithmetic)",
    0xCA: "SOF10 (progressive, arithmetic)", 0xCB: "SOF11 (lossless, arithmetic)",
    0xCD: "SOF13 (differential sequential, arithmetic)",
    0xCE: "SOF14 (differential progressive, arithmetic)",
    0xCF: "SOF15 (differential lossless, arithmetic)",
}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _lookup(bits, vals) -> np.ndarray:
    """(65536,) int32: the next 16 bits -> symbol | code length << 8
    (0 where no code starts)."""
    code, length = _huffman_codes(bits, vals)
    lut = np.zeros(1 << 16, np.int32)
    for v in np.flatnonzero(length):
        n = int(length[v])
        lo = int(code[v]) << (16 - n)
        lut[lo : lo + (1 << (16 - n))] = v | n << 8
    return lut


def _windows(buf: np.ndarray) -> np.ndarray:
    """(N,) uint64: bytes i .. i + 7 of ``buf`` big-endian (0xFF past the
    end)."""
    b = np.concatenate([buf, np.full(8, 0xFF, np.uint8)]).astype(np.uint64)
    w = np.zeros(buf.size, np.uint64)
    for j in range(8):
        w |= b[j : j + buf.size] << np.uint64(56 - 8 * j)
    return w


def _symbols(lut: np.ndarray, is_dc) -> tuple:
    """Per table entry: the symbol's size, run and the bits it spans (code
    and value), and the step of the coefficient index k it makes (DC: to
    1; EOB: to the end; ZRL: 16; else run + 1)."""
    n = lut >> 8
    sym = lut & 0xFF
    size = np.minimum(sym, 16) if is_dc else sym & 15
    run = np.zeros_like(sym) if is_dc else sym >> 4
    if is_dc:
        step = np.ones_like(sym)
        valid = (n > 0) & (sym <= 11)
    else:
        step = np.where(sym == 0, 64, np.where(sym == 0xF0, 16, run + 1))
        valid = (n > 0) & ((size > 0) | (sym == 0) | (sym == 0xF0))
    return size, run, np.where(valid, n + size, 0), step


def _walk(words: list, luts: list, start: int, n_blocks: int, pos: list, ends: list) -> int:
    """The sequential walk along one entropy-coded segment from bit
    ``start`` over ``n_blocks`` blocks: appends each symbol's start bit to
    ``pos`` and, at each block's end, the count of symbols so far to
    ``ends``. ``luts[slot]`` holds the DC and AC tables of an MCU slot as
    lists over the next 16 bits of (bits spanned | k step << 5); only the
    lengths are read here, the values afterwards all at once. Returns the
    bit after the last symbol."""
    p, slot, n_slots = start, 0, len(luts)
    for _ in range(n_blocks):
        dc, ac = luts[slot]
        x = dc[(words[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
        if not x:
            raise ValueError("corrupt JPEG entropy-coded data")
        pos.append(p)
        p += x & 31
        k = 1
        while k < 64:
            x = ac[(words[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
            if not x:
                raise ValueError("corrupt JPEG entropy-coded data")
            pos.append(p)
            p += x & 31
            k += x >> 5
        ends.append(len(pos))
        slot = slot + 1 if slot + 1 < n_slots else 0
    return p


def _coefficients(pos, ends, words, slot_tables, n_blocks) -> np.ndarray:
    """Every block's zigzag coefficients (n_blocks, 64), DC as differences,
    from the symbols' start bits ``pos`` and the blocks' ends in symbols
    ``ends``: values, runs and indices read for all symbols at once."""
    counts = np.diff(np.r_[0, ends])
    block = np.repeat(np.arange(n_blocks), counts)
    first = ends - counts
    is_dc = np.zeros(pos.size, bool)
    is_dc[first] = True
    slot = block % len(slot_tables)
    size = np.zeros(pos.size, np.int64)
    run = np.zeros(pos.size, np.int64)
    step = np.zeros(pos.size, np.int64)
    code = np.zeros(pos.size, np.int64)
    w = words[pos >> 3] << (pos & 7).astype(np.uint64)
    peek = (w >> np.uint64(48)).astype(np.int64)
    for i, (dc, ac, dc_lut, ac_lut) in enumerate(slot_tables):
        here = slot == i
        for m, tab, lut in ((is_dc & here, dc, dc_lut), (~is_dc & here, ac, ac_lut)):
            e = peek[m]
            size[m], run[m], step[m] = tab[0][e], tab[1][e], tab[3][e]
            code[m] = lut[e] >> 8
    raw = (((w << code.astype(np.uint64)) >> np.uint64(1))
           >> (63 - size).astype(np.uint64)).astype(np.int64)
    half = np.left_shift(1, np.maximum(size - 1, 0))
    value = np.where(size == 0, 0, np.where(raw >= half, raw, raw - 2 * half + 1))
    cs = np.cumsum(step)
    k = cs - step - (cs - step)[first][block]  # k before each symbol
    index = k + run
    put = is_dc | (size > 0)
    if (index[put] > 63).any():
        raise ValueError("corrupt JPEG entropy-coded data (coefficient past 63)")
    out = np.zeros((n_blocks, 64), np.int64)
    out[block[put], index[put]] = value[put]
    return out


def _upsample2(x: np.ndarray, axis: int) -> np.ndarray:
    """libjpeg's "fancy" 2x upsampling along ``axis``: each output sample
    is 3/4 of its nearer and 1/4 of its farther input sample."""
    x = np.moveaxis(x, axis, -1)
    left = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    right = np.concatenate([x[..., 1:], x[..., -1:]], axis=-1)
    out = np.stack([0.75 * x + 0.25 * left, 0.75 * x + 0.25 * right], axis=-1)
    return np.moveaxis(out.reshape(x.shape[:-1] + (-1,)), -1, axis)


def read_jpeg(path: str) -> np.ndarray:
    """A sequential Huffman JPEG -> (H, W, C) uint8, C = 1 (grey) or 3
    (RGB, from JFIF YCbCr)."""
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    blob = data.tobytes()
    if blob[:2] != b"\xff\xd8":
        raise ValueError(f"not a JPEG file: {path}")
    qt, dht, frame, restart, coefs, scans = {}, {}, None, 0, None, 0
    pos = 2
    while pos < len(blob):
        if blob[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}: {path}")
        marker = blob[pos + 1]
        pos += 2
        if marker == 0xFF:  # fill byte
            pos -= 1
            continue
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        n = int.from_bytes(blob[pos : pos + 2], "big")
        if n < 2 or pos + n > len(blob):
            raise ValueError(f"truncated JPEG segment 0xFF{marker:02X}: {path}")
        seg = blob[pos + 2 : pos + n]
        pos += n
        if marker in _SOF_NAMES:
            raise ValueError(f"unsupported JPEG: {_SOF_NAMES[marker]}: {path}")
        if marker in (0xC0, 0xC1):
            prec, H, W, C = struct.unpack(">BHHB", seg[:6])
            if prec != 8 or C not in (1, 3) or H == 0:
                raise ValueError(f"unsupported JPEG: {prec}-bit, {C} components, "
                                 f"height {H}: {path}")
            comps = [tuple(seg[6 + 3 * i : 9 + 3 * i]) for i in range(C)]
            frame = dict(H=H, W=W, comps={c[0]: (c[1] >> 4, c[1] & 15, c[2])
                                          for c in comps}, order=[c[0] for c in comps])
            if any(not (1 <= h <= 2 and 1 <= v <= 2) for h, v, _ in frame["comps"].values()):
                raise ValueError(f"unsupported JPEG sampling factors: {path}")
            hmax = max(h for h, _, _ in frame["comps"].values())
            vmax = max(v for _, v, _ in frame["comps"].values())
            frame.update(hmax=hmax, vmax=vmax, mx=_ceil(W, 8 * hmax), my=_ceil(H, 8 * vmax))
            coefs = {c: np.zeros((frame["my"] * v, frame["mx"] * h, 64), np.int64)
                     for c, (h, v, _) in frame["comps"].items()}
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                cnt = 128 if pq else 64
                qt[tq] = np.frombuffer(seg[i + 1 : i + 1 + cnt], ">u2" if pq else np.uint8
                                       ).astype(np.float64)
                i += 1 + cnt
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                bits = list(seg[i + 1 : i + 17])
                vals = list(seg[i + 17 : i + 17 + sum(bits)])
                dht[(seg[i] >> 4, seg[i] & 15)] = _lookup(bits, vals)
                i += 17 + sum(bits)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"JPEG scan before its frame header: {path}")
            pos = _read_scan(data, pos, seg, frame, dht, restart, coefs)
            scans += 1
    if frame is None or not scans:
        raise ValueError(f"JPEG without a frame header or scan: {path}")
    return _reconstruct(frame, qt, coefs)


def _read_scan(data, pos, seg, frame, dht, restart, coefs) -> int:
    """Decode the scan whose header is ``seg`` and whose data starts at
    byte ``pos`` into ``coefs``; returns the position of the next marker."""
    ns = seg[0]
    sel = [(seg[1 + 2 * i], seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15) for i in range(ns)]
    ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
    if (ss, se) != (0, 63):
        raise ValueError("JPEG scan is not sequential (spectral selection)")
    # the entropy-coded data runs to the first marker other than RSTn
    ff = np.flatnonzero(data[pos:-1] == 0xFF) + pos
    nxt = data[ff + 1]
    stop = ff[(nxt != 0) & ~((nxt >= 0xD0) & (nxt <= 0xD7)) & (nxt != 0xFF)]
    if not stop.size:
        raise ValueError("truncated JPEG: no marker after the scan data")
    end = int(stop[0])
    rst = ff[(ff < end) & (nxt >= 0xD0) & (nxt <= 0xD7)]
    bounds = np.r_[pos, rst + 2]
    ends = np.r_[rst, end]
    pieces = []
    for s, e in zip(bounds, ends):
        piece = data[s:e]
        stuffed = np.flatnonzero((piece[:-1] == 0xFF) & (piece[1:] == 0)) + 1
        pieces.append(np.delete(piece, stuffed))
    sizes = np.array([p.size for p in pieces], np.int64)
    seg_bits = list(zip((np.cumsum(sizes) - sizes) * 8, np.cumsum(sizes) * 8))
    buf = np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)

    fr = frame["comps"]
    if ns == 1:  # non-interleaved: the component's own blocks in raster order
        c = sel[0][0]
        h, v, _ = fr[c]
        bw = _ceil(_ceil(frame["W"] * h, frame["hmax"]), 8)
        bh = _ceil(_ceil(frame["H"] * v, frame["vmax"]), 8)
        rows, cols = np.divmod(np.arange(bh * bw), bw)
        comp = np.full(rows.size, c)
        slot_tables = [(sel[0][1], sel[0][2])]
        per_mcu = 1
    else:
        slots = [(c, v_, h_) for c, _, _ in sel
                 for v_ in range(fr[c][1]) for h_ in range(fr[c][0])]
        per_mcu = len(slots)
        m = np.arange(frame["my"] * frame["mx"])
        my, mx = np.divmod(m, frame["mx"])
        comp = np.tile([s[0] for s in slots], m.size)
        sv = np.tile([s[1] for s in slots], m.size)
        sh = np.tile([s[2] for s in slots], m.size)
        vv = np.array([fr[c][1] for c in comp])
        hh = np.array([fr[c][0] for c in comp])
        rows = np.repeat(my, per_mcu) * vv + sv
        cols = np.repeat(mx, per_mcu) * hh + sh
        tables = {c: (td, ta) for c, td, ta in sel}
        slot_tables = [tables[s[0]] for s in slots]
    keys = sorted({(0, t) for t, _ in slot_tables} | {(1, t) for _, t in slot_tables})
    missing = [k for k in keys if k not in dht]
    if missing:
        raise ValueError(f"JPEG scan uses undefined Huffman tables {missing}")
    n_blocks = rows.size
    per_seg = restart * per_mcu if restart else n_blocks
    if len(pieces) != _ceil(n_blocks, per_seg):
        raise ValueError("JPEG restart markers do not match the restart interval")
    tabs = {k: _symbols(dht[k], k[0] == 0) for k in keys}
    packed = {k: (t[2] | t[3] << 5).tolist() for k, t in tabs.items()}
    luts = [(packed[(0, d)], packed[(1, a)]) for d, a in slot_tables]
    words = _windows(buf)
    word_list = words.tolist()
    sym_pos, blk_ends = [], []
    for i, (s0, s1) in enumerate(seg_bits):
        try:
            p = _walk(word_list, luts, int(s0), min(per_seg, n_blocks - i * per_seg),
                      sym_pos, blk_ends)
        except IndexError:
            p = s1 + 1
        if p > s1:
            raise ValueError("truncated JPEG entropy-coded data")
    zz = _coefficients(np.array(sym_pos, np.int64), np.array(blk_ends, np.int64), words,
                       [(tabs[(0, d)], tabs[(1, a)], dht[(0, d)], dht[(1, a)])
                        for d, a in slot_tables], n_blocks)
    # DC: running sums of the differences per component, reset per segment
    seg_of = np.arange(n_blocks) // per_seg
    for c in set(comp.tolist()):
        idx = np.flatnonzero(comp == c)
        d = zz[idx, 0]
        cs = np.cumsum(d)
        start = np.r_[True, seg_of[idx][1:] != seg_of[idx][:-1]]
        base = np.maximum.accumulate(np.where(start, np.arange(idx.size), 0))
        zz[idx, 0] = cs - (cs - d)[base]
        coefs[c][rows[idx], cols[idx]] = zz[idx]
    return end


def _reconstruct(frame, qt, coefs) -> np.ndarray:
    """Dequantize, inverse DCT, upsample and convert to RGB."""
    d = _dct_matrix()
    natural = np.argsort(ZIGZAG)
    planes = []
    for c in frame["order"]:
        h, v, tq = frame["comps"][c]
        if tq not in qt:
            raise ValueError(f"JPEG quantization table {tq} is not defined")
        zz = coefs[c] * qt[tq]
        blk = torch.from_numpy(zz[..., natural].reshape(zz.shape[:2] + (8, 8)))
        pix = (d.T @ blk @ d + 128.0).permute(0, 2, 1, 3).reshape(
            zz.shape[0] * 8, zz.shape[1] * 8).numpy()
        for axis, f in ((0, frame["vmax"] // v), (1, frame["hmax"] // h)):
            if f == 2:
                pix = _upsample2(pix, axis)
            elif f != 1:
                raise ValueError("unsupported JPEG sampling ratio")
        planes.append(pix[: frame["H"], : frame["W"]])
    if len(planes) == 1:
        out = planes[0][..., None]
    else:
        y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
        out = np.stack([y + 1.402 * cr, y - 0.344136286 * cb - 0.714136286 * cr,
                        y + 1.772 * cb], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)
