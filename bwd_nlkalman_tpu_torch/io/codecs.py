"""Image codecs (PNG, TIFF, PFM, Middlebury FLO, and JPEG natively).

The port's own copy of ``bwd_nlkalman_tpu.io.codecs``. As there, reads
and writes go through the native io library (``native/``: libpng,
libtiff, libjpeg, C++ PFM and FLO) where ``native`` below routes them
there and it has the format's codec, and through the pure-numpy codecs
below otherwise, or where a native call fails (JAX io/codecs.py:37-94).
The pure codecs write the JAX package's pure codecs' bytes. JPEG exists
only natively (there is no pure decoder): without the library, or without
libjpeg in it, a JPEG path raises.

``native`` picks the route in place of the JAX package's
``BNLK_NO_NATIVE`` environment variable: None (the default) takes the
library for JPEG only, which has no other route, building it at first
use, so that no build left in the checkout changes what the other formats
write; True takes it for every format it has (building it at first use),
as the JAX package does wherever its library is built; False never takes
it.

All readers return float32 (H, W, C) arrays; writers accept float arrays
and choose the stored type per format conventions.  Row order is top-down
in memory, matching the reference's iio conventions — including iio's PFM
quirk of NOT flipping rows on read/write (lib/iio/iio.c:2048-2071).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_FLO_MAGIC = 202021.25  # Middlebury sanity check (lib/iio/iio.c:2073-2090)
_JPEG = (".jpg", ".jpeg")


def _native(path: str, native: bool | None):
    """The native io module where ``native`` routes ``path`` through it and
    it has the format's codec, else None."""
    if native is False or (native is None
                           and os.path.splitext(path)[1].lower() not in _JPEG):
        return None
    from .. import native as nat

    if not nat.available():
        if native is None:
            return None
        raise RuntimeError("native=True: the native io library needs g++ to build")
    return nat if nat.has_codec(path) else None


def _no_jpeg(path: str) -> ValueError:
    # JPEG lives in the native library only (libjpeg, like iio's
    # I_CAN_HAS_LIBJPEG path, lib/iio/iio.c:30); no pure-python decoder
    return ValueError(f"{path}: JPEG needs a native io library, which this package "
                      "does not have here (native/ builds it with g++ where jpeglib.h "
                      "is found)")


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def read_image(path: str, native: bool | None = None) -> np.ndarray:
    nat = _native(path, native)
    if nat is not None:
        try:
            return nat.read_image(path)
        except Exception:
            pass
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        return read_pfm(path)
    if ext == ".png":
        return read_png(path)
    if ext in (".tif", ".tiff"):
        return read_tiff(path)
    if ext in _JPEG:
        raise _no_jpeg(path)
    raise ValueError(f"unsupported image format: {path}")


def write_image(path: str, img: np.ndarray, native: bool | None = None) -> None:
    ext = os.path.splitext(path)[1].lower()
    nat = _native(path, native)
    if nat is not None:
        try:
            img3 = np.asarray(img)
            if ext == ".flo":
                return nat.write_flo(path, img3)
            if ext == ".pfm":
                return nat.write_pfm(path, img3)
            if ext == ".png":
                depth = 16 if (img3.dtype == np.uint16
                               or np.nanmax(img3, initial=0) > 255.5) else 8
                return nat.write_png(path, img3.astype(np.float32), depth)
            if ext in (".tif", ".tiff"):
                return nat.write_tiff(path, img3)
            if ext in _JPEG:
                return nat.write_jpeg(path, img3)
        except Exception:
            pass
    if ext == ".flo":
        return write_flo(path, img)
    if ext == ".pfm":
        return write_pfm(path, img)
    if ext == ".png":
        return write_png(path, img)
    if ext in (".tif", ".tiff"):
        return write_tiff(path, img)
    if ext in _JPEG:
        raise _no_jpeg(path)
    raise ValueError(f"unsupported image format: {path}")


# ---------------------------------------------------------------------------
# PFM (iio row convention: no vertical flip)
# ---------------------------------------------------------------------------


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        hdr = f.readline().strip()
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    c = 3 if hdr == b"PF" else 1
    return data.reshape(h, w, c).astype(np.float32)


def write_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] == 1:
        hdr, flat = b"Pf", img[..., 0]
    elif img.shape[2] == 3:
        hdr, flat = b"PF", img
    else:
        raise ValueError("PFM supports 1 or 3 channels")
    with open(path, "wb") as f:
        f.write(hdr + b"\n%d %d\n-1.0\n" % (img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(flat, "<f4").tobytes())


# ---------------------------------------------------------------------------
# Middlebury FLO (iio reader lib/iio/iio.c:2073, writer :3105)
# ---------------------------------------------------------------------------


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic, = struct.unpack("<f", f.read(4))
        if abs(magic - _FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(w * h * 2 * 4), "<f4")
    return data.reshape(h, w, 2).astype(np.float32)


def write_flo(path: str, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    assert flow.ndim == 3 and flow.shape[2] == 2
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<f", _FLO_MAGIC))
        f.write(struct.pack("<ii", w, h))
        f.write(np.ascontiguousarray(flow, "<f4").tobytes())


# ---------------------------------------------------------------------------
# PNG (no interlace; 8/16-bit gray, gray+alpha, RGB, RGBA)
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG per-scanline filters.  raw: (h, 1 + stride) uint8."""
    out = np.zeros((h, stride), np.uint8)
    for y in range(h):
        ft = raw[y, 0]
        line = raw[y, 1:].astype(np.int32)
        prior = out[y - 1].astype(np.int32) if y else np.zeros(stride, np.int32)
        if ft == 0:
            cur = line
        elif ft == 2:  # Up
            cur = (line + prior) & 0xFF
        elif ft in (1, 3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prior[x]
                if ft == 1:
                    v = line[x] + a
                elif ft == 3:
                    v = line[x] + ((a + b) >> 1)
                else:  # Paeth
                    c = prior[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    v = line[x] + pr
                cur[x] = v & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ft}")
        out[y] = cur.astype(np.uint8)
    return out


def read_png(path: str) -> np.ndarray:
    """Read a PNG into float32 (H, W, C) with values in [0, 255] for 8-bit
    (16-bit images keep their 0-65535 range, like iio)."""
    with open(path, "rb") as f:
        if f.read(8) != _PNG_SIG:
            raise ValueError(f"{path}: not a PNG")
        idat = b""
        plte = None
        trns = None
        while True:
            ln, typ = struct.unpack(">I4s", f.read(8))
            data = f.read(ln)
            f.read(4)  # crc
            if typ == b"IHDR":
                w, h, depth, color, comp, filt, interlace = struct.unpack(
                    ">IIBBBBB", data
                )
                if interlace:
                    raise ValueError("interlaced PNG not supported")
            elif typ == b"PLTE":
                plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
            elif typ == b"tRNS":
                trns = np.frombuffer(data, np.uint8)
            elif typ == b"IDAT":
                idat += data
            elif typ == b"IEND":
                break
    raw = zlib.decompress(idat)
    if color == 3:  # palette
        stride = (w * depth + 7) // 8
        rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + stride)
        px = _unfilter(rows, h, stride, 1)
        if depth < 8:
            bits = np.unpackbits(px, axis=1)[:, : w * depth]
            idx = bits.reshape(h, w, depth)
            weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
            px = (idx * weights).sum(-1).astype(np.uint8)
        else:
            px = px[:, :w]
        out = plte[px].astype(np.float32)
        if trns is not None:
            alpha = np.where(px < len(trns), trns[np.clip(px, 0, len(trns) - 1)], 255)
            out = np.concatenate([out, alpha[..., None].astype(np.float32)], -1)
        return out
    nch = _CHANNELS[color]
    bytes_per_sample = 2 if depth == 16 else 1
    if depth not in (8, 16):
        raise ValueError(f"PNG depth {depth} not supported for color {color}")
    stride = w * nch * bytes_per_sample
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + stride)
    px = _unfilter(rows, h, stride, nch * bytes_per_sample)
    if depth == 16:
        arr = px.reshape(h, w, nch, 2).astype(np.uint16)
        arr = (arr[..., 0] << 8) | arr[..., 1]
        return arr.astype(np.float32)
    return px.reshape(h, w, nch).astype(np.float32)


def _png_chunk(typ: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + typ
        + data
        + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray, depth: int | None = None) -> None:
    """Write float/int data as 8- or 16-bit PNG (values clipped+rounded)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    if depth is None:
        depth = 16 if (img.dtype == np.uint16 or np.nanmax(img, initial=0) > 255.5) else 8
    if depth == 8:
        arr = np.clip(np.rint(img), 0, 255).astype(np.uint8)
        payload = arr.reshape(h, w * c)
    else:
        arr = np.clip(np.rint(img), 0, 65535).astype(">u2")
        payload = arr.reshape(h, w * c).view(np.uint8).reshape(h, -1)
    raw = b"".join(b"\x00" + payload[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# TIFF (baseline, strip-based; float32 / uint8 / uint16, LZW or none)
# ---------------------------------------------------------------------------

_TIFF_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 11: ("f", 4), 12: ("d", 8), 16: ("Q", 8), 17: ("q", 8), 2: ("s", 1)}


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first codes, EarlyChange)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    dict_ = {}
    next_code = 258
    width = 9
    prev = None
    acc = 0
    nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (acc >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            # trim consumed bits — an unbounded accumulator turns every
            # shift into bignum arithmetic (O(n^2) overall)
            acc &= (1 << nbits) - 1
            if code == CLEAR:
                dict_ = {}
                next_code = 258
                width = 9
                prev = None
                continue
            if code == EOI:
                return bytes(out)
            if prev is None:
                entry = bytes([code])
            elif code < 256:
                entry = bytes([code])
            elif code in dict_:
                entry = dict_[code]
            elif code == next_code:
                entry = prev + prev[:1]
            else:
                raise ValueError("bad LZW stream")
            out += entry
            if prev is not None:
                dict_[next_code] = prev + entry[:1]
                next_code += 1
                if next_code == (1 << width) - 1 and width < 12:
                    width += 1
            prev = entry
    return bytes(out)


def read_tiff(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        buf = f.read()
    bo = buf[:2]
    if bo == b"II":
        e = "<"
    elif bo == b"MM":
        e = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    magic, = struct.unpack(e + "H", buf[2:4])
    if magic == 42:
        big = False
        off, = struct.unpack(e + "I", buf[4:8])
    elif magic == 43:  # BigTIFF (what iio emits for float images)
        big = True
        off, = struct.unpack(e + "Q", buf[8:16])
    else:
        raise ValueError(f"{path}: bad TIFF magic {magic}")
    if big:
        nent, = struct.unpack(e + "Q", buf[off : off + 8])
        ent0, entsz, valsz = off + 8, 20, 8
    else:
        nent, = struct.unpack(e + "H", buf[off : off + 2])
        ent0, entsz, valsz = off + 2, 12, 4
    tags = {}
    for i in range(nent):
        o = ent0 + entsz * i
        if big:
            tag, typ, cnt = struct.unpack(e + "HHQ", buf[o : o + 12])
            vo = o + 12
        else:
            tag, typ, cnt = struct.unpack(e + "HHI", buf[o : o + 8])
            vo = o + 8
        fmt, sz = _TIFF_TYPES.get(typ, ("I", 4))
        total = sz * cnt
        if total <= valsz:
            vals_raw = buf[vo : vo + total]
        else:
            voff, = struct.unpack(e + ("Q" if big else "I"), buf[vo : vo + valsz])
            vals_raw = buf[voff : voff + total]
        if typ == 5:
            vals = [struct.unpack(e + "II", vals_raw[8 * j : 8 * j + 8]) for j in range(cnt)]
        elif typ == 2:
            vals = [vals_raw]
        else:
            vals = list(struct.unpack(e + fmt * cnt, vals_raw))
        tags[tag] = vals
    w = tags[256][0]
    h = tags[257][0]
    bps = tags.get(258, [1])
    spp = tags.get(277, [len(bps)])[0]
    comp = tags.get(259, [1])[0]
    fmtcode = tags.get(339, [1])[0]  # 1 uint, 2 int, 3 float
    offsets = tags[273]
    counts = tags[279]
    rows_per_strip = tags.get(278, [h])[0]
    predictor = tags.get(317, [1])[0]
    raw = b""
    for o_, c_ in zip(offsets, counts):
        chunk = buf[o_ : o_ + c_]
        if comp == 1:
            raw += chunk
        elif comp == 5:
            raw += _lzw_decode(chunk)
        elif comp in (8, 32946):
            raw += zlib.decompress(chunk)
        else:
            raise ValueError(f"TIFF compression {comp} not supported")
    del rows_per_strip
    bits = bps[0]
    if fmtcode == 3 and bits == 32:
        arr = np.frombuffer(raw, e + "f4")
    elif bits == 8:
        arr = np.frombuffer(raw, np.uint8)
    elif bits == 16:
        arr = np.frombuffer(raw, e + "u2")
    else:
        raise ValueError(f"TIFF {bits}-bit fmt {fmtcode} not supported")
    arr = arr[: h * w * spp].reshape(h, w, spp)
    if predictor == 2:
        arr = np.cumsum(arr.astype(np.int64), axis=1).astype(arr.dtype)
    return arr.astype(np.float32)


def write_tiff(path: str, img: np.ndarray) -> None:
    """Write float32 (H, W, C) as an uncompressed single-strip float TIFF
    (the format iio emits for the pipeline's .tif artifacts)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    data = np.ascontiguousarray(img, "<f4").tobytes()
    tags = [
        (256, 4, 1, w),          # width
        (257, 4, 1, h),          # height
        (258, 3, c, None),       # bits per sample (16bit type, value 32 each)
        (259, 3, 1, 1),          # no compression
        (262, 3, 1, 1),          # photometric: BlackIsZero
        (273, 4, 1, None),       # strip offset (patched below)
        (277, 3, 1, c),          # samples per pixel
        (278, 4, 1, h),          # rows per strip
        (279, 4, 1, len(data)),  # strip byte count
        (339, 3, c, None),       # sample format: IEEE float (3)
    ]
    nent = len(tags)
    ifd_off = 8
    extra_off = ifd_off + 2 + 12 * nent + 4
    extra = b""
    entries = b""
    # bits-per-sample and sample-format arrays may need external storage
    def val_or_ptr(typ, cnt, values):
        nonlocal extra
        fmt = {3: "H", 4: "I"}[typ]
        sz = {3: 2, 4: 4}[typ]
        raw = struct.pack("<" + fmt * cnt, *values)
        if len(raw) <= 4:
            return raw + b"\x00" * (4 - len(raw))
        ptr = extra_off + len(extra)
        extra += raw
        return struct.pack("<I", ptr)

    data_off_placeholder = {}
    for tag, typ, cnt, val in tags:
        entries += struct.pack("<HHI", tag, typ, cnt)
        if tag == 258:
            entries += val_or_ptr(typ, cnt, [32] * c)
        elif tag == 339:
            entries += val_or_ptr(typ, cnt, [3] * c)
        elif tag == 273:
            data_off_placeholder[273] = len(entries)
            entries += struct.pack("<I", 0)
        else:
            entries += val_or_ptr(typ, cnt, [val])
    data_off = extra_off + len(extra)
    entries = (
        entries[: data_off_placeholder[273]]
        + struct.pack("<I", data_off)
        + entries[data_off_placeholder[273] + 4 :]
    )
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, ifd_off))
        f.write(struct.pack("<H", nent) + entries + struct.pack("<I", 0))
        f.write(extra)
        f.write(data)
