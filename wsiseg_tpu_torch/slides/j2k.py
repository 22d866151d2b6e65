"""Aperio JPEG2000 SVS support (TIFF compression 33003 / 33005).

libtiff cannot decode Aperio's JPEG2000 codecs, so the C++ reader fails
loudly on them (native/wsitile/wsitile.cc — "undecodable TIFF tiles").
Real Aperio scanners commonly emit J2K, and the reference opens them
transparently through OpenSlide (reference utils/dataset.py:121,
utils/eval.py:63). This module closes that capability gap:

* :class:`J2KTiledSlide` — pure-Python TIFF directory walk + per-tile
  JPEG2000 codestream decode via PIL (OpenJPEG). Functional and correct;
  slower than the C++ path, so production ingest should convert once.
  :func:`wsiseg_tpu_torch.slides.reader.open_slide` routes ``.svs/.tif`` files
  here automatically when the first IFD sniffs as 33003/33005.
* :func:`convert_to_wsiraw` — one-time ingest to the ``.wsiraw`` mmap
  pyramid for the fast native path (CLI: ``python -m
  wsiseg_tpu_torch.cli.convert_slide in.svs out.wsiraw``).
* :func:`write_j2k_tiled_tiff` — synthetic Aperio-J2K-layout writer
  (lossless codestreams) for hermetic tests.

Compression semantics (matching OpenSlide's Aperio driver): 33005 tiles
decode directly as RGB; 33003 tiles are wavelet YCbCr — decoded samples
are converted with the full-range JPEG matrix.
"""

from __future__ import annotations

import io
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

APERIO_J2K_YCBCR = 33003
APERIO_J2K_RGB = 33005

# TIFF tag ids used here
_TAG_WIDTH = 256
_TAG_HEIGHT = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_SAMPLES = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_PLANAR = 284
_TAG_TILE_W = 322
_TAG_TILE_H = 323
_TAG_TILE_OFFSETS = 324
_TAG_TILE_COUNTS = 325

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 13: 4}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 16: "Q", 17: "q", 8: "h", 9: "i",
             11: "f", 12: "d"}
# Byte-valued tag types kept as raw bytes: 2 (ASCII — Software etc., read
# by the vendor sniffs) and 7 (UNDEFINED — JPEGTables). Fetched even in
# inline_only sniffs, but capped so a lying header can't make every
# open_slide() stage megabytes.
_TYPE_BYTES = (2, 7)
_MAX_SNIFF_TEXT_BYTES = 64 << 10


def _read_exact(f, n: int, what: str) -> bytes:
    """Read exactly ``n`` bytes or raise a clean ValueError — malformed /
    truncated slide files must never surface as bare struct.error."""
    data = f.read(n)
    if len(data) != n:
        raise ValueError(f"truncated TIFF: short read of {what}")
    return data


# Sanity caps for untrusted input: no real slide has >4096 tags per IFD,
# and the largest legitimate out-of-line arrays (tile offsets of a 100k²
# level-0 at 240² tiles) are ~1.4 MB — 256 MB is far past any real file.
_MAX_IFD_ENTRIES = 4096
_MAX_TAG_ARRAY_BYTES = 256 << 20


def _read_ifds(f, inline_only: bool = False) -> List[Dict[int, List[int]]]:
    """Parse every IFD of a classic or BigTIFF file into {tag: [values]}
    dicts (integer-typed tags only — all this reader needs).

    ``inline_only=True`` skips out-of-line value arrays (tile offsets /
    byte counts — potentially millions of entries per level): the cheap
    mode for sniffing single-valued tags like Compression, which TIFF
    always stores inline."""
    header = f.read(8)
    if len(header) < 8 or header[:2] not in (b"II", b"MM"):
        raise ValueError("not a TIFF file")
    bo = "<" if header[:2] == b"II" else ">"
    magic = struct.unpack(bo + "H", header[2:4])[0]
    if magic == 42:
        big = False
        next_off = struct.unpack(bo + "I", header[4:8])[0]
    elif magic == 43:
        big = True
        f.seek(8)
        next_off = struct.unpack(bo + "Q", _read_exact(f, 8, "BigTIFF IFD0 offset"))[0]
    else:
        raise ValueError(f"bad TIFF magic {magic}")

    entry_size = 20 if big else 12
    ifds = []
    seen = set()
    while next_off and next_off not in seen and len(ifds) < 64:
        seen.add(next_off)
        f.seek(next_off)
        if big:
            (count,) = struct.unpack(bo + "Q", _read_exact(f, 8, "IFD entry count"))
        else:
            (count,) = struct.unpack(bo + "H", _read_exact(f, 2, "IFD entry count"))
        if count > _MAX_IFD_ENTRIES:
            raise ValueError(f"malformed TIFF: implausible IFD entry count {count}")
        raw = _read_exact(f, entry_size * count, "IFD entry table")
        tags: Dict[int, List[int]] = {}
        deferred = []  # (tag, typ, n, offset) for out-of-line values
        for i in range(count):
            e = raw[i * entry_size:(i + 1) * entry_size]
            tag, typ = struct.unpack(bo + "HH", e[:4])
            if big:
                (n,) = struct.unpack(bo + "Q", e[4:12])
                val = e[12:20]
            else:
                (n,) = struct.unpack(bo + "I", e[4:8])
                val = e[8:12]
            if typ in _TYPE_BYTES:
                # kept as one raw-bytes value (NUL trimmed by the
                # consumer) — vendor sniffs read Software, tile decoders
                # read JPEGTables
                if n <= len(val):
                    tags[tag] = [val[:n]]
                else:
                    off_fmt = "Q" if big else "I"
                    (off,) = struct.unpack(bo + off_fmt, val)
                    deferred.append((tag, typ, n, off))
                continue
            if typ not in _TYPE_FMT:
                continue
            nbytes = _TYPE_SIZE[typ] * n
            if nbytes <= len(val):
                tags[tag] = list(struct.unpack(bo + _TYPE_FMT[typ] * n,
                                               val[:nbytes]))
            else:
                off_fmt = "Q" if big else "I"
                (off,) = struct.unpack(bo + off_fmt, val)
                deferred.append((tag, typ, n, off))
        if big:
            (next_off,) = struct.unpack(bo + "Q", _read_exact(f, 8, "next-IFD offset"))
        else:
            (next_off,) = struct.unpack(bo + "I", _read_exact(f, 4, "next-IFD offset"))
        for tag, typ, n, off in deferred:
            if typ in _TYPE_BYTES:
                if n > _MAX_SNIFF_TEXT_BYTES:
                    continue  # lying/huge text tag — drop, never a level tag
                try:
                    f.seek(off)
                    tags[tag] = [_read_exact(f, n, f"tag {tag} text value")]
                except (ValueError, OSError):
                    # bogus offset on a descriptive tag: drop it — the old
                    # parser ignored byte tags entirely, and aborting here
                    # would misroute otherwise-readable slides (the sniffs
                    # treat a parse failure as "not this vendor")
                    pass
                continue
            if inline_only:
                continue
            nbytes = _TYPE_SIZE[typ] * n
            if nbytes > _MAX_TAG_ARRAY_BYTES:
                raise ValueError(
                    f"malformed TIFF: tag {tag} claims {nbytes}-byte value array")
            f.seek(off)
            data = _read_exact(f, nbytes, f"tag {tag} value array")
            tags[tag] = list(struct.unpack(bo + _TYPE_FMT[typ] * n,
                                           data))
        ifds.append(tags)
    return ifds


def sniff_tiff_compressions(path: str) -> Tuple[int, ...]:
    """Compression tag of every IFD (cheap: header + IFD entry reads only;
    out-of-line arrays like tile offsets are never touched — open_slide
    runs this sniff on EVERY .svs/.tif open)."""
    try:
        with open(path, "rb") as f:
            ifds = _read_ifds(f, inline_only=True)
    except (ValueError, OSError, struct.error):
        return ()
    return tuple(t.get(_TAG_COMPRESSION, [0])[0] for t in ifds)


def aperio_j2k_from_ifds(ifds) -> bool:
    """J2K-routing predicate over an already-parsed (inline) IFD list —
    shared by :func:`is_aperio_j2k` and ``open_slide``'s one-pass
    classifier (vendor.classify_tiff)."""
    pyramid = [t.get(_TAG_COMPRESSION, [1])[0] for t in ifds
               # _TAG_TILE_W is a single inline value — a reliable
               # tiledness probe in inline_only mode (tile offsets are
               # out-of-line arrays and may be absent from the sniff)
               if _TAG_TILE_W in t and t.get(_TAG_SAMPLES, [3])[0] == 3]
    return bool(pyramid) and all(
        c in (APERIO_J2K_YCBCR, APERIO_J2K_RGB) for c in pyramid)


def is_aperio_j2k(path: str) -> bool:
    """True when the file's pyramid (tiled 3-sample directories) is
    entirely Aperio-JPEG2000 compressed — the routing predicate for
    :class:`J2KTiledSlide`.

    Mixed files (some tiled RGB levels libtiff-decodable, some J2K) return
    False so ``open_slide`` keeps routing them to NativeSlide, which reads
    the decodable levels and fails loudly only on a J2K tile read — the
    pre-J2K behavior. Routing them here instead would make the whole file
    unopenable (J2KTiledSlide rejects non-J2K tiled dirs). Stripped
    directories (Aperio label/macro) are ignored, as in J2KTiledSlide.
    """
    try:
        with open(path, "rb") as f:
            ifds = _read_ifds(f, inline_only=True)
    except (ValueError, OSError, struct.error):
        return False
    return aperio_j2k_from_ifds(ifds)


def _ycbcr_to_rgb(arr: np.ndarray) -> np.ndarray:
    """Full-range JPEG YCbCr → RGB (OpenSlide's Aperio 33003 semantics)."""
    y = arr[..., 0].astype(np.float32)
    cb = arr[..., 1].astype(np.float32) - 128.0
    cr = arr[..., 2].astype(np.float32) - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _rgb_to_ycbcr(arr: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_ycbcr_to_rgb` (fixture writer for 33003)."""
    r = arr[..., 0].astype(np.float32)
    g = arr[..., 1].astype(np.float32)
    b = arr[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return np.clip(np.round(np.stack([y, cb, cr], -1)), 0, 255).astype(np.uint8)


class J2KTiledSlide:
    """SlideReader over an Aperio-JPEG2000 tiled TIFF/SVS.

    Tiled RGB directories become pyramid levels (sorted by width,
    descending); stripped directories (Aperio label/macro images) are
    skipped, matching the native reader. ``read_region`` takes level-0
    coordinates (OpenSlide convention) and pads out-of-bounds with white.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._io_lock = threading.Lock()
        levels = []
        for tags in _read_ifds(self._f):
            comp = tags.get(_TAG_COMPRESSION, [1])[0]
            if _TAG_TILE_OFFSETS not in tags:
                continue          # stripped dir (label/macro) — not a level
            if tags.get(_TAG_SAMPLES, [3])[0] != 3:
                continue
            if comp not in (APERIO_J2K_YCBCR, APERIO_J2K_RGB):
                raise ValueError(
                    f"J2KTiledSlide: directory compression {comp} is not "
                    "Aperio JPEG2000 — open it with NativeSlide instead")
            self._validate_level_tags(path, tags)
            levels.append(tags)
        if not levels:
            raise ValueError(f"{path!r}: no tiled J2K directories")
        import os
        self._fsize = os.fstat(self._f.fileno()).st_size
        levels.sort(key=lambda t: -t[_TAG_WIDTH][0])
        self._levels = levels
        self._dims = tuple((t[_TAG_WIDTH][0], t[_TAG_HEIGHT][0])
                           for t in levels)
        w0 = float(self._dims[0][0])
        self._downsamples = tuple(w0 / w for (w, _h) in self._dims)
        self._cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._cache_cap = 64
        self._cache_lock = threading.Lock()  # read_tiles decodes threaded

    @staticmethod
    def _validate_level_tags(path: str, tags: Dict[int, List[int]]) -> None:
        """Reject structurally invalid tiled directories with a clean error
        (this reader opens untrusted scanner output)."""
        for tag, name in ((_TAG_WIDTH, "ImageWidth"), (_TAG_HEIGHT, "ImageLength"),
                          (_TAG_TILE_W, "TileWidth"), (_TAG_TILE_H, "TileLength"),
                          (_TAG_TILE_COUNTS, "TileByteCounts")):
            if not tags.get(tag):
                raise ValueError(f"{path!r}: tiled directory missing {name} tag")
        w, h = tags[_TAG_WIDTH][0], tags[_TAG_HEIGHT][0]
        tw, th = tags[_TAG_TILE_W][0], tags[_TAG_TILE_H][0]
        if min(w, h, tw, th) <= 0:
            raise ValueError(
                f"{path!r}: non-positive image/tile dimensions "
                f"({w}x{h}, tile {tw}x{th})")
        n_tiles = ((w + tw - 1) // tw) * ((h + th - 1) // th)
        if (len(tags[_TAG_TILE_OFFSETS]) < n_tiles
                or len(tags[_TAG_TILE_COUNTS]) < n_tiles):
            raise ValueError(
                f"{path!r}: directory declares {n_tiles} tiles but carries "
                f"{len(tags[_TAG_TILE_OFFSETS])} offsets / "
                f"{len(tags[_TAG_TILE_COUNTS])} byte counts")

    # ---- SlideReader protocol ----

    @property
    def level_count(self) -> int:
        return len(self._levels)

    @property
    def level_dimensions(self) -> Tuple[Tuple[int, int], ...]:
        return self._dims

    @property
    def level_downsamples(self) -> Tuple[float, ...]:
        return self._downsamples

    def _decode_tile(self, level: int, idx: int) -> np.ndarray:
        """Decode tile ``idx`` of ``level`` to (th, tw, 3) RGB uint8."""
        key = (level, idx)
        with self._cache_lock:
            hit = self._cache.get(key)
        if hit is not None:
            return hit
        tags = self._levels[level]
        off = tags[_TAG_TILE_OFFSETS][idx]
        cnt = tags[_TAG_TILE_COUNTS][idx]
        if cnt <= 0 or off <= 0 or off + cnt > self._fsize:
            raise ValueError(
                f"{self.path!r}: level {level} tile {idx} extent is outside "
                f"the file (offset {off}, {cnt} bytes, file {self._fsize})")
        with self._io_lock:
            self._f.seek(off)
            data = self._f.read(cnt)
        from PIL import Image
        try:
            arr = np.asarray(Image.open(io.BytesIO(data)))
        except Exception as e:
            raise ValueError(
                f"{self.path!r}: level {level} tile {idx} codestream is "
                f"undecodable: {e}") from e
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        arr = np.ascontiguousarray(arr[..., :3])
        if tags[_TAG_COMPRESSION][0] == APERIO_J2K_YCBCR:
            arr = _ycbcr_to_rgb(arr)
        with self._cache_lock:
            while len(self._cache) >= self._cache_cap:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = arr
        return arr

    def _read_at_level(self, level: int, x0: int, y0: int,
                       w: int, h: int) -> np.ndarray:
        """(h, w, 3) at LEVEL coords, white-padded out of bounds."""
        tags = self._levels[level]
        lw, lh = self._dims[level]
        tw, th = tags[_TAG_TILE_W][0], tags[_TAG_TILE_H][0]
        tiles_x = (lw + tw - 1) // tw
        out = np.full((h, w, 3), 255, np.uint8)
        ix0, ix1 = max(0, x0) // tw, (min(lw, x0 + w) + tw - 1) // tw
        iy0, iy1 = max(0, y0) // th, (min(lh, y0 + h) + th - 1) // th
        for iy in range(iy0, max(iy0, iy1)):
            for ix in range(ix0, max(ix0, ix1)):
                tile = self._decode_tile(level, iy * tiles_x + ix)
                # tile extent clipped to the image, then to the request
                ty0, tx0 = iy * th, ix * tw
                sy0 = max(ty0, y0, 0)
                sy1 = min(ty0 + th, y0 + h, lh)
                sx0 = max(tx0, x0, 0)
                sx1 = min(tx0 + tw, x0 + w, lw)
                if sy1 <= sy0 or sx1 <= sx0:
                    continue
                out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = \
                    tile[sy0 - ty0:sy1 - ty0, sx0 - tx0:sx1 - tx0]
        return out

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        ds = self._downsamples[level]
        # floor (not truncate-toward-zero): OpenSlide's convention for
        # negative out-of-bounds level-0 coordinates
        x0 = int(np.floor(location[0] / ds))
        y0 = int(np.floor(location[1] / ds))
        w, h = int(size[0]), int(size[1])
        return self._read_at_level(level, x0, y0, w, h)

    def read_level(self, level: int) -> np.ndarray:
        w, h = self._dims[level]
        return self._read_at_level(level, 0, 0, w, h)

    def read_tiles(self, xs: Sequence[int], ys: Sequence[int], level: int,
                   tile_w: int, tile_h: int,
                   nthreads: Optional[int] = None,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched tile decode at LEVEL coordinates (native-reader API
        twin; threaded — PIL's OpenJPEG decode releases the GIL)."""
        from concurrent.futures import ThreadPoolExecutor
        xs_a = np.asarray(xs, np.int64)
        ys_a = np.asarray(ys, np.int64)
        n = len(xs_a)
        if out is None:
            out = np.empty((n, tile_h, tile_w, 3), np.uint8)

        def work(i):
            out[i] = self._read_at_level(level, int(xs_a[i]), int(ys_a[i]),
                                         tile_w, tile_h)

        with ThreadPoolExecutor(max_workers=max(1, nthreads or 4)) as pool:
            list(pool.map(work, range(n)))
        return out

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_j2k_tiled_tiff(path: str, levels: Sequence[np.ndarray],
                         tile_size: int = 128,
                         compression=APERIO_J2K_RGB) -> str:
    """Write an Aperio-layout tiled TIFF whose tiles are LOSSLESS JPEG2000
    codestreams (compression 33005 RGB, or 33003 with YCbCr-transformed
    samples). Classic little-endian TIFF; hermetic test fixture for the
    J2K ingest path — no real scanner output required.

    ``compression`` may be a per-level sequence; value 1 writes that
    level's tiles UNCOMPRESSED (libtiff-decodable) — used to synthesize
    mixed-compression files for the open_slide routing tests."""
    from PIL import Image

    comps = (list(compression) if isinstance(compression, (list, tuple))
             else [compression] * len(levels))
    if len(comps) != len(levels):
        raise ValueError("per-level compression list length mismatch")

    def enc(tile: np.ndarray, comp: int) -> bytes:
        if comp == 1:
            return tile.tobytes()
        buf = io.BytesIO()
        Image.fromarray(tile).save(buf, "JPEG2000", no_jp2=True,
                                   irreversible=False)
        return buf.getvalue()

    out = io.BytesIO()
    out.write(struct.pack("<2sHI", b"II", 42, 0))  # IFD0 offset patched later
    ifd_off_pos = 4
    for lv, compression in zip(levels, comps):
        lv = np.ascontiguousarray(lv, np.uint8)
        if compression == APERIO_J2K_YCBCR:
            lv_enc = _rgb_to_ycbcr(lv)
        else:
            lv_enc = lv
        h, w = lv.shape[:2]
        ts = tile_size
        tiles_x, tiles_y = (w + ts - 1) // ts, (h + ts - 1) // ts
        offsets, counts = [], []
        for iy in range(tiles_y):
            for ix in range(tiles_x):
                tile = np.full((ts, ts, 3), 255, np.uint8)
                block = lv_enc[iy * ts:iy * ts + ts, ix * ts:ix * ts + ts]
                tile[:block.shape[0], :block.shape[1]] = block
                data = enc(tile, compression)
                offsets.append(out.tell())
                counts.append(len(data))
                out.write(data)

        # out-of-line arrays (word-aligned)
        if out.tell() % 2:
            out.write(b"\0")
        bits_off = out.tell()
        out.write(struct.pack("<3H", 8, 8, 8))
        if out.tell() % 2:
            out.write(b"\0")
        offs_off = out.tell()
        out.write(struct.pack(f"<{len(offsets)}I", *offsets))
        cnts_off = out.tell()
        out.write(struct.pack(f"<{len(counts)}I", *counts))

        n_tiles = len(offsets)
        entries = [
            (_TAG_WIDTH, 4, 1, w),
            (_TAG_HEIGHT, 4, 1, h),
            (_TAG_BITS, 3, 3, bits_off),
            (_TAG_COMPRESSION, 3, 1, compression),
            (_TAG_PHOTOMETRIC, 3, 1,
             6 if compression == APERIO_J2K_YCBCR else 2),
            (_TAG_SAMPLES, 3, 1, 3),
            (_TAG_PLANAR, 3, 1, 1),
            (_TAG_TILE_W, 3, 1, ts),
            (_TAG_TILE_H, 3, 1, ts),
            (_TAG_TILE_OFFSETS, 4, n_tiles,
             offsets[0] if n_tiles == 1 else offs_off),
            (_TAG_TILE_COUNTS, 4, n_tiles,
             counts[0] if n_tiles == 1 else cnts_off),
        ]
        ifd_off = out.tell()
        # patch previous next-IFD pointer
        end = out.tell()
        out.seek(ifd_off_pos)
        out.write(struct.pack("<I", ifd_off))
        out.seek(end)
        out.write(struct.pack("<H", len(entries)))
        for tag, typ, n, val in sorted(entries):
            if typ == 3 and n == 1:
                out.write(struct.pack("<HHIHH", tag, typ, n, val, 0))
            else:
                out.write(struct.pack("<HHII", tag, typ, n, val))
        ifd_off_pos = out.tell()
        out.write(struct.pack("<I", 0))

    with open(path, "wb") as f:
        f.write(out.getvalue())
    return path


_RAW_MAGIC = 0x77736972617731  # kRawMagic in native/wsitile/wsitile.cc
_RAW_MAX_LEVELS = 16


def convert_to_wsiraw(src: str, dst: str,
                      max_band_bytes: int = 256 << 20) -> str:
    """One-time ingest: decode every pyramid level of ``src`` (any
    supported reader, including J2K SVS) and write the ``.wsiraw`` mmap
    pyramid the C++ fast path reads. Returns ``dst``.

    Streams each level in horizontal bands of at most ``max_band_bytes``
    decoded pixels (via the reader's level-coordinate ``read_tiles``), so
    peak memory is one band — a production 90k×60k level 0 (~16 GB RGB)
    converts in ~256 MB of RAM instead of holding every level at once.
    The format is written directly (RawHeader: magic + levels + dims[32],
    then contiguous RGB planes — native/wsitile/wsitile.cc
    ``wsitile_write_raw``), byte-identical to the C++ writer."""
    from wsiseg_tpu_torch.slides.reader import open_slide

    slide = open_slide(src)
    try:
        n = slide.level_count
        if not 1 <= n <= _RAW_MAX_LEVELS:
            raise ValueError(f"{src!r}: {n} levels out of wsiraw range")
        dims = list(slide.level_dimensions)
        with open(dst, "wb") as f:
            hdr = struct.pack(
                "<Qq", _RAW_MAGIC, n) + struct.pack(
                "<32q", *[v for (w, h) in dims for v in (w, h)]
                + [0] * (2 * (_RAW_MAX_LEVELS - n)))
            f.write(hdr)
            read_tiles = getattr(slide, "read_tiles", None)
            for k, (w, h) in enumerate(dims):
                ds = slide.level_downsamples[k]
                band_h = max(1, min(h, max_band_bytes // max(1, w * 3)))
                for y0 in range(0, h, band_h):
                    bh = min(band_h, h - y0)
                    if read_tiles is not None:
                        band = read_tiles([0], [y0], k, w, bh)[0]
                    else:
                        # SlideReader protocol fallback (.npy/PIL inputs):
                        # read_region takes LEVEL-0 coords, size in level-k
                        band = slide.read_region((0, int(round(y0 * ds))),
                                                 k, (w, bh))
                    f.write(np.ascontiguousarray(band, np.uint8).tobytes())
    finally:
        slide.close()
    return dst
