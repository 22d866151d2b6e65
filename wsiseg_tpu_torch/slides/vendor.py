"""Vendor WSI formats beyond Aperio SVS: Hamamatsu NDPI and Philips TIFF.

The reference opens every vendor format transparently through OpenSlide
(reference utils/dataset.py:121, utils/eval.py:63). The native stack
reads SVS / tiled TIFF / J2K-SVS / .wsiraw; this module closes the two
most common remaining single-file vendor formats with pure-Python readers
built on the same hardened TIFF IFD walk as :mod:`wsiseg_tpu_torch.slides.j2k`:

* Hamamatsu NDPI (:class:`NDPISlide`) — a classic little-endian TIFF
  whose IFDs are whole-slide images at descending magnifications, stored
  as STRIPS (typically one strip per image) with the old-style JPEG
  compression tag 6 that libtiff refuses to decode. Pyramid levels are
  the IFDs with a positive SourceLens (tag 65421); the macro
  (SourceLens == -1) and map (== -2) images are exposed via
  :meth:`NDPISlide.associated_image`.
* Philips TIFF (:class:`PhilipsTiffSlide`) — a tiled (Big)TIFF pyramid
  identified by Software="Philips..." (tag 305). Tiles may be SPARSE
  (offset/bytecount 0 → background white, the scanner's empty-region
  encoding), and JPEG tiles may share one split JPEGTables stream (tag
  347) that must be merged into each abbreviated tile stream.

Both implement the :class:`~wsiseg_tpu_torch.slides.reader.SlideReader`
protocol (level-0 coordinates, RGB output, white out-of-bounds) plus the
batched ``read_tiles`` API the banded
:func:`wsiseg_tpu_torch.slides.j2k.convert_to_wsiraw` ingest uses, so
production pipelines convert once to ``.wsiraw`` for the C++ fast path
(``python -m wsiseg_tpu.cli.convert_slide in.ndpi out.wsiraw``).

Known bounds (documented, loud): multi-file formats (MIRAX ``.mrxs``,
DICOM WSI) are rejected with an explanatory error in ``open_slide``;
LZW tiles route to the C++/libtiff reader rather than being re-decoded
here. Giant single-strip NDPI JPEG levels are randomly accessed by
DRI restart-marker bands (:mod:`wsiseg_tpu_torch.slides.jpegband` — the real
NDP.scan layout), bit-identical to a whole decode with bounded memory;
streams without restart markers fall back to whole-strip decode.
"""

from __future__ import annotations

import io
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from wsiseg_tpu_torch.slides.j2k import (
    APERIO_J2K_RGB,
    APERIO_J2K_YCBCR,
    _read_ifds,
    _ycbcr_to_rgb,
)

# TIFF tag ids (shared ones re-declared here to keep this module readable)
_TAG_SUBFILE = 254
_TAG_WIDTH = 256
_TAG_HEIGHT = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_DESCRIPTION = 270
_TAG_STRIP_OFFSETS = 273
_TAG_SAMPLES = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_COUNTS = 279
_TAG_PLANAR = 284
_TAG_PREDICTOR = 317
_TAG_SOFTWARE = 305
_TAG_TILE_W = 322
_TAG_TILE_H = 323
_TAG_TILE_OFFSETS = 324
_TAG_TILE_COUNTS = 325
_TAG_JPEG_TABLES = 347

# Hamamatsu private tags (the NDPI dialect marker + per-IFD lens power)
_TAG_NDPI_MARKER = 65420
_TAG_NDPI_SOURCELENS = 65421

_COMP_NONE = 1
_COMP_JPEG_OLD = 6
_COMP_JPEG = 7
_COMP_DEFLATE = 8
_COMP_DEFLATE_ADOBE = 32946


def _tag_text(tags: Dict[int, list], tag: int) -> str:
    """ASCII tag value as a stripped str ('' when absent)."""
    vals = tags.get(tag)
    if not vals or not isinstance(vals[0], (bytes, bytearray)):
        return ""
    return bytes(vals[0]).split(b"\0", 1)[0].decode("latin-1", "replace")


def _vendor_from_ifds(ifds) -> Optional[str]:
    if not ifds:
        return None
    if any(_TAG_NDPI_MARKER in t for t in ifds):
        return "ndpi"
    for t in ifds:
        if _tag_text(t, _TAG_SOFTWARE).startswith("Philips"):
            return "philips"
    return None


def sniff_vendor(path: str) -> Optional[str]:
    """Identify the vendor dialect of a TIFF container: ``"ndpi"``,
    ``"philips"``, or None (plain/Aperio TIFF). Cheap: inline IFD entries
    plus small ASCII tag fetches only."""
    try:
        with open(path, "rb") as f:
            ifds = _read_ifds(f, inline_only=True)
    except (ValueError, OSError, struct.error):
        return None
    return _vendor_from_ifds(ifds)


def classify_tiff(path: str) -> Optional[str]:
    """ONE inline IFD walk feeding every routing predicate ``open_slide``
    needs: ``"ndpi"`` / ``"philips"`` / ``"j2k"`` (Aperio JPEG2000
    pyramid) / None (plain TIFF → the C++ native reader). Replaces three
    independent full-file sniffs on the evaluator's many-slide open
    path."""
    from wsiseg_tpu_torch.slides.j2k import aperio_j2k_from_ifds
    try:
        with open(path, "rb") as f:
            ifds = _read_ifds(f, inline_only=True)
    except (ValueError, OSError, struct.error):
        return None
    vendor = _vendor_from_ifds(ifds)
    if vendor:
        return vendor
    if aperio_j2k_from_ifds(ifds):
        return "j2k"
    return None


# ---------------------------------------------------------------------------
# shared decode helpers
# ---------------------------------------------------------------------------


def _split_jpeg_tables(data: bytes) -> Tuple[bytes, bytes]:
    """Split one interchange JPEG stream into (tables, abbreviated image)
    streams — the TIFF JPEGTables (tag 347) convention: DQT/DHT segments
    move to the tables stream, everything else (APPn/SOF/SOS/scan) stays.
    Fixture-writer helper; the decoder does the inverse merge."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream")
    tables = b""
    image = b""
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise ValueError("bad JPEG marker sync")
        marker = data[i + 1]
        if marker == 0xDA:  # SOS — the rest is entropy-coded data + EOI
            image += data[i:]
            break
        seglen = int.from_bytes(data[i + 2:i + 4], "big")
        seg = data[i:i + 2 + seglen]
        if marker in (0xDB, 0xC4):  # DQT / DHT
            tables += seg
        else:
            image += seg
        i += 2 + seglen
    return b"\xff\xd8" + tables + b"\xff\xd9", b"\xff\xd8" + image


def _merge_jpeg_tables(tables: bytes, abbrev: bytes) -> bytes:
    """Inverse of :func:`_split_jpeg_tables`: tables stream (minus EOI) +
    abbreviated stream (minus SOI)."""
    if len(tables) >= 4 and tables[:2] == b"\xff\xd8":
        return tables[:-2] + abbrev[2:]
    return abbrev


def _decode_block(data: bytes, comp: int, h: int, w: int,
                  jpeg_tables: Optional[bytes], what: str) -> np.ndarray:
    """Decode one strip/tile payload to (h, w, 3) uint8 RGB.

    JPEG (old-style 6 and new 7) goes through PIL (which applies the
    stream's own YCbCr→RGB); deflate and raw are unpacked directly;
    Aperio J2K reuses the j2k module's semantics. The decoded extent is
    cropped/padded to the declared (h, w) so a lying codestream cannot
    corrupt the caller's canvas geometry."""
    if comp == _COMP_NONE:
        need = h * w * 3
        if len(data) < need:
            raise ValueError(f"{what}: raw block carries {len(data)} bytes, "
                             f"needs {need}")
        arr = np.frombuffer(data, np.uint8, need).reshape(h, w, 3).copy()
        return arr
    if comp in (_COMP_DEFLATE, _COMP_DEFLATE_ADOBE):
        import zlib
        try:
            raw = zlib.decompress(data)
        except zlib.error as e:
            raise ValueError(f"{what}: deflate block undecodable: {e}") from e
        need = h * w * 3
        if len(raw) < need:
            raise ValueError(f"{what}: deflate block inflates to {len(raw)} "
                             f"bytes, needs {need}")
        return np.frombuffer(raw, np.uint8, need).reshape(h, w, 3).copy()
    if comp in (_COMP_JPEG_OLD, _COMP_JPEG):
        from PIL import Image
        stream = _merge_jpeg_tables(jpeg_tables or b"", data)
        try:
            img = Image.open(io.BytesIO(stream))
            arr = np.asarray(img.convert("RGB"))
        except Exception as e:
            raise ValueError(f"{what}: JPEG block undecodable: {e}") from e
    elif comp in (APERIO_J2K_YCBCR, APERIO_J2K_RGB):
        from PIL import Image
        try:
            arr = np.asarray(Image.open(io.BytesIO(data)))
        except Exception as e:
            raise ValueError(f"{what}: J2K block undecodable: {e}") from e
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        arr = np.ascontiguousarray(arr[..., :3])
        if comp == APERIO_J2K_YCBCR:
            arr = _ycbcr_to_rgb(arr)
    else:
        raise ValueError(
            f"{what}: compression {comp} is not decodable here — open via "
            "the native libtiff reader or convert with cli/convert_slide")
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    out = np.full((h, w, 3), 255, np.uint8)
    ch, cw = min(h, arr.shape[0]), min(w, arr.shape[1])
    out[:ch, :cw] = arr[:ch, :cw, :3]
    return out


def _white(h: int, w: int) -> np.ndarray:
    return np.full((h, w, 3), 255, np.uint8)


# ---------------------------------------------------------------------------
# Hamamatsu NDPI
# ---------------------------------------------------------------------------


class NDPISlide:
    """SlideReader over a Hamamatsu NDPI file.

    Pyramid = the striped RGB IFDs with SourceLens (tag 65421) > 0 (or
    untagged), ordered by width descending; SourceLens −1/−2 become the
    ``"macro"``/``"map"`` associated images (OpenSlide's naming). Strips
    are decoded lazily into a byte-budgeted LRU cache (hits refresh
    recency) that always retains the most recent strip, so banded
    whole-level reads decode each strip exactly once even when a level
    is one giant strip.

    Classic-TIFF NDPI files larger than 4 GiB are REFUSED loudly: the
    real-world dialect stores >32-bit strip offsets modulo 2^32 with
    driver-side fixups (OpenSlide's ndpi quirks); decoding the wrapped
    offsets as-is could return wrong pixels without an error.
    """

    def __init__(self, path: str, cache_bytes: int = 256 << 20):
        self.path = path
        self._f = open(path, "rb")
        self._io_lock = threading.Lock()
        import os
        self._fsize = os.fstat(self._f.fileno()).st_size
        header = self._f.read(4)
        self._f.seek(0)
        is_bigtiff = len(header) == 4 and header[2:4] in (b"\x2b\x00",
                                                          b"\x00\x2b")
        if not is_bigtiff and self._fsize > (1 << 32):
            self._f.close()
            raise ValueError(
                f"{path!r}: classic-TIFF NDPI over 4 GiB stores strip "
                "offsets modulo 2^32 (the Hamamatsu >4 GiB dialect) — "
                "refusing rather than risk decoding wrong bytes; convert "
                "the slide with vendor tooling or use a smaller level")
        try:
            ifds = _read_ifds(self._f)
        except (ValueError, struct.error) as e:
            self._f.close()
            raise ValueError(f"{path!r}: malformed NDPI TIFF: {e}") from e

        levels: List[Dict[int, list]] = []
        self._associated: Dict[str, Dict[int, list]] = {}
        try:
            for tags in ifds:
                if _TAG_STRIP_OFFSETS not in tags or _TAG_WIDTH not in tags:
                    continue
                lens = tags.get(_TAG_NDPI_SOURCELENS, [1.0])[0]
                if lens == -1:
                    self._associated["macro"] = tags
                    continue
                if lens == -2:
                    self._associated["map"] = tags
                    continue
                if lens <= 0 or tags.get(_TAG_SAMPLES, [3])[0] != 3:
                    continue
                self._validate_striped(path, tags)
                levels.append(tags)
        except ValueError:
            self._f.close()
            raise
        if not levels:
            self._f.close()
            raise ValueError(f"{path!r}: no NDPI pyramid directories")
        levels.sort(key=lambda t: -t[_TAG_WIDTH][0])
        self._levels = levels
        self._dims = tuple((t[_TAG_WIDTH][0], t[_TAG_HEIGHT][0])
                           for t in levels)
        w0 = float(self._dims[0][0])
        self._downsamples = tuple(w0 / w for (w, _h) in self._dims)
        self._cache: Dict[tuple, np.ndarray] = {}
        self._cache_bytes = 0
        self._cache_cap = cache_bytes
        self._cache_lock = threading.Lock()
        # restart-banded decode state per level (False = not probed yet;
        # None = not bandable → whole-strip decode). The probe lock keeps
        # two first readers from both running the linear restart-index
        # scan of a multi-GB strip.
        self._bandinfo: Dict[int, object] = {}
        self._band_lock = threading.Lock()

    def _validate_striped(self, path: str, tags: Dict[int, list]) -> None:
        w, h = tags[_TAG_WIDTH][0], tags.get(_TAG_HEIGHT, [0])[0]
        if w <= 0 or h <= 0:
            raise ValueError(f"{path!r}: non-positive NDPI image dims "
                             f"({w}x{h})")
        rps = tags.get(_TAG_ROWS_PER_STRIP, [h])[0]
        if rps <= 0:
            raise ValueError(f"{path!r}: non-positive RowsPerStrip {rps}")
        n = (h + rps - 1) // rps
        offs = tags.get(_TAG_STRIP_OFFSETS, [])
        cnts = tags.get(_TAG_STRIP_COUNTS, [])
        if len(offs) < n or len(cnts) < n:
            raise ValueError(
                f"{path!r}: NDPI directory declares {n} strips but carries "
                f"{len(offs)} offsets / {len(cnts)} byte counts")

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

    @property
    def associated_names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._associated))

    def associated_image(self, name: str) -> np.ndarray:
        """Decode a non-pyramid image ('macro'/'map') to (H, W, 3) u8."""
        tags = self._associated.get(name)
        if tags is None:
            raise KeyError(f"{self.path!r} has no associated image "
                           f"{name!r} (have {self.associated_names})")
        # macro/map IFDs skip init-time validation (a broken associated
        # image must not make the pyramid unopenable) — validate here so
        # malformed ones raise the module's clean ValueError, not a bare
        # KeyError/ZeroDivisionError
        self._validate_striped(self.path, tags)
        return self._read_striped(tags, f"associated {name}")

    def _read_striped(self, tags: Dict[int, list], what: str) -> np.ndarray:
        w, h = tags[_TAG_WIDTH][0], tags[_TAG_HEIGHT][0]
        rps = tags.get(_TAG_ROWS_PER_STRIP, [h])[0]
        rows = []
        for s in range((h + rps - 1) // rps):
            sh = min(rps, h - s * rps)
            rows.append(self._decode_strip_raw(tags, s, sh, w, what))
        return np.concatenate(rows, axis=0) if len(rows) > 1 else rows[0]

    def _decode_strip_raw(self, tags, idx: int, sh: int, w: int,
                          what: str) -> np.ndarray:
        off = tags[_TAG_STRIP_OFFSETS][idx]
        cnt = tags[_TAG_STRIP_COUNTS][idx]
        if cnt <= 0 or off <= 0 or off + cnt > self._fsize:
            raise ValueError(
                f"{self.path!r}: {what} strip {idx} extent is outside the "
                f"file (offset {off}, {cnt} bytes, file {self._fsize})")
        with self._io_lock:
            self._f.seek(off)
            data = self._f.read(cnt)
        comp = tags.get(_TAG_COMPRESSION, [_COMP_NONE])[0]
        tables = tags.get(_TAG_JPEG_TABLES)
        tbytes = bytes(tables[0]) if tables and isinstance(
            tables[0], (bytes, bytearray)) else (
            bytes(tables) if tables else None)
        return _decode_block(data, comp, sh, w, tbytes,
                             f"{self.path!r}: {what} strip {idx}")

    def _read_at(self, pos: int, n: int) -> bytes:
        with self._io_lock:
            self._f.seek(pos)
            return self._f.read(n)

    def _cache_get(self, key):
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.pop(key)       # LRU: refresh recency
                self._cache[key] = hit
            return hit

    def _cache_put(self, key, arr: np.ndarray) -> np.ndarray:
        with self._cache_lock:
            if key in self._cache:
                return self._cache[key]    # lost a decode race: count once
            while self._cache and self._cache_bytes + arr.nbytes > self._cache_cap:
                old = self._cache.pop(next(iter(self._cache)))
                self._cache_bytes -= old.nbytes
            self._cache[key] = arr
            self._cache_bytes += arr.nbytes
        return arr

    def _band_structure(self, level: int):
        """Lazily probe a single-JPEG-strip level for restart-banded
        random access (slides/jpegband.py): returns (structure,
        segment starts, EOI offset, read_at-closure) or None when the
        level must be decoded whole (multi-strip, raw, no/ragged DRI,
        progressive). The one-time restart index scan reads the strip
        linearly WITHOUT decoding it."""
        with self._band_lock:
            cached = self._bandinfo.get(level, False)
            if cached is not False:
                return cached
            from wsiseg_tpu_torch.slides.jpegband import (index_restarts,
                                                    parse_structure)
            info = None
            tags = self._levels[level]
            w, h = self._dims[level]
            rps = tags.get(_TAG_ROWS_PER_STRIP, [h])[0]
            comp = tags.get(_TAG_COMPRESSION, [_COMP_NONE])[0]
            if (comp in (_COMP_JPEG_OLD, _COMP_JPEG)
                    and (h + rps - 1) // rps == 1
                    # abbreviated streams (split JPEGTables, tag 347) carry
                    # no DQT/DHT of their own — the synthetic band JPEG
                    # would be undecodable; whole-strip decode merges the
                    # tables (_merge_jpeg_tables) and stays correct
                    and _TAG_JPEG_TABLES not in tags):
                off = tags[_TAG_STRIP_OFFSETS][0]
                cnt = tags[_TAG_STRIP_COUNTS][0]
                if 0 < off and 0 < cnt and off + cnt <= self._fsize:
                    st = parse_structure(
                        self._read_at(off, min(cnt, 256 << 10)))
                    if (st is not None and st.bandable
                            and st.width >= w and st.height >= h):
                        ra = (lambda p, n, _o=off: self._read_at(_o + p, n))
                        starts, eoi = index_restarts(
                            ra, st.entropy_start, cnt - st.entropy_start)
                        info = (st, starts, eoi, ra)
            self._bandinfo[level] = info
            return info

    def _jband(self, level: int, y0: int, y1: int) -> np.ndarray:
        """Cached banded decode of pixel rows [y0, y1) of a bandable
        level — peak memory is the requested band plus one restart
        segment of chroma-upsampling margin per side, never the whole
        (potentially multi-GB) strip. The cache is keyed on the
        SEGMENT-ALIGNED span actually decoded (not the raw request), so
        overlapping requests with different row offsets dedupe both the
        decode work and the cached bytes."""
        st, starts, eoi, ra = self._band_structure(level)
        rps = st.rows_per_segment_px
        ya = (y0 // rps) * rps
        yb = min(((y1 + rps - 1) // rps) * rps, st.height)
        key = ("jband", level, ya, yb)
        hit = self._cache_get(key)
        if hit is None:
            from wsiseg_tpu_torch.slides.jpegband import decode_rows
            try:
                arr = decode_rows(ra, st, starts, eoi, ya, yb)
            except Exception as e:
                raise ValueError(
                    f"{self.path!r}: level {level} banded JPEG decode of "
                    f"rows [{ya},{yb}) failed: {e}") from e
            hit = self._cache_put(key, arr)
        return hit[y0 - ya:y1 - ya]

    def _strip(self, level: int, idx: int) -> np.ndarray:
        """Cached decode of pyramid strip ``idx`` of ``level``.

        The LRU always keeps the newly decoded strip (the _cache_put
        eviction loop stops before removing it), so banded reads of a
        one-strip level decode it exactly once; the decode-race re-check
        in _cache_put counts a concurrently inserted strip's bytes ONCE
        (a double-add would leak _cache_bytes forever)."""
        key = (level, idx)
        hit = self._cache_get(key)
        if hit is not None:
            return hit
        tags = self._levels[level]
        w, h = self._dims[level]
        rps = tags.get(_TAG_ROWS_PER_STRIP, [h])[0]
        sh = min(rps, h - idx * rps)
        arr = self._decode_strip_raw(tags, idx, sh, w, f"level {level}")
        return self._cache_put(key, arr)

    def _read_at_level(self, level: int, x0: int, y0: int,
                       w: int, h: int) -> np.ndarray:
        lw, lh = self._dims[level]
        tags = self._levels[level]
        rps = tags.get(_TAG_ROWS_PER_STRIP, [lh])[0]
        out = _white(h, w)
        sy0, sy1 = max(0, y0), min(lh, y0 + h)
        sx0, sx1 = max(0, x0), min(lw, x0 + w)
        if sy1 <= sy0 or sx1 <= sx0:
            return out
        if self._band_structure(level) is not None:
            # single-JPEG-strip level with restart markers: decode only
            # the touched rows (real NDPI level 0 is one multi-GB JPEG —
            # whole-strip decode would hold the full level in host RAM)
            band = self._jband(level, sy0, sy1)
            out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = band[:, sx0:sx1]
            return out
        for s in range(sy0 // rps, (sy1 + rps - 1) // rps):
            strip = self._strip(level, s)
            ty0 = s * rps
            a0, a1 = max(sy0, ty0), min(sy1, ty0 + strip.shape[0])
            if a1 <= a0:
                continue
            out[a0 - y0:a1 - y0, sx0 - x0:sx1 - x0] = \
                strip[a0 - ty0:a1 - ty0, sx0:sx1]
        return out

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        ds = self._downsamples[level]
        x0 = int(np.floor(location[0] / ds))
        y0 = int(np.floor(location[1] / ds))
        return self._read_at_level(level, x0, y0, int(size[0]), int(size[1]))

    def read_level(self, level: int) -> np.ndarray:
        w, h = self._dims[level]
        return self._read_at_level(level, 0, 0, w, h)

    def read_tiles(self, xs: Sequence[int], ys: Sequence[int], level: int,
                   tile_w: int, tile_h: int,
                   nthreads: Optional[int] = None,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched tile reads at LEVEL coordinates (native-reader API
        twin). Sequential: strips are horizontal, so tile batches from the
        planner's row-major order hit the strip cache; threads would just
        contend on the decode lock."""
        xs_a = np.asarray(xs, np.int64)
        ys_a = np.asarray(ys, np.int64)
        n = len(xs_a)
        if out is None:
            out = np.empty((n, tile_h, tile_w, 3), np.uint8)
        for i in range(n):
            out[i] = self._read_at_level(level, int(xs_a[i]), int(ys_a[i]),
                                         tile_w, tile_h)
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


# ---------------------------------------------------------------------------
# Philips TIFF
# ---------------------------------------------------------------------------


class PhilipsTiffSlide:
    """SlideReader over a Philips tiled TIFF (Software="Philips...").

    Differences from the Aperio layout that this reader absorbs:
    tiles may be sparse (offset/bytecount 0 → white background), JPEG
    tiles may share one JPEGTables (tag 347) stream, and label/macro
    images live in striped IFDs (skipped here, as in the other readers).
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._io_lock = threading.Lock()
        import os
        self._fsize = os.fstat(self._f.fileno()).st_size
        try:
            ifds = _read_ifds(self._f)
        except (ValueError, struct.error) as e:
            self._f.close()
            raise ValueError(f"{path!r}: malformed Philips TIFF: {e}") from e
        levels = []
        try:
            for tags in ifds:
                if _TAG_TILE_OFFSETS not in tags:
                    continue
                if tags.get(_TAG_SAMPLES, [3])[0] != 3:
                    continue
                self._validate_tiled(path, tags)
                levels.append(tags)
        except ValueError:
            self._f.close()
            raise
        if not levels:
            self._f.close()
            raise ValueError(f"{path!r}: no tiled pyramid directories")
        levels.sort(key=lambda t: -t[_TAG_WIDTH][0])
        self._levels = levels
        self._dims = tuple((t[_TAG_WIDTH][0], t[_TAG_HEIGHT][0])
                           for t in levels)
        w0 = float(self._dims[0][0])
        self._downsamples = tuple(w0 / w for (w, _h) in self._dims)
        self._cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._cache_cap = 64
        self._cache_lock = threading.Lock()

    @staticmethod
    def _validate_tiled(path: str, tags: Dict[int, list]) -> None:
        for tag, name in ((_TAG_WIDTH, "ImageWidth"),
                          (_TAG_HEIGHT, "ImageLength"),
                          (_TAG_TILE_W, "TileWidth"),
                          (_TAG_TILE_H, "TileLength"),
                          (_TAG_TILE_COUNTS, "TileByteCounts")):
            if not tags.get(tag):
                raise ValueError(f"{path!r}: tiled directory missing {name}")
        w, h = tags[_TAG_WIDTH][0], tags[_TAG_HEIGHT][0]
        tw, th = tags[_TAG_TILE_W][0], tags[_TAG_TILE_H][0]
        if min(w, h, tw, th) <= 0:
            raise ValueError(f"{path!r}: non-positive image/tile dims "
                             f"({w}x{h}, tile {tw}x{th})")
        n = ((w + tw - 1) // tw) * ((h + th - 1) // th)
        if (len(tags[_TAG_TILE_OFFSETS]) < n
                or len(tags[_TAG_TILE_COUNTS]) < n):
            raise ValueError(
                f"{path!r}: directory declares {n} tiles but carries "
                f"{len(tags[_TAG_TILE_OFFSETS])} offsets / "
                f"{len(tags[_TAG_TILE_COUNTS])} byte counts")
        pred = tags.get(_TAG_PREDICTOR, [1])[0]
        if pred != 1:
            raise ValueError(
                f"{path!r}: predictor {pred} not supported here — open via "
                "the native libtiff reader")

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
        key = (level, idx)
        with self._cache_lock:
            hit = self._cache.get(key)
        if hit is not None:
            return hit
        tags = self._levels[level]
        tw, th = tags[_TAG_TILE_W][0], tags[_TAG_TILE_H][0]
        off = tags[_TAG_TILE_OFFSETS][idx]
        cnt = tags[_TAG_TILE_COUNTS][idx]
        if off == 0 or cnt == 0:
            # sparse tile: background (white) by Philips convention
            arr = _white(th, tw)
        else:
            if cnt < 0 or off < 0 or off + cnt > self._fsize:
                raise ValueError(
                    f"{self.path!r}: level {level} tile {idx} extent is "
                    f"outside the file (offset {off}, {cnt} bytes, "
                    f"file {self._fsize})")
            with self._io_lock:
                self._f.seek(off)
                data = self._f.read(cnt)
            comp = tags.get(_TAG_COMPRESSION, [_COMP_NONE])[0]
            tables = tags.get(_TAG_JPEG_TABLES)
            tbytes = bytes(tables[0]) if tables and isinstance(
                tables[0], (bytes, bytearray)) else None
            arr = _decode_block(data, comp, th, tw, tbytes,
                                f"{self.path!r}: level {level} tile {idx}")
        with self._cache_lock:
            while len(self._cache) >= self._cache_cap:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = arr
        return arr

    def _read_at_level(self, level: int, x0: int, y0: int,
                       w: int, h: int) -> np.ndarray:
        tags = self._levels[level]
        lw, lh = self._dims[level]
        tw, th = tags[_TAG_TILE_W][0], tags[_TAG_TILE_H][0]
        tiles_x = (lw + tw - 1) // tw
        out = _white(h, w)
        ix0, ix1 = max(0, x0) // tw, (min(lw, x0 + w) + tw - 1) // tw
        iy0, iy1 = max(0, y0) // th, (min(lh, y0 + h) + th - 1) // th
        for iy in range(iy0, max(iy0, iy1)):
            for ix in range(ix0, max(ix0, ix1)):
                tile = self._decode_tile(level, iy * tiles_x + ix)
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
        x0 = int(np.floor(location[0] / ds))
        y0 = int(np.floor(location[1] / ds))
        return self._read_at_level(level, x0, y0, int(size[0]), int(size[1]))

    def read_level(self, level: int) -> np.ndarray:
        w, h = self._dims[level]
        return self._read_at_level(level, 0, 0, w, h)

    def read_tiles(self, xs: Sequence[int], ys: Sequence[int], level: int,
                   tile_w: int, tile_h: int,
                   nthreads: Optional[int] = None,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched tile decode at LEVEL coordinates (threaded — PIL's
        JPEG decode releases the GIL)."""
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


# ---------------------------------------------------------------------------
# hermetic fixture writers (tests synthesize vendor files; no scanner output
# or network access required)
# ---------------------------------------------------------------------------


class _TiffBuilder:
    """Minimal classic little-endian TIFF writer for vendor fixtures.

    Entries are (tag, type, values) with types 2 (ASCII bytes, NUL
    terminated), 7 (UNDEFINED raw bytes), 3 (SHORT), 4 (LONG), 11 (FLOAT);
    out-of-line arrays are word-aligned, matching the j2k fixture writer's
    layout conventions."""

    def __init__(self):
        self.out = io.BytesIO()
        self.out.write(struct.pack("<2sHI", b"II", 42, 0))
        self._ifd_patch = 4

    def blob(self, data: bytes) -> int:
        if self.out.tell() % 2:
            self.out.write(b"\0")
        off = self.out.tell()
        self.out.write(data)
        return off

    def add_ifd(self, entries: List[Tuple[int, int, object]]) -> None:
        packed = []
        for tag, typ, values in entries:
            if typ in (2, 7):
                data = bytes(values)
                if typ == 2 and not data.endswith(b"\0"):
                    data += b"\0"
                n = len(data)
                val = (int.from_bytes(data.ljust(4, b"\0"), "little")
                       if n <= 4 else self.blob(data))
            elif typ == 11:
                vals = list(values)
                n = len(vals)
                raw = struct.pack(f"<{n}f", *vals)
                val = (struct.unpack("<I", raw.ljust(4, b"\0"))[0]
                       if n == 1 else self.blob(raw))
            else:
                fmt = {3: "H", 4: "I"}[typ]
                vals = [int(v) for v in (values if isinstance(
                    values, (list, tuple, np.ndarray)) else [values])]
                n = len(vals)
                raw = struct.pack(f"<{n}{fmt}", *vals)
                val = (int.from_bytes(raw.ljust(4, b"\0"), "little")
                       if len(raw) <= 4 else self.blob(raw))
            packed.append((tag, typ, n, val))
        if self.out.tell() % 2:
            self.out.write(b"\0")
        ifd_off = self.out.tell()
        end = ifd_off
        self.out.seek(self._ifd_patch)
        self.out.write(struct.pack("<I", ifd_off))
        self.out.seek(end)
        self.out.write(struct.pack("<H", len(packed)))
        for tag, typ, n, val in sorted(packed):
            self.out.write(struct.pack("<HHII", tag, typ, n, val))
        self._ifd_patch = self.out.tell()
        self.out.write(struct.pack("<I", 0))

    def save(self, path: str) -> str:
        with open(path, "wb") as f:
            f.write(self.out.getvalue())
        return path


def _encode_jpeg(arr: np.ndarray, quality: int,
                 restart_rows: int = 0) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    kw = {"restart_marker_rows": restart_rows} if restart_rows else {}
    Image.fromarray(arr).save(buf, "JPEG", quality=quality, **kw)
    return buf.getvalue()


def write_ndpi(path: str, levels: Sequence[np.ndarray],
               magnifications: Optional[Sequence[float]] = None,
               compression: str = "jpeg", rows_per_strip: int = 0,
               quality: int = 95, restart_rows: int = 0,
               macro: Optional[np.ndarray] = None) -> str:
    """Write a Hamamatsu-NDPI-layout TIFF: striped whole-image IFDs with
    the NDPI marker (65420) and SourceLens (65421) tags. ``rows_per_strip``
    0 means one strip per image (the common real layout); ``restart_rows``
    N writes JPEG strips with a DRI restart marker every N MCU rows (the
    real NDP.scan layout that makes giant strips randomly accessible —
    slides/jpegband.py); ``macro`` adds a SourceLens=-1 image."""
    if magnifications is None:
        magnifications = [40.0 / (2 ** i) for i in range(len(levels))]
    b = _TiffBuilder()

    def striped_ifd(arr: np.ndarray, lens: float):
        arr = np.ascontiguousarray(arr, np.uint8)
        h, w = arr.shape[:2]
        rps = rows_per_strip or h
        offs, cnts = [], []
        for y0 in range(0, h, rps):
            band = arr[y0:y0 + rps]
            if compression == "jpeg":
                data = _encode_jpeg(band, quality,
                                    restart_rows=restart_rows)
                comp, photo = _COMP_JPEG_OLD, 6
            else:
                data = band.tobytes()
                comp, photo = _COMP_NONE, 2
            offs.append(b.blob(data))
            cnts.append(len(data))
        b.add_ifd([
            (_TAG_SUBFILE, 4, 0),
            (_TAG_WIDTH, 4, w),
            (_TAG_HEIGHT, 4, h),
            (_TAG_BITS, 3, [8, 8, 8]),
            (_TAG_COMPRESSION, 3, comp),
            (_TAG_PHOTOMETRIC, 3, photo),
            (_TAG_STRIP_OFFSETS, 4, offs),
            (_TAG_SAMPLES, 3, 3),
            (_TAG_ROWS_PER_STRIP, 4, rps),
            (_TAG_STRIP_COUNTS, 4, cnts),
            (_TAG_PLANAR, 3, 1),
            (_TAG_SOFTWARE, 2, b"NDP.scan synthetic"),
            (_TAG_NDPI_MARKER, 4, 1),
            (_TAG_NDPI_SOURCELENS, 11, [float(lens)]),
        ])

    for arr, mag in zip(levels, magnifications):
        striped_ifd(arr, mag)
    if macro is not None:
        striped_ifd(macro, -1.0)
    return b.save(path)


def write_philips_tiff(path: str, levels: Sequence[np.ndarray],
                       tile_size: int = 128,
                       sparse: Sequence[Tuple[int, int, int]] = (),
                       compression: str = "jpeg",
                       use_jpeg_tables: bool = False,
                       quality: int = 95) -> str:
    """Write a Philips-layout tiled TIFF (Software tag "Philips DP v1.0").

    ``sparse`` lists (level, tile_iy, tile_ix) tiles written as
    offset=0/count=0 (the scanner's empty-background encoding);
    ``use_jpeg_tables`` moves the shared DQT/DHT segments into one
    JPEGTables (347) stream, leaving abbreviated per-tile streams."""
    b = _TiffBuilder()
    sparse_set = {tuple(s) for s in sparse}
    for li, arr in enumerate(levels):
        arr = np.ascontiguousarray(arr, np.uint8)
        h, w = arr.shape[:2]
        ts = tile_size
        tiles_x, tiles_y = (w + ts - 1) // ts, (h + ts - 1) // ts
        offs, cnts = [], []
        tables_stream = None
        for iy in range(tiles_y):
            for ix in range(tiles_x):
                if (li, iy, ix) in sparse_set:
                    offs.append(0)
                    cnts.append(0)
                    continue
                tile = np.full((ts, ts, 3), 255, np.uint8)
                block = arr[iy * ts:iy * ts + ts, ix * ts:ix * ts + ts]
                tile[:block.shape[0], :block.shape[1]] = block
                if compression == "jpeg":
                    data = _encode_jpeg(tile, quality)
                    if use_jpeg_tables:
                        tables_stream, data = _split_jpeg_tables(data)
                    comp, photo = _COMP_JPEG, 6
                elif compression == "deflate":
                    import zlib
                    data = zlib.compress(tile.tobytes())
                    comp, photo = _COMP_DEFLATE, 2
                else:
                    data = tile.tobytes()
                    comp, photo = _COMP_NONE, 2
                offs.append(b.blob(data))
                cnts.append(len(data))
        entries = [
            (_TAG_SUBFILE, 4, 0),
            (_TAG_WIDTH, 4, w),
            (_TAG_HEIGHT, 4, h),
            (_TAG_BITS, 3, [8, 8, 8]),
            (_TAG_COMPRESSION, 3, comp),
            (_TAG_PHOTOMETRIC, 3, photo),
            (_TAG_SAMPLES, 3, 3),
            (_TAG_PLANAR, 3, 1),
            (_TAG_SOFTWARE, 2, b"Philips DP v1.0"),
            (_TAG_TILE_W, 3, ts),
            (_TAG_TILE_H, 3, ts),
            (_TAG_TILE_OFFSETS, 4, offs),
            (_TAG_TILE_COUNTS, 4, cnts),
        ]
        if tables_stream is not None:
            entries.append((_TAG_JPEG_TABLES, 7, tables_stream))
        b.add_ifd(entries)
    return b.save(path)
