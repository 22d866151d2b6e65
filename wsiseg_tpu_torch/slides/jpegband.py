"""Restart-marker banded JPEG decode — bounded-memory NDPI strip reads.

Real Hamamatsu NDPI levels are usually ONE baseline JPEG per IFD (a
single multi-GB strip for level 0). Decoding such a strip whole holds
the full RGB level in host RAM. But NDP.scan writes DRI restart markers
at MCU-row boundaries, which make the entropy stream randomly accessible:
each restart interval decodes independently, so a horizontal band can be
decoded by splicing SOI+headers (with the SOF height rewritten), the
band's restart segments (markers renumbered to the D0.. sequence a
decoder expects), and EOI — the standard trick OpenSlide's hamamatsu
driver builds its position map for.

Pure-Python implementation over any file-like source:

* :func:`parse_structure` — walk the JPEG segments up to SOS; geometry
  (height/width/MCU size), DRI, and the raw header bytes.
* :func:`index_restarts` — chunked scan of the entropy stream for RSTn
  markers (exact for baseline JPEG: an 0xFF in entropy data is always
  followed by 0x00 stuffing or a marker byte).
* :func:`decode_rows` — decode pixel rows [y0, y1) via a synthetic
  band JPEG handed to PIL/libjpeg.

Bandability requires: baseline (SOF0/SOF1), DRI a whole number of MCU
rows, single scan. Anything else → caller falls back to whole-strip
decode (NDPISlide does this transparently).
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

_SOF_BASELINE = (0xC0, 0xC1)
_SOF_OTHER = (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
              0xCD, 0xCE, 0xCF)


@dataclass
class JpegStructure:
    header: bytes          # SOI .. SOS segment (inclusive), unmodified
    sof_off: int           # offset of the SOF marker within header
    height: int
    width: int
    mcu_h: int             # MCU pixel height (8 * max vertical sampling)
    mcus_per_row: int
    dri: int               # restart interval in MCUs (0 = none)
    entropy_start: int     # offset of entropy-coded data in the stream

    @property
    def rows_per_segment_px(self) -> int:
        """Pixel rows covered by one restart interval (whole MCU rows)."""
        return (self.dri // self.mcus_per_row) * self.mcu_h

    @property
    def bandable(self) -> bool:
        return (self.dri > 0 and self.mcus_per_row > 0
                and self.dri % self.mcus_per_row == 0)


def parse_structure(head: bytes) -> Optional[JpegStructure]:
    """Parse segments of a baseline JPEG prefix up to (and including) the
    SOS header. Returns None for non-JPEG / progressive / multi-component
    layouts this module does not band-decode."""
    if len(head) < 4 or head[:2] != b"\xff\xd8":
        return None
    i = 2
    sof_off = -1
    height = width = 0
    mcu_h = 8
    mcus_per_row = 0
    dri = 0
    while i + 4 <= len(head):
        if head[i] != 0xFF:
            return None
        marker = head[i + 1]
        if marker == 0xD8:
            i += 2
            continue
        if marker == 0xDA:  # SOS — header complete
            seglen = int.from_bytes(head[i + 2:i + 4], "big")
            end = i + 2 + seglen
            if end > len(head):
                return None  # caller must pass a longer prefix
            return JpegStructure(header=head[:end], sof_off=sof_off,
                                 height=height, width=width, mcu_h=mcu_h,
                                 mcus_per_row=mcus_per_row, dri=dri,
                                 entropy_start=end)
        seglen = int.from_bytes(head[i + 2:i + 4], "big")
        seg_end = i + 2 + seglen
        if seg_end > len(head):
            return None
        if marker in _SOF_OTHER:
            return None  # progressive / arithmetic — not bandable
        if marker in _SOF_BASELINE:
            sof_off = i
            body = head[i + 4:seg_end]
            # precision(1) H(2) W(2) ncomp(1) then per-comp (id, HV, tq)
            if len(body) < 6:
                return None  # truncated/malformed SOF — not bandable
            height = int.from_bytes(body[1:3], "big")
            width = int.from_bytes(body[3:5], "big")
            ncomp = body[5]
            if len(body) < 6 + 3 * ncomp:
                return None
            max_h = max_v = 1
            for c in range(ncomp):
                hv = body[6 + c * 3 + 1]
                max_h = max(max_h, hv >> 4)
                max_v = max(max_v, hv & 0xF)
            mcu_w = 8 * max_h
            mcu_h = 8 * max_v
            mcus_per_row = (width + mcu_w - 1) // mcu_w
        elif marker == 0xDD:  # DRI
            dri = int.from_bytes(head[i + 4:i + 6], "big")
        i = seg_end
    return None


def index_restarts(read_at, entropy_abs: int, entropy_len: int,
                   chunk: int = 8 << 20):
    """(segment starts, EOI offset) — both absolute, via
    ``read_at(pos, n) -> bytes``. Segment starts are
    [entropy_abs, after-RST0, after-RST1, ...]. Linear chunked scan;
    exact for baseline entropy data (0xFF is always followed by 0x00
    stuffing, an RSTn, EOI, or DNL)."""
    starts = [entropy_abs]
    pos = entropy_abs
    end = entropy_abs + entropy_len
    carry = b""
    while pos < end:
        data = carry + read_at(pos, min(chunk, end - pos))
        base = pos - len(carry)
        n = len(data)
        j = 0
        while True:
            j = data.find(b"\xff", j)
            if j < 0 or j + 1 >= n:
                break
            m = data[j + 1]
            if 0xD0 <= m <= 0xD7:
                starts.append(base + j + 2)
            elif m == 0xD9:  # EOI
                return starts, base + j
            j += 2 if m != 0xFF else 1
        carry = data[-1:] if data.endswith(b"\xff") else b""
        pos += min(chunk, end - pos)
    return starts, end


def decode_rows(read_at, structure: JpegStructure, seg_starts: List[int],
                stream_end_abs: int, y0: int, y1: int) -> np.ndarray:
    """Decode pixel rows [y0, y1) of the stream into (y1-y0, W, 3) u8.

    Builds a synthetic JPEG of only the covering restart segments: the
    SOF height is rewritten to the band height and the interior restart
    markers renumbered to the D0.. sequence a fresh decoder expects.
    One extra segment of margin is decoded on each side and cropped
    away: libjpeg's fancy chroma upsampling interpolates across MCU
    rows, so interior band edges would otherwise differ from a
    whole-image decode by a few chroma counts. With the margin the
    returned rows are BIT-IDENTICAL to the whole decode (image edges
    behave as real edges either way)."""
    from PIL import Image
    rps = structure.rows_per_segment_px
    if rps <= 0:
        raise ValueError("stream is not bandable")
    a = max(0, y0 // rps - 1)
    b = min((y1 + rps - 1) // rps + 1, len(seg_starts))
    band_h = min(structure.height - a * rps, (b - a) * rps)

    header = bytearray(structure.header)
    hoff = structure.sof_off + 5  # FF C0 len(2) prec(1) -> height
    header[hoff:hoff + 2] = int(band_h).to_bytes(2, "big")

    parts = [bytes(header)]
    for k in range(a, b):
        seg_end = (seg_starts[k + 1] - 2 if k + 1 < len(seg_starts)
                   else stream_end_abs)
        parts.append(read_at(seg_starts[k], seg_end - seg_starts[k]))
        if k + 1 < b:
            parts.append(bytes([0xFF, 0xD0 + ((k - a) & 7)]))
    parts.append(b"\xff\xd9")

    arr = np.asarray(Image.open(io.BytesIO(b"".join(parts))).convert("RGB"))
    if arr.shape[0] < band_h:
        pad = np.full((band_h - arr.shape[0], structure.width, 3), 255,
                      np.uint8)
        arr = np.concatenate([arr, pad], axis=0)
    r0 = y0 - a * rps
    out = np.ascontiguousarray(arr[r0:r0 + (y1 - y0), :structure.width])
    if out.shape[0] != y1 - y0:
        # fewer restart segments in the entropy stream than the declared
        # geometry implies (corruption / ragged encoder) — a short return
        # would surface as a bare numpy broadcast error in the caller
        raise ValueError(
            f"stream carries only {len(seg_starts)} restart segments — "
            f"rows [{y0},{y1}) are not addressable")
    return out
