"""Legacy BIFF8 .xls parser — the `water/parser/XlsParser.java` (859 LoC)
analog, stdlib-only like the sibling XLSX reader (``h2o_tpu/io/xls.py``,
copied).

Two layers, per the [MS-CFB] + [MS-XLS] specs:

1. **OLE2 compound file**: 512-byte header, sector FAT chains, the
   directory tree, and the MiniStream/MiniFAT that small (<4096 byte)
   streams — which most small .xls files' Workbook streams are — live in.
2. **BIFF8 record stream**: ``[id:u16][len:u16][payload]`` records. The
   cell records the reference reads are handled: NUMBER (IEEE double), RK
   and MULRK (packed 30-bit ints / truncated doubles, ÷100 flag), LABELSST
   against the shared-string table (SST + CONTINUE continuation, compressed
   and UTF-16 strings), LABEL (inline pre-SST strings), BOOLERR, BLANK/
   MULBLANK, and FORMULA cached results (number, or string via the
   following STRING record). Only the FIRST worksheet parses, like the
   reference.

The cell grid lands in the same (rows, header-guess, column typing)
pipeline the XLSX reader feeds, so `.xls` and `.xlsx` twins of the same
sheet produce identical frames.
"""

from __future__ import annotations

import struct

_OLE_MAGIC = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"
_FREE = 0xFFFFFFFF
_ENDCHAIN = 0xFFFFFFFE


# ---------------------------------------------------------------------------
# OLE2 compound document
# ---------------------------------------------------------------------------
def _read_chain(data: bytes, fat: list[int], start: int,
                sector_size: int) -> bytes:
    # sector #n begins at (n+1) * sector_size per [MS-CFB] — the header
    # occupies exactly one sector regardless of version (512 for v3,
    # 4096 for v4), so the base is the sector size, not a constant 512
    out = []
    sec = start
    seen = 0
    while sec not in (_ENDCHAIN, _FREE):
        if sec >= len(fat):
            raise ValueError("xls: FAT chain runs off the table")
        off = sector_size + sec * sector_size
        out.append(data[off: off + sector_size])
        sec = fat[sec]
        seen += 1
        if seen > len(fat) + 1:
            raise ValueError("xls: cyclic FAT chain")
    return b"".join(out)


def ole2_stream(data: bytes, name: str) -> bytes:
    """Extract one stream (by directory-entry name) from an OLE2 file."""
    if data[:8] != _OLE_MAGIC:
        raise ValueError("not an OLE2 compound document (bad magic)")
    sector_shift = struct.unpack_from("<H", data, 30)[0]
    mini_shift = struct.unpack_from("<H", data, 32)[0]
    sector_size = 1 << sector_shift
    mini_size = 1 << mini_shift
    n_fat = struct.unpack_from("<I", data, 44)[0]
    dir_start = struct.unpack_from("<I", data, 48)[0]
    mini_cutoff = struct.unpack_from("<I", data, 56)[0]
    minifat_start = struct.unpack_from("<I", data, 60)[0]
    n_minifat = struct.unpack_from("<I", data, 64)[0]
    difat_start = struct.unpack_from("<I", data, 68)[0]
    n_difat = struct.unpack_from("<I", data, 72)[0]

    # FAT sector list: 109 entries in the header DIFAT, then DIFAT sectors
    fat_sectors = [s for s in struct.unpack_from("<109I", data, 76)
                   if s not in (_FREE, _ENDCHAIN)][:n_fat]
    difat_sec = difat_start
    for _ in range(n_difat):
        off = sector_size + difat_sec * sector_size
        entries = struct.unpack_from(f"<{sector_size // 4}I", data, off)
        fat_sectors.extend(s for s in entries[:-1]
                           if s not in (_FREE, _ENDCHAIN))
        difat_sec = entries[-1]
        if difat_sec in (_FREE, _ENDCHAIN):
            break
    fat: list[int] = []
    for s in fat_sectors:
        off = sector_size + s * sector_size
        fat.extend(struct.unpack_from(f"<{sector_size // 4}I", data, off))

    directory = _read_chain(data, fat, dir_start, sector_size)
    root_start = root_size = None
    target = None
    for off in range(0, len(directory), 128):
        entry = directory[off: off + 128]
        if len(entry) < 128:
            break
        name_len = struct.unpack_from("<H", entry, 64)[0]
        if name_len < 2:
            continue
        ename = entry[: name_len - 2].decode("utf-16-le", errors="replace")
        etype = entry[66]
        start = struct.unpack_from("<I", entry, 116)[0]
        size = struct.unpack_from("<I", entry, 120)[0]
        if etype == 5:  # root: owns the MiniStream
            root_start, root_size = start, size
        elif ename == name:
            target = (start, size)
    if target is None:
        raise ValueError(f"xls: no '{name}' stream in the compound file")
    start, size = target
    if size >= mini_cutoff:
        return _read_chain(data, fat, start, sector_size)[:size]
    # small stream: walk the MiniFAT within the root's MiniStream
    mini_stream = _read_chain(data, fat, root_start, sector_size)
    minifat: list[int] = []
    sec = minifat_start
    for _ in range(n_minifat):
        off = sector_size + sec * sector_size
        minifat.extend(struct.unpack_from(f"<{sector_size // 4}I",
                                          data, off))
        sec = fat[sec]
        if sec in (_ENDCHAIN, _FREE):
            break
    out = []
    msec = start
    seen = 0
    while msec not in (_ENDCHAIN, _FREE):
        if msec >= len(minifat):
            raise ValueError("xls: MiniFAT chain runs off the table")
        out.append(mini_stream[msec * mini_size: (msec + 1) * mini_size])
        msec = minifat[msec]
        seen += 1
        if seen > len(minifat) + 1:  # crafted uploads: no infinite walks
            raise ValueError("xls: cyclic MiniFAT chain")
    return b"".join(out)[:size]


# ---------------------------------------------------------------------------
# BIFF8 records
# ---------------------------------------------------------------------------
def _rk_value(rk: int) -> float:
    """RK packing: bit0 = ÷100, bit1 = int30 vs high-30-bits-of-double."""
    div100 = rk & 1
    if rk & 2:
        v = float(rk >> 2 if not (rk & 0x80000000)
                  else (rk >> 2) - (1 << 30))
    else:
        v = struct.unpack("<d", b"\0\0\0\0" +
                          struct.pack("<I", rk & 0xFFFFFFFC))[0]
    return v / 100.0 if div100 else v


def _read_unicode(buf: bytes, pos: int) -> tuple[str, int]:
    """XLUnicodeRichExtendedString (inside SST)."""
    n = struct.unpack_from("<H", buf, pos)[0]
    grbit = buf[pos + 2]
    pos += 3
    rich = grbit & 0x08
    ext = grbit & 0x04
    n_rich = 0
    ext_len = 0
    if rich:
        n_rich = struct.unpack_from("<H", buf, pos)[0]
        pos += 2
    if ext:
        ext_len = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
    if grbit & 0x01:  # uncompressed UTF-16LE
        s = buf[pos: pos + 2 * n].decode("utf-16-le", errors="replace")
        pos += 2 * n
    else:             # compressed: one byte per char (latin-1)
        s = buf[pos: pos + n].decode("latin-1")
        pos += n
    pos += 4 * n_rich + ext_len
    return s, pos


def _records(stream: bytes):
    """Yield (record id, payload, boundaries): CONTINUE records are
    concatenated onto their owner, and ``boundaries`` records each
    continuation's start offset within the concatenated payload — the SST
    re-emits a grbit byte when a string's CHARACTER DATA crosses one."""
    pos = 0
    pending = None  # (id, payload bytes, boundary offsets)
    while pos + 4 <= len(stream):
        rid, ln = struct.unpack_from("<HH", stream, pos)
        payload = stream[pos + 4: pos + 4 + ln]
        pos += 4 + ln
        if rid == 0x3C and pending is not None:  # CONTINUE
            pending = (pending[0], pending[1] + payload,
                       pending[2] + [len(pending[1])])
            continue
        if pending is not None:
            yield pending
        pending = (rid, payload, [])
    if pending is not None:
        yield pending


def _parse_sst(payload: bytes, boundaries: list[int]) -> list[str]:
    """SST: total/unique counts then packed unicode strings, with Excel's
    continuation rule honored: when character data spans a CONTINUE
    boundary, the continuation starts with a FRESH grbit byte and the
    remaining characters may switch between compressed and UTF-16
    ([MS-XLS] 2.5.293). A parse that drifts off the record raises instead
    of shipping corrupt strings."""
    total, unique = struct.unpack_from("<II", payload, 0)
    bset = sorted(b for b in boundaries if b > 8)
    out = []
    pos = 8
    for _ in range(unique):
        if pos + 3 > len(payload):
            raise ValueError("xls: SST ran off the record "
                             "(unsupported continuation layout?)")
        n = struct.unpack_from("<H", payload, pos)[0]
        grbit = payload[pos + 2]
        pos += 3
        rich = grbit & 0x08
        ext = grbit & 0x04
        wide = grbit & 0x01
        n_rich = ext_len = 0
        if rich:
            n_rich = struct.unpack_from("<H", payload, pos)[0]
            pos += 2
        if ext:
            ext_len = struct.unpack_from("<I", payload, pos)[0]
            pos += 4
        chars: list[str] = []
        remaining = n
        while remaining:
            if pos in bset:
                # char data resuming at a continuation start: the fragment
                # re-emits a fresh grbit byte, possibly switching width
                wide = payload[pos] & 0x01
                pos += 1
                bset = [b for b in bset if b > pos]
            nxt = next((b for b in bset if b > pos), None)
            limit = nxt if nxt is not None else len(payload)
            if pos >= limit:
                raise ValueError("xls: SST string hit record end "
                                 "(unsupported continuation layout)")
            width = 2 if wide else 1
            avail = (limit - pos) // width
            take = min(remaining, avail)
            if take == 0:
                raise ValueError("xls: SST character split across a "
                                 "continuation boundary")
            raw = payload[pos: pos + take * width]
            chars.append(raw.decode("utf-16-le" if wide else "latin-1",
                                    errors="replace"))
            pos += take * width
            remaining -= take
        # rich-text runs / ext blocks may themselves span continuations,
        # but they are pure skip-bytes (no re-emitted headers)
        pos += 4 * n_rich + ext_len
        out.append("".join(chars))
        bset = [b for b in bset if b > pos]
    return out


def parse_xls_cells(data: bytes) -> dict[tuple[int, int], object]:
    """.xls bytes → {(row, col): value} for the first worksheet."""
    try:
        stream = ole2_stream(data, "Workbook")
    except ValueError:
        stream = ole2_stream(data, "Book")  # BIFF5-era directory name
    sst: list[str] = []
    cells: dict[tuple[int, int], object] = {}
    sheet_no = -1
    pending_formula_cell = None
    for rid, p, bounds in _records(stream):
        if rid == 0x809:  # BOF
            bt = struct.unpack_from("<H", p, 2)[0]
            if bt == 0x10:  # worksheet substream
                sheet_no += 1
                if sheet_no > 0:
                    break  # first sheet only, like the reference
            continue
        if rid == 0xFC:  # SST
            sst = _parse_sst(p, bounds)
            continue
        if sheet_no != 0:
            continue
        if rid == 0x203:  # NUMBER
            r, c = struct.unpack_from("<HH", p, 0)
            cells[(r, c)] = struct.unpack_from("<d", p, 6)[0]
        elif rid in (0x27E, 0x7E):  # RK
            r, c = struct.unpack_from("<HH", p, 0)
            cells[(r, c)] = _rk_value(struct.unpack_from("<I", p, 6)[0])
        elif rid == 0xBD:  # MULRK
            r, c0 = struct.unpack_from("<HH", p, 0)
            n = (len(p) - 6) // 6
            for i in range(n):
                rk = struct.unpack_from("<I", p, 4 + 6 * i + 2)[0]
                cells[(r, c0 + i)] = _rk_value(rk)
        elif rid == 0xFD:  # LABELSST
            r, c = struct.unpack_from("<HH", p, 0)
            idx = struct.unpack_from("<I", p, 6)[0]
            cells[(r, c)] = sst[idx] if idx < len(sst) else ""
        elif rid == 0x204:  # LABEL (inline string)
            r, c = struct.unpack_from("<HH", p, 0)
            s, _ = _read_unicode(p, 6)
            cells[(r, c)] = s
        elif rid == 0x205:  # BOOLERR
            r, c = struct.unpack_from("<HH", p, 0)
            val, is_err = p[6], p[7]
            cells[(r, c)] = float("nan") if is_err else float(val)
        elif rid == 0x6:  # FORMULA: cached result
            r, c = struct.unpack_from("<HH", p, 0)
            res = p[6:14]
            if res[6:8] == b"\xff\xff":
                if res[0] == 0:      # string result follows in STRING rec
                    pending_formula_cell = (r, c)
                elif res[0] == 1:    # boolean
                    cells[(r, c)] = float(res[2])
                else:                # error / blank
                    cells[(r, c)] = float("nan")
            else:
                cells[(r, c)] = struct.unpack("<d", res)[0]
        elif rid == 0x207 and pending_formula_cell is not None:  # STRING
            s, _ = _read_unicode(p, 0)
            cells[pending_formula_cell] = s
            pending_formula_cell = None
    return cells


def cells_to_rows(cells: dict) -> list[list]:
    if not cells:
        return []
    nrow = max(r for r, _ in cells) + 1
    ncol = max(c for _, c in cells) + 1
    return [[cells.get((r, c)) for c in range(ncol)] for r in range(nrow)]
