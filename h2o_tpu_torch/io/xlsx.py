"""Minimal XLSX reader — the `water/parser/XlsParser.java` role
(``h2o_tpu/io/xlsx.py``, copied).

The reference parses legacy XLS via a vendored BIFF reader; modern sheets are
XLSX (a zip of XML), which the stdlib covers: `xl/worksheets/sheet1.xml`
cells + `xl/sharedStrings.xml`. Supported: inline/shared strings, numbers,
booleans, blank cells; first row = header (matching the reference's
header-guess for spreadsheets). One sheet (the first) per file.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
import zipfile

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}


def _col_index(ref: str) -> int:
    """'BC12' → zero-based column 54."""
    acc = 0
    for ch in ref:
        if ch.isalpha():
            acc = acc * 26 + (ord(ch.upper()) - 64)
        else:
            break
    return acc - 1


def read_xlsx(path: str):
    """→ (header, rows) where rows are lists of float | str | None."""
    with zipfile.ZipFile(path) as z:
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", _NS):
                shared.append("".join(t.text or ""
                                      for t in si.iter(
                                          "{%s}t" % _NS["m"])))
        sheet_names = sorted(n for n in z.namelist()
                             if re.fullmatch(r"xl/worksheets/sheet\d+\.xml",
                                             n))
        if not sheet_names:
            raise ValueError(f"{path}: no worksheets found")
        root = ET.fromstring(z.read(sheet_names[0]))

    rows = []
    for row_el in root.iter("{%s}row" % _NS["m"]):
        cells: dict[int, object] = {}
        for c in row_el.findall("m:c", _NS):
            ci = _col_index(c.get("r", "A"))
            t = c.get("t", "n")
            v_el = c.find("m:v", _NS)
            if t == "inlineStr":
                is_el = c.find("m:is", _NS)
                val = "".join(x.text or "" for x in is_el.iter(
                    "{%s}t" % _NS["m"])) if is_el is not None else None
            elif v_el is None or v_el.text is None:
                val = None
            elif t == "s":
                val = shared[int(v_el.text)]
            elif t == "b":
                val = float(int(v_el.text))
            elif t in ("str", "d"):  # formula-string / ISO-date cells
                val = v_el.text
            elif t == "e":  # error cells (#DIV/0!, #N/A, …) → NA
                val = None
            else:  # numeric
                val = float(v_el.text)
            cells[ci] = val
        width = max(cells) + 1 if cells else 0
        rows.append([cells.get(i) for i in range(width)])

    width = max((len(r) for r in rows), default=0)
    rows = [r + [None] * (width - len(r)) for r in rows]
    if not rows:
        return [], []
    header = [str(v) if v is not None else f"C{i + 1}"
              for i, v in enumerate(rows[0])]
    return header, rows[1:]


def write_xlsx(path: str, header, rows):
    """Minimal writer (tests + export): inline strings, shared nothing."""
    def esc(s):
        return (str(s).replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;"))

    def cell(ref, v):
        if v is None:
            return ""
        if isinstance(v, str):
            return (f'<c r="{ref}" t="inlineStr"><is><t>{esc(v)}</t></is>'
                    f'</c>')
        return f'<c r="{ref}"><v>{float(v)}</v></c>'

    def colname(i):
        out = ""
        i += 1
        while i:
            i, r = divmod(i - 1, 26)
            out = chr(65 + r) + out
        return out

    lines = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             '<worksheet xmlns="http://schemas.openxmlformats.org/'
             'spreadsheetml/2006/main"><sheetData>']
    for ri, row in enumerate([list(header)] + [list(r) for r in rows]):
        cs = "".join(cell(f"{colname(ci)}{ri + 1}", v)
                     for ci, v in enumerate(row))
        lines.append(f'<row r="{ri + 1}">{cs}</row>')
    lines.append("</sheetData></worksheet>")
    sheet = "".join(lines)

    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
        'content-types">'
        '<Default Extension="rels" ContentType="application/vnd.'
        'openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.'
        'openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
        'worksheet+xml"/></Types>')
    rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/'
            'package/2006/relationships">'
            '<Relationship Id="rId1" Type="http://schemas.openxmlformats.'
            'org/officeDocument/2006/relationships/officeDocument" '
            'Target="xl/workbook.xml"/></Relationships>')
    wb = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
          '<workbook xmlns="http://schemas.openxmlformats.org/'
          'spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.'
          'org/officeDocument/2006/relationships"><sheets>'
          '<sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets>'
          '</workbook>')
    wb_rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
               '<Relationships xmlns="http://schemas.openxmlformats.org/'
               'package/2006/relationships">'
               '<Relationship Id="rId1" Type="http://schemas.'
               'openxmlformats.org/officeDocument/2006/relationships/'
               'worksheet" Target="worksheets/sheet1.xml"/></Relationships>')
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", rels)
        z.writestr("xl/workbook.xml", wb)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
