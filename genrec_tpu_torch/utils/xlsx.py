"""Minimal dependency-free .xlsx reader (stdlib zipfile + ElementTree): the
port's copy of ``genrec_tpu/utils/xlsx.py``.

The reference reads its 3-sheet major-hierarchy workbook with openpyxl
(`major-encode/bert_emb.py:50-124`); openpyxl is not a dependency, and an
xlsx file is just a zip of SpreadsheetML, so this module implements the
tiny subset needed: named-sheet lookup, row iteration, shared/inline
strings, and numeric cells. Not a general xlsx library (no styles, dates
stay raw serial numbers, no formula evaluation — cached formula values are
returned).
"""

from __future__ import annotations

import re
import zipfile
from typing import Any, Dict, List, Optional
from xml.etree import ElementTree as ET

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
       "r": "http://schemas.openxmlformats.org/officeDocument/2006/relationships"}
_REL_NS = "{http://schemas.openxmlformats.org/package/2006/relationships}"


def _col_index(cell_ref: str) -> int:
    """'BC12' → zero-based column 54."""
    col = 0
    for ch in cell_ref:
        if ch.isdigit():
            break
        col = col * 26 + (ord(ch.upper()) - 64)
    return col - 1


def _cell_value(c, shared: List[str]) -> Any:
    t = c.get("t", "n")
    if t == "inlineStr":
        tnode = c.find("m:is/m:t", _NS)
        return tnode.text if tnode is not None else None
    v = c.find("m:v", _NS)
    if v is None or v.text is None:
        return None
    if t == "s":
        return shared[int(v.text)]
    if t in ("str", "e"):
        return v.text
    if t == "b":
        return v.text == "1"
    # numeric: return int when exact
    try:
        f = float(v.text)
        return int(f) if f.is_integer() else f
    except ValueError:
        return v.text


class Workbook:
    """Read-only workbook: ``Workbook(path).rows('Sheet1')`` → list of
    row-lists (padded to the widest referenced column, None for blanks)."""

    def __init__(self, path: str):
        self._zf = zipfile.ZipFile(path)
        self._shared: List[str] = []
        if "xl/sharedStrings.xml" in self._zf.namelist():
            root = ET.fromstring(self._zf.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", _NS):
                # a shared string may be split into runs (<r><t>)
                self._shared.append("".join(
                    t.text or "" for t in si.iter(
                        "{%s}t" % _NS["m"])))
        wb = ET.fromstring(self._zf.read("xl/workbook.xml"))
        rels = ET.fromstring(self._zf.read("xl/_rels/workbook.xml.rels"))
        rid_to_target = {
            rel.get("Id"): rel.get("Target")
            for rel in rels.findall(f"{_REL_NS}Relationship")
        }
        self._sheets: Dict[str, str] = {}
        for sh in wb.findall("m:sheets/m:sheet", _NS):
            rid = sh.get("{%s}id" % _NS["r"])
            target = rid_to_target.get(rid, "")
            if target.startswith("/"):
                target = target[1:]
            elif not target.startswith("xl/"):
                target = "xl/" + target
            self._sheets[sh.get("name")] = target

    @property
    def sheet_names(self) -> List[str]:
        return list(self._sheets)

    def rows(self, sheet_name: str) -> List[List[Any]]:
        if sheet_name not in self._sheets:
            raise KeyError(f"no sheet {sheet_name!r}; have {self.sheet_names}")
        root = ET.fromstring(self._zf.read(self._sheets[sheet_name]))
        out: List[List[Any]] = []
        sheet_data = root.find("m:sheetData", _NS)
        for row in (sheet_data if sheet_data is not None else ()):
            cells: Dict[int, Any] = {}
            for i, c in enumerate(row.findall("m:c", _NS)):
                ref = c.get("r")
                idx = _col_index(ref) if ref else i
                cells[idx] = _cell_value(c, self._shared)
            width = max(cells) + 1 if cells else 0
            out.append([cells.get(i) for i in range(width)])
        return out

    def close(self) -> None:
        self._zf.close()


def write_xlsx(path: str, sheets: Dict[str, List[List[Any]]]) -> None:
    """Write a minimal xlsx (inline strings; used by ETL round-trip tests
    and to materialize seed workbooks without openpyxl)."""

    def esc(s: str) -> str:
        return (s.replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;"))

    def col_letter(i: int) -> str:
        s = ""
        i += 1
        while i:
            i, r = divmod(i - 1, 26)
            s = chr(65 + r) + s
        return s

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        names = list(sheets)
        zf.writestr("[Content_Types].xml", (
            '<?xml version="1.0"?>'
            '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
            'content-types">'
            '<Default Extension="rels" ContentType="application/vnd.'
            'openxmlformats-package.relationships+xml"/>'
            '<Default Extension="xml" ContentType="application/xml"/>'
            '<Override PartName="/xl/workbook.xml" ContentType="application/'
            'vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
            + "".join(
                f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
                'ContentType="application/vnd.openxmlformats-officedocument.'
                'spreadsheetml.worksheet+xml"/>'
                for i in range(len(names)))
            + "</Types>"))
        zf.writestr("_rels/.rels", (
            '<?xml version="1.0"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
            '2006/relationships">'
            '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
            'officeDocument/2006/relationships/officeDocument" '
            'Target="xl/workbook.xml"/></Relationships>'))
        zf.writestr("xl/workbook.xml", (
            '<?xml version="1.0"?>'
            '<workbook xmlns="http://schemas.openxmlformats.org/'
            'spreadsheetml/2006/main" xmlns:r="http://schemas.'
            'openxmlformats.org/officeDocument/2006/relationships"><sheets>'
            + "".join(
                f'<sheet name="{esc(n)}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
                for i, n in enumerate(names))
            + "</sheets></workbook>"))
        zf.writestr("xl/_rels/workbook.xml.rels", (
            '<?xml version="1.0"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
            '2006/relationships">'
            + "".join(
                f'<Relationship Id="rId{i + 1}" Type="http://schemas.'
                'openxmlformats.org/officeDocument/2006/relationships/'
                f'worksheet" Target="worksheets/sheet{i + 1}.xml"/>'
                for i in range(len(names)))
            + "</Relationships>"))
        for i, n in enumerate(names):
            body = []
            for r, row in enumerate(sheets[n], start=1):
                cells = []
                for ci, v in enumerate(row):
                    if v is None:
                        continue
                    ref = f"{col_letter(ci)}{r}"
                    if isinstance(v, bool):
                        cells.append(f'<c r="{ref}" t="b"><v>{int(v)}</v></c>')
                    elif isinstance(v, (int, float)):
                        cells.append(f'<c r="{ref}"><v>{v}</v></c>')
                    else:
                        cells.append(
                            f'<c r="{ref}" t="inlineStr"><is><t>{esc(str(v))}'
                            '</t></is></c>')
                body.append(f'<row r="{r}">' + "".join(cells) + "</row>")
            zf.writestr(f"xl/worksheets/sheet{i + 1}.xml", (
                '<?xml version="1.0"?>'
                '<worksheet xmlns="http://schemas.openxmlformats.org/'
                'spreadsheetml/2006/main"><sheetData>'
                + "".join(body) + "</sheetData></worksheet>"))
