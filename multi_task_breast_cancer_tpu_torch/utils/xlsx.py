"""Minimal dependency-free XLSX writer (single sheet, inline strings); a copy
of ``multi_task_breast_cancer_tpu/utils/xlsx.py``.

Neither openpyxl nor xlsxwriter is installed; this keeps the reference's Excel
artifact contract (``results_segmentation.xlsx`` / ``classification_results.xlsx``,
``src/utils/miscellany.py:99-152``) without new dependencies. XLSX is a zip of
a handful of XML parts; numbers are written as numeric cells, everything else
as inline strings.
"""

from __future__ import annotations

import zipfile
from pathlib import Path
from xml.sax.saxutils import escape

import numpy as np
import pandas as pd

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _col_letter(idx: int) -> str:
    letters = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        letters = chr(65 + rem) + letters
    return letters


def _cell(row: int, col: int, value) -> str:
    ref = f"{_col_letter(col)}{row + 1}"
    if isinstance(value, (int, float, np.integer, np.floating)) and not isinstance(value, bool):
        if isinstance(value, (float, np.floating)) and not np.isfinite(value):
            # pandas.to_excel (the reference artifact writer) leaves NaN as
            # an EMPTY cell — a literal 'nan' string would flip the column
            # dtype to object for any consumer reading the sheet back
            return f'<c r="{ref}"/>'
        return f'<c r="{ref}"><v>{value}</v></c>'
    return f'<c r="{ref}" t="inlineStr"><is><t>{escape(str(value))}</t></is></c>'


def write_xlsx(path: str | Path, df: pd.DataFrame, index: bool = False) -> None:
    """Write a DataFrame to an .xlsx file (header row + optional index col)."""
    rows = []
    header = ([""] if index else []) + [str(c) for c in df.columns]
    rows.append(header)
    for ix, row in df.iterrows():
        rows.append(([ix] if index else []) + list(row.values))

    cells_xml = []
    for r, row in enumerate(rows):
        cells = "".join(_cell(r, c, v) for c, v in enumerate(row))
        cells_xml.append(f'<row r="{r + 1}">{cells}</row>')
    sheet = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
             f'<sheetData>{"".join(cells_xml)}</sheetData></worksheet>')

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
