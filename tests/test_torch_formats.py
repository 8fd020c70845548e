"""Port parity: the Avro, XLSX, XLS, SVMLight and ARFF importers of
``h2o_tpu_torch/io/parser.py`` against the reference's parse
(``h2o_tpu/io/parser.py``) on the fixtures of ``tests/test_parser.py``,
``tests/test_xls_parser.py`` and ``tests/test_explain_pojo_arff.py``.

Tolerance: none. Each file parses in both packages into frames with the
same names, types, domains and host strings, every device cell bit-equal
as float32 (NA cells are NaN in both) and the same exact host copies.
These cases train nothing.
"""

import json
import struct
import zipfile

import numpy as np
import pytest

from h2o_tpu.io import parser as jparser
from h2o_tpu_torch import import_file
from h2o_tpu_torch.io import parser as tparser
from h2o_tpu_torch.io.avro import write_avro
from h2o_tpu_torch.io.xlsx import write_xlsx

import test_xls_parser as xlsgen


def assert_same_frame(jfr, tfr) -> None:
    assert tfr.names == jfr.names
    assert tfr.nrow == jfr.nrow
    for name in jfr.names:
        jv, tv = jfr.vec(name), tfr.vec(name)
        assert tv.type == jv.type, name
        assert tv.domain == (None if jv.domain is None else list(jv.domain))
        if jv.data is None:
            assert tv.data is None
            assert list(tv.host_data) == list(jv.host_data), name
            continue
        a = np.asarray(jv.data)[:jv.nrow]
        b = tv.data[:tv.nrow].numpy()
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), name
        assert (tv.exact_data is None) == (jv.exact_data is None), name
        if jv.exact_data is not None:
            assert np.array_equal(tv.exact_data, jv.exact_data,
                                  equal_nan=True), name


def _both(path):
    return (jparser.parse_file(str(path)),
            tparser.parse_file(str(path), device="cpu"))


def _zz(v):
    v = (v << 1) ^ (v >> 63)
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _avro_enum_int(path):
    """The hand-rolled container of ``test_parser.py``: a long field and
    an enum field."""
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "i", "type": "long"},
        {"name": "col", "type": {"type": "enum", "name": "e",
                                 "symbols": ["red", "green"]}}]}
    sj = json.dumps(schema).encode()
    body = _zz(7) + _zz(0) + _zz(-2) + _zz(1) + _zz(41) + _zz(0)
    buf = (b"Obj\x01" + _zz(1) + _zz(len(b"avro.schema")) + b"avro.schema"
           + _zz(len(sj)) + sj + _zz(0) + b"S" * 16
           + _zz(3) + _zz(len(body)) + body + b"S" * 16)
    path.write_bytes(buf)


def _xlsx_error_cells(path):
    """``test_parser.py``'s error-cell sheet: ``t="e"`` becomes NA."""
    write_xlsx(str(path), ["v"], [[1.0], [2.0]])
    with zipfile.ZipFile(path) as z:
        contents = {n: z.read(n) for n in z.namelist()}
    sheet = contents["xl/worksheets/sheet1.xml"].decode()
    contents["xl/worksheets/sheet1.xml"] = sheet.replace(
        '<c r="A3"><v>2.0</v></c>',
        '<c r="A3" t="e"><v>#DIV/0!</v></c>').encode()
    with zipfile.ZipFile(path, "w") as z:
        for n, data in contents.items():
            z.writestr(n, data)


_XLS_RECORDS = (["a", "b", "c", "d", "e"], [
    [("rk_int", 2), ("rk_int", 4), ("rk_int", 6), ("rk_int", 8),
     ("rk_int", 10)],
    [True, False, ("label", "inline"), ("formula_num", 12.5), 3.25]])

#: fixture name -> (file suffix, writer(path)); the cases of one format
#: run in one test
FIXTURES = {
    # tests/test_parser.py:77 and its comment and blank-line forms
    "svmlight": (".svm", lambda p: p.write_text("1 0:1.5 3:2.0\n-1 1:0.5\n")),
    "svmlight_comments": (".svmlight", lambda p: p.write_text(
        "# header comment\n0 2:-3.25 # trailing\n\n1 0:1e-3 2:7\n")),
    # tests/test_parser.py:92, TestAvro
    "avro_null_codec": (".avro", lambda p: write_avro(
        str(p), ["num", "name"], [[1.5, None, 3.25], ["a", "b", None]],
        schema_types=["double", "string"])),
    "avro_deflate": (".avro", lambda p: write_avro(
        str(p), ["num", "name"], [[1.5, None, 3.25], ["a", "b", None]],
        schema_types=["double", "string"], codec="deflate")),
    "avro_enum_int": (".avro", _avro_enum_int),
    # TestXlsx
    "xlsx_roundtrip": (".xlsx", lambda p: write_xlsx(
        str(p), ["num", "name"],
        [[1.5, "a"], [2.5, "b"], [None, None], [4.0, "a"]])),
    "xlsx_duplicate_headers": (".xlsx", lambda p: write_xlsx(
        str(p), ["a", "a"], [[1.0, 2.0], [3.0, 4.0]])),
    "xlsx_error_cells": (".xlsx", _xlsx_error_cells),
    "xlsx_twin": (".xlsx", lambda p: write_xlsx(str(p), xlsgen.HEADER,
                                                xlsgen.ROWS)),
    # tests/test_xls_parser.py
    "xls_ministream": (".xls", lambda p: xlsgen._write_xls(
        p, xlsgen.HEADER, xlsgen.ROWS)),
    "xls_regular_fat": (".xls", lambda p: xlsgen._write_xls(
        p, xlsgen.HEADER, [[f"row{i}", float(i), float(i) * 0.5,
                            float(i * i)] for i in range(300)],
        force_big=True)),
    "xls_all_records": (".xls", lambda p: xlsgen._write_xls(
        p, *_XLS_RECORDS)),
    "xls_utf16": (".xls", lambda p: xlsgen._write_xls(
        p, ["s", "x"], [["žluťoučký", 1.0], ["ascii", 2.0]])),
    # tests/test_explain_pojo_arff.py:131,152
    "arff_quoted_commas": (".arff", lambda p: p.write_text(
        "@relation r\n"
        "@attribute city {'New York, NY', 'Boston, MA'}\n"
        "@attribute v numeric\n"
        "@data\n"
        "'New York, NY',1\n"
        "'Boston, MA',2\n")),
    "arff_ingest": (".arff", lambda p: p.write_text(
        "% comment\n"
        "@relation test\n"
        "@attribute age numeric\n"
        "@attribute 'work class' {a, b, c}\n"
        "@attribute note string\n"
        "@data\n"
        "38,a,hello\n"
        "?,c,world\n"
        "51,b,?\n")),
}


@pytest.mark.parametrize("fmt", ["svmlight", "avro", "xlsx", "xls", "arff"])
def test_import_matches_the_reference(fmt, tmp_path):
    """Each fixture of the format, its frame bit-equal to the reference's
    parse (tolerance 0), on the CPU through ``import_file``'s parser."""
    cases = [c for c in FIXTURES if c.split("_")[0] == fmt]
    assert cases
    for case in cases:
        suffix, write = FIXTURES[case]
        path = tmp_path / f"{case}{suffix}"
        write(path)
        jfr, tfr = _both(path)
        assert_same_frame(jfr, tfr)


def test_xls_twin_parses_like_its_xlsx_twin(tmp_path):
    """``test_xls_parser.py``'s done-criterion in the port: the same sheet
    as .xls and .xlsx gives bit-equal frames (tolerance 0)."""
    xls, xlsx = tmp_path / "twin.xls", tmp_path / "twin.xlsx"
    xlsgen._write_xls(xls, xlsgen.HEADER, xlsgen.ROWS)
    write_xlsx(str(xlsx), xlsgen.HEADER, xlsgen.ROWS)
    assert_same_frame(tparser.parse_file(str(xls), device="cpu"),
                      tparser.parse_file(str(xlsx), device="cpu"))


@pytest.mark.parametrize("case", ["xls_not_ole2", "arff_sparse"])
def test_import_refuses_as_the_reference(case, tmp_path):
    """A file that is no OLE2 document and a sparse ARFF raise what the
    reference raises, with its message."""
    if case == "xls_not_ole2":
        path = tmp_path / "bad.xls"
        path.write_bytes(b"this is not a compound document at all")
        want = ValueError
    else:
        path = tmp_path / "s.arff"
        path.write_text("@relation r\n@attribute a numeric\n@data\n"
                        "{0 38}\n")
        want = NotImplementedError
    with pytest.raises(want) as jerr:
        jparser.parse_file(str(path))
    with pytest.raises(want) as terr:
        tparser.parse_file(str(path), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_import_file_entry_point_and_key(tmp_path):
    """``import_file`` reads the new formats and registers the frame under
    ``destination_frame`` (values bit-equal to the reference's)."""
    from h2o_tpu_torch import STORE

    p = tmp_path / "e.xlsx"
    write_xlsx(str(p), ["a"], [[1.0], [2.0]])
    fr = import_file(str(p), destination_frame="sheet.hex", device="cpu")
    assert STORE.get("sheet.hex") is fr
    assert_same_frame(jparser.import_file(str(p)), fr)


def test_pyarrow_formats_still_raise(tmp_path):
    """Parquet and ORC need pyarrow, which the card's machine lacks: they
    raise naming ROADMAP Queue 1 item 3."""
    for ext in (".parquet", ".pq", ".orc"):
        path = tmp_path / f"f{ext}"
        path.write_bytes(b"")
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 3"):
            import_file(str(path), device="cpu")


def test_svmlight_matches_a_dense_generator(tmp_path):
    """A 2,000 x 28 HIGGS-shaped SVMLight file (every value written as the
    float64 repr of its float32) parses to the generator's float32 values
    bit for bit, in both packages."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(2000, 28)).astype(np.float32)
    y = (rng.random(2000) < 0.5).astype(np.float32)
    txt = X.astype(np.float64).astype(str)
    lines = [" ".join([f"{int(y[i])}"] + [f"{j}:{txt[i, j]}"
                                           for j in range(28)])
             for i in range(2000)]
    path = tmp_path / "h.svm"
    path.write_text("\n".join(lines) + "\n")
    jfr, tfr = _both(path)
    assert_same_frame(jfr, tfr)
    for j in range(28):
        got = tfr.vec(f"C{j}").data[:2000].numpy()
        assert np.array_equal(got.view(np.int32), X[:, j].view(np.int32))
    assert struct.pack("<2000f", *tfr.vec("target").data[:2000].numpy()) \
        == struct.pack("<2000f", *y)
