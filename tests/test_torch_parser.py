"""Port parity: ``h2o_tpu_torch.import_file`` (the port's own C++
tokenizer and numpy typing) against ``h2o_tpu.io.parser.import_file``
(pyarrow's reader), and the row operations behind ``split_frame`` and
cross-validation.

Every fixture is written to ``tmp_path`` and parsed by both packages.
Equal: column names, types, categorical domains (sorted lexicographically,
as H2O interns them), each column's logical values bit for bit with NaN at
the same rows (``Vec.to_numpy``: the exact int64/float64 host copy where
float32 loses a value, else the float32 column), the float32 device
column bit for bit, and string columns' host values. ``split_frame`` and
``split_exact`` draw from numpy's ``default_rng(seed)`` in both packages,
so each split holds the same rows; ``take`` and ``concat_rows`` give the
same columns. The port's C++ tokenizer equals Python's ``csv`` reader
(pyarrow's quoting rules) on written and on random files;
``Vec.with_data`` and ``astype_cat`` give the reference's types, domains
and values. Formats other than CSV/TSV raise ``NotImplementedError``
naming ROADMAP Queue 1 item 3.
"""

import csv
import gzip
import io
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o_tpu.frame import split as jsplit
from h2o_tpu.frame.vec import Vec as JVec
from h2o_tpu.io import parser as jparser
from h2o_tpu_torch import import_file, split_frame
from h2o_tpu_torch.frame.split import split_exact
from h2o_tpu_torch.frame.vec import Vec
from h2o_tpu_torch.io import parser as tparser

#: name -> (file name, text, import_file keywords)
FIXTURES = {
    "header_comma": ("a.csv", "a,b,c,d\n1,x,1.5,7\n2,y,,8\n3,x,2.25,9\n", {}),
    "no_header": ("b.csv", "1,x,1.5\n2,y,2.5\n3,z,-0.5\n", {}),
    "tsv": ("c.tsv", "a\tb\tc\n1\tq\t0.5\n2\tr\t1e3\n", {}),
    "gz": ("d.csv.gz", "a,b\n1,u\n3,v\nNA,w\n", {}),
    "zip": ("e.zip", "a,b\n1,2.5\n3,4\n", {}),
    "quoted": ("f.csv", 'a,b,c\n"x,y",1,"say ""hi"""\nplain,2,"a\nb"\n'
                        'p"q,3,""\n', {}),
    "na_numeric": ("g.csv", "a,b,c\n1,NA,0.5\nN/A,2,nan\n,3,?\nnull,4,"
                            "NULL\nNone,5,NaN\n6,na,1\n", {}),
    "na_in_strings": ("h.csv", "a,b\nx,1\nNA,2\n,3\ny,4\nnull,5\n", {}),
    "user_na_strings": ("i.csv", "a,b,c\nx,1,missing\nNA,missing,2\n,3,4\n"
                                 "y,4,NA\n",
                        dict(na_strings=["missing", "NA"])),
    "col_types": ("j.csv", "a,b,c,d\n1,2,3,x\n10,20,30,y\n2,3,4,z\n11,,5,x\n",
                  dict(col_types={"a": "enum", "b": "string", "c": "real"})),
    "all_na_column": ("k.csv", "a,b\nNA,1\n,2\nNA,3\n", {}),
    "booleans": ("l.csv", "a,b,c\ntrue,True,1\nfalse,FALSE,0\ntrue,true,"
                          "TRUE\n,False,NA\n", {}),
    "dates_timestamps": ("m.csv", "a,b,c\n2020-01-02,2020-01-02 03:04:05,"
                                  "2020-01-02T03:04Z\n2021-12-31,"
                                  "2021-12-31T00:00:00.123,NA\n", {}),
    "big_integers": ("n.csv", "a,b,c,d\n16777217,123456789012,1.000000001,5"
                              "\n2,3,2.5,NA\n-7,NA,1e300,16777219\n", {}),
    "spaced_numbers": ("o.csv", "a,b,c\n 1, 1.5,x \n2 ,2.5 , y\n", {}),
    "lexicographic_enum": ("p.csv", "m,v\n1,0.1\n10,0.7\n2,3.14159265358979"
                                    "\n11,-2.5e-8\n3,inf\n",
                           dict(col_types={"m": "enum"})),
    "crlf_and_blank_lines": ("q.csv", "a,b\r\n1,x\r\n\r\n2,y\r\n", {}),
    # every field quoted, as R's write.csv and QUOTE_ALL writers do
    "quoted_every_field": ("r.csv", '"a","b","c","d"\r\n"1","x,y","2.5",'
                                    '"NA"\r\n"2","say ""hi""","","b"\r\n'
                                    '"3","two\nlines","4.5",""\r\n', {}),
    # levels that first appear after row 2^16: the interning's sample of
    # the first 65,536 fields does not cover the column
    # int64's two bounds exact, one past either bound float64, leading
    # zeros free
    "int64_19_digits": ("t.csv", "a,b,c,d\n1234567890123456789,"
                                 "9223372036854775807,-9223372036854775808,"
                                 "9223372036854775808\n-1234567890123456789,"
                                 "0000000000000000000001,5,"
                                 "-9223372036854775809\n", {}),
    # pyarrow's hex integers: either case, up to 16 digits as the 64 bits,
    # mixed with decimals; next to a float or a bad digit, levels
    "hex_integers": ("u.csv", "a,b,c,d,e\n0x10,0XaB,0x10,0xFFFFFFFFFFFFFFFF,"
                              "0x10\n0x1f,0x7FFFFFFFFFFFFFFF,12,1,1.5\n0X0,"
                              "0x8000000000000000,-3,NA,0x1g\n", {}),
    # time32[s] columns: datetime.time host values, NA as None; fractional
    # seconds or an out-of-range hour stay levels
    "time_of_day": ("v.csv", "a,b,c,d\n03:04:05,03:04,03:04:05.5,25:00:00\n"
                             "23:59:59,,03:04:05,01:00:00\n 00:00:00,12:00,"
                             "NA,01:00:00\n", {}),
    "levels_after_65536": ("s.csv", "c,v\n" + "".join(
        f"{'ab'[i % 2] if i < 70_000 else 'zA'[i % 2]},{i % 7}\n"
        for i in range(70_010)), {}),
}


def _csv_reader_columns(text: str, sep: str):
    """Python's ``csv`` reader's columns (blank lines skipped), or None
    when its records differ in length."""
    rows = [r for r in csv.reader(io.StringIO(text, newline=""),
                                  delimiter=sep) if r]
    if any(len(r) != len(rows[0]) for r in rows):
        return None
    return [[r[c].encode() for r in rows] for c in range(len(rows[0]))] \
        if rows else []


@pytest.mark.parametrize("source", ["csv_writer", "random_bytes"])
def test_tokenizer_matches_the_csv_reader(source):
    """The port's C++ tokenizer against Python's ``csv`` reader, whose
    quoting rules are pyarrow's: on files ``csv.writer`` quotes minimally,
    fully and non-numerically, and on random runs of separators, quotes,
    line breaks and CRs, where a quote may sit inside an unquoted field,
    text may follow a closing quote and a quote may stay open."""
    rng = np.random.default_rng(0 if source == "csv_writer" else 1)
    alpha = list('ab,"\n\r 1.-x\t;')
    for it in range(600):
        sep = ",\t;"[it % 3]
        if source == "csv_writer":
            rows = [["".join(rng.choice(alpha, int(rng.integers(0, 5))))
                     for _ in range(2 + it % 3)]
                    for _ in range(int(rng.integers(1, 6)))]
            out = io.StringIO()
            csv.writer(out, delimiter=sep,
                       lineterminator=("\n", "\r\n")[it % 2],
                       quoting=(csv.QUOTE_MINIMAL, csv.QUOTE_ALL,
                                csv.QUOTE_NONNUMERIC)[it % 3]).writerows(rows)
            text = out.getvalue()
        else:
            text = "".join(rng.choice(alpha, int(rng.integers(0, 30))))
        want = _csv_reader_columns(text, sep)
        if want is None:
            with pytest.raises(ValueError, match="CSV parse error"):
                tparser._tokenize(text.encode(), sep)
            continue
        got = tparser._tokenize(text.encode(), sep)
        assert [list(c) for c in got] == want, repr(text)


def test_vec_with_data_and_astype_cat_match_the_reference():
    codes = np.array([0, 2, 1, np.nan, 2], dtype=np.float32)
    jv, tv = JVec.from_numpy(codes), Vec.from_numpy(codes, device="cpu")
    new = np.array([1, 0, 0, 1, np.nan], dtype=np.float32)
    for kw in ({}, dict(type="real"), dict(domain=None)):
        jw = jv.astype_cat(["a", "b", "c"]).with_data(jnp.asarray(new), **kw)
        tw = tv.astype_cat(["a", "b", "c"]).with_data(torch.from_numpy(new),
                                                       **kw)
        assert (tw.type, tw.domain, tw.nrow) == (jw.type, jw.domain, jw.nrow)
        assert np.array_equal(tw.to_numpy(), jw.to_numpy(), equal_nan=True)
    jc, tc = jv.astype_cat(["x", "y", "z"]), tv.astype_cat(["x", "y", "z"])
    assert (tc.type, tc.domain) == (jc.type, jc.domain) == ("enum",
                                                            ["x", "y", "z"])
    assert tc.cardinality() == jc.cardinality() == 3
    assert np.array_equal(tc.to_numpy(), jc.to_numpy(), equal_nan=True)


def _write(tmp_path, name, text):
    path = str(tmp_path / name)
    if name.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(text.encode())
    elif name.endswith(".zip"):
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("inner.csv", text)
    else:
        with open(path, "w", newline="") as f:
            f.write(text)
    return path


def _assert_same_frame(jf, tf):
    assert tf.names == jf.names
    assert tf.nrow == jf.nrow
    for n in jf.names:
        jv, tv = jf.vec(n), tf.vec(n)
        assert tv.type == jv.type, n
        assert tv.domain == jv.domain, n
        ja, ta = jv.to_numpy(), tv.to_numpy()
        if jv.type == "string":
            assert tv.data is None
            assert list(ta) == list(ja), n
            continue
        assert ta.dtype == ja.dtype, n
        assert np.array_equal(ta, ja, equal_nan=True), n
        jd = np.asarray(jv.data)[:jv.nrow]
        td = tv.data[:tv.nrow].numpy()
        assert np.array_equal(td.view(np.int32), jd.view(np.int32)), n


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_parse_matches_the_reference(tmp_path, kind):
    name, text, kw = FIXTURES[kind]
    path = _write(tmp_path, name, text)
    jf = jparser.import_file(path, **kw)
    tf = import_file(path, device="cpu", **kw)
    _assert_same_frame(jf, tf)


def _airline_like(tmp_path, n=2000):
    """A CSV with enum, int (with NAs), real, big-integer and string
    columns, parsed by both packages."""
    rng = np.random.default_rng(3)
    lines = ["carrier,hour,dist,id,note"]
    for i in range(n):
        hour = "" if i % 89 == 88 else str(rng.integers(0, 24))
        dist = "NA" if i % 97 == 96 else repr(float(rng.normal(500, 200)))
        lines.append(f"C{rng.integers(0, 7):02d},{hour},{dist},"
                     f"{16777216 + 3 * i},n{i % 13}")
    path = _write(tmp_path, "air.csv", "\n".join(lines) + "\n")
    kw = dict(col_types={"note": "string"})
    return jparser.import_file(path, **kw), import_file(path, device="cpu",
                                                        **kw)


@pytest.mark.parametrize("how", ["split_frame", "split_exact"])
def test_splits_hold_the_reference_rows(tmp_path, how):
    jf, tf = _airline_like(tmp_path)
    fn = {"split_frame": (jsplit.split_frame, split_frame),
          "split_exact": (jsplit.split_exact, split_exact)}[how]
    jparts = fn[0](jf, ratios=[0.7, 0.15], seed=42)
    tparts = fn[1](tf, ratios=[0.7, 0.15], seed=42)
    assert [p.nrow for p in tparts] == [p.nrow for p in jparts]
    assert sum(p.nrow for p in tparts) == tf.nrow
    for jp, tpart in zip(jparts, tparts):
        _assert_same_frame(jp, tpart)


def test_take_and_concat_rows_match_the_reference(tmp_path):
    jf, tf = _airline_like(tmp_path, n=500)
    idx = np.random.default_rng(5).permutation(500)[:300]
    _assert_same_frame(jf.take(idx), tf.take(idx))
    jt, tt = jf.take(idx[:100]), tf.take(idx[:100])
    _assert_same_frame(jf.concat_rows(jt, jf), tf.concat_rows(tt, tf))


@pytest.mark.parametrize("sep", ["::", '"', "\n", "\u00a7"])
def test_separator_must_be_one_ascii_character(tmp_path, sep):
    path = _write(tmp_path, "t.csv", "a,b\n1,2\n")
    with pytest.raises(ValueError, match="separator"):
        import_file(path, sep=sep, device="cpu")


@pytest.mark.parametrize("ext", [".parquet", ".pq", ".orc", ".avro",
                                 ".xlsx", ".xls", ".svmlight", ".arff"])
def test_other_formats_are_refused(tmp_path, ext):
    """Parquet and ORC need pyarrow and raise naming ROADMAP Queue 1 item
    3. The formats ported since (Avro, XLSX, XLS, SVMLight, ARFF; their
    parity is in test_torch_formats.py) read an empty file as the
    reference does: the same exception type, or the same empty frame."""
    path = tmp_path / f"data{ext}"
    path.write_bytes(b"")
    if ext in (".parquet", ".pq", ".orc"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 3"):
            import_file(str(path), device="cpu")
        return
    try:
        want = jparser.import_file(str(path))
    except Exception as e:          # noqa: BLE001 - the type is the contract
        with pytest.raises(type(e)):
            import_file(str(path), device="cpu")
        return
    got = import_file(str(path), device="cpu")
    assert got.names == want.names and got.nrow == want.nrow == 0
    assert got.types() == want.types()
