"""Port parity: the chunk codecs of ``h2o_tpu_torch/frame/chunks.py``
against the reference's (``h2o_tpu/frame/chunks.py``), on the cases of
``tests/test_chunks.py:64-150``.

Contracts, all exact:
- ``encode_column`` picks the reference's codec for every case, with equal
  ``ChunkMeta`` fields (NaN values identified) and equal codes (dtype and
  values);
- ``decode_chunk`` of those codes is bit-equal to the reference's decode
  and to the column (every NaN identified), padding rows NaN;
- ``CodedVec.from_vec`` keeps the plain Vec where no codec wins, and its
  payload is smaller than 4 bytes a row where one does;
- ``compress_frame`` on the same frame in both packages codes every column
  alike, and the batched code-space rollups hold the raw pass's NA and
  zero counts, min and max exactly, mean and sigma within 1e-6 relative
  (the reductions run in another order).
The Cleaner's residency cases (``tests/test_chunks.py:167,191,209``) wait
for the port's Cleaner (ROADMAP step L).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o_tpu.frame import chunks as jchunks
from h2o_tpu_torch.frame import chunks as tchunks
from h2o_tpu_torch.frame.chunks import CodedVec, compress_frame
from h2o_tpu_torch.frame.vec import T_CAT, Vec
from h2o_tpu_torch.parallel.mesh import padded_len

from torch_parity import frames


def _bits_eq(a, b):
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    same = a.view(np.int32) == b.view(np.int32)
    return bool(np.all(same | (np.isnan(a) & np.isnan(b))))


def _col_cases():
    rng = np.random.default_rng(3)
    n = 1000
    cases = {
        "const": np.full(n, 2.5, np.float32),
        "const_nan": np.full(n, np.nan, np.float32),
        "int8": rng.integers(-3, 250, n).astype(np.float32),
        "int8_na": np.where(rng.random(n) < 0.1, np.nan,
                            rng.integers(0, 100, n)).astype(np.float32),
        "int8_scaled": (rng.integers(0, 200, n) * 0.25 + 7.0
                        ).astype(np.float32),
        "int16": rng.integers(0, 40_000, n).astype(np.float32),
        "sparse0": np.where(rng.random(n) < 0.03,
                            rng.normal(size=n), 0.0).astype(np.float32),
        "raw": rng.normal(size=n).astype(np.float32),
        "cat8": np.array([0, 1, 2, 1, 0, np.nan, 2] * 20, np.float32),
        "cat16": rng.integers(0, 300, n).astype(np.float32),
    }
    cases["sparse0"][::97] = np.nan      # sparse with NA entries
    cases["sparse0"][5] = -0.0           # the sign bit must survive
    cases["raw"][::31] = np.nan
    return cases


def _padded(col):
    buf = np.full(padded_len(len(col)), np.nan, np.float32)
    buf[:len(col)] = col
    return buf


def _meta_equal(jm, tm):
    a, b = dataclasses.asdict(jm), dataclasses.asdict(tm)
    va, vb = a.pop("value"), b.pop("value")
    assert a == b
    assert (np.isnan(va) and np.isnan(vb)) or va == vb


@pytest.mark.parametrize("name", list(_col_cases()))
def test_codec_meta_codes_and_decode_match_the_reference(name):
    col = _col_cases()[name]
    host = _padded(col)
    is_cat = name.startswith("cat")
    jcodes, jmeta = jchunks.encode_column(host, len(col), is_cat=is_cat)
    tcodes, tmeta = tchunks.encode_column(host, len(col), is_cat=is_cat)
    expect = name.split("_")[0]
    assert tmeta.kind == jmeta.kind == expect
    _meta_equal(jmeta, tmeta)
    assert tcodes.dtype == jcodes.dtype
    assert tcodes.tobytes() == jcodes.tobytes()
    jdec = np.asarray(jchunks.decode_chunk(jnp.asarray(jcodes), jmeta))
    tdec = tchunks.decode_chunk(tchunks._to_device(tcodes, "cpu"),
                                tmeta).numpy()
    assert _bits_eq(tdec, jdec) and _bits_eq(tdec, host)
    assert np.isnan(tdec[len(col):]).all()
    v = Vec.from_numpy(col, device="cpu", **(
        dict(type=T_CAT, domain=[f"l{i}" for i in range(300)])
        if is_cat else {}))
    cv = CodedVec.from_vec(v)
    if expect == "raw":
        assert cv is v
        return
    assert cv.meta == tmeta or cv.meta.kind == "const"
    assert _bits_eq(cv.data.numpy(), v.data.numpy())
    assert _bits_eq(cv.to_numpy(), col)
    assert cv.coded_nbytes() < v.data.numel() * 4
    assert cv.plen == v.plen and cv.domain == v.domain


def test_coded_vec_setter_degrades_to_raw():
    cv = CodedVec.from_vec(Vec.from_numpy(np.arange(64, dtype=np.float32),
                                          device="cpu"))
    assert cv.meta.kind == "int8"
    cv.data = torch.zeros(cv.plen * 2)
    assert cv.meta.kind == "raw" and cv.plen == cv.data.shape[0]


def test_compress_frame_and_batched_rollups_match_the_reference():
    rng = np.random.default_rng(7)
    n = 3000
    cols = {"ints": rng.integers(0, 50, n).astype(np.float32),
            "const": np.full(n, 1.5, np.float32),
            "real": rng.normal(size=n).astype(np.float32),
            "wide": rng.integers(0, 40_000, n).astype(np.float32),
            "halves": np.where(rng.random(n) < 0.05, np.nan,
                               rng.integers(0, 200, n) * 0.5 - 10
                               ).astype(np.float32),
            "zeros": np.where(rng.random(n) < 0.02, rng.normal(size=n),
                              0.0).astype(np.float32)}
    y = rng.integers(0, 3, n).astype(np.float32)
    one, jfr, fr = frames(cols, y, ydom=["a", "b", "c"])
    jc, tc = jfr.compress(), compress_frame(fr)
    for name in fr.names:
        jv, tv = jc.vec(name), tc.vec(name)
        assert isinstance(tv, CodedVec) == isinstance(jv, jchunks.CodedVec)
        if isinstance(tv, CodedVec):
            _meta_equal(jv.meta, tv.meta)
            codes = tv.coded.numpy()
            if codes.dtype == np.int16:
                codes = codes.view(np.uint16)
            assert np.array_equal(codes, np.asarray(jv.coded))
        assert _bits_eq(tv.data.numpy(), fr.vec(name).data.numpy())
    kinds = {n: tc.vec(n).meta.kind for n in tc.names
             if isinstance(tc.vec(n), CodedVec)}
    assert kinds == {"ints": "int8", "const": "const", "wide": "int16",
                     "halves": "int8", "zeros": "sparse0", "y": "cat8"}
    tc.ensure_rollups()
    for name in fr.names:
        r, rc = fr.vec(name).rollups(), tc.vec(name).rollups()
        assert (rc.nacnt, rc.nrow, rc.zerocnt, rc.is_int) == \
            (r.nacnt, r.nrow, r.zerocnt, r.is_int), name
        assert (rc.mins, rc.maxs) == (r.mins, r.maxs), name
        np.testing.assert_allclose([rc.mean, rc.sigma], [r.mean, r.sigma],
                                   rtol=1e-6, err_msg=name)
