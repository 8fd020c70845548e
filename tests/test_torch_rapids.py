"""Port parity: the frame algebra (``h2o_tpu_torch/rapids/``) against the
reference (``h2o_tpu/rapids/``) on a one-device mesh — ops, group-by,
sort, both merge paths, mungers, strings, advmath and fairness, on the
scenarios of ``tests/test_rapids.py``, ``test_rapids_advmath.py``,
``test_rapids_wave3.py``, ``test_fairness_prims.py`` and the replicated
merge of ``test_sharded_frames.py``: duplicate keys, NA keys, signed
zero, empty sides, exact-int64 keys, categorical keys by level name, NAs
first in a sort.

Tolerances, and why:

- integers, counts, orders, permutations, merges, strings, domains and
  every host-numpy result: exact;
- float32 ``+ - * /``, ``fmod``, truncations, comparisons, min/max,
  rounding: exact (the same IEEE operation in both packages);
- float32 transcendental functions (``exp``, ``log``, ``pow``, the
  trigonometric and gamma families): within 1e-5 relative plus 1e-6
  absolute (XLA's and torch's libm-style kernels differ by a few ulps;
  ``lgamma``/``digamma`` near their poles by more in relative terms);
- sums, means and deviations of float32 columns, and group-by aggregates
  (the port reduces each group in float64, the reference in float32 in
  XLA's order): within 1e-5 relative plus 1e-5 absolute;
- correlation, skewness, kurtosis, scaled columns: within 1e-5 relative
  plus 1e-6 absolute (float32 sums in other orders).
"""

import numpy as np
import pytest
import torch

from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu.rapids import advmath as jadv
from h2o_tpu.rapids import mungers as jmun
from h2o_tpu.rapids import ops as jops
from h2o_tpu.rapids import strings as jstr
from h2o_tpu.rapids.groupby import group_by as jgroup_by
from h2o_tpu.rapids.merge import merge as jmerge
from h2o_tpu.rapids.merge import sort as jsort
from h2o_tpu_torch.rapids import advmath as tadv
from h2o_tpu_torch.rapids import mungers as tmun
from h2o_tpu_torch.rapids import ops as tops
from h2o_tpu_torch.rapids import strings as tstr
from h2o_tpu_torch.rapids.groupby import group_by as tgroup_by
from h2o_tpu_torch.rapids.merge import merge as tmerge
from h2o_tpu_torch.rapids.merge import sort as tsort

from torch_parity import assert_same, both_frames, one_mesh

FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)    # transcendental float32
F = FLOAT_TOL
SUM_TOL = dict(rtol=1e-5, atol=1e-5)      # float32 sums in other orders
# group-by sd/var: the reference's float32 E[x^2] - E[x]^2 misses the
# variance by tens of eps32 * E[x^2] (10 measured at mean 700, sd 29: sd
# 5e-4 relative off), so variances are held to it within 64 eps32 *
# max(x^2); the port's centred float64 pass is held to float64 numpy
# within 1e-6 relative instead
VAR_EPS = 64 * 2.0 ** -23

N = 64
MS0 = 1_614_834_367_000.0   # 2021-03-04 05:06:07 UTC


@pytest.fixture(scope="module")
def one():
    return one_mesh()


def _cols(seed: int = 17, n: int = N) -> dict:
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=n) * 3).astype(np.float32)
    a[::7] = np.nan
    a[3], a[5], a[9] = 0.0, -0.0, 2.5
    b = rng.integers(-4, 5, n).astype(np.float32)
    b[::11] = np.nan
    pos = (rng.random(n) * 4 + 0.1).astype(np.float32)
    g = rng.integers(0, 3, n).astype(np.float32)
    g[::13] = np.nan
    big = (2 ** 24 + rng.integers(0, 50, n)).astype(np.int64)
    t = MS0 + rng.integers(0, 400 * 86_400_000, n).astype(np.float64)
    t[::9] = np.nan
    words = np.array([None if i % 10 == 4 else
                      ["apple pie", "Banana", "  cherry ", "date-x",
                       "elder flower"][i % 5] for i in range(n)],
                     dtype=object)
    return {"a": a, "b": b, "pos": pos, "g": g, "big": big, "t": t,
            "c": (rng.integers(0, 4, n).astype(np.float32),
                  ["lo", "mid", "hi", "top"]),
            "s": words}


def _run(one, fn_ref, fn_port):
    with meshmod.use_mesh(one):
        j = fn_ref()
    return j, fn_port()


def test_ops_match_the_reference(one):
    jfr, fr = both_frames(_cols(), one)
    pairs = [("a", "b"), ("a", "pos"), ("big", "b"), ("t", "a")]
    exact_ops = ("+", "-", "*", "/", "%%", "intDiv", "%/%", "==", "!=", "<",
                 "<=", ">", ">=", "&", "&&", "|", "||")
    for l, r in pairs:
        for op in exact_ops + ("^",):
            tol = FLOAT_TOL if op == "^" else {}
            for lhs, rhs in ((l, r), (l, 2.0), (-3.0, r), (l, 0.0)):
                jl = jfr.vec(lhs) if isinstance(lhs, str) else lhs
                jr = jfr.vec(rhs) if isinstance(rhs, str) else rhs
                tl = fr.vec(lhs) if isinstance(lhs, str) else lhs
                tr = fr.vec(rhs) if isinstance(rhs, str) else rhs
                j, t = _run(one, lambda: jops.binop(op, jl, jr),
                            lambda: tops.binop(op, tl, tr))
                assert_same(j, t, what=f"{lhs} {op} {rhs}", **tol)
    for name in ("a", "pos", "b"):
        for op in ("abs", "ceiling", "floor", "trunc", "sign", "not",
                   "isna", "round"):
            j, t = _run(one, lambda: jops.unop(op, jfr.vec(name)),
                        lambda: tops.unop(op, fr.vec(name)))
            assert_same(j, t, what=f"{op}({name})")
        for op in ("exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
                   "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
                   "cosh", "tanh", "asinh", "acosh", "atanh", "gamma",
                   "lgamma", "digamma", "trigamma", "cospi", "sinpi",
                   "tanpi"):
            j, t = _run(one, lambda: jops.unop(op, jfr.vec(name)),
                        lambda: tops.unop(op, fr.vec(name)))
            rt = (dict(rtol=2e-4, atol=1e-4)
                  if op in ("digamma", "trigamma", "gamma", "lgamma",
                            "tanpi", "tan") else FLOAT_TOL)
            assert_same(j, t, what=f"{op}({name})", **rt)
        for d in (0, 1, 2):
            j, t = _run(one, lambda: jops.round_digits(jfr.vec(name), d),
                        lambda: tops.round_digits(fr.vec(name), d))
            assert_same(j, t, what=f"round({name},{d})")
            j, t = _run(one, lambda: jops.signif(jfr.vec(name), d + 1),
                        lambda: tops.signif(fr.vec(name), d + 1))
            assert_same(j, t, what=f"signif({name},{d + 1})", **FLOAT_TOL)
    j, t = _run(one, lambda: jops.unop("isna", jfr.vec("s")),
                lambda: tops.unop("isna", fr.vec("s"), device="cpu"))
    assert_same(j, t, what="isna(s)")
    for yes, no in ((("a",), ("b",)), ((1.0,), (-1.0,)), (("a",), (0.0,))):
        jy = jfr.vec(yes[0]) if isinstance(yes[0], str) else yes[0]
        jn = jfr.vec(no[0]) if isinstance(no[0], str) else no[0]
        ty = fr.vec(yes[0]) if isinstance(yes[0], str) else yes[0]
        tn = fr.vec(no[0]) if isinstance(no[0], str) else no[0]
        j, t = _run(one, lambda: jops.ifelse(jfr.vec("b"), jy, jn),
                    lambda: tops.ifelse(fr.vec("b"), ty, tn))
        assert_same(j, t, what=f"ifelse {yes} {no}")
    for name in ("a", "b", "pos", "big", "t", "g"):
        for op in ("sum", "prod", "min", "max", "mean", "sd", "sdev", "var",
                   "median", "all", "any", "nacnt"):
            for na_rm in (True, False):
                j, t = _run(one,
                            lambda: jops.reduce_op(op, jfr.vec(name), na_rm),
                            lambda: tops.reduce_op(op, fr.vec(name), na_rm))
                tol = ({} if op in ("min", "max", "all", "any", "nacnt",
                                    "median") else SUM_TOL)
                assert_same(j, t, what=f"{op}({name}, {na_rm})", **tol)
        for op in ("cumsum", "cumprod", "cummin", "cummax"):
            j, t = _run(one, lambda: jops.cumulative(op, jfr.vec(name)),
                        lambda: tops.cumulative(op, fr.vec(name)))
            assert_same(j, t, what=f"{op}({name})",
                        **({} if op in ("cummin", "cummax") else SUM_TOL))
    for name in ("b", "c", "g"):
        j, t = _run(one, lambda: jops.table(jfr.vec(name)),
                    lambda: tops.table(fr.vec(name)))
        assert_same(j, t, what=f"table({name})")
        j, t = _run(one, lambda: jops.unique(jfr.vec(name)),
                    lambda: tops.unique(fr.vec(name)))
        assert_same(j, t, what=f"unique({name})")
        j, t = _run(one, lambda: jops.hist(jfr.vec(name), 7),
                    lambda: tops.hist(fr.vec(name), 7))
        assert_same(j, t, what=f"hist({name})")
    for part in ("year", "month", "day", "dayOfWeek", "hour", "minute",
                 "second", "millis"):
        j, t = _run(one, lambda: jops.time_part(jfr.vec("t"), part),
                    lambda: tops.time_part(fr.vec("t"), part))
        assert_same(j, t, what=part)


def _gb_cols(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    k1 = rng.integers(-3, 4, n).astype(np.float32)
    k1[::17] = np.nan
    x = (rng.normal(size=n) * 50 + 700).astype(np.float32)
    x[::5] = np.nan
    y = rng.integers(0, 2400, n).astype(np.float32)
    y[::19] = np.nan
    return {"k1": k1, "k2": (rng.integers(0, 5, n).astype(np.float32),
                             ["A", "B", "C", "D", "E"]),
            "x": x, "y": y,
            "m": (rng.integers(0, 3, n).astype(np.float32), ["u", "v", "w"])}


def _hold_to_float64(fr, by, t):
    """The port's sums, means and deviations against float64 numpy over
    the same groups, within 1e-6 relative (float64 sums of float32
    values, stored as float32)."""
    keys = np.stack([np.where(np.isnan(fr.vec(b).to_numpy()), np.inf,
                              fr.vec(b).to_numpy()) for b in by], axis=1)
    out = np.stack([np.where(np.isnan(t.vec(b).to_numpy()), np.inf,
                             t.vec(b).to_numpy()) for b in by], axis=1)
    x = fr.vec("x").to_numpy().astype(np.float64)
    for g, key in enumerate(out):
        sel = (keys == key).all(axis=1)
        xs = x[sel][~np.isnan(x[sel])]
        want = dict(sum_x=xs.sum(), mean_x=xs.mean() if xs.size else np.nan,
                    sd_x=xs.std(ddof=1) if xs.size > 1 else
                    (0.0 if xs.size else np.nan))
        for name, w in want.items():
            np.testing.assert_allclose(t.vec(name).to_numpy()[g], w,
                                       rtol=1e-6, atol=1e-9, err_msg=name)


def test_group_by_matches_the_reference(one):
    jfr, fr = both_frames(_gb_cols(3, 500), one)
    aggs = [("nrow", None), ("sum", "x", "rm"), ("mean", "x", "rm"),
            ("min", "x", "rm"), ("max", "x", "rm"), ("sd", "x", "rm"),
            ("var", "y", "rm"), ("sumSquares", "y", "rm"), ("sum", "y", "all"),
            ("mean", "x", "all"), ("max", "y", "ignore"), ("mode", "m", "rm")]
    for by in (["k1"], ["k2"], ["k1", "k2"], ["k2", "m"]):
        j, t = _run(one, lambda: jgroup_by(jfr, by, aggs),
                    lambda: tgroup_by(fr, by, aggs))
        for name in j.names:
            exact = name in by or name in ("nrow", "mode_m") or \
                name.startswith(("min_", "max_"))
            if name.startswith(("sd_", "var_")):
                # compared as variances, at the reference's own error
                p = 2 if name.startswith("sd_") else 1
                col = fr.vec(name.split("_", 1)[1]).to_numpy()
                np.testing.assert_allclose(
                    t.vec(name).to_numpy() ** p, j.vec(name).to_numpy() ** p,
                    rtol=0, atol=VAR_EPS * np.nanmax(col * col),
                    err_msg=f"{by} {name}")
                continue
            assert_same(j.vec(name), t.vec(name), what=f"{by} {name}",
                        **({} if exact else SUM_TOL))
        _hold_to_float64(fr, by, t)
        again = tgroup_by(fr, by, aggs)
        for name in t.names:
            assert np.array_equal(again.vec(name).to_numpy(),
                                  t.vec(name).to_numpy(), equal_nan=True)
    # the oracles of tests/test_rapids.py: negative keys and the NA group
    jfr, fr = both_frames({"g": np.array([-5, -5, -1, np.nan], np.float32),
                           "v": np.array([1.0, 2.0, 3.0, 4.0], np.float32)},
                          one)
    j, t = _run(one, lambda: jgroup_by(jfr, ["g"], [("sum", "v")]),
                lambda: tgroup_by(fr, ["g"], [("sum", "v")]))
    assert_same(j, t, what="NA group")


def test_sort_matches_the_reference(one):
    rng = np.random.default_rng(11)
    n = 300
    k = rng.integers(-3, 4, n).astype(np.float32)
    k[rng.random(n) < 0.1] = np.nan
    special = np.array([np.inf, -np.inf, 0.0, -0.0, np.nan], np.float32)
    k[rng.integers(0, n, 40)] = special[rng.integers(0, 5, 40)]
    z = np.where(rng.random(n) < 0.5, 0.0, -0.0).astype(np.float32)
    z[::31] = np.nan
    cols = {"k": k, "z": z,
            "v": rng.normal(size=n).astype(np.float32),
            "c": (rng.integers(0, 4, n).astype(np.float32),
                  ["a", "b", "c", "d"]),
            "s": np.array([f"r{i}" for i in range(n)], dtype=object)}
    jfr, fr = both_frames(cols, one)
    for by in (["k"], ["z", "k"], ["c", "k", "v"], ["k", "z", "v"]):
        for asc in ([True] * len(by), [False] * len(by),
                    [i % 2 == 0 for i in range(len(by))]):
            j, t = _run(one, lambda: jsort(jfr, by, asc),
                        lambda: tsort(fr, by, asc))
            # the string column carries each row's id: the permutation
            assert_same(j, t, what=f"sort {by} {asc}")
    jfr, fr = both_frames({"a": np.array([2, np.nan, 1], np.float32)}, one)
    j, t = _run(one, lambda: jsort(jfr, ["a"]), lambda: tsort(fr, ["a"]))
    assert_same(j, t, what="NAs first")
    assert np.isnan(t.vec("a").to_numpy()[0])


def _merge_pair(seed: int, ln: int, rn: int, one):
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, 40, ln).astype(np.float32)
    lk[rng.random(ln) < 0.05] = np.nan
    lk[:3] = [0.0, -0.0, np.inf]
    rk = rng.integers(0, 30, rn).astype(np.float32)
    rk[:4] = [-0.0, 0.0, np.nan, 7.0]
    left = {"k": lk, "x": np.arange(ln, dtype=np.float32),
            "lc": (rng.integers(0, 3, ln).astype(np.float32), ["p", "q", "r"])}
    right = {"k": rk, "w": rng.normal(size=rn).astype(np.float32),
             "rc": (rng.integers(0, 2, rn).astype(np.float32), ["m", "n"])}
    return both_frames(left, one), both_frames(right, one)


def test_device_merge_matches_the_reference(one):
    (jl, tl), (jr, tr) = _merge_pair(5, 400, 60, one)
    for all_x in (False, True):
        j, t = _run(one, lambda: jmerge(jl, jr, ["k"], all_x=all_x),
                    lambda: tmerge(tl, tr, ["k"], all_x=all_x))
        assert_same(j, t, what=f"device merge all_x={all_x}")
        again = tmerge(tl, tr, ["k"], all_x=all_x)
        for name in t.names:
            assert torch.equal(again.vec(name).data.view(torch.int32),
                               t.vec(name).data.view(torch.int32))
    # no key in common: the empty frame of the join's schema
    (jl, tl), _ = _merge_pair(6, 20, 5, one)
    jr, tr = both_frames({"k": np.array([100.0, 101.0], np.float32),
                          "w": np.array([1.0, 2.0], np.float32)}, one)
    j, t = _run(one, lambda: jmerge(jl, jr, ["k"]),
                lambda: tmerge(tl, tr, ["k"]))
    assert_same(j, t, what="no matches")
    # the signed-zero and NA-key oracles of tests/test_rapids.py
    jl, tl = both_frames({"key": np.array([0.0, 1.0, np.nan], np.float32),
                          "x": np.array([1.0, 2.0, 3.0], np.float32)}, one)
    jr, tr = both_frames({"key": np.array([-0.0, 1.0, np.nan], np.float32),
                          "v": np.array([7.0, 8.0, 9.0], np.float32)}, one)
    j, t = _run(one, lambda: jmerge(jl, jr), lambda: tmerge(tl, tr))
    assert_same(j, t, what="signed zero")
    assert t.nrow == 2


def test_host_merge_matches_the_reference(one):
    rng = np.random.default_rng(8)
    ln, rn = 300, 50
    # string columns, multiple keys, categorical keys by level name
    left = {"k": rng.integers(0, 12, ln).astype(np.float32),
            "c": (rng.integers(0, 4, ln).astype(np.float32),
                  ["a", "b", "c", "d"]),
            "s": np.array([f"L{i}" for i in range(ln)], dtype=object)}
    left["k"][::23] = np.nan
    right = {"k": rng.integers(0, 15, rn).astype(np.float32),
             "c": (rng.integers(0, 5, rn).astype(np.float32),
                   ["d", "e", "b", "a", "c"]),
             "w": rng.normal(size=rn).astype(np.float32)}
    right["k"][::9] = np.nan
    jl, tl = both_frames(left, one)
    jr, tr = both_frames(right, one)
    for by in (["k"], ["c"], ["k", "c"]):
        for all_x, all_y in ((False, False), (True, False), (False, True),
                             (True, True)):
            j, t = _run(one, lambda: jmerge(jl, jr, by, all_x, all_y),
                        lambda: tmerge(tl, tr, by, all_x, all_y))
            assert_same(j, t, what=f"host merge {by} {all_x} {all_y}")
    # exact-int64 keys: only the exact match joins (no float32 collision)
    jl, tl = both_frames({"k": np.array([16777217, 16777216], np.int64),
                          "v": np.array([1.0, 2.0], np.float32)}, one)
    jr, tr = both_frames({"k": np.array([16777217], np.int64),
                          "w": np.array([9.0], np.float32)}, one)
    j, t = _run(one, lambda: jmerge(jl, jr, ["k"]),
                lambda: tmerge(tl, tr, ["k"]))
    assert t.nrow == j.nrow == 1
    assert t.vec("k").to_numpy()[0] == 16777217
    assert_same(j.vec("w"), t.vec("w"), what="exact keys")
    # empty sides
    empty = {"k": np.zeros(0, np.float32), "v": np.zeros(0, np.float32)}
    one_row = {"k": np.array([1.0, 2.0], np.float32),
               "w": np.array([2.0, 3.0], np.float32)}
    for lcols, rcols in ((empty, one_row), (one_row, {
            "k": np.zeros(0, np.float32), "x": np.zeros(0, np.float32)})):
        jl, tl = both_frames(lcols, one)
        jr, tr = both_frames(rcols, one)
        for all_x in (False, True):
            j, t = _run(one, lambda: jmerge(jl, jr, ["k"], all_x),
                        lambda: tmerge(tl, tr, ["k"], all_x))
            assert_same(j, t, what=f"empty side all_x={all_x}")


def _check_all(one, checks) -> None:
    for fn_j, fn_t, tol in checks:
        j, t = _run(one, fn_j, fn_t)
        assert_same(j, t, what=str(fn_t), **tol)


def test_mungers_and_strings_match_the_reference(one):
    """The munger and string functions the evaluator's expressions do not
    reach, or reach only through one of their options: rectangle
    assignment of a categorical source (levels remapped by name),
    explicit and named histogram breaks, iSAX, every string distance and
    the host-string functions with a ``device``."""
    jfr, fr = both_frames(_cols(), one)
    dst_j, dst_t = both_frames({"c": (np.array([0, 1, 0, 2], np.float32),
                                      ["x", "y", "z"])}, one)
    src_j, src_t = both_frames({"c": (np.array([1, 0], np.float32),
                                      ["z", "new"])}, one)
    checks = [
        (lambda: jmun.rectangle_assign(dst_j, src_j, [0], np.array([1, 3])),
         lambda: tmun.rectangle_assign(dst_t, src_t, [0], np.array([1, 3])),
         {}),
        (lambda: jmun.hist(jfr.vec("pos"), [0.0, 1.0, 2.5, 4.5]),
         lambda: tmun.hist(fr.vec("pos"), [0.0, 1.0, 2.5, 4.5]), {}),
        *[(lambda m=m: jmun.hist(jfr.vec("a"), m),
           lambda m=m: tmun.hist(fr.vec("a"), m), {})
          for m in ("rice", "sqrt", "doane", "scott", "fd")],
        (lambda: jmun.isax(jfr.subframe(["a", "b", "pos"]), 2, 4),
         lambda: tmun.isax(fr.subframe(["a", "b", "pos"]), 2, 4), {}),
        *[(lambda m=m: jstr.strdistance(jfr.vec("s"), jfr.vec("c"), m),
           lambda m=m: tstr.strdistance(fr.vec("s"), fr.vec("c"), m), F)
          for m in ("lv", "jaccard", "jw", "lcs")],
        (lambda: jstr.grep(jfr.vec("s"), "e", output_logical=False),
         lambda: tstr.grep(fr.vec("s"), "e", output_logical=False,
                           device="cpu"), {}),
        (lambda: jstr.asfactor(jfr.vec("b")),
         lambda: tstr.asfactor(fr.vec("b")), {}),
    ]
    _check_all(one, checks)


def test_advmath_and_fairness_match_the_reference(one):
    """Grouped impute, Spearman through ties, ``tabulate``'s two tables
    (no primitive reaches it), and the fairness overview of one model in
    both packages, NA protected levels included."""
    from h2o_tpu.rapids import fairness as jfair
    from h2o_tpu_torch.models.ensemble import carry_model
    from h2o_tpu_torch.rapids import fairness as tfair

    jfr, fr = both_frames(_cols(), one)
    checks = [
        (lambda: jadv.impute(jfr.subframe(["a", "g"]), 0, "median",
                             gb_cols=[1.0]),
         lambda: tadv.impute(fr.subframe(["a", "g"]), 0, "median",
                             gb_cols=[1.0]), {}),
        (lambda: jadv.cor(jfr.subframe(["b"]), jfr.subframe(["g"]),
                          method="Spearman"),
         lambda: tadv.cor(fr.subframe(["b"]), fr.subframe(["g"]),
                          method="Spearman"), SUM_TOL),
        (lambda: [t.cell_values for t in jadv.tabulate(jfr, "c", "a")],
         lambda: [t.cell_values for t in tadv.tabulate(fr, "c", "a")], {}),
        (lambda: [t.cell_values for t in jadv.tabulate(jfr, "b", "g", "pos",
                                                        4, 3)],
         lambda: [t.cell_values for t in tadv.tabulate(fr, "b", "g", "pos",
                                                        4, 3)], {}),
    ]
    _check_all(one, checks)
    # fairness: the reference's GBM, carried into the port
    from h2o_tpu.models.gbm import GBM, GBMParameters

    rng = np.random.default_rng(6)
    n = 500
    sex = rng.integers(0, 2, n).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x + sex)))).astype(np.float32)
    sex[::50] = np.nan
    jb, tb = both_frames({"x": x, "SEX": (sex, ["F", "M"]),
                          "y": (y, ["no", "yes"])}, one)
    with meshmod.use_mesh(one):
        jm = GBM(GBMParameters(training_frame=jb, response_column="y",
                               ntrees=3, max_depth=2, seed=1)).train_model()
    tm = carry_model(jm, device="cpu")
    j, t = _run(one, lambda: jfair.fairness_metrics(jm, jb, ["SEX"], None,
                                                    "yes"),
                lambda: tfair.fairness_metrics(tm, tb, ["SEX"], None, "yes"))
    assert_same(j, t, what="fairness", **FLOAT_TOL)
    assert tfair._fisher_exact(3, 1, 1, 3) == jfair._fisher_exact(3, 1, 1, 3)
