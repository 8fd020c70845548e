"""Port parity: the Rapids evaluator (``h2o_tpu_torch/rapids/exec.py``)
against the reference's (``h2o_tpu/rapids/exec.py``), and the host radix
sort (``h2o_tpu_torch/backend/native.py``) against ``np.lexsort``.

Every one of the 195 primitives runs at least once through both
evaluators on the same expression strings, over the same frames put in
both packages' stores under the same keys (the reference on a one-device
mesh), grouped by module into a few test items. The model primitives run
on the reference's models carried into the port (``carry_model``,
``*.from_reference``), so both evaluate the same model.

Tolerances: integers, orders, merges, strings, domains and host-numpy
results exactly; each float result names its own (``F``: float32
transcendental functions and products, 1e-5 relative plus 1e-6 absolute,
XLA's and torch's kernels differing by a few ulps; ``S``: float32 sums,
moments and deviations in other orders, 1e-5 relative plus 1e-5
absolute; ``G``: the gamma family, 2e-4 relative plus 1e-4 absolute near
its poles).
"""

import numpy as np
import pytest

from h2o_tpu.backend.kvstore import STORE as JSTORE
from h2o_tpu.parallel import mesh as meshmod
from h2o_tpu.rapids import exec as jexec
from h2o_tpu_torch.backend import native
from h2o_tpu_torch.backend.kvstore import STORE as TSTORE
from h2o_tpu_torch.rapids import exec as texec

from torch_parity import assert_same, both_frames, one_mesh

F = dict(rtol=1e-5, atol=1e-6)
S = dict(rtol=1e-5, atol=1e-5)
G = dict(rtol=2e-4, atol=1e-4)


def _contains_keys(j, t):
    """``ls``: both stores list the world's keys."""
    for out in (j, t):
        keys = set(out.vec(0).host_data)
        assert {"rx_f", "rx_k"} <= keys


EXPRS = {
    "ops_elementwise": [
        *[(f"({op} (cols rx_f 'a') (cols rx_f 'b'))", {}) for op in
          ("+", "-", "*", "/", "%%", "%", "intDiv", "%/%", "==", "!=", "<",
           "<=", ">", ">=", "&", "|", "&&", "||")],
        *[(f"({op} -7 3)", {}) for op in
          ("+", "-", "*", "/", "%%", "%", "intDiv", "%/%", "==", "!=", "<",
           "<=", ">", ">=", "&", "|", "&&", "||")],
        ("(^ (cols rx_f 'pos') (cols rx_f 'b'))", F),
        ("(^ -1 0.5)", {}),
        ("(+ (cols rx_f ['a' 'b']) 1)", {}),
        ("(* (cols rx_f 'big') 3)", {}),
        ("(> (cols rx_f 't') 1.62e12)", {}),
        *[(f"({op} (cols rx_f 'a'))", {}) for op in
          ("abs", "ceiling", "floor", "trunc", "sign", "not")],
        *[(f"({op} (cols rx_f 'pos'))", F) for op in
          ("exp", "expm1", "log", "log10", "log2", "log1p", "sqrt", "sin",
           "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
           "asinh", "acosh", "atanh", "cospi", "sinpi", "tanpi")],
        *[(f"({op} (cols rx_f 'a'))", G) for op in
          ("gamma", "lgamma", "digamma", "trigamma")],
        ("(is.na (cols rx_f ['a' 's']))", {}),
        ("(is.na (cols rx_f 'a'))", {}),
    ],
    "ops_reducers": [
        *[(f"({op} (cols rx_f 'a') true)", S) for op in
          ("sum", "mean", "sd", "var", "prod")],
        *[(f"({op} (cols rx_f ['b' 'g']) {na})", {}) for op in
          ("min", "max", "median", "all", "any") for na in ("true", "false")],
        ("(sum (cols rx_f 'a'))", {}),
        *[(f"({op} (cols rx_f ['a' 'b']) true)", S) for op in
          ("sumNA", "maxNA", "minNA", "prod.na")],
        *[(f"({op} (cols rx_f 'b'))", {}) for op in
          ("cumsum", "cumprod", "cummin", "cummax")],
        ("(cumsum (cols rx_f 'pos'))", S),
        ("(round (cols rx_f 'a') 1)", {}),
        ("(signif (cols rx_f 'a') 2)", F),
        ("(ifelse (> (cols rx_f 'a') 0) (cols rx_f 'b') -1)", {}),
        ("(ifelse (cols rx_f 'b') 1 0)", {}),
        ("(table (cols rx_f 'c'))", {}),
        ("(table (cols rx_f 'b'))", {}),
        ("(unique (cols rx_f 'g'))", {}),
        ("(, 1 2 42)", {}),
        ("(nrow rx_f)", {}), ("(ncol rx_f)", {}),
        ("(sumaxis (cols rx_f ['b' 'g']) true 0)", {}),
        ("(sumaxis (cols rx_f ['b' 'g']) false 1)", {}),
        ("(naCnt rx_f)", {}), ("(any.na (cols rx_f 'pos'))", {}),
        ("(filterNACols rx_f 0.1)", {}),
    ],
    "munging_frames": [
        ("(cols rx_f [0 2])", {}), ("(cols_py rx_f 'a')", {}),
        ("(cols rx_f [1:3])", {}),
        ("(rows rx_f [1 3 5])", {}), ("(rows rx_f [2:6])", {}),
        ("(rows rx_f (> (cols rx_f 'a') 0))", {}),
        ("(rows rx_f [38 39 40 41])", {}),
        ("(cbind (cols rx_f 'a') (cols rx_f 'a') (cols rx_f 'b'))", {}),
        ("(rbind (cols rx_f ['a' 'c']) (cols rx_f ['a' 'c']))", {}),
        ("(colnames= (cols rx_f ['a' 'b']) [0 1] ['x' 'y'])", {}),
        ("(is.factor (cols rx_f 'c'))", {}),
        ("(as.factor (cols rx_f 'b'))", {}),
        ("(as.factor (cols rx_f 's'))", {}),
        ("(as.numeric (cols rx_f 'c'))", {}),
        ("(GB rx_f [4] 'nrow' 0 'all' 'mean' 1 'rm' 'max' 2 'all')", S),
        ("(GB rx_f [3 4] 'sum' 0 'rm' 'min' 1 'rm')", S),
        ("(sort rx_f [0 1] [1 0])", {}),
        ("(sort (cols rx_f ['g' 'b' 'a']) [0 1])", {}),
        ("(merge rx_k rx_kr false false [0] [0] 'auto')", {}),
        ("(merge rx_k rx_kr true false [0] [0] 'auto')", {}),
        ("(merge rx_k rx_kr false true [0] [0] 'auto')", {}),
        ("(append (cols rx_f ['a']) 7 'z')", {}),
        ("(append (cols rx_f ['a']) 'lvl' 'z' (cols rx_f 'b') 'w')", {}),
        ("(:= (cols rx_f ['a' 'b']) 99 [0] [1 2])", {}),
        ("(:= (cols rx_f ['a' 'b']) NA [] [0])", {}),
        ("(:= (cols rx_f ['c']) 'new' [0] [2])", {}),
        ("(:= (cols rx_f ['a' 'b']) (cols rx_f 'pos') [1] [])", {}),
    ],
    "munging_columns": [
        ("(seq 2 10 2)", {}), ("(seq_len 4)", {}), ("(rep_len 1.5 3)", {}),
        ("(rep_len (cols rx_f 'c') 50)", {}),
        ("(mode (cols rx_f 'c'))", {}),
        ("(distance (cols rx_mt [0 1]) (cols rx_mt [1 2]) 'l2')", F),
        ("(distance (cols rx_mt [0 1]) (cols rx_mt [1 2]) 'l1')", F),
        ("(distance (cols rx_mt [0 1]) (cols rx_mt [1 2]) 'cosine')", F),
        ("(distance (cols rx_mt [0 1]) (cols rx_mt [1 2]) 'cosine_sq')", F),
        ("(hist (cols rx_f 'pos') 'sturges')", {}),
        ("(hist (cols rx_f 'pos') 5)", {}),
        ("(modulo_kfold_column (cols rx_f 0) 3)", {}),
        ("(dropdup rx_dd [0] 'first')", {}),
        ("(dropdup rx_dd [0] 'last')", {}),
        ("(h2o.mad (cols rx_f 'pos') 'interpolate' 1.4826)", {}),
        ("(perfectAUC (cols rx_pa 'p') (cols rx_pa 'y'))", {}),
        ("(nlevels (cols rx_f 'c'))", {}), ("(any.factor rx_f)", {}),
        ("(is.character (cols rx_f 's'))", {}),
        ("(is.numeric (cols rx_f 'a'))", {}),
        ("(columnsByType rx_f 'numeric')", {}),
        ("(columnsByType rx_f 'categorical')", {}),
        ("(columnsByType rx_f 'string')", {}),
        ("(setLevel (cols rx_f 'c') 'mid')", {}),
        ("(appendLevels (cols rx_f 'c') ['zz'])", {}),
        ("(relevel.by.freq (cols rx_f 'c') -1)", {}),
        ("(getrow rx_g1)", {}), ("(flatten rx_g2)", {}),
        ("(apply (cols rx_f ['a' 'b']) 2 {x . (mean x true)})", S),
        ("(apply (cols rx_f ['pos' 'b']) 1 {x . (sum x)})", S),
        ("(apply (cols rx_f ['pos' 'g']) 1 {x . (+ (max x true) 1)})", {}),
        ("(ddply rx_f [3] {x . (mean (cols x 'pos') true)})", S),
        ("(tmp= rx_tmp (cols rx_f ['a' 'b']))", {}),
        ("(nrow rx_tmp)", {}),
        ("(rm rx_tmp)", {}),
        ("(rename 'rx_old' 'rx_new')", {}),
        ("(nrow rx_new)", {}),
        ("(ls)", _contains_keys),
        ("(grouped_permute rx_gp 1 [0] 2 3)", {}),
        ("(h2o.runif rx_f 42)", {}),
    ],
    "strings": [
        *[(f"({op} (cols rx_f 's'))", {}) for op in
          ("toupper", "tolower", "trim", "nchar", "entropy", "strlen")],
        *[(f"({op} (cols rx_f 'c'))", {}) for op in
          ("toupper", "nchar", "ascharacter", "as.character", "entropy")],
        ("(sub 'a' 'A' (cols rx_f 's'))", {}),
        ("(gsub '[aeiou]' '_' (cols rx_f 's'))", {}),
        ("(gsub 'I' 'x' (cols rx_f 'c') true)", {}),
        ("(grep (cols rx_f 's') 'an' false false true)", {}),
        ("(grep (cols rx_f 's') 'A' true true false)", {}),
        ("(lstrip (cols rx_f 's') ' ')", {}),
        ("(rstrip (cols rx_f 's') ' ')", {}),
        ("(substring (cols rx_f 's') 1 4)", {}),
        ("(replacefirst (cols rx_f 's') 'e' 'E')", {}),
        ("(replaceall (cols rx_f 's') 'e' 'E')", {}),
        ("(countmatches (cols rx_f 's') ['a' 'e'])", {}),
        ("(strsplit (cols rx_f 's') ' ')", {}),
        ("(strsplit (ascharacter (cols rx_f 'c')) 'i')", {}),
        ("(strDistance (cols rx_f 's') (cols rx_s2 0) 'lv' true)", {}),
        ("(strDistance (cols rx_f 's') (cols rx_s2 0) 'jaccard' true)", F),
        ("(strDistance (cols rx_f 's') (cols rx_s2 0) 'jw' false)", F),
        ("(strDistance (cols rx_f 's') (cols rx_s2 0) 'lcs' true)", {}),
        ("(tokenize (cols rx_f 's') ' ')", {}),
        ("(num_valid_substrings (cols rx_f 's') 'WORDS')", {}),
        ("(tf-idf rx_tfi 0 1 true true)", F),
        ("(tf-idf rx_tfi 0 1 false false)", F),
    ],
    "time": [
        *[(f"({op} (cols rx_f 't'))", {}) for op in
          ("year", "month", "day", "dayOfWeek", "hour", "minute", "second",
           "millis", "week")],
        ("(moment 2020 1 2 3 4 5 6)", {}),
        ("(mktime 2021 3 4 5 6 7 8)", {}),
        ("(as.Date (cols rx_ad 0) 'yyyy-MM-dd')", {}),
        ("(as.Date (as.factor (cols rx_ad 0)) 'yyyy-MM-dd')", {}),
        ("(week (as.Date (cols rx_ad 0) 'yyyy-MM-dd'))", {}),
        ("(listTimeZones)", {}), ("(setTimeZone 'UTC')", {}),
        ("(getTimeZone)", {}),
        ("(isax rx_ts 4 8 0)", {}),
    ],
    "advmath_stats": [
        ("(skewness (cols rx_f 'pos') true)", S),
        ("(kurtosis (cols rx_f 'pos') true)", S),
        ("(cor (cols rx_f ['a' 'pos']) (cols rx_f ['b' 'pos']) "
         "'everything' 'Pearson')", S),
        ("(cor (cols rx_f 'a') (cols rx_f 'pos') 'everything' 'Spearman')",
         S),
        ("(quantile (cols rx_f ['a' 'big']) [0.1 0.5 0.9] 'interpolate' _)",
         {}),
        ("(quantile (cols rx_f ['a']) [0.25 0.75] 'low' _)", {}),
        ("(h2o.impute rx_imp 0 'mean' 'interpolate' [] _ _)", S),
        ("(h2o.impute rx_imp 1 'median' 'interpolate' [3] _ _)", {}),
        ("(h2o.impute rx_imp 2 'mode' 'interpolate' [] _ _)", {}),
        ("(cols rx_imp [0 1 2])", S),
        ("(scale (cols rx_f ['a' 'pos' 'c']) true true)", S),
        ("(scale (cols rx_f ['a' 'pos']) [1 2] [2 4])", F),
        ("(scale_inplace rx_sc true false)", S),
        ("(na.omit rx_f)", {}),
        ("(h2o.fillna (cols rx_f ['a' 'b']) 'forward' 0 1)", {}),
        ("(h2o.fillna (cols rx_f ['a' 'b']) 'backward' 0 2)", {}),
        ("(h2o.fillna (cols rx_f ['a' 'b' 'g']) 'forward' 1 1)", {}),
        ("(which (cols rx_f 'b'))", {}),
        ("(which.max (cols rx_f ['a' 'b']) true 0)", {}),
        ("(which.min (cols rx_f ['a' 'b']) true 1)", {}),
        ("(match (cols rx_f 'c') ['hi' 'lo'] _ 1)", {}),
        ("(match (cols rx_f 'b') [1 2] 0 1)", {}),
        ("(cut (cols rx_f 'a') [-5 -1 0 1 5] _ false true 3)", {}),
        ("(cut (cols rx_f 'a') [-5 0 5] ['neg' 'pos'] true false 3)", {}),
        ("(difflag1 (cols rx_f 'pos'))", {}),
        ("(kfold_column (cols rx_f 'a') 5 42)", {}),
        ("(stratified_kfold_column (cols rx_f 'c') 3 42)", {}),
        ("(h2o.random_stratified_split (cols rx_f 'c') 0.3 42)", {}),
    ],
    "advmath_reshape": [
        ("(levels (cols rx_f ['c' 'a']))", {}),
        ("(relevel (cols rx_f 'c') 'hi')", {}),
        ("(setDomain (cols rx_f 'c') ['w' 'x' 'y' 'z'])", {}),
        ("(pivot rx_pv 'id' 'kind' 'val')", {}),
        ("(melt rx_wd ['id'] ['u' 'v'] 'variable' 'value' false)", {}),
        ("(melt rx_wd ['id'] ['u' 'v'] 'var' 'val' true)", {}),
        ("(t rx_mt)", {}),
        ("(x*y rx_mt (t rx_mt))", F),
        ("(x*y (cols rx_f ['big']) (t (cols rx_f ['big'])))", {}),
        ("(rank_within_groupby rx_f ['g'] ['a'] [1] 'rank' false)", {}),
        ("(rank_within_groupby rx_f ['c' 'g'] ['b' 'a'] [0 1] 'r' false)",
         {}),
        ("(topn rx_f 0 20 0)", {}), ("(topn rx_f 7 30 1)", {}),
        ("(interaction rx_ia ['a' 'b'] false 100 1)", {}),
        ("(interaction rx_ia ['a' 'b' 'c'] true 2 1)", {}),
    ],
    "models_explain": [
        ("(PermutationVarImp rx_gbm rx_fair 'AUTO' 1 42)", F),
        ("(makeLeaderboard ['rx_gbm'])", F),
        ("(makeLeaderboard ['rx_gbm'] rx_fair 'logloss')", F),
        ("(fairnessMetrics rx_gbm rx_fair ['SEX'] [] 'yes')", F),
        ("(fairnessMetrics rx_gbm rx_fair ['SEX' 'EDU'] ['F' 'hs'] 'yes')",
         F),
    ],
    "models_transform": [
        ("(model.reset.threshold rx_gbm 0.9)", {}),
        ("(transform rx_te_m rx_te)", F),
        ("(segment_models_as_frame rx_seg_m)", {}),
        ("(word2vec.to.frame rx_w2v)", {}),
    ],
}


def _heads(node, out):
    kind, val = node
    if kind in ("exec", "list", "fun"):
        if kind == "exec" and val and val[0][0] == "id":
            out.add(val[0][1])
        for x in val:
            _heads(x, out)
    return out


def _world(one, tmp) -> tuple:
    """The frames of the expressions, as (reference, port) pairs."""
    rng = np.random.default_rng(29)
    n = 40
    a = (rng.normal(size=n) * 2).astype(np.float32)
    a[::7] = np.nan
    a[3], a[5] = 0.0, -0.0
    b = rng.integers(-3, 4, n).astype(np.float32)
    b[::9] = np.nan
    g = rng.integers(0, 3, n).astype(np.float32)
    g[::11] = np.nan
    words = ["apple pie", "Banana", " cherry ", "date-x", "elder flower"]
    s = np.array([None if i % 8 == 6 else words[i % 5] for i in range(n)],
                 dtype=object)
    t = 1_614_834_367_000.0 + rng.integers(
        0, 400 * 86_400_000, n).astype(np.float64)
    t[::10] = np.nan
    f = {"a": a, "b": b, "pos": (rng.random(n) * 3 + 0.2).astype(np.float32),
         "g": g, "c": (rng.integers(0, 4, n).astype(np.float32),
                       ["lo", "mid", "hi", "top"]),
         "s": s, "t": t,
         "big": (2 ** 24 + rng.integers(0, 30, n)).astype(np.int64)}
    world = {
        "rx_f": f,
        "rx_k": {"k": rng.integers(0, 8, 30).astype(np.float32),
                 "v": np.arange(30, dtype=np.float32)},
        "rx_kr": {"k": rng.integers(0, 10, 12).astype(np.float32),
                  "w": rng.normal(size=12).astype(np.float32)},
        "rx_mt": {f"m{j}": rng.normal(size=4).astype(np.float32)
                  for j in range(4)},
        "rx_dd": {"k": np.array([1, 2, 1, 3, 2, np.nan, np.nan], np.float32),
                  "v": np.arange(7, dtype=np.float32)},
        "rx_pa": {"p": rng.random(n).astype(np.float32),
                  "y": rng.integers(0, 2, n).astype(np.float32)},
        "rx_g1": {"n": np.array([3.5], np.float32),
                  "c": (np.array([0], np.float32), ["lv"])},
        "rx_g2": {"x": np.array([42.0], np.float32)},
        "rx_old": {"x": np.array([1.0], np.float32)},
        "rx_gp": {"g": (rng.integers(0, 2, 16).astype(np.float32),
                        ["j0", "j1"]),
                  "id": (rng.integers(0, 4, 16).astype(np.float32),
                         ["r0", "r1", "r2", "r3"]),
                  "kind": (rng.integers(0, 2, 16).astype(np.float32),
                           ["C", "D"]),
                  "amt": rng.integers(1, 9, 16).astype(np.float32)},
        "rx_s2": {"s": np.array([words[(i * 3) % 5] for i in range(n)],
                                dtype=object)},
        "rx_tfi": {"doc": np.array([0, 0, 1, 2], np.float32),
                   "text": np.array(["a b a", "c", "a c", "B b"],
                                    dtype=object)},
        "rx_ad": {"d": np.array(["2020-01-02", "2020-12-31", None,
                                 "1999-07-04"], dtype=object)},
        "rx_ts": {f"t{i}": rng.normal(size=8).astype(np.float32)
                  for i in range(16)},
        "rx_pv": {"id": np.array([1, 1, 2, 2, 3], np.float32),
                  "kind": (np.array([0, 1, 0, 1, 1], np.float32),
                           ["p", "q"]),
                  "val": np.array([10, 20, 30, 40, 50], np.float32)},
        "rx_wd": {"id": np.array([1, 2, 3], np.float32),
                  "u": np.array([1, np.nan, 3], np.float32),
                  "v": np.array([4, 5, np.nan], np.float32)},
        "rx_ia": {k: (rng.integers(0, 3, 30).astype(np.float32),
                      [f"{k}{i}" for i in range(3)]) for k in "abc"},
        "rx_imp": {k: f[k] for k in ("a", "b", "c", "g")},
        "rx_sc": {"x": f["pos"].copy(), "y": f["a"].copy()},
    }
    out = {}
    for key, cols in world.items():
        jfr, fr = both_frames(cols, one)
        out[key] = (jfr, fr)
    words_path = tmp / "words.txt"
    words_path.write_text("an\nna\nap\npie\nerr\nfl\n")
    return out, str(words_path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    one = one_mesh()
    frames, words = _world(one, tmp_path_factory.mktemp("rapids_exec"))
    return one, words, frames


def _install(pairs: dict) -> list:
    """Put each (reference, port) pair in its package's store under its
    key, at the start of each test item: another test on the same xdist
    worker may have cleared a store since the module fixture ran."""
    for key, (j, t) in pairs.items():
        j.key = t.key = key
        JSTORE.put(key, j)
        TSTORE.put(key, t)
    return list(pairs)


def _bin_cols(n=600, seed=6):
    rng = np.random.default_rng(seed)
    sex = rng.integers(0, 2, n).astype(np.float32)
    edu = rng.integers(0, 3, n).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    logit = x + 0.8 * sex - 0.3 * edu
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return {"x": x, "SEX": (sex, ["F", "M"]), "EDU": (edu, ["hs", "bsc", "msc"]),
            "y": (y, ["no", "yes"])}


def _models(one):
    """The model primitives' models: trained by the reference, carried
    into the port under the same keys."""
    from h2o_tpu.models.gbm import GBM, GBMParameters
    from h2o_tpu.models.segments import (SegmentModelsBuilder,
                                         SegmentModelsParameters)
    from h2o_tpu.models.target_encoder import (TargetEncoder,
                                               TargetEncoderParameters)
    from h2o_tpu.models.word2vec import Word2Vec, Word2VecParameters
    from h2o_tpu_torch.models.ensemble import carry_model
    from h2o_tpu_torch.models.segments import SegmentModels
    from h2o_tpu_torch.models.target_encoder import TargetEncoderModel
    from h2o_tpu_torch.models.word2vec import Word2VecModel

    jfair, fair = both_frames(_bin_cols(), one)
    rng = np.random.default_rng(3)
    c = rng.integers(0, 4, 200).astype(np.float32)
    jte, te = both_frames({"y": (c % 2 + 0.1 * rng.normal(size=200))
                           .astype(np.float32),
                           "c": (c, list("abcd"))}, one)
    emb = {"Word": np.array(["cat", "dog", "eel"], dtype=object),
           **{f"V{j + 1}": rng.normal(size=3).astype(np.float32)
              for j in range(4)}}
    jemb, _ = both_frames(emb, one)
    with meshmod.use_mesh(one):
        jgbm = GBM(GBMParameters(training_frame=jfair, response_column="y",
                                 ntrees=4, max_depth=3, seed=1)).train_model()
        jte_m = TargetEncoder(TargetEncoderParameters(
            training_frame=jte, response_column="y")).train_model()
        jseg = SegmentModelsBuilder(GBM, GBMParameters(
            training_frame=jfair, response_column="y", ntrees=2,
            max_depth=2, seed=1), SegmentModelsParameters(
                segment_columns=["SEX"])).build_segment_models()
        jw2v = Word2Vec(Word2VecParameters(pre_trained=jemb, vec_size=4)
                        ).train_model()
    seg = SegmentModels.from_reference(jseg, device="cpu")
    for a, b in zip(jseg.results, seg.results):
        if b["model"] is not None:
            b["model"].key = a["model"].key   # the carried model's key
    return _install({
        "rx_gbm": (jgbm, carry_model(jgbm, device="cpu")),
        "rx_te_m": (jte_m, TargetEncoderModel.from_reference(
            jte_m, device="cpu")),
        "rx_seg_m": (jseg, seg),
        "rx_w2v": (jw2v, Word2VecModel.from_reference(jw2v, device="cpu")),
        "rx_fair": (jfair, fair), "rx_te": (jte, te)})


def test_prims_table_equals_the_reference():
    assert set(texec._PRIMS) == set(jexec._PRIMS)
    assert len(texec._PRIMS) == 195
    heads = set()
    for exprs in EXPRS.values():
        for expr, _ in exprs:
            _heads(texec._Parser(expr).parse(), heads)
    assert set(texec._PRIMS) - heads == set()


@pytest.mark.parametrize("group", sorted(EXPRS))
def test_prims_match_the_reference(world, group):
    one, words, frames = world
    keys = _install(frames) + ["rx_new"]
    if group.startswith("models"):
        keys += _models(one)
    jr = jexec.Rapids(jexec.Session())
    tr = texec.Rapids(texec.Session(device="cpu"))
    try:
        for expr, tol in EXPRS[group]:
            expr = expr.replace("WORDS", words)
            with meshmod.use_mesh(one):
                j = jr.exec(expr)
            t = tr.exec(expr)
            if callable(tol):
                tol(j, t)
            else:
                assert_same(j, t, what=expr, **tol)
    finally:
        jr.session.end()
        tr.session.end()
        for key in keys:
            JSTORE.remove(key, cascade=False)
            TSTORE.remove(key, cascade=False)


@pytest.mark.parametrize("n", [1000, native.RADIX_MIN_ROWS + 4321],
                         ids=["numpy", "radix"])
def test_radix_route_matches_lexsort(n):
    """Both routes of ``radix_lexsort`` (numpy below 2^15 rows, the C++
    radix above) give ``np.lexsort``'s permutation over the same keys:
    ties, NaN first or last, +-inf, +-0 and descending keys."""
    rng = np.random.default_rng(12)
    k0 = rng.integers(-3, 4, n).astype(np.float64)
    k0[rng.random(n) < 0.05] = np.nan
    k1 = rng.normal(size=n)
    k1[rng.integers(0, n, 50)] = np.inf
    k1[rng.integers(0, n, 50)] = -np.inf
    k1[rng.integers(0, n, 50)] = np.nan
    k1[rng.integers(0, n, 50)] = 0.0
    k1[rng.integers(0, n, 50)] = -0.0
    k2 = (rng.integers(0, 2 ** 40, n)).astype(np.float64)
    for asc in ([True, True, True], [False, True, False],
                [True, False, True]):
        for na_first in (True, False):
            got = native.radix_lexsort([k0, k1, k2], asc, na_first)
            keys = [native._as_sortable_u64(c, a, na_first)
                    for c, a in zip((k0, k1, k2), asc)]
            want = np.lexsort(list(reversed(keys)))
            assert np.array_equal(got, want), (n, asc, na_first)
            # the order itself: NaN first ascending, descending keys
            # reversed, ties in row order
            s0 = k0[got]
            na = np.isnan(s0)
            if asc[0]:
                assert na[:na.sum()].all() == na_first
            fin = s0[~na]
            step = np.diff(fin)
            assert (step >= 0).all() if asc[0] else (step <= 0).all()
