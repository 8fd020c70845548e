"""Advanced math / munging rapids prims (``h2o_tpu/rapids/advmath.py``;
`water/rapids/ast/prims/{advmath,mungers,matrix}`).

Moments, correlation, scaling, lag differences and matrix products run as
torch reductions on the columns' device; the index-shuffling munging ops
(quantile, impute, pivot/melt/rank/match, fold columns) assemble on the
host, as in the reference, and their columns go back to the input's
device. Fold and split columns draw with numpy's ``default_rng``, so a
seed gives the reference's draws."""

from __future__ import annotations

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_INT, T_TIME, Vec
from .ops import dev_vec, device_of


def _valid_np(v: Vec) -> np.ndarray:
    x = v.to_numpy()
    return x, ~np.isnan(x)


# ---------------------------------------------------------------------------
# moments / correlation (`AstSkewness`, `AstKurtosis`, `AstCorrelation`)
# ---------------------------------------------------------------------------
def _centred(v: Vec):
    x = v.data
    ok = ~torch.isnan(x) & (torch.arange(x.shape[0], device=x.device)
                            < v.nrow)
    n = ok.sum()
    mu = torch.where(ok, x, 0.0).sum() / n
    return torch.where(ok, x - mu, 0.0), n


def skewness(v: Vec, na_rm: bool = True) -> float:
    d, n = _centred(v)
    m2 = (d * d).sum() / (n - 1)
    m3 = (d ** 3).sum() / n
    return float(m3 / torch.pow(m2, 1.5))


def kurtosis(v: Vec, na_rm: bool = True) -> float:
    d, n = _centred(v)
    m2 = (d * d).sum() / (n - 1)
    m4 = (d ** 4).sum() / n
    return float(m4 / (m2 * m2))


def _rank_frame(fr: Frame) -> Frame:
    """Average-rank transform per column (ties → midranks), the Spearman
    front-end (`advmath/SpearmanCorrelation.java` rank MRTask)."""
    from scipy.stats import rankdata

    cols = {}
    for n in fr.names:
        x = fr.vec(n).to_numpy()
        r = np.full_like(x, np.nan, dtype=np.float64)
        ok = ~np.isnan(x)
        r[ok] = rankdata(x[ok])
        cols[n] = r.astype(np.float32)
    return Frame(list(fr.names), [Vec.from_numpy(v, device=fr.device)
                                  for v in cols.values()])


def cor(fx: Frame, fy: Frame, use: str = "everything",
        method: str = "Pearson"):
    """Pairwise Pearson/Spearman correlation; complete-rows handling like the
    reference's 'complete.obs'. Returns a float for 1x1, else a Frame."""
    if str(method).lower().startswith("spearman"):
        # Spearman = Pearson over midrank-transformed columns; ranks are
        # computed AFTER dropping incomplete rows so they stay contiguous
        # (matches R's complete.obs and `SpearmanCorrelation.java`)
        ok = np.ones(fx.vec(0).nrow, dtype=bool)
        for f in (fx, fy):
            for i in range(f.ncol):
                ok &= ~np.isnan(f.vec(i).to_numpy())
        idx = np.where(ok)[0]
        return cor(_rank_frame(fx.take(idx)), _rank_frame(fy.take(idx)),
                   use, "Pearson")
    Xc = [fx.vec(i) for i in range(fx.ncol)]
    Yc = [fy.vec(i) for i in range(fy.ncol)]
    X = torch.stack([c.data for c in Xc], dim=1)
    Y = torch.stack([c.data for c in Yc], dim=1)
    nrow = Xc[0].nrow
    inr = torch.arange(X.shape[0], device=X.device) < nrow
    ok = (inr & ~torch.isnan(X).any(dim=1) & ~torch.isnan(Y).any(dim=1))
    n = ok.sum()
    Xz = torch.where(ok[:, None], X, 0.0)
    Yz = torch.where(ok[:, None], Y, 0.0)
    mx = Xz.sum(dim=0) / n
    my = Yz.sum(dim=0) / n
    Xd = torch.where(ok[:, None], X - mx, 0.0)
    Yd = torch.where(ok[:, None], Y - my, 0.0)
    cov = Xd.T @ Yd / (n - 1)
    sx = torch.sqrt((Xd * Xd).sum(dim=0) / (n - 1))
    sy = torch.sqrt((Yd * Yd).sum(dim=0) / (n - 1))
    C = cov / torch.outer(sx, sy)
    if C.shape == (1, 1):
        return float(C[0, 0])
    out = C.cpu().numpy()
    return Frame(list(fy.names),
                 [Vec.from_numpy(out[:, j].astype(np.float32),
                                 device=X.device)
                  for j in range(out.shape[1])])


def quantile_frame(fr: Frame, probs, interpolation: str = "interpolate") -> Frame:
    """`AstQtile` (type 7 linear interpolation, NAs skipped)."""
    probs = [probs] if isinstance(probs, float) else list(probs)
    dev = fr.device
    cols = {"Probs": Vec.from_numpy(np.asarray(probs, dtype=np.float32),
                                    device=dev)}
    for name in fr.names:
        v = fr.vec(name)
        x, ok = _valid_np(v)
        xs = np.sort(x[ok])
        if xs.size == 0:
            q = np.full(len(probs), np.nan)
        else:
            q = np.quantile(xs, probs,
                            method="linear" if interpolation != "low"
                            else "lower")
        # float64 out: from_numpy keeps an exact copy when f32 is lossy,
        # so the client reads full-precision quantiles (the reference is
        # float64 end-to-end)
        cols[f"{name}Quantiles"] = Vec.from_numpy(q.astype(np.float64),
                                                  device=dev)
    return Frame(list(cols), list(cols.values()))


# ---------------------------------------------------------------------------
# imputation / scaling / NA handling (`AstImpute`, `AstScale`, `AstNaOmit`,
# `AstFillNA`)
# ---------------------------------------------------------------------------
def _column_stat(x: np.ndarray, ok: np.ndarray, method: str) -> float:
    if not ok.any():
        return np.nan
    if method == "median":
        return float(np.median(x[ok]))
    if method == "mode":
        vals, cnt = np.unique(x[ok], return_counts=True)
        return float(vals[np.argmax(cnt)])
    return float(np.mean(x[ok]))


def impute(fr: Frame, col: int, method: str = "mean",
           combine_method: str = "interpolate", gb_cols=None,
           values=None) -> list[float]:
    """In-place column imputation, optionally per group (`AstImpute`);
    returns the fill value(s) (global path) or the per-group fills."""
    method = (method or "mean").lower()
    idxs = range(fr.ncol) if col is None or col < 0 else [int(col)]
    gb_cols = [] if gb_cols in (None, [], "_") else (
        gb_cols if isinstance(gb_cols, list) else [gb_cols])
    gkeys = None
    if gb_cols:
        G = np.stack([fr.vec(int(c) if isinstance(c, float) else c).to_numpy()
                      for c in gb_cols], axis=1)
        _, gkeys = np.unique(G, axis=0, return_inverse=True)
    fills = []
    for ci in idxs:
        v = fr.vec(ci)
        if v.is_categorical() and method == "mean":
            raise ValueError("mean imputation on a categorical column — "
                             "use method='mode' (AstImpute restriction)")
        x, ok = _valid_np(v)
        if values not in (None, []) and not isinstance(values, str):
            fill = float(values[len(fills)] if isinstance(values, list)
                         else values)
            filled = np.where(ok, x, fill)
            fills.append(fill)
        elif gkeys is not None:
            filled = x.copy()
            group_fills = {}
            for g in np.unique(gkeys):
                sel = gkeys == g
                f = _column_stat(x, ok & sel, method)
                group_fills[int(g)] = f
                filled[sel & ~ok] = f
            fills.append(group_fills)
        else:
            fill = _column_stat(x, ok, method)
            filled = np.where(ok, x, fill)
            fills.append(fill)
        fr.replace(fr.names[ci], Vec.from_numpy(filled, type=v.type,
                                                domain=v.domain,
                                                device=v.device))
    return fills


def scale_frame(fr: Frame, center=True, scale=True) -> Frame:
    """(x - center)/scale per numeric column; center/scale may be bools or
    per-column number lists (`AstScale`)."""
    out = Frame([], [])
    num_i = 0
    for name in fr.names:
        v = fr.vec(name)
        if v.is_categorical() or v.data is None:
            out.add(name, v)
            continue
        r = v.rollups()
        if isinstance(center, list):
            c = float(center[num_i])
        else:
            c = float(r.mean) if center else 0.0
        if isinstance(scale, list):
            s = float(scale[num_i])
        else:
            s = float(r.sigma) if scale else 1.0
        s = s if s > 0 else 1.0
        out.add(name, dev_vec((v.data - c) / s, v.nrow))
        num_i += 1
    return out


def na_omit(fr: Frame) -> Frame:
    keep = np.ones(fr.nrow, dtype=bool)
    for i in range(fr.ncol):
        x = fr.vec(i).to_numpy()
        if x is not None and x.dtype != object:
            keep &= ~np.isnan(x)
        else:
            keep &= np.array([s is not None for s in fr.vec(i).host_data])
    return fr.take(np.where(keep)[0])


def _ffill_1d(x: np.ndarray, maxlen: int) -> np.ndarray:
    idx = np.arange(len(x))
    ok = ~np.isnan(x)
    last = np.maximum.accumulate(np.where(ok, idx, -1))
    dist = idx - last
    can = (last >= 0) & (dist > 0) & (dist <= maxlen)
    return np.where(can, x[np.clip(last, 0, None)], x)


def fillna(fr: Frame, method: str = "forward", axis: int = 0,
           maxlen: int = 1) -> Frame:
    """`AstFillNA`: propagate last (or next) valid value up to maxlen cells,
    down the rows (axis=0) or across the columns (axis=1). Exact-int64/time
    columns keep their original dtype (Vec.from_numpy retains the exact
    copy when f32 would be lossy)."""
    back = method.lower() in ("backward", "bfill")
    if axis == 1:
        numeric = [n for n in fr.names if fr.vec(n).data is not None
                   and not fr.vec(n).is_categorical()]
        X = np.stack([fr.vec(n).to_numpy().astype(np.float64)
                      for n in numeric], axis=1)
        if back:
            X = X[:, ::-1]
        idx = np.arange(X.shape[1])[None, :]
        ok = ~np.isnan(X)
        last = np.maximum.accumulate(np.where(ok, idx, -1), axis=1)
        dist = idx - last
        can = (last >= 0) & (dist > 0) & (dist <= maxlen)
        X = np.where(can, np.take_along_axis(X, np.clip(last, 0, None),
                                             axis=1), X)
        if back:
            X = X[:, ::-1]
        out = Frame([], [])
        ji = 0
        for n in fr.names:
            v = fr.vec(n)
            if n in numeric:
                out.add(n, Vec.from_numpy(X[:, ji], type=v.type,
                                          domain=v.domain, device=v.device))
                ji += 1
            else:
                out.add(n, v)
        return out
    out = Frame([], [])
    for name in fr.names:
        v = fr.vec(name)
        x = v.to_numpy().copy()
        if x is None or x.dtype == object:
            out.add(name, v)
            continue
        filled = _ffill_1d(x[::-1], maxlen)[::-1] if back \
            else _ffill_1d(x, maxlen)
        out.add(name, Vec.from_numpy(filled, type=v.type, domain=v.domain,
                                     device=v.device))
    return out


# ---------------------------------------------------------------------------
# which / match / cut / diff (`AstWhich*`, `AstMatch`, `AstCut`, `AstDiffLag1`)
# ---------------------------------------------------------------------------
def which(v: Vec) -> Vec:
    x, ok = _valid_np(v)
    # int64 indices: Vec.from_numpy keeps the exact copy when f32 is lossy
    return Vec.from_numpy(np.where(ok & (x != 0))[0], type=T_INT,
                          device=v.device)


def which_extreme(fr: Frame, na_rm: bool = True, axis: int = 0,
                  mx: bool = True) -> Frame:
    """Per-column (axis=0) or per-row (axis=1) arg-extreme (`AstWhichMax`)."""
    key = "which.max" if mx else "which.min"
    if axis == 1:
        X = np.stack([fr.vec(n).to_numpy() for n in fr.names], axis=1)
        ok = ~np.isnan(X)
        Xm = np.where(ok, X, -np.inf if mx else np.inf)
        idx = (np.argmax(Xm, axis=1) if mx
               else np.argmin(Xm, axis=1)).astype(np.float64)
        idx[~ok.any(axis=1)] = np.nan
        return Frame([key], [Vec.from_numpy(idx, device=fr.device)])
    idxs = []
    for name in fr.names:
        x, ok = _valid_np(fr.vec(name))
        if not ok.any():
            idxs.append(np.nan)
        else:
            xm = np.where(ok, x, -np.inf if mx else np.inf)
            idxs.append(float(np.argmax(xm) if mx else np.argmin(xm)))
    return Frame([key], [Vec.from_numpy(np.asarray(idxs, dtype=np.float64),
                                        device=fr.device)])


def match(v: Vec, table, nomatch=np.nan, start_index: float = 1.0) -> Vec:
    """Map values/levels to their 1-based position in `table` (`AstMatch`)."""
    table = [table] if isinstance(table, (str, float)) else list(table)
    x = v.to_numpy()
    out = np.full(len(x), np.nan if nomatch is None else float(nomatch),
                  dtype=np.float32)
    if v.is_categorical() and v.domain:
        lut = {}
        for pos, t in enumerate(table):
            lut.setdefault(str(t), pos + start_index)
        codes = {i: lut.get(lvl) for i, lvl in enumerate(v.domain)}
        ok = ~np.isnan(x)
        for i, hit in codes.items():
            if hit is not None:
                out[ok & (x == i)] = hit
    else:
        for pos, t in enumerate(table):
            out[x == float(t)] = pos + start_index
    return Vec.from_numpy(out, device=v.device)


def cut(v: Vec, breaks, labels=None, include_lowest=False, right=True,
        dig_lab: int = 3) -> Vec:
    """Numeric → categorical binning (`AstCut`)."""
    breaks = np.asarray(breaks, dtype=np.float64)
    x = v.to_numpy()
    # the reference searches in float32 (breaks and values both float32)
    b = np.searchsorted(breaks.astype(np.float32),
                        np.nan_to_num(x, nan=np.inf).astype(np.float32),
                        side="left" if right else "right")
    codes = b.astype(np.float64) - 1
    oob = np.isnan(x) | (x > breaks[-1]) | \
        ((x <= breaks[0]) if (right and not include_lowest) else (x < breaks[0]))
    if not right:
        oob |= x >= breaks[-1]   # last interval is right-open
    if right and include_lowest:
        codes[x == breaks[0]] = 0
    codes = np.clip(codes, 0, len(breaks) - 2)
    codes[oob] = np.nan
    if labels in (None, []):
        fmt = lambda a: f"%.{dig_lab}g" % a
        labels = [f"({fmt(breaks[i])},{fmt(breaks[i+1])}]" if right else
                  f"[{fmt(breaks[i])},{fmt(breaks[i+1])})"
                  for i in range(len(breaks) - 1)]
    return Vec.from_numpy(codes.astype(np.float32), type=T_CAT,
                          domain=[str(l) for l in labels], device=v.device)


def difflag1(v: Vec) -> Vec:
    """x[i] − x[i−1], first row NA (`AstDiffLag1`)."""
    x = v.data
    out = torch.cat([torch.full((1,), torch.nan, device=x.device),
                     x[1:] - x[:-1]])
    return dev_vec(out, v.nrow)


# ---------------------------------------------------------------------------
# fold / split columns (`AstKFold`, `AstStratifiedKFold`, `AstStratifiedSplit`)
# ---------------------------------------------------------------------------
def kfold_column(v: Vec, nfolds: int, seed: int = -1) -> Vec:
    rng = np.random.default_rng(None if seed in (-1, None) else int(seed))
    folds = rng.permutation(np.arange(v.nrow) % int(nfolds))
    return Vec.from_numpy(folds.astype(np.float32), type=T_INT,
                          device=v.device)


def stratified_kfold_column(y: Vec, nfolds: int, seed: int = -1) -> Vec:
    rng = np.random.default_rng(None if seed in (-1, None) else int(seed))
    x = y.to_numpy()
    out = np.zeros(y.nrow, dtype=np.float32)
    for lvl in np.unique(x[~np.isnan(x)]):
        idx = np.where(x == lvl)[0]
        out[rng.permutation(idx)] = np.arange(len(idx)) % int(nfolds)
    return Vec.from_numpy(out, type=T_INT, device=y.device)


def stratified_split(y: Vec, test_frac: float = 0.2, seed: int = -1) -> Vec:
    rng = np.random.default_rng(None if seed in (-1, None) else int(seed))
    x = y.to_numpy()
    out = np.zeros(y.nrow, dtype=np.float32)
    for lvl in np.unique(x[~np.isnan(x)]):
        idx = rng.permutation(np.where(x == lvl)[0])
        out[idx[:int(round(test_frac * len(idx)))]] = 1.0
    return Vec.from_numpy(out, type=T_CAT, domain=["train", "test"],
                          device=y.device)


# ---------------------------------------------------------------------------
# levels / relevel (`AstLevels`, `AstRelevel`, `AstSetDomain`)
# ---------------------------------------------------------------------------
def levels(fr: Frame) -> list:
    return [list(fr.vec(i).domain or []) for i in range(fr.ncol)]


def relevel(v: Vec, level: str) -> Vec:
    if not v.is_categorical():
        raise ValueError("relevel requires a categorical column")
    dom = list(v.domain)
    if level not in dom:
        raise ValueError(f"level '{level}' not in domain")
    new_dom = [level] + [d for d in dom if d != level]
    remap = np.array([new_dom.index(d) for d in dom], dtype=np.float32)
    x = v.to_numpy()
    ok = ~np.isnan(x)
    out = np.full(len(x), np.nan, dtype=np.float32)
    out[ok] = remap[x[ok].astype(np.int64)]
    return Vec.from_numpy(out, type=T_CAT, domain=new_dom, device=v.device)


def set_domain(v: Vec, labels) -> Vec:
    return Vec(v.data, v.nrow, type=T_CAT, domain=[str(l) for l in labels])


# ---------------------------------------------------------------------------
# reshape (`AstPivot`, `AstMelt`, `AstTranspose`, `AstMMult`)
# ---------------------------------------------------------------------------
def pivot(fr: Frame, index: str, column: str, value: str) -> Frame:
    idx_v, col_v, val_v = (fr.vec(n) for n in (index, column, value))
    ivals = idx_v.to_numpy()
    cvals = col_v.to_numpy()
    vvals = val_v.to_numpy()
    uidx = np.unique(ivals[~np.isnan(ivals)])
    cdom = col_v.domain if col_v.is_categorical() else \
        [str(x) for x in np.unique(cvals[~np.isnan(cvals)])]
    ccodes = cvals if col_v.is_categorical() else \
        np.searchsorted(np.unique(cvals[~np.isnan(cvals)]), cvals)
    out = np.full((len(uidx), len(cdom)), np.nan, dtype=np.float64)
    pos = np.searchsorted(uidx, ivals)
    ok = ~np.isnan(ivals) & ~np.isnan(cvals)
    out[pos[ok], ccodes[ok].astype(np.int64)] = vvals[ok]
    dev = fr.device
    cols = {index: Vec.from_numpy(uidx, type=idx_v.type,
                                  domain=idx_v.domain, device=dev)}
    for j, c in enumerate(cdom):
        cols[str(c)] = Vec.from_numpy(out[:, j], device=dev)
    return Frame(list(cols), list(cols.values()))


def melt(fr: Frame, id_vars, value_vars=None, var_name: str = "variable",
         value_name: str = "value", skipna: bool = False) -> Frame:
    id_vars = [id_vars] if isinstance(id_vars, str) else list(id_vars)
    value_vars = value_vars or [n for n in fr.names if n not in id_vars]
    value_vars = [value_vars] if isinstance(value_vars, str) else list(value_vars)
    n = fr.nrow
    ids = {c: fr.vec(c).to_numpy() for c in id_vars}
    var_codes, vals = [], []
    keep = []
    for vi, c in enumerate(value_vars):
        x = fr.vec(c).to_numpy()
        m = ~np.isnan(x) if skipna else np.ones(n, dtype=bool)
        keep.append(m)
        var_codes.append(np.full(int(m.sum()), vi, dtype=np.float32))
        vals.append(x[m])
    cols = {}
    dev = fr.device
    for c in id_vars:
        v = fr.vec(c)
        cols[c] = Vec.from_numpy(
            np.concatenate([ids[c][m] for m in keep]),
            type=v.type, domain=v.domain, device=dev)
    cols[var_name] = Vec.from_numpy(np.concatenate(var_codes), type=T_CAT,
                                    domain=[str(c) for c in value_vars],
                                    device=dev)
    cols[value_name] = Vec.from_numpy(np.concatenate(vals), device=dev)
    return Frame(list(cols), list(cols.values()))


def transpose(fr: Frame) -> Frame:
    # to_numpy returns the exact f64 copy when present; keep that
    # precision through the transpose (from_numpy re-derives the copies)
    X = np.stack([fr.vec(i).to_numpy().astype(np.float64)
                  for i in range(fr.ncol)], axis=0)
    return Frame([f"C{i+1}" for i in range(X.shape[1])],
                 [Vec.from_numpy(X[:, i], device=fr.device)
                  for i in range(X.shape[1])])


def mmult(fx: Frame, fy: Frame) -> Frame:
    # f64 host path when either side carries exact host copies (values that
    # don't round-trip f32) — the reference multiplies doubles; a float32
    # product on the device remains the path for the other data
    dev = fx.device
    if any(fx.vec(i).exact_data is not None for i in range(fx.ncol)) or \
            any(fy.vec(i).exact_data is not None for i in range(fy.ncol)):
        X = np.stack([fx.vec(i).to_numpy().astype(np.float64)
                      for i in range(fx.ncol)], axis=1)
        Y = np.stack([fy.vec(i).to_numpy().astype(np.float64)
                      for i in range(fy.ncol)], axis=1)
        Z = X @ Y
        return Frame([f"C{i+1}" for i in range(Z.shape[1])],
                     [Vec.from_numpy(Z[:, i], device=dev)
                      for i in range(Z.shape[1])])
    X = torch.stack([fx.vec(i).data[:fx.nrow] for i in range(fx.ncol)], dim=1)
    Y = torch.stack([fy.vec(i).data[:fy.nrow] for i in range(fy.ncol)], dim=1)
    Z = torch.matmul(X, Y).cpu().numpy()
    return Frame([f"C{i+1}" for i in range(Z.shape[1])],
                 [Vec.from_numpy(Z[:, i].astype(np.float32), device=dev)
                  for i in range(Z.shape[1])])


# ---------------------------------------------------------------------------
# rank within group (`AstRankWithinGroupBy`)
# ---------------------------------------------------------------------------
def rank_within_group_by(fr: Frame, group_cols, sort_cols, ascending=None,
                         new_col_name: str = "New_Rank_column") -> Frame:
    group_cols = [group_cols] if isinstance(group_cols, (str, float)) else group_cols
    sort_cols = [sort_cols] if isinstance(sort_cols, (str, float)) else sort_cols
    gnames = [fr.names[int(c)] if isinstance(c, float) else c for c in group_cols]
    snames = [fr.names[int(c)] if isinstance(c, float) else c for c in sort_cols]
    asc = ascending if ascending not in (None, []) else [1.0] * len(snames)
    G = np.stack([fr.vec(n).to_numpy() for n in gnames], axis=1)
    S = np.stack([fr.vec(n).to_numpy() * (1 if a else -1)
                  for n, a in zip(snames, asc)], axis=1)
    order = np.lexsort(tuple(S[:, i] for i in reversed(range(S.shape[1])))
                       + tuple(G[:, i] for i in reversed(range(G.shape[1]))))
    ranks = np.full(fr.nrow, np.nan, dtype=np.float32)
    prev = None
    r = 0
    for pos in order:
        gkey = tuple(G[pos])
        if any(np.isnan(S[pos])):
            continue
        if gkey != prev:
            r = 1
            prev = gkey
        else:
            r += 1
        ranks[pos] = r
    out = Frame(list(fr.names), list(fr.vecs))
    out.add(new_col_name, Vec.from_numpy(ranks, device=fr.device))
    return out


# ---------------------------------------------------------------------------
# topn (`AstTopN`)
# ---------------------------------------------------------------------------
def topn(fr: Frame, col: int, npercent: float, bottom: bool = False) -> Frame:
    v = fr.vec(int(col))
    x, ok = _valid_np(v)
    n = max(1, int(round(npercent / 100.0 * v.nrow)))
    idx = np.where(ok)[0]
    order = idx[np.argsort(x[idx])]
    pick = order[:n] if bottom else order[::-1][:n]
    name = "Bottom" if bottom else "Top"
    # original dtypes through from_numpy: exact int64/time values survive
    return Frame(["Row Indices", f"{name} {fr.names[int(col)]} values"],
                 [Vec.from_numpy(pick, type=T_INT, device=fr.device),
                  Vec.from_numpy(x[pick], device=fr.device)])


# ---------------------------------------------------------------------------
# factor interactions (`hex/Interaction` / `h2o.interaction`)
# ---------------------------------------------------------------------------
def interaction(fr: Frame, factors, pairwise: bool = False,
                max_factors: int = 100, min_occurrence: int = 1) -> Frame:
    """Combined categorical columns from factor tuples: top `max_factors`
    observed combos (≥ min_occurrence) become levels, the tail becomes
    'other'."""
    factors = [factors] if isinstance(factors, str) else list(factors)
    names = [fr.names[int(f)] if isinstance(f, float) else f for f in factors]
    groups = ([[a, b] for i, a in enumerate(names) for b in names[i + 1:]]
              if pairwise and len(names) > 2 else [names])
    out = Frame([], [])
    for grp in groups:
        vs = [fr.vec(n) for n in grp]
        for v, n in zip(vs, grp):
            if not v.is_categorical():
                raise ValueError(f"interaction: column '{n}' is not "
                                 f"categorical")
        # vectorized combo coding: stack code columns, NA row-mask, then one
        # np.unique over complete rows builds the observed-combo table
        codes = np.stack([v.to_numpy() for v in vs], axis=1)
        ok = ~np.isnan(codes).any(axis=1)
        combos = codes[ok].astype(np.int64)
        uniq, inverse, counts = np.unique(
            combos, axis=0, return_inverse=True, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        keep_n = int(min(max_factors,
                         int(np.sum(counts >= min_occurrence))))
        kept_ids = order[:keep_n][counts[order[:keep_n]] >= min_occurrence]
        dom = ["_".join(v.domain[c] for v, c in zip(vs, uniq[u]))
               for u in kept_ids]
        has_other = len(uniq) > len(kept_ids)
        if has_other:
            dom.append("other")
        remap = np.full(len(uniq), float(len(kept_ids)))  # default → other
        remap[kept_ids] = np.arange(len(kept_ids), dtype=np.float64)
        col = np.full(fr.nrow, np.nan, dtype=np.float32)
        col[ok] = remap[inverse]
        out.add("_".join(grp), Vec.from_numpy(col, type=T_CAT, domain=dom,
                                              device=fr.device))
    return out


# ---------------------------------------------------------------------------
# time construction (`AstMoment`, `AstMktime`)
# ---------------------------------------------------------------------------
def moment(year, month, day, hour=0.0, minute=0.0, second=0.0, msec=0.0,
           device=None) -> Vec:
    def arr(a):
        if isinstance(a, Vec):
            return a.to_numpy().astype(np.float64)
        return np.asarray([float(a)])
    ys, ms, ds, hs, mins, ss, mss = (arr(a) for a in
                                     (year, month, day, hour, minute, second,
                                      msec))
    n = max(map(len, (ys, ms, ds, hs, mins, ss, mss)))
    def bc(a):
        return np.broadcast_to(a, (n,)) if len(a) != n else a
    ys, ms, ds, hs, mins, ss, mss = map(bc, (ys, ms, ds, hs, mins, ss, mss))
    out = np.full(n, np.nan, dtype=np.float64)
    for i in range(n):
        try:
            dt = np.datetime64(
                f"{int(ys[i]):04d}-{int(ms[i]):02d}-{int(ds[i]):02d}"
                f"T{int(hs[i]):02d}:{int(mins[i]):02d}:{int(ss[i]):02d}", "ms")
            out[i] = dt.astype("int64") + mss[i]
        except Exception:
            pass
    # float64 in: Vec keeps an exact host copy when f32 would be lossy
    # (ms-since-epoch exceeds 2^24)
    return Vec.from_numpy(out, type=T_TIME, device=device_of(
        [year, month, day, hour, minute, second, msec], device=device))


# ---------------------------------------------------------------------------
# Tabulate (`water/util/Tabulate`, `POST /99/Tabulate`)
# ---------------------------------------------------------------------------
def tabulate(fr: Frame, predictor: str, response: str,
             weight: str | None = None, nbins_predictor: int = 20,
             nbins_response: int = 10):
    """Co-occurrence tabulation of predictor vs response: a weighted count
    grid over (x-bin, y-bin) and the per-x-bin weighted response mean —
    `Tabulate.execImpl`'s two tables. Categoricals keep one bin per level,
    numerics bin uniformly over [min,max], missing values get a leading
    "missing(NA)" bin when present (the reference's `_missing` offset)."""
    from ..utils.twodimtable import TwoDimTable

    if nbins_predictor < 1 or nbins_response < 1:
        raise ValueError("number of bins must be >= 1")
    vx, vy = fr.vec(predictor), fr.vec(response)
    if vx is None or vy is None:
        missing = predictor if vx is None else response
        raise KeyError(f"column {missing} not found")
    w = (fr.vec(weight).to_numpy() if weight else
         np.ones(fr.nrow, dtype=np.float64))

    def axis(v, nbins):
        x = v.to_numpy().astype(np.float64)
        has_na = bool(np.isnan(x).any())
        if v.domain is not None:
            nb = v.cardinality()
            bins = np.where(np.isnan(x), -1, x).astype(np.int64)
            labels = list(v.domain)
        else:
            lo, hi = np.nanmin(x), np.nanmax(x)
            if v.type == T_INT and (hi - lo + 1) <= nbins:
                nb = int(hi - lo + 1)
                bins = np.where(np.isnan(x), -1, x - lo).astype(np.int64)
                labels = [str(int(lo + b)) for b in range(nb)]
            else:
                nb = nbins
                d = (hi - lo) / nbins or 1.0
                bins = np.where(np.isnan(x), -1,
                                np.minimum((x - lo) / d, nbins - 1)
                                ).astype(np.int64)
                labels = [f"{lo + (b + 0.5) * d:5f}" for b in range(nb)]
        if has_na:  # NA bin leads, like `Tabulate.bin()`'s +_missing offset
            bins = bins + 1
            labels = ["missing(NA)"] + labels
            nb += 1
        return bins, labels, nb

    xb, xlabels, nx = axis(vx, nbins_predictor)
    yb, ylabels, ny = axis(vy, nbins_response)
    yraw = vy.to_numpy().astype(np.float64)

    counts = np.zeros((nx, ny))
    np.add.at(counts, (xb, yb), w)
    resp_w = np.zeros(nx)
    resp_sum = np.zeros(nx)
    ok = ~np.isnan(yraw)
    np.add.at(resp_w, xb[ok], w[ok])
    np.add.at(resp_sum, xb[ok], (w * yraw)[ok])
    with np.errstate(invalid="ignore", divide="ignore"):
        resp_mean = resp_sum / resp_w

    count_rows = [[xlabels[i], ylabels[j], float(counts[i, j])]
                  for i in range(nx) for j in range(ny)]
    count_table = TwoDimTable(
        f"(Weighted) co-occurrence counts of {predictor} vs {response}", "",
        [predictor, response, "counts"], ["string", "string", "double"],
        None, count_rows)
    resp_rows = [[xlabels[i],
                  None if resp_w[i] == 0 else float(resp_mean[i]),
                  float(resp_w[i])] for i in range(nx)]
    response_table = TwoDimTable(
        f"(Weighted) response means of {response} by {predictor}", "",
        [predictor, f"mean {response}", "counts"],
        ["string", "double", "double"], None, resp_rows)
    return count_table, response_table
