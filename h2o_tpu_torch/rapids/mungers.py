"""Frame mutation, repeaters, search/filter/munge prims
(``h2o_tpu/rapids/mungers.py``).

Reference: `water/rapids/ast/prims/{assign,repeaters,mungers,filters,advmath,
reducers,time,timeseries,models}`. Wire names match the reference
``str()`` registrations exactly (e.g. `AstAppend` "append",
`AstRectangleAssign` ":=", `AstRepLen` "rep_len", `AstDropDuplicates`
"dropdup", `AstMad` "h2o.mad", `AstDistance` "distance").

Device placement: the distance matrix is one product on the frames'
device; structural edits (rectangle assign, domain surgery, dedup) go
through numpy on the host, as in the reference, and their columns go back
to the input's device. Columns made from nothing (``seq``, ``seq_len``,
``rep_len`` of a number) and columns made from host strings take
``device`` (None -> ``cuda``).
"""

from __future__ import annotations

import datetime as _dt

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_INT, T_NUM, T_TIME, Vec
from ..parallel.mesh import resolve_device
from .ops import device_of
from .strings import level_strings


# ---------------------------------------------------------------------------
# assign (`prims/assign/AstAppend.java`, `AstRectangleAssign.java`)
# ---------------------------------------------------------------------------
def _const_vec(value, nrow: int, device) -> Vec:
    if isinstance(value, str):
        # `Vec.makeCon(String)`: constant categorical with a 1-level domain
        return Vec.from_numpy(np.zeros(nrow, dtype=np.float32),
                              type=T_CAT, domain=[value], device=device)
    return Vec.from_numpy(np.full(nrow, float(value), dtype=np.float32),
                          device=device)


def append(dst: Frame, src, name: str, device=None) -> Frame:
    """(append dst src "name") — attach a column; number/str sources become
    constant columns (`AstAppend.java:44-60`)."""
    out = Frame(list(dst.names), list(dst.vecs))
    if isinstance(src, Frame):
        if src.ncol != 1:
            raise ValueError("Can only append one column")
        vec = src.vec(0)
    elif isinstance(src, Vec):
        vec = src
    else:
        vec = _const_vec(src, dst.nrow, device_of(dst, device=device))
    if vec.nrow != dst.nrow and dst.ncol:
        raise ValueError(f"append: row mismatch {vec.nrow} vs {dst.nrow}")
    if name in out.names:
        out.replace(name, vec)
    else:
        out.add(str(name), vec)
    return out


def _assign_into(col: Vec, rows, src_col, nrow: int) -> Vec:
    """Overwrite `rows` of one column; src_col is a Vec (len == selection),
    a number, a string (categorical level / string value), or NaN."""
    if col.is_string():
        vals = np.array(col.host_data, dtype=object)
        if isinstance(src_col, Vec):
            sv = (src_col.host_data if src_col.is_string()
                  else src_col.to_numpy().astype(object))
            vals[rows] = sv
        else:
            vals[rows] = src_col if isinstance(src_col, str) else (
                None if src_col is None or (isinstance(src_col, float)
                                            and np.isnan(src_col))
                else float(src_col))
        return Vec.from_numpy(vals)

    dev = col.device
    data = col.to_numpy().astype(np.float64)
    domain = list(col.domain) if col.domain else None
    if isinstance(src_col, Vec):
        sv = src_col.to_numpy()
        if col.is_categorical() and src_col.is_categorical():
            # remap source levels into the destination domain, extending it
            code_map = np.full(len(src_col.domain or []), np.nan)
            for i, lvl in enumerate(src_col.domain or []):
                if lvl not in domain:
                    domain.append(lvl)
                code_map[i] = domain.index(lvl)
            ok = ~np.isnan(sv)
            mapped = np.full_like(sv, np.nan, dtype=np.float64)
            mapped[ok] = code_map[sv[ok].astype(int)]
            sv = mapped
        data[rows] = sv
    elif isinstance(src_col, str):
        if not col.is_categorical():
            raise ValueError("string assignment needs a categorical column")
        if src_col not in domain:
            domain.append(src_col)
        data[rows] = domain.index(src_col)
    else:
        data[rows] = (np.nan if src_col is None else float(src_col))
    return Vec.from_numpy(data.astype(np.float32), type=col.type,
                          domain=domain, device=dev)


def rectangle_assign(dst: Frame, src, cols, rows) -> Frame:
    """(:= dst src col_expr row_expr) — `AstRectangleAssign.java`: overwrite a
    row × column slice; conceptually a fresh frame (COW in the reference)."""
    nrow = dst.nrow
    rows = np.arange(nrow) if rows is None else np.asarray(rows)
    if rows.dtype == bool:
        rows = np.where(rows)[0]
    out = Frame(list(dst.names), list(dst.vecs))
    col_list = cols if isinstance(cols, list) else [cols]
    # strictly 0..nrow-1 IN ORDER: a permuted or duplicated full-length row
    # list is a scatter, not a column replacement
    whole_column = len(rows) == nrow and \
        (nrow == 0 or bool(np.array_equal(rows, np.arange(nrow))))
    for k, ci in enumerate(col_list):
        ci = int(ci)
        if whole_column and isinstance(src, (Frame, Vec)):
            # assigning a full column REPLACES it, adopting the source's
            # type/domain (h2o-py `f[col] = numeric_frame` drops the old
            # enum domain — `AstRectangleAssign` whole-vec path)
            sv = src.vec(k) if isinstance(src, Frame) else src
            if sv.nrow == nrow:
                out._vecs[ci] = sv
                continue
        if isinstance(src, Frame):
            if src.ncol != len(col_list):
                raise ValueError(f"Frame src has {src.ncol} cols; assigning "
                                 f"{len(col_list)}")
            sv = src.vec(k)
            if sv.nrow != len(rows):
                raise ValueError(f"src rows {sv.nrow} != selection "
                                 f"{len(rows)}")
            src_col = sv
        elif isinstance(src, Vec):
            src_col = src
        else:
            src_col = src
        out._vecs[ci] = _assign_into(dst.vec(ci), rows, src_col, nrow)
    return out


# ---------------------------------------------------------------------------
# repeaters (`prims/repeaters/Ast{Seq,SeqLen,RepLen}.java`)
# ---------------------------------------------------------------------------
def seq(frm: float, to: float, by: float, device=None) -> Vec:
    if by == 0:
        raise ValueError("seq: by must be non-zero")
    n = int(np.floor((to - frm) / by + 1e-10)) + 1
    if n <= 0:
        raise ValueError("seq: wrong sign of 'by'")
    return Vec.from_numpy((frm + by * np.arange(n)).astype(np.float64),
                          device=resolve_device(device))


def seq_len(n: float, device=None) -> Vec:
    if int(n) <= 0:
        raise ValueError(f"Argument to seq_len must be a positive number: {n}")
    return Vec.from_numpy(np.arange(1, int(n) + 1, dtype=np.float64),
                          device=resolve_device(device))


def rep_len(x, length: int, device=None) -> Vec:
    length = int(length)
    if isinstance(x, Frame):
        x = x.vec(0)
    if isinstance(x, Vec):
        reps = int(np.ceil(length / max(x.nrow, 1)))
        vals = np.tile(x.to_numpy(), reps)[:length]
        return Vec.from_numpy(vals, type=x.type,
                              domain=list(x.domain) if x.domain else None,
                              device=device_of(x, device=device))
    return Vec.from_numpy(np.full(length, float(x), dtype=np.float64),
                          device=resolve_device(device))


# ---------------------------------------------------------------------------
# advmath: mode / distance / hist breaks algos / modulo kfold
# ---------------------------------------------------------------------------
def mode(v: Vec) -> float:
    """(mode col) — most frequent level of a categorical (`AstMode.java`)."""
    if not v.is_categorical():
        raise ValueError("mode expects a categorical column")
    x = v.to_numpy()
    x = x[~np.isnan(x)].astype(int)
    if not x.size:
        return float("nan")
    return float(np.bincount(x).argmax())


def distance(x: Frame, y: Frame, measure: str) -> Frame:
    """(distance X Y measure) — pairwise distances, N×M output
    (`AstDistance.java`); one product per measure on the frames' device."""
    measure = measure.lower()
    if measure not in ("cosine", "cosine_sq", "l1", "l2"):
        raise ValueError(f"Invalid distance measure provided: {measure}")
    if x.ncol != y.ncol:
        raise ValueError(f"Frames must have the same number of cols, found "
                         f"{x.ncol} and {y.ncol}")
    dev = x.device
    X = torch.nan_to_num(x.as_matrix(), nan=0.0)[: x.nrow]
    Y = torch.nan_to_num(y.as_matrix(), nan=0.0)[: y.nrow]
    if measure == "l1":
        D = torch.abs(X[:, None, :] - Y[None, :, :]).sum(dim=-1)
    else:
        G = X @ Y.T
        nx = (X * X).sum(dim=1)
        ny = (Y * Y).sum(dim=1)
        if measure == "l2":
            D = torch.sqrt(torch.clamp(nx[:, None] + ny[None, :] - 2 * G,
                                       min=0.0))
        elif measure == "cosine":
            D = G / torch.clamp(torch.sqrt(nx)[:, None]
                                * torch.sqrt(ny)[None, :], min=1e-30)
        else:  # cosine_sq
            D = (G * G) / torch.clamp(nx[:, None] * ny[None, :], min=1e-30)
    Dn = D.cpu().numpy()
    return Frame([f"C{j + 1}" for j in range(Dn.shape[1])],
                 [Vec.from_numpy(Dn[:, j], device=dev)
                  for j in range(Dn.shape[1])])


def _hist_nbins(v: Vec, algo: str) -> int:
    """Break-count heuristics (`AstHist.java` sturges/rice/sqrt/doane/scott/fd)."""
    n = v.nrow - v.nacnt()
    x = v.to_numpy()
    x = x[~np.isnan(x)]
    rng = float(x.max() - x.min()) if x.size else 1.0
    if algo == "sturges":
        return max(int(np.ceil(np.log2(max(n, 2)) + 1)), 1)
    if algo == "rice":
        return max(int(np.ceil(2 * n ** (1.0 / 3))), 1)
    if algo == "sqrt":
        return max(int(np.ceil(np.sqrt(n))), 1)
    if algo == "doane":
        if n <= 2:
            return 1
        g1 = float(np.abs(
            np.mean((x - x.mean()) ** 3) / max(np.std(x) ** 3, 1e-30)))
        sg = np.sqrt(6.0 * (n - 2) / ((n + 1.0) * (n + 3)))
        return max(int(np.ceil(1 + np.log2(n) + np.log2(1 + g1 / sg))), 1)
    if algo == "scott":
        h = 3.5 * float(np.std(x)) / max(n, 1) ** (1.0 / 3)
        return max(int(np.ceil(rng / max(h, 1e-30))), 1)
    if algo == "fd":
        q75, q25 = np.percentile(x, [75, 25]) if x.size else (1.0, 0.0)
        h = 2.0 * (q75 - q25) / max(n, 1) ** (1.0 / 3)
        return max(int(np.ceil(rng / max(h, 1e-30))), 1) if h > 0 else 1
    return _hist_nbins(v, "sturges")


def hist(v: Vec, breaks) -> Frame:
    """(hist col breaks) — breaks may be an algo name, a count, or explicit
    break points; output columns mirror `AstHist.java`: breaks/counts/
    mids_true/mids."""
    x = v.to_numpy()
    x = x[~np.isnan(x)]
    if isinstance(breaks, str):
        edges = np.linspace(x.min(), x.max(), _hist_nbins(v, breaks.lower()) + 1)
    elif isinstance(breaks, list):
        edges = np.asarray([float(b) for b in breaks])
    else:
        edges = np.linspace(x.min(), x.max(), max(int(breaks), 1) + 1)
    counts, _ = np.histogram(x, bins=edges)
    mids = 0.5 * (edges[:-1] + edges[1:])
    # mids_true = mean of members per bin (reference HistTask computes this)
    which = np.clip(np.digitize(x, edges) - 1, 0, len(counts) - 1)
    sums = np.bincount(which, weights=x, minlength=len(counts))
    mids_true = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
    dev = v.device
    return Frame(
        ["breaks", "counts", "mids_true", "mids"],
        [Vec.from_numpy(edges[1:], device=dev),
         Vec.from_numpy(counts.astype(np.float64), device=dev),
         Vec.from_numpy(mids_true, device=dev),
         Vec.from_numpy(mids, device=dev)])


def modulo_kfold_column(v: Vec, n: int) -> Vec:
    idx = np.arange(v.nrow, dtype=np.int64)
    return Vec.from_numpy((idx % int(n)).astype(np.float32), type=T_INT,
                          device=v.device)


def mad(fr: Frame, combine: str = "interpolate",
        constant: float = 1.4826) -> float:
    """(h2o.mad fr combine const) — `AstMad.java`: const·median(|x−median|)."""
    v = fr.vec(0)
    if v.nacnt() > 0:
        return float("nan")
    x = v.to_numpy()
    med = float(np.median(x))
    return constant * float(np.median(np.abs(x - med)))


def perfect_auc(probs: Vec, acts: Vec) -> float:
    """(perfectAUC p y) — exact AUC by rank statistic (`AstPerfectAUC.java`)."""
    p = probs.to_numpy()
    y = acts.to_numpy()
    ok = ~(np.isnan(p) | np.isnan(y))
    p, y = p[ok], y[ok].astype(int)
    n1 = int(y.sum())
    n0 = len(y) - n1
    if n0 == 0 or n1 == 0:
        return float("nan")
    order = np.argsort(p, kind="stable")
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    # midranks for ties
    ps = p[order]
    i = 0
    while i < len(ps):
        j = i
        while j + 1 < len(ps) and ps[j + 1] == ps[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    return float((ranks[y == 1].sum() - n1 * (n1 + 1) / 2.0) / (n0 * n1))


# ---------------------------------------------------------------------------
# filters (`prims/filters/dropduplicates`)
# ---------------------------------------------------------------------------
def dropdup(fr: Frame, cols, keep: str = "first") -> Frame:
    """(dropdup fr [cols] keep) — drop duplicate rows by key columns."""
    idxs = cols if isinstance(cols, list) else [cols]
    keys = []
    for c in idxs:
        v = fr.vec(int(c)) if not isinstance(c, str) else fr.vec(c)
        keys.append(v.host_data if v.is_string() else v.to_numpy())
    tags = [tuple(None if (isinstance(k[i], float) and np.isnan(k[i]))
                  else k[i] for k in keys) for i in range(fr.nrow)]
    seen: dict = {}
    order = range(fr.nrow) if keep == "first" else range(fr.nrow - 1, -1, -1)
    for i in order:
        seen.setdefault(tags[i], i)
    pick = np.array(sorted(seen.values()), dtype=np.int64)
    return fr.take(pick)


# ---------------------------------------------------------------------------
# mungers: domains, types, shapes
# ---------------------------------------------------------------------------
def nlevels(v: Vec) -> float:
    return float(len(v.domain)) if v.domain else 0.0


def any_factor(fr: Frame) -> float:
    return float(any(v.is_categorical() for v in fr.vecs))


def columns_by_type(fr: Frame, coltype: str = "numeric") -> list[float]:
    """(columnsByType fr type) — indices of columns of the given type
    (`AstColumnsByType.java`)."""
    coltype = coltype.lower()
    picks = []
    for i, v in enumerate(fr.vecs):
        is_num = v.type in (T_NUM, T_INT) and not v.is_categorical()
        if ((coltype == "numeric" and is_num)
                or (coltype == "categorical" and v.is_categorical())
                or (coltype == "string" and v.is_string())
                or (coltype == "time" and v.type == T_TIME)
                or (coltype == "bad" and v.type == "bad")
                or (coltype == "uuid" and v.type == "uuid")):
            picks.append(float(i))
    return picks


def set_level(v: Vec, level: str) -> Vec:
    """(setLevel col "lvl") — constant column at one existing level."""
    if not v.is_categorical() or level not in (v.domain or []):
        raise ValueError(f"setLevel: '{level}' not in domain")
    code = float(v.domain.index(level))
    return Vec.from_numpy(np.full(v.nrow, code, dtype=np.float32),
                          type=T_CAT, domain=list(v.domain), device=v.device)


def append_levels(v: Vec, levels) -> Vec:
    """(appendLevels col [lvls]) — widen the domain, data unchanged."""
    if not v.is_categorical():
        raise ValueError("appendLevels expects a categorical column")
    dom = list(v.domain)
    for l in ([levels] if isinstance(levels, str) else levels):
        if l not in dom:
            dom.append(str(l))
    return Vec.from_numpy(v.to_numpy(), type=T_CAT, domain=dom,
                          device=v.device)


def relevel_by_freq(v: Vec, top_n: int = -1) -> Vec:
    """(relevel.by.freq col topN) — reorder domain by descending frequency."""
    if not v.is_categorical():
        raise ValueError("relevel.by.freq expects a categorical column")
    x = v.to_numpy()
    ok = ~np.isnan(x)
    counts = np.bincount(x[ok].astype(int), minlength=len(v.domain))
    order = np.argsort(-counts, kind="stable")
    if top_n > 0:  # only promote the top_n most frequent, keep the rest as-is
        promoted = list(order[:top_n])
        rest = [i for i in range(len(v.domain)) if i not in promoted]
        order = np.array(promoted + rest)
    new_dom = [v.domain[i] for i in order]
    remap = np.empty(len(v.domain))
    remap[order] = np.arange(len(order))
    out = np.where(ok, remap[np.clip(x, 0, None).astype(int)], np.nan)
    return Vec.from_numpy(out.astype(np.float32), type=T_CAT, domain=new_dom,
                          device=v.device)


def getrow(fr: Frame) -> list:
    """(getrow fr) — single-row frame to a row of values (`AstGetrow.java`)."""
    if fr.nrow != 1:
        raise ValueError(f"getrow requires a frame with exactly 1 row; "
                         f"got {fr.nrow}")
    out = []
    for v in fr.vecs:
        if v.is_string():
            out.append(v.host_data[0])
        elif v.is_categorical():
            c = v.to_numpy()[0]
            out.append(None if np.isnan(c) else v.domain[int(c)])
        else:
            out.append(float(v.to_numpy()[0]))
    return out


def flatten(fr: Frame):
    """(flatten fr) — 1×1 frame to a scalar (`AstFlatten.java`)."""
    if fr.nrow != 1 or fr.ncol != 1:
        raise ValueError("flatten requires a 1x1 frame")
    return getrow(fr)[0]


# ---------------------------------------------------------------------------
# time (`prims/time/Ast{AsDate,Week,*TimeZone}.java`)
# ---------------------------------------------------------------------------
_TZ = ["UTC"]  # process-wide like the reference's ParseTime.setTimezone


def _java_fmt_to_strptime(fmt: str) -> str:
    """SimpleDateFormat pattern → strptime (the subset h2o clients use)."""
    out, i = [], 0
    table = [("yyyy", "%Y"), ("yy", "%y"), ("MMM", "%b"), ("MM", "%m"),
             ("dd", "%d"), ("HH", "%H"), ("mm", "%M"), ("ss", "%S"),
             ("SSS", "%f")]
    while i < len(fmt):
        for pat, rep in table:
            if fmt.startswith(pat, i):
                out.append(rep)
                i += len(pat)
                break
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


def as_date(v: Vec, fmt: str, device=None) -> Vec:
    """(as.Date col format) — parse string/categorical to ms-since-epoch."""
    pyfmt = _java_fmt_to_strptime(fmt)
    if v.is_string():
        vals = v.host_data
    elif v.is_categorical():
        vals = level_strings(v)
    else:
        raise ValueError("as.Date expects a string or categorical column")
    out = np.full(v.nrow, np.nan, dtype=np.float64)
    for i, s in enumerate(vals):
        if s is None:
            continue
        try:
            dt = _dt.datetime.strptime(str(s), pyfmt)
            out[i] = dt.replace(tzinfo=_dt.timezone.utc).timestamp() * 1000.0
        except ValueError:
            pass
    return Vec.from_numpy(out, type=T_TIME,
                          device=device_of(v, device=device))


def week(v: Vec) -> Vec:
    """(week col) — ISO week-of-year from an ms-since-epoch column."""
    ms = v.to_numpy()
    out = np.full(v.nrow, np.nan)
    ok = ~np.isnan(ms)
    days = (ms[ok] / 86400000.0).astype(np.int64)
    dates = np.array(["1970-01-01"], dtype="datetime64[D]")[0] + days
    out[ok] = [float(d.astype(_dt.date).isocalendar()[1]) for d in dates]
    return Vec.from_numpy(out, type=T_INT, device=v.device)


def list_timezones() -> Frame:
    try:
        import zoneinfo
        zones = sorted(zoneinfo.available_timezones())
    except Exception:
        zones = ["UTC"]
    return Frame(["Timezones"], [Vec.from_numpy(np.array(zones, dtype=object))])


def get_timezone() -> Frame:
    return Frame(["Timezone"],
                 [Vec.from_numpy(np.array([_TZ[0]], dtype=object))])


def set_timezone(tz: str) -> None:
    _TZ[0] = str(tz)


# ---------------------------------------------------------------------------
# timeseries (`prims/timeseries/AstIsax.java`)
# ---------------------------------------------------------------------------
def isax(fr: Frame, num_words: int, max_cardinality: int,
         optimize_card: bool = False) -> Frame:
    """(isax fr numWords maxCardinality optimizeCard) — symbolic aggregate
    approximation per row: z-normalize, PAA into num_words means, discretize
    by standard-normal breakpoints into max_cardinality symbols."""
    num_words, max_cardinality = int(num_words), int(max_cardinality)
    if num_words <= 0 or max_cardinality <= 0:
        raise ValueError("numWords and maxCardinality must be greater than 0")
    X = fr.as_matrix()[: fr.nrow].cpu().numpy()
    mu = np.nanmean(X, axis=1, keepdims=True)
    sd = np.nanstd(X, axis=1, keepdims=True)
    Z = (X - mu) / np.where(sd > 0, sd, 1.0)
    ncol = Z.shape[1]
    # PAA: mean per word over a near-even column partition
    bounds = np.linspace(0, ncol, num_words + 1).astype(int)
    paa = np.stack([np.nanmean(Z[:, bounds[w]:max(bounds[w + 1], bounds[w] + 1)],
                               axis=1)
                    for w in range(num_words)], axis=1)
    # N(0,1) quantile breakpoints, cardinality-1 cuts (Acklam-style inverse
    # via scipy-free erfinv: Φ⁻¹(p) = √2·erfinv(2p−1))
    from math import sqrt

    from scipy.special import erfinv
    cuts = sqrt(2.0) * erfinv(
        2 * np.arange(1, max_cardinality) / max_cardinality - 1)
    symbols = np.digitize(paa, cuts)
    names = [f"c{i}" for i in range(num_words)]
    out = Frame(
        ["iSax_index"],
        [Vec.from_numpy(np.array(
            ["_".join(f"{int(s)}^{max_cardinality}" for s in row)
             for row in symbols], dtype=object))])
    for j, n in enumerate(names):
        out.add(n, Vec.from_numpy(symbols[:, j].astype(np.float64),
                                  device=fr.device))
    return out


# ---------------------------------------------------------------------------
# tf-idf (`prims/advmath/AstTfIdf.java`)
# ---------------------------------------------------------------------------
def _str_values(v: Vec) -> list:
    if v.is_string():
        return list(v.host_data)
    if v.is_categorical():
        return list(level_strings(v))
    raise ValueError("expected a string/categorical column")


def tf_idf(fr: Frame, doc_id_idx: int, text_idx: int, preprocess: bool = True,
           case_sensitive: bool = True) -> Frame:
    """(tf-idf fr doc_id_idx text_idx preprocess case_sensitive) — output
    [DocID, Word, TF, IDF, TF-IDF]; IDF = log((N+1)/(df+1)) like the
    reference's InverseDocumentFrequencyTask."""
    doc_ids = fr.vec(int(doc_id_idx)).to_numpy()
    texts = _str_values(fr.vec(int(text_idx)))
    pairs: dict[tuple, int] = {}
    docs_of_word: dict[str, set] = {}
    all_docs = set()
    for d, t in zip(doc_ids, texts):
        if t is None or np.isnan(d):
            continue
        d = float(d)
        all_docs.add(d)
        words = str(t).split() if preprocess else [str(t)]
        for w in words:
            if not case_sensitive:
                w = w.lower()
            pairs[(d, w)] = pairs.get((d, w), 0) + 1
            docs_of_word.setdefault(w, set()).add(d)
    N = len(all_docs)
    rows = sorted(pairs.items())
    doc_col = np.array([k[0] for k, _ in rows])
    words = [k[1] for k, _ in rows]
    tf = np.array([c for _, c in rows], dtype=np.float64)
    idf = np.array([np.log((N + 1.0) / (len(docs_of_word[w]) + 1.0))
                    for w in words])
    dev = fr.device
    return Frame(
        ["DocID", "Word", "TF", "IDF", "TF-IDF"],
        [Vec.from_numpy(doc_col, device=dev),
         Vec.from_numpy(np.array(words, dtype=object)),
         Vec.from_numpy(tf, type=T_INT, device=dev),
         Vec.from_numpy(idf, device=dev),
         Vec.from_numpy(tf * idf, device=dev)])


# ---------------------------------------------------------------------------
# string (`prims/string/AstCountSubstringsWords.java`)
# ---------------------------------------------------------------------------
def num_valid_substrings(v: Vec, words_path: str, device=None) -> Vec:
    """(num_valid_substrings col "words_file") — count substrings (len ≥ 2)
    present in the dictionary file."""
    with open(words_path) as f:
        words = set(w.strip() for w in f if w.strip())
    if v.is_string():
        vals = v.host_data
    elif v.is_categorical():
        vals = level_strings(v)
    else:
        raise ValueError("num_valid_substrings expects a string column")
    out = np.full(v.nrow, np.nan)
    for i, s in enumerate(vals):
        if s is None:
            continue
        s = str(s)
        out[i] = float(sum(
            1 for a in range(len(s)) for b in range(a + 2, len(s) + 1)
            if s[a:b] in words))
    return Vec.from_numpy(out, type=T_INT, device=device_of(v, device=device))


def grouped_permute(fr: Frame, perm_col: int, gb_cols: list, permute_by: int,
                    keep_col: int) -> Frame:
    """`AstGroupedPermute` — for each group (first groupBy column), pair
    every type-'D' row against every non-'D' row (the permuteBy column's
    domain decides the type, exactly the Java's ``dom[..].equals("D")``):
    amounts (keepCol) sum per distinct permCol id within a type, and the
    output is the per-group cross product [group, In, Out, InAmnt, OutAmnt]
    with In/Out carrying permCol's domain."""
    names = list(fr.names)
    gb = gb_cols[0]
    dom = fr.vec(names[permute_by]).domain
    if not dom:
        raise ValueError("grouped_permute: the permuteBy column must be "
                         "categorical (its domain decides the D/C split)")
    gvals = fr.vec(names[gb]).to_numpy()
    rids = fr.vec(names[perm_col]).to_numpy()
    types = fr.vec(names[permute_by]).to_numpy()
    amnts = fr.vec(names[keep_col]).to_numpy()
    groups: dict = {}
    for i in range(fr.nrow):
        if np.isnan(gvals[i]) or np.isnan(rids[i]):
            continue
        jid = int(gvals[i])
        t = 0 if (not np.isnan(types[i])
                  and dom[int(types[i])] == "D") else 1
        d = groups.setdefault(jid, ({}, {}))[t]
        rid = float(rids[i])
        if rid in d:
            d[rid] += float(amnts[i])
        else:
            d[rid] = float(amnts[i])
    rows = []
    for jid in groups:
        d0, d1 = groups[jid]
        for r0, a0 in d0.items():
            for r1, a1 in d1.items():
                rows.append([float(jid), r0, r1, a0, a1])
    A = (np.array(rows, dtype=np.float64) if rows
         else np.zeros((0, 5), np.float64))
    out_names = [names[gb], "In", "Out", "InAmnt", "OutAmnt"]
    perm_dom = fr.vec(names[perm_col]).domain
    keep_dom = fr.vec(names[keep_col]).domain
    doms = [fr.vec(names[gb]).domain, perm_dom, perm_dom, keep_dom, keep_dom]
    vecs = []
    for j, (nm, dm) in enumerate(zip(out_names, doms)):
        col = A[:, j].astype(np.float32)
        vecs.append(Vec.from_numpy(col, type=T_CAT, domain=list(dm),
                                   device=fr.device)
                    if dm else Vec.from_numpy(col, device=fr.device))
    return Frame(out_names, vecs)
