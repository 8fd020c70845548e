"""Rapids.exec — the Lisp-ish expression evaluator behind `/99/Rapids`
(``h2o_tpu/rapids/exec.py``).

Analog of `water/rapids/Rapids.java:60,86` (tokenizer/parser) +
`water/rapids/ast/AstExec.java` (apply) + `water/rapids/Session.java`
(ref-counted result tracking). Clients submit strings like

    (tmp= py_1 (cols_py higgs [0 3]))
    (mean (cols frame_key 'x') true)
    (:= fr (* (cols fr 'x') 2) 1 [])

The grammar (`Rapids.java` class comment): ``( )`` applies a primitive;
``[ ]`` is a number/string list; numbers, ``'str'``/``"str"`` strings, ids
reference env/DKV objects; ``tmp=``/``:=`` assign.

Primitives dispatch onto the rapids ops (ops/groupby/merge/mungers/strings/
advmath/fairness) — the evaluator is a thin host-side shim; bulk work runs
on the device of the frames it is given. The ``Session``'s ``device``
(None -> ``cuda``) places the columns a primitive makes from nothing or
from host strings. The prim table has the reference's 195 names.
"""

from __future__ import annotations

import numpy as np

from ..backend.kvstore import STORE
from ..frame.frame import Frame
from ..frame.vec import T_STR, Vec
from . import advmath
from . import mungers
from . import strings as strmod
from .groupby import group_by
from .merge import merge as merge_fn, sort as sort_fn
from .ops import (binop, cumulative, ifelse, reduce_op, round_digits, signif,
                  table, time_part, unique, unop)


# ---------------------------------------------------------------------------
# session (`water/rapids/Session.java`)
# ---------------------------------------------------------------------------
class Session:
    """Holds temp results (`tmp=`) between Rapids calls; `end()` sweeps.
    ``device`` places the columns primitives make from nothing (``seq``,
    ``moment``) or from host strings (``nchar``, ``as.Date``)."""

    def __init__(self, session_id: str | None = None, device=None):
        self.id = session_id or f"session_{np.random.randint(1 << 30)}"
        self.temps: dict[str, object] = {}
        self.device = device

    def lookup(self, name: str):
        if name in self.temps:
            return self.temps[name]
        return STORE.get(name)

    def assign(self, name: str, value):
        if isinstance(value, Vec):
            # a keyed temp is always frame-shaped (the reference's tmp= puts
            # a Frame in DKV even for single-Vec expression results)
            value = _as_frame(value)
        self.temps[name] = value
        if isinstance(value, Frame):
            value.key = name
            STORE.put(name, value)
        return value

    def end(self):
        for k in self.temps:
            STORE.remove(k, cascade=False)
        self.temps.clear()


# ---------------------------------------------------------------------------
# tokenizer / parser (`Rapids.java:86` parse)
# ---------------------------------------------------------------------------
class _Parser:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def peek(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1
        return self.s[self.i] if self.i < len(self.s) else ""

    def parse(self):
        c = self.peek()
        if c == "(":
            return self._list(")", "exec")
        if c == "[":
            return self._list("]", "list")
        if c == "{":
            return self._list("}", "fun")
        if c in "'\"":
            return self._string(c)
        return self._token()

    def _list(self, close, kind):
        self.i += 1  # consume open
        items = []
        while self.peek() != close:
            if self.peek() == "":
                raise ValueError(f"unbalanced rapids expression: {self.s}")
            items.append(self.parse())
        self.i += 1  # consume close
        return (kind, items)

    def _string(self, q):
        self.i += 1
        out = []
        while self.i < len(self.s) and self.s[self.i] != q:
            if self.s[self.i] == "\\":
                self.i += 1
            out.append(self.s[self.i])
            self.i += 1
        self.i += 1
        return ("str", "".join(out))

    def _token(self):
        j = self.i
        while j < len(self.s) and not self.s[j].isspace() and self.s[j] not in "()[]{}":
            j += 1
        tok, self.i = self.s[self.i:j], j
        if not tok:
            raise ValueError(f"parse error at {self.i} in {self.s!r}")
        try:
            return ("num", float(tok))
        except ValueError:
            pass
        if ":" in tok and tok not in (":=",):  # 0:10 span
            lo, _, hi = tok.partition(":")
            try:
                return ("span", (int(lo), int(hi)))
            except ValueError:
                pass
        return ("id", tok)


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------
def _as_vec(x, nrow=None):
    if isinstance(x, Frame):
        if x.ncol != 1:
            raise ValueError("expected a single-column frame")
        return x.vec(0)
    return x


def _as_frame(x) -> Frame:
    if isinstance(x, Vec):
        return Frame([getattr(x, "key", None) or "C1"], [x])
    if not isinstance(x, Frame):
        raise ValueError(f"expected frame, got {type(x).__name__}")
    return x


def _col_indices(fr: Frame, sel) -> list[int]:
    if isinstance(sel, float):
        return [int(sel)]
    if isinstance(sel, str):
        return [fr.names.index(sel)]
    if isinstance(sel, tuple) and len(sel) == 2:  # span
        return list(range(sel[0], sel[1]))
    if isinstance(sel, list):
        out = []
        for s in sel:
            out.extend(_col_indices(fr, s))
        return out
    raise ValueError(f"bad column selector {sel!r}")


def _row_mask(fr: Frame, sel) -> np.ndarray | None:
    """None = all rows; else bool mask or index list."""
    if isinstance(sel, list) and not sel:
        return None
    if isinstance(sel, Frame):
        sel = _as_vec(sel)
    if isinstance(sel, Vec):
        m = sel.to_numpy()
        if set(np.unique(m[~np.isnan(m)])) <= {0.0, 1.0}:
            return ~np.isnan(m) & (m == 1.0)
        return m[~np.isnan(m)].astype(np.int64)
    if isinstance(sel, float):
        return np.asarray([int(sel)])
    if isinstance(sel, tuple):
        return np.arange(sel[0], sel[1])
    if isinstance(sel, list):
        out: list = []
        for _x in sel:
            if isinstance(_x, tuple):  # [a:b] span inside a list
                out.extend(range(_x[0], _x[1]))
            else:
                out.append(int(_x))
        return np.asarray(out, dtype=np.int64)
    return None


def _subset_rows(fr: Frame, rows) -> Frame:
    """The selected rows; past the last row, NA rows (`AstRows`)."""
    if rows is None:
        return fr
    idx = np.where(rows)[0] if rows.dtype == bool else rows
    oob = (idx < 0) | (idx >= fr.nrow)
    if not oob.any():
        return fr.take(idx)
    # h2o semantics: selecting past the last row yields NA rows, not an
    # error (`AstRows` reads beyond the Vec as NA)
    out = fr.take(np.clip(idx, 0, max(fr.nrow - 1, 0)))
    from ..frame.vec import Vec as _Vec

    for name in list(out.names):
        v = out.vec(name)
        if v.is_string():
            hd = v.host_data.copy()
            hd[oob] = None
            out.replace(name, _Vec(None, len(idx), type=v.type,
                                   host_data=hd))
        else:
            x = v.to_numpy().astype(np.float64)
            x[oob] = np.nan
            out.replace(name, _Vec.from_numpy(x, type=v.type,
                                              domain=v.domain,
                                              device=v.device))
    return out


class Rapids:
    """Evaluator instance bound to a Session."""

    def __init__(self, session: Session | None = None):
        self.session = session or Session()
        self._scopes: list[dict] = []  # lambda parameter bindings

    @property
    def device(self):
        """The session's device for new columns (None -> ``cuda``, resolved
        where a column is made)."""
        return self.session.device

    # -- public entry (`Rapids.exec`) ----------------------------------------
    def exec(self, expr: str):
        ast = _Parser(expr).parse()
        return self._eval(ast)

    # -- eval ----------------------------------------------------------------
    def _eval(self, node):
        kind, val = node
        if kind == "num":
            return val
        if kind == "str":
            return val
        if kind == "span":
            return val
        if kind == "list":
            return [self._eval(x) for x in val]
        if kind == "fun":
            # { id1 id2 . body } — `water/rapids/ast/AstFunction.java`
            params, body, seen_dot = [], None, False
            for item in val:
                if item == ("id", "."):
                    seen_dot = True
                elif not seen_dot:
                    params.append(item[1])
                else:
                    body = item
            if body is None:
                raise ValueError("lambda without body: { ids . expr }")
            return RLambda(self, params, body)
        if kind == "id":
            lit = {"true": 1.0, "TRUE": 1.0, "True": 1.0,
                   "false": 0.0, "FALSE": 0.0, "False": 0.0,
                   "NA": float("nan"), "NaN": float("nan"),
                   "null": None, "None": None,
                   "_": None}  # h2o-py placeholder for defaulted args
            if val in lit:
                return lit[val]
            for scope in reversed(self._scopes):
                if val in scope:
                    return scope[val]
            obj = self.session.lookup(val)
            if obj is None:
                raise KeyError(f"rapids: unknown id '{val}'")
            return obj
        if kind == "exec":
            if not val:
                raise ValueError("empty () application")
            opkind, opname = val[0]
            if opkind != "id":
                raise ValueError(f"cannot apply {val[0]!r}")
            return self._apply(opname, val[1:])
        raise ValueError(f"bad ast node {node!r}")

    def _apply(self, op, raw_args):
        # assignment forms keep their first arg un-evaluated (a fresh name)
        if op in ("tmp=", "assign"):
            name = raw_args[0][1]
            value = self._eval(raw_args[1])
            return self.session.assign(name, value)
        if op == "rm":
            name = raw_args[0][1]
            self.session.temps.pop(name, None)
            STORE.remove(name, cascade=False)
            return None
        args = [self._eval(a) for a in raw_args]
        fn = _PRIMS.get(op)
        if fn is None:
            raise ValueError(f"rapids: unimplemented primitive '{op}'")
        return fn(self, *args)


class RLambda:
    """A parsed `{ ids . body }` function value (`AstFunction.java`)."""

    def __init__(self, rapids: "Rapids", params: list[str], body):
        self.rapids = rapids
        self.params = params
        self.body = body

    def __call__(self, *vals):
        self.rapids._scopes.append(dict(zip(self.params, vals)))
        try:
            return self.rapids._eval(self.body)
        finally:
            self.rapids._scopes.pop()


# row-wise vectorized fast path for `apply` margin=1 lambdas of the form
# { x . (op x [na_rm]) } — one fused reduction instead of a per-row loop.
# Keyed (op, na_rm) so NA semantics match _prim_reduce exactly: na_rm=False
# (the reducer default) propagates NaN through the row.
_ROW_REDUCERS = {
    ("mean", True): lambda M: np.nanmean(M, axis=1),
    ("mean", False): lambda M: np.mean(M, axis=1),
    ("sum", True): lambda M: np.nansum(M, axis=1),
    ("sum", False): lambda M: np.sum(M, axis=1),
    ("min", True): lambda M: np.nanmin(M, axis=1),
    ("min", False): lambda M: np.min(M, axis=1),
    ("max", True): lambda M: np.nanmax(M, axis=1),
    ("max", False): lambda M: np.max(M, axis=1),
    ("median", True): lambda M: np.nanmedian(M, axis=1),
    ("median", False): lambda M: np.median(M, axis=1),
    ("sd", True): lambda M: np.nanstd(M, axis=1, ddof=1),
    ("sd", False): lambda M: np.std(M, axis=1, ddof=1),
    ("var", True): lambda M: np.nanvar(M, axis=1, ddof=1),
    ("var", False): lambda M: np.var(M, axis=1, ddof=1),
}

_NA_RM_LITERALS = {("id", "true"): True, ("id", "TRUE"): True,
                   ("id", "True"): True, ("num", 1.0): True,
                   ("id", "false"): False, ("id", "FALSE"): False,
                   ("id", "False"): False, ("num", 0.0): False}


def _apply(R, fr, margin, fun):
    """(apply fr margin fun) — `AstApply.java`: 1 = rows, 2 = columns."""
    fr = _as_frame(fr)
    dev = fr.device or R.device
    margin = int(margin)
    if not isinstance(fun, RLambda):
        raise ValueError("apply expects a function {x . body}")
    if margin == 2:
        results = [fun(Frame([n], [fr.vec(n)])) for n in fr.names]
        if all(isinstance(r, (int, float)) for r in results):
            return Frame(fr.names, [Vec.from_numpy(np.asarray([r]),
                                                   device=dev)
                                    for r in results])
        cols = []
        for n, r in zip(fr.names, results):
            v = _as_vec(r) if isinstance(r, (Frame, Vec)) else Vec.from_numpy(
                np.asarray([float(r)]), device=dev)
            cols.append(v)
        nr = max(v.nrow for v in cols)
        cols = [v if v.nrow == nr else Vec.from_numpy(
            np.resize(v.to_numpy(), nr), device=dev) for v in cols]
        return Frame(list(fr.names), cols)
    if margin != 1:
        raise ValueError("apply margin must be 1 (rows) or 2 (cols)")
    body = fun.body
    if (body[0] == "exec" and len(body[1]) in (2, 3)
            and body[1][1] == ("id", fun.params[0])
            and (len(body[1]) == 2 or body[1][2] in _NA_RM_LITERALS)):
        na_rm = (_NA_RM_LITERALS[body[1][2]] if len(body[1]) == 3
                 else False)  # _prim_reduce's na_rm default
        red = _ROW_REDUCERS.get((body[1][0][1], na_rm))
        if red is not None:
            M = fr.as_matrix()[: fr.nrow].cpu().numpy()
            return Frame(["apply"], [Vec.from_numpy(red(M), device=dev)])
    # general path: per-row evaluation (host loop; reference runs an MRTask).
    # The row binds as a single column of its values (ValRow semantics: row
    # reducers fold across the row's cells).
    M = fr.as_matrix()[: fr.nrow].cpu().numpy()
    rows = []
    for i in range(fr.nrow):
        r = fun(Frame(["row"], [Vec.from_numpy(M[i, :], device=dev)]))
        if isinstance(r, (Frame, Vec)):
            r = [float(x) for x in _as_vec(r).to_numpy()]
        rows.append(r if isinstance(r, list) else [float(r)])
    width = max(len(r) for r in rows)
    out = np.full((fr.nrow, width), np.nan)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return Frame([f"C{j + 1}" for j in range(width)] if width > 1
                 else ["apply"],
                 [Vec.from_numpy(out[:, j], device=dev)
                  for j in range(width)])


def _ddply(R, fr, group_cols, fun):
    """(ddply fr [cols] fun) — per-group lambda results (`AstDdply.java`)."""
    fr = _as_frame(fr)
    dev = fr.device or R.device
    if not isinstance(fun, RLambda):
        raise ValueError("ddply expects a function {x . body}")
    gidx = _col_indices(fr, group_cols)
    keys = [fr.vec(i).to_numpy() for i in gidx]
    tags = {}
    for r in range(fr.nrow):
        t = tuple(np.nan if np.isnan(k[r]) else float(k[r]) for k in keys)
        tags.setdefault(t, []).append(r)
    grows, rrows = [], []
    for t, idx in sorted(tags.items(),
                         key=lambda kv: tuple(
                             (np.inf if x != x else x) for x in kv[0])):
        sub = fr.take(np.asarray(idx))
        r = fun(sub)
        if isinstance(r, (Frame, Vec)):
            r = [float(x) for x in _as_vec(r).to_numpy()]
        grows.append(list(t))
        rrows.append(r if isinstance(r, list) else [float(r)])
    width = max(len(r) for r in rrows) if rrows else 1
    names = [fr.names[i] for i in gidx] + [f"ddply_C{j + 1}"
                                           for j in range(width)]
    cols = []
    for j in range(len(gidx)):
        src = fr.vec(gidx[j])
        cols.append(Vec.from_numpy(
            np.asarray([g[j] for g in grows], dtype=np.float32),
            type=src.type, domain=src.domain, device=dev))
    for j in range(width):
        cols.append(Vec.from_numpy(np.asarray(
            [r[j] if j < len(r) else np.nan for r in rrows]), device=dev))
    return Frame(names, cols)


def _append_prim(R, dst, *rest):
    """(append dst (src name)+ ) — `AstAppend.java`."""
    out = _as_frame(dst)
    if len(rest) % 2:
        raise ValueError("append needs (src, name) pairs")
    for i in range(0, len(rest), 2):
        out = mungers.append(out, rest[i], str(rest[i + 1]),
                             device=R.device)
    return out


def _rect_assign_prim(R, dst, src, cols, rows=None):
    """(:= dst src col_expr row_expr) — `AstRectangleAssign.java`."""
    fr = _as_frame(dst)
    cidx = _col_indices(fr, cols) if cols not in ([],) else []
    if not cidx:  # "empty really means all"
        cidx = list(range(fr.ncol))
    return mungers.rectangle_assign(fr, src, cidx, _row_mask(fr, rows))


def _merge_prim(R, l, r, all_l=False, all_r=False, by_l=None, by_r=None,
                method="auto"):
    """(merge l r all_x all_y [bx] [by] method) — `AstMerge.java`. Explicit
    by-columns come as index lists; differently-named right keys are
    realigned onto the left names before the join."""
    lf, rf = _as_frame(l), _as_frame(r)
    bx = _col_indices(lf, by_l) if by_l not in (None, []) else None
    by_ = _col_indices(rf, by_r) if by_r not in (None, []) else None
    by_names = None
    if bx:
        by_names = [lf.names[i] for i in bx]
        if by_:
            if len(by_) != len(bx):
                raise ValueError("merge: by_x and by_y lengths differ")
            rnames = list(rf.names)
            for li, ri in zip(bx, by_):
                rnames[ri] = lf.names[li]
            rf = Frame(rnames, list(rf.vecs))
    return merge_fn(lf, rf, by=by_names,
                    all_x=bool(all_l), all_y=bool(all_r))


def _rename_key(R, old: str, new: str):
    """(rename "old" "new") — rename a DKV key (`AstRename.java`)."""
    obj = R.session.lookup(old)
    if obj is None:
        raise KeyError(f"rename: no such key '{old}'")
    R.session.temps.pop(old, None)
    STORE.remove(old, cascade=False)
    obj.key = new
    STORE.put(new, obj)
    return float("nan")


def _sumaxis(fr: Frame, na_rm: bool, axis: int):
    """(sumaxis fr na_rm axis) — per-column (0) or per-row (1) sums."""
    M = fr.as_matrix()[: fr.nrow].cpu().numpy()
    red = np.nansum if na_rm else np.sum
    if axis == 1:
        return Frame(["sum"], [Vec.from_numpy(red(M, axis=1),
                                              device=fr.device)])
    return Frame(list(fr.names),
                 [Vec.from_numpy(np.asarray([red(M[:, j])]),
                                 device=fr.device)
                  for j in range(fr.ncol)])


# ---------------------------------------------------------------------------
# primitive table (`water/rapids/ast/prims/**` subset)
# ---------------------------------------------------------------------------
# numpy ufuncs so scalar edge cases match the vector path: (/ 1 0) → inf,
# (%% x 0) → nan, (^ -1 0.5) → nan — never a Python ZeroDivisionError
_SCALAR_BINOPS = {
    "+": np.add, "-": np.subtract, "*": np.multiply, "/": np.divide,
    "^": np.float_power, "%%": np.fmod,  # Java %: sign follows dividend
    # operands truncate BEFORE the divide (AstIntDiv: `(int) l / (int) r`)
    "intDiv": lambda a, b: np.where(np.trunc(b) == 0, np.nan,
                                    np.trunc(np.trunc(a) / np.trunc(b))),
    "%/%": lambda a, b: np.where(b == 0, np.nan, np.trunc(np.divide(a, b))),
    "==": np.equal, "!=": np.not_equal,
    "<": np.less, "<=": np.less_equal,
    ">": np.greater, ">=": np.greater_equal,
    "&": lambda a, b: (a != 0) & (b != 0),
    "|": lambda a, b: (a != 0) | (b != 0),
    "&&": lambda a, b: (a != 0) & (b != 0),
    "||": lambda a, b: (a != 0) | (b != 0),
}


def _prim_binop(op):
    def fn(R, l, r):
        if isinstance(l, (int, float)) and isinstance(r, (int, float)):
            with np.errstate(divide="ignore", invalid="ignore"):
                return float(_SCALAR_BINOPS[op](np.float64(l),
                                                np.float64(r)))
        # multi-column frames apply column-wise (`AstBinOp.frame_op_frame`)
        lm = isinstance(l, Frame) and l.ncol > 1
        rm = isinstance(r, Frame) and r.ncol > 1
        if lm or rm:
            n = l.ncol if lm else r.ncol
            if lm and rm and r.ncol != n:
                raise ValueError(
                    f"binop '{op}': frames have {l.ncol} vs {r.ncol} columns")
            vecs = [binop(op,
                          l.vec(i) if lm else _as_vec(l)
                          if isinstance(l, (Frame, Vec)) else l,
                          r.vec(i) if rm else _as_vec(r)
                          if isinstance(r, (Frame, Vec)) else r)
                    for i in range(n)]
            return Frame(list((l if lm else r).names), vecs)
        return binop(op, _as_vec(l), _as_vec(r))
    return fn


def _prim_unop(op, rename=None):
    """``rename``: per-column output naming (AstIsNa's "isNA(col)")."""
    def fn(R, v):
        if isinstance(v, Frame) and v.ncol > 1:
            names = [rename(n) if rename else n for n in v.names]
            return Frame(names, [unop(op, v.vec(i), device=R.device)
                                 for i in range(v.ncol)])
        out = unop(op, _as_vec(v), device=R.device)
        if rename and isinstance(v, Frame):
            return Frame([rename(v.names[0])], [out])
        return out
    return fn


def _prim_reduce(op):
    def fn(R, v, na_rm=False):
        fr = _as_frame(v)
        vals = [reduce_op(op, fr.vec(i), na_rm=bool(na_rm))
                for i in range(fr.ncol)]
        return vals[0] if len(vals) == 1 else vals
    return fn


def _cols(R, fr, sel):
    fr = _as_frame(fr)
    idx = _col_indices(fr, sel)
    return fr.subframe([fr.names[i] for i in idx])


def _rows(R, fr, sel):
    return _subset_rows(_as_frame(fr), _row_mask(_as_frame(fr), sel))


def _cbind(R, *frs):
    names, vecs = [], []
    for f in frs:
        f = _as_frame(f)
        for n in f.names:
            nm, k = n, 1
            while nm in names:
                nm, k = f"{n}{k}", k + 1
            names.append(nm)
            vecs.append(f.vec(n))
    return Frame(names, vecs)


def _rbind(R, *frs):
    frs = [_as_frame(f) for f in frs]
    return frs[0].concat_rows(*frs[1:])


def _colnames(R, fr, idxs, names):
    fr = _as_frame(fr)
    idx = _col_indices(fr, idxs)
    new = names if isinstance(names, list) else [names]
    out = Frame(fr.names, fr.vecs)
    for i, nm in zip(idx, new):
        out._names[i] = str(nm)
    return out


def _group_by(R, fr, by, *aggspec):
    fr = _as_frame(fr)
    by_names = [fr.names[i] for i in _col_indices(fr, list(by))]
    aggs = []
    for i in range(0, len(aggspec), 3):
        agg, col, na = aggspec[i], aggspec[i + 1], aggspec[i + 2]
        col_name = fr.names[_col_indices(fr, col)[0]]
        aggs.append((agg, col_name, na))
    return group_by(fr, by_names, aggs)


def _w2v_to_frame(m, device) -> Frame:
    """`water/rapids/ast/prims/models/AstWord2VecToFrame` — dump a word2vec
    model's learned embeddings as a frame of [Word, V1..VD]."""
    words = sorted(m.vocab, key=m.vocab.get)
    W = np.asarray(m.vectors)
    vecs = [Vec(None, len(words), type=T_STR,
                host_data=np.array(words, dtype=object))]
    names = ["Word"] + [f"V{j + 1}" for j in range(W.shape[1])]
    for j in range(W.shape[1]):
        vecs.append(Vec.from_numpy(W[[m.vocab[w] for w in words], j]
                                   .astype(np.float32), device=device))
    return Frame(names, vecs)


def _resolve_model(obj):
    m = STORE.get(obj) if isinstance(obj, str) else obj
    if m is None:
        raise KeyError(f"rapids: unknown model '{obj}'")
    return m


def _reset_threshold_prim(R, model, threshold):
    """`AstModelResetThreshold`: swap the binomial decision threshold used
    for the predict label, returning the old one."""
    m = _resolve_model(model)
    old = float(getattr(m, "default_threshold", 0.5))
    m.default_threshold = float(threshold)
    return old


def _table_to_frame(t, device) -> Frame:
    cols = list(zip(*t.cell_values)) if t.cell_values else [
        () for _ in t.col_header]
    vecs, names = [], []
    for name, ctype, col in zip(t.col_header, t.col_types, cols):
        names.append(name)
        if ctype in ("string",):
            vecs.append(Vec(None, len(col), type="string",
                            host_data=np.asarray(col, dtype=object)))
        else:
            vecs.append(Vec.from_numpy(np.asarray(
                [np.nan if v is None else float(v) for v in col],
                np.float32), device=device))
    return Frame(names, vecs)


def _permutation_varimp_prim(R, model, fr, metric="AUTO", n_repeats=1,
                             seed=-1):
    """`AstPermutationVarImp` role: the PVI table as a frame."""
    m = _resolve_model(model)
    fr = _as_frame(fr)
    t = m.permutation_importance(fr, metric=str(metric),
                                 n_repeats=int(n_repeats), seed=int(seed))
    return _table_to_frame(t, fr.device)


def _make_leaderboard_prim(R, obj, lb_frame=None, sort_metric=None, *rest):
    """`AstMakeLeaderboard` role: leaderboard frame from an AutoML run (by
    key) or an explicit list of model keys, optionally re-scored on a
    leaderboard frame and sorted by a named metric."""
    from ..models.automl import H2OAutoML, Leaderboard

    if isinstance(obj, str) and isinstance(STORE.get(obj), H2OAutoML):
        return STORE.get(obj).leaderboard.as_frame()
    keys = obj if isinstance(obj, list) else [obj]
    if not keys:
        raise ValueError("makeLeaderboard: no models given")
    models = [_resolve_model(k) for k in keys]
    sm = (str(sort_metric) if sort_metric not in (None, "", "AUTO", "auto")
          else None)
    overrides: dict = {}
    if lb_frame not in (None, ""):
        # rank on metrics recomputed against the supplied frame, without
        # mutating the models' stored metrics
        fr = _as_frame(lb_frame if not isinstance(lb_frame, str)
                       else STORE.get(lb_frame))
        overrides = {m.key: m.model_performance(fr) for m in models}

    class _FrameScoredLB(Leaderboard):
        def _metric(self, m, name):
            mm = overrides.get(m.key)
            if mm is None:
                return super()._metric(m, name)
            v = getattr(mm, name, None)
            return (None if v is None
                    or (isinstance(v, float) and np.isnan(v)) else v)

    lb = _FrameScoredLB(models[0].output.model_category, sm,
                        device=R.device)
    for m in models:
        lb.add(m)
    return lb.as_frame()


_PRIMS = {
    # math / comparison
    **{op: _prim_binop(op) for op in
       ("+", "-", "*", "/", "^", "%%", "intDiv", "==", "!=", "<", "<=", ">",
        ">=", "&", "|", "&&", "||")},
    **{op: _prim_unop(op) for op in
       ("abs", "ceiling", "floor", "trunc", "exp", "expm1", "log", "log10",
        "log2", "log1p", "sqrt", "sin", "cos", "tan", "asin", "acos", "atan",
        "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "sign", "not",
        "gamma", "lgamma", "digamma", "trigamma", "cospi", "sinpi", "tanpi")},
    "is.na": _prim_unop("isna", rename=lambda n: f"isNA({n})"),
    **{op: _prim_reduce(op) for op in
       ("min", "max", "sum", "mean", "median", "sd", "var", "prod", "all",
        "any")},
    **{op: (lambda o: (lambda R, v: cumulative(o, _as_vec(v))))(op)
       for op in ("cumsum", "cumprod", "cummin", "cummax")},
    "round": lambda R, v, d=0: round_digits(_as_vec(v), int(d)),
    "signif": lambda R, v, d=6: signif(_as_vec(v), int(d)),
    "ifelse": lambda R, t, y, n: ifelse(_as_vec(t), _as_vec(y, 0) if isinstance(y, (Vec, Frame)) else y,
                                        _as_vec(n, 0) if isinstance(n, (Vec, Frame)) else n),
    "table": lambda R, v: table(_as_vec(v)),
    "unique": lambda R, v: unique(_as_vec(v)),
    # munging
    "cols": _cols, "cols_py": _cols,
    "rows": _rows,
    "cbind": _cbind,
    "rbind": _rbind,
    "colnames=": _colnames,
    "nrow": lambda R, fr: float(_as_frame(fr).nrow),
    "ncol": lambda R, fr: float(_as_frame(fr).ncol),
    "is.factor": lambda R, v: float(_as_vec(v).is_categorical()),
    "as.factor": lambda R, v: strmod.asfactor(_as_vec(v), device=R.device),
    "as.numeric": lambda R, v: _asnumeric(_as_vec(v)),
    "GB": _group_by,
    "merge": _merge_prim,
    "sort": lambda R, fr, by, asc=None: sort_fn(
        _as_frame(fr),
        [_as_frame(fr).names[i] for i in _col_indices(_as_frame(fr), by)],
        None if asc is None else [bool(a) for a in (asc if isinstance(asc, list) else [asc])]),
    # strings
    "toupper": lambda R, v: strmod.toupper(_as_vec(v)),
    "tolower": lambda R, v: strmod.tolower(_as_vec(v)),
    "trim": lambda R, v: strmod.trim(_as_vec(v)),
    "nchar": lambda R, v: strmod.nchar(_as_vec(v), device=R.device),
    "sub": lambda R, pat, rep, v, ic=False: strmod.sub(_as_vec(v), pat, rep, ignore_case=bool(ic)),
    "gsub": lambda R, pat, rep, v, ic=False: strmod.gsub(_as_vec(v), pat, rep, ignore_case=bool(ic)),
    "grep": lambda R, v, pat, ic=False, inv=False, ol=True: strmod.grep(
        _as_vec(v), pat, ignore_case=bool(ic), invert=bool(inv),
        output_logical=bool(ol), device=R.device),
    "lstrip": lambda R, v, set=None: strmod.lstrip(_as_vec(v), set),
    "rstrip": lambda R, v, set=None: strmod.rstrip(_as_vec(v), set),
    "substring": lambda R, v, s, e=None: strmod.substring(
        _as_vec(v), int(s), None if e is None else int(e)),
    "replacefirst": lambda R, v, pat, rep, ic=False: strmod.sub(
        _as_vec(v), pat, rep, ignore_case=bool(ic)),
    "replaceall": lambda R, v, pat, rep, ic=False: strmod.gsub(
        _as_vec(v), pat, rep, ignore_case=bool(ic)),
    "countmatches": lambda R, v, pats: strmod.countmatches(
        _as_vec(v), pats, device=R.device),
    "strsplit": lambda R, v, pat: (lambda vs: Frame(
        [f"C{i + 1}" for i in range(len(vs))], vs))(
            strmod.strsplit(_as_vec(v), pat)),
    "entropy": lambda R, v: strmod.entropy(_as_vec(v), device=R.device),
    "strDistance": lambda R, a, b, measure="lv", ce=True: strmod.strdistance(
        _as_vec(a), _as_vec(b), measure, bool(ce), device=R.device),
    "tokenize": lambda R, v, split=" ": strmod.tokenize(_as_vec(v), split),
    "ascharacter": lambda R, v: strmod.ascharacter(_as_vec(v)),
    # time
    **{part: (lambda p: (lambda R, v: time_part(_as_vec(v), p)))(part)
       for part in ("year", "month", "day", "dayOfWeek", "hour", "minute",
                    "second", "millis")},
    "moment": lambda R, *a: advmath.moment(*a, device=R.device),
    "mktime": lambda R, *a: advmath.moment(*a, device=R.device),
    # advmath / munging (second wave, `prims/{advmath,mungers,matrix}`)
    "skewness": lambda R, v, na_rm=True: advmath.skewness(_as_vec(v)),
    "kurtosis": lambda R, v, na_rm=True: advmath.kurtosis(_as_vec(v)),
    "cor": lambda R, x, y, use="everything", method="Pearson":
        advmath.cor(_as_frame(x), _as_frame(y), use, method),
    "quantile": lambda R, fr, probs, interp="interpolate", w="_":
        advmath.quantile_frame(_as_frame(fr), probs, interp),
    "h2o.impute": lambda R, fr, col=-1, method="mean", combine="interpolate",
        by=None, gbframe=None, values=None:
        advmath.impute(_as_frame(fr), None if col is None else int(col),
                       method, combine, by, values),
    "scale": lambda R, fr, center=True, scale=True:
        advmath.scale_frame(_as_frame(fr), _maybe_list(center),
                            _maybe_list(scale)),
    "na.omit": lambda R, fr: advmath.na_omit(_as_frame(fr)),
    "h2o.fillna": lambda R, fr, method="forward", axis=0, maxlen=1:
        advmath.fillna(_as_frame(fr), method, int(axis), int(maxlen)),
    "which": lambda R, v: advmath.which(_as_vec(v)),
    "which.max": lambda R, fr, na_rm=True, axis=0:
        advmath.which_extreme(_as_frame(fr), bool(na_rm), int(axis), mx=True),
    "which.min": lambda R, fr, na_rm=True, axis=0:
        advmath.which_extreme(_as_frame(fr), bool(na_rm), int(axis), mx=False),
    "match": lambda R, v, table, nomatch=None, start=1.0:
        advmath.match(_as_vec(v), table, nomatch, float(start)),
    "cut": lambda R, v, breaks, labels=None, il=False, right=True, dig=3:
        advmath.cut(_as_vec(v), breaks, labels, bool(il), bool(right),
                    int(dig)),
    "difflag1": lambda R, v: advmath.difflag1(_as_vec(v)),
    "kfold_column": lambda R, v, n, seed=-1:
        advmath.kfold_column(_as_vec(v), int(n), seed),
    "stratified_kfold_column": lambda R, v, n, seed=-1:
        advmath.stratified_kfold_column(_as_vec(v), int(n), seed),
    "h2o.random_stratified_split": lambda R, v, frac=0.2, seed=-1:
        advmath.stratified_split(_as_vec(v), float(frac), seed),
    "levels": lambda R, fr: advmath.levels(_as_frame(fr)),
    "relevel": lambda R, v, lvl: advmath.relevel(_as_vec(v), str(lvl)),
    "setDomain": lambda R, v, *a: advmath.set_domain(_as_vec(v), a[-1]),
    "pivot": lambda R, fr, index, column, value:
        advmath.pivot(_as_frame(fr), index, column, value),
    "melt": lambda R, fr, ids, vals=None, var="variable", val="value",
        skipna=False: advmath.melt(_as_frame(fr), ids, vals, var, val,
                                   bool(skipna)),
    "t": lambda R, fr: advmath.transpose(_as_frame(fr)),
    "x*y": lambda R, x, y: advmath.mmult(_as_frame(x), _as_frame(y)),
    "rank_within_groupby": lambda R, fr, g, s, asc=None,
        name="New_Rank_column", *rest: advmath.rank_within_group_by(
            _as_frame(fr), g, s, asc, str(name)),
    "topn": lambda R, fr, col, pct, bottom=0.0:
        advmath.topn(_as_frame(fr), int(col), float(pct), bool(bottom)),
    "interaction": lambda R, fr, factors, pairwise=False, mf=100, mo=1:
        advmath.interaction(_as_frame(fr), factors, bool(pairwise), int(mf),
                            int(mo)),
    # third wave: mutation / repeaters / mungers (`prims/{assign,repeaters,
    # mungers,filters,timeseries}`)
    "append": _append_prim,
    ":=": _rect_assign_prim,
    "seq": lambda R, frm, to, by=1.0: mungers.seq(
        float(frm), float(to), float(by), device=R.device),
    "seq_len": lambda R, n: mungers.seq_len(n, device=R.device),
    "rep_len": lambda R, x, n: mungers.rep_len(x, n, device=R.device),
    "mode": lambda R, v: mungers.mode(_as_vec(v)),
    "distance": lambda R, x, y, measure="l2": mungers.distance(
        _as_frame(x), _as_frame(y), str(measure)),
    "hist": lambda R, v, breaks="sturges": mungers.hist(_as_vec(v), breaks),
    "modulo_kfold_column": lambda R, v, n: mungers.modulo_kfold_column(
        _as_vec(v), int(n)),
    "dropdup": lambda R, fr, cols, keep="first": mungers.dropdup(
        _as_frame(fr), cols, str(keep)),
    "h2o.mad": lambda R, fr, combine="interpolate", const=1.4826:
        mungers.mad(_as_frame(fr), str(combine), float(const)),
    "perfectAUC": lambda R, p, y: mungers.perfect_auc(_as_vec(p), _as_vec(y)),
    "nlevels": lambda R, v: mungers.nlevels(_as_vec(v)),
    "any.factor": lambda R, fr: mungers.any_factor(_as_frame(fr)),
    "is.character": lambda R, v: float(_as_vec(v).is_string()),
    "is.numeric": lambda R, v: float(_as_vec(v).is_numeric()
                                     and not _as_vec(v).is_categorical()),
    "columnsByType": lambda R, fr, t="numeric": mungers.columns_by_type(
        _as_frame(fr), str(t)),
    "rename": lambda R, old, new: _rename_key(R, str(old), str(new)),
    "setLevel": lambda R, v, lvl: mungers.set_level(_as_vec(v), str(lvl)),
    "appendLevels": lambda R, v, lvls: mungers.append_levels(_as_vec(v), lvls),
    "relevel.by.freq": lambda R, v, topn=-1.0: mungers.relevel_by_freq(
        _as_vec(v), int(topn)),
    "getrow": lambda R, fr: mungers.getrow(_as_frame(fr)),
    "flatten": lambda R, fr: mungers.flatten(_as_frame(fr)),
    "as.Date": lambda R, v, fmt: mungers.as_date(_as_vec(v), str(fmt),
                                                 device=R.device),
    "week": lambda R, v: mungers.week(_as_vec(v)),
    "listTimeZones": lambda R: mungers.list_timezones(),
    "getTimeZone": lambda R: mungers.get_timezone(),
    "setTimeZone": lambda R, tz: mungers.set_timezone(str(tz)),
    "isax": lambda R, fr, nw, mc, oc=0.0: mungers.isax(
        _as_frame(fr), int(nw), int(mc), bool(oc)),
    "num_valid_substrings": lambda R, v, path: mungers.num_valid_substrings(
        _as_vec(v), str(path), device=R.device),
    "apply": _apply,
    "ddply": _ddply,
    "tf-idf": lambda R, fr, did, tid, pre=True, cs=True: mungers.tf_idf(
        _as_frame(fr), int(did), int(tid), bool(pre), bool(cs)),
    # NA-tolerant reducer aliases + axis/count reducers (`prims/reducers`)
    **{alias: _prim_reduce(base) for alias, base in
       (("sumNA", "sum"), ("maxNA", "max"), ("minNA", "min"),
        ("prod.na", "prod"))},
    "sumaxis": lambda R, fr, na_rm=False, axis=0.0: _sumaxis(
        _as_frame(fr), bool(na_rm), int(axis)),
    "naCnt": lambda R, fr: [float(v.nacnt())
                            for v in _as_frame(fr).vecs],
    "any.na": lambda R, fr: float(any(v.nacnt() > 0
                                      for v in _as_frame(fr).vecs)),
    "%/%": _prim_binop("%/%"),
    # uniform random column keyed to the frame's rows (`AstRunif`) — the
    # h2o-py split_frame building block
    "h2o.runif": lambda R, fr, seed=-1: (lambda f: Vec.from_numpy(
        np.random.default_rng(
            None if seed in (-1, None) else int(seed)).random(
                f.nrow).astype(np.float32), device=f.device or R.device))(
        _as_frame(fr)),
    # fourth wave: registry stragglers closing the diff against the
    # reference's prim set (`water/rapids/ast/prims/**` str() names)
    "%": _prim_binop("%%"),                      # AstMod's registered name
    ",": lambda R, *vals: (vals[-1] if vals else None),  # AstComma sequencing
    "as.character": lambda R, v: strmod.ascharacter(_as_vec(v)),
    "strlen": lambda R, v: strmod.nchar(_as_vec(v),       # AstStrLength
                                        device=R.device),
    "ls": lambda R: Frame(["key"], [Vec(
        None, len(STORE.keys()), type=T_STR,
        host_data=np.asarray(sorted(STORE.keys()), dtype=object))]),
    # (filterNACols fr frac): indices of columns whose NA count stays BELOW
    # nrow*frac (AstFilterNaCols.java:32-46)
    "filterNACols": lambda R, fr, frac: [
        float(i) for i, nm in enumerate(_as_frame(fr).names)
        if _as_frame(fr).vec(nm).nacnt() < _as_frame(fr).nrow * float(frac)],
    "model.reset.threshold": _reset_threshold_prim,
    "segment_models_as_frame": lambda R, key: _resolve_model(key).as_frame(),
    # `AstWord2VecToFrame` — embeddings as a [Word, V1..VD] frame
    "word2vec.to.frame": lambda R, key: _w2v_to_frame(_resolve_model(key),
                                                      R.device),
    "PermutationVarImp": _permutation_varimp_prim,
    "makeLeaderboard": _make_leaderboard_prim,
    # `AstFairnessMetrics` — disparate-impact analysis; returns a MAP of
    # frames ('overview' + per-group threshold tables)
    "fairnessMetrics": lambda R, model, fr, pcols, ref, fav:
        _fairness_metrics_prim(R, model, fr, pcols, ref, fav),
    # `AstTransformFrame` — model.transform (TargetEncoder et al.);
    # lambdas defer the name lookups to call time (defs live below)
    "transform": lambda R, m, fr: _transform_frame_prim(R, m, fr),
    # `AstScale` in-place flavor: same standardization, the input frame's
    # vecs are REBOUND (callers holding the key see scaled data)
    "scale_inplace": lambda R, fr, center=True, scale=True:
        _scale_inplace_prim(R, fr, center, scale),
    # `AstGroupedPermute` — within-group cross pairing of debit/credit rows
    "grouped_permute": lambda R, fr, perm_col, gb, permute_by, keep_col:
        mungers.grouped_permute(_as_frame(fr), int(perm_col),
                                [int(g) for g in (gb if isinstance(gb, list)
                                                  else [gb])],
                                int(permute_by), int(keep_col)),
}


def _as_strlist(x):
    return x if isinstance(x, list) else [x]


def _fairness_metrics_prim(R, model, fr, pcols, ref, fav):
    from .fairness import fairness_metrics

    return fairness_metrics(_resolve_model(model), _as_frame(fr),
                            [str(c) for c in _as_strlist(pcols)],
                            (None if not ref else
                             [str(c) for c in _as_strlist(ref)]), str(fav))


def _transform_frame_prim(R, model, fr):
    m = _resolve_model(model)
    fn = getattr(m, "transform", None)
    if fn is None:
        raise ValueError(f"model {getattr(m, 'key', m)} does not support "
                         "transform (TargetEncoder-style models only)")
    return fn(_as_frame(fr))


def _scale_inplace_prim(R, fr, center=True, scale=True):
    src = _as_frame(fr)
    out = advmath.scale_frame(src, _maybe_list(center), _maybe_list(scale))
    # mutate the shared Vec OBJECTS (rapids evaluation may hand the prim a
    # shallow frame copy, but the vecs are the DKV-resident ones): swap
    # their device arrays and invalidate rollups — every holder of the
    # frame key observes the scaled data (`AstScale.java:67-72`)
    for n in src.names:
        v, nv = src.vec(n), out.vec(n)
        if nv is not v and nv.data is not None:
            v.data = nv.data
            v.exact_data = None
            v._rollups = None
    return src


def _maybe_list(x):
    if isinstance(x, list):
        return [float(v) for v in x]
    return bool(x)


def _asnumeric(v: Vec) -> Vec:
    if not v.is_categorical():
        return v
    return Vec.from_numpy(v.to_numpy(), type="real", device=v.device)


def rapids_exec(expr: str, session: Session | None = None):
    """Module-level convenience — `Rapids.exec(String, Session)`."""
    return Rapids(session).exec(expr)
