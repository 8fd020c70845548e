"""Rapids core ops — element-wise math, comparisons, reducers, cumulants
(``h2o_tpu/rapids/ops.py``).

Analog of `water/rapids/ast/prims/{math,operators,reducers,timeseries}`.
Each op is one vectorized torch expression over the padded column on the
Vec's own device; NA propagation comes from NaN arithmetic.

H2O semantics kept:
- comparisons return 0/1 numeric vecs, NA in -> NA out
- ``&&``/``||`` use H2O's ternary NA logic (NA && 0 == 0, NA || 1 == 1)
- reducers have ``na_rm`` variants
- ``%/%``, ``intDiv`` and ``%%`` follow Java's truncation
- columns that carry an exact host copy (integers past 2^24, milliseconds
  since the epoch) evaluate in float64 on the host, as the reference does
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_INT, Vec
from ..parallel.mesh import resolve_device


def device_of(*objs, device=None) -> torch.device:
    """The device of the first Vec or Frame among ``objs`` that has one,
    else ``device`` (``None`` -> ``cuda``): where an op's new columns go."""
    for o in objs:
        if isinstance(o, (Vec, Frame)) and o.device is not None:
            return o.device
        if isinstance(o, (list, tuple)):
            for x in o:
                if isinstance(x, (Vec, Frame)) and x.device is not None:
                    return x.device
    return resolve_device(device)


def dev_vec(out: torch.Tensor, nrow: int, type: str = "real",
            domain=None) -> Vec:
    """A freshly computed padded column as a Vec, its padding rows set
    back to NaN (rollups read every row of the padded column)."""
    if out.shape[0] > nrow:
        out[nrow:] = torch.nan
    return Vec(out, nrow, type=type, domain=domain)


def _data(v, dev=None):
    if isinstance(v, Vec):
        return v.data
    return torch.tensor(float(v), dtype=torch.float32, device=dev)


def _nrow(*vs):
    for v in vs:
        if isinstance(v, Vec):
            return v.nrow
    raise ValueError("need at least one Vec")


def _mask(v: Vec) -> torch.Tensor:
    return torch.arange(v.data.shape[0], device=v.data.device) < v.nrow


# ---------------------------------------------------------------------------
# binary / unary element-wise
# ---------------------------------------------------------------------------
_BINOPS = {
    "+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
    "^": torch.pow,
    # Java truncated remainder (sign follows the dividend, AstMod.java:11);
    # x % 0 is NaN on Java doubles
    "%%": lambda a, b: torch.where(b == 0, torch.nan, torch.fmod(a, b)),
    # AstIntDiv: each operand truncates before the divide; AstIntDivR
    # (`%/%`): the real quotient truncates
    "intDiv": lambda a, b: torch.where(
        torch.trunc(b) == 0, torch.nan,
        torch.trunc(torch.trunc(a) / torch.trunc(b))),
    "%/%": lambda a, b: torch.where(b == 0, torch.nan, torch.trunc(a / b)),
}

_CMPOPS = {
    "==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
    ">": torch.gt, ">=": torch.ge,
}

#: float64 twins on the host, for columns float32 cannot hold
_NP_BINOPS = {
    "+": np.add, "-": np.subtract, "*": np.multiply, "/": np.divide,
    "^": np.float_power,
    "%%": lambda a, b: np.where(b == 0, np.nan, np.fmod(a, b)),
    "intDiv": lambda a, b: np.where(np.trunc(b) == 0, np.nan,
                                    np.trunc(np.trunc(a) / np.trunc(b))),
    "%/%": lambda a, b: np.where(b == 0, np.nan, np.trunc(np.divide(a, b))),
}

_NP_CMPOPS = {
    "==": np.equal, "!=": np.not_equal, "<": np.less, "<=": np.less_equal,
    ">": np.greater, ">=": np.greater_equal,
}


def _exact_np(v):
    if isinstance(v, Vec):
        return v.to_numpy().astype(np.float64)
    return np.float64(v)


def _wants_f64(v) -> bool:
    return isinstance(v, Vec) and v.exact_data is not None


def _binop_host(op: str, l, r, dev) -> Vec:
    a, b = _exact_np(l), _exact_np(r)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if op in _NP_BINOPS:
            return Vec.from_numpy(np.asarray(_NP_BINOPS[op](a, b),
                                             dtype=np.float64), device=dev)
        if op in _NP_CMPOPS:
            res = _NP_CMPOPS[op](a, b).astype(np.float64)
            res = np.where(np.isnan(a) | np.isnan(b), np.nan, res)
            return Vec.from_numpy(res, type=T_INT, device=dev)
        if op in ("&", "&&"):
            out = np.where((a == 0) | (b == 0), 0.0,
                           np.where(np.isnan(a) | np.isnan(b), np.nan, 1.0))
            return Vec.from_numpy(out, type=T_INT, device=dev)
        if op in ("|", "||"):
            a1 = (a != 0) & ~np.isnan(a)
            b1 = (b != 0) & ~np.isnan(b)
            out = np.where(a1 | b1, 1.0,
                           np.where(np.isnan(a) | np.isnan(b), np.nan, 0.0))
            return Vec.from_numpy(out, type=T_INT, device=dev)
    raise ValueError(f"unknown op {op!r}")


def binop(op: str, l, r) -> Vec:
    nrow = _nrow(l, r)
    dev = device_of(l, r)
    if _wants_f64(l) or _wants_f64(r):
        return _binop_host(op, l, r, dev)
    a, b = _data(l, dev), _data(r, dev)
    if op in _BINOPS:
        return dev_vec(_BINOPS[op](a, b), nrow)
    if op in _CMPOPS:
        res = _CMPOPS[op](a, b).to(torch.float32)
        if isinstance(l, Vec):
            res = torch.where(torch.isnan(a), torch.nan, res)
        if isinstance(r, Vec):
            res = torch.where(torch.isnan(b), torch.nan, res)
        return dev_vec(res, nrow, type=T_INT)
    if op in ("&", "&&"):
        out = torch.where((a == 0) | (b == 0), 0.0,
                          torch.where(torch.isnan(a) | torch.isnan(b),
                                      torch.nan, 1.0))
        return dev_vec(out, nrow, type=T_INT)
    if op in ("|", "||"):
        a1 = (a != 0) & ~torch.isnan(a)
        b1 = (b != 0) & ~torch.isnan(b)
        out = torch.where(a1 | b1, 1.0,
                          torch.where(torch.isnan(a) | torch.isnan(b),
                                      torch.nan, 0.0))
        return dev_vec(out, nrow, type=T_INT)
    raise ValueError(f"unknown op {op!r}")


def _pole(x):
    return (x <= 0) & (x == torch.floor(x))


def _gamma(x):
    s = torch.cos(torch.pi * torch.floor(x))
    return torch.exp(torch.lgamma(x)) * torch.where(
        x > 0, 1.0, torch.where(torch.isnan(s), s, torch.sign(s)))


_UNARY = {
    "abs": torch.abs, "ceiling": torch.ceil, "floor": torch.floor,
    "trunc": torch.trunc,
    "sign": lambda x: torch.where(torch.isnan(x), x, torch.sign(x)),
    "exp": torch.exp, "expm1": torch.expm1,
    "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "sqrt": torch.sqrt,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "gamma": _gamma,
    "lgamma": torch.lgamma,
    # at the poles (0, -1, -2, ...) digamma is NaN and trigamma +inf, as
    # jax.scipy.special gives them
    "digamma": lambda x: torch.where(_pole(x), torch.nan,
                                     torch.special.digamma(x)),
    "trigamma": lambda x: torch.where(_pole(x), torch.inf,
                                      torch.special.polygamma(1, x)),
    "cospi": lambda x: torch.cos(torch.pi * x),
    "sinpi": lambda x: torch.sin(torch.pi * x),
    "tanpi": lambda x: torch.tan(torch.pi * x),
    "not": lambda x: torch.where(torch.isnan(x), torch.nan,
                                 (x == 0).to(torch.float32)),
}


def unop(op: str, v: Vec, device=None) -> Vec:
    """An element-wise function of one column. ``device`` places the
    result of ``isna`` on a host string column (None -> ``cuda``)."""
    if op == "isna":
        if v.data is None:  # string column: host-side None check
            out = np.array([1.0 if x is None else 0.0
                            for x in v.host_data], np.float32)
            return Vec.from_numpy(out, type=T_INT,
                                  device=resolve_device(device))
        out = torch.isnan(v.data).to(torch.float32)
        return dev_vec(out, v.nrow, type=T_INT)
    if op == "round":
        return round_digits(v, 0)
    return dev_vec(_UNARY[op](v.data), v.nrow)


def round_digits(v: Vec, digits: int = 0) -> Vec:
    # round-half-even, as R and H2O round; the scale as a tensor on the
    # column's device, so the card divides as the CPU does (a Python
    # scalar divisor becomes a multiply by its reciprocal on CUDA)
    scale = torch.tensor(10.0 ** digits, dtype=torch.float32,
                         device=v.data.device)
    return dev_vec(torch.round(v.data * scale) / scale, v.nrow)


def signif(v: Vec, digits: int) -> Vec:
    x = v.data
    mag = torch.where(x == 0, 1.0, torch.pow(
        10.0, digits - 1 - torch.floor(torch.log10(torch.abs(
            torch.where(x == 0, 1.0, x))))))
    return dev_vec(torch.round(x * mag) / mag, v.nrow)


def ifelse(test, yes, no) -> Vec:
    nrow = _nrow(test)
    dev = test.device
    t = test.data
    out = torch.where(torch.isnan(t), torch.nan,
                      torch.where(t != 0, _data(yes, dev), _data(no, dev)))
    return dev_vec(out.to(torch.float32), nrow)


# ---------------------------------------------------------------------------
# reducers (`water/rapids/ast/prims/reducers`)
# ---------------------------------------------------------------------------
def _reduce_host(op: str, v: Vec, na_rm: bool) -> float:
    x = v.to_numpy().astype(np.float64)
    ok = ~np.isnan(x)
    if not na_rm and not ok.all():
        return float("nan")
    xv = x[ok]
    if xv.size == 0 and op in ("sum", "prod", "min", "max", "mean", "median"):
        return float("nan") if op not in ("sum", "prod") else \
            (0.0 if op == "sum" else 1.0)
    fns = {"sum": np.sum, "prod": np.prod, "min": np.min, "max": np.max,
           "mean": np.mean, "median": np.median,
           "sd": lambda a: np.std(a, ddof=1),
           "sdev": lambda a: np.std(a, ddof=1),
           "var": lambda a: np.var(a, ddof=1)}
    if op in fns:
        return float(fns[op](xv))
    if op == "all":
        return bool(np.all(xv != 0))
    if op == "any":
        return bool(np.any(xv != 0))
    if op == "nacnt":
        return v.nacnt()
    raise ValueError(f"unknown reducer {op!r}")


def reduce_op(op: str, v: Vec, na_rm: bool = True) -> float:
    if _wants_f64(v):
        return _reduce_host(op, v, na_rm)
    x = v.data
    ok = ~torch.isnan(x)
    has_na = bool((~ok).sum() > (v.plen - v.nrow))
    if not na_rm and has_na:
        return float("nan")
    if op == "sum":
        return float(torch.where(ok, x, 0.0).sum())
    if op == "prod":
        return float(torch.where(ok, x, 1.0).prod())
    if op == "min":
        return float(torch.where(ok, x, torch.inf).min())
    if op == "max":
        return float(torch.where(ok, x, -torch.inf).max())
    if op == "mean":
        return v.rollups().mean
    if op in ("sd", "sdev"):
        return v.rollups().sigma
    if op == "var":
        return v.rollups().sigma ** 2
    if op == "median":
        from ..models.quantile import quantiles_device

        return float(quantiles_device(x, v.nrow, (0.5,))[0])
    if op == "all":
        return bool(torch.where(ok, x != 0, True).all())
    if op == "any":
        return bool(torch.where(ok, x != 0, False).any())
    if op == "nacnt":
        return v.nacnt()
    raise ValueError(f"unknown reducer {op!r}")


def cumulative(op: str, v: Vec) -> Vec:
    """cumsum/cumprod/cummin/cummax, NA from the first NA on."""
    if _wants_f64(v):
        x = v.to_numpy().astype(np.float64)
        hf = {"cumsum": np.cumsum, "cumprod": np.cumprod,
              "cummin": np.minimum.accumulate,
              "cummax": np.maximum.accumulate}[op]
        return Vec.from_numpy(hf(x), device=v.device)
    fns = {"cumsum": lambda t: torch.cumsum(t, 0),
           "cumprod": lambda t: torch.cumprod(t, 0),
           "cummin": lambda t: torch.cummin(t, 0).values,
           "cummax": lambda t: torch.cummax(t, 0).values}
    neutral = {"cumsum": 0.0, "cumprod": 1.0, "cummin": torch.inf,
               "cummax": -torch.inf}[op]
    inr = _mask(v)
    ok = ~torch.isnan(v.data) & inr
    out = fns[op](torch.where(ok, v.data, neutral))
    # once an in-range NA appears, every later output is NA
    na_seen = torch.cumsum((~ok & inr).to(torch.int32), 0) > 0
    return dev_vec(torch.where(na_seen, torch.nan, out), v.nrow)


# ---------------------------------------------------------------------------
# table / unique / histogram (`prims/advmath`)
# ---------------------------------------------------------------------------
def table(v: Vec) -> Frame:
    """Counts per level/integer value — `AstTable`."""
    dev = v.device
    host = v.to_numpy()
    ok = ~np.isnan(host)
    vals, counts = np.unique(host[ok], return_counts=True)
    if v.is_categorical() and v.domain:
        names = [v.domain[int(x)] for x in vals]
        c1 = Vec.from_numpy(np.arange(len(vals), dtype=np.float32),
                            type=T_CAT, domain=names, device=dev)
    else:
        c1 = Vec.from_numpy(vals.astype(np.float32), device=dev)
    return Frame(["row", "count"],
                 [c1, Vec.from_numpy(counts.astype(np.float32), type=T_INT,
                                     device=dev)])


def unique(v: Vec) -> Vec:
    host = v.to_numpy()
    vals = np.unique(host[~np.isnan(host)])
    if v.is_categorical():
        return Vec.from_numpy(vals.astype(np.float32), type=T_CAT,
                              domain=v.domain, device=v.device)
    return Vec.from_numpy(vals.astype(np.float32), device=v.device)


def hist(v: Vec, breaks: int = 20):
    """(counts, edges): ``breaks`` equal-width bins over [min, max]; the
    counts are exact (an integer ``bincount`` on the column's device)."""
    r = v.rollups()
    edges = np.linspace(r.mins, r.maxs, breaks + 1)
    x = v.data
    ok = ~torch.isnan(x) & _mask(v)
    inner = torch.tensor(edges[1:-1], dtype=torch.float32, device=x.device)
    b = torch.clamp(torch.searchsorted(inner, x.contiguous(), right=True),
                    0, breaks - 1)
    counts = torch.bincount(b[ok], minlength=breaks)
    return counts.cpu().numpy().astype(np.float32), edges


# ---------------------------------------------------------------------------
# time ops (`prims/time`) — columns are ms since epoch
# ---------------------------------------------------------------------------
def time_part(v: Vec, part: str) -> Vec:
    ms = v.to_numpy().astype("float64")
    ok = ~np.isnan(ms)
    dt = np.full(ms.shape, np.datetime64("NaT"), dtype="datetime64[ms]")
    dt[ok] = ms[ok].astype("int64").astype("datetime64[ms]")
    Y = dt.astype("datetime64[Y]")
    M = dt.astype("datetime64[M]")
    D = dt.astype("datetime64[D]")
    out = {
        "year": lambda: Y.astype(float) + 1970,
        "month": lambda: (M - Y).astype(float) + 1,
        "day": lambda: (D - M).astype(float) + 1,
        "dayOfWeek": lambda: ((D.astype("int64") + 3) % 7).astype(float),
        "hour": lambda: (dt - D).astype("timedelta64[h]").astype(float),
        "minute": lambda: (dt - dt.astype("datetime64[h]")).astype(
            "timedelta64[m]").astype(float),
        "second": lambda: (dt - dt.astype("datetime64[m]")).astype(
            "timedelta64[s]").astype(float),
        "millis": lambda: (dt - dt.astype("datetime64[s]")).astype(
            "timedelta64[ms]").astype(float),
    }[part]()
    out = np.where(ok, out, np.nan).astype(np.float32)
    return Vec.from_numpy(out, type=T_INT, device=v.device)
