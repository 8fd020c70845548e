"""Model explanation — partial dependence and permutation importance
(``h2o_tpu/models/explain.py``; `hex/PartialDependence.java`,
`hex/PermutationVarImp.java`).

The reference runs one scoring MRTask per grid point or shuffled column;
here each batch of grid points is one ``model.predict`` over a tall frame
built on the frame's device, and each shuffled column is a gather on the
device. The loop over grid points and columns stays on the host, and so do
the per-point means (over a (points, rows) copy of the responses) and the
permutation draws (numpy's ``default_rng(seed)``, the reference's).
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import Vec
from ..parallel.mesh import padded_len
from ..utils.twodimtable import TwoDimTable

#: rows of one batched partial-dependence predict (grid points x frame rows)
PDP_BATCH_ROWS = 2_000_000


def _response_col(model, pred: Frame, target: str | None = None):
    """The PDP target: p1 for binomial, p(target) for multinomial, the
    prediction for regression — a device tensor of the frame's rows."""
    cat = model.output.model_category
    if cat == "Binomial":
        v = pred.vec(2)
    elif cat == "Multinomial":
        v = pred.vec(f"p{target}")
    else:
        v = pred.vec(0)
    return v.data[:v.nrow]


def _device_vec(values: torch.Tensor, like: Vec) -> Vec:
    """A padded float32 column on ``values``' device, typed like ``like``."""
    n = values.shape[0]
    buf = torch.full((padded_len(n),), float("nan"), dtype=torch.float32,
                     device=values.device)
    buf[:n] = values
    return Vec(buf, n, type=like.type, domain=like.domain)


def partial_dependence(model, fr: Frame, cols=None, nbins: int = 20,
                       weight_column: str | None = None,
                       targets=None, row_index: int = -1) -> list[TwoDimTable]:
    """One table per column (per target class for multinomial): grid
    value, weighted mean response, its standard deviation and the standard
    error of the mean, over the rows with the column pinned to the value.

    ``row_index >= 0`` gives the ICE curve of that one row instead of the
    all-rows average (`hex/PartialDependence.java:21` _row_index): the grid
    still comes from the whole frame's column range, and the stddev and
    stderr columns are 0."""
    cat = model.output.model_category
    if cat == "Multinomial" and not targets:
        raise ValueError("multinomial PDP requires `targets` (class labels), "
                         "as in the reference's PartialDependence.targets")
    targets = [None] if cat != "Multinomial" else (
        [targets] if isinstance(targets, str) else list(targets))
    cols = cols or list(model.output.names)[:2]
    cols = [cols] if isinstance(cols, str) else list(cols)
    w = None
    if weight_column is not None:
        w = np.nan_to_num(fr.vec(weight_column).to_numpy())
    ice = row_index is not None and row_index >= 0
    R = fr.nrow
    out = []
    for col, target in [(c, t) for c in cols for t in targets]:
        v = fr.vec(col)
        if v.is_categorical():
            grid = np.arange(len(v.domain), dtype=np.float64)
            labels = list(v.domain)
        else:
            x = v.to_numpy()
            ok = ~np.isnan(x)
            lo, hi = float(np.min(x[ok])), float(np.max(x[ok]))
            grid = np.linspace(lo, hi, nbins)
            labels = None
        # only the model's features (plus the swept and weight columns)
        # enter the rebuilt frames
        used = set(model.output.names) | {col}
        if weight_column:
            used.add(weight_column)
        pd_names = [n for n in fr.names if n in used]
        dev = v.data.device
        rows = []
        if ice:
            # one predict over a G-row frame: the chosen row repeated with
            # the column swept over the grid
            gt = torch.from_numpy(grid.astype(np.float32)).to(dev)
            reps = Frame(pd_names, [
                _device_vec(gt if n == col else
                            fr.vec(n).data[row_index].expand(len(grid)),
                            fr.vec(n))
                for n in pd_names])
            resp = _response_col(model, model.predict(reps),
                                 target).cpu().numpy()
            for gi, val in enumerate(grid):
                rows.append([labels[gi] if labels else float(val),
                             float(resp[gi]), 0.0, 0.0])
        else:
            # many grid points per predict, as one tall frame (grid-block
            # major), within the row budget
            per_batch = max(1, PDP_BATCH_ROWS // max(R, 1))
            for b0 in range(0, len(grid), per_batch):
                gb = torch.from_numpy(
                    grid[b0:b0 + per_batch].astype(np.float32)).to(dev)
                k = gb.shape[0]
                vecs = [_device_vec(
                    torch.repeat_interleave(gb, R) if n == col
                    else fr.vec(n).data[:R].repeat(k), fr.vec(n))
                    for n in pd_names]
                resp = _response_col(model, model.predict(Frame(pd_names,
                                                                vecs)),
                                     target)
                resp = resp[:k * R].reshape(k, R).cpu().numpy()
                for ki in range(k):
                    gi = b0 + ki
                    r = resp[ki]
                    ok = ~np.isnan(r)
                    ww = w[ok] if w is not None else np.ones(ok.sum())
                    tot = max(ww.sum(), 1e-12)
                    mean = float(np.sum(ww * r[ok]) / tot)
                    var = float(np.sum(ww * (r[ok] - mean) ** 2) / tot)
                    std = np.sqrt(var)
                    rows.append([labels[gi] if labels else float(grid[gi]),
                                 mean, std,
                                 std / np.sqrt(max(ok.sum(), 1))])
        hdr = (f"PartialDependence: {col}"
               + (f" (target {target})" if target is not None else "")
               + (f" for row {row_index}" if ice else ""))
        out.append(TwoDimTable(
            table_header=hdr,
            col_header=[col, "mean_response", "stddev_response",
                        "std_error_mean_response"],
            col_types=["string" if labels else "double"] + ["double"] * 3,
            cell_values=rows))
    return out


def permutation_varimp(model, fr: Frame, metric: str = "AUTO",
                       n_repeats: int = 1, seed: int = -1) -> TwoDimTable:
    """Permutation feature importance (`hex/PermutationVarImp.java`): the
    metric's degradation when one feature column is shuffled, per
    feature. Each shuffle is a gather on the frame's device; the metrics
    are computed there."""
    from .metrics import (make_binomial_metrics, make_multinomial_metrics,
                          make_regression_metrics)

    cat = model.output.model_category
    mname = metric.upper()
    allowed = {"Binomial": ("AUTO", "AUC", "LOGLOSS"),
               "Multinomial": ("AUTO", "LOGLOSS"),
               "Regression": ("AUTO", "RMSE", "MSE")}.get(cat)
    if allowed is None:
        raise ValueError(f"permutation importance is not supported for "
                         f"{cat} models")
    if mname not in allowed:
        raise ValueError(f"metric '{metric}' is not supported for {cat} "
                         f"models (one of {allowed})")
    n = fr.nrow
    y = fr.vec(model.params.response_column).data[:n]

    def score_metric(frame) -> float:
        pred = model.predict(frame)
        if cat == "Binomial":
            m = make_binomial_metrics(y, pred.vec(2).data[:n])
            return m.auc if mname in ("AUTO", "AUC") else -m.logloss
        if cat == "Multinomial":
            P = torch.stack([pred.vec(i).data[:n]
                             for i in range(1, pred.ncol)], dim=1)
            return -make_multinomial_metrics(y, P).logloss
        m = make_regression_metrics(y, pred.vec(0).data[:n])
        return -m.rmse if mname in ("AUTO", "RMSE") else -m.mse

    base = score_metric(fr)
    rng = np.random.default_rng(None if seed in (-1, None) else int(seed))
    rows = []
    for col in model.output.names:
        v = fr.vec(col)
        deltas = []
        for _ in range(max(1, n_repeats)):
            perm = torch.from_numpy(rng.permutation(n)).to(v.data.device)
            shuffled = Frame(list(fr.names),
                             [_device_vec(v.data[:n][perm], v)
                              if name == col else fr.vec(name)
                              for name in fr.names])
            deltas.append(base - score_metric(shuffled))
        rows.append([col, float(np.mean(deltas))])
    imp = np.array([r[1] for r in rows])
    mx = imp.max() if imp.max() > 0 else 1.0
    tot = imp.sum() if imp.sum() > 0 else 1.0
    table_rows = [[r[0], r[1], r[1] / mx, r[1] / tot]
                  for r in sorted(rows, key=lambda r: -r[1])]
    return TwoDimTable(
        table_header="Permutation Variable Importance",
        col_header=["Variable", "Relative Importance", "Scaled Importance",
                    "Percentage"],
        col_types=["string", "double", "double", "double"],
        cell_values=table_rows)
