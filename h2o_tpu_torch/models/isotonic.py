"""Isotonic regression (``h2o_tpu/models/isotonic.py``, `hex/isotonic/`):
pool adjacent violators.

The rows are pooled to their unique x on the device — one stable sort,
then per-segment float64 sums of w and w y — and the sequential PAV stack
runs on the host over the unique values, as the reference runs it.
Prediction interpolates linearly between the fitted points
(``searchsorted`` on the device); x outside the fitted range gives NA, or
under ``out_of_bounds="clip"`` the nearest end's value; NA in gives NA
out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .metrics import make_metrics
from .model_base import Model, ModelBuilder, ModelOutput, Parameters
from .tree.engine import _fma


@dataclass
class IsotonicParameters(Parameters):
    out_of_bounds: str = "NA"  # NA | clip


def _pav(x: np.ndarray, y: np.ndarray, w: np.ndarray):
    """Pool-adjacent-violators over pre-aggregated unique (x, ybar, w)."""
    # stack of blocks [sum_wy, sum_w, start_idx]
    vals, wts, starts = [], [], []
    for i in range(len(x)):
        vals.append(y[i] * w[i])
        wts.append(w[i])
        starts.append(i)
        while len(vals) > 1 and vals[-2] / wts[-2] > vals[-1] / wts[-1]:
            v, ww = vals.pop(), wts.pop()
            starts.pop()
            vals[-1] += v
            wts[-1] += ww
    fitted = np.empty_like(y)
    bounds = starts + [len(x)]
    for b in range(len(vals)):
        fitted[bounds[b]:bounds[b + 1]] = vals[b] / wts[b]
    return fitted


def _pool(x, y, w):
    """(unique x, per-x sum w, per-x sum w y) on the host, float64, from
    device columns: the rows with x, y and a positive weight, sorted by x
    (stable), pooled by equal x."""
    ok = ~(torch.isnan(x) | torch.isnan(y)) & (w > 0)
    x, y, w = x[ok].double(), y[ok].double(), w[ok].double()
    order = torch.sort(x, stable=True).indices
    x, y, w = x[order], y[order], w[order]
    ux, inv = torch.unique_consecutive(x, return_inverse=True)
    sw = torch.zeros_like(ux).index_add_(0, inv, w)
    swy = torch.zeros_like(ux).index_add_(0, inv, w * y)
    return ux.cpu().numpy(), sw.cpu().numpy(), swy.cpu().numpy()


class IsotonicRegressionModel(Model):
    algo_name = "isotonicregression"

    def __init__(self, params, output, xs, ys, key=None):
        self.xs = xs  # (m,) increasing thresholds, float32 numpy
        self.ys = ys  # (m,) fitted nondecreasing values
        super().__init__(params, output, key=key)

    @staticmethod
    def from_reference(ref, device=None) -> "IsotonicRegressionModel":
        """Carry a JAX-trained isotonic fit over: its thresholds and fitted
        values, host arrays (``device`` is taken for the carriers' common
        signature; scoring runs on the frame's device)."""
        out = ModelOutput.carried(ref.output)
        out.training_metrics = ref.output.training_metrics
        params = IsotonicParameters(
            response_column=ref.params.response_column,
            out_of_bounds=ref.params.out_of_bounds)
        return IsotonicRegressionModel(params, out,
                                       np.array(ref.xs, np.float32),
                                       np.array(ref.ys, np.float32))

    def score0(self, X: torch.Tensor) -> torch.Tensor:
        x = X[:, 0]
        xs = torch.from_numpy(np.asarray(self.xs, np.float32)).to(x.device)
        ys = torch.from_numpy(np.asarray(self.ys, np.float32)).to(x.device)
        m = xs.shape[0]
        idx = torch.searchsorted(xs, x.contiguous(), right=True)
        lo = torch.clamp(idx - 1, 0, m - 1)
        hi = torch.clamp(idx, 0, m - 1)
        x0, x1, y0, y1 = xs[lo], xs[hi], ys[lo], ys[hi]
        t = torch.where(x1 > x0, (x - x0) / torch.clamp(x1 - x0, min=1e-30),
                        0.0)
        # XLA contracts y0 + t * (y1 - y0) into one FMA
        out = _fma(t, y1 - y0, y0)
        if (self.params.out_of_bounds or "NA").lower() == "clip":
            out = torch.clamp(out, ys[0], ys[-1])
        else:
            out = torch.where((x < xs[0]) | (x > xs[-1]), torch.nan, out)
        return torch.where(torch.isnan(x), torch.nan, out)


class IsotonicRegression(ModelBuilder):
    algo_name = "isotonicregression"

    def build_impl(self, job) -> IsotonicRegressionModel:
        p: IsotonicParameters = self.params
        fr = p.training_frame
        names = self.feature_names()
        if len(names) != 1:
            raise ValueError("isotonic regression takes exactly one feature "
                             "column")
        n = fr.nrow
        x = fr.vec(names[0]).data[:n]
        y = fr.vec(p.response_column).data[:n]
        w = (torch.nan_to_num(fr.vec(p.weights_column).data[:n])
             if p.weights_column else torch.ones_like(y))
        ux, sw, swy = _pool(x, y, w)
        fitted = _pav(ux, swy / sw, sw)

        output = ModelOutput()
        output.names = names
        output.domains = {names[0]: None}
        output.model_category = "Regression"
        model = IsotonicRegressionModel(
            p, output, ux.astype(np.float32), fitted.astype(np.float32))
        raw = model.score0(fr.as_matrix(names))
        output.training_metrics = make_metrics(
            "Regression", fr.vec(p.response_column).data, raw, None)
        return model
