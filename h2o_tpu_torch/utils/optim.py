"""optax's L-BFGS and Adam written out in PyTorch, for the GLM's L_BFGS
solver and ordinal family (``h2o_tpu/models/glm.py:1526-1680``).

The reference calls ``optax.lbfgs()`` — ``scale_by_lbfgs`` (memory 10,
the scaled identity as the first preconditioner), ``scale(-1)`` and the
zoom linesearch (Nocedal & Wright algorithms 3.5 and 3.6, 20 steps, first
guess 1) — and ``optax.adam(1e-1)``. Both are written out here step for
step, so the two packages take the same iterations: vectors stay float32
tensors on the caller's device, and every scalar of the optimizers'
states (step sizes, values, slopes, the curvature weights) is a numpy
float32, as the reference's jitted states are with x64 off. Only the
objective's sums run in another order than XLA's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

f32 = np.float32


def _dot(a: torch.Tensor, b: torch.Tensor) -> np.float32:
    return f32(torch.dot(a, b).item())


class LBFGS:
    """``optax.lbfgs()`` at its defaults over one flat float32 parameter
    vector. ``value_and_grad(params) -> (float32 value, gradient)`` is the
    objective. ``step(params)`` is one call of the reference's jitted step
    (``optax.value_and_grad_from_state`` then ``opt.update`` then
    ``apply_updates``): it returns (new params, the value and the gradient
    at ``params``)."""

    def __init__(self, value_and_grad: Callable, params: torch.Tensor,
                 memory_size: int = 10):
        self.vg = value_and_grad
        self.count = 0
        self.prev_params = torch.zeros_like(params)
        self.prev_updates = torch.zeros_like(params)
        self.dw = torch.zeros((memory_size,) + tuple(params.shape),
                              dtype=params.dtype, device=params.device)
        self.du = torch.zeros_like(self.dw)
        self.rho = np.zeros(memory_size, f32)
        self.value = f32(np.inf)          # the linesearch's last value
        self.grad = torch.zeros_like(params)

    def step(self, params: torch.Tensor):
        if np.isfinite(self.value):
            value, grad = self.value, self.grad
        else:
            value, grad = self.vg(params)
        d = -self._precondition(grad, params)
        lr, self.value, self.grad = zoom_linesearch(self.vg, params, d,
                                                    value, grad)
        return params + float(lr) * d, value, grad

    def _precondition(self, g, w):
        """``scale_by_lbfgs``'s update: the memory takes the last step's
        differences, then Algorithm 7.4's two loops over it."""
        m = len(self.rho)
        k = self.count
        idx, prev = k % m, (k - 1) % m
        dw = w - self.prev_params
        du = g - self.prev_updates
        v = _dot(du, dw)
        weight = f32(0.0) if v == 0.0 else f32(1.0) / v
        if k == 0:
            dw, du, weight = torch.zeros_like(dw), torch.zeros_like(du), \
                f32(0.0)
        self.dw[prev], self.du[prev], self.rho[prev] = dw, du, weight
        den = _dot(du, du)
        gamma = _dot(du, dw) / den if den > 0.0 else f32(1.0)
        if k == 0:   # the first step: a capped reciprocal of the norm
            gamma = np.minimum(f32(1.0), f32(1.0) / np.sqrt(_dot(g, g)))
        order = [(idx + i) % m for i in range(m)]
        q = g
        alphas = {}
        for i in reversed(order):
            a = self.rho[i] * _dot(self.dw[i], q)
            q = q + float(-a) * self.du[i]
            alphas[i] = a
        r = float(gamma) * q
        for i in order:
            b = self.rho[i] * _dot(self.du[i], r)
            r = r + float(alphas[i] - b) * self.dw[i]
        self.prev_params, self.prev_updates = w, g
        self.count += 1
        return r


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc ** 2, -(db ** 2)], [-(dc ** 3), db ** 3]], f32)
    A, B = (d1 @ np.array([fb - fa - C * db, fc - fa - C * dc], f32)) / denom
    radical = B * B - f32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (f32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (f32(2.0) * B)


def zoom_linesearch(vg, params, d, value, grad, max_steps: int = 20,
                    slope_rtol: float = 1e-4, curv_rtol: float = 0.9,
                    approx_dec_rtol: float = 1e-6,
                    interval_threshold: float = 1e-5,
                    increase_factor: float = 2.0):
    """``optax.scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy='one')`` along ``d`` from ``params``: returns
    (step size, value, gradient at the step the search settled on)."""
    zero, inf = f32(0.0), f32(np.inf)

    def on_line(step):
        v, g = vg(params + float(step) * d)
        return v, g, _dot(g, d)

    def dec_err(step, v, s, v0, s0):
        e = v - v0 - slope_rtol * step * s0
        approx = np.maximum(s - (2 * slope_rtol - 1.0) * s0,
                            v - v0 - approx_dec_rtol * abs(v0))
        e = np.maximum(np.minimum(approx, e), zero)
        return inf if np.isnan(e) else e

    def curv_err(s, s0):
        e = np.maximum(abs(s) - curv_rtol * abs(s0), zero)
        return inf if np.isnan(e) else e

    slope = _dot(grad, d)
    st = dict(count=0, stepsize=zero, value=f32(value), grad=grad,
              slope=slope, dec=inf, interval_found=False, done=False,
              failed=False, low=zero, value_low=value, slope_low=slope,
              high=zero, value_high=value, slope_high=slope, cubic_ref=zero,
              value_cubic_ref=value, safe_stepsize=zero, safe_value=value,
              safe_grad=grad)
    v0, s0 = f32(value), slope
    with np.errstate(all="ignore"):
        while not (st["done"] or st["failed"]):
            it = st["count"]
            if not st["interval_found"]:       # Algorithm 3.5
                new = f32(1.0) if it == 0 else \
                    f32(increase_factor * st["stepsize"])
                v, g, s = on_line(new)
                de = dec_err(new, v, s, v0, s0)
                err = np.maximum(de, curv_err(s, s0))
                if de <= 0.0:
                    st.update(safe_stepsize=new, safe_value=v, safe_grad=g)
                high_new = bool(de > 0.0 or (v >= st["value"] and it > 0))
                low_new = bool(s >= 0.0 and not high_new)
                prev = (st["stepsize"], st["value"], st["slope"])
                lo, hi = ((new, v, s), prev) if low_new else (prev,
                                                              (new, v, s))
                found = high_new or low_new or err <= 0.0
                done = bool(err <= 0.0)
                st.update(count=it + 1, stepsize=new, value=v, grad=g,
                          slope=s, dec=de, interval_found=found, done=done,
                          failed=bool(it + 1 >= max_steps and not done),
                          low=lo[0], value_low=lo[1], slope_low=lo[2],
                          high=hi[0], value_high=hi[1], slope_high=hi[2],
                          cubic_ref=lo[0], value_cubic_ref=lo[1])
            else:                               # Algorithm 3.6
                low, high = st["low"], st["high"]
                vlo, slo = st["value_low"], st["slope_low"]
                vhi, shi = st["value_high"], st["slope_high"]
                delta = abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                cubic = _cubicmin(low, vlo, slo, high, vhi, st["cubic_ref"],
                                  st["value_cubic_ref"])
                quad = _quadmin(low, vlo, slo, high, vhi)
                if left + 0.2 * delta < cubic < right - 0.2 * delta:
                    mid = cubic
                elif left + 0.1 * delta < quad < right - 0.1 * delta:
                    mid = quad
                else:
                    mid = (low + high) / f32(2.0)
                mid = f32(mid)
                v, g, s = on_line(mid)
                de = dec_err(mid, v, s, v0, s0)
                err = np.maximum(de, curv_err(s, s0))
                if de <= 0.0 and v < st["safe_value"]:
                    st.update(safe_stepsize=mid, safe_value=v, safe_grad=g)
                done = bool(err <= 0.0)
                high_mid = bool(de > 0.0 or v >= vlo)
                high_low = bool(s * (high - low) >= 0.0 and not high_mid)
                nhi = (mid, v, s) if high_mid else (high, vhi, shi)
                if high_low:
                    nhi = (low, vlo, slo)
                nlo = (low, vlo, slo) if high_mid else (mid, v, s)
                ref = (high, vhi) if (high_mid or high_low) else (low, vlo)
                failed = (it + 1 >= max_steps
                          or (delta <= interval_threshold
                              and st["safe_stepsize"] > 0.0)) and not done
                st.update(count=it + 1, stepsize=mid, value=v, grad=g,
                          slope=s, dec=de, done=done, failed=bool(failed),
                          low=nlo[0], value_low=nlo[1], slope_low=nlo[2],
                          high=nhi[0], value_high=nhi[1], slope_high=nhi[2],
                          cubic_ref=ref[0], value_cubic_ref=ref[1])
            if st["failed"] and (st["safe_stepsize"] > 0.0
                                 or np.isinf(st["dec"])):
                st.update(stepsize=st["safe_stepsize"],
                          value=st["safe_value"], grad=st["safe_grad"])
    return st["stepsize"], f32(st["value"]), st["grad"]


class Adam:
    """``optax.adam(learning_rate)`` (b1 0.9, b2 0.999, eps 1e-8) over a
    dict of float32 tensors, updated in place by ``step(params, grads)``."""

    def __init__(self, params: dict, learning_rate: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.count += 1
        # 1 - decay**count in float32, as XLA takes it
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(self.count))
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * (g ** 2) + self.b2 * self.nu[k]
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                      + self.eps)
            p.add_(-self.lr * u)
