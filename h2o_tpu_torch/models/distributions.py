"""Distributions & link functions (``h2o_tpu/models/distributions.py``).

Each supplies the link/linkinv pair, the intercept-only fit ``init_f``, and
the per-row gradient, hessian and deviance on the link scale, as plain
functions on tensors in the reference's formulas and operation order. The
special leaf fits of laplace, quantile and huber (per-leaf quantiles
instead of a Newton step) live in the tree engine.
"""

from __future__ import annotations

import inspect

import torch

EPS = 1e-10


def _exp(x):
    """``torch.exp`` in float64, rounded once to ``x``'s type. The card's
    float32 exp and the CPU's differ in the last bit on some inputs, and a
    gradient one bit apart can tip a near-tied split; both round the
    float64 value alike."""
    return torch.exp(x.double()).to(x.dtype)


def _log(x):
    """``torch.log`` in float64, rounded once to ``x``'s type (see
    ``_exp``)."""
    return torch.log(x.double()).to(x.dtype)


def _sigmoid(f):
    # the reference's formula, not torch.sigmoid, so both round alike
    return 1.0 / (1.0 + _exp(-f))


def _nanquantile(a: torch.Tensor, q: float, midpoint: bool = False):
    """``jnp.nanquantile(a, q)`` of a 1-D float32 tensor (``midpoint``:
    ``jnp.nanmedian``'s method) in jax's formulation: NaNs sort last, the
    position ``q * (n - 1)`` is formed in float32 over the non-NaN count,
    and the two neighbours are mixed linearly (or averaged). 0-d result."""
    s = torch.sort(a).values
    n = (~torch.isnan(s)).sum().to(torch.float32)
    pos = torch.tensor(q, dtype=torch.float32, device=a.device) * (n - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    top = n - 1.0
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top))
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, top))
    lv, hv = s[low.long()], s[high.long()]
    if midpoint:
        return (lv + hv) * 0.5
    # XLA's CPU backend contracts the mix to fma(hv, hw, lv * lw): the
    # float32 product hv * hw is exact in float64, so this rounds once too
    return (hv.double() * hw.double() + (lv * lw).double()).to(torch.float32)


class Distribution:
    name = "base"
    needs_hessian = True

    def link(self, mu):
        return mu

    def linkinv(self, f):
        return f

    def init_f(self, y, w):
        """Intercept-only fit: the link of the weighted mean response
        (floored at EPS for the log-link count families)."""
        mu = torch.sum(w * y) / torch.clamp(torch.sum(w), min=EPS)
        return self.link(torch.clamp(mu, min=EPS) if self.name in
                         ("poisson", "gamma", "tweedie") else mu)

    def gradient(self, y, f, w):
        raise NotImplementedError

    def hessian(self, y, f, w):
        raise NotImplementedError

    def deviance(self, y, f, w):
        raise NotImplementedError


class Gaussian(Distribution):
    name = "gaussian"

    def gradient(self, y, f, w):
        return w * (f - y)

    def hessian(self, y, f, w):
        return w

    def deviance(self, y, f, w):
        return w * (y - f) ** 2


class Bernoulli(Distribution):
    name = "bernoulli"

    def link(self, mu):
        mu = torch.clamp(mu, EPS, 1 - EPS)
        return _log(mu / (1 - mu))

    def linkinv(self, f):
        return _sigmoid(f)

    def gradient(self, y, f, w):
        return w * (_sigmoid(f) - y)

    def hessian(self, y, f, w):
        p = _sigmoid(f)
        return w * p * (1 - p)

    def deviance(self, y, f, w):
        p = torch.clamp(_sigmoid(f), EPS, 1 - EPS)
        return -2 * w * (y * _log(p) + (1 - y) * _log(1 - p))


class Quasibinomial(Bernoulli):
    name = "quasibinomial"


class Multinomial(Distribution):
    """Per-class bernoulli-style trees with softmax normalization; the GBM
    builder computes the softmax and the one-hot targets itself."""

    name = "multinomial"

    def gradient(self, y_1hot, p, w):
        return w * (p - y_1hot)

    def hessian(self, y_1hot, p, w):
        return w * p * (1 - p)

    def deviance(self, y_1hot, logp, w):
        return -2 * w * torch.sum(y_1hot * logp, dim=-1)


class Poisson(Distribution):
    name = "poisson"

    def link(self, mu):
        return _log(torch.clamp(mu, min=EPS))

    def linkinv(self, f):
        return _exp(f)

    def gradient(self, y, f, w):
        return w * (_exp(f) - y)

    def hessian(self, y, f, w):
        return w * _exp(f)

    def deviance(self, y, f, w):
        mu = _exp(f)
        return 2 * w * (y * _log(torch.clamp(y, min=EPS) / mu) - (y - mu))


class Gamma(Distribution):
    name = "gamma"

    def link(self, mu):
        return _log(torch.clamp(mu, min=EPS))

    def linkinv(self, f):
        return _exp(f)

    def gradient(self, y, f, w):
        return w * (1.0 - y * _exp(-f))

    def hessian(self, y, f, w):
        return w * y * _exp(-f)

    def deviance(self, y, f, w):
        mu = _exp(f)
        return 2 * w * (-_log(torch.clamp(y, min=EPS) / mu)
                        + (y - mu) / mu)


class Tweedie(Distribution):
    name = "tweedie"

    def __init__(self, tweedie_power: float = 1.5):
        if not 1.0 < tweedie_power < 2.0:
            raise ValueError(f"tweedie_power must lie in (1, 2), got "
                             f"{tweedie_power}")
        self.p = tweedie_power

    def link(self, mu):
        return _log(torch.clamp(mu, min=EPS))

    def linkinv(self, f):
        return _exp(f)

    def gradient(self, y, f, w):
        p = self.p
        return w * (-y * _exp(f * (1 - p)) + _exp(f * (2 - p)))

    def hessian(self, y, f, w):
        p = self.p
        return w * (-y * (1 - p) * _exp(f * (1 - p))
                    + (2 - p) * _exp(f * (2 - p)))

    def deviance(self, y, f, w):
        p = self.p
        mu = _exp(f)
        yp = torch.clamp(y, min=0.0)
        return 2 * w * (torch.pow(yp, 2 - p) / ((1 - p) * (2 - p))
                        - y * torch.pow(mu, 1 - p) / (1 - p)
                        + torch.pow(mu, 2 - p) / (2 - p))


class Laplace(Distribution):
    """L1 loss; the engine fits per-leaf medians."""

    name = "laplace"
    needs_hessian = False

    def init_f(self, y, w):
        return _nanquantile(torch.where(w > 0, y, torch.nan), 0.5,
                            midpoint=True)

    def gradient(self, y, f, w):
        return -w * torch.sign(y - f)

    def hessian(self, y, f, w):
        return w

    def deviance(self, y, f, w):
        return w * torch.abs(y - f)


class Quantile(Distribution):
    """Pinball loss at alpha; the engine fits per-leaf alpha-quantiles."""

    name = "quantile"
    needs_hessian = False

    def __init__(self, quantile_alpha: float = 0.5):
        self.alpha = quantile_alpha

    def init_f(self, y, w):
        return _nanquantile(torch.where(w > 0, y, torch.nan), self.alpha)

    def gradient(self, y, f, w):
        return -w * torch.where(y > f, self.alpha, self.alpha - 1.0)

    def hessian(self, y, f, w):
        return w

    def deviance(self, y, f, w):
        d = y - f
        return w * torch.where(d > 0, self.alpha * d, (self.alpha - 1.0) * d)


class Huber(Distribution):
    """Huber loss. The split search's gradients clip at the unit delta (the
    reference's documented residue); the engine fits hybrid leaves with the
    per-tree delta from ``huber_alpha``."""

    name = "huber"
    needs_hessian = False

    def __init__(self, huber_alpha: float = 0.9):
        self.huber_alpha = huber_alpha
        self.delta = 1.0

    def gradient(self, y, f, w):
        d = y - f
        return -w * torch.where(torch.abs(d) <= self.delta, d,
                                self.delta * torch.sign(d))

    def hessian(self, y, f, w):
        return w

    def deviance(self, y, f, w):
        d = torch.abs(y - f)
        return w * torch.where(d <= self.delta, 0.5 * d * d,
                               self.delta * (d - 0.5 * self.delta))


class NegativeBinomial(Distribution):
    name = "negativebinomial"

    def __init__(self, theta: float = 1.0):
        self.theta = theta

    def link(self, mu):
        return _log(torch.clamp(mu, min=EPS))

    def linkinv(self, f):
        return _exp(f)

    def gradient(self, y, f, w):
        mu = _exp(f)
        return w * (mu * (1 + self.theta * y) / (1 + self.theta * mu) - y)

    def hessian(self, y, f, w):
        mu = _exp(f)
        return w * mu * (1 + self.theta * y) / (1 + self.theta * mu) ** 2

    def deviance(self, y, f, w):
        mu = _exp(f)
        t = 1.0 / self.theta
        return 2 * w * (y * _log(torch.clamp(y, min=EPS) / mu)
                        - (y + t) * _log((y + t) / (mu + t)))


_REGISTRY = {c.name: c for c in (
    Gaussian, Bernoulli, Quasibinomial, Multinomial, Poisson, Gamma, Tweedie,
    Laplace, Quantile, Huber, NegativeBinomial)}


def get_distribution(name: str, **params) -> Distribution:
    """The distribution named ``name`` (``auto`` -> gaussian), given the
    parameters its constructor takes of ``tweedie_power``,
    ``quantile_alpha``, ``huber_alpha`` and ``theta``."""
    name = (name or "gaussian").lower()
    if name == "auto":
        name = "gaussian"
    if name not in _REGISTRY:
        raise ValueError(f"unknown distribution '{name}' "
                         f"(supported: {sorted(_REGISTRY)})")
    cls = _REGISTRY[name]
    sig = inspect.signature(cls.__init__)
    return cls(**{k: v for k, v in params.items() if k in sig.parameters})
