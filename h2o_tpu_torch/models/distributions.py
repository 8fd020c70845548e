"""Distributions & link functions (``h2o_tpu/models/distributions.py``):
gaussian, bernoulli and multinomial, the families ported so far. Each
supplies the link/linkinv pair, the intercept-only fit ``init_f``, and the
per-row gradient and hessian of the deviance on the link scale."""

from __future__ import annotations

import torch

EPS = 1e-10


def _sigmoid(f):
    # the reference's formula, not torch.sigmoid, so both round alike
    return 1.0 / (1.0 + torch.exp(-f))


class Distribution:
    name = "base"

    def link(self, mu):
        return mu

    def linkinv(self, f):
        return f

    def init_f(self, y, w):
        """Intercept-only fit: the link of the weighted mean response."""
        mu = torch.sum(w * y) / torch.clamp(torch.sum(w), min=EPS)
        return self.link(mu)

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
        return torch.log(mu / (1 - mu))

    def linkinv(self, f):
        return _sigmoid(f)

    def gradient(self, y, f, w):
        return w * (_sigmoid(f) - y)

    def hessian(self, y, f, w):
        p = _sigmoid(f)
        return w * p * (1 - p)

    def deviance(self, y, f, w):
        p = torch.clamp(_sigmoid(f), EPS, 1 - EPS)
        return -2 * w * (y * torch.log(p) + (1 - y) * torch.log(1 - p))


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


_PORTED = {"gaussian": Gaussian, "bernoulli": Bernoulli,
           "multinomial": Multinomial}


def get_distribution(name: str) -> Distribution:
    key = name.lower()
    if key in _PORTED:
        return _PORTED[key]()
    raise NotImplementedError(
        f"distribution '{name}' is not ported yet (ROADMAP Queue 1 item 6; "
        f"the port has {sorted(_PORTED)})")
