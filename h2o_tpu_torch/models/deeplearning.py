"""DeepLearning — MLP and autoencoder (``h2o_tpu/models/deeplearning.py``).

Synchronous minibatch SGD, as the reference trains it (it replaces the
reference's Hogwild! replicas, SURVEY.md §7.6d): one forward and backward
pass per minibatch of at least 32 rows, gradients from ``torch.autograd``,
then the optimizer update written out as optax 0.2.6 computes it —
``adadelta(learning_rate=1.0, rho, eps)`` (the reference default) or
``sgd(rate, momentum)`` — with the optimizer state kept in optax's shape
(``e_g``/``e_x`` per parameter, or the momentum ``trace``) so checkpoints
and ``from_reference`` carry it. Parameter surface: hidden layout,
Rectifier/Tanh/Maxout with or without dropout, input and hidden dropout,
epochs, ADADELTA or rate/momentum SGD, l1/l2, the loss by distribution,
standardization through ``DataInfo``, and the autoencoder with
reconstruction-MSE scoring, ``anomaly`` and ``deepfeatures``.

Every draw is the reference's ``jax.random`` stream
(``utils/threefry.py``): the UniformAdaptive init through the reference's
``split`` chain, each epoch's shuffle ``permutation(fold_in(fold_in(key,
1), epoch), plen)`` and each step's dropout key ``fold_in(key, 2 +
global step)``. Streams are indexed by the global step, so a checkpoint
continuation goes on with the stream and a resumed job replays the
uninterrupted one bit for bit. No step depends on unordered atomics (the
minibatch is a gather from X, which needs no gradient), so two runs at one
seed give the same weights on the card too.

The step is host-driven: eager torch issues each layer's forward,
backward and update launches, where the reference jit-fuses the step.
Products run in full float32: ``torch.backends.cuda.matmul.allow_tf32``
must be False (PyTorch's default).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ..backend.kvstore import STORE, make_key
from ..frame.frame import Frame
from ..frame.vec import Vec
from ..parallel.mesh import resolve_device
from ..utils import failpoints, threefry
from .datainfo import DataInfo
from .metrics import make_metrics
from .model_base import Model, ModelBuilder, ModelOutput, Parameters


@dataclass
class DeepLearningParameters(Parameters):
    """Mirrors `hex/schemas/DeepLearningV3` (the subset h2o-py uses)."""

    hidden: list = field(default_factory=lambda: [200, 200])
    #: publish per-layer weight/bias frames in the store (h2o-py
    #: ``model.weights(i)`` / ``model.biases(i)`` read them back)
    export_weights_and_biases: bool = False
    activation: str = "Rectifier"  # Tanh|TanhWithDropout|Rectifier|
                                   # RectifierWithDropout|Maxout|MaxoutWithDropout
    epochs: float = 10.0
    mini_batch_size: int = 1  # reference default; lifted to >= 32
    adaptive_rate: bool = True
    rho: float = 0.99
    epsilon: float = 1e-8
    rate: float = 0.005
    rate_decay: float = 1.0
    momentum_start: float = 0.0
    momentum_stable: float = 0.0
    input_dropout_ratio: float = 0.0
    hidden_dropout_ratios: list | None = None
    l1: float = 0.0
    l2: float = 0.0
    loss: str = "Automatic"  # Automatic|Quadratic|CrossEntropy|Huber|Absolute
    standardize: bool = True
    autoencoder: bool = False
    use_all_factor_levels: bool = True
    train_samples_per_iteration: int = -2
    score_interval: float = 5.0
    initial_weight_distribution: str = "UniformAdaptive"
    initial_weight_scale: float = 1.0


class ReconstructionMetrics:
    """An autoencoder's training metrics: the reconstruction MSE."""

    def __init__(self, mse: float):
        self.mse = float(mse)
        self.rmse = float(np.sqrt(mse))

    def __repr__(self):
        return f"Reconstruction(mse={self.mse:.5f})"


def _abs(x):
    """|x| whose gradient at 0 is +1, as JAX's ``abs`` has it (torch's
    is 0)."""
    return torch.where(x >= 0, x, -x)


def _act(name):
    base = name.lower().replace("withdropout", "")
    return {"rectifier": torch.relu, "tanh": torch.tanh,
            "maxout": None}[base]   # maxout: pairs of units, max


def _maxout(z):
    """The max of each pair of units. ``amax`` shares the gradient among
    tied inputs, as JAX's max reduction does."""
    return z.reshape(z.shape[0], -1, 2).amax(dim=2)


def _init_params(key, sizes, dist, scale, maxout, device):
    """UniformAdaptive init (`hex/deeplearning/Neurons.java` randomize):
    bit-equal to the reference's, through the same ``split`` chain."""
    params = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        wk, key = threefry.split(key, 2)
        units = fan_out * (2 if (maxout and i < len(sizes) - 2) else 1)
        if dist.lower() == "normal":
            W = threefry.normal(wk, (fan_in, units), device) * scale
        else:
            lim = float(np.sqrt(6.0 / (fan_in + units)))
            W = threefry.uniform(wk, (fan_in, units), device, minval=-lim,
                                 maxval=lim)
        params.append({"W": W.to(torch.float32),
                       "b": torch.zeros(units, dtype=torch.float32,
                                        device=device)})
    return params


def _dropout(h, key, ratio):
    """``h * (u >= ratio) / (1 - ratio)``, u the reference's uniform."""
    keep = threefry.uniform(key, h.shape, h.device) >= ratio
    return h * keep / (1 - ratio)


def _forward(params, X, act_name, dropout_key, in_drop, hid_drops, train):
    """fprop (`hex/deeplearning/Neurons.java` fprop chain)."""
    maxout = act_name.lower().startswith("maxout")
    act = _act(act_name)
    h = X
    if train and in_drop > 0:
        dropout_key, k = threefry.split(dropout_key, 2)
        h = _dropout(h, k, in_drop)
    L = len(params)
    for i, p in enumerate(params):
        z = h @ p["W"] + p["b"]
        if i < L - 1:
            z = _maxout(z) if maxout else act(z)
            dr = hid_drops[i] if hid_drops else 0.0
            if train and dr > 0:
                dropout_key, k = threefry.split(dropout_key, 2)
                z = _dropout(z, k, dr)
        h = z
    return h


def _loss_fn(kind, out, y, w):
    den = torch.clamp_min(w.sum(), 1.0)
    if kind == "CrossEntropy":
        logp = torch.log_softmax(out, dim=1)
        ll = -torch.gather(logp, 1, y.to(torch.int64)[:, None])[:, 0]
        return (w * ll).sum() / den
    if kind == "Reconstruction":
        return (w * ((out - y) ** 2).mean(dim=1)).sum() / den
    pred = out[:, 0] if out.dim() == 2 else out
    if kind == "Absolute":
        e = _abs(pred - y)
    elif kind == "Huber":
        d = pred - y
        e = torch.where(_abs(d) <= 1.0, 0.5 * d * d, _abs(d) - 0.5)
    else:  # Quadratic
        e = 0.5 * (pred - y) ** 2
    return (w * e).sum() / den


# ---------------------------------------------------------------------------
# optimizers, as optax 0.2.6 computes them
# ---------------------------------------------------------------------------
def _zeros_like_net(net):
    return [{n: torch.zeros_like(t) for n, t in layer.items()}
            for layer in net]


def _opt_init(p, net) -> dict:
    """optax's ``opt.init(net)``: ADADELTA's ``e_g``/``e_x``, the momentum
    ``trace``, or nothing for plain SGD."""
    if p.adaptive_rate:
        return {"e_g": _zeros_like_net(net), "e_x": _zeros_like_net(net)}
    if p.momentum_stable:
        return {"trace": _zeros_like_net(net)}
    return {}


@torch.no_grad()
def _opt_apply(p, net, grads, state) -> None:
    """One update, in place: ``net + opt.update(g, state)``. ADADELTA
    (``scale_by_adadelta`` then the learning rate 1.0): e_g ← (1−ρ)g² +
    ρe_g, u = √(e_x + ε)/√(e_g + ε)·g, e_x ← (1−ρ)u² + ρe_x, net −= u.
    SGD: trace ← g + μ·trace (with momentum), net += (−rate)·trace."""
    for i, layer in enumerate(net):
        for n, t in layer.items():
            g = grads[i][n]
            if p.adaptive_rate:
                e_g, e_x = state["e_g"][i][n], state["e_x"][i][n]
                e_g.copy_((1 - p.rho) * (g * g) + p.rho * e_g)
                u = torch.sqrt(e_x + p.epsilon) / torch.sqrt(e_g + p.epsilon) \
                    * g
                e_x.copy_((1 - p.rho) * (u * u) + p.rho * e_x)
                t.sub_(u)
            else:
                if "trace" in state:
                    tr = state["trace"][i][n]
                    tr.copy_(g + p.momentum_stable * tr)
                    g = tr
                t.add_((-p.rate) * g)


def _opt_from_reference(opt_state) -> dict:
    """The port's optimizer state from an optax chain state (a tuple of
    per-transform states): ``e_g``/``e_x`` or ``trace`` as numpy."""
    def host(tree):
        return [{n: np.asarray(t, np.float32) for n, t in layer.items()}
                for layer in tree]

    for s in opt_state or ():
        if hasattr(s, "e_g"):
            return {"e_g": host(s.e_g), "e_x": host(s.e_x)}
        if hasattr(s, "trace"):
            return {"trace": host(s.trace)}
    return {}


def _to_device(tree, dev):
    """A copy of a net or optimizer state (numpy or tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, dev) for v in tree]
    if not isinstance(tree, torch.Tensor):
        tree = torch.from_numpy(np.array(tree, np.float32))
    return tree.to(device=dev, dtype=torch.float32).clone()


class DeepLearningModel(Model):
    algo_name = "deeplearning"

    def __init__(self, params, output, net, dinfo, loss_kind, key=None,
                 opt_state=None, epochs_trained=0.0):
        self.net = net
        self.dinfo = dinfo
        self.loss_kind = loss_kind
        self.opt_state = opt_state   # optimizer slots, carried by
                                     # checkpoints like the reference's
        self.epochs_trained = epochs_trained
        super().__init__(params, output, key=key)

    @staticmethod
    def from_reference(ref, device=None) -> "DeepLearningModel":
        """Carry a JAX-trained net over from its plain fields: ``net`` (a
        list of {"W", "b"}), the optax state, the ``DataInfo`` fields, the
        loss, ``epochs_trained``, the parameters and the output. Given the
        same frame it scores what the reference scores, and a checkpoint
        continuation from it resumes the reference's optimizer state."""
        dev = resolve_device(device)
        params = DeepLearningParameters(**{
            f.name: copy.deepcopy(getattr(ref.params, f.name))
            for f in dataclasses.fields(DeepLearningParameters)
            if f.name not in ("training_frame", "validation_frame",
                              "checkpoint")})
        out = ModelOutput.carried(ref.output)
        net = _to_device([{"W": l["W"], "b": l["b"]} for l in ref.net], dev)
        return DeepLearningModel(
            params, out, net, DataInfo.carried(ref.dinfo), ref.loss_kind,
            opt_state=_to_device(_opt_from_reference(ref.opt_state), dev),
            epochs_trained=float(ref.epochs_trained))

    def adapt_frame(self, fr: Frame):
        """The ``DataInfo``-expanded design, not raw columns."""
        X, _ = self.dinfo.expand(fr)
        return X

    @torch.no_grad()
    def _raw(self, X):
        return _forward(self.net, X, self.params.activation, None, 0.0, None,
                        train=False)

    def score0(self, X):
        out = self._raw(X)
        if self.output.model_category == "Regression":
            return out[:, 0]
        probs = torch.softmax(out, dim=1)
        label = torch.argmax(probs, dim=1).to(torch.float32)
        return torch.cat([label[:, None], probs], dim=1)

    def predict(self, fr: Frame) -> Frame:
        X = self.adapt_frame(fr)
        if self.params.autoencoder:
            out = self._raw(X)
            names = [f"reconstr_{n}" for n in self.dinfo.expanded_names]
            return Frame(names, [Vec(out[:, i].contiguous(), fr.nrow)
                                 for i in range(out.shape[1])])
        return self._predictions_frame(self.score0(X), fr.nrow)

    def anomaly(self, fr: Frame) -> Frame:
        """Per-row reconstruction MSE (autoencoder anomaly detection)."""
        X = self.adapt_frame(fr)
        mse = ((self._raw(X) - X) ** 2).mean(dim=1)
        return Frame(["Reconstruction.MSE"], [Vec(mse, fr.nrow)])

    @torch.no_grad()
    def deepfeatures(self, fr: Frame, layer: int) -> Frame:
        """Hidden-layer activations (h2o-py ``model.deepfeatures(frame,
        layer)``); ``layer`` is 0-based."""
        X = self.adapt_frame(fr)
        nhidden = len(self.net) - 1
        if not (0 <= layer < nhidden):
            raise ValueError(f"layer must be in [0, {nhidden})")
        act = _act(self.params.activation)
        maxout = self.params.activation.lower().startswith("maxout")
        h = X
        for i in range(layer + 1):
            z = h @ self.net[i]["W"] + self.net[i]["b"]
            h = _maxout(z) if maxout else act(z)
        names = [f"DF.L{layer + 1}.C{j + 1}" for j in range(h.shape[1])]
        return Frame(names, [Vec(h[:, j].contiguous(), fr.nrow)
                             for j in range(h.shape[1])])


class DeepLearning(ModelBuilder):
    algo_name = "deeplearning"

    def _validate(self):
        if self.params.autoencoder:
            self.supervised = False
        super()._validate()

    #: parameters a checkpoint continuation may not change (the reference's
    #: non-modifiable list, `hex/deeplearning/DeepLearning.java:261-348`)
    _CP_FROZEN = ("hidden", "activation", "autoencoder", "standardize",
                  "use_all_factor_levels", "adaptive_rate", "loss",
                  "distribution", "response_column")

    def _resolve_checkpoint(self, cp) -> DeepLearningModel:
        prior = STORE.get(cp) if isinstance(cp, str) else cp
        if prior is None:
            raise ValueError(f"checkpoint model '{cp}' not found")
        if not isinstance(prior, DeepLearningModel):
            raise ValueError("checkpoint must be a DeepLearning model")
        pp = prior.params
        for name in self._CP_FROZEN:
            if getattr(pp, name) != getattr(self.params, name):
                raise ValueError(
                    f"checkpoint continuation cannot change '{name}' "
                    f"({getattr(pp, name)!r} -> {getattr(self.params, name)!r})")
        if self.params.epochs <= prior.epochs_trained:
            raise ValueError(
                f"epochs must exceed the checkpoint's trained epochs "
                f"({prior.epochs_trained}) to continue training")
        return prior

    def build_impl(self, job) -> DeepLearningModel:
        p: DeepLearningParameters = self.params
        fr = p.training_frame
        rs = self._take_resume_state()
        prior = (self._resolve_checkpoint(p.checkpoint)
                 if p.checkpoint is not None else None)
        if prior is not None:
            # the stored params keep the key, not the model object; the
            # prior's DataInfo keeps the restored weights' input space
            p = self.params = dataclasses.replace(p, checkpoint=prior.key)
            names = list(prior.output.names)
            dinfo = prior.dinfo
        else:
            names = self.feature_names()
            dinfo = DataInfo.make(fr, names, standardize=p.standardize,
                                  use_all_factor_levels=p.use_all_factor_levels)
        X, okrow = dinfo.expand(fr)
        dev = X.device
        plen = X.shape[0]
        rowmask = (torch.arange(plen, device=dev) < fr.nrow) & okrow

        if p.autoencoder:
            category, K, y, resp_domain = "AutoEncoder", X.shape[1], None, None
            loss_kind = "Reconstruction"
        else:
            y_dev, category, resp_domain = self.response_info()
            K = len(resp_domain) if resp_domain else 1
            y = torch.nan_to_num(y_dev)
            rowmask = rowmask & ~torch.isnan(y_dev)
            loss_kind = p.loss if p.loss not in ("Automatic", "AUTO") else (
                "CrossEntropy" if category in ("Binomial", "Multinomial")
                else "Quadratic")
        w = rowmask.to(torch.float32)
        if p.weights_column:
            w = w * torch.nan_to_num(fr.vec(p.weights_column).data)

        n_in = X.shape[1]
        n_out = n_in if p.autoencoder else (K if K > 1 else 1)
        sizes = [n_in] + list(p.hidden) + [n_out]
        seed = p.seed if p.seed not in (-1, None) else 1234
        key = threefry.prng_key(seed)
        maxout = p.activation.lower().startswith("maxout")
        if rs is not None:
            # resume: the exact weights and slots as of the last state write
            net = _to_device(rs["net"], dev)
        elif prior is not None:
            net = _to_device(prior.net, dev)
        else:
            net = _init_params(key, sizes, p.initial_weight_distribution,
                               p.initial_weight_scale, maxout, dev)
        if rs is not None and rs.get("opt_state") is not None:
            opt_state = _to_device(rs["opt_state"], dev)
        elif prior is not None and prior.opt_state is not None:
            opt_state = _to_device(prior.opt_state, dev)
        else:
            opt_state = _opt_init(p, net)

        batch = min(max(int(p.mini_batch_size), 32), plen)
        hid_drops = (list(p.hidden_dropout_ratios)
                     if p.hidden_dropout_ratios else
                     ([0.5] * len(p.hidden)
                      if "withdropout" in p.activation.lower() else None))
        dropout = p.input_dropout_ratio > 0 or any(hid_drops or ())
        leaves = [t.requires_grad_() for layer in net for t in layer.values()]

        def step(Xb, yb, wb, dk):
            out = _forward(net, Xb, p.activation, dk, p.input_dropout_ratio,
                           hid_drops, train=True)
            loss = _loss_fn(loss_kind, out, Xb if p.autoencoder else yb, wb)
            if p.l2 > 0:
                loss = loss + p.l2 * sum((q["W"] ** 2).sum() for q in net)
            if p.l1 > 0:
                loss = loss + p.l1 * sum(_abs(q["W"]).sum() for q in net)
            g = iter(torch.autograd.grad(loss, leaves))
            grads = [{n: next(g) for n in layer} for layer in net]
            _opt_apply(p, net, grads, opt_state)

        steps_per_epoch = max(plen // batch, 1)
        prior_epochs = prior.epochs_trained if prior is not None else 0.0
        total_steps = max(int((p.epochs - prior_epochs) * steps_per_epoch), 1)
        # a continuation goes on with the stream: shuffles and dropout keys
        # are indexed by the global step
        step_offset = int(round(prior_epochs * steps_per_epoch))
        perm_base = threefry.fold_in(key, 1)
        start_s = int(rs["steps_done"]) if rs is not None and \
            rs.get("steps_done") else 0   # always an epoch boundary
        perm = None
        for s in range(start_s, total_steps):
            gs = step_offset + s
            if s % steps_per_epoch == 0:
                failpoints.hit("train.dl.epoch")
                job.check_cancelled()
                if s:
                    if job.time_exceeded():  # keep the completed epochs:
                        total_steps = s      # epochs_trained stays honest
                        break
                else:
                    # no epoch finished yet: an expired budget raises
                    job.check_max_runtime()
                perm = threefry.permutation(
                    threefry.fold_in(perm_base, gs // steps_per_epoch), plen,
                    dev)
            lo = (s % steps_per_epoch) * batch
            idx = perm[lo:lo + batch]
            step(X[idx], None if y is None else y[idx], w[idx],
                 threefry.fold_in(key, 2 + gs) if dropout else None)
            if s % steps_per_epoch == steps_per_epoch - 1:
                job.update(steps_per_epoch / total_steps)
                # the recovery state at the epoch boundary, where a resume
                # re-derives the shuffle
                self._recovery_tick(
                    lambda s=s: {"algo": self.algo_name, "steps_done": s + 1,
                                 "net": net, "opt_state": opt_state},
                    progress={"steps_done": s + 1,
                              "steps_total": int(total_steps)})
        for t in leaves:
            t.requires_grad_(False)

        output = ModelOutput()
        output.names = names
        output.domains = {n: fr.vec(n).domain for n in names}
        output.model_category = category
        if not p.autoencoder:
            output.response_domain = list(resp_domain) if resp_domain else None
        model = DeepLearningModel(
            p, output, net, dinfo, loss_kind, opt_state=opt_state,
            epochs_trained=prior_epochs + total_steps / steps_per_epoch)
        if p.export_weights_and_biases:
            # per-layer weight/bias frames under store keys, the reference's
            # layout: weight frames are (units_out, units_in)
            wrefs, brefs = [], []
            for li, layer in enumerate(net):
                Wt = layer["W"].T.cpu().numpy()
                bv = layer["b"].reshape(-1).cpu().numpy()
                wk, bk = make_key(f"weights_{li}"), make_key(f"biases_{li}")
                STORE.put_keyed(Frame.from_dict(
                    {f"C{j + 1}": Wt[:, j] for j in range(Wt.shape[1])},
                    device=dev, key=wk))
                STORE.put_keyed(Frame.from_dict({"C1": bv}, device=dev,
                                                key=bk))
                wrefs.append(wk)
                brefs.append(bk)
            output.weights_keys = wrefs
            output.biases_keys = brefs
        if p.autoencoder:
            out = model._raw(X)
            mse = float((w * ((out - X) ** 2).mean(dim=1)).sum()
                        / torch.clamp_min(w.sum(), 1.0))
            output.training_metrics = ReconstructionMetrics(mse)
        else:
            raw = model.score0(X)
            ymet = torch.where(rowmask, y, torch.nan)
            output.training_metrics = make_metrics(
                category, ymet, raw,
                None if p.weights_column is None else w,
                auc_type=p.auc_type, domain=output.response_domain)
            if p.validation_frame is not None:
                output.validation_metrics = model.model_performance(
                    p.validation_frame)
        return model
