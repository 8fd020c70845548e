"""TargetEncoder (``h2o_tpu/models/target_encoder.py``;
`ai/h2o/targetencoding/TargetEncoderModel.java`, `TargetEncoderHelper.java`):
each categorical column replaced by the (blended) per-level mean of the
target, with leakage control:

- ``None``        — the full-data per-level mean;
- ``LeaveOneOut`` — each row's level mean without its own target,
  ``(sum - y_i) / (cnt - 1)``;
- ``KFold``       — a row in fold f takes the other folds' sums
  (`TargetEncoderModel.java:331`).

Blending (`TargetEncoderHelper.java:236-247`): ``lambda(n) ybar_level +
(1 - lambda(n)) ybar`` with ``lambda(n) = 1 / (1 + exp((k - n) / f))``;
uniform noise in [-noise, noise] on training transforms, drawn on the
host from the reference's ``np.random.default_rng(seed)`` stream, column
by column. A multiclass target gets one encoded column per non-baseline
class.

The per-level sums and counts are one float64 ``index_add_`` per column
(and per column and fold) on the device, into a table with the NA level in
its last slot; the encode step is a gather and the blend, float64 on the
device, each encoded column rounded once to float32. Counts, and the sums
of a binary or multiclass target, are exact up to 2^53 rows a level. The
reference sums in float32, exact for those only below 2^24 rows a level
(no level of a 7M-row frame nears it), and rounds a numeric target's sums
where the port does not.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, Vec
from ..parallel.mesh import padded_len, resolve_device
from .model_base import Model, ModelBuilder, ModelOutput, Parameters


@dataclass
class TargetEncoderParameters(Parameters):
    columns_to_encode: list = field(default_factory=list)  # default: all cats
    data_leakage_handling: str = "None"  # None|LeaveOneOut|KFold
    blending: bool = False
    inflection_point: float = 10.0
    smoothing: float = 20.0
    noise: float = 0.01
    keep_original_categorical_columns: bool = True


def _target_matrix(yv: Vec, target_domain) -> torch.Tensor:
    """(R, C) float64 target on the device: per non-baseline class
    indicators for a multiclass target, ``y == 1`` for a binary one, the
    value for a numeric one (NaN where the response is NA for the last)."""
    y = yv.data
    if target_domain and len(target_domain) > 2:
        C = len(target_domain) - 1
        return torch.stack([(y == c + 1).double() for c in range(C)], dim=1)
    if target_domain:
        return (y == 1).double()[:, None]
    return y.double()[:, None]


def _level_codes(v: Vec, train_dom) -> torch.Tensor:
    """The column's codes on the training domain (levels matched by name;
    a level the training never saw, and NA, become NaN)."""
    codes = v.data
    if v.domain is not None and v.domain != train_dom:
        remap = {lvl: i for i, lvl in enumerate(train_dom)}
        lut = torch.tensor([float(remap.get(lvl, np.nan)) for lvl in v.domain],
                           dtype=torch.float32, device=codes.device)
        ok = ~torch.isnan(codes)
        codes = torch.where(ok, lut[torch.where(ok, codes, 0.0).long()],
                            torch.nan)
    return codes


def _padded_col(x: torch.Tensor, nrow: int) -> Vec:
    buf = torch.full((padded_len(nrow),), float("nan"), dtype=torch.float32,
                     device=x.device)
    buf[:nrow] = x[:nrow].to(torch.float32)
    return Vec(buf, nrow)


class TargetEncoderModel(Model):
    algo_name = "targetencoder"

    def __init__(self, params, output, encodings, prior, target_domain,
                 nfolds_seen, key=None):
        super().__init__(params, output, key=key)
        # encodings[col]: num (card+1, C), den (card+1,), fold_num
        # (F, card+1, C) and fold_den (F, card+1) or None; float64 tensors
        self.encodings = encodings
        self.prior = prior  # (C,) float64 per-class prior mean
        self.target_domain = target_domain
        self.nfolds_seen = nfolds_seen

    @staticmethod
    def from_reference(ref, device=None) -> "TargetEncoderModel":
        """Carry a JAX-trained target encoder over: its tables, prior and
        parameters."""
        dev = resolve_device(device)

        def t(a):
            return (None if a is None else
                    torch.from_numpy(np.array(a, np.float64)).to(dev))
        enc = {c: {k: t(e.get(k)) for k in ("num", "den", "fold_num",
                                                "fold_den")}
               for c, e in ref.encodings.items()}
        out = ModelOutput.carried(ref.output)
        rp = ref.params
        params = TargetEncoderParameters(
            response_column=rp.response_column, fold_column=rp.fold_column,
            columns_to_encode=list(rp.columns_to_encode),
            data_leakage_handling=rp.data_leakage_handling,
            blending=rp.blending, inflection_point=rp.inflection_point,
            smoothing=rp.smoothing, noise=rp.noise, seed=rp.seed,
            keep_original_categorical_columns=(
                rp.keep_original_categorical_columns))
        return TargetEncoderModel(
            params, out, enc, t(ref.prior),
            None if ref.target_domain is None else list(ref.target_domain),
            ref.nfolds_seen)

    def encoding_map_frame(self, col: str) -> Frame:
        """The column's encoding map (the reference's encoding map
        frame): one row per level — level, numerator (the first encoded
        class's), denominator. The tables' NA slot is left out; the
        reference's frame pairs the levels with the tables' card + 1 rows
        and refuses to build (ROADMAP Queue 3 item 29)."""
        e = self.encodings[col]
        dom = self.output.domains[col]
        dev = e["num"].device
        n = len(dom)
        cols = {col: Vec.from_numpy(np.arange(n, dtype=np.float32),
                                    type=T_CAT, domain=dom, device=dev),
                "numerator": Vec.from_numpy(e["num"][:n, 0].cpu().numpy(),
                                            device=dev),
                "denominator": Vec.from_numpy(e["den"][:n].cpu().numpy(),
                                              device=dev)}
        return Frame(list(cols), list(cols.values()))

    def _encoded_names(self, col: str) -> list[str]:
        if len(self.target_domain or []) > 2:
            return [f"{col}_{c}_te" for c in self.target_domain[1:]]
        return [f"{col}_te"]

    def transform(self, fr: Frame, as_training: bool = False,
                  noise: float | None = None) -> Frame:
        """Apply the encodings. ``as_training`` honours the leakage
        strategy (LeaveOneOut and KFold read the target and fold columns);
        otherwise the ``None`` strategy applies and no noise is added
        (`TargetEncoderModel.java:324`)."""
        p: TargetEncoderParameters = self.params
        strategy = p.data_leakage_handling if as_training else "None"
        noise = p.noise if noise is None else noise
        if not as_training:
            noise = 0.0
        rng = np.random.default_rng(p.seed if p.seed not in (-1, None)
                                    else None)
        n = fr.nrow
        out = Frame(fr.names, fr.vecs)
        y = oky = fold = None
        if strategy in ("LeaveOneOut", "KFold"):
            y = _target_matrix(fr.vec(p.response_column),
                               self.target_domain)[:n]
            oky = ~torch.isnan(fr.vec(p.response_column).data[:n])
        if strategy == "KFold":
            fold = fr.vec(p.fold_column).data[:n].long()

        for col, enc in self.encodings.items():
            train_dom = self.output.domains[col]
            card = len(train_dom)
            codes_f = _level_codes(fr.vec(col), train_dom)[:n]
            ok = ~torch.isnan(codes_f)
            codes = torch.where(ok, codes_f, float(card)).long()  # NA slot
            num, den = enc["num"], enc["den"]
            if strategy == "KFold" and enc.get("fold_num") is not None:
                f_num, f_den = enc["fold_num"], enc["fold_den"]
                fidx = torch.clamp(fold, 0, f_num.shape[0] - 1)
                row_num = num[codes] - f_num[fidx, codes]
                row_den = den[codes] - f_den[fidx, codes]
            elif strategy == "LeaveOneOut":
                sub = ok & oky   # the rows that entered the sums
                row_num = num[codes] - torch.where(sub[:, None],
                                                   torch.nan_to_num(y), 0.0)
                row_den = den[codes] - sub.double()
            else:
                row_num = num[codes]
                row_den = den[codes]
            row_den = row_den[:, None]           # against row_num's (n, C)
            post = row_num / torch.clamp(row_den, min=1e-300)
            prior = self.prior.to(codes.device)[None, :]
            if p.blending:
                lam = 1.0 / (1.0 + torch.exp(torch.clamp(
                    (p.inflection_point - row_den) / max(p.smoothing, 1e-12),
                    -60, 60)))
                val = lam * post + (1.0 - lam) * prior
            else:
                val = post
            val = torch.where(row_den > 0, val, prior)
            if noise and noise > 0:
                val = val + torch.from_numpy(rng.uniform(
                    -noise, noise, size=tuple(val.shape))).to(val.device)
            for j, name in enumerate(self._encoded_names(col)):
                out.add(name, _padded_col(val[:, j], n))
            if not p.keep_original_categorical_columns:
                out.remove(col)
        return out

    def transform_training(self, fr: Frame) -> Frame:
        return self.transform(fr, as_training=True)

    def score0(self, X):
        raise NotImplementedError("TargetEncoder transforms frames; use "
                                  "transform()")

    def predict(self, fr: Frame) -> Frame:
        return self.transform(fr, as_training=False)


class TargetEncoder(ModelBuilder):
    algo_name = "targetencoder"
    supports_cv = False  # the fold column feeds the KFold strategy

    def build_impl(self, job) -> TargetEncoderModel:
        p: TargetEncoderParameters = self.params
        fr = p.training_frame
        cols = list(p.columns_to_encode) or [
            n for n in fr.names
            if fr.vec(n).is_categorical()
            and n not in (p.response_column, p.fold_column)]
        if p.data_leakage_handling == "KFold" and not p.fold_column:
            raise ValueError("KFold leakage handling requires fold_column")
        n = fr.nrow
        yv = fr.vec(p.response_column)
        target_domain = list(yv.domain) if yv.is_categorical() else None
        Y = _target_matrix(yv, target_domain)[:n]
        ok_y = ~torch.isnan(yv.data[:n])
        prior = Y[ok_y].mean(dim=0)

        fold, nfolds = None, 0
        if p.data_leakage_handling == "KFold":
            fold = fr.vec(p.fold_column).data[:n].long()
            nfolds = int(fold.max()) + 1

        encodings, doms = {}, {}
        for col in cols:
            v = fr.vec(col)
            if not v.is_categorical():
                continue
            card = len(v.domain)
            cf = v.data[:n]
            okc = ~torch.isnan(cf) & ok_y
            codes = torch.where(okc, cf, float(card)).long()
            Yd = torch.where(okc[:, None], Y, 0.0)
            cnt = okc.double()
            num = torch.zeros((card + 1, Y.shape[1]), dtype=torch.float64,
                              device=Y.device).index_add_(0, codes, Yd)
            den = torch.zeros(card + 1, dtype=torch.float64,
                              device=Y.device).index_add_(0, codes, cnt)
            enc = {"num": num, "den": den, "fold_num": None,
                   "fold_den": None}
            if nfolds:
                seg = codes + torch.clamp(fold, 0, nfolds - 1) * (card + 1)
                m = nfolds * (card + 1)
                enc["fold_num"] = torch.zeros(
                    (m, Y.shape[1]), dtype=torch.float64, device=Y.device
                ).index_add_(0, seg, Yd).view(nfolds, card + 1, -1)
                enc["fold_den"] = torch.zeros(
                    m, dtype=torch.float64, device=Y.device
                ).index_add_(0, seg, cnt).view(nfolds, card + 1)
            encodings[col] = enc
            doms[col] = list(v.domain)

        out = ModelOutput()
        out.model_category = "TargetEncoder"
        out.names = list(encodings)
        out.domains = doms
        out.response_domain = target_domain
        return TargetEncoderModel(p, out, encodings, prior, target_domain,
                                  nfolds)
