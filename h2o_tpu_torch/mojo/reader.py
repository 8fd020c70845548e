"""Standalone MOJO scorer (``h2o_tpu/mojo/reader.py``) — the
`hex/genmodel/MojoModel.java` role, host numpy with no engine dependency,
as h2o-genmodel has none on h2o-core. It reads any MOJO: the port's, the
reference's and the JVM's.

`MojoModel.load(path)` parses the zip (`ModelMojoReader.java:291` model.ini
grammar) and dispatches on `algo` to a scorer implementing the same
prediction-combination rules as the reference readers:
- gbm: accumulate tree sums, apply init_f + inverse link / GBM_rescale
  (`hex/genmodel/algos/gbm/GbmMojoModel.java:43-62`).
- drf: average over tree groups, p1 = 1 - p0 for binomial
  (`hex/genmodel/algos/drf/DrfMojoModel.java:38-58`).
- glm: categorical offset indexing + dense dot + inverse link
  (`hex/genmodel/algos/glm/GlmMojoModel.java:33-66`).
- kmeans: standardize then nearest center
  (`hex/genmodel/algos/kmeans/KMeansMojoModel.java`).
"""

from __future__ import annotations

import numpy as np

from .format import (MojoZipReader, decode_tree, parse_kv, parse_model_ini,
                     score_tree, unescape_line)


class MojoModel:
    """A loaded MOJO: metadata + a batch scorer over raw feature rows."""

    def __init__(self, info, columns, domains):
        self.info = info
        self.columns = columns          # feature columns + response (if sup.)
        self.domains = domains          # aligned with columns
        self.algo = info["algo"]
        self.category = info["category"]
        self.supervised = parse_kv(info.get("supervised"), False)
        self.n_features = parse_kv(info.get("n_features"))
        self.n_classes = parse_kv(info.get("n_classes"), 1)
        self.response_column = columns[-1] if self.supervised else None

    # -- loading -------------------------------------------------------------
    @staticmethod
    def load(path: str) -> "MojoModel":
        import os

        if os.path.isdir(path):
            # exploded MOJO directory (`FolderMojoReaderBackend` analog)
            return MojoModel._from_reader(_DirReader(path))
        zr = MojoZipReader(path)
        try:
            return MojoModel._from_reader(zr)
        finally:
            zr.close()

    @staticmethod
    def _from_reader(zr) -> "MojoModel":
        """Load from any reader backend (the top-level zip or a nested
        sub-model directory inside an ensemble MOJO — the
        `MultiModelMojoReader.NestedMojoReaderBackend` role)."""
        info, columns, dommap = parse_model_ini(zr.text("model.ini"))
        domains = [None] * len(columns)
        for ci, fname in dommap.items():
            if ci >= len(columns):
                # some JVM exports carry a response-domain file indexed past
                # n_columns; the reference skips it (ModelMojoReader.java:348)
                continue
            lines = zr.text(f"domains/{fname}").splitlines()
            domains[ci] = [unescape_line(s) for s in lines]
        algo = info.get("algo")
        if algo is None:
            # pre-`algo`-key MOJOs (mojo_version 1.0) carry only the display
            # name; the reference dispatches on it too (ModelMojoFactory)
            algo = {
                "Gradient Boosting Machine": "gbm",
                "Gradient Boosting Method": "gbm",
                "Distributed Random Forest": "drf",
                "Generalized Linear Modeling": "glm",
                "Generalized Linear Model": "glm",
                "K-means": "kmeans",
                "Deep Learning": "deeplearning",
                "Isolation Forest": "isolationforest",
                "Extended Isolation Forest": "extendedisolationforest",
                "Support Vector Machine (SVM)": "psvm",
                "SVM": "psvm",
                "Word2Vec": "word2vec",
                "Generalized Low Rank Modeling": "glrm",
                "Generalized Low Rank Model": "glrm",
                "Stacked Ensemble": "stackedensemble",
            }.get(info.get("algorithm"))
            if algo is not None:
                info["algo"] = algo  # MojoModel.__init__ reads info["algo"]
        cls = {"gbm": _TreeMojo, "drf": _TreeMojo, "glm": _GlmMojo,
               "kmeans": _KMeansMojo, "deeplearning": _DeepLearningMojo,
               "isolationforest": _IsoForMojo,
               "extendedisolationforest": _IsoForMojo,
               "pca": _PcaMojo,
               "coxph": _CoxPHMojo,
               "isotonic": _IsotonicMojo,
               "word2vec": _Word2VecMojo,
               "glrm": _GlrmMojo,
               "targetencoder": _TargetEncoderMojo,
               "upliftdrf": _UpliftMojo,
               "gam": _GamMojo,
               "rulefit": _RuleFitMojo,
               "psvm": _PsvmMojo,
               "svm": _SparkSvmMojo,
               "stackedensemble": _EnsembleMojo}.get(algo)
        if cls is None:
            raise NotImplementedError(f"no MOJO reader for algo '{algo}'")
        model = cls(info, columns, domains)
        model._read(zr)
        return model

    def _read(self, zr: MojoZipReader):
        raise NotImplementedError

    # -- scoring -------------------------------------------------------------
    def score(self, X: np.ndarray) -> np.ndarray:
        """X: (R, n_features) raw values (categoricals as domain codes).
        Returns (R,) regression / cluster labels, or (R, 1+K) [label, p...]."""
        raise NotImplementedError

    def feature_frame_matrix(self, fr) -> np.ndarray:
        """Adapt a port Frame (or a dict of numpy columns) to this model's
        feature order and domains — the EasyPredictModelWrapper role. A
        Frame's columns may lie on the card: each is copied to the host
        once, whole (``Vec.to_numpy``), and categorical codes are remapped
        onto the model's domain by level name (unseen levels become NaN)."""
        feats = self.columns[:-1] if self.supervised else self.columns
        out = np.empty((_nrow(fr, feats), len(feats)), dtype=np.float64)
        for ci, name in enumerate(feats):
            if isinstance(fr, dict):
                out[:, ci] = np.asarray(fr[name], dtype=np.float64)
                continue
            v = fr.vec(name)
            x = v.to_numpy().astype(np.float64)
            dom = self.domains[ci]
            if dom is not None and v.domain is not None \
                    and list(v.domain) != dom:
                remap = {lvl: i for i, lvl in enumerate(dom)}
                codes = np.array([remap.get(l, np.nan) for l in v.domain],
                                 dtype=np.float64)
                ok = ~np.isnan(x)
                y = np.full_like(x, np.nan)
                y[ok] = codes[x[ok].astype(np.int64)]
                x = y
            out[:, ci] = x
        return out

    def predict(self, fr) -> np.ndarray:
        return self.score(self.feature_frame_matrix(fr))


def _nrow(fr, feats) -> int:
    if isinstance(fr, dict):
        return len(np.asarray(fr[feats[0]])) if feats else 0
    return fr.nrow


# ---------------------------------------------------------------------------
class _TreeMojo(MojoModel):
    def _read(self, zr):
        self.n_groups = parse_kv(self.info.get("n_trees"))
        self.tpc = parse_kv(self.info.get("n_trees_per_class"), 1)
        self.init_f = parse_kv(self.info.get("init_f"), 0.0)
        self.distribution = self.info.get("distribution", "gaussian")
        # absent link_function falls back to the family default, exactly as
        # ModelMojoReader.readLinkFunction/defaultLinkFunction do (pre-1.2
        # GBM zips carry only `distribution`)
        default_link = {
            "bernoulli": "logit", "fractionalbinomial": "logit",
            "quasibinomial": "logit", "modified_huber": "logit",
            "ordinal": "logit",
            "multinomial": "log", "poisson": "log", "gamma": "log",
            "tweedie": "log", "negativebinomial": "log",
        }.get(self.info.get("distribution", ""), "identity")
        self.link = self.info.get("link_function", default_link)
        self.trees = []  # [group][class] -> decoded root
        for j in range(self.n_groups):
            row = []
            for i in range(self.tpc):
                name = f"trees/t{i:02d}_{j:03d}.bin"
                row.append(decode_tree(zr.blob(name)) if zr.exists(name)
                           else None)
            self.trees.append(row)

    def _tree_sums(self, X):
        sums = np.zeros((X.shape[0], self.tpc))
        for row in self.trees:
            for i, root in enumerate(row):
                if root is not None:
                    sums[:, i] += score_tree(root, X, self.domains)
        return sums

    def _linkinv(self, f):
        if self.link == "logit":
            return 1.0 / (1.0 + np.exp(-f))
        if self.link in ("log", "tweedie"):
            return np.exp(f)
        if self.link == "inverse":
            return 1.0 / np.where(np.abs(f) < 1e-12, 1e-12, f)
        return f

    def score(self, X):
        s = self._tree_sums(X)
        R = X.shape[0]
        if self.algo == "gbm":
            if self.category == "Regression":
                return self._linkinv(s[:, 0] + self.init_f)
            if self.category == "Binomial":
                p1 = self._linkinv(s[:, 0] + self.init_f)
                return np.stack([(p1 > 0.5).astype(np.float64), 1 - p1, p1],
                                axis=1)
            # multinomial: GBM_rescale = softmax over per-class sums
            m = s - s.max(axis=1, keepdims=True)
            e = np.exp(m)
            p = e / e.sum(axis=1, keepdims=True)
            return np.concatenate(
                [p.argmax(axis=1)[:, None].astype(np.float64), p], axis=1)
        # drf
        if self.category == "Regression":
            return s[:, 0] / self.n_groups
        if self.category == "Binomial" and self.tpc == 1:
            p0 = s[:, 0] / self.n_groups
            p1 = 1.0 - p0
            return np.stack([(p1 > 0.5).astype(np.float64), p0, p1], axis=1)
        tot = s.sum(axis=1, keepdims=True)
        p = np.where(tot > 0, s / np.where(tot == 0, 1, tot), 0.0)
        return np.concatenate(
            [p.argmax(axis=1)[:, None].astype(np.float64), p], axis=1)


# ---------------------------------------------------------------------------
class _GlmMojo(MojoModel):
    def _read(self, zr):
        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self.use_all = g("use_all_factor_levels", False)
        self.cats = g("cats", 0)
        self.cat_modes = np.asarray(g("cat_modes", []), dtype=np.int64)
        self.cat_offsets = np.asarray(g("cat_offsets", [0]), dtype=np.int64)
        self.nums = g("nums", 0)
        self.num_means = np.asarray(g("num_means", []), dtype=np.float64)
        self.mean_imputation = g("mean_imputation", False)
        self.beta = np.asarray(g("beta"), dtype=np.float64)
        if self.category == "Multinomial":  # flattened (K, P+1) class-major
            self.beta = self.beta.reshape(self.n_classes, -1)
        self.family = self.info.get("family", "gaussian")
        self.link = self.info.get("link", "identity")
        self.tweedie_link_power = g("tweedie_link_power", 0.0)

    def _cat_terms(self, X):
        """Per-categorical (index, valid) arrays — independent of beta, so
        multinomial scoring computes them once and reuses across classes."""
        skip = 0 if self.use_all else 1
        terms = []
        for i in range(self.cats):
            ival = X[:, i].astype(np.int64) - skip + self.cat_offsets[i]
            ok = ((ival >= self.cat_offsets[i])
                  & (ival < self.cat_offsets[i + 1]))
            terms.append((np.clip(ival, 0, None), ok))
        return terms

    def _eta(self, X, beta, cat_terms=None):
        eta = np.zeros(X.shape[0])
        for ival, ok in (cat_terms if cat_terms is not None
                         else self._cat_terms(X)):
            eta += np.where(ok, beta[np.clip(ival, 0, len(beta) - 1)], 0.0)
        ncat = self.cat_offsets[self.cats]
        eta += X[:, self.cats:self.cats + self.nums] @ beta[ncat:-1]
        return eta + beta[-1]

    def score(self, X):
        X = np.asarray(X, dtype=np.float64).copy()
        if self.mean_imputation:
            for i in range(self.cats):
                X[np.isnan(X[:, i]), i] = self.cat_modes[i]
            for i in range(self.nums):
                c = self.cats + i
                X[np.isnan(X[:, c]), c] = self.num_means[i]
        if self.category == "Multinomial":  # softmax over per-class etas
            terms = self._cat_terms(X)
            etas = np.stack([self._eta(X, self.beta[k], terms)
                             for k in range(self.beta.shape[0])], axis=1)
            e = np.exp(etas - etas.max(axis=1, keepdims=True))
            p = e / e.sum(axis=1, keepdims=True)
            return np.concatenate(
                [p.argmax(axis=1)[:, None].astype(np.float64), p], axis=1)
        eta = self._eta(X, self.beta)
        mu = self._linkinv(eta)
        if self.category == "Binomial":
            return np.stack([(mu > 0.5).astype(np.float64), 1 - mu, mu],
                            axis=1)
        return mu

    def _linkinv(self, eta):
        if self.link == "logit":
            return 1.0 / (1.0 + np.exp(-eta))
        if self.link == "log":
            return np.exp(eta)
        if self.link == "inverse":
            x = np.where(np.abs(eta) < 1e-12, 1e-12, eta)
            return 1.0 / x
        if self.link == "tweedie":
            lp = self.tweedie_link_power
            return np.exp(eta) if lp == 0 else np.power(eta, 1.0 / lp)
        return eta


# ---------------------------------------------------------------------------
class _KMeansMojo(MojoModel):
    def _read(self, zr):
        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self.standardize = g("standardize", False)
        means = g("standardize_means")
        self.means = (np.asarray(means, dtype=np.float64)
                      if means is not None else None)
        if self.standardize:
            self.mults = np.asarray(g("standardize_mults"), dtype=np.float64)
        self.centers = np.asarray(
            [g(f"center_{i}") for i in range(g("center_num"))],
            dtype=np.float64)

    def score(self, X):
        X = np.asarray(X, dtype=np.float64)
        if self.means is not None:  # engine imputes NAs with means
            X = np.where(np.isnan(X), self.means, X)
        if self.standardize:
            X = (X - self.means) * self.mults
        d2 = ((X[:, None, :] - self.centers[None, :, :]) ** 2).sum(axis=2)
        return d2.argmin(axis=1).astype(np.float64)


# ---------------------------------------------------------------------------
class _DeepLearningMojo(MojoModel):
    """`hex/genmodel/algos/deeplearning/DeeplearningMojoModel` role: numpy
    forward pass over the stored layers, with the DataInfo input spec
    (one-hot cats first, standardized numerics) replayed exactly."""

    def _read_datainfo_spec(self):
        """Shared parse of the writer's _datainfo_spec keys (DL + PCA).
        Writers always emit every key; defaults only guard hand-built zips."""
        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self.use_all = g("use_all_factor_levels", True)
        self.cats = g("cats", 0)
        self.cat_modes = np.asarray(g("cat_modes", []), dtype=np.int64)
        self.cat_offsets = np.asarray(g("cat_offsets", [0]), dtype=np.int64)
        self.nums = g("nums", 0)
        self.num_means = np.asarray(g("num_means", []), dtype=np.float64)
        self.num_sigmas = np.asarray(g("num_sigmas", []), dtype=np.float64)
        self.standardize = g("standardize", True)
        self.center = g("center", True)

    def _read(self, zr):
        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self.activation = self.info.get("activation", "Rectifier")
        # genuine JVM DL MOJOs (`DeeplearningMojoReader.java`) carry
        # `neural_network_sizes` + per-layer `weight_layer{i}`/`bias_layer{i}`
        # kv arrays; our writer's layout stores binary weight files instead
        self.jvm_layout = "neural_network_sizes" in self.info
        if self.jvm_layout:
            self.units = np.asarray(g("neural_network_sizes", []), np.int64)
            self.cats = g("cats", 0)
            self.nums = g("nums", 0)
            self.cat_offsets = np.asarray(g("cat_offsets", [0]) or [0],
                                          np.int64)
            self.norm_mul = np.asarray(g("norm_mul", []) or [], np.float64)
            self.norm_sub = np.asarray(g("norm_sub", []) or [], np.float64)
            self.norm_resp_mul = g("norm_resp_mul")
            self.norm_resp_sub = g("norm_resp_sub")
            self.use_all = g("use_all_factor_levels", True)
            self.dropout = np.asarray(g("hidden_dropout_ratios", []) or [],
                                      np.float64)
            self.distribution = self.info.get("distribution", "gaussian")
            self.default_threshold = g("default_threshold", 0.5)
            self.jvm_layers = []
            for i in range(len(self.units) - 1):
                W = np.asarray(g(f"weight_layer{i}", []), np.float64)
                b = np.asarray(g(f"bias_layer{i}", []), np.float64)
                # NeuralNetwork.formNNInputs: w[row*in + col], row = out node;
                # weights round-trip through float like convertDouble2Float
                self.jvm_layers.append((W.astype(np.float32)
                                        .astype(np.float64), b))
            return
        self._read_datainfo_spec()
        n_layers = g("n_layers")
        self.layers = []
        for i in range(n_layers):
            W = np.frombuffer(zr.blob(f"weights/w{i:02d}.bin"),
                              dtype="<f4").astype(np.float64)
            b = np.frombuffer(zr.blob(f"weights/b{i:02d}.bin"),
                              dtype="<f4").astype(np.float64)
            W = W.reshape(-1, b.shape[0])
            self.layers.append((W, b))

    def _expand(self, X):
        """Raw (R, cats+nums) codes/values -> network input, mirroring
        DataInfo.expand (impute, one-hot, standardize)."""
        R = X.shape[0]
        skip = 0 if self.use_all else 1
        blocks = []
        for i in range(self.cats):
            col = X[:, i].copy()
            card = int(self.cat_offsets[i + 1] - self.cat_offsets[i]) + skip
            bad = np.isnan(col) | (col >= card)
            col = np.where(bad, self.cat_modes[i], col).astype(np.int64)
            oh = np.zeros((R, card), dtype=np.float64)
            oh[np.arange(R), col] = 1.0
            blocks.append(oh[:, skip:])
        for i in range(self.nums):
            col = X[:, self.cats + i].copy()
            col = np.where(np.isnan(col), self.num_means[i], col)
            if self.center:
                col = col - self.num_means[i]
            if self.standardize:
                col = col / self.num_sigmas[i]
            blocks.append(col[:, None])
        return np.concatenate(blocks, axis=1)

    def _score_jvm(self, X):
        """Score a genuine JVM DL MOJO: `GenModel.setInput` input layout
        (one-hot cats with the trained NA level, standardized numerics with
        NaN→0 i.e. mean imputation) + `NeuralNetwork.formNNInputs` fprop."""
        X = np.asarray(X, dtype=np.float64)
        R = X.shape[0]
        total_cat = int(self.cat_offsets[-1])
        Z = np.zeros((R, total_cat + self.nums))
        for i in range(self.cats):
            col = X[:, i]
            lo, hi = int(self.cat_offsets[i]), int(self.cat_offsets[i + 1])
            nan = np.isnan(col)
            c = np.where(nan, 0, col).astype(np.int64)
            if self.use_all:
                idx = c + lo
            else:
                idx = np.where(c != 0, c - 1 + lo, -1)
            idx = np.where(nan | (idx >= hi), hi - 1, idx)  # NA/unseen level
            ok = idx >= 0
            Z[np.arange(R)[ok], idx[ok]] = 1.0
        for j in range(self.nums):
            d = X[:, self.cats + j]
            if self.norm_mul.size:
                d = (d - self.norm_sub[j]) * self.norm_mul[j]
            Z[:, total_cat + j] = np.where(np.isnan(d), 0.0, d)

        act_hidden = self.activation
        maxout = act_hidden.startswith("Maxout")
        h = Z
        nl = len(self.jvm_layers)
        for li, (W, b) in enumerate(self.jvm_layers):
            out = int(self.units[li + 1])
            n_in = h.shape[1]
            last = li == nl - 1
            if maxout and not last:
                k = len(b) // out
                Wk = W.reshape(out, n_in, k)  # w[k*(row*in+col)+kk]
                z = np.einsum("ri,oik->rok", h, Wk) + b.reshape(out, k)[None]
                z = z.max(axis=2)
            else:
                z = h @ W.reshape(out, n_in).T + b
            if last:
                h = z
                break
            name = act_hidden.lower().replace("withdropout", "")
            if name == "tanh":
                z = np.tanh(z)
            elif name == "exprectifier":  # ELU
                z = np.where(z >= 0, z, np.exp(np.minimum(z, 0)) - 1.0)
            elif name != "maxout":  # rectifier (default)
                z = np.maximum(z, 0.0)
            if "WithDropout" in act_hidden and li < len(self.dropout) \
                    and self.dropout[li] > 0:
                z = z * (1.0 - self.dropout[li])
            h = z
        if self.n_classes > 1:
            e = np.exp(h - h.max(axis=1, keepdims=True))
            p = e / e.sum(axis=1, keepdims=True)
            if self.n_classes == 2:
                label = (p[:, 1] >= self.default_threshold).astype(np.float64)
            else:
                label = p.argmax(axis=1).astype(np.float64)
            return np.concatenate([label[:, None], p], axis=1)
        f = h[:, 0]
        if self.norm_resp_mul is not None:
            f = f / self.norm_resp_mul + self.norm_resp_sub
        dist = self.distribution
        if dist in ("bernoulli", "quasibinomial", "modified_huber", "ordinal"):
            f = 1.0 / (1.0 + np.minimum(1e19, np.exp(-f)))
        elif dist in ("multinomial", "poisson", "gamma", "tweedie"):
            f = np.minimum(1e19, np.exp(f))
        return f

    def score(self, X):
        if self.jvm_layout:
            return self._score_jvm(X)
        h = self._expand(np.asarray(X, dtype=np.float64))
        name = self.activation.lower().replace("withdropout", "")
        L = len(self.layers)
        for i, (W, b) in enumerate(self.layers):
            z = h @ W + b
            if i < L - 1:
                if name == "maxout":
                    z = z.reshape(z.shape[0], -1, 2).max(axis=2)
                elif name == "tanh":
                    z = np.tanh(z)
                else:  # rectifier
                    z = np.maximum(z, 0.0)
            h = z
        if self.category == "Regression":
            return h[:, 0]
        e = np.exp(h - h.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        label = p.argmax(axis=1).astype(np.float64)
        return np.concatenate([label[:, None], p], axis=1)


# ---------------------------------------------------------------------------
class _IsoForMojo(MojoModel):
    """`hex/genmodel/algos/isofor` + `algos/isoforextended` role. Three
    layouts: our writer's hyperplane arrays (isofor/wvec.bin), the JVM
    IsolationForest's shared compressed trees (`IsolationForestMojoModel`:
    score = (max_path − Σtree)/(max_path − min_path)), and the JVM Extended
    IsolationForest's record-stream trees (`ExtendedIsolationForestMojoModel.
    scoreTree0`: hyperplane (row−p)·n ≤ 0 goes left, score 2^(−E[h]/c(n)))."""

    def _read(self, zr):
        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self.mode = ("ours" if zr.exists("isofor/wvec.bin") else
                     "jvm_eif" if zr.exists("trees/t00.bin") else "jvm_if")
        if self.mode == "jvm_if":
            self.n_groups = g("n_trees")
            self.min_path = g("min_path_length", 0)
            self.max_path = g("max_path_length", 0)
            self.anomaly_flag = g("output_anomaly_flag", False)
            self.threshold = g("default_threshold", 0.5)
            self.jvm_trees = [decode_tree(zr.blob(f"trees/t00_{j:03d}.bin"))
                              for j in range(self.n_groups)]
            return
        if self.mode == "jvm_eif":
            self.n_groups = g("ntrees", 0)
            self.sample_size = g("sample_size", 0)
            self.eif_trees = [self._parse_eif_tree(zr.blob(f"trees/t{j:02d}.bin"))
                              for j in range(self.n_groups)]
            return
        T, N = g("n_trees"), g("n_nodes")
        F = g("n_features")
        self.depth = g("max_depth")
        self.sample_size = g("sample_size")
        self.wvec = np.frombuffer(zr.blob("isofor/wvec.bin"),
                                  dtype="<f4").reshape(T, N, F).astype(np.float64)
        self.thr = np.frombuffer(zr.blob("isofor/thr.bin"),
                                 dtype="<f4").reshape(T, N).astype(np.float64)
        self.is_split = np.frombuffer(zr.blob("isofor/is_split.bin"),
                                      dtype=np.uint8).reshape(T, N).astype(bool)
        self.counts = np.frombuffer(zr.blob("isofor/counts.bin"),
                                    dtype="<f4").reshape(T, N).astype(np.float64)

    @staticmethod
    def _parse_eif_tree(buf: bytes):
        """Record stream (`ExtendedIsolationForestMojoModel.scoreTree0`):
        int32 size, then per node [int32 id, u8 type, NODE: n[size] f64 +
        p[size] f64 | LEAF: int32 num_rows] — little-endian like all MOJO
        blobs. Returns {id: ('N', n, p) | ('L', num_rows)}."""
        import struct

        size = struct.unpack_from("<i", buf, 0)[0]
        pos = 4
        nodes = {}
        while pos < len(buf):
            nid, typ = struct.unpack_from("<iB", buf, pos)
            pos += 5
            if typ == ord("N"):
                n = np.frombuffer(buf, "<f8", size, pos)
                p = np.frombuffer(buf, "<f8", size, pos + 8 * size)
                pos += 16 * size
                nodes[nid] = ("N", n, p)
            elif typ == ord("L"):
                num_rows = struct.unpack_from("<i", buf, pos)[0]
                # precompute the c(num_rows) leaf constant: the traversal
                # loop is per row per tree, the constant never changes
                nodes[nid] = ("L", float(
                    _IsoForMojo._c_unsuccessful(num_rows)))
                pos += 4
            elif typ == 0:  # AutoBuffer zero padding after the last record
                break
            else:
                raise ValueError(f"unknown EIF node type {typ}")
        return nodes

    @staticmethod
    def _avg_path(n):
        n = np.maximum(n, 2.0)
        H = np.log(n - 1.0) + 0.5772156649
        return 2.0 * H - 2.0 * (n - 1.0) / n

    def _score_jvm_if(self, X):
        """`IsolationForestMojoModel.unifyPreds`: path-length sum over the
        shared-format trees, normalized by the stored min/max path lengths."""
        psum = np.zeros(X.shape[0])
        for root in self.jvm_trees:
            psum += score_tree(root, X, self.domains)
        mp = psum / max(self.n_groups, 1)
        if self.max_path > self.min_path:
            score = (self.max_path - psum) / (self.max_path - self.min_path)
        else:
            score = np.ones(X.shape[0])
        if self.anomaly_flag:
            label = (score > self.threshold).astype(np.float64)
            return np.stack([label, score, mp], axis=1)
        return np.stack([score, mp], axis=1)

    @staticmethod
    def _c_unsuccessful(n):
        """`MathUtils.averagePathLengthOfUnsuccessfulSearch` exactly."""
        n = np.asarray(n, dtype=np.float64)
        out = np.zeros_like(n)
        out = np.where(n == 2, 1.0, out)
        big = n > 2
        nb = np.where(big, n, 3.0)
        out = np.where(big, 2.0 * (np.log(nb - 1.0) + 0.5772156649)
                       - 2.0 * (nb - 1.0) / nb, out)
        return out

    def _score_jvm_eif(self, X):
        X = np.asarray(X, dtype=np.float64)
        R = X.shape[0]
        plen = np.zeros(R)
        for nodes in self.eif_trees:
            for r in range(R):
                nid, height = 0, 0
                while True:
                    kind = nodes[nid]
                    if kind[0] == "L":
                        plen[r] += height + kind[1]
                        break
                    _, n, p = kind
                    mul = float(np.dot(X[r] - p, n))
                    nid = 2 * nid + 1 if mul <= 0 else 2 * nid + 2
                    height += 1
        eh = plen / max(self.n_groups, 1)
        cn = float(self._c_unsuccessful(self.sample_size))
        score = np.power(2.0, -eh / max(cn, 1e-12))
        return np.stack([score, eh], axis=1)

    def score(self, X):
        if self.mode == "jvm_if":
            return self._score_jvm_if(np.asarray(X, dtype=np.float64))
        if self.mode == "jvm_eif":
            return self._score_jvm_eif(X)
        X = np.nan_to_num(np.asarray(X, dtype=np.float64))
        R = X.shape[0]
        T = self.wvec.shape[0]
        hsum = np.zeros(R)
        for t in range(T):
            node = np.zeros(R, dtype=np.int64)
            depth_at = np.zeros(R)
            for d in range(self.depth):
                # a row parked at a non-split node stays parked: the
                # traversal self-terminates, no done-mask needed
                split = self.is_split[t, node]
                proj = np.einsum("rf,rf->r", X, self.wvec[t, node])
                right = proj > self.thr[t, node]
                nxt = 2 * node + 1 + right.astype(np.int64)
                node = np.where(split, nxt, node)
                depth_at = np.where(split, depth_at + 1, depth_at)
            # unresolved leaves contribute the subtree-size correction
            c_term = np.where(self.counts[t, node] > 1,
                              self._avg_path(self.counts[t, node]), 0.0)
            hsum += depth_at + c_term
        eh = hsum / T
        cn = self._avg_path(np.asarray(float(self.sample_size)))
        score = np.power(2.0, -eh / cn)
        return score


# ---------------------------------------------------------------------------
class _PcaMojo(_DeepLearningMojo):
    """`hex/genmodel/algos/pca/PCAMojoModel` role. Reuses the DL reader's
    DataInfo input replay (_expand); scores (expand(x) − μ) @ V."""

    def _read(self, zr):
        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self._read_datainfo_spec()
        k = g("k")
        self.V = np.frombuffer(zr.blob("pca/eigenvectors.bin"),
                               dtype="<f8").reshape(-1, k)
        self.mu = np.frombuffer(zr.blob("pca/mu.bin"), dtype="<f8")

    def score(self, X):
        Z = self._expand(np.asarray(X, dtype=np.float64))
        return (Z - self.mu) @ self.V


# ---------------------------------------------------------------------------
class _CoxPHMojo(_DeepLearningMojo):
    """`hex/genmodel/algos/coxph/CoxPHMojoModel` role: centered linear
    predictor over the DataInfo-expanded design."""

    def _read(self, zr):
        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self._read_datainfo_spec()
        self.beta = np.asarray(g("beta"), dtype=np.float64)
        self.mean_x = np.asarray(g("mean_x"), dtype=np.float64)

    def score(self, X):
        Z = self._expand(np.asarray(X, dtype=np.float64))
        return (Z - self.mean_x) @ self.beta


# ---------------------------------------------------------------------------
class _IsotonicMojo(MojoModel):
    """`hex/genmodel/algos/isotonic/IsotonicRegressionMojoModel` role:
    piecewise-linear interpolation over the fitted thresholds, clamped."""

    def _read(self, zr):
        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self.xs = np.asarray(g("thresholds_x"), dtype=np.float64)
        self.ys = np.asarray(g("thresholds_y"), dtype=np.float64)
        self.out_of_bounds = self.info.get("out_of_bounds", "clip")

    def score(self, X):
        x = np.asarray(X, dtype=np.float64)[:, 0]
        out = np.interp(x, self.xs, self.ys)
        if self.out_of_bounds == "NA":
            out = np.where((x < self.xs[0]) | (x > self.xs[-1]), np.nan, out)
        return np.where(np.isnan(x), np.nan, out)


# ---------------------------------------------------------------------------
class _Word2VecMojo(MojoModel):
    """`hex/genmodel/algos/word2vec/Word2VecMojoModel` role: word → embedding
    lookup (plus cosine synonyms, the `h2o.find_synonyms` surface)."""

    def _read(self, zr):
        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self.vec_size = g("vec_size")
        if zr.exists("vocabulary"):
            # genuine JVM layout (`Word2VecMojoReader.java`): `vocabulary`
            # text + `vectors` floats written through a plain ByteBuffer
            # (big-endian, unlike the little-endian tree blobs)
            words = [unescape_line(w)
                     for w in zr.text("vocabulary").splitlines()]
            self.vocab = {w: i for i, w in enumerate(words)}
            self.vectors = np.frombuffer(
                zr.blob("vectors"),
                dtype=">f4").reshape(len(words), self.vec_size).astype(np.float64)
            self._norm = self.vectors / np.maximum(
                np.linalg.norm(self.vectors, axis=1, keepdims=True), 1e-12)
            return
        words = [unescape_line(w)
                 for w in zr.text("word2vec/words.txt").splitlines()]
        self.vocab = {w: i for i, w in enumerate(words)}
        self.vectors = np.frombuffer(
            zr.blob("word2vec/vectors.bin"),
            dtype="<f4").reshape(len(words), self.vec_size).astype(np.float64)
        self._norm = self.vectors / np.maximum(
            np.linalg.norm(self.vectors, axis=1, keepdims=True), 1e-12)

    def transform(self, words) -> np.ndarray:
        """(len(words), vec_size); unknown words → NaN rows."""
        out = np.full((len(words), self.vec_size), np.nan)
        for i, w in enumerate(words):
            j = self.vocab.get(w)
            if j is not None:
                out[i] = self.vectors[j]
        return out

    def find_synonyms(self, word: str, count: int = 20):
        j = self.vocab.get(word)
        if j is None:
            return {}
        sims = self._norm @ self._norm[j]
        order = np.argsort(-sims)
        inv = {i: w for w, i in self.vocab.items()}
        out = {}
        for i in order:
            if i != j:
                out[inv[int(i)]] = float(sims[i])
                if len(out) >= count:
                    break
        return out

    def score(self, X):
        raise NotImplementedError("word2vec MOJOs score words, not rows — "
                                  "use transform()/find_synonyms()")


# ---------------------------------------------------------------------------
class _GlrmMojo(_DeepLearningMojo):
    """`hex/genmodel/algos/glrm/GlrmMojoModel` role: project a row onto the
    archetypes (masked least squares, the X-update the reference iterates at
    scoring time) and emit the reconstruction in expanded space."""

    def _read(self, zr):
        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self.permutation = None
        if "ncolY" in self.info:
            # genuine JVM layout (`GlrmMojoReader.java`): kv geometry +
            # big-endian archetypes blob (plain ByteBuffer putDouble);
            # cols_permutation reorders raw columns into cats-first order
            nrowY, ncolY = g("nrowY"), g("ncolY")
            self.Y = np.frombuffer(zr.blob("archetypes"),
                                   dtype=">f8").reshape(nrowY, ncolY)
            self.cats = g("num_categories", 0)
            self.nums = g("num_numeric", 0)
            self.cat_offsets = np.asarray(g("catOffsets", [0]) or [0],
                                          np.int64)
            self.cat_modes = np.zeros(self.cats, np.int64)
            self.use_all = True  # GLRM expands all factor levels
            norm_sub = np.asarray(g("norm_sub", []) or [], np.float64)
            norm_mul = np.asarray(g("norm_mul", []) or [], np.float64)
            self.standardize = self.center = norm_mul.size > 0
            self.num_means = (norm_sub if norm_sub.size
                              else np.zeros(self.nums))
            with np.errstate(divide="ignore"):
                self.num_sigmas = (1.0 / norm_mul if norm_mul.size
                                   else np.ones(self.nums))
            perm = g("cols_permutation")
            if perm is not None:
                self.permutation = np.asarray(perm, np.int64)
            return
        self._read_datainfo_spec()
        k = g("k")
        self.Y = np.frombuffer(zr.blob("glrm/archetypes.bin"),
                               dtype="<f8").reshape(k, -1)

    def _mask(self, X):
        """Expanded-space validity mask from raw-column NAs."""
        blocks = []
        for i in range(self.cats):
            card = int(self.cat_offsets[i + 1] - self.cat_offsets[i])
            blocks.append(np.repeat(~np.isnan(X[:, i])[:, None], card, axis=1))
        for i in range(self.nums):
            blocks.append(~np.isnan(X[:, self.cats + i])[:, None])
        return np.concatenate(blocks, axis=1).astype(np.float64)

    def project(self, X):
        X = np.asarray(X, dtype=np.float64)
        if self.permutation is not None:
            X = X[:, self.permutation]
        A = self._expand(X)
        M = self._mask(X)
        Y = self.Y
        k = Y.shape[0]
        G = np.einsum("km,rm,lm->rkl", Y, M, Y) + 1e-6 * np.eye(k)
        b = np.einsum("km,rm,rm->rk", Y, M, np.where(M > 0, A, 0.0))
        return np.linalg.solve(G, b[..., None])[..., 0]

    def score(self, X):
        return self.project(X) @ self.Y


# ---------------------------------------------------------------------------
class _TargetEncoderMojo(MojoModel):
    """`hex/genmodel/algos/targetencoder/TargetEncoderMojoModel` role: the
    no-leakage encoding path (posterior mean, optional blending)."""

    def _read(self, zr):
        import json

        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self.blending = g("blending", False)
        self.inflection_point = g("inflection_point", 10.0)
        self.smoothing = g("smoothing", 20.0)
        self.prior = np.asarray(g("prior"), dtype=np.float64)
        tables = json.loads(zr.text("targetencoder/tables.json"))
        self.tables = {c: (np.asarray(t["num"], dtype=np.float64),
                           np.asarray(t["den"], dtype=np.float64))
                       for c, t in tables.items()}
        self.encoded_columns = list(self.tables)

    def score(self, X):
        """X columns ordered as self.columns[:-1]; returns the te columns
        stacked (R, sum of per-column target dims)."""
        X = np.asarray(X, dtype=np.float64)
        outs = []
        for ci, col in enumerate(self.encoded_columns):
            num, den = self.tables[col]
            card = num.shape[0] - 1          # last slot = NA bucket
            codes = X[:, ci]
            ok = ~np.isnan(codes) & (codes < card)
            idx = np.where(ok, codes, card).astype(np.int64)
            row_num, row_den = num[idx], den[idx][:, None]
            with np.errstate(invalid="ignore", divide="ignore"):
                post = row_num / np.maximum(row_den, 1e-300)
            if self.blending:
                lam = 1.0 / (1.0 + np.exp(np.clip(
                    (self.inflection_point - row_den) /
                    max(self.smoothing, 1e-12), -60, 60)))
                val = lam * post + (1.0 - lam) * self.prior[None, :]
            else:
                val = post
            # unseen/NA levels (den=0) fall back to the prior, exactly as the
            # engine does after blending (target_encoder.py transform)
            val = np.where(row_den > 0, val, self.prior[None, :])
            outs.append(val)
        return np.concatenate(outs, axis=1)


# ---------------------------------------------------------------------------
class _UpliftMojo(MojoModel):
    """`hex/genmodel/algos/upliftdrf` role: paired treatment/control tree
    groups; emits [uplift, p_y1_ct1, p_y1_ct0]."""

    def _read(self, zr):
        self.n_trees = parse_kv(self.info.get("n_trees"))
        self.trees_t, self.trees_c = [], []
        for j in range(self.n_trees):
            self.trees_t.append(decode_tree(zr.blob(f"trees/t00_{j:03d}.bin")))
            self.trees_c.append(decode_tree(zr.blob(f"trees/t01_{j:03d}.bin")))

    def score(self, X):
        X = np.asarray(X, dtype=np.float64)
        pt = np.zeros(X.shape[0])
        pc = np.zeros(X.shape[0])
        for rt, rc in zip(self.trees_t, self.trees_c):
            pt += score_tree(rt, X)
            pc += score_tree(rc, X)
        pt /= self.n_trees
        pc /= self.n_trees
        return np.stack([pt - pc, pt, pc], axis=1)


# ---------------------------------------------------------------------------
class _GamMojo(_DeepLearningMojo):
    """`hex/genmodel/algos/gam/GamMojoModel` role: [linear-expanded | spline
    bases] design, eta → linkinv."""

    def _read(self, zr):
        import json

        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self._read_datainfo_spec()
        self.beta = np.asarray(g("beta"), dtype=np.float64)
        self.link = self.info.get("link", "identity")
        self.n_lin = g("n_lin", 0)
        self.gam_specs = json.loads(zr.text("gam/specs.json"))

    _linkinv = _GlmMojo._linkinv
    tweedie_link_power = 0.0

    def score(self, X):
        from .format import gam_basis

        X = np.asarray(X, dtype=np.float64)
        blocks = []
        if self.n_lin:
            blocks.append(self._expand(X[:, :self.n_lin]))
        for gi, spec in enumerate(self.gam_specs):
            x = X[:, self.n_lin + gi]
            B = gam_basis(x, spec)
            blocks.append(B - np.asarray(spec["col_means"])[None, :])
        D = np.concatenate(blocks, axis=1)
        eta = D @ self.beta[:-1] + self.beta[-1]
        mu = self._linkinv(eta)
        if self.category == "Binomial":
            return np.stack([(mu > 0.5).astype(np.float64), 1 - mu, mu],
                            axis=1)
        return mu


# ---------------------------------------------------------------------------
class _RuleFitMojo(MojoModel):
    """`hex/genmodel/algos/rulefit/RuleFitMojoModel` role: rule-membership
    design + standardized linear terms, linear model on top."""

    def _read(self, zr):
        import json

        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self.beta = np.asarray(g("beta"), dtype=np.float64)
        self.link = self.info.get("link", "identity")
        spec = json.loads(zr.text("rulefit/spec.json"))
        self.spec = spec
        self.n_rules = g("n_rules", 0)

    _linkinv = _GlmMojo._linkinv
    tweedie_link_power = 0.0

    def score(self, X):
        X = np.asarray(X, dtype=np.float64)
        s = self.spec
        blocks = []
        if self.n_rules:
            fidx = np.asarray(s["fidx"], dtype=np.int64)
            thr = np.asarray(s["thr"], dtype=np.float64)
            is_gt = np.asarray(s["is_gt"], dtype=bool)
            na_left = np.asarray(s["na_left"], dtype=bool)
            act = np.asarray(s["act"], dtype=bool)
            xv = X[:, fidx]                       # (R, rules, L)
            isna = np.isnan(xv)
            le = np.where(isna, na_left, xv <= thr)
            cond = np.where(is_gt, ~le, le)
            cond = np.where(act, cond, True)
            blocks.append(np.all(cond, axis=2).astype(np.float64))
        if s["lin_names"]:
            feats = self.columns[:-1] if self.supervised else self.columns
            mus = np.asarray(s["lin_means"])
            sgs = np.asarray(s["lin_sigmas"])
            cols = []
            for n, mu, sg in zip(s["lin_names"], mus, sgs):
                col = X[:, feats.index(n)]
                col = np.where(np.isnan(col), mu, col)
                cols.append((col - mu) / sg)
            blocks.append(np.stack(cols, axis=1))
        D = np.concatenate(blocks, axis=1)
        eta = D @ self.beta[:-1] + self.beta[-1]
        mu = self._linkinv(eta)
        if self.category == "Binomial":
            return np.stack([(mu > 0.5).astype(np.float64), 1 - mu, mu],
                            axis=1)
        return mu


# ---------------------------------------------------------------------------
class _PsvmMojo(_DeepLearningMojo):
    """`hex/genmodel/algos/psvm/SvmMojoModel` role: Nystrom (or linear)
    decision function over the DataInfo-expanded features."""

    def _read(self, zr):
        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self._read_datainfo_spec()
        self.gamma = g("gamma", 0.0)
        self.bias = g("bias", 0.0)
        self.kernel = self.info.get("kernel", "gaussian")
        self.beta = np.frombuffer(zr.blob("psvm/beta.bin"), dtype="<f8")
        if self.kernel == "gaussian":
            lm = np.frombuffer(zr.blob("psvm/landmarks.bin"), dtype="<f8")
            wh = np.frombuffer(zr.blob("psvm/whiten.bin"), dtype="<f8")
            m = int(round(np.sqrt(wh.shape[0])))
            self.whiten = wh.reshape(m, m)
            self.landmarks = lm.reshape(m, -1)
        else:
            self.landmarks = self.whiten = None

    def score(self, X):
        Z = self._expand(np.asarray(X, dtype=np.float64))
        if self.landmarks is not None:
            d2 = (np.sum(Z * Z, axis=1, keepdims=True)
                  - 2.0 * Z @ self.landmarks.T
                  + np.sum(self.landmarks ** 2, axis=1)[None, :])
            Z = np.exp(-self.gamma * np.maximum(d2, 0.0)) @ self.whiten
        f = Z @ self.beta + self.bias
        p1 = 1.0 / (1.0 + np.exp(-2.0 * f))
        return np.stack([(f > 0).astype(np.float64), 1 - p1, p1], axis=1)


# ---------------------------------------------------------------------------
class _DirReader:
    """Reader backend over an exploded MOJO directory — the reference's
    `FolderMojoReaderBackend` analog (used by its own test fixtures)."""

    def __init__(self, root: str):
        self._root = root

    def _p(self, name: str) -> str:
        import os

        return os.path.join(self._root, name)

    def text(self, name: str) -> str:
        with open(self._p(name), "r", encoding="utf-8") as fh:
            return fh.read()

    def blob(self, name: str) -> bytes:
        with open(self._p(name), "rb") as fh:
            return fh.read()

    def exists(self, name: str) -> bool:
        import os

        return os.path.exists(self._p(name))


class _SparkSvmMojo(MojoModel):
    """`hex/genmodel/algos/svm/SvmMojoModel` role (the Sparkling-Water linear
    SVM, distinct from PSVM): dense dot + interceptor, with the reference's
    exact threshold/label emission."""

    def _read(self, zr):
        g = lambda k, d=None: parse_kv(self.info.get(k), d)
        self.mean_imputation = g("meanImputation", False)
        self.means = np.asarray(g("means", []) or [], np.float64)
        self.weights = np.asarray(g("weights", []), np.float64)
        self.interceptor = g("interceptor", 0.0)
        self.default_threshold = g("defaultThreshold", 0.0)
        self.threshold = g("threshold", 0.0)

    def score(self, X):
        X = np.asarray(X, dtype=np.float64)
        if self.mean_imputation and self.means.size:
            X = np.where(np.isnan(X), self.means[None, :X.shape[1]], X)
        f = X @ self.weights[:X.shape[1]] + self.interceptor
        if self.n_classes == 1:
            return f
        hi = f > self.threshold
        p1 = np.where(hi, np.maximum(f, self.default_threshold),
                      np.where(f >= self.default_threshold,
                               self.default_threshold - 1, f))
        p0 = np.where(hi, p1 - 1, p1 + 1)
        return np.stack([hi.astype(np.float64), p0, p1], axis=1)


class _PrefixReader:
    """Reader backend view into a sub-directory of the parent zip — the
    `MultiModelMojoReader.NestedMojoReaderBackend` analog."""

    def __init__(self, parent, prefix: str):
        self._parent = parent
        self._prefix = prefix

    def text(self, name: str) -> str:
        return self._parent.text(self._prefix + name)

    def blob(self, name: str) -> bytes:
        return self._parent.blob(self._prefix + name)

    def exists(self, name: str) -> bool:
        return self._parent.exists(self._prefix + name)


class _EnsembleMojo(MojoModel):
    """`hex/genmodel/algos/ensemble/StackedEnsembleMojoModel` +
    `StackedEnsembleMojoReader` role: sub-model MOJOs live as nested
    directories inside the same zip (``submodel_key_i``/``submodel_dir_i``
    in model.ini — the `MultiModelMojoReader` convention), the meta-features
    are the base predictions in ``base_model{i}`` index order, and the
    metalearner scores that row (with the optional Logit transform)."""

    def _read(self, zr):
        if "submodel_count" not in self.info:
            # pre-round-2 exports from this framework: nested base_{i}.zip
            # blobs plus an ensemble/mapping.json. Kept as a read-only
            # fallback so earlier exports still load.
            self._read_legacy(zr)
            return
        self._legacy = False
        subs = {}
        for i in range(parse_kv(self.info.get("submodel_count"), 0)):
            key = self.info[f"submodel_key_{i}"]
            prefix = self.info[f"submodel_dir_{i}"]
            subs[key] = MojoModel._from_reader(_PrefixReader(zr, prefix))
        self.meta = subs[self.info["metalearner"]]
        transform = self.info.get("metalearner_transform", "NONE") or "NONE"
        if transform not in ("NONE", "Logit"):
            raise NotImplementedError(
                f"metalearner_transform '{transform}' is not supported")
        self.logit_transform = transform == "Logit"
        self.base = []
        for i in range(parse_kv(self.info.get("base_models_num"), 0)):
            key = self.info.get(f"base_model{i}")
            # a missing key means the metalearner zero-weighted this slot
            # (the reference writes no entry and scores it as 0.0)
            self.base.append(subs.get(key) if key not in (None, "null")
                             else None)

    def _read_legacy(self, zr):
        import io as _io
        import json as _json

        self._legacy = True
        if not zr.exists("ensemble/mapping.json"):
            raise NotImplementedError(
                "unrecognized stacked-ensemble MOJO layout: model.ini has no "
                "submodel_count (MultiModelMojoReader convention) and the "
                "zip has no ensemble/mapping.json (this framework's "
                "pre-round-2 legacy layout); re-export with a current writer")
        spec = _json.loads(zr.text("ensemble/mapping.json"))
        self.mapping = spec["bases"]
        self.meta_features = spec["metalearner_features"]
        self.logit_transform = False
        self.base = []
        n = parse_kv(self.info.get("n_base_models"), 0)
        for i in range(n):
            sub = MojoZipReader(_io.BytesIO(zr.blob(f"models/base_{i}.zip")))
            try:
                self.base.append(MojoModel._from_reader(sub))
            finally:
                sub.close()
        sub = MojoZipReader(_io.BytesIO(zr.blob("models/metalearner.zip")))
        try:
            self.meta = MojoModel._from_reader(sub)
        finally:
            sub.close()

    def _score_legacy(self, X):
        feats = self.columns[:-1]
        level_one = {}
        for bm, mp in zip(self.base, self.mapping):
            bfeats = bm.columns[:-1] if bm.supervised else bm.columns
            Xb = X[:, [feats.index(f) for f in bfeats]]
            pred = bm.score(Xb)
            if mp["category"] == "Binomial":
                level_one[mp["key"]] = pred[:, 2]
            elif mp["category"] == "Multinomial":
                for ki, cls in enumerate(mp["response_domain"]):
                    level_one[f'{mp["key"]}/p{cls}'] = pred[:, 1 + ki]
            else:
                level_one[mp["key"]] = pred if pred.ndim == 1 else pred[:, 0]
        D = np.stack([level_one[n] for n in self.meta_features], axis=1)
        return self.meta.score(D)

    def score(self, X):
        X = np.asarray(X, dtype=np.float64)
        if getattr(self, "_legacy", False):
            return self._score_legacy(X)
        feats = self.columns[:-1] if self.supervised else self.columns
        K = self.n_classes
        R = X.shape[0]
        cols = []
        for bm in self.base:
            if bm is None:  # unused slot: the reference leaves 0.0
                cols.extend([np.zeros(R)] * (K if K > 2 else 1))
                continue
            bfeats = bm.columns[:-1] if bm.supervised else bm.columns
            Xb = X[:, [feats.index(f) for f in bfeats]]
            pred = bm.score(Xb)
            if K > 2:       # multinomial: class probabilities per base model
                cols.extend(pred[:, 1 + j] for j in range(K))
            elif K == 2:    # binomial: p1
                cols.append(pred[:, 2])
            else:           # regression: the prediction
                cols.append(pred if pred.ndim == 1 else pred[:, 0])
        D = np.stack(cols, axis=1)
        if self.logit_transform and K >= 2:
            p = np.clip(D, 1e-9, 1 - 1e-9)
            D = np.maximum(-19.0, np.log(p / (1 - p)))
        return self.meta.score(D)
