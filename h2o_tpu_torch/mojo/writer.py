"""MOJO export (``h2o_tpu/mojo/writer.py``) — `hex/ModelMojoWriter.java` and
the per-algo writers.

The zips are the reference's, entry for entry: a port model and the
reference model it was carried from (``from_reference``) write the same
bytes in every entry but the random ``uuid`` line of ``model.ini``. The
writers read the model's tensors once, on the host (``_np``), and write
what the reference writes:

- trees (GBM, DRF, XRT): the tree bytecode and aux blobs
  `trees/t%02d_%03d.bin` (`hex/tree/SharedTreeMojoWriter.java:81`), set
  splits as bitsets; the engine sends x <= thr left, the MOJO x >= splitVal
  right, so splitVal = nextafter(thr, +inf). A DRF's leaves are rewritten
  for the reference scorer's rule (`DrfMojoModel.java:38-58`: p0 =
  preds[1]/T): 1 - leaf - f0 binomial, leaf + f0 otherwise. A multinomial
  GBM's f0[k] is folded into the first tree group's leaves. ``algo`` is
  "drf" for a DRF or XRT forest (``cfg.drf_mode``), whatever the model's
  ``algo_name``.
- GLM: the coefficients destandardized (``glm._destandardize``), the
  categorical offsets and modes and the numeric means (the scorer
  mean-imputes and never standardizes); a multinomial beta flattened class
  by class. The ordinal family raises, as in the reference.
- KMeans (numeric features only), DeepLearning (supervised only), PCA,
  CoxPH, GAM, RuleFit and stacked ensembles (sub-model MOJOs as nested
  directories, the `MultiModelMojoReader` layout).
- isolation forests (both forms: per-node directions, cuts, split flags
  and subsample counts as blobs), isotonic regression (the fitted points
  in ``model.ini``), the target encoder (its per-level numerator and
  denominator tables as JSON, the no-leakage path) and uplift DRF (each
  tree written twice, treatment leaves as group 0 and control leaves as
  group 1, NA right).

- word2vec (the vocabulary in index order and the float32 vectors), GLRM
  (the archetypes Y in float64 and the ``DataInfo`` spec; the scorer
  projects rows by masked least squares) and PSVM (weights, and for the
  Gaussian kernel the Nyström landmarks and whitening, in float64, over
  the ``DataInfo``-expanded features).

Other algorithms raise ``NotImplementedError`` as the reference's
``export_mojo`` does (XGBoost, SVD, ANOVA GLM, ModelSelection, Aggregator);
a DT's model is a DRF forest and exports as one.
"""

from __future__ import annotations

import uuid as _uuid

import numpy as np
import torch

from .format import MojoZipWriter, build_model_ini, encode_tree, escape_line

_GBM_LINKS = {
    "bernoulli": "logit", "quasibinomial": "logit",
    "poisson": "log", "gamma": "log", "tweedie": "tweedie",
    "negativebinomial": "log",
}
_GLM_LINKS = {  # family link name -> LinkFunctionType name
    "identity": "identity", "logit": "logit", "log": "log",
    "inverse": "inverse", "tweedie": "tweedie",
}


def _np(x, dtype=None) -> np.ndarray:
    """A model field on the host: a tensor (on any device) copied once, an
    array or list as it is."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def export_mojo(model, path: str) -> str:
    """Write ``model`` to ``path`` as a MOJO zip; returns the path."""
    algo = model.algo_name
    writer = {"gbm": _write_tree_mojo, "drf": _write_tree_mojo,
              "xrt": _write_tree_mojo, "glm": _write_glm_mojo,
              "kmeans": _write_kmeans_mojo,
              "deeplearning": _write_deeplearning_mojo,
              "pca": _write_pca_mojo, "coxph": _write_coxph_mojo,
              "gam": _write_gam_mojo, "rulefit": _write_rulefit_mojo,
              "stackedensemble": _write_ensemble_mojo,
              "isolationforest": _write_isofor_mojo,
              "extendedisolationforest": _write_isofor_mojo,
              "isotonic": _write_isotonic_mojo,
              "isotonicregression": _write_isotonic_mojo,
              "targetencoder": _write_targetencoder_mojo,
              "upliftdrf": _write_uplift_mojo,
              "word2vec": _write_word2vec_mojo, "glrm": _write_glrm_mojo,
              "psvm": _write_psvm_mojo}.get(algo)
    if writer is None:
        raise NotImplementedError(f"MOJO export not implemented for '{algo}'")
    writer(model, path)
    return path


# ---------------------------------------------------------------------------
def _common_info(model, algo, algo_full, category, n_classes, columns,
                 domains, mojo_version):
    return {
        "h2o_version": "tpu-0.1.0",
        "mojo_version": mojo_version,
        "license": "Apache License Version 2.0",
        "algo": algo,
        "algorithm": algo_full,
        "endianness": "LITTLE_ENDIAN",
        "category": category,
        "uuid": str(_uuid.uuid4()),
        "supervised": category != "Clustering",
        "n_features": len(columns) - (0 if category == "Clustering" else 1),
        "n_classes": n_classes,
        "n_columns": len(columns),
        "n_domains": sum(d is not None for d in domains),
        "balance_classes": False,
        "default_threshold": float(getattr(model, "default_threshold", 0.5)),
        "prior_class_distrib": "null",
        "model_class_distrib": "null",
        "timestamp": "1970-01-01 00:00:00",
        "escape_domain_values": True,
    }


def _write_common(zw, info, columns, domains):
    zw.write_text("model.ini", build_model_ini(info, columns, domains))
    di = 0
    for dom in domains:
        if dom is not None:
            zw.write_text(f"domains/d{di:03d}.txt",
                          "\n".join(escape_line(str(x)) for x in dom) + "\n")
            di += 1


def _supervised_columns(model):
    names = list(model.output.names)
    columns = names + [model.params.response_column]
    domains = [model.output.domains.get(n) for n in names]
    domains.append(model.output.response_domain)
    return columns, domains


def _n_classes(category, response_domain) -> int:
    return {"Regression": 1, "Binomial": 2}.get(
        category, len(response_domain or []))


def _datainfo_spec(di) -> tuple[list, list, dict]:
    """(cats + nums column order, domains, info keys) for the writers whose
    scorer replays ``DataInfo.expand`` (DL, PCA, CoxPH, GAM)."""
    cats = [n for n in di.names if n in di.domains]
    nums = [n for n in di.names if n not in di.domains]
    lo = 0 if di.use_all_factor_levels else 1
    cat_offsets = [0]
    for n in cats:
        cat_offsets.append(cat_offsets[-1] + len(di.domains[n]) - lo)
    columns = cats + nums
    domains = [di.domains[n] for n in cats] + [None] * len(nums)
    info = {
        "use_all_factor_levels": di.use_all_factor_levels,
        "cats": len(cats),
        "cat_modes": [di.cat_modes[n] for n in cats],
        "cat_offsets": cat_offsets,
        "nums": len(nums),
        "num_means": [di.num_means[n] for n in nums],
        "num_sigmas": [di.num_sigmas[n] for n in nums],
        "standardize": di.standardize,
        "center": di.effective_center,
    }
    return columns, domains, info


# ---------------------------------------------------------------------------
def _write_tree_mojo(model, path: str):
    out = model.output
    category = out.model_category
    n_classes = _n_classes(category, out.response_domain)
    columns, domains = _supervised_columns(model)

    feat = _np(model.forest["feat"])
    thr = _np(model.forest["thr"])
    nanL = _np(model.forest["nanL"])
    val = _np(model.forest["val"]).astype(np.float64)
    catd, iscat, nedges, cards = model.set_split_arrays_np()
    multi = feat.ndim == 3
    T = feat.shape[0]
    K = feat.shape[1] if multi else 1
    drf = model.cfg.drf_mode
    f0 = _np(model.f0, np.float64)

    # leaves rewritten so the reference scorer's combination rule gives the
    # engine's predictions (module docstring)
    leaves = feat < 0
    if drf:
        if category == "Binomial":
            val = np.where(leaves, 1.0 - val - float(f0), val)
        else:   # regression mean / multinomial per-class probabilities
            val = np.where(leaves, val + (f0[None, :, None] if multi else
                                          float(f0)), val)
        init_f = 0.0
    elif multi:  # multinomial GBM: f0[k] folded into the first tree group
        val = val.copy()
        val[0] = np.where(leaves[0], val[0] + f0[:, None], val[0])
        init_f = 0.0
    else:
        init_f = float(f0)

    algo = "drf" if drf else "gbm"
    full = "Distributed Random Forest" if drf else "Gradient Boosting Machine"
    info = _common_info(model, algo, full, category, n_classes, columns,
                        domains, mojo_version=1.30)
    info["n_trees"] = T
    info["n_trees_per_class"] = K
    if drf:
        info["binomial_double_trees"] = False
    else:
        info["distribution"] = model.dist.name
        info["init_f"] = init_f
        info["link_function"] = _GBM_LINKS.get(model.dist.name, "identity")

    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    for j in range(T):
        for i in range(K):
            tree = (feat[j, i], thr[j, i], nanL[j, i], val[j, i]) if multi \
                else (feat[j], thr[j], nanL[j], val[j])
            cd = None if catd is None else (catd[j, i] if multi else catd[j])
            blob, aux = encode_tree(*tree, catd=cd, iscat=iscat,
                                    nedges=nedges, cards=cards)
            zw.write_blob(f"trees/t{i:02d}_{j:03d}.bin", blob)
            zw.write_blob(f"trees/t{i:02d}_{j:03d}_aux.bin", aux)
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_glm_mojo(model, path: str):
    out = model.output
    category = out.model_category
    if type(model).__name__ == "GLMOrdinalModel":
        raise NotImplementedError(
            "ordinal GLM MOJO export: follow-up (needs a threshold spec; the "
            "reference's GlmOrdinalMojoModel)")
    di = model.dinfo
    cats = [n for n, c in zip(di.names, di.is_cat) if c]
    nums = [n for n, c in zip(di.names, di.is_cat) if not c]
    columns = cats + nums + [model.params.response_column]
    domains = [di.domains[n] for n in cats] + [None] * len(nums)
    domains.append(out.response_domain)

    lo = 0 if di.use_all_factor_levels else 1
    cat_offsets = [0]
    for n in cats:
        cat_offsets.append(cat_offsets[-1] + len(di.domains[n]) - lo)

    from ..models.glm import _destandardize

    beta_out = _destandardize(_np(model.beta, np.float64), di)
    means = np.array([di.num_means[n] for n in nums])

    info = _common_info(model, "glm", "Generalized Linear Modeling", category,
                        _n_classes(category, out.response_domain), columns,
                        domains, mojo_version=1.00)
    info.update({
        "use_all_factor_levels": di.use_all_factor_levels,
        "cats": len(cats),
        "cat_modes": [di.cat_modes[n] for n in cats],
        "cat_offsets": cat_offsets,
        "nums": len(nums),
        "num_means": list(means),
        # the engine imputes at predict time in both missing-value modes,
        # so the standalone scorer does too
        "mean_imputation": True,
        # multinomial: the flattened (K, P+1) class-major matrix
        "beta": list(beta_out.ravel()),
        "family": model.family.name,
        "link": _GLM_LINKS.get(model.family.link_name, "identity"),
        "tweedie_link_power": getattr(model.family, "tweedie_link_power", 0.0),
        "dispersion_estimated": 1.0,
    })
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_kmeans_mojo(model, path: str):
    di = model.dinfo
    if any(di.is_cat):
        raise NotImplementedError(
            "KMeans MOJO export supports numeric features only (categorical "
            "columns use one-hot distance in the engine, which has no "
            "equivalent in the reference's kmeans MOJO scorer)")
    columns = list(di.names)
    domains = [None] * len(columns)
    info = _common_info(model, "kmeans", "K-means", "Clustering", 1,
                        columns, domains, mojo_version=1.00)
    info["supervised"] = False
    info["n_features"] = len(columns)
    centers = _np(model.centers_std, np.float64)
    info["standardize"] = di.standardize
    # the means are written without standardization too: the engine
    # imputes NAs with them at predict time, and so does the scorer
    info["standardize_means"] = [di.num_means[n] for n in columns]
    info["standardize_modes"] = [-1] * len(columns)
    if di.standardize:
        info["standardize_mults"] = [1.0 / di.num_sigmas[n] for n in columns]
    info["center_num"] = centers.shape[0]
    for i in range(centers.shape[0]):
        info[f"center_{i}"] = list(centers[i])
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_deeplearning_mojo(model, path: str):
    """Per-layer weight and bias blobs plus the input spec (categorical
    offsets, numeric means and sigmas), so the scorer replays
    ``DataInfo.expand``."""
    di = model.dinfo
    out = model.output
    category = out.model_category
    if category == "AutoEncoder":
        raise NotImplementedError("autoencoder MOJO export not supported "
                                  "(the reference exports supervised DL only)")
    feat_cols, feat_doms, di_info = _datainfo_spec(di)
    columns = feat_cols + [model.params.response_column]
    domains = feat_doms + [out.response_domain]
    net = [{"W": _np(l["W"]), "b": _np(l["b"])} for l in model.net]
    info = _common_info(model, "deeplearning", "Deep Learning", category,
                        _n_classes(category, out.response_domain), columns,
                        domains, mojo_version=1.00)
    info.update(di_info)
    maxout = model.params.activation.lower().startswith("maxout")
    info.update({
        "activation": model.params.activation,
        "n_layers": len(net),
        # H2O-style layer widths: maxout layers report post-max units
        "units": ([int(net[0]["W"].shape[0])]
                  + [int(l["b"].shape[0])
                     // (2 if (maxout and i < len(net) - 1) else 1)
                     for i, l in enumerate(net)]),
    })
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    for i, layer in enumerate(net):
        zw.write_blob(f"weights/w{i:02d}.bin",
                      layer["W"].astype("<f4").tobytes())
        zw.write_blob(f"weights/b{i:02d}.bin",
                      layer["b"].astype("<f4").tobytes())
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_pca_mojo(model, path: str):
    """The expanded-space eigenvectors and the input spec: the scorer
    gives (expand(x) - mu) @ V."""
    di = model.dinfo
    columns, domains, di_info = _datainfo_spec(di)

    V = _np(model.V, np.float64)      # (P, k)
    mu = _np(model.mu, np.float64)
    if mu.ndim == 0:
        mu = np.full(V.shape[0], float(mu))
    info = _common_info(model, "pca", "Principal Components Analysis",
                        "DimReduction", 1, columns, domains, mojo_version=1.00)
    info.update(di_info)
    info.update({
        "supervised": False,
        "n_features": len(columns),
        "k": int(V.shape[1]),
    })
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    zw.write_blob("pca/eigenvectors.bin", V.astype("<f8").tobytes())
    zw.write_blob("pca/mu.bin", mu.astype("<f8").tobytes())
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_coxph_mojo(model, path: str):
    """The coefficients and the centring means: the scorer gives the
    centred linear predictor (expand(x) - mean_x) . beta."""
    di = model.dinfo
    columns, domains, di_info = _datainfo_spec(di)
    columns = columns + [model.params.response_column]
    domains = domains + [None]
    info = _common_info(model, "coxph", "Cox Proportional Hazards",
                        "CoxPH", 1, columns, domains, mojo_version=1.00)
    info.update(di_info)
    info.update({
        "beta": [float(v) for v in _np(model.beta)],
        "mean_x": [float(v) for v in _np(model.mean_x)],
    })
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_gam_mojo(model, path: str):
    """The linear terms' input spec, each GAM column's spline spec (knots,
    degree, centring means) and the coefficients over [linear | bases]."""
    import json

    out = model.output
    category = out.model_category
    di = model.dinfo
    if di is not None and di.names:
        lin_cols, lin_doms, di_info = _datainfo_spec(di)
    else:
        lin_cols, lin_doms, di_info = [], [], {"cats": 0, "nums": 0}
    gam_cols = [s["column"] for s in model.gam_specs]
    columns = lin_cols + gam_cols + [model.params.response_column]
    domains = lin_doms + [None] * len(gam_cols) + [out.response_domain]
    info = _common_info(model, "gam", "Generalized Additive Model", category,
                        _n_classes(category, out.response_domain), columns,
                        domains, mojo_version=1.00)
    info.update(di_info)
    info.update({
        "beta": [float(v) for v in _np(model.beta)],
        "family": model.family.name,
        "link": model.family.link_name,
        "n_lin": len(lin_cols),
    })
    specs = [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
              for k, v in s.items()} for s in model.gam_specs]
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    zw.write_text("gam/specs.json", json.dumps(specs))
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_rulefit_mojo(model, path: str):
    """The packed rule arrays, the linear terms' standardization and the
    raw-scale coefficients over the [rules | linear] design."""
    import json

    from ..models.glm import _destandardize

    out = model.output
    category = out.model_category
    columns = list(out.names) + [model.params.response_column]
    domains = [out.domains.get(n) for n in out.names] + [out.response_domain]
    info = _common_info(model, "rulefit", "RuleFit", category,
                        _n_classes(category, out.response_domain), columns,
                        domains, mojo_version=1.00)
    g = getattr(model, "glm_model", None)
    if g is not None:   # a multinomial fit carries a sub-GLM
        beta = _destandardize(_np(g.beta, np.float64), g.dinfo)
        family_name, link_name = g.family.name, g.family.link_name
    elif getattr(model, "beta", None) is not None \
            and getattr(model, "family", None) is not None:
        # direct and streamed fits: beta is on the raw design scale
        beta = _np(model.beta, np.float64)
        family_name, link_name = model.family.name, model.family.link_name
    else:
        raise NotImplementedError(
            "MOJO export needs the model's fitted coefficients (beta + "
            "family) — this RuleFit model carries neither a sub-GLM nor a "
            "direct fit")
    info.update({
        "beta": list(beta.ravel()),
        "family": family_name,
        "link": link_name,
        "n_rules": 0 if model.rule_arrays is None
        else int(_np(model.rule_arrays[0]).shape[0]),
    })
    spec = {
        "lin_names": list(model.lin_names),
        "lin_means": ([float(v) for v in model.lin_stats[0]]
                      if model.lin_names else []),
        "lin_sigmas": ([float(v) for v in model.lin_stats[1]]
                       if model.lin_names else []),
    }
    if model.rule_arrays is not None:
        fidx, thr, is_gt, na_left, act = (_np(a) for a in model.rule_arrays)
        spec.update({"fidx": fidx.astype(int).tolist(), "thr": thr.tolist(),
                     "is_gt": is_gt.astype(int).tolist(),
                     "na_left": na_left.astype(int).tolist(),
                     "act": act.astype(int).tolist()})
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    zw.write_text("rulefit/spec.json", json.dumps(spec))
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_ensemble_mojo(model, path: str):
    """A stacked ensemble in the reference's `MultiModelMojoReader` layout
    (`hex/genmodel/algos/ensemble/StackedEnsembleMojoReader.java`): each
    sub-model's MOJO a nested directory ``models/<ALGO>/<key>/`` of the
    same zip, declared by ``submodel_count``/``submodel_key_i``/
    ``submodel_dir_i``, with ``base_models_num``, ``base_model{i}`` and
    ``metalearner`` naming the roles."""
    import os
    import shutil
    import tempfile
    import zipfile

    out = model.output
    category = out.model_category
    # the MOJO's feature columns: the union of the base models' features
    feats, doms = [], []
    for bm in model.base_models:
        for n in bm.output.names:
            if n not in feats:
                feats.append(n)
                doms.append(bm.output.domains.get(n))
    columns = feats + [model.params.response_column]
    domains = doms + [out.response_domain]
    info = _common_info(model, "stackedensemble", "Stacked Ensemble", category,
                        _n_classes(category, out.response_domain), columns,
                        domains, mojo_version=1.01)

    meta = model.metalearner
    submodels = [(str(meta.key), meta)] + [(str(bm.key), bm)
                                           for bm in model.base_models]
    seen = set()
    for key, _ in submodels:
        if key in seen:
            raise ValueError(f"duplicate sub-model key '{key}' in ensemble")
        seen.add(key)
    dirs = {key: f"models/{type(m).algo_name.upper()}/{key}/"
            for key, m in submodels}
    info["submodel_count"] = len(submodels)
    for i, (key, _) in enumerate(submodels):
        info[f"submodel_key_{i}"] = key
        info[f"submodel_dir_{i}"] = dirs[key]
    info["base_models_num"] = len(model.base_models)
    info["metalearner"] = str(meta.key)
    info["metalearner_transform"] = "NONE"
    for i, bm in enumerate(model.base_models):
        info[f"base_model{i}"] = str(bm.key)

    zw = MojoZipWriter()
    tmpdir = tempfile.mkdtemp()
    try:
        for key, m in submodels:
            sub = os.path.join(tmpdir, "sub.zip")
            export_mojo(m, sub)
            with zipfile.ZipFile(sub) as sz:
                for entry in sz.namelist():
                    zw.write_blob(dirs[key] + entry, sz.read(entry))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    _write_common(zw, info, columns, domains)
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_isofor_mojo(model, path: str):
    """Isolation forest MOJO (`hex/genmodel/algos/isofor` role): the
    per-node split vectors (one-hot for the classic forest), thresholds,
    split flags and subsample counts as blobs; the scorer reproduces
    2^(-E[path length] / c(n))."""
    out = model.output
    columns = list(out.names)
    domains = [out.domains.get(n) for n in columns]
    wvec, thr, is_split, counts = (_np(a) for a in model.forest)
    info = _common_info(model, model.algo_name, "Isolation Forest",
                        "AnomalyDetection", 1, columns, domains,
                        mojo_version=1.00)
    info.update({
        "supervised": False,
        "n_features": len(columns),
        "n_trees": int(wvec.shape[0]),
        "n_nodes": int(wvec.shape[1]),
        "max_depth": int(model.depth),
        "sample_size": int(model.sample_size),
    })
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    zw.write_blob("isofor/wvec.bin", wvec.astype("<f4").tobytes())
    zw.write_blob("isofor/thr.bin", thr.astype("<f4").tobytes())
    zw.write_blob("isofor/is_split.bin",
                  is_split.astype(np.uint8).tobytes())
    zw.write_blob("isofor/counts.bin", counts.astype("<f4").tobytes())
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_isotonic_mojo(model, path: str):
    """Isotonic MOJO (`IsotonicRegressionMojoWriter` role): the fitted
    thresholds; scoring interpolates between them, clamped to the fitted
    range."""
    columns = list(model.output.names) + [model.params.response_column]
    domains = [None] * len(columns)
    info = _common_info(model, "isotonic", "Isotonic Regression",
                        "Regression", 1, columns, domains, mojo_version=1.00)
    xs = _np(model.xs, np.float64)
    ys = _np(model.ys, np.float64)
    info.update({"n_thresholds": len(xs),
                 "thresholds_x": list(xs), "thresholds_y": list(ys),
                 "out_of_bounds": getattr(model.params, "out_of_bounds",
                                          "clip")})
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_targetencoder_mojo(model, path: str):
    """Target encoder MOJO (`TargetEncoderMojoWriter` role): per-column
    numerator and denominator tables, the prior and the blending
    parameters; the scorer applies the no-leakage path (strategy None), as
    `TargetEncoderMojoModel` does."""
    import json

    out = model.output
    cols = list(model.encodings)
    columns = cols + [model.params.response_column]
    domains = [out.domains[c] for c in cols] + [out.response_domain]
    info = _common_info(model, "targetencoder", "TargetEncoder",
                        "TargetEncoder", 1, columns, domains,
                        mojo_version=1.00)
    p = model.params
    info.update({
        "blending": bool(p.blending),
        "inflection_point": float(p.inflection_point),
        "smoothing": float(p.smoothing),
        "prior": [float(v) for v in _np(model.prior)],
        "keep_original": bool(getattr(p, "keep_original_categorical_columns",
                                      True)),
    })
    tables = {c: {"num": _np(model.encodings[c]["num"], np.float64).tolist(),
                  "den": _np(model.encodings[c]["den"], np.float64).tolist()}
              for c in cols}
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    zw.write_text("targetencoder/tables.json", json.dumps(tables))
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_uplift_mojo(model, path: str):
    """Uplift DRF MOJO (`hex/genmodel/algos/upliftdrf` role): each tree
    twice in the tree bytecode, group 0 with the treatment leaves and
    group 1 with the control leaves, NA right; the scorer averages each
    group and emits [uplift, p_y1_ct1, p_y1_ct0]."""
    out = model.output
    columns = list(out.names) + [model.params.response_column]
    domains = [out.domains.get(n) for n in out.names] + [out.response_domain]
    feat = _np(model.forest["feat"])
    thr = _np(model.forest["thr"])
    val_t = _np(model.forest["val_t"]).astype(np.float64)
    val_c = _np(model.forest["val_c"]).astype(np.float64)
    nanL = np.zeros_like(feat, dtype=bool)           # the engine sends NA right
    T = feat.shape[0]
    info = _common_info(model, "upliftdrf", "Uplift Distributed Random Forest",
                        "BinomialUplift", 2, columns, domains,
                        mojo_version=1.30)
    info.update({"n_trees": T, "n_trees_per_class": 2,
                 "max_depth": int(model.cfg.max_depth),
                 "treatment_column": model.params.treatment_column})
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    for j in range(T):
        for gi, val in ((0, val_t), (1, val_c)):
            blob, aux = encode_tree(feat[j], thr[j], nanL[j], val[j])
            zw.write_blob(f"trees/t{gi:02d}_{j:03d}.bin", blob)
            zw.write_blob(f"trees/t{gi:02d}_{j:03d}_aux.bin", aux)
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_word2vec_mojo(model, path: str):
    """Word2Vec MOJO (`Word2VecMojoWriter` role): the embedding matrix as
    one float32 blob and the vocabulary, word-aligned."""
    words = sorted(model.vocab, key=model.vocab.get)
    vectors = _np(model.vectors, "<f4")
    info = _common_info(model, "word2vec", "Word2Vec", "WordEmbedding", 1,
                        [], [], mojo_version=1.00)
    info.update({"supervised": False, "n_features": 0,
                 "vec_size": int(vectors.shape[1]),
                 "vocab_size": int(vectors.shape[0])})
    zw = MojoZipWriter()
    _write_common(zw, info, [], [])
    zw.write_text("word2vec/words.txt",
                  "\n".join(escape_line(w) for w in words) + "\n")
    zw.write_blob("word2vec/vectors.bin", vectors.tobytes())
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_glrm_mojo(model, path: str):
    """GLRM MOJO (`GlrmMojoWriter` role): the archetypes Y and the
    ``DataInfo`` spec; the scorer projects rows onto the archetypes by
    masked least squares."""
    columns, domains, di_info = _datainfo_spec(model.dinfo)
    Y = _np(model.Y, np.float64)
    info = _common_info(model, "glrm", "Generalized Low Rank Modeling",
                        "DimReduction", 1, columns, domains, mojo_version=1.00)
    info.update(di_info)
    info.update({"supervised": False, "n_features": len(columns),
                 "k": int(Y.shape[0]), "expanded": int(Y.shape[1])})
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    zw.write_blob("glrm/archetypes.bin", Y.astype("<f8").tobytes())
    zw.finish(path)


# ---------------------------------------------------------------------------
def _write_psvm_mojo(model, path: str):
    """PSVM MOJO (`SvmMojoWriter` role): the decision function's state —
    Nyström landmarks, whitening and weights, or the linear weights —
    over the ``DataInfo``-expanded features."""
    out = model.output
    feat_cols, feat_doms, di_info = _datainfo_spec(model.dinfo)
    columns = feat_cols + [model.params.response_column]
    domains = feat_doms + [out.response_domain]
    info = _common_info(model, "psvm", "PSVM", "Binomial", 2, columns,
                        domains, mojo_version=1.00)
    info.update(di_info)
    info.update({"gamma": float(model.gamma), "bias": float(model.bias),
                 "kernel": "gaussian" if model.landmarks is not None
                 else "linear",
                 "sv_count": int(model.sv_count)})
    zw = MojoZipWriter()
    _write_common(zw, info, columns, domains)
    zw.write_blob("psvm/beta.bin", _np(model.beta, "<f8").tobytes())
    if model.landmarks is not None:
        zw.write_blob("psvm/landmarks.bin",
                      _np(model.landmarks, "<f8").tobytes())
        zw.write_blob("psvm/whiten.bin", _np(model.whiten, "<f8").tobytes())
    zw.finish(path)
