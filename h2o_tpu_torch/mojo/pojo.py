"""POJO codegen (``h2o_tpu/mojo/pojo.py``) — Java source scorers for tree
and GLM models.

Analog of `hex/tree/TreeJCodeGen.java` + `hex/glm/GLMModel.toJavaPredict`:
emits a single compilable Java class with the reference POJO entry point
(`double[] score0(double[] data, double[] preds)`), nested per-tree methods
with NaN-aware if/else splits, and the same prediction-combination rules the
engine and the MOJO scorer use (init_f + inverse link for GBM, tree-average
for DRF, destandardized dot product + inverse link for GLM).

The source is the reference's, character for character, for the same
model: the model's tensors are read on the host once, and a DRF or XRT
forest names itself "gbm" in the class name and the header comment, as
the reference's DRF and XRT models do (their ``algo_name`` is "gbm",
ROADMAP Queue 3 item 15). The emitted code only uses `java.lang.Math` and
`Double.isNaN` — no h2o-genmodel dependency."""

from __future__ import annotations

import numpy as np

from .writer import _np


def pojo_source(model, class_name: str | None = None) -> str:
    """The generated Java source as a string — `GET /3/Models.java/{id}`
    serves this directly (`ModelsHandler.fetchJavaCode`)."""
    algo = model.algo_name
    if algo in ("gbm", "drf", "xrt"):
        return _tree_pojo(model, class_name)
    if algo == "glm":
        return _glm_pojo(model, class_name)
    raise NotImplementedError(f"POJO export not implemented for '{algo}' "
                              "(the reference generates POJOs for tree "
                              "and linear models)")


def export_pojo(model, path: str, class_name: str | None = None) -> str:
    src = pojo_source(model, class_name)
    with open(path, "w") as fh:
        fh.write(src)
    return path


def _jd(x: float) -> str:
    """Java double literal."""
    if np.isnan(x):
        return "Double.NaN"
    return repr(float(x))


def _tree_method(feat, thr, nanL, val, name: str, catd=None, iscat=None,
                 nedges=None, cards=None) -> str:
    """One tree as a recursive-descent if/else over the heap arrays.

    Categorical set-split nodes (``catd`` routing tables present) emit a
    per-node `static final boolean[]` go-right group — the POJO analog of
    the reference's GenmodelBitSet splits — indexed by the clipped level."""
    groups = []

    def emit(j, indent) -> str:
        pad = "    " * indent
        if feat[j] < 0:
            return f"{pad}return {_jd(float(val[j]))};\n"
        f, t = int(feat[j]), float(thr[j])
        na_left = bool(nanL[j])
        left, right = 2 * j + 1, 2 * j + 2
        if catd is not None and iscat is not None and iscat[f]:
            card = int(cards[f])
            bits = catd[j][np.minimum(np.arange(card), int(nedges[f]))] > 0.5
            gname = f"GRP_{name}_{j}"
            groups.append(
                f"  static final boolean[] {gname} = {{"
                + ", ".join("true" if b else "false" for b in bits) + "};\n")
            # out-of-domain codes follow the NA direction, like the engine
            # (adapt_frame maps unseen levels to NaN) and the MOJO scorer
            # (score_tree's beyond-domain -> cond); in-domain indexes GRP
            bad = (f"(Double.isNaN(data[{f}]) || data[{f}] < 0.0 "
                   f"|| data[{f}] >= {card}.0)")
            if na_left:
                cond = f"{bad} || !{gname}[(int) data[{f}]]"
            else:
                cond = f"!{bad} && !{gname}[(int) data[{f}]]"
        elif na_left:
            cond = f"Double.isNaN(data[{f}]) || data[{f}] <= {_jd(t)}"
        else:
            cond = f"!Double.isNaN(data[{f}]) && data[{f}] <= {_jd(t)}"
        s = f"{pad}if ({cond}) {{\n"
        s += emit(left, indent + 1)
        s += f"{pad}}} else {{\n"
        s += emit(right, indent + 1)
        s += f"{pad}}}\n"
        return s

    body = emit(0, 2)
    return ("".join(groups)
            + f"  static double {name}(double[] data) {{\n" + body + "  }\n")


def _tree_pojo(model, class_name) -> str:
    out = model.output
    cat = out.model_category
    feat = _np(model.forest["feat"])
    thr = _np(model.forest["thr"])
    nanL = _np(model.forest["nanL"])
    val = _np(model.forest["val"], np.float64)
    catd, iscat, nedges, cards = model.set_split_arrays_np()
    multi = feat.ndim == 3
    T = feat.shape[0]
    K = feat.shape[1] if multi else 1
    drf = model.cfg.drf_mode
    algo = _pojo_algo(model)
    cname = class_name or f"{algo}_pojo"
    f0 = np.atleast_1d(_np(model.f0, np.float64))

    methods, calls = [], [[] for _ in range(K)]
    for t in range(T):
        for k in range(K):
            nm = f"tree_{t}_{k}"
            tree = (feat[t, k], thr[t, k], nanL[t, k], val[t, k]) if multi \
                else (feat[t], thr[t], nanL[t], val[t])
            cd = None if catd is None else (catd[t, k] if multi else catd[t])
            methods.append(_tree_method(*tree, name=nm, catd=cd, iscat=iscat,
                                        nedges=nedges, cards=cards))
            calls[k].append(f"{nm}(data)")

    body = []
    if cat == "Regression":
        acc = " + ".join(calls[0]) or "0.0"
        if drf:
            body.append(f"    double f = {_jd(float(f0[0]))} + ({acc}) / {T}.0;")
            body.append("    preds[0] = f;")
        else:
            body.append(f"    double f = {_jd(float(f0[0]))} + {acc};")
            link = getattr(model.dist, "name", "gaussian")
            if link in ("poisson", "gamma", "tweedie", "negativebinomial"):
                body.append("    preds[0] = Math.exp(f);")
            else:
                body.append("    preds[0] = f;")
    elif cat == "Binomial":
        acc = " + ".join(calls[0]) or "0.0"
        if drf:
            body.append(f"    double p1 = Math.min(1.0, Math.max(0.0, "
                        f"{_jd(float(f0[0]))} + ({acc}) / {T}.0));")
        else:
            body.append(f"    double f = {_jd(float(f0[0]))} + {acc};")
            body.append("    double p1 = 1.0 / (1.0 + Math.exp(-f));")
        body.append("    preds[1] = 1.0 - p1; preds[2] = p1;")
        body.append("    preds[0] = p1 > 0.5 ? 1 : 0;")
    else:  # Multinomial
        for k in range(K):
            acc = " + ".join(calls[k]) or "0.0"
            base = f"{_jd(float(f0[k]))} + " if not drf else ""
            div = f" / {T}.0" if drf else ""
            body.append(f"    double f{k} = {base}({acc}){div};")
        if drf:
            body.append("    double tot = " +
                        " + ".join(f"Math.max(f{k}, 1e-9)"
                                   for k in range(K)) + ";")
            for k in range(K):
                body.append(f"    preds[{k + 1}] = Math.max(f{k}, 1e-9) / tot;")
        else:
            body.append("    double mx = "
                        + _nested_max([f"f{k}" for k in range(K)]) + ";")
            body.append("    double tot = 0;")
            for k in range(K):
                body.append(f"    preds[{k + 1}] = Math.exp(f{k} - mx); "
                            f"tot += preds[{k + 1}];")
            for k in range(K):
                body.append(f"    preds[{k + 1}] /= tot;")
        body.append("    int best = 1;")
        body.append(f"    for (int i = 2; i <= {K}; i++) "
                    "if (preds[i] > preds[best]) best = i;")
        body.append("    preds[0] = best - 1;")

    names = ", ".join(f'"{n}"' for n in out.names)
    return (
        f"// Auto-generated POJO scorer ({algo}); entry point\n"
        f"// matches hex.genmodel.GenModel.score0(double[], double[]).\n"
        f"public class {cname} {{\n"
        f"  public static final String[] NAMES = {{ {names} }};\n"
        f"  public static double[] score0(double[] data, double[] preds) {{\n"
        + "\n".join(body) + "\n"
        "    return preds;\n"
        "  }\n\n"
        + "\n".join(methods)
        + "}\n")


def _pojo_algo(model) -> str:
    """The name the reference's model of this forest gives its POJO: its
    DRF and XRT models report ``algo_name`` "gbm"."""
    return "gbm" if model.algo_name in ("drf", "xrt") else model.algo_name


def _nested_max(terms) -> str:
    if len(terms) == 1:
        return terms[0]
    return f"Math.max({terms[0]}, {_nested_max(terms[1:])})"


def _glm_pojo(model, class_name) -> str:
    from ..models.glm import _destandardize

    out = model.output
    cat = out.model_category
    di = model.dinfo
    cats = [n for n, c in zip(di.names, di.is_cat) if c]
    nums = [n for n, c in zip(di.names, di.is_cat) if not c]
    lo = 0 if di.use_all_factor_levels else 1
    cat_offsets = [0]
    for n in cats:
        cat_offsets.append(cat_offsets[-1] + len(di.domains[n]) - lo)
    beta = _destandardize(_np(model.beta, np.float64), di)
    if beta.ndim > 1:
        raise NotImplementedError("multinomial GLM POJO: follow-up")
    ncat = cat_offsets[-1]
    cname = class_name or "glm_pojo"
    means = [di.num_means[n] for n in nums]
    modes = [di.cat_modes[n] for n in cats]

    lines = ["    double eta = 0.0;"]
    for i, n in enumerate(cats):
        lines.append(f"    {{ int c = Double.isNaN(data[{i}]) ? {modes[i]} "
                     f": (int) data[{i}];")
        lines.append(f"      int idx = c - {lo} + {cat_offsets[i]};")
        lines.append(f"      if (idx >= {cat_offsets[i]} && "
                     f"idx < {cat_offsets[i + 1]}) eta += BETA[idx]; }}")
    for i, n in enumerate(nums):
        col = len(cats) + i
        lines.append(f"    eta += (Double.isNaN(data[{col}]) "
                     f"? {_jd(float(means[i]))} : data[{col}]) "
                     f"* BETA[{ncat + i}];")
    lines.append(f"    eta += BETA[{len(beta) - 1}];")
    link = model.family.link_name
    if cat == "Binomial" or link == "logit":
        lines.append("    double mu = 1.0 / (1.0 + Math.exp(-eta));")
    elif link == "log":
        lines.append("    double mu = Math.exp(eta);")
    elif link == "inverse":
        lines.append("    double mu = 1.0 / eta;")
    else:
        lines.append("    double mu = eta;")
    if cat == "Binomial":
        lines.append("    preds[1] = 1.0 - mu; preds[2] = mu; "
                     "preds[0] = mu > 0.5 ? 1 : 0;")
    else:
        lines.append("    preds[0] = mu;")
    betas = ", ".join(_jd(b) for b in beta)
    names = ", ".join(f'"{n}"' for n in cats + nums)
    return (
        f"// Auto-generated POJO scorer (glm)\n"
        f"public class {cname} {{\n"
        f"  public static final String[] NAMES = {{ {names} }};\n"
        f"  static final double[] BETA = {{ {betas} }};\n"
        f"  public static double[] score0(double[] data, double[] preds) {{\n"
        + "\n".join(lines) + "\n"
        "    return preds;\n  }\n}\n")
