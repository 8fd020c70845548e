#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``h2o_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``h2o_tpu_torch/csrc`` (and the parser's
host C++ tokenizer), then drives five paths: the flagship numeric GBM
(HIGGS-shaped, flat histogram plan; continued from a checkpoint), XGBoost
on the same frame (gbtree at depth 6; DART and gblinear against the CPU),
the airlines-shaped categorical GBM (grouped plan, set splits), the
HIGGS-shaped binomial GLM (IRLS over the weighted Gram kernel) and the
covertype-shaped multinomial DRF and XRT (depth 12, row and column
sampling on jax's random streams, out-of-bag metrics); every GBM option of
the port against the CPU; H2O's usual workflow from a CSV file on disk
to cross-validated metrics; state that outlives a training process
(coded columns, model files, snapshots, kill-and-resume);
unsupervised and neural models on an MNIST-shaped frame (DeepLearning,
KMeans, PCA/SVD through the Gram kernel); and model search (AutoML, the
multinomial GLM, stacked ensembles, grid recovery); and the model surface
of the tree models (TreeSHAP, node covers, leaf assignments, staged
predictions, categorical encodings, custom metrics). In order:

1. ``level_hist``: holds the kernel, through its flat wrapper, against its
   plain PyTorch version at the HIGGS shapes (11,001,856 padded rows, 28
   int8 features, V = 3) for every level width of a depth-6 tree (n_lv = 1,
   2, 4, 8, 16, 32; the kernel line sums the depth-5 GBM tree's n_lv 1..16
   and, under ``higgs_depth6``, all six): the integer-valued weight channel must match exactly, the
   real channels within 1e-4 of each cell's absolute mass, and two launches
   must be bit-identical; times the kernel, the plain version, one
   ``index_add_`` call on precomputed keys (a yardstick the port never
   calls) and the memory-traffic bound; each level's line also gives the
   launch's shape (``hist.launch_shape``: rows per staged block, CTAs per
   cluster, clusters, the largest tile);
2. ``train``: trains the flagship GBM end to end — bernoulli, 11M x 28
   HIGGS-shaped rows from the benchmark's generator, depth 5, 20 bins,
   learn rate 0.1, seed 42, 10 trees scored once — and requires 50 flat
   launches (ntrees x max_depth), no grouped launch and a finite training
   AUC above 0.6;
2b. ``xgboost_train``: XGBoost gbtree on that frame at the port's
   ``XGBoostParameters`` defaults (eta 0.3, min_child_weight 1, lambda 1)
   with xgboost's max_depth 6, 50 rounds scored every 5, early stopping
   after 2 scorings without a 1e-3 relative logloss gain, seed 42: requires
   trees built x 6 flat launches and no other, a finite training AUC above
   0.6 and 28 variable importances whose percentages sum to 1 within 1e-5;
2c. ``checkpoint_higgs``: 5 trees of that GBM, then ``checkpoint=`` that
   model's key to 10 trees: 25 new flat launches (the prior replays in
   bin-code space, no histogram), structure and thresholds equal to the
   ``train`` phase's 10-tree model, leaves and predictions within 1e-5; a
   10-tree run with ``score_tree_interval=2`` and
   ``export_checkpoints_dir``: its forest bit-equal to ``train``'s, 5
   snapshots that each load and score; the continuation saved, loaded by a
   fresh process on the card that scores a saved 100,000-row slice, bit-
   equal to this process's scores;
2d. ``shap_higgs``: on ``train``'s model, the node covers over the 11M
   training rows (each root the row count, each node its children's sum)
   and TreeSHAP contributions of all 11M rows (each row's sum within 1e-4
   of the float64 margin); on its first 1M rows the leaf node ids (their
   leaf values summed within 1e-5 of ``predict``'s margin), the leaf paths
   (naming those nodes) and the staged predictions (the last within 1e-6
   of ``predict``'s p1); walls and peak memory, no kernel launch;
3. ``card_vs_cpu``: the same GBM on 1M rows x 5 trees on the card and on
   the CPU: equal forest structure (split features, NA directions, split
   bins), leaf values and predictions within 1e-5;
4. ``level_hist_grouped``: the same checks and timings for the kernel
   through its grouped wrapper at the airlines plan (9 int16 features in
   width buckets 32/16/8/301, 5% NA) at 11,001,856 rows and at the airlines
   train's 116,006,912 padded rows, whose numbers the kernel line reports;
   the weight channel must equal the exact int64 count and the plain
   version (float64 sums, rounded once); plus one wide case (a 1025-bin bucket at n_lv = 16)
   that needs the node-range tiling;
5. ``airlines_train``: the airlines-shaped GBM end to end — 116M rows from
   the benchmark's airlines generator (seven categoricals, Origin/Dest at
   300 levels, two numerics), depth 5, nbins 20, nbins_cats 1024, learn
   rate 0.1, seed 42, 10 trees — requiring 50 grouped launches, no flat
   launch, a finite training AUC above 0.6, at least one set split and
   finite predictions;
6. ``airlines_card_vs_cpu``: that GBM on 1M rows x 5 trees on the card and
   on the CPU: equal split features, NA directions, set-split tables and
   split bins, leaf values and predictions within 1e-5;
7. ``gram``: holds the weighted Gram kernel against its plain version (the
   reference's balanced row blocks, ascending) at GLM's HIGGS design
   (11,001,856 rows x 29 columns, with z) and at the airlines one-hot width
   (1,048,576 x 690, with z): two launches bit-identical, every entry
   within 1e-5 of its absolute mass (the plain Gram of |X|, |W|, |z|);
   checks the z = None mask form (W in {0, 1}) at the HIGGS design, and
   that the kernel computes in float32, not TF32 (``gram_tf32_probe``:
   within 1e-5 of the float64 Gram on operands TF32 would move by 1e-4);
   times the kernel, the plain version, one ``torch.mm`` of precomputed
   (W o X)^T and [X | z] (TF32 off; a yardstick the port never calls) and
   the bound: the bytes, or the operations of G's triangle and b at the
   rate of the arithmetic the kernel runs (3xTF32 on the tensor cores),
   with the float32 FMA rate's bound printed beside it;
8. ``glm_train``: ``bench.py``'s ``glm_irlsm`` leg on the HIGGS frame —
   binomial, IRLSM, seed 42, every other parameter at its default — and
   requires one Gram launch per IRLS iteration, no histogram launch, a
   finite training AUC above 0.6, residual below null deviance, finite
   coefficients and predictions;
9. ``glm_cod_train``: the same with ``solver="COORDINATE_DESCENT"``;
10. ``glm_card_vs_cpu``: two fits at 1M rows on the card and on the CPU —
    IRLSM with ``lambda_search`` and COD with ``lambda_=1e-3`` —
    coefficients within 1e-4 x max(1, |beta|), residual deviance within a
    relative 1e-5, predictions within 1e-4 (a one-iteration difference in
    where IRLS stops moves beta by up to ``beta_epsilon``); the card's
    lambda search makes iterations + 1 Gram launches (its lambda_max pass);
10b. ``gbm_options_card_vs_cpu``: 250,000 HIGGS rows with a regression
    response and a positive one from the generator's latent; 5 trees each
    of poisson, gamma, tweedie, laplace, quantile (alpha 0.9), huber (alpha
    0.9), gaussian with two monotone constraints and one interaction
    group, and ``histogram_type="Exact"`` on the features rounded to one
    decimal, plus one early-stopped gaussian GBM, on the card and on the
    CPU: equal split features, NA directions, split bins and tree counts,
    leaf values and predictions within 1e-5, the same variable-importance
    order, and the early-stopped model stopping before its 20 trees;
10c. ``xgboost_card_vs_cpu``: 1M HIGGS rows, 5 rounds of DART (rate_drop
    0.3, seed 42, max_depth 6) on the card and on the CPU: the same dropped
    trees, equal forests, leaves and predictions within 1e-5; and the
    gblinear fit (COD over the Gram kernel): coefficients within 1e-4 x
    max(1, |beta|), one Gram launch per iteration on the card;
11. ``level_hist_covtype``: the kernel through the wrapper the covertype
    frame's plan picks (581,012 rows x 54: 10 continuous columns, 4
    wilderness and 40 soil one-hots; ``_covtype_cols``), on the frame's own
    bin codes at 581,120 padded rows, at n_lv = 64, 512 and 2,048 (DRF's
    deepest level), V = 3 with integer bag weights: the same checks and
    timings as ``level_hist_grouped``, with each level's launch shape;
12. ``drf_train``: the JAX package's DRF defaults on that frame — 50 trees,
    max_depth 20 capped to 12, sample_rate 0.632, mtries floor(sqrt(54)) =
    7, nbins 20, min_rows 10, seed 42 — 7 classes: requires 50 x 7 x 12 =
    4,200 launches of the plan's wrapper and none of the other two kernels,
    training metrics "Reported on OOB data", an OOB logloss finite and below
    the class prior's (1.205 nats), a mean per-class error below the
    prior's 6/7, and class probabilities finite with rows summing to 1
    within 1e-5;
13. ``xrt_train``: the same for XRT (random bin edges), 10 trees, 840
    launches;
13b. ``recovery_drf``: ``drf_train``'s DRF cut to 30 trees (the script's
    clock) with ``score_tree_interval=10``
    and ``auto_recovery_dir`` (a state write at every boundary), killed
    before its third chunk (``train.gbm.chunk:raise(preempt)@3``) and
    resumed with ``resume_training``: forest, out-of-bag sums and counts
    and class probabilities bit-equal to an uninterrupted run at the same
    parameters; 2,520 launches of the plan's wrapper between the two runs;
    prints the frame save's seconds and MB/s, the state writes and their
    seconds, and the resume wall against the uninterrupted wall;
14. ``drf_card_vs_cpu``: that DRF on 100,000 rows x 5 iterations on the card
    and on the CPU: equal split features, NA directions, split bins, leaf
    values and out-of-bag counts (integer channels), predictions within
    1e-5; and ``model_performance`` under each of the four multinomial
    ``auc_type``s on both devices: within 1e-6, finite, in (0.5, 1];
14b. ``recovery_card_vs_cpu``: the GBM kill drill at every boundary on 1M
    HIGGS rows (6 trees, ``score_tree_interval=2``: 3 kills) on the card:
    each resumed forest and its predictions bit-equal to the card's
    uninterrupted run, which matches the CPU's within the ``card_vs_cpu``
    tolerances;
15. ``import_csv``: writes the airlines generator (seed 116) as a
    7,009,728-row CSV (the row count of the ASA Data Expo 2009 on-time
    file for 2008; levels as strings, ``Distance`` NA on every 97th row,
    ``CRSDepTime`` empty on every 89th), reads it back through
    ``import_file`` with the calendar columns typed ``enum`` as H2O's
    airlines demos do, and requires the types, the 8 domain sizes, NA at
    exactly the blanked cells, every level (by name) and every float32
    value as generated; prints the write and parse walls, MB/s and rows/s;
    then writes the same rows with the header and string levels quoted (R's
    ``write.csv``), parses that through the same call and requires the
    frame bit-equal to the unquoted parse, printing its wall and MB/s;
15b. ``compress_airlines``: ``compress_frame`` on that frame: each
    column's codec, its coded bytes against raw float32, a bit-equal decode
    on the card; the batched code-space rollups against the raw ones (NA
    and zero counts, min and max exact, mean and sigma within 1e-4
    relative); a 5-tree GBM at ``bench_airlines`` settings on the coded
    frame bit-equal to one on the raw frame, 25 grouped launches;
16. ``import_cv_gbm``: ``split_frame(ratios=[0.7, 0.15], seed=42)`` into
    train, valid and calib, then ``bench_airlines``'s GBM (10 trees) on
    train with 5-fold CV (holdout predictions and fold assignment kept),
    the validation frame and Platt calibration on calib: the folds cover
    every train row, holdout predictions finite, CV, validation and
    calibrated AUC finite and above 0.6, cal_p0 + cal_p1 = 1 within 1e-6,
    and grouped launches = trees built x 5 with no other; prints each
    fold's and the main build's wall and the metrics scans' seconds; then,
    after the counted run, holds the kernel through its grouped wrapper
    against its plain version on the train frame's own bin codes under the
    main model's edges and plan, at n_lv = 1, 2, 4, 8, 16, with the checks
    and timings of ``level_hist_grouped``;
17. ``import_cv_glm``: ``bench.py:bench_glm``'s IRLSM fit on all nine
    predictors (one-hot, P = 690) with 5-fold CV and the validation frame:
    Gram launches = the IRLS iterations of the 6 fits, residual below null
    deviance on each, CV and validation AUC finite and above 0.6; prints
    the peak device memory; then, after the counted run, holds the Gram
    kernel against its plain version on the main fit's own one-hot design
    (about 4.9M x 690) with the checks and timings of ``gram``;
17b. ``encoding_airlines``: ``import_cv_gbm``'s GBM settings (10 trees, no
    CV) on the imported train split under ``categorical_encoding``
    EnumLimited, SortByResponse and Eigen (~4.9M rows) and OneHotExplicit
    (1M rows, ~700 columns): 50 histogram launches each, widths, walls and
    peak memory; the validation split through ``predict`` (the encoding
    replayed; AUC finite, above 0.6); a saved and loaded model predicting
    bit for bit alike; EnumLimited's callable ``custom_metric_func`` (a
    numpy logloss) equal to the logloss of ``predict``'s p1 within 1e-6;
    after each counted run the wrapper its plan took against the plain
    version on that model's own root-level inputs, with the checks and
    timings of ``level_hist_grouped``;
17c. ``model_surface_card_vs_cpu``: 100,000 HIGGS rows and 100,000 rows
    of the airlines split on the card and on the CPU: covers, leaf ids and
    paths equal, contributions within 1e-5, staged predictions within
    1e-6; every encoding's state and columns bit for bit; the GBMs on the
    EnumLimited, SortByResponse and Eigen frames structurally equal,
    leaves within 1e-5; a GLM grid over ``solver=["IRLSM", "L_BFGS"]``
    raising naming ROADMAP Queue 1 item 8;
18. ``import_cv_card_vs_cpu``: a 100,000-row CSV of the same generator
    through import, split, the CV GBM and the CV GLM on the card and on
    the CPU: the same frame bit for bit, equal folds and fold/main
    forests, leaves, holdout predictions, Platt (a, b) and GBM CV metrics
    within 1e-5, GLM coefficients within 1e-4 x max(1, |beta|) and GLM CV
    metrics within 1e-4;
19. ``dl_mnist``: a generated MNIST-shaped frame (``_mnist_cols``: 60,000
    rows x 784 integer pixels, 67 border pixels 0 in every row so 717
    vary, a 10-level label from per-class stroke templates — a stand-in,
    MNIST itself is not in the repo); DeepLearning at H2O-3's defaults
    (hidden [200, 200], Rectifier, ADADELTA rho 0.99 epsilon 1e-8) with
    the mini-batch lifted to 32, 1 epoch, seed 42: 717 inputs, training
    logloss finite and below ln 10, error below 0.5, a second run's
    weights and optimizer slots bit-equal; prints the wall, steps/s, peak
    memory, and from two builds under ``torch.profiler`` whose difference
    is steps alone the device launches and busy time per step and the
    device's idle share; no launch of the port's kernels (none is on
    this path: the reference's DL is plain XLA);
20. ``dl_mnist_autoencoder``: ``autoencoder=True``, Tanh, hidden [128, 64,
    128], 1 epoch: reconstruction MSE below the zero predictor's, the
    ``anomaly`` column's mean equal to it within 1e-4 relative, and
    ``deepfeatures(layer=1)`` a finite 64-wide frame;
21. ``kmeans_mnist``: KMeans k = 10, Furthest, standardize, 10 iterations
    at most, on those 64 deep features and on the 717 pixel columns:
    iterations, ``tot_withinss`` below ``totss``, cluster sizes summing to
    the rows, the wall;
22. ``pca_mnist``: PCA k = 50 (STANDARDIZE, GramSVD) and SVD nv = 50 on
    the pixels: one Gram launch each and no histogram launch, standard
    deviations finite and descending, SVD's singular values PCA's, and
    Randomized PCA's top five within 1e-3 relative of GramSVD's (its wall
    beside theirs); then, after the counted run, the Gram kernel against
    its plain version on PCA's own 60,160 x 717 design (z = None, the 0/1
    row mask as W), the plain version on float64 copies of the inputs
    (on an H100 the float32 one misses the float64 Gram by 3.1e-5 of an
    entry's mass there, the kernel by 1.8e-6; its distance is printed),
    with the timings of ``gram``;
23. ``recovery_dl``: ``dl_mnist``'s model at 3 epochs with
    ``auto_recovery_dir`` (a state write every epoch), killed at
    ``train.dl.epoch:raise(preempt)@3`` and resumed with
    ``resume_training``: weights and optimizer slots bit-equal to an
    uninterrupted 3-epoch run; prints the frame save, the state writes
    and the resume wall;
24. ``unsupervised_card_vs_cpu``: 2,000 rows of the generator on the card
    and on the CPU: DL (hidden [32, 32], 2 epochs) weights within 1e-4;
    KMeans assignments agreeing on >= 99.9% of rows, ``tot_withinss``
    within 1e-5 relative; PCA (k = 10) standard deviations within 1e-5
    relative, vectors equal up to sign (|cos| >= 1 - 1e-5) where the
    eigenvalues are separated by more than 1e-3 relative;
25. ``automl_higgs``: ``H2OAutoML(max_models=13, nfolds=3, seed=42,
    exclude_algos=["DeepLearning"])`` (``AUTOML_FOLDS``, cut from 5) on
    250,000 HIGGS-shaped rows at the full 28 features — 3 XGBoost, the
    lambda-search GLM, DRF, GBM def_1..def_5, XRT, a 2-model GBM grid,
    both ensembles: each step's
    wall, launches and deepest level width, peak memory, the leaderboard
    (AUCs finite, above 0.6, sorted; no step failed); the leader predicts,
    partial dependence on two columns and permutation importance are
    timed; then the flat kernel against its plain version on GBM def_5's
    own codes, node ids and channels at its levels of 8,192 and 16,384
    nodes, with the timings of ``level_hist``;
26. ``glm_multinomial_covtype``: the multinomial GLM (lambda 1e-4) on the
    covertype frame: sweeps x 7 x 3 Gram launches, mean per-class error
    below 6/7, logloss below 1.205 nats, class rows summing to 1; then the
    Gram against its plain version on the last class block's design;
27. ``ensemble_covtype``: a 3-fold GBM (10 trees, depth 5), DRF (10
    trees) and multinomial GLM under the AUTO metalearner: 21 level-one
    columns, class probabilities finite, rows summing to 1 within 1e-5;
28. ``automl_card_vs_cpu``: a plan with every algo (DeepLearning and a
    grid included) at 20,000 HIGGS rows with 3 folds, card and CPU: the
    same steps and combos, metrics within 1e-4, every ensemble's
    metalearner coefficients within 1e-4 x max(1, |beta|) and its
    predictions within 1e-4; the multinomial GLM on 20,000 covertype rows
    likewise;
29. ``grid_recovery``: a 4-combo GBM grid on 100,000 HIGGS rows killed at
    its third manifest write and resumed: bit-equal to the uninterrupted
    grid; and the grid with ``parallelism=2`` on the card: bit-equal to
    the sequential grid, with as many flat launches.

Between phases the K/V store is cleared (``h2o.remove_all()``): what a
phase keeps, it returns. Scratch files (CSVs, model files, snapshot and
recovery directories) go to the git-ignored ``.chip_smoke/`` and are
removed after each phase.

It prints the card's name and power limit, one JSON line of per-kernel
numbers (with each kernel's launches per path; the wrapper the covertype
plan picks carries that path's levels under ``covtype``; the Gram entry
carries its times at the CV GLM's, at PCA's and at the multinomial
GLM's class-block design; the flat entry carries GBM def_5's deep
levels; each histogram entry the encoded airlines models' root levels
that took its wrapper), and last
``{"ok": true, "device": {...}}``. Any failed phase raises and exits
non-zero without that line; so does a machine without a CUDA GPU. Imports nothing of JAX or of ``h2o_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HIGGS_ROWS = 11_000_000
HIGGS_F = 28
AIRLINES_ROWS = 116_000_000     # bench.py's airlines default (knobs.py:415)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
TF32X3_OPS_PER_S = 495e12 / 3  # H100 SXM dense TF32, three products per 3xTF32
REAL_TOL = 1e-4                # real channels: |kernel - plain| <= this x cell |mass|
CPU_TOL = 1e-5                 # card vs CPU: leaf values and predictions
GRAM_MAIN = (11_001_856, 29)   # GLM's HIGGS design: padded rows x (28 + intercept)
GRAM_WIDE = (1_048_576, 690)   # airlines drop-first one-hot width + intercept
GRAM_TOL = 1e-5                # Gram entry vs plain: <= this x entry |mass|
GLM_COEF_TOL = 1e-4            # card vs CPU: |dbeta| <= this x max(1, |beta|)
GLM_DEV_TOL = 1e-5             # card vs CPU: residual deviance, relative
GLM_PRED_TOL = 1e-4            # card vs CPU: predictions
OPTIONS_ROWS = 250_000         # gbm_options_card_vs_cpu: HIGGS rows
XGB_CPU_ROWS = 1_000_000       # xgboost_card_vs_cpu: HIGGS rows
IMPORT_ROWS = 7_009_728        # the ASA Data Expo 2009 on-time file for 2008
IMPORT_CPU_ROWS = 100_000      # import_cv_card_vs_cpu
SLICE_ROWS = 100_000           # checkpoint_higgs: rows a fresh process scores
RECOVERY_ROWS = 1_000_000      # recovery_card_vs_cpu: HIGGS rows
RECOVERY_DRF_TREES = 30        # recovery_drf: drf_train's 50 trees cut to 30
                               # for the script's clock (3 chunks: the kill
                               # before the third still replays one)
MNIST_ROWS = 60_000            # MNIST's training set
MNIST_BORDER = 67              # pixels 0 in every row of MNIST's training set
MNIST_CPU_ROWS = 2_000         # unsupervised_card_vs_cpu
AUTOML_ROWS = 250_000          # automl_higgs: HIGGS rows (cut from 11M)
AUTOML_FOLDS = 3               # automl_higgs: CV folds (cut from 5: 78 fits
                               # took 208-226 s on an H100 at 700 W, and
                               # 100,000 rows no less: a deep tree's levels
                               # cost by their 2^level nodes, not rows)
AUTOML_CPU_ROWS = 20_000       # automl_card_vs_cpu: HIGGS and covertype rows
GRID_ROWS = 100_000            # grid_recovery: HIGGS rows
#: what H2O's airlines demos pass to import_file
IMPORT_COL_TYPES = {"Year": "enum", "Month": "enum", "DayofMonth": "enum",
                    "DayOfWeek": "enum"}
IMPORT_CATS = ("Year", "Month", "DayofMonth", "DayOfWeek", "UniqueCarrier",
               "Origin", "Dest", "IsDepDelayed")
IMPORT_CARDS = (22, 12, 31, 7, 22, 300, 300, 2)
AUC_TYPES = ("MACRO_OVR", "WEIGHTED_OVR", "MACRO_OVO", "WEIGHTED_OVO")
#: the CSVs are written here, inside the checkout (git-ignored), and removed
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".chip_smoke")


def _higgs_cols(nrow: int, seed: int = 42):
    """The benchmark's HIGGS-shaped generator (``bench.py:_higgs_frame``):
    28 normal features, every third mixed with a latent factor, and a
    binary response through a logistic link."""
    rng = np.random.default_rng(seed)
    cols = {}
    latent = rng.normal(size=nrow).astype(np.float32)
    for j in range(HIGGS_F):
        mix = 0.3 if j % 3 == 0 else 0.0
        cols[f"f{j}"] = (rng.normal(size=nrow).astype(np.float32)
                         + mix * latent).astype(np.float32)
    logits = latent + 0.5 * cols["f0"] - 0.25 * cols["f3"]
    y = (rng.random(nrow) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return cols, y


def _higgs_frame(nrow: int, device):
    from h2o_tpu_torch import Frame, Vec
    from h2o_tpu_torch.frame.vec import T_CAT

    cols, y = _higgs_cols(nrow)
    fr = Frame.from_dict(cols, device=device)
    fr.add("response", Vec.from_numpy(y, type=T_CAT, domain=["b", "s"],
                                      device=device))
    return fr


def _airlines_cols(nrow: int, seed: int = 116):
    """The benchmark's airlines generator (``bench.py:_airlines_frame``):
    hub-skewed Origin/Dest over 300 airports, 22 carriers, calendar
    columns, departure time and distance, and a response wired through
    per-level effects. Returns (name -> (values, domain or None)) and y."""
    rng = np.random.default_rng(seed)
    n_air, n_car = 300, 22
    p_air = 1.0 / (np.arange(n_air) + 5.0)
    p_air /= p_air.sum()
    origin = rng.choice(n_air, size=nrow, p=p_air).astype(np.int16)
    dest = rng.choice(n_air, size=nrow, p=p_air).astype(np.int16)
    carrier = rng.integers(0, n_car, nrow).astype(np.int8)
    year = rng.integers(0, 22, nrow).astype(np.int8)
    month = rng.integers(0, 12, nrow).astype(np.int8)
    dom = rng.integers(0, 31, nrow).astype(np.int8)
    dow = rng.integers(0, 7, nrow).astype(np.int8)
    deptime = (rng.integers(5, 24, nrow) * 100
               + rng.integers(0, 60, nrow)).astype(np.float32)
    dist = np.exp(rng.normal(6.5, 0.8, nrow)).astype(np.float32)
    air_eff = rng.normal(0, 0.6, n_air)
    car_eff = rng.normal(0, 0.4, n_car)
    mon_eff = rng.normal(0, 0.3, 12)
    logit = (air_eff[origin] + 0.7 * air_eff[dest] + car_eff[carrier]
             + mon_eff[month] + 0.6 * np.sin(deptime / 2400 * 2 * np.pi)
             + 0.2 * (dist / 1000.0) - 0.4)
    y = (rng.random(nrow) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    airports = [f"A{i:03d}" for i in range(n_air)]
    cols = {"Year": (year, [str(1987 + i) for i in range(22)]),
            "Month": (month, [str(i + 1) for i in range(12)]),
            "DayofMonth": (dom, [str(i + 1) for i in range(31)]),
            "DayOfWeek": (dow, [str(i + 1) for i in range(7)]),
            "UniqueCarrier": (carrier, [f"C{i:02d}" for i in range(n_car)]),
            "Origin": (origin, airports), "Dest": (dest, airports),
            "CRSDepTime": (deptime, None), "Distance": (dist, None)}
    return cols, y


def _airlines_frame(nrow: int, device):
    from h2o_tpu_torch import Frame, Vec
    from h2o_tpu_torch.frame.vec import T_CAT

    cols, y = _airlines_cols(nrow)
    fr = Frame()
    for name, (vals, dom) in cols.items():
        fr.add(name, Vec.from_numpy(vals, type=T_CAT if dom else None,
                                    domain=dom, device=device))
    fr.add("IsDepDelayed", Vec.from_numpy(y, type=T_CAT, domain=["NO", "YES"],
                                          device=device))
    return fr


def _csv_blanks(nrow: int) -> dict:
    """The cells ``_write_airlines_csv`` leaves NA: ``Distance`` on every
    97th row (written ``NA``), ``CRSDepTime`` on every 89th (left empty)."""
    r = np.arange(nrow)
    return {"Distance": r % 97 == 96, "CRSDepTime": r % 89 == 88}


def _write_airlines_csv(path: str, nrow: int, seed: int = 116,
                        quote: bool = False):
    """The airlines generator as a CSV file, the way H2O's airlines demos
    import it: categorical levels as strings (carriers ``C00``.., airports
    ``A000``.., the calendar columns as their numbers, ``IsDepDelayed`` as
    ``NO``/``YES``), ``CRSDepTime`` as an integer, ``Distance`` with nine
    significant digits (its float32 values read back bit for bit), and the
    ``_csv_blanks`` cells NA. Rows are assembled with numpy: each field's
    bytes scattered to its offset in the line. With ``quote`` the header
    and the string levels (carriers, airports, ``NO``/``YES``) are quoted,
    as R's ``write.csv`` writes them. Returns the generator's (cols, y)."""
    cols, y = _airlines_cols(nrow, seed)
    blank = _csv_blanks(nrow)
    q = b'"' if quote else b""
    fields = []
    for name, (vals, dom) in cols.items():
        if dom is not None:
            lq = q if name in ("UniqueCarrier", "Origin", "Dest") else b""
            s = np.array([lq + d.encode() + lq for d in dom])[
                vals.astype(np.int64)]
        elif name == "CRSDepTime":
            s = np.array([b"%d" % v for v in range(2400)])[
                vals.astype(np.int64)]
        else:
            s = np.array([b"%.9g" % v for v in vals.tolist()])
        if name in blank:
            s = s.astype(f"S{max(s.dtype.itemsize, 2)}")
            s[blank[name]] = b"NA" if name == "Distance" else b""
        fields.append(s)
    fields.append(np.array([q + b"NO" + q, q + b"YES" + q])[
        y.astype(np.int64)])
    names = list(cols) + ["IsDepDelayed"]
    mats = [np.ascontiguousarray(s).view(np.uint8).reshape(nrow, -1)
            for s in fields]
    lens = [(m != 0).sum(axis=1) for m in mats]
    line = np.sum(lens, axis=0) + len(fields)   # separators and newline
    off = np.concatenate([[0], np.cumsum(line)[:-1]])
    out = np.empty(int(line.sum()), dtype=np.uint8)
    for c, (m, ln) in enumerate(zip(mats, lens)):
        for j in range(m.shape[1]):
            ok = j < ln
            out[off[ok] + j] = m[ok, j]
        off = off + ln
        out[off] = ord("\n") if c == len(fields) - 1 else ord(",")
        off = off + 1
    with open(path, "wb") as f:
        f.write(b",".join(q + n.encode() + q for n in names) + b"\n")
        f.write(out.tobytes())
    return cols, y


#: UCI Covertype (``covtype.data``): the 10 continuous columns and their
#: published ranges, then 4 wilderness-area and 40 soil-type one-hots
COVTYPE_CONT = (("Elevation", 1859, 3858), ("Aspect", 0, 360),
                ("Slope", 0, 66), ("Horizontal_Distance_To_Hydrology", 0, 1397),
                ("Vertical_Distance_To_Hydrology", -173, 601),
                ("Horizontal_Distance_To_Roadways", 0, 7117),
                ("Hillshade_9am", 0, 254), ("Hillshade_Noon", 0, 254),
                ("Hillshade_3pm", 0, 254),
                ("Horizontal_Distance_To_Fire_Points", 0, 7173))
#: the published class counts of Cover_Type 1..7 (581,012 rows)
COVTYPE_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
COVTYPE_ROWS = sum(COVTYPE_COUNTS)
#: per class: mean elevation, roughly the published class means
_COVTYPE_ELEV = (3128, 2955, 2394, 2223, 2787, 2419, 3362)


def _covtype_cols(nrow: int = COVTYPE_ROWS, seed: int = 581):
    """A covertype-shaped frame: ``nrow`` rows drawn with the published
    class frequencies (exactly the published counts at 581,012 rows),
    integer-valued continuous columns inside their published ranges whose
    centres move with the class (elevation most), and wilderness and soil
    one-hots from per-class probabilities. Returns (name -> values) and the
    class codes 0..6."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(COVTYPE_COUNTS)
    if nrow != COVTYPE_ROWS:
        counts = np.floor(counts * nrow / COVTYPE_ROWS).astype(np.int64)
        counts[1] += nrow - counts.sum()
    y = rng.permutation(np.repeat(np.arange(7), counts))
    cols = {}
    shift = rng.normal(size=(10, 7))
    shift[0] = (np.asarray(_COVTYPE_ELEV) - 2858.5) / 1999.0 * 4
    for j, (name, lo, hi) in enumerate(COVTYPE_CONT):
        u = 0.5 + 0.12 * shift[j][y] + 0.18 * rng.standard_normal(nrow)
        cols[name] = np.rint(lo + np.clip(u, 0, 1) * (hi - lo)).astype(
            np.float32)

    def one_hot(prefix, k, alpha):
        p = rng.dirichlet(np.full(k, alpha), size=7)          # (7, k)
        c = (rng.random(nrow)[:, None] > np.cumsum(p[y], axis=1)).sum(1)
        for i in range(k):
            cols[f"{prefix}{i + 1}"] = (c == i).astype(np.float32)
    one_hot("Wilderness_Area", 4, 1.0)
    one_hot("Soil_Type", 40, 0.3)
    return cols, y.astype(np.float32)


def _covtype_frame(nrow: int, device):
    from h2o_tpu_torch import Frame, Vec
    from h2o_tpu_torch.frame.vec import T_CAT

    cols, y = _covtype_cols(nrow)
    fr = Frame.from_dict(cols, device=device)
    fr.add("Cover_Type", Vec.from_numpy(y, type=T_CAT, device=device,
                                        domain=[str(i) for i in range(1, 8)]))
    return fr


def _drf(fr, ntrees: int, xrt: bool = False):
    """The JAX package's own DRF defaults (``h2o_tpu/models/drf.py``):
    max_depth 20 capped to 12, sample_rate 0.632, mtries -1 ->
    floor(sqrt(54)) = 7, nbins 20, min_rows 10; seed 42. ``xrt`` takes XRT
    (the same on random bin edges)."""
    from h2o_tpu_torch import DRF, XRT, DRFParameters, XRTParameters

    builder, params = (XRT, XRTParameters) if xrt else (DRF, DRFParameters)
    return builder(params(training_frame=fr, response_column="Cover_Type",
                          ntrees=ntrees, seed=42)).train_model()


def _gbm(fr, ntrees: int, response: str = "response"):
    from h2o_tpu_torch import GBM, GBMParameters

    return GBM(GBMParameters(training_frame=fr, response_column=response,
                             ntrees=ntrees, max_depth=5, nbins=20,
                             nbins_cats=1024, learn_rate=0.1,
                             seed=42)).train_model()


def _glm(fr, **kw):
    """``bench.py:bench_glm``'s fit: binomial, seed 42, IRLSM unless
    ``solver`` says otherwise, every other parameter at its default."""
    from h2o_tpu_torch import GLM, GLMParameters

    return GLM(GLMParameters(training_frame=fr, response_column="response",
                             family="binomial", seed=42, **kw)).train_model()


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def phase_kernel(dev) -> dict:
    """The kernel through its flat wrapper against its plain version at
    HIGGS shapes."""
    import torch

    from h2o_tpu_torch.backend.kernels import hist
    from h2o_tpu_torch.parallel.mesh import padded_len

    rl, F, V, B = padded_len(HIGGS_ROWS), HIGGS_F, 3, 21
    g = torch.Generator(device=dev).manual_seed(42)
    codes = torch.randint(0, B - 1, (rl, F), generator=g, device=dev,
                          dtype=torch.int8)
    codes[torch.rand((rl, F), generator=g, device=dev) < 0.05] = B - 1  # NA
    vv = torch.randn((rl, V), generator=g, device=dev)
    vv[:, 0] = torch.randint(0, 4, (rl,), generator=g, device=dev).float()
    per_level = []
    for n_lv in (1, 2, 4, 8, 16, 32):
        lc = torch.randint(0, n_lv, (rl,), generator=g, device=dev,
                           dtype=torch.int32)
        k1 = hist._cuda_flat(codes, lc, vv, n_lv, B)
        k2 = hist._cuda_flat(codes, lc, vv, n_lv, B)
        plain = hist._torch_flat(codes, lc, vv, n_lv, B)
        mass = hist._torch_flat(codes, lc, vv.abs(), n_lv, B)
        torch.cuda.synchronize()
        _check(torch.equal(k1, k2), f"n_lv={n_lv}: two launches differ")
        _check(torch.equal(k1[..., 0], plain[..., 0]),
               f"n_lv={n_lv}: integer channel differs from the plain version")
        err = (k1 - plain).abs()
        rel = float((err / (mass + 1e-30)).max())
        _check(rel <= REAL_TOL, f"n_lv={n_lv}: real channels off by {rel:.3g} "
                                f"of the cell mass (limit {REAL_TOL})")
        # yardstick: one index_add_ over precomputed flat keys
        f_idx = torch.arange(F, device=dev)[None, :]
        keys = (((f_idx * n_lv + lc[:, None].long()) * B + codes.long())
                .reshape(-1))
        src = vv[:, None, :].expand(rl, F, V).reshape(-1, V)
        lib = torch.zeros((F * n_lv * B, V), device=dev)
        kernel_ms = _cuda_ms(lambda: hist._cuda_flat(codes, lc, vv, n_lv, B), 20)
        plain_ms = _cuda_ms(lambda: hist._torch_flat(codes, lc, vv, n_lv, B),
                            2)
        library_ms = _cuda_ms(lambda: lib.zero_().index_add_(0, keys, src), 5)
        del keys, src, lib
        nbytes = rl * F * codes.element_size() + rl * 4 + rl * V * 4 \
            + F * n_lv * B * V * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S, rl * F * V / F32_OPS_PER_S) * 1e3
        row = dict(n_lv=n_lv, max_abs_err=float(err.max()), max_rel_mass=rel,
                   ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms,
                   **hist.launch_shape(codes, lc, vv, n_lv, B))
        print("level_hist", json.dumps(row), flush=True)
        per_level.append(row)

    def tree_sums(rows):
        return {k: (max(r[k] for r in rows) if k == "max_abs_err"
                    else sum(r[k] for r in rows))
                for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                          "bound_ms")}
    # the depth-5 GBM tree (n_lv 1..16), and xgboost's depth-6 tree; the
    # largest error is over every level checked
    return dict(tree_sums(per_level[:5]),
                max_abs_err=max(r["max_abs_err"] for r in per_level),
                depth6=dict(n_lv=[r["n_lv"] for r in per_level],
                            **tree_sums(per_level)))


def phase_train(dev, fr):
    """The flagship GBM end to end on the HIGGS frame; returns the kernel
    launches it made and the model."""
    import torch

    from h2o_tpu_torch.backend.kernels import gram, hist

    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _gbm(fr, ntrees=10)     # train_model synchronises the card
    train_s = time.perf_counter() - t0
    launches, grouped = hist.LAUNCHES, hist.GROUPED_LAUNCHES
    _check(gram.GRAM_LAUNCHES == 0, "the GBM launched the Gram kernel")
    m = model.output.training_metrics
    t0 = time.perf_counter()
    pred = model.predict(fr)
    p1 = pred.vec("ps").data[:fr.nrow]
    finite = bool(torch.isfinite(p1).all())
    predict_s = time.perf_counter() - t0
    print("train", json.dumps(dict(
        rows=HIGGS_ROWS, ntrees=10, train_s=train_s, predict_s=predict_s,
        auc=m.auc, logloss=m.logloss, kernel_launches=launches,
        grouped_launches=grouped,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)),
        flush=True)
    _check(launches == 10 * 5 and grouped == 0,
           f"{launches} flat and {grouped} grouped launches, want 50 and 0")
    _check(bool(np.isfinite(m.auc)) and m.auc > 0.6, f"AUC {m.auc}")
    _check(finite and p1.shape == (HIGGS_ROWS,), "predictions not finite")
    return launches, model


def _xgboost(fr, **kw):
    """XGBoost at the port's ``XGBoostParameters`` defaults (eta 0.3,
    min_child_weight 1, lambda 1) with xgboost's own max_depth 6, seed 42,
    on the HIGGS frame's response."""
    from h2o_tpu_torch import XGBoost, XGBoostParameters

    return XGBoost(XGBoostParameters(training_frame=fr,
                                     response_column="response", max_depth=6,
                                     seed=42, **kw)).train_model()


def phase_xgboost_train(dev, fr) -> int:
    """XGBoost gbtree on the HIGGS frame, 50 rounds scored every 5 with
    early stopping (2 rounds, tolerance 1e-3); returns its flat launches."""
    import torch

    from h2o_tpu_torch.backend.kernels import gram, hist

    torch.cuda.reset_peak_memory_stats(dev)
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _xgboost(fr, ntrees=50, score_tree_interval=5, stopping_rounds=2,
                     stopping_tolerance=1e-3)
    train_s = time.perf_counter() - t0
    launches, grouped = hist.LAUNCHES, hist.GROUPED_LAUNCHES
    trees, depth = model.ntrees, model.cfg.max_depth
    m = model.output.training_metrics
    vi = model.output.variable_importances
    pct = float(np.sum(vi["percentage"]))
    p1 = model.predict(fr).vec("ps").data[:fr.nrow]
    print("xgboost_train", json.dumps(dict(
        rows=HIGGS_ROWS, booster="gbtree", max_depth=depth, trees_built=trees,
        scorings=len(model.output.scoring_history), train_s=train_s,
        auc=m.auc, logloss=m.logloss, flat_launches=launches,
        grouped_launches=grouped, gram_launches=gram.GRAM_LAUNCHES,
        varimp_top5=[[v, float(p)] for v, p in
                     zip(vi["variable"][:5], vi["percentage"][:5])],
        varimp_rows=len(vi["variable"]), varimp_pct_sum=pct,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)),
        flush=True)
    _check(depth == 6 and launches == trees * 6 and grouped == 0
           and gram.GRAM_LAUNCHES == 0,
           f"xgboost_train: {launches} flat, {grouped} grouped and "
           f"{gram.GRAM_LAUNCHES} Gram launches for {trees} trees of depth "
           f"{depth}, want {trees} x 6 flat and no other")
    _check(bool(np.isfinite(m.auc)) and m.auc > 0.6,
           f"xgboost_train: AUC {m.auc}")
    _check(len(vi["variable"]) == HIGGS_F and abs(pct - 1.0) <= 1e-5,
           f"xgboost_train: varimp has {len(vi['variable'])} rows summing "
           f"to {pct}")
    _check(bool(torch.isfinite(p1).all()), "xgboost_train: predictions")
    return launches


def _higgs_option_frame(nrow: int, device):
    """The HIGGS features with two responses from the generator's latent
    (its first draw): ``reg`` = latent + 0.5 f0 - 0.25 f3 + N(0, 0.5), and
    ``pos`` = Gamma(2, exp(0.3 reg) / 2) > 0 for the log-link families;
    plus ``q*``, the features rounded to one decimal, for exact bins."""
    from h2o_tpu_torch import Frame

    cols, _y = _higgs_cols(nrow)
    latent = np.random.default_rng(42).normal(size=nrow).astype(np.float32)
    rng = np.random.default_rng(43)
    reg = (latent + 0.5 * cols["f0"] - 0.25 * cols["f3"]
           + rng.normal(scale=0.5, size=nrow)).astype(np.float32)
    pos = rng.gamma(2.0, np.exp(0.3 * reg) / 2.0).astype(np.float32)
    cols.update({f"q{j}": np.round(cols[f"f{j}"], 1) for j in range(HIGGS_F)})
    cols.update(reg=reg, pos=pos)
    return Frame.from_dict(cols, device=device)


#: gbm_options_card_vs_cpu: name -> (response, GBM options), 5 trees each
GBM_OPTIONS = {
    "poisson": ("pos", dict(distribution="poisson")),
    "gamma": ("pos", dict(distribution="gamma")),
    "tweedie": ("pos", dict(distribution="tweedie", tweedie_power=1.5)),
    "laplace": ("reg", dict(distribution="laplace")),
    "quantile": ("reg", dict(distribution="quantile", quantile_alpha=0.9)),
    "huber": ("reg", dict(distribution="huber", huber_alpha=0.9)),
    "constrained": ("reg", dict(monotone_constraints={"f0": 1, "f3": -1},
                                interaction_constraints=[["f0", "f1",
                                                          "f2"]])),
    "exact": ("reg", dict(histogram_type="Exact")),
    # the MSE falls 11-19% a scoring until the sixth (10%, 250k rows), so
    # it stops at 12 trees
    "early_stopped": ("reg", dict(ntrees=20, score_tree_interval=2,
                                  stopping_rounds=2,
                                  stopping_tolerance=0.11)),
}


def _option_model(fr, name):
    from h2o_tpu_torch import GBM, GBMParameters

    resp, kw = GBM_OPTIONS[name]
    feats = [f"q{j}" if name == "exact" else f"f{j}" for j in range(HIGGS_F)]
    ignored = [n for n in fr.names if n not in feats and n != resp]
    kw = dict(dict(ntrees=5, max_depth=5, seed=42), **kw)
    return GBM(GBMParameters(training_frame=fr, response_column=resp,
                             ignored_columns=ignored, **kw)).train_model()


def _same_forest(a, b, what: str, keys=("feat", "nanL")) -> dict:
    """Card model ``a`` against CPU model ``b``: equal ``keys`` and split
    bins, leaf values within CPU_TOL; returns the leaf error."""
    import torch

    for k in keys:
        _check(torch.equal(a.forest[k].cpu(), b.forest[k]),
               f"{what}: {k} differs between card and CPU")
    _check(np.array_equal(_split_bins(a), _split_bins(b)),
           f"{what}: split bins differ between card and CPU")
    val_err = float((a.forest["val"].cpu() - b.forest["val"]).abs().max())
    _check(val_err <= CPU_TOL, f"{what}: leaf values off by {val_err}")
    return dict(leaf_max_abs_err=val_err,
                split_nodes=int((a.forest["feat"] >= 0).sum()))


def phase_gbm_options_card_vs_cpu(dev) -> None:
    """Every GBM option this slice ported, 5 trees at 250,000 HIGGS rows on
    the card and on the CPU: equal forests, leaves and predictions within
    CPU_TOL, the same variable-importance order; the early-stopped model
    stops at the same tree count."""
    rows = OPTIONS_ROWS
    frames = {d: _higgs_option_frame(rows, d) for d in (dev, "cpu")}
    for name in GBM_OPTIONS:
        models, preds, secs = {}, {}, {}
        for d, fr in frames.items():
            t0 = time.perf_counter()
            models[d] = _option_model(fr, name)
            preds[d] = models[d].predict(fr).vec(0).data[:rows].cpu().numpy()
            secs[d] = time.perf_counter() - t0
        a, b = models[dev], models["cpu"]
        out = _same_forest(a, b, f"gbm option {name}")
        pred_err = float(np.abs(preds[dev] - preds["cpu"]).max())
        va, vb = (m.output.variable_importances for m in (a, b))
        print("gbm_options_card_vs_cpu", json.dumps(dict(
            option=name, rows=rows, trees_card=a.ntrees, trees_cpu=b.ntrees,
            plan="grouped" if a.cfg.hist_groups else "flat",
            pred_max_abs_err=pred_err, varimp_top3=va["variable"][:3],
            card_s=secs[dev], cpu_s=secs["cpu"], **out)), flush=True)
        _check(pred_err <= CPU_TOL, f"gbm option {name}: predictions off by "
                                    f"{pred_err}")
        _check(va["variable"] == vb["variable"],
               f"gbm option {name}: variable importances in another order")
        _check(a.ntrees == b.ntrees, f"gbm option {name}: {a.ntrees} trees "
                                     f"on the card, {b.ntrees} on the CPU")
        if name == "early_stopped":
            _check(a.ntrees < GBM_OPTIONS[name][1]["ntrees"],
                   f"gbm option {name}: did not stop early")


def phase_xgboost_card_vs_cpu(dev) -> int:
    """DART (5 rounds, rate_drop 0.3) and gblinear at 1M HIGGS rows on the
    card and on the CPU; returns the card gblinear fit's Gram launches."""
    import torch

    from h2o_tpu_torch.backend.kernels import gram, hist

    rows = XGB_CPU_ROWS
    frames = {d: _higgs_frame(rows, d) for d in (dev, "cpu")}
    models, preds, secs = {}, {}, {}
    for d, fr in frames.items():
        t0 = time.perf_counter()
        models[d] = _xgboost(fr, booster="dart", rate_drop=0.3, ntrees=5)
        preds[d] = models[d].predict(fr).vec("ps").data[:rows].cpu().numpy()
        secs[d] = time.perf_counter() - t0
    a, b = models[dev], models["cpu"]
    _check(a.dropped_trees == b.dropped_trees and any(a.dropped_trees),
           f"dart: dropped {a.dropped_trees} on the card, "
           f"{b.dropped_trees} on the CPU")
    out = _same_forest(a, b, "dart")
    pred_err = float(np.abs(preds[dev] - preds["cpu"]).max())
    print("xgboost_card_vs_cpu", json.dumps(dict(
        booster="dart", rows=rows, rounds=a.ntrees, dropped=a.dropped_trees,
        pred_max_abs_err=pred_err, auc_card=a.output.training_metrics.auc,
        auc_cpu=b.output.training_metrics.auc, card_s=secs[dev],
        cpu_s=secs["cpu"], **out)), flush=True)
    _check(pred_err <= CPU_TOL, f"dart: predictions off by {pred_err}")
    fits = {}
    for d, fr in frames.items():
        hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
        if d != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = _xgboost(fr, booster="gblinear")
        fits[d] = (m, gram.GRAM_LAUNCHES, hist.LAUNCHES
                   + hist.GROUPED_LAUNCHES, time.perf_counter() - t0)
    (a, la, ha, ta), (b, _lb, _hb, tb) = fits[dev], fits["cpu"]
    coef = float(np.max(np.abs(a.beta - b.beta)
                        / np.maximum(1.0, np.abs(b.beta))))
    iters = a.output.scoring_history[-1]["iterations"]
    print("xgboost_card_vs_cpu", json.dumps(dict(
        booster="gblinear", rows=rows, solver=a.params.solver,
        lambda_=a.params.lambda_, alpha=a.params.alpha, iterations=iters,
        gram_launches=la, hist_launches=ha, coef_max_rel_err=coef,
        auc_card=a.output.training_metrics.auc,
        auc_cpu=b.output.training_metrics.auc, card_s=ta, cpu_s=tb)),
        flush=True)
    _check(coef <= GLM_COEF_TOL, f"gblinear: coefficients off by {coef:.3g} "
                                 f"(limit {GLM_COEF_TOL})")
    _check(la == iters and ha == 0, f"gblinear: {la} Gram launches for "
                                    f"{iters} iterations, {ha} histogram "
                                    f"launches")
    return la


def _split_bins(model) -> np.ndarray:
    """Each split node's cut as a bin index into the model's own edges."""
    feat = model.forest["feat"].cpu().numpy()
    thr = model.forest["thr"].cpu().numpy()
    e = model.edges[np.clip(feat, 0, None)]
    with np.errstate(invalid="ignore"):
        bins = np.sum(e < thr[..., None], axis=-1)
    return np.where(feat >= 0, bins, -1)


def phase_card_vs_cpu(dev) -> None:
    """The HIGGS GBM on 1M rows x 5 trees, on the card and on the CPU."""
    import torch

    rows, ntrees = 1_000_000, 5
    models, preds = {}, {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        fr = _higgs_frame(rows, d)
        models[d] = _gbm(fr, ntrees)
        preds[d] = models[d].predict(fr).vec("ps").data[:rows].cpu().numpy()
        print(f"card_vs_cpu {d}: {time.perf_counter() - t0:.3f} s", flush=True)
    a, b = models[dev], models["cpu"]
    for k in ("feat", "nanL"):
        _check(torch.equal(a.forest[k].cpu(), b.forest[k]),
               f"1M rows: {k} differs between card and CPU")
    _check(np.array_equal(_split_bins(a), _split_bins(b)),
           "1M rows: split bins differ between card and CPU")
    edge_ulps = int(np.nanmax(np.abs(a.edges.view(np.int32).astype(np.int64)
                                     - b.edges.view(np.int32).astype(np.int64))))
    val_err = float((a.forest["val"].cpu() - b.forest["val"]).abs().max())
    pred_err = float(np.abs(preds[dev] - preds["cpu"]).max())
    print("card_vs_cpu", json.dumps(dict(
        rows=rows, ntrees=ntrees, edge_max_ulps=edge_ulps,
        leaf_max_abs_err=val_err, pred_max_abs_err=pred_err,
        auc_card=a.output.training_metrics.auc,
        auc_cpu=b.output.training_metrics.auc)), flush=True)
    _check(val_err <= CPU_TOL and pred_err <= CPU_TOL,
           f"1M rows: leaf values off by {val_err}, predictions by {pred_err}")


def _airlines_plan_inputs(dev, rl: int, widths, B: int, n_lv: int, g):
    """int16 codes with each feature's data bins 0..w-1 and 5% NA (code
    B-1), node ids, and [weight, g, h]-like channels with integer weights."""
    import torch

    codes = torch.stack([torch.randint(0, w, (rl,), generator=g, device=dev,
                                       dtype=torch.int16) for w in widths], 1)
    codes[torch.rand(codes.shape, generator=g, device=dev) < 0.05] = B - 1
    lc = torch.randint(0, n_lv, (rl,), generator=g, device=dev,
                       dtype=torch.int32)
    vv = torch.randn((rl, 3), generator=g, device=dev)
    vv[:, 0] = torch.randint(0, 4, (rl,), generator=g, device=dev).float()
    return codes.contiguous(), lc, vv


def _grouped_level(dev, codes, lc, vv, groups, n_lv: int, B: int,
                   reps: int, flat: bool = False) -> dict:
    """One grouped level: kernel vs plain checks and the four timings.
    ``flat`` takes the flat wrapper instead, ``groups`` then being its one
    bucket of every feature at width ``B``.

    The integer channel is held against the exact per-cell count (int64
    ``index_add_``, rounded once to float32) and against the plain version,
    whose float64 sums count exactly and round once too: bit-equal even
    where a cell weighs more than 2^24 (at 116M rows, n_lv = 1, each 7-level
    DayOfWeek bin weighs ~2.4e7)."""
    import torch

    from h2o_tpu_torch.backend.kernels import hist

    rl, F = codes.shape
    V = vv.shape[1]
    xgs = [codes[:, list(idxs)] for idxs, _Bg, _mode in groups]
    # each row's cell per feature in the packed output, NA remapped to its
    # group's last slot: keys of the exact count and the index_add_ yardstick
    keys, n_cells = [], 0
    for (idxs, Bg, _m), xg in zip(groups, xgs):
        c = xg.long()
        c = torch.where(c == B - 1, Bg - 1, c)
        slot = torch.arange(len(idxs), device=dev)[None, :]
        keys.append(n_cells + (slot * n_lv + lc[:, None].long()) * Bg + c)
        n_cells += len(idxs) * n_lv * Bg
    keys = torch.cat(keys, 1).reshape(-1)
    exact = torch.zeros(n_cells, dtype=torch.int64, device=dev).index_add_(
        0, keys, vv[:, 0].long()[:, None].expand(rl, F).reshape(-1))

    def launch():
        if flat:
            return (hist._cuda_flat(codes, lc, vv, n_lv, B),)
        return hist._cuda_grouped(codes, lc, vv, groups, n_lv, B - 1)
    k1, k2 = launch(), launch()
    # the plain version is timed on its checking call: at 116M rows one
    # call takes seconds, so it runs once
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    plain = hist._torch_grouped(xgs, lc, vv, groups, n_lv, B - 1)
    stop.record()
    mass = hist._torch_grouped(xgs, lc, vv.abs(), groups, n_lv, B - 1)
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    k0 = torch.cat([a[..., 0].reshape(-1) for a in k1])
    p0 = torch.cat([p[..., 0].reshape(-1) for p in plain])
    _check(torch.equal(k0, exact.float()),
           f"grouped n_lv={n_lv}: integer channel differs from the exact count")
    _check(torch.equal(k0, p0),
           f"grouped n_lv={n_lv}: integer channel differs from the plain "
           f"version")
    err, rel = 0.0, 0.0
    for (idxs, Bg, _m), a, b, p, m in zip(groups, k1, k2, plain, mass):
        _check(torch.equal(a, b), f"grouped n_lv={n_lv} Bg={Bg}: two "
                                  f"launches differ")
        d = (a - p).abs()
        err = max(err, float(d.max()))
        rel = max(rel, float((d[..., 1:] / (m[..., 1:] + 1e-30)).max()))
    _check(rel <= REAL_TOL, f"grouped n_lv={n_lv}: real channels off by "
                            f"{rel:.3g} of the cell mass (limit {REAL_TOL})")
    del plain, mass, exact
    # yardstick: one index_add_ over the keys into the same packed output
    src = vv[:, None, :].expand(rl, F, V).reshape(-1, V)
    lib = torch.zeros((n_cells, V), device=dev)
    kernel_ms = _cuda_ms(launch, reps)
    library_ms = _cuda_ms(lambda: lib.zero_().index_add_(0, keys, src), 3)
    del keys, src, lib
    nbytes = (rl * F * codes.element_size() + rl * 4 + rl * V * 4
              + n_cells * V * 4)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, rl * F * V / F32_OPS_PER_S) * 1e3
    return dict(rows=rl, n_lv=n_lv, max_abs_err=err, max_rel_mass=rel,
                ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                **hist.launch_shape(codes, lc, vv, n_lv, B,
                                    None if flat else groups))


def phase_grouped_kernel(dev) -> dict:
    """The grouped wrapper against its plain version at the airlines plan
    (the widths `plan_hist_groups` gives the airlines frame), every level
    width of a depth-5 tree, at 11,001,856 rows and at the airlines train's
    own 116,006,912; then one 1025-wide bucket at n_lv = 16. Returns the
    per-tree sums at the train's row count."""
    import torch

    from h2o_tpu_torch.parallel.mesh import padded_len

    B = 301
    groups = (((0, 2, 4, 7, 8), 32, "onehot"), ((1,), 16, "onehot"),
              ((3,), 8, "segsum"), ((5, 6), 301, "onehot"))
    # data bins per feature: Year 22, Month 12, DayofMonth 31, DayOfWeek 7,
    # UniqueCarrier 22, Origin/Dest 300, CRSDepTime/Distance 20
    widths = (22, 12, 31, 7, 22, 300, 300, 20, 20)
    g = torch.Generator(device=dev).manual_seed(116)
    for rl in (padded_len(HIGGS_ROWS), padded_len(AIRLINES_ROWS)):
        per_level = []
        for n_lv in (1, 2, 4, 8, 16):
            codes, lc, vv = _airlines_plan_inputs(dev, rl, widths, B, n_lv, g)
            row = _grouped_level(dev, codes, lc, vv, groups, n_lv, B, 20)
            print("level_hist_grouped", json.dumps(row), flush=True)
            per_level.append(row)
            del codes, lc, vv
        torch.cuda.empty_cache()
    # wide case: a 1025-bin bucket needs 16 x 1025 x 3 x 8 = 393 KB at
    # n_lv = 16, so the plan cuts it into node ranges
    Bw, rw = 1025, 2 ** 21
    wide_groups = (((0, 2), 32, "onehot"), ((1, 3), 1025, "onehot"))
    codes, lc, vv = _airlines_plan_inputs(dev, rw, (30, 1023, 30, 1023), Bw,
                                          16, g)
    row = _grouped_level(dev, codes, lc, vv, wide_groups, 16, Bw, 5)
    print("level_hist_grouped_wide", json.dumps(dict(row, B=Bw)), flush=True)
    out = {k: (max(r[k] for r in per_level) if k == "max_abs_err"
               else sum(r[k] for r in per_level))
           for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                     "bound_ms")}
    out["max_abs_err"] = max(out["max_abs_err"], row["max_abs_err"])
    return out


def _set_split_nodes(model) -> int:
    feat = model.forest["feat"].cpu().numpy()
    return int(((feat >= 0) & model.is_cat[np.clip(feat, 0, None)]).sum())


def phase_airlines_train(dev) -> int:
    """The airlines-shaped GBM end to end; returns its grouped launches."""
    import torch

    from h2o_tpu_torch.backend.kernels import gram, hist

    t0 = time.perf_counter()
    fr = _airlines_frame(AIRLINES_ROWS, dev)
    print(f"airlines frame {AIRLINES_ROWS}x9: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _gbm(fr, ntrees=10, response="IsDepDelayed")
    train_s = time.perf_counter() - t0
    launches, flat = hist.GROUPED_LAUNCHES, hist.LAUNCHES
    _check(gram.GRAM_LAUNCHES == 0, "the airlines GBM launched the Gram "
                                    "kernel")
    m = model.output.training_metrics
    t0 = time.perf_counter()
    pred = model.predict(fr)
    p1 = pred.vec("pYES").data[:fr.nrow]
    finite = bool(torch.isfinite(p1).all())
    predict_s = time.perf_counter() - t0
    sets = _set_split_nodes(model)
    print("airlines_train", json.dumps(dict(
        rows=AIRLINES_ROWS, ntrees=10, train_s=train_s, predict_s=predict_s,
        auc=m.auc, logloss=m.logloss, grouped_launches=launches,
        flat_launches=flat, set_split_nodes=sets,
        hist_groups=[[list(i), w, md] for i, w, md in model.cfg.hist_groups],
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)),
        flush=True)
    _check(launches == 10 * 5 and flat == 0,
           f"{launches} grouped and {flat} flat launches, want 50 and 0")
    _check(bool(np.isfinite(m.auc)) and m.auc > 0.6, f"airlines AUC {m.auc}")
    _check(sets >= 1, "no set-split node in the airlines forest")
    _check(finite and p1.shape == (AIRLINES_ROWS,),
           "airlines predictions not finite")
    return launches


def phase_airlines_card_vs_cpu(dev) -> None:
    """The airlines GBM on 1M rows x 5 trees, on the card and on the CPU."""
    import torch

    rows, ntrees = 1_000_000, 5
    models, preds = {}, {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        fr = _airlines_frame(rows, d)
        models[d] = _gbm(fr, ntrees, response="IsDepDelayed")
        preds[d] = models[d].predict(fr).vec("pYES").data[:rows].cpu().numpy()
        print(f"airlines_card_vs_cpu {d}: {time.perf_counter() - t0:.3f} s",
              flush=True)
    a, b = models[dev], models["cpu"]
    for k in ("feat", "nanL", "catd"):
        _check(torch.equal(a.forest[k].cpu(), b.forest[k]),
               f"airlines 1M rows: {k} differs between card and CPU")
    _check(np.array_equal(_split_bins(a), _split_bins(b)),
           "airlines 1M rows: split bins differ between card and CPU")
    val_err = float((a.forest["val"].cpu() - b.forest["val"]).abs().max())
    pred_err = float(np.abs(preds[dev] - preds["cpu"]).max())
    print("airlines_card_vs_cpu", json.dumps(dict(
        rows=rows, ntrees=ntrees, set_split_nodes=_set_split_nodes(a),
        leaf_max_abs_err=val_err, pred_max_abs_err=pred_err,
        auc_card=a.output.training_metrics.auc,
        auc_cpu=b.output.training_metrics.auc)), flush=True)
    _check(_set_split_nodes(a) >= 1, "airlines 1M rows: no set split")
    _check(val_err <= CPU_TOL and pred_err <= CPU_TOL,
           f"airlines 1M rows: leaf values off by {val_err}, predictions by "
           f"{pred_err}")


def _gram_case(dev, R: int, P: int, g, reps: int) -> dict:
    """One Gram shape with z on random inputs, W in [0, 0.25) like a
    binomial IRLS weight: ``_gram_check``'s numbers."""
    import torch

    X = torch.randn((R, P), generator=g, device=dev)
    W = torch.rand((R,), generator=g, device=dev) * 0.25
    z = torch.randn((R,), generator=g, device=dev)
    return _gram_check(X, W, z, reps)


def _gram_check(X, W, z, reps: int, f64: bool = False) -> dict:
    """The Gram kernel on (X, W, z): two launches bit-equal, every entry
    within GRAM_TOL of its mass (the plain Gram of |X|, W, |z|) from the
    plain version, and the four timings. ``z`` may be None (PCA's form:
    G only). With ``f64`` the plain version that holds the kernel runs on
    the float64 copies of the inputs (its float32 run is still the one
    timed, and its own distance from the float64 one is reported): on
    PCA's standardized MNIST design, on an H100, the float32 plain version
    misses the float64 Gram by 3.1e-5 of an entry's mass, the kernel by
    1.8e-6."""
    import torch

    from h2o_tpu_torch.backend.kernels import gram

    R, P = X.shape
    has_z = z is not None
    Xk, Wk, zk = X, W, z
    G1, b1 = gram._cuda_gram(X, W, z)
    G2, b2 = gram._cuda_gram(X, W, z)
    # the plain version's matmuls: cuBLAS sets itself up on its first call
    # of the process, which no earlier phase makes, so warm it up untimed
    gram._plain_gram(X[:4096], W[:4096], z[:4096] if has_z else None)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    Gp, bp = gram._plain_gram(X, W, z)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    plain_f32_rel = None
    if f64:
        G32 = Gp
        X, W = X.double(), W.double()
        z = z.double() if has_z else None
        Gp, bp = gram._plain_gram(X, W, z)
    Xa = X.abs()
    Gm, bm = gram._plain_gram(Xa, W, z.abs() if has_z else None)
    del Xa
    if f64:
        plain_f32_rel = float(((G32 - Gp).abs() / (Gm + 1e-30)).max())
        del G32, X, W, z
        X, W, z = Xk, Wk, zk
    _check(torch.equal(G1, G2) and (not has_z or torch.equal(b1, b2)),
           f"gram {R}x{P}: two launches differ")
    err = float((G1 - Gp).abs().max())
    rel = float(((G1 - Gp).abs() / (Gm + 1e-30)).max())
    if has_z:
        err = max(err, float((b1 - bp).abs().max()))
        rel = max(rel, float(((b1 - bp).abs() / (bm + 1e-30)).max()))
    _check(rel <= GRAM_TOL, f"gram {R}x{P}: off by {rel:.3g} of the entry "
                            f"mass (limit {GRAM_TOL})")
    del Gp, bp, Gm, bm
    kernel_ms = _cuda_ms(lambda: gram._cuda_gram(X, W, z), reps)
    # yardstick: one torch.mm of precomputed (W o X)^T and [X | z]
    A = X * W[:, None]
    B = torch.cat([X, z[:, None]], dim=1) if has_z else X
    library_ms = _cuda_ms(lambda: torch.mm(A.T, B), reps)
    del A, B
    nbytes = R * P * 4 + (1 + has_z) * R * 4 + (P * P + has_z * P) * 4
    # G is symmetric: its triangle, and b
    flops = 2 * R * (P * (P + 1) // 2 + has_z * P)
    # the kernel's products run on the tensor cores in 3xTF32, so its
    # operations are bounded at that rate; the float32 FMA rate's bound is
    # printed beside it
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / TF32X3_OPS_PER_S
    tile, tiles, n_chunks, chunk_rows, bk = gram._gram_plan(R, P, has_z)
    return dict(rows=R, cols=P, max_abs_err=err, max_rel_mass=rel,
                plain_f32_rel_mass=plain_f32_rel,
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes >= by_ops
                else "operations (3xTF32)",
                bound_f32_ms=max(by_bytes, flops / F32_OPS_PER_S) * 1e3,
                plan=dict(tile=tile, tiles=len(tiles), chunks=n_chunks,
                          chunk_rows=chunk_rows, bk=bk))


def gram_tf32_probe(dev, R: int, P: int, g) -> tuple[float, float]:
    """Inputs on which a Gram whose operands were rounded to TF32 (10
    mantissa bits) fails and the float32 Gram does not: X and z in [1, 2)
    carry a 2^-12 term, a quarter of TF32's step there, which truncation and
    rounding to nearest both drop, so each TF32 operand is low by 1.2e-4 to
    2.4e-4 of itself; W in {2^-2, 2^-3, 2^-4} keeps W o X on X's grid. Every
    term is positive, so each entry is its own mass. Returns the kernel's
    largest error against the float64 Gram, over the entry, and the same
    for the float64 product of the TF32-truncated operands."""
    import torch

    from h2o_tpu_torch.backend.kernels import gram

    def on_grid(shape):
        m = torch.randint(0, 1024, shape, generator=g, device=dev)
        return 1.0 + m.to(torch.float32) * 2.0 ** -10 + 2.0 ** -12

    def tf32(t):        # keep 10 of float32's 23 mantissa bits
        return (t.view(torch.int32) & ~0x1FFF).view(torch.float32).double()

    X, z = on_grid((R, P)), on_grid((R,))
    W = 2.0 ** -torch.randint(2, 5, (R,), generator=g,
                              device=dev).to(torch.float32)
    G, b = gram._cuda_gram(X, W, z)
    A = X.double() * W.double()[:, None]
    G64, b64 = A.T @ X.double(), A.T @ z.double()
    At = tf32(X * W[:, None])
    Gt, bt = At.T @ tf32(X), At.T @ tf32(z)

    def rel(Gx, bx):
        return max(float(((Gx.double() - G64).abs() / G64).max()),
                   float(((bx.double() - b64).abs() / b64).max()))
    return rel(G, b), rel(Gt, bt)


def phase_gram(dev) -> dict:
    """The Gram kernel against its plain version at GLM's HIGGS design and
    at the airlines one-hot width, plus the z = None mask form; returns the
    main-path case's numbers (max_abs_err over all checks)."""
    import torch

    from h2o_tpu_torch.backend.kernels import gram

    g = torch.Generator(device=dev).manual_seed(29)
    main = _gram_case(dev, *GRAM_MAIN, g, reps=20)
    print("gram", json.dumps(main), flush=True)
    # z = None with a 0/1 mask (PCA's form): G only, b None
    R, P = GRAM_MAIN
    X = torch.randn((R, P), generator=g, device=dev)
    W = (torch.rand((R,), generator=g, device=dev) < 0.7).to(torch.float32)
    G1, b1 = gram._cuda_gram(X, W, None)
    G2, _ = gram._cuda_gram(X, W, None)
    Gp, _ = gram._plain_gram(X, W, None)
    Gm, _ = gram._plain_gram(X.abs(), W, None)
    torch.cuda.synchronize()
    nz_rel = float(((G1 - Gp).abs() / (Gm + 1e-30)).max())
    _check(b1 is None and torch.equal(G1, G2), "gram z=None: b or bits")
    _check(nz_rel <= GRAM_TOL, f"gram z=None: off by {nz_rel:.3g} of the "
                               f"entry mass (limit {GRAM_TOL})")
    nz_err = float((G1 - Gp).abs().max())
    print("gram_no_z", json.dumps(dict(rows=R, cols=P, max_abs_err=nz_err,
                                       max_rel_mass=nz_rel)), flush=True)
    del X, W, G1, G2, Gp, Gm
    # float32, not TF32: on operands TF32 cannot hold the kernel stays
    # within GRAM_TOL of the float64 Gram and TF32 falls far outside it
    f32_rel, tf32_rel = gram_tf32_probe(dev, 1 << 20, P, g)
    print("gram_f32_probe", json.dumps(dict(rows=1 << 20, cols=P,
                                            kernel_rel=f32_rel,
                                            tf32_rel=tf32_rel)), flush=True)
    _check(f32_rel <= GRAM_TOL < 10 * GRAM_TOL <= tf32_rel,
           f"gram f32 probe: kernel off by {f32_rel:.3g} of the float64 "
           f"Gram, TF32 operands by {tf32_rel:.3g} (limit {GRAM_TOL})")
    torch.cuda.empty_cache()
    wide = _gram_case(dev, *GRAM_WIDE, g, reps=5)
    print("gram_wide", json.dumps(wide), flush=True)
    torch.cuda.empty_cache()
    return dict(main, max_abs_err=max(main["max_abs_err"], nz_err,
                                      wide["max_abs_err"]))


def _glm_train(dev, fr, what: str, **kw) -> int:
    """One GLM fit of ``bench.py``'s settings on the HIGGS frame and its
    checks; returns its Gram launches."""
    import torch

    from h2o_tpu_torch.backend.kernels import gram, hist

    torch.cuda.reset_peak_memory_stats(dev)
    gram.GRAM_LAUNCHES = hist.LAUNCHES = hist.GROUPED_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _glm(fr, **kw)          # train_model synchronises the card
    train_s = time.perf_counter() - t0
    launches = gram.GRAM_LAUNCHES
    hist_launches = hist.LAUNCHES + hist.GROUPED_LAUNCHES
    m = model.output.training_metrics
    iters = model.output.scoring_history[-1]["iterations"]
    t0 = time.perf_counter()
    p1 = model.predict(fr).vec("ps").data[:fr.nrow]
    finite = bool(torch.isfinite(p1).all())
    predict_s = time.perf_counter() - t0
    print(what, json.dumps(dict(
        rows=fr.nrow, solver=model.params.solver, train_s=train_s,
        predict_s=predict_s, iterations=iters, gram_launches=launches,
        hist_launches=hist_launches, auc=m.auc, logloss=m.logloss,
        residual_deviance=m.residual_deviance,
        null_deviance=m.null_deviance,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)),
        flush=True)
    _check(launches == iters and hist_launches == 0,
           f"{what}: {launches} Gram launches for {iters} iterations, "
           f"{hist_launches} histogram launches")
    _check(bool(np.isfinite(m.auc)) and m.auc > 0.6, f"{what}: AUC {m.auc}")
    _check(m.residual_deviance < m.null_deviance,
           f"{what}: residual deviance {m.residual_deviance} not below the "
           f"null deviance {m.null_deviance}")
    _check(bool(np.isfinite(model.beta).all()), f"{what}: coefficients")
    _check(finite and p1.shape == (fr.nrow,), f"{what}: predictions")
    return launches


def phase_glm_card_vs_cpu(dev) -> None:
    """IRLSM with lambda search and COD with lambda 1e-3 at 1M rows, on the
    card and on the CPU."""
    from h2o_tpu_torch.backend.kernels import gram

    rows = 1_000_000
    frames = {d: _higgs_frame(rows, d) for d in (dev, "cpu")}
    for what, kw in (("irlsm_lambda_search", dict(lambda_search=True)),
                     ("cod", dict(solver="COORDINATE_DESCENT",
                                  lambda_=1e-3))):
        fits = {}
        for d, fr in frames.items():
            t0 = time.perf_counter()
            gram.GRAM_LAUNCHES = 0
            m = _glm(fr, **kw)
            fits[d] = (m, gram.GRAM_LAUNCHES,
                       m.predict(fr).vec("ps").data[:rows].cpu().numpy(),
                       time.perf_counter() - t0)
        (a, la, pa, ta), (b, lb, pb, tb) = fits[dev], fits["cpu"]
        ia = a.output.scoring_history[-1]["iterations"]
        ib = b.output.scoring_history[-1]["iterations"]
        coef = float(np.max(np.abs(a.beta - b.beta)
                            / np.maximum(1.0, np.abs(b.beta))))
        ra = a.output.training_metrics.residual_deviance
        rb = b.output.training_metrics.residual_deviance
        dev_rel = abs(ra - rb) / abs(rb)
        pred = float(np.abs(pa - pb).max())
        print("glm_card_vs_cpu", json.dumps(dict(
            fit=what, rows=rows, iterations_card=ia, iterations_cpu=ib,
            gram_launches_card=la, lambda_card=a.output.scoring_history[-1][
                "lambda"], lambda_cpu=b.output.scoring_history[-1]["lambda"],
            coef_max_rel_err=coef, dev_rel_err=dev_rel, pred_max_abs_err=pred,
            auc_card=a.output.training_metrics.auc,
            auc_cpu=b.output.training_metrics.auc, card_s=ta, cpu_s=tb)),
            flush=True)
        _check(coef <= GLM_COEF_TOL, f"glm {what}: coefficients off by "
                                     f"{coef:.3g} (limit {GLM_COEF_TOL})")
        _check(dev_rel <= GLM_DEV_TOL, f"glm {what}: residual deviance off "
                                       f"by {dev_rel:.3g} relative")
        _check(pred <= GLM_PRED_TOL, f"glm {what}: predictions off by {pred}")
        want = ia + 1 if kw.get("lambda_search") else ia
        _check(la == want, f"glm {what}: {la} Gram launches on the card, "
                           f"want {want}")


def _covtype_plan(fr):
    """The covertype frame's bin codes, edges and histogram plan, as the
    DRF build makes them (binning is on the frame's device)."""
    from h2o_tpu_torch.backend.memory import hbm_budget_bytes
    from h2o_tpu_torch.frame.chunks import BinnedView
    from h2o_tpu_torch.models.tree.binning import compute_bin_edges_cols
    from h2o_tpu_torch.models.tree.engine import plan_hist_groups

    names = [n for n in fr.names if n != "Cover_Type"]
    vecs = [fr.vec(n) for n in names]
    edges = compute_bin_edges_cols(vecs, np.zeros(len(names), bool), 20,
                                   seed=42)
    nedges = (~np.isnan(edges)).sum(axis=1)
    groups, _blk = plan_hist_groups(nedges, edges.shape[1] + 2, 8192,
                                    budget_bytes=hbm_budget_bytes(fr.device),
                                    n_lv_max=2 ** 11)
    return BinnedView.build(vecs, edges, names=names).matrix, edges, groups


def phase_covtype_kernel(dev, fr) -> dict:
    """The kernel through the wrapper the covertype plan picks, on the
    frame's own bin codes at 581,120 padded rows, at n_lv = 64, 512 and
    2,048 (DRF's deepest level at depth 12), V = 3: a bag's integer weights
    (0 or 1) and two real channels. Returns the plan and per-level rows."""
    import torch

    codes, edges, groups = _covtype_plan(fr)
    B = edges.shape[1] + 2
    flat = groups is None
    plan = (((tuple(range(codes.shape[1])), B, "onehot"),) if flat
            else groups)
    g = torch.Generator(device=dev).manual_seed(54)
    rl = codes.shape[0]
    rows = []
    for n_lv in (64, 512, 2048):
        lc = torch.randint(0, n_lv, (rl,), generator=g, device=dev,
                           dtype=torch.int32)
        vv = torch.randn((rl, 3), generator=g, device=dev)
        vv[:, 0] = torch.randint(0, 2, (rl,), generator=g, device=dev).float()
        row = _grouped_level(dev, codes, lc, vv, plan, n_lv, B, 10, flat=flat)
        row["wrapper"] = "flat" if flat else "grouped"
        print("level_hist_covtype", json.dumps(row), flush=True)
        rows.append(row)
        del lc, vv
    torch.cuda.empty_cache()
    return dict(wrapper="flat" if flat else "grouped", B=B,
                hist_groups=None if flat else
                [[list(i), w, m] for i, w, m in groups], per_level=rows)


def _class_probs(model, fr) -> "torch.Tensor":
    import torch

    pred = model.predict(fr)
    return torch.stack([pred.vec(f"p{d}").data[:fr.nrow]
                        for d in model.output.response_domain], dim=1)


def phase_drf_train(dev, fr, ntrees: int, xrt: bool, what: str,
                    wrapper: str) -> int:
    """DRF (or XRT) on the covertype frame end to end; returns the
    launches of the wrapper its plan picks, which must be ``wrapper`` (the
    one ``level_hist_covtype`` held against its plain version)."""
    import torch

    from h2o_tpu_torch.backend.kernels import gram, hist

    torch.cuda.reset_peak_memory_stats(dev)
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _drf(fr, ntrees, xrt=xrt)   # train_model synchronises the card
    train_s = time.perf_counter() - t0
    flat, grouped = hist.LAUNCHES, hist.GROUPED_LAUNCHES
    picked, other = (grouped, flat) if model.cfg.hist_groups else (flat,
                                                                   grouped)
    m = model.output.training_metrics
    t0 = time.perf_counter()
    p = _class_probs(model, fr)
    finite = bool(torch.isfinite(p).all())
    row_err = float((p.sum(dim=1) - 1).abs().max())
    predict_s = time.perf_counter() - t0
    pri = np.asarray(COVTYPE_COUNTS) / COVTYPE_ROWS
    prior_logloss = float(-(pri * np.log(pri)).sum())
    K, depth = len(COVTYPE_COUNTS), model.cfg.max_depth
    print(what, json.dumps(dict(
        rows=fr.nrow, ntrees=ntrees, classes=K, max_depth=depth,
        mtries=model.cfg.mtries, train_s=train_s, predict_s=predict_s,
        description=m.description, oob_logloss=m.logloss,
        prior_logloss=prior_logloss,
        mean_per_class_error=m.mean_per_class_error, oob_rows=m.nobs,
        wrapper="grouped" if model.cfg.hist_groups else "flat",
        launches=picked, other_launches=other,
        gram_launches=gram.GRAM_LAUNCHES, prob_row_sum_err=row_err,
        split_nodes=int((model.forest["feat"] >= 0).sum()),
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)),
        flush=True)
    _check(("grouped" if model.cfg.hist_groups else "flat") == wrapper,
           f"{what}: the plan picked another wrapper than {wrapper}")
    _check(picked == ntrees * K * 12 and depth == 12,
           f"{what}: {picked} launches of the plan's wrapper, want "
           f"{ntrees} x {K} x 12")
    _check(other == 0 and gram.GRAM_LAUNCHES == 0,
           f"{what}: {other} launches of the other histogram wrapper, "
           f"{gram.GRAM_LAUNCHES} Gram launches")
    _check(m.description == "Reported on OOB data",
           f"{what}: training metrics '{m.description}', not out of bag")
    _check(bool(np.isfinite(m.logloss)) and m.logloss < prior_logloss,
           f"{what}: OOB logloss {m.logloss} not below the prior's "
           f"{prior_logloss}")
    _check(m.mean_per_class_error < 6 / 7,
           f"{what}: mean per-class error {m.mean_per_class_error}")
    _check(finite and p.shape == (fr.nrow, K) and row_err <= 1e-5,
           f"{what}: class probabilities not finite or rows off 1 by "
           f"{row_err}")
    return picked


def phase_drf_card_vs_cpu(dev) -> None:
    """The covertype DRF on 100,000 rows x 5 iterations (35 trees, depth
    12), on the card and on the CPU: integer channels, so identical."""
    import torch

    rows, ntrees = 100_000, 5
    models, probs, frames = {}, {}, {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        fr = frames[d] = _covtype_frame(rows, d)
        models[d] = _drf(fr, ntrees)
        probs[d] = _class_probs(models[d], fr).cpu().numpy()
        print(f"drf_card_vs_cpu {d}: {time.perf_counter() - t0:.3f} s",
              flush=True)
    a, b = models[dev], models["cpu"]
    for k in ("feat", "nanL", "val"):
        _check(torch.equal(a.forest[k].cpu(), b.forest[k]),
               f"drf 100k rows: {k} differs between card and CPU")
    _check(np.array_equal(_split_bins(a), _split_bins(b)),
           "drf 100k rows: split bins differ between card and CPU")
    ma, mb = a.output.training_metrics, b.output.training_metrics
    _check(ma.nobs == mb.nobs and np.array_equal(ma.confusion_matrix,
                                                 mb.confusion_matrix),
           "drf 100k rows: out-of-bag counts differ between card and CPU")
    pred_err = float(np.abs(probs[dev] - probs["cpu"]).max())
    # the multinomial AUC family: model_performance under each auc_type
    aucs = {}
    for t in AUC_TYPES:
        for d, m in models.items():
            m.params.auc_type = t
            mm = m.model_performance(frames[d])
            aucs[(t, d)] = (mm.auc, mm.pr_auc)
        a.params.auc_type = b.params.auc_type = "AUTO"
    auc_err = max(abs(aucs[(t, dev)][i] - aucs[(t, "cpu")][i])
                  for t in AUC_TYPES for i in (0, 1))
    print("drf_card_vs_cpu", json.dumps(dict(
        rows=rows, ntrees=ntrees, split_nodes=int((a.forest["feat"] >= 0)
                                                  .sum()),
        oob_rows=ma.nobs, oob_logloss_card=ma.logloss,
        oob_logloss_cpu=mb.logloss, pred_max_abs_err=pred_err,
        auc_card={t: aucs[(t, dev)][0] for t in AUC_TYPES},
        pr_auc_card={t: aucs[(t, dev)][1] for t in AUC_TYPES},
        auc_max_abs_err=auc_err)), flush=True)
    _check(pred_err <= CPU_TOL, f"drf 100k rows: predictions off by "
                                f"{pred_err}")
    _check(auc_err <= 1e-6, f"drf 100k rows: AUC types off by {auc_err}")
    for t in AUC_TYPES:
        auc = aucs[(t, dev)][0]
        _check(bool(np.isfinite(auc)) and 0.5 < auc <= 1.0,
               f"drf 100k rows: {t} AUC {auc}")


class _Walls:
    """Wall clock of each call of ``cls.method`` (synchronised with the
    card), recorded while the context is open: the fold and main model
    builds under ``train_model``, or the metrics scans."""

    def __init__(self, cls, method: str, dev):
        self.cls, self.method, self.dev, self.s = cls, method, dev, []

    def __enter__(self):
        import torch

        orig = getattr(self.cls, self.method)
        self.orig = orig

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            self.s.append(time.perf_counter() - t0)
            return out
        setattr(self.cls, self.method, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.method, self.orig)


def _import_airlines(path: str, dev):
    from h2o_tpu_torch import import_file

    return import_file(path, col_types=IMPORT_COL_TYPES, device=dev)


def phase_import_csv(dev):
    """Write the 7,009,728-row airlines CSV, read it back through
    ``import_file`` and check every column against the generator; returns
    the frame and the parse's numbers."""
    import torch

    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, "airlines_2008.csv")
    try:
        t0 = time.perf_counter()
        cols, y = _write_airlines_csv(path, IMPORT_ROWS)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = _import_airlines(path, dev)
        torch.cuda.synchronize()
        parse_s = time.perf_counter() - t0
    finally:
        if os.path.exists(path):
            os.remove(path)
    n = IMPORT_ROWS
    _check(fr.nrow == n, f"import_csv: {fr.nrow} rows, want {n}")
    types = fr.types()
    want = dict({c: "enum" for c in IMPORT_CATS}, CRSDepTime="int",
                Distance="real")
    _check(types == want, f"import_csv: types {types}")
    cards = tuple(fr.vec(c).cardinality() for c in IMPORT_CATS)
    _check(cards == IMPORT_CARDS, f"import_csv: domain sizes {cards}")
    blank = _csv_blanks(n)
    for name in fr.names:
        na = torch.isnan(fr.vec(name).data[:n]).cpu().numpy()
        want_na = blank.get(name, np.zeros(n, dtype=bool))
        _check(np.array_equal(na, want_na),
               f"import_csv: {name} NA at {int(na.sum())} rows, the writer "
               f"blanked {int(want_na.sum())}")
    gen = dict(cols, IsDepDelayed=(y, ["NO", "YES"]))
    for name, (vals, dom) in gen.items():
        got = fr.vec(name).data[:n].cpu().numpy()
        if dom is not None:
            # the parsed codes, read by level name, are the generator's
            at = {lvl: i for i, lvl in enumerate(fr.vec(name).domain)}
            perm = np.array([at[lvl] for lvl in dom], dtype=np.float32)
            _check(np.array_equal(got, perm[vals.astype(np.int64)]),
                   f"import_csv: {name} levels differ from the generator's")
        else:
            ok = ~blank[name]
            _check(np.array_equal(got[ok].view(np.int32),
                                  vals[ok].astype(np.float32).view(np.int32)),
                   f"import_csv: {name} is not the generator's float32")
    # the same rows with the string levels quoted (R's write.csv): the
    # same frame bit for bit
    try:
        _write_airlines_csv(path, IMPORT_ROWS, quote=True)
        qsize = os.path.getsize(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fq = _import_airlines(path, dev)
        torch.cuda.synchronize()
        qparse_s = time.perf_counter() - t0
    finally:
        if os.path.exists(path):
            os.remove(path)
    _check(fq.names == fr.names and fq.types() == types,
           f"import_csv quoted: names {fq.names}, types {fq.types()}")
    for name in fr.names:
        a, b = fr.vec(name), fq.vec(name)
        _check(a.domain == b.domain and torch.equal(
            a.data.view(torch.int32), b.data.view(torch.int32)),
            f"import_csv quoted: {name} differs from the unquoted parse")
    del fq
    out = dict(rows=n, bytes=size, write_s=write_s, parse_s=parse_s,
               parse_mb_per_s=size / 1e6 / parse_s,
               parse_rows_per_s=n / parse_s, quoted_bytes=qsize,
               quoted_parse_s=qparse_s,
               quoted_parse_mb_per_s=qsize / 1e6 / qparse_s,
               na=dict(Distance=int(blank["Distance"].sum()),
                       CRSDepTime=int(blank["CRSDepTime"].sum())),
               domain_sizes=dict(zip(IMPORT_CATS, cards)))
    print("import_csv", json.dumps(out), flush=True)
    return fr, out


def _cv_gbm(train, valid, calib, **kw):
    """``bench_airlines``'s GBM with 5-fold CV (holdout predictions and
    fold assignment kept), a validation frame and Platt calibration."""
    from h2o_tpu_torch import GBM, GBMParameters

    params = dict(training_frame=train, response_column="IsDepDelayed",
                  ntrees=10, max_depth=5, nbins=20, nbins_cats=1024,
                  learn_rate=0.1, seed=42, nfolds=5,
                  keep_cross_validation_predictions=True,
                  keep_cross_validation_fold_assignment=True,
                  validation_frame=valid, calibrate_model=True,
                  calibration_frame=calib)
    params.update(kw)
    return GBM(GBMParameters(**params)).train_model()


def _cv_glm(train, valid):
    """``bench.py:bench_glm``'s IRLSM fit (binomial, seed 42) on all nine
    predictors, one-hot, with 5-fold CV and a validation frame."""
    from h2o_tpu_torch import GLM, GLMParameters

    return GLM(GLMParameters(training_frame=train,
                             response_column="IsDepDelayed",
                             family="binomial", seed=42, nfolds=5,
                             validation_frame=valid)).train_model()


def _import_hist_levels(dev, model, train) -> dict:
    """The grouped wrapper against its plain version on the imported train
    frame's own bin codes, under the main CV model's edges and plan, at
    every level width of its depth-5 trees, V = 3 (a 0/1 weight and two
    real channels). Returns the levels' sums and the per-level rows."""
    import torch

    from h2o_tpu_torch.frame.chunks import BinnedView

    names = [n for n in train.names if n != "IsDepDelayed"]
    groups, B = model.cfg.hist_groups, model.cfg.nbins + 1
    _check(groups is not None and len(names) == model.edges.shape[0],
           "import_cv_gbm: the main model's plan is not grouped")
    codes = BinnedView.build([train.vec(n) for n in names], model.edges,
                             names=names).matrix
    g = torch.Generator(device=dev).manual_seed(2008)
    rl = codes.shape[0]
    rows = []
    for n_lv in (1, 2, 4, 8, 16):
        lc = torch.randint(0, n_lv, (rl,), generator=g, device=dev,
                           dtype=torch.int32)
        vv = torch.randn((rl, 3), generator=g, device=dev)
        vv[:, 0] = torch.randint(0, 2, (rl,), generator=g, device=dev).float()
        row = _grouped_level(dev, codes, lc, vv, groups, n_lv, B, 10)
        print("level_hist_import", json.dumps(row), flush=True)
        rows.append(row)
        del lc, vv
    del codes
    torch.cuda.empty_cache()
    out = {k: sum(r[k] for r in rows)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(out, rows=rl, B=B, n_lv=[r["n_lv"] for r in rows],
                max_abs_err=max(r["max_abs_err"] for r in rows),
                max_rel_mass=max(r["max_rel_mass"] for r in rows),
                per_level_ms=[r["ms"] for r in rows], bound_by="bytes",
                hist_groups=[[list(i), w, m] for i, w, m in groups])


def phase_import_cv_gbm(dev, train, valid, calib) -> tuple[int, dict]:
    """The GBM with CV, validation and calibration on the imported split;
    returns its grouped launches and the kernel's numbers on the train
    frame's own codes."""
    import torch

    from h2o_tpu_torch import GBM
    from h2o_tpu_torch.backend.kernels import gram, hist
    from h2o_tpu_torch.models import metrics

    torch.cuda.reset_peak_memory_stats(dev)
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Walls(GBM, "build_impl", dev) as builds, \
            _Walls(metrics, "make_binomial_metrics", dev) as scans:
        model = _cv_gbm(train, valid, calib)
    train_s = time.perf_counter() - t0
    launches, flat, grams = (hist.GROUPED_LAUNCHES, hist.LAUNCHES,
                             gram.GRAM_LAUNCHES)
    folds = model.output.cv_models
    trees = sum(m.ntrees for m in folds) + model.ntrees
    fa = model.output.cv_fold_assignment.vec(0).to_numpy()
    hold = model.output.cv_holdout_predictions.vec("pYES").to_numpy()
    cv = model.output.cross_validation_metrics
    va = model.output.validation_metrics
    pred = model.predict(valid)
    p0 = pred.vec("cal_p0").data[:valid.nrow]
    p1 = pred.vec("cal_p1").data[:valid.nrow]
    cal_err = float((p0 + p1 - 1).abs().max())
    cal_auc = metrics.make_binomial_metrics(
        valid.vec("IsDepDelayed").data[:valid.nrow], p1).auc
    print("import_cv_gbm", json.dumps(dict(
        train_rows=train.nrow, valid_rows=valid.nrow, calib_rows=calib.nrow,
        train_s=train_s, fold_build_s=builds.s[:-1], main_build_s=builds.s[-1],
        metrics_scans=len(scans.s), metrics_scan_s=sum(scans.s),
        trees=trees, grouped_launches=launches, flat_launches=flat,
        cv_auc=cv.auc, valid_auc=va.auc, calibrated_valid_auc=cal_auc,
        platt=list(model.calib), cal_sum_max_err=cal_err,
        fold_rows=np.bincount(fa.astype(np.int64)).tolist(),
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)),
        flush=True)
    _check(len(folds) == 5 and len(builds.s) == 6, "import_cv_gbm: 5 folds")
    _check(fa.shape == (train.nrow,) and set(np.unique(fa)) == set(range(5)),
           "import_cv_gbm: the fold assignment does not cover the train rows "
           "with 5 folds")
    _check(hold.shape == (train.nrow,) and bool(np.isfinite(hold).all()),
           "import_cv_gbm: holdout predictions not finite on every row")
    for what, auc in (("CV", cv.auc), ("validation", va.auc),
                      ("calibrated", cal_auc)):
        _check(bool(np.isfinite(auc)) and auc > 0.6,
               f"import_cv_gbm: {what} AUC {auc}")
    _check(cal_err <= 1e-6, f"import_cv_gbm: cal_p0 + cal_p1 off 1 by "
                            f"{cal_err}")
    _check(launches == trees * 5 and flat == 0 and grams == 0,
           f"import_cv_gbm: {launches} grouped, {flat} flat, {grams} Gram "
           f"launches for {trees} trees of depth 5")
    # after the counted run: the kernel against its plain version on what
    # this path feeds it
    return launches, _import_hist_levels(dev, model, train)


def phase_import_cv_glm(dev, train, valid) -> tuple[int, dict]:
    """The one-hot binomial GLM with CV on the imported split; returns its
    Gram launches and the Gram kernel's time at this path's design."""
    import torch

    from h2o_tpu_torch import GLM
    from h2o_tpu_torch.backend.kernels import gram, hist

    torch.cuda.reset_peak_memory_stats(dev)
    gram.GRAM_LAUNCHES = hist.LAUNCHES = hist.GROUPED_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Walls(GLM, "build_impl", dev) as builds:
        model = _cv_glm(train, valid)
    train_s = time.perf_counter() - t0
    launches = gram.GRAM_LAUNCHES
    hist_launches = hist.LAUNCHES + hist.GROUPED_LAUNCHES
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    fits = model.output.cv_models + [model]
    iters = [m.output.scoring_history[-1]["iterations"] for m in fits]
    P = len(model.dinfo.expanded_names) + 1
    cv, va = (model.output.cross_validation_metrics,
              model.output.validation_metrics)
    devs = [(m.output.training_metrics.residual_deviance,
             m.output.training_metrics.null_deviance) for m in fits]
    # the kernel at this path's design, after the counted run: the main
    # fit's one-hot X, held against the plain version on the same inputs
    # (W an IRLS-like weight in [0, 0.25), zero on the rows the fit drops)
    Xi, ok = model.dinfo.expand(train, intercept=True)
    g = torch.Generator(device=dev).manual_seed(690)
    R = Xi.shape[0]
    W = torch.rand((R,), generator=g, device=dev) * 0.25 * ok.float()
    z = torch.randn((R,), generator=g, device=dev)
    shape = _gram_check(Xi.contiguous(), W, z, reps=3)
    del Xi, ok, W, z
    torch.cuda.empty_cache()
    print("import_cv_glm", json.dumps(dict(
        train_rows=train.nrow, P=P, train_s=train_s, fit_s=builds.s,
        iterations=iters, gram_launches=launches,
        hist_launches=hist_launches, cv_auc=cv.auc, valid_auc=va.auc,
        deviances=devs, peak_mem_gb=peak, gram_at_path=shape)), flush=True)
    _check(P == 690, f"import_cv_glm: P = {P}, want 690")
    _check(len(fits) == 6 and launches == sum(iters) and hist_launches == 0,
           f"import_cv_glm: {launches} Gram launches for {sum(iters)} IRLS "
           f"iterations over {len(fits)} fits, {hist_launches} histogram "
           "launches")
    _check(all(r < n for r, n in devs),
           f"import_cv_glm: residual not below null deviance: {devs}")
    for what, auc in (("CV", cv.auc), ("validation", va.auc)):
        _check(bool(np.isfinite(auc)) and auc > 0.6,
               f"import_cv_glm: {what} AUC {auc}")
    return launches, shape


def phase_import_cv_card_vs_cpu(dev) -> None:
    """A 100,000-row CSV of the same generator through the whole path on
    the card and on the CPU: the same frame, folds, forests, Platt
    coefficients, coefficients and CV metrics."""
    import torch

    from h2o_tpu_torch import split_frame

    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, "airlines_small.csv")
    try:
        _write_airlines_csv(path, IMPORT_CPU_ROWS)
        frames = {d: _import_airlines(path, d) for d in (dev, "cpu")}
    finally:
        if os.path.exists(path):
            os.remove(path)
    a, b = frames[dev], frames["cpu"]
    _check(a.types() == b.types(), "import 100k: types differ")
    for name in a.names:
        va, vb = a.vec(name), b.vec(name)
        _check(va.domain == vb.domain and np.array_equal(
            va.data.cpu().numpy().view(np.int32),
            vb.data.numpy().view(np.int32)),
            f"import 100k: {name} differs between card and CPU")
    gbms, glms = {}, {}
    for d, fr in frames.items():
        t0 = time.perf_counter()
        train, valid, calib = split_frame(fr, ratios=[0.7, 0.15], seed=42)
        gbms[d] = _cv_gbm(train, valid, calib)
        t1 = time.perf_counter()
        glms[d] = _cv_glm(train, valid)
        print(f"import_cv_card_vs_cpu {d}: gbm {t1 - t0:.3f} s, glm "
              f"{time.perf_counter() - t1:.3f} s", flush=True)
    ga, gb = gbms[dev], gbms["cpu"]
    _check(np.array_equal(ga.output.cv_fold_assignment.vec(0).to_numpy(),
                          gb.output.cv_fold_assignment.vec(0).to_numpy()),
           "import 100k: fold assignments differ")
    val_err = platt_err = 0.0
    for ma, mb in zip(ga.output.cv_models + [ga], gb.output.cv_models + [gb]):
        for k in ("feat", "nanL", "catd"):
            _check(torch.equal(ma.forest[k].cpu(), mb.forest[k]),
                   f"import 100k GBM: {k} differs between card and CPU")
        _check(np.array_equal(_split_bins(ma), _split_bins(mb)),
               "import 100k GBM: split bins differ")
        val_err = max(val_err, float((ma.forest["val"].cpu()
                                      - mb.forest["val"]).abs().max()))
        platt_err = max(platt_err, float(np.abs(np.subtract(ma.calib,
                                                            mb.calib)).max()))
    ha = ga.output.cv_holdout_predictions.vec("pYES").to_numpy()
    hb = gb.output.cv_holdout_predictions.vec("pYES").to_numpy()
    pred_err = float(np.abs(ha - hb).max())
    cva, cvb = (ga.output.cross_validation_metrics,
                gb.output.cross_validation_metrics)
    gbm_cv_err = max(abs(getattr(cva, k) - getattr(cvb, k))
                     for k in ("auc", "logloss", "mse"))
    coef_err = 0.0
    for ma, mb in zip(glms[dev].output.cv_models + [glms[dev]],
                      glms["cpu"].output.cv_models + [glms["cpu"]]):
        coef_err = max(coef_err, float(np.max(
            np.abs(ma.beta - mb.beta) / np.maximum(1.0, np.abs(mb.beta)))))
    la, lb = (glms[dev].output.cross_validation_metrics,
              glms["cpu"].output.cross_validation_metrics)
    glm_cv_err = max(abs(getattr(la, k) - getattr(lb, k))
                     for k in ("auc", "logloss", "mse"))
    print("import_cv_card_vs_cpu", json.dumps(dict(
        rows=IMPORT_CPU_ROWS, leaf_max_abs_err=val_err,
        holdout_pred_max_abs_err=pred_err, platt_max_abs_err=platt_err,
        gbm_cv_metric_max_abs_err=gbm_cv_err, glm_coef_max_rel_err=coef_err,
        glm_cv_metric_max_abs_err=glm_cv_err, gbm_cv_auc_card=cva.auc,
        glm_cv_auc_card=la.auc)), flush=True)
    _check(val_err <= CPU_TOL and pred_err <= CPU_TOL,
           f"import 100k GBM: leaves off by {val_err}, holdout predictions "
           f"by {pred_err}")
    _check(platt_err <= CPU_TOL, f"import 100k: Platt (a, b) off by "
                                 f"{platt_err}")
    _check(gbm_cv_err <= CPU_TOL, f"import 100k: GBM CV metrics off by "
                                  f"{gbm_cv_err}")
    _check(coef_err <= GLM_COEF_TOL, f"import 100k: GLM coefficients off by "
                                     f"{coef_err} x max(1, |beta|)")
    _check(glm_cv_err <= GLM_COEF_TOL, f"import 100k: GLM CV metrics off by "
                                       f"{glm_cv_err}")


def _forests_bit_equal(a, b) -> bool:
    import torch

    return set(a.forest) == set(b.forest) and all(
        torch.equal(a.forest[k], b.forest[k]) for k in a.forest)


def phase_compress_airlines(dev, fr) -> int:
    """The chunk codecs on the imported airlines frame: each column's
    codec, its coded bytes against raw float32 and a bit-equal decode on
    the card; the batched code-space rollups against the raw rollups; and a
    5-tree GBM at ``bench_airlines`` settings on the coded frame against
    one on the raw frame (bit-equal forests). Returns the coded frame's
    grouped launches."""
    import torch

    from h2o_tpu_torch import compress_frame
    from h2o_tpu_torch.backend.kernels import gram, hist
    from h2o_tpu_torch.frame.chunks import CodedVec

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfr = compress_frame(fr)
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    cols, coded_b, raw_b = {}, 0, 0
    for name in fr.names:
        v, cv = fr.vec(name), cfr.vec(name)
        raw = v.plen * 4
        nbytes = cv.coded_nbytes() if isinstance(cv, CodedVec) else raw
        _check(torch.equal(cv.data.view(torch.int32),
                           v.data.view(torch.int32)),
               f"compress_airlines: {name} does not decode bit for bit")
        cols[name] = dict(kind=cv.meta.kind if isinstance(cv, CodedVec)
                          else "raw", coded_bytes=nbytes, raw_bytes=raw)
        coded_b += nbytes
        raw_b += raw
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfr.ensure_rollups()
    rollup_s = time.perf_counter() - t0
    roll_err = 0.0
    for name in fr.names:
        r, rc = fr.vec(name).rollups(), cfr.vec(name).rollups()
        _check((rc.nacnt, rc.zerocnt, rc.mins, rc.maxs, rc.is_int)
               == (r.nacnt, r.zerocnt, r.mins, r.maxs, r.is_int),
               f"compress_airlines: {name} rollups {rc} against raw {r}")
        for a, b in ((rc.mean, r.mean), (rc.sigma, r.sigma)):
            roll_err = max(roll_err, abs(a - b) / max(abs(b), 1e-30))
    _check(roll_err <= 1e-4, f"compress_airlines: mean/sigma off by a "
                             f"relative {roll_err}")
    kw = dict(response_column="IsDepDelayed", ntrees=5, max_depth=5,
              nbins=20, nbins_cats=1024, learn_rate=0.1, seed=42)
    from h2o_tpu_torch import GBM, GBMParameters

    raw_model = GBM(GBMParameters(training_frame=fr, **kw)).train_model()
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded_model = GBM(GBMParameters(training_frame=cfr, **kw)).train_model()
    coded_s = time.perf_counter() - t0
    launches, flat = hist.GROUPED_LAUNCHES, hist.LAUNCHES
    print("compress_airlines", json.dumps(dict(
        rows=fr.nrow, compress_s=compress_s, rollup_s=rollup_s,
        coded_bytes=coded_b, raw_f32_bytes=raw_b, ratio=coded_b / raw_b,
        rollup_max_rel_err=roll_err, columns=cols,
        gbm_on_coded_s=coded_s, grouped_launches=launches,
        flat_launches=flat,
        raw_gbm_s=raw_model.output.run_time_ms / 1000,
        auc=coded_model.output.training_metrics.auc)), flush=True)
    _check(_forests_bit_equal(coded_model, raw_model),
           "compress_airlines: the forest on the coded frame differs")
    _check(launches == 5 * 5 and flat == 0 and gram.GRAM_LAUNCHES == 0,
           f"compress_airlines: {launches} grouped, {flat} flat launches")
    return launches


def phase_checkpoint_higgs(dev, fr, full) -> int:
    """Checkpoint continuation, snapshots and model files on the HIGGS
    frame: 5 trees, then ``checkpoint=`` that model's key to 10 trees
    against the ``train`` phase's 10-tree model ``full``; a 10-tree run
    with ``export_checkpoints_dir`` every 2 trees; the continuation saved
    and scored by a fresh process on the card. Returns the continuation's
    flat launches."""
    import shutil

    import torch

    from h2o_tpu_torch import (GBM, GBMParameters, load_model, save_frame)
    from h2o_tpu_torch.backend.kernels import gram, hist

    kw = dict(training_frame=fr, response_column="response", max_depth=5,
              nbins=20, nbins_cats=1024, learn_rate=0.1, seed=42)
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    prior = GBM(GBMParameters(ntrees=5, **kw)).train_model()
    prior_launches = hist.LAUNCHES
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cont = GBM(GBMParameters(ntrees=10, checkpoint=prior.key, **kw)
               ).train_model()
    cont_s = time.perf_counter() - t0
    launches, other = hist.LAUNCHES, hist.GROUPED_LAUNCHES
    rows = fr.nrow
    p_full = full.predict(fr).vec("ps").data[:rows]
    p_cont = cont.predict(fr).vec("ps").data[:rows]
    pred_err = float((p_cont - p_full).abs().max())
    val_err = float((cont.forest["val"] - full.forest["val"]).abs().max())
    for k in ("feat", "nanL", "thr"):
        _check(torch.equal(cont.forest[k], full.forest[k]),
               f"checkpoint_higgs: {k} differs from the 10-tree run")
    _check(pred_err <= CPU_TOL and val_err <= CPU_TOL,
           f"checkpoint_higgs: leaves off by {val_err}, predictions by "
           f"{pred_err}")
    _check(launches == 25 and other == 0 and prior_launches == 25,
           f"checkpoint_higgs: {launches} flat and {other} grouped launches "
           f"for the continuation, {prior_launches} for the prior")
    snaps = os.path.join(DATA_DIR, "higgs_snapshots")
    shutil.rmtree(snaps, ignore_errors=True)
    os.makedirs(DATA_DIR, exist_ok=True)
    try:
        t0 = time.perf_counter()
        exp = GBM(GBMParameters(ntrees=10, score_tree_interval=2,
                                export_checkpoints_dir=snaps, **kw)
                  ).train_model()
        export_s = time.perf_counter() - t0
        _check(_forests_bit_equal(exp, full),
               "checkpoint_higgs: the exporting run's forest differs from "
               "the train phase's")
        names = sorted(os.listdir(snaps))
        _check(names == [f"gbm_{n:05d}.bin" for n in (2, 4, 6, 8, 10)],
               f"checkpoint_higgs: snapshots {names}")
        sl = fr.take(np.arange(min(SLICE_ROWS, rows)))
        for i, name in enumerate(names):
            snap = load_model(os.path.join(snaps, name), device=dev)
            _check(snap.ntrees == 2 * (i + 1), f"{name}: {snap.ntrees} trees")
            ps = snap.predict(sl).vec("ps").data
            _check(bool(torch.isfinite(ps).all()), f"{name}: scores")
        _check(torch.equal(ps, exp.predict(sl).vec("ps").data),
               "checkpoint_higgs: the last snapshot scores differently")
        # the continuation's file, scored by a fresh process on the card
        mpath = os.path.join(DATA_DIR, "higgs_cont.bin")
        t0 = time.perf_counter()
        cont.save(mpath)
        save_s = time.perf_counter() - t0
        save_frame(sl, os.path.join(DATA_DIR, "higgs_slice"))
        code = ("import sys, numpy as np; sys.path.insert(0, sys.argv[1]); "
                "from h2o_tpu_torch import load_frame, load_model; "
                "d, dev = sys.argv[2], sys.argv[3]; "
                "m = load_model(d + '/higgs_cont.bin', device=dev); "
                "fr = load_frame(d + '/higgs_slice.npz', device=dev); "
                "np.save(d + '/higgs_slice_p.npy', "
                "m.predict(fr).vec('ps').data[:fr.nrow].cpu().numpy())")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", code,
             os.path.dirname(os.path.abspath(__file__)), DATA_DIR, str(dev)],
            capture_output=True, text=True, timeout=300)
        fresh_s = time.perf_counter() - t0
        _check(proc.returncode == 0,
               f"checkpoint_higgs: fresh process failed\n{proc.stderr}")
        child = np.load(os.path.join(DATA_DIR, "higgs_slice_p.npy"))
        mine = cont.predict(sl).vec("ps").data[:sl.nrow].cpu().numpy()
        _check(child.tobytes() == mine.tobytes(),
               "checkpoint_higgs: the fresh process scores differently")
        model_mb = os.path.getsize(mpath) / 1e6
    finally:
        shutil.rmtree(snaps, ignore_errors=True)
        for f in ("higgs_cont.bin", "higgs_slice.npz", "higgs_slice.json",
                  "higgs_slice_p.npy"):
            if os.path.exists(os.path.join(DATA_DIR, f)):
                os.remove(os.path.join(DATA_DIR, f))
    print("checkpoint_higgs", json.dumps(dict(
        rows=rows, prior_trees=5, ntrees=10, continuation_s=cont_s,
        continuation_launches=launches, leaf_max_abs_err=val_err,
        pred_max_abs_err=pred_err, export_run_s=export_s, snapshots=names,
        model_file_mb=model_mb, model_save_s=save_s,
        fresh_process_s=fresh_s, fresh_rows=len(child))), flush=True)
    return launches


class _LastOOB:
    """Records the out-of-bag sums and counts of the last
    ``gbm._oob_metrics`` call while the context is open."""

    def __enter__(self):
        from h2o_tpu_torch.models import gbm

        self.orig, self.last = gbm._oob_metrics, None

        def spy(category, osum, ocnt, *a, **kw):
            self.last = (osum.clone(), ocnt.clone())
            return self.orig(category, osum, ocnt, *a, **kw)
        gbm._oob_metrics = spy
        return self

    def __exit__(self, *exc):
        from h2o_tpu_torch.models import gbm

        gbm._oob_metrics = self.orig


def phase_recovery_drf(dev, fr, wrapper: str) -> int:
    """The covertype DRF at the ``drf_train`` settings with
    ``score_tree_interval=10`` and ``auto_recovery_dir``, killed before
    its third chunk (``train.gbm.chunk:raise(preempt)@3``) and resumed:
    forest, out-of-bag sums and counts and class probabilities bit-equal to
    an uninterrupted run at the same parameters. Returns the launches of
    the plan's wrapper in the killed run and the resume together."""
    import shutil

    import torch

    from h2o_tpu_torch import DRF, DRFParameters, resume_training
    from h2o_tpu_torch.backend import persist
    from h2o_tpu_torch.backend.kernels import gram, hist
    from h2o_tpu_torch.utils import failpoints

    def params(**kw):
        return DRFParameters(training_frame=fr, response_column="Cover_Type",
                             ntrees=RECOVERY_DRF_TREES, seed=42,
                             score_tree_interval=10, **kw)

    def counted():
        return hist.GROUPED_LAUNCHES if wrapper == "grouped" \
            else hist.LAUNCHES

    rdir = os.path.join(DATA_DIR, "recovery_drf")
    shutil.rmtree(rdir, ignore_errors=True)
    old = os.environ.get("H2O_TORCH_CHECKPOINT_SECS")
    os.environ["H2O_TORCH_CHECKPOINT_SECS"] = "0"   # every boundary
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _LastOOB() as oob_base:
            base = DRF(params()).train_model()
        base_s = time.perf_counter() - t0
        hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
        failpoints.arm("train.gbm.chunk", "raise(preempt)@3")
        t0 = time.perf_counter()
        with _Walls(persist, "save_frame", dev) as frame_saves, \
                _Walls(persist.TrainingRecovery, "save_state",
                       dev) as writes:
            try:
                DRF(params(auto_recovery_dir=rdir)).train_model()
                _check(False, "recovery_drf: the kill did not fire")
            except failpoints.InjectedPreemption:
                pass
            killed_s = time.perf_counter() - t0
            failpoints.reset()
            killed_writes = len(writes.s)
            killed_launches = counted()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _LastOOB() as oob_res:
                res = resume_training(rdir, device=dev)
            resume_s = time.perf_counter() - t0
        launches = counted()
        manifest = persist.Recovery(rdir).read()
    finally:
        failpoints.reset()
        shutil.rmtree(rdir, ignore_errors=True)
        if old is None:
            os.environ.pop("H2O_TORCH_CHECKPOINT_SECS", None)
        else:
            os.environ["H2O_TORCH_CHECKPOINT_SECS"] = old
    pb, pr = _class_probs(base, fr), _class_probs(res, fr)
    frame_mb = sum(v.plen * 4 for v in fr.vecs) / 1e6
    print("recovery_drf", json.dumps(dict(
        rows=fr.nrow, ntrees=RECOVERY_DRF_TREES, interval=10,
        killed_at_chunk=3,
        uninterrupted_s=base_s, killed_run_s=killed_s, resume_s=resume_s,
        frame_save_s=frame_saves.s, frame_f32_mb=frame_mb,
        frame_save_mb_per_s=frame_mb / max(sum(frame_saves.s), 1e-9),
        state_writes=len(writes.s), state_writes_killed_run=killed_writes,
        write_s=sum(writes.s), killed_launches=killed_launches,
        launches=launches, manifest_checkpoints=manifest["checkpoints"],
        completed=manifest["completed"],
        description=res.output.training_metrics.description)), flush=True)
    _check(_forests_bit_equal(res, base),
           "recovery_drf: the resumed forest differs")
    _check(torch.equal(oob_res.last[0], oob_base.last[0])
           and torch.equal(oob_res.last[1], oob_base.last[1]),
           "recovery_drf: OOB sums or counts differ")
    _check(torch.equal(pr, pb), "recovery_drf: class probabilities differ")
    chunks = RECOVERY_DRF_TREES // 10
    _check(manifest["completed"] and killed_writes == 2
           and len(writes.s) == chunks,
           f"recovery_drf: {len(writes.s)} state writes "
           f"({killed_writes} before the kill), manifest {manifest}")
    _check(launches == RECOVERY_DRF_TREES * 7 * 12
           and killed_launches == 20 * 7 * 12,
           f"recovery_drf: {launches} launches ({killed_launches} before "
           f"the kill), want {RECOVERY_DRF_TREES * 7 * 12} (1680 before "
           f"it)")
    return launches


def phase_recovery_card_vs_cpu(dev) -> None:
    """The GBM kill drill at every boundary on 1M HIGGS rows (6 trees,
    ``score_tree_interval=2``: 3 kills) on the card: each resumed forest
    and its predictions bit-equal to the card's uninterrupted run; that
    forest against the CPU's within the ``card_vs_cpu`` tolerances."""
    import shutil

    import torch

    from h2o_tpu_torch import GBM, GBMParameters, resume_training
    from h2o_tpu_torch.utils import failpoints

    rows = RECOVERY_ROWS

    def params(fr, **kw):
        return GBMParameters(training_frame=fr, response_column="response",
                             ntrees=6, max_depth=5, nbins=20, learn_rate=0.1,
                             score_tree_interval=2, seed=42, **kw)

    fr = _higgs_frame(rows, dev)
    base = GBM(params(fr)).train_model()
    p_base = base.predict(fr).vec("ps").data[:rows]
    old = os.environ.get("H2O_TORCH_CHECKPOINT_SECS")
    os.environ["H2O_TORCH_CHECKPOINT_SECS"] = "0"
    walls = []
    try:
        for k in (1, 2, 3):
            rdir = os.path.join(DATA_DIR, f"recovery_gbm_k{k}")
            shutil.rmtree(rdir, ignore_errors=True)
            failpoints.arm("train.gbm.chunk", f"raise(preempt)@{k}")
            try:
                GBM(params(fr, auto_recovery_dir=rdir)).train_model()
                _check(False, f"recovery_card_vs_cpu: kill {k} did not fire")
            except failpoints.InjectedPreemption:
                pass
            failpoints.reset()
            t0 = time.perf_counter()
            m = resume_training(rdir, device=dev)
            walls.append(time.perf_counter() - t0)
            shutil.rmtree(rdir, ignore_errors=True)
            _check(_forests_bit_equal(m, base),
                   f"recovery_card_vs_cpu: forest differs after kill {k}")
            _check(torch.equal(m.predict(fr).vec("ps").data[:rows], p_base),
                   f"recovery_card_vs_cpu: predictions differ after kill {k}")
    finally:
        failpoints.reset()
        if old is None:
            os.environ.pop("H2O_TORCH_CHECKPOINT_SECS", None)
        else:
            os.environ["H2O_TORCH_CHECKPOINT_SECS"] = old
    cfr = _higgs_frame(rows, "cpu")
    cpu = GBM(params(cfr)).train_model()
    cmp = _same_forest(base, cpu, "recovery_card_vs_cpu")
    pred_err = float((p_base.cpu() - cpu.predict(cfr).vec("ps").data[:rows]
                      ).abs().max())
    _check(pred_err <= CPU_TOL,
           f"recovery_card_vs_cpu: predictions off by {pred_err}")
    print("recovery_card_vs_cpu", json.dumps(dict(
        rows=rows, ntrees=6, interval=2, kills=3, resume_s=walls,
        pred_max_abs_err=pred_err, **cmp)), flush=True)


# ---------------------------------------------------------------------------
# the MNIST-shaped unsupervised and neural slice
# ---------------------------------------------------------------------------
def _mnist_cols(nrow: int, seed: int = 784):
    """An MNIST-shaped design (a stand-in: MNIST itself is not in the
    repo): ``pixels`` (nrow, 784) uint8 in 0..255 (28 x 28, row-major) and
    ``labels`` (nrow,) in 0..9. Each class has a stroke template (four
    thick random segments on the canvas); a row draws its class's template
    shifted by up to 3 pixels each way and blended with a third of another
    class's, and lights each pixel with that map's probability plus a
    floor — about a fifth of all pixels, at an intensity in 1..255.
    MNIST_BORDER pixels of the outer ring stay 0 in every row, as in
    MNIST's training set, so 717 columns vary."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float64)
    tmpl = np.zeros((10, 28, 28))
    for c in range(10):
        for _ in range(4):
            (y0, x0), (y1, x1) = rng.uniform(6, 22, size=(2, 2))
            dy, dx = y1 - y0, x1 - x0
            t = np.clip(((yy - y0) * dy + (xx - x0) * dx)
                        / max(dy * dy + dx * dx, 1e-9), 0, 1)
            d = np.hypot(yy - (y0 + t * dy), xx - (x0 + t * dx))
            tmpl[c] = np.maximum(tmpl[c], np.exp(-(d / 2.0) ** 2))
    shifts = [(a, b) for a in range(-3, 4) for b in range(-3, 4)]
    maps = np.stack([np.roll(tmpl, sh, axis=(1, 2)) for sh in shifts],
                    axis=1).reshape(10, len(shifts), 784).astype(np.float32)
    labels = rng.integers(0, 10, nrow)
    other = (labels + rng.integers(1, 10, nrow)) % 10
    sh = rng.integers(0, len(shifts), nrow)
    p = 0.65 * maps[labels, sh] + 0.35 * maps[other, sh]
    floor = np.float32(0.02)
    p = np.clip(floor + (0.2 - floor) / p.mean() * p, 0, 0.95)
    ring = [i for i in range(784)
            if i // 28 in (0, 27) or i % 28 in (0, 27)]
    p[:, ring[:MNIST_BORDER]] = 0.0
    u = rng.random((nrow, 784), dtype=np.float32)
    pixels = np.where(u < p, 1 + np.floor(254 * (1 - u / np.maximum(
        p, 1e-9))), 0).astype(np.uint8)
    return pixels, labels


def _mnist_frame(nrow: int, device):
    """The MNIST-shaped frame: pixel columns C1..C784 and the categorical
    ``label`` (levels "0".."9")."""
    from h2o_tpu_torch import Frame
    from h2o_tpu_torch.frame.vec import T_CAT, Vec

    pixels, labels = _mnist_cols(nrow)
    cols = np.ascontiguousarray(pixels.T).astype(np.float32)
    fr = Frame([f"C{j + 1}" for j in range(784)],
               [Vec.from_numpy(cols[j], device=device) for j in range(784)])
    fr.add("label", Vec.from_numpy(labels.astype(np.float32), type=T_CAT,
                                   domain=[str(i) for i in range(10)],
                                   device=device))
    return fr


def _dl_mnist(fr, **kw):
    """H2O-3's DeepLearning defaults (hidden [200, 200], Rectifier,
    ADADELTA rho 0.99, epsilon 1e-8) with the mini-batch lifted to 32, as
    the reference does, 1 epoch, seed 42."""
    from h2o_tpu_torch import DeepLearning, DeepLearningParameters

    args = dict(training_frame=fr, response_column="label",
                hidden=[200, 200], activation="Rectifier", epochs=1.0,
                mini_batch_size=32, seed=42)
    args.update(kw)
    return DeepLearning(DeepLearningParameters(**args)).train_model()


def _nets_equal(a, b) -> bool:
    """Weights, biases and optimizer slots bit-equal."""
    import torch

    same = all(torch.equal(la[n], lb[n]) for la, lb in zip(a.net, b.net)
               for n in ("W", "b"))
    return same and a.opt_state.keys() == b.opt_state.keys() and all(
        torch.equal(la[n], lb[n]) for k in a.opt_state
        for la, lb in zip(a.opt_state[k], b.opt_state[k]) for n in la)


def _reset_counts():
    from h2o_tpu_torch.backend.kernels import gram, hist

    gram.GRAM_LAUNCHES = hist.LAUNCHES = hist.GROUPED_LAUNCHES = 0


def _counts() -> dict:
    from h2o_tpu_torch.backend.kernels import gram, hist

    return dict(gram=gram.GRAM_LAUNCHES, flat=hist.LAUNCHES,
                grouped=hist.GROUPED_LAUNCHES)


def _profiled_steps(dev, fr, epochs) -> tuple[int, float, float]:
    """(device launches, device busy us, wall s) of one DL build of
    ``epochs`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _dl_mnist(fr, epochs=epochs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kern), sum(e.time_range.elapsed_us() for e in kern), wall


def phase_dl_mnist(dev, fr) -> dict:
    """The MLP at H2O-3's defaults on the MNIST-shaped frame, twice at one
    seed (bit-equal weights and slots), then the step's device launches and
    the device's idle share from two builds under ``torch.profiler`` whose
    difference is the steps alone."""
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m1 = _dl_mnist(fr)
    wall = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    m2 = _dl_mnist(fr)
    steps = fr.vec(0).plen // 32
    tm = m1.output.training_metrics
    lab = fr.vec("label").data[:fr.nrow]
    pred = m1.predict(fr).vec(0).data[:fr.nrow]
    err = float((pred != lab).float().mean())
    n_a, busy_a, wall_a = _profiled_steps(dev, fr, 0.05)
    n_b, busy_b, wall_b = _profiled_steps(dev, fr, 0.15)
    dsteps = int(0.15 * steps) - int(0.05 * steps)
    per_step = dict(launches=(n_b - n_a) / dsteps,
                    busy_us=(busy_b - busy_a) / dsteps,
                    wall_us_profiled=(wall_b - wall_a) * 1e6 / dsteps)
    per_step["idle_share_profiled"] = (
        1 - per_step["busy_us"] / per_step["wall_us_profiled"]
        if n_b > n_a else None)
    per_step["idle_share_unprofiled"] = (
        1 - per_step["busy_us"] / (wall * 1e6 / steps) if n_b > n_a
        else None)
    out = dict(rows=fr.nrow, features=len(m1.output.names),
               inputs=m1.net[0]["W"].shape[0], steps=steps, train_s=wall,
               steps_per_s=steps / wall, logloss=tm.logloss,
               mean_per_class_error=tm.mean_per_class_error,
               train_error=err, peak_mem_gb=peak, launches=counts,
               per_step=per_step,
               second_run_bit_equal=_nets_equal(m1, m2))
    print("dl_mnist", json.dumps(out), flush=True)
    _check(out["second_run_bit_equal"],
           "dl_mnist: two runs at one seed differ")
    _check(out["features"] == 717 and out["inputs"] == 717,
           f"dl_mnist: {out['features']} features, {out['inputs']} inputs")
    _check(bool(np.isfinite(tm.logloss)) and tm.logloss < np.log(10)
           and err < 0.5, f"dl_mnist: logloss {tm.logloss}, error {err}")
    _check(sum(counts.values()) == 0,
           f"dl_mnist: launches of kernels off its path: {counts}")
    return out


def phase_dl_mnist_autoencoder(dev, fr):
    """The autoencoder (Tanh, hidden [128, 64, 128], 1 epoch): the
    reconstruction MSE, the ``anomaly`` column's mean and the 64-wide
    ``deepfeatures(layer=1)`` code frame, which it returns."""
    import torch

    from h2o_tpu_torch import DeepLearning, DeepLearningParameters

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = DeepLearning(DeepLearningParameters(
        training_frame=fr, ignored_columns=["label"], autoencoder=True,
        activation="Tanh", hidden=[128, 64, 128], epochs=1.0,
        mini_batch_size=32, seed=42)).train_model()
    wall = time.perf_counter() - t0
    counts = _counts()
    anom = m.anomaly(fr).vec(0).data[:fr.nrow]
    codes = m.deepfeatures(fr, 1)
    X = m.adapt_frame(fr)[:fr.nrow]
    zero_mse = float((X * X).mean())     # predicting the standardized mean
    out = dict(rows=fr.nrow, train_s=wall,
               reconstruction_mse=m.output.training_metrics.mse,
               anomaly_mean=float(anom.mean()), zero_predictor_mse=zero_mse,
               deepfeatures=[codes.nrow, codes.ncol], launches=counts)
    print("dl_mnist_autoencoder", json.dumps(out), flush=True)
    _check(codes.ncol == 64 and codes.nrow == fr.nrow and all(
        bool(torch.isfinite(v.data[:fr.nrow]).all()) for v in codes.vecs),
        "dl_mnist_autoencoder: deep features")
    _check(bool(torch.isfinite(anom).all())
           and abs(out["anomaly_mean"] - out["reconstruction_mse"])
           <= 1e-4 * out["reconstruction_mse"]
           and out["reconstruction_mse"] < zero_mse,
           f"dl_mnist_autoencoder: mse {out['reconstruction_mse']}, "
           f"anomaly mean {out['anomaly_mean']}, zero predictor {zero_mse}")
    _check(sum(counts.values()) == 0,
           f"dl_mnist_autoencoder: launches off its path: {counts}")
    return codes


def _kmeans(fr, **kw):
    from h2o_tpu_torch import KMeans, KMeansParameters

    args = dict(training_frame=fr, k=10, init="Furthest", standardize=True,
                max_iterations=10, seed=42)
    args.update(kw)
    return KMeans(KMeansParameters(**args)).train_model()


def phase_kmeans_mnist(dev, codes, fr) -> dict:
    """KMeans k = 10 (Furthest, standardize, 10 iterations) on the
    autoencoder's 64 deep features and on the pixel columns."""
    import torch

    out = {}
    for what, frame, kw in (("deepfeatures", codes, {}),
                            ("pixels", fr, dict(ignored_columns=["label"]))):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = _kmeans(frame, **kw)
        wall = time.perf_counter() - t0
        tm = m.output.training_metrics
        out[what] = dict(features=len(m.output.names), train_s=wall,
                         iterations=m.output.num_iterations,
                         tot_withinss=tm.tot_withinss, totss=tm.totss,
                         sizes=tm.sizes.tolist(), launches=_counts())
        _check(bool(np.isfinite(tm.tot_withinss))
               and tm.tot_withinss < tm.totss
               and int(tm.sizes.sum()) == frame.nrow
               and np.isfinite(m.centers).all(),
               f"kmeans_mnist {what}: {out[what]}")
        _check(sum(out[what]["launches"].values()) == 0,
               f"kmeans_mnist {what}: launches off its path")
    print("kmeans_mnist", json.dumps(out), flush=True)
    _check(out["deepfeatures"]["features"] == 64
           and out["pixels"]["features"] == 717, "kmeans_mnist: widths")
    return out


def phase_pca_mnist(dev, fr) -> tuple[int, dict]:
    """PCA k = 50 (STANDARDIZE, GramSVD) and SVD nv = 50 on the pixel
    columns, one Gram launch each; Randomized PCA's wall beside GramSVD's;
    then, after the counted run, the Gram kernel against its plain
    version on the PCA's own design (z = None, the 0/1 row mask as W), and
    the card's float32 ``eigh`` of that Gram against its float64 one (the
    reason PCA's runs in float64). Returns the Gram launches and the
    kernel's numbers at this design."""
    import torch

    from h2o_tpu_torch import PCA, SVD, PCAParameters, SVDParameters
    from h2o_tpu_torch.backend.kernels import gram

    common = dict(training_frame=fr, ignored_columns=["label"],
                  transform="STANDARDIZE", seed=42)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pca = PCA(PCAParameters(k=50, pca_method="GramSVD", **common)
              ).train_model()
    pca_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svd = SVD(SVDParameters(nv=50, svd_method="GramSVD", **common)
              ).train_model()
    svd_s = time.perf_counter() - t0
    counts = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rnd = PCA(PCAParameters(k=50, pca_method="Randomized", **common)
              ).train_model()
    rnd_s = time.perf_counter() - t0
    vi = pca.output.variable_importances
    sdev, rsdev = vi["std_deviation"], rnd.output.variable_importances[
        "std_deviation"]
    # the kernel at this path's design: (X - mu) and the row mask
    X, ok = pca.dinfo.expand(fr)
    X = X - pca.mu
    W = ((torch.arange(X.shape[0], device=dev) < fr.nrow) & ok).to(
        torch.float32)
    shape = _gram_check(X.contiguous(), W, None, reps=5, f64=True)
    # why PCA's eigh runs in float64: the leading 50 eigenvalues of this
    # Gram from the card's float32 eigh, against its float64 eigh
    G, _ = gram._cuda_gram(X.contiguous(), W, None)
    e64 = torch.linalg.eigvalsh(G.double()).flip(0)[:50]
    e32 = torch.linalg.eigvalsh(G).flip(0)[:50].double()
    eigh_f32_rel = float(((e32 - e64).abs() / e64.abs()).max())
    del X, W, G
    torch.cuda.empty_cache()
    out = dict(rows=fr.nrow, P=len(pca.dinfo.expanded_names), pca_s=pca_s,
               svd_s=svd_s, randomized_s=rnd_s, launches=counts,
               sdev_top5=sdev[:5].tolist(), sdev_50=float(sdev[-1]),
               cumulative_50=float(vi["cumulative_proportion"][-1]),
               randomized_sdev_top5=rsdev[:5].tolist(),
               eigh_f32_rel=eigh_f32_rel, gram_at_path=shape)
    print("pca_mnist", json.dumps(out), flush=True)
    _check(out["P"] == 717, f"pca_mnist: P = {out['P']}")
    _check(counts["gram"] == 2 and counts["flat"] + counts["grouped"] == 0,
           f"pca_mnist: launches {counts}, want 2 Gram (PCA and SVD)")
    _check(bool(np.isfinite(sdev).all()) and bool(np.all(np.diff(sdev) <= 0))
           and sdev[-1] > 0 and 0 < out["cumulative_50"] <= 1 + 1e-6,
           "pca_mnist: standard deviations")
    _check(np.allclose(svd.singular_values, pca.d.cpu().numpy(), rtol=1e-6),
           "pca_mnist: SVD's singular values differ from PCA's")
    _check(np.allclose(rsdev[:5], sdev[:5], rtol=1e-3),
           f"pca_mnist: Randomized {rsdev[:5]} vs GramSVD {sdev[:5]}")
    return counts["gram"], shape


def phase_recovery_dl(dev, fr) -> dict:
    """``dl_mnist``'s model at 3 epochs with ``auto_recovery_dir`` (a state
    write at every epoch), killed at ``train.dl.epoch:raise(preempt)@3``
    and resumed with ``resume_training``: weights and optimizer slots
    bit-equal to an uninterrupted 3-epoch run."""
    import shutil

    import torch

    from h2o_tpu_torch import resume_training
    from h2o_tpu_torch.backend import persist
    from h2o_tpu_torch.utils import failpoints

    rdir = os.path.join(DATA_DIR, "recovery_dl")
    shutil.rmtree(rdir, ignore_errors=True)
    old = os.environ.get("H2O_TORCH_CHECKPOINT_SECS")
    os.environ["H2O_TORCH_CHECKPOINT_SECS"] = "0"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base = _dl_mnist(fr, epochs=3.0)
        base_s = time.perf_counter() - t0
        failpoints.arm("train.dl.epoch", "raise(preempt)@3")
        t0 = time.perf_counter()
        with _Walls(persist, "save_frame", dev) as frame_saves, \
                _Walls(persist.TrainingRecovery, "save_state",
                       dev) as writes:
            try:
                _dl_mnist(fr, epochs=3.0, auto_recovery_dir=rdir)
                _check(False, "recovery_dl: the kill did not fire")
            except failpoints.InjectedPreemption:
                pass
            killed_s = time.perf_counter() - t0
            failpoints.reset()
            killed_writes = len(writes.s)
            t0 = time.perf_counter()
            res = resume_training(rdir, device=dev)
            resume_s = time.perf_counter() - t0
        manifest = persist.Recovery(rdir).read()
    finally:
        failpoints.reset()
        shutil.rmtree(rdir, ignore_errors=True)
        if old is None:
            os.environ.pop("H2O_TORCH_CHECKPOINT_SECS", None)
        else:
            os.environ["H2O_TORCH_CHECKPOINT_SECS"] = old
    out = dict(rows=fr.nrow, epochs=3, killed_before_epoch=3,
               uninterrupted_s=base_s, killed_run_s=killed_s,
               resume_s=resume_s, frame_save_s=frame_saves.s,
               state_writes=len(writes.s),
               state_writes_killed_run=killed_writes, write_s=sum(writes.s),
               completed=manifest["completed"],
               epochs_trained=res.epochs_trained)
    print("recovery_dl", json.dumps(out), flush=True)
    _check(_nets_equal(res, base),
           "recovery_dl: resumed weights or slots differ")
    _check(manifest["completed"] and killed_writes == 2
           and len(writes.s) == 3 and res.epochs_trained == 3.0,
           f"recovery_dl: {len(writes.s)} state writes ({killed_writes} "
           f"before the kill), manifest {manifest}")
    return out


def phase_unsupervised_card_vs_cpu(dev) -> None:
    """MNIST_CPU_ROWS rows of the generator on the card and on the CPU: the
    DL (hidden [32, 32], 2 epochs) weights within 1e-4; KMeans
    assignments agreeing on >= 99.9% of rows with ``tot_withinss`` within
    1e-5 relative; PCA (k = 10, STANDARDIZE) standard deviations within
    1e-5 relative and vectors equal up to sign where the eigenvalues are
    separated (|cos| >= 1 - 1e-5 for gaps above 1e-3 relative)."""
    import torch

    from h2o_tpu_torch import PCA, PCAParameters

    frs = {d: _mnist_frame(MNIST_CPU_ROWS, d) for d in (dev, "cpu")}
    dl = {d: _dl_mnist(f, hidden=[32, 32], epochs=2.0)
          for d, f in frs.items()}
    w_err = max(float((a[n].cpu() - b[n]).abs().max())
                for a, b in zip(dl[dev].net, dl["cpu"].net)
                for n in ("W", "b"))
    km = {d: _kmeans(f, ignored_columns=["label"]) for d, f in frs.items()}
    a_card = km[dev].predict(frs[dev]).vec(0).data[:MNIST_CPU_ROWS].cpu()
    a_cpu = km["cpu"].predict(frs["cpu"]).vec(0).data[:MNIST_CPU_ROWS]
    agree = float((a_card == a_cpu).float().mean())
    tw = [km[d].output.training_metrics.tot_withinss for d in (dev, "cpu")]
    pca = {d: PCA(PCAParameters(training_frame=f, ignored_columns=["label"],
                                k=10, transform="STANDARDIZE")).train_model()
           for d, f in frs.items()}
    s_card = pca[dev].output.variable_importances["std_deviation"]
    s_cpu = pca["cpu"].output.variable_importances["std_deviation"]
    sd_rel = float(np.max(np.abs(s_card - s_cpu) / s_cpu))
    Vc, Vh = pca[dev].V.cpu().numpy(), pca["cpu"].V.numpy()
    cos = np.abs((Vc * Vh).sum(0)) / np.linalg.norm(Vc, axis=0) \
        / np.linalg.norm(Vh, axis=0)
    ev = s_cpu ** 2
    gaps = np.minimum(np.r_[np.inf, -np.diff(ev)], np.r_[-np.diff(ev), ev[-1]])
    separated = gaps / ev > 1e-3
    out = dict(rows=MNIST_CPU_ROWS, dl_max_weight_err=w_err,
               kmeans_agreement=agree, kmeans_tot_withinss=tw,
               pca_sdev_rel=sd_rel, pca_min_cos_separated=float(
                   cos[separated].min()) if separated.any() else None,
               pca_separated=int(separated.sum()))
    print("unsupervised_card_vs_cpu", json.dumps(out), flush=True)
    _check(w_err <= 1e-4, f"unsupervised_card_vs_cpu: DL weights off by "
                          f"{w_err}")
    _check(agree >= 0.999 and abs(tw[0] - tw[1]) <= 1e-5 * abs(tw[1]),
           f"unsupervised_card_vs_cpu: KMeans agreement {agree}, "
           f"tot_withinss {tw}")
    _check(sd_rel <= 1e-5 and separated.any()
           and cos[separated].min() >= 1 - 1e-5,
           f"unsupervised_card_vs_cpu: PCA sdev {sd_rel}, cos {cos}")
    del frs, dl, km, pca
    torch.cuda.empty_cache()




# ---------------------------------------------------------------------------
# model search (grid, stacked ensembles, AutoML, the multinomial GLM)
# ---------------------------------------------------------------------------
class _FlatLevels:
    """While open, every launch of the flat wrapper records its level
    width under the current ``label``; for the labels in ``keep`` the
    inputs of the last launch at each width of at least ``keep_from`` are
    kept (the codes, node ids and channels that level really ran on), for
    holding the kernel against its plain version after the counted run.
    The launch itself, and its count, are the wrapper's own."""

    def __init__(self, keep=(), keep_from: int = 8192):
        self.keep, self.keep_from = set(keep), keep_from
        self.label = None
        self.deepest: dict = {}
        self.inputs: dict = {}

    def __enter__(self):
        from h2o_tpu_torch.backend.kernels import hist

        self.orig = orig = hist._cuda_flat

        def recorded(Xb, lc, vv, n_lv, nbins_tot):
            lb = self.label
            self.deepest[lb] = max(self.deepest.get(lb, 0), n_lv)
            if lb in self.keep and n_lv >= self.keep_from:
                self.inputs[(lb, n_lv)] = (Xb, lc, vv, nbins_tot)
            return orig(Xb, lc, vv, n_lv, nbins_tot)
        hist._cuda_flat = recorded
        return self

    def __exit__(self, *exc):
        from h2o_tpu_torch.backend.kernels import hist

        hist._cuda_flat = self.orig


def _timed_plan(plan, dev, levels, steps):
    """The plan with each step's ``make`` wrapped: its wall (synchronised
    with the card), its launches of each kernel and the models it made go
    to ``steps``; ``levels.label`` names the running step."""
    import torch

    from h2o_tpu_torch.models.automl import Step

    def wrap(step):
        label = f"{step.algo}_{step.id}"

        def make(aml):
            before = _counts()
            levels.label = label
            t0 = time.perf_counter()
            models = None
            try:
                models = step.make(aml)
                return models
            finally:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                after = _counts()
                steps.append(dict(
                    step=label, s=time.perf_counter() - t0,
                    launches={k: after[k] - before[k] for k in after},
                    models=[m.key for m in models or []]))
        return Step(step.algo, step.id, make, step.weight)
    return [wrap(s) for s in plan]


def _leaderboard_rows(aml, steps) -> list:
    made = {k: s["step"] for s in steps for k in s["models"]}
    lb = aml.leaderboard
    return [dict(model=m.key, step=made.get(m.key),
                 auc=lb._metric(m, "auc"), logloss=lb._metric(m, "logloss"))
            for m in lb.models]


def phase_automl_higgs(dev) -> tuple[dict, dict]:
    """``H2OAutoML(max_models=13, nfolds=AUTOML_FOLDS, seed=42,
    exclude_algos=["DeepLearning"])`` on AUTOML_ROWS HIGGS-shaped rows at
    the full 28 features: every step of the default plan but DeepLearning
    (3 XGBoost, the lambda-search GLM, DRF, GBM def_1..def_5, XRT, a 2-model
    GBM grid) and both stacked ensembles. Prints each step's wall and
    launches, the deepest level width each met, peak memory and the
    leaderboard; requires finite AUCs above 0.6, sorted, 13 base models and
    2 ensembles, every base-model step through the flat kernel and the GLM
    and ensembles through the Gram; the leader predicts, and partial
    dependence on two columns and permutation importance are timed. After
    the counted run the flat kernel is held against its plain version on
    GBM def_5's own codes, node ids and channels at each of its levels of
    8,192 nodes or more. Returns the launches by kernel and the deep
    levels' numbers."""
    import torch

    from h2o_tpu_torch import (H2OAutoML, partial_dependence,
                               permutation_varimp)
    from h2o_tpu_torch.backend.kernels import hist
    from h2o_tpu_torch.models import automl

    fr = _higgs_frame(AUTOML_ROWS, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _FlatLevels(keep=("GBM_def_5",)) as levels:
        aml = H2OAutoML(max_models=13, nfolds=AUTOML_FOLDS, seed=42,
                        exclude_algos=["DeepLearning"],
                        modeling_plan=_timed_plan(automl._default_plan(),
                                                  dev, levels, steps))
        aml.train(y="response", training_frame=fr)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = _counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    for s in steps:
        s["deepest_n_lv"] = levels.deepest.get(s["step"])
    rows = _leaderboard_rows(aml, steps)
    t0 = time.perf_counter()
    pred = aml.predict(fr)
    p1 = pred.vec(2).data[:fr.nrow]
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pdp = partial_dependence(aml.leader, fr, cols=["f0", "f3"])
    pdp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pvi = permutation_varimp(aml.leader, fr, seed=42)
    pvi_s = time.perf_counter() - t0
    warns = [e["message"] for e in aml.event_log.events
             if e["level"] == "Warn"]
    # the kernel at def_5's deep levels, and at the deepest the run met,
    # on the inputs those levels ran on
    deep = {}
    deepest = max(levels.deepest.values(), default=0)
    for (lb, n_lv), (Xb, lc, vv, B) in sorted(levels.inputs.items(),
                                                key=lambda kv: kv[0][1]):
        plan = ((tuple(range(Xb.shape[1])), B, "onehot"),)
        row = _grouped_level(dev, Xb, lc, vv, plan, n_lv, B, 5, flat=True)
        row["step"] = lb
        print("level_hist_automl", json.dumps(row), flush=True)
        deep[n_lv] = row
    levels.inputs.clear()
    torch.cuda.empty_cache()
    out = dict(rows=fr.nrow, train_s=train_s, steps=steps, launches=launches,
               peak_mem_gb=peak, leaderboard=rows, leader=aml.leader.key,
               predict_s=predict_s, pdp_s=pdp_s, varimp_s=pvi_s,
               pdp_rows=[len(t.cell_values) for t in pdp],
               varimp_top=[r[0] for r in pvi.cell_values[:3]],
               deepest_n_lv=deepest, warnings=warns,
               deep_levels={str(k): {c: v[c] for c in (
                   "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err",
                   "max_rel_mass", "clusters", "cluster")
                   if c in v} for k, v in deep.items()})
    print("automl_higgs", json.dumps(out), flush=True)
    aucs = [r["auc"] for r in rows]
    base = [r for r in rows if not r["model"].startswith("stackedensemble")]
    _check(not warns, f"automl_higgs: steps failed: {warns}")
    _check(len(base) == 13 and len(rows) == 15,
           f"automl_higgs: {len(base)} base models, {len(rows)} in all")
    _check(all(a is not None and np.isfinite(a) and a > 0.6 for a in aucs),
           f"automl_higgs: leaderboard AUCs {aucs}")
    _check(aucs == sorted(aucs, reverse=True),
           f"automl_higgs: leaderboard not sorted by AUC: {aucs}")
    for s in steps:
        if s["step"].startswith("StackedEnsemble"):
            _check(s["launches"]["gram"] > 0 and s["launches"]["flat"] == 0,
                   f"automl_higgs: {s['step']} launches {s['launches']}")
        elif s["step"].startswith("GLM"):
            _check(s["launches"]["gram"] > 0 and s["launches"]["flat"] == 0,
                   f"automl_higgs: {s['step']} launches {s['launches']}")
        else:
            _check(s["launches"]["flat"] > 0 and s["launches"]["gram"] == 0
                   and s["launches"]["grouped"] == 0,
                   f"automl_higgs: {s['step']} launches {s['launches']}")
    _check(launches["grouped"] == 0, "automl_higgs: grouped launches")
    _check(bool(torch.isfinite(p1).all()), "automl_higgs: leader predictions")
    _check(levels.deepest.get("GBM_def_5") == 2 ** 14 and 2 ** 14 in deep
           and 2 ** 13 in deep,
           f"automl_higgs: GBM def_5's deepest level "
           f"{levels.deepest.get('GBM_def_5')}, checked {sorted(deep)}")
    del aml, fr, pred, p1
    torch.cuda.empty_cache()
    return launches, deep


def _multinomial_glm(fr, **kw):
    """The multinomial GLM on the covertype-shaped frame at lambda 1e-4
    (alpha 0.5). Its 4 wilderness and 40 soil one-hots each sum to 1 in
    every row, so at the default lambda 0 the design is exactly collinear
    with the intercept and the unpenalised block solves diverge — in both
    packages (on 4,000 rows the reference's coefficients reach 9.1e6 and
    its training logloss 32.3; the port's 6.5e6 and 29.5). At 1e-4 both
    give logloss 0.14144 there."""
    from h2o_tpu_torch import GLM, GLMParameters

    return GLM(GLMParameters(training_frame=fr, response_column="Cover_Type",
                             family="multinomial", lambda_=1e-4, seed=42,
                             **kw)).train_model()


class _GramInputs:
    """While open, the GLM's Gram calls keep the inputs of the last one
    (a class block's design, IRLS weights and working response)."""

    def __enter__(self):
        from h2o_tpu_torch.models import glm

        self.orig, self.last = glm.gram_accumulate, None
        orig = self.orig

        def kept(X, W, z=None):
            self.last = (X, W, z)
            return orig(X, W, z)
        glm.gram_accumulate = kept
        return self

    def __exit__(self, *exc):
        from h2o_tpu_torch.models import glm

        glm.gram_accumulate = self.orig


def phase_glm_multinomial_covtype(dev, fr) -> tuple[int, dict]:
    """The multinomial GLM on the covertype-shaped frame (581,012 x 54, 7
    classes): per-class block IRLS, ``sweeps x 7 x 3`` Gram launches (6
    sweeps at the default max_iterations) and no histogram launch; the
    training mean per-class error below the prior's 6/7 and logloss below
    the prior's 1.205 nats; probabilities finite with rows summing to 1
    within 1e-5. After the counted run the Gram kernel is held against its
    plain version on the last class block's weighted design. Returns the
    launches and that check's numbers."""
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _GramInputs() as kept:
        model = _multinomial_glm(fr)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = _counts()
    sweeps = max(2, min(6, model.params.max_iterations // 5))
    m = model.output.training_metrics
    probs = _class_probs(model, fr)
    row_err = float((probs.sum(1) - 1).abs().max())
    X, W, z = kept.last
    shape = _gram_check(X, W, z, reps=5)
    del kept, X, W, z
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out = dict(rows=fr.nrow, P=len(model.dinfo.expanded_names) + 1,
               classes=7, sweeps=sweeps, train_s=train_s,
               launches=launches, logloss=m.logloss,
               mean_per_class_error=m.mean_per_class_error,
               row_sum_err=row_err, peak_mem_gb=peak, gram_at_block=shape)
    print("glm_multinomial_covtype", json.dumps(out), flush=True)
    _check(launches["gram"] == sweeps * 7 * 3 and launches["flat"] == 0
           and launches["grouped"] == 0,
           f"glm_multinomial_covtype: launches {launches}, want "
           f"{sweeps * 21} Gram")
    _check(np.isfinite(m.logloss) and m.logloss < 1.205,
           f"glm_multinomial_covtype: logloss {m.logloss}")
    _check(m.mean_per_class_error < 6 / 7,
           f"glm_multinomial_covtype: mean per-class error "
           f"{m.mean_per_class_error}")
    _check(bool(torch.isfinite(probs).all()) and row_err <= 1e-5,
           f"glm_multinomial_covtype: probabilities (row sums off by "
           f"{row_err})")
    del model, probs
    torch.cuda.empty_cache()
    return launches["gram"], shape


def phase_ensemble_covtype(dev, fr) -> dict:
    """A stacked ensemble on the covertype-shaped frame: 3-fold CV (Modulo,
    holdout predictions kept) bases — a multinomial GBM (10 trees, depth
    5), a DRF (10 trees) and the multinomial GLM (lambda 1e-4, as in
    ``_multinomial_glm``) — under the AUTO
    metalearner (a multinomial GLM over their 21 class columns). Requires
    class probabilities finite with rows summing to 1 within 1e-5, the
    ensemble's training logloss finite, flat launches for the trees and
    Gram launches for the GLMs. Returns the launches."""
    import torch

    from h2o_tpu_torch import (DRF, GBM, GLM, DRFParameters, GBMParameters,
                               GLMParameters, StackedEnsemble,
                               StackedEnsembleParameters)

    common = dict(training_frame=fr, response_column="Cover_Type", nfolds=3,
                  fold_assignment="Modulo", seed=42,
                  keep_cross_validation_predictions=True)
    _reset_counts()
    torch.cuda.synchronize()
    walls, t0 = {}, time.perf_counter()
    bases = []
    for name, builder in (
            ("gbm", lambda: GBM(GBMParameters(ntrees=10, max_depth=5,
                                              **common))),
            ("drf", lambda: DRF(DRFParameters(ntrees=10, **common))),
            ("glm", lambda: GLM(GLMParameters(family="multinomial",
                                              lambda_=1e-4, **common)))):
        t1 = time.perf_counter()
        bases.append(builder().train_model())
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t1
    before = _counts()
    t1 = time.perf_counter()
    se = StackedEnsemble(StackedEnsembleParameters(
        training_frame=fr, response_column="Cover_Type", base_models=bases,
        seed=42)).train_model()
    torch.cuda.synchronize()
    walls["ensemble"] = time.perf_counter() - t1
    train_s = time.perf_counter() - t0
    launches = _counts()
    meta_launches = {k: launches[k] - before[k] for k in launches}
    probs = _class_probs(se, fr)
    row_err = float((probs.sum(1) - 1).abs().max())
    m = se.output.training_metrics
    out = dict(rows=fr.nrow, train_s=train_s, walls=walls,
               launches=launches, metalearner_launches=meta_launches,
               level_one_cols=len(se.metalearner.output.names),
               cv_logloss={b.algo_name: b.output.cross_validation_metrics
                           .logloss for b in bases},
               logloss=m.logloss, mean_per_class_error=m.mean_per_class_error,
               row_sum_err=row_err)
    print("ensemble_covtype", json.dumps(out), flush=True)
    _check(len(se.metalearner.output.names) == 21,
           "ensemble_covtype: level-one columns")
    _check(bool(torch.isfinite(probs).all()) and row_err <= 1e-5,
           f"ensemble_covtype: probabilities (row sums off by {row_err})")
    _check(np.isfinite(m.logloss), f"ensemble_covtype: logloss {m.logloss}")
    _check(launches["flat"] + launches["grouped"] > 0
           and meta_launches["gram"] > 0
           and meta_launches["flat"] + meta_launches["grouped"] == 0,
           f"ensemble_covtype: launches {launches}, metalearner "
           f"{meta_launches}")
    del se, bases, probs
    torch.cuda.empty_cache()
    return launches


def phase_automl_card_vs_cpu(dev) -> dict:
    """AUTOML_CPU_ROWS HIGGS rows through ``automl.small_plan`` (10 trees
    at depth 4, XGBoost included, a DeepLearning of three 10-unit layers)
    with 3 folds on
    the card and on the CPU: the same steps, the same grid combos, every
    model's leaderboard metrics (auc, logloss, rmse) within 1e-4; every
    ensemble's metalearner coefficients within 1e-4 x max(1, |beta|) and
    its predictions within 1e-4 (with the largest difference of its
    level-one columns printed); the leaders' predictions within 1e-4; and
    the multinomial GLM on AUTOML_CPU_ROWS covertype rows: coefficients
    within 1e-4 x max(1, |beta|), logloss within 1e-5. Returns the card's
    launches."""
    import torch

    from h2o_tpu_torch import H2OAutoML
    from h2o_tpu_torch.models import automl

    runs, launches = [], None
    for d in (dev, "cpu"):
        fr = _higgs_frame(AUTOML_CPU_ROWS, d)
        if d is dev:
            _reset_counts()
        t0 = time.perf_counter()
        aml = H2OAutoML(max_models=7, nfolds=3, seed=42,
                        modeling_plan=automl.small_plan(
                            ntrees=10, max_depth=4, hidden=(10, 10, 10),
                            xgboost=True))
        aml.train(y="response", training_frame=fr)
        if d is dev:
            torch.cuda.synchronize()
            launches = _counts()
        runs.append((aml, fr, time.perf_counter() - t0))
    (ca, cfr, c_s), (ha, hfr, h_s) = runs

    cs, hs = automl.models_by_step(ca), automl.models_by_step(ha)
    _check([lb for lb, _ in cs] == [lb for lb, _ in hs] and len(cs) == 9,
           f"automl_card_vs_cpu: steps {[lb for lb, _ in cs]} vs "
           f"{[lb for lb, _ in hs]}")
    grid_params = [[(m.params.max_depth, m.params.learn_rate)
                    for lb, m in s if lb == "GBM_grid_1"] for s in (cs, hs)]
    _check(grid_params[0] == grid_params[1],
           f"automl_card_vs_cpu: grid combos {grid_params}")
    err = 0.0
    for (lb, cm), (_lb, hm) in zip(cs, hs):
        for name in ("auc", "logloss", "rmse"):
            a = ca.leaderboard._metric(cm, name)
            b = ha.leaderboard._metric(hm, name)
            err = max(err, abs(a - b))
    ens = {}
    for (lb, cm), (_lb, hm) in zip(cs, hs):
        if lb.startswith("StackedEnsemble"):
            cb, hb = cm.metalearner.beta, hm.metalearner.beta
            l1 = [m.metalearner.params.training_frame for m in (cm, hm)]
            ens[lb] = dict(
                level_one_err=max(float((a.data[:l1[1].nrow].cpu() - b.data[
                    :l1[1].nrow]).abs().max()) for a, b in zip(
                        l1[0].vecs[:-1], l1[1].vecs[:-1])),
                coef_rel=float(np.max(np.abs(cb - hb)
                                      / np.maximum(1.0, np.abs(hb)))),
                pred_err=float((cm.predict(cfr).vec(2).data[:cfr.nrow].cpu()
                                - hm.predict(hfr).vec(2).data[:hfr.nrow])
                               .abs().max()))
    pc = ca.predict(cfr).vec(2).data[:cfr.nrow].cpu()
    ph = ha.predict(hfr).vec(2).data[:hfr.nrow]
    pred_err = float((pc - ph).abs().max())
    mg = {d: _multinomial_glm(_covtype_frame(AUTOML_CPU_ROWS, d))
          for d in (dev, "cpu")}
    hb = np.asarray(mg["cpu"].beta)
    mg_coef = float(np.max(np.abs(mg[dev].beta - hb)
                           / np.maximum(1.0, np.abs(hb))))
    mg_ll = abs(mg[dev].output.training_metrics.logloss
                - mg["cpu"].output.training_metrics.logloss)
    out = dict(rows=AUTOML_CPU_ROWS, card_s=c_s, cpu_s=h_s,
               steps=[lb for lb, _ in cs], grid=grid_params[0],
               launches=launches, max_metric_err=err, ensembles=ens,
               leader=[ca.leader.key, ha.leader.key],
               leader_pred_err=pred_err, multinomial_coef_rel=mg_coef,
               multinomial_logloss_err=mg_ll)
    print("automl_card_vs_cpu", json.dumps(out), flush=True)
    _check(err <= 1e-4, f"automl_card_vs_cpu: metrics off by {err}")
    for lb, e in ens.items():
        _check(e["coef_rel"] <= 1e-4 and e["pred_err"] <= 1e-4,
               f"automl_card_vs_cpu: {lb}: coefficients off by "
               f"{e['coef_rel']}, predictions by {e['pred_err']}")
    _check(pred_err <= 1e-4,
           f"automl_card_vs_cpu: leader predictions off by {pred_err}")
    _check(mg_coef <= 1e-4 and mg_ll <= 1e-5,
           f"automl_card_vs_cpu: multinomial GLM coefficients {mg_coef}, "
           f"logloss {mg_ll}")
    del runs, ca, ha, cfr, hfr, mg
    torch.cuda.empty_cache()
    return launches


def phase_grid_recovery(dev) -> int:
    """A 4-combo random GBM grid on GRID_ROWS HIGGS rows with
    ``recovery_dir``, killed at its third manifest write (the
    ``persist.checkpoint`` failpoint, between the temp write and the
    rename: the second model's file is on disk, the manifest names one),
    resumed with ``GridSearch.resume``: the resumed grid's models equal the
    uninterrupted grid's, forests and predictions bit for bit, in the same
    walk order. Then the grid again with ``parallelism=2``, two builds at
    a time on the card from two threads: its models bit-equal to the
    sequential grid's, combo for combo, and its flat launches, counted
    under ``COUNT_LOCK`` from both threads, equal to the sequential
    grid's (the sum over its four models). Prints the walls. Returns the
    flat launches of the four runs and the resume."""
    import shutil

    import torch

    from h2o_tpu_torch import (GBM, GBMParameters, GridSearch,
                               SearchCriteria)
    from h2o_tpu_torch.utils import failpoints

    fr = _higgs_frame(GRID_ROWS, dev)
    params = GBMParameters(training_frame=fr, response_column="response",
                           ntrees=5, seed=42, sample_rate=0.8)
    hyper = {"max_depth": [4, 6], "learn_rate": [0.1, 0.2]}
    crit = dict(strategy="RandomDiscrete", seed=7)
    rdir = os.path.join(DATA_DIR, "grid_recovery")
    shutil.rmtree(rdir, ignore_errors=True)
    _reset_counts()
    t0 = time.perf_counter()
    full = GridSearch(GBM, params, hyper, SearchCriteria(**crit)).train()
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    seq_flat = _counts()["flat"]
    failpoints.arm("persist.checkpoint", "raise(preempt)@3")
    t0 = time.perf_counter()
    try:
        GridSearch(GBM, params, hyper, SearchCriteria(**crit),
                   recovery_dir=rdir).train()
        killed = False
    except failpoints.InjectedFault:
        killed = True
    finally:
        failpoints.reset()
    killed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gs = GridSearch.resume(rdir, device=dev)
    recovered = len(gs._recovered_models)
    resumed = gs.train()
    resume_s = time.perf_counter() - t0
    launches = _counts()
    _reset_counts()
    t0 = time.perf_counter()
    par = GridSearch(GBM, params, hyper, SearchCriteria(**crit),
                     parallelism=2).train()
    torch.cuda.synchronize()
    par_s = time.perf_counter() - t0
    par_flat = _counts()["flat"]

    def combo(m):
        return (m.params.max_depth, m.params.learn_rate)

    def equal(xs, ys):
        return [combo(m) for m in xs] == [combo(m) for m in ys] and all(
            _forests_bit_equal(a, b) and torch.equal(
                a.predict(fr).vec(2).data, b.predict(fr).vec(2).data)
            for a, b in zip(xs, ys))
    same = equal(full.models, resumed.models)
    par_same = equal(sorted(full.models, key=combo),
                     sorted(par.models, key=combo))
    out = dict(rows=GRID_ROWS, full_s=full_s, killed_s=killed_s,
               resume_s=resume_s, parallel_s=par_s, recovered=recovered,
               models=[combo(m) for m in resumed.models], launches=launches,
               bit_equal=same, sequential_flat=seq_flat,
               parallel_flat=par_flat, parallel_bit_equal=par_same)
    print("grid_recovery", json.dumps(out), flush=True)
    shutil.rmtree(rdir, ignore_errors=True)
    _check(killed and recovered == 1,
           f"grid_recovery: killed {killed}, {recovered} models recovered")
    _check(resumed.model_count == full.model_count == 4 and same,
           "grid_recovery: the resumed grid differs from the uninterrupted "
           "one")
    _check(par.model_count == 4 and par_same,
           "grid_recovery: the parallelism=2 grid differs from the "
           "sequential one")
    _check(par_flat == seq_flat > 0,
           f"grid_recovery: parallelism=2 made {par_flat} flat launches, "
           f"the sequential grid {seq_flat}")
    return launches["flat"] + par_flat


# -- the model surface (TreeSHAP, leaf assignments, staged predictions,
#    categorical encodings) ---------------------------------------------------
SHAP_SUB_ROWS = 1_000_000      # shap_higgs: rows of the leaf and staged checks
ONEHOT_ROWS = 1_000_000        # encoding_airlines: OneHotExplicit's rows
SURFACE_CPU_ROWS = 100_000     # model_surface_card_vs_cpu: rows per frame
ENCODINGS = ("EnumLimited", "SortByResponse", "Eigen", "OneHotExplicit")


def _margin64(model, X) -> "torch.Tensor":
    """f0 plus the summed leaf values in float64, from the leaf ids."""
    import torch

    nodes = model._leaf_nodes(X)
    val = model.forest["val"].double()
    f = torch.full((X.shape[0],), float(model.f0), dtype=torch.float64,
                   device=X.device)
    for t in range(val.shape[0]):
        f += val[t][nodes[:, t]]
    return f


def _frame_columns(fr) -> "torch.Tensor":
    import torch

    return torch.stack([v.data[:fr.nrow] for v in fr.vecs], dim=1)


def _heap_of_path(p: str) -> int:
    """An L/R path string -> its heap node."""
    node = 0
    for c in p:
        node = 2 * node + (2 if c == "R" else 1)
    return node


def phase_shap_higgs(dev, fr, model) -> dict:
    """TreeSHAP on the ``train`` phase's model over the 11M HIGGS rows: the
    node covers over the training rows, the contributions of every row
    (each row's sum against the float64 margin), then leaf assignments and
    staged predictions on the first 1M rows against ``predict``."""
    import torch

    from h2o_tpu_torch.backend.kernels import gram, hist

    torch.cuda.reset_peak_memory_stats(dev)
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    model.forest.pop("cover", None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model._ensure_covers()
    torch.cuda.synchronize()
    covers_s = time.perf_counter() - t0
    cover = model.forest["cover"].cpu().numpy().astype(np.float64)
    feat = model.forest["feat"].cpu().numpy()
    inner = np.argwhere(feat >= 0)
    kids = cover[inner[:, 0], 2 * inner[:, 1] + 1] + \
        cover[inner[:, 0], 2 * inner[:, 1] + 2]
    _check(bool((cover[:, 0] == fr.nrow).all()),
           f"shap_higgs: root covers {np.unique(cover[:, 0])}, want "
           f"{fr.nrow}")
    _check(np.array_equal(kids, cover[inner[:, 0], inner[:, 1]]),
           "shap_higgs: a node's cover is not its children's sum")
    t0 = time.perf_counter()
    phi = model.predict_contributions(fr)
    torch.cuda.synchronize()
    contrib_s = time.perf_counter() - t0
    contrib_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    _check(phi.ncol == HIGGS_F + 1 and phi.names[-1] == "BiasTerm",
           f"shap_higgs: contribution columns {phi.names}")
    X = model._rows(fr)
    margin = _margin64(model, X)
    total = torch.zeros_like(margin)
    for v in phi.vecs:
        total += v.data[:fr.nrow].double()
    sum_err = float((total - margin).abs().max())
    finite = bool(torch.isfinite(total).all())
    del phi, total, margin
    torch.cuda.empty_cache()
    sub = fr.take(np.arange(SHAP_SUB_ROWS))
    Xs = model._rows(sub)
    raw = model._raw_f(Xs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = model.predict_leaf_node_assignment(sub, type="Node_ID")
    torch.cuda.synchronize()
    ids_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = model.predict_leaf_node_assignment(sub)
    torch.cuda.synchronize()
    paths_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = model.staged_predict_proba(sub)
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    node = _frame_columns(ids).long()
    val = model.forest["val"].double()
    leaf_sum = float(model.f0) + sum(val[t][node[:, t]]
                                     for t in range(node.shape[1]))
    leaf_err = float((leaf_sum - raw.double()).abs().max())
    path_ok = all(
        torch.equal(torch.tensor([_heap_of_path(p) for p in v.domain],
                                 device=dev)[v.data[:sub.nrow].long()],
                    node[:, t])
        for t, v in enumerate(paths.vecs))
    p1 = model.predict(sub).vec("ps").data[:sub.nrow]
    last = staged.vecs[-1].data[:sub.nrow]
    staged_err = float((last - p1).abs().max())
    out = dict(rows=fr.nrow, trees=model.ntrees, covers_s=covers_s,
               contributions_s=contrib_s,
               contributions_rows_per_s=fr.nrow / contrib_s,
               contributions_peak_gb=contrib_peak,
               sum_vs_margin64_max_abs_err=sum_err, sub_rows=sub.nrow,
               leaf_ids_s=ids_s, leaf_paths_s=paths_s, staged_s=staged_s,
               leaf_sum_vs_margin_max_abs_err=leaf_err,
               staged_last_vs_p1_max_abs_err=staged_err,
               staged_columns=staged.ncol,
               kernel_launches=hist.LAUNCHES + hist.GROUPED_LAUNCHES
               + gram.GRAM_LAUNCHES,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    print("shap_higgs", json.dumps(out), flush=True)
    _check(finite and sum_err <= 1e-4,
           f"shap_higgs: contributions miss the float64 margin by {sum_err}")
    _check(leaf_err <= 1e-5, f"shap_higgs: leaf values over the node ids "
                             f"miss predict's margin by {leaf_err}")
    _check(path_ok, "shap_higgs: leaf paths do not name the leaf node ids")
    _check(staged.ncol == model.ntrees and staged_err <= 1e-6,
           f"shap_higgs: the last stage misses predict's p1 by {staged_err}")
    return out


class _FirstLevel:
    """Records the first level-histogram call's inputs (the root level of
    the first tree) while the context is open, and counts the calls."""

    def __enter__(self):
        from h2o_tpu_torch.backend.kernels import hist

        self.inputs, self.orig = None, hist.level_hist_blocks

        def rec(Xb, lc, vv, *, n_lv, nbins_tot, block, groups=None):
            if self.inputs is None:
                self.inputs = (Xb, lc.clone(), vv.clone(), nbins_tot, groups)
            return self.orig(Xb, lc, vv, n_lv=n_lv, nbins_tot=nbins_tot,
                             block=block, groups=groups)
        hist.level_hist_blocks = rec
        return self

    def __exit__(self, *exc):
        from h2o_tpu_torch.backend.kernels import hist

        hist.level_hist_blocks = self.orig


def _logloss_metric(y, raw, w):
    """A custom metric: the weighted binomial logloss, in numpy."""
    p = np.clip(raw[:, 2].astype(np.float64), 1e-15, 1 - 1e-15)
    ok = ~np.isnan(y)
    ll = -(y[ok] * np.log(p[ok]) + (1 - y[ok]) * np.log(1 - p[ok]))
    return "np_logloss", float(np.sum(w[ok] * ll) / np.sum(w[ok]))


def _encoded_gbm(fr, scheme: str, **kw):
    """``import_cv_gbm``'s GBM settings (10 trees, depth 5, 20 bins, 1024
    categorical bins, learn rate 0.1, seed 42) under ``scheme``."""
    from h2o_tpu_torch import GBM, GBMParameters

    return GBM(GBMParameters(
        training_frame=fr, response_column="IsDepDelayed", ntrees=10,
        max_depth=5, nbins=20, nbins_cats=1024, learn_rate=0.1, seed=42,
        categorical_encoding=scheme, **kw)).train_model()


def phase_encoding_airlines(dev, train, valid) -> dict:
    """The imported airlines train split under four categorical encodings:
    each model's launches, wall and width, the kernel against its plain
    version on that model's own first-level inputs, the encoding replayed
    on the validation split through ``predict`` (AUC finite, above 0.6), a
    saved and loaded model predicting bit for bit alike; the custom
    metric's value against its numpy recomputation."""
    import torch

    from h2o_tpu_torch import load_model
    from h2o_tpu_torch.backend.kernels import gram, hist
    from h2o_tpu_torch.models import metrics

    os.makedirs(DATA_DIR, exist_ok=True)
    out = {"launches": {"flat": 0, "grouped": 0}, "models": {},
           "levels": {}}
    yv = valid.vec("IsDepDelayed").data[:valid.nrow]
    for scheme in ENCODINGS:
        fr = (train.take(np.arange(ONEHOT_ROWS))
              if scheme == "OneHotExplicit" else train)
        kw = ({"custom_metric_func": _logloss_metric}
              if scheme == "EnumLimited" else {})
        torch.cuda.reset_peak_memory_stats(dev)
        hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _FirstLevel() as first:
            model = _encoded_gbm(fr, scheme, **kw)
        train_s = time.perf_counter() - t0
        flat, grouped = hist.LAUNCHES, hist.GROUPED_LAUNCHES
        _check(gram.GRAM_LAUNCHES == 0 and flat + grouped == 10 * 5,
               f"encoding_airlines {scheme}: {flat} flat, {grouped} grouped, "
               f"{gram.GRAM_LAUNCHES} Gram launches, want 50 histograms")
        out["launches"]["flat"] += flat
        out["launches"]["grouped"] += grouped
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        t0 = time.perf_counter()
        pred = model.predict(valid)
        p1 = pred.vec("pYES").data[:valid.nrow]
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        auc = metrics.make_binomial_metrics(yv, p1).auc
        path = os.path.join(DATA_DIR, f"enc_{scheme}.bin")
        try:
            back = load_model(model.save(path), device=dev)
        finally:
            if os.path.exists(path):
                os.remove(path)
        same = all(torch.equal(a.data, b.data) for a, b in
                   zip(pred.vecs, back.predict(valid).vecs))
        row = dict(rows=fr.nrow, P=len(model.output.names), train_s=train_s,
                   predict_s=predict_s, flat_launches=flat,
                   grouped_launches=grouped, valid_auc=auc,
                   train_auc=model.output.training_metrics.auc,
                   peak_mem_gb=peak,
                   plan="flat" if model.cfg.hist_groups is None
                   else "grouped")
        if kw:
            enc = model.params.training_frame
            ptr = model.predict(enc).vec("pYES").to_numpy().astype(
                np.float64)
            y = enc.vec("IsDepDelayed").to_numpy()
            ok = ~np.isnan(y)
            p = np.clip(ptr, 1e-15, 1 - 1e-15)
            want = float(-np.mean(y[ok] * np.log(p[ok])
                                  + (1 - y[ok]) * np.log(1 - p[ok])))
            got = model.output.training_metrics.custom_metric_value
            row.update(custom_metric=got, custom_metric_err=abs(got - want))
            _check(abs(got - want) <= 1e-6,
                   f"encoding_airlines: custom metric {got} against numpy's "
                   f"{want}")
        print("encoding_airlines", scheme, json.dumps(row), flush=True)
        _check(bool(np.isfinite(auc)) and auc > 0.6,
               f"encoding_airlines {scheme}: validation AUC {auc}")
        _check(same, f"encoding_airlines {scheme}: the loaded model predicts "
                     f"differently")
        # after the counted run: the kernel on this model's root level
        Xb, lc, vv, B, groups = first.inputs
        is_flat = groups is None
        plan = (((tuple(range(Xb.shape[1])), B, "onehot"),) if is_flat
                else groups)
        lvl = _grouped_level(dev, Xb, lc, vv, plan, 1, B, 5, flat=is_flat)
        lvl["wrapper"] = "flat" if is_flat else "grouped"
        print("level_hist_encoding", scheme, json.dumps(lvl), flush=True)
        out["models"][scheme] = row
        out["levels"][scheme] = lvl
        del model, back, pred, first, Xb, lc, vv
        torch.cuda.empty_cache()
    return out


def _cpu_frame(fr):
    """The same frame on the CPU, column for column."""
    from h2o_tpu_torch import Frame
    from h2o_tpu_torch.frame.vec import Vec

    return Frame(list(fr.names), [Vec(v.data.cpu(), v.nrow, type=v.type,
                                      domain=v.domain) for v in fr.vecs])


def phase_model_surface_card_vs_cpu(dev, air) -> dict:
    """The model surface on the card and on the CPU: 100,000 HIGGS rows
    (covers, leaf ids and paths, contributions, staged predictions of one
    GBM) and 100,000 rows of the airlines split (each encoding's columns;
    GBMs on three encoded frames); a grid with an L_BFGS combo raises on
    the card too. Returns the card's histogram launches."""
    import torch

    from h2o_tpu_torch import GLM, GLMParameters, GridSearch
    from h2o_tpu_torch.backend.kernels import hist
    from h2o_tpu_torch.utils import linalg

    hist.LAUNCHES = hist.GROUPED_LAUNCHES = 0
    out = {}
    frames = {d: _higgs_frame(SURFACE_CPU_ROWS, d) for d in (dev, "cpu")}
    got = {}
    for d, fr in frames.items():
        m = _gbm(fr, ntrees=10)
        m._ensure_covers()
        got[d] = dict(
            model=m, cover=m.forest["cover"].cpu(),
            ids=_frame_columns(m.predict_leaf_node_assignment(
                fr, type="Node_ID")).cpu(),
            paths=[(v.domain, v.data[:fr.nrow].cpu())
                   for v in m.predict_leaf_node_assignment(fr).vecs],
            phi=_frame_columns(m.predict_contributions(fr)).cpu(),
            staged=_frame_columns(m.staged_predict_proba(fr)).cpu())
    a, b = got[dev], got["cpu"]
    _same_forest(a["model"], b["model"], "model surface HIGGS")
    _check(torch.equal(a["cover"], b["cover"]),
           "model surface: covers differ between card and CPU")
    _check(torch.equal(a["ids"], b["ids"]),
           "model surface: leaf node ids differ between card and CPU")
    _check(all(da == db and torch.equal(ca, cb) for (da, ca), (db, cb)
               in zip(a["paths"], b["paths"])),
           "model surface: leaf paths differ between card and CPU")
    phi_err = float((a["phi"] - b["phi"]).abs().max())
    staged_err = float((a["staged"] - b["staged"]).abs().max())
    _check(phi_err <= CPU_TOL, f"model surface: contributions off by "
                               f"{phi_err}")
    _check(staged_err <= 1e-6, f"model surface: staged predictions off by "
                               f"{staged_err}")
    out["higgs"] = dict(rows=SURFACE_CPU_ROWS, phi_max_abs_err=phi_err,
                        staged_max_abs_err=staged_err)
    del got, frames
    airs = {dev: air, "cpu": _cpu_frame(air)}
    for scheme in ENCODINGS:
        encs = {}
        for d, fr in airs.items():
            state = linalg.build_encoding_state(
                fr, scheme, skip=["IsDepDelayed"], response="IsDepDelayed")
            encs[d] = (state, linalg.apply_encoding_state(fr, state))
        (sa, ea), (sb, eb) = encs[dev], encs["cpu"]
        _check(repr(sa) == repr(sb),
               f"model surface {scheme}: frozen states differ")
        _check(ea.names == eb.names and all(
            va.type == vb.type and va.domain == vb.domain and torch.equal(
                va.data.cpu().view(torch.int32), vb.data.view(torch.int32))
            for va, vb in zip(ea.vecs, eb.vecs)),
            f"model surface {scheme}: encoded columns differ")
        row = dict(columns=ea.ncol)
        if scheme != "OneHotExplicit":   # ~700 columns: minutes on the CPU
            ma, mb = (_encoded_gbm(airs[d], scheme) for d in (dev, "cpu"))
            row.update(_same_forest(ma, mb, f"model surface {scheme}",
                                    keys=("feat", "nanL", "catd")))
        out[scheme] = row
    with_lbfgs = GridSearch(
        GLM, GLMParameters(training_frame=airs[dev],
                           response_column="IsDepDelayed",
                           family="binomial", seed=42),
        {"solver": ["IRLSM", "L_BFGS"]})
    try:
        with_lbfgs.train()
        raised = ""
    except NotImplementedError as e:
        raised = str(e)
    _check("ROADMAP Queue 1 item 8" in raised,
           f"model surface: the L_BFGS grid did not refuse ({raised!r})")
    out["grid_refusal"] = raised
    out["launches"] = dict(flat=hist.LAUNCHES, grouped=hist.GROUPED_LAUNCHES)
    print("model_surface_card_vs_cpu", json.dumps(out), flush=True)
    # the card's four GBMs (HIGGS and three encodings), 10 trees x 5 levels
    _check(hist.LAUNCHES + hist.GROUPED_LAUNCHES == 4 * 50,
           f"model surface: {out['launches']} histogram launches on the "
           f"card, want 200")
    return out["launches"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from h2o_tpu_torch.backend import kernels

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s", flush=True)
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "smem" in line:
            print("ptxas", line.strip(), flush=True)
    # the parser's host tokenizer, built before its parse is timed
    from h2o_tpu_torch.io import parser
    t0 = time.perf_counter()
    parser._csv_library()
    print(f"csv tokenizer build: {time.perf_counter() - t0:.3f} s",
          flush=True)

    from h2o_tpu_torch import STORE

    phases = {}

    def run(name, fn):
        t0 = time.perf_counter()
        out = fn(dev)
        phases[name] = time.perf_counter() - t0
        # h2o.remove_all() between phases: what a phase keeps, it returns
        STORE.clear()
        return out

    t0 = time.perf_counter()
    higgs = _higgs_frame(HIGGS_ROWS, dev)
    print(f"higgs frame {HIGGS_ROWS}x{HIGGS_F}: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    flat = run("level_hist", phase_kernel)
    launches, higgs_model = run("train", lambda d: phase_train(d, higgs))
    ckpt_launches = run("checkpoint_higgs", lambda d: phase_checkpoint_higgs(
        d, higgs, higgs_model))
    run("shap_higgs", lambda d: phase_shap_higgs(d, higgs, higgs_model))
    del higgs_model
    xgb_launches = run("xgboost_train",
                       lambda d: phase_xgboost_train(d, higgs))
    run("card_vs_cpu", phase_card_vs_cpu)
    grouped = run("level_hist_grouped", phase_grouped_kernel)
    grouped_launches = run("airlines_train", phase_airlines_train)
    run("airlines_card_vs_cpu", phase_airlines_card_vs_cpu)
    gram_nums = run("gram", phase_gram)
    gram_launches = run("glm_train", lambda d: _glm_train(d, higgs,
                                                          "glm_train"))
    run("glm_cod_train", lambda d: _glm_train(
        d, higgs, "glm_cod_train", solver="COORDINATE_DESCENT"))
    del higgs
    run("glm_card_vs_cpu", phase_glm_card_vs_cpu)
    run("gbm_options_card_vs_cpu", phase_gbm_options_card_vs_cpu)
    gblinear_launches = run("xgboost_card_vs_cpu", phase_xgboost_card_vs_cpu)
    t0 = time.perf_counter()
    cov = _covtype_frame(COVTYPE_ROWS, dev)
    print(f"covtype frame {COVTYPE_ROWS}x54: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    covtype = run("level_hist_covtype", lambda d: phase_covtype_kernel(d, cov))
    drf_launches = run("drf_train", lambda d: phase_drf_train(
        d, cov, 50, False, "drf_train", covtype["wrapper"]))
    xrt_launches = run("xrt_train", lambda d: phase_drf_train(
        d, cov, 10, True, "xrt_train", covtype["wrapper"]))
    rec_launches = run("recovery_drf", lambda d: phase_recovery_drf(
        d, cov, covtype["wrapper"]))
    del cov
    run("drf_card_vs_cpu", phase_drf_card_vs_cpu)
    run("recovery_card_vs_cpu", phase_recovery_card_vs_cpu)
    from h2o_tpu_torch import split_frame

    imported, _parse = run("import_csv", phase_import_csv)
    cmp_launches = run("compress_airlines",
                       lambda d: phase_compress_airlines(d, imported))
    train, valid, calib = split_frame(imported, ratios=[0.7, 0.15], seed=42)
    del imported
    cv_gbm_launches, hist_at_path = run(
        "import_cv_gbm", lambda d: phase_import_cv_gbm(d, train, valid,
                                                       calib))
    cv_glm_launches, gram_at_path = run(
        "import_cv_glm", lambda d: phase_import_cv_glm(d, train, valid))
    enc = run("encoding_airlines",
              lambda d: phase_encoding_airlines(d, train, valid))
    air = train.take(np.arange(SURFACE_CPU_ROWS))
    del train, valid, calib
    surface_launches = run("model_surface_card_vs_cpu",
                           lambda d: phase_model_surface_card_vs_cpu(d, air))
    del air
    run("import_cv_card_vs_cpu", phase_import_cv_card_vs_cpu)
    t0 = time.perf_counter()
    mnist = _mnist_frame(MNIST_ROWS, dev)
    print(f"mnist frame {MNIST_ROWS}x785: {time.perf_counter() - t0:.3f} s",
          flush=True)
    run("dl_mnist", lambda d: phase_dl_mnist(d, mnist))
    codes = run("dl_mnist_autoencoder",
                lambda d: phase_dl_mnist_autoencoder(d, mnist))
    run("kmeans_mnist", lambda d: phase_kmeans_mnist(d, codes, mnist))
    del codes
    pca_launches, gram_at_pca = run("pca_mnist",
                                    lambda d: phase_pca_mnist(d, mnist))
    run("recovery_dl", lambda d: phase_recovery_dl(d, mnist))
    del mnist
    run("unsupervised_card_vs_cpu", phase_unsupervised_card_vs_cpu)
    automl_launches, deep_levels = run("automl_higgs", phase_automl_higgs)
    t0 = time.perf_counter()
    cov = _covtype_frame(COVTYPE_ROWS, dev)
    print(f"covtype frame {COVTYPE_ROWS}x54: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    mglm_launches, gram_at_block = run(
        "glm_multinomial_covtype",
        lambda d: phase_glm_multinomial_covtype(d, cov))
    ens_launches = run("ensemble_covtype",
                       lambda d: phase_ensemble_covtype(d, cov))
    del cov
    cvc_launches = run("automl_card_vs_cpu", phase_automl_card_vs_cpu)
    grid_launches = run("grid_recovery", phase_grid_recovery)
    print("phase_s", json.dumps(phases), flush=True)
    # the covertype path's numbers join the entry of the wrapper its plan
    # picks: its launches, and its three levels' sums
    levels = covtype["per_level"]
    cov_nums = dict(
        n_lv=[r["n_lv"] for r in levels],
        launches_by_path=dict(drf_train=drf_launches, xrt_train=xrt_launches,
                              recovery_drf=rec_launches),
        max_abs_err=max(r["max_abs_err"] for r in levels),
        **{k: sum(r[k] for r in levels)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        per_level_ms=[r["ms"] for r in levels], bound_by="bytes")
    paths = {"level_hist": dict(train=launches, xgboost_train=xgb_launches,
                                checkpoint_higgs=ckpt_launches,
                                automl_higgs=automl_launches["flat"],
                                ensemble_covtype=ens_launches["flat"],
                                automl_card_vs_cpu=cvc_launches["flat"],
                                grid_recovery=grid_launches),
             "level_hist_grouped": dict(airlines_train=grouped_launches,
                                        import_cv_gbm=cv_gbm_launches,
                                        compress_airlines=cmp_launches),
             "gram": dict(glm_train=gram_launches,
                          xgboost_gblinear=gblinear_launches,
                          import_cv_glm=cv_glm_launches,
                          pca_mnist=pca_launches,
                          automl_higgs=automl_launches["gram"],
                          glm_multinomial_covtype=mglm_launches,
                          ensemble_covtype=ens_launches["gram"],
                          automl_card_vs_cpu=cvc_launches["gram"])}
    for path, counts in (("encoding_airlines", enc["launches"]),
                         ("model_surface_card_vs_cpu", surface_launches)):
        paths["level_hist"][path] = counts["flat"]
        paths["level_hist_grouped"][path] = counts["grouped"]
    if ens_launches["grouped"]:
        paths["level_hist_grouped"]["ensemble_covtype"] = \
            ens_launches["grouped"]
    cov_entry = ("level_hist" if covtype["wrapper"] == "flat"
                 else "level_hist_grouped")
    paths[cov_entry].update(cov_nums["launches_by_path"])
    hist_src = "h2o_tpu_torch/csrc/level_hist.cu"
    entries = []
    for name, src, replaces, nums in (
            ("level_hist", hist_src, "h2o_tpu/backend/kernels/hist.py:158",
             flat),
            ("level_hist_grouped", hist_src,
             "h2o_tpu/backend/kernels/hist.py:181", grouped),
            ("gram", "h2o_tpu_torch/csrc/gram.cu",
             "h2o_tpu/backend/kernels/gram.py:79", gram_nums)):
        e = dict(name=name, route="cuda", source=src, replaces=replaces,
                 launches=sum(paths[name].values()),
                 launches_by_path=paths[name],
                 max_abs_err=nums["max_abs_err"], ms=nums["ms"],
                 plain_ms=nums["plain_ms"], bound_ms=nums["bound_ms"],
                 bound_by=nums.get("bound_by", "bytes"),
                 library_ms=nums["library_ms"])
        if name == cov_entry:
            e["covtype"] = cov_nums
        # each encoded airlines model's root level, under the wrapper its
        # plan took
        wrapper = "flat" if name == "level_hist" else "grouped"
        at_enc = {k: r for k, r in enc["levels"].items()
                  if r["wrapper"] == wrapper and name != "gram"}
        if at_enc:
            e["encoding_airlines_levels"] = at_enc
            e["max_abs_err"] = max([e["max_abs_err"]] + [
                r["max_abs_err"] for r in at_enc.values()])
        if name == "level_hist":
            e["higgs_depth6"] = flat["depth6"]
            # GBM def_5's levels of 8,192 nodes and more, on its own
            # inputs (automl_higgs)
            e["automl_deep_levels"] = deep_levels
            e["max_abs_err"] = max([e["max_abs_err"]] + [
                r["max_abs_err"] for r in deep_levels.values()])
        if name == "level_hist_grouped":
            e["import_cv_gbm_levels"] = hist_at_path
            e["max_abs_err"] = max(e["max_abs_err"],
                                   hist_at_path["max_abs_err"])
        if name == "gram":
            e["import_cv_glm_shape"] = gram_at_path
            e["pca_mnist_shape"] = {k: gram_at_pca[k] for k in (
                "rows", "cols", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err")}
            e["multinomial_block_shape"] = {k: gram_at_block[k] for k in (
                "rows", "cols", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err")}
            e["max_abs_err"] = max(e["max_abs_err"],
                                   gram_at_path["max_abs_err"],
                                   gram_at_pca["max_abs_err"],
                                   gram_at_block["max_abs_err"])
        entries.append(e)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
