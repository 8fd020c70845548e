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
multinomial GLM, stacked ensembles, grid recovery); the model surface
of the tree models (TreeSHAP, node covers, leaf assignments, staged
predictions, categorical encodings, custom metrics); and the rest of GLM
(p-values, L_BFGS, box and linear constraints, alpha lists, ``ml``
dispersion, interactions, HGLM, the ordinal family) with ANOVA GLM and
ModelSelection over it; and the Gram's other users (GAM with all four
spline bases, RuleFit over a streamed rule design, CoxPH); and models
out, data in (MOJO and POJO export, the standalone MOJO scorer and
Generic models; SVMLight, ARFF and XLSX import); and the tree engine's
other families (Uplift DRF at four histogram channels, DT on ``Exact``
bins, both isolation forests, AdaBoost, Naive Bayes, quantiles, isotonic
regression, the infogram, the target encoder and segment models); and
the frame algebra (group-by, sort and both merge paths, the Rapids
evaluator and its model primitives) on the imported airlines frame. In
order:

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
3. ``card_vs_cpu``: the same GBM on 250,000 rows x 5 trees
   (``CARD_CPU_ROWS``, cut from 1M) on the card and on the CPU: equal
   forest structure (split features, NA directions, split bins), leaf
   values and predictions within 1e-5;
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
8b. ``mojo_export``: ``train``'s GBM and ``glm_train``'s GLM exported as
    MOJOs and POJOs, each MOJO loaded by the port's standalone scorer and
    as a ``Generic`` model and scored on the HIGGS frame's first 1,000,000
    rows (``MOJO_ROWS``) on the host, against the card's ``predict``:
    probabilities within ``tests/test_mojo.py``'s round-trip tolerances
    (atol 1e-5, rtol 1e-4; GLM atol 1e-4), the Generic frame on the card
    and bit-equal to the scorer's output cast to float32, the GBM POJO one
    method a tree, the GLM POJO's coefficients the MOJO's; then a
    set-split airlines GBM (1M rows, 5 trees: 25 grouped launches) whose
    MOJO holds bitset nodes and whose POJO holds set-split groups, and the
    multinomial covertype DRF at ``drf_card_vs_cpu``'s size (its plan's
    wrapper, 2 x 7 x 12 launches), each exported and scored on its own
    rows likewise; export walls, MOJO and POJO bytes, the scorer's rows/s
    beside the card ``predict``'s; no launch while exporting or scoring;
8c. ``import_formats``: 250,000 HIGGS-shaped rows (``FORMAT_ROWS``, seed 7)
    written as SVMLight and ARFF and 20,000 (``XLSX_ROWS``) as XLSX, each
    imported on the card with every float32 value and the response's
    codes bit-equal to the generator's (write and parse walls, MB/s,
    rows/s); then a 5-tree bernoulli GBM on the SVMLight frame: 25 flat
    launches, AUC above 0.6;
9. ``glm_cod_train``: the same with ``solver="COORDINATE_DESCENT"``;
9b. ``glm_pvalues_higgs``: IRLSM at lambda 0 with ``compute_p_values``:
    Gram launches = iterations + 1 (the Fisher pass), std errors finite
    and positive, p-values in [0, 1]; the kernel against its plain version
    on the Fisher pass's own inputs;
9c. ``glm_lbfgs_higgs``: the same with ``solver="L_BFGS"``: no launch,
    coefficients within 1e-3 x max(1, |beta|) of 9b's, residual deviance
    within a relative 1e-4;
9d. ``glm_constrained_higgs``: bounds on four coefficients, one equality
    and one inequality linear constraint: residuals within 1e-5, the
    constraints table; ``alpha=[0, 0.5, 1.0]`` at lambda 1e-4: the best
    alpha, each fit's launches;
9e. ``anova_modelselection_higgs``: ANOVA GLM over 5 predictors with
    their pairs (16 fits) at 2M rows; ModelSelection maxr (gaussian, a
    drawn response) over the 28 predictors at 11M rows — one Gram launch
    of [X | 1 | y] (z = None), then held against the plain version —;
    backward (binomial) over 8 predictors at 1M rows;
10. ``glm_card_vs_cpu``: two fits at 1M rows on the card and on the CPU —
    IRLSM with ``lambda_search`` and COD with ``lambda_=1e-3`` —
    coefficients within 1e-4 x max(1, |beta|), residual deviance within a
    relative 1e-5, predictions within 1e-4 (a one-iteration difference in
    where IRLS stops moves beta by up to ``beta_epsilon``); the card's
    lambda search makes iterations + 1 Gram launches (its lambda_max pass);
10b. ``gbm_options_card_vs_cpu``: 50,000 HIGGS rows with a regression
    response and a positive one from the generator's latent; 5 trees each
    of poisson, gamma, tweedie, laplace, quantile (alpha 0.9), huber (alpha
    0.9), gaussian with two monotone constraints and one interaction
    group, and ``histogram_type="Exact"`` on the features rounded to one
    decimal, plus one early-stopped gaussian GBM, on the card and on the
    CPU: equal split features, NA directions, split bins and tree counts,
    leaf values and predictions within 1e-5, the same variable-importance
    order, and the early-stopped model stopping before its 20 trees;
10c. ``xgboost_card_vs_cpu``: 250,000 HIGGS rows, 5 rounds of DART
    (rate_drop 0.3, seed 42, max_depth 6) on the card and on the CPU: the
    same dropped trees, equal forests, leaves and predictions within 1e-5;
    and the gblinear fit (COD over the Gram kernel): coefficients within
    1e-4 x max(1, |beta|), one Gram launch per iteration on the card;
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
14. ``drf_card_vs_cpu``: that DRF on 30,000 rows x 2 iterations on the card
    and on the CPU: equal split features, NA directions, split bins, leaf
    values and out-of-bag counts (integer channels), predictions within
    1e-5; and ``model_performance`` under each of the four multinomial
    ``auc_type``s on both devices: within 1e-6, finite, in (0.5, 1];
14b. ``recovery_card_vs_cpu``: the GBM kill drill at every boundary
    on 250,000 HIGGS rows (6 trees, ``score_tree_interval=2``: 3 kills)
    on the card: each resumed forest and its predictions bit-equal to the
    card's uninterrupted run, which matches the CPU's within the
    ``card_vs_cpu`` tolerances;
15. ``import_csv``: writes the airlines generator (seed 116) as a
    7,009,728-row CSV (the row count of the ASA Data Expo 2009 on-time
    file for 2008; levels as strings, ``Distance`` NA on every 97th row,
    ``CRSDepTime`` empty on every 89th), reads it back through
    ``import_file`` with the calendar columns typed ``enum`` as H2O's
    airlines demos do, and requires the types, the 8 domain sizes, NA at
    exactly the blanked cells, every level (by name) and every float32
    value as generated; prints the write and parse walls, MB/s and rows/s;
    then writes the generator's first 500,000 rows (``QUOTED_ROWS``, cut
    from the whole file) with the header and string levels quoted (R's
    ``write.csv``) and plain, parses both through the same call and
    requires the frames bit-equal, printing the quoted parse's wall and
    MB/s;
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
17c. ``model_surface_card_vs_cpu``: 50,000 HIGGS rows and 50,000 rows
    of the airlines split on the card and on the CPU: covers, leaf ids and
    paths equal, contributions within 1e-5, staged predictions within
    1e-6; every encoding's state and columns bit for bit; the GBMs on the
    EnumLimited, SortByResponse and Eigen frames structurally equal,
    leaves within 1e-5; a GLM grid over ``solver=["IRLSM", "L_BFGS"]``
    and ``feature_parallelism=[1, 2]`` raising naming ROADMAP Queue 1 item
    1 (step M);
17d. ``glm_interactions_airlines``: that GLM on the imported train split
    (no CV) with the pairs UniqueCarrier x Month (cat x cat, capped at 100
    combos), UniqueCarrier x Distance (cat x num) and CRSDepTime x Distance
    (num x num): Gram launches = IRLS iterations, P and peak memory (at
    most 60 GiB), validation AUC through the replayed interactions finite
    and above 0.6, a saved and loaded model predicting bit for bit alike;
    then the kernel against its plain version on the fit's own design;
17e. ``hglm_airlines``: HGLM on the same split, Origin (300 levels) the
    random intercept, Distance, CRSDepTime and DayOfWeek fixed, a gaussian
    response drawn on it (per-Origin effects of mean square 0.36, noise
    of mean square 1): no kernel launch (float64 cross products),
    ``varfix`` and ``varranef`` within 10% of those;
17f. ``glm_rest_card_vs_cpu``: every option of the GLM's remainder at
    50,000 rows on the card and on the CPU (p-values, L_BFGS, box and
    linear constraints, the alpha list, gamma and tweedie ``ml``
    dispersion, interactions, HGLM, the ordinal family, ANOVA,
    ModelSelection maxr and backward): coefficients within 1e-4 x max(1,
    |beta|), std errors and p-values within 1e-5 relative, the same ANOVA
    terms (each LR statistic within 1e-6 of its reduced model's float32
    deviance, each p-value inside the band that puts on the CPU's) and
    ModelSelection subsets, HGLM's variances within 1e-5;
18. ``import_cv_card_vs_cpu``: a 50,000-row CSV of the same generator
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
23. ``recovery_dl``: ``dl_mnist``'s model on the frame's first 10,000
    rows (``RECOVERY_DL_ROWS``, cut from 60,000) at 2 epochs (cut from 3)
    with
    ``auto_recovery_dir`` (a state write every epoch), killed at
    ``train.dl.epoch:raise(preempt)@2`` and resumed with
    ``resume_training``: weights and optimizer slots bit-equal to an
    uninterrupted 2-epoch run; prints the frame save, the state writes
    and the resume wall;
24. ``unsupervised_card_vs_cpu``: 2,000 rows of the generator on the card
    and on the CPU: DL (hidden [32, 32], 2 epochs) weights within 1e-4;
    KMeans assignments agreeing on >= 99.9% of rows, ``tot_withinss``
    within 1e-5 relative; PCA (k = 10) standard deviations within 1e-5
    relative, vectors equal up to sign (|cos| >= 1 - 1e-5) where the
    eigenvalues are separated by more than 1e-3 relative;
25. ``automl_higgs``: ``H2OAutoML(max_models=10, nfolds=2, seed=42,
    exclude_algos=["DeepLearning"])`` (``AUTOML_MAX_MODELS``, cut from 13;
    ``AUTOML_FOLDS``, cut from 5) on 250,000 HIGGS-shaped rows at the full
    28 features — 3 XGBoost, the lambda-search GLM, DRF, GBM
    def_1..def_5, both ensembles: each step's
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
26b. ``glm_ordinal_covtype``: the ordinal family on that frame, its 7
    classes taken as ordered (full-batch Adam, no kernel): thresholds
    strictly increasing, mean per-class error below 6/7, steps and wall;
27. ``ensemble_covtype``: a 2-fold GBM (10 trees, depth 5), DRF (10
    trees) and multinomial GLM under the AUTO metalearner: 21 level-one
    columns, class probabilities finite, rows summing to 1 within 1e-5;
28. ``automl_card_vs_cpu``: a plan with every algo (DeepLearning and a
    grid included) at 10,000 HIGGS rows with 2 folds (``AUTOML_CPU_FOLDS``,
    cut from 3), card and CPU: the
    same steps and combos, metrics within 1e-4, every ensemble's
    metalearner coefficients within 1e-4 x max(1, |beta|) and its
    predictions within 1e-4; the multinomial GLM on 10,000 covertype rows
    likewise;
29. ``grid_recovery``: a 4-combo GBM grid on 100,000 HIGGS rows killed at
    its third manifest write and resumed: bit-equal to the uninterrupted
    grid; and the grid with ``parallelism=2`` on the card: bit-equal to
    the sequential grid, with as many flat launches;
30. ``gam_higgs`` (after ``anova_modelselection_higgs``): ``bench.py``'s
    GAM (binomial, IRLSM, cr bases at 8 knots on f1, f2 and f4) on the 11M
    HIGGS frame, then thin plate on f1, monotone I-splines on f0 and
    P-splines on f4 (``GAM_BS``): Gram launches = IRLS iterations, residual
    below null deviance, AUC above 0.6, predictions through the replayed
    bases within 1e-4 of the standalone scorer's numpy bases, the
    I-spline smooth non-decreasing; then the Gram kernel against its
    plain version on GAM's 11,001,856 x 50 design;
31. ``rulefit_higgs``: ``bench.py``'s RuleFit (rules and linear terms,
    rule length 3, 50 depth-3 DRF trees) on that frame: the streamed
    design, 150 flat launches, Gram launches = IRLS steps x blocks, as
    many rules as the forest's distinct depth-3 paths, supports in
    [0, 1], AUC above 0.6; then the kernel against its plain version on
    the first streamed block's design, IRLS weights and working response;
32. ``coxph_survival``: CoxPH (Efron ties, 4 strata) twice on a generated
    1,000,000-row survival frame (``_survival_cols``: 10 covariates, a
    5-level categorical, integer follow-up times of 1-2,000 days, ~35%
    events, known coefficients): bit-equal twice, Gram launches = 2 x
    Newton passes, the log-likelihood rising, coefficients within 0.05 of
    the truth, concordance above 0.5, cumulative baseline hazards that do
    not fall and ``survfit`` curves in [0, 1] that do not rise; then the
    kernel on a Newton pass's own design and risk weights (z = None);
33. ``gam_rulefit_coxph_card_vs_cpu``: 98,304 rows on the card and on
    the CPU: both GAM fits (identified coefficients or smooths within
    1e-4, predictions within 1e-4), RuleFit built and streamed (10 trees:
    the same rules, memberships, supports and lambda path, coefficients
    within 1e-4 x max(1, |beta|)) and CoxPH (coefficients within 1e-5 x
    max(1, |beta|), log-likelihood within a relative 1e-6, baseline
    hazard within 1e-5);
34. ``families_higgs`` (after ``rulefit_higgs``): AdaBoost at its
    defaults (50 DRF learners of depth 2, ``mtries`` 1, each re-binning
    its weighted frame) on the first 2M HIGGS rows: 2 flat launches per
    learner, AUC above 0.5; Naive Bayes on all 11M rows (AUC above 0.5,
    logloss below the constant model's); ``QuantileBuilder`` at its
    default probabilities on every column (each quantile between the
    order statistics around its exact rank, sorted, finite; its distance
    from ``torch.quantile`` printed); isotonic regression of the response
    on f0 on 1M rows (MSE below the constant's, fit non-decreasing); the
    core infogram over GBM probes (10 trees) on 250,000 rows: 29 probes x
    50 flat launches, CMI and relevance in [0, 1];
35. ``uplift_criteo``: a generated frame of the Criteo Uplift Prediction
    Dataset v2.1's shape (``_criteo_cols``: 13,979,592 rows, 12 float32
    features, 85% treated, visits at 4.70%, an effect that varies with f3
    and f4); ``UpliftDRF`` at the JAX package's defaults (KL, nbins 20,
    depth 12, sample rate 0.632, mtries 3) with 10 trees (cut from 50),
    seed 42: 10 x 12 launches of the plan's wrapper at V = 4, no Gram
    launch, finite predictions, qini above a random ordering's, the ATE
    within 0.003 of the generator's; then the kernel at V = 4 against its
    plain version on the frame's codes and the first tree's bag at n_lv =
    1, 64 and 2,048 (all four channels exact, two launches bit-identical;
    the timings of ``level_hist_grouped``), and the MOJO on the first 1M
    rows through the port's reader, within 1e-5 of ``predict``;
36. ``isofor_creditcard``: a generated frame of the ULB credit-card fraud
    data set's shape (``_creditcard_cols``: 284,807 rows, 30 float32
    features, 492 planted anomalies); ``IsolationForest`` at its defaults
    (50 trees, 256-row samples, drawn by ``randint`` at this row count)
    and ``ExtendedIsolationForest`` at extension level 29: every row
    scored on the card, the AUC of the score against the planted label
    above 0.5, each MOJO on the first 20,000 rows within 1e-6, no kernel
    launch;
37. ``dt_covtype`` (after ``recovery_drf``): ``DT`` at its defaults on
    the covertype frame (one tree a class, depth 5, ``Exact`` bins for
    columns of at most 2,048 distinct values): 7 x 5 launches of the
    plan's wrapper, training logloss below the class prior's; then the
    kernel against its plain version at the root level of the model's own
    ``Exact`` plan and codes, the weight channel exact;
38. ``families_card_vs_cpu`` (after ``drf_card_vs_cpu``): every new
    builder at about 50,000 rows on the card and on the CPU (uplift with
    3 trees, DT at 30,000 rows, both isolation forests at 120,000 rows
    with 10 trees, AdaBoost with 5
    learners, Naive Bayes, quantiles, isotonic, a 6-feature infogram, the
    KFold target encoder, segment GBMs per carrier): tree structure,
    thresholds, split flags, subsample counts, leaf rates, bin edges,
    count tables and quantiles equal; gains, probabilities, alphas, CMI
    and encodings within 1e-6;
39. ``encoders_airlines`` (after ``compress_airlines``, on the imported
    7,009,728-row airlines frame): the target encoder on Origin, Dest and
    UniqueCarrier, KFold over a 5-fold column, blending, noise 0.01
    (encodings finite, within [-0.02, 1.02]); a 5-tree GBM on the encoded
    numerics (25 flat launches, AUC above 0.6); segment models of 5-tree
    GBMs, one per UniqueCarrier (22), at ``parallelism`` 1 and 2: every
    segment succeeded, 22 x 25 launches each, the two runs' forests
    bit-equal; the encoder's MOJO on the first 1M rows within 1e-6 of
    its transform;
40. ``psvm_higgs`` (after ``families_higgs``): PSVM with the Gaussian
    kernel (``rank_ratio`` auto: 500 Nystrom landmarks) on the first
    1,000,000 HIGGS rows and the linear kernel on all 11M: one Gram launch
    per Newton iteration and no other kernel, the objective never rising,
    AUC above 0.6, ``sv_count`` in (0, n], each MOJO on 100,000 rows within
    ``test_mojo_extended.py``'s round trip (p1 atol 1e-4, rtol 1e-3); then
    the Gram kernel against its plain version on the Gaussian fit's first
    launch's own inputs (1M x 501);
41. ``glrm_higgs`` (after ``psvm_higgs``): GLRM on the 11M x 28 HIGGS
    features, k = 10, Quadratic, STANDARDIZE, PlusPlus, 100 iterations,
    ``min_step_size`` 1e-9 (at 1e-4 every step at 11M rows is rejected):
    the objective history never rising and ending below its start,
    ``transform_frame`` and ``predict`` on every row, the MOJO on 20,000
    rows within atol and rtol 1e-3 (``test_mojo_extended.py:59``), no
    kernel launch;
42. ``word2vec_text8`` (after ``isofor_creditcard``): a generated corpus
    of text8's shape (``_text8_words``: Zipf over 71,290 words, 20
    planted topics, sentences of 1,000 tokens), cut to 1,000,000 tokens;
    Word2Vec (vec_size 100, window 5, 5 negatives, min_word_freq 5, one
    epoch) twice: the vectors bit-equal, the share of same-topic words
    among 200 frequent words' 10 nearest at least 5x chance, AVERAGE
    pooling one finite row a sentence, the MOJO's vectors bit-equal;
    steps/s; no kernel launch;
43. ``aggregator_covtype`` (after ``dt_covtype``): Aggregator on the
    covertype frame's 54 features, target 5,000 exemplars, ``rel_tol``
    0.5, NORMALIZE, twice: the count within the tolerance (or the search's
    fallback taken), counts summing to the rows and equal to the
    assignment's ``bincount``, the two runs bit-equal;
44. ``lastfamilies_card_vs_cpu`` (after ``families_card_vs_cpu``): PSVM
    (Gaussian, 20,000 HIGGS rows, three Newton steps: weights within 1e-4
    x max(1, |beta|),
    decision values within 1e-4), GLRM (a rank-10 frame, k = 10: history
    within 1e-5 relative and Y within 1e-4 over 25 iterations, the final
    objective of 100 within 1e-4), Aggregator (20,000 covertype
    rows: exemplars and counts equal), Word2Vec (50,000 tokens:
    vocabulary, pairs and every step's negatives equal, vectors within
    1e-5) on the card and on the CPU, and DeepLearning and IsolationForest
    with ``offset_column`` bit-equal to the column ignored;
45. ``glrm_airlines`` (after ``hglm_airlines``): GLRM on the imported
    train split's first 1,000,000 rows, every column, k = 5, Categorical
    blocks, Month's block Ordinal (``loss_by_col``), NonNegative X, the
    numerics standardized: the checks of ``glrm_higgs`` and X
    non-negative;
46. ``rapids_airlines`` (after ``encoders_airlines``, on the imported
    frame): group-by over [Origin, Dest] (nrow, Distance's mean/sd/min/
    max with NAs removed, CRSDepTime's sum with NAs poisoning): numpy's
    groups in key order, counts, min and max exactly, mean and sd within
    1e-5 of float64 numpy, two runs bit-equal; sort by [Origin,
    CRSDepTime descending, Distance]: ``np.lexsort``'s permutation, twice;
    the device merge on CRSDepTime against its distinct values (inner and
    all_x, each right key once and twice: ~14M rows), numpy's join bit for
    bit and twice the same; the host merge on [UniqueCarrier, Month]
    against a table listing their levels in another order, through the
    radix sort (its order equal to ``np.lexsort``'s on the 7M rows) and
    equal to numpy's join; 28 evaluator expressions (their shapes,
    checksums and walls printed, ``Session.end()`` leaving the store as
    it was); a 5-tree GBM on the first 1M rows with
    ``PermutationVarImp``, ``fairnessMetrics`` (UniqueCarrier) and
    ``makeLeaderboard`` through the evaluator: 25 grouped launches;
47. ``rapids_card_vs_cpu``: 57 evaluator expressions over a generated
    100,000-row frame (NAs, a string, a time and an int64 column past
    2^24) on the card and on the CPU: integers, orders, merges and
    strings exactly, floats within 1e-6, deviations, correlation and
    moments within 1e-5.

Between phases the K/V store is cleared (``h2o.remove_all()``): what a
phase keeps, it returns. Scratch files (CSVs, SVMLight, ARFF and XLSX
files, MOJOs and POJOs, model files, snapshot and recovery directories)
go to the git-ignored ``.chip_smoke/`` and are removed after each phase.

It prints the card's name and power limit, one JSON line of per-kernel
numbers (with each kernel's launches per path; the wrapper the covertype
plan picks carries that path's levels under ``covtype``; the Gram entry
carries its times at the CV GLM's, at PCA's, at the multinomial
GLM's class-block design, at the p-values' Fisher pass, at the
interaction design, at ModelSelection's [X | 1 | y], at GAM's design, at
a streamed RuleFit block, at a CoxPH Newton pass and at PSVM's first
Newton launch (``psvm_shape``); the flat entry
carries GBM def_5's deep levels; each histogram entry the encoded
airlines models' root levels that took its wrapper; ``mojo_export``'s
and ``import_formats``' trainings under ``launches_by_path``, as the new
families' are; the uplift path's V = 4 levels under ``uplift_v4_levels``
and DT's root level under ``dt_exact_root``, in the entry of the wrapper
each plan took), and last
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
OPTIONS_ROWS = 50_000          # gbm_options_card_vs_cpu: HIGGS rows (cut
                               # from 250,000 for the clock; 100,000 until
                               # the GAM/RuleFit/CoxPH slice)
XGB_CPU_ROWS = 250_000         # xgboost_card_vs_cpu: HIGGS rows (cut
                               # from 1M for the clock)
IMPORT_ROWS = 7_009_728        # the ASA Data Expo 2009 on-time file for 2008
IMPORT_CPU_ROWS = 50_000       # import_cv_card_vs_cpu (cut from 100,000 for
                               # the clock when the tree families came)
SLICE_ROWS = 100_000           # checkpoint_higgs: rows a fresh process scores
CARD_CPU_ROWS = 250_000        # card_vs_cpu: HIGGS rows (cut from 1M for
                               # the clock; the CPU side took ~46 s)
QUOTED_ROWS = 500_000          # import_csv: the quoted twin's rows (cut
                               # from the full 7,009,728 for the clock;
                               # 1,000,000 until the tree families came)
RECOVERY_ROWS = 250_000        # recovery_card_vs_cpu: HIGGS rows (cut
                               # from 1M for the clock)
RECOVERY_DRF_TREES = 30        # recovery_drf: drf_train's 50 trees cut to 30
DRF_CPU_ROWS = 30_000          # drf_card_vs_cpu: covertype rows (cut from
DRF_CPU_ITERATIONS = 2         # 100,000 x 5 iterations for the clock;
                               # 3 until the GAM/RuleFit/CoxPH slice)
                               # for the script's clock (3 chunks: the kill
                               # before the third still replays one)
MNIST_ROWS = 60_000            # MNIST's training set
MNIST_BORDER = 67              # pixels 0 in every row of MNIST's training set
MNIST_CPU_ROWS = 2_000         # unsupervised_card_vs_cpu
RECOVERY_DL_EPOCHS = 2.0       # recovery_dl: cut from 3 epochs (PR 12)
RECOVERY_DL_ROWS = 10_000      # recovery_dl: the frame's first rows (cut
                               # from 60,000 for the clock; 20,000 until
                               # the tree families came)
AUTOML_ROWS = 250_000          # automl_higgs: HIGGS rows (cut from 11M)
AUTOML_FOLDS = 2               # automl_higgs: CV folds (cut from 5: 78 fits
                               # took 208-226 s on an H100 at 700 W, and
                               # 100,000 rows no less: a deep tree's levels
                               # cost by their 2^level nodes, not rows; 3
                               # folds took 164-228 s, so 2 since PR 12)
AUTOML_MAX_MODELS = 10         # automl_higgs: cut from 13 for the clock
                               # (the 2-model GBM grid, ~24 s, and XRT,
                               # ~14 s, go; GBM def_5, whose deep levels
                               # the kernel line reports, is the 10th;
                               # automl_card_vs_cpu still runs a grid)
ENSEMBLE_FOLDS = 2             # ensemble_covtype: CV folds (cut from 3
                               # for the clock when the MOJO/formats
                               # phases came)
AUTOML_CPU_ROWS = 10_000       # automl_card_vs_cpu: HIGGS and covertype rows
                               # (20,000 until the tree families came)
AUTOML_CPU_FOLDS = 2           # automl_card_vs_cpu: CV folds (3 until
                               # the GAM/RuleFit/CoxPH slice, cut for the
                               # clock)
DL_PROFILED_EPOCHS = (0.02, 0.06)  # dl_mnist: the two profiled builds
                               # (0.05 and 0.15 epochs until the GAM/
                               # RuleFit/CoxPH slice, cut for the clock)
GRID_ROWS = 100_000            # grid_recovery: HIGGS rows
MOJO_ROWS = 1_000_000          # mojo_export: the rows each MOJO scores
                               # (the DRF's: all DRF_CPU_ROWS)
MOJO_AIRLINES_ROWS = 1_000_000  # mojo_export: the set-split GBM's rows
MOJO_ATOL, MOJO_RTOL = 1e-5, 1e-4  # tests/test_mojo.py:_roundtrip
MOJO_GLM_ATOL = 1e-4           # tests/test_mojo.py:test_glm_mojo
FORMAT_ROWS = 250_000          # import_formats: HIGGS rows of the
                               # SVMLight and ARFF files
XLSX_ROWS = 20_000             # import_formats: HIGGS rows of the XLSX
                               # file (cut from 250,000: the reader walks
                               # every cell of the sheet's XML in Python)
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
    # the MSE falls 11-19% a scoring until the sixth (10%), so it stops at
    # 12 trees (at 250,000 rows, and at 100,000 on the CPU)
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
    """Every GBM option this slice ported, 5 trees at 100,000 HIGGS rows on
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
    """DART (5 rounds, rate_drop 0.3) and gblinear at 250,000 HIGGS rows on the
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
    """The HIGGS GBM on CARD_CPU_ROWS rows x 5 trees, on the card and on
    the CPU."""
    import torch

    rows, ntrees = CARD_CPU_ROWS, 5
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
               f"card_vs_cpu: {k} differs between card and CPU")
    _check(np.array_equal(_split_bins(a), _split_bins(b)),
           "card_vs_cpu: split bins differ between card and CPU")
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
           f"card_vs_cpu: leaf values off by {val_err}, predictions by "
           f"{pred_err}")


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
                   reps: int, flat: bool = False, exact_ch: int = 1) -> dict:
    """One grouped level: kernel vs plain checks and the four timings.
    ``flat`` takes the flat wrapper instead, ``groups`` then being its one
    bucket of every feature at width ``B``. The first ``exact_ch`` channels
    are integer-valued and must equal the plain version bit for bit (all
    four of uplift's); the rest are held within ``REAL_TOL`` of the mass.

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
        _check(torch.equal(a[..., :exact_ch], p[..., :exact_ch]),
               f"grouped n_lv={n_lv} Bg={Bg}: an integer channel differs "
               f"from the plain version")
        d = (a - p).abs()
        err = max(err, float(d.max()))
        if exact_ch < V:
            rel = max(rel, float((d[..., exact_ch:]
                                  / (m[..., exact_ch:] + 1e-30)).max()))
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


def _glm_train(dev, fr, what: str, **kw) -> tuple[int, object]:
    """One GLM fit of ``bench.py``'s settings on the HIGGS frame and its
    checks; returns its Gram launches and the model."""
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
    return launches, model


def _mojo_roundtrip(dev, model, fr, what: str, atol: float,
                    pojo: bool) -> dict:
    """``model`` exported as a MOJO (and a POJO), loaded by the port's
    standalone scorer and as a ``Generic`` model, and ``fr``'s rows scored
    on the host against the card's ``predict``: probabilities (or the
    regression value) within ``atol`` and ``MOJO_RTOL``; the Generic
    frame on the card, bit-equal to the scorer's output cast to float32.
    No kernel launches (the counts are read by the caller)."""
    import torch

    from h2o_tpu_torch import MojoModel, import_mojo

    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, f"{what}.zip")
    t0 = time.perf_counter()
    model.save_mojo(path)
    export_s = time.perf_counter() - t0
    out = dict(rows=fr.nrow, export_s=export_s,
               mojo_bytes=os.path.getsize(path))
    if pojo:
        jpath = os.path.join(DATA_DIR, f"{what}.java")
        t0 = time.perf_counter()
        model.save_pojo(jpath)
        out.update(pojo_export_s=time.perf_counter() - t0,
                   pojo_bytes=os.path.getsize(jpath))
        with open(jpath) as fh:
            out["pojo_source"] = fh.read()
        os.remove(jpath)
    t0 = time.perf_counter()
    scorer = MojoModel.load(path)
    out["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = scorer.feature_frame_matrix(fr)     # one host copy a column
    out["adapt_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = scorer.score(X)
    out["score_s"] = time.perf_counter() - t0
    del X
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = model.predict(fr)
    cols = [pred.vec(i).data[:fr.nrow] for i in range(pred.ncol)]
    torch.cuda.synchronize()
    out["predict_s"] = time.perf_counter() - t0
    want = torch.stack(cols, dim=1).double().cpu().numpy()
    if got.ndim == 1:
        a, b = got, want[:, 0]
    else:
        a, b = got[:, 1:], want[:, 1:want.shape[1]]
        _check(got.shape[1] == want.shape[1],
               f"{what}: MOJO gives {got.shape[1]} columns, predict "
               f"{want.shape[1]}")
    err = float(np.abs(a - b).max())
    _check(bool(np.isfinite(got).all()), f"{what}: MOJO scores not finite")
    _check(bool(np.allclose(a, b, atol=atol, rtol=MOJO_RTOL)),
           f"{what}: MOJO scores off the card's predict by {err} (atol "
           f"{atol}, rtol {MOJO_RTOL})")
    t0 = time.perf_counter()
    g = import_mojo(path, device=dev)
    gp = g.predict(fr)
    torch.cuda.synchronize()
    out["generic_s"] = time.perf_counter() - t0
    g32 = got.astype(np.float32).reshape(fr.nrow, -1)
    for j in range(gp.ncol):
        v = gp.vec(j).data
        _check(v.device.type == dev.type, f"{what}: Generic frame on "
                                          f"{v.device}")
        _check(np.array_equal(v[:fr.nrow].cpu().numpy().view(np.int32),
                              g32[:, j].view(np.int32)),
               f"{what}: Generic column {j} differs from the scorer's")
    os.remove(path)
    out.update(max_abs_err=err, scorer_rows_per_s=fr.nrow / out["score_s"],
               predict_rows_per_s=fr.nrow / out["predict_s"])
    out["scorer"] = scorer
    return out


def _report_mojo(what: str, r: dict) -> None:
    print("mojo_export", what, json.dumps(
        {k: v for k, v in r.items() if k not in ("scorer", "pojo_source")}),
        flush=True)


def _bitset_nodes(scorer) -> int:
    """The bitset (set-split) nodes of a tree MOJO's decoded trees."""
    count = 0
    for row in scorer.trees:
        stack = [t for t in row if t is not None]
        while stack:
            nd = stack.pop()
            if nd.leaf_val is None:
                count += nd.bitset is not None
                stack.extend([nd.left, nd.right])
    return count


def phase_mojo_export(dev, higgs, gbm, glm) -> dict:
    """MOJO and POJO export of the flagship GBM (``train``'s model) and
    the IRLSM GLM (``glm_train``'s), scored on the HIGGS frame's first
    MOJO_ROWS rows; then a set-split airlines GBM (MOJO_AIRLINES_ROWS
    rows, 5 trees, the grouped kernel) and the multinomial covertype DRF
    at ``drf_card_vs_cpu``'s size (the plan's wrapper), each trained here
    with its launches counted, exported and scored on its own rows.
    Returns the flat and grouped launches of the two trainings."""
    import re

    import torch

    from h2o_tpu_torch.backend.kernels import gram, hist

    sub = higgs.take(np.arange(MOJO_ROWS))
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    r = _mojo_roundtrip(dev, gbm, sub, "higgs_gbm", MOJO_ATOL, pojo=True)
    _check(r["pojo_source"].count("static double tree_") == gbm.ntrees,
           "higgs_gbm: the POJO lacks a tree method")
    _report_mojo("higgs_gbm", r)
    r = _mojo_roundtrip(dev, glm, sub, "higgs_glm", MOJO_GLM_ATOL, pojo=True)
    beta = [float(t) for t in re.search(r"double\[\] BETA = \{ (.*?) \}",
                                        r["pojo_source"]).group(1)
            .split(",")]
    _check(np.array_equal(np.array(beta), r["scorer"].beta),
           "higgs_glm: the POJO's coefficients differ from the MOJO's")
    _report_mojo("higgs_glm", r)
    _check(hist.LAUNCHES + hist.GROUPED_LAUNCHES + gram.GRAM_LAUNCHES == 0,
           "exporting or scoring a MOJO launched a kernel")
    del sub

    air = _airlines_frame(MOJO_AIRLINES_ROWS, dev)
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _gbm(air, ntrees=5, response="IsDepDelayed")
    train_s = time.perf_counter() - t0
    launches = dict(flat=hist.LAUNCHES, grouped=hist.GROUPED_LAUNCHES)
    _check(launches == dict(flat=0, grouped=25) and gram.GRAM_LAUNCHES == 0,
           f"airlines GBM: {launches}, want 25 grouped launches")
    r = _mojo_roundtrip(dev, model, air, "airlines_gbm", MOJO_ATOL,
                        pojo=True)
    sets = _bitset_nodes(r["scorer"])
    _check(sets >= 1, "airlines_gbm: no bitset node in the MOJO")
    _check("static final boolean[] GRP_" in r["pojo_source"],
           "airlines_gbm: no set-split group in the POJO")
    r.update(train_s=train_s, bitset_nodes=sets)
    _report_mojo("airlines_gbm", r)
    del air, model

    cov = _covtype_frame(DRF_CPU_ROWS, dev)
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _drf(cov, DRF_CPU_ITERATIONS)
    train_s = time.perf_counter() - t0
    drf = hist.LAUNCHES + hist.GROUPED_LAUNCHES
    want = DRF_CPU_ITERATIONS * 7 * 12
    _check(drf == want and gram.GRAM_LAUNCHES == 0,
           f"covertype DRF: {drf} histogram launches, want {want}")
    launches["flat"] += hist.LAUNCHES
    launches["grouped"] += hist.GROUPED_LAUNCHES
    r = _mojo_roundtrip(dev, model, cov, "covtype_drf", MOJO_ATOL,
                        pojo=False)
    _check(r["scorer"].algo == "drf" and r["scorer"].tpc == 7,
           "covtype_drf: not a 7-class DRF MOJO")
    r.update(train_s=train_s)
    _report_mojo("covtype_drf", r)
    return launches


def _write_svmlight_arff(svm_path: str, arff_path: str, X, y) -> None:
    """(X, y) as an SVMLight file (indices from 0) and an ARFF file (the
    response nominal {b,s}), in one pass, each value with nine significant
    digits: the decimal lies within 5e-9 of the float32 relative to its
    magnitude, far inside its rounding interval (3e-8), so it parses back
    through float64 to the same float32."""
    F = X.shape[1]
    svm_row = "%d " + " ".join(f"{j}:%.9g" for j in range(F)) + "\n"
    arff_row = ",".join(["%.9g"] * F) + ",%s\n"
    with open(svm_path, "w") as svm, open(arff_path, "w") as arff:
        arff.write("% HIGGS-shaped rows\n@relation higgs\n"
                   + "".join(f"@attribute f{j} numeric\n" for j in range(F))
                   + "@attribute response {b,s}\n@data\n")
        for r0 in range(0, X.shape[0], 25_000):
            rows = X[r0:r0 + 25_000].astype(np.float64).tolist()
            labs = y[r0:r0 + 25_000].astype(np.int64).tolist()
            for lab, row in zip(labs, rows):
                svm.write(svm_row % (lab, *row))
                arff.write(arff_row % (*row, "bs"[lab]))


def phase_import_formats(dev) -> int:
    """HIGGS-shaped files in three more formats: SVMLight and ARFF of
    FORMAT_ROWS rows, XLSX of XLSX_ROWS; each imported on the card with
    every float32 value (and the response's codes) bit-equal to the
    generator's; then a 5-tree bernoulli GBM on the SVMLight frame through
    the flat kernel. Returns its flat launches."""
    import torch

    from h2o_tpu_torch import import_file
    from h2o_tpu_torch.backend.kernels import gram, hist
    from h2o_tpu_torch.io.xlsx import write_xlsx

    os.makedirs(DATA_DIR, exist_ok=True)
    cols, y = _higgs_cols(FORMAT_ROWS, seed=7)
    X = np.stack([cols[f"f{j}"] for j in range(HIGGS_F)], axis=1)
    del cols
    out, frames = {}, {}

    def check(fr, what, names, nrow):
        _check(fr.nrow == nrow and fr.device.type == dev.type,
               f"{what}: {fr.nrow} rows on {fr.device}")
        for j, name in enumerate(names):
            got = fr.vec(name).data[:nrow].cpu().numpy()
            _check(np.array_equal(got.view(np.int32),
                                  X[:nrow, j].view(np.int32)),
                   f"{what}: column {name} differs from the generator's")

    paths = {w: os.path.join(DATA_DIR, f"higgs.{w}")
             for w in ("svmlight", "arff")}
    t0 = time.perf_counter()
    _write_svmlight_arff(paths["svmlight"], paths["arff"], X, y)
    out["svmlight_arff_write_s"] = time.perf_counter() - t0
    nrow = FORMAT_ROWS
    for what, path in paths.items():
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        fr = import_file(path, device=dev)
        parse_s = time.perf_counter() - t0
        os.remove(path)
        if what == "svmlight":
            check(fr, what, [f"C{j}" for j in range(HIGGS_F)], nrow)
            _check(np.array_equal(fr.vec("target").data[:nrow].cpu().numpy(),
                                  y[:nrow]), "svmlight: target differs")
        else:
            check(fr, what, [f"f{j}" for j in range(HIGGS_F)], nrow)
            resp = fr.vec("response")
            _check(resp.domain == ["b", "s"] and np.array_equal(
                resp.data[:nrow].cpu().numpy(), y[:nrow]),
                "arff: response codes differ")
        frames[what] = fr
        out[what] = dict(rows=nrow, parse_s=parse_s, mb=size / 1e6,
                         mb_per_s=size / 1e6 / parse_s,
                         rows_per_s=nrow / parse_s)
    path = os.path.join(DATA_DIR, "higgs.xlsx")
    header = [f"f{j}" for j in range(HIGGS_F)] + ["response"]
    t0 = time.perf_counter()
    write_xlsx(path, header, [
        row + ["bs"[int(lab)]] for row, lab in
        zip(X[:XLSX_ROWS].astype(np.float64).tolist(), y[:XLSX_ROWS])])
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    fr = import_file(path, device=dev)
    parse_s = time.perf_counter() - t0
    os.remove(path)
    check(fr, "xlsx", header[:-1], XLSX_ROWS)
    resp = fr.vec("response")
    _check(resp.domain == ["b", "s"] and np.array_equal(
        resp.data[:XLSX_ROWS].cpu().numpy(), y[:XLSX_ROWS]),
        "xlsx: response codes differ")
    out["xlsx"] = dict(rows=XLSX_ROWS, write_s=write_s, parse_s=parse_s,
                       mb=size / 1e6, mb_per_s=size / 1e6 / parse_s,
                       rows_per_s=XLSX_ROWS / parse_s)
    del fr, frames["arff"]

    from h2o_tpu_torch import GBM, GBMParameters

    fr = frames.pop("svmlight")
    hist.LAUNCHES = hist.GROUPED_LAUNCHES = gram.GRAM_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = GBM(GBMParameters(training_frame=fr, response_column="target",
                              distribution="bernoulli", ntrees=5,
                              max_depth=5, nbins=20, learn_rate=0.1,
                              seed=42)).train_model()
    train_s = time.perf_counter() - t0
    launches = hist.LAUNCHES
    _check(launches == 25 and hist.GROUPED_LAUNCHES == 0
           and gram.GRAM_LAUNCHES == 0,
           f"svmlight GBM: {launches} flat launches, want 25")
    auc = model.output.training_metrics.auc
    _check(bool(np.isfinite(auc)) and auc > 0.6, f"svmlight GBM: AUC {auc}")
    out["gbm"] = dict(train_s=train_s, auc=auc, flat_launches=launches)
    print("import_formats", json.dumps(out), flush=True)
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
    """The covertype DRF on DRF_CPU_ROWS rows x DRF_CPU_ITERATIONS
    iterations (7 trees each, depth 12), on the card and on the CPU:
    integer channels, so identical."""
    import torch

    rows, ntrees = DRF_CPU_ROWS, DRF_CPU_ITERATIONS
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
    # QUOTED_ROWS rows of the generator with the string levels quoted (R's
    # write.csv), and the same rows plain: the same frame bit for bit
    try:
        _write_airlines_csv(path, QUOTED_ROWS, quote=True)
        qsize = os.path.getsize(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fq = _import_airlines(path, dev)
        torch.cuda.synchronize()
        qparse_s = time.perf_counter() - t0
        _write_airlines_csv(path, QUOTED_ROWS)
        fu = _import_airlines(path, dev)
    finally:
        if os.path.exists(path):
            os.remove(path)
    _check(fq.names == fu.names and fq.types() == fu.types() == types,
           f"import_csv quoted: names {fq.names}, types {fq.types()}")
    for name in fu.names:
        a, b = fu.vec(name), fq.vec(name)
        _check(a.domain == b.domain and torch.equal(
            a.data.view(torch.int32), b.data.view(torch.int32)),
            f"import_csv quoted: {name} differs from the unquoted parse")
    del fq, fu
    out = dict(rows=n, bytes=size, write_s=write_s, parse_s=parse_s,
               parse_mb_per_s=size / 1e6 / parse_s,
               parse_rows_per_s=n / parse_s, quoted_rows=QUOTED_ROWS,
               quoted_bytes=qsize,
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
    """A 50,000-row CSV of the same generator through the whole path on
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
    """The GBM kill drill at every boundary on 250,000 HIGGS rows (6
    trees, ``score_tree_interval=2``: 3 kills) on the card: each resumed
    forest and its predictions bit-equal to the card's uninterrupted run;
    that forest against the CPU's within the ``card_vs_cpu``
    tolerances."""
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
    lo, hi = DL_PROFILED_EPOCHS
    n_a, busy_a, wall_a = _profiled_steps(dev, fr, lo)
    n_b, busy_b, wall_b = _profiled_steps(dev, fr, hi)
    dsteps = int(hi * steps) - int(lo * steps)
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
    """``dl_mnist``'s model on the frame's first RECOVERY_DL_ROWS rows at 2
    epochs with ``auto_recovery_dir`` (a state write at every epoch),
    killed at ``train.dl.epoch:raise(preempt)@2`` and resumed with
    ``resume_training``: weights and optimizer slots bit-equal to an
    uninterrupted 2-epoch run."""
    import shutil

    import torch

    from h2o_tpu_torch import resume_training
    from h2o_tpu_torch.backend import persist
    from h2o_tpu_torch.utils import failpoints

    fr = fr.take(np.arange(RECOVERY_DL_ROWS))
    rdir = os.path.join(DATA_DIR, "recovery_dl")
    shutil.rmtree(rdir, ignore_errors=True)
    old = os.environ.get("H2O_TORCH_CHECKPOINT_SECS")
    os.environ["H2O_TORCH_CHECKPOINT_SECS"] = "0"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base = _dl_mnist(fr, epochs=RECOVERY_DL_EPOCHS)
        base_s = time.perf_counter() - t0
        failpoints.arm("train.dl.epoch",
                       f"raise(preempt)@{int(RECOVERY_DL_EPOCHS)}")
        t0 = time.perf_counter()
        with _Walls(persist, "save_frame", dev) as frame_saves, \
                _Walls(persist.TrainingRecovery, "save_state",
                       dev) as writes:
            try:
                _dl_mnist(fr, epochs=RECOVERY_DL_EPOCHS,
                          auto_recovery_dir=rdir)
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
    n = int(RECOVERY_DL_EPOCHS)
    out = dict(rows=fr.nrow, epochs=n, killed_before_epoch=n,
               uninterrupted_s=base_s, killed_run_s=killed_s,
               resume_s=resume_s, frame_save_s=frame_saves.s,
               state_writes=len(writes.s),
               state_writes_killed_run=killed_writes, write_s=sum(writes.s),
               completed=manifest["completed"],
               epochs_trained=res.epochs_trained)
    print("recovery_dl", json.dumps(out), flush=True)
    _check(_nets_equal(res, base),
           "recovery_dl: resumed weights or slots differ")
    _check(manifest["completed"] and killed_writes == n - 1
           and len(writes.s) == n and res.epochs_trained == float(n),
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
    """``H2OAutoML(max_models=AUTOML_MAX_MODELS, nfolds=AUTOML_FOLDS,
    seed=42, exclude_algos=["DeepLearning"])`` on AUTOML_ROWS HIGGS-shaped rows
    at the full 28 features: the default plan's steps but DeepLearning up to
    the model budget (3 XGBoost, the lambda-search GLM, DRF, GBM def_1..def_5)
    and both stacked ensembles. Prints each step's wall and launches, the
    deepest level width each met, peak memory and the leaderboard; requires
    finite AUCs above 0.6, sorted, AUTOML_MAX_MODELS base models and 2
    ensembles, every base-model step through the flat kernel and the GLM and
    ensembles through the Gram; the leader predicts, and partial dependence on
    two columns and permutation importance are timed. After the counted run the
    flat kernel is held against its plain version on GBM def_5's own codes,
    node ids and channels at each of its levels of 8,192 nodes or more. Returns
    the launches by kernel and the deep levels' numbers."""
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
        aml = H2OAutoML(max_models=AUTOML_MAX_MODELS, nfolds=AUTOML_FOLDS,
                        seed=42,
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
    _check(len(base) == AUTOML_MAX_MODELS
           and len(rows) == AUTOML_MAX_MODELS + 2,
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
    """While open, the Gram calls of ``module`` (the GLM's by default,
    or ModelSelection's, RuleFit's, CoxPH's) keep the inputs of the last
    one (with ``first``, of the first one): a class block's design, IRLS
    weights and working response, [X | 1 | y] and its row weights, a
    streamed design block, or a Newton pass's design and risk weights."""

    def __init__(self, module=None, first: bool = False):
        from h2o_tpu_torch.models import glm

        self.module = module or glm
        self.first = first

    def __enter__(self):
        self.orig, self.last = self.module.gram_accumulate, None
        orig = self.orig

        def kept(X, W, z=None):
            if not (self.first and self.last is not None):
                self.last = (X, W, z)
            return orig(X, W, z)
        self.module.gram_accumulate = kept
        return self

    def __exit__(self, *exc):
        self.module.gram_accumulate = self.orig


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
    """A stacked ensemble on the covertype-shaped frame: 2-fold CV
    (``ENSEMBLE_FOLDS``, cut from 3; Modulo,
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

    common = dict(training_frame=fr, response_column="Cover_Type",
                  nfolds=ENSEMBLE_FOLDS, fold_assignment="Modulo", seed=42,
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
    at depth 4, XGBoost included, a DeepLearning of three 10-unit layers) with
    AUTOML_CPU_FOLDS folds on the card and on the CPU: the same steps, the same
    grid combos, every model's leaderboard metrics (auc, logloss, rmse) within
    1e-4; every ensemble's metalearner coefficients within 1e-4 x max(1,
    |beta|) and its predictions within 1e-4 (with the largest difference of its
    level-one columns printed); the leaders' predictions within 1e-4; and the
    multinomial GLM on AUTOML_CPU_ROWS covertype rows: coefficients within 1e-4
    x max(1, |beta|), logloss within 1e-5. Returns the card's launches."""
    import torch

    from h2o_tpu_torch import H2OAutoML
    from h2o_tpu_torch.models import automl

    runs, launches = [], None
    for d in (dev, "cpu"):
        fr = _higgs_frame(AUTOML_CPU_ROWS, d)
        if d is dev:
            _reset_counts()
        t0 = time.perf_counter()
        aml = H2OAutoML(max_models=7, nfolds=AUTOML_CPU_FOLDS, seed=42,
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
SURFACE_CPU_ROWS = 50_000      # model_surface_card_vs_cpu: rows per frame
                               # (100,000 until the tree families came)
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
    """The model surface on the card and on the CPU: 50,000 HIGGS rows
    (covers, leaf ids and paths, contributions, staged predictions of one
    GBM) and 50,000 rows of the airlines split (each encoding's columns;
    GBMs on three encoded frames); a GLM grid with a feature-parallel combo
    raises on the card too. Returns the card's histogram launches."""
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
    refused = GridSearch(
        GLM, GLMParameters(training_frame=airs[dev],
                           response_column="IsDepDelayed",
                           family="binomial", seed=42),
        {"solver": ["IRLSM", "L_BFGS"], "feature_parallelism": [1, 2]})
    try:
        refused.train()
        raised = ""
    except NotImplementedError as e:
        raised = str(e)
    _check("ROADMAP Queue 1 item 1" in raised,
           f"model surface: the feature-parallel grid did not refuse "
           f"({raised!r})")
    out["grid_refusal"] = raised
    out["launches"] = dict(flat=hist.LAUNCHES, grouped=hist.GROUPED_LAUNCHES)
    print("model_surface_card_vs_cpu", json.dumps(out), flush=True)
    # the card's four GBMs (HIGGS and three encodings), 10 trees x 5 levels
    _check(hist.LAUNCHES + hist.GROUPED_LAUNCHES == 4 * 50,
           f"model surface: {out['launches']} histogram launches on the "
           f"card, want 200")
    return out["launches"]


# ---------------------------------------------------------------------------
# the rest of GLM: p-values, L_BFGS, constraints, alpha lists, interactions,
# HGLM, the ordinal family, ANOVA GLM and ModelSelection
# ---------------------------------------------------------------------------
GLM_REST_ROWS = 50_000         # glm_rest_card_vs_cpu: rows per frame
                               # (100,000 until the tree families came)
ANOVA_ROWS = 2_000_000         # anova_modelselection_higgs: ANOVA's rows
BACKWARD_ROWS = 1_000_000      # anova_modelselection_higgs: backward's rows
INTERACTION_PAIRS = [("UniqueCarrier", "Month"),
                     ("UniqueCarrier", "Distance"),
                     ("CRSDepTime", "Distance")]
#: glm_constrained_higgs: natural-scale bounds on four coefficients, and
#: f9 + f12 = 0.2 with f15 - f18 <= 0
HIGGS_BOUNDS = {"names": ["f0", "f3", "f1", "f6"],
                "lower_bounds": [0.0, -0.1, -0.05, 0.0],
                "upper_bounds": [0.3, 0.1, 0.05, 0.1]}
HIGGS_LINEAR = {"names": ["f9", "f12", "constant", "f15", "f18"],
                "values": [1.0, 1.0, -0.2, 1.0, -1.0],
                "types": ["Equal"] * 3 + ["LessThanEqual"] * 2,
                "constraint_numbers": [0, 0, 0, 1, 1]}


class _FitLaunches:
    """While open, each single-block GLM fit's Gram launches and IRLS
    iterations, in order (alpha-list members, ANOVA's and
    ModelSelection's fits)."""

    def __enter__(self):
        from h2o_tpu_torch.backend.kernels import gram
        from h2o_tpu_torch.models.glm import GLM

        self.orig, self.fits = GLM._build_single, []
        orig, fits = self.orig, self.fits

        def counted(builder, *a, **kw):
            n0 = gram.GRAM_LAUNCHES
            m = orig(builder, *a, **kw)
            fits.append(dict(alpha=builder.params.alpha,
                             launches=gram.GRAM_LAUNCHES - n0,
                             iterations=m.output.scoring_history[-1][
                                 "iterations"]))
            return m
        GLM._build_single = counted
        return self

    def __exit__(self, *exc):
        from h2o_tpu_torch.models.glm import GLM

        GLM._build_single = self.orig


def _gram_shape(shape: dict) -> dict:
    return {k: shape[k] for k in ("rows", "cols", "ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by",
                                  "max_abs_err")}


def phase_glm_pvalues_higgs(dev, fr) -> tuple[int, object, dict]:
    """The HIGGS binomial GLM (IRLSM, lambda 0) with ``compute_p_values``:
    Gram launches = IRLS iterations + 1 (the Fisher pass at the solution),
    std errors finite and positive, p-values in [0, 1]; then the kernel
    against its plain version on the Fisher pass's own inputs. Returns the
    launches, the model and that check."""
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _GramInputs() as kept:
        model = _glm(fr, lambda_=0.0, compute_p_values=True)
    train_s = time.perf_counter() - t0
    launches = _counts()
    iters = model.output.scoring_history[-1]["iterations"]
    se = np.array(list(model.std_errs.values()))
    pv = np.array(list(model.p_values.values()))
    X, W, z = kept.last
    shape = _gram_check(X, W, z, reps=5)
    del kept, X, W, z
    m = model.output.training_metrics
    print("glm_pvalues_higgs", json.dumps(dict(
        rows=fr.nrow, train_s=train_s, iterations=iters, launches=launches,
        auc=m.auc, residual_deviance=m.residual_deviance,
        std_err_range=[float(se.min()), float(se.max())],
        p_value_range=[float(pv.min()), float(pv.max())],
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        gram_at_path=shape)), flush=True)
    _check(launches["gram"] == iters + 1 and launches["flat"] == 0
           and launches["grouped"] == 0,
           f"glm_pvalues_higgs: launches {launches} for {iters} iterations")
    _check(bool(np.all(np.isfinite(se)) and np.all(se > 0)),
           "glm_pvalues_higgs: std errors")
    _check(bool(np.all((pv >= 0) & (pv <= 1))), "glm_pvalues_higgs: p-values")
    _check(bool(np.isfinite(m.auc)) and m.auc > 0.6,
           f"glm_pvalues_higgs: AUC {m.auc}")
    torch.cuda.empty_cache()
    return launches["gram"], model, shape


def phase_glm_lbfgs_higgs(dev, fr, irlsm) -> None:
    """The same fit with ``solver="L_BFGS"``: no Gram launch, coefficients
    within 1e-3 x max(1, |beta|) of the IRLSM fit, residual deviance within
    a relative 1e-4; iterations and wall."""
    import torch

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _glm(fr, lambda_=0.0, solver="L_BFGS")
    train_s = time.perf_counter() - t0
    launches = _counts()
    coef = float(np.max(np.abs(model.beta - irlsm.beta)
                        / np.maximum(1.0, np.abs(irlsm.beta))))
    ra = model.output.training_metrics.residual_deviance
    rb = irlsm.output.training_metrics.residual_deviance
    dev_rel = abs(ra - rb) / abs(rb)
    print("glm_lbfgs_higgs", json.dumps(dict(
        rows=fr.nrow, train_s=train_s,
        iterations=model.output.scoring_history[-1]["iterations"],
        launches=launches, coef_max_rel_err_vs_irlsm=coef,
        dev_rel_err_vs_irlsm=dev_rel,
        auc=model.output.training_metrics.auc)), flush=True)
    _check(sum(launches.values()) == 0,
           f"glm_lbfgs_higgs: kernel launches {launches}")
    _check(coef <= 1e-3, f"glm_lbfgs_higgs: coefficients {coef:.3g} from "
                         f"IRLSM's (limit 1e-3)")
    _check(dev_rel <= 1e-4, f"glm_lbfgs_higgs: deviance {dev_rel:.3g} from "
                            f"IRLSM's (limit 1e-4)")


def phase_glm_constrained_higgs(dev, fr) -> int:
    """Box bounds on four coefficients plus one equality and one
    inequality linear constraint (IRLSM, lambda 0): every residual within
    1e-5, the constraints table printed; then ``alpha=[0, 0.5, 1.0]`` at
    lambda 1e-4: ``best_alpha`` and each fit's Gram launches (= its
    iterations). Returns the phase's Gram launches."""
    import torch

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _glm(fr, lambda_=0.0, beta_constraints=HIGGS_BOUNDS,
                 linear_constraints=HIGGS_LINEAR)
    con_s = time.perf_counter() - t0
    con_launches = _counts()["gram"]
    iters = model.output.scoring_history[-1]["iterations"]
    table = model.output.linear_constraints_table
    print(table, flush=True)
    c = model.coef()
    box = [(n, c[n], lo, hi) for n, lo, hi in zip(
        HIGGS_BOUNDS["names"], HIGGS_BOUNDS["lower_bounds"],
        HIGGS_BOUNDS["upper_bounds"])]
    residuals = [r[2] for r in table.cell_values]
    t0 = time.perf_counter()
    with _FitLaunches() as fl:
        best = _glm(fr, lambda_=1e-4, alpha=[0.0, 0.5, 1.0])
    alpha_s = time.perf_counter() - t0
    print("glm_constrained_higgs", json.dumps(dict(
        rows=fr.nrow, constrained_s=con_s, iterations=iters,
        gram_launches=con_launches, residuals=residuals,
        box=[[n, v] for n, v, _lo, _hi in box], alpha_list_s=alpha_s,
        best_alpha=best.best_alpha, alpha_fits=fl.fits)), flush=True)
    _check(con_launches == iters, f"glm_constrained_higgs: {con_launches} "
                                  f"Gram launches for {iters} iterations")
    _check(abs(residuals[0]) <= 1e-5 and residuals[1] <= 1e-5
           and all(r[3] for r in table.cell_values),
           f"glm_constrained_higgs: constraint residuals {residuals}")
    _check(all(lo - 1e-6 <= v <= hi + 1e-6 for _n, v, lo, hi in box),
           f"glm_constrained_higgs: bounds {box}")
    _check(len(fl.fits) == 3 and all(f["launches"] == f["iterations"]
                                     for f in fl.fits),
           f"glm_constrained_higgs: alpha fits {fl.fits}")
    _check(best.best_alpha in (0.0, 0.5, 1.0),
           f"glm_constrained_higgs: best_alpha {best.best_alpha}")
    return con_launches + sum(f["launches"] for f in fl.fits)


def _interaction_glm(train, valid, **kw):
    from h2o_tpu_torch import GLM, GLMParameters

    return GLM(GLMParameters(training_frame=train,
                             response_column="IsDepDelayed",
                             family="binomial", seed=42,
                             interaction_pairs=INTERACTION_PAIRS,
                             validation_frame=valid, **kw)).train_model()


def phase_glm_interactions_airlines(dev, train, valid) -> tuple[int, dict]:
    """``import_cv_glm``'s one-hot binomial GLM (no CV) on the imported
    train split with three interaction pairs — cat x cat (UniqueCarrier x
    Month, capped at 100 combos), cat x num (UniqueCarrier x Distance) and
    num x num (CRSDepTime x Distance): Gram launches = iterations, P and
    peak memory; validation AUC through the replayed interactions finite
    and above 0.6; a saved and loaded model predicting bit for bit alike;
    then the kernel against its plain version on the fit's own design.
    Returns the launches and that check."""
    import torch

    from h2o_tpu_torch import load_model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _GramInputs() as kept:
        model = _interaction_glm(train, valid)
    train_s = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    iters = model.output.scoring_history[-1]["iterations"]
    P = len(model.dinfo.expanded_names) + 1
    auc = model.output.validation_metrics.auc
    t0 = time.perf_counter()
    pred = model.predict(valid)
    predict_s = time.perf_counter() - t0
    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, "glm_interactions.bin")
    try:
        model.save(path)
        back = load_model(path, device=dev)
    finally:
        if os.path.exists(path):
            os.remove(path)
    same = all(torch.equal(a.data, b.data) for a, b in
               zip(pred.vecs, back.predict(valid).vecs))
    del pred, back
    X, W, z = kept.last
    shape = _gram_check(X, W, z, reps=3)
    del kept, X, W, z
    torch.cuda.empty_cache()
    print("glm_interactions_airlines", json.dumps(dict(
        train_rows=train.nrow, P=P, train_s=train_s, predict_s=predict_s,
        iterations=iters, launches=launches, valid_auc=auc,
        train_auc=model.output.training_metrics.auc, peak_mem_gb=peak,
        interaction_columns=len(model.dinfo.expanded_names) - 689,
        gram_at_path=shape)), flush=True)
    _check(launches["gram"] == iters and launches["flat"] == 0
           and launches["grouped"] == 0,
           f"glm_interactions_airlines: launches {launches} for {iters} "
           f"iterations")
    _check(bool(np.isfinite(auc)) and auc > 0.6,
           f"glm_interactions_airlines: validation AUC {auc}")
    _check(same, "glm_interactions_airlines: the loaded model predicts "
                 "differently")
    _check(peak <= 60.0, f"glm_interactions_airlines: peak {peak:.1f} GiB")
    return launches["gram"], shape


def _hglm_frame(fr, seed: int = 300):
    """Distance, CRSDepTime, DayOfWeek and Origin of an airlines frame, and
    a gaussian response ``y`` drawn on the host: 1 + 0.5 z(Distance) - 0.3
    z(CRSDepTime) + u[Origin] + e, u normal per Origin level (300) scaled
    to a mean square of exactly 0.6^2, e normal per row scaled to a mean
    square of exactly 1, so the draw's variances are the nominal ones;
    rows whose Distance or CRSDepTime is NA take its mean. Returns the
    frame and the draw's variances (mean u^2, mean e^2)."""
    from h2o_tpu_torch import Vec

    rng = np.random.default_rng(seed)
    origin = fr.vec("Origin").to_numpy().astype(np.int64)
    q = len(fr.vec("Origin").domain)
    u = rng.normal(size=q)
    u *= 0.6 / np.sqrt(np.mean(u * u))
    e = rng.normal(size=fr.nrow)
    e /= np.sqrt(np.mean(e * e))

    def z(name):
        x = fr.vec(name).to_numpy().astype(np.float64)
        x = np.where(np.isnan(x), np.nanmean(x), x)
        return (x - x.mean()) / x.std()

    y = 1.0 + 0.5 * z("Distance") - 0.3 * z("CRSDepTime") + u[origin] + e
    out = _columns(fr, ["Distance", "CRSDepTime", "DayOfWeek", "Origin"])
    out.add("y", Vec.from_numpy(y.astype(np.float32), device=fr.device))
    return out, float(np.mean(u * u)), float(np.mean(e * e))


def _hglm(fr):
    from h2o_tpu_torch import GLM, GLMParameters

    return GLM(GLMParameters(training_frame=fr, response_column="y",
                             family="gaussian", HGLM=True,
                             random_columns=["Origin"],
                             seed=42)).train_model()


def phase_hglm_airlines(dev, train) -> None:
    """HGLM on the imported train split with a response drawn on it
    (``_hglm_frame``): no kernel launch (its cross products are float64
    products and ``index_add_`` sums, as the reference's are plain
    einsums), ``varfix`` and ``varranef`` within 10% of the draw's
    variances, 1.0 and 0.36."""
    import torch

    fr, var_u, var_e = _hglm_frame(train)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _hglm(fr)
    train_s = time.perf_counter() - t0
    launches = _counts()
    print("hglm_airlines", json.dumps(dict(
        rows=fr.nrow, train_s=train_s, launches=launches,
        iterations=model.output.scoring_history[-1]["iterations"],
        varfix=model.varfix, varranef=model.varranef, draw_var_e=var_e,
        draw_var_u=var_u, levels=len(model.random_domain),
        rmse=model.output.training_metrics.rmse)), flush=True)
    _check(sum(launches.values()) == 0, f"hglm_airlines: launches {launches}")
    _check(abs(model.varfix - var_e) <= 0.1 * var_e,
           f"hglm_airlines: varfix {model.varfix}, the draw's {var_e}")
    _check(abs(model.varranef - var_u) <= 0.1 * var_u,
           f"hglm_airlines: varranef {model.varranef}, the draw's {var_u}")


def _ordinal(fr):
    from h2o_tpu_torch import GLM, GLMParameters

    return GLM(GLMParameters(training_frame=fr, response_column="Cover_Type",
                             family="ordinal", seed=42)).train_model()


def phase_glm_ordinal_covtype(dev, fr) -> None:
    """The ordinal family on the covertype-shaped frame, its 7 classes
    taken as ordered: full-batch Adam, no kernel launch; thresholds
    strictly increasing, mean per-class error below 6/7; steps and wall."""
    import torch

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _ordinal(fr)
    train_s = time.perf_counter() - t0
    launches = _counts()
    th = np.asarray(model.thresholds)
    m = model.output.training_metrics
    print("glm_ordinal_covtype", json.dumps(dict(
        rows=fr.nrow, train_s=train_s,
        steps=model.output.scoring_history[-1]["iterations"],
        launches=launches, thresholds=th.tolist(), logloss=m.logloss,
        mean_per_class_error=m.mean_per_class_error)), flush=True)
    _check(sum(launches.values()) == 0,
           f"glm_ordinal_covtype: kernel launches {launches}")
    _check(bool(np.all(np.diff(th) > 0)),
           f"glm_ordinal_covtype: thresholds {th}")
    _check(m.mean_per_class_error < 6 / 7,
           f"glm_ordinal_covtype: mean per-class error "
           f"{m.mean_per_class_error}")


def _with_reg(fr, seed: int = 28):
    """The HIGGS features and a gaussian response drawn on the host:
    0.5 f0 - 0.25 f3 + 0.3 f6 + N(0, 1)."""
    from h2o_tpu_torch import Vec

    e = np.random.default_rng(seed).normal(size=fr.nrow)
    reg = (0.5 * fr.vec("f0").to_numpy() - 0.25 * fr.vec("f3").to_numpy()
           + 0.3 * fr.vec("f6").to_numpy() + e).astype(np.float32)
    out = _columns(fr, [f"f{j}" for j in range(HIGGS_F)])
    out.add("reg", Vec.from_numpy(reg, device=fr.device))
    return out


def _columns(fr, names):
    """The named columns of ``fr`` as a frame of their own (no copy). The
    builders over GLM are given such frames, not ``ignored_columns``: their
    sub-fits replace the user's ignored columns by the other terms, in the
    reference as here (ROADMAP Queue 3 item 22)."""
    from h2o_tpu_torch import Frame

    return Frame(list(names), [fr.vec(n) for n in names])


def _anova(fr):
    from h2o_tpu_torch import ANOVAGLM, ANOVAGLMParameters

    return ANOVAGLM(ANOVAGLMParameters(
        training_frame=_columns(fr, [f"f{j}" for j in range(5)]
                                + ["response"]),
        response_column="response", family="binomial", lambda_=0.0,
        seed=42)).train_model()


def _maxr(fr):
    from h2o_tpu_torch import ModelSelection, ModelSelectionParameters

    return ModelSelection(ModelSelectionParameters(
        training_frame=fr, response_column="reg", family="gaussian",
        mode="maxr", seed=42)).train_model()


def _backward(fr):
    from h2o_tpu_torch import ModelSelection, ModelSelectionParameters

    return ModelSelection(ModelSelectionParameters(
        training_frame=_columns(fr, [f"f{j}" for j in range(8)]
                                + ["response"]),
        response_column="response", family="binomial", mode="backward",
        p_values_threshold=0.05, seed=42)).train_model()


def phase_anova_modelselection_higgs(dev, higgs) -> tuple[int, dict]:
    """ANOVA GLM over 5 HIGGS predictors with their pairs (15 terms, 16
    binomial fits) at 2M rows; ModelSelection ``maxr`` (gaussian, a drawn
    response on f0, f3, f6) over all 28 predictors at 11M rows — one Gram
    launch of [X | 1 | y] in its z = None form, then held against the
    plain version on those inputs; ``backward`` (binomial) over 8
    predictors at 1M rows with a ``p_values_threshold``. Launches = the
    fits' IRLS iterations + 1. Returns the launches and the sweep Gram's
    check."""
    import torch

    from h2o_tpu_torch.backend.kernels import gram
    from h2o_tpu_torch.models import modelselection

    out = {}
    _reset_counts()
    sub = higgs.take(np.arange(ANOVA_ROWS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _FitLaunches() as fl:
        anova = _anova(sub)
    out["anova"] = dict(rows=sub.nrow, fits=len(fl.fits),
                        wall_s=time.perf_counter() - t0,
                        launches=sum(f["launches"] for f in fl.fits),
                        iterations=sum(f["iterations"] for f in fl.fits),
                        table=[[r["term"], r["df"], r["deviance"],
                                r["p_value"]] for r in anova.result()])
    del sub
    reg = _with_reg(higgs)
    n0 = _counts()["gram"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _GramInputs(modelselection) as kept:
        maxr = _maxr(reg)
    sweep_s = time.perf_counter() - t0
    best3 = next(r["predictors"] for r in maxr.result()
                 if len(r["predictors"]) == 3)
    out["maxr"] = dict(rows=reg.nrow, wall_s=sweep_s,
                       launches=_counts()["gram"] - n0,
                       sizes=len(maxr.result()), best3=best3,
                       r2=[r["r2"] for r in maxr.result()][:5])
    Z, w, _ = kept.last
    n_path = gram.GRAM_LAUNCHES
    shape = _gram_check(Z, w, None, reps=5)
    gram.GRAM_LAUNCHES = n_path   # the check's launches are not the path's
    del kept, Z, w, reg
    torch.cuda.empty_cache()
    sub = higgs.take(np.arange(BACKWARD_ROWS))
    t0 = time.perf_counter()
    with _FitLaunches() as fb:
        back = _backward(sub)
    out["backward"] = dict(rows=sub.nrow, wall_s=time.perf_counter() - t0,
                           fits=len(fb.fits),
                           launches=sum(f["launches"] for f in fb.fits),
                           iterations=sum(f["iterations"] for f in fb.fits),
                           subsets=[r["predictors"] for r in back.result()])
    del sub
    launches = _counts()
    out.update(launches=launches, sweep_gram=shape)
    print("anova_modelselection_higgs", json.dumps(out), flush=True)
    tbl = {r["term"]: r for r in anova.result()}
    _check(len(tbl) == 15 and out["anova"]["fits"] == 16,
           f"anova: {len(tbl)} terms, {out['anova']['fits']} fits")
    _check(tbl["f0"]["p_value"] < 1e-6, f"anova: f0 p-value "
                                        f"{tbl['f0']['p_value']}")
    _check(out["anova"]["launches"] == out["anova"]["iterations"],
           f"anova: {out['anova']}")
    _check(out["maxr"]["launches"] == 1 and set(best3) == {"f0", "f3", "f6"},
           f"maxr: {out['maxr']}")
    _check(out["backward"]["launches"] == out["backward"]["iterations"]
           and len(back.result()) == 8, f"backward: {out['backward']}")
    want = (out["anova"]["launches"] + 1 + out["backward"]["launches"])
    _check(launches["gram"] == want and launches["flat"] == 0
           and launches["grouped"] == 0,
           f"anova_modelselection_higgs: launches {launches}, want {want}")
    return launches["gram"], shape


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


def phase_glm_rest_card_vs_cpu(dev, air) -> int:
    """Every option of this slice at 50,000 rows on the card and on the
    CPU: coefficients within 1e-4 x max(1, |beta|) (IRLSM with p-values,
    L_BFGS, box and linear constraints, the alpha list, gamma and tweedie
    with ``ml`` dispersion, interactions, the ordinal family); std errors
    and p-values within 1e-5 relative (p-values below 1e-7 within 1e-12
    absolute), dispersion estimates within 1e-5 relative; HGLM's variance
    components within 1e-5 relative; the same ANOVA terms (each LR
    statistic within 1e-6 of its reduced model's deviance, each p-value
    inside the band that tolerance puts on the CPU's: a weak term's LR is
    a difference of two float32 sums of ~1e5, so its p-value moves by up
    to ~1e-2) and the same ModelSelection subsets. Returns the card's Gram
    launches."""
    from h2o_tpu_torch import GLM, GLMParameters

    rows = GLM_REST_ROWS
    out, launches = {}, 0
    higgs = {d: _higgs_frame(rows, d) for d in (dev, "cpu")}
    opt = {d: _higgs_option_frame(rows, d) for d in (dev, "cpu")}
    airs = {dev: air, "cpu": _cpu_frame(air)}
    cov = {d: _covtype_frame(rows, d) for d in (dev, "cpu")}

    def pair(name, make, frames):
        nonlocal launches
        fits, secs = {}, {}
        for d, fr in frames.items():
            _reset_counts()
            t0 = time.perf_counter()
            fits[d] = make(fr)
            secs[d] = time.perf_counter() - t0
            if d != "cpu":
                launches += _counts()["gram"]
        a, b = fits[dev], fits["cpu"]
        row = dict(card_s=secs[dev], cpu_s=secs["cpu"])
        if hasattr(a, "beta"):
            ba, bb = np.asarray(a.beta), np.asarray(b.beta)
            row["coef_max_rel_err"] = _rel(ba, bb)
            _check(row["coef_max_rel_err"] <= GLM_COEF_TOL,
                   f"glm_rest {name}: coefficients off by "
                   f"{row['coef_max_rel_err']:.3g}")
        out[name] = row
        return a, b, row

    def opt_glm(family, **kw):
        def make(fr):
            return GLM(GLMParameters(
                training_frame=fr, response_column="pos", family=family,
                lambda_=0.0, dispersion_parameter_method="ml", seed=42,
                ignored_columns=[n for n in fr.names if n.startswith("q")]
                + ["reg"], **kw)).train_model()
        return make

    a, b, row = pair("p_values", lambda fr: _glm(
        fr, lambda_=0.0, compute_p_values=True), higgs)
    names = list(b.p_values)
    for k in ("std_errs", "p_values"):
        va = np.array([getattr(a, k)[n] for n in names])
        vb = np.array([getattr(b, k)[n] for n in names])
        err = np.abs(va - vb)
        row[f"{k}_max_rel_err"] = float(np.max(err / np.maximum(vb, 1e-300)))
        ok = (err <= 1e-5 * vb) | ((vb < 1e-7) & (err <= 1e-12))
        _check(bool(ok.all()), f"glm_rest {k}: {row}")
    pair("lbfgs", lambda fr: _glm(fr, lambda_=0.0, solver="L_BFGS"), higgs)
    pair("constrained", lambda fr: _glm(
        fr, lambda_=0.0, beta_constraints=HIGGS_BOUNDS,
        linear_constraints=HIGGS_LINEAR), higgs)
    a, b, row = pair("alpha_list", lambda fr: _glm(
        fr, lambda_=1e-4, alpha=[0.0, 0.5, 1.0]), higgs)
    _check(a.best_alpha == b.best_alpha, f"glm_rest alpha: {a.best_alpha} "
                                         f"against {b.best_alpha}")
    for fam, kw in (("gamma", {}), ("tweedie",
                                    dict(tweedie_variance_power=1.5))):
        a, b, row = pair(f"{fam}_ml", opt_glm(fam, **kw), opt)
        row["dispersion"] = [a.dispersion_estimated, b.dispersion_estimated]
        _check(abs(a.dispersion_estimated - b.dispersion_estimated)
               <= 1e-5 * b.dispersion_estimated,
               f"glm_rest {fam} ml dispersion: {row['dispersion']}")
    a, b, row = pair("interactions", lambda fr: _interaction_glm(fr, None),
                     airs)
    row["P"] = len(b.dinfo.expanded_names) + 1
    hg = {d: _hglm_frame(fr)[0] for d, fr in airs.items()}
    a, b, row = pair("hglm", _hglm, hg)
    row.update(varfix=[a.varfix, b.varfix], varranef=[a.varranef,
                                                      b.varranef])
    for k in ("varfix", "varranef"):
        _check(abs(getattr(a, k) - getattr(b, k)) <= 1e-5 * getattr(b, k),
               f"glm_rest hglm {k}: {row[k]}")
    a, b, row = pair("ordinal", _ordinal, cov)
    row["steps"] = [m.output.scoring_history[-1]["iterations"]
                    for m in (a, b)]
    _check(_rel(a.thresholds, b.thresholds) <= GLM_COEF_TOL,
           f"glm_rest ordinal thresholds: {a.thresholds} against "
           f"{b.thresholds}")
    a, b, row = pair("anova", _anova, higgs)
    ta, tb = a.result(), b.result()
    _check([r["term"] for r in ta] == [r["term"] for r in tb]
           and [r["df"] for r in ta] == [r["df"] for r in tb],
           "glm_rest anova: terms differ")
    # each LR statistic is a difference of two float32 deviance sums, the
    # reduced one the larger: within 1e-6 of it; a p-value follows from
    # its LR, so the card's must lie between the CPU's LR's p-values at
    # the ends of that band
    from h2o_tpu_torch.models.anovaglm import chi2_sf

    full = b.full_model.output.training_metrics.residual_deviance
    row["lr_max_err"] = max(abs(x["deviance"] - y["deviance"]) / (
        full + y["deviance"]) for x, y in zip(ta, tb))
    row["p_max_err"] = max(abs(x["p_value"] - y["p_value"])
                           for x, y in zip(ta, tb))
    band = [(chi2_sf(y["deviance"] + 1e-6 * (full + y["deviance"]),
                     y["df"]) - 1e-12,
             chi2_sf(max(y["deviance"] - 1e-6 * (full + y["deviance"]), 0.0),
                     y["df"]) + 1e-12) for y in tb]
    _check(row["lr_max_err"] <= 1e-6
           and all(lo <= x["p_value"] <= hi
                   for x, (lo, hi) in zip(ta, band)),
           f"glm_rest anova: {row}")
    regs = {d: _with_reg(fr) for d, fr in higgs.items()}
    for name, make, frames in (("maxr", _maxr, regs),
                               ("backward", _backward, higgs)):
        a, b, row = pair(name, make, frames)
        sa = [r["predictors"] for r in a.result()]
        sb = [r["predictors"] for r in b.result()]
        row["sizes"] = len(sa)
        _check(sa == sb, f"glm_rest {name}: subsets differ")
        ca = np.array([v for r in a.result() for v in r["coefs"].values()])
        cb = np.array([v for r in b.result() for v in r["coefs"].values()])
        row["coef_max_rel_err"] = _rel(ca, cb)
        _check(row["coef_max_rel_err"] <= GLM_COEF_TOL,
               f"glm_rest {name}: coefficients off by "
               f"{row['coef_max_rel_err']:.3g}")
    print("glm_rest_card_vs_cpu", json.dumps(dict(
        rows=rows, fits=out, card_gram_launches=launches)), flush=True)
    return launches


GAM_COLUMNS = ["f1", "f2", "f4"]   # bench.py:588's gam columns
#: gam_higgs' second fit: thin plate, monotone I-splines and P-splines, one
#: column each; the I-splines on f0, the response's strongest column (f1,
#: f2 and f4 are noise in the generator, so a monotone smooth there is
#: flat). Each smooth at penalty scale 1,000: at 1 the thin plate's Gram
#: is near-singular, and on 100,000 rows a 1e-6 relative change of the
#: Gram's sums moved the predictions by up to 1.5e-3 (a CPU experiment;
#: ROADMAP Queue 3 item 26), so no card could be held to the CPU there
GAM_BS = dict(gam_columns=["f1", "f0", "f4"], bs=[1, 2, 3],
              scale=[1000.0] * 3)
SLICE_CPU_ROWS = 98_304            # gam_rulefit_coxph_card_vs_cpu: rows (3 x
                                   # 2^15: the CPU's streamed RuleFit keeps
                                   # the reference's power-of-two blocks,
                                   # 32,768 rows here, 256 at 100,000)
RULEFIT_CPU_TREES = 10             # gam_rulefit_coxph_card_vs_cpu: RuleFit's
                                   # trees (50 in rulefit_higgs; the CPU's
                                   # plain histogram takes ~0.1 s a level)
COXPH_ROWS = 1_000_000             # coxph_survival: the survival frame
COXPH_BETA = (0.5, -0.4, 0.3, -0.2, 0.1, 0.0, 0.25, -0.15, 0.05, -0.3)
COXPH_CAT_BETA = (0.2, -0.1, 0.3, -0.25)   # levels c1..c4 against c0
COXPH_RATES = (2.7e-4, 4e-4, 2e-4, 3.3e-4)  # baseline hazard a day, stratum
COXPH_TOL = 1e-5                   # card vs CPU: coefficients, baseline


def _survival_cols(nrow: int, seed: int = 2000):
    """A survival frame with known coefficients: 10 standard normal
    covariates, a 5-level categorical ``c`` and a 4-level stratum, event
    times exponential at each stratum's baseline rate times exp(lp),
    censored uniformly over 3,000 days and at the 2,000-day end of
    follow-up, rounded up to whole days (so Efron's tie groups are large;
    about 35% events)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(nrow, 10)).astype(np.float32)
    cat = rng.integers(0, 5, nrow)
    strat = rng.integers(0, 4, nrow)
    lp = (X.astype(np.float64) @ np.asarray(COXPH_BETA)
          + np.concatenate([[0.0], COXPH_CAT_BETA])[cat])
    t = rng.exponential(1.0 / (np.asarray(COXPH_RATES)[strat] * np.exp(lp)))
    end = np.minimum(rng.uniform(0.0, 3000.0, nrow), 2000.0)
    cols = {f"x{j}": X[:, j] for j in range(10)}
    cols["time"] = np.clip(np.ceil(np.minimum(t, end)), 1, 2000).astype(
        np.float32)
    cols["event"] = (t <= end).astype(np.float32)
    return cols, cat, strat


def _survival_frame(nrow: int, device):
    from h2o_tpu_torch import Frame, Vec
    from h2o_tpu_torch.frame.vec import T_CAT

    cols, cat, strat = _survival_cols(nrow)
    fr = Frame.from_dict(cols, device=device)
    fr.add("c", Vec.from_numpy(cat, type=T_CAT, device=device,
                               domain=[f"c{i}" for i in range(5)]))
    fr.add("stratum", Vec.from_numpy(strat, type=T_CAT, device=device,
                                     domain=[f"s{i}" for i in range(4)]))
    return fr


def _coxph(fr):
    from h2o_tpu_torch import CoxPH, CoxPHParameters

    return CoxPH(CoxPHParameters(
        training_frame=fr, response_column="event", stop_column="time",
        stratify_by=["stratum"], ties="efron")).train_model()


def _gam(fr, **kw):
    """``bench.py:bench_gam``'s fit: binomial, IRLSM, seed 42, cr bases at
    8 knots on f1, f2 and f4, every other parameter at its default."""
    from h2o_tpu_torch import GAM, GAMParameters

    kw = dict(dict(gam_columns=GAM_COLUMNS), **kw)
    return GAM(GAMParameters(training_frame=fr, response_column="response",
                             family="binomial", solver="IRLSM", seed=42,
                             **kw)).train_model()


def _rulefit(fr, ntrees: int = 50):
    """``bench.py:bench_rulefit``'s fit: rules and linear terms, rule
    length 3 to 3 (one DRF of ``ntrees`` depth-3 trees), seed 42."""
    from h2o_tpu_torch import RuleFit, RuleFitParameters

    return RuleFit(RuleFitParameters(
        training_frame=fr, response_column="response",
        model_type="rules_and_linear", min_rule_length=3, max_rule_length=3,
        rule_generation_ntrees=ntrees, seed=42)).train_model()


def _gam_identified(model) -> np.ndarray:
    """GAM coefficients with each cr / B-spline block's mean removed: those
    bases sum to one in every row, so with the intercept the design is
    rank-deficient along each block's all-ones direction, whose share is
    rounding noise over the solve's 1e-8 ridge (ROADMAP Queue 3 item 26)."""
    b = np.asarray(model.beta, np.float64).copy()
    off = len(model.dinfo.expanded_names)
    for spec in model.gam_specs:
        k = len(spec["col_means"])
        if int(spec["bs"]) in (0, 3):
            b[off:off + k] -= b[off:off + k].mean()
        off += k
    return b


def _gam_smooths(model, fr) -> list:
    """Each gam column's fitted smooth (its centred basis times its
    coefficient block) over the frame's rows, what a block's coefficients
    determine whatever its conditioning, with its absolute mass (the sum
    of |basis x coefficient|: a thin plate's terms cancel)."""
    X = model.adapt_frame(fr)[:fr.nrow].double().cpu().numpy()
    beta = np.asarray(model.beta, np.float64)
    out, off = [], len(model.dinfo.expanded_names)
    for spec in model.gam_specs:
        k = len(spec["col_means"])
        B, b = X[:, off:off + k], beta[off:off + k]
        out.append((B @ b, np.abs(B) @ np.abs(b)))
        off += k
    return out


def _gam_host_eta(model, fr, n: int) -> np.ndarray:
    """The linear predictor of the first ``n`` rows from the standalone
    scorer's numpy bases (``mojo/format.py``), in float64 on the host."""
    from h2o_tpu_torch.mojo.format import gam_basis

    beta = np.asarray(model.beta, np.float64)
    X, _ = model.dinfo.expand(fr)
    P = X.shape[1]
    eta = X[:n].double().cpu().numpy() @ beta[:P] + beta[-1]
    off = P
    for spec in model.gam_specs:
        B = gam_basis(fr.vec(spec["column"]).to_numpy()[:n], spec)
        B = B - np.asarray(spec["col_means"])[None, :]
        eta = eta + B @ beta[off:off + B.shape[1]]
        off += B.shape[1]
    return eta


def phase_gam_higgs(dev, fr) -> tuple[int, dict]:
    """``bench.py:bench_gam`` on the 11M HIGGS frame (cr bases at 8 knots on
    f1, f2, f4), then thin plate on f1, monotone I-splines on f0 and
    P-splines on f4 (``GAM_BS``): Gram launches = IRLS iterations and no
    other kernel, residual below null deviance, training AUC finite and
    above 0.6; the first SLICE_CPU_ROWS rows' predictions, through the
    bases replayed on the card, within 1e-4 of the standalone scorer's
    numpy bases; the
    I-spline smooth non-decreasing over a grid of f0 (its coefficients
    non-negative, the predictions along the grid not falling); P, walls
    and peak memory. Then the Gram kernel against its plain version on
    the first fit's own design. Returns the launches and that check."""
    import torch

    from h2o_tpu_torch import Frame

    out, launches, shape = {}, 0, None
    n = SLICE_CPU_ROWS
    for name, kw in (("cr", {}), ("bs123", GAM_BS)):
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _GramInputs() as kept:
            model = _gam(fr, **kw)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = _counts()
        launches += counts["gram"]
        iters = model.output.scoring_history[0]["iterations"]
        m = model.output.training_metrics
        t0 = time.perf_counter()
        p1 = model.predict(fr).vec("ps").data[:n].double().cpu().numpy()
        predict_s = time.perf_counter() - t0
        host = 1.0 / (1.0 + np.exp(-_gam_host_eta(model, fr, n)))
        row = dict(rows=fr.nrow, P=len(model.beta), train_s=train_s,
                   predict_s=predict_s, iterations=iters, launches=counts,
                   auc=m.auc, residual_deviance=m.residual_deviance,
                   null_deviance=m.null_deviance,
                   replay_vs_numpy_max_abs_err=float(np.abs(p1 - host).max()),
                   peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        _check(counts["gram"] == iters and counts["flat"] == 0
               and counts["grouped"] == 0,
               f"gam_higgs {name}: launches {counts} for {iters} iterations")
        _check(m.residual_deviance < m.null_deviance,
               f"gam_higgs {name}: residual {m.residual_deviance} >= null "
               f"{m.null_deviance}")
        _check(bool(np.isfinite(m.auc)) and m.auc > 0.6,
               f"gam_higgs {name}: AUC {m.auc}")
        _check(row["replay_vs_numpy_max_abs_err"] <= 1e-4,
               f"gam_higgs {name}: replayed bases off by "
               f"{row['replay_vs_numpy_max_abs_err']}")
        if name == "cr":
            X, W, z = kept.last
            shape = _gram_check(X, W, z, reps=5)
            row["gram_at_path"] = shape
            del X, W, z
        else:
            # the I-spline block (f0): non-negative coefficients, and a
            # smooth that does not fall along a grid of f0
            off = len(model.dinfo.expanded_names)
            for spec in model.gam_specs:
                k = len(spec["col_means"])
                if spec["bs"] == 2:
                    mono = model.beta[off:off + k]
                off += k
            r = fr.vec("f0").rollups()
            g = np.linspace(r.mins, r.maxs, 400).astype(np.float32)
            cols = {c: np.zeros(400, np.float32) for c in fr.names
                    if c != "response"}
            cols["f0"] = g
            gp = model.predict(Frame.from_dict(cols, device=dev))
            gp = gp.vec("ps").data[:400].double().cpu().numpy()
            row["ispline_min_coef"] = float(mono.min())
            row["grid_min_step"] = float(np.diff(gp).min())
            _check(row["ispline_min_coef"] >= 0.0 and
                   row["grid_min_step"] >= -1e-6,
                   f"gam_higgs: the I-spline smooth falls: {row}")
        del kept
        out[name] = {k: v for k, v in row.items() if k != "gram_at_path"}
        del model
        torch.cuda.empty_cache()
    print("gam_higgs", json.dumps(dict(fits=out, gram_at_path=shape)),
          flush=True)
    return launches, shape


def _recount_rules(forests, depth: int) -> int:
    """Distinct root-to-node paths of exactly ``depth`` splits over the
    sub-forests' (T[, K], N) arrays: a node counts when every ancestor
    split (an independent walk of the heap, not ``extract_rules``)."""
    seen = set()
    for fo in forests:
        feat, thr, nanL = (fo[k].cpu().numpy() for k in ("feat", "thr",
                                                          "nanL"))
        feat, thr, nanL = (a.reshape(-1, a.shape[-1])
                           for a in (feat, thr, nanL))
        for t in range(feat.shape[0]):
            for node in range(2 ** depth - 1, 2 ** (depth + 1) - 1):
                path, n = [], node
                while n > 0:
                    p = (n - 1) // 2
                    if feat[t, p] < 0:
                        break
                    path.append((int(feat[t, p]), "<=" if n == 2 * p + 1
                                 else ">", float(thr[t, p]),
                                 bool(nanL[t, p])))
                    n = p
                else:
                    seen.add(tuple(reversed(path)))
    return len(seen)


class _RuleForests:
    """While open, keeps the sub-forests RuleFit extracts its rules from."""

    def __enter__(self):
        from h2o_tpu_torch.models import rulefit

        self.forests, self.orig = [], rulefit.extract_rules

        def kept(forest, *a):
            self.forests.append(forest)
            return self.orig(forest, *a)
        rulefit.extract_rules = kept
        return self

    def __exit__(self, *exc):
        from h2o_tpu_torch.models import rulefit

        rulefit.extract_rules = self.orig


def phase_rulefit_higgs(dev, fr) -> tuple[dict, dict]:
    """``bench.py:bench_rulefit`` on the 11M HIGGS frame: 50 depth-3 DRF
    trees, rules of length 3 and the 28 linear terms, the L1 path over
    the streamed design (11M x ~430 is past the 2^29-cell budget): the
    streamed path taken, flat launches = trees x 3 levels, Gram launches =
    IRLS steps x blocks per step and no grouped launch, as many rules as
    the forest has distinct depth-3 paths (recounted independently),
    every support in [0, 1], training AUC finite and above 0.6; walls,
    lambdas walked, steps, block rows and peak memory. Then the Gram kernel
    against its plain version on the first streamed block's own design,
    IRLS weights and working response. Returns the launches by kernel and
    that check."""
    import torch

    from h2o_tpu_torch.models import rulefit

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _GramInputs(rulefit, first=True) as kept, _RuleForests() as rf:
        model = _rulefit(fr)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = _counts()
    plen = fr.vec(0).plen
    blocks = -(-plen // model.stream_block_rows)
    trees = sum(int(np.prod(f["feat"].shape[:-1])) for f in rf.forests)
    sup = np.array([r.support for r in model.rules])
    m = model.output.training_metrics
    want_rules = _recount_rules(rf.forests, 3)
    X, W, z = kept.last
    shape = _gram_check(X, W, z, reps=5)
    del kept, X, W, z
    out = dict(rows=fr.nrow, train_s=train_s, stream=model.stream,
               rules=len(model.rules), recounted_rules=want_rules,
               linear_terms=len(model.lin_names), P=len(model.beta),
               trees=trees, block_rows=model.stream_block_rows,
               blocks_per_step=blocks, steps=model.stream_steps,
               lambdas_walked=model.lambdas_walked,
               lambda_used=model.lambda_used, launches=counts,
               nonzero=int(np.sum(np.abs(model.beta) > 0)), auc=m.auc,
               support_range=[float(sup.min()), float(sup.max())],
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               gram_at_path=shape)
    print("rulefit_higgs", json.dumps(out), flush=True)
    _check(model.stream, "rulefit_higgs: the streamed path was not taken")
    _check(counts["flat"] == trees * 3 and counts["grouped"] == 0,
           f"rulefit_higgs: {counts} for {trees} depth-3 trees")
    _check(counts["gram"] == model.stream_steps * blocks,
           f"rulefit_higgs: {counts['gram']} Gram launches for "
           f"{model.stream_steps} steps of {blocks} blocks")
    _check(len(model.rules) == want_rules and all(
        len(r.conds) == 3 for r in model.rules),
        f"rulefit_higgs: {len(model.rules)} rules, {want_rules} paths")
    _check(bool(np.all((sup >= 0) & (sup <= 1))),
           f"rulefit_higgs: supports {out['support_range']}")
    _check(bool(np.isfinite(m.auc)) and m.auc > 0.6,
           f"rulefit_higgs: AUC {m.auc}")
    del model
    torch.cuda.empty_cache()
    return counts, shape


class _CoxPasses:
    """While open, records each Newton pass's log-likelihood."""

    def __enter__(self):
        from h2o_tpu_torch.models import coxph

        self.ll, self.orig = [], coxph._cox_pass

        def kept(*a):
            out = self.orig(*a)
            self.ll.append(float(out[0]))
            return out
        coxph._cox_pass = kept
        return self

    def __exit__(self, *exc):
        from h2o_tpu_torch.models import coxph

        coxph._cox_pass = self.orig


def phase_coxph_survival(dev) -> tuple[int, dict]:
    """CoxPH (Efron ties, 4 strata) on the 1,000,000-row survival frame
    (``_survival_cols``), twice: the two fits bit-equal (coefficients and
    log-likelihood), Gram launches = 2 x Newton passes and no other
    kernel, the log-likelihood rising pass by pass, every coefficient
    within 0.05 of its true value, concordance above 0.5, each stratum's
    cumulative baseline hazard non-decreasing, and ``survfit`` curves in
    [0, 1] that do not rise; walls, passes, events and peak memory. Then
    the Gram kernel against its plain version on a Newton pass's own
    design and risk weights (z = None). Returns the first fit's launches
    and that check."""
    import torch

    from h2o_tpu_torch.models import coxph

    fr = _survival_frame(COXPH_ROWS, dev)
    fits, walls, lls, launches = [], [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _GramInputs(coxph, first=True) as kept, _CoxPasses() as passes:
            fits.append(_coxph(fr))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(_counts())
        lls.append(passes.ll)
    a, b = fits
    X, W, _ = kept.last
    shape = _gram_check(X, W, None, reps=5)
    del kept, X, W
    tm = a.output.training_metrics
    names = list(a.coefficients)
    truth = dict(zip([f"c.c{i}" for i in range(1, 5)], COXPH_CAT_BETA))
    truth.update({f"x{j}": v for j, v in enumerate(COXPH_BETA)})
    err = {k: abs(a.coefficients[k] - truth[k]) for k in names}
    bh_ok = all(bool(np.all(np.diff(h) >= 0)) for _, h in a.baseline.values())
    sub = fr.take(np.arange(5))
    sf = a.survfit(sub)
    curves = np.stack([sf.vec(c).to_numpy() for c in sf.names[1:]])
    ll = lls[0]
    out = dict(rows=fr.nrow, events=tm.n_events, fit_s=walls,
               passes=a.newton_passes, launches=launches[0], loglik=ll,
               coefficients={k: float(v) for k, v in a.coefficients.items()},
               max_coef_err=max(err.values()), concordance=tm.concordance,
               strata=len(a.baseline), survfit_times=int(curves.shape[1]),
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               gram_at_path=shape)
    print("coxph_survival", json.dumps(out), flush=True)
    _check(all(a.coefficients[k] == b.coefficients[k] for k in names)
           and tm.loglik == b.output.training_metrics.loglik
           and lls[0] == lls[1],
           "coxph_survival: two fits at one seed differ")
    _check(launches[0]["gram"] == 2 * a.newton_passes
           and launches[0]["flat"] == launches[0]["grouped"] == 0,
           f"coxph_survival: {launches[0]} for {a.newton_passes} passes")
    _check(all(y >= x - 1e-9 * abs(x) for x, y in zip(ll, ll[1:]))
           and ll[-1] > ll[0], f"coxph_survival: log-likelihoods {ll}")
    _check(out["max_coef_err"] <= 0.05, f"coxph_survival: {err}")
    _check(tm.concordance > 0.5, f"coxph_survival: concordance "
                                 f"{tm.concordance}")
    _check(bh_ok and len(a.baseline) == 4,
           "coxph_survival: a cumulative baseline hazard falls")
    _check(bool(np.all((curves >= 0) & (curves <= 1))
                and np.all(np.diff(curves, axis=1) <= 0)),
           "coxph_survival: survfit curves")
    return launches[0]["gram"], shape


def phase_gam_rulefit_coxph_card_vs_cpu(dev) -> dict:
    """SLICE_CPU_ROWS rows on the card and on the CPU. GAM, both of
    ``gam_higgs``' fits: iterations within one, predictions within 1e-4; the cr
    fit's coefficients within 1e-4 x max(1, |beta|), each cr block with its
    mean removed (``_gam_identified``); the second fit's linear coefficients
    and intercept likewise, and each smooth's values within 1e-4 x max(1, its
    absolute mass) at every row (``_gam_smooths``: its thin plate's Gram is
    near-singular and its I-splines' COD runs in float32, so their coefficients
    are held through what they fit). RuleFit at ``rulefit_higgs``' settings
    with RULEFIT_CPU_TREES trees, on the built design and streamed (the cell
    budget lowered to 1 inside the phase): the same rules, rule arrays,
    memberships and supports, exactly; the same lambdas (the built path's last
    within a relative 1e-4, the streamed path's count and steps equal);
    coefficients within 1e-4 x max(1, |beta|). CoxPH on the survival frame:
    coefficients within 1e-5 x max(1, |beta|), the log-likelihood within a
    relative 1e-6, the baseline hazard within a relative 1e-5 at the same
    times. Returns the card's launches."""
    import torch

    from h2o_tpu_torch.models import rulefit

    rows = SLICE_CPU_ROWS
    higgs = {d: _higgs_frame(rows, d) for d in (dev, "cpu")}
    out, launches = {}, dict(gram=0, flat=0, grouped=0)

    def pair(name, make, frames):
        fits, secs = {}, {}
        for d, fr in frames.items():
            _reset_counts()
            t0 = time.perf_counter()
            fits[d] = make(fr)
            secs[d] = time.perf_counter() - t0
            if d != "cpu":
                for k, v in _counts().items():
                    launches[k] += v
        out[name] = dict(card_s=secs[dev], cpu_s=secs["cpu"])
        return fits[dev], fits["cpu"], out[name]

    for name, kw in (("gam_cr", {}), ("gam_bs123", GAM_BS)):
        a, b, row = pair(name, lambda fr: _gam(fr, **kw), higgs)
        row["iterations"] = [m.output.scoring_history[0]["iterations"]
                             for m in (a, b)]
        row["coef_max_rel_err"] = _rel(_gam_identified(a),
                                       _gam_identified(b))
        pa = a.predict(higgs[dev]).vec("ps").data[:rows].cpu().numpy()
        pb = b.predict(higgs["cpu"]).vec("ps").data[:rows].numpy()
        row["pred_max_abs_err"] = float(np.abs(pa - pb).max())
        # the stopping test compares a float32-rounded step with
        # beta_epsilon: a count may end one iteration apart
        _check(abs(row["iterations"][0] - row["iterations"][1]) <= 1,
               f"card_vs_cpu {name}: iterations {row['iterations']}")
        _check(row["pred_max_abs_err"] <= GLM_PRED_TOL,
               f"card_vs_cpu {name}: predictions {row}")
        if name == "gam_cr":
            _check(row["coef_max_rel_err"] <= GLM_COEF_TOL,
                   f"card_vs_cpu {name}: coefficients {row}")
        else:
            # the thin plate's Gram is near-singular and the I-splines' COD
            # runs in float32: the linear terms and the intercept by their
            # coefficients, each smooth by its values
            lin = np.r_[0:len(a.dinfo.expanded_names), len(a.beta) - 1]
            row["coef_max_rel_err"] = _rel(np.asarray(a.beta)[lin],
                                           np.asarray(b.beta)[lin])
            row["smooth_max_rel_mass"] = max(
                float((np.abs(x - y) / np.maximum(1.0, mass)).max())
                for (x, _), (y, mass) in zip(_gam_smooths(a, higgs[dev]),
                                             _gam_smooths(b, higgs["cpu"])))
            _check(row["coef_max_rel_err"] <= GLM_COEF_TOL
                   and row["smooth_max_rel_mass"] <= GLM_COEF_TOL,
                   f"card_vs_cpu {name}: coefficients {row}")
    old = rulefit._STREAM_CELL_BUDGET
    for name, budget in (("rulefit_built", old), ("rulefit_streamed", 1)):
        rulefit._STREAM_CELL_BUDGET = budget
        try:
            a, b, row = pair(name, lambda fr: _rulefit(
                fr, RULEFIT_CPU_TREES), higgs)
        finally:
            rulefit._STREAM_CELL_BUDGET = old
        _check(a.stream == b.stream == (budget == 1),
               f"card_vs_cpu {name}: streamed {a.stream}, {b.stream}")
        _check([r.conds for r in a.rules] == [r.conds for r in b.rules]
               and all(torch.equal(x, y) for x, y in zip(a.rule_arrays,
                                                         b.rule_arrays)),
               f"card_vs_cpu {name}: rules differ")
        ma = rulefit.eval_rules(higgs[dev].as_matrix(a.output.names),
                                *a.rule_arrays).cpu()
        mb = rulefit.eval_rules(higgs["cpu"].as_matrix(b.output.names),
                                *b.rule_arrays)
        sa = [r.support for r in a.rules]
        sb = [r.support for r in b.rules]
        _check(torch.equal(ma, mb) and sa == sb,
               f"card_vs_cpu {name}: memberships or supports differ")
        row.update(rules=len(a.rules),
                   lambda_used=[a.lambda_used, b.lambda_used],
                   coef_max_rel_err=_rel(a.beta, b.beta))
        if a.stream:
            row.update(lambdas_walked=[a.lambdas_walked, b.lambdas_walked],
                       steps=[a.stream_steps, b.stream_steps])
            _check(a.lambdas_walked == b.lambdas_walked
                   and a.stream_steps == b.stream_steps,
                   f"card_vs_cpu {name}: lambda paths {row}")
        _check(abs(a.lambda_used - b.lambda_used) <= 1e-4 * b.lambda_used
               and row["coef_max_rel_err"] <= GLM_COEF_TOL,
               f"card_vs_cpu {name}: {row}")
    surv = {d: _survival_frame(rows, d) for d in (dev, "cpu")}
    a, b, row = pair("coxph", _coxph, surv)
    names = list(b.coefficients)
    ca = np.array([a.coefficients[k] for k in names])
    cb = np.array([b.coefficients[k] for k in names])
    la, lb = a.output.training_metrics.loglik, b.output.training_metrics.loglik
    row.update(passes=[a.newton_passes, b.newton_passes],
               coef_max_rel_err=_rel(ca, cb),
               loglik_rel_err=abs(la - lb) / abs(lb))
    _check(sorted(a.baseline) == sorted(b.baseline) and all(
        np.array_equal(a.baseline[k][0], b.baseline[k][0])
        for k in b.baseline), "card_vs_cpu coxph: baseline times differ")
    row["baseline_max_rel_err"] = max(
        float(np.max(np.abs(a.baseline[k][1] - b.baseline[k][1])
                     / np.maximum(np.abs(b.baseline[k][1]), 1e-300)))
        for k in b.baseline)
    _check(row["coef_max_rel_err"] <= COXPH_TOL
           and row["loglik_rel_err"] <= 1e-6
           and row["baseline_max_rel_err"] <= COXPH_TOL,
           f"card_vs_cpu coxph: {row}")
    print("gam_rulefit_coxph_card_vs_cpu", json.dumps(dict(
        rows=rows, fits=out, card_launches=launches)), flush=True)
    return launches


# ---------------------------------------------------------------------------
# The tree engine's other families: uplift, DT, isolation forests, AdaBoost,
# Naive Bayes, quantiles, isotonic regression, infogram, target encoding and
# segment models.
# ---------------------------------------------------------------------------
CRITEO_ROWS = 13_979_592       # Criteo Uplift Prediction Dataset v2.1
CRITEO_F = 12                  # its float features f0..f11
CRITEO_TREATED = 0.85          # its treatment share
CRITEO_VISIT = 0.0470          # its overall visit rate
UPLIFT_TREES = 10              # uplift_criteo: cut from the defaults' 50
UPLIFT_ATE_TOL = 0.003         # |model ATE - generator's ATE|
UPLIFT_MOJO_ROWS = 1_000_000   # uplift_criteo: the rows the MOJO scores
CREDITCARD_ROWS = 284_807      # the ULB credit-card fraud data set
CREDITCARD_F = 30              # Time, V1..V28, Amount
CREDITCARD_FRAUD = 492         # its frauds, planted here as anomalies
ISOFOR_MOJO_ROWS = 20_000      # isofor_creditcard: the rows each MOJO scores
                               # (the host scorer walks ~15-20k rows/s)
ADABOOST_ROWS = 2_000_000      # families_higgs: AdaBoost's rows
ISOTONIC_ROWS = 1_000_000      # families_higgs: isotonic's rows
INFOGRAM_ROWS = 250_000        # families_higgs: the infogram's rows
TE_FOLDS = 5                   # encoders_airlines: the KFold column
TE_MOJO_ROWS = 1_000_000       # encoders_airlines: the rows the MOJO scores
FAMILIES_CPU_ROWS = 50_000     # families_card_vs_cpu: rows per frame
ISOFOR_CPU_ROWS = 120_000      # families_card_vs_cpu: the isolation
                               # forests' rows (past 100,000: randint)
ISOFOR_CPU_TREES = 10          # families_card_vs_cpu: cut from 50 (the CPU
                               # scores the extended forest in 13.4 s at 50)
DT_CPU_ROWS = 30_000           # families_card_vs_cpu: DT's covertype rows
                               # (cut from 100,000: 8.8 s on the CPU)
FAMILIES_TOL = 1e-6            # families_card_vs_cpu: float results


def _criteo_cols(nrow: int, seed: int = 2018):
    """A frame of the Criteo Uplift Prediction Dataset v2.1's published
    shape (Diemert et al., AdKDD 2018): 12 float32 features, treatment on
    85% of rows, a binary visit at 4.70% overall. The visit's logit is
    linear in f0-f2 and the treatment adds 0.8 where f3 > 0 plus 0.4 f4,
    so the effect varies with the features; the intercept is solved on
    the first 1M rows for the published rate. Returns (features, treatment,
    visit, the generator's average treatment effect)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((nrow, CRITEO_F), dtype=np.float32)
    treat = (rng.random(nrow, dtype=np.float32) < CRITEO_TREATED).astype(
        np.float32)
    lin = 0.6 * X[:, 0] - 0.4 * X[:, 1] + 0.3 * X[:, 2]
    tau = 0.8 * (X[:, 3] > 0) + 0.4 * X[:, 4]
    m = min(nrow, 1_000_000)
    a = -3.5
    for _ in range(8):     # Newton on the mean visit rate
        p = 1 / (1 + np.exp(-(a + lin[:m] + treat[:m] * tau[:m])))
        a -= (p.mean() - CRITEO_VISIT) / (p * (1 - p)).mean()
    p_c = 1 / (1 + np.exp(-(a + lin)))
    p_t = 1 / (1 + np.exp(-(a + lin + tau)))
    y = (rng.random(nrow) < np.where(treat > 0, p_t, p_c)).astype(np.float32)
    return X, treat, y, float(np.mean(p_t - p_c))


def _criteo_frame(nrow: int, device):
    from h2o_tpu_torch import Frame, Vec
    from h2o_tpu_torch.frame.vec import T_CAT

    X, treat, y, ate = _criteo_cols(nrow)
    fr = Frame.from_dict({f"f{j}": X[:, j] for j in range(CRITEO_F)},
                         device=device)
    fr.add("treatment", Vec.from_numpy(treat, type=T_CAT, device=device,
                                       domain=["control", "treatment"]))
    fr.add("visit", Vec.from_numpy(y, type=T_CAT, domain=["0", "1"],
                                   device=device))
    return fr, ate


def _uplift(fr, ntrees: int):
    """The JAX package's UpliftDRF defaults (KL, nbins 20, max_depth 20
    capped to 12, sample_rate 0.632, mtries -1 -> 3), seed 42."""
    from h2o_tpu_torch import UpliftDRF, UpliftDRFParameters

    return UpliftDRF(UpliftDRFParameters(
        training_frame=fr, response_column="visit",
        treatment_column="treatment", ntrees=ntrees, seed=42)).train_model()


def _mojo_scores(model, fr, what: str, atol: float, cols=None) -> dict:
    """``model``'s MOJO scored by the port's standalone reader on ``fr``'s
    rows, against ``model.predict`` (``cols``: the prediction columns the
    scorer's columns line up with; all by default): within ``atol``."""
    import torch

    from h2o_tpu_torch import MojoModel

    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, f"{what}.zip")
    t0 = time.perf_counter()
    model.save_mojo(path)
    export_s = time.perf_counter() - t0
    scorer = MojoModel.load(path)
    t0 = time.perf_counter()
    got = np.asarray(scorer.score(scorer.feature_frame_matrix(fr)))
    score_s = time.perf_counter() - t0
    pred = model.predict(fr)
    names = cols or pred.names
    want = torch.stack([pred.vec(n).data[:fr.nrow] for n in names],
                       dim=1).double().cpu().numpy()
    got = got.reshape(fr.nrow, -1)[:, :want.shape[1]]
    err = float(np.abs(got - want).max())
    _check(bool(np.isfinite(got).all()), f"{what}: MOJO scores not finite")
    _check(err <= atol, f"{what}: MOJO scores off predict by {err} (atol "
                        f"{atol})")
    out = dict(rows=fr.nrow, mojo_bytes=os.path.getsize(path),
               export_s=export_s, score_s=score_s, max_abs_err=err,
               scorer_rows_per_s=fr.nrow / score_s)
    os.remove(path)
    return out


def _uplift_level(dev, codes, vv, plan, flat: bool, B: int,
                  n_lv: int, g) -> dict:
    """One V = 4 level of the kernel on the uplift frame's own codes and
    channels (node ids drawn uniformly over the level's nodes)."""
    import torch

    lc = torch.randint(0, n_lv, (codes.shape[0],), generator=g, device=dev,
                       dtype=torch.int32)
    row = _grouped_level(dev, codes, lc, vv, plan, n_lv, B, 10, flat=flat,
                         exact_ch=4)
    row["wrapper"] = "flat" if flat else "grouped"
    return row


def phase_uplift_criteo(dev, fr, ate_gen: float) -> dict:
    """UpliftDRF end to end on the Criteo-shaped frame: 10 x 12 launches of
    the plan's wrapper at V = 4, no Gram launch, finite predictions, qini
    above a random ordering's, the ATE near the generator's; then the
    kernel at V = 4 against its plain version on the frame's codes and the
    first tree's channels at n_lv 1, 64 and 2,048, and the MOJO on the
    first 1M rows."""
    import torch

    from h2o_tpu_torch.frame.chunks import BinnedView
    from h2o_tpu_torch.models.tree.binning import compute_bin_edges
    from h2o_tpu_torch.models.uplift import make_uplift_metrics
    from h2o_tpu_torch.utils import threefry

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _uplift(fr, UPLIFT_TREES)
    train_s = time.perf_counter() - t0
    counts = _counts()
    flat = model.cfg.hist_groups is None
    wrapper = "flat" if flat else "grouped"
    other = counts["grouped" if flat else "flat"]
    depth = model.cfg.max_depth
    t0 = time.perf_counter()
    pred = model.predict(fr)
    raw = torch.stack([pred.vec(j).data[:fr.nrow] for j in range(3)], 1)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    m = model.output.training_metrics
    y = fr.vec("visit").to_numpy()
    t = fr.vec("treatment").to_numpy()
    rand = make_uplift_metrics(y, t, np.random.default_rng(7).random(
        fr.nrow), model.params.auuc_nbins, "qini")
    out = dict(rows=fr.nrow, ntrees=UPLIFT_TREES, max_depth=depth,
               mtries=model.cfg.mtries, nbins=model.cfg.nbins,
               wrapper=wrapper, launches=counts[wrapper],
               other_launches=other, gram_launches=counts["gram"],
               train_s=train_s, predict_s=predict_s, qini=m.qini,
               random_qini=rand.qini, auuc=m.auuc,
               auuc_normalized=m.auuc_normalized, ate=m.ate, att=m.att,
               atc=m.atc, generator_ate=ate_gen,
               visit_rate=float(np.mean(y)), treated=float(np.mean(t)),
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    _check(counts[wrapper] == UPLIFT_TREES * 12 and depth == 12,
           f"uplift_criteo: {counts[wrapper]} launches of the {wrapper} "
           f"wrapper, want {UPLIFT_TREES} x 12")
    _check(other == 0 and counts["gram"] == 0,
           f"uplift_criteo: {other} launches of the other wrapper, "
           f"{counts['gram']} Gram launches")
    _check(bool(torch.isfinite(raw).all()),
           "uplift_criteo: predictions not finite")
    _check(m.qini > rand.qini, f"uplift_criteo: qini {m.qini} not above a "
                               f"random ordering's {rand.qini}")
    _check(abs(m.ate - ate_gen) <= UPLIFT_ATE_TOL,
           f"uplift_criteo: ATE {m.ate} off the generator's {ate_gen} by "
           f"more than {UPLIFT_ATE_TOL}")
    # the kernel at V = 4 on this frame's codes and the first tree's bag
    names = [f"f{j}" for j in range(CRITEO_F)]
    edges = compute_bin_edges(fr.as_matrix(names), np.zeros(CRITEO_F, bool),
                              20, seed=42, nbins_cats=20)
    codes = BinnedView.build([fr.vec(n) for n in names], edges,
                             names=names).matrix
    B = edges.shape[1] + 2
    plan = (((tuple(range(CRITEO_F)), B, "onehot"),) if flat
            else model.cfg.hist_groups)
    key = threefry.split(threefry.prng_key(42), UPLIFT_TREES)[0]
    rl = codes.shape[0]
    s = (threefry.uniform(threefry.fold_in(key, 0), (rl,), dev)
         < np.float32(model.cfg.sample_rate)).to(torch.float32)
    s = s * (~torch.isnan(fr.vec("visit").data)).to(torch.float32)
    tr = torch.nan_to_num(fr.vec("treatment").data)
    yv = torch.nan_to_num(fr.vec("visit").data)
    vv = torch.stack([s * tr, s * tr * yv, s * (1 - tr), s * (1 - tr) * yv],
                     dim=1).contiguous()
    g = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for n_lv in (1, 64, 2048):
        row = _uplift_level(dev, codes, vv, plan, flat, B, n_lv, g)
        print("level_hist_uplift", json.dumps(row), flush=True)
        rows.append(row)
    del codes, vv
    torch.cuda.empty_cache()
    mojo = _mojo_scores(model, fr.take(np.arange(UPLIFT_MOJO_ROWS)),
                        "uplift_criteo", CPU_TOL)
    out["mojo"] = mojo
    print("uplift_criteo", json.dumps(out), flush=True)
    return dict(wrapper=wrapper, launches=counts[wrapper], per_level=rows)


def phase_dt_covtype(dev, fr) -> dict:
    """DT at its defaults (one tree per class, depth 5, ``Exact`` bins up
    to 2,048 distinct values) on the covertype frame: 7 x 5 launches of
    the plan's wrapper, a training logloss below the class prior's; then
    the kernel against its plain version at the root level of the model's
    own ``Exact`` plan and codes, the weight channel exact."""
    import torch

    from h2o_tpu_torch import DT, DTParameters
    from h2o_tpu_torch.frame.chunks import BinnedView

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = DT(DTParameters(training_frame=fr,
                            response_column="Cover_Type")).train_model()
    train_s = time.perf_counter() - t0
    counts = _counts()
    cfg = model.cfg
    wrapper = "grouped" if cfg.hist_groups else "flat"
    other = counts["flat" if cfg.hist_groups else "grouped"]
    K = len(COVTYPE_COUNTS)
    pri = np.asarray(COVTYPE_COUNTS) / COVTYPE_ROWS
    prior_logloss = float(-(pri * np.log(pri)).sum())
    m = model.output.training_metrics
    widths = ([w for _i, w, _m in cfg.hist_groups] if cfg.hist_groups
              else [cfg.nbins + 1])
    out = dict(rows=fr.nrow, classes=K, max_depth=cfg.max_depth,
               nbins=cfg.nbins, bucket_widths=sorted(widths),
               wrapper=wrapper, launches=counts[wrapper],
               other_launches=other, gram_launches=counts["gram"],
               train_s=train_s, logloss=m.logloss,
               prior_logloss=prior_logloss,
               mean_per_class_error=m.mean_per_class_error)
    _check(counts[wrapper] == K * cfg.max_depth and other == 0
           and counts["gram"] == 0,
           f"dt_covtype: launches {counts}, want {K} x {cfg.max_depth} of "
           f"the {wrapper} wrapper")
    _check(bool(np.isfinite(m.logloss)) and m.logloss < prior_logloss,
           f"dt_covtype: training logloss {m.logloss} not below the "
           f"prior's {prior_logloss}")
    names = model.output.names
    codes = BinnedView.build([fr.vec(n) for n in names], model.edges,
                             names=names).matrix
    B = cfg.nbins + 1
    plan = (cfg.hist_groups if cfg.hist_groups
            else (((tuple(range(len(names))), B, "onehot"),)))
    g = torch.Generator(device=dev).manual_seed(55)
    rl = codes.shape[0]
    lc = torch.zeros((rl,), dtype=torch.int32, device=dev)
    vv = torch.randn((rl, 3), generator=g, device=dev)
    vv[:, 0] = (torch.arange(rl, device=dev) < fr.nrow).to(torch.float32)
    row = _grouped_level(dev, codes, lc, vv, plan, 1, B, 10,
                         flat=not cfg.hist_groups)
    row["wrapper"] = wrapper
    out["root_level"] = row
    print("dt_covtype", json.dumps(out), flush=True)
    return dict(wrapper=wrapper, launches=counts[wrapper], root_level=row)


def _creditcard_cols(nrow: int = CREDITCARD_ROWS, seed: int = 2013):
    """A frame of the ULB credit-card fraud data set's shape: 30 float32
    features (Time as a ramp over the two days in days, 28 unit-normal
    components, Amount log-normal around 1, in hundreds) and 492 planted
    anomalies (every 578th row), each shifted by 4 standard deviations in 8
    of the components. The columns share one scale, so the extended
    forest's hyperplanes are not all Time. Returns the features and the
    planted label."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((nrow, CREDITCARD_F), dtype=np.float32)
    X[:, 0] = np.linspace(0, 2, nrow, dtype=np.float32)
    X[:, -1] = np.exp(rng.normal(0.0, 0.5, nrow)).astype(np.float32)
    fraud = np.zeros(nrow, np.float32)
    idx = np.arange(CREDITCARD_FRAUD) * (nrow // CREDITCARD_FRAUD)
    fraud[idx] = 1.0
    for i in idx:
        cols = 1 + rng.choice(28, 8, replace=False)
        X[i, cols] += np.float32(4.0) * np.sign(rng.standard_normal(8))
    return X, fraud


def _creditcard_frame(nrow: int, device):
    from h2o_tpu_torch import Frame

    X, fraud = _creditcard_cols(nrow)
    names = ["Time"] + [f"V{j}" for j in range(1, 29)] + ["Amount"]
    return Frame.from_dict({n: X[:, j] for j, n in enumerate(names)},
                           device=device), fraud


def _isofor(fr, extended: bool, ntrees: int = 50):
    """Isolation Forest at its defaults (50 trees, 256-row samples), or the
    extended form at extension level 29 (every component), seed 42."""
    from h2o_tpu_torch import (ExtendedIsolationForest, IsolationForest,
                               IsolationForestParameters)

    if extended:
        return ExtendedIsolationForest(IsolationForestParameters(
            training_frame=fr, ntrees=ntrees,
            extension_level=CREDITCARD_F - 1, seed=42)).train_model()
    return IsolationForest(IsolationForestParameters(
        training_frame=fr, ntrees=ntrees, seed=42)).train_model()


def phase_isofor_creditcard(dev, fr, fraud) -> dict:
    """Isolation Forest (50 trees, 256-row samples: ``randint`` at this
    row count) and the extended form at extension level 29 on the
    credit-card-shaped frame: every row scored on the card, the AUC of the
    score against the planted label above 0.5, each MOJO round-tripped
    through the port's reader within 1e-6, no kernel launch."""
    import torch

    from h2o_tpu_torch.models.metrics import make_binomial_metrics

    out = {}
    _reset_counts()
    lab = torch.from_numpy(fraud).to(dev)
    for what, ext in (("isofor", False), ("eif", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = _isofor(fr, ext)
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        score = model.predict(fr).vec(0).data[:fr.nrow]
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        _check(bool(torch.isfinite(score).all()),
               f"isofor_creditcard {what}: scores not finite")
        auc = make_binomial_metrics(lab, score).auc
        _check(auc > 0.5, f"isofor_creditcard {what}: AUC {auc}")
        mojo = _mojo_scores(model, fr.take(np.arange(ISOFOR_MOJO_ROWS)),
                            f"isofor_{what}", 1e-6, cols=["predict"])
        out[what] = dict(train_s=train_s, score_s=score_s, auc=auc,
                         depth=model.depth, sample_size=model.sample_size,
                         mean_length=model.output.training_metrics
                         .mean_length, mojo=mojo)
    counts = _counts()
    _check(sum(counts.values()) == 0,
           f"isofor_creditcard: kernel launches {counts}")
    out["rows"] = fr.nrow
    print("isofor_creditcard", json.dumps(out), flush=True)
    return out


def phase_families_higgs(dev, higgs) -> dict:
    """On the HIGGS frame: AdaBoost at its defaults (50 DRF learners of
    depth 2) on 2M rows, 2 flat launches per learner; Naive Bayes and
    ``QuantileBuilder`` on all 11M rows; isotonic regression of the
    response on f0 on 1M rows; the core infogram with GBM probes (10 trees)
    on 250,000 rows, 29 probes x 50 launches. Returns the flat launches."""
    import torch

    from h2o_tpu_torch import (AdaBoost, AdaBoostParameters, Frame,
                               Infogram, InfogramParameters,
                               IsotonicParameters, IsotonicRegression,
                               NaiveBayes, NaiveBayesParameters,
                               QuantileBuilder, QuantileParameters, Vec)

    out, launches = {}, 0
    y11 = higgs.vec("response").data[:higgs.nrow]
    prior = float(y11.double().mean())
    const_ll = -(prior * np.log(prior) + (1 - prior) * np.log(1 - prior))
    # AdaBoost
    ada_fr = higgs.take(np.arange(ADABOOST_ROWS))
    _reset_counts()
    t0 = time.perf_counter()
    ada = AdaBoost(AdaBoostParameters(training_frame=ada_fr,
                                      response_column="response",
                                      seed=42)).train_model()
    c = _counts()
    m = ada.output.training_metrics
    out["adaboost"] = dict(rows=ADABOOST_ROWS, learners=len(ada.learners),
                           train_s=time.perf_counter() - t0, auc=m.auc,
                           launches=c)
    _check(c["flat"] == 2 * len(ada.learners) and c["grouped"] == 0
           and c["gram"] == 0, f"adaboost: launches {c}, want 2 a learner "
                               f"of {len(ada.learners)}")
    _check(len(ada.learners) >= 1 and m.auc > 0.5,
           f"adaboost: {len(ada.learners)} learners, AUC {m.auc}")
    launches += c["flat"]
    del ada, ada_fr
    # Naive Bayes on every row
    _reset_counts()
    t0 = time.perf_counter()
    nb = NaiveBayes(NaiveBayesParameters(training_frame=higgs,
                                         response_column="response")
                    ).train_model()
    m = nb.output.training_metrics
    out["naivebayes"] = dict(rows=higgs.nrow, train_s=time.perf_counter() - t0,
                             auc=m.auc, logloss=m.logloss,
                             constant_logloss=const_ll)
    _check(sum(_counts().values()) == 0, "naivebayes: kernel launches")
    _check(m.auc > 0.5 and m.logloss < const_ll,
           f"naivebayes: AUC {m.auc}, logloss {m.logloss} (constant "
           f"{const_ll})")
    del nb
    # quantiles of every column: each between the order statistics around
    # its exact rank; their distance from torch.quantile is printed
    t0 = time.perf_counter()
    q = QuantileBuilder(QuantileParameters(training_frame=higgs)).train_model()
    qs = time.perf_counter() - t0
    probs = torch.tensor(q.params.probs, dtype=torch.float64, device=dev)
    pos = probs.cpu().numpy() * (higgs.nrow - 1)
    lo = np.clip(np.floor(pos).astype(np.int64) - 1, 0, higgs.nrow - 1)
    hi = np.clip(np.ceil(pos).astype(np.int64) + 1, 0, higgs.nrow - 1)
    qerr = 0.0
    for name, vals in q.quantiles.items():
        col = higgs.vec(name).data[:higgs.nrow]
        srt = torch.sort(col).values.cpu().numpy()
        _check(bool(np.isfinite(vals).all() and (np.diff(vals) >= 0).all()
                    and (srt[lo] <= vals).all() and (vals <= srt[hi]).all()),
               f"quantile {name}: not finite, not sorted or off its rank")
        want = torch.quantile(col.double(), probs).cpu().numpy()
        qerr = max(qerr, float(np.abs(vals - want).max()))
    out["quantile"] = dict(rows=higgs.nrow, columns=len(q.quantiles),
                           train_s=qs, max_abs_err_vs_torch=qerr)
    # isotonic regression of the response on f0
    n = ISOTONIC_ROWS
    sub = higgs.take(np.arange(n))
    iso_fr = Frame(["f0", "y"], [sub.vec("f0"),
                                 Vec(sub.vec("response").data, n)])
    t0 = time.perf_counter()
    iso = IsotonicRegression(IsotonicParameters(
        training_frame=iso_fr, response_column="y")).train_model()
    m = iso.output.training_metrics
    yv = higgs.vec("response").data[:n].double()
    var = float(((yv - yv.mean()) ** 2).mean())
    out["isotonic"] = dict(rows=n, thresholds=len(iso.xs),
                           train_s=time.perf_counter() - t0, mse=m.mse,
                           constant_mse=var)
    _check(bool(np.all(np.diff(iso.ys) >= 0)) and m.mse < var,
           f"isotonic: mse {m.mse} not below the constant's {var}")
    # the core infogram over GBM probes
    info_fr = higgs.take(np.arange(INFOGRAM_ROWS))
    _reset_counts()
    t0 = time.perf_counter()
    info = Infogram(InfogramParameters(
        training_frame=info_fr, response_column="response", seed=42,
        infogram_algorithm_params={"ntrees": 10})).train_model()
    c = _counts()
    probes = 1 + len(info.cmi)
    out["infogram"] = dict(rows=INFOGRAM_ROWS, probes=probes,
                           train_s=time.perf_counter() - t0, launches=c,
                           admissible=info.admissible_features)
    _check(c["flat"] == probes * 10 * 5 and c["grouped"] == 0,
           f"infogram: launches {c}, want {probes} probes x 10 x 5")
    vals = list(info.cmi.values()) + list(info.relevance.values())
    out["infogram"]["max_cmi"] = max(info.cmi.values())
    _check(all(0 <= v <= 1 + 1e-12 for v in vals)
           and abs(max(info.cmi.values()) - 1) <= 1e-12,
           f"infogram: CMI or relevance outside [0, 1]: {info.cmi}, "
           f"{info.relevance}")
    launches += c["flat"]
    print("families_higgs", json.dumps(out), flush=True)
    return launches


def phase_encoders_airlines(dev, fr) -> dict:
    """On the 7,009,728-row airlines frame: the target encoder (KFold over
    a 5-fold column, blending, noise 0.01) on Origin, Dest and
    UniqueCarrier; a 5-tree GBM on the encoded numerics (25 flat
    launches); segment models of 5-tree GBMs per UniqueCarrier at
    parallelism 1 and 2, bit-equal segment by segment; the encoder's MOJO
    on the first 1M rows. Returns the launches by wrapper."""
    import torch

    from h2o_tpu_torch import (GBM, Frame, GBMParameters,
                               SegmentModelsBuilder, SegmentModelsParameters,
                               TargetEncoder, TargetEncoderParameters, Vec)

    n = fr.nrow
    base = Frame(fr.names, fr.vecs)
    fold = Vec.from_numpy((np.arange(n) % TE_FOLDS).astype(np.float32),
                          device=dev)
    te_fr = Frame(fr.names + ["fold"], fr.vecs + [fold])
    cols = ["Origin", "Dest", "UniqueCarrier"]
    out = {}
    t0 = time.perf_counter()
    te = TargetEncoder(TargetEncoderParameters(
        training_frame=te_fr, response_column="IsDepDelayed",
        columns_to_encode=cols, data_leakage_handling="KFold",
        fold_column="fold", blending=True, seed=42)).train_model()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = te.transform(te_fr, as_training=True)
    torch.cuda.synchronize()
    out["target_encoder"] = dict(rows=n, fit_s=fit_s,
                                 transform_s=time.perf_counter() - t0)
    te_names = [f"{c}_te" for c in cols]
    for name in te_names:
        v = enc.vec(name).data[:n]
        _check(bool(torch.isfinite(v).all()) and float(v.min()) > -0.02
               and float(v.max()) < 1.02, f"target encoder: {name} off")
    gfr = Frame(te_names + ["CRSDepTime", "Distance", "IsDepDelayed"],
                [enc.vec(c) for c in te_names + ["CRSDepTime", "Distance",
                                                 "IsDepDelayed"]])
    _reset_counts()
    t0 = time.perf_counter()
    gbm = GBM(GBMParameters(training_frame=gfr,
                            response_column="IsDepDelayed", ntrees=5,
                            max_depth=5, seed=42)).train_model()
    c = _counts()
    out["gbm_on_encoded"] = dict(train_s=time.perf_counter() - t0,
                                 auc=gbm.output.training_metrics.auc,
                                 launches=c)
    _check(c["flat"] == 25 and c["grouped"] == 0,
           f"encoders_airlines: GBM launches {c}, want 25 flat")
    _check(gbm.output.training_metrics.auc > 0.6,
           f"encoders_airlines: GBM AUC {gbm.output.training_metrics.auc}")
    launches = {"flat": c["flat"], "grouped": 0}
    del gbm, gfr, enc
    seg_models = []
    for par in (1, 2):
        _reset_counts()
        t0 = time.perf_counter()
        sm = SegmentModelsBuilder(GBM, GBMParameters(
            training_frame=base, response_column="IsDepDelayed", ntrees=5,
            max_depth=5, seed=42), SegmentModelsParameters(
                segment_columns=["UniqueCarrier"], parallelism=par)
        ).build_segment_models()
        torch.cuda.synchronize()
        c = _counts()
        launches["flat"] += c["flat"]
        launches["grouped"] += c["grouped"]
        out[f"segments_parallelism_{par}"] = dict(
            segments=len(sm.results), wall_s=time.perf_counter() - t0,
            launches=c)
        _check([r["status"] for r in sm.results]
               == ["SUCCEEDED"] * len(sm.results) and len(sm.results) == 22,
               f"segments: {[r['errors'] for r in sm.results]}")
        _check(c["flat"] + c["grouped"] == 22 * 25 and c["gram"] == 0,
               f"segments: launches {c}, want 22 x 25")
        seg_models.append(sm.models())
    for a, b in zip(*seg_models):
        _check(_forests_bit_equal(a, b),
               "segments: parallelism 2 differs from the sequential build")
    sub = te_fr.take(np.arange(TE_MOJO_ROWS))
    out["mojo"] = _mojo_scores(te, sub, "target_encoder", FAMILIES_TOL,
                               cols=te_names)
    print("encoders_airlines", json.dumps(out), flush=True)
    return launches


RAPIDS_GBM_ROWS = 1_000_000    # rapids_airlines: the model primitives' rows
RAPIDS_SUB_ROWS = 100_000      # rapids_airlines: rows of the per-row host
                               # expressions (strsplit, ddply)
RAPIDS_CPU_ROWS = 100_000      # rapids_card_vs_cpu: the generated frame
RAPIDS_TOL = 1e-5              # group-by mean/sd vs float64 numpy; card vs
                               # CPU sd, var, cor, skewness, kurtosis
RAPIDS_CPU_TOL = 1e-6          # card vs CPU: every other float result


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _bits_equal(a, b) -> bool:
    """Two float32 host arrays bit for bit, NaN at the same rows (a NaN's
    payload is the arithmetic's: the card's and the CPU's differ)."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    b = np.ascontiguousarray(b, dtype=np.float32)
    na = np.isnan(a)
    return a.shape == b.shape and np.array_equal(na, np.isnan(b)) and \
        np.array_equal(a[~na].view(np.int32), b[~na].view(np.int32))


def _frames_bit_equal(a, b) -> bool:
    import torch

    return a.names == b.names and all(
        torch.equal(a.vec(n).data.view(torch.int32),
                    b.vec(n).data.view(torch.int32)) for n in a.names)


def _np_group_stats(keys, x):
    """numpy's group-by of ``x`` over integer host ``keys`` (no NA): the
    sorted distinct key rows, rows per group, and per group the valid
    count, min, max, float64 sum, mean and centred sd (ddof 1)."""
    comb = np.zeros(len(x), dtype=np.int64)
    for k in keys:
        comb = comb * (int(k.max()) + 1) + k.astype(np.int64)
    uk, inv, rows = np.unique(comb, return_inverse=True, return_counts=True)
    order = np.argsort(inv, kind="stable")
    starts = np.concatenate([[0], np.cumsum(rows)[:-1]])
    xs = x[order].astype(np.float64)
    ok = ~np.isnan(xs)
    cnt = np.add.reduceat(ok.astype(np.int64), starts)
    s = np.add.reduceat(np.where(ok, xs, 0.0), starts)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = s / cnt
        d = np.where(ok, xs - np.repeat(mean, rows), 0.0)
        sd = np.sqrt(np.add.reduceat(d * d, starts) / np.maximum(cnt - 1, 1))
    sd = np.where(cnt > 0, sd, np.nan)
    mn = np.minimum.reduceat(np.where(ok, xs, np.inf), starts)
    mx = np.maximum.reduceat(np.where(ok, xs, -np.inf), starts)
    na = cnt < rows
    return dict(key=uk, rows=rows, cnt=cnt, sum=s, mean=mean, sd=sd,
                min=np.where(cnt > 0, mn, np.nan),
                max=np.where(cnt > 0, mx, np.nan), has_na=na)


def _rel_close(got, want, tol: float) -> bool:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    nan = np.isnan(want)
    return bool(np.array_equal(np.isnan(got), nan) and (
        np.abs(got[~nan] - want[~nan]) <= tol * np.abs(want[~nan])).all())


def _rapids_group_by(dev, fr) -> dict:
    from h2o_tpu_torch.rapids import group_by

    n = fr.nrow
    aggs = [("nrow", None), ("mean", "Distance", "rm"),
            ("sd", "Distance", "rm"), ("min", "Distance", "rm"),
            ("max", "Distance", "rm"), ("sum", "CRSDepTime", "all")]
    out, s1 = _timed(lambda: group_by(fr, ["Origin", "Dest"], aggs))
    again, s2 = _timed(lambda: group_by(fr, ["Origin", "Dest"], aggs))
    _check(_frames_bit_equal(out, again), "rapids group-by: two runs differ")
    # the host copies of the float32 columns the card aggregates (the
    # parsed Distance also keeps an exact float64 copy, which group-by
    # does not read, as the reference's does not)
    o, d, dist, crs = (fr.vec(c).data[:n].cpu().numpy()
                       for c in ("Origin", "Dest", "Distance", "CRSDepTime"))
    want = _np_group_stats([o, d], dist)
    cw = _np_group_stats([o, d], crs)
    go, gd = out.vec("Origin").to_numpy(), out.vec("Dest").to_numpy()
    width = int(d.max()) + 1
    got_key = go.astype(np.int64) * width + gd.astype(np.int64)
    _check(out.nrow == len(want["key"]) and bool(
        (np.diff(got_key) > 0).all()) and np.array_equal(got_key, want["key"]),
        "rapids group-by: groups not numpy's, sorted by key")
    nrow = out.vec("nrow").to_numpy()
    _check(int(nrow.sum()) == n and np.array_equal(nrow, want["rows"]),
           "rapids group-by: counts differ from numpy's")
    for name, key in (("min_Distance", "min"), ("max_Distance", "max")):
        _check(_bits_equal(out.vec(name).to_numpy(),
                           want[key].astype(np.float32)),
               f"rapids group-by: {name} differs from numpy's")
    for name, key in (("mean_Distance", "mean"), ("sd_Distance", "sd")):
        _check(_rel_close(out.vec(name).to_numpy(), want[key], RAPIDS_TOL),
               f"rapids group-by: {name} not within {RAPIDS_TOL} of "
               "float64 numpy")
    _check(_rel_close(out.vec("sum_CRSDepTime").to_numpy(),
                      np.where(cw["has_na"], np.nan, cw["sum"]), RAPIDS_TOL),
           "rapids group-by: sum_CRSDepTime ('all') differs from numpy's")
    return dict(groups=out.nrow, wall_s=[s1, s2],
                rows_per_s=n / min(s1, s2),
                groups_with_na=int(cw["has_na"].sum()))


def _rapids_sort(dev, fr) -> dict:
    from h2o_tpu_torch.rapids import sort
    from h2o_tpu_torch.rapids.merge import sort_permutation

    n = fr.nrow
    by, asc = ["Origin", "CRSDepTime", "Distance"], [True, False, True]
    keys = [fr.vec(c).data[:n] for c in by]
    perm, perm_s = _timed(lambda: sort_permutation(keys, asc))
    perm2 = sort_permutation(keys, asc)
    _check(bool((perm == perm2).all()), "rapids sort: two runs differ")
    # the float32 keys the card sorts (the reference's sort reads them too)
    host = [fr.vec(c).data[:n].cpu().numpy() for c in by]
    canon = [np.where(np.isnan(h), -np.inf, h) for h in host]
    canon = [c if a else -c for c, a in zip(canon, asc)]
    want = np.lexsort(list(reversed(canon)))
    p = perm.cpu().numpy()
    _check(np.array_equal(p, want), "rapids sort: permutation differs "
           "from np.lexsort's")
    out, frame_s = _timed(lambda: sort(fr, by, asc))
    for name in ("CRSDepTime", "Dest"):
        _check(_bits_equal(out.vec(name).to_numpy(),
                           fr.vec(name).to_numpy()[want]),
               f"rapids sort: sorted {name} differs")
    return dict(permutation_s=perm_s, frame_s=frame_s, columns=fr.ncol,
                rows_per_s=n / frame_s)


def _rapids_device_merge(dev, fr) -> dict:
    from h2o_tpu_torch import Frame
    from h2o_tpu_torch.rapids import merge

    n = fr.nrow
    # no column with an exact host copy (Distance has one): those joins
    # take the host path, as the reference's do
    left = fr.subframe(["CRSDepTime", "Origin", "Dest"])
    crs = fr.vec("CRSDepTime").to_numpy()
    host = {c: fr.vec(c).to_numpy() for c in left.names}
    u = np.unique(crs[~np.isnan(crs)]).astype(np.float32)
    R = len(u)
    matched = ~np.isnan(crs)
    pos = np.searchsorted(u, np.where(matched, crs, 0))
    out = {}
    for copies in (1, 2):
        keys = np.tile(u, copies)
        right = Frame.from_dict({
            "CRSDepTime": keys, "half": keys * np.float32(0.5),
            "slot": np.arange(copies * R, dtype=np.float32)}, device=dev)
        for all_x in (False, True):
            res, s = _timed(lambda: merge(left, right, ["CRSDepTime"],
                                          all_x=all_x))
            # numpy's join: each left row in order, its matches in the
            # right table's stable sorted order (copy c of key i at c*R+i)
            reps = np.where(matched, copies, 1 if all_x else 0)
            rows = np.repeat(np.arange(n), reps)
            within = np.arange(len(rows)) - np.repeat(
                np.cumsum(reps) - reps, reps)
            hit = matched[rows]
            slot = np.where(hit, pos[rows] + within * R, -1)
            want = {c: host[c][rows] for c in left.names}
            want["half"] = np.where(hit, u[np.clip(slot % R, 0, R - 1)]
                                    * np.float32(0.5), np.nan)
            want["slot"] = np.where(hit, slot, np.nan)
            _check(res.nrow == len(rows) and res.names == list(want),
                   f"rapids merge x{copies} all_x={all_x}: {res.nrow} rows, "
                   f"numpy's join has {len(rows)}")
            for c, w in want.items():
                _check(_bits_equal(res.vec(c).to_numpy(), w),
                       f"rapids merge x{copies} all_x={all_x}: {c} differs")
            again = merge(left, right, ["CRSDepTime"], all_x=all_x)
            _check(_frames_bit_equal(res, again),
                   f"rapids merge x{copies} all_x={all_x}: two runs differ")
            out[f"x{copies}_all_x_{all_x}"] = dict(
                rows=res.nrow, right_rows=copies * R, wall_s=s,
                rows_per_s=res.nrow / s)
            del res, again
    return out


def _rapids_host_merge(dev, fr) -> dict:
    from h2o_tpu_torch import Frame, Vec
    from h2o_tpu_torch.backend import native
    from h2o_tpu_torch.rapids import merge

    n = fr.nrow
    car, mon = fr.vec("UniqueCarrier"), fr.vec("Month")
    ldom_c, ldom_m = list(reversed(car.domain)), list(reversed(mon.domain))
    rng = np.random.default_rng(17)
    combos = np.array([(i, j) for i in range(len(ldom_c))
                       for j in range(len(ldom_m))], dtype=np.float32)
    combos = combos[rng.permutation(len(combos))]
    rate = (np.arange(len(combos)) * 0.5).astype(np.float32)
    small = Frame(["UniqueCarrier", "Month", "rate"], [
        Vec.from_numpy(combos[:, 0], type="enum", domain=ldom_c, device=dev),
        Vec.from_numpy(combos[:, 1], type="enum", domain=ldom_m, device=dev),
        Vec.from_numpy(rate, device=dev)])
    big = fr.subframe(["UniqueCarrier", "Month", "Distance", "CRSDepTime"])
    res, s = _timed(lambda: merge(small, big, ["UniqueCarrier", "Month"]))
    # numpy's join: the big table's codes in the small table's level
    # order, its rows in stable key order, each small row's block in turn
    cmap = np.array([ldom_c.index(l) for l in car.domain], dtype=np.int64)
    mmap = np.array([ldom_m.index(l) for l in mon.domain], dtype=np.int64)
    rc = cmap[car.to_numpy().astype(np.int64)]
    rm = mmap[mon.to_numpy().astype(np.int64)]
    t0 = time.perf_counter()
    r_order = native.radix_lexsort([rc, rm])
    radix_s = time.perf_counter() - t0
    want_order = np.lexsort((rm, rc))
    _check(n >= native.RADIX_MIN_ROWS and np.array_equal(r_order, want_order),
           "rapids host merge: the radix order differs from np.lexsort's")
    comb = (rc * len(ldom_m) + rm)[want_order]
    lkey = combos[:, 0].astype(np.int64) * len(ldom_m) + combos[:, 1]
    lo = np.searchsorted(comb, lkey, "left")
    hi = np.searchsorted(comb, lkey, "right")
    r_pos = np.concatenate([want_order[a:b] for a, b in zip(lo, hi)])
    l_idx = np.repeat(np.arange(len(combos)), hi - lo)
    want = {"UniqueCarrier": combos[l_idx, 0], "Month": combos[l_idx, 1],
            "rate": rate[l_idx]}
    for c in ("Distance", "CRSDepTime"):
        want[c] = fr.vec(c).to_numpy()[r_pos]
    _check(res.nrow == len(r_pos) == n and res.names == list(want),
           f"rapids host merge: {res.nrow} rows, numpy's join {len(r_pos)}")
    _check(res.vec("UniqueCarrier").domain == ldom_c
           and res.vec("Month").domain == ldom_m,
           "rapids host merge: domains are not the left table's")
    for c, w in want.items():
        _check(_bits_equal(res.vec(c).to_numpy(), w),
               f"rapids host merge: {c} differs from numpy's join")
    return dict(rows=res.nrow, left_rows=len(combos), wall_s=s,
                rows_per_s=res.nrow / s, radix_s=radix_s)


def _checksum(x):
    """A result's shape and a checksum: per numeric column the float64 sum
    of its finite values, per string column the characters."""
    from h2o_tpu_torch import Frame, Vec

    if isinstance(x, Vec):
        x = Frame(["C1"], [x])
    if isinstance(x, Frame):
        sums = []
        for v in x.vecs:
            h = v.to_numpy()
            if h.dtype == object:
                sums.append(float(sum(len(str(s)) for s in h
                                      if s is not None)))
            else:
                h = h.astype(np.float64)
                sums.append(float(h[np.isfinite(h)].sum()))
        return [x.nrow, x.ncol], sums
    if isinstance(x, dict):
        return {k: _checksum(v) for k, v in x.items()}
    return None, x


def _rapids_evaluator(dev, fr, right) -> dict:
    from h2o_tpu_torch import STORE
    from h2o_tpu_torch.rapids import Rapids, Session

    n = fr.nrow
    STORE.put("air", fr)
    STORE.put("air_right", right)
    STORE.put("air_sub", fr.take(np.arange(RAPIDS_SUB_ROWS)))
    before = set(STORE.keys())
    ix = {c: i for i, c in enumerate(fr.names)}
    exprs = [
        f"(GB air [{ix['Origin']} {ix['Dest']}] 'nrow' 0 'all' 'mean' "
        f"{ix['Distance']} 'rm' 'sd' {ix['CRSDepTime']} 'rm')",
        f"(sort air [{ix['UniqueCarrier']} {ix['CRSDepTime']}] [1 0])",
        "(merge (cols air ['CRSDepTime' 'Origin']) air_right false false "
        "[0] [0] 'auto')",
        "(cut (cols air 'Distance') [0 250 500 1000 2000 100000] _ false "
        "true 3)",
        "(quantile (cols air ['Distance' 'CRSDepTime']) "
        "[0.01 0.25 0.5 0.75 0.99] 'interpolate' _)",
        "(cor (cols air ['Distance' 'CRSDepTime']) (cols air ['Distance' "
        "'CRSDepTime']) 'everything' 'Pearson')",
        "(tmp= air_imp (cols air ['Distance' 'CRSDepTime']))",
        "(h2o.impute air_imp 0 'mean' 'interpolate' [] _ _)",
        "(h2o.impute air_imp 1 'median' 'interpolate' [] _ _)",
        "(scale (cols air ['Distance' 'CRSDepTime']) true true)",
        "(table (cols air 'UniqueCarrier'))",
        "(unique (cols air 'Origin'))",
        "(ifelse (> (cols air 'Distance') 1000) 1 0)",
        "(cumsum (is.na (cols air 'Distance')))",
        "(kfold_column (cols air 'Distance') 5 42)",
        "(strsplit (as.character (cols air_sub 'Origin')) '0')",
        "(:= (cols air ['Distance' 'CRSDepTime']) 0 [0] [0:1000])",
        "(apply (cols air ['Distance' 'CRSDepTime']) 2 {x . (mean x true)})",
        "(ddply (cols air_sub ['UniqueCarrier' 'Distance']) [0] "
        "{x . (mean (cols x 'Distance') true)})",
        "(mean (cols air 'Distance') true)",
        "(sd (cols air 'Distance') true)",
        "(nrow (rows air (> (cols air 'Distance') 2000)))",
        "(toupper (cols air 'Origin'))",
        "(hist (cols air 'Distance') 20)",
        "(which.max (cols air ['Distance' 'CRSDepTime']) true 0)",
        "(sum (* (cols air 'Distance') 2) true)",
        "(cbind (cols air 'Distance') (log1p (cols air 'Distance')))",
        "(rm air_imp)",
    ]
    R = Rapids(Session(device=dev))
    results, rows = {}, []
    for e in exprs:
        res, s = _timed(lambda: R.exec(e))
        shape, ck = _checksum(res)
        rows.append(dict(expr=e, shape=shape, checksum=ck, wall_s=s))
        results[e] = res
    R.session.end()
    _check(set(STORE.keys()) == before,
           "rapids evaluator: Session.end() left the store changed")
    dist = fr.vec("Distance").to_numpy().astype(np.float64)
    ok = ~np.isnan(dist)
    gb = results[exprs[0]]
    _check(int(gb.vec("nrow").to_numpy().sum()) == n,
           "rapids evaluator: GB counts do not sum to nrow")
    _check(abs(results["(mean (cols air 'Distance') true)"]
               - dist[ok].mean()) <= RAPIDS_TOL * dist[ok].mean(),
           "rapids evaluator: mean differs from numpy's")
    _check(results["(nrow (rows air (> (cols air 'Distance') 2000)))"]
           == float((dist[ok] > 2000).sum()),
           "rapids evaluator: the row filter's count differs from numpy's")
    tbl = results["(table (cols air 'UniqueCarrier'))"]
    _check(int(tbl.vec("count").to_numpy().sum()) == n,
           "rapids evaluator: table counts do not sum to nrow")
    cut = results[exprs[3]].to_numpy()
    want_cut = np.searchsorted([0, 250, 500, 1000, 2000, 100000],
                               dist, side="left") - 1.0
    _check(np.array_equal(np.where(ok, cut, -9), np.where(ok, want_cut, -9)),
           "rapids evaluator: cut codes differ from numpy's")
    q = results[exprs[4]].vec("DistanceQuantiles").to_numpy()
    _check(np.allclose(q, np.quantile(dist[ok].astype(np.float32),
                                      [0.01, 0.25, 0.5, 0.75, 0.99]),
                       rtol=1e-6),
           "rapids evaluator: quantiles differ from numpy's")
    fold = results[exprs[14]].to_numpy()
    _check(np.array_equal(np.bincount(fold.astype(np.int64)),
                          np.bincount(np.arange(n) % 5)),
           "rapids evaluator: kfold_column's folds are not balanced")
    srt = results[exprs[1]]
    car = srt.vec("UniqueCarrier").to_numpy()
    _check(bool((np.diff(car) >= 0).all()),
           "rapids evaluator: sort output not sorted")
    mg = results[exprs[2]]
    _check(mg.nrow == int((~np.isnan(fr.vec("CRSDepTime").to_numpy())).sum()),
           "rapids evaluator: merge rows differ from the non-NA keys")
    return dict(expressions=len(exprs), per_expr=rows,
                wall_s=sum(r["wall_s"] for r in rows))


def _rapids_models(dev, fr) -> dict:
    from h2o_tpu_torch import GBM, STORE, GBMParameters
    from h2o_tpu_torch.rapids import Rapids, Session

    sub = fr.take(np.arange(RAPIDS_GBM_ROWS))
    STORE.put("air_1m", sub)
    _reset_counts()
    gbm, train_s = _timed(lambda: GBM(GBMParameters(
        training_frame=sub, response_column="IsDepDelayed", ntrees=5,
        max_depth=5, seed=42)).train_model())
    STORE.put(gbm.key, gbm)
    R = Rapids(Session(device=dev))
    pvi, pvi_s = _timed(lambda: R.exec(
        f"(PermutationVarImp {gbm.key} air_1m 'AUTO' 1 42)"))
    fair, fair_s = _timed(lambda: R.exec(
        f"(fairnessMetrics {gbm.key} air_1m ['UniqueCarrier'] [] 'YES')"))
    lb, lb_s = _timed(lambda: R.exec(f"(makeLeaderboard ['{gbm.key}'])"))
    R.session.end()
    c = _counts()
    _check(c == dict(gram=0, flat=0, grouped=25),
           f"rapids model primitives: launches {c}, want 25 grouped")
    _check(pvi.nrow == len(gbm.output.names) and all(
        np.isfinite(pvi.vec(i).to_numpy()).all() for i in range(1, pvi.ncol)
        if pvi.vec(i).data is not None),
        "rapids PermutationVarImp: not one finite row per feature")
    ov = fair["overview"]
    total = ov.vec("total").to_numpy()
    _check(ov.nrow == 22 and int(total.sum()) == RAPIDS_GBM_ROWS,
           f"rapids fairnessMetrics: {ov.nrow} groups, {total.sum()} rows")
    ref = int(np.argmax(total))
    _check(all(abs(ov.vec(c).to_numpy()[ref] - 1.0) < 1e-6
               for c in ov.names if c.startswith("AIR_")
               and np.isfinite(ov.vec(c).to_numpy()[ref])),
           "rapids fairnessMetrics: the reference group's AIRs are not 1")
    auc = gbm.output.training_metrics.auc
    _check(lb.nrow == 1 and abs(lb.vec("auc").to_numpy()[0] - auc) < 1e-6,
           "rapids makeLeaderboard: not the model's training AUC")
    return dict(rows=RAPIDS_GBM_ROWS, train_s=train_s, auc=auc, launches=c,
                pvi_s=pvi_s, fairness_s=fair_s, fairness_groups=ov.nrow,
                leaderboard_s=lb_s)


def phase_rapids_airlines(dev, fr) -> dict:
    """Frame algebra on the 7,009,728-row imported airlines frame: group-by
    over [Origin, Dest] (numpy's groups and counts, min and max exactly,
    mean and sd within 1e-5 of float64 numpy, two runs bit-equal), sort by
    [Origin, CRSDepTime desc, Distance] (np.lexsort's permutation), the
    device merge on CRSDepTime (inner and all_x, right keys once and
    twice: numpy's join bit for bit, twice the same), the host merge on
    [UniqueCarrier, Month] against a table with its levels in another
    order (through the radix sort; numpy's join), 28 evaluator
    expressions with their shapes and checksums, and the model primitives
    on a 5-tree GBM over the first 1M rows (25 grouped launches). Returns
    the launches by wrapper."""
    from h2o_tpu_torch import Frame

    out = {"rows": fr.nrow}
    steps = {}
    for name, fn in (("group_by", _rapids_group_by), ("sort", _rapids_sort),
                     ("device_merge", _rapids_device_merge),
                     ("host_merge", _rapids_host_merge)):
        t0 = time.perf_counter()
        out[name] = fn(dev, fr)
        steps[name] = time.perf_counter() - t0
    crs = fr.vec("CRSDepTime").to_numpy()
    u = np.unique(crs[~np.isnan(crs)]).astype(np.float32)
    right = Frame.from_dict({"CRSDepTime": u, "hour": np.floor(u / 100)},
                            device=dev)
    t0 = time.perf_counter()
    out["evaluator"] = _rapids_evaluator(dev, fr, right)
    steps["evaluator"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["models"] = _rapids_models(dev, fr)
    steps["models"] = time.perf_counter() - t0
    out["step_s"] = steps   # each step with its numpy checks
    print("rapids_airlines", json.dumps(out), flush=True)
    return {"flat": out["models"]["launches"]["flat"],
            "grouped": out["models"]["launches"]["grouped"]}


def _rapids_cpu_cols(n: int, seed: int = 2016) -> dict:
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=n) * 3).astype(np.float32)
    a[::13] = np.nan
    b = rng.integers(-5, 6, n).astype(np.float32)
    b[::17] = np.nan
    vocab = [f"w{i:02d} {'ab'[i % 2]}x{i % 7}" for i in range(50)]
    s = np.array([None if i % 23 == 5 else vocab[j]
                  for i, j in enumerate(rng.integers(0, 50, n))],
                 dtype=object)
    t = 1.2e12 + rng.integers(0, 10 * 365 * 86_400_000, n).astype(np.float64)
    t[::29] = np.nan
    return {"a": a, "b": b, "pos": (rng.random(n) * 4 + 0.1).astype(
                np.float32),
            "g": rng.integers(0, 50, n).astype(np.float32),
            "c": (rng.integers(0, 10, n).astype(np.float32),
                  [f"L{i}" for i in range(10)]),
            "s": s, "t": t,
            "big": (2 ** 24 + rng.integers(0, 10 ** 6, n)).astype(np.int64),
            "e": rng.exponential(size=n).astype(np.float32)}


def _rapids_cpu_frames(device, n: int):
    from h2o_tpu_torch import Frame, Vec

    fr = Frame()
    for name, col in _rapids_cpu_cols(n).items():
        if isinstance(col, tuple):
            fr.add(name, Vec.from_numpy(col[0], type="enum", domain=col[1],
                                        device=device))
        else:
            fr.add(name, Vec.from_numpy(col, device=device))
    rng = np.random.default_rng(7)
    right = Frame.from_dict({"g": np.arange(0, 60, dtype=np.float32),
                             "w": rng.normal(size=60).astype(np.float32)},
                            device=device)
    right2 = Frame()
    right2.add("c", Vec.from_numpy(
        np.arange(12, dtype=np.float32) % 12, type="enum",
        domain=[f"L{i}" for i in (3, 1, 4, 0, 9, 2, 6, 5, 11, 8, 7, 10)],
        device=device))
    right2.add("v", Vec.from_numpy(np.arange(12, dtype=np.float32),
                                   device=device))
    return {"rc_f": fr, "rc_r": right, "rc_r2": right2}


#: card vs CPU expressions: "x" exact, "f" within RAPIDS_CPU_TOL, "m"
#: (deviations, correlation, moments) within RAPIDS_TOL
RAPIDS_CPU_EXPRS = [
    ("(+ (cols rc_f 'a') (cols rc_f 'b'))", "x"),
    ("(/ (cols rc_f 'a') (cols rc_f 'pos'))", "x"),
    ("(%% (cols rc_f 'b') 3)", "x"),
    ("(intDiv (cols rc_f 'a') (cols rc_f 'b'))", "x"),
    ("(&& (< (cols rc_f 'a') 0) (cols rc_f 'b'))", "x"),
    ("(* (cols rc_f 'big') 3)", "x"),
    ("(^ (cols rc_f 'pos') 1.5)", "f"),
    ("(log (cols rc_f 'pos'))", "f"), ("(exp (cols rc_f 'a'))", "f"),
    ("(sqrt (cols rc_f 'pos'))", "f"), ("(tanh (cols rc_f 'a'))", "f"),
    ("(sign (cols rc_f 'a'))", "x"), ("(round (cols rc_f 'a') 2)", "x"),
    ("(signif (cols rc_f 'pos') 3)", "f"),
    ("(is.na (cols rc_f ['a' 's']))", "x"),
    ("(ifelse (> (cols rc_f 'a') 0) (cols rc_f 'a') (cols rc_f 'b'))", "x"),
    ("(cumsum (cols rc_f 'b'))", "x"), ("(cummax (cols rc_f 'a'))", "x"),
    ("(sum (cols rc_f 'pos') true)", "f"),
    ("(mean (cols rc_f 'pos') true)", "f"),
    ("(sd (cols rc_f 'pos') true)", "m"), ("(var (cols rc_f 'a') true)", "m"),
    ("(median (cols rc_f 'a') true)", "f"),
    ("(min (cols rc_f 'a') true)", "x"), ("(max (cols rc_f 'a') true)", "x"),
    ("(GB rc_f [3] 'nrow' 0 'all' 'min' 0 'rm' 'max' 2 'rm')", "x"),
    ("(GB rc_f [3 4] 'sum' 2 'rm' 'mean' 0 'rm')", "f"),
    ("(GB rc_f [4] 'sd' 0 'rm' 'var' 2 'rm')", "m"),
    ("(sort rc_f [3 0] [1 0])", "x"),
    ("(sort rc_f [4 1 2] [0 1 1])", "x"),
    ("(merge (cols rc_f ['g' 'a' 'pos']) rc_r false false [0] [0] 'auto')",
     "x"),
    ("(merge (cols rc_f ['g' 'a']) rc_r true false [0] [0] 'auto')", "x"),
    ("(merge (cols rc_f ['c' 'g' 's']) rc_r2 true false [0] [0] 'auto')",
     "x"),
    ("(toupper (cols rc_f 's'))", "x"), ("(nchar (cols rc_f 's'))", "x"),
    ("(grep (cols rc_f 's') 'ax' false false true)", "x"),
    ("(strsplit (cols rc_f 's') ' ')", "x"),
    ("(year (cols rc_f 't'))", "x"), ("(hour (cols rc_f 't'))", "x"),
    ("(dayOfWeek (cols rc_f 't'))", "x"),
    ("(quantile (cols rc_f ['a' 'pos' 'big']) [0.1 0.5 0.9] 'interpolate' "
     "_)", "x"),
    ("(cut (cols rc_f 'a') [-10 -1 0 1 10] _ false true 3)", "x"),
    ("(scale (cols rc_f ['a' 'pos']) true true)", "f"),
    ("(cor (cols rc_f ['a' 'pos']) (cols rc_f ['b' 'pos']) 'everything' "
     "'Pearson')", "m"),
    ("(skewness (cols rc_f 'e') true)", "m"),
    ("(kurtosis (cols rc_f 'e') true)", "m"),
    ("(h2o.fillna (cols rc_f ['a' 'b']) 'forward' 0 2)", "x"),
    ("(which (> (cols rc_f 'a') 2))", "x"),
    ("(difflag1 (cols rc_f 'pos'))", "x"),
    ("(table (cols rc_f 'c'))", "x"), ("(unique (cols rc_f 'g'))", "x"),
    ("(hist (cols rc_f 'pos') 10)", "x"),
    ("(kfold_column (cols rc_f 'a') 5 42)", "x"),
    ("(rank_within_groupby (cols rc_f ['g' 'a']) ['g'] ['a'] [1] 'r' false)",
     "x"),
    ("(topn rc_f 0 1 0)", "x"),
    ("(apply (cols rc_f ['a' 'pos']) 2 {x . (sd x true)})", "m"),
    ("(ddply (cols rc_f ['c' 'pos']) [0] {x . (mean (cols x 'pos') true)})",
     "f"),
]


def _host_result(x):
    from h2o_tpu_torch import Frame, Vec

    if isinstance(x, Vec):
        x = Frame(["C1"], [x])
    if isinstance(x, Frame):
        return ("frame", x.names, [(v.type, v.domain, v.to_numpy(),
                                    None if v.data is None
                                    else v.data[:v.nrow].cpu().numpy())
                                   for v in x.vecs])
    if isinstance(x, dict):
        return {k: _host_result(v) for k, v in x.items()}
    return x


def _same_result(a, b, tol: str, what: str) -> None:
    """A card result against the CPU's: structure, types, domains and
    strings exactly; numbers exactly ("x") or within RAPIDS_CPU_TOL
    ("f") or RAPIDS_TOL ("m") of each column's largest magnitude."""
    rtol = {"x": 0.0, "f": RAPIDS_CPU_TOL, "m": RAPIDS_TOL}[tol]
    if isinstance(a, tuple) and a and a[0] == "frame":
        _check(a[1] == b[1] and len(a[2]) == len(b[2]),
               f"rapids card vs CPU: {what}: columns {a[1]} vs {b[1]}")
        for name, ca, cb in zip(a[1], a[2], b[2]):
            _check(ca[0] == cb[0] and ca[1] == cb[1],
                   f"rapids card vs CPU: {what}[{name}]: type or domain")
            if ca[2].dtype == object:
                _check(list(ca[2]) == list(cb[2]),
                       f"rapids card vs CPU: {what}[{name}] strings differ")
            elif rtol == 0:
                _check(_bits_equal(ca[3], cb[3]) and np.array_equal(
                    ca[2], cb[2], equal_nan=True),
                    f"rapids card vs CPU: {what}[{name}] not bit-equal")
            else:
                x = ca[2].astype(np.float64)
                y = cb[2].astype(np.float64)
                scale = np.nanmax(np.abs(y)) if np.isfinite(y).any() else 0
                _check(np.array_equal(np.isnan(x), np.isnan(y)) and bool(
                    (np.abs(x - y)[~np.isnan(y)]
                     <= rtol * np.maximum(np.abs(y[~np.isnan(y)]),
                                          1e-3 * scale)).all()),
                    f"rapids card vs CPU: {what}[{name}] beyond {rtol}")
        return
    if isinstance(a, dict):
        for k in a:
            _same_result(a[k], b[k], tol, f"{what}[{k}]")
        return
    if isinstance(a, list):
        _check(len(a) == len(b), f"rapids card vs CPU: {what}: lengths")
        for i, (p, q) in enumerate(zip(a, b)):
            _same_result(p, q, tol, f"{what}[{i}]")
        return
    if isinstance(a, (bool, str)) or a is None:
        _check(a == b, f"rapids card vs CPU: {what}: {a} vs {b}")
        return
    x, y = float(a), float(b)
    _check((np.isnan(x) and np.isnan(y)) or abs(x - y) <= rtol * abs(y),
           f"rapids card vs CPU: {what}: {x} vs {y}")


def phase_rapids_card_vs_cpu(dev) -> dict:
    """The evaluator's expressions over a generated 100,000-row frame (NAs,
    a string, a time and an int64 column past 2^24) on the card and with
    ``device="cpu"``: integers, orders, merges and strings exactly, float
    results within 1e-6 relative, deviations, correlation and moments
    within 1e-5."""
    from h2o_tpu_torch import STORE
    from h2o_tpu_torch.rapids import Rapids, Session

    runs = {}
    for where in (dev, "cpu"):
        frames = _rapids_cpu_frames(where, RAPIDS_CPU_ROWS)
        for k, v in frames.items():
            STORE.put(k, v)
        R = Rapids(Session(device=where))
        t0 = time.perf_counter()
        runs[str(where)] = [_host_result(R.exec(e))
                            for e, _ in RAPIDS_CPU_EXPRS]
        runs[f"{where}_s"] = time.perf_counter() - t0
        R.session.end()
        for k in frames:
            STORE.remove(k)
    for (e, tol), a, b in zip(RAPIDS_CPU_EXPRS, runs[str(dev)], runs["cpu"]):
        _same_result(a, b, tol, e)
    out = dict(rows=RAPIDS_CPU_ROWS, expressions=len(RAPIDS_CPU_EXPRS),
               card_s=runs[f"{dev}_s"], cpu_s=runs["cpu_s"])
    print("rapids_card_vs_cpu", json.dumps(out), flush=True)
    return out


def _same_tree_arrays(a: dict, b: dict, exact, close, what: str) -> None:
    """Forest arrays of the card and the CPU: ``exact`` keys equal, ``close``
    keys within ``FAMILIES_TOL`` relative."""
    for k in exact:
        _check(np.array_equal(np.asarray(a[k]), np.asarray(b[k])),
               f"{what}: {k} differs between the card and the CPU")
    for k in close:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        _check(bool(np.allclose(x, y, rtol=FAMILIES_TOL, atol=FAMILIES_TOL)),
               f"{what}: {k} off by {np.abs(x - y).max()}")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def phase_families_card_vs_cpu(dev) -> dict:
    """Every new builder on the card and on the CPU at about 50,000 rows:
    integer results equal (tree structure, split flags and subsample
    counts, per-level counts as exact leaf rates, tables of counts), float
    results within ``FAMILIES_TOL``. Returns the card's launches."""
    import torch

    from h2o_tpu_torch import (AdaBoost, AdaBoostParameters, DT, Frame,
                               DTParameters, GBM, GBMParameters, Infogram,
                               InfogramParameters, IsotonicParameters,
                               IsotonicRegression, NaiveBayes,
                               NaiveBayesParameters, QuantileBuilder,
                               QuantileParameters, SegmentModelsBuilder,
                               SegmentModelsParameters, TargetEncoder,
                               TargetEncoderParameters, Vec)

    cpu = torch.device("cpu")
    n = FAMILIES_CPU_ROWS
    out = {}
    card = {"flat": 0, "grouped": 0, "gram": 0}

    walls = {}

    def both(fn, what):
        _reset_counts()
        t1 = time.perf_counter()
        a = fn(dev)
        t2 = time.perf_counter()
        for k, v in _counts().items():
            card[k] += v
        b = fn(cpu)
        walls[what] = dict(card_s=t2 - t1, cpu_s=time.perf_counter() - t2)
        return a, b

    def close(a, b, what):
        a, b = _host(a).astype(np.float64), _host(b).astype(np.float64)
        err = float(np.nanmax(np.abs(a - b))) if a.size else 0.0
        _check(np.array_equal(np.isnan(a), np.isnan(b))
               and err <= FAMILIES_TOL * max(1.0, float(np.nanmax(
                   np.abs(b))) if b.size else 1.0),
               f"{what}: card and CPU {err} apart")
        return err

    t0 = time.perf_counter()
    # uplift: 3 trees at depth 12 on a 50,000-row Criteo-shaped frame
    a, b = both(lambda d: _uplift(_criteo_frame(n, d)[0], 3), "uplift")
    _same_tree_arrays({k: _host(v) for k, v in a.forest.items()},
                      {k: _host(v) for k, v in b.forest.items()},
                      ("feat", "thr", "val_t", "val_c"), ("gain",), "uplift")
    out["uplift"] = close(a.output.training_metrics.qini,
                          b.output.training_metrics.qini, "uplift qini")
    # DT on DT_CPU_ROWS covertype rows
    a, b = both(lambda d: DT(DTParameters(
        training_frame=_covtype_frame(DT_CPU_ROWS, d),
        response_column="Cover_Type")).train_model(), "dt")
    _same_tree_arrays({k: _host(v) for k, v in a.forest.items()},
                      {k: _host(v) for k, v in b.forest.items()},
                      ("feat", "nanL", "thr", "val"), (), "dt")
    _check(np.array_equal(a.edges, b.edges, equal_nan=True),
           "dt: Exact bin edges differ between the card and the CPU")
    # both isolation forests on 120,000 credit-card rows (randint path)
    for what, ext in (("isofor", False), ("eif", True)):
        frs = {}

        def fit(d, ext=ext):
            frs[d.type] = _creditcard_frame(ISOFOR_CPU_ROWS, d)[0]
            return _isofor(frs[d.type], ext, ISOFOR_CPU_TREES)
        a, b = both(fit, what)
        ta, tb = [_host(x) for x in a.forest], [_host(x) for x in b.forest]
        _same_tree_arrays(dict(zip("wtsc", ta)), dict(zip("wtsc", tb)),
                          ("s", "c") + (() if ext else ("w", "t")),
                          ("w", "t") if ext else (), what)
        m = ISOFOR_CPU_ROWS
        out[what] = close(a.predict(frs[dev.type]).vec(0).data[:m],
                          b.predict(frs["cpu"]).vec(0).data[:m],
                          f"{what} scores")
    # AdaBoost, Naive Bayes, quantiles and isotonic on 50,000 HIGGS rows
    a, b = both(lambda d: AdaBoost(AdaBoostParameters(
        training_frame=_higgs_frame(n, d), response_column="response",
        nlearners=5, seed=42)).train_model(), "adaboost")
    _check(len(a.learners) == len(b.learners),
           "adaboost: learner counts differ")
    out["adaboost"] = close(np.asarray(a.alphas), np.asarray(b.alphas),
                            "adaboost alphas")
    for la, lb in zip(a.learners, b.learners):
        _same_tree_arrays({k: _host(v) for k, v in la.forest.items()},
                          {k: _host(v) for k, v in lb.forest.items()},
                          ("feat", "nanL", "thr"), ("val",), "adaboost tree")
    hf = {d.type: _higgs_frame(n, d) for d in (dev, cpu)}
    a, b = both(lambda d: NaiveBayes(NaiveBayesParameters(
        training_frame=hf[d.type], response_column="response")).train_model(),
        "naivebayes")
    for k in a.gauss:
        close(a.gauss[k], b.gauss[k], f"naivebayes {k}")
    out["naivebayes"] = close(
        a.predict(hf[dev.type]).vec(2).data[:n],
        b.predict(hf["cpu"]).vec(2).data[:n], "naivebayes probabilities")
    a, b = both(lambda d: QuantileBuilder(QuantileParameters(
        training_frame=hf[d.type])).train_model(), "quantile")
    for k in a.quantiles:
        _check(np.array_equal(a.quantiles[k], b.quantiles[k]),
               f"quantile {k}: card and CPU differ")

    def iso(d):
        f = hf[d.type]
        return IsotonicRegression(IsotonicParameters(
            training_frame=Frame(["f0", "y"], [f.vec("f0"), Vec(
                f.vec("response").data, n)]),
            response_column="y")).train_model()
    a, b = both(iso, "isotonic")
    _check(np.array_equal(a.xs, b.xs), "isotonic: thresholds differ")
    out["isotonic"] = close(a.ys, b.ys, "isotonic fit")
    # infogram: 6 predictors, 3 probes of 3 trees
    a, b = both(lambda d: Infogram(InfogramParameters(
        training_frame=hf[d.type], response_column="response", seed=42,
        ignored_columns=[f"f{j}" for j in range(6, HIGGS_F)],
        top_n_features=3,
        infogram_algorithm_params={"ntrees": 3})).train_model(), "infogram")
    _check(a.output.names == b.output.names
           and a.admissible_features == b.admissible_features,
           "infogram: top or admissible features differ")
    for k in a.cmi_raw:
        close(a.cmi_raw[k], b.cmi_raw[k], f"infogram cmi {k}")
    # the target encoder and segment models on 50,000 airlines rows
    af = {}
    for d in (dev, cpu):
        f = _airlines_frame(n, d)
        f.add("fold", Vec.from_numpy((np.arange(n) % TE_FOLDS).astype(
            np.float32), device=d))
        af[d.type] = f
    a, b = both(lambda d: TargetEncoder(TargetEncoderParameters(
        training_frame=af[d.type], response_column="IsDepDelayed",
        columns_to_encode=["Origin", "Dest", "UniqueCarrier"],
        data_leakage_handling="KFold", fold_column="fold", blending=True,
        seed=42)).train_model(), "target_encoder")
    for col in a.encodings:
        for k in ("num", "den", "fold_num", "fold_den"):
            _check(torch.equal(a.encodings[col][k].cpu(),
                               b.encodings[col][k]),
                   f"target encoder {col} {k}: card and CPU differ")
    ea = a.transform(af[dev.type], as_training=True)
    eb = b.transform(af["cpu"], as_training=True)
    out["target_encoder"] = max(close(ea.vec(c).data[:n], eb.vec(c).data[:n],
                                      f"target encoder {c}")
                                for c in ea.names[len(af["cpu"].names):])
    a, b = both(lambda d: SegmentModelsBuilder(GBM, GBMParameters(
        training_frame=af[d.type], response_column="IsDepDelayed", ntrees=3,
        max_depth=3, seed=42, ignored_columns=["fold"]),
        SegmentModelsParameters(segment_columns=["UniqueCarrier"],
                                parallelism=2)).build_segment_models(),
        "segments")
    _check(len(a.results) == len(b.results) == 22,
           "segments: segment counts differ")
    for ra, rb in zip(a.results, b.results):
        _check(ra["segment"] == rb["segment"], "segments: order differs")
        _same_tree_arrays({k: _host(v) for k, v in ra["model"].forest.items()},
                          {k: _host(v) for k, v in rb["model"].forest.items()},
                          ("feat", "nanL", "catd"), ("thr", "val"),
                          f"segment {ra['segment']}")
    out["wall_s"] = time.perf_counter() - t0
    out["walls"] = walls
    out["card_launches"] = card
    print("families_card_vs_cpu", json.dumps(out), flush=True)
    return card


# ---------------------------------------------------------------------------
# The last families: PSVM on the Gram kernel, GLRM, Aggregator, Word2Vec
# ---------------------------------------------------------------------------
PSVM_ROWS = 1_000_000          # psvm_higgs: the Gaussian fit's HIGGS rows
                               # (cut from 11M: at m = 500 the feature map
                               # and the distances are 2 GB each per 1M)
PSVM_MOJO_ROWS = 100_000       # psvm_higgs: the rows each MOJO scores
PSVM_MOJO_ATOL, PSVM_MOJO_RTOL = 1e-4, 1e-3   # test_mojo_extended.py:161
GLRM_AIRLINES_ROWS = 1_000_000  # glrm_airlines: the train split's rows
GLRM_MIN_STEP = 1e-9           # glrm_*: min_step_size (default 1e-4). Y's
                               # gradient sums over the rows and the step is
                               # not scaled by them: at 11M rows every step
                               # at 1e-4 overshoots and is rejected, in both
                               # packages (ROADMAP Queue 3)
GLRM_MOJO_ROWS = 20_000        # glrm_*: the rows each MOJO scores
GLRM_MOJO_TOL = 1e-3           # test_mojo_extended.py:59 (atol and rtol)
TEXT8_TOKENS = 1_000_000       # word2vec_text8: text8's 17,005,207 tokens
                               # cut to 1M (about 9,800 steps an epoch)
TEXT8_TYPES = 71_290           # text8's distinct words
TEXT8_TOPICS = 20              # planted topics (function words aside)
TEXT8_FUNCTION = 150           # the most frequent types, in every topic
TEXT8_SENTENCE = 1_000         # tokens a sentence, NA between sentences
TEXT8_RUN = 50                 # tokens a topic run (a paragraph's topic)
AGG_TARGET = 5_000             # aggregator_covtype: target exemplars
LAST_CPU_ROWS = 20_000         # lastfamilies_card_vs_cpu: rows per frame
LAST_CPU_TOKENS = 50_000       # lastfamilies_card_vs_cpu: corpus tokens
PSVM_CPU_TOL = 1e-4            # card vs CPU: beta (x max(1, |beta|)),
                               # decision values
GLRM_HIST_TOL = 1e-5           # card vs CPU: objective history, relative
GLRM_Y_TOL = 1e-4              # card vs CPU: archetypes
GLRM_CPU_ITERS = 25            # card vs CPU: iterations the history and Y
                               # are held over
GLRM_FINAL_TOL = 1e-4          # card vs CPU: the 100-iteration objective
W2V_CPU_TOL = 1e-5             # card vs CPU: word vectors after one epoch


def _text8_words(ntok: int, seed: int = 8):
    """A text8-shaped corpus (Matt Mahoney's first 10^8 bytes of English
    Wikipedia: 17,005,207 tokens over 71,290 words, no punctuation): Zipf
    frequencies over ``TEXT8_TYPES`` words, the ``TEXT8_FUNCTION`` most
    frequent ones in every context, the others each planted in one of
    ``TEXT8_TOPICS`` topics; a sentence is ``TEXT8_SENTENCE`` tokens of
    ``TEXT8_RUN``-token runs, each run from one topic, 45% of its tokens
    function words; NA ends a sentence. Returns the
    host word array (None for NA) and each word's topic (-1: a function
    word)."""
    rng = np.random.default_rng(seed)
    V = TEXT8_TYPES
    zipf = 1.0 / np.arange(1, V + 1)
    topic = np.full(V, -1, np.int64)
    topic[TEXT8_FUNCTION:] = rng.integers(0, TEXT8_TOPICS,
                                          V - TEXT8_FUNCTION)
    fn_p = zipf[:TEXT8_FUNCTION] / zipf[:TEXT8_FUNCTION].sum()
    by_topic = [np.flatnonzero(topic == t) for t in range(TEXT8_TOPICS)]
    cdfs = [np.cumsum(zipf[ix]) / zipf[ix].sum() for ix in by_topic]
    nrun = -(-ntok // TEXT8_RUN)
    run_topic = rng.integers(0, TEXT8_TOPICS, nrun)
    tok_topic = np.repeat(run_topic, TEXT8_RUN)[:ntok]
    ids = np.empty(ntok, np.int64)
    fn = rng.random(ntok) < 0.45
    ids[fn] = rng.choice(TEXT8_FUNCTION, size=int(fn.sum()), p=fn_p)
    u = rng.random(ntok)
    for t in range(TEXT8_TOPICS):
        sel = ~fn & (tok_topic == t)
        ids[sel] = by_topic[t][np.minimum(np.searchsorted(cdfs[t], u[sel]),
                                          len(by_topic[t]) - 1)]
    names = np.array([f"w{i}" for i in range(V)], dtype=object)
    # each sentence of TEXT8_SENTENCE tokens followed by an NA row
    pos = np.arange(ntok)
    out = np.full(ntok + -(-ntok // TEXT8_SENTENCE), None, dtype=object)
    out[pos + pos // TEXT8_SENTENCE] = names[ids]
    return out, dict(zip(names, topic))


def _word_frame(words, device):
    from h2o_tpu_torch import Frame, Vec
    from h2o_tpu_torch.frame.vec import T_STR

    return Frame(["word"], [Vec(None, len(words), type=T_STR,
                                host_data=words)])


def _w2v(fr, device, epochs: int = 1, min_word_freq: int = 5):
    from h2o_tpu_torch import Word2Vec, Word2VecParameters

    return Word2Vec(Word2VecParameters(
        training_frame=fr, vec_size=100, window_size=5, negative_samples=5,
        min_word_freq=min_word_freq, epochs=epochs, seed=42,
        device=device)).train_model()


class _SgnsSteps:
    """While open, each Word2Vec step's centers, contexts, negatives and
    learning rate are kept (host copies), on either device."""

    def __enter__(self):
        from h2o_tpu_torch.models import word2vec

        self.orig, self.steps = word2vec._Stepper.__call__, []
        orig = self.orig

        def kept(stepper, sel, negs, lr):
            batch = stepper.pairs[sel].cpu().numpy()
            self.steps.append((batch[:, 0], batch[:, 1], negs.cpu().numpy(),
                               lr))
            return orig(stepper, sel, negs, lr)
        word2vec._Stepper.__call__ = kept
        return self

    def __exit__(self, *exc):
        from h2o_tpu_torch.models import word2vec

        word2vec._Stepper.__call__ = self.orig


def _psvm(fr, kernel: str, max_iterations: int = 30):
    from h2o_tpu_torch import PSVM, SVMParameters

    return PSVM(SVMParameters(training_frame=fr, response_column="response",
                              kernel_type=kernel, hyper_param=1.0,
                              max_iterations=max_iterations,
                              seed=42)).train_model()


class _PsvmObjective:
    """While open, the squared-hinge objective at each Newton iteration
    (the loss the Gram launch's pass returns, and ½‖β‖²)."""

    def __enter__(self):
        from h2o_tpu_torch.models import psvm

        self.orig, self.obj = psvm._sq_hinge_grad_hess, []
        orig = self.orig

        def kept(Phib, y, w, beta):
            g, H, loss = orig(Phib, y, w, beta)
            self.obj.append(float(loss) + 0.5 * float((beta[:-1] ** 2).sum()))
            return g, H, loss
        psvm._sq_hinge_grad_hess = kept
        return self

    def __exit__(self, *exc):
        from h2o_tpu_torch.models import psvm

        psvm._sq_hinge_grad_hess = self.orig


def _psvm_mojo(model, fr, what: str) -> dict:
    """The PSVM MOJO scored by the port's reader on ``fr``: p1 within the
    reference's round trip of ``predict`` (atol 1e-4, rtol 1e-3), labels
    agreeing on 99% of rows."""
    import torch

    from h2o_tpu_torch import MojoModel

    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, f"{what}.zip")
    model.save_mojo(path)
    scorer = MojoModel.load(path)
    t0 = time.perf_counter()
    got = np.asarray(scorer.score(scorer.feature_frame_matrix(fr)))
    score_s = time.perf_counter() - t0
    pred = model.predict(fr)
    want = torch.stack([pred.vec(j).data[:fr.nrow] for j in range(3)],
                       dim=1).double().cpu().numpy()
    excess = np.abs(got[:, 2] - want[:, 2]) - (
        PSVM_MOJO_ATOL + PSVM_MOJO_RTOL * np.abs(want[:, 2]))
    agree = float((got[:, 0] == want[:, 0]).mean())
    out = dict(rows=fr.nrow, mojo_bytes=os.path.getsize(path),
               score_s=score_s, max_abs_err=float(np.abs(
                   got[:, 2] - want[:, 2]).max()), label_agreement=agree)
    os.remove(path)
    _check(bool(np.isfinite(got).all()) and float(excess.max()) <= 0
           and agree >= 0.99, f"{what}: MOJO {out}")
    return out


def phase_psvm_higgs(dev, higgs) -> tuple[int, dict]:
    """PSVM on HIGGS: the Gaussian kernel (``rank_ratio`` auto: m = 500
    landmarks, the reference's cap) on the first ``PSVM_ROWS`` rows, then
    the linear kernel on all 11M. Each fit: Gram launches equal its Newton
    iterations and no other kernel launches; the objective does not rise;
    training AUC finite and above 0.6; ``sv_count`` in (0, n]; its MOJO on
    ``PSVM_MOJO_ROWS`` rows within the reference's round trip. Then the
    Gram kernel against its plain version on the Gaussian fit's first
    launch's own inputs (Φb at P = 501, W = 2·active, z = −y·m). Returns
    the launches and that check."""
    import torch

    from h2o_tpu_torch.models import psvm

    out, launches = {}, 0
    first = None
    for what, fr, kernel in (
            ("gaussian", higgs.take(np.arange(PSVM_ROWS)), "gaussian"),
            ("linear", higgs, "linear")):
        _reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _GramInputs(psvm, first=True) as kept, _PsvmObjective() as ob:
            model = _psvm(fr, kernel)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        c = _counts()
        launches += c["gram"]
        auc = model.output.training_metrics.auc
        obj = ob.obj
        r = dict(rows=fr.nrow, train_s=train_s, iterations=model.iterations,
                 launches=c, sv_count=model.sv_count, auc=auc,
                 objective=obj, landmarks=(0 if model.landmarks is None
                                           else model.landmarks.shape[0]),
                 peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        _check(c["gram"] == model.iterations and c["flat"] == c["grouped"]
               == 0, f"psvm_higgs {what}: {c} for {model.iterations} "
                     f"iterations")
        _check(all(b <= a * (1 + 1e-6) for a, b in zip(obj, obj[1:])),
               f"psvm_higgs {what}: objective rose {obj}")
        _check(auc is not None and np.isfinite(auc) and auc > 0.6,
               f"psvm_higgs {what}: AUC {auc}")
        _check(0 < model.sv_count <= fr.nrow,
               f"psvm_higgs {what}: sv_count {model.sv_count}")
        r["mojo"] = _psvm_mojo(model, fr.take(np.arange(PSVM_MOJO_ROWS)),
                               f"psvm_{what}")
        if first is None:
            first = kept.last
        out[what] = r
        del model, kept
    X, W, z = first
    shape = _gram_check(X, W, z, reps=5)
    del first, X, W, z
    out["gram_at_path"] = shape
    print("psvm_higgs", json.dumps(out), flush=True)
    return launches, shape


def _glrm(fr, **kw):
    from h2o_tpu_torch import GLRM, GLRMParameters

    return GLRM(GLRMParameters(training_frame=fr, seed=42,
                               **kw)).train_model()


def _glrm_checks(model, fr, what: str) -> dict:
    """The history never rises and ends below its start; ``transform_frame``
    and ``predict`` run on every row, finite where the frame is observed;
    the MOJO reconstructs ``GLRM_MOJO_ROWS`` rows within the reference's
    round trip."""
    import torch

    from h2o_tpu_torch import MojoModel

    hist = [h["objective"] for h in model.output.scoring_history]
    _check(all(b <= a for a, b in zip(hist, hist[1:])) and hist[-1] < hist[0],
           f"{what}: objective history {hist[:3]}...{hist[-3:]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arch = model.transform_frame(fr)
    rec = model.predict(fr)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    _check(arch.nrow == rec.nrow == fr.nrow
           and all(bool(torch.isfinite(v.data[:fr.nrow]).all())
                   for v in arch.vecs),
           f"{what}: transform_frame not finite")
    sub = fr.take(np.arange(GLRM_MOJO_ROWS))
    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, f"{what}.zip")
    model.save_mojo(path)
    scorer = MojoModel.load(path)
    got = np.asarray(scorer.predict(sub))
    want = torch.stack([v.data[:GLRM_MOJO_ROWS] for v in rec.vecs],
                       dim=1).double().cpu().numpy()
    err = float(np.abs(got - want).max())
    excess = float((np.abs(got - want) - GLRM_MOJO_TOL
                    * (1 + np.abs(want))).max())
    os.remove(path)
    _check(excess <= 0, f"{what}: MOJO off predict by {err}")
    return dict(objective_first=hist[0], objective_last=hist[-1],
                iterations=len(hist), archetypes=list(model.Y.shape),
                transform_predict_s=score_s, mojo_max_abs_err=err)


def phase_glrm_higgs(dev, higgs) -> dict:
    """GLRM on the 11M x 28 HIGGS features (the response left out): k = 10,
    Quadratic loss, STANDARDIZE, PlusPlus init, 100 iterations (the
    defaults), ``min_step_size`` ``GLRM_MIN_STEP``; the checks of
    ``_glrm_checks``; no kernel launches."""
    import torch

    fr = higgs.subframe([f"f{j}" for j in range(HIGGS_F)])
    _reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _glrm(fr, k=10, transform="STANDARDIZE", init="PlusPlus",
                  min_step_size=GLRM_MIN_STEP)
    torch.cuda.synchronize()
    out = dict(rows=fr.nrow, train_s=time.perf_counter() - t0)
    out.update(_glrm_checks(model, fr, "glrm_higgs"))
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    c = _counts()
    _check(sum(c.values()) == 0, f"glrm_higgs: kernel launches {c}")
    print("glrm_higgs", json.dumps(out), flush=True)
    return out


def phase_glrm_airlines(dev, train) -> dict:
    """GLRM on the imported airlines train split's first
    ``GLRM_AIRLINES_ROWS`` rows, every column: k = 5, the Categorical
    multi-loss on the categorical blocks, Month's block Ordinal through
    ``loss_by_col``, NonNegative X, the numerics standardized; the checks of ``_glrm_checks`` and X
    non-negative; no kernel launches."""
    import torch

    fr = train.take(np.arange(GLRM_AIRLINES_ROWS))
    _reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _glrm(fr, k=5, multi_loss="Categorical",
                  loss_by_col={"Month": "Ordinal"},
                  regularization_x="NonNegative", init="PlusPlus",
                  transform="STANDARDIZE", min_step_size=GLRM_MIN_STEP)
    torch.cuda.synchronize()
    out = dict(rows=fr.nrow, train_s=time.perf_counter() - t0,
               expanded=model.Y.shape[1])
    out.update(_glrm_checks(model, fr, "glrm_airlines"))
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    _check(bool((model.X >= 0).all()), "glrm_airlines: X negative")
    c = _counts()
    _check(sum(c.values()) == 0, f"glrm_airlines: kernel launches {c}")
    print("glrm_airlines", json.dumps(out), flush=True)
    return out


def phase_word2vec_text8(dev) -> dict:
    """Word2Vec on the text8-shaped corpus (``_text8_words``): vec_size
    100, window 5, 5 negatives, min_word_freq 5, one epoch (cut from 5),
    twice: the two models' vectors bit-equal; among the 10 nearest words
    of 200 frequent topical words, the share of their own topic at least
    5x the chance share; ``transform`` with AVERAGE gives one finite row a
    sentence; the MOJO's vectors bit-equal to the model's; steps/s; no
    kernel launches."""
    import torch

    from h2o_tpu_torch import MojoModel

    t0 = time.perf_counter()
    words, topic = _text8_words(TEXT8_TOKENS)
    gen_s = time.perf_counter() - t0
    fr = _word_frame(words, dev)
    models, walls = [], []
    _reset_counts()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models.append(_w2v(fr, dev))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    a, b = models
    _check(a.vocab == b.vocab and np.array_equal(
        a.vectors.view(np.int32), b.vectors.view(np.int32)),
        "word2vec_text8: two runs differ")
    steps = a.output.scoring_history[0]["steps"]
    inv = list(a.vocab)
    counts = np.bincount([a.vocab[w] for w in words
                          if w is not None and w in a.vocab],
                         minlength=len(inv))
    cand = [i for i in np.argsort(-counts) if topic[inv[i]] >= 0][:200]
    same = []
    for i in cand:
        syn = a.find_synonyms(inv[i], 10)
        same += [topic[w] == topic[inv[i]] for w in syn]
    share = float(np.mean(same))
    topical = np.array([topic[w] for w in inv])
    chance = float(np.mean([np.mean(topical == topical[i]) for i in cand]))
    pooled = a.transform(fr.vec(0), aggregate_method="AVERAGE")
    nsent = sum(1 for w in words if w is None)
    _check(pooled.nrow == nsent and bool(np.isfinite(
        pooled.vec(0).to_numpy()).all()), "word2vec_text8: AVERAGE rows")
    os.makedirs(DATA_DIR, exist_ok=True)
    path = os.path.join(DATA_DIR, "word2vec.zip")
    a.save_mojo(path)
    scorer = MojoModel.load(path)
    got = scorer.transform(inv)
    os.remove(path)
    _check(np.array_equal(got, a.vectors.astype(np.float64)),
           "word2vec_text8: MOJO vectors differ")
    c = _counts()
    out = dict(tokens=TEXT8_TOKENS, vocab=len(inv), steps=steps,
               pairs=a.output.scoring_history[0]["pairs"], gen_s=gen_s,
               train_s=walls, steps_per_s=steps / walls[0],
               same_topic_share=share, chance_share=chance,
               sentences=nsent, launches=c)
    print("word2vec_text8", json.dumps(out), flush=True)
    _check(share >= 5 * chance, f"word2vec_text8: same-topic share {share} "
                                f"against chance {chance}")
    _check(sum(c.values()) == 0, f"word2vec_text8: kernel launches {c}")
    return out


def _aggregate(fr, target: int = AGG_TARGET):
    from h2o_tpu_torch import Aggregator, AggregatorParameters

    return Aggregator(AggregatorParameters(
        training_frame=fr, target_num_exemplars=target,
        rel_tol_num_exemplars=0.5, transform="NORMALIZE")).train_model()


def phase_aggregator_covtype(dev, cov) -> dict:
    """Aggregator on the covertype-shaped frame (581,012 x 54, the class
    column left out), target 5,000 exemplars, ``rel_tol`` 0.5, NORMALIZE,
    twice: the exemplar count within the tolerance of the target (or the
    reference's fallback took the last radius), the counts summing to the
    rows and equal to the assignment's ``bincount``, the two runs
    bit-equal; no kernel launches."""
    import torch

    fr = cov.subframe([n for n in cov.names if n != "Cover_Type"])
    models, walls = [], []
    _reset_counts()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models.append(_aggregate(fr))
        walls.append(time.perf_counter() - t0)
    a, b = models
    agg = a.aggregated_frame
    counts = agg.vec("counts").to_numpy()
    hist = a.output.scoring_history[0]
    ok_n = abs(agg.nrow - AGG_TARGET) <= 0.5 * AGG_TARGET
    out = dict(rows=fr.nrow, exemplars=agg.nrow, passes=hist["passes"],
               fallback=hist["fallback"], within_tol=ok_n, train_s=walls,
               launches=_counts())
    print("aggregator_covtype", json.dumps(out), flush=True)
    _check(ok_n or hist["fallback"],
           f"aggregator_covtype: {agg.nrow} exemplars")
    _check(int(counts.sum()) == fr.nrow and np.array_equal(
        counts, np.bincount(a.exemplar_assignment)),
        "aggregator_covtype: counts")
    bg = b.aggregated_frame
    _check(np.array_equal(a.exemplar_assignment, b.exemplar_assignment)
           and all(np.array_equal(agg.vec(n).to_numpy(), bg.vec(n).to_numpy(),
                                  equal_nan=True) for n in agg.names),
           "aggregator_covtype: two runs differ")
    _check(sum(out["launches"].values()) == 0,
           f"aggregator_covtype: kernel launches {out['launches']}")
    return out


def phase_lastfamilies_card_vs_cpu(dev) -> dict:
    """The last families on the card and on the CPU: PSVM (Gaussian, m = 500,
    on ``LAST_CPU_ROWS`` HIGGS rows, three Newton steps) weights within 1e-4·max(1, |β|) and
    decision values within 1e-4; GLRM (a rank-10 frame with noise,
    ``LAST_CPU_ROWS`` x 28, k = 10) the objective history within 1e-5
    relative and Y within 1e-4 over ``GLRM_CPU_ITERS`` iterations, and the
    final objective of 100 within 1e-4 relative; Aggregator
    (covertype rows) exemplar rows and counts equal; Word2Vec
    (``LAST_CPU_TOKENS`` tokens) vocabulary, pairs, every step's negatives
    equal and the vectors within ``W2V_CPU_TOL``; DeepLearning and
    IsolationForest with ``offset_column`` bit-equal to the same builder
    with the column ignored. Returns the card's launches."""
    import torch

    from h2o_tpu_torch import (DeepLearning, DeepLearningParameters, Frame,
                               IsolationForest, IsolationForestParameters,
                               Vec)

    cpu = torch.device("cpu")
    n = LAST_CPU_ROWS
    out = {}
    card_launches = dict(gram=0, flat=0, grouped=0)

    def on_card(fn):
        _reset_counts()
        r = fn()
        for k, v in _counts().items():
            card_launches[k] += v
        return r

    hig = _higgs_frame(n, dev)
    hig_cpu = _cpu_frame(hig)
    # PSVM, three Newton steps on each device: the stopping rule compares
    # two float32 objective sums at 1e-8 relative, so where the fit stops
    # moves by one iteration with their rounding (an ulp-sized step then
    # moves beta by ~1e-3)
    a = on_card(lambda: _psvm(hig, "gaussian", max_iterations=3))
    b = _psvm(hig_cpu, "gaussian", max_iterations=3)
    ba, bb = _host(a.beta), _host(b.beta)
    db = float((np.abs(ba - bb) / np.maximum(1, np.abs(bb))).max())
    da = _host(a.decision_function(a.adapt_frame(hig)))[:n]
    dc = _host(b.decision_function(b.adapt_frame(hig_cpu)))[:n]
    dd = float(np.abs(da - dc).max())
    out["psvm"] = dict(beta_rel=db, decision_abs=dd, iterations=[
        a.iterations, b.iterations], sv=[a.sv_count, b.sv_count])
    _check(db <= PSVM_CPU_TOL and dd <= PSVM_CPU_TOL,
           f"lastfamilies_card_vs_cpu psvm: {out['psvm']}")
    # GLRM on a rank-10 signal with noise. The backtracking rule compares
    # two float32 objectives: once the descent flattens, an ulp flips an
    # accept and the paths part (on one CPU, 1 and 8 threads part at
    # iteration 32 of 100, Y by 0.15, the last objectives within 1e-6).
    # So the trajectory is held over its first GLRM_CPU_ITERS iterations
    # and the 100-iteration run by its final objective
    rng = np.random.default_rng(10)
    A = (rng.normal(size=(n, 10)) * np.linspace(3, 1, 10)
         @ rng.normal(size=(10, HIGGS_F))
         + 0.3 * rng.normal(size=(n, HIGGS_F))).astype(np.float32)
    low = Frame.from_dict({f"c{j}": A[:, j] for j in range(HIGGS_F)},
                          device=dev)
    low_cpu = _cpu_frame(low)
    hist = lambda m: np.array([h["objective"]
                               for h in m.output.scoring_history])
    a = on_card(lambda: _glrm(low, k=10, transform="STANDARDIZE",
                              max_iterations=GLRM_CPU_ITERS))
    b = _glrm(low_cpu, k=10, transform="STANDARDIZE",
              max_iterations=GLRM_CPU_ITERS)
    dh = float((np.abs(hist(a) - hist(b)) / np.abs(hist(b))).max())
    dy = float(np.abs(_host(a.Y) - _host(b.Y)).max())
    a = on_card(lambda: _glrm(low, k=10, transform="STANDARDIZE"))
    b = _glrm(low_cpu, k=10, transform="STANDARDIZE")
    df = abs(hist(a)[-1] - hist(b)[-1]) / abs(hist(b)[-1])
    out["glrm"] = dict(history_rel=dh, y_abs=dy, final_rel=df)
    _check(dh <= GLRM_HIST_TOL and dy <= GLRM_Y_TOL
           and df <= GLRM_FINAL_TOL,
           f"lastfamilies_card_vs_cpu glrm: {out['glrm']}")
    del hig, hig_cpu
    # Aggregator
    cov = _covtype_frame(n, dev)
    cov = cov.subframe([c for c in cov.names if c != "Cover_Type"])
    a = on_card(lambda: _aggregate(cov, 500))
    b = _aggregate(_cpu_frame(cov), 500)
    ga, gb = a.aggregated_frame, b.aggregated_frame
    _check(np.array_equal(a.exemplar_assignment, b.exemplar_assignment)
           and all(np.array_equal(ga.vec(c).to_numpy(), gb.vec(c).to_numpy(),
                                  equal_nan=True) for c in ga.names),
           "lastfamilies_card_vs_cpu aggregator: exemplars differ")
    out["aggregator"] = dict(exemplars=ga.nrow)
    del cov
    # Word2Vec
    words, _ = _text8_words(LAST_CPU_TOKENS, seed=9)
    fr = _word_frame(words, dev)
    with _SgnsSteps() as sa:
        a = on_card(lambda: _w2v(fr, dev, min_word_freq=2))
    with _SgnsSteps() as sb:
        b = _w2v(fr, cpu, min_word_freq=2)
    _check(a.vocab == b.vocab and len(sa.steps) == len(sb.steps)
           and all(all(np.array_equal(x, y) for x, y in zip(p[:3], q[:3]))
                   and p[3] == q[3] for p, q in zip(sa.steps, sb.steps)),
           "lastfamilies_card_vs_cpu word2vec: pairs or negatives differ")
    dv = float(np.abs(a.vectors - b.vectors).max())
    out["word2vec"] = dict(vocab=len(a.vocab), steps=len(sa.steps),
                           vectors_abs=dv)
    _check(dv <= W2V_CPU_TOL,
           f"lastfamilies_card_vs_cpu word2vec: vectors {dv}")
    # offsets: the column left out of the features, as ignored
    cols, y = _higgs_cols(n, seed=7)
    cols = {k: cols[k] for k in list(cols)[:6]}
    cols["off"] = (0.1 * np.arange(n) % 1).astype(np.float32)
    ofr = Frame.from_dict(cols, device=dev)
    ofr.add("response", Vec.from_numpy(y, device=dev))
    for what, fn in (
            ("deeplearning", lambda **kw: DeepLearning(DeepLearningParameters(
                training_frame=ofr, response_column="response",
                hidden=[16], epochs=1, seed=42, **kw)).train_model()),
            ("isolationforest", lambda **kw: IsolationForest(
                IsolationForestParameters(training_frame=ofr, ntrees=10,
                                          seed=42, **kw)).train_model())):
        pa = on_card(lambda: fn(offset_column="off")).predict(ofr)
        pb = fn(ignored_columns=["off"]).predict(ofr)
        _check(all(torch.equal(x.data.nan_to_num(7.25), y.data.nan_to_num(
            7.25)) for x, y in zip(pa.vecs, pb.vecs)),
            f"lastfamilies_card_vs_cpu: {what} with an offset column")
    out["offsets"] = ["deeplearning", "isolationforest"]
    out["launches"] = card_launches
    print("lastfamilies_card_vs_cpu", json.dumps(out), flush=True)
    return card_launches


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
    # the host radix sort of the merge's host path, built the same way
    from h2o_tpu_torch.backend import native
    t0 = time.perf_counter()
    native.lib()
    print(f"radix sort build: {time.perf_counter() - t0:.3f} s", flush=True)

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
    xgb_launches = run("xgboost_train",
                       lambda d: phase_xgboost_train(d, higgs))
    run("card_vs_cpu", phase_card_vs_cpu)
    grouped = run("level_hist_grouped", phase_grouped_kernel)
    grouped_launches = run("airlines_train", phase_airlines_train)
    run("airlines_card_vs_cpu", phase_airlines_card_vs_cpu)
    gram_nums = run("gram", phase_gram)
    gram_launches, higgs_glm = run("glm_train", lambda d: _glm_train(
        d, higgs, "glm_train"))
    mojo = run("mojo_export", lambda d: phase_mojo_export(
        d, higgs, higgs_model, higgs_glm))
    del higgs_model, higgs_glm
    fmt_launches = run("import_formats", phase_import_formats)
    run("glm_cod_train", lambda d: _glm_train(
        d, higgs, "glm_cod_train", solver="COORDINATE_DESCENT"))
    pv_launches, irlsm, gram_at_pvalues = run(
        "glm_pvalues_higgs", lambda d: phase_glm_pvalues_higgs(d, higgs))
    run("glm_lbfgs_higgs", lambda d: phase_glm_lbfgs_higgs(d, higgs, irlsm))
    del irlsm
    con_launches = run("glm_constrained_higgs",
                       lambda d: phase_glm_constrained_higgs(d, higgs))
    ams_launches, gram_at_sweep = run(
        "anova_modelselection_higgs",
        lambda d: phase_anova_modelselection_higgs(d, higgs))
    gam_launches, gram_at_gam = run("gam_higgs",
                                    lambda d: phase_gam_higgs(d, higgs))
    rf_launches, gram_at_rulefit = run(
        "rulefit_higgs", lambda d: phase_rulefit_higgs(d, higgs))
    fam_launches = run("families_higgs",
                       lambda d: phase_families_higgs(d, higgs))
    psvm_launches, gram_at_psvm = run(
        "psvm_higgs", lambda d: phase_psvm_higgs(d, higgs))
    run("glrm_higgs", lambda d: phase_glrm_higgs(d, higgs))
    del higgs
    t0 = time.perf_counter()
    criteo, criteo_ate = _criteo_frame(CRITEO_ROWS, dev)
    print(f"criteo frame {CRITEO_ROWS}x{CRITEO_F + 2}: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    uplift = run("uplift_criteo", lambda d: phase_uplift_criteo(
        d, criteo, criteo_ate))
    del criteo
    t0 = time.perf_counter()
    card, fraud = _creditcard_frame(CREDITCARD_ROWS, dev)
    print(f"creditcard frame {CREDITCARD_ROWS}x{CREDITCARD_F}: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    run("isofor_creditcard", lambda d: phase_isofor_creditcard(d, card,
                                                               fraud))
    del card
    run("word2vec_text8", phase_word2vec_text8)
    cox_launches, gram_at_cox = run("coxph_survival", phase_coxph_survival)
    grc_launches = run("gam_rulefit_coxph_card_vs_cpu",
                       phase_gam_rulefit_coxph_card_vs_cpu)
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
    dt = run("dt_covtype", lambda d: phase_dt_covtype(d, cov))
    run("aggregator_covtype", lambda d: phase_aggregator_covtype(d, cov))
    del cov
    run("drf_card_vs_cpu", phase_drf_card_vs_cpu)
    fam_cpu_launches = run("families_card_vs_cpu",
                           phase_families_card_vs_cpu)
    last_cpu_launches = run("lastfamilies_card_vs_cpu",
                            phase_lastfamilies_card_vs_cpu)
    run("recovery_card_vs_cpu", phase_recovery_card_vs_cpu)
    from h2o_tpu_torch import split_frame

    imported, _parse = run("import_csv", phase_import_csv)
    cmp_launches = run("compress_airlines",
                       lambda d: phase_compress_airlines(d, imported))
    enc_launches = run("encoders_airlines",
                       lambda d: phase_encoders_airlines(d, imported))
    rapids_launches = run("rapids_airlines",
                          lambda d: phase_rapids_airlines(d, imported))
    run("rapids_card_vs_cpu", phase_rapids_card_vs_cpu)
    train, valid, calib = split_frame(imported, ratios=[0.7, 0.15], seed=42)
    del imported
    cv_gbm_launches, hist_at_path = run(
        "import_cv_gbm", lambda d: phase_import_cv_gbm(d, train, valid,
                                                       calib))
    cv_glm_launches, gram_at_path = run(
        "import_cv_glm", lambda d: phase_import_cv_glm(d, train, valid))
    enc = run("encoding_airlines",
              lambda d: phase_encoding_airlines(d, train, valid))
    inter_launches, gram_at_inter = run(
        "glm_interactions_airlines",
        lambda d: phase_glm_interactions_airlines(d, train, valid))
    run("hglm_airlines", lambda d: phase_hglm_airlines(d, train))
    run("glrm_airlines", lambda d: phase_glrm_airlines(d, train))
    air = train.take(np.arange(SURFACE_CPU_ROWS))
    del train, valid, calib
    surface_launches = run("model_surface_card_vs_cpu",
                           lambda d: phase_model_surface_card_vs_cpu(d, air))
    rest_launches = run("glm_rest_card_vs_cpu",
                        lambda d: phase_glm_rest_card_vs_cpu(d, air))
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
    run("glm_ordinal_covtype", lambda d: phase_glm_ordinal_covtype(d, cov))
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
                                grid_recovery=grid_launches,
                                rulefit_higgs=rf_launches["flat"],
                                mojo_export=mojo["flat"],
                                import_formats=fmt_launches,
                                gam_rulefit_coxph_card_vs_cpu=grc_launches[
                                    "flat"]),
             "level_hist_grouped": dict(airlines_train=grouped_launches,
                                        import_cv_gbm=cv_gbm_launches,
                                        compress_airlines=cmp_launches,
                                        mojo_export=mojo["grouped"]),
             "gram": dict(glm_train=gram_launches,
                          xgboost_gblinear=gblinear_launches,
                          import_cv_glm=cv_glm_launches,
                          pca_mnist=pca_launches,
                          automl_higgs=automl_launches["gram"],
                          glm_multinomial_covtype=mglm_launches,
                          ensemble_covtype=ens_launches["gram"],
                          automl_card_vs_cpu=cvc_launches["gram"],
                          glm_pvalues_higgs=pv_launches,
                          glm_constrained_higgs=con_launches,
                          anova_modelselection_higgs=ams_launches,
                          glm_interactions_airlines=inter_launches,
                          glm_rest_card_vs_cpu=rest_launches,
                          gam_higgs=gam_launches,
                          rulefit_higgs=rf_launches["gram"],
                          coxph_survival=cox_launches,
                          gam_rulefit_coxph_card_vs_cpu=grc_launches[
                              "gram"],
                          psvm_higgs=psvm_launches,
                          lastfamilies_card_vs_cpu=last_cpu_launches[
                              "gram"])}
    for path, counts in (("encoding_airlines", enc["launches"]),
                         ("model_surface_card_vs_cpu", surface_launches),
                         ("encoders_airlines", enc_launches),
                         ("rapids_airlines", rapids_launches),
                         ("families_card_vs_cpu", fam_cpu_launches)):
        paths["level_hist"][path] = counts["flat"]
        paths["level_hist_grouped"][path] = counts["grouped"]
    paths["level_hist"]["families_higgs"] = fam_launches
    # the tree engine's other families: uplift's V = 4 path and DT's
    # Exact plan, each under the wrapper its plan took
    up_entry = ("level_hist" if uplift["wrapper"] == "flat"
                else "level_hist_grouped")
    paths[up_entry]["uplift_criteo"] = uplift["launches"]
    dt_entry = ("level_hist" if dt["wrapper"] == "flat"
                else "level_hist_grouped")
    paths[dt_entry]["dt_covtype"] = dt["launches"]
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
        if name == up_entry:
            rows = uplift["per_level"]
            e["uplift_v4_levels"] = dict(
                n_lv=[r["n_lv"] for r in rows], V=4,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                per_level=rows,
                **{k: sum(r[k] for r in rows)
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
            e["max_abs_err"] = max(e["max_abs_err"],
                                   e["uplift_v4_levels"]["max_abs_err"])
        if name == dt_entry:
            e["dt_exact_root"] = dt["root_level"]
            e["max_abs_err"] = max(e["max_abs_err"],
                                   dt["root_level"]["max_abs_err"])
        if name == "level_hist_grouped":
            e["import_cv_gbm_levels"] = hist_at_path
            e["max_abs_err"] = max(e["max_abs_err"],
                                   hist_at_path["max_abs_err"])
        if name == "gram":
            e["import_cv_glm_shape"] = gram_at_path
            e["pca_mnist_shape"] = _gram_shape(gram_at_pca)
            e["multinomial_block_shape"] = _gram_shape(gram_at_block)
            # the rest of GLM's new shapes: the Fisher pass at HIGGS's
            # design, the interaction design and ModelSelection's
            # [X | 1 | y] (z = None)
            e["pvalues_shape"] = _gram_shape(gram_at_pvalues)
            e["interactions_shape"] = _gram_shape(gram_at_inter)
            e["modelselection_shape"] = _gram_shape(gram_at_sweep)
            # the Gram's other users: GAM's 11M design, RuleFit's first
            # streamed block and a CoxPH Newton pass (z = None)
            e["gam_shape"] = _gram_shape(gram_at_gam)
            e["rulefit_block_shape"] = _gram_shape(gram_at_rulefit)
            e["coxph_shape"] = _gram_shape(gram_at_cox)
            # PSVM's Newton Hessian and gradient: the Gaussian fit's first
            # launch, the Nystrom features (500 landmarks + the bias)
            e["psvm_shape"] = _gram_shape(gram_at_psvm)
            e["max_abs_err"] = max(e["max_abs_err"],
                                   gram_at_path["max_abs_err"],
                                   gram_at_pca["max_abs_err"],
                                   gram_at_block["max_abs_err"],
                                   gram_at_pvalues["max_abs_err"],
                                   gram_at_inter["max_abs_err"],
                                   gram_at_sweep["max_abs_err"],
                                   gram_at_gam["max_abs_err"],
                                   gram_at_rulefit["max_abs_err"],
                                   gram_at_cox["max_abs_err"],
                                   gram_at_psvm["max_abs_err"])
        entries.append(e)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
