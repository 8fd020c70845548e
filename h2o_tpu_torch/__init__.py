"""h2o_tpu_torch — the PyTorch/CUDA port of ``h2o_tpu``, one slice at a time.

The JAX package ``h2o_tpu`` stays the reference; this package mirrors its
module layout so each port module sits at the same relative path as its
counterpart, and never imports ``jax`` or anything of ``h2o_tpu``.

Scope so far: the user's front door — ``import_file`` (CSV/TSV, plain,
``.gz`` or ``.zip``, through the port's own C++ tokenizer on the host
with the reference's type, NA and interning rules), ``split_frame`` and
string, time and exact-integer columns; cross-validation for every builder
(``nfolds``, ``fold_column``, the fold assignments), Platt calibration,
custom distributions and the multinomial AUC family; GBM (every built-in distribution, quantile and huber leaves,
monotone and interaction constraints, early stopping, variable importances)
and DRF/XRT on numeric and categorical features, and XGBoost (gbtree, DART,
gblinear) over them, trained and scored end to end —
``Frame``/``Vec`` on torch tensors, quantile, uniform, random, exact and
per-level bin edges and int8/int16 bin codes, the tree engine's level loop over the
level-histogram kernel (flat or width-bucketed plans,
``backend/kernels/hist.py``, CUDA C++ in ``csrc/level_hist.cu``), row and
column sampling on ``jax.random``'s threefry streams reproduced bit for bit
(``utils/threefry.py``), categorical set splits, out-of-bag scoring, and
binomial/multinomial/regression metrics; GLM (gaussian,
binomial, quasibinomial, poisson, gamma, tweedie, negativebinomial,
multinomial, ordinal, HGLM) through IRLSM, coordinate descent or L_BFGS,
with or without lambda search, with alpha lists, box and linear
constraints, interactions, p-values and ``ml`` dispersion — ``DataInfo``'s
design expansion (``models/datainfo.py``) and the IRLS loop over the weighted
Gram kernel (``backend/kernels/gram.py``, CUDA C++ in ``csrc/gram.cu``), the
small solves on the host; ``ANOVAGLM`` and ``ModelSelection`` over it.
Unsupervised and neural models: DeepLearning
(MLP and autoencoder, ``models/deeplearning.py``: autograd gradients,
optax's ADADELTA and momentum SGD written out, the reference's init,
shuffle and dropout streams), KMeans (``models/kmeans.py``) and PCA/SVD
(``models/pca.py``: GramSVD through the Gram kernel, Power, Randomized).
Model search: the multinomial GLM (per-class block IRLS over the Gram
kernel), ``GridSearch`` (Cartesian and RandomDiscrete walks, budgets,
early stopping, ``parallelism``, recovery, export and import),
``StackedEnsemble`` (CV stacking or blending, every metalearner),
``H2OAutoML`` (the reference's default plan, leaderboard and event log)
and ``partial_dependence``/``permutation_varimp``. The model surface:
TreeSHAP contributions, leaf assignments and staged predictions for every
tree model (``models/tree/shap.py``, ``engine.forest_covers``), the
categorical encodings frozen at training and replayed at scoring
(``utils/linalg.py``), custom metrics and the ``Model`` tables. The
Gram's other users: ``GAM`` (cr, thin-plate, monotone I-spline and
P-spline bases, ``mojo/format.py``'s numpy bases and their device twins,
one Gram launch per penalized IRLS iteration), ``RuleFit`` (rules from DRF
or GBM sub-forests, the L1 path over a built design or, past 2^29 cells,
a design streamed block by block through the Gram kernel) and ``CoxPH``
(Efron or Breslow ties, strata, two Gram launches per Newton pass, the
Breslow baseline hazard and ``survfit``). Models out, data in: MOJO and
POJO export of every model kind the reference exports
(``Model.save_mojo``/``save_pojo``, ``mojo/writer.py``, ``mojo/pojo.py``),
the standalone host scorer of every MOJO kind (``MojoModel``,
``mojo/reader.py``) and ``Generic`` models over it, and ``import_file``
of Avro, XLSX, XLS, SVMLight and ARFF files. The tree engine's other
families: ``UpliftDRF`` (the level-histogram kernel at four channels),
``DT`` (one tree on ``Exact`` bins), ``AdaBoost`` over the port's
builders, ``IsolationForest`` and ``ExtendedIsolationForest`` (all trees
grown as batched tensors), ``NaiveBayes``, ``TargetEncoder``,
``IsotonicRegression``, ``QuantileBuilder``, ``Infogram`` and
``SegmentModelsBuilder``. The last families: ``PSVM`` (a Nyström feature
map, then Newton on the squared hinge with one Gram kernel launch an
iteration), ``GLRM`` (every loss and regularizer, the three inits),
``Aggregator`` (the greedy exemplar pass and its radius search) and
``Word2Vec`` (skip-gram with negative sampling, deterministic scatter-adds
on the card), with the PSVM, GLRM and word2vec MOJO writers. Every builder
takes ``offset_column`` as the reference's does.

State that outlives a training process: the K/V store (``STORE``) that
models and frames register in, jobs on worker threads
(``ModelBuilder.train()``), the chunk codecs (``compress_frame``,
``Frame.compress``), frame and model files (``save_frame``/``load_frame``,
``save_model``/``load_model``, ``Model.save``), checkpoint continuation
(``checkpoint=``), in-training snapshots (``export_checkpoints_dir``) and
auto-recovery checkpoints resumed bit-equal by ``resume_training``.

Device policy: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` on a machine without a GPU raises.
Kernel wrappers dispatch on the tensor's device: the plain PyTorch version
for a CPU tensor, the hand-written kernel for a CUDA tensor.
"""

from .backend.kvstore import STORE
from .backend.persist import load_frame, load_model, save_frame, save_model
from .frame.chunks import compress_frame
from .frame.frame import Frame
from .frame.split import split_frame
from .frame.vec import Vec
from .io.parser import ParseSetup, import_file
from .models.anovaglm import ANOVAGLM, ANOVAGLMModel, ANOVAGLMParameters
from .models.automl import H2OAutoML, Leaderboard
from .models.coxph import CoxPH, CoxPHModel, CoxPHParameters
from .models.deeplearning import (DeepLearning, DeepLearningModel,
                                  DeepLearningParameters)
from .models.drf import (DRF, XRT, DRFModel, DRFParameters,
                         XRTParameters)
from .models.gbm import GBM, GBMModel, GBMParameters
from .models.ensemble import (StackedEnsemble, StackedEnsembleModel,
                              StackedEnsembleParameters)
from .models.explain import partial_dependence, permutation_varimp
from .models.gam import GAM, GAMModel, GAMParameters
from .models.generic import (Generic, GenericModel, GenericParameters,
                             import_mojo)
from .models.glm import GLM, GLMModel, GLMMultinomialModel, GLMParameters
from .models.grid import (Grid, GridSearch, SearchCriteria, export_grid,
                          import_grid)
from .models.kmeans import KMeans, KMeansModel, KMeansParameters
from .models.modelselection import (ModelSelection, ModelSelectionModel,
                                    ModelSelectionParameters)
from .models.model_base import resume_training
from .models.pca import PCA, SVD, PCAModel, PCAParameters, SVDModel, \
    SVDParameters
from .models.rulefit import RuleFit, RuleFitModel, RuleFitParameters
from .models.xgboost import XGBoost, XGBoostParameters
from .models.adaboost import AdaBoost, AdaBoostModel, AdaBoostParameters
from .models.dt import DT, DTParameters
from .models.infogram import Infogram, InfogramModel, InfogramParameters
from .models.isofor import (ExtendedIsolationForest, IsolationForest,
                            IsolationForestModel, IsolationForestParameters)
from .models.isotonic import (IsotonicParameters, IsotonicRegression,
                              IsotonicRegressionModel)
from .models.naivebayes import (NaiveBayes, NaiveBayesModel,
                                NaiveBayesParameters)
from .models.quantile import (QuantileBuilder, QuantileModel,
                              QuantileParameters, frame_quantiles)
from .models.segments import (SegmentModels, SegmentModelsBuilder,
                              SegmentModelsParameters)
from .models.target_encoder import (TargetEncoder, TargetEncoderModel,
                                    TargetEncoderParameters)
from .models.uplift import UpliftDRF, UpliftDRFModel, UpliftDRFParameters
from .models.aggregator import (Aggregator, AggregatorModel,
                                AggregatorParameters)
from .models.glrm import GLRM, GLRMModel, GLRMParameters
from .models.psvm import PSVM, SVMModel, SVMParameters
from .models.word2vec import Word2Vec, Word2VecModel, Word2VecParameters
from .mojo import MojoModel

__all__ = ["Frame", "Vec", "import_file", "ParseSetup", "split_frame",
           "GBM", "GBMModel", "GBMParameters", "DRF", "DRFModel",
           "DRFParameters", "XRT", "XRTParameters", "GLM", "GLMModel",
           "GLMParameters", "XGBoost", "XGBoostParameters", "STORE",
           "compress_frame", "save_frame", "load_frame", "save_model",
           "load_model", "resume_training", "DeepLearning",
           "DeepLearningModel", "DeepLearningParameters", "KMeans",
           "KMeansModel", "KMeansParameters", "PCA", "PCAModel",
           "PCAParameters", "SVD", "SVDModel", "SVDParameters",
           "GLMMultinomialModel", "Grid", "GridSearch", "SearchCriteria",
           "export_grid", "import_grid", "StackedEnsemble",
           "StackedEnsembleModel", "StackedEnsembleParameters", "H2OAutoML",
           "Leaderboard", "partial_dependence", "permutation_varimp",
           "ANOVAGLM", "ANOVAGLMModel", "ANOVAGLMParameters",
           "ModelSelection", "ModelSelectionModel",
           "ModelSelectionParameters", "GAM", "GAMModel", "GAMParameters",
           "RuleFit", "RuleFitModel", "RuleFitParameters", "CoxPH",
           "CoxPHModel", "CoxPHParameters", "Generic", "GenericModel",
           "GenericParameters", "import_mojo", "MojoModel", "UpliftDRF",
           "UpliftDRFModel", "UpliftDRFParameters", "DT", "DTParameters",
           "AdaBoost", "AdaBoostModel", "AdaBoostParameters",
           "IsolationForest", "ExtendedIsolationForest",
           "IsolationForestModel", "IsolationForestParameters", "NaiveBayes",
           "NaiveBayesModel", "NaiveBayesParameters", "TargetEncoder",
           "TargetEncoderModel", "TargetEncoderParameters",
           "IsotonicRegression", "IsotonicRegressionModel",
           "IsotonicParameters", "QuantileBuilder", "QuantileModel",
           "QuantileParameters", "frame_quantiles", "Infogram",
           "InfogramModel", "InfogramParameters", "SegmentModels",
           "SegmentModelsBuilder", "SegmentModelsParameters", "PSVM",
           "SVMModel", "SVMParameters", "GLRM", "GLRMModel",
           "GLRMParameters", "Aggregator", "AggregatorModel",
           "AggregatorParameters", "Word2Vec", "Word2VecModel",
           "Word2VecParameters"]
