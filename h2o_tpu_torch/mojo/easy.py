"""EasyPredictModelWrapper — the row-at-a-time production scoring façade
(``h2o_tpu/mojo/easy.py``, copied).

Reference: `h2o-genmodel/src/main/java/hex/genmodel/easy/
EasyPredictModelWrapper.java` + the typed prediction classes under
`hex/genmodel/easy/prediction/*`. A loaded MOJO scores batched matrices
(`reader.MojoModel.score`); this wrapper adds the deployment-side surface:
RowData dicts with string categorical levels, per-category typed results,
and unknown-level handling (`convertUnknownCategoricalLevelsToNa`).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from .reader import MojoModel


@dataclass
class RegressionModelPrediction:
    value: float = 0.0


@dataclass
class BinomialModelPrediction:
    label: str = ""
    labelIndex: int = 0
    classProbabilities: list = field(default_factory=list)


@dataclass
class MultinomialModelPrediction:
    label: str = ""
    labelIndex: int = 0
    classProbabilities: list = field(default_factory=list)


@dataclass
class ClusteringModelPrediction:
    cluster: int = 0


@dataclass
class AnomalyDetectionPrediction:
    score: float = 0.0
    normalizedScore: float = 0.0


@dataclass
class DimReductionModelPrediction:
    dimensions: list = field(default_factory=list)


class PredictUnknownCategoricalLevelException(ValueError):
    def __init__(self, message, column, level):
        super().__init__(message)
        self.column = column
        self.level = level


class RowEncoder:
    """dict → (N, F) feature-matrix conversion (`easy/RowToRawDataConverter`).

    The one row-encoding implementation both scoring surfaces share: the
    EasyPredictModelWrapper row API below and the serving runtime's
    request path (`h2o_tpu/serving/`). Level lookup is a prebuilt
    per-column hash map — the historical ``dom.index(v)`` linear scan is
    O(cardinality) per cell, which a request hot path cannot afford —
    with identical semantics (a domain lists unique levels, so the first-
    occurrence index IS the dict index).

    Unknown-level handling matches the wrapper contract exactly: strict
    mode raises ``PredictUnknownCategoricalLevelException`` on the first
    unknown encountered; lenient mode (``convert_unknown=True``) leaves
    NaN and increments ``unknown_seen[column]`` once per occurrence.
    """

    def __init__(self, features, domains, convert_unknown: bool = False,
                 unknown_seen: dict | None = None, dtype=np.float64):
        self.features = list(features)
        self.domains = list(domains)
        self.convert_unknown = convert_unknown
        #: shared, mutated in place — the wrapper aliases its public
        #: unknown_categorical_levels_seen dict to this
        self.unknown_seen = {} if unknown_seen is None else unknown_seen
        #: the serving runtime encodes on concurrent request threads; an
        #: unlocked read-modify-write on the shared counter drops counts
        self._seen_lock = threading.Lock()
        self.dtype = dtype
        self._luts = [None if d is None
                      else {lvl: i for i, lvl in enumerate(d)}
                      for d in self.domains]

    def encode(self, rows: list) -> np.ndarray:
        """rows: list of {column: value} dicts → (N, F) matrix (absent /
        None cells NaN, categoricals as training-domain codes)."""
        X = np.full((len(rows), len(self.features)), np.nan, dtype=self.dtype)
        for i, (name, lut) in enumerate(zip(self.features, self._luts)):
            col = X[:, i]
            for r, row in enumerate(rows):
                if name not in row or row[name] is None:
                    continue
                v = row[name]
                if lut is not None:
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        col[r] = float(v)  # pre-encoded level index
                        continue
                    v = str(v)
                    code = lut.get(v)
                    if code is None:
                        if not self.convert_unknown:
                            raise PredictUnknownCategoricalLevelException(
                                f"Unknown categorical level ({name},{v})",
                                name, v)
                        with self._seen_lock:
                            self.unknown_seen[name] = (
                                self.unknown_seen.get(name, 0) + 1)
                    else:
                        col[r] = code
                else:
                    col[r] = float(v)
        return X


class EasyPredictModelWrapper:
    """Row-dict scoring over a loaded MOJO (`EasyPredictModelWrapper.java`)."""

    def __init__(self, model: MojoModel | str,
                 convert_unknown_categorical_levels_to_na: bool = False):
        if isinstance(model, str):
            model = MojoModel.load(model)
        self.model = model
        self.convert_unknown = convert_unknown_categorical_levels_to_na
        self._features = (model.columns[:-1] if model.supervised
                          else model.columns)
        self._feat_domains = model.domains[:len(self._features)]
        self._resp_domain = (model.domains[-1]
                             if model.supervised else None)
        self.unknown_categorical_levels_seen: dict[str, int] = {}
        self.encoder = RowEncoder(self._features, self._feat_domains,
                                  convert_unknown=self.convert_unknown,
                                  unknown_seen=self
                                  .unknown_categorical_levels_seen)

    # -- row encoding (`easy/RowToRawDataConverter.java`) --------------------
    def _encode_row(self, row: dict) -> np.ndarray:
        return self.encoder.encode([row])[0]

    def _encode_rows(self, rows: list) -> np.ndarray:
        """Vectorized batch path: N row dicts → one (N, F) matrix, so a
        batch scores in ONE model dispatch instead of N."""
        return self.encoder.encode(rows)

    def _score_rows(self, rows: list) -> np.ndarray:
        out = self.model.score(self._encode_rows(rows))
        return np.asarray(out)

    def _score_row(self, row: dict) -> np.ndarray:
        return np.atleast_1d(self._score_rows([row])[0])

    # -- typed per-category entry points -------------------------------------
    def predict_regression(self, row: dict) -> RegressionModelPrediction:
        out = self._score_row(row)
        return RegressionModelPrediction(value=float(out[-1] if out.ndim
                                                     else out))

    def predict_binomial(self, row: dict) -> BinomialModelPrediction:
        out = self._score_row(row)
        probs = [float(p) for p in out[1:]]
        idx = int(out[0])
        dom = self._resp_domain or [str(i) for i in range(len(probs))]
        return BinomialModelPrediction(label=dom[idx], labelIndex=idx,
                                       classProbabilities=probs)

    def predict_multinomial(self, row: dict) -> MultinomialModelPrediction:
        b = self.predict_binomial(row)
        return MultinomialModelPrediction(label=b.label,
                                          labelIndex=b.labelIndex,
                                          classProbabilities=b.classProbabilities)

    def predict_clustering(self, row: dict) -> ClusteringModelPrediction:
        out = self._score_row(row)
        return ClusteringModelPrediction(cluster=int(out[0]))

    def predict_anomaly_detection(self, row: dict) -> AnomalyDetectionPrediction:
        out = self._score_row(row)
        score = float(out[0])
        norm = float(out[1]) if out.shape[0] > 1 else score
        return AnomalyDetectionPrediction(score=score, normalizedScore=norm)

    def predict_dim_reduction(self, row: dict) -> DimReductionModelPrediction:
        out = self._score_row(row)
        return DimReductionModelPrediction(
            dimensions=[float(v) for v in out])

    def predict(self, row: dict):
        """Category-dispatched prediction (`EasyPredictModelWrapper.predict`)."""
        cat = (self.model.category or "").lower()
        return {
            "regression": self.predict_regression,
            "binomial": self.predict_binomial,
            "multinomial": self.predict_multinomial,
            "clustering": self.predict_clustering,
            "anomalydetection": self.predict_anomaly_detection,
            "dimreduction": self.predict_dim_reduction,
        }.get(cat, self.predict_regression)(row)
