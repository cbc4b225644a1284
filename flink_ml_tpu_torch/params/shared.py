"""Shared ``Has*`` param mixins.

Mirrors the reference's shared mixin interfaces in
``flink-ml-lib/.../common/param/`` (HasDistanceMeasure, HasFeaturesCol,
HasPredictionCol, HasSeed, HasMaxIter) and extends the set with the params
the linear/streaming estimators in BASELINE.json need.
"""

from __future__ import annotations

from .param import (
    FloatParam,
    IntParam,
    ParamValidators,
    StringArrayParam,
    StringParam,
)
from .with_params import WithParams

__all__ = [
    "HasDistanceMeasure",
    "HasFeaturesCol",
    "HasLabelCol",
    "HasWeightCol",
    "HasPredictionCol",
    "HasRawPredictionCol",
    "HasSeed",
    "HasMaxIter",
    "HasTol",
    "HasLearningRate",
    "HasRegParam",
    "HasElasticNet",
    "HasGlobalBatchSize",
    "HasBatchStrategy",
    "HasOutputCol",
    "HasInputCols",
    "HasOutputCols",
]


class HasDistanceMeasure(WithParams):
    """``common/param/HasDistanceMeasure.java`` — metric name resolved through
    the DistanceMeasure registry (§2.1 distance)."""

    DISTANCE_MEASURE = StringParam(
        "distanceMeasure", "Distance measure name.", default="euclidean",
        validator=ParamValidators.in_array(["euclidean", "cosine", "manhattan"]))

    def get_distance_measure(self) -> str:
        return self.get(HasDistanceMeasure.DISTANCE_MEASURE)

    def set_distance_measure(self, value: str):
        return self.set(HasDistanceMeasure.DISTANCE_MEASURE, value)


class HasFeaturesCol(WithParams):
    FEATURES_COL = StringParam(
        "featuresCol", "Features column name.", default="features",
        validator=ParamValidators.not_null())

    def get_features_col(self) -> str:
        return self.get(HasFeaturesCol.FEATURES_COL)

    def set_features_col(self, value: str):
        return self.set(HasFeaturesCol.FEATURES_COL, value)


class HasLabelCol(WithParams):
    LABEL_COL = StringParam(
        "labelCol", "Label column name.", default="label",
        validator=ParamValidators.not_null())

    def get_label_col(self) -> str:
        return self.get(HasLabelCol.LABEL_COL)

    def set_label_col(self, value: str):
        return self.set(HasLabelCol.LABEL_COL, value)


class HasWeightCol(WithParams):
    WEIGHT_COL = StringParam(
        "weightCol", "Sample-weight column name (optional).", default=None)

    def get_weight_col(self):
        return self.get(HasWeightCol.WEIGHT_COL)

    def set_weight_col(self, value: str):
        return self.set(HasWeightCol.WEIGHT_COL, value)


class HasPredictionCol(WithParams):
    PREDICTION_COL = StringParam(
        "predictionCol", "Prediction column name.", default="prediction",
        validator=ParamValidators.not_null())

    def get_prediction_col(self) -> str:
        return self.get(HasPredictionCol.PREDICTION_COL)

    def set_prediction_col(self, value: str):
        return self.set(HasPredictionCol.PREDICTION_COL, value)


class HasRawPredictionCol(WithParams):
    RAW_PREDICTION_COL = StringParam(
        "rawPredictionCol", "Raw prediction (margin / probability) column name.",
        default="rawPrediction")

    def get_raw_prediction_col(self) -> str:
        return self.get(HasRawPredictionCol.RAW_PREDICTION_COL)

    def set_raw_prediction_col(self, value: str):
        return self.set(HasRawPredictionCol.RAW_PREDICTION_COL, value)


class HasSeed(WithParams):
    """``common/param/HasSeed.java`` — default differs from the reference
    (System.nanoTime) so runs are reproducible unless overridden."""

    SEED = IntParam("seed", "PRNG seed.", default=0)

    def get_seed(self) -> int:
        return self.get(HasSeed.SEED)

    def set_seed(self, value: int):
        return self.set(HasSeed.SEED, value)


class HasMaxIter(WithParams):
    MAX_ITER = IntParam(
        "maxIter", "Maximum number of iterations.", default=20,
        validator=ParamValidators.gt(0))

    def get_max_iter(self) -> int:
        return self.get(HasMaxIter.MAX_ITER)

    def set_max_iter(self, value: int):
        return self.set(HasMaxIter.MAX_ITER, value)


class HasTol(WithParams):
    TOL = FloatParam(
        "tol", "Convergence tolerance on the iteration criterion.",
        default=1e-6, validator=ParamValidators.gt_eq(0))

    def get_tol(self) -> float:
        return self.get(HasTol.TOL)

    def set_tol(self, value: float):
        return self.set(HasTol.TOL, value)


class HasLearningRate(WithParams):
    LEARNING_RATE = FloatParam(
        "learningRate", "Step size for gradient updates.", default=0.1,
        validator=ParamValidators.gt(0))

    def get_learning_rate(self) -> float:
        return self.get(HasLearningRate.LEARNING_RATE)

    def set_learning_rate(self, value: float):
        return self.set(HasLearningRate.LEARNING_RATE, value)


class HasRegParam(WithParams):
    REG = FloatParam(
        "reg", "L2 regularization strength.", default=0.0,
        validator=ParamValidators.gt_eq(0))

    def get_reg(self) -> float:
        return self.get(HasRegParam.REG)

    def set_reg(self, value: float):
        return self.set(HasRegParam.REG, value)


class HasElasticNet(WithParams):
    ELASTIC_NET = FloatParam(
        "elasticNet", "Elastic-net mixing: 0 = pure L2, 1 = pure L1.",
        default=0.0, validator=ParamValidators.in_range(0.0, 1.0))

    def get_elastic_net(self) -> float:
        return self.get(HasElasticNet.ELASTIC_NET)

    def set_elastic_net(self, value: float):
        return self.set(HasElasticNet.ELASTIC_NET, value)


class HasGlobalBatchSize(WithParams):
    GLOBAL_BATCH_SIZE = IntParam(
        "globalBatchSize",
        "Global (across all devices) mini-batch size.  None = auto: 32, "
        "except mixed/sparse hashed linear fits size the batch so the ELL "
        "scatter kernel's layout fits its HBM budget "
        "(sgd.resolve_global_batch_size).",
        default=None,
        validator=lambda v: v is None or v > 0)

    def get_global_batch_size(self) -> int:
        return self.get(HasGlobalBatchSize.GLOBAL_BATCH_SIZE)

    def set_global_batch_size(self, value: int):
        return self.set(HasGlobalBatchSize.GLOBAL_BATCH_SIZE, value)


class HasNumFeatures(WithParams):
    NUM_FEATURES = IntParam(
        "numFeatures",
        "Feature-space size for hashed sparse input (pair columns); 0 = "
        "derive from the data (dense input or SparseVector.size).",
        default=0, validator=ParamValidators.gt_eq(0))

    def get_num_features(self) -> int:
        return self.get(HasNumFeatures.NUM_FEATURES)

    def set_num_features(self, value: int):
        return self.set(HasNumFeatures.NUM_FEATURES, value)


class HasBatchStrategy(WithParams):
    BATCH_STRATEGY = StringParam(
        "batchStrategy", "Mini-batch strategy.", default="count",
        validator=ParamValidators.in_array(["count"]))

    def get_batch_strategy(self) -> str:
        return self.get(HasBatchStrategy.BATCH_STRATEGY)


class HasOutputCol(WithParams):
    OUTPUT_COL = StringParam("outputCol", "Output column name.",
                             default="output")

    def get_output_col(self) -> str:
        return self.get(HasOutputCol.OUTPUT_COL)

    def set_output_col(self, value: str):
        return self.set(HasOutputCol.OUTPUT_COL, value)


class HasInputCols(WithParams):
    INPUT_COLS = StringArrayParam("inputCols", "Input column names.",
                                  default=None)

    def get_input_cols(self):
        return self.get(HasInputCols.INPUT_COLS)

    def set_input_cols(self, *cols: str):
        return self.set(HasInputCols.INPUT_COLS, cols)


class HasOutputCols(WithParams):
    OUTPUT_COLS = StringArrayParam("outputCols", "Output column names.",
                                   default=None)

    def get_output_cols(self):
        return self.get(HasOutputCols.OUTPUT_COLS)

    def set_output_cols(self, *cols: str):
        return self.set(HasOutputCols.OUTPUT_COLS, cols)
