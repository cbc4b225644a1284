"""flink_ml_tpu_torch — the PyTorch/CUDA port of flink_ml_tpu.

The same Estimator/Transformer/Model/Pipeline API, typed params and
directory save/load as the JAX package, with PyTorch tensors inside and
hand-written CUDA kernels for Hopper (``kernels/csrc``) where the JAX
package wrote Pallas kernels for the TPU.  Ported so far: the linear
family's ``fit``/``transform`` on the Criteo-shaped mixed layout, with the
three ELL kernels.  Entry points run on the card unless the caller passes
``device="cpu"``.  This package imports neither JAX nor ``flink_ml_tpu``.
"""

from .api.pipeline import Pipeline, PipelineModel
from .api.stage import AlgoOperator, Estimator, Model, Stage, Transformer
from .data.table import Table
from .linalg import DenseVector, SparseVector, Vectors
from .models import (
    LinearRegression,
    LinearRegressionModel,
    LinearSVC,
    LinearSVCModel,
    LogisticRegression,
    LogisticRegressionModel,
)
from .params.param import (
    BoolParam,
    DoubleArrayParam,
    DoubleParam,
    FloatArrayParam,
    FloatParam,
    IntArrayParam,
    IntParam,
    InvalidParamError,
    LongParam,
    Param,
    ParamValidators,
    StringArrayParam,
    StringParam,
    VectorParam,
)
from .params.with_params import WithParams

__all__ = [
    "AlgoOperator", "Estimator", "Model", "Stage", "Transformer",
    "Pipeline", "PipelineModel", "Table",
    "DenseVector", "SparseVector", "Vectors",
    "LogisticRegression", "LogisticRegressionModel",
    "LinearRegression", "LinearRegressionModel",
    "LinearSVC", "LinearSVCModel",
    "Param", "ParamValidators", "WithParams", "InvalidParamError",
    "BoolParam", "IntParam", "LongParam", "FloatParam", "DoubleParam",
    "StringParam", "IntArrayParam", "FloatArrayParam", "DoubleArrayParam",
    "StringArrayParam", "VectorParam",
]
