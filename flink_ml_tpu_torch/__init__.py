"""flink_ml_tpu_torch — the PyTorch/CUDA port of flink_ml_tpu.

The same Estimator/Transformer/Model/Pipeline API, typed params and
directory save/load as the JAX package, with PyTorch tensors inside and
hand-written CUDA kernels for Hopper (``kernels/csrc``) where the JAX
package wrote Pallas kernels for the TPU.  Ported so far: the linear
family's ``fit``/``transform`` (LogisticRegression, LinearRegression,
LinearSVC) on dense matrices, sparse ``(indices, values)`` pairs and the
Criteo-shaped mixed layout, with the three ELL kernels (the sparse layout
drives their value variants), and SoftmaxRegression on dense matrices;
the streamed fits (``fit_outofcore`` of the linear family, KMeans and
Wide&Deep) and the online learners (OnlineLogisticRegression, streaming
FTRL, and OnlineKMeans) over windowed streams (``data.stream``) and the
write-ahead window log (``data.wal``);
the Criteo TSV reader (``data.criteo``); the binary, multiclass,
regression and clustering evaluators; KMeans ``fit`` (BSP and workset)
and ``transform``, with the three KMeans kernels; Wide&Deep ``fit``
(routed table gradients, dense and lazy Adam) and ``transform``, with the
routed-gradient fold kernel;
the IVF / IVF-PQ vector index (``IVFIndex.build``, ``search``,
``transform``), with the two fused scan+top-k kernels; the composition
layer (``Graph``, ``CrossValidator``, ``TrainValidationSplit``) and the
chainable feature stages (``models.feature``), whose runs inside a
``PipelineModel`` execute as fused device segments (``api.chain``) ending
in the linear, KMeans, Wide&Deep or IVF terminal; the serving runtime
(``serving``: endpoints, the multi-tenant scheduler, failover) with
train-while-serve publishes (``online``) and the autoscale control plane
(``autoscale``).  Entry points run
on the card unless the caller passes ``device="cpu"``.
This package imports neither JAX nor ``flink_ml_tpu``.
"""

from .api.graph import Graph, GraphBuilder, GraphModel, TableId
from .api.model_selection import (CrossValidator,
                                  CrossValidatorModel,
                                  ParamGridBuilder,
                                  TrainValidationSplit)
from .api.pipeline import Pipeline, PipelineModel
from .api.stage import AlgoOperator, Estimator, Model, Stage, Transformer
from .data.table import Table
from .linalg import DenseVector, SparseVector, Vectors
from .models import (
    KMeans,
    KMeansModel,
    LinearRegression,
    LinearRegressionModel,
    LinearSVC,
    LinearSVCModel,
    LogisticRegression,
    LogisticRegressionModel,
    OnlineKMeans,
    OnlineKMeansModel,
    OnlineLogisticRegression,
    OnlineLogisticRegressionModel,
    SoftmaxRegression,
    SoftmaxRegressionModel,
    WideDeep,
    WideDeepModel,
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
from .retrieval import IVFIndex, PQConfig

__all__ = [
    "AlgoOperator", "Estimator", "Model", "Stage", "Transformer",
    "CrossValidator", "CrossValidatorModel", "ParamGridBuilder",
    "TrainValidationSplit",
    "Pipeline", "PipelineModel", "Table",
    "Graph", "GraphBuilder", "GraphModel", "TableId",
    "DenseVector", "SparseVector", "Vectors",
    "LogisticRegression", "LogisticRegressionModel",
    "LinearRegression", "LinearRegressionModel",
    "LinearSVC", "LinearSVCModel",
    "SoftmaxRegression", "SoftmaxRegressionModel",
    "KMeans", "KMeansModel",
    "OnlineLogisticRegression", "OnlineLogisticRegressionModel",
    "OnlineKMeans", "OnlineKMeansModel",
    "WideDeep", "WideDeepModel",
    "IVFIndex", "PQConfig",
    "Param", "ParamValidators", "WithParams", "InvalidParamError",
    "BoolParam", "IntParam", "LongParam", "FloatParam", "DoubleParam",
    "StringParam", "IntArrayParam", "FloatArrayParam", "DoubleArrayParam",
    "StringArrayParam", "VectorParam",
]
