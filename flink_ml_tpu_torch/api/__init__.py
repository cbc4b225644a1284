from .chain import (  # noqa: F401
    StageKernel,
    chain_disabled,
    compile_pipeline,
)
from .stage import AlgoOperator, Estimator, Model, Stage, Transformer  # noqa: F401
from .graph import Graph, GraphBuilder, GraphModel, TableId  # noqa: F401
from .pipeline import Pipeline, PipelineModel  # noqa: F401
from .model_selection import (  # noqa: F401
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
)
