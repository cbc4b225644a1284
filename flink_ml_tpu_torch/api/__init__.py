from .pipeline import Pipeline, PipelineModel  # noqa: F401
from .stage import AlgoOperator, Estimator, Model, Stage, Transformer  # noqa: F401
