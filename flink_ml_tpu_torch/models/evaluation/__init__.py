from .binary_evaluator import BinaryClassificationEvaluator  # noqa: F401
from .clustering_evaluator import ClusteringEvaluator  # noqa: F401
from .multiclass_evaluator import (  # noqa: F401
    MulticlassClassificationEvaluator,
)
from .ranking_evaluator import RankingEvaluator  # noqa: F401
from .regression_evaluator import RegressionEvaluator  # noqa: F401
