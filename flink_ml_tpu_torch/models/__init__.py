"""Algorithm library (ported so far: the linear family on the mixed
layout, KMeans, and Wide&Deep)."""

from .classification import (  # noqa: F401
    LinearSVC,
    LinearSVCModel,
    LogisticRegression,
    LogisticRegressionModel,
)
from .clustering import KMeans, KMeansModel  # noqa: F401
from .recommendation import WideDeep, WideDeepModel  # noqa: F401
from .regression import LinearRegression, LinearRegressionModel  # noqa: F401
