"""Algorithm library (ported so far: the linear family on the mixed
layout)."""

from .classification import (  # noqa: F401
    LinearSVC,
    LinearSVCModel,
    LogisticRegression,
    LogisticRegressionModel,
)
from .regression import LinearRegression, LinearRegressionModel  # noqa: F401
