from .logisticregression import LogisticRegression, LogisticRegressionModel  # noqa: F401
from .linearsvc import LinearSVC, LinearSVCModel  # noqa: F401
