from .logisticregression import LogisticRegression, LogisticRegressionModel  # noqa: F401
from .linearsvc import LinearSVC, LinearSVCModel  # noqa: F401
from .online_logisticregression import (  # noqa: F401
    OnlineLogisticRegression,
    OnlineLogisticRegressionModel,
)
from .softmaxregression import (  # noqa: F401
    SoftmaxRegression,
    SoftmaxRegressionModel,
)
