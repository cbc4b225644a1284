from .logisticregression import LogisticRegression, LogisticRegressionModel  # noqa: F401
from .linearsvc import LinearSVC, LinearSVCModel  # noqa: F401
from .naivebayes import NaiveBayes, NaiveBayesModel  # noqa: F401
from .online_logisticregression import (  # noqa: F401
    OnlineLogisticRegression,
    OnlineLogisticRegressionModel,
)
from .softmaxregression import (  # noqa: F401
    SoftmaxRegression,
    SoftmaxRegressionModel,
)
from .knn import KNNClassifier, KNNClassifierModel  # noqa: F401
from .gbtclassifier import GBTClassifier, GBTClassifierModel  # noqa: F401
from .onevsrest import OneVsRest, OneVsRestModel  # noqa: F401
