"""Algorithm library (ported so far: the linear family on every feature
layout with SoftmaxRegression and OnlineLogisticRegression, KMeans and
OnlineKMeans, AgglomerativeClustering, Wide&Deep, the boosted trees (GBTClassifier, GBTRegressor),
NaiveBayes, KNNClassifier and OneVsRest, the recommenders (ALS, Swing),
the evaluators of those families with RankingEvaluator, every feature
stage of the JAX package's ``models/feature``, and the stats tests)."""

from .classification import (  # noqa: F401
    GBTClassifier,
    GBTClassifierModel,
    KNNClassifier,
    KNNClassifierModel,
    LinearSVC,
    LinearSVCModel,
    LogisticRegression,
    LogisticRegressionModel,
    NaiveBayes,
    NaiveBayesModel,
    OnlineLogisticRegression,
    OnlineLogisticRegressionModel,
    SoftmaxRegression,
    SoftmaxRegressionModel,
)
from .clustering import (  # noqa: F401
    AgglomerativeClustering,
    KMeans,
    KMeansModel,
    OnlineKMeans,
    OnlineKMeansModel,
)
from .evaluation import (  # noqa: F401
    BinaryClassificationEvaluator,
    MulticlassClassificationEvaluator,
)
from .feature import (  # noqa: F401
    Binarizer,
    Bucketizer,
    Imputer,
    ImputerModel,
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinMaxScalerModel,
    Normalizer,
    OneHotEncoder,
    OneHotEncoderModel,
    OnlineStandardScaler,
    OnlineStandardScalerModel,
    PolynomialExpansion,
    RobustScaler,
    RobustScalerModel,
    StandardScaler,
    StandardScalerModel,
    StringIndexer,
    StringIndexerModel,
    VectorAssembler,
)
from .recommendation import ALS, ALSModel, WideDeep, WideDeepModel  # noqa: F401
from .stats import ChiSqTest  # noqa: F401
from .regression import (  # noqa: F401
    GBTRegressor,
    GBTRegressorModel,
    LinearRegression,
    LinearRegressionModel,
)
