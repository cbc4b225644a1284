from .linearregression import LinearRegression, LinearRegressionModel  # noqa: F401
from .gbtregressor import GBTRegressor, GBTRegressorModel  # noqa: F401
