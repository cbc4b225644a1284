from .linearregression import LinearRegression, LinearRegressionModel  # noqa: F401
