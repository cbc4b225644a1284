from .als import ALS, ALSModel, ALSModelParams, ALSParams  # noqa: F401
from .swing import Swing, SwingParams  # noqa: F401
from .widedeep import WideDeep, WideDeepModel  # noqa: F401
