from .widedeep import WideDeep, WideDeepModel  # noqa: F401
