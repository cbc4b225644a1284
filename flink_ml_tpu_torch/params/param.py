"""Typed, validated, JSON-codable hyperparameters.

Re-design of the reference param system
(``flink-ml-api/.../param/Param.java:33-79`` and the twelve typed param
classes).  The reference discovers params by reflecting over public-final
``Param<?>`` fields (``util/ParamUtils.java:41-88``); here params are plain
class attributes (descriptors) discovered by walking the MRO — no reflection
tricks needed in Python.
"""

from __future__ import annotations

import numpy as np

from typing import Any, Callable, Generic, Optional, Sequence, TypeVar

T = TypeVar("T")

__all__ = [
    "Param",
    "IntParam",
    "LongParam",
    "FloatParam",
    "DoubleParam",
    "BoolParam",
    "StringParam",
    "IntArrayParam",
    "FloatArrayParam",
    "DoubleArrayParam",
    "StringArrayParam",
    "VectorParam",
    "ParamValidator",
    "ParamValidators",
    "InvalidParamError",
]


class InvalidParamError(ValueError):
    """Raised when a param value fails validation (reference throws
    IllegalArgumentException from ``WithParams.set``, ``WithParams.java:74-95``)."""


ParamValidator = Callable[[Any], bool]


class ParamValidators:
    """Factory of validators mirroring ``param/ParamValidators.java:27-90``."""

    @staticmethod
    def always_true() -> ParamValidator:
        return lambda value: True

    @staticmethod
    def gt(lower: float) -> ParamValidator:
        return lambda value: value is not None and value > lower

    @staticmethod
    def gt_eq(lower: float) -> ParamValidator:
        return lambda value: value is not None and value >= lower

    @staticmethod
    def lt(upper: float) -> ParamValidator:
        return lambda value: value is not None and value < upper

    @staticmethod
    def lt_eq(upper: float) -> ParamValidator:
        return lambda value: value is not None and value <= upper

    @staticmethod
    def in_range(lower: float, upper: float,
                 lower_inclusive: bool = True,
                 upper_inclusive: bool = True) -> ParamValidator:
        def check(value: Any) -> bool:
            if value is None:
                return False
            lo_ok = value >= lower if lower_inclusive else value > lower
            hi_ok = value <= upper if upper_inclusive else value < upper
            return lo_ok and hi_ok
        return check

    @staticmethod
    def in_array(allowed: Sequence[Any]) -> ParamValidator:
        allowed_set = list(allowed)
        return lambda value: value in allowed_set

    @staticmethod
    def not_null() -> ParamValidator:
        return lambda value: value is not None

    @staticmethod
    def non_empty_array() -> ParamValidator:
        return lambda value: value is not None and len(value) > 0


class Param(Generic[T]):
    """A named, typed, validated hyperparameter.

    Mirrors ``param/Param.java:33-58`` (name / clazz / description / default /
    validator) plus ``jsonEncode``/``jsonDecode`` (``Param.java:66-79``).

    Params double as Python descriptors so ``stage.max_iter`` reads the
    current value while ``MyParams.MAX_ITER`` (class access) yields the Param
    object itself for use with ``get``/``set``.
    """

    value_type: type = object

    def __init__(self, name: str, description: str = "",
                 default: Optional[T] = None,
                 validator: Optional[ParamValidator] = None):
        self.name = name
        self.description = description
        self.validator = validator or ParamValidators.always_true()
        if default is not None:
            default = self.coerce(default)
            if not self.validator(default):
                raise InvalidParamError(
                    f"Invalid default value {default!r} for param {name!r}")
        self.default_value = default

    # -- value handling -----------------------------------------------------
    def coerce(self, value: Any) -> T:
        """Normalise a user-supplied value to the canonical runtime type."""
        return value

    def validate(self, value: Any) -> T:
        value = self.coerce(value)
        if not self.validator(value):
            raise InvalidParamError(
                f"Parameter {self.name} is given an invalid value {value!r}")
        return value

    # -- JSON ---------------------------------------------------------------
    def json_encode(self, value: T) -> Any:
        return value

    def json_decode(self, payload: Any) -> T:
        return self.coerce(payload)

    # -- descriptor protocol ------------------------------------------------
    def __set_name__(self, owner: type, attr_name: str) -> None:
        self._attr_name = attr_name
        self._owner = owner

    def __reduce__(self):
        # pickled by reference to the class attribute that declares it (its
        # validator is a lambda): a stage's param map crosses processes
        owner = getattr(self, "_owner", None)
        if owner is None:
            return super().__reduce__()
        return (getattr, (owner, self._attr_name))

    def __get__(self, obj: Any, objtype: Optional[type] = None):
        if obj is None:
            return self
        return obj.get(self)

    def __set__(self, obj: Any, value: Any) -> None:
        obj.set(self, value)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}({self.name!r}, default={self.default_value!r})"

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.name))

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, Param) and other.name == self.name
                and type(other) is type(self))


class IntParam(Param[int]):
    value_type = int

    def coerce(self, value: Any) -> int:
        if isinstance(value, bool):
            raise InvalidParamError(f"Param {self.name} expects int, got bool")
        return int(value)


class LongParam(IntParam):
    """Alias — Python ints are arbitrary precision (reference LongParam)."""


class FloatParam(Param[float]):
    value_type = float

    def coerce(self, value: Any) -> float:
        return float(value)


class DoubleParam(FloatParam):
    """Alias — Python floats are doubles (reference DoubleParam)."""


class BoolParam(Param[bool]):
    value_type = bool

    def coerce(self, value: Any) -> bool:
        if not isinstance(value, (bool, np.bool_)):
            raise InvalidParamError(f"Param {self.name} expects bool, got {value!r}")
        return bool(value)


class StringParam(Param[str]):
    value_type = str

    def coerce(self, value: Any) -> str:
        if value is None:
            return value
        if not isinstance(value, str):
            raise InvalidParamError(f"Param {self.name} expects str, got {value!r}")
        return value


class _ArrayParam(Param[tuple]):
    element_coerce: Callable[[Any], Any] = staticmethod(lambda x: x)

    def coerce(self, value: Any) -> tuple:
        if value is None:
            return value
        if isinstance(value, (str, bytes)):
            raise InvalidParamError(
                f"Param {self.name} expects a sequence, got {value!r} "
                "(wrap single values in a list)")
        if isinstance(value, np.ndarray):
            value = value.tolist()
        return tuple(type(self).element_coerce(v) for v in value)

    def json_encode(self, value: tuple) -> Any:
        return None if value is None else list(value)


class IntArrayParam(_ArrayParam):
    element_coerce = staticmethod(int)


class FloatArrayParam(_ArrayParam):
    element_coerce = staticmethod(float)


class DoubleArrayParam(FloatArrayParam):
    pass


class StringArrayParam(_ArrayParam):
    element_coerce = staticmethod(str)


class VectorParam(Param[np.ndarray]):
    """Dense vector-valued param (reference ``VectorParam`` over DenseVector)."""

    value_type = np.ndarray

    def coerce(self, value: Any) -> np.ndarray:
        if value is None:
            return value
        return np.asarray(value, dtype=np.float64)

    def json_encode(self, value: np.ndarray) -> Any:
        return None if value is None else np.asarray(value).tolist()

    def json_decode(self, payload: Any) -> np.ndarray:
        return None if payload is None else np.asarray(payload, dtype=np.float64)
