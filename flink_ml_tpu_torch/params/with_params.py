"""WithParams mixin: param discovery, get/set, JSON round-trip.

Re-design of ``param/WithParams.java:74-142`` +
``util/ParamUtils.java:41-88``.  The reference scans public-final
``Param<?>`` fields reflectively (including interfaces and superclasses);
here we walk the MRO and collect ``Param`` class attributes, which covers the
same "params inherited from mixin interfaces" behavior.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, TypeVar, Union

from .param import InvalidParamError, Param

S = TypeVar("S", bound="WithParams")

__all__ = ["WithParams"]


_PARAMS_CACHE: Dict[type, Dict[str, Param]] = {}


def _declared_params(cls: type) -> Dict[str, Param]:
    """All Param descriptors reachable on ``cls`` via the MRO, keyed by
    param name (mirror of ``ParamUtils.getPublicFinalParamFields``,
    ``util/ParamUtils.java:63-88``).  Cached per class — param sets are
    static after class creation and this runs on every get/set."""
    cached = _PARAMS_CACHE.get(cls)
    if cached is None:
        cached = {}
        for klass in reversed(cls.__mro__):
            for value in vars(klass).values():
                if isinstance(value, Param):
                    cached[value.name] = value
        _PARAMS_CACHE[cls] = cached
    return cached


class WithParams:
    """Base mixin giving any class a typed, validated param map.

    The live values are stored per-instance in ``_param_map``
    (Param -> value), initialised with defaults the way
    ``ParamUtils.initializeMapWithDefaultValues`` does
    (``util/ParamUtils.java:41-52``).
    """

    _param_map: Dict[Param, Any]

    def __init__(self) -> None:
        self._ensure_param_map()

    # -- discovery ----------------------------------------------------------
    def _ensure_param_map(self) -> Dict[Param, Any]:
        if "_param_map" not in self.__dict__:
            self.__dict__["_param_map"] = {
                p: p.default_value for p in _declared_params(type(self)).values()
            }
        return self.__dict__["_param_map"]

    @classmethod
    def params(cls) -> Dict[str, Param]:
        return _declared_params(cls)

    def get_param(self, name: str) -> Optional[Param]:
        """Mirror of ``WithParams.getParam(String)`` (``WithParams.java:60-68``)."""
        return _declared_params(type(self)).get(name)

    # -- get/set ------------------------------------------------------------
    def _resolve(self, param: Union[Param, str]) -> Param:
        if isinstance(param, str):
            resolved = self.get_param(param)
            if resolved is None:
                raise InvalidParamError(
                    f"Parameter {param!r} is not defined on {type(self).__name__}")
            return resolved
        return param

    def set(self: S, param: Union[Param, str], value: Any) -> S:
        """Validate and set; returns self for chaining.  Null values are
        validated too, matching ``WithParams.java:91-95`` which rejects null
        at set time unless the validator accepts it."""
        param = self._resolve(param)
        declared = self.get_param(param.name)
        if declared is None or declared != param:
            raise InvalidParamError(
                f"Parameter {param.name!r} is not defined on {type(self).__name__}")
        if value is None:
            if not _nullable(declared):
                raise InvalidParamError(
                    f"Parameter {declared.name}'s value should not be null")
            self._ensure_param_map()[declared] = None
        else:
            self._ensure_param_map()[declared] = declared.validate(value)
        return self

    def get(self, param: Union[Param, str]) -> Any:
        """Mirror of ``WithParams.get`` (``WithParams.java:102-116``): raises if
        the param has no value and no default."""
        param = self._resolve(param)
        param_map = self._ensure_param_map()
        if param not in param_map:
            raise InvalidParamError(
                f"Parameter {param.name!r} is not defined on {type(self).__name__}")
        value = param_map[param]
        if value is None and param.default_value is None and not _nullable(param):
            raise InvalidParamError(
                f"Parameter {param.name}'s value should not be null")
        return value

    def get_param_map(self) -> Dict[Param, Any]:
        return self._ensure_param_map()

    def param_items(self) -> Iterator:
        return iter(self._ensure_param_map().items())

    # -- JSON ---------------------------------------------------------------
    def params_to_json(self) -> Dict[str, Any]:
        """name -> json value, mirror of the paramMap section written by
        ``ReadWriteUtils.saveMetadata`` (``util/ReadWriteUtils.java:77-96``)."""
        return {
            p.name: p.json_encode(v) for p, v in self._ensure_param_map().items()
        }

    def params_from_json(self, payload: Dict[str, Any]) -> None:
        for name, raw in payload.items():
            param = self.get_param(name)
            if param is None:
                continue  # forward-compatible: unknown params are skipped
            self._ensure_param_map()[param] = (
                None if raw is None else param.json_decode(raw))

    def copy_params_from(self: S, other: "WithParams") -> S:
        for param, value in other.param_items():
            mine = self.get_param(param.name)
            if mine is not None:
                self._ensure_param_map()[mine] = value
        return self


def _nullable(param: Param) -> bool:
    # A param whose validator accepts None is considered nullable.
    try:
        return bool(param.validator(None))
    except Exception:
        return False
