"""Framework configuration: the port of the JAX package's
``utils/config.py``.

Mirror of the reference's config surface: it owns exactly one option,
``iteration.data-cache.path`` with a random-tmp fallback
(``config/IterationOptions.java:29-37``, resolved at
``operator/OperatorUtils.java:109-117``); everything else rides host-runtime
config.  Here: a dataclass with env-var overrides (``FLINK_ML_TPU_*``, the
JAX package's names, so one environment configures both packages), a
process-wide instance, and the same tmp-dir fallback semantics.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

from typing import Optional

__all__ = ["FrameworkConfig", "get_config", "set_config", "resolve_cache_dir"]

_ENV_PREFIX = "FLINK_ML_TPU_"


@dataclasses.dataclass
class FrameworkConfig:
    # The analog of iteration.data-cache.path (IterationOptions.java:29-37).
    data_cache_path: Optional[str] = None
    # Default checkpoint interval (epochs) when estimators enable it.
    checkpoint_interval: int = 1
    # matmul dtype policy for estimators that support it ("float32"|"bfloat16")
    compute_dtype: str = "float32"
    # INFO-log period for iteration metrics listeners (0 = silent)
    log_every_epochs: int = 0
    # Root of the durable cache of the nvcc-built kernel libraries and the
    # autotuner's decisions (kernels/aot.py; env
    # FLINK_ML_TPU_AOT_CACHE_PATH).  None: the libraries build into the
    # package's kernels/build/ and nothing is autotuned.
    aot_cache_path: Optional[str] = None

    @staticmethod
    def from_env(base: Optional["FrameworkConfig"] = None) -> "FrameworkConfig":
        cfg = dataclasses.replace(base) if base else FrameworkConfig()
        for field in dataclasses.fields(cfg):
            env_key = _ENV_PREFIX + field.name.upper()
            if env_key in os.environ:
                raw = os.environ[env_key]
                current = getattr(cfg, field.name)
                if field.type in ("int", int) or isinstance(current, int):
                    setattr(cfg, field.name, int(raw))
                else:
                    setattr(cfg, field.name, raw)
        return cfg


_CONFIG: Optional[FrameworkConfig] = None


def get_config() -> FrameworkConfig:
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = FrameworkConfig.from_env()
    return _CONFIG


def set_config(config: FrameworkConfig) -> None:
    global _CONFIG
    _CONFIG = config


def resolve_cache_dir() -> str:
    """Configured path or a fresh random tmp dir
    (``OperatorUtils.java:109-117`` semantics)."""
    configured = get_config().data_cache_path
    if configured:
        os.makedirs(configured, exist_ok=True)
        return configured
    return tempfile.mkdtemp(prefix="flink_ml_tpu_cache_")
