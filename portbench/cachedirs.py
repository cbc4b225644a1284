"""Where a run's build and kernel caches live: fixed directories inside
the checkout, so that only a checkout's first run builds."""

import os


def configure(root: str) -> None:
    """Point the port's library cache (and any torch extension or Triton
    cache) at ``portbench/.kcache`` under ``root``, and keep libraries
    that could load JAX from doing so.  Call before importing torch."""
    cache = os.path.join(root, "portbench", ".kcache")
    os.environ["FLINK_ML_TPU_AOT_CACHE_PATH"] = cache
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
