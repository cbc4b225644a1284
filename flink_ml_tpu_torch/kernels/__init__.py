"""The control plane of the port's kernels and their hand-written CUDA
sources (``csrc/``): the build and its durable library cache
(:mod:`.build`, :mod:`.aot`), the registry every consumer resolves its
implementation through (:mod:`.registry`, :mod:`.catalog`), and measured,
persisted backend choices (:mod:`.autotune`)."""

from . import aot, autotune  # noqa: F401
from .registry import (  # noqa: F401
    KernelEntry,
    KernelStats,
    backends,
    cuda_only,
    dispatch,
    dispatch_count,
    kernel_stats,
    lookup,
    ops,
    register_kernel,
)
