"""Vector retrieval: IVF / IVF-PQ index build and search, with the fused
scan+top-k kernels of ``ops/retrieve.py``."""

from .ivf import IVFIndex, PQConfig, SearchPlan, retrieve_sig
from .metrics import RecallProbe, exact_neighbors, recall_at_k

__all__ = [
    "IVFIndex",
    "PQConfig",
    "RecallProbe",
    "SearchPlan",
    "exact_neighbors",
    "recall_at_k",
    "retrieve_sig",
]
