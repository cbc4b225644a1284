"""The registration catalog: importing this module imports every module
that registers kernels, so ``registry.lookup``/``ops()`` see the full
table whichever consumer asked first.

Registrations live NEXT TO their implementations (an op's shape contract
is the kernel's own business, its planning policy the model's):

- ``ops/ell_scatter.py``      — ``ell_margin``, ``ell_scatter_apply``
  (B1-B3: ``"cuda"``, ``"cuda-pair"``, ``"plain"``)
- ``ops/emb_grad.py``         — ``routed_table_grad`` (B7)
- ``models/common/gbt.py``    — ``gbt_level_histograms`` (``"segsum"``,
  ``"mxu"``)
- ``models/common/linear.py`` — ``linear_margins`` (stage convention)
- ``models/clustering/kmeans.py`` — ``kmeans_assign`` (stage, B5),
  ``kmeans_update_stats`` (B4), ``kmeans_workset_update`` (B6)
- ``models/recommendation/widedeep.py`` — ``widedeep_scores`` (stage)
- ``ops/int8_serving.py``     — ``"int8"`` backends of ``linear_margins``,
  ``kmeans_assign``, ``widedeep_scores`` (forced lookup only: the
  servable's bind path quantizes the params they consume)
- ``retrieval/ivf.py`` with ``ops/retrieve.py`` — ``retrieve`` (stage
  convention; B8 and B9)

This module is imported lazily by ``registry._ensure_catalog`` (first
lookup), never at ``flink_ml_tpu_torch.kernels`` import: that keeps the
registry itself dependency-free and cycle-safe.
"""

from ..ops import ell_scatter, emb_grad, int8_serving  # noqa: F401
from ..models.clustering import kmeans  # noqa: F401
from ..models.common import gbt, linear  # noqa: F401
from ..models.recommendation import widedeep  # noqa: F401
from ..retrieval import ivf  # noqa: F401
