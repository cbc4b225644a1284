#!/usr/bin/env python3
"""IVF-PQ recall@10 of the JAX package and of the PyTorch port on the
retrieval bench's full corpus, both built on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/ivfpq_recall_vs_jax.py

The corpus is ``chip_smoke.retrieval_corpus`` (the JAX package's
``bench.py:4208-4213``: 131072 x 64 points in 4096 masses of 32, 256
queries, numpy seed 77); both indexes are built with nlist 256, m 8,
ksub 16, k 10, build seed 1.  Prints recall@10 of each at nprobe 1, 2, 4,
8 and 16, their largest gap, and the wall seconds of each build, as one
JSON line at the end.  Runs on the CPU only; takes minutes.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROBES = (1, 2, 4, 8, 16)


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, HERE)
    import jax
    import numpy as np

    import flink_ml_tpu_torch as T
    from chip_smoke import (RT_D, RT_K, RT_N, RT_NLIST, RT_NQ, RT_PQ,
                            retrieval_corpus)
    from flink_ml_tpu.parallel.mesh import device_mesh, use_mesh
    from flink_ml_tpu.retrieval import IVFIndex as JIVF
    from flink_ml_tpu.retrieval import PQConfig as JPQ
    from flink_ml_tpu_torch.retrieval import exact_neighbors, recall_at_k

    X, queries = retrieval_corpus(RT_N, RT_D, RT_NQ)
    exact = exact_neighbors(queries, X, np.arange(RT_N), RT_K)
    out = {"corpus": [RT_N, RT_D], "queries": RT_NQ, "nlist": RT_NLIST,
           "pq": RT_PQ, "nprobes": list(NPROBES)}
    with use_mesh(device_mesh({"data": 1}, devices=jax.devices()[:1])):
        t0 = time.perf_counter()
        jidx = JIVF.build(X, RT_NLIST, pq=JPQ(**RT_PQ), k=RT_K, seed=1)
        out["jax_build_s"] = time.perf_counter() - t0
        out["jax_recall"] = [
            recall_at_k(jidx.search(queries, nprobe=p)[0], exact)
            for p in NPROBES]
    print(f"jax: {out['jax_recall']} ({out['jax_build_s']:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    tidx = T.IVFIndex.build(X, RT_NLIST, T.PQConfig(**RT_PQ), k=RT_K,
                            seed=1, device="cpu")
    out["port_build_s"] = time.perf_counter() - t0
    out["port_recall"] = [
        recall_at_k(tidx.search(queries, nprobe=p)[0], exact)
        for p in NPROBES]
    print(f"port: {out['port_recall']} ({out['port_build_s']:.1f} s)",
          flush=True)
    out["max_gap"] = max(abs(a - b) for a, b in zip(out["jax_recall"],
                                                    out["port_recall"]))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
