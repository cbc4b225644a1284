"""IVF / IVF-PQ vector index: build, search, incremental updates.

A port of the JAX package's ``retrieval/ivf.py``, single device.

**Index layout.**  ``IVFIndex.build(vectors, nlist, pq=None)`` trains the
coarse quantizer with the port's workset KMeans fit
(``models/clustering/kmeans.py``, on the index's device), refines its
balance, then assigns every vector to its nearest centroid's posting
list.  Lists are padded row blocks: each list occupies ``block``
contiguous rows of one packed ``(nlist*block, d)`` array (``offsets`` are
the CSR offsets of the REAL rows), padded with exact zeros; pad rows carry
id ``-1`` and are masked inert inside the scan.

**PQ variant.**  ``pq=PQConfig(m, ksub)`` stores residuals (vector minus
its coarse centroid) as ``m`` int8 codes per vector against per-subspace
codebooks, trained with the same workset KMeans on each residual subspace
and stored through ``kernels/quantize.py::quantize_rows``; encoding
argmins against the DECODED book, the values the scan uses.

**Search.**  One launch per search of the fused scan+top-k kernel
(``ops/retrieve.py``) on a CUDA index; on the CPU its plain version.
``params`` stays the canonical numpy dict, as in the JAX package; the
index copies it to ``device`` at its first search and keeps the copy for
as long as it serves the same ``params`` object.

**Updates.**  ``updated(inserts, delete_ids)`` edits posting-list blocks
(swap-remove deletes, free-slot inserts) and reports ``"delta"``; when a
list overflows its block or the centroid drift (max per-list ||member mean
- centroid|| over the centroid RMS norm) crosses ``drift_threshold``, it
reports ``"reanchor"`` with a freshly built index instead.

``transform`` and the chain terminal (``transform_kernel``,
``api/chain.py``) call the same retrieve wrappers as ``search`` on the
index's cached device params; ``serving/executor.py`` serves an index
through that terminal, an index is a ``SharedScheduler`` tenant like a
model, and an ``updated`` generation reaches serving through the online
publish protocol (``online/driver.py::publish_index_update``: a
``"delta"`` ships the touched rows through ``params_of_model`` ->
``rebound``; a ``"reanchor"`` ships the rebuilt index whole, or through a
warmed redeploy when its shapes changed).  The build helpers
are numpy and array-for-array the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api.chain import StageKernel, numeric_entry, run_kernel
from ..data.table import Table
from ..kernels.quantize import quantize_rows
from ..kernels.registry import cuda_only, lookup, on_cuda, register_kernel
from ..ops import retrieve as R
from ..utils.device import resolve_device
from ..utils.padding import pad_rows_to_block, require_block_rows

__all__ = ["IVFIndex", "PQConfig", "SearchPlan", "retrieve_sig"]


#: the chain terminal's staging columns, mapped by its host ``post``
_NN_STAGE = "__retrieve_nn__"
_DIST_STAGE = "__retrieve_dist__"


def _scan(p: Dict[str, torch.Tensor], q: torch.Tensor, nprobe: int, k: int,
          nlist: int, block: int, m: Optional[int], flat_fn, pq_fn):
    """One search of ``q (b, d)`` over the device params ``p``: the flat
    search, or the PQ search with ``m`` subspaces."""
    shape = dict(nprobe=nprobe, k=k, nlist=nlist, block=block)
    if m is None:
        return flat_fn(q, p["centroids"], p["ids"], p["vecs"], **shape)
    return pq_fn(q, p["centroids"], p["ids"], p["codes"], p["cb_q"],
                 p["cb_s"], m=m, **shape)


def _ivf_chain_kernel(static, params, cols):
    """Chain-terminal search: the stage of op ``retrieve`` the kernel
    registry resolves at ``retrieve_sig + (device type,)`` (the B8/B9
    kernels on the card, their plain versions on the CPU)."""
    (qcol, nprobe, k, nlist, block, m) = static
    q = cols[qcol]
    pq = m is not None
    sig = retrieve_sig(nprobe, k, int(q.shape[1]), m if pq else 0,
                       int(params["cb_q"].shape[1]) if pq else 0, nlist,
                       block) + (q.device.type,)
    return lookup("retrieve", sig).fn(static, params, cols)


def _retrieve_stage(static, params, cols, flat_fn, pq_fn):
    (qcol, nprobe, k, nlist, block, m) = static
    q = cols[qcol].to(torch.float32).contiguous()
    nn, dist = _scan(params, q, nprobe, k, nlist, block, m, flat_fn, pq_fn)
    return {_NN_STAGE: nn, _DIST_STAGE: dist}


def _retrieve_stage_cuda(static, params, cols):
    """Op ``retrieve``, backend ``"cuda"``: one call of the flat or IVF-PQ
    search kernel (whose wrapper raises on a shape it cannot take)."""
    return _retrieve_stage(static, params, cols, R._retrieve_flat_cuda,
                           R._retrieve_pq_cuda)


def _retrieve_stage_plain(static, params, cols):
    """Op ``retrieve``, backend ``"plain"``: the kernels' plain versions
    (the counterpart of the JAX package's ``"xla"`` stage)."""
    return _retrieve_stage(static, params, cols, R.retrieve_flat_plain,
                           R.retrieve_pq_plain)


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Product-quantization config: ``m`` subspaces of ``dim // m``
    components each, ``ksub`` codebook entries per subspace (int8 codes,
    so at most 127), trained for ``max_iter`` workset-KMeans rounds."""

    m: int
    ksub: int = 16
    max_iter: int = 8


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """The planned search: the signature and the backend of op
    ``retrieve`` (``"cuda"``: the kernel; ``"plain"``: its plain version,
    on the CPU)."""

    sig: tuple
    backend: str


def retrieve_sig(nprobe: int, k: int, dim: int, m: int, ksub: int,
                 nlist: int, block: int) -> tuple:
    """The retrieve signature: one kernel schema per (nprobe, k, dim, pq)
    point; ``m == 0`` is the flat-f32 scan."""
    return (nprobe, k, dim, m, ksub, nlist, block)


class IVFIndex:
    """A built IVF / IVF-PQ index: params + host bookkeeping.

    ``params`` is the canonical numpy dict: ``centroids`` (nlist, d) f32,
    ``ids`` (nlist, block) int32 (-1 = empty slot), ``counts`` (nlist,)
    int32, and either ``vecs`` (nlist*block, d) f32 (flat) or ``codes``
    (nlist*block, m) int8 + ``cb_q``/``cb_s`` codebooks (PQ).  The
    id->vector store (drift, re-anchor, exact-scan probes) is host-side
    only.  ``device`` is where builds fit and searches run (default
    ``"cuda"``; raises without a card unless ``"cpu"`` is asked for)."""

    query_col = "query"
    neighbors_col = "neighbors"
    distances_col = "distances"

    def __init__(self, *, params: Dict[str, np.ndarray], nlist: int,
                 block: int, dim: int, k: int, nprobe: int,
                 pq: Optional[PQConfig], seed: int, list_slack: int,
                 drift_threshold: Optional[float], max_iter: int,
                 store: Dict[int, np.ndarray], device="cuda"):
        self.params = params
        self.nlist = int(nlist)
        self.block = int(block)
        self.dim = int(dim)
        self.k = int(k)
        self.nprobe = int(nprobe)
        self.pq = pq
        self.seed = int(seed)
        self.list_slack = int(list_slack)
        self.drift_threshold = drift_threshold
        self.max_iter = int(max_iter)
        self.device = device
        self.build_times: Dict[str, float] = {}
        self.build_fits: List[Tuple[str, str, int]] = []
        self._store = store
        self._drop_device_copy()

    # -- build --------------------------------------------------------------
    @classmethod
    def build(cls, vectors, nlist: int, pq: Optional[PQConfig] = None, *,
              k: int = 10, nprobe: Optional[int] = None,
              ids=None, seed: int = 0, list_slack: int = 8,
              drift_threshold: Optional[float] = 0.25, max_iter: int = 10,
              block: Optional[int] = None, device="cuda") -> "IVFIndex":
        """Train the coarse quantizer (workset KMeans fit on ``device``),
        assign vectors to padded posting-list row blocks, and (PQ) encode
        residuals.

        ``block`` (rows per list, a multiple of 8) is normally sized to
        the fullest list plus ``list_slack`` insert headroom; passing it
        pins the shapes (the same-shape re-anchor uses this).  The wall
        seconds of the build's parts land in ``index.build_times``: the
        coarse fit, the balance refinement and assignment, the PQ fits,
        and the packing (with the PQ encode and the id store).  Each
        KMeans fit's ``(name, planned_impl, rounds)`` lands in
        ``index.build_fits``."""
        resolve_device(device)
        vectors = np.ascontiguousarray(np.asarray(vectors, np.float32))
        if vectors.ndim != 2 or vectors.shape[0] == 0:
            raise ValueError("vectors must be a non-empty (n, d) array")
        n, dim = vectors.shape
        if not 1 <= nlist <= n:
            raise ValueError(f"nlist={nlist} must be in [1, n={n}]")
        ids = (np.arange(n, dtype=np.int32) if ids is None
               else np.asarray(ids, np.int32))
        if ids.shape != (n,) or len(set(ids.tolist())) != n:
            raise ValueError("ids must be n unique int32 values")
        if np.any(ids < 0):
            raise ValueError("ids must be non-negative (-1 marks pad "
                             "slots in the posting lists)")
        if pq is not None:
            if dim % pq.m:
                raise ValueError(f"PQ m={pq.m} must divide dim={dim}")
            if not 2 <= pq.ksub <= 127:
                raise ValueError("PQ ksub must be in [2, 127] (int8 "
                                 "codes)")
            if n < pq.ksub:
                raise ValueError(f"PQ needs n >= ksub={pq.ksub}")

        times: Dict[str, float] = {}
        t0 = time.perf_counter()
        fits: List[Tuple[str, str, int]] = []
        centroids = _workset_fit(vectors, nlist, seed, max_iter, device,
                                 fits, "coarse")
        t1 = time.perf_counter()
        times["coarse_fit_s"] = t1 - t0
        centroids = _refine_balance(centroids, vectors)
        assign = _nearest_list(centroids, vectors)
        counts = np.bincount(assign, minlength=nlist).astype(np.int32)
        need = int(counts.max()) if n else 1
        if block is None:
            block = _round_up8(max(need + list_slack, 8))
        elif need > block:
            raise ValueError(f"block={block} cannot hold the fullest "
                             f"list ({need} rows)")
        require_block_rows(block, 8, op="retrieve")

        ids2 = np.full((nlist, block), -1, np.int32)
        rows_of: List[np.ndarray] = []
        for lst in range(nlist):
            rows = np.flatnonzero(assign == lst)
            rows_of.append(rows)
            ids2[lst, :rows.size] = ids[rows]
        params: Dict[str, np.ndarray] = {
            "centroids": centroids,
            "ids": ids2,
            "counts": counts,
        }
        t2 = time.perf_counter()
        times["balance_assign_s"] = t2 - t1
        if pq is None:
            params["vecs"] = _pack_blocks(vectors, rows_of, block, dim,
                                          np.float32)
        else:
            cb_q, cb_s = _fit_codebooks(
                vectors - centroids[assign], pq, seed, max_iter, device,
                fits)
            times["pq_fit_s"] = time.perf_counter() - t2
            codes = _encode_pq(vectors - centroids[assign], cb_q, cb_s)
            params["codes"] = _pack_blocks(codes, rows_of, block, pq.m,
                                           np.int8)
            params["cb_q"], params["cb_s"] = cb_q, cb_s
        store = {int(i): vectors[j].copy()
                 for j, i in enumerate(ids.tolist())}
        times["pack_encode_s"] = (time.perf_counter() - t2
                                  - times.get("pq_fit_s", 0.0))
        index = cls(params=params, nlist=nlist, block=block, dim=dim, k=k,
                    nprobe=(max(1, nlist // 8) if nprobe is None
                            else int(nprobe)),
                    pq=pq, seed=seed, list_slack=list_slack,
                    drift_threshold=drift_threshold, max_iter=max_iter,
                    store=store, device=device)
        index.build_times = times
        index.build_fits = fits
        return index

    # -- search planning ----------------------------------------------------
    def sig(self) -> tuple:
        pq = self.pq
        return retrieve_sig(self.nprobe, self.k, self.dim,
                            pq.m if pq else 0, pq.ksub if pq else 0,
                            self.nlist, self.block)

    def search_plan(self) -> SearchPlan:
        """The signature and the backend a search takes, as the kernel
        registry resolves op ``retrieve`` at ``sig() + (device type,)``:
        ``"cuda"`` (the kernel, whose wrapper raises on a shape it cannot
        take) on a CUDA index, ``"plain"`` (the plain version) on the
        CPU."""
        dev = resolve_device(self.device)
        entry = lookup("retrieve", self.sig() + (dev.type,))
        return SearchPlan(sig=self.sig(), backend=entry.backend)

    def with_options(self, *, nprobe: Optional[int] = None,
                     k: Optional[int] = None) -> "IVFIndex":
        """A view of the same index at a different operating point (new
        schema, the same posting lists and the same device copy of them)."""
        out = IVFIndex.__new__(IVFIndex)
        out.__dict__.update(self.__dict__)
        if nprobe is not None:
            if not 1 <= nprobe <= self.nlist:
                raise ValueError(f"nprobe={nprobe} not in [1, "
                                 f"nlist={self.nlist}]")
            out.nprobe = int(nprobe)
        if k is not None:
            out.k = int(k)
        return out

    def transform_kernel(self, schema):
        """Chain TERMINAL: the search of :meth:`search_tensors` (the
        retrieve kernel on a CUDA index, one launch) over the segment's
        query column, on the index's cached device params."""
        if numeric_entry(schema, self.query_col) is None:
            return None
        ncol, dcol = self.neighbors_col, self.distances_col

        def post(host):
            return {ncol: host[_NN_STAGE].astype(np.int64),
                    dcol: host[_DIST_STAGE]}

        return StageKernel(
            fn=_ivf_chain_kernel,
            static=(self.query_col, self.nprobe, self.k, self.nlist,
                    self.block, None if self.pq is None else self.pq.m),
            params=self.device_params(),
            consumes=(self.query_col,),
            produces=(_NN_STAGE, _DIST_STAGE), post=post,
            device=self.device)

    # -- search -------------------------------------------------------------
    def _drop_device_copy(self) -> None:
        # a fresh holder: clones that change params must not share it
        self._device_copy: Dict[str, Any] = {}

    def device_params(self) -> Dict[str, torch.Tensor]:
        """``params`` as tensors on ``device``, copied at the first search
        and reused while ``params`` is the same object (``with_options``
        views share the copy; ``updated``/``rebound`` clones start
        without one)."""
        dev = resolve_device(self.device)
        cache = self._device_copy
        if cache.get("params") is not self.params or cache.get("dev") != dev:
            cache.clear()
            cache.update(params=self.params, dev=dev, tensors={
                name: torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
                for name, arr in self.params.items()})
        return cache["tensors"]

    def search_tensors(self, q: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The search on device tensors: ``q (b, d)`` f32 on ``device`` ->
        ``(neighbors (b, k) int32, distances (b, k) f32)``: one kernel
        launch on a CUDA index."""
        return self._scan(q, R.retrieve_flat, R.retrieve_pq)

    def _scan(self, q, flat_fn, pq_fn):
        return _scan(self.device_params(), q, self.nprobe, self.k,
                     self.nlist, self.block,
                     None if self.pq is None else self.pq.m, flat_fn, pq_fn)

    def _search(self, queries: np.ndarray, plain: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(f"queries must be (n, {self.dim}), got "
                             f"{queries.shape}")
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
            resolve_device(self.device))
        nn, dist = (self._scan(q, R.retrieve_flat_plain, R.retrieve_pq_plain)
                    if plain else self.search_tensors(q))
        return (nn.cpu().numpy().astype(np.int64),
                dist.cpu().numpy())

    def transform(self, *inputs) -> List[Table]:
        """Batch search: appends ``neighbors`` (n, k) int64 ids (-1 for
        unfilled slots) and ``distances`` (n, k) f32: squared L2 for flat,
        the lookup-table approximation for PQ.  The chain terminal as a
        one-stage segment (queries padded to the shared bucket)."""
        (table,) = inputs
        kernel = self.transform_kernel(table.schema())
        if kernel is None:
            raise TypeError(
                f"IVFIndex.transform needs a numeric {self.query_col!r} "
                "column of query vectors")
        cols = run_kernel(kernel, table, op="retrieve")
        out = table.with_column(self.neighbors_col,
                                cols[self.neighbors_col])
        return [out.with_column(self.distances_col,
                                cols[self.distances_col])]

    def search(self, queries, *, nprobe: Optional[int] = None,
               k: Optional[int] = None, plain: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Convenience entry: (neighbor ids (n, k) int64, distances (n, k)
        f32) for a raw (n, d) query array.  ``plain`` runs the kernel's
        plain version (for comparisons on the card; the main path never
        sets it)."""
        index = self.with_options(nprobe=nprobe, k=k)
        return index._search(np.asarray(queries, np.float32), plain=plain)

    def scan_fraction(self, queries, nprobe: Optional[int] = None) -> float:
        """Analytic scan accounting: the mean over queries of (real rows in
        the probed lists) / (live rows), from the coarse selection and the
        CSR counts, not from timing."""
        nprobe = self.nprobe if nprobe is None else int(nprobe)
        queries = np.asarray(queries, np.float32)
        cents = self.params["centroids"]
        coarse = (np.sum(cents * cents, axis=1)[None, :]
                  - 2.0 * queries @ cents.T)
        probes = np.argsort(coarse, axis=1, kind="stable")[:, :nprobe]
        live = max(1, self.num_vectors)
        scanned = self.params["counts"][probes].sum(axis=1)
        return float(np.mean(scanned) / live)

    # -- bookkeeping ---------------------------------------------------------
    @property
    def num_vectors(self) -> int:
        return int(self.params["counts"].sum())

    @property
    def offsets(self) -> np.ndarray:
        """CSR list offsets of the REAL rows (exclusive cumsum of
        ``counts``; ``offsets[-1]`` is the live row total)."""
        return np.concatenate(
            ([0], np.cumsum(self.params["counts"], dtype=np.int64)))

    def stored_vectors(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids (n,) int32, vectors (n, d) f32) of every live vector in
        ascending id order: the exact-scan reference for recall probes and
        the re-anchor rebuild corpus."""
        order = sorted(self._store)
        ids = np.asarray(order, np.int32)
        if not order:
            return ids, np.zeros((0, self.dim), np.float32)
        return ids, np.stack([self._store[i] for i in order])

    def centroid_drift(self) -> float:
        """Max over non-empty lists of ||member mean - centroid||, over the
        RMS centroid norm: the re-anchor signal."""
        cents = self.params["centroids"].astype(np.float64)
        scale = float(np.sqrt(np.mean(np.sum(cents * cents, axis=1))))
        ids2, counts = self.params["ids"], self.params["counts"]
        worst = 0.0
        for lst in range(self.nlist):
            cnt = int(counts[lst])
            if not cnt:
                continue
            members = np.stack([self._store[int(i)]
                                for i in ids2[lst, :cnt]])
            gap = float(np.linalg.norm(
                members.astype(np.float64).mean(axis=0) - cents[lst]))
            worst = max(worst, gap)
        return worst / (scale + 1e-12)

    # -- incremental updates -------------------------------------------------
    def updated(self, inserts=None, insert_ids=None,
                delete_ids=()) -> Tuple[str, "IVFIndex"]:
        """Apply inserts/deletes; returns ``(mode, new_index)`` with this
        index untouched (in-flight queries finish on the old lists).

        ``mode == "delta"``: only the touched posting-list rows changed.
        ``mode == "reanchor"``: a list overflowed its block or the centroid
        drift crossed the threshold, and ``new_index`` is a fresh build
        over the surviving + inserted vectors (same ``block`` kept when the
        new occupancy still fits)."""
        inserts = (np.zeros((0, self.dim), np.float32) if inserts is None
                   else np.asarray(inserts, np.float32).reshape(-1, self.dim))
        if insert_ids is None:
            nxt = (max(self._store) + 1) if self._store else 0
            insert_ids = np.arange(nxt, nxt + inserts.shape[0],
                                   dtype=np.int32)
        insert_ids = np.asarray(insert_ids, np.int32).reshape(-1)
        if insert_ids.shape[0] != inserts.shape[0]:
            raise ValueError("insert_ids must match inserts rows")
        for vid in insert_ids.tolist():
            if vid in self._store or vid < 0:
                raise ValueError(f"insert id {vid} already live (or "
                                 "negative)")

        params = {name: arr.copy() for name, arr in self.params.items()}
        store = dict(self._store)
        ids2, counts = params["ids"], params["counts"]
        slot = {int(ids2[lst, j]): (lst, j)
                for lst in range(self.nlist)
                for j in range(int(counts[lst]))}
        for did in delete_ids:
            did = int(did)
            if did not in slot:
                raise KeyError(f"delete id {did} is not in the index")
            lst, j = slot.pop(did)
            last = int(counts[lst]) - 1
            if j != last:
                moved = int(ids2[lst, last])
                ids2[lst, j] = moved
                slot[moved] = (lst, j)
                self._move_row(params, lst, last, j)
            ids2[lst, last] = -1
            self._clear_row(params, lst, last)
            counts[lst] = last
            del store[did]

        cents = params["centroids"]
        overflow = False
        for vec, vid in zip(inserts, insert_ids.tolist()):
            lst = int(_nearest_list(cents, vec[None])[0])
            j = int(counts[lst])
            if j >= self.block:
                overflow = True
                break
            ids2[lst, j] = vid
            self._write_row(params, lst, j, vec)
            counts[lst] = j + 1
            slot[vid] = (lst, j)
            store[vid] = vec.copy()

        if overflow:
            merged = dict(self._store)
            for did in delete_ids:
                merged.pop(int(did), None)
            merged.update({int(i): v.copy()
                           for i, v in zip(insert_ids.tolist(), inserts)})
            return "reanchor", self._rebuilt(merged)

        out = IVFIndex.__new__(IVFIndex)
        out.__dict__.update(self.__dict__)
        out.params = params
        out._store = store
        out._drop_device_copy()
        if (self.drift_threshold is not None
                and out.centroid_drift() > self.drift_threshold):
            return "reanchor", self._rebuilt(store)
        return "delta", out

    def rebound(self, params: Dict[str, Any]) -> "IVFIndex":
        """The publish-side clone: same schema, new param buffers.  Host
        bookkeeping stays with the producer's copy."""
        out = IVFIndex.__new__(IVFIndex)
        out.__dict__.update(self.__dict__)
        out.params = {name: np.asarray(arr) for name, arr in params.items()}
        out._drop_device_copy()
        return out

    def _rebuilt(self, store: Dict[int, np.ndarray]) -> "IVFIndex":
        order = sorted(store)
        vectors = np.stack([store[i] for i in order])
        counts = np.bincount(
            _nearest_list(self.params["centroids"], vectors),
            minlength=self.nlist)
        keep = (int(counts.max()) + self.list_slack <= self.block)

        def build(block):
            return IVFIndex.build(
                vectors, self.nlist, self.pq, k=self.k,
                nprobe=self.nprobe, ids=np.asarray(order, np.int32),
                seed=self.seed, list_slack=self.list_slack,
                drift_threshold=self.drift_threshold,
                max_iter=self.max_iter, block=block, device=self.device)

        if keep:
            # the occupancy estimate above used the OLD centroids; the
            # re-anchor refits them, so the same-shape attempt can still
            # overflow: fall through to a fresh block size then
            try:
                return build(self.block)
            except ValueError:
                pass
        return build(None)

    # row edits shared by insert/delete (vecs for flat, codes for PQ)
    def _move_row(self, params, lst, src, dst):
        base = lst * self.block
        for name in ("vecs", "codes"):
            if name in params:
                params[name][base + dst] = params[name][base + src]

    def _clear_row(self, params, lst, j):
        base = lst * self.block
        for name in ("vecs", "codes"):
            if name in params:
                params[name][base + j] = 0

    def _write_row(self, params, lst, j, vec):
        base = lst * self.block
        if "vecs" in params:
            params["vecs"][base + j] = vec
        else:
            resid = vec - params["centroids"][lst]
            params["codes"][base + j] = _encode_pq(
                resid[None], params["cb_q"], params["cb_s"])[0]


# ---------------------------------------------------------------------------
# host-side build helpers (deterministic numpy, the JAX package's)
# ---------------------------------------------------------------------------

def _round_up8(n: int) -> int:
    return -(-int(n) // 8) * 8


def _nearest_list(centroids: np.ndarray, vectors: np.ndarray) -> np.ndarray:
    """Nearest-centroid assignment (f32 expression, first-index ties)."""
    c = np.asarray(centroids, np.float32)
    v = np.asarray(vectors, np.float32)
    scores = np.sum(c * c, axis=1)[None, :] - 2.0 * (v @ c.T)
    return np.argmin(scores, axis=1).astype(np.int32)


def _refine_balance(centroids: np.ndarray, vectors: np.ndarray,
                    rounds: Optional[int] = None) -> np.ndarray:
    """Split-heaviest / merge-lightest refinement of the coarse fit.

    The padded row-block layout charges every probe for the FULLEST list
    (``block`` is sized to ``max(counts)``), so one fat list inflates the
    whole index's scan cost.  Each round takes the heaviest list, splits
    its members at the median of their projection onto the farthest
    member's direction, and re-uses the lightest list's centroid slot for
    the second half; only the two touched lists' members are re-assigned
    between rounds (the caller's final ``_nearest_list`` pass restores the
    nearest-centroid invariant).  Stops when the heaviest list is within
    2x of the mean occupancy."""
    c = np.array(centroids, np.float32, copy=True)
    n, nlist = vectors.shape[0], c.shape[0]
    if nlist < 2 or n == 0:
        return c
    assign = _nearest_list(c, vectors)
    counts = np.bincount(assign, minlength=nlist)
    cap = max(2.0 * n / nlist, 8.0)
    for _ in range(nlist if rounds is None else rounds):
        h = int(counts.argmax())
        lo = int(counts.argmin())
        if h == lo or counts[h] <= cap or counts[h] < 2:
            break
        rows = np.flatnonzero(assign == h)
        pts = vectors[rows]
        dvec = pts - c[h]
        far = dvec[int(np.argmax(np.einsum("nd,nd->n", dvec, dvec)))]
        proj = dvec @ far
        side = proj > np.median(proj)
        if not side.any() or side.all():
            break
        c[h] = pts[side].mean(axis=0)
        c[lo] = pts[~side].mean(axis=0)
        moved = np.concatenate([rows, np.flatnonzero(assign == lo)])
        assign[moved] = _nearest_list(c, vectors[moved])
        counts = np.bincount(assign, minlength=nlist)
    return c


def _pack_blocks(rows: np.ndarray, rows_of: List[np.ndarray], block: int,
                 width: int, dtype) -> np.ndarray:
    """Pack per-list member rows into the (nlist*block, width) row-block
    array; pad rows are exact zeros (masked inert by their ``-1`` ids)."""
    out = np.zeros((len(rows_of) * block, width), dtype)
    for lst, members in enumerate(rows_of):
        if not members.size:
            continue
        (padded,), _ = pad_rows_to_block((rows[members],), block)
        out[lst * block:(lst + 1) * block] = padded.astype(dtype)
    return out


def _workset_fit(points: np.ndarray, k: int, seed: int, max_iter: int,
                 device, fits: List[Tuple[str, str, int]], name: str
                 ) -> np.ndarray:
    """Centroids of a workset KMeans fit on ``device``; appends ``(name,
    planned_impl, rounds)`` to ``fits``."""
    from ..models.clustering.kmeans import KMeans

    est = (KMeans(device=device).set_k(k).set_workset(True).set_seed(seed)
           .set_max_iter(max_iter))
    model = est.fit(Table({"features": points}))
    fits.append((name, est.planned_impl,
                 int(est.last_workset_report["rounds"])))
    return np.asarray(model.get_model_data()[0]["centroids"][0], np.float32)


def _fit_codebooks(resid: np.ndarray, pq: PQConfig, seed: int,
                   max_iter: int, device="cuda",
                   fits: Optional[List[Tuple[str, str, int]]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-subspace codebooks: workset KMeans on each residual subspace (on
    ``device``), stored through ``quantize_rows`` (int8 codes + per-row
    f32 scales).  (``max_iter`` is the coarse fit's; the subspace fits run
    ``pq.max_iter`` rounds, as in the JAX package.)"""
    fits = [] if fits is None else fits
    dsub = resid.shape[1] // pq.m
    cb_q = np.empty((pq.m, pq.ksub, dsub), np.int8)
    cb_s = np.empty((pq.m, pq.ksub), np.float32)
    for s in range(pq.m):
        sub = np.ascontiguousarray(resid[:, s * dsub:(s + 1) * dsub])
        book = _workset_fit(sub, pq.ksub, seed + 1 + s, pq.max_iter, device,
                            fits, f"pq[{s}]")
        cb_q[s], cb_s[s] = quantize_rows(book)
    return cb_q, cb_s


def _encode_pq(resid: np.ndarray, cb_q: np.ndarray,
               cb_s: np.ndarray) -> np.ndarray:
    """int8 PQ codes: per-subspace argmin against the DECODED codebook, the
    exact values the scan's table uses."""
    m, _ksub, dsub = cb_q.shape
    decoded = cb_q.astype(np.float32) * cb_s[..., None]
    codes = np.empty((resid.shape[0], m), np.int8)
    for s in range(m):
        sub = resid[:, s * dsub:(s + 1) * dsub]
        d2 = np.sum(
            (sub[:, None, :] - decoded[s][None, :, :]) ** 2, axis=-1)
        codes[:, s] = np.argmin(d2, axis=1).astype(np.int8)
    return codes


# ---------------------------------------------------------------------------
# kernel-registry entries: op ``retrieve`` (stage convention), the kernels'
# launchers in ops/retrieve.py
# ---------------------------------------------------------------------------

def _register_retrieve_kernels() -> None:
    register_kernel("retrieve", "cuda", _retrieve_stage_cuda, priority=10,
                    supports=on_cuda, available=cuda_only,
                    convention="stage")
    register_kernel("retrieve", "plain", _retrieve_stage_plain,
                    convention="stage")


_register_retrieve_kernels()
