"""IVF retrieve kernels: coarse probe selection, posting-list scan and
top-k in one kernel call per search, with their plain PyTorch versions.

A port of the JAX package's ``ops/retrieve_pallas.py`` (the fused Pallas
kernels) and of the XLA stage ``retrieval/ivf.py::_retrieve_stage_xla``
that they equal bit for bit.  The kernels are CUDA C++ for Hopper
(``kernels/csrc/retrieve.cu``; its header note says what bounds them and
how they are laid out):

- :func:`retrieve_flat`: flat f32 posting lists, squared L2
  ``|q|^2 + |x|^2 - 2 q.x``, sized by :func:`flat_plan`;
- :func:`retrieve_pq`: IVF-PQ, asymmetric distances from a per-(query,
  probe) lookup table over int8 codes, sized by :func:`pq_plan`.

Both are list-major, two CUDA launches a call: the probes (one kernel for
both), which write each list's membership; the scan (one kernel template
over the two scorers), which reads each probed list once for each span of
the queries that probe it, and merges each query's partial results.

Both return ``(neighbors (b, k) int32, distances (b, k) f32)``.  Probes are
taken in ascending (coarse score, list index) order and the top-k runs
over the ``nprobe * block`` candidates flattened probe-major, ascending
distance with the lowest flat position first on ties: the order of
``lax.top_k``, reproduced here by a stable sort (``torch.topk`` leaves the
order of ties unspecified).  Pad slots (id ``-1``) sit at ``+inf``; when
fewer than ``k`` real candidates were scanned the result carries id ``-1``
at ``+inf``, never a fake id.

**Bit for bit.**  The plain versions write every sum as a sequential loop
(over ``d`` for ``|q|^2``, ``|x|^2``, ``q.x`` and ``|c|^2``; over ``dsub``
in the lookup table; over ``m`` in the ADC scan) of separately rounded
elementwise ops, and the kernels do the same adds in the same order with
``__fmul_rn``/``__fadd_rn``, which the compiler never contracts into an
FMA.  So on the card each kernel equals its plain version bit for bit:
ids equal, distance bits equal.  The JAX stage multiplies by a runtime
1.0 (``runtime_one``) to pin XLA's fusion choices; ``x * 1.0f == x``
exactly, so both sides here leave it out and no bit changes.

Each wrapper checks its operands and resolves through the kernel
registry (op ``retrieve``, registered in ``retrieval/ivf.py`` at the
signature ``retrieve_sig + (device type,)``): tensors on the CPU take
the plain version, CUDA tensors launch the kernel or raise: it never
falls back.  A shape the
kernel cannot take raises with the limit in its message
(:func:`flat_plan`, :func:`pq_plan`).  A call on the card adds one to
:data:`LAUNCHES`, whatever number of CUDA launches it takes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ..kernels.build import count_launch
from ..kernels.registry import kernel_or_plain

__all__ = ["retrieve_flat", "retrieve_flat_plain", "retrieve_pq",
           "retrieve_pq_plain", "coarse_distances", "flat_distances",
           "decode_codebooks", "pq_lut", "adc_distances", "select_probes",
           "flat_plan", "pq_plan", "FlatPlan", "PQPlan", "K_MAX", "LAUNCHES",
           "reset_launch_counts"]

#: Calls of each kernel since the last :func:`reset_launch_counts` (one
#: per wrapper call on the card, whatever number of CUDA launches it
#: takes).  Only the CUDA kernel counts, never a plain version.
LAUNCHES: Dict[str, int] = {"retrieve_flat": 0, "retrieve_pq": 0}

#: Most results a query: the kernels hold a query's k best one a lane of
#: a warp.
K_MAX = 32

# retrieve.cu's threads a block and Hopper's per-block opt-in shared
# memory: flat_plan and pq_plan size the kernels' layouts here, and the
# launchers check only the cap
_THREADS = 256
_SMEM_LIMIT = 232448

# bytes of gathered posting rows a plain scan holds at once
_PLAIN_CHUNK_BYTES = 256 << 20


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# shared distance expressions, sums as sequential loops
# ---------------------------------------------------------------------------

def _seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_j a[..., j] * b[..., j]`` (broadcast), added left to right
    from 0.0, each product and each add rounded."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]),
                      dtype=torch.float32, device=a.device)
    for j in range(a.shape[-1]):
        acc = acc + a[..., j] * b[..., j]
    return acc


def coarse_distances(q: torch.Tensor, centroids: torch.Tensor
                     ) -> torch.Tensor:
    """Selection-only coarse scores ``|c|^2 - 2 q.c`` for ``q`` (..., d)
    against ``centroids`` (nlist, d) -> (..., nlist); ``|q|^2`` shifts a
    row uniformly and is left out."""
    c2 = _seq_dot(centroids, centroids)
    qc = _seq_dot(q[..., None, :], centroids)
    return c2 - 2.0 * qc


def flat_distances(q: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Squared L2 ``(|q|^2 + |x|^2) - 2 q.x`` for ``q`` (..., d) against
    row blocks ``vecs`` (..., L, d) -> (..., L)."""
    q2 = _seq_dot(q, q)[..., None]
    x2 = _seq_dot(vecs, vecs)
    qx = _seq_dot(q[..., None, :], vecs)
    return q2 + x2 - 2.0 * qx


def decode_codebooks(cb_q: torch.Tensor, cb_s: torch.Tensor) -> torch.Tensor:
    """The stored per-subspace codebooks: int8 codes (m, ksub, dsub) times
    per-row scales (m, ksub)."""
    return cb_q.to(torch.float32) * cb_s[..., None]


def pq_lut(resid: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """ADC lookup table: squared L2 from residual subvectors (..., m,
    dsub) to every codebook entry (m, ksub, dsub) -> (..., m, ksub), summed
    over ``dsub`` left to right."""
    acc = torch.zeros(resid.shape[:-1] + books.shape[1:2],
                      dtype=torch.float32, device=resid.device)
    for t in range(resid.shape[-1]):
        diff = resid[..., :, None, t] - books[:, :, t]
        acc = acc + diff * diff
    return acc


def adc_distances(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Asymmetric distances: each candidate's per-subspace table entries
    summed over ``m`` left to right.  ``lut`` (..., m, ksub), ``codes``
    (..., L, m) int8 -> (..., L)."""
    acc = torch.zeros(codes.shape[:-1], dtype=torch.float32,
                      device=lut.device)
    for s in range(codes.shape[-1]):
        acc = acc + torch.gather(lut[..., s, :], -1, codes[..., s].long())
    return acc


def select_probes(q: torch.Tensor, centroids: torch.Tensor,
                  nprobe: int) -> torch.Tensor:
    """(b, nprobe) list indices in ascending (coarse score, index) order."""
    coarse = coarse_distances(q, centroids)
    return torch.sort(coarse, dim=1, stable=True).indices[:, :nprobe]


def _scan_plain(q: torch.Tensor, centroids: torch.Tensor, ids: torch.Tensor,
                *, nprobe: int, k: int, block: int, row_bytes: int,
                score: Callable[[torch.Tensor], torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe, score and take the top-k.  ``score(probes (b, c))`` returns
    the (b, c, block) candidate distances of a chunk of probes; chunks
    bound the gathered posting rows to ``_PLAIN_CHUNK_BYTES``."""
    b = q.shape[0]
    probes = select_probes(q, centroids, nprobe)
    chunk = max(1, _PLAIN_CHUNK_BYTES // max(1, b * block * row_bytes))
    dist = torch.cat([score(probes[:, c:c + chunk])
                      for c in range(0, nprobe, chunk)], dim=1)
    pid = ids[probes].reshape(b, -1)                  # probe-major
    dist = torch.where(pid >= 0, dist.reshape(b, -1), torch.inf)
    short = k - pid.shape[1]
    if short > 0:
        dist = torch.cat([dist, dist.new_full((b, short), torch.inf)], 1)
        pid = torch.cat([pid, pid.new_full((b, short), -1)], 1)
    vals, pos = torch.sort(dist, dim=1, stable=True)
    return (torch.gather(pid, 1, pos[:, :k]).to(torch.int32),
            vals[:, :k].contiguous())


def retrieve_flat_plain(q, centroids, ids, vecs, *, nprobe: int, k: int,
                        nlist: int, block: int):
    """Flat f32 search: ``(q (b, d), centroids (nlist, d), ids (nlist,
    block) i32, vecs (nlist*block, d)) -> (neighbors (b, k) i32, distances
    (b, k) f32)``."""
    d = q.shape[1]
    rows = vecs.view(nlist, block, d)

    def score(pr):
        return flat_distances(q[:, None, :], rows[pr])

    return _scan_plain(q, centroids, ids, nprobe=nprobe, k=k, block=block,
                       row_bytes=4 * d, score=score)


def retrieve_pq_plain(q, centroids, ids, codes, cb_q, cb_s, *, nprobe: int,
                      k: int, nlist: int, block: int, m: int):
    """IVF-PQ search: ``codes (nlist*block, m)`` int8 against the decoded
    books ``cb_q (m, ksub, d/m)`` int8 times ``cb_s (m, ksub)``; the
    per-(query, probe) table is built from the residual ``q - c[probe]``."""
    b, d = q.shape
    books = decode_codebooks(cb_q, cb_s)
    blocks = codes.view(nlist, block, m)

    def score(pr):
        resid = q[:, None, :] - centroids[pr]          # (b, c, d)
        lut = pq_lut(resid.reshape(b, pr.shape[1], m, d // m), books)
        return adc_distances(lut, blocks[pr])

    return _scan_plain(q, centroids, ids, nprobe=nprobe, k=k, block=block,
                       row_bytes=4 * m, score=score)


# ---------------------------------------------------------------------------
# kernel planning and wrappers
# ---------------------------------------------------------------------------

# retrieve.cu's list-major search: most queries a scan round (one a warp),
# rows a scan block (flat; IVF-PQ), centroid rows a probe tile
_SCAN_QUERIES = _THREADS // 32
_SCAN_ROWS = 256
_PQ_SCAN_ROWS = 1024
_PROBE_ROWS = 256
# probe blocks: a search of b queries puts ceil(b / 64) of them in a
# block, up to the plan's count (4 at the bench's b = 256: fewer blocks
# than SMs, each staging the centroids once for more queries, measured
# faster than 1, 2 and 8 by scripts/retrieve_phase_times.py)
_PROBE_BLOCKS = 64
# the scan's static shared bytes (a count a warp)
_SCAN_STATIC = 4 * (_THREADS // 32)


class FlatPlan(NamedTuple):
    """Launch sizes of the list-major flat search (:func:`flat_plan`)."""

    probe_queries: int   # queries a probe block (at most)
    probe_rows: int      # centroid rows a probe tile
    probe_smem: int      # probe shared bytes
    scan_rows: int       # rows a scan block
    scan_smem: int       # scan shared bytes


class PQPlan(NamedTuple):
    """Launch sizes of the list-major IVF-PQ search (:func:`pq_plan`)."""

    probe_queries: int   # queries a probe block (at most)
    probe_rows: int      # centroid rows a probe tile
    probe_smem: int      # probe shared bytes
    scan_rows: int       # rows a scan block
    scan_smem: int       # scan shared bytes
    scan_queries: int    # queries a scan round (one a warp)


def _common_limits(dim: int, k: int, nlist: int, block: int) -> None:
    if dim < 1 or nlist < 1 or block < 1:
        raise ValueError(f"need dim, nlist, block >= 1, got dim={dim}, "
                         f"nlist={nlist}, block={block}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k={k} is past the kernel's per-lane result "
                         f"list: k must be in [1, {K_MAX}]")
    if nlist * block >= 2 ** 31:
        raise ValueError(f"nlist*block={nlist * block} posting slots: the "
                         "kernel addresses at most 2^31 - 1")


def _probe_plan(dim: int, nlist: int) -> Tuple[int, int, int]:
    """``(queries a block, centroid rows a tile, shared bytes)`` of the
    probe launch both searches share: per query its row and its coarse
    scores and taken flags (one word per list each), then the tile's
    ``|c|^2`` and a tile of up to 256 centroid rows (a multiple of 4; fewer
    where the rows are wide); up to 8 queries a block, fewer where the
    scores would not fit."""
    row = dim + 4 if dim % 4 == 0 else dim + 1
    per_query = 4 * (dim + 2 * nlist)
    prow = min(_PROBE_ROWS, max(0, _SMEM_LIMIT - per_query)
               // (4 * (1 + row)) // 4 * 4)
    tile = 4 * max(prow, 4) * (1 + row)
    nq = min(_SCAN_QUERIES, max(0, _SMEM_LIMIT - tile) // per_query)
    probe = tile + per_query * max(nq, 1)
    if nq < 1 or prow < 4:
        raise ValueError(
            f"nlist={nlist}, dim={dim} need {probe} bytes of shared memory "
            "for one query's coarse row and a tile of centroids; a block "
            f"has at most {_SMEM_LIMIT}")
    return nq, prow, probe


@functools.lru_cache(maxsize=64)
def flat_plan(dim: int, k: int, nlist: int, block: int) -> FlatPlan:
    """The launch sizes of the flat search's two list-major launches
    (``retrieve.cu``) for lists of ``block`` rows of ``dim`` floats;
    raises ``ValueError`` naming the limit a shape passes (the counterpart
    of the JAX package's ``fused_supported``; the counts that grow with a
    call's batch are checked by :func:`retrieve_flat`).  The one place
    that sizes their layouts, rows of ``dim + 4`` words where
    ``dim % 4 == 0`` (16-byte copies), else ``dim + 1``:

    - probe: :func:`_probe_plan`;
    - scan: a window's 256 selected (query, rank) pairs, the ids and
      ``|x|^2`` of a chunk of up to 256 rows (a multiple of 4; fewer where
      the rows are wide), a round's 8 queries and the chunk's rows.

    Cached, as :func:`pq_plan` is: a search asks every call."""
    dim, k, nlist, block = int(dim), int(k), int(nlist), int(block)
    _common_limits(dim, k, nlist, block)
    nq, prow, probe = _probe_plan(dim, nlist)
    row = dim + 4 if dim % 4 == 0 else dim + 1
    limit = _SMEM_LIMIT - _SCAN_STATIC
    fixed = 4 * (_SCAN_QUERIES * dim + _THREADS)
    rows = min(_SCAN_ROWS, max(0, limit - fixed) // (4 * (row + 2))
               // 4 * 4)
    scan = fixed + 4 * max(rows, 4) * (row + 2)
    if rows < 4:
        raise ValueError(
            f"dim={dim} needs {scan} bytes of shared memory for the scan's "
            f"{_SCAN_QUERIES} queries and 4 rows; a block has at most "
            f"{limit}")
    return FlatPlan(nq, prow, probe, rows, scan)


@functools.lru_cache(maxsize=64)
def pq_plan(dim: int, k: int, nlist: int, block: int, m: int,
            ksub: int) -> PQPlan:
    """The launch sizes of the IVF-PQ search's two list-major launches
    (``retrieve.cu``): the probe launch of the flat search, then the scan
    with its PQ scorer; raises ``ValueError`` naming the limit a shape
    passes (the counterpart of the JAX package's ``fused_supported``;
    ``m == 0``, the flat search, is :func:`flat_plan`'s).  The one place
    that sizes the scan's layout: a window's 256 selected (query, rank)
    pairs and a chunk's ids (a word each), per query of a round its table
    (``m * ksub`` words) and residual (``dim``), the decoded books (``ksub
    * dim``) and the chunk's codes (``m`` bytes a row).  A list is split
    into equal chunks of at most 1024 rows (the whole list at the bench),
    and the scan takes as many queries a round, up to 8, as fit beside one;
    where not one fits, a single query and fewer rows.  It accepts every
    shape the one-block-a-query design before it did."""
    dim, k, nlist, block, m, ksub = (int(v) for v in
                                     (dim, k, nlist, block, m, ksub))
    if m == 0:
        raise ValueError("m == 0 is the flat search: flat_plan sizes its "
                         "launches")
    _common_limits(dim, k, nlist, block)
    if m < 1 or dim % m or not 2 <= ksub <= 127:
        raise ValueError(f"PQ needs m | dim and ksub in [2, 127], got "
                         f"m={m}, ksub={ksub}, dim={dim}")
    nq, prow, probe = _probe_plan(dim, nlist)
    limit = _SMEM_LIMIT - _SCAN_STATIC
    books = 4 * ksub * dim
    warp = 4 * (m * ksub + dim)

    def need(rows: int, queries: int) -> int:
        return (4 * (_THREADS + rows) + queries * warp + books
                + -(-rows * m // 4) * 4)

    chunks = -(-block // _PQ_SCAN_ROWS)
    rows = -(-block // chunks)
    queries = min(_SCAN_QUERIES, max(0, limit - need(rows, 0)) // warp)
    if queries < 1:
        queries = 1
        rows = min(rows, max(0, limit - need(0, 1)) // (4 + m))
    scan = need(max(rows, 1), queries)
    if rows < 1:
        raise ValueError(
            f"dim={dim}, m={m}, ksub={ksub} need {scan} bytes of shared "
            "memory for the scan's decoded books, one query's table and "
            f"one row; a block has at most {limit}")
    return PQPlan(nq, prow, probe, rows, scan, queries)


_LIB = None


def _kernels():
    """The built ``retrieve`` library with its C signatures declared (built
    on first use)."""
    global _LIB
    if _LIB is None:
        from ..kernels.build import load_library

        _LIB = declare(load_library("retrieve"))
    return _LIB


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a built ``retrieve.cu`` library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.retrieve_flat_launch.argtypes = ([vp] * 7 + [ci] * 8
                                         + [cl, ci, cl, vp])
    lib.scan_scratch_words.argtypes = [ci] * 6
    lib.scan_scratch_words.restype = cl
    lib.retrieve_pq_launch.argtypes = ([vp] * 9 + [ci] * 10
                                       + [cl, ci, ci, cl, vp])
    lib.retrieve_flat_launch.restype = ctypes.c_int
    lib.retrieve_pq_launch.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(q, centroids, ids, *, nprobe, k, nlist, block):
    if q.dim() != 2:
        raise ValueError("q must be (b, d)")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    b, d = q.shape
    _check("q", q, torch.float32, (b, d), dev)
    _check("centroids", centroids, torch.float32, (nlist, d), dev)
    _check("ids", ids, torch.int32, (nlist, block), dev)
    if not 1 <= nprobe <= nlist or k < 1:
        raise ValueError(f"need 1 <= nprobe={nprobe} <= nlist={nlist} and "
                         f"k={k} >= 1")
    return b, d, dev


def _outputs(b: int, k: int, dev):
    return (torch.empty((b, k), dtype=torch.int32, device=dev),
            torch.empty((b, k), dtype=torch.float32, device=dev))


def _search(name: str, launch: Callable[..., int], pointers: tuple,
            sizes: tuple, plan, *, b: int, nprobe: int, k: int, nlist: int,
            block: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """Checks the counts that grow with the batch, allocates the outputs
    and the scratch, and calls ``launch(*pointers, nn, dist, scratch,
    *sizes, stream)`` on the current stream; raises on a non-zero
    return."""
    parts = b * nprobe * -(-block // plan.scan_rows) * k
    if max(nlist * b, parts) >= 2 ** 31:
        raise ValueError(f"nlist * b = {nlist * b} memberships and {parts} "
                         "partial results (b * nprobe * ceil(block / "
                         f"{plan.scan_rows}) * k): the kernel addresses at "
                         "most 2^31 - 1 of each")
    nn, dist = _outputs(b, k, dev)
    # partial top-k, probes, the lists' membership, merge counters
    scratch = torch.empty(
        _kernels().scan_scratch_words(b, nlist, block, nprobe, k,
                                      plan.scan_rows),
        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = launch(*pointers, nn.data_ptr(), dist.data_ptr(),
                    scratch.data_ptr(), *sizes,
                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, name)
    return nn, dist


def _probe_sizes(plan, b: int) -> tuple:
    return (min(plan.probe_queries, -(-b // _PROBE_BLOCKS)),
            plan.probe_rows, plan.probe_smem)


def _on_card(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, got "
                         f"{q.device}")


def _retrieve_flat_cuda(q, centroids, ids, vecs, *, nprobe: int, k: int,
                        nlist: int, block: int):
    """The flat search kernel: one call (two CUDA launches)."""
    _on_card("retrieve_flat", q)
    b, d = q.shape
    plan = flat_plan(d, k, nlist, block)
    return _search(
        "retrieve_flat", _kernels().retrieve_flat_launch,
        tuple(t.data_ptr() for t in (q, centroids, ids, vecs)),
        (b, d, nlist, block, nprobe, k, *_probe_sizes(plan, b),
         plan.scan_rows, plan.scan_smem),
        plan, b=b, nprobe=nprobe, k=k, nlist=nlist, block=block,
        dev=q.device)


def _retrieve_pq_cuda(q, centroids, ids, codes, cb_q, cb_s, *, nprobe: int,
                      k: int, nlist: int, block: int, m: int):
    """The IVF-PQ search kernel: one call (two CUDA launches)."""
    _on_card("retrieve_pq", q)
    b, d = q.shape
    ksub = cb_q.shape[1]
    plan = pq_plan(d, k, nlist, block, m, ksub)
    return _search(
        "retrieve_pq", _kernels().retrieve_pq_launch,
        tuple(t.data_ptr() for t in (q, centroids, ids, codes, cb_q, cb_s)),
        (b, d, nlist, block, nprobe, k, m, ksub, *_probe_sizes(plan, b),
         plan.scan_rows, plan.scan_queries, plan.scan_smem),
        plan, b=b, nprobe=nprobe, k=k, nlist=nlist, block=block,
        dev=q.device)


def retrieve_flat(q: torch.Tensor, centroids: torch.Tensor, ids: torch.Tensor,
                  vecs: torch.Tensor, *, nprobe: int, k: int, nlist: int,
                  block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat search (see :func:`retrieve_flat_plain`).  Replaces the JAX
    package's ``retrieve_flat_fused``.  Deterministic."""
    b, d, dev = _check_common(q, centroids, ids, nprobe=nprobe, k=k,
                              nlist=nlist, block=block)
    _check("vecs", vecs, torch.float32, (nlist * block, d), dev)
    fn = kernel_or_plain("retrieve",
                         (nprobe, k, d, 0, 0, nlist, block, dev.type),
                         _retrieve_flat_cuda, retrieve_flat_plain)
    return fn(q, centroids, ids, vecs, nprobe=nprobe, k=k, nlist=nlist,
              block=block)


def retrieve_pq(q: torch.Tensor, centroids: torch.Tensor, ids: torch.Tensor,
                codes: torch.Tensor, cb_q: torch.Tensor, cb_s: torch.Tensor,
                *, nprobe: int, k: int, nlist: int, block: int, m: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ search (see :func:`retrieve_pq_plain`).  Replaces the JAX
    package's ``retrieve_pq_fused``.  ``codes`` must hold indices in
    ``[0, ksub)``, as the index build writes them.  Deterministic."""
    b, d, dev = _check_common(q, centroids, ids, nprobe=nprobe, k=k,
                              nlist=nlist, block=block)
    if m < 1 or cb_q.dim() != 3:
        raise ValueError("PQ needs m >= 1 and cb_q (m, ksub, d/m)")
    ksub = cb_q.shape[1]
    _check("codes", codes, torch.int8, (nlist * block, m), dev)
    _check("cb_q", cb_q, torch.int8, (m, ksub, d // m), dev)
    _check("cb_s", cb_s, torch.float32, (m, ksub), dev)
    fn = kernel_or_plain("retrieve",
                         (nprobe, k, d, m, ksub, nlist, block, dev.type),
                         _retrieve_pq_cuda, retrieve_pq_plain)
    return fn(q, centroids, ids, codes, cb_q, cb_s, nprobe=nprobe, k=k,
              nlist=nlist, block=block, m=m)
