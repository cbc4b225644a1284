"""Run a function on the ranks of a fresh process group.

The JAX package's ``utils/backend.py::force_virtual_cpu`` turns one
process into N virtual CPU devices, the stand-in for N chips in its tests
(and for the reference's MiniCluster,
``UnboundedStreamIterationITCase.java:71``).
The port runs one process a device, so its stand-in is N processes:
:func:`run_on_ranks` spawns them through ``torch.multiprocessing``, joins
them in a process group (gloo between CPU processes by default), calls
``fn(rank, *args)`` on each and returns what each returned, in rank order.

Every rank has one deadline: a rank that hangs (a collective one rank
never reached) or dies fails the call, naming the rank, and every process
is stopped before it returns or raises.
"""

from __future__ import annotations

import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List

__all__ = ["run_on_ranks", "run_in_group_of_one", "free_port"]


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _rank_main(fn, rank, world, address, device, backend, timeout_s,
               threads, args, results):
    import torch

    from ..parallel import distributed

    try:
        torch.set_num_threads(threads)
        distributed.initialize(address, num_processes=world,
                               process_id=rank, device=device,
                               backend=backend, timeout_s=timeout_s)
        results.put((rank, True, _to_host(fn(rank, *args))))
    except Exception:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


def run_on_ranks(fn: Callable[..., Any], world_size: int, *args,
                 device: str = "cpu", backend=None, timeout_s: float = 60.0,
                 threads: int = 1) -> List[Any]:
    """``[fn(0, *args), ..., fn(world_size - 1, *args)]``, each call in its
    own spawned process, rank ``r`` of a process group over
    ``tcp://127.0.0.1:<free port>`` (``distributed.initialize`` with
    ``device`` and ``backend``: gloo on the CPU by default; ``"cuda:0"``
    with ``backend="gloo"`` puts every rank on one card).  ``fn`` must be
    importable by name (a module-level function); tensors in its result
    come back as numpy arrays.  A rank that raises fails the call with its
    traceback; one that has not returned within ``timeout_s`` of the start
    fails it as a hang.  ``threads`` caps each rank's CPU threads."""
    import torch.multiprocessing as mp

    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, address, device, backend,
                               timeout_s, threads, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got, errors = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if errors:
                # the others may wait on the failed rank forever
                left = min(left, 5.0)
            if left <= 0:
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got
                        and r not in errors and p.exitcode not in (0, None)]
                for r in dead:
                    errors[r] = (f"rank {r} died (exit code "
                                 f"{procs[r].exitcode})")
                continue
            (got if ok else errors)[rank] = value
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if errors:
        raise RuntimeError("rank(s) failed:\n" + "\n".join(
            f"--- rank {r} ---\n{errors[r]}" for r in sorted(errors)))
    missing = [r for r in range(world_size) if r not in got]
    if missing:
        raise TimeoutError(f"rank(s) {missing} of {world_size} did not "
                           f"return within {timeout_s} s")
    return [got[r] for r in range(world_size)]


def run_in_group_of_one(fn: Callable[..., Any], *args, device: str = "cpu",
                        backend=None, timeout_s: float = 60.0) -> Any:
    """``fn(0, 1, *args)`` in this process, as the one rank of a fresh
    process group (``distributed.initialize`` over a free localhost port
    with ``device`` and ``backend``), left again before it returns: a
    group of one without a spawn.  Tensors in its result come back as
    numpy arrays, as from :func:`run_on_ranks`.  Refused inside a group
    this process has already joined."""
    from ..parallel import distributed

    if distributed.is_initialized():
        raise RuntimeError("this process is already a rank of a process "
                           "group")
    distributed.initialize(f"tcp://127.0.0.1:{free_port()}",
                           num_processes=1, process_id=0, device=device,
                           backend=backend, timeout_s=timeout_s)
    try:
        return _to_host(fn(0, 1, *args))
    finally:
        distributed.shutdown()
