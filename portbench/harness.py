"""One run of one cell: set-up, the measured window, the traced extras,
the check against the plain reference, and the result line.

The cell's entry in ``BENCHMARK.json`` names its configuration and its
traffic; the traffic file names the job and the generator; the metrics
the cell reports are read by ``metrics/<name>.py``.  Nothing here knows a
cell by name.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Optional

import torch

from .jobs.seeds import data_seed, fit_seed

HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level module names that no run may load (compared whole:
#: ``flink_ml_tpu_torch`` is the port and passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "flink_ml_tpu")


class NoCard(RuntimeError):
    """The run asks for more cards than PyTorch sees."""


def load_spec(root: str, workload: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "workloads", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": layer}


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def launches() -> int:
    """Kernel launches and registry dispatches so far in this process."""
    from flink_ml_tpu_torch.kernels.registry import kernel_stats

    snap = kernel_stats.snapshot()
    return int(sum(snap["launches"].values())) + int(snap["dispatches"])


class Run:
    """What one run measured, handed to every metric reader."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool,
                 device: torch.device):
        self.spec = spec
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        job_mod = importlib.import_module(
            f"portbench.jobs.{self.traffic['job']}")
        self.job = job_mod.Job(self.config, self.traffic, device)
        self.columns: Optional[dict] = None
        self.setup_s = float("nan")
        self.window_s = float("nan")
        self.fit_walls: list = []
        self.infos: list = []
        self.kept: list = []
        self.peak_bytes = 0
        self.profile: Optional[dict] = None

    @property
    def fit_s(self) -> float:
        return self.window_s / len(self.fit_walls)

    def set_up(self, t0: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.init()
            torch.zeros(1, device=self.device)
        self.columns = self.job.make_inputs(data_seed(self.seed))
        self.table = self.job.table(self.columns)
        self.job.warm_up(self.columns, self.table,
                         fit_seed(self.seed, -1))
        self._sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.setup_s = time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self) -> None:
        """Whole fits back to back, one caller, until the fit that crosses
        ``seconds`` ends."""
        start = time.perf_counter()
        i = 0
        while True:
            s = fit_seed(self.seed, i)
            t = time.perf_counter()
            out, info = self.job.fit(self.table, s)
            self._sync()
            now = time.perf_counter()
            self.fit_walls.append(now - t)
            self.infos.append(info)
            self.kept.append((s, out))
            i += 1
            if now - start >= self.seconds:
                break
        self.window_s = now - start
        if self.device.type == "cuda":
            self.peak_bytes = int(torch.cuda.max_memory_allocated())

    def traced_fit(self) -> None:
        from . import profiling

        s = fit_seed(self.seed, len(self.fit_walls))
        before = launches()
        self.profile = profiling.profile_fit(
            lambda: self.job.fit(self.table, s),
            spans=getattr(self.job, "host_spans", ()))
        self.profile["launches"] = launches() - before

    def read(self, metrics: list) -> dict:
        out = {}
        for m in metrics:
            value = load_reader(m["name"]).read(self)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def _free_device() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run(argv=None, *, t0: float, require_card: bool = True,
        device: Optional[str] = None, spec_hook=None, root: str = None):
    """One run; returns ``(result line, Run)``.  ``require_card`` False and
    ``device`` let the tests drive a run without a card; ``spec_hook``
    lets them shrink the cell."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_spec(root or os.path.dirname(HERE), args.workload)
    if spec_hook is not None:
        spec_hook(spec)
    chips = int(spec["cell"]["chips"])
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < chips):
        raise NoCard(f"the cell needs {chips} CUDA device(s); PyTorch sees "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = torch.device(device or "cuda")
    r = Run(spec, args.seed, args.seconds, bool(args.trace), dev)
    r.set_up(t0)
    r.window()
    if r.trace:
        r.traced_fit()
        metrics = r.read(spec["per_layer"])
    else:
        metrics = r.read(spec["end_to_end"])
    columns, kept = r.columns, r.kept
    r.table = None
    _free_device()
    checks = r.job.check(columns, kept, args.seed)
    _free_device()
    failed = sum(1 for _, v, lim in checks if not v <= lim)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                 else "cpu"),
        "count": chips,
        "memory_peak_bytes": r.peak_bytes,
    }
    result = {"correct": failed == 0 and bool(checks),
              "attempted": len(r.fit_walls), "failed": failed,
              "metrics": metrics, "device": device_info}
    if r.profile is not None:
        device_info["busy_s"] = r.profile["busy_s"]
        device_info["window_s"] = r.profile["span_s"]
        result["breakdown"] = {"device_ops": r.profile["device_ops"],
                               "idle_gaps": r.profile["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result, r


def main(argv=None, *, t0: float) -> int:
    from . import peaks

    try:
        result, r = run(argv, t0=t0)
    except NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the benchmark runs the "
              "port alone", file=sys.stderr)
        return 3
    walls = ", ".join(f"{w:.4f}" for w in r.fit_walls)
    print(f"portbench: {result['device']['kind']} ({peaks.power_limit()}); "
          f"set-up {r.setup_s:.3f} s; {len(r.fit_walls)} fits in "
          f"{r.window_s:.3f} s: {walls}", file=sys.stderr)
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']:.6g} limit {c['limit']:.6g} "
              f"{verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
