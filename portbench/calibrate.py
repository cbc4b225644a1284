"""The readings that the check's limits are set from, at a cell's own
sizes on the card.

    python portbench/calibrate.py --workload <cell> --seeds 12 \
        --controls 3 [--first-seed N] [--out FILE]

For each seed: the inputs, one fit of the program (the window's call),
the plain reference from the same seed, and every number the job's
``numbers`` reads (the lower readings).  On the first ``--controls``
seeds, the same numbers for the control (the reference put in the
program's place, its products on the TF32 tensor cores, one precision
below the configuration's float32) and for the faults the job plants
(``faults``).  Prints one JSON line a reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _job(workload: str, spec_hook, device):
    """The cell's job on ``device`` (default the card), and its spec."""
    import torch

    from portbench import harness

    spec = harness.load_spec(ROOT, workload)
    if spec_hook is not None:
        spec_hook(spec)
    dev = torch.device(device or "cuda")
    return harness.Run(spec, 0, 0.0, False, dev).job, spec


def readings(workload: str, seeds: list, controls: int, emit,
             spec_hook=None, device=None) -> None:
    import torch

    from portbench.jobs.seeds import data_seed, fit_seed

    job, _ = _job(workload, spec_hook, device)
    for n, seed in enumerate(seeds):
        t = time.perf_counter()
        columns = job.make_inputs(data_seed(seed))
        table = job.table(columns)
        fseed = fit_seed(seed, 0)
        out, _ = job.fit(table, fseed)
        for unit in job.units(columns, [(fseed, out)], seed):
            ref = unit.reference()
            head = {"seed": seed, "unit": unit.prefix}
            emit({**head, "who": "program", **unit.numbers(unit.out, ref),
                  "s": time.perf_counter() - t})
            if n >= controls:
                continue
            for who, kwargs in [("control_tf32", {"tf32": True})] + list(
                    job.faults().items()):
                got = unit.as_output(unit.reference(**kwargs))
                emit({**head, "who": who, **unit.numbers(got, ref)})
            if unit.prefix.startswith("fit@"):
                variants = getattr(job, "program_variants", dict)()
                for who, fn in variants.items():
                    emit({**head, "who": who,
                          **unit.numbers(fn(table, fseed), ref)})
        del table, columns, out
        if job.device.type == "cuda":
            torch.cuda.empty_cache()


def control_checks(workload: str, seed: int, spec_hook=None,
                   device=None) -> list:
    """``[(name, value, limit)]`` of the control put in the program's
    place (the reference with its products on the TF32 tensor cores),
    held against the float32 reference by the cell's own limits: the run
    that ``correct`` has to refuse."""
    from portbench.jobs.seeds import data_seed, fit_seed

    job, spec = _job(workload, spec_hook, device)
    columns = job.make_inputs(data_seed(seed))
    fseed = fit_seed(seed, 0)
    out, _ = job.fit(job.table(columns), fseed)
    checks = []
    for unit in job.units(columns, [(fseed, out)], seed):
        unit.out = unit.as_output(unit.reference(tf32=True))
        checks += unit.compare(spec["traffic"]["limits"])
    return checks


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--out")
    args = p.parse_args()
    sys.path[0] = ROOT
    from portbench.cachedirs import configure

    configure(ROOT)
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec, default=float)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    try:
        readings(args.workload, seeds, args.controls, emit)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
