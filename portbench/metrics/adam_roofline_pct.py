"""Dense Adam's share of its roofline (``models/common/adam.py``
``adam_update``) on the fit's parameter tree: CUDA events around chained
updates, against 28 bytes a value (gradient, both moments and the
parameter read; both moments and the parameter written) at 3.35 TB/s."""

import numpy as np
import torch

from portbench import peaks

WARM, REPS = 3, 20
BYTES_PER_VALUE = 28


def values(shapes) -> int:
    if isinstance(shapes, dict):
        return sum(values(v) for v in shapes.values())
    if isinstance(shapes, list):
        return sum(values(v) for v in shapes)
    return int(np.prod(shapes, dtype=np.int64))


def bound_s(shapes) -> float:
    return peaks.roofline_s(0.0, BYTES_PER_VALUE * values(shapes))


def read(run):
    shapes_of = getattr(run.job, "param_shapes", None)
    if shapes_of is None or run.device.type != "cuda":
        return None
    from flink_ml_tpu_torch.models.common.adam import (adam_init,
                                                       adam_update)

    shapes = shapes_of()
    g = torch.Generator(device=run.device)
    g.manual_seed(run.seed % (1 << 63))

    def tree(s):
        if isinstance(s, dict):
            return {k: tree(v) for k, v in s.items()}
        if isinstance(s, list):
            return [tree(v) for v in s]
        return torch.randn(s, generator=g, device=run.device)

    params, grads = tree(shapes), tree(shapes)
    state = adam_init(params)
    lr = float(run.config["learning_rate"])
    for _ in range(WARM):
        params, state = adam_update(grads, state, params, lr)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        params, state = adam_update(grads, state, params, lr)
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) * 1e-3 / REPS
    return 100.0 * bound_s(shapes) / seconds
