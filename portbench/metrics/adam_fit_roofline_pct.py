"""Dense Adam's share of its roofline inside the fit: the bound of
``adam_roofline_pct`` (``bound_s`` of the job's parameter tree, 28 bytes
a value at 3.35 TB/s) over the card's mean busy time under the
``wd_step.adam`` spans (``widedeep.py::_make_train_ops``) of a profiled
one-epoch fit, where Adam runs between the steps that feed it
(``portbench/spans.py``)."""

from portbench.metrics.adam_roofline_pct import bound_s
from portbench.spans import mean_busy_s


def read(run):
    shapes_of = getattr(run.job, "param_shapes", None)
    if shapes_of is None:
        return None
    s = mean_busy_s(run, "wd_step.adam")
    return None if not s else 100.0 * bound_s(shapes_of()) / s
