"""Metric readers, one file a metric, named as the metric.  Each
``read(run)`` takes the :class:`portbench.harness.Run` and returns the
metric's value, or None where this cell has nothing to read (the metric is
then left out of the line)."""
