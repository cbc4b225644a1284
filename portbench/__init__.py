"""The benchmark of the PyTorch/CUDA port (``flink_ml_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; everything a cell needs is
found by name: its configuration in ``configs/<config>.json``, its traffic
in ``workloads/<traffic>.json``, the job that the traffic names in
``jobs/<job>.py``, the data generator in ``gen/<generator>.py`` and each
metric's reader in ``metrics/<metric>.py``.  ``reference/`` holds the plain
PyTorch versions that decide ``correct``; it imports nothing of the port.
"""
