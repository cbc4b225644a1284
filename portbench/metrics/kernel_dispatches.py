"""The port's hand-written kernel launches and registry dispatches over
one fit (the traced one): the ops modules' ``LAUNCHES`` counters and
``KernelStats.dispatches``, as ``kernels/registry.py`` reports them."""


def read(run):
    return run.profile["launches"] if run.profile else None
