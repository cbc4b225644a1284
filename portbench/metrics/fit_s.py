"""Seconds a whole fit: the window's wall time on the host clock over the
number of whole fits it completed (a mean over all the window's time)."""


def read(run):
    return run.fit_s if run.fit_walls else None
