"""The host route of the routed table gradients (``ops/emb_grad.py``): the
seconds a fit spends building it, ``WideDeep.route_info["build_s"]``,
as a mean over the window's fits.  Nothing to read in a fit without a
route."""


def read(run):
    got = [i.get("route_build_s") for i in run.infos]
    got = [g for g in got if g is not None]
    return sum(got) / len(got) if got else None
