"""Input generators, one module a generator, found by the name a traffic
file gives.  Each ``make(config, data, seed, device)`` draws the inputs
from ``seed`` on ``device`` (the card in a run) with a ``torch.Generator``
in a few large calls and returns host numpy columns."""
