"""The card memory the window's fits held at their peak:
``torch.cuda.max_memory_allocated()`` over the window, after a reset that
follows the warm-up, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
