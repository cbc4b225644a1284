"""The precision a reference computes its products in."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def products(tf32: bool):
    """Matrix products in full float32 (``tf32=False``) or on the TF32
    tensor cores (``tf32=True``, the control one precision below), restored
    on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
