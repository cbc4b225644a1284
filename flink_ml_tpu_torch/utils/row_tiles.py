"""Row-invariant scoring: a row-wise function run on tiles of one shape.

A matrix product's library kernel is picked by shape (cuBLAS on the card,
the CPU's BLAS), and with it the order of a row's sums: the same row can
get other bits in a batch of 8 rows than in one of 64.  Served requests
ride coalesced batches of any size while their offline ``transform``
runs them alone, so a scoring path whose product would change with the
batch runs it here, on tiles of exactly :data:`ROW_TILE` rows: every
call has one shape, and a row's bits no longer depend on its batch.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["ROW_TILE", "in_row_tiles"]

#: rows of every tile: at the Wide&Deep bench width a product over 256
#: rows costs what one over 8 does on the card
#: (``scripts/serving_bucket_bits.py``)
ROW_TILE = 256


def in_row_tiles(fn: Callable[..., torch.Tensor], *rows: torch.Tensor,
                 tile: int = ROW_TILE) -> torch.Tensor:
    """``fn(*rows)`` for a ROW-WISE ``fn``, computed on consecutive tiles of
    ``tile`` rows (the last tile padded with zero rows) and concatenated
    back to the input's row count."""
    n = rows[0].shape[0]
    pad = (-n) % tile
    if pad:
        rows = tuple(torch.cat([r, r.new_zeros((pad,) + r.shape[1:])])
                     for r in rows)
    return torch.cat([fn(*(r[s:s + tile] for r in rows))
                      for s in range(0, n + pad, tile)])[:n]
