"""Adam and LazyAdam written out by hand, over trees of tensors.

The JAX package trains Wide&Deep with ``optax.adam``; this module repeats
``optax.scale_by_adam`` (optax 0.2.6) expression by expression, in its
order, so one step from the same state rounds the same way:

    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * g**2 + b2 * nu
    count += 1
    mu_hat = mu / (1 - b1**count)
    nu_hat = nu / (1 - b2**count)
    u = mu_hat / (sqrt(nu_hat) + eps)
    p = p + (-lr) * u

(``torch.optim.Adam`` orders these differently, and Adam amplifies
ulp-level differences 10-20x per epoch.)  The bias corrections are f32 on
the host: the step count is a Python int, so the loop never reads the
device.  Each line is one ``torch._foreach_*`` call over every leaf, so a
step costs a dozen launches, not a dozen per leaf.

:func:`lazy_adam_rows` is the LazyAdam update of the JAX package's
``widedeep.py`` at the rows a batch touches.

A tree is a tensor, or a dict / list / tuple of trees; dict leaves are
visited in sorted key order (JAX's pytree order).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

__all__ = ["Adam", "AdamState", "adam_init", "adam_update",
           "lazy_adam_rows", "bias_correction", "tree_leaves",
           "tree_unflatten", "tree_map"]


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    return _build(like, iter(leaves))


def _build(t, it) -> Any:
    # a module-level recursion, not a closure over ``it``: a recursive
    # closure is a reference cycle, which would hold ``leaves`` (a step's
    # gradients, moments and parameters on the card) until Python's
    # collector ran, and so move the peak memory with its timing
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)


def tree_map(fn: Callable, tree, *rest) -> Any:
    return tree_unflatten(tree, [fn(*xs) for xs in zip(
        tree_leaves(tree), *(tree_leaves(r) for r in rest))])


@dataclass
class AdamState:
    """``optax.ScaleByAdamState``: the step count and the two moment trees
    (shaped like the parameters)."""

    count: int
    mu: Any
    nu: Any


def adam_init(params) -> AdamState:
    zeros = tree_map(torch.zeros_like, params)
    return AdamState(count=0, mu=zeros,
                     nu=tree_map(torch.zeros_like, params))


def bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in f32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def adam_update(grads, state: AdamState, params, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                ) -> Tuple[Any, AdamState]:
    """One ``optax.adam(lr)`` step followed by ``optax.apply_updates``:
    ``(new_params, new_state)``.  Nothing is updated in place."""
    g = tree_leaves(grads)
    mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                            torch._foreach_mul(tree_leaves(state.mu), b1))
    nu = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
        torch._foreach_mul(tree_leaves(state.nu), b2))
    count = state.count + 1
    mu_hat = torch._foreach_div(mu, bias_correction(b1, count))
    nu_hat = torch._foreach_div(nu, bias_correction(b2, count))
    u = torch._foreach_div(
        mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), eps))
    new = torch._foreach_add(tree_leaves(params), torch._foreach_mul(u, -lr))
    return tree_unflatten(params, new), AdamState(
        count=count, mu=tree_unflatten(params, mu),
        nu=tree_unflatten(params, nu))


@dataclass(frozen=True)
class Adam:
    """``optax.adam(lr)`` as a value: ``init(params)`` and ``update(grads,
    state, params) -> (new_params, new_state)`` (optax's ``update`` and
    ``apply_updates`` in one call)."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> AdamState:
        return adam_init(params)

    def update(self, grads, state: AdamState, params
               ) -> Tuple[Any, AdamState]:
        return adam_update(grads, state, params, self.lr, self.b1,
                           self.b2, self.eps)


def lazy_adam_rows(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, ids: torch.Tensor, t: int, lr: float,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                   ) -> None:
    """LazyAdam at the rows ``ids`` (int64, duplicates allowed) of a table
    whose dense gradient is ``g``, at step ``t`` (already incremented).
    Updates ``table``, ``m`` and ``v`` IN PLACE at those rows only (copying
    the full tables each step would stream what the lazy update exists to
    skip).  The expression of the JAX package's lazy step:

        m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g**2
        table = table - lr * (m / bc1) / (sqrt(v / bc2) + eps)

    A duplicated id computes the same values at every occurrence (its
    gradient row is the combined one), so the writes agree."""
    bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)
    g_rows = g[ids]
    m_rows = b1 * m[ids] + (1.0 - b1) * g_rows
    v_rows = b2 * v[ids] + (1.0 - b2) * torch.square(g_rows)
    step_rows = lr * (m_rows / bc1) / (torch.sqrt(v_rows / bc2) + eps)
    new_rows = table[ids] - step_rows
    m[ids] = m_rows
    v[ids] = v_rows
    table[ids] = new_rows
