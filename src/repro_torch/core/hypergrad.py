"""Stochastic Neumann-series hypergradient estimator (paper Eq. (15)).

  ∇̂f(x,y; ξ̄) = ∇x f(x,y;ξ) − ∇²xy g(x,y;ζ₀) ·
                 [ K·θ · Π_{i=1..k} (I − θ ∇²yy g(x,y;ζ_i)) ] · ∇y f(x,y;ξ)

with k ~ U{0,…,K−1}, θ ∈ (0, 1/L_g]. Written for ONE client with
``torch.func``; callers batch clients with ``torch.func.vmap``. The depth
``k`` is an input (a 0-d integer tensor), not a draw made here. So that one
vmapped call serves clients with different ``k``, the Neumann loop always
runs ``K-1`` iterations and keeps, per client, only the first ``k`` of them:
the same values as a loop of ``k`` iterations.

Two implementations:
  * ``hypergrad``           — paper-faithful, generic autodiff (grad-of-grad).
  * ``hypergrad_factored``  — the factored LL fast path (features cached in
    bf16; the Neumann loop touches only the head). Same estimator.

``batches`` layout: {"f": ξ batch, "g0": ζ₀ batch, "gi": ζ_{1..K} batches with
a leading K axis}.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.func import grad, jvp, vmap

from repro_torch.core.bilevel import BilevelProblem
from repro_torch.core.tree_util import (tree_axpy, tree_index, tree_map,
                                        tree_scale, tree_sub, tree_vdot)


def _grad_y(g, xp, yp, batch):
    return grad(g, argnums=1)(xp, yp, batch)


def _hvp_yy(g, xp, yp, batch, u):
    """(∇²yy g) u via jvp of grad."""
    return jvp(lambda y: _grad_y(g, xp, y, batch), (yp,), (u,))[1]


def _mixed_xy(g, xp, yp, batch, u):
    """(∇²xy g) u = ∇x ⟨∇y g(x,y), u⟩ (maps y-space -> x-space)."""
    def inner(x):
        return tree_vdot(_grad_y(g, x, yp, batch), u)
    return grad(inner)(xp)


def _neumann(hvp, gy, k, K: int, theta: float):
    """p = K·θ · Π_{i=1..k}(I − θ H_i) ∇y f; iteration i reads batch ζ_i and
    is kept only where i < k."""
    p = gy
    for i in range(K - 1):
        stepped = tree_axpy(-theta, hvp(i, p), p)          # p − θ H_i p
        keep = i < k
        p = tree_map(lambda s, q: torch.where(keep, s, q), stepped, p)
    return tree_scale(p, K * theta)


def _grad_f_xy(problem, xp, yp, batch):
    """(∇x f, ∇y f) in ONE backward, microbatched where the problem says
    how (``grad_f_xy``)."""
    if problem.grad_f_xy is not None:
        return problem.grad_f_xy(xp, yp, batch)
    return grad(problem.f, argnums=(0, 1))(xp, yp, batch)


def hypergrad(problem: BilevelProblem, xp, yp, batches: Dict[str, Any],
              k, K: int, theta: float):
    """Paper-faithful estimator. Returns the x-space tree w."""
    gx, gy = _grad_f_xy(problem, xp, yp, batches["f"])

    def hvp(i, p):
        return _hvp_yy(problem.g, xp, yp, tree_index(batches["gi"], i), p)

    p = _neumann(hvp, gy, k, K, theta)
    corr = _mixed_xy(problem.g, xp, yp, batches["g0"], p)
    return tree_sub(gx, corr)


def hypergrad_factored(problem: BilevelProblem, xp, yp,
                       batches: Dict[str, Any], k, K: int, theta: float):
    """Fast path: identical estimator; the Neumann ∇²yy products run against
    cached features (LL depends on x only through features)."""
    if not problem.factored:
        raise ValueError("hypergrad_factored needs a factored problem "
                         "(features / g_from_feats)")
    gx, gy = _grad_f_xy(problem, xp, yp, batches["f"])

    # features of the K Neumann batches, computed once and stored bf16: they
    # are loop-invariant inputs of the Neumann loop, so their dtype is a
    # live-memory term
    feats_i = vmap(lambda b: problem.features(xp, b))(batches["gi"])
    feats_i = tree_map(lambda a: (a.to(torch.bfloat16)
                                  if a.dtype == torch.float32 else a
                                  ).detach(), feats_i)

    def hvp(i, p):
        fi = tree_index(feats_i, i)
        bi = tree_index(batches["gi"], i)
        grad_y = lambda y: grad(problem.g_from_feats)(y, fi, bi)
        return jvp(grad_y, (yp,), (p,))[1]

    p = _neumann(hvp, gy, k, K, theta)
    corr = _mixed_xy(problem.g, xp, yp, batches["g0"], p)
    return tree_sub(gx, corr)


def hypergrad_fn(problem: BilevelProblem, K: int, theta: float):
    """The estimator for ``problem``: the factored path when it has one."""
    impl = hypergrad_factored if problem.factored else hypergrad
    return lambda xp, yp, batches, k: impl(problem, xp, yp, batches, k,
                                           K, theta)
