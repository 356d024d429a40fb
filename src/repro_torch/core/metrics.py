"""Analysis-quantity monitoring: the terms the paper's proof tracks.

Theorem 1's Lyapunov function and the consensus lemmas (Lemmas 20-21) bound:

  consensus error   (1/M) Σ_m ‖θ^m − θ̄‖²  for θ ∈ {x, y, v, w}
                    (resets to 0 at every sync; grows ∝ q between syncs)
  estimator drift   ‖v̄ − ∇y g(x̄,ȳ)‖, ‖w̄ − ∇̂f(x̄,ȳ)‖ (STORM tracking error)
  LL optimality gap ‖ȳ − y*(x̄)‖ (when y* is computable)

If the consensus error stops contracting at syncs, q is too large for the
current learning rates (the (12kλq)³ M^{5/2} condition in Theorem 1).
States carry a leading client axis M; every value is a 0-d f32 tensor on
the states' device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.func import grad

from repro_torch.core.bilevel import BilevelProblem
from repro_torch.core.tree_util import (tree_leaves, tree_mean_axis0,
                                        tree_sqnorm, tree_sub)


def consensus_error(states: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """(1/M) Σ_m ‖θ^m − θ̄‖² per state field."""
    avg = tree_mean_axis0(states)
    m = tree_leaves(states)[0].shape[0]
    out = {}
    for field in ("x", "y", "v", "w"):
        if field not in states:
            continue
        total = None
        for a, b in zip(tree_leaves(states[field]), tree_leaves(avg[field])):
            d = torch.sum((a.float() - b.float().unsqueeze(0)) ** 2)
            total = d if total is None else total + d
        out[field] = total / m
    return out


def estimator_drift(problem: BilevelProblem, states: Dict[str, Any],
                    batches_avg) -> Dict[str, torch.Tensor]:
    """‖v̄ − ∇y g(x̄,ȳ;ζ)‖ and the norms of v̄ and w̄, on a probe batch."""
    avg = tree_mean_axis0(states)
    gy = grad(problem.g, argnums=1)(avg["x"], avg["y"], batches_avg)
    dv = tree_sub(avg["v"], gy)
    return {"v_drift": torch.sqrt(tree_sqnorm(dv)),
            "v_norm": torch.sqrt(tree_sqnorm(avg["v"])),
            "w_norm": torch.sqrt(tree_sqnorm(avg["w"]))}


def lyapunov_terms(problem: BilevelProblem, states: Dict[str, Any],
                   batches_avg, y_star_fn=None) -> Dict[str, torch.Tensor]:
    """The measurable pieces of Theorem 1's Ω_t (F(x̄) + LL gap + drift)."""
    avg = tree_mean_axis0(states)
    out = {"F": problem.f(avg["x"], avg["y"], batches_avg)}
    if y_star_fn is not None:
        ys = y_star_fn(avg["x"], avg["y"])
        out["ll_gap_sq"] = tree_sqnorm(tree_sub(avg["y"], ys))
    return out


class MetricsLog:
    """Append-only metrics recorder used by the drivers."""

    def __init__(self):
        self.rows = []

    def log(self, step: int, **scalars):
        row = {"step": step}
        row.update({k: float(v) for k, v in scalars.items()})
        self.rows.append(row)

    def column(self, key):
        return [r.get(key) for r in self.rows]

    def last(self):
        return self.rows[-1] if self.rows else {}
