"""Bilevel problem abstraction (Problem (1) of the paper).

A ``BilevelProblem`` bundles the per-client UL objective ``f^m(x, y; xi)`` and
LL objective ``g^m(x, y; zeta)``. Two calling conventions:

- generic: ``f(xp, yp, batch)`` / ``g(xp, yp, batch)`` scalars, used by the
  paper-faithful hypergradient estimator.
- factored (optional fast path): ``features(xp, batch)`` with
  ``g_from_feats(yp, feats, batch)`` / ``f_from_feats(yp, feats, batch)``.
  When the LL variable only touches the loss through the features, the
  Neumann ``∇²yy g`` products need only head-local autodiff against cached
  features.

Every function is written for ONE client and must work under
``torch.func`` transforms (``grad``, ``jvp``, ``vmap``): no ``.item()``, no
in-place updates, no data-dependent Python control flow.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class BilevelProblem:
    f: Callable[..., torch.Tensor]              # f(xp, yp, batch) -> scalar
    g: Callable[..., torch.Tensor]              # g(xp, yp, batch) -> scalar
    features: Optional[Callable[..., Any]] = None       # features(xp, batch)
    f_from_feats: Optional[Callable[..., torch.Tensor]] = None
    g_from_feats: Optional[Callable[..., torch.Tensor]] = None

    @property
    def factored(self) -> bool:
        return self.features is not None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy. logits [..., V], labels [...] int."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    iota = torch.arange(lf.shape[-1], dtype=labels.dtype, device=lf.device)
    ll = torch.where(iota == labels.unsqueeze(-1), lf,
                     torch.zeros((), dtype=lf.dtype, device=lf.device)
                     ).sum(dim=-1)
    loss = lse - ll
    if mask is not None:
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1)
    return loss.mean()


def quadratic_bilevel_problem(H: torch.Tensor, Bm: torch.Tensor,
                              c: torch.Tensor,
                              Q: torch.Tensor) -> BilevelProblem:
    """Analytic test problem with closed-form hypergradient:

      g(x, y) = 1/2 y^T H y - (B x)^T y          (H ≻ 0)
      f(x, y) = 1/2 ||y - c||^2 + 1/2 x^T Q x
      y*(x)   = H^{-1} B x
      ∇F(x)   = Q x + B^T H^{-1} (y*(x) - c)
    """
    def g(xp, yp, batch):
        del batch
        return 0.5 * yp @ H @ yp - (Bm @ xp) @ yp

    def f(xp, yp, batch):
        del batch
        return 0.5 * torch.sum((yp - c) ** 2) + 0.5 * xp @ Q @ xp

    return BilevelProblem(f=f, g=g)


def quadratic_true_grad(H, Bm, c, Q, x):
    y_star = torch.linalg.solve(H, Bm @ x)
    return Q @ x + Bm.T @ torch.linalg.solve(H, y_star - c)
