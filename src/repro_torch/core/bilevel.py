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

The LM problem (:func:`lm_bilevel_problem`) also carries memory-bounded
gradient paths (``grad_f_xy``, ``grad_g_y``): the gradient accumulated over
microbatches of the batch (:func:`microbatched_grad`). The reference's
sharding constraints (``constrain_x``/``constrain_y``) have no counterpart:
the port runs on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.func import grad

from repro_torch.core.tree_util import tree_index, tree_map, tree_sqnorm


@dataclasses.dataclass(frozen=True)
class BilevelProblem:
    f: Callable[..., torch.Tensor]              # f(xp, yp, batch) -> scalar
    g: Callable[..., torch.Tensor]              # g(xp, yp, batch) -> scalar
    features: Optional[Callable[..., Any]] = None       # features(xp, batch)
    f_from_feats: Optional[Callable[..., torch.Tensor]] = None
    g_from_feats: Optional[Callable[..., torch.Tensor]] = None
    # optional memory-bounded gradient paths (microbatched accumulation):
    grad_f_xy: Optional[Callable[..., Any]] = None  # (xp,yp,b) -> (gx, gy)
    grad_g_y: Optional[Callable[..., Any]] = None   # (xp,yp,b) -> gy
    # run the clients' gradients one client at a time, not under vmap
    # (core/adafbio.per_client): the LM problem's, whose client holds a
    # working set of gigabytes
    client_loop: bool = False

    @property
    def factored(self) -> bool:
        return self.features is not None


def _split_chunks(batch, nc: int):
    return tree_map(lambda a: a.reshape((nc, a.shape[0] // nc)
                                        + tuple(a.shape[1:])), batch)


def microbatched_grad(loss, argnums, nc: int, acc_dtype=None):
    """grad of a mean-loss, accumulated over ``nc`` microbatches in order.

    Bounds backward transients to one microbatch. ``acc_dtype`` None =
    accumulate in f32; "param" = accumulate in each param's own dtype (bf16
    at LLM scale). Each chunk adds ``(g / nc)`` cast to the accumulator's
    dtype, as the reference's scan body does (summing first and dividing
    last would round differently). With one chunk the sum is the chunk's
    gradient itself, so no accumulator is allocated (at LM width it would
    be a second copy of the backbone).
    """
    gfn = grad(loss, argnums=argnums)

    def wrapped(xp, yp, batch):
        args = (xp, yp)
        like = args[argnums] if isinstance(argnums, int) else tuple(
            args[i] for i in argnums)
        if nc == 1:
            return tree_map(lambda gi, p: gi.to(p.dtype),
                            gfn(xp, yp, batch), like)
        chunks = _split_chunks(batch, nc)
        acc = tree_map(lambda p: torch.zeros(
            p.shape, dtype=p.dtype if acc_dtype == "param" else torch.float32,
            device=p.device), like)
        for c in range(nc):
            g = gfn(xp, yp, tree_index(chunks, c))
            acc = tree_map(lambda a, gi: a + (gi / nc).to(a.dtype), acc, g)
        return tree_map(lambda a, p: a.to(p.dtype), acc, like)

    return wrapped


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


def lm_bilevel_problem(cfg, ctx, nu: float,
                       microbatch: Optional[int] = None) -> BilevelProblem:
    """Hyper-representation learning on the LM: x = backbone, y = head.

    ``batch`` keys: "tokens" (LL/UL chosen by the caller), optional modality
    stubs. The LL adds the strongly-convex regulariser (nu/2)||y||^2
    (Problem (3)). ``microbatch``: max sequences per gradient microbatch
    (the memory bound of the big-batch ∇(x,y) f and ∇y g paths).
    """
    from repro_torch.models.model import features as model_features
    from repro_torch.models.model import head_logits

    def feats_fn(xp, batch):
        return model_features(cfg, xp, batch, ctx)

    def _xent_head(yp, feats, batch):
        logits = head_logits(cfg, yp, feats[:, :-1])
        return softmax_xent(logits, batch["tokens"][:, 1:])

    def g_from_feats(yp, feats, batch):
        return _xent_head(yp, feats, batch) + 0.5 * nu * tree_sqnorm(yp)

    def f_from_feats(yp, feats, batch):
        return _xent_head(yp, feats, batch)

    def g(xp, yp, batch):
        return g_from_feats(yp, feats_fn(xp, batch), batch)

    def f(xp, yp, batch):
        return f_from_feats(yp, feats_fn(xp, batch), batch)

    def _nc(batch):
        n = batch["tokens"].shape[0]
        if microbatch is None or n <= microbatch:
            return 1
        if n % microbatch:
            raise ValueError(f"batch of {n} sequences does not split into "
                             f"microbatches of {microbatch}")
        return n // microbatch

    acc_dtype = "param" if cfg.dtype == "bfloat16" else None

    def grad_f_xy(xp, yp, batch):
        return microbatched_grad(f, (0, 1), _nc(batch), acc_dtype)(
            xp, yp, batch)

    def grad_g_y(xp, yp, batch):
        return microbatched_grad(g, 1, _nc(batch), acc_dtype)(xp, yp, batch)

    return BilevelProblem(f=f, g=g, features=feats_fn,
                          f_from_feats=f_from_feats, g_from_feats=g_from_feats,
                          grad_f_xy=grad_f_xy, grad_g_y=grad_g_y,
                          client_loop=True)


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
