"""Unified adaptive matrices (paper Alg. 1 line 6, Eqs. (8)-(9), Assumption 6).

The server generates, at every sync step, a diagonal matrix A_t for the UL
variable x and a scalar matrix B_t = b_t·I for the LL variable y, from the
*averaged* estimators (w̄, v̄). All clients then share (A_t, B_t) for the next
q local steps. Variants:

  adam      : a_t = ϱ a + (1−ϱ) w̄²,          A = diag(√a + ρ)       (line 6)
  adabelief : a_t = ϱ a + (1−ϱ)(w̄ − w̄_prev)², A = diag(√a + ρ)     (Eq. 8)
  amsgrad   : adam's a_t but A uses the running MAX (monotone precond.)
  adagrad   : a_t = a + w̄² (no EMA),          A = diag(√a + ρ)
  none      : A = I, B = I                                      (Theorem 2)

B_t: b_t = ϱ b + (1−ϱ)‖v̄‖ (line 6) / ‖v̄ − v̄_prev‖ (Eq. 9). Every scalar
stays a 0-d f32 tensor on the device, so no step waits on the host.
``precondition_x`` broadcasts ``a`` over a leading client axis of ``w``.

A state whose ``b`` is a [n] vector is a bank of n states, one per gossip
node (every leaf stacked on a leading node axis, the reference's
``vmap(sync_update)``): ``update_adaptive`` then takes each node's norm of
its own ``v̄`` row, and the preconditioners apply row by row.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.tree_util import (tree_leaves, tree_map, tree_norm,
                                        tree_row_norm, tree_zeros_like)


def _scalar(value: float, like) -> torch.Tensor:
    device = tree_leaves(like)[0].device
    return torch.full((), value, dtype=torch.float32, device=device)


def init_adaptive_state(x_like, kind: str) -> Dict[str, Any]:
    """``a`` inherits each param's dtype."""
    st = {"b": _scalar(0.0, x_like)}
    if kind != "none":
        st["a"] = tree_map(torch.zeros_like, x_like)
    if kind == "adabelief":
        st["w_prev"] = tree_zeros_like(st["a"])
        st["v_norm_prev"] = _scalar(0.0, x_like)
    if kind == "amsgrad":
        st["a_max"] = tree_zeros_like(st["a"])
    return st


def per_node(state) -> bool:
    """True for a bank of per-node states (``b`` a [n] vector)."""
    return state["b"].dim() == 1


def _ema_sq(a, w, varrho: float):
    return (varrho * a.float() + (1 - varrho) * w.float() ** 2).to(a.dtype)


def update_adaptive(state: Dict[str, Any], w_bar, v_bar, *, kind: str,
                    varrho: float, b_max: float = 1e3) -> Dict[str, Any]:
    """Server-side regeneration at a sync step."""
    new = dict(state)
    vn = tree_row_norm(v_bar) if per_node(state) else tree_norm(v_bar)
    if kind == "adam":
        new["a"] = tree_map(lambda a, w: _ema_sq(a, w, varrho),
                            state["a"], w_bar)
        new["b"] = torch.clamp(varrho * state["b"] + (1 - varrho) * vn,
                               max=b_max)
    elif kind == "adabelief":
        new["a"] = tree_map(
            lambda a, w, wp: (varrho * a.float()
                              + (1 - varrho) * (w.float() - wp.float()) ** 2
                              ).to(a.dtype),
            state["a"], w_bar, state["w_prev"])
        new["b"] = torch.clamp(
            varrho * state["b"]
            + (1 - varrho) * torch.abs(vn - state["v_norm_prev"]), max=b_max)
        new["w_prev"] = tree_map(lambda w, wp: w.to(wp.dtype), w_bar,
                                 state["w_prev"])
        new["v_norm_prev"] = vn
    elif kind == "amsgrad":
        new["a"] = tree_map(lambda a, w: _ema_sq(a, w, varrho),
                            state["a"], w_bar)
        new["a_max"] = tree_map(torch.maximum, state["a_max"], new["a"])
        new["b"] = torch.clamp(varrho * state["b"] + (1 - varrho) * vn,
                               max=b_max)
    elif kind == "adagrad":
        new["a"] = tree_map(lambda a, w: (a.float() + w.float() ** 2
                                          ).to(a.dtype), state["a"], w_bar)
        new["b"] = torch.clamp(state["b"] + vn, max=b_max)
    elif kind == "none":
        new["b"] = torch.ones_like(state["b"])
    else:
        raise ValueError(kind)
    return new


def precondition_x(state, w, *, kind: str, rho: float):
    """A_t^{-1} w (diagonal)."""
    if kind == "none":
        return w
    acc = state["a_max"] if kind == "amsgrad" else state["a"]
    return tree_map(
        lambda wi, a: (wi.float() / (torch.sqrt(a.float()) + rho)
                       ).to(wi.dtype), w, acc)


def precondition_y(state, v, *, kind: str, rho: float):
    """B_t^{-1} v = v / (b_t + ρ) (a node's own b_t on each row of a
    per-node bank)."""
    if kind == "none":
        return v
    scale = 1.0 / (state["b"] + rho)
    return tree_map(lambda vi: (vi * scale.reshape(
        scale.shape + (1,) * (vi.dim() - scale.dim()))).to(vi.dtype), v)
