"""AdaFBiO — Algorithm 1 of the paper, as client-batched step functions.

What this module owns: the paper's per-iteration math — the eta_t /
alpha / beta schedules (§4), the STORM variance-reduced estimator refreshes
(Eqs. 10-11), the adaptive-matrix local update (Eq. 14), and the sync-step
server update with adaptive regeneration (Eqs. 8-9, lines 4-9).
Hypergradients come from :mod:`repro_torch.core.hypergrad` (Eq. 15),
adaptive matrices from :mod:`repro_torch.core.adaptive`, and the fused
flat-buffer kernels from :mod:`repro_torch.kernels.ops` (selected by
``FedConfig.fused``).

Client states carry a leading M axis: per-client gradients run through
``torch.func.vmap`` (:func:`per_client`; one client, and the clients of a
problem that asks for it, run without it), and each fused kernel then
launches ONCE over all clients' leaves.

State:
  ClientState = {"x", "y", "v", "w"}        (each leaf [M, ...])
  ServerState = {"adaptive": {...}, "t": 0-d int32 tensor}

One iteration t:
  * local step (lines 10-14 + 16-20):
      x⁺ = x − γ η_t A⁻¹ w  (Eq. 14),  y⁺ = y − λ η_t B⁻¹ v
      STORM refresh (Eqs. 10-11) with same-sample grads at (new, old) params
  * sync (lines 4-9): the runtime averages states across clients, calls
    ``sync_update`` (adaptive regeneration + one server update), and
    broadcasts.

The paper's schedules: η_t = k·M^{1/3}/(n+t)^{1/3}, α_{t+1} = c1 η_t²,
β_{t+1} = c2 η_t² (both clipped to (0, 1]). They are computed as f32
tensors on the device from the int32 step counter ``t``, as the reference
computes them, so no step waits on the host.

Randomness is an input: ``k`` holds each client's Neumann depth for the step.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.func import grad, vmap

from repro_torch.configs.base import FedConfig
from repro_torch.core import adaptive as ada
from repro_torch.core.bilevel import BilevelProblem
from repro_torch.core.hypergrad import hypergrad_fn
from repro_torch.core.tree_util import (tree_axpy, tree_bcast_axis0,
                                        tree_leaves, tree_map,
                                        tree_match_dtypes, tree_sub,
                                        tree_update)


# ------------------------------------------------------------------ schedules

def eta_t(fed: FedConfig, t: torch.Tensor, m: int) -> torch.Tensor:
    num = torch.full((), fed.eta_k * (m ** (1 / 3)), dtype=torch.float32,
                     device=t.device)
    return num / (fed.eta_n + t.to(torch.float32)) ** (1 / 3)


def alpha_beta(fed: FedConfig, eta):
    a = torch.clamp(fed.alpha_c1 * eta ** 2, 0.0, 1.0)
    b = torch.clamp(fed.beta_c2 * eta ** 2, 0.0, 1.0)
    return a, b


def grad_g_y_fn(problem: BilevelProblem):
    """One client's ∇y g(x, y; ζ), microbatched where the problem says how
    (``grad_g_y``)."""
    return problem.grad_g_y or grad(problem.g, argnums=1)


def per_client(fn, loop: bool = False):
    """``fn`` mapped over the leading client axis of all its arguments:
    ``vmap``, or ``fn`` on each client's slices in turn, its outputs
    written into one stacked tree (the same function without the batching
    layer). One client always runs so, with the axis put back as a view,
    and so do the clients of every call with ``loop`` (a problem's
    ``client_loop``: the LM problem's).

    Why: at M = 1 ``vmap`` gives the same peak and device time, but its
    batching layer costs the host-bound qwen1.5-4b step 0.8-1.9 s: 3.8-4.5
    s a step against 2.6-3.0 s on an H100 80GB HBM3 at 700 W
    (``launch/profile_train.py``). For a cohort of 2 at full width (4
    layers, seq 512, ``chip_smoke.py``'s lm-population phase, same card)
    ``vmap`` took 21.8 s a round and peaked at 70.05 GB; one client at a
    time, 3.6-4.0 s and 58.06 GB; under ``vmap`` the async and gossip
    rounds (2 and 4 clients at 2 layers) ran out of the card's memory at
    seq 512 and 256 alike. The MNIST-width tasks keep ``vmap``: one client
    at a time took 6.0-6.9x its time a round on the main path (8 clients,
    595-608 ms against 3,624-4,083 ms) and 5.7-6.6x on population N 32
    C 8 (533-541 against 3,069-3,501 ms), at the same peak (same card,
    ``scripts/cohort_loop_times.py``)."""
    batched = vmap(fn)

    def call(*args):
        m = tree_leaves(args)[0].shape[0]
        if m != 1 and not loop:
            return batched(*args)
        if m == 1:
            out = fn(*tree_map(lambda a: a[0], args))
            return tree_map(lambda a: a.unsqueeze(0), out)
        out = None
        for i in range(m):
            row = fn(*tree_map(lambda a: a[i], args))
            if out is None:
                out = tree_map(lambda a: a.new_empty((m,) + a.shape), row)
            tree_map(lambda o, a: o[i].copy_(a), out, row)
            del row
        return out
    return call


def _ll_batch(batches):
    return batches.get("g", batches["g0"])        # ζ_{t+1}: the LL minibatch


# ------------------------------------------------------------------ init

def init_client_state(problem: BilevelProblem, fed: FedConfig, xp, yp,
                      batches, k) -> Dict[str, Any]:
    """Line 2: initial estimators from a sample, for M clients that share
    ``(xp, yp)``; ``batches`` and the depths ``k`` are stacked [M, ...]."""
    hg = hypergrad_fn(problem, fed.neumann_k, fed.theta)
    gy = grad_g_y_fn(problem)
    m = k.shape[0]
    loop = problem.client_loop
    v = per_client(lambda b: gy(xp, yp, b), loop)(_ll_batch(batches))
    w = per_client(lambda b, kk: hg(xp, yp, b, kk), loop)(batches, k)
    return {"x": tree_bcast_axis0(xp, m), "y": tree_bcast_axis0(yp, m),
            "v": v, "w": w}


def init_server_state(x_like, fed: FedConfig) -> Dict[str, Any]:
    device = tree_leaves(x_like)[0].device
    return {"adaptive": ada.init_adaptive_state(x_like, fed.adaptive),
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def warm_adaptive(server: Dict[str, Any], avg_state: Dict[str, Any],
                  fed: FedConfig) -> Dict[str, Any]:
    """Line 2 of Algorithm 1: generate A_1, B_1 from the initial averaged
    estimators (an a=0 start would make the first local phase take
    lr/ρ-scale steps)."""
    new = dict(server)
    new["adaptive"] = ada.update_adaptive(
        server["adaptive"], avg_state["w"], avg_state["v"],
        kind=fed.adaptive, varrho=0.0)
    return new


# ------------------------------------------------------------------ steps

def use_fused(fed: FedConfig, like) -> bool:
    """Whether the flat-buffer fused update path is active: "on"/"off"
    force it, "auto" takes it when the tensors of ``like`` are on CUDA."""
    mode = fed.fused
    if mode == "on":
        return True
    if mode == "off":
        return False
    return tree_leaves(like)[0].device.type == "cuda"


def param_update(fed: FedConfig, adaptive_state, x, y, v, w, eta):
    """Eqs. (12)-(14): adaptive-preconditioned interpolated update. ``x, y,
    v, w`` are client-stacked, or one (averaged) client's trees. A per-node
    ``adaptive_state`` (:func:`repro_torch.core.adaptive.per_node`) holds
    one accumulator per row of the stacked trees."""
    if use_fused(fed, x) and fed.adaptive != "none":
        from repro_torch.kernels import ops
        acc = (adaptive_state["a_max"] if fed.adaptive == "amsgrad"
               else adaptive_state["a"])
        x_new = ops.adafbio_update_tree(x, w, acc, fed.lr_x * eta, fed.rho)
    else:
        dx = ada.precondition_x(adaptive_state, w, kind=fed.adaptive,
                                rho=fed.rho)
        x_new = tree_update(x, dx, fed.lr_x * eta)
    # B_t is scalar (b·I): the y update is one cheap broadcast either way
    dy = ada.precondition_y(adaptive_state, v, kind=fed.adaptive, rho=fed.rho)
    y_new = tree_update(y, dy, fed.lr_y * eta)
    return x_new, y_new


def storm_refresh(problem: BilevelProblem, fed: FedConfig, states, x_new,
                  y_new, batches, k, alpha, beta):
    """Eqs. (10)-(11): same-sample gradients at new and old params, for all
    clients at once."""
    hg = per_client(hypergrad_fn(problem, fed.neumann_k, fed.theta),
                    problem.client_loop)
    gy = per_client(grad_g_y_fn(problem), problem.client_loop)
    bg = _ll_batch(batches)
    g_new = gy(x_new, y_new, bg)
    g_old = gy(states["x"], states["y"], bg)
    fused = use_fused(fed, states["v"])
    if fused:
        from repro_torch.kernels import ops
        v_new = ops.storm_update_tree(g_new, g_old, states["v"], alpha)
    else:
        v_new = tree_axpy(1.0 - alpha, tree_sub(states["v"], g_old), g_new)
    del g_new, g_old          # y-sized; freed before the hypergradients
    w_hat_new = hg(x_new, y_new, batches, k)
    w_hat_old = hg(states["x"], states["y"], batches, k)  # same sample & k
    if fused:
        w_new = ops.storm_update_tree(w_hat_new, w_hat_old, states["w"], beta)
    else:
        w_new = tree_axpy(1.0 - beta, tree_sub(states["w"], w_hat_old),
                          w_hat_new)
    return (tree_match_dtypes(v_new, states["v"]),
            tree_match_dtypes(w_new, states["w"]))


def local_step(problem: BilevelProblem, fed: FedConfig, states: Dict[str, Any],
               adaptive_state, batches, k, t, m: int) -> Dict[str, Any]:
    """One local iteration of every client (no cross-client communication);
    ``k`` holds the clients' Neumann depths, ``t`` is the int32 step."""
    eta = eta_t(fed, t, m)
    alpha, beta = alpha_beta(fed, eta)
    x_new, y_new = param_update(fed, adaptive_state, states["x"], states["y"],
                                states["v"], states["w"], eta)
    v_new, w_new = storm_refresh(problem, fed, states, x_new, y_new, batches,
                                 k, alpha, beta)
    return {"x": x_new, "y": y_new, "v": v_new, "w": w_new}


def sync_update(fed: FedConfig, server: Dict[str, Any],
                avg_state: Dict[str, Any], m: int) -> Tuple[Dict, Dict]:
    """Server part of the sync step (lines 5-8): regenerate (A_t, B_t) from the
    averaged estimators, then one preconditioned update on the averaged params.
    Returns (new broadcastable client state, new server state).

    A per-node server bank (the gossip engine: every leaf, ``t`` included,
    stacked on a leading node axis, ``avg_state`` the [n] mixed states) runs
    every node's server step at once, each on its own accumulators. The
    nodes step in lockstep, so their counters are equal and eta is read
    from node 0's.
    """
    t = server["t"]
    adaptive_state = ada.update_adaptive(
        server["adaptive"], avg_state["w"], avg_state["v"],
        kind=fed.adaptive, varrho=fed.varrho)
    eta = eta_t(fed, t.reshape(-1)[0], m)
    x_new, y_new = param_update(fed, adaptive_state, avg_state["x"],
                                avg_state["y"], avg_state["v"], avg_state["w"],
                                eta)
    new_client = {"x": x_new, "y": y_new, "v": avg_state["v"],
                  "w": avg_state["w"]}
    new_server = {"adaptive": adaptive_state, "t": t + 1}
    return new_client, new_server
