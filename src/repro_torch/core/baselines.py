"""Baselines from Table 1 (+ the single-level adaptive-FL comparison).

All baselines reuse the same substrate (hypergradient, client/server runtime)
with the knobs that define them, so benchmark comparisons isolate the paper's
contributions:

  fednest      — Tarzanagh et al. 2022: no variance reduction, no adaptivity;
                 the inner loop refreshes y several times per x step.
  fedbioacc    — Li et al. 2022a: STORM-VR local bilevel, no adaptive LR.
                 == AdaFBiO with adaptive="none".
  localbsgvrm  — Gao 2022: momentum-VR local bilevel, no adaptive LR, with a
                 single momentum on the hypergradient rather than full STORM.
  fedavg_sgd   — FedAvg on the bilevel estimators with no VR and no adaptivity.
  adafbio_na   — Theorem 2 ablation: AdaFBiO with A=I, B=I.

Each exposes the same client-batched (local_step, sync_update) contract as
:mod:`repro_torch.core.adafbio`, so the federated runtime is
algorithm-agnostic. ``k`` is always the step's per-client Neumann depths.
The clients' gradients map over the client axis as AdaFBiO's do
(:func:`repro_torch.core.adafbio.per_client`): under ``vmap``, or one
client at a time for a problem that asks for it (the LM problem's
``client_loop``), the same values either way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

from torch.func import grad

from repro_torch.configs.base import FedConfig
from repro_torch.core import adafbio
from repro_torch.core.bilevel import BilevelProblem
from repro_torch.core.hypergrad import hypergrad_fn
from repro_torch.core.tree_util import (tree_axpy, tree_match_dtypes,
                                        tree_sub, tree_update)


@dataclasses.dataclass(frozen=True)
class Algorithm:
    name: str
    fed: FedConfig
    local_step: Callable[..., Dict[str, Any]]     # (st, ad, b, k, t, m)
    sync_update: Callable[..., Tuple[Dict, Dict]]  # (server, avg, m)
    init_client_state: Callable[..., Dict[str, Any]]  # (xp, yp, b, k)
    init_server_state: Callable[..., Dict[str, Any]]  # (x_like)


def make_adafbio(fed: FedConfig, problem: BilevelProblem,
                 name: str = "adafbio") -> Algorithm:
    return Algorithm(
        name=name,
        fed=fed,
        local_step=lambda st, ad, b, k, t, m: adafbio.local_step(
            problem, fed, st, ad, b, k, t, m),
        sync_update=lambda srv, avg, m: adafbio.sync_update(fed, srv, avg, m),
        init_client_state=lambda xp, yp, b, k: adafbio.init_client_state(
            problem, fed, xp, yp, b, k),
        init_server_state=lambda x_like: adafbio.init_server_state(x_like, fed),
    )


def make_adafbio_nonadaptive(fed: FedConfig,
                             problem: BilevelProblem) -> Algorithm:
    fed_na = dataclasses.replace(fed, adaptive="none")
    return make_adafbio(fed_na, problem, name="adafbio_na")


def make_fedavg_sgd(fed: FedConfig, problem: BilevelProblem) -> Algorithm:
    """No VR: v, w are fresh stochastic (hyper)gradients each step (α=β=1)."""
    fed_sgd = dataclasses.replace(fed, adaptive="none",
                                  alpha_c1=1e9, beta_c2=1e9)  # clip -> 1
    return make_adafbio(fed_sgd, problem, name="fedavg_sgd")


def _init_client(problem, fed_b):
    return lambda xp, yp, b, k: adafbio.init_client_state(problem, fed_b, xp,
                                                          yp, b, k)


def _client_fns(fed: FedConfig, problem: BilevelProblem):
    """The hypergradient and the LL gradient in y, each mapped over the
    client axis as AdaFBiO maps them. The LL gradient is
    ``grad(problem.g)`` over the whole LL batch, as the reference's
    baselines take ``jax.grad(problem.g)``, not the problem's microbatched
    ``grad_g_y``: at LM width its backward holds the activations of every
    sequence of the batch at once (8 at the launcher's shape) where
    AdaFBiO's holds one microbatch's."""
    loop = problem.client_loop
    return (adafbio.per_client(hypergrad_fn(problem, fed.neumann_k,
                                            fed.theta), loop),
            adafbio.per_client(grad(problem.g, argnums=1), loop))


def make_fednest(fed: FedConfig, problem: BilevelProblem,
                 inner_steps: int = 2) -> Algorithm:
    """FedNest-style: per local step, ``inner_steps`` plain SGD updates on y,
    then one SGD hypergradient step on x. No VR, no adaptivity."""
    fed_b = dataclasses.replace(fed, adaptive="none")
    hg, gy_fn = _client_fns(fed, problem)

    def local_step(states, adaptive_state, batches, k, t, m):
        del adaptive_state
        eta = adafbio.eta_t(fed_b, t, m)
        x, y = states["x"], states["y"]
        for _ in range(inner_steps):
            gy = gy_fn(x, y, batches.get("g", batches["g0"]))
            y = tree_update(y, gy, fed_b.lr_y * eta)
        w = hg(x, y, batches, k)
        x = tree_update(x, w, fed_b.lr_x * eta)
        return {"x": x, "y": y, "v": states["v"], "w": w}

    def sync_update(server, avg_state, m):
        new_client = {"x": avg_state["x"], "y": avg_state["y"],
                      "v": avg_state["v"], "w": avg_state["w"]}
        return new_client, {"adaptive": server["adaptive"],
                            "t": server["t"] + 1}

    return Algorithm("fednest", fed_b, local_step, sync_update,
                     _init_client(problem, fed_b),
                     lambda x_like: adafbio.init_server_state(x_like, fed_b))


def make_localbsgvrm(fed: FedConfig, problem: BilevelProblem,
                     momentum: float = 0.5) -> Algorithm:
    """Gao-2022-style: heavy-ball momentum-VR on the hypergradient, plain SGD
    on the LL, local steps + averaging; no adaptivity."""
    fed_b = dataclasses.replace(fed, adaptive="none")
    hg, gy_fn = _client_fns(fed, problem)

    def local_step(states, adaptive_state, batches, k, t, m):
        del adaptive_state
        eta = adafbio.eta_t(fed_b, t, m)
        gy = gy_fn(states["x"], states["y"], batches.get("g", batches["g0"]))
        w_hat = hg(states["x"], states["y"], batches, k)
        w = tree_axpy(momentum, tree_sub(states["w"], w_hat), w_hat)
        w = tree_match_dtypes(w, states["w"])
        y = tree_update(states["y"], gy, fed_b.lr_y * eta)
        x = tree_update(states["x"], w, fed_b.lr_x * eta)
        return {"x": x, "y": y, "v": tree_match_dtypes(gy, states["v"]),
                "w": w}

    def sync_update(server, avg_state, m):
        return dict(avg_state), {"adaptive": server["adaptive"],
                                 "t": server["t"] + 1}

    return Algorithm("localbsgvrm", fed_b, local_step, sync_update,
                     _init_client(problem, fed_b),
                     lambda x_like: adafbio.init_server_state(x_like, fed_b))


def make_algorithm(name: str, fed: FedConfig,
                   problem: BilevelProblem) -> Algorithm:
    if name == "adafbio":
        return make_adafbio(fed, problem)
    if name in ("adafbio_na", "fedbioacc"):
        alg = make_adafbio_nonadaptive(fed, problem)
        return dataclasses.replace(alg, name=name)
    if name == "fednest":
        return make_fednest(fed, problem)
    if name == "localbsgvrm":
        return make_localbsgvrm(fed, problem)
    if name == "fedavg_sgd":
        return make_fedavg_sgd(fed, problem)
    raise KeyError(name)


ALGORITHMS = ("adafbio", "adafbio_na", "fedbioacc", "fednest", "localbsgvrm",
              "fedavg_sgd")
