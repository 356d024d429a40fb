"""Federated hyper-representation learning (paper Problem (3) / Section 6.1).

x: shared representation MLP (in -> hidden -> rep); y: per-client linear
heads, stacked [M, rep, classes] (the paper's y = (y^1;...;y^M), each g^m
touching only block m + the strongly convex regularizer).

The data is synthetic, non-iid classification (a client-specific rotation
of class prototypes plus noise), drawn on the requested device from
``torch.Generator``s seeded by (seed, client, step): one draw per call
gives all of a step's splits, the same call gives the same batch on every
run, and no dataset is downloaded.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch import device as devices
from repro_torch.configs.paper_tasks import HyperRepConfig
from repro_torch.core.bilevel import BilevelProblem, softmax_xent
from repro_torch.core.tree_util import tree_sqnorm

# batch splits of one (client, step): the LL batch, the ζ₀ batch, the UL
# batch, then the K Neumann batches; validation draws at its own step
_G, _G0, _F, _GI = 0, 1, 2, 3
_VAL_STEP, _VAL_N = 999_999, 256


def build_hyperrep(cfg: HyperRepConfig, device="cuda", seed: int = 0):
    dev = devices.resolve(device)

    def generator(*parts) -> torch.Generator:
        return devices.generator(dev, seed, *parts)

    protos = torch.randn(cfg.n_classes, cfg.in_dim, generator=generator(42),
                         device=dev)
    rots: Dict[int, torch.Tensor] = {}

    def rotation(client: int) -> torch.Tensor:
        if client not in rots:
            noise = torch.randn(cfg.in_dim, cfg.in_dim,
                                generator=generator(5, client), device=dev)
            rots[client] = (torch.eye(cfg.in_dim, device=dev)
                            + 0.2 * noise / math.sqrt(cfg.in_dim))
        return rots[client]

    def client_sample(client: int, step: int, splits: int, n: int):
        """``splits`` samples of ``n`` examples for (client, step), drawn
        together: features [splits, n, in_dim] f32, labels [splits, n]."""
        g = generator(7, client, step, splits)
        labels = torch.randint(0, cfg.n_classes, (splits, n), generator=g,
                               device=dev)
        noise = torch.randn(splits, n, cfg.in_dim, generator=g, device=dev)
        feats = protos[labels] @ rotation(client) + 0.3 * noise
        return feats, labels

    def rep(xp, a):
        h = torch.tanh(a @ xp["w1"] + xp["b1"])
        return torch.tanh(h @ xp["w2"] + xp["b2"])

    def _loss(xp, yp, batch):
        m = batch["client"].reshape(1).to(torch.int64)
        head = torch.index_select(yp["heads"], 0, m)[0]
        return softmax_xent(rep(xp, batch["a"]) @ head, batch["b"])

    def g(xp, yp, batch):
        return _loss(xp, yp, batch) + 0.5 * cfg.fed.nu * tree_sqnorm(yp)

    def f(xp, yp, batch):
        return _loss(xp, yp, batch)

    problem = BilevelProblem(f=f, g=g)

    def init_xy(gen: torch.Generator):
        s1 = 1.0 / math.sqrt(cfg.in_dim)
        s2 = 1.0 / math.sqrt(cfg.hidden)
        xp = {"w1": s1 * torch.randn(cfg.in_dim, cfg.hidden, generator=gen,
                                     device=dev),
              "b1": torch.zeros(cfg.hidden, device=dev),
              "w2": s2 * torch.randn(cfg.hidden, cfg.rep_dim, generator=gen,
                                     device=dev),
              "b2": torch.zeros(cfg.rep_dim, device=dev)}
        yp = {"heads": torch.zeros(cfg.n_clients, cfg.rep_dim,
                                   cfg.n_classes, device=dev)}
        return xp, yp

    def batch_fn(client: int, step: int) -> Dict:
        K = cfg.fed.neumann_k
        a, b = client_sample(client, step, _GI + K, cfg.batch)
        cid = torch.full((), client, dtype=torch.int32, device=dev)

        def mk(i):
            return {"client": cid, "a": a[i], "b": b[i]}

        return {"g": mk(_G), "g0": mk(_G0), "f": mk(_F),
                "gi": {"client": cid.expand(K), "a": a[_GI:], "b": b[_GI:]}}

    def val_loss(xp, yp):
        losses = []
        for m in range(cfg.n_clients):
            a, b = client_sample(m, _VAL_STEP, 1, _VAL_N)
            losses.append(softmax_xent(rep(xp, a[0]) @ yp["heads"][m], b[0]))
        return torch.stack(losses).mean()

    return dict(problem=problem, init_xy=init_xy, batch_fn=batch_fn,
                val_loss=val_loss, cfg=cfg)
