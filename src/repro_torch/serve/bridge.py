"""Checkpoint -> serve-params bridge (``src/repro/serve/bridge.py``).

A training checkpoint carries a whole training state (the client states or
a population bank, the server state, and mode-specific extras) in one of
several tuple layouts. Serving needs only the trained global model (x̄, ȳ).
This module builds candidate templates from the requested ``ArchConfig``
with the port's ``FederatedTrainer`` (the same structures the trainer
writes), matches the stored structure and shapes against them through
:func:`repro_torch.checkpoint.load_checkpoint` (which raises ``ValueError``
naming a mismatched leaf's path), and returns the client-mean ``{"x": x̄,
"y": ȳ}`` params the serve engine takes. Every sync engine broadcasts the
aggregate back to the bank each round, so the rows agree at checkpoint
time and the mean is the global model.

It reads checkpoints of either package, dense or ``--ckpt-shards K``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from repro_torch import device as devices
from repro_torch.checkpoint import load_checkpoint, treedef_str
from repro_torch.configs.base import ArchConfig, FedConfig, ShapeConfig
from repro_torch.core.tree_util import tree_leaves, tree_map
from repro_torch.models.params import TensorSpec

ADAPTIVE_VARIANTS = ("adam", "none", "adabelief")


def client_mean(bank):
    """The mean over the bank's leading axis as the reference's
    ``jnp.mean`` computes it: the f32 sum times the f32 1/n (XLA turns the
    division by a constant into that product; ``torch.mean`` divides, which
    rounds otherwise), cast back to the leaf's dtype. A one-row bank gives
    views of its row."""
    return tree_map(lambda a: a[0] if a.shape[0] == 1 else
                    (a.float().sum(dim=0) * (1.0 / a.shape[0])).to(a.dtype),
                    bank)


def candidate_templates(cfg: ArchConfig, n: int, codec: str,
                        codec_bits: int, topk_frac: float):
    """``(name, template)`` for every checkpoint layout the trainer writes
    at population or client count ``n``: plain, population and gossip,
    each also with the EF bank when ``codec`` is lossy, over the server's
    adaptive variants. The templates' leaves are ``TensorSpec``s."""
    from repro_torch.fed.runtime import FederatedTrainer
    shape = ShapeConfig("bridge", 8, 1, "train")
    out = []
    for adaptive in ADAPTIVE_VARIANTS:
        fed = FedConfig(adaptive=adaptive, codec=codec,
                        codec_bits=codec_bits, topk_frac=topk_frac,
                        error_feedback=codec != "none")
        tr = FederatedTrainer(cfg, fed, shape, device="cpu")
        bank = tr.abstract_population_states(n)
        server = tr.abstract_server_state()
        last_sync = TensorSpec((n,), torch.int32)
        ef = (tree_map(lambda s: TensorSpec(s.shape, torch.float32), bank)
              if tr.codec.stateful else None)
        tag = f"adaptive={adaptive}"
        out.append((f"population[{tag}]", (bank, last_sync, server)))
        srv_bank = tree_map(lambda s: TensorSpec((n,) + s.shape, s.dtype),
                            server)
        out.append((f"gossip[{tag}]", (bank, srv_bank)))
        out.append((f"plain[{tag}]", (bank, server)))
        if ef is not None:
            out.append((f"population+ef[{tag}]", (bank, last_sync, ef,
                                                  server)))
            out.append((f"gossip+ef[{tag}]", (bank, srv_bank, ef)))
            out.append((f"plain+ef[{tag}]", (bank, server, ef)))
    return out


def load_serve_params(path, cfg: ArchConfig, *, codec: str = "none",
                      codec_bits: int = 8, topk_frac: float = 0.05,
                      device="cuda") -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a training checkpoint and extract the serve params.

    Returns ``(params, info)``: ``params = {"x": x̄, "y": ȳ}`` on ``device``
    in ``model_specs(cfg)``'s layout and dtypes, ``info`` the matched
    layout, the client count and the training step. A checkpoint whose leaf
    shapes do not fit ``cfg`` raises ``ValueError`` naming the leaf's path;
    one whose structure matches no known layout raises ``ValueError``
    listing the layouts tried. ``codec`` names the training run's codec for
    lossy (EF-bank) checkpoints. ``device`` defaults to the card; a CUDA
    device without a card raises, and ``device="cpu"`` loads on the host.
    """
    device = devices.resolve(device)
    meta_path = Path(str(path) + ".json")
    if not meta_path.is_file():
        raise ValueError(f"checkpoint {path}: no {meta_path.name} sidecar "
                         f"(is this a training checkpoint?)")
    meta = json.loads(meta_path.read_text())
    leaf0 = meta.get("shapes", {}).get("leaf_0")
    if not leaf0:
        raise ValueError(f"checkpoint {path}: sidecar records no leaf "
                         f"shapes, so the client count is unknown")
    # every layout leads with the client bank; its first leaf's leading
    # axis is the population or client count
    n = int(leaf0[0])
    treedef = meta.get("treedef")
    candidates = candidate_templates(cfg, n, codec, codec_bits, topk_frac)
    errors = []
    # first pass: the exact structure (plain and gossip differ only in leaf
    # shapes, so the loader's shape checks pick between them); second pass:
    # the leaf count, so a different arch surfaces the loader's leaf-path
    # ValueError instead of a generic miss
    passes = ([(name, t) for name, t in candidates
               if treedef is None or treedef_str(t) == treedef],
              [(name, t) for name, t in candidates
               if len(tree_leaves(t)) == meta.get("n_leaves")])
    for cands in passes:
        for name, tmpl in cands:
            try:
                state, step = load_checkpoint(path, tmpl, device=device)
            except ValueError as e:
                errors.append((name, e))
                continue
            avg = client_mean(state[0])
            params = {"x": avg["x"], "y": avg["y"]}
            return params, {"layout": name, "clients": n, "step": step}
        if errors:
            # a candidate's structure fit but a leaf did not: the loader's
            # leaf-path ValueError (an arch mismatch)
            raise errors[0][1]
    raise ValueError(
        f"checkpoint {path}: structure matches no known training layout "
        f"(tried {', '.join(name for name, _ in candidates)}); async-engine "
        f"checkpoints are not servable: rerun training with a sync engine, "
        f"or pass the matching --codec for EF-bank layouts")
