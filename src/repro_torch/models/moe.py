"""Mixture-of-Experts layer (``src/repro/models/moe.py``): top-k
token-choice routing with a capacity-based scatter dispatch, each batch row
its own dispatch group, and an optional shared FFN beside the experts.

The reference's semantics, point by point:

- Routing: the router logits in the model dtype, then f32; the top k
  experts by logit with ties going to the lower expert index, as
  ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order among
  equal values, and bf16 logits over many experts tie often), so the
  experts are taken from a stable descending sort; the gates a softmax
  over the k chosen logits, in the model dtype.
- Slots: the (token, choice) pairs of a row in flat order (token-major,
  by choice within a token) take the slot ``cumsum(one_hot(expert)) - 1``:
  a token's priority is its position, not its gate. A row's capacity is
  ``max(int(S k capacity_factor / E), 4)``; a pair at or past it is
  dropped (its slot clamped to ``C - 1``, adding zero on dispatch and on
  combine).
- Dispatch and combine: the scatter-add into ``[E, C, d]``, the gated SiLU
  expert FFN (the down product in the model dtype), the gather of each
  token's k slots times gate and keep, summed over k.

The reference vmaps the group over the batch rows; here the rows are
batched by offsetting their indices into one ``[B E C, d]`` buffer (one
``index_add`` in, one gather out), and the expert products run over every
row's slots at once, ``[E, B C, d]`` against ``[E, d, f]``. The layer runs
under ``torch.func.grad``, ``vjp`` and ``vmap`` and inside
``models/remat.py``'s Function, so it closes over no tensor and builds its
offsets itself.

The products are plain ``torch`` operations: the reference computes them
outside any Pallas kernel, so the port has no kernel here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamSpec


def moe_specs(cfg: ArchConfig, n_layers: int) -> Dict[str, ParamSpec]:
    e = cfg.moe
    d = cfg.d_model
    L = n_layers
    specs = {
        "router": ParamSpec((L, d, e.n_experts), ("layers", "embed", None)),
        "we_gate": ParamSpec((L, e.n_experts, d, e.d_ff_expert),
                             ("layers", "experts", "embed", "expert_mlp")),
        "we_up": ParamSpec((L, e.n_experts, d, e.d_ff_expert),
                           ("layers", "experts", "embed", "expert_mlp")),
        "we_down": ParamSpec((L, e.n_experts, e.d_ff_expert, d),
                             ("layers", "experts", "expert_mlp", "embed")),
    }
    if e.d_ff_shared:
        specs.update({
            "ws_gate": ParamSpec((L, d, e.d_ff_shared),
                                 ("layers", "embed", "mlp")),
            "ws_up": ParamSpec((L, d, e.d_ff_shared),
                               ("layers", "embed", "mlp")),
            "ws_down": ParamSpec((L, e.d_ff_shared, d),
                                 ("layers", "mlp", "embed")),
        })
    return specs


def capacity(cfg: ArchConfig, seq: int) -> int:
    """Slots an expert holds in one dispatch group (a batch row of ``seq``
    tokens)."""
    e = cfg.moe
    return max(int(seq * e.top_k * e.capacity_factor / e.n_experts), 4)


def route(cfg: ArchConfig, router: torch.Tensor, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [..., n, d] -> (f32 logits [..., n, E], gates [..., n, k] in
    x's dtype, expert ids [..., n, k]): the top k logits, ties to the lower
    expert index."""
    logits = (x @ router).float()
    top, eids = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gates = torch.softmax(top[..., :k], dim=-1).to(x.dtype)
    return logits, gates, eids[..., :k]


def slots(eids: torch.Tensor, n_experts: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """eids [B, n, k] -> (slot, keep), each [B, n k]: a pair's place in
    its expert's queue in flat order, clamped to ``cap - 1``, and whether
    it is below ``cap``."""
    flat = eids.flatten(-2)                                    # [B, n k]
    experts = torch.arange(n_experts, device=eids.device)
    onehot = (flat[..., None] == experts).to(torch.int32)     # [B, n k, E]
    pos = torch.cumsum(onehot, dim=-2) - 1
    slot = torch.gather(pos, -1, flat[..., None])[..., 0]
    return torch.clamp(slot, max=cap - 1), slot < cap


def apply_moe(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]; ``p`` holds one layer's params. Each batch
    row is its own dispatch group of S tokens."""
    e = cfg.moe
    b, s, d = x.shape
    E, k = e.n_experts, e.top_k
    cap = capacity(cfg, s)
    _, gates, eids = route(cfg, p["router"], x)
    slot, keep = slots(eids, E, cap)
    keep_x = keep.to(x.dtype)[..., None]                       # [B, n k, 1]
    rows = torch.arange(b, device=x.device)[:, None]
    index = ((rows * E + eids.flatten(-2)) * cap + slot).flatten()
    src = torch.repeat_interleave(x, k, dim=1) * keep_x        # [B, n k, d]
    buf = x.new_zeros((b * E * cap, d)).index_add(0, index,
                                                  src.reshape(-1, d))
    # [B, E, C, d] -> [E, B C, d]: every row's slots of an expert in one
    # product against its [d, f] weights
    h = buf.reshape(b, E, cap, d).transpose(0, 1).reshape(E, b * cap, d)
    act = F.silu(torch.bmm(h, p["we_gate"])) * torch.bmm(h, p["we_up"])
    out = torch.bmm(act, p["we_down"]).to(x.dtype)             # [E, B C, d]
    out = out.reshape(E, b, cap, d).transpose(0, 1).reshape(-1, d)
    gathered = out[index].reshape(b, s * k, d)
    gathered = gathered * (gates.reshape(b, s * k, 1) * keep_x)
    y = gathered.reshape(b, s, k, d).sum(dim=2)
    if e.d_ff_shared:
        hs = F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])
        y = y + hs @ p["ws_down"]
    return y


def aux_load_balance_loss(logits: torch.Tensor, eids: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss over logits [n, E] and the
    chosen ids [n, k] (for monitoring; no training path calls it, as in
    the reference)."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=0)
    ce = torch.bincount(eids.reshape(-1), minlength=n_experts) / eids.numel()
    return n_experts * torch.sum(me * ce)
