"""Client population bank: N persistent client states, O(C) compute a round.

A ``ClientPopulation`` holds N client states as one client-stacked tree
(every leaf ``[N, ...]``) plus per-client bookkeeping (``last_sync``: the
round at which each client last received the server state). Each round a
``CohortSampler`` (:mod:`repro_torch.fed.sampling`) picks C ids, and the
round is gather → the q local steps on the C gathered states → scatter, so
compute scales with the cohort, not the population.

Sync modes (who receives the post-aggregation server state):

  broadcast     every client in the bank: the masked-participation
                semantics, inactive clients idle at the server state.
                Staleness is identically zero.
  participants  only the aggregating cohort. Clients carry stale models
                between participations, and ``staleness_weights`` can
                down-weight long-absent clients at aggregation time.

Only the synchronous rounds are ported; the asynchronous rounds, the
cohort-only round of the host-spill bank and ``scatter_where`` come with
the federated-runtime slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.tree_util import tree_bcast_axis0, tree_leaves, tree_map
from repro_torch.fed.topology import as_aggregator

SYNC_MODES = ("broadcast", "participants")


# ------------------------------------------------------------ bank primitives

def gather(bank_states, ids: torch.Tensor):
    """Select cohort rows: [N, ...] tree -> [C, ...] tree."""
    return tree_map(lambda a: a.index_select(0, ids), bank_states)


def resolve_last_wins(ids: torch.Tensor, values):
    """Rewrite duplicate-id cohort slots so every writer of a row carries
    the LAST slot's value, which makes a scatter order-independent. O(C^2)
    in the cohort size."""
    pos = torch.arange(ids.shape[0], device=ids.device)
    same = ids[:, None] == ids[None, :]
    winner = torch.where(same, pos[None, :], -1).amax(dim=1)
    return tree_map(lambda v: v.index_select(0, winner), values)


def scatter(bank_states, ids: torch.Tensor, values):
    """Write cohort rows back, out of place: bank[ids] = values; a later
    duplicate id wins (:func:`resolve_last_wins`)."""
    values = resolve_last_wins(ids, values)
    return tree_map(lambda a, v: a.index_copy(0, ids, v.to(a.dtype)),
                    bank_states, values)


def broadcast(bank_states, value):
    """Every bank row set to one (unbatched) client state."""
    n = tree_leaves(bank_states)[0].shape[0]
    return tree_map(lambda a, v: v.to(a.dtype), bank_states,
                    tree_bcast_axis0(value, n))


def cohort_staleness_weights(last_sync_c: torch.Tensor, round_id,
                             decay: float) -> torch.Tensor:
    """:func:`staleness_weights` from the already-gathered cohort slice
    ``last_sync_c`` (int32 [C])."""
    stale = (round_id - last_sync_c).clamp_min(0).float()
    w = (1.0 + stale) ** (-decay)
    return w / w.sum().clamp_min(1e-12)


def staleness_weights(last_sync: torch.Tensor, ids: torch.Tensor, round_id,
                      decay: float) -> torch.Tensor:
    """Aggregation weights for a cohort, down-weighting stale members.

    Client i's staleness is ``round_id - last_sync[i]``, the rounds since it
    last pulled the server state. Weights are ``(1 + staleness)^-decay``,
    normalized over the cohort; ``decay = 0`` (or an all-fresh cohort)
    gives the plain uniform average.
    """
    return cohort_staleness_weights(last_sync.index_select(0, ids),
                                    round_id, decay)


# ------------------------------------------------------------ the population

@dataclasses.dataclass
class ClientPopulation:
    """N stacked client states + per-client sync bookkeeping (the async
    fields ``in_flight``/``dispatch_round`` come with the async slice)."""
    states: Any                  # tree, every leaf with leading axis N
    last_sync: torch.Tensor      # int32 [N]: round of last server-state pull
    n: int

    def gather(self, ids):
        return gather(self.states, ids)

    def scatter(self, ids, values):
        return dataclasses.replace(self, states=scatter(self.states, ids,
                                                        values))


# ------------------------------------------------------------ fused round

def make_population_round(local_step_ids: Callable, sync_update: Callable,
                          q: int, *, sync_mode: str = "broadcast",
                          staleness_decay: float = 0.0,
                          codec=None) -> Callable:
    """Build the gather → local steps → aggregate → scatter round.

    ``local_step_ids(states_c, server, batch, k, ids)`` is one local step of
    the COHORT (client-batched; ``k`` the cohort's [C] Neumann depths,
    ``ids`` the global client ids). ``sync_update(server, avg_state)`` maps
    the aggregated client state to ``(new_client_state, new_server)``, or
    pass a :class:`repro_torch.fed.topology.Aggregator`.

    Returns ``round_fn(bank_states, last_sync, server, ids, batches_q,
    draws_q, round_id) -> (bank_states, last_sync, server)``: q local steps
    on the C gathered states (``draws_q`` [q, C]), a (staleness-weighted)
    cohort aggregate, the server update, and the write-back that
    ``sync_mode`` dictates.

    With a lossy ``codec`` the cohort's messages pass through the codec
    before aggregation (the gathered pre-step state is the server-known
    reference) and the signature grows the stacked error-feedback bank and
    the int8 codec's noise: ``round_fn(bank_states, last_sync, ef_bank,
    server, ids, batches_q, draws_q, round_id, u) -> (bank_states,
    last_sync, ef_bank, server)`` (``ef_bank`` None when error feedback is
    off, ``u`` the [C, n] noise or None for topk).
    """
    if sync_mode not in SYNC_MODES:
        raise ValueError(f"sync_mode must be one of {SYNC_MODES}, "
                         f"got {sync_mode!r}")
    if q < 1:
        raise ValueError(f"round needs q >= 1 local steps, got {q}")
    agg = as_aggregator(sync_update, codec=codec)
    codec = agg.codec
    lossy = codec is not None and codec.lossy

    def run_steps(cur, server, ids, batches_q, draws_q):
        for j in range(q):
            cur, server = local_step_ids(
                cur, server, tree_map(lambda a: a[j], batches_q),
                draws_q[j], ids)
        return cur, server

    def write_back(bank_states, last_sync, new_client, ids, round_id):
        if sync_mode == "broadcast":
            return (broadcast(bank_states, new_client),
                    torch.full_like(last_sync, round_id + 1))
        c = ids.shape[0]
        return (scatter(bank_states, ids, tree_bcast_axis0(new_client, c)),
                last_sync.index_fill(0, ids, round_id + 1))

    def round_fn(bank_states, last_sync, server, ids, batches_q, draws_q,
                 round_id):
        cur = gather(bank_states, ids)
        cur, server = run_steps(cur, server, ids, batches_q, draws_q)
        w = staleness_weights(last_sync, ids, round_id, staleness_decay)
        new_client, server = agg.reduce(server, cur, weights=w)
        bank_states, last_sync = write_back(bank_states, last_sync,
                                            new_client, ids, round_id)
        return bank_states, last_sync, server

    if not lossy:
        return round_fn

    def round_fn_codec(bank_states, last_sync, ef_bank, server, ids,
                       batches_q, draws_q, round_id, u=None):
        ref = gather(bank_states, ids)   # server-known dispatch states
        cur, server = run_steps(ref, server, ids, batches_q, draws_q)
        ef_c = gather(ef_bank, ids) if ef_bank is not None else None
        recon, ef_c = agg.messages(ref, cur, ef_c, u)
        if ef_bank is not None:
            ef_bank = scatter(ef_bank, ids, ef_c)
        w = staleness_weights(last_sync, ids, round_id, staleness_decay)
        new_client, server = agg.reduce(server, recon, weights=w)
        bank_states, last_sync = write_back(bank_states, last_sync,
                                            new_client, ids, round_id)
        return bank_states, last_sync, ef_bank, server

    return round_fn_codec
