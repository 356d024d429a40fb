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

Asynchronous rounds (:func:`make_async_round`) drop the synchronized-round
assumption: a dispatched client takes ``delay`` rounds to return its update
(``in_flight``/``dispatch_round`` bookkeeping and a pending-update buffer
holding the computed update until it arrives), cohorts overlap (a client
sampled while still in flight keeps flying), the server drops arrivals
older than ``max_staleness`` rounds and can scale its step by the observed
staleness (delay-adaptive eta_t). With every delay one round, no gating and
no delay adaptation, the async rounds reproduce the synchronous
``make_population_round`` trajectories.

The delays come from a :class:`DelayModel` (uniform, tiers, lognormal or a
recorded trace), whose random draws are an input: a :class:`DelayDraws`
source of torch generators seeded by (seed, salt, round), on the reference's
salts (0x0DE1A7 uniform, 0x71E5A tier assignment, 0x71D0D tier draws,
0x10C4A lognormal). The parity tests hand in the reference's draws.

For banks the card cannot hold, :func:`make_cohort_round` is the round's
cohort-only core: the caller gathers the C rows and writes them back
(:class:`repro_torch.fed.spill.HostSpillBank` keeps the N rows in host
memory). Both builders run the same steps and aggregate
(:func:`_round_pieces`).

The mega-scan tier runs R rounds as one call:
:func:`make_multi_population_round` and :func:`make_multi_async_round`
(:func:`repro_torch.fed.round.make_multi_round`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import device as devices
from repro_torch.configs.base import DELAY_MODELS, validate_delay_model
from repro_torch.core.tree_util import (take, tree_bcast_axis0, tree_leaves,
                                        tree_map)
from repro_torch.fed.round import make_multi_round
from repro_torch.fed.topology import as_aggregator, weighted_mean

SYNC_MODES = ("broadcast", "participants")

# return_round of a client with no update in flight
NEVER = torch.iinfo(torch.int32).max


# ------------------------------------------------------------ bank primitives

def gather(bank_states, ids: torch.Tensor):
    """Select cohort rows: [N, ...] tree -> [C, ...] tree."""
    return tree_map(lambda a: a.index_select(0, ids), bank_states)


def _winners(ids: torch.Tensor, keep: Optional[torch.Tensor] = None):
    """For each cohort slot, the last slot with the same id (and ``keep``,
    when a keep mask is given), and whether there is one."""
    pos = torch.arange(ids.shape[0], device=ids.device)
    same = ids[:, None] == ids[None, :]
    if keep is not None:
        same = same & keep[None, :]
    winner = torch.where(same, pos[None, :], -1).amax(dim=1)
    return winner.clamp_min(0), winner >= 0


def resolve_last_wins(ids: torch.Tensor, values):
    """Rewrite duplicate-id cohort slots so every writer of a row carries
    the LAST slot's value, which makes a scatter order-independent. O(C^2)
    in the cohort size."""
    src, _ = _winners(ids)
    return tree_map(lambda v: v.index_select(0, src), values)


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
    """N stacked client states + per-client sync/flight bookkeeping.

    ``in_flight``/``dispatch_round`` are the async fields: client i with
    ``in_flight[i]`` is computing an update it dispatched at round
    ``dispatch_round[i]`` and cannot start new work until it arrives
    (:func:`make_async_round`). The synchronous path never sets them."""
    states: Any                  # tree, every leaf with leading axis N
    last_sync: torch.Tensor      # int32 [N]: round of last server-state pull
    n: int
    in_flight: Optional[torch.Tensor] = None        # bool  [N]
    dispatch_round: Optional[torch.Tensor] = None   # int32 [N]

    def __post_init__(self):
        device = self.last_sync.device
        if self.in_flight is None:
            self.in_flight = torch.zeros(self.n, dtype=torch.bool,
                                         device=device)
        if self.dispatch_round is None:
            self.dispatch_round = torch.zeros(self.n, dtype=torch.int32,
                                              device=device)

    def gather(self, ids):
        return gather(self.states, ids)

    def scatter(self, ids, values):
        return dataclasses.replace(self, states=scatter(self.states, ids,
                                                        values))


# ------------------------------------------------------------ fused round

def _round_pieces(local_step_ids: Callable, sync_update: Callable, q: int,
                  staleness_decay: float, codec):
    """What the dense and the cohort-only rounds share: ``(steps,
    aggregate, agg, lossy)``. ``steps(cur, server, ids, batches_q,
    draws_q)`` runs the q local steps of the gathered cohort (the gathered
    rows go after step 0); ``aggregate(server, msgs, last_sync_c,
    round_id)`` is the staleness-weighted cohort aggregate and the server
    step."""
    if q < 1:
        raise ValueError(f"round needs q >= 1 local steps, got {q}")
    agg = as_aggregator(sync_update, codec=codec)
    lossy = agg.codec is not None and agg.codec.lossy

    def steps(cur, server, ids, batches_q, draws_q):
        # record_function: a named region in a profiler trace (the
        # reference's named_scope), no value changes
        with record_function("round/local_scan"):
            for j in range(q):
                cur, server = local_step_ids(
                    cur, server, tree_map(lambda a: a[j], batches_q),
                    draws_q[j], ids)
        return cur, server

    def aggregate(server, msgs, last_sync_c, round_id):
        with record_function("round/aggregate"):
            w = cohort_staleness_weights(last_sync_c, round_id,
                                         staleness_decay)
            return agg.reduce(server, msgs, weights=w)

    return steps, aggregate, agg, lossy


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
    ``sync_mode`` dictates. The round takes the entries out of the
    ``bank_states`` (and ``ef_bank``) dicts it is given, as JAX donates
    buffers: each old tensor is freed as the round replaces it, which at
    language-model width is the difference between fitting the card and
    not. A caller that keeps them passes shallow copies.

    With a lossy ``codec`` the cohort's messages pass through the codec
    before aggregation (the gathered pre-step state is the server-known
    reference) and the signature grows the stacked error-feedback bank and
    the int8 codec's noise: ``round_fn(bank_states, last_sync, ef_bank,
    server, ids, batches_q, draws_q, round_id, u) -> (bank_states,
    last_sync, ef_bank, server)`` (``ef_bank`` None when error feedback is
    off, ``u`` the int8 codec's noise source ``(leaf, size) -> [C, size]``
    or None for topk).
    """
    if sync_mode not in SYNC_MODES:
        raise ValueError(f"sync_mode must be one of {SYNC_MODES}, "
                         f"got {sync_mode!r}")
    steps, aggregate, agg, lossy = _round_pieces(
        local_step_ids, sync_update, q, staleness_decay, codec)

    def write_back(bank_states, last_sync, new_client, ids, round_id):
        with record_function("round/scatter"):
            if sync_mode == "broadcast":
                return (broadcast(bank_states, new_client),
                        torch.full_like(last_sync, round_id + 1))
            c = ids.shape[0]
            return (scatter(bank_states, ids,
                            tree_bcast_axis0(new_client, c)),
                    last_sync.index_fill(0, ids, round_id + 1))

    def round_fn(bank_states, last_sync, server, ids, batches_q, draws_q,
                 round_id):
        bank_states = take(bank_states)
        with record_function("round/gather"):
            cur = gather(bank_states, ids)
        cur, server = steps(cur, server, ids, batches_q, draws_q)
        new_client, server = aggregate(server, cur,
                                       last_sync.index_select(0, ids),
                                       round_id)
        bank_states, last_sync = write_back(bank_states, last_sync,
                                            new_client, ids, round_id)
        return bank_states, last_sync, server

    if not lossy:
        return round_fn

    def round_fn_codec(bank_states, last_sync, ef_bank, server, ids,
                       batches_q, draws_q, round_id, u=None):
        bank_states, ef_bank = take(bank_states), take(ef_bank)
        with record_function("round/gather"):
            ref = gather(bank_states, ids)  # server-known dispatch states
        cur, server = steps(ref, server, ids, batches_q, draws_q)
        with record_function("round/codec"):
            ef_c = gather(ef_bank, ids) if ef_bank is not None else None
            recon, ef_c = agg.messages(ref, cur, ef_c, u)
            del ref, cur
            if ef_bank is not None:
                ef_bank = scatter(ef_bank, ids, ef_c)
        new_client, server = aggregate(server, recon,
                                       last_sync.index_select(0, ids),
                                       round_id)
        bank_states, last_sync = write_back(bank_states, last_sync,
                                            new_client, ids, round_id)
        return bank_states, last_sync, ef_bank, server

    return round_fn_codec


def make_cohort_round(local_step_ids: Callable, sync_update: Callable,
                      q: int, *, staleness_decay: float = 0.0,
                      codec=None) -> Callable:
    """The cohort-only core of :func:`make_population_round`, for banks the
    card cannot hold: gather and write-back are the CALLER's
    (:class:`repro_torch.fed.spill.HostSpillBank` keeps the [N, ...] rows
    in host memory), the round sees only the [C, ...] cohort.

    ``round_fn(cur, last_sync_c, server, ids, batches_q, draws_q, round_id)
    -> (new_client, server)``, ``cur`` the gathered cohort states and
    ``last_sync_c`` the gathered int32 [C] slice of the sync bookkeeping.
    The q local steps, the staleness-weighted aggregate and the server step
    are :func:`make_population_round`'s own, so a spilled run replays the
    dense broadcast-mode trajectory (the caller's write-back: every row :=
    ``new_client``, ``last_sync = round_id + 1``). The round takes the
    entries out of the ``cur`` (and ``ef_c``) dicts, as the dense round
    takes them out of the bank, so the gathered rows are freed as the steps
    replace them. With a lossy ``codec`` the signature grows the gathered EF
    residual slice and the int8 codec's noise: ``round_fn(cur,
    last_sync_c, ef_c, server, ids, batches_q, draws_q, round_id, u) ->
    (new_client, ef_c, server)``; the caller scatters ``ef_c`` back into
    its EF bank."""
    steps, aggregate, agg, lossy = _round_pieces(
        local_step_ids, sync_update, q, staleness_decay, codec)

    def round_fn(cur, last_sync_c, server, ids, batches_q, draws_q,
                 round_id):
        cur, server = steps(take(cur), server, ids, batches_q, draws_q)
        return aggregate(server, cur, last_sync_c, round_id)

    if not lossy:
        return round_fn

    def round_fn_codec(cur, last_sync_c, ef_c, server, ids, batches_q,
                       draws_q, round_id, u=None):
        ref = take(cur)                     # server-known dispatch states
        cur, server = steps(ref, server, ids, batches_q, draws_q)
        with record_function("round/codec"):
            recon, ef_c = agg.messages(ref, cur, take(ef_c), u)
        del ref, cur
        new_client, server = aggregate(server, recon, last_sync_c, round_id)
        return new_client, ef_c, server

    return round_fn_codec


# ------------------------------------------------------------ async execution

def scatter_where(bank_states, ids: torch.Tensor, values, keep: torch.Tensor):
    """Masked cohort write-back, out of place: ``bank[ids[j]] = values[j]``
    where ``keep[j]``; a row none of whose slots are kept stays untouched.
    The last kept duplicate wins (every slot writing a row carries its
    value, so the write order cannot matter)."""
    src, wins = _winners(ids, keep)

    def upd(a, v):
        v = v.index_select(0, src).to(a.dtype)
        m = wins.reshape((wins.shape[0],) + (1,) * (v.dim() - 1))
        return a.index_copy(0, ids, torch.where(m, v, a.index_select(0, ids)))
    return tree_map(upd, bank_states, values)


def _rows_where(bank_states, mask: torch.Tensor, value):
    """Overwrite the bank rows selected by ``mask`` ([N] bool) with one
    unbatched client state."""
    def upd(a, v):
        m = mask.reshape((mask.shape[0],) + (1,) * (a.dim() - 1))
        return torch.where(m, v.unsqueeze(0).to(a.dtype), a)
    return tree_map(upd, bank_states, value)


def _tree_where(pred: torch.Tensor, a, b):
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


# salts of the delay draws, the reference's, apart from every other stream
_DELAY_SALT = 0x0DE1A7
_TIER_ASSIGN_SALT = 0x71E5A
_TIER_DRAW_SALT = 0x71D0D
_LOGNORMAL_SALT = 0x10C4A


@dataclasses.dataclass(frozen=True)
class DelayDraws:
    """The random draws of the delay models, on ``device``, each from a
    ``torch.Generator`` seeded by (seed, salt[, round]): the port's draw
    source. The parity tests replace it with one that returns the
    reference's draws (same methods)."""
    seed: int = 0
    device: Any = "cpu"

    def _gen(self, *parts) -> torch.Generator:
        return devices.generator(self.device, self.seed, *parts)

    def randint(self, salt: int, round_id: int, n: int, low: int,
                high: int) -> torch.Tensor:
        """int32 [n] uniform on [low, high)."""
        return torch.randint(low, high, (n,), generator=self._gen(
            salt, round_id), device=self.device).to(torch.int32)

    def uniform(self, salt: int, round_id: int, n: int) -> torch.Tensor:
        """f32 [n] uniform on [0, 1)."""
        return torch.rand((n,), generator=self._gen(salt, round_id),
                          device=self.device)

    def normal(self, salt: int, n: int) -> torch.Tensor:
        """f32 [n] standard normal."""
        return torch.randn((n,), generator=self._gen(salt),
                           device=self.device)

    def permutation(self, salt: int, n: int) -> torch.Tensor:
        """int64 [n] permutation of range(n)."""
        return torch.randperm(n, generator=self._gen(salt),
                              device=self.device)


def delay_schedule(draws, round_id: int, n: int,
                   max_delay: int) -> torch.Tensor:
    """Per-(client, round) return delays, uniform over [1, max_delay]
    rounds, int32 [n] on ``draws.device``."""
    if max_delay == 1:
        return torch.ones(n, dtype=torch.int32, device=draws.device)
    return draws.randint(_DELAY_SALT, round_id, n, 1, max_delay + 1)


def _tier_sizes(n: int, fracs: Tuple[float, ...]) -> Tuple[int, ...]:
    """Largest-remainder rounding of ``fracs * n`` (sums to exactly n)."""
    raw = [f * n for f in fracs]
    sizes = [int(x) for x in raw]
    order = sorted(range(len(fracs)), key=lambda i: raw[i] - sizes[i],
                   reverse=True)
    for j in range(n - sum(sizes)):
        sizes[order[j % len(sizes)]] += 1
    return tuple(sizes)


def tier_assignment(draws, n: int, fracs: Tuple[float, ...]) -> torch.Tensor:
    """Permanent speed tier of each client, int32 [n]: tier sizes are the
    largest-remainder rounding of ``fracs * n``; which clients land in which
    tier is a permutation from ``draws``."""
    bounds = torch.cumsum(torch.tensor(_tier_sizes(n, fracs)), 0)
    slot_tier = torch.searchsorted(bounds, torch.arange(n), right=True)
    perm = draws.permutation(_TIER_ASSIGN_SALT, n).cpu()
    out = torch.zeros(n, dtype=torch.int32)
    out[perm] = slot_tier.to(torch.int32)
    return out.to(draws.device)


@dataclasses.dataclass(frozen=True)
class DelayModel:
    """Per-client dispatch-return delay model (device speeds).

    ``schedule(draws, round_id, n)`` gives the int32 [n] return delays (in
    rounds) of a dispatch at ``round_id``. Models:

      uniform    delay ~ U[1, max_delay] per (client, round).
      tiers      each client is permanently in a speed tier
                 (:func:`tier_assignment` over ``tier_fracs``) and draws its
                 delay uniformly from its tier's ``(lo, hi)`` each round.
      lognormal  a permanent per-client latency ``exp(mu + sigma z_i)``,
                 ``z_i ~ N(0, 1)``, rounded up to rounds and clipped to
                 [1, max_delay].
      trace      delays replayed from a recorded [horizon, n] table
                 (``table[round % horizon, client]``;
                 :func:`repro_torch.fed.sampling.load_delay_trace`).

    Build one with :func:`make_delay_model`, which validates.
    """
    name: str = "uniform"
    max_delay: int = 1
    tier_fracs: Tuple[float, ...] = (0.2, 0.6, 0.2)
    tier_delays: Tuple[Tuple[int, int], ...] = ((1, 1), (2, 4), (4, 8))
    mu: float = 0.0
    sigma: float = 0.5
    table: Optional[Any] = None          # np [horizon, n] int32 (trace)
    # resolve() caches of the permanent per-client quantities
    client_lo: Optional[Any] = None      # tiers: per-client delay lo bound
    client_hi: Optional[Any] = None      # tiers: per-client delay hi bound
    client_delay: Optional[Any] = None   # lognormal: the delay vector

    @property
    def bound(self) -> int:
        """The largest delay this model can emit."""
        if self.name == "tiers":
            return max(hi for _, hi in self.tier_delays)
        if self.name == "trace":
            return int(self.table.max())
        return self.max_delay

    def tiers(self, draws, n: int) -> torch.Tensor:
        """The permanent tier of each client (tiers model)."""
        return tier_assignment(draws, n, self.tier_fracs)

    def resolve(self, draws, n: int) -> "DelayModel":
        """Compute the permanent per-client quantities once (the tiers
        model's [lo, hi] ranges, the lognormal model's delays); the draws
        are the same as without it."""
        if self.name == "tiers":
            lo, hi = self._tier_ranges(draws, n)
            return dataclasses.replace(self, client_lo=lo, client_hi=hi)
        if self.name == "lognormal":
            return dataclasses.replace(
                self, client_delay=self._lognormal(draws, n))
        return self

    def _tier_ranges(self, draws, n: int):
        tier = tier_assignment(draws, n, self.tier_fracs).long()
        lo = torch.tensor([d[0] for d in self.tier_delays], dtype=torch.int32,
                          device=tier.device)[tier]
        hi = torch.tensor([d[1] for d in self.tier_delays], dtype=torch.int32,
                          device=tier.device)[tier]
        return lo, hi

    def _lognormal(self, draws, n: int) -> torch.Tensor:
        lat = torch.exp(self.mu + self.sigma * draws.normal(_LOGNORMAL_SALT,
                                                            n))
        return torch.clamp(torch.ceil(lat), 1, self.max_delay).to(torch.int32)

    def schedule(self, draws, round_id: int, n: int) -> torch.Tensor:
        """int32 [n] return delays of a dispatch at ``round_id``."""
        if self.name == "uniform":
            return delay_schedule(draws, round_id, n, self.max_delay)
        if self.name == "tiers":
            if self.client_lo is not None:
                lo, hi = self.client_lo, self.client_hi
            else:
                lo, hi = self._tier_ranges(draws, n)
            u = draws.uniform(_TIER_DRAW_SALT, round_id, n)
            return lo + (u * (hi - lo + 1).float()).to(torch.int32)
        if self.name == "lognormal":
            if self.client_delay is not None:
                return self.client_delay
            return self._lognormal(draws, n)
        if self.name == "trace":
            if self.table.shape[1] != n:
                raise ValueError(
                    f"trace delay table covers {self.table.shape[1]} "
                    f"clients but the population has {n}")
            row = np.asarray(self.table[round_id % self.table.shape[0]],
                             np.int32)
            return devices.to_device(torch.from_numpy(row), draws.device)
        raise ValueError(f"unknown delay model {self.name!r}; "
                         f"known: {DELAY_MODELS}")


def accum_staleness_hist(hist, taus) -> np.ndarray:
    """Accumulate accepted-staleness values into a growing int64 histogram
    (index = staleness in rounds), on the host. Returns the (possibly
    reallocated) histogram; start from ``np.zeros(0, np.int64)``."""
    h = np.bincount(np.asarray(taus)).astype(np.int64)
    if h.size > hist.size:
        h[:hist.size] += hist
        return h
    hist = hist.copy()
    hist[:h.size] += h
    return hist


def accum_tier_hists(hist_by_tier: dict, stale, tier_of,
                     n_tiers: int) -> dict:
    """Split one round's staleness vector (int [N], accepted tau or -1) by
    permanent speed tier and accumulate each slice into
    ``hist_by_tier[tier]`` with :func:`accum_staleness_hist`."""
    for ti in range(n_tiers):
        acc = stale[(stale >= 0) & (tier_of == ti)]
        if acc.size:
            hist_by_tier[ti] = accum_staleness_hist(
                hist_by_tier.get(ti, np.zeros(0, np.int64)), acc)
    return hist_by_tier


def parse_tier_spec(spec: str):
    """Parse a ``frac:lo:hi[,frac:lo:hi...]`` tier spec, e.g.
    ``0.2:1:1,0.6:2:4,0.2:4:8`` → ``((0.2, 0.6, 0.2),
    ((1, 1), (2, 4), (4, 8)))``."""
    fracs, delays = [], []
    for part in spec.split(","):
        fields = part.split(":")
        if len(fields) != 3:
            raise ValueError(f"bad tier spec segment {part!r} (want "
                             f"frac:lo:hi, e.g. 0.2:1:1,0.6:2:4,0.2:4:8)")
        f, lo, hi = fields
        fracs.append(float(f))
        delays.append((int(lo), int(hi)))
    return tuple(fracs), tuple(delays)


def make_delay_model(name: str = "uniform", max_delay: int = 1, *,
                     tier_fracs=None, tier_delays=None, mu: float = 0.0,
                     sigma: float = 0.5, table=None) -> DelayModel:
    """A validated :class:`DelayModel`; ``tier_fracs``/``tier_delays``
    default to the 20/60/20 fast/medium/straggler split with ranges
    (1,1)/(2,4)/(4,8)."""
    fr = tuple(tier_fracs) if tier_fracs is not None else (0.2, 0.6, 0.2)
    td = (tuple((int(lo), int(hi)) for lo, hi in tier_delays)
          if tier_delays is not None else ((1, 1), (2, 4), (4, 8)))
    validate_delay_model(name, max_delay, fr, td, sigma)
    kw = {}
    if name == "tiers":
        kw = {"tier_fracs": fr, "tier_delays": td}
    elif name == "lognormal":
        kw = {"mu": float(mu), "sigma": float(sigma)}
    elif name == "trace":
        if table is None:
            raise ValueError("delay model 'trace' needs a [horizon, n] "
                             "delay table (repro_torch.fed.sampling."
                             "load_delay_trace over the JSONL trace's "
                             "per-client 'delay' field)")
        if getattr(table, "ndim", 0) != 2 or table.size == 0:
            raise ValueError(f"delay table must be a non-empty "
                             f"[horizon, n] array, got shape "
                             f"{getattr(table, 'shape', None)}")
        if int(table.min()) < 1:
            raise ValueError(f"trace delays must be >= 1 round, "
                             f"min is {int(table.min())}")
        kw = {"table": table}
    return DelayModel(name=name, max_delay=max_delay, **kw)


def delay_model_from_config(pcfg) -> DelayModel:
    """The :class:`DelayModel` a ``PopulationConfig`` describes (the trace
    model loads its table from ``pcfg.trace_file``)."""
    table = None
    if pcfg.delay_model == "trace":
        from repro_torch.fed.sampling import load_delay_trace
        table = load_delay_trace(pcfg.trace_file, pcfg.n)
    return make_delay_model(
        pcfg.delay_model, pcfg.max_delay, tier_fracs=pcfg.tier_fracs,
        tier_delays=pcfg.tier_delays, mu=pcfg.delay_mu,
        sigma=pcfg.delay_sigma, table=table)


def init_async_state(bank_states, server, n: int, codec=None) -> dict:
    """Initial async state around a fresh bank. Keys:

      bank            [N, ...] tree: each client's latest local state
      pending         [N, ...] tree: the in-flight update awaiting arrival
      last_sync       int32 [N]: round of last server-state pull
      in_flight       bool  [N]: the client's update has not landed yet
      dispatch_round  int32 [N]: round the current flight started
      return_round    int32 [N]: round the pending update arrives (NEVER
                      when idle)
      anchor          unbatched client state: the server's global model
      server          the algorithm's server state
      ef              [N, ...] f32 error-feedback residuals, only with a
                      stateful (lossy, error-feedback) codec
    """
    device = tree_leaves(bank_states)[0].device
    uniform = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    state = {
        "bank": bank_states,
        "pending": tree_map(torch.clone, bank_states),
        "last_sync": torch.zeros(n, dtype=torch.int32, device=device),
        "in_flight": torch.zeros(n, dtype=torch.bool, device=device),
        "dispatch_round": torch.zeros(n, dtype=torch.int32, device=device),
        "return_round": torch.full((n,), NEVER, dtype=torch.int32,
                                   device=device),
        "anchor": weighted_mean(bank_states, uniform),
        "server": server,
    }
    if codec is not None and codec.stateful:
        from repro_torch.fed.compress import zeros_ef
        state["ef"] = zeros_ef(codec, bank_states)
    return state


def make_async_round(local_step_ids: Callable, sync_update: Callable,
                     q: int, *, sync_mode: str = "broadcast",
                     staleness_decay: float = 0.0,
                     max_staleness: float = float("inf"),
                     max_delay: int = 1, delay_eta: float = 0.0,
                     delay: Optional[DelayModel] = None,
                     delay_draws=None, codec=None) -> Callable:
    """Build the asynchronous round: arrivals → gate → server step →
    dispatch.

    One call advances the simulation by one server round ``round_id``:

      1. Arrivals: every in-flight update whose ``return_round`` is due
         lands, with staleness ``tau = round_id - dispatch_round``.
      2. Bounded-staleness gate: arrivals with ``tau > max_staleness`` are
         dropped (the client still re-syncs). Accepted arrivals aggregate
         with weights ``(1 + tau)^-staleness_decay``.
      3. Server step: ``sync_update`` on the aggregate; with ``delay_eta >
         0`` the move away from the previous global model (``anchor``) is
         scaled by ``1 / (1 + delay_eta * max(mean_tau - 1, 0))``.
         ``broadcast`` pushes the result to every idle client,
         ``participants`` to the clients that just arrived. A round with no
         accepted arrival leaves the server untouched.
      4. Dispatch: the cohort ``ids`` runs the q local steps. Clients still
         in flight are ineligible (their slot's compute is discarded);
         eligible ones park the update in ``pending`` with return round
         ``round_id + delay``, the delay from ``delay`` (default: uniform
         over [1, max_delay]) on ``delay_draws`` (default: a
         :class:`DelayDraws` of seed 0).

    Returns ``round_fn(state, ids, batches_q, draws_q, round_id, u=None) ->
    (state, stats)`` over the :func:`init_async_state` dict, whose entries
    the round takes out of it (a donated argument, as in
    :func:`make_population_round`) (``draws_q`` the
    cohort's [q, C] Neumann depths, ``u`` the int8 codec's noise source).
    ``stats`` holds device tensors: ``arrived``/``accepted``/``dropped``
    counts, ``mean_staleness``, ``eta_scale``, ``dispatched`` (unique
    clients that started work), ``synced`` (clients that received the new
    global model: the downlink count) and ``staleness`` (int32 [N], the
    accepted arrival's tau, -1 elsewhere).

    With a lossy ``codec`` the update a dispatch parks is the codec's
    reconstruction against the client's dispatch state, and the EF
    residuals in ``state["ef"]`` change only for the clients that
    dispatched.
    """
    if sync_mode not in SYNC_MODES:
        raise ValueError(f"sync_mode must be one of {SYNC_MODES}, "
                         f"got {sync_mode!r}")
    if q < 1:
        raise ValueError(f"round needs q >= 1 local steps, got {q}")
    if max_delay < 1:
        raise ValueError(f"max_delay must be >= 1 round, got {max_delay}")
    if max_staleness <= 0:
        raise ValueError("async rounds need max_staleness > 0 (use the "
                         "synchronous make_population_round for the "
                         "max_staleness=0 setting)")
    dm = delay if delay is not None else make_delay_model("uniform",
                                                          max_delay)
    agg = as_aggregator(sync_update, codec=codec)

    def round_fn(state, ids, batches_q, draws_q, round_id: int, u=None):
        draws = (delay_draws if delay_draws is not None
                 else DelayDraws(0, ids.device))
        state = take(state)
        bank, pending = state.pop("bank"), state.pop("pending")
        last_sync, in_flight = state["last_sync"], state["in_flight"]
        disp, ret = state["dispatch_round"], state["return_round"]
        anchor, server = state.pop("anchor"), state.pop("server")
        ef = state.pop("ef", None)
        n = last_sync.shape[0]

        # 1. arrivals + 2. bounded-staleness gate
        arrived = in_flight & (ret <= round_id)
        tau = (round_id - disp).clamp_min(0).float()
        accept = arrived & (tau <= max_staleness)
        n_acc = accept.sum()
        has = n_acc > 0
        w = accept.float() * (1.0 + tau) ** (-staleness_decay)
        w = w / w.sum().clamp_min(1e-12)
        # a round with no arrival aggregates the anchor (discarded below)
        with record_function("round/aggregate"):
            avg = _tree_where(has, agg.combine(pending, weights=w), anchor)

        # 3. server step (+ delay-adaptive scaling of the model's move)
        new_client, new_server = agg.server_step(server, avg)
        mean_tau = torch.where(has, (accept * tau).sum()
                               / n_acc.clamp_min(1), 0.0)
        scale = 1.0 / (1.0 + delay_eta * (mean_tau - 1.0).clamp_min(0.0))
        if delay_eta > 0.0:
            new_client = tree_map(
                lambda a, c: (a.float() + scale * (c.float() - a.float())
                              ).to(c.dtype), anchor, new_client)
        server = _tree_where(has, new_server, server)
        anchor = _tree_where(has, new_client, anchor)
        # the aggregate and the server step's outputs are in the anchor and
        # server now; a client state each, freed before the dispatch
        del avg, new_client, new_server
        if sync_mode == "broadcast":
            sync_rows = ~(in_flight & ~arrived)   # everyone not mid-flight
        else:
            # returners only; dropped arrivals re-sync too, so no client
            # stays past the staleness bound for good
            sync_rows = arrived
        sync_rows = sync_rows & has               # no arrivals, no write
        bank = _rows_where(bank, sync_rows, anchor)
        last_sync = torch.where(sync_rows, round_id, last_sync)
        in_flight = in_flight & ~arrived
        ret = torch.where(arrived, NEVER, ret)

        # 4. dispatch the cohort (in-flight members are ineligible)
        eligible = ~in_flight.index_select(0, ids)
        lossy = agg.codec is not None and agg.codec.lossy
        with record_function("round/gather"):
            cur = gather(bank, ids)
        ref = cur if lossy else None              # server-known states
        with record_function("round/local_scan"):
            for j in range(draws_q.shape[0]):
                cur, server = local_step_ids(
                    cur, server, tree_map(lambda a: a[j], batches_q),
                    draws_q[j], ids)
        if lossy:
            # the message fixed at send time: what arrives from `pending`
            # is the codec's reconstruction; residuals change only where
            # the dispatch happened
            with record_function("round/codec"):
                ef_c = gather(ef, ids) if ef is not None else None
                cur, ef_c = agg.messages(ref, cur, ef_c, u)
                del ref
                if ef is not None:
                    ef = scatter_where(ef, ids, ef_c, eligible)
        delays = dm.schedule(draws, round_id, n).index_select(0, ids)
        with record_function("round/scatter"):
            pending = scatter_where(pending, ids, cur, eligible)
            # the bank row mirrors the client's latest local state; the
            # server reads the arrival from `pending`
            bank = scatter_where(bank, ids, cur, eligible)
        new_flight = in_flight.index_fill(0, ids, True)
        # unique clients that started work: a duplicate cohort id holds two
        # slots but dispatches one client
        started = new_flight & ~in_flight
        in_flight = new_flight
        disp = disp.index_copy(0, ids, torch.where(
            eligible, round_id, disp.index_select(0, ids)))
        ret = ret.index_copy(0, ids, torch.where(
            eligible, round_id + delays, ret.index_select(0, ids)))

        state = {"bank": bank, "pending": pending, "last_sync": last_sync,
                 "in_flight": in_flight, "dispatch_round": disp,
                 "return_round": ret, "anchor": anchor, "server": server}
        if ef is not None:
            state["ef"] = ef
        n_arr = arrived.sum()
        stats = {"arrived": n_arr.to(torch.int32),
                 "accepted": n_acc.to(torch.int32),
                 "dropped": (n_arr - n_acc).to(torch.int32),
                 "mean_staleness": mean_tau,
                 "eta_scale": scale.float(),
                 "dispatched": started.sum().to(torch.int32),
                 "synced": sync_rows.sum().to(torch.int32),
                 "staleness": torch.where(accept, tau.to(torch.int32), -1)}
        return state, stats

    return round_fn


# ------------------------------------------------------------ mega-scan tier
#
# R whole rounds as one call (repro_torch.fed.round.make_multi_round). The
# round functions above derive everything round-dependent (staleness
# weights, last_sync stamps, delay schedules) from their round_id, so a
# chunk only threads the carry and hands each round its slice of the
# staged inputs.

def make_multi_population_round(round_fn: Callable, *,
                                lossy: bool) -> Callable:
    """R synchronous population rounds as one call.

    ``round_fn`` is what :func:`make_population_round` returned (``lossy``
    says whether it threads the EF bank and the noise). Returns
    ``multi(bank_states, last_sync[, ef_bank], server, ids_R, batches_R,
    draws_R, round0[, noise_R]) -> (bank_states, last_sync[, ef_bank],
    server)`` after rounds ``round0 .. round0 + R - 1``: ``ids_R`` [R, C],
    ``batches_R`` each round's
    ``batches_q`` on a new leading R axis, ``draws_R`` the [R, q, C]
    Neumann depths and ``noise_R`` a list of the rounds' int8 noise
    sources (None: none). Equal to R sequential ``round_fn`` calls bit for
    bit."""
    def taken(carry):
        # every dict of the carry taken, as the round takes the bank's: a
        # chunk holds no round's input past the round
        return tuple(take(c) if isinstance(c, dict) else c for c in carry)

    if lossy:
        def one(carry, ids, batches_q, dr, round_id):
            draws_q, u = dr
            return round_fn(*taken(carry), ids, batches_q, draws_q,
                            round_id, u), None

        multi = make_multi_round(one)

        def mega(bank_states, last_sync, ef_bank, server, ids_R, batches_R,
                 draws_R, round0, noise_R=None):
            carry, _ = multi((bank_states, last_sync, ef_bank, server),
                             ids_R, batches_R, (draws_R, noise_R), round0)
            return carry
        return mega

    def one(carry, ids, batches_q, draws_q, round_id):
        return round_fn(*taken(carry), ids, batches_q, draws_q,
                        round_id), None

    multi = make_multi_round(one)

    def mega(bank_states, last_sync, server, ids_R, batches_R, draws_R,
             round0):
        carry, _ = multi((bank_states, last_sync, server), ids_R, batches_R,
                         draws_R, round0)
        return carry
    return mega


def make_multi_async_round(round_fn: Callable) -> Callable:
    """R asynchronous rounds (:func:`make_async_round`'s) as one call:
    ``multi(state, ids_R, batches_R, draws_R, round0, noise_R=None) ->
    (state, stats_R)``, every stats field stacked on a new leading R axis.
    The async round is uniform in ``round_id`` (round 0 is not special),
    so a run chunks from round 0."""
    def one(state, ids, batches_q, dr, round_id):
        draws_q, u = dr
        return round_fn(state, ids, batches_q, draws_q, round_id, u)

    multi = make_multi_round(one)

    def mega(state, ids_R, batches_R, draws_R, round0, noise_R=None):
        return multi(state, ids_R, batches_R, (draws_R, noise_R), round0)
    return mega
