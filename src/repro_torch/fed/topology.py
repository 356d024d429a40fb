"""The sync layer: every engine syncs through one ``Aggregator`` contract
(``combine`` / ``server_step`` / ``reduce`` / ``messages`` /
``wire_round``).

  * :class:`StarAggregator`: the paper's star server. Combine the client
    states into one average, run ``sync_update`` (Algorithm 1 lines 4-9)
    once, broadcast or scatter the result. The eager, scan, population and
    async engines sync through it.
  * :class:`GossipAggregator`: the decentralized setting, with no server.
    Each node keeps its own server state (adaptive matrices and step
    counter), and one sync is one doubly-stochastic mixing step
    ``x_i ← Σ_j W_ij x_j`` over a graph, followed by every node's
    ``sync_update`` on its own mixed average. On the complete graph W is
    uniform (every entry ``1/n``), so gossip is the star population engine
    at cohort n.

Wire pricing is the aggregator's: star bills ``tx`` codec-priced uplinks and
``rx`` full-precision downlinks; gossip bills per directed edge, one
codec-priced message along each edge in each direction it exists, with no
full-precision broadcast.

Mixing matrices are Metropolis–Hastings over a symmetric adjacency::

    W_ij = A_ij / (1 + max(deg_i, deg_j)),   W_ii = 1 - Σ_{j≠i} W_ij

symmetric and doubly stochastic, so a mix keeps the network average and
consensus contracts at the spectral gap ``1 − |λ₂(W)|``. Topologies: ring,
2D torus, complete, Erdős–Rényi (static from numpy's ``default_rng(seed)``,
as the reference draws it, or time-varying: a new graph every round from a
uniform [n, n] draw). The time-varying draw is an input, a callable
``round_id -> [n, n]`` uniform tensor; by default a generator seeded by
(seed, 0x70B0, round), the reference's salt, apart from every other stream.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.configs.base import TOPOLOGIES, validate_topology
from repro_torch.core.tree_util import take, tree_map, tree_mean_axis0
from repro_torch.fed.compress import Codec, client_messages

# seed salt of the time-varying graph draws
_TOPOLOGY_SALT = 0x70B0


def weighted_mean(states, w: torch.Tensor):
    """Convex combination over the leading client axis: ``Σ_i w_i ·
    state_i`` per leaf, computed in f32 and cast back to the leaf dtype
    (``w`` is a [C] weight vector)."""
    return tree_map(
        lambda a: torch.tensordot(w, a.float(), dims=1).to(a.dtype), states)


# ------------------------------------------------------------ topology zoo

def ring_adjacency(n: int) -> np.ndarray:
    """Cycle graph: node i ↔ i±1 (mod n). [n, n] bool, zero diagonal."""
    A = np.zeros((n, n), bool)
    for i in range(n):
        A[i, (i - 1) % n] = True
        A[i, (i + 1) % n] = True
    np.fill_diagonal(A, False)
    return A


def torus2d_dims(n: int) -> Tuple[int, int]:
    """The a × b grid of the 2D torus: a = largest divisor of n with
    a <= sqrt(n). Raises for prime n (a 1 × n torus is the ring)."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    if a == 1 and n > 2:
        raise ValueError(f"torus2d needs a composite population size to "
                         f"form an a x b grid, got prime n={n} "
                         f"(use topology='ring')")
    return a, n // a


def torus2d_adjacency(n: int) -> np.ndarray:
    """2D torus: nodes on an a × b wrap-around grid, each joined to its 4
    grid neighbours (fewer when a dimension has length <= 2)."""
    a, b = torus2d_dims(n)
    A = np.zeros((n, n), bool)
    for i in range(a):
        for j in range(b):
            u = i * b + j
            for v in (((i - 1) % a) * b + j, ((i + 1) % a) * b + j,
                      i * b + (j - 1) % b, i * b + (j + 1) % b):
                if v != u:
                    A[u, v] = True
                    A[v, u] = True
    return A


def complete_adjacency(n: int) -> np.ndarray:
    """Complete graph: its Metropolis weights are uniform (every entry
    ``1/n``), the star engines' unweighted mean."""
    return ~np.eye(n, dtype=bool)


def erdos_adjacency(n: int, p: float, seed: int) -> np.ndarray:
    """Static seeded Erdős–Rényi graph G(n, p), unioned with the ring as a
    connectivity backbone (a disconnected component never reaches
    consensus). numpy's ``default_rng(seed)`` draws it, as in the
    reference."""
    rng = np.random.default_rng(seed)
    u = rng.random((n, n))
    A = np.triu(u < p, 1)
    A = A | A.T
    A |= ring_adjacency(n)
    np.fill_diagonal(A, False)
    return A


def metropolis_weights(adj) -> torch.Tensor:
    """Doubly-stochastic Metropolis–Hastings mixing matrix of a symmetric
    adjacency (numpy or a bool tensor): ``W_ij = A_ij / (1 + max(deg_i,
    deg_j))``, the diagonal takes the slack. f32 [n, n] on the adjacency's
    device."""
    A = torch.as_tensor(np.asarray(adj) if not isinstance(
        adj, torch.Tensor) else adj).bool()
    n = A.shape[0]
    A = A & ~torch.eye(n, dtype=torch.bool, device=A.device)
    deg = A.sum(dim=1)
    pair = 1.0 + torch.maximum(deg[:, None], deg[None, :]).float()
    W = torch.where(A, 1.0 / pair, torch.zeros((), device=A.device))
    return W + torch.diag(1.0 - W.sum(dim=1))


def mixing_matrix(topology: str, n: int, *, er_p: float = 0.4,
                  seed: int = 0) -> np.ndarray:
    """The static [n, n] f32 Metropolis mixing matrix of a named topology."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"topology must be one of {TOPOLOGIES}, "
                         f"got {topology!r}")
    if topology == "ring":
        A = ring_adjacency(n)
    elif topology == "torus2d":
        A = torus2d_adjacency(n)
    elif topology == "complete":
        A = complete_adjacency(n)
    else:
        A = erdos_adjacency(n, er_p, seed)
    return metropolis_weights(A).numpy()


def sample_er_matrix(u: torch.Tensor, p: float) -> torch.Tensor:
    """One time-varying Erdős–Rényi graph from a uniform [n, n] draw ``u``:
    a symmetric Bernoulli(p) adjacency, then Metropolis weights. No
    backbone: a transiently disconnected round mixes less."""
    up = torch.triu(u < p, diagonal=1)
    return metropolis_weights(up | up.t())


def spectral_gap(W) -> float:
    """``1 − |λ₂(W)|`` of a symmetric doubly-stochastic mixing matrix (0:
    disconnected, 1: one mix reaches consensus, the complete graph)."""
    lam = np.sort(np.abs(np.linalg.eigvalsh(np.asarray(W, np.float64))))
    return float(1.0 - (lam[-2] if lam.size > 1 else 0.0))


def directed_edges(W) -> int:
    """Directed (ordered-pair) edge count of a mixing matrix, self-loops
    excluded: the peer messages one gossip sync puts on the wire."""
    W = np.asarray(W)
    n = W.shape[0]
    return int(((W > 0) & ~np.eye(n, dtype=bool)).sum())


# ------------------------------------------------------------ the contract

class Aggregator:
    """The duck-typed sync contract: engines accept any object with these
    methods."""

    codec: Optional[Codec] = None

    def combine(self, states, weights=None):
        raise NotImplementedError

    def server_step(self, server, avg):
        raise NotImplementedError

    def reduce(self, server, states, weights=None):
        return self.server_step(server, self.combine(states, weights))

    def messages(self, ref, cur, ef=None, u=None):
        """The codec-priced uplink leg (:func:`client_messages`); a lossless
        codec returns ``(cur, ef)`` untouched."""
        return client_messages(self.codec, ref, cur, ef, u)

    def wire_round(self, msg_b: int, down_b: int, **counts) -> Tuple[int, int]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class StarAggregator(Aggregator):
    """The paper's star server: one average, one ``sync_update``, one
    broadcast. ``sync_update(server, avg) -> (new_client, new_server)`` is
    the algorithm's server step with the client count already closed
    over."""
    sync_update: Callable[[Any, Any], Tuple[Any, Any]]
    codec: Optional[Codec] = None

    def combine(self, states, weights=None):
        if weights is None:
            return tree_mean_axis0(states)
        return weighted_mean(states, weights)

    def server_step(self, server, avg):
        return self.sync_update(server, avg)

    def wire_round(self, msg_b: int, down_b: int, *, tx: int,
                   rx: int) -> Tuple[int, int]:
        """``tx`` unique transmitters ship one codec-priced message each; ``rx``
        receivers each take one full-precision downlink push."""
        return tx * msg_b, rx * down_b


def as_aggregator(sync_or_agg, codec: Optional[Codec] = None) -> Aggregator:
    """Normalize an engine's sync argument: an :class:`Aggregator` passes
    through (its own codec wins), a bare ``sync_update`` callable wraps
    into the star default with ``codec``."""
    if hasattr(sync_or_agg, "combine"):
        return sync_or_agg
    return StarAggregator(sync_update=sync_or_agg, codec=codec)


@dataclasses.dataclass(frozen=True)
class GossipAggregator(Aggregator):
    """Decentralized gossip: one Metropolis mixing step over a graph, then
    every node's ``sync_update`` on its own mixed average against its own
    server state. The server bank stacks the ``{"adaptive", "t"}`` tree on
    a leading [n] axis, and ``sync_update`` takes the whole bank at once
    (the algorithms' server steps are written for it: see
    :func:`repro_torch.core.adafbio.sync_update`).

    Static topologies build their matrix once, on ``device``;
    ``time_varying`` (erdos only) draws one each round from ``uniform``
    (``round_id -> [n, n]`` uniform[0, 1) tensor; by default a generator
    seeded by (seed, 0x70B0, round)). :meth:`host_matrix` evaluates the same
    draw for the per-round edge billing."""
    sync_update: Callable[[Any, Any], Tuple[Any, Any]]
    n: int
    topology: str = "ring"
    er_p: float = 0.4
    seed: int = 0
    time_varying: bool = False
    codec: Optional[Codec] = None
    device: Any = "cpu"
    uniform: Optional[Callable[[int], torch.Tensor]] = None

    def __post_init__(self):
        validate_topology(self.topology, self.er_p, self.time_varying)
        if not self.time_varying:
            W = mixing_matrix(self.topology, self.n, er_p=self.er_p,
                              seed=self.seed)
            object.__setattr__(self, "_W", devices.to_device(
                torch.from_numpy(W), self.device))

    # -------------------------------------------------- mixing

    def _draw(self, round_id: int) -> torch.Tensor:
        if self.uniform is not None:
            return self.uniform(round_id).to(self.device)
        g = devices.generator(self.device, self.seed, _TOPOLOGY_SALT,
                              round_id)
        return torch.rand((self.n, self.n), generator=g, device=self.device)

    def matrix(self, round_id: int) -> torch.Tensor:
        """The round's [n, n] mixing matrix on ``device``."""
        if not self.time_varying:
            return self._W
        return sample_er_matrix(self._draw(round_id), self.er_p)

    def host_matrix(self, round_id: int) -> np.ndarray:
        """The same matrix on the host, for edge billing and reporting."""
        return self.matrix(round_id).cpu().numpy()

    def mix(self, states, W: torch.Tensor):
        """One mixing step per leaf: ``x ← W @ x`` over the leading node
        axis, f32 accumulate, cast back."""
        return tree_map(
            lambda a: torch.tensordot(W, a.float(), dims=1).to(a.dtype),
            states)

    def combine(self, states, weights=None):
        """Row-wise: every node gets its own mixed average ([n, ...] in,
        [n, ...] out)."""
        if weights is not None:
            raise ValueError("gossip mixes with the matrix, not a weight "
                             "vector — staleness weighting is a star-sync "
                             "policy")
        return self.mix(states, self.matrix(0))

    def server_step(self, server, avg):
        """Every node's server step: ``server`` is the stacked [n] server
        bank, ``avg`` the [n, ...] mixed states."""
        return self.sync_update(server, avg)

    # -------------------------------------------------- wire accounting

    def edges(self, round_id: int = 0) -> int:
        """Directed peer-message count of the round's graph."""
        return directed_edges(self.host_matrix(round_id))

    def wire_round(self, msg_b: int, down_b: int, *,
                   edges: int) -> Tuple[int, int]:
        """Per-edge pricing: every directed edge carries one codec-priced
        message, the sender's uplink and the receiver's downlink (no
        full-precision broadcast: ``down_b`` is unused)."""
        del down_b
        return edges * msg_b, edges * msg_b

    @property
    def gap(self) -> float:
        """Spectral gap of the round-0 mixing matrix."""
        return spectral_gap(self.host_matrix(0))


# ------------------------------------------------------------ round program

def make_gossip_round(local_step, agg: GossipAggregator, q: int):
    """The gossip engine's round, shaped as the star engines': the mix that
    closes the previous round, then this round's local steps.

    ``local_step(bank, srv_bank, batch, k, ids)`` advances all n nodes one
    local step against their own server rows (``k`` the [n] Neumann
    depths). Returns ``round_fn(bank, srv_bank, ef, batches_q, draws_q,
    round_id, u=None, *, n_steps=q, sync_first=True) -> (bank, srv_bank,
    ef)``; ``sync_first=False`` is round 0. With a lossy codec the round
    ends by shipping each node's update through the codec against its
    round-start state (``u`` the int8 noise); the bank row becomes the
    reconstruction, the public copy the next mix reads, and the per-node
    EF residual keeps the rest. The round takes the entries out of the
    ``bank``, ``srv_bank`` and ``ef`` dicts it is given (donated, as in
    :func:`repro_torch.fed.population.make_population_round`)."""
    n = agg.n
    lossy = agg.codec is not None and agg.codec.lossy

    def round_fn(bank, srv_bank, ef, batches_q, draws_q, round_id, u=None,
                 *, n_steps=q, sync_first=True):
        bank, srv_bank, ef = take(bank), take(srv_bank), take(ef)
        ids = torch.arange(n, device=draws_q.device)
        if sync_first:
            mixed = agg.mix(bank, agg.matrix(round_id - 1))
            bank, srv_bank = agg.server_step(srv_bank, mixed)
            del mixed
        # what the previous mix published, the codec's reference
        ref = bank if lossy else None
        for j in range(n_steps):
            bank, srv_bank = local_step(
                bank, srv_bank, tree_map(lambda a: a[j], batches_q),
                draws_q[j], ids)
        bank, ef = agg.messages(ref, bank, ef, u)
        return bank, srv_bank, ef

    return round_fn
