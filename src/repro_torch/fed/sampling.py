"""Per-round cohort samplers: which C of the N population clients train.

A sampler is a deterministic function ``round_id -> C client ids`` (a host
int64 tensor: the driver builds each client's batches on the host and bills
unique transmitters from it). The random policies draw from an explicit
``torch.Generator`` seeded by (seed, round), so a run is reproducible and a
round's cohort does not depend on which rounds were asked for before.

Four policies, as in the JAX package:

  uniform     C clients uniformly without replacement each round.
  roundrobin  a deterministic cyclic sweep: round r takes clients
              [r·C, r·C + C) mod N.
  trace       each client has a periodic up/down availability schedule
              (random phase); the cohort is drawn uniformly from the clients
              up this round (:func:`draw_from_available`).
  trace-file  the same draw, with availability replayed from a recorded
              JSONL trace (:func:`load_trace`), cycling past its horizon.

The draws from the up set take their uniform scores as an input
(:meth:`CohortSampler.scores`), so a test can hand in the reference's scores
and get its cohorts id for id.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch import device as devices

SAMPLERS = ("uniform", "roundrobin", "trace", "trace-file")

# seed salt of the availability phases, apart from the per-round draws
_PHASE_SALT = 0x7FFFFFFF


def draw_from_available(up: torch.Tensor, scores: torch.Tensor,
                        c: int) -> torch.Tensor:
    """Uniform cohort draw (without replacement) from the up set, given
    uniform[0, 1) ``scores`` [n].

    Up clients score in [-1, 0), down clients in [0, 1): a stable argsort
    ranks every up client ahead of every down one, shuffled within each
    group. A shortfall (0 < #up < c) cycles the up set so the cohort keeps
    its shape [c]; an empty up set falls back to a uniform draw without
    replacement over all n clients.
    """
    n = up.shape[0]
    order = torch.argsort(scores.float() - up.float(), stable=True)
    n_up = int(up.sum())
    pool = n_up if n_up > 0 else n
    slot = torch.arange(c)
    return order[torch.where(slot < pool, slot, slot % pool)]


class CohortSampler:
    """Protocol: deterministic ``round_id -> [c] int64 global client ids``
    on the host."""

    n: int
    c: int
    seed: int                    # seeds the random policies' generators

    def cohort(self, round_id: int) -> torch.Tensor:
        raise NotImplementedError

    def mask(self, round_id: int) -> torch.Tensor:
        """Boolean participation mask over the full population: the masked
        participation view of the same draw."""
        m = torch.zeros(self.n, dtype=torch.bool)
        m[self.cohort(round_id)] = True
        return m

    def scores(self, round_id: int) -> torch.Tensor:
        """Round ``round_id``'s uniform[0, 1) scores [n] for
        :func:`draw_from_available`."""
        return torch.rand(self.n, generator=devices.generator(
            "cpu", self.seed, round_id))


@dataclasses.dataclass(frozen=True)
class UniformSampler(CohortSampler):
    """C of N uniformly at random, without replacement, per round."""
    n: int
    c: int
    seed: int = 0

    def cohort(self, round_id: int) -> torch.Tensor:
        g = devices.generator("cpu", self.seed, round_id)
        return torch.randperm(self.n, generator=g)[:self.c]


@dataclasses.dataclass(frozen=True)
class RoundRobinSampler(CohortSampler):
    """Cyclic sweep: round r takes clients [r*c, r*c + c) mod n."""
    n: int
    c: int
    offset: int = 0

    def cohort(self, round_id: int) -> torch.Tensor:
        start = self.offset + round_id * self.c
        return (start + torch.arange(self.c)) % self.n


@dataclasses.dataclass(frozen=True)
class AvailabilityTraceSampler(CohortSampler):
    """Clients follow periodic up/down schedules; sample among the up ones.

    Client i is up at round r iff ``(r + phase_i) % period < duty *
    period``, with a random per-client phase drawn from ``seed``.
    """
    n: int
    c: int
    seed: int = 0
    period: int = 8
    duty: float = 0.5

    def _phases(self) -> torch.Tensor:
        g = devices.generator("cpu", self.seed, _PHASE_SALT)
        return torch.randint(0, self.period, (self.n,), generator=g)

    def up_mask(self, round_id: int) -> torch.Tensor:
        up_len = max(int(round(self.duty * self.period)), 1)
        return (round_id + self._phases()) % self.period < up_len

    def cohort(self, round_id: int) -> torch.Tensor:
        return draw_from_available(self.up_mask(round_id),
                                   self.scores(round_id), self.c)


# ------------------------------------------------------------ trace replay

def load_trace(path: str, n: int) -> np.ndarray:
    """Load a JSONL availability trace into a dense [horizon, n] bool table.

    One line per client: ``{"client": i, "up": [[start, end], ...]}``:
    client ``i`` is available during the half-open round intervals
    ``[start, end)``. An optional ``{"horizon": T}`` line fixes the table
    length; otherwise the horizon is the max interval end, stretched to the
    longest per-client ``"delay"`` list. Clients absent from the file, or
    listed with a ``"delay"`` but no ``"up"`` key, are always available.
    Format: docs/async.md.
    """
    explicit = None
    derived = 0
    intervals = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "horizon" in rec:
                explicit = int(rec["horizon"])
                if explicit < 1:
                    raise ValueError(f"horizon must be >= 1 round, "
                                     f"got {explicit}")
                continue
            i = int(rec["client"])
            if not 0 <= i < n:
                raise ValueError(f"trace client id {i} outside population "
                                 f"[0, {n})")
            if "up" in rec:
                ivs = [(int(a), int(b)) for a, b in rec["up"]]
                for a, b in ivs:
                    if a < 0 or b < a:
                        raise ValueError(f"bad up interval [{a}, {b}) for "
                                         f"client {i}")
                    derived = max(derived, b)
                intervals[i] = intervals.get(i, []) + ivs
            if "delay" in rec:
                d = rec["delay"]
                derived = max(derived,
                              len(d) if isinstance(d, list) else 1)
    # an explicit horizon line fixes the trace length and clips intervals
    # past it; without one, the max interval end wins
    horizon = explicit if explicit is not None else derived
    if horizon == 0:
        raise ValueError(f"trace {path!r} has no up intervals, no delay "
                         f"lists, and no horizon line")
    table = np.zeros((horizon, n), bool)
    table[:, [i for i in range(n) if i not in intervals]] = True
    for i, ivs in intervals.items():
        for a, b in ivs:
            table[a:min(b, horizon), i] = True
    return table


def save_trace(path: str, table: np.ndarray, delays=None) -> None:
    """Write a dense [horizon, n] availability table as the JSONL trace
    format :func:`load_trace` reads (maximal up intervals per client).

    ``delays``, if given, adds the optional per-client ``"delay"`` field: an
    [n] vector writes one constant delay per client, a [horizon, n] table
    the per-round delay list (constant columns collapse to the scalar
    form)."""
    table = np.asarray(table, bool)
    horizon, n = table.shape
    if delays is not None:
        delays = np.asarray(delays, np.int64)
        if delays.shape not in ((n,), (horizon, n)):
            raise ValueError(f"delays must be [n] or [horizon, n] for a "
                             f"[{horizon}, {n}] table, got "
                             f"{delays.shape}")
    with open(path, "w") as f:
        f.write(json.dumps({"horizon": int(horizon)}) + "\n")
        for i in range(n):
            col = table[:, i]
            edges = np.flatnonzero(np.diff(np.concatenate(
                ([False], col, [False]))))
            ivs = [[int(a), int(b)] for a, b in
                   zip(edges[::2], edges[1::2])]
            rec = {"client": i, "up": ivs}
            if delays is not None:
                d = np.asarray(delays[i] if delays.ndim == 1
                               else delays[:, i])
                if d.ndim == 0 or (d == d.flat[0]).all():
                    rec["delay"] = int(d.flat[0])
                else:
                    rec["delay"] = [int(v) for v in d]
            f.write(json.dumps(rec) + "\n")


def load_delay_trace(path: str, n: int) -> np.ndarray:
    """Parse the JSONL trace's optional per-client ``"delay"`` field into a
    dense [horizon, n] int32 per-round delay table (the ``trace`` delay
    model of :class:`repro_torch.fed.population.DelayModel`).

    A client line may carry ``"delay": d`` (every dispatch of client ``i``
    returns after ``d`` rounds) or ``"delay": [d0, d1, ...]`` (tiled across
    the horizon: a dispatch at round ``r < horizon`` takes ``d[r % len(d)]``
    rounds; past the horizon the whole trace cycles, row ``r % horizon``).
    Clients without the field, or absent from the file, default to delay
    1. Delays must be >= 1 round. The horizon follows :func:`load_trace`'s
    rules (explicit ``horizon`` line, else the max up-interval end),
    stretched to the longest delay list; a delay list longer than an
    explicit horizon is an error. A trace with neither intervals nor a
    horizon line gets horizon 1. Format: docs/async.md.
    """
    explicit = None
    derived = 0
    delays = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "horizon" in rec:
                explicit = int(rec["horizon"])
                if explicit < 1:
                    raise ValueError(f"horizon must be >= 1 round, "
                                     f"got {explicit}")
                continue
            i = int(rec["client"])
            if not 0 <= i < n:
                raise ValueError(f"trace client id {i} outside population "
                                 f"[0, {n})")
            for a, b in rec.get("up", []):
                derived = max(derived, int(b))
            if "delay" in rec:
                d = rec["delay"]
                seq = [int(d)] if np.ndim(d) == 0 else [int(v) for v in d]
                if any(v < 1 for v in seq):
                    raise ValueError(f"client {i} delays must be >= 1 "
                                     f"round, got {seq}")
                if seq:
                    delays[i] = seq
                    derived = max(derived, len(seq))
    horizon = explicit if explicit is not None else max(derived, 1)
    table = np.ones((horizon, n), np.int32)
    for i, seq in delays.items():
        if len(seq) > horizon:
            raise ValueError(
                f"client {i} has {len(seq)} recorded delays but the trace "
                f"horizon is {horizon}: raise the horizon line (truncating"
                f" would silently drop recorded delays)")
        table[:, i] = np.resize(np.asarray(seq, np.int32), horizon)
    return table


@dataclasses.dataclass(frozen=True)
class TraceFileSampler(CohortSampler):
    """Replay a recorded availability trace ([horizon, n] bool table).

    ``up_mask(r)`` is row ``r % horizon``; the cohort is
    :func:`draw_from_available`, shared with the synthetic ``trace``
    sampler.
    """
    n: int
    c: int
    seed: int
    table: np.ndarray            # [horizon, n] bool, on the host

    @classmethod
    def from_file(cls, path: str, n: int, c: int,
                  seed: int = 0) -> "TraceFileSampler":
        return cls(n, c, seed, load_trace(path, n))

    def up_mask(self, round_id: int) -> torch.Tensor:
        return torch.from_numpy(
            self.table[int(round_id) % self.table.shape[0]].copy())

    def cohort(self, round_id: int) -> torch.Tensor:
        return draw_from_available(self.up_mask(round_id),
                                   self.scores(round_id), self.c)


def in_scan_cohort_fn(sampler: CohortSampler):
    """The sampler's ``round_id -> ids`` draw where a mega-scan chunk
    could make it itself, as the reference's: ``sampler.cohort`` for the
    uniform and roundrobin samplers, whose cohorts are functions of (seed,
    round) alone, and None for the trace samplers, which read an
    availability table a round.

    The port's draws are on the host either way (a ``torch.Generator`` on
    the CPU), and the driver and the launcher need the ids there for the
    batches and the unique-transmitter bill, so they draw a chunk's
    cohorts before it starts and stage them as one ``[R, C]`` tensor (the
    reference's route for the trace samplers): the ids an in-chunk draw
    would give, without a copy to the card inside the chunk."""
    if isinstance(sampler, (UniformSampler, RoundRobinSampler)):
        return sampler.cohort
    return None


def make_sampler(name: str, n: int, c: int, seed: int = 0, *,
                 period: int = 8, duty: float = 0.5, offset: int = 0,
                 trace_file: str = None) -> CohortSampler:
    if not 1 <= c <= n:
        raise ValueError(f"cohort size must satisfy 1 <= c <= n, "
                         f"got c={c}, n={n}")
    if name == "uniform":
        return UniformSampler(n, c, seed)
    if name == "roundrobin":
        return RoundRobinSampler(n, c, offset)
    if name == "trace":
        return AvailabilityTraceSampler(n, c, seed, period, duty)
    if name == "trace-file":
        if not trace_file:
            raise ValueError("sampler 'trace-file' needs trace_file=<path> "
                             "(JSONL availability trace, see docs/async.md)")
        return TraceFileSampler.from_file(trace_file, n, c, seed)
    raise KeyError(f"unknown sampler {name!r}; known: {SAMPLERS}")
