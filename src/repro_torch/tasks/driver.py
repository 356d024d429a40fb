"""Small-scale federated experiment driver: the host-side loop that owns
run orchestration for the paper's experiments.

What this module owns: the ``FedDriver`` run loop (batch building, round
scheduling, metric/wall-clock recording in ``RunResult``) for M simulated
clients on one device, algorithm-agnostic via the ``Algorithm`` contract
(:mod:`repro_torch.core.baselines`). Per-step math comes from
:mod:`repro_torch.core`; the round engine from :mod:`repro_torch.fed.round`;
the star sync, its codec and its wire pricing from
:mod:`repro_torch.fed.topology` and :mod:`repro_torch.fed.compress`; cohort
banks and policies from :mod:`repro_torch.fed.population` and
:mod:`repro_torch.fed.sampling`.

Three participation regimes, as in the reference:

  * masked (``participation`` < 1, or a ``sampler``): all M clients
    compute every step and the inactive ones hold their state; the sync
    averages the active clients of the round it closes;
  * population (``population=PopulationConfig(n, cohort)``, synchronous):
    N client states persist in a bank, a sampler picks C ids per round,
    and only those C are computed (gather, local steps, scatter);
  * async population (``population.max_staleness != 0``): overlapping
    cohorts with delayed arrivals, bounded-staleness gating and
    delay-adaptive eta_t (:func:`repro_torch.fed.population.
    make_async_round`); per-round arrival statistics land in
    ``staleness_log``, ``staleness_hist`` and, with the ``tiers`` delay
    model, ``staleness_hist_by_tier``.

Engines, with the reference's accounting: ``"eager"`` calls the client
step once per local step; ``"scan"`` runs each communication round (the
sync closing the previous round, then q local steps) as one call;
``"gossip"`` is the decentralized engine: no server, every node keeps its
own server state and the sync is one mixing step over
``population.topology``'s graph (:mod:`repro_torch.fed.topology`; full
participation, ``population.cohort == n``). All paths track #samples (q(K+2)
at init, K+2 per local step; async scales a round's increment by the
fraction of the cohort that dispatched), #communication rounds (1 per
sync; async counts the rounds in which an aggregation happened) and the
bytes on the wire: one codec-priced message up per unique transmitter
(async: per arrival, dropped ones included) and one full-precision state
down per receiver at each sync; gossip bills one codec-priced message per
directed edge in each direction.

``track_consensus=True`` records the consensus error of every field
(:func:`repro_torch.core.metrics.consensus_error`) before each sync of the
eager engine in ``consensus_log``; the other engines refuse it, as the
reference's do.

Draws are inputs: the Neumann depth of each client at init and at each step
comes from a :class:`Draws` tensor on the device (indexed by global client
id in population mode), the int8 codec's rounding noise from a noise source
(:class:`repro_torch.fed.compress.CodecNoise` unless the caller hands one
in), the cohorts from a sampler, the async delays from a
:class:`repro_torch.fed.population.DelayDraws` source and a time-varying
gossip graph from a uniform source. The parity tests fill them from the
reference.

A ``mesh`` (:class:`repro_torch.sharding.Mesh`) places the population,
async and gossip engines' banks, EF residuals, pending buffers and [N]
vectors by the reference's bank specs (``repro_torch.sharding.bank_spec``,
kept in ``placed``); the masked eager and scan engines ignore it, as the
reference's do. A mesh over several physical devices raises (ROADMAP item
1j). A ``telemetry`` bus (:mod:`repro_torch.obs`) gets a ``round`` record a
round, the ``batch_build`` and ``round_program`` spans and, with a sink,
the on-device stat rows drained every ``metrics_every`` rounds; it only
observes, so a run with it is the run without it, bit for bit.

``rounds_per_scan`` R > 1 is the mega-scan tier (:meth:`FedDriver.
_run_chunks`): every engine but eager runs up to R whole rounds as one call
(:func:`repro_torch.fed.round.make_multi_round`), its inputs staged on the
device before it starts and its per-round outputs read back once a chunk,
equal to R single rounds bit for bit. The scan, population and gossip
engines peel round 0 (no sync before it) off as a chunk of one; the async
engine chunks from round 0; a trailing partial round peels off in all. A
record lands at the end of a chunk that holds an eval round or ends the
run, each round gets its ``round`` record and a ``stats`` record drains
a chunk's stat rows; the first chunk of each length carries the warm-up
into ``compile_seconds``, a steady chunk adds its wall-clock over L to
``round_seconds`` L times. With a telemetry sink asking for the consensus
stat, R > 1 raises ``ValueError``, as the reference's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import device as devices
from repro_torch import sharding as shlib
from repro_torch.configs.base import FedConfig, PopulationConfig
from repro_torch.core.adafbio import warm_adaptive
from repro_torch.core.baselines import Algorithm, make_algorithm
from repro_torch.core.bilevel import BilevelProblem
from repro_torch.core.metrics import consensus_error
from repro_torch.core.tree_util import (tree_bcast_axis0, tree_index,
                                        tree_map, tree_mean_axis0, tree_stack)
from repro_torch.fed.compress import (CodecNoise, codec_from_config,
                                      mask_rows, wire_costs, zeros_ef)
from repro_torch.fed.population import (ClientPopulation, DelayDraws,
                                        accum_staleness_hist,
                                        accum_tier_hists, broadcast,
                                        delay_model_from_config, gather,
                                        init_async_state, make_async_round,
                                        scatter, staleness_weights)
from repro_torch.fed.round import (ENGINES, chunk_calls, chunk_plan,
                                   make_multi_round, stack_chunk_batches,
                                   stack_round_batches)
from repro_torch.fed.sampling import make_sampler
from repro_torch.fed.topology import (GossipAggregator, StarAggregator,
                                      make_gossip_round)
from repro_torch.obs import (NULL, ChunkStats, StatAccum, ring_close,
                             ring_update)


@dataclasses.dataclass
class RunResult:
    name: str
    steps: List[int]
    samples: List[int]
    comms: List[int]
    metric: List[float]            # task metric (val loss / grad norm)
    grad_norm: List[float]
    seconds: float
    final_avg_state: Any = None    # averaged client state at the last step
    # wall-clock of the first round (kernel builds, allocator warm-up);
    # steady-state rounds land in FedDriver.round_seconds
    compile_seconds: float = 0.0
    # cumulative wire bytes at each recorded step
    bytes_up: List[int] = dataclasses.field(default_factory=list)
    bytes_down: List[int] = dataclasses.field(default_factory=list)


# the counters every record carries
COUNTERS = ("samples", "comms", "bytes_up", "bytes_down")
# the async engine's per-round arrival statistics
ASYNC_FIELDS = ("arrived", "accepted", "dropped", "dispatched", "synced",
                "mean_staleness", "eta_scale")


@dataclasses.dataclass
class Bill:
    """A run's running counters: samples (a float in the async engine,
    whose rounds count the dispatched share of the cohort), sync rounds
    and the bytes on the wire. Each engine bills a round through one
    function that its single-round loop and its chunks' accounting
    share."""
    samples: float
    comms: int = 0
    bytes_up: int = 0
    bytes_down: int = 0

    def add(self, samples, comms: int = 0, wire=(0, 0)) -> Dict[str, int]:
        """Add a round's samples, syncs and ``(up, down)`` bytes; returns
        the counters as a record carries them."""
        self.samples += samples
        self.comms += comms
        self.bytes_up += wire[0]
        self.bytes_down += wire[1]
        return dict(samples=int(round(self.samples)), comms=self.comms,
                    bytes_up=self.bytes_up, bytes_down=self.bytes_down)


@dataclasses.dataclass
class Draws:
    """The run's random draws, as device tensors: the Neumann depth of each
    client at init (``init``, [M]) and at each local step (``steps``,
    [T, M]); in population mode M is the population size and column i
    belongs to global client i."""
    init: torch.Tensor
    steps: torch.Tensor

    @classmethod
    def sample(cls, generator: torch.Generator, K: int, n_clients: int,
               total_steps: int, device) -> "Draws":
        def draw(shape):
            return torch.randint(0, K, shape, generator=generator,
                                 device=device)
        return cls(init=draw((n_clients,)),
                   steps=draw((total_steps, n_clients)))


@dataclasses.dataclass
class FedDriver:
    problem: BilevelProblem
    fed: FedConfig
    n_clients: int
    batch_fn: Callable[[int, int], Dict[str, Any]]   # (client, step) -> batches
    init_xy: Callable[[torch.Generator], Any]        # generator -> (xp, yp)
    metric_fn: Optional[Callable[..., Any]] = None   # (x̄, ȳ) -> scalar
    grad_norm_fn: Optional[Callable[..., Any]] = None
    algorithm: str = "adafbio"
    # masked partial participation: fraction of clients active per round
    # (a uniform sampler); inactive clients hold state and are left out of
    # the average, but still compute
    participation: float = 1.0
    # population mode: a bank of population.n client states, only
    # population.cohort of them computed per round (synchronous rounds)
    population: Optional[PopulationConfig] = None
    # cohort policy (repro_torch.fed.sampling); None derives
    # population.sampler, or a uniform sampler for participation < 1, from
    # the run's seed
    sampler: Optional[Any] = None
    track_consensus: bool = False
    # "eager": one client-step call per local step.
    # "scan":  one call per communication round (repro_torch.fed.round).
    # "gossip": the decentralized engine over population.topology's graph
    #          (repro_torch.fed.topology); needs population= with
    #          cohort == n
    engine: str = "eager"
    # mega-scan: up to this many whole rounds a call (every engine but
    # eager, which calls once a step)
    rounds_per_scan: int = 1
    # a device mesh for the population, async and gossip engines' banks
    # (the masked eager and scan engines ignore it)
    mesh: Optional[Any] = None
    # a repro_torch.obs.Telemetry bus: round records, spans, on-device
    # stats; it observes only (NULL: none)
    telemetry: Any = NULL
    device: Any = "cuda"

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {self.engine!r}")
        if self.rounds_per_scan < 1:
            raise ValueError(f"rounds_per_scan must be >= 1, "
                             f"got {self.rounds_per_scan}")
        if self.mesh is not None:
            self.device = shlib.check_mesh_device(self.mesh, self.device)
        self.device = devices.resolve(self.device)
        # the shardings each engine placed its bank-sized state by
        self.placed: Dict[str, Any] = {}
        self.alg: Algorithm = make_algorithm(self.algorithm, self.fed,
                                             self.problem)
        self._run_sampler = None         # set per run by _setup_sampler
        self.consensus_log: List[Dict[str, float]] = []
        # steady-state per-round wall-clock; the first round is reported
        # separately as RunResult.compile_seconds
        self.round_seconds: List[float] = []
        # the engine's whole state after a run (states or bank, server,
        # EF, last_sync, ...), by name
        self.final_state: Dict[str, Any] = {}

    @property
    def codec(self):
        """The update codec the run's FedConfig describes."""
        return codec_from_config(self.alg.fed)

    # -------------------------------------------------- shared pieces

    def batches(self, step: int, ids=None):
        """Step ``step``'s batches of clients ``ids`` (default: all M),
        stacked [C, ...]."""
        ids = range(self.n_clients) if ids is None else ids
        per_client = [self.batch_fn(int(m), step) for m in ids]
        per_client = tree_map(
            lambda a: torch.as_tensor(a, device=self.device), per_client)
        return tree_stack(per_client)

    def _aggregator(self) -> StarAggregator:
        m = self.n_clients
        return StarAggregator(
            sync_update=lambda srv, avg: self.alg.sync_update(srv, avg, m),
            codec=self.codec)

    def draws(self, total_steps: int, seed: int = 0) -> Draws:
        """Standalone draws for a run, from a generator seeded by ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed + 1)
        return Draws.sample(gen, self.alg.fed.neumann_k, self.n_clients,
                            total_steps, self.device)

    def init_run(self, seed: int, draws: Draws):
        """Client states (stacked [M, ...]) and server state at step 0."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        fed = self.alg.fed
        xp, yp = self.init_xy(gen)
        states = self.alg.init_client_state(xp, yp, self.batches(0),
                                            draws.init)
        server = self.alg.init_server_state(xp)
        if fed.adaptive != "none":
            server = warm_adaptive(server, tree_mean_axis0(states), fed)
        return states, server

    def _setup_sampler(self, seed: int) -> None:
        """The run's cohort sampler: the one handed in, else one derived
        from the run's seed (population.sampler, or a uniform sampler of
        max(participation * M, 1) clients), else None (every client, every
        round)."""
        if self.sampler is not None:
            self._run_sampler = self.sampler
            return
        sseed = devices.mix_seed(seed, 23)
        m = self.n_clients
        if self.population is not None:
            p = self.population
            self._run_sampler = make_sampler(
                p.sampler, p.n, p.cohort, sseed, period=p.trace_period,
                duty=p.trace_duty, trace_file=p.trace_file)
        elif self.participation < 1.0:
            c = max(int(self.participation * m), 1)
            self._run_sampler = make_sampler("uniform", m, c, sseed)
        else:
            self._run_sampler = None

    def _active_mask(self, round_id: int) -> Optional[torch.Tensor]:
        """Round ``round_id``'s participation mask on the host, or None when
        every client takes part."""
        if self._run_sampler is None:
            return None
        return self._run_sampler.mask(round_id)

    def _on_device(self, t: Optional[torch.Tensor]):
        return None if t is None else devices.to_device(t, self.device)

    def _transmitters(self, mask: Optional[torch.Tensor]) -> int:
        return self.n_clients if mask is None else int(mask.sum())

    def _codec_noise(self, noise, round_id: int, ids: torch.Tensor):
        """The int8 codec's noise source of a sync (``(leaf, size) -> [C,
        size]``), or None for the codecs that draw none."""
        return noise(round_id, ids) if self.codec.name == "int8" else None

    def _local_body(self, states, server, batches, k, active=None):
        t = server["t"]
        new = self.alg.local_step(states, server["adaptive"], batches, k, t,
                                  self.n_clients)
        if active is not None:
            # partial participation: inactive clients hold their state
            new = mask_rows(active, new, states)
        srv = dict(server)
        srv["t"] = t + 1
        return new, srv

    def _sync_body(self, states, server, active, ref, ef, u):
        """The sync of the eager and scan engines. Messages are priced
        against ``ref`` (the last broadcast, shared by every client; a
        lossless codec sends the states as they are), EF residuals hold for
        inactive clients, and the server averages the active clients'
        reconstructions with weights ``active / max(Σactive, 1)``. Returns
        ``(states, server, ref, ef)`` with the fresh broadcast as the next
        ``ref``."""
        m = self.n_clients
        agg = self._aggregator()
        recon, ef_new = agg.messages(ref, states, ef, u)
        if ef is not None and active is not None:
            ef_new = mask_rows(active, ef_new, ef)
        w = (torch.ones((m,), dtype=torch.float32, device=self.device)
             if active is None else active.float())
        new_client, new_server = agg.reduce(
            server, recon, weights=w / w.sum().clamp_min(1.0))
        new_states = tree_bcast_axis0(new_client, m)
        return new_states, new_server, new_states, ef_new

    def _local_steps(self, states, server, batches_q, draws_q, n_steps,
                     active):
        for j in range(n_steps):
            states, server = self._local_body(
                states, server, tree_index(batches_q, j), draws_q[j], active)
        return states, server

    def round_segment(self, states, server, ref, ef, batches_q, draws_q,
                      u=None, *, n_steps: int, sync_first: bool, active=None,
                      active_prev=None):
        """One round of the scan engine: the sync closing the previous
        round (unless this is round 0; ``u`` its int8 noise), then
        ``n_steps`` local steps. ``active``/``active_prev`` are this and the
        previous round's device masks (None: every client). Returns
        ``(states, server, ref, ef)``."""
        if sync_first:
            with record_function("round/sync"):
                states, server, ref, ef = self._sync_body(
                    states, server, active_prev, ref, ef, u)
        with record_function("round/local_scan"):
            states, server = self._local_steps(states, server, batches_q,
                                               draws_q, n_steps, active)
        return states, server, ref, ef

    def _record(self, res: RunResult, states, step, samples, comms,
                bytes_up: int = 0, bytes_down: int = 0):
        avg = tree_mean_axis0(states)
        res.steps.append(step)
        res.samples.append(samples)
        res.comms.append(comms)
        res.bytes_up.append(int(bytes_up))
        res.bytes_down.append(int(bytes_down))
        res.metric.append(float(self.metric_fn(avg["x"], avg["y"]))
                          if self.metric_fn else float("nan"))
        res.grad_norm.append(float(self.grad_norm_fn(avg["x"], avg["y"]))
                             if self.grad_norm_fn else float("nan"))

    def _log_round(self, res: RunResult, dt: float):
        """Log one round's wall-clock: the sync and the local steps, from
        after its batches are built until the device has finished them (no
        batch building, no evaluation), the same span in every engine. The
        first completed round carries the warm-up; keep it out of the
        steady-state per-round log."""
        if res.compile_seconds == 0.0:
            res.compile_seconds = dt
        else:
            self.round_seconds.append(dt)

    def _log_chunk(self, res: RunResult, dt: float, length: int,
                   fresh: bool):
        """Log a mega-scan chunk's wall-clock: the first chunk of each
        (length, steps, sync) shape carries its warm-up into
        ``compile_seconds``; a steady chunk spreads its wall-clock evenly
        over the ``length`` rounds it holds."""
        if fresh:
            res.compile_seconds += dt
        else:
            self.round_seconds.extend([dt / length] * length)

    # -------------------------------------------------- bank placement

    def _bank_shardings(self, tree):
        """The bank spec of every leaf of ``tree`` (leading population
        axis over the mesh's client axes), or None without a mesh."""
        if self.mesh is None or tree is None:
            return None
        return shlib.bank_shardings(self.mesh, tree, "replica")

    def _place(self, name: str, tree, shardings=None):
        """``tree`` placed by ``shardings`` (default: its bank specs),
        which are kept in ``placed[name]``; unchanged without a mesh."""
        if self.mesh is None or tree is None:
            return tree
        sh = shardings if shardings is not None else self._bank_shardings(
            tree)
        self.placed[name] = sh
        return shlib.device_put(tree, sh)

    def _async_state_shardings(self, state):
        """The async state's shardings: the bank-shaped entries and the
        [N] vectors partition over the client axes, the anchor and the
        server replicate."""
        rep = shlib.NamedSharding(self.mesh, shlib.P())
        return {k: (self._bank_shardings(v) if k in (
            "bank", "pending", "ef", "last_sync", "in_flight",
            "dispatch_round", "return_round") else tree_map(
                lambda _: rep, v)) for k, v in state.items()}

    # -------------------------------------------------- observability

    def _obs_begin(self, states):
        """The on-device stat ring (:mod:`repro_torch.obs.devstats`) when a
        bus with a sink is attached: the stats are computed apart from the
        round, on its output states."""
        return StatAccum.for_bus(self.telemetry, states)

    def _obs_round(self, acc, states, round_id: int, dt: float, step: int,
                   samples, comms: int, bytes_up: int = 0,
                   bytes_down: int = 0, **extra):
        """A round's record and its stat row; the ring drains (one host
        copy) every ``metrics_every`` rounds."""
        tele = self.telemetry
        tele.round(round_id, step=step, round_seconds=dt, samples=samples,
                   comms=comms, bytes_up=bytes_up, bytes_down=bytes_down,
                   **extra)
        ring_update(tele, acc, states)

    def _obs_end(self, acc):
        """Drain the partial tail window and flush the sinks."""
        tele = self.telemetry
        ring_close(tele, acc)
        tele.flush()

    # -------------------------------------------------- mega-scan

    def _run_chunks(self, lengths: List[int], eval_every: int, carry,
                    states_of: Callable, *, stage: Callable, chunk: Callable,
                    account: Callable, peel_first: bool = True):
        """The mega-scan loop of every engine (``rounds_per_scan`` R > 1)
        over the rounds ``lengths``, from ``carry``. Per chunk of L rounds
        from round r (:func:`repro_torch.fed.round.chunk_plan`,
        :func:`repro_torch.fed.round.chunk_calls`):

          * ``stage(r, L, t, n_steps)`` stages its inputs on the device
            (``batch_build``), t its first step;
          * ``chunk(carry, staged, r, n_steps, sync_first, stats)`` runs the
            L rounds as one call (``round_program``) and returns ``(carry,
            (rows, extra))``: the stat rows of ``stats`` (a
            :class:`repro_torch.obs.ChunkStats`) and the engine's own
            per-round outputs, each stacked [L, ...] or None; nothing is
            read back inside it;
          * the host reads ``extra`` once, and ``account(r + j, j, staged,
            host)`` bills round r + j (the engine's bill, which its R = 1
            loop calls too) and returns its counters (:data:`COUNTERS` and
            any fields of its ``round`` record).

        ``states_of(carry)`` is the state tree the stat rows and the
        records read. Returns ``(res, carry)``.

        R = 1 keeps each engine's single-round loop, as the reference
        keeps its ``R <= 1`` branch: there the first round alone carries
        the warm-up into ``compile_seconds`` (here the first chunk of each
        shape does), and the stat ring drains every ``metrics_every``
        rounds, the consensus stat with it (here a ``stats`` record a
        chunk, and no consensus)."""
        q = self.alg.fed.q
        tele = self.telemetry
        stats = ChunkStats(tele, states_of(carry))
        eval_rounds = max(eval_every // q, 1)
        n_rounds = len(lengths)
        first = np.cumsum([0] + lengths).tolist()   # each round's first step
        res = RunResult(self.alg.name, [], [], [], [], [], 0.0)
        seen = set()

        def shape(r):
            return lengths[r], r > 0 or not peel_first

        def call(staged, r, L):
            nonlocal carry
            carry, (rows, extra) = chunk(carry, staged, r, *shape(r), stats)
            return rows, extra

        t0 = time.time()
        for r, L, staged, rows, host, dt in chunk_calls(
                chunk_plan(lengths, q, self.rounds_per_scan,
                           peel_first=peel_first), tele, self.device,
                stage=lambda r, L: stage(r, L, first[r], lengths[r]),
                call=call):
            self._log_chunk(res, dt, L, (L,) + shape(r) not in seen)
            seen.add((L,) + shape(r))
            for j in range(L):
                fields = account(r + j, j, staged, host)
                tele.round(r + j, step=first[r + j + 1] - 1,
                           round_seconds=dt / L, **fields)
            stats.drain(rows, L)
            if (any((r + j) % eval_rounds == 0 for j in range(L))
                    or r + L == n_rounds):
                self._record(res, states_of(carry), first[r + L] - 1,
                             *(fields[k] for k in COUNTERS))
            del staged, rows
        res.seconds = time.time() - t0
        return res, carry

    def _stage_cohorts(self, r: int, L: int, t: int, n_steps: int, draws,
                       noise):
        """A population chunk's staged inputs: the host draws its L cohorts
        (``hosts``, for the batches and the bill) and stages them as one
        [L, C] tensor (``ids``), the cohorts' [L, n_steps, ...] batches,
        their [L, n_steps, C] Neumann depths and the rounds' int8 noise
        sources."""
        hosts = [self._run_sampler.cohort(rr) for rr in range(r, r + L)]
        ids = self._on_device(torch.stack(hosts))
        batches = tree_stack([tree_stack([
            self.batches(t + j * n_steps + jj, hosts[j])
            for jj in range(n_steps)]) for j in range(L)])
        depths = torch.stack([
            draws.steps[t + j * n_steps:t + (j + 1) * n_steps].index_select(
                1, ids[j]) for j in range(L)])
        return dict(hosts=hosts, ids=ids, batches=batches, draws=(
            depths, [self._codec_noise(noise, r + j, ids[j])
                     for j in range(L)]))

    # -------------------------------------------------- run loops

    def run(self, total_steps: int, seed: int = 0, eval_every: int = 10,
            draws: Optional[Draws] = None,
            noise: Optional[Callable] = None,
            delay_draws: Optional[Any] = None,
            graph_draws: Optional[Callable] = None) -> RunResult:
        """Run ``total_steps`` local steps. ``draws`` defaults to
        :meth:`draws`, ``noise`` (``(round_id, ids)`` -> a sync's noise
        source, ``(leaf, size) -> [C, size]``) to a :class:`CodecNoise` of
        ``seed`` on the run's device, ``delay_draws``
        (the async delays) to a :class:`DelayDraws` of ``seed``, and
        ``graph_draws`` (``round_id -> [n, n]`` uniform, a time-varying
        gossip graph) to a generator of ``population.topology_seed``."""
        draws = draws if draws is not None else self.draws(total_steps, seed)
        if tuple(draws.init.shape) != (self.n_clients,) or (
                draws.steps.shape[0] < total_steps
                or draws.steps.shape[1] != self.n_clients):
            raise ValueError(
                f"draws must cover {self.n_clients} clients and "
                f"{total_steps} steps, got init {tuple(draws.init.shape)}, "
                f"steps {tuple(draws.steps.shape)}")
        noise = noise if noise is not None else CodecNoise(seed, self.device)
        self._setup_sampler(seed)
        if self.engine == "gossip":
            return self._run_gossip(total_steps, seed, eval_every, draws,
                                    noise, graph_draws)
        if self.population is not None:
            return self._run_population(
                total_steps, seed, eval_every, draws, noise,
                delay_draws if delay_draws is not None
                else DelayDraws(seed, self.device))
        if self.engine == "scan":
            return self._run_scan(total_steps, seed, eval_every, draws,
                                  noise)
        fed = self.alg.fed
        m = self.n_clients
        states, server = self.init_run(seed, draws)
        samples = fed.q * (fed.neumann_k + 2)
        comms = 0
        agg = self._aggregator()
        msg_b, down_b = wire_costs(self.codec, states)
        bytes_up = bytes_down = 0
        ref, ef = states, zeros_ef(self.codec, states)   # server-known init
        ids = torch.arange(m, device=self.device)

        tele = self.telemetry
        acc = self._obs_begin(states)
        res = RunResult(self.alg.name, [], [], [], [], [], 0.0)
        t0 = time.time()
        for t in range(total_steps):
            rnd = t // fed.q
            round_end = (t + 1) % fed.q == 0 or t == total_steps - 1
            eval_now = t % eval_every == 0 or t == total_steps - 1
            if t % fed.q == 0:
                if t > 0 and self.track_consensus:
                    # the pre-sync client states, off the round's clock
                    ce = consensus_error(states)
                    self.consensus_log.append(
                        {"step": t, **{k: float(v) for k, v in ce.items()}})
                # the round's batches and masks are built before its clock
                # starts, and evaluations inside the round are taken off it
                # (_log_round)
                with tele.span("batch_build"):
                    round_batches = [self.batches(s) for s in
                                     range(t, min(t + fed.q, total_steps))]
                    mask = self._active_mask(rnd)
                    active = self._on_device(mask)
                    if t > 0:
                        mask_prev = self._active_mask(rnd - 1)
                        active_prev = self._on_device(mask_prev)
                eval_s = 0.0
                r0 = time.time()
            # the eager engine runs one program a step: a span each
            with tele.span("round_program"):
                if t > 0 and t % fed.q == 0:
                    states, server, ref, ef = self._sync_body(
                        states, server, active_prev, ref, ef,
                        self._codec_noise(noise, rnd - 1, ids))
                states, server = self._local_body(
                    states, server, round_batches[t % fed.q], draws.steps[t],
                    active)
                if round_end or eval_now:
                    devices.fence(self.device)
            if t > 0 and t % fed.q == 0:
                comms += 1
                up, down = agg.wire_round(
                    msg_b, down_b, tx=self._transmitters(mask_prev), rx=m)
                bytes_up += up
                bytes_down += down
            samples += fed.neumann_k + 2
            if round_end:
                dt = time.time() - r0 - eval_s
                self._log_round(res, dt)
                self._obs_round(acc, states, rnd, dt, t, samples, comms,
                                bytes_up, bytes_down)
            if eval_now:
                e0 = time.time()
                self._record(res, states, t, samples, comms, bytes_up,
                             bytes_down)
                eval_s += time.time() - e0
        res.seconds = time.time() - t0
        self._obs_end(acc)
        self.final_state = dict(states=states, server=server, ref=ref, ef=ef)
        res.final_avg_state = tree_mean_axis0(states)
        return res

    def _run_scan(self, total_steps: int, seed: int, eval_every: int,
                  draws: Draws, noise) -> RunResult:
        """Round engine: each communication round is one call — the sync
        that closes the PREVIOUS round, then this round's local steps. Same
        per-step math, draws and step count as the eager loop (a trailing
        partial round runs the remainder), and every recorded state is
        post-local/pre-sync like the eager loop's; only the eval granularity
        is per round instead of per step. The codec sync closing round r-1
        draws round r-1's noise, as the eager engine's does."""
        if self.track_consensus:
            raise ValueError("track_consensus needs engine='eager' (it reads "
                             "pre-sync client states mid-round)")
        fed = self.alg.fed
        q = fed.q
        m = self.n_clients
        states, server = self.init_run(seed, draws)
        agg = self._aggregator()
        msg_b, down_b = wire_costs(self.codec, states)
        ctr = Bill(fed.q * (fed.neumann_k + 2))
        ref, ef = states, zeros_ef(self.codec, states)
        ids = torch.arange(m, device=self.device)

        def bill(r, n_steps, mask_prev):
            """Round r's bill: its local steps and, past round 0, the sync
            closing round r - 1 (its transmitters up, every client
            down)."""
            if r == 0:
                return ctr.add(n_steps * (fed.neumann_k + 2))
            return ctr.add(n_steps * (fed.neumann_k + 2), 1, agg.wire_round(
                msg_b, down_b, tx=self._transmitters(mask_prev), rx=m))

        full, rem = divmod(total_steps, q)
        lengths = [q] * full + ([rem] if rem else [])
        if self.rounds_per_scan > 1:
            def stage(r, L, t, n_steps):
                rounds = range(r, r + L)
                cur = [self._active_mask(rr) for rr in rounds]
                # round 0 has no preceding sync: no mask(-1) is drawn
                prev = [self._active_mask(rr - 1) if rr > 0 else c
                        for rr, c in zip(rounds, cur)]
                masks = (None if cur[0] is None else (
                    self._on_device(torch.stack(prev)),
                    self._on_device(torch.stack(cur))))
                return dict(prev=prev, masks=masks, batches=(
                    stack_chunk_batches(self.batches, t, n_steps, L)),
                    draws=(draws.steps[t:t + L * n_steps].reshape(
                        L, n_steps, m),
                        [self._codec_noise(noise, rr - 1, ids) if rr > 0
                         else None for rr in rounds]))

            def chunk(carry, st, r, n_steps, sync_first, stats):
                def one(c, masks, batches_q, dr, rid):
                    prev, cur = masks if masks is not None else (None, None)
                    c = self.round_segment(
                        *c, batches_q, dr[0], dr[1], n_steps=n_steps,
                        sync_first=sync_first, active=cur, active_prev=prev)
                    return c, (stats.row(c[0]), None)
                return make_multi_round(one)(carry, st["masks"],
                                             st["batches"], st["draws"], r)

            res, (states, server, ref, ef) = self._run_chunks(
                lengths, eval_every, (states, server, ref, ef),
                lambda c: c[0], stage=stage, chunk=chunk,
                account=lambda rr, j, st, host: bill(rr, lengths[rr],
                                                     st["prev"][j]))
            self._obs_end(None)
            self.final_state = dict(states=states, server=server, ref=ref,
                                    ef=ef)
            res.final_avg_state = tree_mean_axis0(states)
            return res
        eval_rounds = max(eval_every // q, 1)
        tele = self.telemetry
        acc = self._obs_begin(states)
        res = RunResult(self.alg.name, [], [], [], [], [], 0.0)
        t0 = time.time()
        t = 0
        for r, n_steps in enumerate(lengths):
            with tele.span("batch_build"):
                batches_q = stack_round_batches(self.batches, t, n_steps)
                mask = self._active_mask(r)
                # round 0 has no preceding sync: no mask(-1) is drawn
                mask_prev = self._active_mask(r - 1) if r > 0 else mask
                masks = dict(active=self._on_device(mask),
                             active_prev=self._on_device(mask_prev))
            kw = dict(n_steps=n_steps, sync_first=r > 0, **masks)
            r0 = time.time()
            with tele.span("round_program"):
                u = (self._codec_noise(noise, r - 1, ids) if r > 0
                     else None)
                states, server, ref, ef = self.round_segment(
                    states, server, ref, ef, batches_q,
                    draws.steps[t:t + n_steps], u, **kw)
                devices.fence(self.device)
            dt = time.time() - r0
            self._log_round(res, dt)
            t += n_steps
            fields = bill(r, n_steps, mask_prev)
            self._obs_round(acc, states, r, dt, t - 1, **fields)
            if r % eval_rounds == 0 or r == len(lengths) - 1:
                self._record(res, states, t - 1, **fields)
        res.seconds = time.time() - t0
        self._obs_end(acc)
        self.final_state = dict(states=states, server=server, ref=ref, ef=ef)
        res.final_avg_state = tree_mean_axis0(states)
        return res

    # -------------------------------------------------- population mode

    def _init_population(self, seed: int, draws: Draws):
        """Bank of N client states: the masked path's init (shared (x0, y0),
        per-client Neumann depths and step-0 batches) over all N, so N == M
        runs start identically."""
        states, server = self.init_run(seed, draws)
        n = self.population.n
        return ClientPopulation(states=states, n=n, last_sync=torch.zeros(
            n, dtype=torch.int32, device=self.device)), server

    def population_segment(self, bank, last_sync, ef, server, prev_ids, ids,
                           batches_q, draws_q, round_id: int, u=None, *,
                           n_steps: int, sync_first: bool):
        """One population round: the sync that closes round ``round_id - 1``
        over the previous cohort ``prev_ids`` (unless this is round 0), then
        ``n_steps`` local steps of cohort ``ids`` (``draws_q`` [n_steps, C]),
        its messages through the codec (``u`` the int8 noise), and the
        write-back. Returns ``(bank, last_sync, ef, server)``."""
        pcfg = self.population
        agg = self._aggregator()
        if sync_first:
            # a client stamped at the previous sync (last_sync == r-1) is
            # fully fresh
            with record_function("round/aggregate"):
                w = staleness_weights(last_sync, prev_ids, round_id - 1,
                                      pcfg.staleness_decay)
                new_client, server = agg.reduce(
                    server, gather(bank, prev_ids), weights=w)
            if pcfg.sync_mode == "broadcast":
                with record_function("round/broadcast"):
                    bank = broadcast(bank, new_client)
                    last_sync = torch.full_like(last_sync, round_id)
            else:
                with record_function("round/scatter_sync"):
                    bank = scatter(bank, prev_ids, tree_bcast_axis0(
                        new_client, prev_ids.shape[0]))
                    last_sync = last_sync.index_fill(0, prev_ids, round_id)
        with record_function("round/gather"):
            ref = cur = gather(bank, ids)    # server-known dispatch states
        with record_function("round/local_scan"):
            cur, server = self._local_steps(cur, server, batches_q, draws_q,
                                            n_steps, None)
        # the cohort ships its update when the round ends; its bank rows
        # become the server-side reconstructions the next sync averages (a
        # lossless codec sends the states as they are)
        with record_function("round/codec"):
            ef_c = gather(ef, ids) if ef is not None else None
            cur, ef_c = agg.messages(ref, cur, ef_c, u)
            if ef is not None:
                ef = scatter(ef, ids, ef_c)
        with record_function("round/scatter"):
            return scatter(bank, ids, cur), last_sync, ef, server

    def _run_population(self, total_steps: int, seed: int, eval_every: int,
                        draws: Draws, noise, delay_draws) -> RunResult:
        """Cohort-sampled synchronous rounds over a persistent N-client bank,
        shaped as the scan engine's: the sync that closes the PREVIOUS round,
        then this round's local steps, touching only the C sampled clients.
        With ``sync_mode='broadcast'`` and the same cohorts this is the
        masked-participation trajectory. An asynchronous population runs
        :meth:`_run_population_async`."""
        if self.track_consensus:
            raise ValueError("track_consensus needs the masked eager engine "
                             "(it reads pre-sync client states mid-round)")
        pcfg = self.population
        if pcfg.n != self.n_clients:
            raise ValueError(
                f"population.n ({pcfg.n}) must equal n_clients "
                f"({self.n_clients}): batch_fn and init indices run over the "
                f"population")
        if pcfg.asynchronous:
            return self._run_population_async(total_steps, seed, eval_every,
                                              draws, noise, delay_draws)
        n = pcfg.n
        fed = self.alg.fed
        q = fed.q
        agg = self._aggregator()
        pop, server = self._init_population(seed, draws)
        bank, last_sync = pop.states, pop.last_sync
        msg_b, down_b = wire_costs(self.codec, bank)
        ctr = Bill(fed.q * (fed.neumann_k + 2))
        ef = zeros_ef(self.codec, bank)
        # the bank layout, committed up front
        bank = self._place("bank", bank)
        last_sync = self._place("last_sync", last_sync)
        ef = self._place("ef", ef)

        def bill(r, n_steps, prev_host):
            """Round r's bill: its local steps and, past round 0, the sync
            closing round r - 1 over that round's cohort ``prev_host``.
            The uplink bills UNIQUE transmitters: a duplicate cohort id
            holds two aggregation slots, but one client shipped one
            message; participants-mode downlink reaches each once."""
            if r == 0:
                return ctr.add(n_steps * (fed.neumann_k + 2))
            tx = int(torch.unique(prev_host).numel())
            return ctr.add(n_steps * (fed.neumann_k + 2), 1, agg.wire_round(
                msg_b, down_b, tx=tx,
                rx=(n if pcfg.sync_mode == "broadcast" else tx)))

        full, rem = divmod(total_steps, q)
        lengths = [q] * full + ([rem] if rem else [])
        if self.rounds_per_scan > 1:
            last = [None]          # the cohort of the round before a chunk

            def stage(r, L, t, n_steps):
                st = self._stage_cohorts(r, L, t, n_steps, draws, noise)
                # the sync opening round rr bills round rr - 1's cohort
                hosts = st["hosts"]
                st["billed"] = [last[0] if last[0] is not None
                                else hosts[0]] + hosts[:-1]
                last[0] = hosts[-1]
                return st

            def chunk(carry, st, r, n_steps, sync_first, stats):
                def one(c, ids, batches_q, dr, rid):
                    bank, last_sync, ef, server, prev_ids = c
                    bank, last_sync, ef, server = self.population_segment(
                        bank, last_sync, ef, server,
                        ids if prev_ids is None else prev_ids, ids,
                        batches_q, dr[0], rid, dr[1], n_steps=n_steps,
                        sync_first=sync_first)
                    return ((bank, last_sync, ef, server, ids),
                            (stats.row(bank), None))
                return make_multi_round(one)(carry, st["ids"], st["batches"],
                                             st["draws"], r)

            res, (bank, last_sync, ef, server, _) = self._run_chunks(
                lengths, eval_every, (bank, last_sync, ef, server, None),
                lambda c: c[0], stage=stage, chunk=chunk,
                account=lambda rr, j, st, host: bill(rr, lengths[rr],
                                                     st["billed"][j]))
            self._obs_end(None)
            self.final_state = dict(bank=bank, last_sync=last_sync, ef=ef,
                                    server=server)
            self.final_bank = bank
            res.final_avg_state = tree_mean_axis0(bank)
            return res
        eval_rounds = max(eval_every // q, 1)
        tele = self.telemetry
        acc = self._obs_begin(bank)
        res = RunResult(self.alg.name, [], [], [], [], [], 0.0)
        t0 = time.time()
        t = 0
        prev_ids = prev_host = None
        for r, n_steps in enumerate(lengths):
            with tele.span("batch_build"):
                ids_host = self._run_sampler.cohort(r)
                ids = self._on_device(ids_host)
                # the sync opening round r aggregates (and bills) the
                # PREVIOUS round's cohort: the clients whose updates are on
                # the wire
                if prev_ids is None:
                    prev_ids, prev_host = ids, ids_host
                batches_q = tree_stack([self.batches(t + j, ids_host)
                                        for j in range(n_steps)])
                draws_q = draws.steps[t:t + n_steps].index_select(1, ids)
            r0 = time.time()
            with tele.span("round_program"):
                bank, last_sync, ef, server = self.population_segment(
                    bank, last_sync, ef, server, prev_ids, ids, batches_q,
                    draws_q, r, self._codec_noise(noise, r, ids),
                    n_steps=n_steps, sync_first=r > 0)
                devices.fence(self.device)
            dt = time.time() - r0
            self._log_round(res, dt)
            t += n_steps
            fields = bill(r, n_steps, prev_host)
            prev_ids, prev_host = ids, ids_host
            self._obs_round(acc, bank, r, dt, t - 1, **fields)
            if r % eval_rounds == 0 or r == len(lengths) - 1:
                self._record(res, bank, t - 1, **fields)
        res.seconds = time.time() - t0
        self._obs_end(acc)
        self.final_state = dict(bank=bank, last_sync=last_sync, ef=ef,
                                server=server)
        self.final_bank = bank
        res.final_avg_state = tree_mean_axis0(bank)
        return res

    # -------------------------------------------------- gossip engine

    def _gossip_local_step(self, n: int):
        """One local step of every node of the decentralized engine: the
        client step against each node's own adaptive matrices (the server
        bank's [n] rows). The nodes step in lockstep, so their counters are
        equal and the step reads node 0's; each node's counter advances."""
        def step(states, srv_bank, batch, k, ids):
            t = srv_bank["t"]
            new = self.alg.local_step(states, srv_bank["adaptive"], batch, k,
                                      t[0], n)
            srv = dict(srv_bank)
            srv["t"] = t + 1
            return new, srv
        return step

    def _run_gossip(self, total_steps: int, seed: int, eval_every: int,
                    draws: Draws, noise, graph_draws) -> RunResult:
        """Decentralized rounds: no server. Each node keeps its own server
        state, and the sync that opens round r is one doubly-stochastic
        mixing step over ``population.topology``'s graph, then every node's
        own ``sync_update`` (:mod:`repro_torch.fed.topology`). Same round
        shape as :meth:`_run_population` (the mix closing round r-1, then q
        local steps; round 0 has nothing to close), full participation.

        Wire accounting is per directed edge: every sync, each node ships
        one codec-priced message along each out-edge and receives one along
        each in-edge; there is no full-precision broadcast. Time-varying
        graphs are billed from each round's draw.

        On the complete graph the Metropolis matrix is uniform, so this
        engine follows the star population engine at cohort n."""
        if self.track_consensus:
            raise ValueError("track_consensus needs the masked eager engine "
                             "(it reads pre-sync client states mid-round)")
        pcfg = self.population
        if pcfg is None:
            raise ValueError(
                "engine='gossip' needs population=PopulationConfig(...) — "
                "the population size and topology knobs live there")
        if pcfg.n != self.n_clients:
            raise ValueError(
                f"population.n ({pcfg.n}) must equal n_clients "
                f"({self.n_clients}) — batch_fn/init indices run over the "
                f"population")
        if pcfg.cohort != pcfg.n:
            raise ValueError(
                f"the gossip engine is full-participation: every node mixes "
                f"and steps every round, so population.cohort "
                f"({pcfg.cohort}) must equal population.n ({pcfg.n})")
        if pcfg.asynchronous:
            raise ValueError("the gossip engine is synchronous — set "
                             "population.max_staleness = 0")
        n = pcfg.n
        fed = self.alg.fed
        q = fed.q
        agg = GossipAggregator(
            sync_update=lambda srv, avg: self.alg.sync_update(srv, avg, n),
            n=n, topology=pcfg.topology, er_p=pcfg.er_p,
            seed=pcfg.topology_seed, time_varying=pcfg.time_varying,
            codec=self.codec, device=self.device, uniform=graph_draws)
        self.gossip_agg = agg
        pop, server = self._init_population(seed, draws)
        bank = pop.states
        # every node starts from the same warm-adaptive server state: the
        # star engines' init, so round 0 coincides with theirs
        srv_bank = tree_bcast_axis0(server, n)
        msg_b, down_b = wire_costs(self.codec, bank)
        ctr = Bill(fed.q * (fed.neumann_k + 2))
        ef = zeros_ef(self.codec, bank)
        bank = self._place("bank", bank)
        srv_bank = self._place("srv_bank", srv_bank)
        ef = self._place("ef", ef)
        ids = torch.arange(n, device=self.device)
        round_fn = make_gossip_round(self._gossip_local_step(n), agg, q)
        # static graphs price once; time-varying ones per round
        static_edges = None if pcfg.time_varying else agg.edges(0)

        def bill(r, n_steps):
            """Round r's bill: its local steps and, past round 0, the mix
            closing round r - 1 over that round's edges."""
            if r == 0:
                return ctr.add(n_steps * (fed.neumann_k + 2))
            edges = (static_edges if static_edges is not None
                     else agg.edges(r - 1))
            return ctr.add(n_steps * (fed.neumann_k + 2), 1,
                           agg.wire_round(msg_b, down_b, edges=edges))

        full, rem = divmod(total_steps, q)
        lengths = [q] * full + ([rem] if rem else [])
        if self.rounds_per_scan > 1:
            def stage(r, L, t, n_steps):
                return dict(batches=stack_chunk_batches(self.batches, t,
                                                        n_steps, L),
                            draws=(draws.steps[t:t + L * n_steps].reshape(
                                L, n_steps, n),
                                [self._codec_noise(noise, r + j, ids)
                                 for j in range(L)]))

            def chunk(carry, st, r, n_steps, sync_first, stats):
                # a time-varying graph is drawn from the absolute round id
                # inside the chunk
                def one(c, _, batches_q, dr, rid):
                    c = round_fn(*c, batches_q, dr[0], rid, dr[1],
                                 n_steps=n_steps, sync_first=sync_first)
                    return c, (stats.row(c[0]), None)
                return make_multi_round(one)(carry, None, st["batches"],
                                             st["draws"], r)

            res, (bank, srv_bank, ef) = self._run_chunks(
                lengths, eval_every, (bank, srv_bank, ef), lambda c: c[0],
                stage=stage, chunk=chunk,
                account=lambda rr, j, st, host: bill(rr, lengths[rr]))
            self._obs_end(None)
            self.final_state = dict(bank=bank, srv_bank=srv_bank, ef=ef)
            self.final_bank = bank
            res.final_avg_state = tree_mean_axis0(bank)
            return res
        eval_rounds = max(eval_every // q, 1)
        tele = self.telemetry
        acc = self._obs_begin(bank)
        res = RunResult(self.alg.name, [], [], [], [], [], 0.0)
        t0 = time.time()
        t = 0
        for r, n_steps in enumerate(lengths):
            with tele.span("batch_build"):
                batches_q = stack_round_batches(self.batches, t, n_steps)
            u = self._codec_noise(noise, r, ids)
            r0 = time.time()
            with tele.span("round_program"):
                bank, srv_bank, ef = round_fn(
                    bank, srv_bank, ef, batches_q,
                    draws.steps[t:t + n_steps], r, u, n_steps=n_steps,
                    sync_first=r > 0)
                devices.fence(self.device)
            dt = time.time() - r0
            self._log_round(res, dt)
            t += n_steps
            fields = bill(r, n_steps)
            self._obs_round(acc, bank, r, dt, t - 1, **fields)
            if r % eval_rounds == 0 or r == len(lengths) - 1:
                self._record(res, bank, t - 1, **fields)
        res.seconds = time.time() - t0
        self._obs_end(acc)
        self.final_state = dict(bank=bank, srv_bank=srv_bank, ef=ef)
        self.final_bank = bank
        res.final_avg_state = tree_mean_axis0(bank)
        return res

    # -------------------------------------------------- async population

    def _run_population_async(self, total_steps: int, seed: int,
                              eval_every: int, draws: Draws, noise,
                              delay_draws) -> RunResult:
        """Asynchronous rounds over the bank: arrivals → bounded-staleness
        gate → (delay-adaptively scaled) server step → overlapping-cohort
        dispatch, one :func:`repro_torch.fed.population.make_async_round`
        call a round. Per-round arrival stats land in ``staleness_log``,
        the accepted-staleness histogram in ``staleness_hist`` (index =
        staleness in rounds) and, with the ``tiers`` delay model, split by
        the client's permanent tier in ``staleness_hist_by_tier``.

        Sample accounting: a cohort slot whose client is still in flight is
        masked out and its compute discarded, so a round's sample increment
        scales by ``dispatched / cohort``. Bytes: every arrival shipped one
        codec message (dropped ones too: the gate rejects them after
        transmission); the rows that received the new global model each
        take one full-precision downlink."""
        pcfg = self.population
        n, c = pcfg.n, pcfg.cohort
        fed = self.alg.fed
        q = fed.q
        agg = self._aggregator()
        # the permanent per-client delay quantities, drawn once
        dm = delay_model_from_config(pcfg).resolve(delay_draws, n)
        pop, server = self._init_population(seed, draws)
        state = init_async_state(pop.states, server, n, codec=self.codec)
        if self.mesh is not None:
            state = self._place("state", state,
                                self._async_state_shardings(state))
        msg_b, down_b = wire_costs(self.codec, pop.states)
        ctr = Bill(float(fed.q * (fed.neumann_k + 2)))
        self.staleness_log: List[Dict[str, float]] = []
        self.staleness_hist = np.zeros(0, np.int64)
        self.staleness_hist_by_tier: Dict[int, Any] = {}
        tier_of = (dm.tiers(delay_draws, n).cpu().numpy()
                   if pcfg.delay_model == "tiers" else None)
        round_fn = make_async_round(
            lambda st, srv, b, k, ids: self._local_body(st, srv, b, k), agg,
            q, sync_mode=pcfg.sync_mode,
            staleness_decay=pcfg.staleness_decay,
            max_staleness=pcfg.max_staleness, max_delay=pcfg.max_delay,
            delay_eta=pcfg.delay_eta, delay=dm, delay_draws=delay_draws,
            codec=self.codec)

        def bill(r, n_steps, host):
            """Round r's bill from its stats, read to the host: the
            histograms and the log row (:meth:`_note_async_round`), the
            dispatched share of its samples, a sync if it accepted, every
            arrival up and every synced row down. Returns the counters and
            the row's fields."""
            row = self._note_async_round(r, host, tier_of,
                                         len(pcfg.tier_fracs))
            fields = ctr.add(
                n_steps * (fed.neumann_k + 2) * row["dispatched"] / c,
                int(row["accepted"] > 0),
                agg.wire_round(msg_b, down_b, tx=row["arrived"],
                               rx=row["synced"]))
            return dict(fields, **{k: row[k] for k in ASYNC_FIELDS})

        full, rem = divmod(total_steps, q)
        lengths = [q] * full + ([rem] if rem else [])
        if self.rounds_per_scan > 1:
            def stage(r, L, t, n_steps):
                return self._stage_cohorts(r, L, t, n_steps, draws, noise)

            def chunk(carry, st, r, n_steps, sync_first, stats):
                # the async round is uniform in its round id: chunks start
                # at round 0, and the stats come back stacked [L, ...]
                def one(state, ids, batches_q, dr, rid):
                    state, rstats = round_fn(state, ids, batches_q, dr[0],
                                             rid, dr[1])
                    return state, (stats.row(state["bank"]), rstats)
                return make_multi_round(one)(carry, st["ids"], st["batches"],
                                             st["draws"], r)

            res, state = self._run_chunks(
                lengths, eval_every, state, lambda st: st["bank"],
                stage=stage, chunk=chunk, peel_first=False,
                account=lambda rr, j, st, host: bill(
                    rr, lengths[rr], {k: v[j] for k, v in host.items()}))
            self.telemetry.note(
                staleness_hist=[int(k) for k in self.staleness_hist])
            self._obs_end(None)
            self.final_state = dict(state)
            self.final_bank = state["bank"]
            res.final_avg_state = tree_mean_axis0(state["bank"])
            return res
        eval_rounds = max(eval_every // q, 1)
        tele = self.telemetry
        acc = self._obs_begin(state["bank"])
        res = RunResult(self.alg.name, [], [], [], [], [], 0.0)
        t0 = time.time()
        t = 0
        for r, n_steps in enumerate(lengths):
            with tele.span("batch_build"):
                ids_host = self._run_sampler.cohort(r)
                ids = self._on_device(ids_host)
                batches_q = tree_stack([self.batches(t + j, ids_host)
                                        for j in range(n_steps)])
                draws_q = draws.steps[t:t + n_steps].index_select(1, ids)
            u = self._codec_noise(noise, r, ids)
            r0 = time.time()
            with tele.span("round_program"):
                state, stats = round_fn(state, ids, batches_q, draws_q, r, u)
                devices.fence(self.device)
            dt = time.time() - r0
            self._log_round(res, dt)
            t += n_steps
            fields = bill(r, n_steps,
                          {k: v.cpu().numpy() for k, v in stats.items()})
            self._obs_round(acc, state["bank"], r, dt, t - 1, **fields)
            if r % eval_rounds == 0 or r == len(lengths) - 1:
                self._record(res, state["bank"], t - 1,
                             *(fields[k] for k in COUNTERS))
        res.seconds = time.time() - t0
        tele.note(staleness_hist=[int(k) for k in self.staleness_hist])
        self._obs_end(acc)
        self.final_state = dict(state)
        self.final_bank = state["bank"]
        res.final_avg_state = tree_mean_axis0(state["bank"])
        return res

    def _note_async_round(self, r: int, host, tier_of, n_tiers: int):
        """One async round's stats, read to the host (numpy): the
        histograms and a ``staleness_log`` row, which it returns."""
        stale = host["staleness"]
        accepted = stale[stale >= 0]
        if accepted.size:
            self.staleness_hist = accum_staleness_hist(self.staleness_hist,
                                                       accepted)
        if tier_of is not None:
            accum_tier_hists(self.staleness_hist_by_tier, stale, tier_of,
                             n_tiers)
        row = {"round": r}
        for k in ("arrived", "accepted", "dropped", "dispatched", "synced"):
            row[k] = int(host[k])
        for k in ("mean_staleness", "eta_scale"):
            row[k] = float(host[k])
        self.staleness_log.append(row)
        return row
