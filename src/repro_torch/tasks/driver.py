"""Small-scale federated experiment driver: the host-side loop that owns
run orchestration for the paper's experiments.

What this module owns: the ``FedDriver`` run loop (batch building, round
scheduling, metric/wall-clock recording in ``RunResult``) for M simulated
clients on one device, algorithm-agnostic via the ``Algorithm`` contract
(:mod:`repro_torch.core.baselines`). Per-step math comes from
:mod:`repro_torch.core`; the round engine from :mod:`repro_torch.fed.round`;
the star sync and its wire pricing from :mod:`repro_torch.fed.topology`.

Two engines, with the reference's accounting: ``"eager"`` calls the client
step once per local step; ``"scan"`` runs each communication round (the
sync closing the previous round, then q local steps) as one call. Both
track #samples (q(K+2) at init, K+2 per local step), #communication rounds
(1 per sync) and the bytes on the wire (one message up per client and one
state down per client at each sync).

Draws are inputs: the Neumann depth of each client at init and at each step
comes from a :class:`Draws` tensor on the device, made from a
``torch.Generator`` unless the caller hands one in (the parity tests fill it
from the reference's keys).

Not ported yet: ``population=`` (cohort banks, slice 2), ``participation <
1`` (cohort sampling, slice 2) and lossy codecs (slice 2); each raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import device as devices
from repro_torch.configs.base import FedConfig
from repro_torch.core.adafbio import warm_adaptive
from repro_torch.core.baselines import Algorithm, make_algorithm
from repro_torch.core.bilevel import BilevelProblem
from repro_torch.core.tree_util import (tree_bcast_axis0, tree_index,
                                        tree_map, tree_mean_axis0, tree_stack)
from repro_torch.fed.compress import codec_from_config, wire_costs
from repro_torch.fed.round import ENGINES, stack_round_batches
from repro_torch.fed.topology import StarAggregator


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


@dataclasses.dataclass
class Draws:
    """The run's random draws, as device tensors: the Neumann depth of each
    client at init (``init``, [M]) and at each local step (``steps``,
    [T, M])."""
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
    participation: float = 1.0
    population: Optional[Any] = None
    # "eager": one client-step call per local step.
    # "scan":  one call per communication round (repro_torch.fed.round).
    engine: str = "eager"
    device: Any = "cuda"

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {self.engine!r}")
        if self.population is not None:
            raise NotImplementedError(
                "population= is not ported yet: client banks and cohort "
                "rounds come with the population and codec slice (slice 2)")
        if self.participation < 1.0:
            raise NotImplementedError(
                "participation < 1 is not ported yet: cohort sampling comes "
                "with the population and codec slice (slice 2)")
        self.device = devices.resolve(self.device)
        self.alg: Algorithm = make_algorithm(self.algorithm, self.fed,
                                             self.problem)
        self.codec = codec_from_config(self.alg.fed)
        # steady-state per-round wall-clock; the first round is reported
        # separately as RunResult.compile_seconds
        self.round_seconds: List[float] = []

    # -------------------------------------------------- shared pieces

    def batches(self, step: int):
        """Step ``step``'s batches of every client, stacked [M, ...]."""
        per_client = [self.batch_fn(m, step) for m in range(self.n_clients)]
        per_client = tree_map(
            lambda a: torch.as_tensor(a, device=self.device), per_client)
        return tree_stack(per_client)

    def _aggregator(self) -> StarAggregator:
        m = self.n_clients
        return StarAggregator(
            sync_update=lambda srv, avg: self.alg.sync_update(srv, avg, m))

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

    def _local_body(self, states, server, batches, k):
        t = server["t"]
        new = self.alg.local_step(states, server["adaptive"], batches, k, t,
                                  self.n_clients)
        srv = dict(server)
        srv["t"] = t + 1
        return new, srv

    def _sync_body(self, states, server):
        m = self.n_clients
        w = torch.ones((m,), dtype=torch.float32, device=self.device)
        new_client, new_server = self._aggregator().reduce(
            server, states, weights=w / w.sum())
        return tree_bcast_axis0(new_client, m), new_server

    def round_segment(self, states, server, batches_q, draws_q, *,
                      n_steps: int, sync_first: bool):
        """One round of the scan engine: the sync closing the previous
        round (unless this is round 0), then ``n_steps`` local steps."""
        if sync_first:
            states, server = self._sync_body(states, server)
        for j in range(n_steps):
            states, server = self._local_body(
                states, server, tree_index(batches_q, j), draws_q[j])
        return states, server

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
        batch building, no evaluation), the same span in both engines. The
        first completed round carries the warm-up; keep it out of the
        steady-state per-round log."""
        if res.compile_seconds == 0.0:
            res.compile_seconds = dt
        else:
            self.round_seconds.append(dt)

    # -------------------------------------------------- run loops

    def run(self, total_steps: int, seed: int = 0, eval_every: int = 10,
            draws: Optional[Draws] = None) -> RunResult:
        draws = draws if draws is not None else self.draws(total_steps, seed)
        if tuple(draws.init.shape) != (self.n_clients,) or (
                draws.steps.shape[0] < total_steps
                or draws.steps.shape[1] != self.n_clients):
            raise ValueError(
                f"draws must cover {self.n_clients} clients and "
                f"{total_steps} steps, got init {tuple(draws.init.shape)}, "
                f"steps {tuple(draws.steps.shape)}")
        if self.engine == "scan":
            return self._run_scan(total_steps, seed, eval_every, draws)
        fed = self.alg.fed
        states, server = self.init_run(seed, draws)
        samples = fed.q * (fed.neumann_k + 2)
        comms = 0
        agg = self._aggregator()
        msg_b, down_b = wire_costs(self.codec, states)
        bytes_up = bytes_down = 0

        res = RunResult(self.alg.name, [], [], [], [], [], 0.0)
        t0 = time.time()
        for t in range(total_steps):
            if t % fed.q == 0:
                # the round's batches are built before its clock starts, and
                # evaluations inside the round are taken off it (_log_round)
                round_batches = [self.batches(s) for s in
                                 range(t, min(t + fed.q, total_steps))]
                eval_s = 0.0
                r0 = time.time()
            if t > 0 and t % fed.q == 0:
                states, server = self._sync_body(states, server)
                comms += 1
                up, down = agg.wire_round(msg_b, down_b, tx=self.n_clients,
                                          rx=self.n_clients)
                bytes_up += up
                bytes_down += down
            states, server = self._local_body(states, server,
                                              round_batches[t % fed.q],
                                              draws.steps[t])
            samples += fed.neumann_k + 2
            if (t + 1) % fed.q == 0 or t == total_steps - 1:
                devices.fence(self.device)
                self._log_round(res, time.time() - r0 - eval_s)
            if t % eval_every == 0 or t == total_steps - 1:
                devices.fence(self.device)
                e0 = time.time()
                self._record(res, states, t, samples, comms, bytes_up,
                             bytes_down)
                eval_s += time.time() - e0
        res.seconds = time.time() - t0
        res.final_avg_state = tree_mean_axis0(states)
        return res

    def _run_scan(self, total_steps: int, seed: int, eval_every: int,
                  draws: Draws) -> RunResult:
        """Round engine: each communication round is one call — the sync
        that closes the PREVIOUS round, then this round's local steps. Same
        per-step math, draws and step count as the eager loop (a trailing
        partial round runs the remainder), and every recorded state is
        post-local/pre-sync like the eager loop's; only the eval granularity
        is per round instead of per step."""
        fed = self.alg.fed
        q = fed.q
        states, server = self.init_run(seed, draws)
        samples = fed.q * (fed.neumann_k + 2)
        comms = 0
        agg = self._aggregator()
        msg_b, down_b = wire_costs(self.codec, states)
        bytes_up = bytes_down = 0

        full, rem = divmod(total_steps, q)
        lengths = [q] * full + ([rem] if rem else [])
        eval_rounds = max(eval_every // q, 1)
        res = RunResult(self.alg.name, [], [], [], [], [], 0.0)
        t0 = time.time()
        t = 0
        for r, n_steps in enumerate(lengths):
            batches_q = stack_round_batches(self.batches, t, n_steps)
            r0 = time.time()
            states, server = self.round_segment(
                states, server, batches_q, draws.steps[t:t + n_steps],
                n_steps=n_steps, sync_first=r > 0)
            devices.fence(self.device)
            dt = time.time() - r0
            self._log_round(res, dt)
            t += n_steps
            samples += n_steps * (fed.neumann_k + 2)
            if r > 0:
                comms += 1
                up, down = agg.wire_round(msg_b, down_b, tx=self.n_clients,
                                          rx=self.n_clients)
                bytes_up += up
                bytes_down += down
            if r % eval_rounds == 0 or r == len(lengths) - 1:
                self._record(res, states, t - 1, samples, comms, bytes_up,
                             bytes_down)
        res.seconds = time.time() - t0
        res.final_avg_state = tree_mean_axis0(states)
        return res
