"""Synthetic open-loop load generation for the serve engine, request for
request as the JAX package's (``src/repro/serve/loadgen.py``): numpy only,
so a seed gives the same requests in both packages.

Requests arrive on a Poisson process (exponential inter-arrival gaps at
``rate`` req/s), prompts draw from a discrete length-bucket distribution,
and generation budgets draw from a clipped geometric. ``replay`` drives an
engine open-loop against the wall clock: a request enters the queue at its
arrival time whether or not the engine has kept up, so overload shows up
as queue growth and latency blow-up. ``rate=0`` submits everything at once
(the max-throughput measurement).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.engine import Completion, Engine, Request


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """Open-loop workload: ``n_requests`` at ``rate`` req/s (0 = all at
    t=0), prompt lengths drawn from ``prompt_lens`` with optional
    ``prompt_weights``, output budgets ~ min(1 + Geom(1/mean_new_tokens),
    ``max_new_cap``)."""
    n_requests: int = 32
    rate: float = 0.0
    prompt_lens: Tuple[int, ...] = (8, 16, 32)
    prompt_weights: Optional[Tuple[float, ...]] = None
    mean_new_tokens: float = 16.0
    max_new_cap: int = 64
    seed: int = 0


def generate_requests(spec: LoadSpec, vocab: int, *,
                      enc_shape: Optional[Tuple[int, int]] = None,
                      prefix_shape: Optional[Tuple[int, int]] = None,
                      ) -> List[Request]:
    """Materialize the workload: token prompts over ``vocab``, arrival
    offsets, budgets. ``enc_shape``/``prefix_shape`` ([len, d_model]) add
    random encoder/prefix embeddings for encdec/VLM archs."""
    rng = np.random.default_rng(spec.seed)
    gaps = (rng.exponential(1.0 / spec.rate, spec.n_requests)
            if spec.rate > 0 else np.zeros(spec.n_requests))
    arrivals = np.cumsum(gaps)
    weights = spec.prompt_weights
    if weights is not None:
        weights = np.asarray(weights, np.float64)
        weights = weights / weights.sum()
    lens = rng.choice(np.asarray(spec.prompt_lens), size=spec.n_requests,
                      p=weights)
    mean = max(spec.mean_new_tokens, 1.0)
    budgets = np.minimum(1 + rng.geometric(1.0 / mean, spec.n_requests),
                         spec.max_new_cap)
    reqs = []
    for i in range(spec.n_requests):
        extras = {}
        if enc_shape is not None:
            extras["enc_embeds"] = rng.standard_normal(
                enc_shape).astype(np.float32)
        if prefix_shape is not None:
            extras["prefix_embeds"] = rng.standard_normal(
                prefix_shape).astype(np.float32)
        reqs.append(Request(
            rid=i,
            tokens=rng.integers(0, vocab, int(lens[i])).astype(np.int32),
            max_new_tokens=int(budgets[i]),
            arrival_s=float(arrivals[i]),
            **extras))
    return reqs


def replay(engine: Engine, requests: Sequence[Request],
           ) -> List[Completion]:
    """Open-loop replay: submit each request when the engine clock reaches
    its ``arrival_s``, tick whenever there is admitted work, drain fully.
    Returns completions (engine-clock timestamps; latency_s measures
    arrival -> finish)."""
    pending = sorted(requests, key=lambda r: r.arrival_s)
    i = 0
    done: List[Completion] = []
    engine.start_clock()
    while i < len(pending) or engine.has_work:
        now = engine.now()
        while i < len(pending) and pending[i].arrival_s <= now:
            engine.submit(pending[i])
            i += 1
        if engine.has_work:
            done.extend(engine.step())
        elif i < len(pending):
            time.sleep(min(pending[i].arrival_s - engine.now(), 0.01))
    return done
