"""Round engine: q local steps then the sync, as one call per round, and the
mega-scan tier: R whole rounds as one call per chunk.

AdaFBiO's communication saving is structural: q local steps per sync round
(paper §4, Remark 2). The scan engine (``FedDriver.round_segment``) runs a
whole round over the q per-step batches and draws, stacked on a leading axis
by :func:`stack_round_batches`. The step counter ``t`` rides in the server
state as a device tensor, exactly as the eager loop carries it, so both
engines see the same schedules and draws. The gossip engine's round
(:func:`repro_torch.fed.topology.make_gossip_round`) takes the same shape.

A mega-scan chunk (:func:`make_multi_round`, ``rounds_per_scan`` R) is one
host call that runs R whole rounds back to back on the current stream. Its
inputs are staged on the device before it starts (the ``[R, q, ...]``
batches, the ``[R, q, C]`` Neumann depths, the ``[R, C]`` cohorts or
``[R, M]`` masks, and the rounds' noise sources); it reads nothing back to
the host between its first and its last round, and it returns the rounds'
outputs stacked on a leading R axis, which the host reads once a chunk.
There is no CUDA graph: each round queues the same operations as a
single-round call, so a chunk equals R single rounds bit for bit.
:func:`chunk_calls` is the host side of a run of chunks, which the driver
and the launcher share: the spans, the fence and the one read a chunk.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List

import torch
from torch.profiler import record_function

from repro_torch import device as devices
from repro_torch.core.tree_util import tree_leaves, tree_map, tree_stack

ENGINES = ("eager", "scan", "gossip")


def stack_round_batches(batch_fn: Callable[[int], Any], t0: int, q: int):
    """Stack ``batch_fn(t0) .. batch_fn(t0+q-1)`` on a new leading axis —
    the layout ``FedDriver.round_segment`` expects."""
    return tree_stack([batch_fn(t0 + j) for j in range(q)])


def stack_chunk_batches(batch_fn: Callable[[int], Any], t0: int, q: int,
                        rounds: int):
    """The ``[R, q, ...]`` batches of ``rounds`` whole rounds from step
    ``t0``: round j's :func:`stack_round_batches` on a new leading axis."""
    return tree_stack([stack_round_batches(batch_fn, t0 + j * q, q)
                       for j in range(rounds)])


def per_round(x, i: int):
    """Round ``i``'s entry of a chunk input: None stays None, a list is a
    sequence of per-round entries (noise sources, say), a tensor is stacked
    on a leading round axis, and tuples and dicts hold such entries."""
    if x is None:
        return None
    if isinstance(x, list):
        return x[i]
    if isinstance(x, tuple):
        return tuple(per_round(e, i) for e in x)
    if isinstance(x, dict):
        return {k: per_round(v, i) for k, v in x.items()}
    return x[i]


def stack_outs(outs: List[Any]):
    """Per-round outputs stacked on a new leading axis, leaf by leaf; a
    None output (or leaf) stays None."""
    if not outs or outs[0] is None:
        return None
    return tree_map(lambda *xs: None if xs[0] is None else torch.stack(xs),
                    *outs)


def make_multi_round(round_fn: Callable) -> Callable:
    """Fuse R whole rounds into one call (the mega-scan tier).

    ``round_fn(carry, ids, batches_q, draws, round_id) -> (carry, out)`` is
    a complete communication round over an opaque ``carry``. ``ids`` is
    any per-round input (cohort ids, participation masks, None), ``draws``
    the round's random inputs (its Neumann depths, its noise source) and
    ``out`` the per-round output (stat rows; None is fine).

    Returns ``multi(carry, ids_R, batches_R, draws_R, round0) -> (carry,
    outs)``, which runs rounds ``round0 .. round0 + R - 1`` back to back, R
    the leading axis of ``batches_R``: round i gets :func:`per_round` ``(x,
    i)`` of ``ids_R``, ``batches_R`` and ``draws_R`` and the absolute
    ``round_id = round0 + i``, and ``outs`` stacks the per-round ``out``
    (:func:`stack_outs`). Nothing in the call reads the device back; R = 1
    is exactly one ``round_fn`` call.
    """
    def multi(carry, ids_R, batches_R, draws_R, round0: int):
        outs = []
        with record_function("megascan"):
            for i in range(tree_leaves(batches_R)[0].shape[0]):
                carry, out = round_fn(carry, per_round(ids_R, i),
                                      per_round(batches_R, i),
                                      per_round(draws_R, i), round0 + i)
                outs.append(out)
        return carry, stack_outs(outs)

    return multi


def chunk_plan(lengths: List[int], q: int, rounds_per_scan: int, *,
               peel_first: bool = True):
    """The chunks of a run of rounds ``lengths`` (``[q] * full + [rem]``):
    ``(r, L)`` pairs, L rounds from round r. Whole rounds chunk by up to
    ``rounds_per_scan``; round 0 (no sync before it) peels off as a chunk
    of one when ``peel_first``, and so does a trailing partial round."""
    full = sum(1 for n in lengths if n == q)
    plan, r = [], 0
    while r < len(lengths):
        whole = lengths[r] == q and (r > 0 or not peel_first)
        L = min(rounds_per_scan, full - r) if whole else 1
        plan.append((r, L))
        r += L
    return plan


def chunk_calls(plan, tele, device, *, stage: Callable, call: Callable):
    """Run the chunks of ``plan`` (``(r, L)`` pairs, :func:`chunk_plan`)
    one after the other: ``stage(r, L)`` stages a chunk's inputs on the
    device (the ``batch_build`` span), ``call(staged, r, L)`` queues its L
    rounds and returns ``(kept, outs)`` (the ``round_program`` span, which
    ends at the device fence), and ``outs``, the rounds' stacked outputs
    the host needs (None: none), comes back in the chunk's one host read.
    Yields ``(r, L, staged, kept, host, dt)``, ``dt`` the chunk's
    wall-clock; the caller drops what it keeps of a chunk before the
    next."""
    for r, L in plan:
        with tele.span("batch_build"):
            staged = stage(r, L)
        r0 = time.time()
        with tele.span("round_program"):
            kept, outs = call(staged, r, L)
            devices.fence(device)
        dt = time.time() - r0
        host = (None if outs is None
                else tree_map(lambda v: v.cpu().numpy(), outs))
        yield r, L, staged, kept, host, dt
        # a round takes its input dicts, as JAX donates buffers; what this
        # frame still held of the chunk would stay alive beside the next
        del staged, kept, outs
