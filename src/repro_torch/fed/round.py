"""Round engine: q local steps then the sync, as one call per round.

AdaFBiO's communication saving is structural: q local steps per sync round
(paper §4, Remark 2). The scan engine (``FedDriver.round_segment``) runs a
whole round over the q per-step batches and draws, stacked on a leading axis
by :func:`stack_round_batches`. The step counter ``t`` rides in the server
state as a device tensor, exactly as the eager loop carries it, so both
engines see the same schedules and draws. The gossip engine's round
(:func:`repro_torch.fed.topology.make_gossip_round`) takes the same shape.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.core.tree_util import tree_stack

ENGINES = ("eager", "scan", "gossip")


def stack_round_batches(batch_fn: Callable[[int], Any], t0: int, q: int):
    """Stack ``batch_fn(t0) .. batch_fn(t0+q-1)`` on a new leading axis —
    the layout ``FedDriver.round_segment`` expects."""
    return tree_stack([batch_fn(t0 + j) for j in range(q)])
