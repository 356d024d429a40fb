"""The sync layer: the paper's star server behind the ``Aggregator``
contract (``combine`` / ``server_step`` / ``reduce`` / ``messages`` /
``wire_round``).

Only the star topology is ported; decentralized gossip comes with the
federated-runtime slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.tree_util import tree_map, tree_mean_axis0
from repro_torch.fed.compress import Codec, client_messages


def weighted_mean(states, w: torch.Tensor):
    """Convex combination over the leading client axis: ``Σ_i w_i ·
    state_i`` per leaf, computed in f32 and cast back to the leaf dtype
    (``w`` is a [C] weight vector)."""
    return tree_map(
        lambda a: torch.tensordot(w, a.float(), dims=1).to(a.dtype), states)


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
