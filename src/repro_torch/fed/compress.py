"""Wire-byte accounting of client→server updates.

Only the full-precision ``none`` codec is ported: a message is the client's
state as it is, so uplink and downlink both cost :func:`state_bytes`. The
lossy codecs (int8, top-k, with error feedback) come with the population
and codec slice.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.tree_util import tree_leaves


def state_bytes(tree) -> int:
    """Uncompressed wire size of one client-state tree: Σ_leaf size ·
    itemsize."""
    return sum(l.numel() * l.element_size() for l in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class Codec:
    """The full-precision client→server codec."""
    name: str = "none"

    def message_bytes(self, tree) -> int:
        """Exact uplink cost of one client→server message."""
        return state_bytes(tree)

    def down_bytes(self, tree) -> int:
        """Downlink cost per receiving client (broadcast is uncompressed)."""
        return state_bytes(tree)


def codec_from_config(fed) -> Codec:
    if fed.codec != "none":
        raise NotImplementedError(
            f"codec={fed.codec!r} is not ported yet: the lossy codecs come "
            f"with the population and codec slice (slice 2)")
    return Codec()


def wire_costs(codec: Codec, stacked_states) -> Tuple[int, int]:
    """(uplink bytes per client→server message, downlink bytes per
    receiving client) for ONE client of a stacked [M, ...] state tree."""
    one = [l[0] for l in tree_leaves(stacked_states)]
    return codec.message_bytes(one), codec.down_bytes(one)
