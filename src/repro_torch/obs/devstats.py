"""On-device per-round stats, drained every K rounds
(``src/repro/obs/devstats.py``).

The round loops are host loops, and reading a scalar a round would wait for
the device a round. :class:`StatAccum` keeps a ``[K, S]`` f32 ring on the
states' device and writes one row of scalars a round, computed on the
device from the round's output states; nothing crosses to the host until
every K rounds (``--metrics-every``) the ring is drained with one host
copy and handed to the bus as a ``stats`` record.

The stats are a separate computation on each round's output states, never
part of the round: a round runs the same operations with telemetry on or
off, so the trajectory is the same bit for bit.

Fields (the buffer's column order):

  global_norm   ‖avg(states)‖ over every state leaf (x, y, v, w)
  update_norm   ‖avg_t − avg_{t−1}‖, the round's server update
  consensus     opt-in: Σ_θ (1/M)Σ_m ‖θ^m − θ̄‖² (Lemmas 20-21's quantity)

Mega-scan chunks (``rounds_per_scan`` R) write their rows with
:class:`ChunkStats`: a row a round, computed on the device inside the
chunk, and one ``stats`` record a chunk with the chunk's rows. The O(N)
consensus column stays out of a chunk (the reference keeps it out of its
fused program): the driver refuses it with R > 1.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.metrics import consensus_error
from repro_torch.core.tree_util import tree_leaves, tree_map, tree_mean_axis0

# the column order of a stat row without the opt-in consensus column
STAT_FIELDS = ("global_norm", "update_norm")


def _own(tree):
    """``tree`` with every view copied: the client mean of one row is a
    view into the states, which a later round may free or overwrite."""
    return tree_map(lambda t: t.clone() if t._base is not None else t, tree)


def _sqdot(t):
    f = t.reshape(-1).float()
    return torch.dot(f, f)


def _row(states, prev_avg, consensus, keep):
    """A stat row computed leaf by leaf, so that no model-sized temporary
    exists beyond one leaf's: each leaf's client mean and its difference
    from ``prev_avg``'s leaf are summed (in f32, in leaf order, as
    ``tree_sqnorm``) and then handed to ``keep(prev_leaf, mean_leaf)``,
    whose results make the returned mean tree."""
    g = u = None

    def leaf(x, p):
        nonlocal g, u
        a = x[0] if x.shape[0] == 1 else x.mean(dim=0)
        ga, ua = _sqdot(a), _sqdot(a - p)
        g = ga if g is None else g + ga
        u = ua if u is None else u + ua
        return keep(p, a)

    with torch.no_grad():
        avg = tree_map(leaf, states, prev_avg)
        cols = [torch.sqrt(g), torch.sqrt(u)]
        if consensus:
            cols.append(sum(consensus_error(states).values()))
        return torch.stack([c.float() for c in cols]), avg


def stat_row(states, prev_avg, consensus: bool = False):
    """One ``[S]`` f32 stat row for a state tree with a leading client axis
    against the previous round's client mean: ``(row, new_avg)``."""
    return _row(states, prev_avg, consensus, lambda p, a: a)


class StatAccum:
    """A device-resident ``[K, S]`` scalar ring.

    Usage (one a run)::

        acc = StatAccum.create(states, k=8, consensus=False)
        for r in range(rounds):
            states = round_fn(states, ...)
            acc.update(states)            # device work only, no host read
            if acc.ready:
                tele.stats(**acc.drain())  # one host copy every k rounds
        if acc.pending:
            tele.stats(**acc.drain())      # the partial tail window
    """

    def __init__(self, k: int, fields: Tuple[str, ...], buf: torch.Tensor,
                 prev, consensus: bool):
        self.k = k
        self.fields = fields
        self.consensus = consensus
        self._buf = buf
        self._prev = prev
        self._slot = 0            # the ring's next row (host-side)
        self.pending = 0          # rows written since the last drain
        self._round0 = 0          # round id of the first pending row

    @classmethod
    def create(cls, states, k: int, consensus: bool = False) -> "StatAccum":
        """The ring for a state tree with a leading client axis, on its
        device. ``k`` is the drain window (``--metrics-every``)."""
        if k < 1:
            raise ValueError(f"stat window must be >= 1, got {k}")
        fields = STAT_FIELDS + (("consensus",) if consensus else ())
        dev = tree_leaves(states)[0].device
        buf = torch.zeros((k, len(fields)), dtype=torch.float32, device=dev)
        with torch.no_grad():
            prev = _own(tree_mean_axis0(states))
        return cls(k, fields, buf, prev, consensus)

    def update(self, states) -> None:
        """Write this round's row from its output states; nothing is read
        back to the host."""
        # the new mean is written over the old one leaf by leaf: the ring
        # keeps one model-sized mean, never two
        row, _ = _row(states, self._prev, self.consensus,
                      lambda p, a: p.copy_(a))
        self._buf[self._slot].copy_(row)
        self._slot = (self._slot + 1) % self.k
        self.pending += 1

    @property
    def ready(self) -> bool:
        return self.pending >= self.k

    @classmethod
    def for_bus(cls, tele, states) -> Optional["StatAccum"]:
        """The ring of a run on the bus ``tele``, or None when it has no
        sink: ``tele.metrics_every`` rows, the consensus column on
        request."""
        if not tele.sinks:
            return None
        return cls.create(states, tele.metrics_every, tele.consensus)

    def drain(self) -> Dict[str, Any]:
        """One host copy of the ring: ``round_start`` and a list a field
        (the pending rows' columns, oldest first)."""
        buf = self._buf.cpu()
        n = self.pending
        rows = buf[[(self._slot - n + j) % self.k for j in range(n)]]
        out: Dict[str, Any] = {"round_start": self._round0}
        for c, name in enumerate(self.fields):
            out[name] = [float(v) for v in rows[:, c]]
        self._round0 += n
        self.pending = 0
        return out


class ChunkStats:
    """The stat rows of a run in mega-scan chunks, as the reference's
    ``_mega_obs``: :meth:`row` writes one round's row on the device from
    its output states (no host read; called inside a chunk, after each
    round), and :meth:`drain` hands a chunk's rows to the bus as one
    ``stats`` record, ``round_start`` its first round, with one host copy.
    Without a sink both do nothing, so a run computes no row."""

    def __init__(self, tele, states):
        if tele.sinks and tele.consensus:
            raise ValueError(
                "rounds_per_scan > 1 cannot fold the O(N) consensus stat "
                "into the mega-scan program; run with rounds_per_scan=1 "
                "or telemetry consensus=False")
        self.tele = tele
        self.round0 = 0
        self._prev = None
        if tele.sinks:
            with torch.no_grad():
                self._prev = _own(tree_mean_axis0(states))

    def row(self, states) -> Optional[torch.Tensor]:
        """This round's ``[2]`` row (global_norm, update_norm) on the
        device, or None without a sink."""
        if self._prev is None:
            return None
        row, _ = _row(states, self._prev, False, lambda p, a: p.copy_(a))
        return row

    def drain(self, rows: Optional[torch.Tensor], n_rounds: int) -> None:
        """A chunk's ``[L, 2]`` rows as one ``stats`` record (one host
        copy); ``n_rounds`` advances the next record's ``round_start``."""
        if rows is not None:
            arr = rows.cpu()
            self.tele.stats(round_start=self.round0,
                            global_norm=[float(v) for v in arr[:, 0]],
                            update_norm=[float(v) for v in arr[:, 1]])
        self.round0 += n_rounds


def ring_update(tele, acc: Optional[StatAccum], states) -> None:
    """A round's row into ``acc`` (None: no ring), drained to ``tele``
    when the window is full."""
    if acc is not None:
        acc.update(states)
        if acc.ready:
            tele.stats(**acc.drain())


def ring_close(tele, acc: Optional[StatAccum]) -> None:
    """Drain the partial tail window."""
    if acc is not None and acc.pending:
        tele.stats(**acc.drain())
