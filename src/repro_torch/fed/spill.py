"""Host-spill tier for dormant client bank rows (``src/repro/fed/spill.py``).

A population bank holds N client states, and on one card N is capped by
the card's memory: at qwen1.5-4b's full depth one row (x, y, v and w in
bf16) is 15.8 GB, so a dense bank of two does not fit beside a client's
working set. Only the round's cohort of C rows needs to be on the card;
the other N - C rows are dormant until sampled. :class:`HostSpillBank`
keeps every row in host memory and moves exactly the cohort each round:

  * :meth:`HostSpillBank.gather` copies the C sampled rows to the device
    (the round program is :func:`repro_torch.fed.population.
    make_cohort_round`: the dense round's local steps, aggregate and server
    step without the bank);
  * the write-back is on the host. :meth:`~HostSpillBank.scatter` writes
    cohort rows, duplicate ids last-wins as the dense bank's ``scatter``;
    :meth:`~HostSpillBank.broadcast` (the broadcast sync: every row := the
    new global state) is lazy: one ``base`` state plus a per-row ``fresh``
    mask instead of N row copies, so the host's work a round stays O(C);
  * :meth:`~HostSpillBank.prefetch` starts the next cohort's copy early, on
    a side stream, so that it overlaps the host's batch building; the
    :meth:`~HostSpillBank.gather` with the same ids consumes it.

Where the bank serves a CUDA device its rows are page-locked host memory:
one allocation a bank (and one for ``base``) of its exact size from the
CUDA driver (``cuMemHostAlloc``), every leaf a view into it, freed when
the last tensor viewing it goes. The caching allocator behind
``pin_memory=True`` pins faster, but rounds each block up to a power of
two (a 17.5 GB EF bank would take 34.4 GB) and keeps freed blocks pinned
for reuse (``scripts/pin_times.py`` times the ways). A failed allocation
raises. For the CPU the rows are ordinary tensors.

Two traps of pinned copies. A slice of a pinned tensor is pinned, but an
indexed gather (``rows[ids]``) is a new pageable tensor, whose
``.to(cuda, non_blocking=True)`` runs synchronously and slowly: every copy
here goes row by row from pinned slices. And a copy from pinned memory
reads it after the call returns: every write to the rows (``scatter``,
``broadcast``) first waits for the copies still reading them (the events
recorded after each gather and prefetch), and every copy from the device
into them synchronises before the host reads the rows.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.checkpoint.ckpt import LazyRows
from repro_torch.core.tree_util import (tree_leaves, tree_map,
                                        tree_structure, tree_unflatten)

_ALIGN = 64          # bytes between the leaves of one host allocation


def _last_wins_mask(ids: np.ndarray) -> np.ndarray:
    """bool [C]: True at the LAST slot of each distinct id, the slots whose
    values a deterministic duplicate-resolving scatter writes."""
    c = ids.shape[0]
    _, first_of_reversed = np.unique(ids[::-1], return_index=True)
    keep = np.zeros(c, bool)
    keep[c - 1 - first_of_reversed] = True
    return keep


def _ids(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return np.asarray(ids, np.int64).reshape(-1)


_driver_lib = None
_CU_MEMHOSTALLOC_PORTABLE = 0x01


def _driver() -> ctypes.CDLL:
    global _driver_lib
    if _driver_lib is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuMemHostAlloc.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                       ctypes.c_size_t, ctypes.c_uint]
        lib.cuMemHostAlloc.restype = ctypes.c_int
        lib.cuMemFreeHost.argtypes = [ctypes.c_void_p]
        lib.cuMemFreeHost.restype = ctypes.c_int
        lib.cuCtxSynchronize.restype = ctypes.c_int
        _driver_lib = lib
    return _driver_lib


def _pinned_bytes(nbytes: int) -> torch.Tensor:
    """uint8 [nbytes] of page-locked host memory from the CUDA driver. The
    tensor's storage holds the object that owns the allocation, so the
    memory is freed only when the last view of it goes, and then after the
    card has finished what was queued (a copy may still read it). Neither
    driver call raises there: at exit the context may be gone already."""
    torch.cuda.init()              # the primary context must be current
    ptr = ctypes.c_void_p()
    err = _driver().cuMemHostAlloc(ctypes.byref(ptr), nbytes,
                                   _CU_MEMHOSTALLOC_PORTABLE)
    if err != 0:
        raise RuntimeError(f"cuMemHostAlloc of {nbytes} bytes failed "
                           f"(CUresult {err})")

    class _Owner(ctypes.c_uint8 * nbytes):
        def __del__(self, addr=ptr.value):
            _driver().cuCtxSynchronize()
            _driver().cuMemFreeHost(addr)
    return torch.frombuffer(_Owner.from_address(ptr.value), dtype=torch.uint8)


def _host_tree(like, pinned: bool):
    """Host tensors shaped and typed as the leaves of ``like`` (tensors or
    ``TensorSpec``), all views into one allocation (page-locked when
    ``pinned``). Returns ``(tree, allocation)``."""
    leaves = tree_leaves(like)
    sizes = [math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
             for s in leaves]
    offsets, end = [], 0
    for nb in sizes:
        end = -(-end // _ALIGN) * _ALIGN
        offsets.append(end)
        end += nb
    buf = (_pinned_bytes(max(end, 1)) if pinned
           else torch.empty(max(end, 1), dtype=torch.uint8))
    out = [buf[off:off + nb].view(s.dtype).view(tuple(s.shape))
           for s, off, nb in zip(leaves, offsets, sizes)]
    return tree_unflatten(tree_structure(like), out), buf


@dataclasses.dataclass
class HostSpillBank:
    """[N, ...] bank rows resident in host memory; cohorts travel to
    ``device`` on demand.

    ``rows`` holds every leaf as a host tensor with leading axis N (pinned
    where ``device`` is CUDA). ``base``/``fresh`` implement the lazy
    broadcast: row i's value is ``rows[i]`` when ``fresh[i]``, else
    ``base`` (the last broadcast state, in the rows' dtypes). ``base`` is
    None only before the first broadcast, when every row is fresh.
    Build one with :meth:`allocate` or :meth:`from_device`.
    """
    rows: Any                       # tree of host tensors [N, ...]
    n: int
    device: Any = "cpu"             # where gathered cohorts go
    base: Optional[Any] = None      # tree of host tensors [...]
    fresh: Optional[np.ndarray] = None   # bool [N]

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.fresh is None:
            self.fresh = np.ones(self.n, bool)
        self._prefetched: Optional[tuple] = None   # (ids, tree, event)
        self._reading: List[Any] = []   # events of copies reading the rows
        self._stream = None
        if self.pinned and not all(t.is_pinned()
                                   for t in tree_leaves(self.rows)):
            raise ValueError("a bank serving a CUDA device keeps its rows in "
                             "pinned host memory: build it with "
                             "HostSpillBank.allocate or from_device")

    @property
    def pinned(self) -> bool:
        return self.device.type == "cuda"

    @classmethod
    def allocate(cls, like, device="cpu", zero: bool = False
                 ) -> "HostSpillBank":
        """A bank shaped as ``like`` (tensors or ``TensorSpec`` with the
        leading N), in one host allocation, pinned when ``device`` is CUDA.
        Its rows are uninitialised unless ``zero``: write every row
        (:meth:`scatter`) before reading one."""
        device = torch.device(device)
        rows, buf = _host_tree(like, device.type == "cuda")
        if zero:
            buf.zero_()
        return cls(rows=rows, n=tree_leaves(like)[0].shape[0], device=device)

    @classmethod
    def from_device(cls, bank, device=None) -> "HostSpillBank":
        """A host bank holding a copy of the stacked ``bank`` tree (on any
        device; ``device`` defaults to the bank's own)."""
        leaves = tree_leaves(bank)
        out = cls.allocate(bank, leaves[0].device if device is None
                           else device)
        for dst, src in zip(tree_leaves(out.rows), leaves):
            dst.copy_(src, non_blocking=True)
        out._settle(leaves)
        return out

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self.rows))

    # -------------------------------------------------- synchronisation

    def _copy_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _wait_reads(self) -> None:
        """Block the host until no copy still reads the rows or ``base``."""
        for ev in self._reading:
            ev.synchronize()
        self._reading.clear()

    def _settle(self, values) -> None:
        """Wait for copies from the device into the host rows (queued on
        the current stream) before the host reads them."""
        devs = {t.device for t in tree_leaves(values)
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
        for d in devs:
            torch.cuda.current_stream(d).synchronize()

    def _before_write(self) -> None:
        """Any bank write drops the prefetch (the rows may change) and
        waits for the copies in flight that read them."""
        self._prefetched = None
        self._wait_reads()

    # -------------------------------------------------- reads

    def _base_leaves(self) -> list:
        """``base``'s leaves in the rows' order, or None for each."""
        if self.base is None:
            return [None] * len(tree_leaves(self.rows))
        return tree_leaves(self.base)

    def _copy_in(self, ids: np.ndarray):
        """The cohort rows [C, ...] on the device, each slot copied from its
        pinned row (or from ``base`` where the row is stale) on the current
        stream; records the event that a write waits for."""
        out = []
        for rows_leaf, base_leaf in zip(tree_leaves(self.rows),
                                        self._base_leaves()):
            dst = torch.empty((len(ids),) + tuple(rows_leaf.shape[1:]),
                              dtype=rows_leaf.dtype, device=self.device)
            for j, i in enumerate(ids):
                src = (rows_leaf[i] if base_leaf is None or self.fresh[i]
                       else base_leaf)
                dst[j].copy_(src, non_blocking=True)
            out.append(dst)
        if self.pinned:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._reading.append(ev)
        return tree_unflatten(tree_structure(self.rows), out)

    def gather(self, ids):
        """The cohort rows on the device ([C, ...] tree). Consumes the
        matching :meth:`prefetch` result when one is pending: the current
        stream waits for its copies, and its tensors are marked as used on
        that stream."""
        with record_function("spill_gather"):
            ids = _ids(ids)
            if self._prefetched is not None:
                key, tree, event = self._prefetched
                self._prefetched = None
                if np.array_equal(key, ids):
                    if event is not None:
                        stream = torch.cuda.current_stream(self.device)
                        stream.wait_event(event)
                        for t in tree_leaves(tree):
                            t.record_stream(stream)
                    return tree
            return self._copy_in(ids)

    def prefetch(self, ids) -> None:
        """Start the copy of a FUTURE cohort: on a CUDA device on the bank's
        side stream, so that it overlaps whatever host work follows; the
        next :meth:`gather` with the same ids consumes it. Any bank write
        drops the prefetch (the rows may have changed)."""
        with record_function("spill_prefetch"):
            ids = _ids(ids)
            if not self.pinned:
                self._prefetched = (ids, self._copy_in(ids), None)
                return
            with torch.cuda.stream(self._copy_stream()):
                tree = self._copy_in(ids)
            self._prefetched = (ids, tree, self._reading[-1])

    # -------------------------------------------------- writes

    def scatter(self, ids, values) -> None:
        """Write cohort rows back on the host. Duplicate ids resolve
        last-wins, as :func:`repro_torch.fed.population.scatter`."""
        with record_function("spill_scatter"):
            ids = _ids(ids)
            self._before_write()
            keep = _last_wins_mask(ids)
            slots = np.nonzero(keep)[0]
            for rows_leaf, vals in zip(tree_leaves(self.rows),
                                       tree_leaves(values)):
                for j in slots:
                    rows_leaf[ids[j]].copy_(vals[j], non_blocking=True)
            self._settle(values)
            self.fresh[ids[keep]] = True

    def broadcast(self, value) -> None:
        """Every row := one client state, lazily: it becomes ``base`` and
        the ``fresh`` mask clears, instead of N row writes."""
        self._before_write()
        if self.base is None:
            self.base, _ = _host_tree(tree_map(lambda r: r[0], self.rows),
                                      self.pinned)
        for dst, src in zip(tree_leaves(self.base), tree_leaves(value)):
            dst.copy_(src, non_blocking=True)
        self._settle(value)
        self.fresh[:] = False

    # -------------------------------------------------- the dense view

    def _rows(self, rows_leaf, base_leaf, lo: int, hi: int) -> torch.Tensor:
        out = rows_leaf[lo:hi].clone()
        if base_leaf is not None:
            stale = torch.from_numpy(~self.fresh[lo:hi])
            if bool(stale.any()):
                out[stale] = base_leaf
        return out

    def lazy_leaves(self):
        """The bank as a tree of :class:`repro_torch.checkpoint.ckpt.
        LazyRows` leaves: ``save_checkpoint(..., shards=K)`` then pulls one
        shard's row range at a time, so a spilled checkpoint never builds
        the dense [N, ...] bank (the extra host memory is one shard's)."""
        out = [LazyRows(lambda lo, hi, r=r, b=b: self._rows(r, b, lo, hi),
                        tuple(r.shape), r.dtype)
               for r, b in zip(tree_leaves(self.rows), self._base_leaves())]
        return tree_unflatten(tree_structure(self.rows), out)

    def materialize(self):
        """The full dense [N, ...] bank on the host (checkpoints and parity
        checks): the only O(N state) host copy besides construction."""
        return tree_map(lambda lz: lz.fetch(0, self.n), self.lazy_leaves())
