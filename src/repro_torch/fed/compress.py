"""Client→server update codecs with error feedback, and wire-byte
accounting.

What a codec compresses: the client→server message of one sync. Client i
finished its local steps at state ``cur_i`` starting from ``ref_i``, the
state the server last handed it, so the message only needs the update
``Δ_i = cur_i − ref_i``. With error feedback (EF-SGD) the client adds its
residual ``e_i`` before encoding and keeps what the codec dropped::

    sent_i  = decode(encode(Δ_i + e_i))        # what the server sees
    e_i'    = (Δ_i + e_i) − sent_i             # kept for the next sync
    recon_i = ref_i + sent_i                   # server-side reconstruction

Three codecs, as in the JAX package:

  none   the message is the state itself; ``client_messages`` returns its
         inputs untouched.
  int8   stochastic uniform quantization to ``bits``-bit levels, one f32
         scale per leaf per client. The cohort's message goes leaf by leaf:
         each leaf's ``[C, size]`` delta through one quantize and one
         dequantize launch over the C rows
         (:func:`repro_torch.kernels.ops.int8_roundtrip`), 2 launches a
         leaf a sync.
  topk   per-leaf, per-client magnitude sparsification keeping
         ``round(topk_frac · size)`` entries (at least 1).

Leaf by leaf, as the reference goes (one ``quantize_stoch`` and one
``dequantize`` a leaf), the working set of a message is one leaf's f32
delta, noise, levels and reconstruction: nothing of the size of the whole
state is formed in f32 (at language-model width one f32 copy of a client
state is 9-32 GB). The values are those of packing the message into one
``[C, n]`` f32 buffer and cutting it into leaf segments: the same
per-(client, leaf) scale, the same f32 operations element by element, one
rounding into each leaf's dtype.

The rounding noise of int8 is an input: ``client_messages`` takes a noise
source ``u(leaf, size) -> [C, size]`` f32 uniform[0, 1), called once per
leaf in leaf order. :class:`CodecNoise` draws it on the device from a
generator seeded by the run's seed, the round and the leaf; the parity
tests fill it from the reference's key chain (one key per client and
leaf).

Bytes (the reference's documented formulas, per client message):

  state_bytes(tree)            = Σ_leaf size · itemsize
  none:  message_bytes(tree)   = state_bytes(tree)
  int8:  message_bytes(tree)   = Σ_leaf ceil(size · bits / 8) + 4
  topk:  message_bytes(tree)   = Σ_leaf k_leaf · (4 + 4)

The server→client broadcast is not compressed: one downlink costs
``state_bytes`` per receiving client.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch import device as devices
from repro_torch.configs.base import validate_codec
from repro_torch.core.tree_util import (tree_leaves, tree_map,
                                        tree_structure, tree_unflatten)
from repro_torch.kernels import ops

# seed salt of the rounding noise, apart from every other stream of a run
_CODEC_SALT = 0xC0DEC


def _leaf_k(size: int, frac: float) -> int:
    """Entries the topk codec keeps in a ``size``-element tensor."""
    return min(max(int(round(frac * size)), 1), size)


def state_bytes(tree) -> int:
    """Uncompressed wire size of one client-state tree: Σ_leaf size ·
    itemsize."""
    return sum(l.numel() * l.element_size() for l in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class Codec:
    """One client→server update codec (module docstring). Build one with
    :func:`make_codec`, which validates."""
    name: str = "none"
    bits: int = 8
    topk_frac: float = 0.1
    error_feedback: bool = True

    @property
    def lossy(self) -> bool:
        return self.name != "none"

    @property
    def stateful(self) -> bool:
        """True when per-client EF residuals persist across rounds."""
        return self.lossy and self.error_feedback

    @property
    def qmax(self) -> int:
        """Largest quantization level: 2^(bits-1) - 1 (127 at 8 bits)."""
        return (1 << (self.bits - 1)) - 1

    # -------------------------------------------------- the lossy identity

    def roundtrip_leaf(self, flat: torch.Tensor,
                       u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """decode(encode(·)) of one leaf's ``[C, size]`` f32 rows under a
        lossy codec (a new tensor, ``flat`` is left as it is); ``u`` is the
        int8 codec's ``[C, size]`` noise."""
        if self.name == "int8":
            if u is None:
                raise ValueError("the int8 codec needs its rounding noise u")
            return ops.int8_roundtrip(flat, u, self.qmax)
        k = _leaf_k(flat.shape[1], self.topk_frac)
        if k == flat.shape[1]:
            return flat.clone()
        idx = torch.topk(flat.abs(), k, dim=1).indices
        return torch.zeros_like(flat).scatter(1, idx, flat.gather(1, idx))

    def leaf_noise(self, u, i: int, size: int) -> Optional[torch.Tensor]:
        """Leaf ``i``'s ``[C, size]`` noise from the source ``u``; None for
        the codecs that draw none."""
        if self.name != "int8" or u is None:
            return None
        return u(i, size)

    def roundtrip(self, tree, u=None):
        """decode(encode(tree)) per client of a client-stacked ``[C, ...]``
        update tree, leaf by leaf; f32 leaves out. ``u`` is the int8
        codec's noise source (module docstring)."""
        if not self.lossy:
            return tree
        leaves = tree_leaves(tree)
        out = []
        for i, leaf in enumerate(leaves):
            flat = leaf.reshape(leaf.shape[0], -1).float()
            out.append(self.roundtrip_leaf(
                flat, self.leaf_noise(u, i, flat.shape[1])).view(leaf.shape))
        return tree_unflatten(tree_structure(tree), out)

    # -------------------------------------------------- bytes accounting

    def message_bytes(self, tree) -> int:
        """Exact uplink cost of one client→server message for a tree of
        this shape (the formulas of the module docstring)."""
        sizes = [l.numel() for l in tree_leaves(tree)]
        if self.name == "int8":
            return sum(-(-s * self.bits // 8) + 4 for s in sizes)
        if self.name == "topk":
            return sum(_leaf_k(s, self.topk_frac) * (4 + 4) for s in sizes)
        return state_bytes(tree)

    def down_bytes(self, tree) -> int:
        """Downlink cost per receiving client (broadcast is uncompressed)."""
        return state_bytes(tree)


def make_codec(name: str = "none", *, bits: int = 8, topk_frac: float = 0.1,
               error_feedback: bool = True) -> Codec:
    """A validated :class:`Codec` (the same validation as ``FedConfig``)."""
    validate_codec(name, bits, topk_frac)
    return Codec(name=name, bits=int(bits), topk_frac=float(topk_frac),
                 error_feedback=bool(error_feedback))


def codec_from_config(fed) -> Codec:
    """The :class:`Codec` a ``FedConfig`` describes."""
    return make_codec(fed.codec, bits=fed.codec_bits,
                      topk_frac=fed.topk_frac,
                      error_feedback=fed.error_feedback)


def wire_costs(codec: Codec, stacked_states) -> Tuple[int, int]:
    """(uplink bytes per client→server message, downlink bytes per
    receiving client) for ONE client of a stacked [M, ...] state tree."""
    one = [l[0] for l in tree_leaves(stacked_states)]
    return codec.message_bytes(one), codec.down_bytes(one)


# ------------------------------------------------------------ EF residuals

def zeros_ef(codec: Optional[Codec], states):
    """The stacked f32 error-feedback residuals matching a [C/N, ...]
    client-state tree, or None when the codec keeps no state."""
    if codec is None or not codec.stateful:
        return None
    return tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                          device=a.device), states)


def mask_rows(keep: torch.Tensor, new, old):
    """Per-row select over a leading client axis: row i of ``new`` where
    ``keep[i]``, else row i of ``old`` (the no-op of clients that did not
    transmit)."""
    if new is None:
        return None

    def sel(a, b):
        return torch.where(keep.reshape((keep.shape[0],) + (1,) * (
            a.dim() - 1)), a, b)
    return tree_map(sel, new, old)


# ------------------------------------------------------------ noise

@dataclasses.dataclass(frozen=True)
class CodecNoise:
    """The int8 codec's rounding noise of a run. ``noise(round_id, ids)``
    is the noise source of one sync of cohort ``ids`` ([C] on the device):
    ``(leaf, size) -> [C, size]`` uniform[0, 1) f32, drawn on ``device``
    from a generator seeded by (seed, round, leaf). Row c is the noise of
    the client in cohort slot c; nothing is copied from the host."""
    seed: int
    device: Any

    def __call__(self, round_id: int, ids: torch.Tensor):
        rows = ids.shape[0]

        def leaf(i: int, size: int) -> torch.Tensor:
            g = devices.generator(self.device, self.seed, _CODEC_SALT,
                                  round_id, i)
            return torch.rand((rows, size), generator=g, device=self.device)
        return leaf


# ------------------------------------------------------------ the uplink leg

def _leaf_message(codec: Codec, ref: torch.Tensor, cur: torch.Tensor,
                  ef: Optional[torch.Tensor], u, i: int):
    """Leaf ``i`` of the uplink leg: ``(recon, new_ef)`` of its ``[C, ...]``
    rows (``new_ef`` None without ``ef``). The f32 buffers are one leaf's
    (13 bytes an element at most): the delta, which becomes the residual
    in place; the noise and the levels; what was sent, which becomes the
    reconstruction in place."""
    c = ref.shape[0]
    delta = cur.reshape(c, -1).to(torch.float32, copy=True)
    delta.sub_(ref.reshape(c, -1))
    if ef is not None:
        delta.add_(ef.reshape(c, -1))
    sent = codec.roundtrip_leaf(delta, codec.leaf_noise(u, i, delta.shape[1]))
    if ef is not None:
        delta.sub_(sent)                     # e' = (Δ + e) − sent
    recon = sent.add_(ref.reshape(c, -1)).to(ref.dtype).view(ref.shape)
    return recon, (delta.view(ref.shape) if ef is not None else None)


def client_messages(codec: Optional[Codec], ref, cur, ef=None,
                    u=None) -> Tuple[Any, Any]:
    """The client→server leg for a client-stacked cohort, leaf by leaf.

    ``ref``/``cur`` are [C, ...] trees (the server-known dispatch states and
    the post-local-steps states), ``ef`` the [C, ...] f32 residuals (None
    when the codec keeps none), ``u`` the int8 codec's noise source
    ``(leaf, size) -> [C, size]``. Returns ``(recon, new_ef)``: the
    server-side reconstructions (leaf dtypes of ``ref``) and the updated
    residuals. A lossless codec returns ``(cur, ef)`` untouched.
    """
    if codec is None or not codec.lossy:
        return cur, ef
    if codec.name == "int8" and u is None:
        raise ValueError("the int8 codec needs its rounding noise u")
    refs, curs = tree_leaves(ref), tree_leaves(cur)
    efs = tree_leaves(ef) if ef is not None else [None] * len(refs)
    recon, new_ef = [], []
    for i, (r, c, e) in enumerate(zip(refs, curs, efs)):
        rec, res = _leaf_message(codec, r, c, e, u, i)
        recon.append(rec)
        new_ef.append(res)
    structure = tree_structure(ref)
    return (tree_unflatten(structure, recon),
            tree_unflatten(structure, new_ef) if ef is not None else None)
