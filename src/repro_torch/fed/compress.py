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
         scale per leaf per client. The whole cohort's message goes through
         one quantize and one dequantize launch
         (:func:`repro_torch.kernels.ops.int8_roundtrip_stacked`).
  topk   per-leaf, per-client magnitude sparsification keeping
         ``round(topk_frac · size)`` entries (at least 1).

The rounding noise of int8 is an input: ``client_messages`` takes it as a
``[C, n]`` f32 tensor in the packed layout of the message
(:func:`repro_torch.core.tree_util.tree_pack_stacked`). :class:`CodecNoise`
draws it on the device from a generator seeded by the run's seed and the
round; the parity tests fill it from the reference's key chain.

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
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch import device as devices
from repro_torch.configs.base import validate_codec
from repro_torch.core.tree_util import (tree_leaves, tree_map,
                                        tree_pack_stacked, tree_unpack_stacked)
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

    def roundtrip_packed(self, flat: torch.Tensor, offsets,
                         u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """decode(encode(·)) of a packed ``[C, n]`` f32 message whose leaves
        start at ``offsets``; ``u`` is the int8 codec's ``[C, n]`` noise."""
        if not self.lossy:
            return flat
        if self.name == "int8":
            if u is None:
                raise ValueError("the int8 codec needs its rounding noise u")
            return ops.int8_roundtrip_stacked(flat, u, offsets, self.qmax)
        parts = []
        for a, b in zip(offsets, offsets[1:]):
            seg = flat[:, a:b]
            k = _leaf_k(b - a, self.topk_frac)
            if k < b - a:
                idx = torch.topk(seg.abs(), k, dim=1).indices
                seg = torch.zeros_like(seg).scatter(1, idx,
                                                    seg.gather(1, idx))
            parts.append(seg)
        return torch.cat(parts, dim=1)

    def roundtrip(self, tree, u: Optional[torch.Tensor] = None):
        """decode(encode(tree)) per client of a client-stacked ``[C, ...]``
        update tree; f32 leaves out."""
        if not self.lossy:
            return tree
        flat, spec = tree_pack_stacked(tree)
        out = self.roundtrip_packed(flat, ops.segment_offsets(spec), u)
        return tree_unpack_stacked(out, spec.with_dtype(torch.float32))

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
    """The int8 codec's rounding noise of a run: for round ``round_id`` and
    cohort ``ids`` ([C] on the device), a ``[C, n]`` uniform[0, 1) f32
    tensor drawn on ``device`` from a generator seeded by (seed, round).
    Row c is the noise of the client in cohort slot c; nothing is copied
    from the host."""
    seed: int
    device: Any

    def __call__(self, round_id: int, ids: torch.Tensor,
                 n: int) -> torch.Tensor:
        g = devices.generator(self.device, self.seed, _CODEC_SALT, round_id)
        return torch.rand((ids.shape[0], n), generator=g,
                          device=self.device)


# ------------------------------------------------------------ the uplink leg

def client_messages(codec: Optional[Codec], ref, cur, ef=None,
                    u: Optional[torch.Tensor] = None) -> Tuple[Any, Any]:
    """The client→server leg for a client-stacked cohort.

    ``ref``/``cur`` are [C, ...] trees (the server-known dispatch states and
    the post-local-steps states), ``ef`` the [C, ...] f32 residuals (None
    when the codec keeps none), ``u`` the int8 codec's ``[C, n]`` noise in
    the packed layout. Returns ``(recon, new_ef)``: the server-side
    reconstructions (leaf dtypes of ``ref``) and the updated residuals. A
    lossless codec returns ``(cur, ef)`` untouched.
    """
    if codec is None or not codec.lossy:
        return cur, ef
    fl_ref, spec = tree_pack_stacked(ref)
    fl_cur, _ = tree_pack_stacked(cur, spec)
    delta = fl_cur - fl_ref
    if ef is not None:
        delta = delta + tree_pack_stacked(ef, spec)[0]
    sent = codec.roundtrip_packed(delta, ops.segment_offsets(spec), u)
    recon = tree_unpack_stacked(fl_ref + sent, spec)
    if ef is None:
        return recon, None
    return recon, tree_unpack_stacked(delta - sent,
                                      spec.with_dtype(torch.float32))


def message_elements(stacked_states) -> int:
    """Elements of one client's packed message (the noise row length)."""
    return sum(math.prod(l.shape[1:]) for l in tree_leaves(stacked_states))
