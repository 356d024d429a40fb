"""Continuous-batching serve engine (``src/repro/serve/engine.py``).

A fixed pool of B slots shares ONE decode step per tick with a per-slot
position vector. New requests prefill at batch 1, their cache row scatters
into the pool, and retired slots (EOS / token budget / cache capacity)
refill on the next tick, so no request waits for the longest one. The
scheduler changes throughput, never results: every cache leaf carries the
batch axis at position 1 and the decode path is row-independent, so a
request's tokens are the same whether it shared the pool or ran alone.

``kv_quant=True`` switches the pool to the int8 layout: prefill stays full
precision, the row is quantized per (token, head) on its way into the
pool, and decode attends over it. It needs an attention KV cache: the ssm
family keeps SSM state and the hybrid family its bf16 shared-block cache,
so both refuse it, as the reference does. ``kv_kernel`` picks the attention of
prefill and decode: "auto" the ``flash_attention`` and
``quant_decode_attention`` kernels on a CUDA device and their plain
versions on the CPU, "kernel" the kernels (refused on the CPU), "xla" the
reference's paths (``attend_full``; the int8 cache dequantized to the
model dtype, then ``attend_decode``; the chunked associative scan). On the
ssm family "auto" prefills through the ``mamba_scan`` kernel.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as devlib
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.tree_util import tree_leaves
from repro_torch.fed.serve import build_serve_fns, check_kv_kernel
from repro_torch.kernels.quant_decode import quantize_kv
from repro_torch.models.decode import zeros
from repro_torch.models.model import check_family

# families with an attention KV cache (the reference's list)
QUANT_FAMILIES = ("dense", "vlm", "moe", "encdec")

@dataclasses.dataclass
class Request:
    """One generation request. ``tokens``: [plen] int32 prompt.
    ``prefix_embeds`` ([n_prefix, d], VLM archs) and ``enc_embeds``
    ([max_len, d], encdec archs: the encoder's frames, as many as the
    engine's ``max_len``) ride along when the architecture needs them; ``arrival_s`` is the open-loop arrival offset
    stamped by the load generator."""
    rid: int
    tokens: np.ndarray
    max_new_tokens: int = 32
    arrival_s: float = 0.0
    enc_embeds: Optional[np.ndarray] = None
    prefix_embeds: Optional[np.ndarray] = None


@dataclasses.dataclass
class Completion:
    """A drained request: generated ``tokens`` (prompt excluded; EOS, when
    hit, included) plus scheduling timestamps in engine-clock seconds."""
    rid: int
    prompt_len: int
    tokens: List[int]
    finish_reason: str            # eos | length | capacity
    arrival_s: float
    admitted_s: float
    finished_s: float
    decode_ticks: int

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.arrival_s


class Engine:
    """Continuous-batching greedy-decode engine over ``build_serve_fns``.

    ``submit()`` queues requests; ``step()`` runs one scheduler tick
    (admissions, then one shared decode) and returns the requests that
    finished; ``run()`` drains the queue. Decoding is greedy argmax.
    ``params`` must already be on ``device`` (default: the card; without
    one the engine raises, and ``device="cpu"`` runs the plain paths).
    ``timings`` holds the host-clock seconds of every admission (prefill,
    quantize, scatter and the first token's readback) and every decode tick
    (the decode and the tokens' readback): each ends in a read of the
    result, so each waits for the card.
    """

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 8,
                 max_len: int = 256, kv_quant: bool = False,
                 kv_kernel: str = "auto", mesh=None,
                 eos_id: Optional[int] = None, telemetry=None,
                 device="cuda"):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        check_kv_kernel(kv_kernel)
        check_family(cfg)
        if kv_quant and cfg.family not in QUANT_FAMILIES:
            raise ValueError(
                f"kv_quant=True needs an attention KV cache; family "
                f"{cfg.family!r} keeps "
                f"{'SSM state' if cfg.family == 'ssm' else 'hybrid state'} "
                f"(supported: {', '.join(QUANT_FAMILIES)})")
        if telemetry is not None:
            raise NotImplementedError("telemetry comes with the port's obs/ "
                                      "slice; pass telemetry=None")
        dev = devlib.resolve(device)
        if kv_kernel == "kernel" and dev.type != "cuda":
            raise ValueError("kv_kernel='kernel' runs the CUDA kernels; on "
                             f"{dev} use 'auto' or 'xla'")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        where = {t.device for t in tree_leaves(params)}
        if where != {dev}:
            raise ValueError(f"params must be on {dev}, got {where}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.kv_quant = kv_quant
        self.kv_kernel = kv_kernel
        self.eos_id = eos_id
        self.device = dev

        dec_shape = ShapeConfig("serve_decode", max_len, slots, "decode")
        pre_shape = ShapeConfig("serve_prefill", max_len, 1, "prefill")
        self._dec = build_serve_fns(cfg, dec_shape, mesh, kv_quant=kv_quant,
                                    kv_kernel=kv_kernel)
        self._pre = build_serve_fns(cfg, pre_shape, mesh,
                                    kv_kernel=kv_kernel)
        self._decode = self._dec["decode"]
        self._prefill = self._pre["prefill"]
        self._pool = zeros(self._dec["cache_abs"], dev)
        # prefill rewrites every slot of the row it is given, so one row
        # serves every admission
        self._row = zeros(self._pre["cache_abs"], dev)

        # host-side slot state
        self._queue: Deque[Request] = deque()
        self._occupant: List[Optional[Request]] = [None] * slots
        self._free: List[int] = list(range(slots))[::-1]   # pop() -> slot 0
        self._pos = np.zeros(slots, np.int32)
        self._last_tok = np.zeros(slots, np.int32)
        self._budget = np.zeros(slots, np.int32)
        self._out: Dict[int, List[int]] = {}
        self._admitted_s: Dict[int, float] = {}
        self._admit_tick: Dict[int, int] = {}
        self._ticks = 0
        self.timings: Dict[str, List[float]] = {"prefill": [], "decode": []}
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------ clock

    def start_clock(self) -> None:
        """Reset the engine clock (latencies are measured from here)."""
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    # ------------------------------------------------------------ pool ops

    def _scatter_row(self, row: Dict[str, torch.Tensor], slot: int) -> None:
        """Write a prefilled B=1 cache row into pool slot ``slot``: every
        leaf carries the batch at axis 1, so one loop covers every family.
        With ``kv_quant`` the row's K/V are quantized per (token, head) on
        the way in; an encdec row's cross cache ``ck``/``cv`` goes in
        dense, as the reference's ``_quantize_row`` leaves it."""
        for key, val in row.items():
            if self.kv_quant and key in ("k", "v"):
                levels, scale = quantize_kv(val[:, 0])
                self._pool[key][:, slot] = levels
                self._pool[key + "_scale"][:, slot] = scale
            else:
                self._pool[key][:, slot] = val[:, 0]

    @staticmethod
    def _argmax(logits: torch.Tensor) -> torch.Tensor:
        return logits[:, 0, :].argmax(dim=-1).to(torch.int32)

    # ------------------------------------------------------------ intake

    def submit(self, req: Request) -> None:
        plen = int(np.shape(req.tokens)[-1])
        if plen < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be "
                             f">= 1, got {req.max_new_tokens}")
        if plen >= self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt_len {plen} must be < the cache "
                f"capacity max_len={self.max_len} (the generation budget is "
                f"truncated at capacity, the prompt is not)")
        self._queue.append(req)

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        return self.slots - len(self._free)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or self.active > 0

    # ------------------------------------------------------------ scheduler

    def _admit(self, req: Request, slot: int,
               completed: List[Completion]) -> None:
        t0 = time.perf_counter()
        tokens = torch.from_numpy(np.asarray(req.tokens, np.int32)[None])
        batch = {"tokens": devlib.to_device(tokens, self.device)}
        if "prefix_embeds" in self._pre["batch_specs"]:
            spec = self._pre["batch_specs"]["prefix_embeds"]
            pe = req.prefix_embeds
            if pe is None:
                pe = np.zeros(spec.shape[1:], np.float32)
            batch["prefix_embeds"] = torch.from_numpy(
                np.asarray(pe, np.float32)[None]).to(self.device, spec.dtype)
        if "enc_embeds" in self._pre["batch_specs"]:
            if req.enc_embeds is None:
                raise ValueError(f"request {req.rid}: encoder-decoder arch "
                                 f"needs enc_embeds [{self.max_len}, d]")
            spec = self._pre["batch_specs"]["enc_embeds"]
            batch["enc_embeds"] = torch.from_numpy(
                np.asarray(req.enc_embeds, np.float32)[None]).to(
                    self.device, spec.dtype)
        logits, row = self._prefill(self.params, batch, self._row)
        self._scatter_row(row, slot)
        first = int(self._argmax(logits)[0].item())
        self.timings["prefill"].append(time.perf_counter() - t0)
        plen = int(np.shape(req.tokens)[-1])
        self._occupant[slot] = req
        self._pos[slot] = plen
        self._last_tok[slot] = first
        self._budget[slot] = req.max_new_tokens - 1
        self._out[req.rid] = [first]
        self._admitted_s[req.rid] = self.now()
        self._admit_tick[req.rid] = self._ticks
        if self.eos_id is not None and first == self.eos_id:
            self._retire(slot, "eos", completed)
        elif req.max_new_tokens == 1:
            self._retire(slot, "length", completed)

    def _retire(self, slot: int, reason: str,
                completed: List[Completion]) -> None:
        req = self._occupant[slot]
        completed.append(Completion(
            rid=req.rid, prompt_len=int(np.shape(req.tokens)[-1]),
            tokens=self._out.pop(req.rid), finish_reason=reason,
            arrival_s=req.arrival_s,
            admitted_s=self._admitted_s.pop(req.rid), finished_s=self.now(),
            decode_ticks=self._ticks - self._admit_tick.pop(req.rid)))
        self._occupant[slot] = None
        self._free.append(slot)

    def step(self) -> List[Completion]:
        """One scheduler tick: admit into free slots, then ONE shared decode
        over every active slot. Returns the requests that completed."""
        completed: List[Completion] = []
        while self._queue and self._free:
            self._admit(self._queue.popleft(), self._free.pop(), completed)
        active = [s for s in range(self.slots)
                  if self._occupant[s] is not None]
        if active:
            t0 = time.perf_counter()
            token = devlib.to_device(
                torch.from_numpy(self._last_tok[:, None].copy()), self.device)
            pos = devlib.to_device(
                torch.from_numpy(np.maximum(self._pos, 1)), self.device)
            logits, self._pool = self._decode(self.params, self._pool, token,
                                              pos)
            nxt = self._argmax(logits).cpu().numpy()
            self.timings["decode"].append(time.perf_counter() - t0)
            for s in active:
                tok = int(nxt[s])
                self._out[self._occupant[s].rid].append(tok)
                self._pos[s] += 1
                self._last_tok[s] = tok
                self._budget[s] -= 1
                if self.eos_id is not None and tok == self.eos_id:
                    self._retire(s, "eos", completed)
                elif self._budget[s] <= 0:
                    self._retire(s, "length", completed)
                elif self._pos[s] >= self.max_len:
                    self._retire(s, "capacity", completed)
        self._ticks += 1
        return completed

    def run(self, requests=None) -> List[Completion]:
        """Drain: submit ``requests`` (if given) and tick until idle."""
        for r in requests or ():
            self.submit(r)
        done: List[Completion] = []
        while self.has_work:
            done.extend(self.step())
        return done
