"""Federated LM runtime: the trainer that turns the paper's algorithm into
step and round functions over a real architecture, on one card
(``src/repro/fed/runtime.py`` with ``mesh=None``).

What this module owns: ``FederatedTrainer``, the state structure (client
x/y/v/w trees with a leading M client axis, the server's adaptive state)
and its step functions (``local``, ``sync``, ``round``, the codec round)
for one architecture. Per-step math comes from :mod:`repro_torch.core`
(``alg.local_step``, Algorithm 1 lines 10-20 with Eq. 14; ``alg.sync_update``,
lines 4-9); the model forward and backward from :mod:`repro_torch.models`
through the bilevel split of :func:`repro_torch.core.bilevel.
lm_bilevel_problem` (x the backbone, y the head). The host loop that
drives them is :mod:`repro_torch.launch.train`.

Without a mesh the trainer has one client (M = 1), as the reference's:
the local step, the sync's server step and the codec leg of a round are
all real at M = 1, and the client mean is the identity. The update kernels
run over the leaves where they lie (:mod:`repro_torch.kernels.ops`), so a
step at full width holds bf16 copies of the model and no f32 pack of it.

Population rounds keep N client states in a bank and step a sampled
cohort of C (:mod:`repro_torch.fed.population`: the synchronous round and
the asynchronous one); the gossip round steps every node against its own
server row and mixes over a graph (:mod:`repro_torch.fed.topology`). A
cohort step runs the C clients' gradients one client at a time (the LM
problem's ``client_loop``, :func:`repro_torch.core.adafbio.per_client`)
and the update kernels once over the C rows; its η_t schedule sees the
population size N.
Each round takes the entries out of the bank dicts it is given, as JAX
donates buffers, so that an old bank is freed as the round replaces it.

Randomness is an input: the Neumann depths come from a draw source
(:class:`NeumannDraws`: step t's depths are a function of (seed, t), as
the reference folds t into one key every step, one per global client id;
:func:`round_depths` cuts a round's out for a cohort), the int8 codec's
noise from a noise source (:class:`repro_torch.fed.compress.CodecNoise`),
the async delays from a :class:`repro_torch.fed.population.DelayDraws`
source, the data from :mod:`repro_torch.data.synthetic`'s draw source. The
parity tests fill them from the reference.

A bank the card cannot hold lives in host memory
(:class:`repro_torch.fed.spill.HostSpillBank`): its rows are built one
client at a time (:meth:`FederatedTrainer.init_spilled_population_states`,
equal to the dense init bit for bit) and each round sees only its gathered
cohort (:meth:`FederatedTrainer.cohort_round_fn`).

A mesh (:class:`repro_torch.sharding.Mesh`) sets M and the rules, as the
reference's: replica mode M = pods x data rows, zero mode M = pods with a
client's batch split over ``data`` (``data_shards``), and the sharding
providers (``state_shardings`` ... ``gossip_server_shardings``) give each
state leaf's spec (:mod:`repro_torch.sharding`). The step functions take
the [M] client axis as they are, so a mesh changes no step; its specs are
applied where the launcher places a bank (:func:`repro_torch.sharding.
device_put`). A mesh over more than one physical device raises at
construction (ROADMAP item 1j).

The mega-scan builders (``multi_population_round_fn``,
``multi_async_population_round_fn``, ``multi_gossip_round_fn``) run R
whole rounds of the population, async and gossip builders as one call
(:func:`repro_torch.fed.round.make_multi_round`): their inputs staged on
the device with a leading R axis, nothing read back inside the call, equal
to R single rounds bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch import device as devices
from repro_torch import sharding as shlib
from repro_torch.configs.base import ArchConfig, FedConfig, ShapeConfig
from repro_torch.core.adafbio import warm_adaptive
from repro_torch.core.baselines import Algorithm, make_algorithm
from repro_torch.core.bilevel import BilevelProblem, lm_bilevel_problem
from repro_torch.core.tree_util import (take, tree_bcast_axis0, tree_index,
                                        tree_map, tree_mean_axis0)
from repro_torch.fed.compress import codec_from_config
from repro_torch.fed.population import (init_async_state, make_async_round,
                                        make_cohort_round,
                                        make_multi_async_round,
                                        make_multi_population_round,
                                        make_population_round)
from repro_torch.fed.round import make_multi_round
from repro_torch.fed.spill import HostSpillBank
from repro_torch.fed.topology import (GossipAggregator, StarAggregator,
                                      make_gossip_round)
from repro_torch.models.model import ModelCtx, check_family, model_specs
from repro_torch.models.params import (TensorSpec, axes_tree, init_params,
                                       torch_dtype)

# seed salt of the Neumann depth draws
_DEPTH_SALT = 0xD3A7


# ------------------------------------------------------------------ batches

def split_client_batch(cfg: ArchConfig, b: Dict[str, Any]) -> Dict[str, Any]:
    """Runtime inputs -> the ``{"g", "g0", "f", "gi"}`` batch dicts of the
    hypergradient and STORM estimators (per client, or stacked on a
    leading client axis: only the keys move)."""
    def pack(tokens, stub_key_prefix):
        d = {"tokens": tokens}
        if cfg.n_prefix_embeds and stub_key_prefix + "prefix_embeds" in b:
            d["prefix_embeds"] = b[stub_key_prefix + "prefix_embeds"]
        if cfg.family == "encdec":
            d["enc_embeds"] = b[stub_key_prefix + "enc_embeds"]
        return d

    return {
        "g": pack(b["tokens"], ""),                 # ζ: LL STORM sample (big)
        "g0": pack(b["hyper0_tokens"], "hyper0_"),  # ζ₀: mixed ∇²xy term
        "f": pack(b["val_tokens"], "val_"),         # ξ: UL sample
        "gi": pack(b["neumann_tokens"], "neumann_"),  # ζ₁..K: Neumann
    }


def client_batch_specs(cfg: ArchConfig, shape: ShapeConfig, m: int,
                       fed: FedConfig) -> Dict[str, TensorSpec]:
    """Shapes and dtypes of one training step's inputs, leading M axis
    included (the reference's specs without their logical axes)."""
    s = shape.seq_len
    # Neumann / ζ₀ samples are independent draws; shorter sequences keep
    # the K cached feature buffers and the second-order term cheap
    sn = max(s // 4, 64)
    bg = max(shape.global_batch // m, 1)
    bf = max(int(bg * fed.ul_batch_frac), 1)
    bn = fed.neumann_batch
    K = fed.neumann_k
    d = cfg.d_model
    tok, emb = torch.int32, torch.bfloat16
    specs = {
        "tokens": TensorSpec((m, bg, s), tok),
        "val_tokens": TensorSpec((m, bf, s), tok),
        "hyper0_tokens": TensorSpec((m, bn, sn), tok),
        "neumann_tokens": TensorSpec((m, K, bn, sn), tok),
    }
    if cfg.n_prefix_embeds:
        pfe = min(cfg.n_prefix_embeds, sn // 2)
        specs.update({
            "prefix_embeds": TensorSpec((m, bg, cfg.n_prefix_embeds, d), emb),
            "val_prefix_embeds": TensorSpec((m, bf, cfg.n_prefix_embeds, d),
                                            emb),
            "hyper0_prefix_embeds": TensorSpec((m, bn, pfe, d), emb),
            "neumann_prefix_embeds": TensorSpec((m, K, bn, pfe, d), emb),
        })
    if cfg.family == "encdec":
        for k, sd in (("tokens", s // 4), ("val_tokens", s // 4),
                      ("hyper0_tokens", sn // 4), ("neumann_tokens", sn // 4)):
            sh = specs[k].shape
            specs[k] = TensorSpec(sh[:-1] + (max(sd, 8),), tok)
        specs.update({
            "enc_embeds": TensorSpec((m, bg, s, d), emb),
            "val_enc_embeds": TensorSpec((m, bf, s, d), emb),
            "hyper0_enc_embeds": TensorSpec((m, bn, sn, d), emb),
            "neumann_enc_embeds": TensorSpec((m, K, bn, sn, d), emb),
        })
    return specs


def client_batch_axes(cfg: ArchConfig) -> Dict[str, Tuple]:
    """The logical axes of :func:`client_batch_specs`' inputs (the
    reference's second return value)."""
    axes = {
        "tokens": ("clients", "batch", None),
        "val_tokens": ("clients", "batch", None),
        "hyper0_tokens": ("clients", "batch", None),
        "neumann_tokens": ("clients", None, "batch", None),
    }
    if cfg.n_prefix_embeds:
        axes.update({
            "prefix_embeds": ("clients", "batch", None, "act_embed"),
            "val_prefix_embeds": ("clients", "batch", None, "act_embed"),
            "hyper0_prefix_embeds": ("clients", "batch", None, "act_embed"),
            "neumann_prefix_embeds": ("clients", None, "batch", None,
                                      "act_embed"),
        })
    if cfg.family == "encdec":
        axes.update({
            "enc_embeds": ("clients", "batch", "seq", "act_embed"),
            "val_enc_embeds": ("clients", "batch", "seq", "act_embed"),
            "hyper0_enc_embeds": ("clients", "batch", "seq", "act_embed"),
            "neumann_enc_embeds": ("clients", None, "batch", "seq",
                                   "act_embed"),
        })
    return axes


def build_lm_problem_ctx(cfg: ArchConfig, fed: FedConfig,
                         data_shards: int = 1
                         ) -> Tuple[BilevelProblem, ModelCtx]:
    """The LM problem; in zero mode a client's batch spans ``data_shards``
    shards, so one microbatch is ``microbatch_per_shard`` sequences a
    shard."""
    ctx = ModelCtx(kind="train")
    mb = max(fed.microbatch_per_shard * data_shards, 1)
    return lm_bilevel_problem(cfg, ctx, fed.nu, microbatch=mb), ctx


@dataclasses.dataclass(frozen=True)
class NeumannDraws:
    """The trainer's Neumann depths k ~ U{0..K-1} on ``device``: ``init()``
    the [n] of the initial estimators, ``step(t)`` the [n] of the local step
    at server step ``t``, each from a generator seeded by (seed, t) alone."""
    seed: int
    K: int
    n: int
    device: Any = "cpu"

    def _draw(self, *parts: int) -> torch.Tensor:
        g = devices.generator(self.device, self.seed, _DEPTH_SALT, *parts)
        return torch.randint(0, self.K, (self.n,), generator=g,
                             device=self.device)

    def init(self) -> torch.Tensor:
        return self._draw(0)

    def step(self, t: int) -> torch.Tensor:
        return self._draw(1, t)


def round_depths(depths: NeumannDraws, r: int, q: int,
                 ids: torch.Tensor) -> torch.Tensor:
    """The [q, C] Neumann depths of round r's local steps for the global
    client ids ``ids``: step j's at the server counter r(q + 1) + j (one
    tick a local step and one a sync), each client's by its global id, so
    a client draws the same depth in a cohort as in the whole population.
    The asynchronous rounds take the same depths, at the counter a
    synchronous run would have."""
    return torch.stack([depths.step(r * (q + 1) + j).index_select(0, ids)
                        for j in range(q)])


# ------------------------------------------------------------------ trainer

@dataclasses.dataclass
class FederatedTrainer:
    """Local, sync, round and eval functions for one architecture."""
    cfg: ArchConfig
    fed: FedConfig
    shape: ShapeConfig
    mesh: Any = None
    algorithm: str = "adafbio"
    problem: Optional[BilevelProblem] = None      # default: LM hyper-rep split
    device: Any = "cuda"

    def __post_init__(self):
        check_family(self.cfg)
        mesh = self.mesh
        if mesh is not None:
            self.device = shlib.check_mesh_device(mesh, self.device)
        self.device = devices.resolve(self.device)
        self.rules = (shlib.train_rules(self.cfg, mesh) if mesh is not None
                      else None)
        self.m = (shlib.n_clients(mesh, self.cfg.fed_mode)
                  if mesh is not None else 1)
        # in zero mode a client's batch is split over `data`: one
        # microbatch spans data_shards shards
        self.data_shards = 1
        if mesh is not None and self.cfg.fed_mode == "zero":
            self.data_shards = mesh.shape.get("data", 1)
        if self.problem is None:
            self.problem, self.ctx = build_lm_problem_ctx(
                self.cfg, self.fed, self.data_shards)
        else:
            self.ctx = ModelCtx(kind="train")
        self.alg: Algorithm = make_algorithm(self.algorithm, self.fed,
                                             self.problem)
        self.codec = codec_from_config(self.fed)
        self.specs = model_specs(self.cfg)
        self._axes = axes_tree(self.specs)
        self.client_axes_names = (shlib.client_axes(mesh, self.cfg.fed_mode)
                                  if mesh is not None else ())

    # -------------------------------------------------- state structure

    def _param_specs(self):
        return tree_map(lambda s: TensorSpec(
            s.shape, torch_dtype(s.dtype or self.cfg.dtype)), self.specs)

    def abstract_population_states(self, n: int):
        p = self._param_specs()
        one = {"x": p["x"], "y": p["y"], "v": p["y"], "w": p["x"]}
        return tree_map(lambda s: TensorSpec((n,) + s.shape, s.dtype), one)

    def abstract_client_states(self):
        return self.abstract_population_states(self.m)

    def abstract_server_state(self):
        """The server state of the trainer's algorithm: its own FedConfig
        says whether there are adaptive accumulators (a baseline's
        ``adaptive="none"`` keeps none, whatever the trainer's
        FedConfig)."""
        adaptive = self.alg.fed.adaptive
        st = {"adaptive": {"b": TensorSpec((), torch.float32)},
              "t": TensorSpec((), torch.int32)}
        if adaptive != "none":
            st["adaptive"]["a"] = self._param_specs()["x"]
        if adaptive == "adabelief":
            st["adaptive"]["w_prev"] = st["adaptive"]["a"]
            st["adaptive"]["v_norm_prev"] = TensorSpec((), torch.float32)
        return st

    def one_state_axes(self):
        """Logical axes of one client's state (no leading client axis)."""
        ax = self._axes
        return {"x": ax["x"], "y": ax["y"], "v": ax["y"], "w": ax["x"]}

    def client_state_axes(self):
        return shlib.map_axes(lambda a: ("clients",) + a,
                              self.one_state_axes())

    def server_state_axes(self):
        """The axes of :meth:`abstract_server_state`'s leaves."""
        adaptive = self.alg.fed.adaptive
        st = {"adaptive": {"b": ()}, "t": ()}
        if adaptive != "none":
            st["adaptive"]["a"] = self._axes["x"]
        if adaptive == "adabelief":
            st["adaptive"]["w_prev"] = self._axes["x"]
            st["adaptive"]["v_norm_prev"] = ()
        return st

    # -------------------------------------------------- shardings

    def _shardings(self, axes_tree_, shapes_tree=None, fallback=()):
        if self.mesh is None:
            return None
        return shlib.tree_shardings(axes_tree_, self.rules, self.mesh,
                                    shapes_tree, fallback)

    def state_shardings(self):
        return self._shardings(self.client_state_axes(),
                               self.abstract_client_states(),
                               fallback=("model",))

    def server_shardings(self):
        return self._shardings(self.server_state_axes(),
                               self.abstract_server_state(),
                               fallback=("model",))

    def batch_shardings(self, batch_specs, batch_axes):
        return self._shardings(batch_axes, batch_specs)

    def population_state_shardings(self, n: int):
        """Bank shardings: the leading population axis partitions over the
        client mesh axes; the trailing model axes keep their rule-based
        layout. Where N does not divide the client axes' product the
        leading assignment drops and the bank replicates client-wise."""
        return self._shardings(self.client_state_axes(),
                               self.abstract_population_states(n),
                               fallback=("model",))

    def bank_vector_sharding(self, n: int):
        """The sharding of the [N] bookkeeping vectors (``last_sync``,
        ``in_flight``, ``dispatch_round``, ``return_round``): partitioned
        like the bank's rows."""
        if self.mesh is None:
            return None
        return shlib.NamedSharding(self.mesh, shlib.bank_spec(
            self.mesh, self.cfg.fed_mode, (n,)))

    def async_state_shardings(self, n: int):
        """Shardings of the async state dict (:meth:`
        init_async_population_states`): the bank, pending buffer, EF
        residuals and [N] vectors partition over the client mesh axes; the
        anchor and the server replicate client-wise. None without a
        mesh."""
        if self.mesh is None:
            return None
        pss = self.population_state_shardings(n)
        vec = self.bank_vector_sharding(n)
        one_abs = tree_map(lambda s: TensorSpec(s.shape[1:], s.dtype),
                           self.abstract_population_states(n))
        one_sh = self._shardings(self.one_state_axes(), one_abs,
                                 fallback=("model",))
        st_sh = {"bank": pss, "pending": pss, "last_sync": vec,
                 "in_flight": vec, "dispatch_round": vec,
                 "return_round": vec, "anchor": one_sh,
                 "server": self.server_shardings()}
        if self.codec.stateful:
            st_sh["ef"] = self.population_state_shardings(n)
        return st_sh

    def gossip_server_shardings(self, n: int):
        """Shardings of the stacked [n] per-node server bank: the leading
        node axis partitions like the state bank's rows."""
        if self.mesh is None:
            return None
        axes = shlib.map_axes(lambda a: ("clients",) + a,
                              self.server_state_axes())
        shapes = tree_map(lambda s: TensorSpec((n,) + s.shape, s.dtype),
                          self.abstract_server_state())
        return self._shardings(axes, shapes, fallback=("model",))

    # -------------------------------------------------- init

    def init_params(self, gen: torch.Generator):
        """The model's ``{"x", "y"}`` params drawn from ``gen`` on the
        trainer's device."""
        return init_params(self.specs, gen, self.cfg.dtype, self.device)

    def init_population_states(self, params, batch, k: torch.Tensor):
        """Bank init over ``n = len(k)`` clients that share ``params``
        (``batch`` has a leading n axis, ``k`` their init Neumann depths):
        line 2's estimators, the server state and its warm start from the
        averaged estimators. Returns ``(bank, last_sync, server)``.

        The warm start follows the algorithm's own FedConfig: a baseline
        with ``adaptive="none"`` (adafbio_na, fedbioacc, fedavg_sgd,
        fednest, localbsgvrm) has no accumulators to warm. The reference
        warms by the trainer's FedConfig and so raises ``KeyError('a')``
        for every baseline at the default ``adaptive="adam"`` (ROADMAP
        section 3); where it runs (the trainer's ``adaptive="none"``) both
        give the same state."""
        n = k.shape[0]
        bank = self.alg.init_client_state(params["x"], params["y"],
                                          split_client_batch(self.cfg, batch),
                                          k)
        server = self.alg.init_server_state(tree_index(bank["x"], 0))
        if self.alg.fed.adaptive != "none":
            server = warm_adaptive(server, tree_mean_axis0(bank),
                                   self.alg.fed)
        return bank, torch.zeros((n,), dtype=torch.int32,
                                 device=self.device), server

    def init_spilled_population_states(self, params, batch,
                                       k: torch.Tensor):
        """:meth:`init_population_states` without a dense bank on the card:
        each client's row is built alone (``init_client_state`` on its own
        batch and depth, what the LM problem's ``client_loop`` runs for it
        in the dense init) and goes into a :class:`repro_torch.fed.spill.
        HostSpillBank` (pinned on a CUDA device) as soon as it is built; the
        warm start's client mean is taken leaf by leaf, that leaf's N rows
        stacked on the device. Equal to the dense init bit for bit where the
        problem steps its clients one at a time. Returns ``(bank,
        last_sync, server)``, ``last_sync`` an int32 [n] host tensor."""
        n = k.shape[0]
        bank = HostSpillBank.allocate(self.abstract_population_states(n),
                                      self.device)
        for i in range(n):
            row = self.alg.init_client_state(
                params["x"], params["y"],
                split_client_batch(self.cfg, tree_map(lambda a: a[i:i + 1],
                                                      batch)), k[i:i + 1])
            bank.scatter([i], row)
            del row
        server = self.alg.init_server_state(params["x"])
        if self.alg.fed.adaptive != "none":
            avg = {key: tree_map(lambda rows: tree_mean_axis0(
                rows.to(self.device)), bank.rows[key])
                for key in ("v", "w")}
            server = warm_adaptive(server, avg, self.alg.fed)
        return bank, torch.zeros((n,), dtype=torch.int32), server

    def init_states(self, params, batch, k: torch.Tensor):
        """``(states, server)`` of the trainer's M clients."""
        states, _, server = self.init_population_states(params, batch, k)
        return states, server

    def init_ef_bank(self, n: int):
        """The stacked [n, ...] f32 error-feedback residuals (zeros), or None
        when the codec keeps no per-client state."""
        if not self.codec.stateful:
            return None
        return tree_map(lambda s: torch.zeros(s.shape, dtype=torch.float32,
                                              device=self.device),
                        self.abstract_population_states(n))

    def init_spilled_ef_bank(self, n: int) -> Optional[HostSpillBank]:
        """:meth:`init_ef_bank` as a :class:`repro_torch.fed.spill.
        HostSpillBank` of zeros made in host memory, or None."""
        if not self.codec.stateful:
            return None
        return HostSpillBank.allocate(
            tree_map(lambda s: TensorSpec(s.shape, torch.float32),
                     self.abstract_population_states(n)), self.device,
            zero=True)

    # -------------------------------------------------- step functions

    def local_step_fn(self) -> Callable:
        """``step(states, server, batch, k) -> (states, server)``: one local
        step of every client, ``k`` their [M] Neumann depths (the cohort
        step over the whole population, as the reference's)."""
        step = self.cohort_local_step_fn()
        return lambda states, server, batch, k: step(states, server, batch,
                                                     k, None)

    def cohort_local_step_fn(self, n: Optional[int] = None) -> Callable:
        """``step(states, server, batch, k, ids) -> (states, server)``: one
        local step of a cohort stacked on a leading [C] axis, ``k`` its [C]
        Neumann depths (drawn per global id and step t: :func:`
        round_depths`; ``ids`` is not read again). The η_t schedule sees the
        population size ``n`` (the paper's M, default the trainer's), not
        the cohort's width, so a cohort step is the step its clients take
        in a step of the whole population."""
        m_sched = n if n is not None else self.m

        def step(states, server, batch, k, ids):
            del ids
            t = server["t"]
            new_states = self.alg.local_step(
                states, server["adaptive"], split_client_batch(self.cfg, batch),
                k, t, m_sched)
            new_server = dict(server)
            new_server["t"] = t + 1
            return new_states, new_server
        return step

    def star_aggregator(self, n: Optional[int] = None) -> StarAggregator:
        """The star sync: ``sync_update`` with the client count ``n``
        (default: the trainer's) closed over, plus the trainer's codec."""
        m = n if n is not None else self.m
        return StarAggregator(
            sync_update=lambda srv, avg: self.alg.sync_update(srv, avg, m),
            codec=self.codec)

    def sync_step_fn(self) -> Callable:
        """``sync(states, server) -> (states, server)``: the client mean,
        the server step and the broadcast."""
        agg = self.star_aggregator()

        def step(states, server):
            new_client, new_server = agg.reduce(server, states)
            return tree_bcast_axis0(new_client, self.m), new_server
        return step

    def round_step_fn(self, q: Optional[int] = None) -> Callable:
        """One communication round: q local steps, then the sync.
        ``round(states, server, batches_q, k_q)``: the per-step batches and
        [M] depths stacked on a leading axis of size q. The same calls as q
        ``local_step_fn()`` steps and one ``sync_step_fn()``.

        The round takes the entries out of the ``states`` and ``server``
        dicts it is given (they are left empty, as JAX's donated buffers),
        so the round-start state is freed after the first step instead of
        staying alive in the caller for the whole round: at full width that
        is 14 GB. A caller that keeps them passes shallow copies."""
        local, sync = self.local_step_fn(), self.sync_step_fn()
        nq = q if q is not None else self.fed.q
        if nq < 1:
            raise ValueError(f"round needs q >= 1 local steps, got {nq}")

        def round_step(states, server, batches_q, k_q):
            states, server = take(states), take(server)
            with record_function("round/local_scan"):
                for j in range(nq):
                    states, server = local(states, server,
                                           tree_index(batches_q, j), k_q[j])
            with record_function("round/sync"):
                return sync(states, server)
        return round_step

    def round_step_codec_fn(self, q: Optional[int] = None) -> Callable:
        """The round with the codec leg: each client's round delta against
        ``ref`` (the last broadcast, what every client started the round
        from) goes through ``FedConfig.codec`` before the mean, with the
        per-client EF residual carried across rounds. ``round(states,
        server, ref, ef, batches_q, k_q, u=None) -> (states, server, ref,
        ef)``; ``u`` is the int8 codec's noise source of the round
        (``(leaf, size) -> [M, size]``); the new ``ref`` is the fresh
        broadcast. With codec none it is :meth:`round_step_fn`."""
        agg = self.star_aggregator()
        local = self.local_step_fn()
        nq = q if q is not None else self.fed.q

        def round_step(states, server, ref, ef, batches_q, k_q, u=None):
            with record_function("round/local_scan"):
                for j in range(nq):
                    states, server = local(states, server,
                                           tree_index(batches_q, j), k_q[j])
            with record_function("round/codec"):
                recon, ef = agg.messages(ref, states, ef, u)
            with record_function("round/sync"):
                new_client, server = agg.reduce(server, recon)
                states = tree_bcast_axis0(new_client, self.m)
            return states, server, states, ef
        return round_step

    def eval_fn(self) -> Callable:
        """Mean UL loss f(x̄, ȳ) over the clients' val batches."""
        def ev(states, batch):
            with torch.no_grad():
                avg = tree_mean_axis0(states)
                val = split_client_batch(self.cfg, batch)["f"]
                m = val["tokens"].shape[0]
                return torch.stack([
                    self.problem.f(avg["x"], avg["y"], tree_index(val, i))
                    for i in range(m)]).mean()
        return ev

    # -------------------------------------------------- population mode

    def population_round_fn(self, n: int, q: Optional[int] = None, *,
                            sync_mode: str = "broadcast",
                            staleness_decay: float = 0.0) -> Callable:
        """Gather -> q local steps -> aggregate -> write-back over an
        n-client bank (:func:`repro_torch.fed.population.
        make_population_round`): ``round(bank, last_sync, server, ids,
        batches_q, k_q, round_id)``, ``k_q`` the cohort's [q, C] depths.
        With a lossy codec: ``round(bank, last_sync, ef_bank, server, ids,
        batches_q, k_q, round_id, u)``, ``ef_bank`` from
        :meth:`init_ef_bank` (None with error feedback off) and ``u`` the
        int8 codec's noise source of the round. The round takes the
        entries out of the ``bank`` and ``ef_bank`` dicts."""
        return make_population_round(
            self.cohort_local_step_fn(n), self.star_aggregator(n),
            q if q is not None else self.fed.q, sync_mode=sync_mode,
            staleness_decay=staleness_decay, codec=self.codec)

    def init_async_population_states(self, params, batch, k: torch.Tensor):
        """Bank init and the async bookkeeping: the :func:`repro_torch.fed.
        population.init_async_state` dict (bank, pending buffer, flight and
        staleness vectors, anchor, server, the EF bank with a stateful
        codec) that :meth:`async_population_round_fn` advances."""
        bank, _, server = self.init_population_states(params, batch, k)
        return init_async_state(bank, server, k.shape[0], codec=self.codec)

    def async_population_round_fn(self, n: int, q: Optional[int] = None, *,
                                  sync_mode: str = "broadcast",
                                  staleness_decay: float = 0.0,
                                  max_staleness: float = float("inf"),
                                  max_delay: int = 1,
                                  delay_eta: float = 0.0,
                                  delay_model=None,
                                  delay_draws=None) -> Callable:
        """The asynchronous round over an n-client bank: arrivals ->
        bounded-staleness gate -> delay-adaptive server step ->
        overlapping-cohort dispatch (:func:`repro_torch.fed.population.
        make_async_round`). ``delay_model`` a :class:`repro_torch.fed.
        population.DelayModel` (None: uniform over [1, max_delay]),
        ``delay_draws`` its draw source. ``round(state, ids, batches_q,
        k_q, round_id, u=None) -> (state, stats)``; the round takes the
        entries out of ``state``."""
        return make_async_round(
            self.cohort_local_step_fn(n), self.star_aggregator(n),
            q if q is not None else self.fed.q, sync_mode=sync_mode,
            staleness_decay=staleness_decay, max_staleness=max_staleness,
            max_delay=max_delay, delay_eta=delay_eta, delay=delay_model,
            delay_draws=delay_draws, codec=self.codec)

    # -------------------------------------------------- gossip mode

    def gossip_aggregator(self, n: int, *, topology: str = "ring",
                          er_p: float = 0.4, seed: int = 0,
                          time_varying: bool = False,
                          uniform=None) -> GossipAggregator:
        """The decentralized sync: a :class:`repro_torch.fed.topology.
        GossipAggregator` mixing an n-node bank over ``topology`` on the
        trainer's device (``uniform``: a time-varying graph's draw
        source)."""
        return GossipAggregator(
            sync_update=lambda srv, avg: self.alg.sync_update(srv, avg, n),
            n=n, topology=topology, er_p=er_p, seed=seed,
            time_varying=time_varying, codec=self.codec, device=self.device,
            uniform=uniform)

    def gossip_local_step_fn(self, n: int) -> Callable:
        """``step(bank, srv_bank, batch, k, ids) -> (bank, srv_bank)``: one
        local step of every node against its own server row (``srv_bank``
        stacks the server state on a leading [n] axis: one accumulator a
        node, which kernel 2 takes per row). The nodes step in lockstep, so
        their counters are equal and η_t reads node 0's; each advances."""
        def step(states, srv_bank, batch, k, ids):
            del ids
            t = srv_bank["t"]
            new = self.alg.local_step(
                states, srv_bank["adaptive"],
                split_client_batch(self.cfg, batch), k, t[0], n)
            srv = dict(srv_bank)
            srv["t"] = t + 1
            return new, srv
        return step

    def init_gossip_states(self, params, batch, k: torch.Tensor):
        """The gossip bank: the population bank, and the star server state
        (the same init and warm start, one initial consensus) on a leading
        [n] axis. Returns ``(bank, srv_bank)``."""
        bank, _, server = self.init_population_states(params, batch, k)
        return bank, tree_bcast_axis0(server, k.shape[0])

    def gossip_round_fn(self, n: int, q: Optional[int] = None, *,
                        topology: str = "ring", er_p: float = 0.4,
                        seed: int = 0, time_varying: bool = False,
                        uniform=None) -> Callable:
        """The gossip round (:func:`repro_torch.fed.topology.
        make_gossip_round`): the mix that closes the previous round, then q
        local steps. ``round(bank, srv_bank, ef, batches_q, k_q, round_id,
        u=None, *, n_steps=q, sync_first=True) -> (bank, srv_bank, ef)``;
        ``ef`` is None unless the codec keeps per-node residuals
        (:meth:`init_ef_bank`). The round takes the entries out of the
        three dicts."""
        agg = self.gossip_aggregator(n, topology=topology, er_p=er_p,
                                     seed=seed, time_varying=time_varying,
                                     uniform=uniform)
        return make_gossip_round(self.gossip_local_step_fn(n), agg,
                                 q if q is not None else self.fed.q)

    def cohort_round_fn(self, n: int, q: Optional[int] = None, *,
                        staleness_decay: float = 0.0) -> Callable:
        """The cohort-only round of the host-spill bank
        (:func:`repro_torch.fed.population.make_cohort_round`): the math of
        :meth:`population_round_fn` without the [N, ...] bank, whose
        gather and write-back are the caller's. ``round(cur, last_sync_c,
        server, ids, batches_q, k_q, round_id) -> (new_client, server)``;
        with a lossy codec ``round(cur, last_sync_c, ef_c, server, ids,
        batches_q, k_q, round_id, u) -> (new_client, ef_c, server)``. The
        round takes the entries out of ``cur`` and ``ef_c``."""
        return make_cohort_round(
            self.cohort_local_step_fn(n), self.star_aggregator(n),
            q if q is not None else self.fed.q,
            staleness_decay=staleness_decay, codec=self.codec)

    # -------------------------------------------------- mega-scan tier

    def multi_population_round_fn(self, n: int, q: Optional[int] = None, *,
                                  sync_mode: str = "broadcast",
                                  staleness_decay: float = 0.0) -> Callable:
        """R rounds of :meth:`population_round_fn` as one call
        (:func:`repro_torch.fed.population.make_multi_population_round`):
        ``multi(bank, last_sync[, ef_bank], server, ids_R, batches_R, k_R,
        round0[, noise_R])``, ``ids_R`` the [R, C] cohorts, ``batches_R``
        each round's ``batches_q`` on a new leading R axis, ``k_R`` the [R, q, C] depths and ``noise_R`` the
        rounds' int8 noise sources (a list, or None)."""
        return make_multi_population_round(
            self.population_round_fn(n, q, sync_mode=sync_mode,
                                     staleness_decay=staleness_decay),
            lossy=self.codec.lossy)

    def multi_async_population_round_fn(self, n: int,
                                        q: Optional[int] = None,
                                        **async_opts) -> Callable:
        """R rounds of :meth:`async_population_round_fn` as one call:
        ``multi(state, ids_R, batches_R, k_R, round0, noise_R=None) ->
        (state, stats_R)``, the per-round stats stacked on a new leading R
        axis. ``async_opts`` forwards the async knobs."""
        return make_multi_async_round(
            self.async_population_round_fn(n, q, **async_opts))

    def multi_gossip_round_fn(self, n: int, q: Optional[int] = None,
                              **topo_opts) -> Callable:
        """R rounds of :meth:`gossip_round_fn`, each with its opening mix,
        as one call: ``multi(bank, srv_bank, ef, batches_R, k_R, round0,
        noise_R=None) -> (bank, srv_bank, ef)``. Round 0 (no mix to run)
        is the caller's to peel off with ``sync_first=False`` on the
        single round. A time-varying graph is drawn from each round's
        absolute id."""
        round_fn = self.gossip_round_fn(n, q, **topo_opts)

        def one(carry, _, batches_q, dr, round_id):
            k_q, u = dr
            return round_fn(*carry, batches_q, k_q, round_id, u), None

        multi = make_multi_round(one)

        def mega(bank, srv_bank, ef, batches_R, k_R, round0, noise_R=None):
            carry, _ = multi((bank, srv_bank, ef), None, batches_R,
                             (k_R, noise_R), round0)
            return carry
        return mega
