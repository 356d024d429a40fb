"""The LM trainer's population rounds against the JAX reference at
``reduced(qwen1.5-4b)`` in f32 (N = 4 clients, cohorts of C = 2, q = 2,
K = 2, ``fused="on"`` on both sides): the bank init over N clients, the
cohort step (the depths drawn per global client id and step, the η_t
schedule at the population size), and whole population rounds with codec
none, int8 + error feedback and topk, under the broadcast and the
participants sync; the codec's leaf route against the packed route bit for
bit. The reference's draws (params, tokens, cohorts, Neumann depths, the
int8 codec's noise) are carried across through numpy; compiled reference
programs are shared through module-scoped fixtures."""
import functools
import math

import numpy as np
import pytest
import torch

import test_torch_lm_train as L
from test_torch_harness import ReferenceNoise, neumann_k, to_torch
from test_torch_population import _Int8Levels

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.configs import FedConfig as RefFed  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.core.tree_util import tree_stack as ref_stack  # noqa: E402
from repro.data.synthetic import FederatedLMData as RefData  # noqa: E402
from repro.data.synthetic import make_client_batch as ref_batch  # noqa: E402
from repro.data.synthetic import make_cohort_batch as ref_cohort  # noqa: E402
from repro.fed import runtime as ref_rt  # noqa: E402
from repro.models.params import init_params as ref_init  # noqa: E402
from repro_torch.configs import FedConfig, ShapeConfig  # noqa: E402
from repro_torch.core.tree_util import (tree_leaves, tree_map,  # noqa: E402
                                        tree_pack_stacked, tree_stack,
                                        tree_unpack_stacked)
from repro_torch.fed import compress, runtime  # noqa: E402
from repro_torch.kernels import ops, quantize as qkern  # noqa: E402

N, C, Q, K = 4, 2, 2, 2
ROUNDS = 2
# rounds and cohorts of the tests: every id appears, and round 1's cohort
# holds a client that round 0's did not (stale under participants)
COHORTS = ([0, 2], [3, 2])
# Tolerances, normwise per leaf, from the readings in each test's
# docstring (the worst over its leaves). Where the Neumann loop reads the
# bf16 feature cache (depth K-1 at some client and step: every seed of 4
# clients), w parts from the reference as the trainer's runs do at depth > 0
# (test_torch_lm_train.CACHE_REL), and the other leaves follow it.
ROUND_REL = L.CACHE_REL
# The lossy codecs make discrete choices (an int8 level, a top-k entry)
# that a rounding difference can flip: one int8 level moves an element by
# 1/127 of its leaf's largest delta, and error feedback carries it on (the
# w cache's 1e-3 made 1.4e-2 after one int8 round, 3.8e-2 after two; topk
# 1.6e-2). So the codec rounds run at K = 1 (no cache), and int8 goes on
# with the reference's levels (test_torch_population._Int8Levels, which
# also holds the levels themselves: one step apart at most, about as often
# as the drift of x / scale predicts). Their EF residuals are remainders
# under one level, whose rounding is relative to the delta: EF_REL.
EF_REL = 1e-2


@functools.lru_cache(maxsize=None)
def _trainers(codec="none", k=K):
    ref_cfg, cfg = L._cfgs("float32")
    kw = dict(q=Q, neumann_k=k, lr_x=1e-2, lr_y=1e-1, fused="on",
              codec=codec, error_feedback=True, rho=L.RHO)
    ref_tr = ref_rt.FederatedTrainer(ref_cfg, RefFed(**kw),
                                     RefShape("t", L.SEQ, L.BATCH, "train"))
    tr = runtime.FederatedTrainer(cfg, FedConfig(**kw),
                                  ShapeConfig("t", L.SEQ, L.BATCH, "train"),
                                  device="cpu")
    return ref_tr, tr


@functools.lru_cache(maxsize=None)
def _data():
    """The bank's init batch ([N, ...]) and each round's cohort batches
    ([q, C, ...]), from the reference's data, as numpy."""
    ref_tr, _ = _trainers()
    specs_c, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, C,
                                           ref_tr.fed)
    specs_n = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
        (N,) + s.shape[1:], s.dtype), specs_c)
    data = RefData(vocab=ref_tr.cfg.vocab, n_clients=N)
    b0 = jax.tree.map(np.asarray, ref_batch(data, ref_tr.cfg, specs_n, 0))
    rounds = [jax.tree.map(np.asarray, ref_stack([
        ref_cohort(data, ref_tr.cfg, specs_c, r * Q + j, np.asarray(ids))
        for j in range(Q)])) for r, ids in enumerate(COHORTS)]
    return b0, rounds


def depth(key, gid: int, t: int, k: int = K) -> int:
    """The reference's Neumann depth of client ``gid`` at server step t
    (``fold_in(fold_in(key, gid), t)``, AdaFBiO's split)."""
    kk = jax.random.fold_in(jax.random.fold_in(key, gid), t)
    return neumann_k(jax.random.split(kk)[0], k)


def round_depths(key, r: int, ids, q: int = Q, k: int = K) -> torch.Tensor:
    """[q, C] depths of round r's steps for ``ids`` at the server counter
    r(q + 1) + j."""
    return torch.tensor([[depth(key, g, r * (q + 1) + j, k) for g in ids]
                         for j in range(q)])


@functools.lru_cache(maxsize=None)
def _ref_init(seed, k=K):
    ref_tr, _ = _trainers(k=k)
    b0, _ = _data()
    return jax.jit(ref_tr.init_population_states, static_argnums=2)(
        jax.random.PRNGKey(seed), jax.tree.map(jnp.asarray, b0), N)


def _port_init(seed, codec="none"):
    """The port's bank init from the reference's params and init depths."""
    ref_tr, tr = _trainers(codec)
    key = jax.random.PRNGKey(seed)
    params = ref_init(ref_tr.specs, jax.random.fold_in(key, L.PARAM_SALT),
                      ref_tr.cfg.dtype)
    k0 = torch.tensor([neumann_k(kk, K) for kk in jax.random.split(key, N)])
    b0, _ = _data()
    return tr.init_population_states(to_torch(params), to_torch(b0), k0), k0


def assert_bank(got, want, rel, what):
    print(what, {name: "%.2e" % max(L.rel_errs(got[name], want[name]))
                 for name in ("x", "y", "v", "w")})
    for name in ("x", "y", "v", "w"):
        L.assert_rel(got[name], want[name], rel, f"{what}: {name}")


def test_population_init_matches_reference():
    """Readings: x, y 4.4e-8, v 4.5e-7, w 8.9e-5 (clients 0-2 draw depth
    K-1 at init: the bf16 feature cache)."""
    (bank, last, server), k0 = _port_init(L.DEEP_SEED)
    r_bank, r_last, r_server = _ref_init(L.DEEP_SEED)
    assert int(k0.max()) == K - 1, k0
    assert_bank(bank, r_bank, ROUND_REL, "init bank")
    L.assert_server(server, r_server, "init server", ROUND_REL)
    assert torch.equal(last, torch.zeros(N, dtype=torch.int32))
    assert np.array_equal(np.asarray(r_last), last.numpy())


@functools.lru_cache(maxsize=None)
def _ref_step():
    ref_tr, _ = _trainers()
    return jax.jit(ref_tr.cohort_local_step_fn(N))


@pytest.mark.parametrize("seed", [L.SEED, L.DEEP_SEED])
def test_cohort_step_matches_reference(seed):
    """One cohort step (C > 1 clients, one at a time) from the reference's own
    gathered states: the depths of the cohort's global ids at t = 0 and the
    η_t schedule at the population size N. Readings: at SEED (depths 0, 0)
    w 2.1e-6, the rest below 4e-7; at DEEP_SEED (depths 1, 0) w 2.4e-4,
    the rest below 4e-7."""
    _, tr = _trainers()
    r_bank, _, r_server = _ref_init(seed)
    ids = COHORTS[0]
    cur = jax.tree.map(lambda a: a[np.asarray(ids)], r_bank)
    b = jax.tree.map(lambda a: a[0], _data()[1][0])
    key = jax.random.PRNGKey(seed)
    want = _ref_step()(cur, r_server, jax.tree.map(jnp.asarray, b), key,
                       jnp.asarray(ids))
    k = round_depths(key, 0, ids)[0]
    got = tr.cohort_local_step_fn(N)(to_torch(cur), to_torch(r_server),
                                     to_torch(b), k, torch.tensor(ids))
    rel = L.cache_rel(seed)
    assert_bank(got[0], want[0], rel, f"cohort step at seed {seed}")
    L.assert_server(got[1], want[1], "cohort step server", rel)
    if seed == L.DEEP_SEED:
        assert int(k.max()) == K - 1, k


@functools.lru_cache(maxsize=None)
def _ref_round(codec, sync_mode, k):
    ref_tr, _ = _trainers(codec, k)
    return jax.jit(ref_tr.population_round_fn(
        N, sync_mode=sync_mode,
        staleness_decay=0.5 if sync_mode == "participants" else 0.0))


# (codec, sync mode, seed, K): the lossy codecs at K = 1, where no depth
# reads the bf16 feature cache (see EF_REL)
CASES = [("none", "broadcast", L.DEEP_SEED, K),
         ("none", "participants", L.DEEP_SEED, K),
         ("int8", "broadcast", L.SEED, 1), ("topk", "participants", L.SEED, 1)]


def _rounds(codec, sync_mode, k, key, round_fn, noise, ref_state, state):
    """Both packages' ROUNDS population rounds from their states; returns
    whether a depth K-1 was drawn, and the final states."""
    r_bank, r_last, r_ef, r_server = ref_state
    bank, last, ef, server = state
    lossy = codec != "none"
    deep = False
    for r, ids in enumerate(COHORTS):
        batches = _data()[1][r]
        jids = jnp.asarray(ids)
        if lossy:
            r_bank, r_last, r_ef, r_server = _ref_round(codec, sync_mode, k)(
                r_bank, r_last, r_ef, r_server, jids,
                jax.tree.map(jnp.asarray, batches), key, jnp.int32(r))
        else:
            r_bank, r_last, r_server = _ref_round(codec, sync_mode, k)(
                r_bank, r_last, r_server, jids,
                jax.tree.map(jnp.asarray, batches), key, jnp.int32(r))
        k_q = round_depths(key, r, ids, k=k)
        deep |= k > 1 and int(k_q.max()) == k - 1
        t_ids = torch.tensor(ids)
        if lossy:
            u = noise(r, t_ids) if codec == "int8" else None
            bank, last, ef, server = round_fn(bank, last, ef, server, t_ids,
                                              to_torch(batches), k_q, r, u)
        else:
            bank, last, server = round_fn(bank, last, server, t_ids,
                                          to_torch(batches), k_q, r)
        assert int(server["t"]) == (Q + 1) * (r + 1)
    return (deep, (r_bank, r_last, r_ef, r_server),
            (bank, last, ef, server))


@pytest.mark.parametrize("codec,sync_mode,seed,k", CASES)
def test_population_rounds_match_reference(codec, sync_mode, seed, k):
    """ROUNDS rounds of the population round (gather, q cohort steps, the
    codec leg, the staleness-weighted aggregate, the server step, the
    write-back), the port starting from the reference's init. Readings
    (worst leaf over the rounds): none at DEEP_SEED (the depths include
    K-1), broadcast 1.24e-3 (w), participants 4.1e-4; at K = 1 int8 + EF
    2.3e-6 (bank; EF 3.9e-3), topk + EF 1.2e-6. ``last_sync`` exactly; the
    server's t q + 1 a round; the EF bank's rows change only for the
    clients that sent."""
    ref_tr, tr = _trainers(codec, k)
    key = jax.random.PRNGKey(seed)
    r_bank, r_last, r_server = _ref_init(seed, k)
    lossy = codec != "none"
    r_ef = ref_tr.init_ef_bank(N) if lossy else None
    bank, last, server = to_torch(r_bank), to_torch(r_last), to_torch(
        r_server)
    ef = tr.init_ef_bank(N)
    round_fn = tr.population_round_fn(
        N, sync_mode=sync_mode,
        staleness_decay=0.5 if sync_mode == "participants" else 0.0)
    sizes = [math.prod(t.shape[1:]) for t in tree_leaves(bank)]
    noise = ReferenceNoise(key, sizes)
    levels = _Int8Levels(key, sizes, N, ROUNDS, replay=True)
    with pytest.MonkeyPatch.context() as mp:
        if codec == "int8":
            levels.patch(mp)
        deep = _rounds(codec, sync_mode, k, key, round_fn, noise, (
            r_bank, r_last, r_ef, r_server), (bank, last, ef, server))
    (r_bank, r_last, r_ef, r_server), (bank, last, ef, server) = deep[1:]
    assert deep[0] == (k > 1)
    rel = ROUND_REL if k > 1 else L.TRAIN_REL
    assert_bank(bank, r_bank, rel, f"{codec} {sync_mode}")
    L.assert_server(server, r_server, f"{codec} {sync_mode} server", rel)
    assert np.array_equal(last.numpy(), np.asarray(r_last))
    if codec == "int8":
        assert sorted(levels.syncs) == list(range(ROUNDS))
        for r, (compared, differ, worst, expected) in levels.syncs.items():
            assert compared == C * sum(sizes) and worst <= 1, r
            assert abs(differ - expected) <= 5 * math.sqrt(expected) + 5
    if lossy:
        L.assert_rel(ef, r_ef, EF_REL, "EF bank")
        touched = sorted(set(sum(COHORTS, [])))
        for t in tree_leaves(ef):
            assert t[touched].abs().max() > 0
            others = [i for i in range(N) if i not in touched]
            assert not others or not t[others].any()
    if sync_mode == "broadcast":
        for t in tree_leaves(bank):
            assert all(torch.equal(t[i], t[0]) for i in range(N))


def _packed_messages(codec, ref, cur, ef, u):
    """The packed route: the whole message as one [C, n] f32 buffer, one
    quantize and one dequantize call over every leaf segment, the noise of
    each leaf concatenated (the route the leaf route replaced)."""
    fl_ref, spec = tree_pack_stacked(ref)
    delta = tree_pack_stacked(cur, spec)[0] - fl_ref
    delta = delta + tree_pack_stacked(ef, spec)[0]
    sizes = [math.prod(s) for s in spec.shapes]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    table = torch.from_numpy(offsets)
    u_all = torch.cat([u(i, s) for i, s in enumerate(sizes)], dim=1)
    scale = ops.leaf_scales(delta, tuple(int(o) for o in offsets),
                            codec.qmax)
    sent = qkern.dequantize(qkern.quantize_stoch(delta, u_all, scale, table,
                                                 codec.qmax), scale, table)
    return (tree_unpack_stacked(fl_ref + sent, spec),
            tree_unpack_stacked(delta - sent, spec.with_dtype(torch.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_route_equals_packed_route_bit_for_bit(dtype, monkeypatch):
    """``client_messages`` leaf by leaf against the packed route on the
    bank's shapes (bf16 leaves with f32 norms in the bf16 case), with the
    same noise: the reconstructions (each leaf's dtype) and the new f32
    residuals bit for bit, and one quantize and one dequantize call a
    leaf."""
    _, tr = _trainers("int8")
    (bank, _, _), _ = _port_init(L.SEED, "int8")
    gen = torch.Generator().manual_seed(4)
    like = {k: bank[k] for k in bank}
    if dtype == "bfloat16":
        like = tree_map(lambda a: a.to(torch.bfloat16) if a.dim() > 2
                        else a, like)
    ref = tree_map(lambda a: a[:C].clone(), like)
    cur = tree_map(lambda a: (a.float() + 1e-3 * torch.randn(
        a.shape, generator=gen)).to(a.dtype), ref)
    ef = tree_map(lambda a: 1e-4 * torch.randn(a.shape, generator=gen,
                                                dtype=torch.float32), ref)
    u = compress.CodecNoise(3, "cpu")(5, torch.tensor(COHORTS[0]))
    calls = []

    def counting(*a):
        calls.append(a[0].shape)
        return qkern.quantize_stoch(*a)
    monkeypatch.setattr(ops, "quantize_stoch", counting)
    got = compress.client_messages(tr.codec, ref, cur, ef, u)
    monkeypatch.undo()
    want = _packed_messages(tr.codec, ref, cur, ef, u)
    leaves = tree_leaves(ref)
    assert [tuple(s) for s in calls] == [
        (C, math.prod(t.shape[1:])) for t in leaves]
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int16 if g.element_size() == 2
                                  else torch.int32),
                           w.view(torch.int16 if w.element_size() == 2
                                  else torch.int32))
    assert any(t.dtype == torch.bfloat16 for t in tree_leaves(got[0])) == (
        dtype == "bfloat16")
