"""The LM trainer's gossip rounds against the JAX reference at
``reduced(qwen1.5-4b)`` in f32: a ring of 4 nodes (Metropolis weights, no
server: each node steps against its own server row, whose accumulator
kernel 2 takes per row), q = 2, the int8 codec with error feedback. The
bank init with its per-node server bank; rounds free-running at K = 1 with
the reference's int8 levels replayed (test_torch_population._Int8Levels,
which also holds the levels themselves); and rounds stage by stage at
K = 2 where the depths include K-1. The reference's draws (params, tokens,
Neumann depths, the codec's noise) are carried across through numpy."""
import functools
import math

import numpy as np
import pytest
import torch

import test_torch_lm_population as P
import test_torch_lm_train as L
from test_torch_harness import ReferenceNoise, neumann_k, to_torch
from test_torch_population import _Int8Levels

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.core.tree_util import tree_stack as ref_stack  # noqa: E402
from repro.data.synthetic import FederatedLMData as RefData  # noqa: E402
from repro.data.synthetic import make_client_batch as ref_batch  # noqa: E402
from repro.fed import runtime as ref_rt  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402

N, Q = P.N, P.Q
ROUNDS = 3
# Readings, the worst leaf over the rounds. Free-running at K = 1 with the
# levels replayed, the packages part by f32 rounding alone: bank 7.6e-6
# (w), a 6.7e-8 (TRAIN_REL). Stage by stage at K = 2, where the bf16
# feature cache parts w: x 1.2e-4, v 1.4e-4, w 4.1e-4 (ROUND_REL). The EF
# residuals are remainders under one level, whose rounding is relative to
# the delta (test_torch_lm_population.EF_REL): 9.1e-3 free, 2.6e-2 by
# stages, where the cache moves the deltas themselves.
FREE_REL = L.TRAIN_REL
EF_REL = 5e-2


@functools.lru_cache(maxsize=None)
def _batches():
    """Each round's batches of every node ([q, N, ...]), the reference's
    data, as numpy."""
    ref_tr, _ = P._trainers()
    specs_n, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, N,
                                           ref_tr.fed)
    data = RefData(vocab=ref_tr.cfg.vocab, n_clients=N)
    return specs_n, [jax.tree.map(np.asarray, ref_stack([
        ref_batch(data, ref_tr.cfg, specs_n, r * Q + j) for j in range(Q)]))
        for r in range(ROUNDS)]


@functools.lru_cache(maxsize=None)
def _ref_init(seed, k):
    ref_tr, _ = P._trainers("int8", k)
    specs_n, _ = _batches()
    data = RefData(vocab=ref_tr.cfg.vocab, n_clients=N)
    b0 = ref_batch(data, ref_tr.cfg, specs_n, 0)
    return jax.jit(ref_tr.init_gossip_states, static_argnums=2)(
        jax.random.PRNGKey(seed), b0, N)


@functools.lru_cache(maxsize=None)
def _ref_round(k):
    ref_tr, _ = P._trainers("int8", k)
    return jax.jit(ref_tr.gossip_round_fn(N, topology="ring"),
                   static_argnames=("n_steps", "sync_first"))


def test_gossip_init_matches_reference():
    """The bank as the population init, and the star server state on a
    leading [n] axis, one row a node. Readings: w 8.9e-5, a 1.8e-4."""
    ref_tr, tr = P._trainers("int8", P.K)
    key = jax.random.PRNGKey(L.DEEP_SEED)
    params = P.ref_init(ref_tr.specs, jax.random.fold_in(key, L.PARAM_SALT),
                        ref_tr.cfg.dtype)
    k0 = torch.tensor([neumann_k(kk, P.K) for kk in jax.random.split(key, N)])
    specs_n, _ = _batches()
    data = RefData(vocab=ref_tr.cfg.vocab, n_clients=N)
    b0 = jax.tree.map(np.asarray, ref_batch(data, ref_tr.cfg, specs_n, 0))
    bank, srv_bank = tr.init_gossip_states(to_torch(params), to_torch(b0),
                                           k0)
    r_bank, r_srv = _ref_init(L.DEEP_SEED, P.K)
    P.assert_bank(bank, r_bank, P.ROUND_REL, "gossip init bank")
    L.assert_rel(srv_bank["adaptive"]["a"], r_srv["adaptive"]["a"],
                 P.ROUND_REL, "per-node a")
    assert srv_bank["t"].tolist() == [0] * N
    for t in tree_leaves(srv_bank["adaptive"]["a"]):
        assert all(torch.equal(t[i], t[0]) for i in range(N))


@pytest.mark.parametrize("seed,k,stages", [(L.SEED, 1, False),
                                          (L.DEEP_SEED, P.K, True)])
def test_gossip_ring_int8_rounds_match_reference(seed, k, stages):
    """ROUNDS gossip rounds on the ring (round 0 without the opening mix),
    int8 + EF, every round's bank, per-node server bank and EF against the
    reference's; the per-node counters advance in lockstep, q + 1 a round
    after round 0."""
    _, tr = P._trainers("int8", k)
    key = jax.random.PRNGKey(seed)
    r_bank, r_srv = _ref_init(seed, k)
    ref_tr, _ = P._trainers("int8", k)
    r_ef = ref_tr.init_ef_bank(N)
    bank, srv_bank, ef = to_torch(r_bank), to_torch(r_srv), tr.init_ef_bank(
        N)
    round_fn = tr.gossip_round_fn(N, topology="ring")
    sizes = [math.prod(t.shape[1:]) for t in tree_leaves(bank)]
    noise = ReferenceNoise(key, sizes)
    levels = _Int8Levels(key, sizes, N, ROUNDS, replay=True)
    ids = torch.arange(N)
    deep = False
    rel = P.ROUND_REL if stages else FREE_REL
    with pytest.MonkeyPatch.context() as mp:
        levels.patch(mp)
        for r in range(ROUNDS):
            batches = _batches()[1][r]
            if stages:
                bank, srv_bank, ef = (to_torch(r_bank), to_torch(r_srv),
                                      to_torch(r_ef))
            r_bank, r_srv, r_ef = _ref_round(k)(
                r_bank, r_srv, r_ef, jax.tree.map(jnp.asarray, batches), key,
                jnp.int32(r), n_steps=Q, sync_first=r > 0)
            k_q = P.round_depths(key, r, range(N), k=k)
            deep |= k > 1 and int(k_q.max()) == k - 1
            bank, srv_bank, ef = round_fn(bank, srv_bank, ef,
                                          to_torch(batches), k_q, r,
                                          noise(r, ids), sync_first=r > 0)
            assert srv_bank["t"].tolist() == [(Q + 1) * r + Q] * N
            print(f"round {r} stages {stages}:", {
                name: "%.2e" % max(L.rel_errs(bank[name], r_bank[name]))
                for name in "xyvw"}, "a %.2e" % max(L.rel_errs(
                    srv_bank["adaptive"]["a"], r_srv["adaptive"]["a"])),
                "ef %.2e" % max(L.rel_errs(ef, r_ef)))
            L.assert_states(bank, r_bank, f"round {r} bank", rel, rel)
            L.assert_rel(srv_bank["adaptive"]["a"], r_srv["adaptive"]["a"],
                         rel, f"round {r} per-node a")
            L.assert_rel(ef, r_ef, EF_REL, f"round {r} EF")
    assert deep == stages
    assert sorted(levels.syncs) == list(range(ROUNDS))
    for r, (compared, differ, worst, expected) in levels.syncs.items():
        assert compared == N * sum(sizes) and worst <= 1, r
        assert abs(differ - expected) <= 5 * math.sqrt(expected) + 5
