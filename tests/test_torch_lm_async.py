"""The LM trainer's asynchronous population rounds against the JAX
reference at ``reduced(qwen1.5-4b)`` in f32 (N = 4 clients, cohorts of
C = 2, q = 2, K = 2): the bank init and its async bookkeeping, then rounds
of overlapping cohorts with delayed arrivals, a staleness bound and the
delay-adaptive step, under the tiered and the uniform delay models. The
per-round stats (arrivals, acceptances, drops, dispatches, syncs, the
staleness of each accepted arrival) and the staleness histograms, by tier
too, are held exactly; the state free-running at K = 1, and stage by
stage (each round from the reference's state before it) at K = 2 where the
depths include K-1. The reference's delay draws come through
``test_torch_async.ReferenceDelayDraws``; a step's Neumann depth follows
the reference's server counter, which advances at a round's server step
only when an arrival was accepted."""
import functools

import numpy as np
import pytest
import torch

import test_torch_lm_population as P
import test_torch_lm_train as L
from test_torch_async import ReferenceDelayDraws
from test_torch_harness import neumann_k, to_torch

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.core.tree_util import tree_stack as ref_stack  # noqa: E402
from repro.data.synthetic import FederatedLMData as RefData  # noqa: E402
from repro.data.synthetic import make_cohort_batch as ref_cohort  # noqa: E402
from repro.fed import population as ref_pop  # noqa: E402
from repro.fed import runtime as ref_rt  # noqa: E402
from repro_torch.fed import population  # noqa: E402

N, C, Q, K = P.N, P.C, P.Q, P.K
# overlapping cohorts: client 3 is sampled again while its first update
# may still be in flight, client 1 twice in a row
COHORTS = ([0, 3], [1, 3], [2, 1], [3, 0])
# (delay model, its knobs, sync mode, staleness decay): fast and slow
# tiers of two clients each, and uniform delays over [1, 2]
MODELS = {
    "tiers": (dict(tier_fracs=(0.5, 0.5), tier_delays=((1, 1), (2, 3)),
                   max_delay=3), "participants", 0.5),
    "uniform": (dict(max_delay=2), "broadcast", 0.0)}
ASYNC = dict(max_staleness=2, delay_eta=0.5)


@functools.lru_cache(maxsize=None)
def _batches():
    """Each round's cohort batches ([q, C, ...]), the reference's data."""
    ref_tr, _ = P._trainers()
    specs_c, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, C,
                                           ref_tr.fed)
    data = RefData(vocab=ref_tr.cfg.vocab, n_clients=N)
    return [jax.tree.map(np.asarray, ref_stack([
        ref_cohort(data, ref_tr.cfg, specs_c, r * Q + j, np.asarray(ids))
        for j in range(Q)])) for r, ids in enumerate(COHORTS)]


@functools.lru_cache(maxsize=None)
def _ref_init(seed, k=K):
    ref_tr, _ = P._trainers(k=k)
    b0, _ = P._data()
    return jax.jit(ref_tr.init_async_population_states, static_argnums=2)(
        jax.random.PRNGKey(seed), jax.tree.map(jnp.asarray, b0), N)


def _models(name, key):
    """The reference's delay model resolved from ``key``, and the port's
    from the reference's draws."""
    kw, _, _ = MODELS[name]
    ref_dm = ref_pop.make_delay_model(name, **kw).resolve(key, N)
    draws = ReferenceDelayDraws(key)
    return ref_dm, population.make_delay_model(name, **kw).resolve(draws, N)


@functools.lru_cache(maxsize=None)
def _ref_round(name, seed, k):
    ref_tr, _ = P._trainers(k=k)
    _, sync_mode, decay = MODELS[name]
    ref_dm, _ = _models(name, jax.random.PRNGKey(seed))
    return jax.jit(ref_tr.async_population_round_fn(
        N, sync_mode=sync_mode, staleness_decay=decay, delay_model=ref_dm,
        max_delay=MODELS[name][0]["max_delay"], **ASYNC))


def test_async_init_matches_reference():
    """The init dict: the bank (as the population init), the pending
    buffer a copy of it, the anchor the bank's mean, the bookkeeping
    vectors exactly. Readings: w 8.9e-5, anchor w 5.3e-5, the rest below
    5e-7."""
    _, tr = P._trainers()
    want = _ref_init(L.DEEP_SEED)
    got = tr.init_async_population_states(*_init_inputs(L.DEEP_SEED))
    for key in ("bank", "pending"):
        P.assert_bank(got[key], want[key], P.ROUND_REL, f"init {key}")
    L.assert_rel(got["anchor"], want["anchor"], P.ROUND_REL, "anchor")
    for key in ("last_sync", "in_flight", "dispatch_round", "return_round"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


def _init_inputs(seed):
    """The reference's params, the bank's init batch and the init depths,
    as the port's inputs."""
    ref_tr, _ = P._trainers()
    key = jax.random.PRNGKey(seed)
    params = P.ref_init(ref_tr.specs, jax.random.fold_in(key, L.PARAM_SALT),
                        ref_tr.cfg.dtype)
    k0 = torch.tensor([neumann_k(kk, K) for kk in jax.random.split(key, N)])
    return to_torch(params), to_torch(P._data()[0]), k0


def _assert_state(state, ref_state, rel, w_rel, what):
    for key in ("bank", "pending"):
        L.assert_states(state[key], ref_state[key], f"{what} {key}", rel,
                        w_rel)
    L.assert_states(state["anchor"], ref_state["anchor"], f"{what} anchor",
                    rel, w_rel)
    L.assert_server(state["server"], ref_state["server"], f"{what} server",
                    rel)
    for key in ("last_sync", "in_flight", "dispatch_round", "return_round"):
        assert np.array_equal(state[key].numpy(),
                              np.asarray(ref_state[key])), (what, key)


# (delay model, seed, K, stages): free-running at K = 1, where the
# packages part by f32 rounding alone, which the adaptive step grows
# round by round (ROADMAP section 3; rho 1e-2 here) to 4.4e-4 in w
# after four rounds: FREE_REL. Stage by stage at K = 2: a client that
# steps twice at depth K-1 reads the bf16 feature cache twice, and its w
# parts by up to 1.3e-2 in one round at t = 9 (the cohort step's 2.4e-4 at
# t = 0; eta at N = 4 is 1.6 times its one-client size): W_REL, with x,
# y, v, the anchor and the server at ROUND_REL (1.2e-4, 1e-7, 4.1e-4).
# Free-running at K = 2 these compound to 4.3e-2 by round 3.
FREE_REL = 1e-3
W_REL = 3e-2
CASES = [("tiers", L.SEED, 1, False), ("uniform", L.SEED, 1, False),
         ("tiers", L.DEEP_SEED, K, True)]


@pytest.mark.parametrize("name,seed,k,stages", CASES)
def test_async_rounds_match_reference(name, seed, k, stages):
    """Four async rounds, the port from the reference's init: the stats of
    every round exactly, the accepted-staleness histogram and, for the
    tiers, the histogram by tier exactly; the bank, the pending buffer,
    the anchor and the server normwise, every round (see FREE_REL and
    W_REL for the readings)."""
    _, tr = P._trainers(k=k)
    key = jax.random.PRNGKey(seed)
    ref_state = _ref_init(seed, k)
    state = to_torch(ref_state)
    ref_dm, dm = _models(name, key)
    _, sync_mode, decay = MODELS[name]
    round_fn = tr.async_population_round_fn(
        N, sync_mode=sync_mode, staleness_decay=decay, delay_model=dm,
        delay_draws=ReferenceDelayDraws(key),
        max_delay=MODELS[name][0]["max_delay"], **ASYNC)
    tier_of = np.asarray(dm.tiers(ReferenceDelayDraws(key), N))
    hist = {"ref": np.zeros(0, np.int64), "port": np.zeros(0, np.int64)}
    by_tier = {"ref": {}, "port": {}}
    accepted = dropped = 0
    deep = False
    for r, ids in enumerate(COHORTS):
        batches = _batches()[r]
        t_before = int(ref_state["server"]["t"])
        if stages:
            state = to_torch(ref_state)
        ref_state, ref_stats = _ref_round(name, seed, k)(
            ref_state, jnp.asarray(ids), jax.tree.map(jnp.asarray, batches),
            key, jnp.int32(r))
        t0 = t_before + int(ref_stats["accepted"] > 0)
        k_q = torch.tensor([[P.depth(key, g, t0 + j, k) for g in ids]
                            for j in range(Q)])
        deep |= k > 1 and int(k_q.max()) == k - 1
        state, stats = round_fn(state, torch.tensor(ids), to_torch(batches),
                                k_q, r)
        for stat in ref_stats:
            np.testing.assert_array_equal(
                np.asarray(stats[stat].numpy(), np.float32),
                np.asarray(ref_stats[stat], np.float32), f"round {r} {stat}")
        for side, st in (("ref", np.asarray(ref_stats["staleness"])),
                         ("port", stats["staleness"].numpy())):
            if (st >= 0).any():
                hist[side] = population.accum_staleness_hist(hist[side],
                                                             st[st >= 0])
            population.accum_tier_hists(by_tier[side], st, tier_of, 2)
        accepted += int(stats["accepted"])
        dropped += int(stats["dropped"])
        rel = P.ROUND_REL if stages else FREE_REL
        _assert_state(state, ref_state, rel, W_REL if stages else rel,
                      f"{name} round {r}")
    assert deep == (k > 1) and accepted > 0
    assert np.array_equal(hist["port"], hist["ref"])
    assert sorted(by_tier["port"]) == sorted(by_tier["ref"])
    for t in by_tier["ref"]:
        assert np.array_equal(by_tier["port"][t], by_tier["ref"][t])
    assert int(hist["port"].sum()) == accepted
    print(f"{name}: accepted {accepted}, dropped {dropped}, histogram "
          f"{hist['port'].tolist()}, by tier "
          f"{ {t: h.tolist() for t, h in by_tier['port'].items()} }")
