"""The port's asynchronous population engine and its delay models against
the reference's.

Fed the reference's delay draws (``ReferenceDelayDraws``: the same salts
and key chain), every delay model's schedule and tier assignment equals the
reference's exactly, as do ``load_delay_trace``'s tables and errors and the
masked write-back ``scatter_where``. One ``make_async_round`` after another
(participants sync, staleness decay, a staleness bound, delay-adaptive
eta, int8 with error feedback, overlapping cohorts with a duplicate id)
gives the reference's stats exactly and its state within 1e-5. ``FedDriver``
on an asynchronous population (uniform delays, tiers, int8 participants)
follows the reference's within 1e-4 on the quadratic problem, with the
accounting, the staleness log and the histograms equal; its Neumann draws
follow the reference's server counter, which advances at a round's server
step only when an arrival was accepted. The degenerate setting (every delay
one round, no gate, no delay adaptation) follows the synchronous population
path within 1e-5."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_harness import (ReferenceNoise, ReplaySampler,
                                assert_trees_close, neumann_k,
                                quadratic_pair, to_torch)

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.configs import FedConfig as RefFedConfig  # noqa: E402
from repro.configs import PopulationConfig as RefPopulationConfig  # noqa: E402
from repro.core.bilevel import quadratic_bilevel_problem as ref_quad  # noqa: E402
from repro.core.bilevel import quadratic_true_grad as ref_true_grad  # noqa: E402
from repro.fed import compress as ref_compress  # noqa: E402
from repro.fed import population as ref_pop  # noqa: E402
from repro.fed import sampling as ref_sampling  # noqa: E402
from repro.tasks.driver import FedDriver as RefFedDriver  # noqa: E402
from repro_torch.configs import FedConfig, PopulationConfig  # noqa: E402
from repro_torch.core.bilevel import (quadratic_bilevel_problem,  # noqa: E402
                                      quadratic_true_grad)
from repro_torch.fed import compress, population, sampling  # noqa: E402
from repro_torch.tasks import Draws, FedDriver  # noqa: E402

KEY = jax.random.PRNGKey(0)
K, Q = 8, 2
QUAD_SIZES = [6, 8, 8, 6]       # state leaves v, w, x, y (sorted keys)
INF = float("inf")


class ReferenceDelayDraws:
    """The port's delay draw source filled from the reference's key chain
    (fed/population.py): ``fold_in(fold_in(key, salt), round)`` for the
    per-round draws, ``fold_in(key, salt)`` for the permanent ones."""
    device = torch.device("cpu")

    def __init__(self, key):
        self.key = key

    def _k(self, *parts):
        k = self.key
        for p in parts:
            k = jax.random.fold_in(k, p)
        return k

    @staticmethod
    def _t(a):
        return torch.from_numpy(np.array(a))

    def randint(self, salt, round_id, n, low, high):
        return self._t(jax.random.randint(self._k(salt, round_id), (n,),
                                          low, high).astype(jnp.int32))

    def uniform(self, salt, round_id, n):
        return self._t(jax.random.uniform(self._k(salt, round_id), (n,)))

    def normal(self, salt, n):
        return self._t(jax.random.normal(self._k(salt), (n,)))

    def permutation(self, salt, n):
        return self._t(jax.random.permutation(self._k(salt), n))


# ------------------------------------------------------------ delay models

DELAY_CASES = [
    ("uniform", dict(max_delay=1)), ("uniform", dict(max_delay=4)),
    ("tiers", dict(max_delay=8)),
    ("tiers", dict(max_delay=6, tier_fracs=(0.5, 0.5),
                   tier_delays=((1, 2), (3, 6)))),
    ("lognormal", dict(max_delay=6, mu=0.5, sigma=0.8)),
    ("trace", dict(table=np.arange(30, dtype=np.int32).reshape(3, 10) % 5
                   + 1))]


@pytest.mark.parametrize("name, kw", DELAY_CASES)
def test_delay_schedules_equal_reference(name, kw):
    n = 10
    draws = ReferenceDelayDraws(KEY)
    port = population.make_delay_model(name, **kw)
    ref = ref_pop.make_delay_model(name, **kw)
    assert port.bound == ref.bound
    for resolved in (False, True):
        p = port.resolve(draws, n) if resolved else port
        r_ = ref.resolve(KEY, n) if resolved else ref
        for r in range(6):
            got = p.schedule(draws, r, n)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(
                r_.schedule(KEY, r, n)), f"{name} round {r}")
    if name == "tiers":
        np.testing.assert_array_equal(
            port.tiers(draws, n).numpy(), np.asarray(ref.tiers(KEY, n)))


def test_tiers_and_specs_equal_reference():
    draws = ReferenceDelayDraws(jax.random.PRNGKey(3))
    for n, fracs in ((10, (0.2, 0.6, 0.2)), (7, (0.5, 0.25, 0.25)),
                     (3, (0.9, 0.1))):
        assert population._tier_sizes(n, fracs) == ref_pop._tier_sizes(
            n, fracs)
        np.testing.assert_array_equal(
            population.tier_assignment(draws, n, fracs).numpy(),
            np.asarray(ref_pop.tier_assignment(jax.random.PRNGKey(3), n,
                                               fracs)))
    spec = "0.2:1:1,0.6:2:4,0.2:4:8"
    assert population.parse_tier_spec(spec) == ref_pop.parse_tier_spec(spec)
    for mod in (population, ref_pop):
        with pytest.raises(ValueError, match="tier spec"):
            mod.parse_tier_spec("0.5:1")
        with pytest.raises(ValueError, match="trace"):
            mod.make_delay_model("trace", 2)
        with pytest.raises(ValueError, match=">= 1"):
            mod.make_delay_model("trace", 2, table=np.zeros((2, 3),
                                                            np.int32))


def test_load_delay_trace_equals_reference(tmp_path):
    path = tmp_path / "d.jsonl"
    files = [
        [{"client": 0, "delay": [4, 2, 7]}],
        [{"horizon": 5}, {"client": 1, "delay": 3, "up": [[0, 2]]},
         {"client": 2, "delay": [1, 2]}],
        [{"client": 0, "up": [[1, 4]]}],
        [],
    ]
    for recs in files:
        path.write_text("".join(json.dumps(r) + "\n" for r in recs))
        got = sampling.load_delay_trace(str(path), 3)
        want = ref_sampling.load_delay_trace(str(path), 3)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for recs, match in (([{"client": 1, "delay": 0}], "delays"),
                        ([{"horizon": 2}, {"client": 0,
                                           "delay": [1, 1, 9]}], "horizon"),
                        ([{"client": 5, "delay": 1}], "outside")):
        path.write_text("".join(json.dumps(r) + "\n" for r in recs))
        for fn in (sampling.load_delay_trace, ref_sampling.load_delay_trace):
            with pytest.raises(ValueError, match=match):
                fn(str(path), 3)


@pytest.mark.parametrize("ids, keep", [([4, 1, 4, 0], [1, 1, 0, 1]),
                                       ([2, 2, 2], [0, 1, 0]),
                                       ([5, 3, 1], [0, 0, 0])])
def test_scatter_where_equals_reference(ids, keep):
    rng = np.random.default_rng(0)
    bank = {"a": rng.standard_normal((6, 3)).astype(np.float32)}
    vals = {"a": rng.standard_normal((len(ids), 3)).astype(np.float32)}
    got = population.scatter_where(to_torch(bank), torch.tensor(ids),
                                   to_torch(vals), torch.tensor(keep).bool())
    want = ref_pop.scatter_where(jax.tree.map(jnp.asarray, bank),
                                 jnp.asarray(ids), jax.tree.map(
                                     jnp.asarray, vals),
                                 jnp.asarray(keep, bool))
    assert_trees_close(got, want, rtol=0, atol=0, what="scatter_where")


# ------------------------------------------------------------ rounds

def _quad_pair(n, fed_kw=None, **kw):
    """The reference's quadratic FedDriver and the port's, alike (seed 1,
    as the population tests)."""
    consts, theta = quadratic_pair(seed=1)
    d, p = 8, 6
    ref_fed = RefFedConfig(q=Q, neumann_k=K, lr_x=0.3, lr_y=0.3, theta=theta,
                           **(fed_kw or {}))
    jc = tuple(map(jnp.asarray, consts))
    ref = RefFedDriver(
        ref_quad(*jc), ref_fed, n_clients=n,
        batch_fn=lambda c, s: {"f": 0.0, "g": 0.0, "g0": 0.0,
                               "gi": jnp.zeros((K,))},
        init_xy=lambda k: (jnp.ones((d,)) * 2.0, jnp.zeros((p,))),
        grad_norm_fn=lambda x, y: jnp.linalg.norm(ref_true_grad(*jc, x)))
    tc = tuple(torch.from_numpy(a) for a in consts)
    zero, gi = torch.zeros(()), torch.zeros(K)
    port = FedDriver(
        quadratic_bilevel_problem(*tc), FedConfig(**dataclasses.asdict(
            ref_fed)), n_clients=n,
        batch_fn=lambda c, s: {"f": zero, "g": zero, "g0": zero, "gi": gi},
        init_xy=lambda g: (torch.ones(d) * 2.0, torch.zeros(p)),
        grad_norm_fn=lambda x, y: torch.linalg.norm(
            quadratic_true_grad(*tc, x)), device="cpu", **kw)
    return ref, port


def _step_draw(key, gid, t):
    """The reference's AdaFBiO Neumann depth of client ``gid`` at server
    step ``t`` (tasks/driver.py ``_cohort_local_step``)."""
    return neumann_k(jax.random.split(jax.random.fold_in(
        jax.random.fold_in(key, gid), t))[0], K)


def test_async_round_matches_reference():
    """Four rounds of ``make_async_round`` on 6 clients, cohorts of 3 that
    overlap clients still in flight (and hold a duplicate id)."""
    n, c = 6, 3
    ref, port = _quad_pair(n, dict(codec="int8"))
    ref.population = RefPopulationConfig(n=n, cohort=c)
    pop, server = ref._init_population(KEY)
    ref_codec = ref_compress.make_codec("int8")
    kw = dict(sync_mode="participants", staleness_decay=0.5,
              max_staleness=2.0, max_delay=3, delay_eta=0.5)
    ref_round = ref_pop.make_async_round(
        ref._cohort_local_step(n),
        lambda srv, avg: ref.alg.sync_update(srv, avg, n), Q,
        codec=ref_codec, **kw)
    port_round = population.make_async_round(
        lambda st, srv, b, k, ids: port._local_body(st, srv, b, k),
        lambda srv, avg: port.alg.sync_update(srv, avg, n), Q,
        codec=compress.make_codec("int8"),
        delay_draws=ReferenceDelayDraws(KEY), **kw)
    ref_state = ref_pop.init_async_state(pop.states, server, n,
                                         codec=ref_codec)
    state = to_torch(ref_state)
    noise = ReferenceNoise(KEY, QUAD_SIZES)
    zero_b = {"f": 0.0, "g": 0.0, "g0": 0.0, "gi": np.zeros(K, np.float32)}
    batches = jax.tree.map(lambda a: np.zeros((Q, c) + np.shape(a),
                                              np.float32), zero_b)
    for r, ids in enumerate(([0, 3, 4], [4, 1, 2], [5, 0, 5], [3, 1, 2],
                             [2, 4, 0])):
        t_before = int(ref_state["server"]["t"])
        ref_state, ref_stats = ref_round(ref_state, jnp.asarray(ids),
                                         jax.tree.map(jnp.asarray, batches),
                                         KEY, jnp.int32(r))
        t0 = t_before + int(ref_stats["accepted"] > 0)
        draws_q = torch.tensor([[_step_draw(KEY, g, t0 + j) for g in ids]
                                for j in range(Q)])
        t_ids = torch.tensor(ids)
        state, stats = port_round(state, t_ids, to_torch(batches), draws_q,
                                  r, noise(r, t_ids))
        for k in ref_stats:
            np.testing.assert_array_equal(
                np.asarray(stats[k].numpy(), np.float32),
                np.asarray(ref_stats[k], np.float32), f"round {r} {k}")
        assert_trees_close(state, ref_state, rtol=1e-5, atol=1e-5,
                           what=f"state after round {r}")


def _async_draws(ref, n, steps, lengths):
    """The port's Neumann draws for an async run, from the reference's
    staleness log: round r's server step (one counter tick) happens only
    when it accepted an arrival, then its local steps tick once each."""
    init = [neumann_k(k, K) for k in jax.random.split(KEY, n)]
    ts, t = [], 0
    for row, n_steps in zip(ref.staleness_log, lengths):
        t += int(row["accepted"] > 0)
        ts += [t + j for j in range(n_steps)]
        t += n_steps
    assert len(ts) == steps
    return Draws(init=torch.tensor(init),
                 steps=torch.tensor([[_step_draw(KEY, g, tt)
                                      for g in range(n)] for tt in ts]))


@pytest.mark.parametrize("pkw, codec", [
    (dict(max_staleness=2.0, max_delay=3), "none"),
    (dict(max_staleness=3.0, max_delay=8, delay_model="tiers",
          staleness_decay=0.5), "none"),
    (dict(max_staleness=INF, max_delay=3, sync_mode="participants",
          delay_eta=0.5, staleness_decay=0.5), "int8")])
def test_async_driver_matches_reference(pkw, codec):
    n, c, steps = 6, 3, 11
    ref_sampler = ref_sampling.UniformSampler(n, c, jax.random.PRNGKey(4))
    pcfg = dict(n=n, cohort=c, **pkw)
    ref, port = _quad_pair(n, dict(codec=codec),
                           population=PopulationConfig(**pcfg),
                           sampler=ReplaySampler(ref_sampler))
    ref.population = RefPopulationConfig(**pcfg)
    ref.sampler = ref_sampler
    ref_res = ref.run(steps, key=KEY, eval_every=2)
    lengths = [Q] * (steps // Q) + [steps % Q]
    res = port.run(steps, eval_every=2,
                   draws=_async_draws(ref, n, steps, lengths),
                   noise=ReferenceNoise(KEY, QUAD_SIZES),
                   delay_draws=ReferenceDelayDraws(KEY))
    for field in ("steps", "samples", "comms", "bytes_up", "bytes_down"):
        assert getattr(res, field) == getattr(ref_res, field), field
    np.testing.assert_allclose(res.grad_norm, ref_res.grad_norm, rtol=1e-4,
                               atol=1e-4)
    assert_trees_close(res.final_avg_state, ref_res.final_avg_state,
                       rtol=1e-4, atol=1e-4, what="final_avg_state")
    assert_trees_close(port.final_bank, ref.final_bank, rtol=1e-4,
                       atol=1e-4, what="final_bank")
    assert len(port.staleness_log) == len(ref.staleness_log)
    for got, want in zip(port.staleness_log, ref.staleness_log):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=k)
    np.testing.assert_array_equal(port.staleness_hist, ref.staleness_hist)
    assert sum(port.staleness_hist) == sum(r["accepted"]
                                           for r in port.staleness_log)
    assert sorted(port.staleness_hist_by_tier) == sorted(
        ref.staleness_hist_by_tier)
    for tier, hist in ref.staleness_hist_by_tier.items():
        np.testing.assert_array_equal(port.staleness_hist_by_tier[tier],
                                      hist)


def test_degenerate_async_equals_sync_population():
    """max_delay 1, no staleness bound, delay_eta 0: every dispatch returns
    the next round at staleness 1, and the async engine follows the
    synchronous population path (the reference's tests/test_async.py:38)."""
    runs = {}
    s = sampling.UniformSampler(4, 2, 9)
    for name, pcfg in (("sync", PopulationConfig(n=4, cohort=2)),
                       ("async", PopulationConfig(n=4, cohort=2,
                                                  max_staleness=INF))):
        runs[name] = _quad_pair(4, population=pcfg, sampler=s)[1].run(
            16, seed=2, eval_every=4)
    sync, asy = runs["sync"], runs["async"]
    for a, b in zip(jax.tree.leaves(sync.final_avg_state),
                    jax.tree.leaves(asy.final_avg_state)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sync.grad_norm, asy.grad_norm, rtol=1e-5,
                               atol=1e-5)
    assert sync.comms[-1] == asy.comms[-1]
    assert sync.samples[-1] == asy.samples[-1]
    pop = population.ClientPopulation(
        states={}, n=3, last_sync=torch.zeros(3, dtype=torch.int32))
    assert pop.in_flight.dtype == torch.bool and not pop.in_flight.any()
    assert pop.dispatch_round.tolist() == [0, 0, 0]
