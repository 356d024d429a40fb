"""The port's population bank, samplers and partial participation against
the reference's.

Bank primitives and staleness weights equal the reference's; the
population round (participants sync, int8 codec with error feedback) and
``FedDriver``'s masked and population paths follow the reference engine of
the same name to 1e-5 on the quadratic problem and 1e-4 on small
hyper-representation (the reference's engine tolerance,
tests/test_round_engine.py), fed the reference's cohorts, Neumann draws and
codec noise, with ``steps``/``comms``/``bytes_up``/``bytes_down`` equal
exactly. On hyper-representation the int8 levels of both packages are
compared at every sync, and the port goes on with the reference's levels
where an f32 rounding difference put one a step apart. Round-robin and
trace-file cohorts equal the reference's id for id (the trace draw fed the
reference's scores); the uniform and trace samplers are held to their
properties.

Run as a script, the file prints the readings behind the parity notes of
PERF.md (see ``_readings``)."""
import dataclasses
import functools
import math
import sys

import numpy as np
import pytest
import torch

from test_torch_harness import (ReferenceNoise, ReplaySampler,
                                assert_trees_close, neumann_k,
                                quadratic_pair, reference_codec_noise,
                                reference_draws, to_jax, to_torch)

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.configs import FedConfig as RefFedConfig  # noqa: E402
from repro.configs import PopulationConfig as RefPopulationConfig  # noqa: E402
from repro.configs.paper_tasks import HyperRepConfig as RefHyperRepConfig  # noqa: E402
from repro.core.bilevel import quadratic_bilevel_problem as ref_quad  # noqa: E402
from repro.core.bilevel import quadratic_true_grad as ref_true_grad  # noqa: E402
from repro.core.tree_util import tree_norm as ref_tree_norm  # noqa: E402
from repro.fed import compress as ref_compress  # noqa: E402
from repro.fed import population as ref_pop  # noqa: E402
from repro.fed import sampling as ref_sampling  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.tasks.driver import FedDriver as RefFedDriver  # noqa: E402
from repro.tasks.hyperrep import build_hyperrep as ref_build_hyperrep  # noqa: E402
from repro_torch.configs import (FedConfig, HyperRepConfig,  # noqa: E402
                                 PopulationConfig)
from repro_torch.core.bilevel import (quadratic_bilevel_problem,  # noqa: E402
                                      quadratic_true_grad)
from repro_torch.core.tree_util import tree_leaves, tree_norm  # noqa: E402
from repro_torch.fed import compress, population, sampling  # noqa: E402
from repro_torch.interop import to_numpy  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.tasks import FedDriver, build_hyperrep  # noqa: E402

KEY = jax.random.PRNGKey(0)
K, Q = 8, 2


# ------------------------------------------------------------ bank primitives

def _bank(seed, n=6):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((n, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((n, 2, 2)).astype(np.float32)}}


@pytest.mark.parametrize("ids", [[4, 1, 4, 0], [2, 2, 2], [5, 3, 1]])
def test_gather_scatter_last_wins_match_reference(ids):
    bank, vals = _bank(0), _bank(1, n=len(ids))
    t_ids, j_ids = torch.tensor(ids), jnp.asarray(ids, jnp.int32)
    assert_trees_close(population.gather(to_torch(bank), t_ids),
                       ref_pop.gather(to_jax(bank), j_ids), rtol=0, atol=0,
                       what="gather")
    got = population.scatter(to_torch(bank), t_ids, to_torch(vals))
    want = ref_pop.scatter(to_jax(bank), j_ids, to_jax(vals))
    assert_trees_close(got, want, rtol=0, atol=0, what="scatter")
    # the last slot of a duplicate id is the one that lands
    last = {g: j for j, g in enumerate(ids)}
    for g, j in last.items():
        np.testing.assert_array_equal(got["a"][g].numpy(), vals["a"][j])
    assert_trees_close(population.resolve_last_wins(t_ids, to_torch(vals)),
                       ref_pop.resolve_last_wins(j_ids, to_jax(vals))[0],
                       rtol=0, atol=0, what="resolve_last_wins")
    one = jax.tree.map(lambda a: a[0], vals)
    assert_trees_close(population.broadcast(to_torch(bank), to_torch(one)),
                       ref_pop.broadcast(to_jax(bank), to_jax(one)), rtol=0,
                       atol=0, what="broadcast")


@pytest.mark.parametrize("decay", [0.0, 0.5, 2.0])
def test_staleness_weights_match_reference(decay):
    last = np.array([0, 3, 1, 5, 2, 5], np.int32)
    ids = np.array([1, 0, 4, 3], np.int64)
    for r in (3, 5, 9):
        got = population.staleness_weights(torch.from_numpy(last),
                                           torch.from_numpy(ids), r, decay)
        want = ref_pop.staleness_weights(jnp.asarray(last), jnp.asarray(ids),
                                         r, decay)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(float(got.sum()), 1.0, rtol=1e-6)


# ------------------------------------------------------------ samplers

def test_roundrobin_cohorts_equal_reference():
    for n, c, off in ((10, 3, 0), (7, 7, 2), (5, 2, 4)):
        port = sampling.make_sampler("roundrobin", n, c, offset=off)
        ref = ref_sampling.make_sampler("roundrobin", n, c,
                                        jax.random.PRNGKey(0), offset=off)
        for r in range(12):
            np.testing.assert_array_equal(port.cohort(r).numpy(),
                                          np.asarray(ref.cohort(r)))
            np.testing.assert_array_equal(port.mask(r).numpy(),
                                          np.asarray(ref.mask(r)))


@dataclasses.dataclass(frozen=True)
class _RefScoredTraceFile(sampling.TraceFileSampler):
    """The port's trace-file sampler drawing on the reference's scores,
    ``uniform(fold_in(key, round), (n,))`` (fed/sampling.py:58-59)."""
    key: object = None

    def scores(self, round_id):
        return torch.from_numpy(np.asarray(jax.random.uniform(
            jax.random.fold_in(self.key, round_id), (self.n,))))


def test_trace_file_cohorts_equal_reference(tmp_path):
    rng = np.random.default_rng(3)
    n, c = 9, 4
    table = rng.random((6, n)) < 0.5
    table[1] = False                       # all down: uniform fallback
    table[2] = False
    table[2, [3, 7]] = True                # shortfall: cycles the up set
    path = str(tmp_path / "trace.jsonl")
    sampling.save_trace(path, table, delays=np.arange(n) % 3 + 1)
    loaded = sampling.load_trace(path, n)
    np.testing.assert_array_equal(loaded, table)
    np.testing.assert_array_equal(ref_sampling.load_trace(path, n), table)
    key = jax.random.PRNGKey(11)
    ref = ref_sampling.make_sampler("trace-file", n, c, key,
                                    trace_file=path)
    port = _RefScoredTraceFile(n, c, 0, loaded, key)
    for r in range(14):
        np.testing.assert_array_equal(port.cohort(r).numpy(),
                                      np.asarray(ref.cohort(r)), f"round {r}")


def test_uniform_sampler_properties():
    s = sampling.make_sampler("uniform", 20, 6, seed=4)
    seen = set()
    for r in range(10):
        ids = s.cohort(r)
        assert ids.dtype == torch.int64 and len(set(ids.tolist())) == 6
        assert ((ids >= 0) & (ids < 20)).all()
        m = s.mask(r)
        assert int(m.sum()) == 6 and m[ids].all()
        assert torch.equal(s.cohort(r), ids)          # deterministic per round
        seen.add(tuple(ids.tolist()))
    assert len(seen) > 1
    assert not torch.equal(sampling.make_sampler("uniform", 20, 6,
                                                 seed=5).cohort(0),
                           s.cohort(0))


def test_trace_samplers_respect_availability():
    s = sampling.make_sampler("trace", 16, 3, seed=2, period=4, duty=0.5)
    for r in range(12):
        up = s.up_mask(r)
        ids = s.cohort(r)
        assert up[ids].all(), r
        if int(up.sum()) >= 3:
            assert len(set(ids.tolist())) == 3
    # shortfall and all-down through a recorded table
    table = np.zeros((2, 8), bool)
    table[0, [2, 5]] = True
    tf = sampling.TraceFileSampler(8, 4, 1, table)
    ids = tf.cohort(0).tolist()
    assert set(ids) == {2, 5} and ids[:2] == ids[2:]
    ids = tf.cohort(1).tolist()
    assert len(set(ids)) == 4 and all(0 <= g < 8 for g in ids)


def test_make_sampler_and_population_config_validate():
    with pytest.raises(ValueError):
        sampling.make_sampler("uniform", 4, 5)
    with pytest.raises(KeyError):
        sampling.make_sampler("zipf", 4, 2)
    with pytest.raises(ValueError):
        sampling.make_sampler("trace-file", 4, 2)
    for kw in (dict(n=4, cohort=5), dict(n=4, cohort=2, sync_mode="x"),
               dict(n=4, cohort=2, max_delay=3),
               dict(n=4, cohort=2, sampler="trace-file"),
               dict(n=4, cohort=2, topology="star")):
        with pytest.raises(ValueError):
            PopulationConfig(**kw)
        with pytest.raises(ValueError):
            RefPopulationConfig(**kw)
    cfg = RefPopulationConfig(n=8, cohort=3, sync_mode="participants",
                              staleness_decay=0.5, max_staleness=4.0,
                              max_delay=3, delay_model="tiers")
    port = PopulationConfig(**dataclasses.asdict(cfg))
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert port.asynchronous and not PopulationConfig(n=2,
                                                      cohort=1).asynchronous


# ------------------------------------------------------------ quadratic runs

def _quad_pair(m, fed_kw=None, engine="eager", *, seed=1,
               dtype=torch.float32, **kw):
    """The reference's quadratic FedDriver and the port's, alike; the port
    computes in ``dtype`` (float64: the witness). Seed 1 by default: at
    seed 0 the masked runs of the two packages part by about 2e-5, both
    about 1e-5 from the float64 witness
    (test_quadratic_seed0_packages_equally_far_from_float64_witness)."""
    consts, theta = quadratic_pair(seed=seed)
    d, p = 8, 6
    ref_fed = RefFedConfig(q=Q, neumann_k=K, lr_x=0.3, lr_y=0.3, theta=theta,
                           **(fed_kw or {}))
    jc = tuple(map(jnp.asarray, consts))
    ref = RefFedDriver(
        ref_quad(*jc), ref_fed, n_clients=m,
        batch_fn=lambda c, s: {"f": 0.0, "g": 0.0, "g0": 0.0,
                               "gi": jnp.zeros((K,))},
        init_xy=lambda k: (jnp.ones((d,)) * 2.0, jnp.zeros((p,))),
        grad_norm_fn=lambda x, y: jnp.linalg.norm(ref_true_grad(*jc, x)),
        engine=engine)
    tc = tuple(torch.from_numpy(a).to(dtype) for a in consts)
    zero, gi = torch.zeros((), dtype=dtype), torch.zeros(K, dtype=dtype)
    port = FedDriver(
        quadratic_bilevel_problem(*tc), FedConfig(**dataclasses.asdict(
            ref_fed)), n_clients=m,
        batch_fn=lambda c, s: {"f": zero, "g": zero, "g0": zero, "gi": gi},
        init_xy=lambda g: (torch.ones(d, dtype=dtype) * 2.0,
                           torch.zeros(p, dtype=dtype)),
        grad_norm_fn=lambda x, y: torch.linalg.norm(
            quadratic_true_grad(*tc, x)),
        engine=engine, device="cpu", **kw)
    return ref, port


QUAD_SIZES = [6, 8, 8, 6]       # state leaves v, w, x, y (sorted keys)


def _compare(res, ref_res, rtol):
    for field in ("steps", "samples", "comms", "bytes_up", "bytes_down"):
        assert getattr(res, field) == getattr(ref_res, field), field
    np.testing.assert_allclose(res.grad_norm, ref_res.grad_norm, rtol=rtol,
                               atol=rtol)
    assert_trees_close(res.final_avg_state, ref_res.final_avg_state,
                       rtol=rtol, atol=rtol, what="final_avg_state")


@pytest.mark.parametrize("engine", ["eager", "scan"])
@pytest.mark.parametrize("codec", ["none", "int8", "topk"])
def test_masked_participation_matches_reference(engine, codec):
    m, steps = 4, 7                        # 3 full rounds + a partial one
    ref_sampler = ref_sampling.UniformSampler(m, 2, jax.random.PRNGKey(9))
    fed_kw = dict(codec=codec, topk_frac=0.3)
    ref, port = _quad_pair(m, fed_kw, engine,
                           sampler=ReplaySampler(ref_sampler))
    ref.sampler = ref_sampler
    ref_res = ref.run(steps, key=KEY, eval_every=2)
    res = port.run(steps, eval_every=2,
                   draws=reference_draws(KEY, m, steps, Q, K),
                   noise=ReferenceNoise(KEY, QUAD_SIZES))
    _compare(res, ref_res, 1e-5)


@pytest.mark.parametrize("sync_mode, codec", [("broadcast", "none"),
                                              ("participants", "int8"),
                                              ("participants", "topk")])
def test_population_driver_matches_reference(sync_mode, codec):
    n, steps = 6, 6
    ref_sampler = ref_sampling.UniformSampler(n, 3, jax.random.PRNGKey(4))
    pcfg = dict(n=n, cohort=3, sync_mode=sync_mode, staleness_decay=0.5)
    ref, port = _quad_pair(n, dict(codec=codec, topk_frac=0.3),
                           population=PopulationConfig(**pcfg),
                           sampler=ReplaySampler(ref_sampler))
    ref.population = RefPopulationConfig(**pcfg)
    ref.sampler = ref_sampler
    ref_res = ref.run(steps, key=KEY, eval_every=2)
    res = port.run(steps, eval_every=2,
                   draws=reference_draws(KEY, n, steps, Q, K),
                   noise=ReferenceNoise(KEY, QUAD_SIZES))
    _compare(res, ref_res, 1e-5)
    assert_trees_close(port.final_bank, ref.final_bank, rtol=1e-5,
                       atol=1e-5, what="final_bank")


def test_population_round_participants_int8_matches_reference():
    """``make_population_round`` with participants sync, staleness weights
    and the int8 codec with error feedback, two rounds on the reference's
    cohorts, Neumann draws and noise."""
    n, c = 5, 3
    ref, port = _quad_pair(n, dict(codec="int8"))
    ref.population = RefPopulationConfig(n=n, cohort=c)
    pop, server = ref._init_population(KEY)
    ref_codec = ref_compress.make_codec("int8")
    ref_round = ref_pop.make_population_round(
        ref._cohort_local_step(n),
        lambda srv, avg: ref.alg.sync_update(srv, avg, n), Q,
        sync_mode="participants", staleness_decay=0.5, codec=ref_codec)
    port_round = population.make_population_round(
        lambda st, srv, b, k, ids: port._local_body(st, srv, b, k),
        lambda srv, avg: port.alg.sync_update(srv, avg, n), Q,
        sync_mode="participants", staleness_decay=0.5,
        codec=compress.make_codec("int8"))
    ref_state = (pop.states, pop.last_sync,
                 ref_compress.zeros_ef(ref_codec, pop.states), server)
    port_state = tuple(to_torch(s) for s in ref_state)
    noise = ReferenceNoise(KEY, QUAD_SIZES)
    zero_b = {"f": 0.0, "g": 0.0, "g0": 0.0, "gi": np.zeros(K, np.float32)}
    for r, ids in enumerate(([0, 3, 4], [4, 1, 2])):
        batches = jax.tree.map(lambda a: np.zeros((Q, c) + np.shape(a),
                                                  np.float32), zero_b)
        ts = [r * (Q + 1) + j for j in range(Q)]    # the server's step t
        draws_q = torch.tensor([[neumann_k(jax.random.split(
            jax.random.fold_in(jax.random.fold_in(KEY, g), t))[0], K)
            for g in ids] for t in ts])
        bank, last, ef, srv = ref_state
        ref_state = ref_round(bank, last, ef, srv, jnp.asarray(ids),
                              to_jax(batches), KEY, jnp.int32(r))
        t_ids = torch.tensor(ids)
        port_state = port_round(*port_state, t_ids, to_torch(batches),
                                draws_q, r, noise(r, t_ids))
    for what, got, want in zip(("bank", "last_sync", "ef", "server"),
                               port_state, ref_state):
        assert_trees_close(got, want, rtol=1e-5, atol=1e-5, what=what)


def test_population_broadcast_equals_masked_participation():
    """The port's own invariant, as the reference's
    (tests/test_population.py:28): with the same cohorts, broadcast
    population rounds follow the masked-participation trajectory of both
    engines."""
    m, steps = 4, 7
    s = sampling.UniformSampler(m, 2, 9)
    runs = {}
    for mode in ("eager", "scan", "population"):
        kw = dict(sampler=s)
        if mode == "population":
            kw["population"] = PopulationConfig(n=m, cohort=2)
        else:
            kw.update(participation=0.5, engine=mode)
        runs[mode] = _quad_pair(m, **kw)[1].run(steps, seed=1, eval_every=7)
    for mode in ("scan", "population"):
        for a, b in zip(jax.tree.leaves(runs["eager"].final_avg_state),
                        jax.tree.leaves(runs[mode].final_avg_state)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        assert runs[mode].samples[-1] == runs["eager"].samples[-1]
        assert runs[mode].bytes_up[-1] == runs["eager"].bytes_up[-1]


def _witness_gaps(engine, codec, seed):
    """Masked participation on the quadratic problem in three runs: the
    reference, the port, and the port in float64 (the witness), on the same
    cohorts and draws. Returns the final states' gaps (as :func:`_gap`):
    port-ref, port-f64 and ref-f64."""
    m, steps = 4, 7
    ref_sampler = ref_sampling.UniformSampler(m, 2, jax.random.PRNGKey(9))
    fed_kw = dict(codec=codec, topk_frac=0.3)
    ref, port = _quad_pair(m, fed_kw, engine, seed=seed,
                           sampler=ReplaySampler(ref_sampler))
    witness = _quad_pair(m, fed_kw, engine, seed=seed, dtype=torch.float64,
                         sampler=ReplaySampler(ref_sampler))[1]
    ref.sampler = ref_sampler
    ref_res = ref.run(steps, key=KEY, eval_every=7)
    draws = reference_draws(KEY, m, steps, Q, K)
    res, res64 = (p.run(steps, eval_every=7, draws=draws,
                        noise=ReferenceNoise(KEY, QUAD_SIZES))
                  for p in (port, witness))
    assert tree_leaves(res64.final_avg_state)[0].dtype == torch.float64
    return {"port-ref": _gap(res, ref_res), "port-f64": _gap(res, res64),
            "ref-f64": _gap(ref_res, res64)}


@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_quadratic_seed0_packages_equally_far_from_float64_witness(engine):
    """At seed 0 the masked runs of the two packages part by about 2e-5,
    more than the 1e-5 the quadratic runs above are held to at seed 1. The
    port run in float64 shows why: both f32 runs are about 1e-5 from it,
    each within 4x of the other's distance, so the parting is f32 rounding
    that this problem magnifies, in both packages alike."""
    gaps = _witness_gaps(engine, "none", 0)
    assert gaps["port-ref"] <= gaps["port-f64"] + gaps["ref-f64"] + 1e-7
    assert gaps["port-f64"] <= 4 * gaps["ref-f64"], gaps
    assert gaps["ref-f64"] <= 4 * gaps["port-f64"], gaps


def test_population_needs_matching_n():
    _, port = _quad_pair(4, population=PopulationConfig(n=5, cohort=2))
    with pytest.raises(ValueError, match="population.n"):
        port.run(2)


# ------------------------------------------------------------ hyperrep

@functools.lru_cache(maxsize=None)
def _hyperrep_batch(client, step):
    return jax.tree.map(np.asarray, _hyperrep_task()[1]["batch_fn"](client,
                                                                   step))


@functools.lru_cache(maxsize=None)
def _hyperrep_task():
    """The reference's small hyper-representation task (its data does not
    depend on the codec: the drivers take the FedConfig)."""
    ref_cfg = RefHyperRepConfig(fed=dataclasses.replace(
        RefHyperRepConfig().fed, q=Q))
    return ref_cfg, ref_build_hyperrep(ref_cfg)


def _hyperrep_runs(engine, codec, key, steps=4, noise_sizes=None):
    """Masked participation (4 of 8 clients a round) on small
    hyper-representation: the reference's run, then the port's on the
    reference's cohorts, Neumann draws and (with ``noise_sizes``) int8
    noise. Returns ``(res, ref_res)``."""
    base_cfg, ref_task = _hyperrep_task()
    ref_fed = dataclasses.replace(base_cfg.fed, codec=codec)
    m = base_cfg.n_clients
    ref_sampler = ref_sampling.UniformSampler(m, 4, jax.random.PRNGKey(2))
    ref = RefFedDriver(ref_task["problem"], ref_fed, m,
                       ref_task["batch_fn"], ref_task["init_xy"],
                       grad_norm_fn=lambda x, y: ref_tree_norm(x),
                       sampler=ref_sampler, engine=engine)
    ref_res = ref.run(steps, key=key, eval_every=2)
    jax.effects_barrier()

    cfg = HyperRepConfig(**{k: v for k, v in dataclasses.asdict(
        base_cfg).items() if k != "fed"}, fed=FedConfig(
        **dataclasses.asdict(ref_fed)))
    task = build_hyperrep(cfg, device="cpu")
    init = to_torch(ref_task["init_xy"](key))
    port = FedDriver(
        task["problem"], cfg.fed, m,
        batch_fn=lambda c, s: to_torch(_hyperrep_batch(c, s)),
        init_xy=lambda g: init, grad_norm_fn=lambda x, y: tree_norm(x),
        sampler=ReplaySampler(ref_sampler), engine=engine, device="cpu")
    noise = (ReferenceNoise(key, noise_sizes) if noise_sizes is not None
             else None)
    res = port.run(steps, eval_every=2,
                   draws=reference_draws(key, m, steps, Q, cfg.fed.neumann_k),
                   noise=noise)
    return res, ref_res


@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_hyperrep_masked_topk_matches_reference(engine):
    """Masked participation with the topk codec and error feedback on small
    hyper-representation."""
    res, ref_res = _hyperrep_runs(engine, "topk", KEY)
    _compare(res, ref_res, 1e-4)


def _hyperrep_message_sizes(key):
    """Leaf sizes of one client's message, in packed order: the client
    state {v (y-shaped), w (x-shaped), x, y}."""
    xp, yp = _hyperrep_task()[1]["init_xy"](key)
    return [int(np.size(l)) for l in jax.tree.leaves(
        {"v": yp, "w": xp, "x": xp, "y": yp})]


class _Int8Levels:
    """Both packages' int8 levels at every sync of a hyper-representation
    run, side by side.

    The reference's levels are read by a ``jax.debug.callback`` on its
    quantize op; the callbacks come per client and per leaf, so each is
    placed by its noise, which is unique to (round, client, leaf). The
    port's quantize launches (one a leaf, over the clients' rows) are
    compared row by row with the reference's levels of the same round,
    client and leaf. With
    ``replay`` the port goes on with the reference's levels, so that a level
    that one f32 rounding difference put one step apart does not carry into
    the rest of the run."""

    def __init__(self, key, sizes, n_clients, rounds, replay):
        self.sizes, self.replay = sizes, replay
        self.offsets = np.cumsum([0] + sizes)
        self.where, self.ref_q = {}, {}
        for r in range(rounds):
            for g in range(n_clients):
                row = reference_codec_noise(key, r, g, sizes)
                for leaf, (a, b) in enumerate(zip(self.offsets,
                                                  self.offsets[1:])):
                    self.where[row[a:b].tobytes()] = (r, g, leaf)
        # per sync (keyed by the round it closes): levels compared, levels
        # that differ, the largest difference
        self.syncs = {}

    def patch(self, mp):
        ref_quant = ref_ops.quantize_stoch
        port_quant = port_ops.quantize_stoch

        def ref_tap(x, u, scale, **kw):
            q = ref_quant(x, u, scale, **kw)
            jax.debug.callback(self._ref_levels, q, u, x / scale)
            return q

        def port_tap(x, u, scale, offsets, qmax):
            return self._port_levels(port_quant(x, u, scale, offsets, qmax),
                                     u, x, scale)

        mp.setattr(ref_ops, "quantize_stoch", ref_tap)
        mp.setattr(port_ops, "quantize_stoch", port_tap)

    def _ref_levels(self, q, u, v):
        self.ref_q[self.where[np.asarray(u).tobytes()]] = (np.asarray(q),
                                                           np.asarray(v))

    def _port_levels(self, q, u, x, scale):
        rows = []
        for c in range(q.shape[0]):
            r, g, leaf = self.where[u[c].numpy().tobytes()]
            ref_q, ref_v = (torch.from_numpy(np.array(a))
                            for a in self.ref_q[(r, g, leaf)])
            # x / scale before the noise is added, as both oracles divide
            v = x[c] / scale[c, 0]
            diff = (q[c].int() - ref_q.int()).abs()
            # the expected count of levels apart: u is shared, so an entry
            # whose x / scale differ by d < 1 straddles an integer with
            # probability d
            drift = (v - ref_v).abs().clamp_max(1.0)
            n, d, w, e = self.syncs.get(r, (0, 0, 0, 0.0))
            self.syncs[r] = (n + diff.numel(), d + int((diff > 0).sum()),
                             max(w, int(diff.max())), e + float(drift.sum()))
            rows.append(ref_q)
        return torch.stack(rows) if self.replay else q


def _hyperrep_int8(engine, seed, replay, steps=6):
    """Masked participation with int8 and error feedback on small
    hyper-representation, both packages, the levels compared at every sync.
    Returns ``(res, ref_res, levels)``."""
    key = jax.random.PRNGKey(seed)
    sizes = _hyperrep_message_sizes(key)
    levels = _Int8Levels(key, sizes, _hyperrep_task()[0].n_clients,
                         steps // Q, replay)
    with pytest.MonkeyPatch.context() as mp:
        levels.patch(mp)
        res, ref_res = _hyperrep_runs(engine, "int8", key, steps, sizes)
    return res, ref_res, levels


def _gap(res, ref_res):
    """The final states' largest ``|a - b| / (1 + |b|)`` (a of ``res``, b of
    ``ref_res``; either package's): the smallest rtol = atol that
    ``_compare`` would pass."""
    def leaves(state):
        return [np.asarray(to_numpy(l) if isinstance(l, torch.Tensor) else l,
                           np.float64) for l in jax.tree.leaves(state)]
    return max(float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))
               for a, b in zip(leaves(res.final_avg_state),
                               leaves(ref_res.final_avg_state)))


@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_hyperrep_masked_int8_matches_reference(engine):
    """Masked participation with the int8 codec and error feedback on small
    hyper-representation over two syncs, with the reference's codec noise.
    Every level of every client is compared with the reference's. The noise
    is shared, so a level can only sit apart where an f32 rounding
    difference of the update carries x/scale + u across an integer: one
    step, never more, and about as often as the drift of x/scale between
    the packages predicts (a drift d < 1 straddles an integer with
    probability d). One step moves a client's message by 1/127 of the leaf's
    largest entry, far beyond 1e-4, so the port goes on with the reference's
    levels; it then follows the reference within the 1e-4 of the topk run.
    (Left to its own levels, the run parts by about 1e-3: PERF.md, parity
    notes.)"""
    res, ref_res, levels = _hyperrep_int8(engine, 0, replay=True)
    m, n = _hyperrep_task()[0].n_clients, sum(levels.sizes)
    assert sorted(levels.syncs) == list(range(ref_res.comms[-1]))
    for r, (compared, differ, worst, expected) in levels.syncs.items():
        assert compared == m * n, r
        assert worst <= 1, (r, worst)
        assert abs(differ - expected) <= 5 * math.sqrt(expected) + 5, (
            r, differ, expected)
    _compare(res, ref_res, 1e-4)


def _readings(*only):
    """The readings of the parity notes in PERF.md (``only``: "quadratic"
    or "hyperrep", default both):

        PYTHONPATH=src python tests/test_torch_population.py [quadratic|hyperrep]
    """
    only = set(only or ("quadratic", "hyperrep"))
    for seed in (0, 1) if "quadratic" in only else ():
        for engine in ("eager", "scan"):
            for codec in ("none", "topk"):
                print(f"quadratic seed {seed} {engine} {codec}: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in
                                  _witness_gaps(engine, codec, seed).items()),
                      flush=True)
    for seed in (0, 1) if "hyperrep" in only else ():
        for engine in ("eager", "scan"):
            for replay in (False, True):
                res, ref_res, lv = _hyperrep_int8(engine, seed, replay)
                syncs = "; ".join(
                    f"sync closing round {r}: {d} of {n} levels differ "
                    f"(expected {e:.1f}), by at most {w}"
                    for r, (n, d, w, e) in sorted(lv.syncs.items()))
                print(f"hyperrep int8 seed {seed} {engine} "
                      f"{'replaying the reference levels' if replay else 'free'}"
                      f": {syncs}; final-state gap {_gap(res, ref_res):.3e}",
                      flush=True)


if __name__ == "__main__":
    _readings(*sys.argv[1:])
