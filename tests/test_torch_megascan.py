"""The port's mega-scan tier (``rounds_per_scan`` R, ROADMAP 2a) against
its own single rounds and against the reference's tier.

``make_multi_round`` at R = 1 is one round call; the population and async
multi-round builders equal R sequential rounds bit for bit (every carry
part, the stacked stats). ``FedDriver(rounds_per_scan=R)`` equals the R = 1
run bit for bit on {scan (masked), population, async (tiers), gossip
(time-varying erdos)} x {none, int8, topk + EF} x R in {1, 3, 7} over 11
rounds of q 4 (R 3 and 7 end on a trailing partial chunk): the final
states and bank, the counters, the byte totals, the last record and the
async staleness log and histograms (the fields of the reference's
``tests/test_megascan.py:_assert_run_equal``). One R = 3 run per engine
follows the reference's R = 3 run, fed the reference's cohorts, draws and
noise, at the engine tolerance 1e-5 (tests/test_round_engine.py), with
the recorded steps, samples, comms, byte totals, ``len(round_seconds)``
and the staleness log equal. No chunk reads the device back
(``test_torch_harness.NoHostRead``, the CPU's stand-in for the card's
sync debug mode). ``in_scan_cohort_fn`` answers per sampler as
the reference's, and the stacked ids route gives the reference's in-scan
draw; a chunk's telemetry is one ``stats`` record a chunk, equal to the
R = 1 run's rows, and the consensus stat refuses R > 1."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_harness import (ReferenceNoise, ReplaySampler,
                                assert_trees_close, chunks_read_nothing,
                                neumann_k, quadratic_pair, reference_draws)
from test_torch_async import ReferenceDelayDraws
from test_torch_gossip import _ReferenceGraph

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.configs import FedConfig as RefFedConfig  # noqa: E402
from repro.configs import PopulationConfig as RefPopulationConfig  # noqa: E402
from repro.core.bilevel import quadratic_bilevel_problem as ref_quad  # noqa: E402
from repro.core.bilevel import quadratic_true_grad as ref_true_grad  # noqa: E402
from repro.fed import sampling as ref_sampling  # noqa: E402
from repro.obs import MemorySink as RefSink  # noqa: E402
from repro.obs import Telemetry as RefTelemetry  # noqa: E402
from repro.tasks.driver import FedDriver as RefFedDriver  # noqa: E402
from repro_torch.configs import FedConfig, PopulationConfig  # noqa: E402
from repro_torch.core.bilevel import (quadratic_bilevel_problem,  # noqa: E402
                                      quadratic_true_grad)
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.fed import compress, population, sampling  # noqa: E402
from repro_torch.fed.round import (chunk_plan, make_multi_round,  # noqa: E402
                                   per_round)
from repro_torch.obs import MemorySink, Telemetry  # noqa: E402
from repro_torch.tasks import Draws, FedDriver  # noqa: E402

KEY = jax.random.PRNGKey(0)
N, C = 8, 4                  # the population and its cohort
STEPS = 44                   # 11 rounds of q 4 (R 3: 1+3+3+3+1 rounds)
R_GRID = (1, 3, 7)
CODECS = {"none": {}, "int8": dict(codec="int8", codec_bits=4),
          "topk": dict(codec="topk", topk_frac=0.5, error_feedback=True)}
ENGINES = {
    "scan": dict(engine="scan", participation=0.5),
    "population": dict(population=PopulationConfig(
        n=N, cohort=C, sync_mode="participants", staleness_decay=0.5)),
    "async": dict(population=PopulationConfig(
        n=N, cohort=C, max_staleness=4.0, max_delay=4, delay_model="tiers",
        delay_eta=0.5, staleness_decay=0.5)),
    "gossip": dict(engine="gossip", population=PopulationConfig(
        n=N, cohort=N, topology="erdos", er_p=0.5, time_varying=True)),
}


def _port_driver(engine, codec, R, *, q=4, K=2, telemetry=None, **kw):
    consts, theta = quadratic_pair(seed=1)
    tc = tuple(map(torch.from_numpy, consts))
    zero, gi = torch.zeros(()), torch.zeros(K)
    fed = FedConfig(q=q, neumann_k=K, lr_x=0.3, lr_y=0.3, theta=theta,
                    **CODECS[codec])
    extra = dict(ENGINES[engine], **kw)
    if telemetry is not None:
        extra["telemetry"] = telemetry
    return FedDriver(
        quadratic_bilevel_problem(*tc), fed, n_clients=N,
        batch_fn=lambda c, s: {"f": zero, "g": zero, "g0": zero, "gi": gi},
        init_xy=lambda g: (torch.ones(8) * 2.0, torch.zeros(6)),
        grad_norm_fn=lambda x, y: torch.linalg.norm(
            quadratic_true_grad(*tc, x)),
        rounds_per_scan=R, device="cpu", **extra)


@functools.lru_cache(maxsize=None)
def _port_run(engine, codec, R, steps=STEPS):
    """A port run; at R > 1 every chunk reads nothing back to the host
    (``chunks_read_nothing``)."""
    drv, chunks = _port_driver(engine, codec, R), []
    with chunks_read_nothing(chunks):
        res = drv.run(steps, seed=0, eval_every=8)
    assert (len(chunks) > 0) == (R > 1)
    return drv, res


def _equal_trees(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert (x is None and y is None) or torch.equal(x, y), (
            f"{what} leaf {i}")


def _assert_run_equal(ref, got, label, drivers):
    """The reference's ``_assert_run_equal`` on the port: the final states,
    the counters and byte totals, the last record, and the final bank and
    the async staleness bookkeeping; and every part of the engine's final
    state (server, EF, last_sync, the async bookkeeping)."""
    _equal_trees(ref.final_avg_state, got.final_avg_state,
                 f"{label}: final_avg_state")
    dref, dgot = drivers
    assert sorted(dref.final_state) == sorted(dgot.final_state), label
    for k in dref.final_state:
        _equal_trees(dref.final_state[k], dgot.final_state[k],
                     f"{label}: {k}")
    for f in ("samples", "comms", "bytes_up", "bytes_down", "grad_norm"):
        assert getattr(ref, f)[-1] == getattr(got, f)[-1], (label, f)
    if hasattr(dref, "final_bank"):
        _equal_trees(dref.final_bank, dgot.final_bank, f"{label}: bank")
    if hasattr(dref, "staleness_hist"):
        np.testing.assert_array_equal(dref.staleness_hist,
                                      dgot.staleness_hist, err_msg=label)
        assert dref.staleness_log == dgot.staleness_log, label
        assert (dref.staleness_hist_by_tier.keys()
                == dgot.staleness_hist_by_tier.keys()), label
        for k, h in dref.staleness_hist_by_tier.items():
            np.testing.assert_array_equal(h, dgot.staleness_hist_by_tier[k],
                                          err_msg=f"{label}: tier {k}")


# ------------------------------------------------------------ the builders

def test_multi_round_of_one_is_one_round_call():
    """R = 1 is exactly one ``round_fn`` call, with the absolute round id;
    ``per_round`` slices tensors, lists, tuples and dicts."""
    def round_fn(carry, ids, batch_q, dr, rid):
        k, u = dr
        return carry + batch_q.sum() * k + rid + u, (carry * 2, None)

    batches = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3)
    out, outs = make_multi_round(round_fn)(
        torch.tensor(0.5), None, batches, (torch.tensor([3.0]), [0.25]), 4)
    want, (w0, _) = round_fn(torch.tensor(0.5), None, batches[0],
                             (torch.tensor(3.0), 0.25), 4)
    assert torch.equal(out, want) and torch.equal(outs[0][0], w0)
    assert outs[1] is None
    x = {"a": torch.arange(4).reshape(2, 2), "b": ([5, 6], None)}
    assert per_round(x, 1)["a"].tolist() == [2, 3]
    assert per_round(x, 1)["b"] == (6, None)


def test_chunk_plan_peels_round_zero_and_the_partial_round():
    lengths = [4] * 11 + [2]
    assert chunk_plan(lengths, 4, 3) == [(0, 1), (1, 3), (4, 3), (7, 3),
                                         (10, 1), (11, 1)]
    assert chunk_plan(lengths, 4, 7, peel_first=False) == [(0, 7), (7, 4),
                                                           (11, 1)]


def _toy_local(states, server, batch, k, ids):
    bump = batch.mean() + 0.01 * ids.sum().float() + 0.1 * k.float().sum()
    return {key: v + bump for key, v in states.items()}, server


def _toy_sync(server, avg):
    return avg, {"s": server["s"] + 1.0}


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_multi_population_round_matches_sequential_carry(codec):
    """Every carry part (bank, last_sync, EF bank, server) of
    ``make_multi_population_round`` equals R sequential
    ``make_population_round`` calls bit for bit."""
    q, n, c, R = 2, 6, 3, 4
    cdc = compress.make_codec(codec, bits=4) if codec != "none" else None
    lossy = cdc is not None
    round_fn = population.make_population_round(
        _toy_local, _toy_sync, q, sync_mode="participants",
        staleness_decay=0.5, codec=cdc)
    sampler = sampling.UniformSampler(n, c, seed=3)
    ids_R = torch.stack([sampler.cohort(r) for r in range(R)])
    gen = torch.Generator().manual_seed(0)
    batches_R = torch.randn(R, q, c, generator=gen)
    draws_R = torch.randint(0, 3, (R, q, c), generator=gen)
    noise = compress.CodecNoise(7, "cpu")
    noise_R = [noise(r, ids_R[r]) for r in range(R)] if lossy else None

    def init():
        bank = {"x": torch.randn(n, 3, generator=torch.Generator()
                                 .manual_seed(1))}
        ef = {"x": torch.zeros(n, 3)} if lossy else None
        return bank, torch.zeros(n, dtype=torch.int32), ef, {
            "s": torch.zeros(())}

    bank, ls, ef, server = init()
    for r in range(R):
        if lossy:
            bank, ls, ef, server = round_fn(bank, ls, ef, server, ids_R[r],
                                            batches_R[r], draws_R[r], r,
                                            noise_R[r])
        else:
            bank, ls, server = round_fn(bank, ls, server, ids_R[r],
                                        batches_R[r], draws_R[r], r)
    mega = population.make_multi_population_round(round_fn, lossy=lossy)
    b0, l0, e0, s0 = init()
    if lossy:
        got = mega(b0, l0, e0, s0, ids_R, batches_R, draws_R, 0, noise_R)
        want = (bank, ls, ef, server)
    else:
        got = mega(b0, l0, s0, ids_R, batches_R, draws_R, 0)
        want = (bank, ls, server)
    for part, a, b in zip(("bank", "last_sync", "ef", "server"), want, got):
        _equal_trees(a, b, f"{codec} {part}")


def test_multi_async_round_matches_sequential_carry():
    """The whole async state (bank, pending, flight and staleness vectors,
    anchor, server) and the stacked per-round stats equal R sequential
    ``make_async_round`` calls."""
    q, n, c, R = 2, 5, 2, 4
    round_fn = population.make_async_round(
        _toy_local, _toy_sync, q, max_staleness=3.0, max_delay=3,
        delay_eta=0.5, delay_draws=population.DelayDraws(2, "cpu"))
    sampler = sampling.UniformSampler(n, c, seed=5)
    ids_R = torch.stack([sampler.cohort(r) for r in range(R)])
    batches_R = torch.randn(R, q, c, generator=torch.Generator()
                            .manual_seed(0))
    draws_R = torch.zeros(R, q, c, dtype=torch.int64)

    def init():
        return population.init_async_state({"x": torch.zeros(n, 2)},
                                           {"s": torch.zeros(())}, n)

    state, seq = init(), []
    for r in range(R):
        state, st = round_fn(state, ids_R[r], batches_R[r], draws_R[r], r)
        seq.append(st)
    got, stats_R = population.make_multi_async_round(round_fn)(
        init(), ids_R, batches_R, draws_R, 0)
    _equal_trees(state, got, "async state")
    for k in seq[0]:
        assert torch.equal(torch.stack([s[k] for s in seq]), stats_R[k]), k


def test_in_scan_cohort_fn_per_sampler(tmp_path):
    """Uniform and roundrobin could draw inside a chunk (the sampler's own
    draw, equal to the host's), the trace samplers could not, as the
    reference's; and the driver's host-staged ids are the reference's
    in-scan draw."""
    n, c = 8, 3
    table = np.zeros((4, n), bool)
    table[:, :5] = True
    path = tmp_path / "trace.jsonl"
    sampling.save_trace(str(path), table)
    for name in sampling.SAMPLERS:
        s = sampling.make_sampler(name, n, c, 4, trace_file=str(path))
        ref = ref_sampling.make_sampler(name, n, c, jax.random.PRNGKey(4),
                                        trace_file=str(path))
        fn = sampling.in_scan_cohort_fn(s)
        assert (fn is None) == (ref_sampling.in_scan_cohort_fn(ref) is None)
        if fn is not None:
            for r in range(5):
                assert torch.equal(fn(r), s.cohort(r)), (name, r)
    ref = ref_sampling.UniformSampler(n, c, jax.random.PRNGKey(9))
    in_scan = jax.jit(lambda rs: jax.lax.map(
        ref_sampling.in_scan_cohort_fn(ref), rs))(jnp.arange(3, 9))
    drv = _port_driver("population", "none", 3, sampler=ReplaySampler(ref))
    drv._setup_sampler(0)
    draws = Draws(init=torch.zeros(N, dtype=torch.int64),
                  steps=torch.zeros(24, N, dtype=torch.int64))
    staged = drv._stage_cohorts(3, 6, 0, 4, draws, None)
    np.testing.assert_array_equal(staged["ids"].numpy(),
                                  np.asarray(in_scan))


# ------------------------------------------------------------ the drivers

@pytest.mark.parametrize("R", R_GRID)
@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_driver_chunks_equal_single_rounds(engine, codec, R):
    dref, ref = _port_run(engine, codec, 1)
    dgot, got = _port_run(engine, codec, R)
    _assert_run_equal(ref, got, f"{engine}/{codec}/R={R}", (dref, dgot))
    last = ref.steps[-1]
    assert got.steps[-1] == last == STEPS - 1
    # a record lands at a chunk's end: the rounds of q 4 that hold an eval
    # step (every 8th) or end the run
    assert set(got.steps) <= {4 * r + 3 for r in range(11)} | {last}
    # the first chunk of each shape carries the warm-up
    assert len(dgot.round_seconds) == {1: 10, 3: 6, 7: 0}[R]


def test_trace_sampler_stacks_its_cohorts():
    """A trace sampler's cohorts, drawn on the host and stacked [L, C]:
    R = 3 equals R = 1 bit for bit."""
    pop = PopulationConfig(n=N, cohort=C, sampler="trace", trace_period=4)
    runs = []
    for R in (1, 3):
        drv = _port_driver("population", "int8", R, population=pop)
        runs.append((drv, drv.run(STEPS, seed=0, eval_every=8)))
    _assert_run_equal(runs[0][1], runs[1][1], "trace/R=3",
                      (runs[0][0], runs[1][0]))


# ------------------------------------------------------------ the reference

Q2, K8 = 2, 8
REF_STEPS = 23               # 11 rounds of q 2 and a partial one


def _ref_pair(engine):
    """The reference's R = 3 driver and the port's, on the quadratic
    problem, with the reference's cohorts (and, in the returned run
    keyword arguments, its draws, noise, delays and graphs)."""
    consts, theta = quadratic_pair(seed=1)
    codec = {"scan": "int8", "population": "topk", "async": "none",
             "gossip": "int8"}[engine]
    ref_fed = RefFedConfig(q=Q2, neumann_k=K8, lr_x=0.3, lr_y=0.3,
                           theta=theta, codec=codec, topk_frac=0.3)
    pkw = {"scan": None,
           "population": dict(n=6, cohort=3, sync_mode="participants",
                              staleness_decay=0.5),
           "async": dict(n=6, cohort=3, max_staleness=3.0, max_delay=8,
                         delay_model="tiers", staleness_decay=0.5,
                         delay_eta=0.5),
           "gossip": dict(n=6, cohort=6, topology="erdos", er_p=0.5,
                          topology_seed=2, time_varying=True)}[engine]
    n = 6
    ref_sampler = ref_sampling.UniformSampler(n, 3, jax.random.PRNGKey(4))
    jc = tuple(map(jnp.asarray, consts))
    eng = {"scan": "scan", "gossip": "gossip"}.get(engine, "eager")
    ref = RefFedDriver(
        ref_quad(*jc), ref_fed, n_clients=n,
        batch_fn=lambda c, s: {"f": 0.0, "g": 0.0, "g0": 0.0,
                               "gi": jnp.zeros((K8,))},
        init_xy=lambda k: (jnp.ones((8,)) * 2.0, jnp.zeros((6,))),
        grad_norm_fn=lambda x, y: jnp.linalg.norm(ref_true_grad(*jc, x)),
        engine=eng, rounds_per_scan=3,
        population=RefPopulationConfig(**pkw) if pkw else None)
    if engine != "gossip":
        ref.sampler = ref_sampler
    tc = tuple(map(torch.from_numpy, consts))
    zero, gi = torch.zeros(()), torch.zeros(K8)
    port = FedDriver(
        quadratic_bilevel_problem(*tc), FedConfig(**dataclasses.asdict(
            ref_fed)), n_clients=n,
        batch_fn=lambda c, s: {"f": zero, "g": zero, "g0": zero, "gi": gi},
        init_xy=lambda g: (torch.ones(8) * 2.0, torch.zeros(6)),
        grad_norm_fn=lambda x, y: torch.linalg.norm(
            quadratic_true_grad(*tc, x)),
        engine=eng, rounds_per_scan=3, device="cpu",
        population=PopulationConfig(**pkw) if pkw else None,
        sampler=None if engine == "gossip" else ReplaySampler(ref_sampler))
    return ref, port


def _async_draws(ref, n):
    """Neumann draws of an async run from the reference's staleness log
    (a server step ticks the counter only in a round that accepted)."""
    def draw(g, t):
        return neumann_k(jax.random.split(jax.random.fold_in(
            jax.random.fold_in(KEY, g), t))[0], K8)
    lengths = [Q2] * (REF_STEPS // Q2) + [REF_STEPS % Q2]
    ts, t = [], 0
    for row, n_steps in zip(ref.staleness_log, lengths):
        t += int(row["accepted"] > 0)
        ts += [t + j for j in range(n_steps)]
        t += n_steps
    return Draws(init=torch.tensor([neumann_k(k, K8) for k in
                                    jax.random.split(KEY, n)]),
                 steps=torch.tensor([[draw(g, tt) for g in range(n)]
                                     for tt in ts]))


@pytest.fixture(scope="module", params=sorted(ENGINES))
def ref_r3(request):
    """One reference R = 3 run per engine and the port's R = 3 run on its
    draws."""
    engine = request.param
    ref, port = _ref_pair(engine)
    ref_res = ref.run(REF_STEPS, key=KEY, eval_every=4)
    kw = dict(noise=ReferenceNoise(KEY, [6, 8, 8, 6]))
    if engine == "async":
        kw.update(draws=_async_draws(ref, 6),
                  delay_draws=ReferenceDelayDraws(KEY))
    else:
        kw.update(draws=reference_draws(KEY, 6, REF_STEPS, Q2, K8))
    if engine == "gossip":
        kw.update(graph_draws=_ReferenceGraph(2, 6))
    res = port.run(REF_STEPS, eval_every=4, **kw)
    return engine, ref, ref_res, port, res


def test_r3_runs_match_the_reference(ref_r3):
    engine, ref, ref_res, port, res = ref_r3
    for f in ("steps", "samples", "comms", "bytes_up", "bytes_down"):
        assert getattr(res, f) == getattr(ref_res, f), (engine, f)
    assert len(port.round_seconds) == len(ref.round_seconds), engine
    np.testing.assert_allclose(res.grad_norm, ref_res.grad_norm, rtol=1e-5,
                               atol=1e-5)
    assert_trees_close(res.final_avg_state, ref_res.final_avg_state,
                       rtol=1e-5, atol=1e-5, what=f"{engine} final state")
    if engine != "scan":
        assert_trees_close(port.final_bank, ref.final_bank, rtol=1e-5,
                           atol=1e-5, what=f"{engine} bank")
    if engine == "async":
        assert len(port.staleness_log) == len(ref.staleness_log)
        for got, want in zip(port.staleness_log, ref.staleness_log):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           err_msg=k)
        np.testing.assert_array_equal(port.staleness_hist,
                                      ref.staleness_hist)
        assert sorted(port.staleness_hist_by_tier) == sorted(
            ref.staleness_hist_by_tier)
        for k, h in ref.staleness_hist_by_tier.items():
            np.testing.assert_array_equal(port.staleness_hist_by_tier[k], h)


# ------------------------------------------------------------ telemetry

@pytest.mark.parametrize("engine", ["population", "async"])
def test_chunk_stream_is_one_stats_record_a_chunk(engine):
    """With a sink, a chunk of L rounds writes L round records and one
    ``stats`` record of L rows, whose values equal the R = 1 run's rows
    (``--metrics-every 1``) bit for bit; the run equals the run without
    telemetry; the record kinds and counters follow the reference's R = 3
    stream."""
    tele = Telemetry([MemorySink()], metrics_every=1)
    drv = _port_driver(engine, "none", 3, telemetry=tele)
    on = drv.run(STEPS, seed=0, eval_every=8)
    tele.close()
    _, off = _port_run(engine, "none", 3)
    _equal_trees(on.final_avg_state, off.final_avg_state, "on vs off")
    sink = tele.sinks[0]
    assert [r["round"] for r in sink.of_kind("round")] == list(range(11))
    stats = sink.of_kind("stats")
    plan = chunk_plan([4] * 11, 4, 3, peel_first=engine != "async")
    assert [(s["round_start"], len(s["global_norm"])) for s in stats] == plan
    one = Telemetry([MemorySink()], metrics_every=1)
    _port_driver(engine, "none", 1, telemetry=one).run(STEPS, seed=0,
                                                        eval_every=8)
    one.close()
    rows = one.sinks[0].of_kind("stats")
    for f in ("global_norm", "update_norm"):
        assert sum((s[f] for s in stats), []) == sum((s[f] for s in rows),
                                                     []), f

    consts, theta = quadratic_pair(seed=1)
    jc = tuple(map(jnp.asarray, consts))
    pkw = dataclasses.asdict(ENGINES[engine]["population"])
    ref_tele = RefTelemetry([RefSink()], metrics_every=1)
    RefFedDriver(
        ref_quad(*jc), RefFedConfig(q=4, neumann_k=2, lr_x=0.3, lr_y=0.3,
                                    theta=theta), n_clients=N,
        batch_fn=lambda c, s: {"f": 0.0, "g": 0.0, "g0": 0.0,
                               "gi": jnp.zeros((2,))},
        init_xy=lambda k: (jnp.ones((8,)) * 2.0, jnp.zeros((6,))),
        population=RefPopulationConfig(**pkw), rounds_per_scan=3,
        telemetry=ref_tele).run(STEPS, key=KEY, eval_every=8)
    ref_tele.close()
    got, want = sink.records, ref_tele.sinks[0].records
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    for g, w in zip(got, want):
        if g["kind"] == "round":
            for k in ("round", "step"):
                assert g[k] == w[k], (k, g, w)
        if g["kind"] == "stats":
            assert g["round_start"] == w["round_start"]
            assert len(g["global_norm"]) == len(w["global_norm"])
        if g["kind"] == "summary":
            assert ({k: v["count"] for k, v in g["phases"].items()}
                    == {k: v["count"] for k, v in w["phases"].items()})


def test_consensus_stat_refuses_chunks():
    tele = Telemetry([MemorySink()], metrics_every=1, consensus=True)
    with pytest.raises(ValueError, match="cannot fold the O\\(N\\) "
                                         "consensus stat"):
        _port_driver("scan", "none", 3, telemetry=tele).run(8, seed=0)
    # without a sink nothing is computed, and nothing refuses
    _port_driver("scan", "none", 3).run(8, seed=0)
