"""The port's gossip engine and its topologies against the reference's.

Adjacencies and directed edge counts equal the reference's exactly,
Metropolis weights within 1e-7 and spectral gaps within 1e-6; the gossip
aggregator prices the wire per directed edge as the reference's does. The
gossip driver follows the reference's on a ring with codec none and int8
(the reference's codec noise), and on a time-varying Erdős–Rényi graph
drawn from the reference's uniforms, within 1e-4 with the accounting equal
(on the quadratic problem, and with codec none on small hyper-
representation). On the complete graph the port's gossip engine follows its
star population engine at cohort n within 1e-5. The per-node accumulators
of the fused update: one ``adafbio_update`` over [M, n] rows of ``a``
equals a per-row loop of the shared version bit for bit."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_harness import (ReferenceNoise, assert_trees_close,
                                quadratic_pair, reference_draws, to_torch)

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.configs import FedConfig as RefFedConfig  # noqa: E402
from repro.configs import PopulationConfig as RefPopulationConfig  # noqa: E402
from repro.configs.paper_tasks import HyperRepConfig as RefHyperRepConfig  # noqa: E402
from repro.core.bilevel import quadratic_bilevel_problem as ref_quad  # noqa: E402
from repro.core.bilevel import quadratic_true_grad as ref_true_grad  # noqa: E402
from repro.core.tree_util import tree_norm as ref_tree_norm  # noqa: E402
from repro.fed import topology as ref_topo  # noqa: E402
from repro.tasks.driver import FedDriver as RefFedDriver  # noqa: E402
from repro.tasks.hyperrep import build_hyperrep as ref_build_hyperrep  # noqa: E402
from repro_torch.configs import (FedConfig, HyperRepConfig,  # noqa: E402
                                 PopulationConfig)
from repro_torch.core.bilevel import (quadratic_bilevel_problem,  # noqa: E402
                                      quadratic_true_grad)
from repro_torch.core.tree_util import tree_norm  # noqa: E402
from repro_torch.fed import topology  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.storm_update import adafbio_update  # noqa: E402
from repro_torch.tasks import FedDriver, build_hyperrep  # noqa: E402

KEY = jax.random.PRNGKey(0)
K, Q = 8, 2
QUAD_SIZES = [6, 8, 8, 6]       # state leaves v, w, x, y (sorted keys)


# ------------------------------------------------------------ topologies

@pytest.mark.parametrize("n", [4, 6, 8, 9, 12])
def test_topologies_match_reference(n):
    cases = [("ring", topology.ring_adjacency(n), ref_topo.ring_adjacency(n)),
             ("complete", topology.complete_adjacency(n),
              ref_topo.complete_adjacency(n))]
    for p, seed in ((0.3, 0), (0.6, 5)):
        cases.append(("erdos", topology.erdos_adjacency(n, p, seed),
                      ref_topo.erdos_adjacency(n, p, seed)))
    cases.append(("torus2d", topology.torus2d_adjacency(n),
                  ref_topo.torus2d_adjacency(n)))
    assert topology.torus2d_dims(n) == ref_topo.torus2d_dims(n)
    for name, got, want in cases:
        np.testing.assert_array_equal(got, want, err_msg=name)
        W = topology.metropolis_weights(got).numpy()
        W_ref = np.asarray(ref_topo.metropolis_weights(want))
        np.testing.assert_allclose(W, W_ref, rtol=1e-7, atol=1e-7,
                                   err_msg=name)
        assert topology.directed_edges(W) == ref_topo.directed_edges(W_ref)
        assert abs(topology.spectral_gap(W) - ref_topo.spectral_gap(W_ref)
                   ) <= 1e-6, name
    for name in ("ring", "torus2d", "complete", "erdos"):
        np.testing.assert_allclose(
            topology.mixing_matrix(name, n, er_p=0.5, seed=3),
            ref_topo.mixing_matrix(name, n, er_p=0.5, seed=3), rtol=1e-7,
            atol=1e-7, err_msg=name)


def test_torus_of_a_prime_and_bad_topologies_raise():
    for mod in (topology, ref_topo):
        with pytest.raises(ValueError, match="prime"):
            mod.torus2d_adjacency(7)
        with pytest.raises(ValueError, match="topology"):
            mod.mixing_matrix("star", 4)


class _ReferenceGraph:
    """The port's time-varying graph source filled from the reference's
    draw: ``uniform(fold_in(fold_in(PRNGKey(seed), 0x70B0), round), (n,
    n))`` (fed/topology.py, GossipAggregator.matrix)."""

    def __init__(self, seed, n):
        self.seed, self.n = seed, n

    def __call__(self, round_id):
        k = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(self.seed), 0x70B0), round_id)
        return torch.from_numpy(np.array(jax.random.uniform(
            k, (self.n, self.n))))


@pytest.mark.parametrize("topo, tv", [("ring", False), ("torus2d", False),
                                      ("erdos", False), ("erdos", True)])
def test_gossip_aggregator_edges_and_wire_bytes(topo, tv):
    n, seed = 8, 4
    sync = lambda srv, avg: (avg, srv)          # noqa: E731
    got = topology.GossipAggregator(sync, n, topology=topo, er_p=0.3,
                                    seed=seed, time_varying=tv,
                                    uniform=_ReferenceGraph(seed, n))
    want = ref_topo.GossipAggregator(sync, n, topology=topo, er_p=0.3,
                                     seed=seed, time_varying=tv)
    for r in range(4):
        np.testing.assert_allclose(got.host_matrix(r), want.host_matrix(r),
                                   rtol=1e-7, atol=1e-7)
        assert got.edges(r) == want.edges(r)
        e = got.edges(r)
        assert got.wire_round(123, 999, edges=e) == want.wire_round(
            123, 999, edges=e) == (123 * e, 123 * e)
    assert abs(got.gap - want.gap) <= 1e-6
    states = {"a": torch.randn(n, 3), "b": torch.randn(n, 2, 2)}
    mixed = got.mix(states, got.matrix(1))
    assert_trees_close(mixed, want.mix(jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), states), want.matrix(1)),
        rtol=1e-6, atol=1e-6, what="mix")
    with pytest.raises(ValueError, match="weight vector"):
        got.combine(states, weights=torch.ones(n))


# ------------------------------------------------------------ drivers

def _quad_pair(n, topo, *, codec="none", tv=False, fused="auto", seed=1):
    """The reference's gossip FedDriver and the port's on the quadratic
    problem (seed 1, as the population tests)."""
    consts, theta = quadratic_pair(seed=seed)
    d, p = 8, 6
    ref_fed = RefFedConfig(q=Q, neumann_k=K, lr_x=0.3, lr_y=0.3, theta=theta,
                           codec=codec)
    pkw = dict(n=n, cohort=n, topology=topo, er_p=0.4, topology_seed=2,
               time_varying=tv)
    jc = tuple(map(jnp.asarray, consts))
    ref = RefFedDriver(
        ref_quad(*jc), ref_fed, n_clients=n,
        batch_fn=lambda c, s: {"f": 0.0, "g": 0.0, "g0": 0.0,
                               "gi": jnp.zeros((K,))},
        init_xy=lambda k: (jnp.ones((d,)) * 2.0, jnp.zeros((p,))),
        grad_norm_fn=lambda x, y: jnp.linalg.norm(ref_true_grad(*jc, x)),
        engine="gossip", population=RefPopulationConfig(**pkw))
    tc = tuple(torch.from_numpy(a) for a in consts)
    zero, gi = torch.zeros(()), torch.zeros(K)
    port = FedDriver(
        quadratic_bilevel_problem(*tc), FedConfig(**dict(
            dataclasses.asdict(ref_fed), fused=fused)), n_clients=n,
        batch_fn=lambda c, s: {"f": zero, "g": zero, "g0": zero, "gi": gi},
        init_xy=lambda g: (torch.ones(d) * 2.0, torch.zeros(p)),
        grad_norm_fn=lambda x, y: torch.linalg.norm(
            quadratic_true_grad(*tc, x)),
        engine="gossip", population=PopulationConfig(**pkw), device="cpu")
    return ref, port


def _compare(res, ref_res, rtol):
    for field in ("steps", "samples", "comms", "bytes_up", "bytes_down"):
        assert getattr(res, field) == getattr(ref_res, field), field
    np.testing.assert_allclose(res.grad_norm, ref_res.grad_norm, rtol=rtol,
                               atol=rtol)
    assert_trees_close(res.final_avg_state, ref_res.final_avg_state,
                       rtol=rtol, atol=rtol, what="final_avg_state")


@pytest.mark.parametrize("topo, codec, tv, fused", [
    ("ring", "none", False, "auto"), ("ring", "none", False, "on"),
    ("ring", "int8", False, "auto"), ("erdos", "none", True, "auto"),
    ("torus2d", "topk", False, "auto")])
def test_gossip_driver_matches_reference(topo, codec, tv, fused):
    """Three rounds and a partial one of q 2 on 6 nodes; ``fused="on"``
    runs every x-update through the per-node plain kernel path."""
    n, steps = 6, 7
    ref, port = _quad_pair(n, topo, codec=codec, tv=tv, fused=fused)
    ref_res = ref.run(steps, key=KEY, eval_every=2)
    res = port.run(steps, eval_every=2,
                   draws=reference_draws(KEY, n, steps, Q, K),
                   noise=ReferenceNoise(KEY, QUAD_SIZES),
                   graph_draws=_ReferenceGraph(2, n) if tv else None)
    _compare(res, ref_res, 1e-4)
    assert_trees_close(port.final_bank, ref.final_bank, rtol=1e-4,
                       atol=1e-4, what="final_bank")
    assert port.gossip_agg.edges(0) == ref.gossip_agg.edges(0)


@functools.lru_cache(maxsize=None)
def _hyperrep():
    ref_cfg = RefHyperRepConfig(n_clients=6, fed=dataclasses.replace(
        RefHyperRepConfig().fed, q=Q))
    return ref_cfg, ref_build_hyperrep(ref_cfg)


@functools.lru_cache(maxsize=None)
def _hyperrep_batch(client, step):
    return jax.tree.map(np.asarray, _hyperrep()[1]["batch_fn"](client, step))


def test_gossip_ring_hyperrep_matches_reference():
    """Small hyper-representation (6 nodes) on a ring: every node's Adam
    accumulators and step counter are its own."""
    ref_cfg, ref_task = _hyperrep()
    n, steps = ref_cfg.n_clients, 6
    pkw = dict(n=n, cohort=n, topology="ring")
    ref = RefFedDriver(ref_task["problem"], ref_cfg.fed, n,
                       ref_task["batch_fn"], ref_task["init_xy"],
                       grad_norm_fn=lambda x, y: ref_tree_norm(x),
                       engine="gossip",
                       population=RefPopulationConfig(**pkw))
    ref_res = ref.run(steps, key=KEY, eval_every=2)
    cfg = HyperRepConfig(**{k: v for k, v in dataclasses.asdict(
        ref_cfg).items() if k != "fed"}, fed=FedConfig(
        **dataclasses.asdict(ref_cfg.fed)))
    task = build_hyperrep(cfg, device="cpu")
    init = to_torch(ref_task["init_xy"](KEY))
    port = FedDriver(task["problem"], cfg.fed, n,
                     batch_fn=lambda c, s: to_torch(_hyperrep_batch(c, s)),
                     init_xy=lambda g: init,
                     grad_norm_fn=lambda x, y: tree_norm(x), engine="gossip",
                     population=PopulationConfig(**pkw), device="cpu")
    res = port.run(steps, eval_every=2, draws=reference_draws(
        KEY, n, steps, Q, cfg.fed.neumann_k))
    _compare(res, ref_res, 1e-4)


def test_complete_graph_equals_star_population():
    """On the complete graph every Metropolis weight is 1/n: the gossip
    engine follows the star population engine at cohort n."""
    n, steps = 5, 7
    runs = {}
    for engine in ("gossip", "eager"):
        port = _quad_pair(n, "complete")[1]
        if engine == "eager":
            port.engine = "eager"
            port.population = PopulationConfig(n=n, cohort=n)
        runs[engine] = port.run(steps, seed=3, eval_every=7)
    got, want = runs["gossip"], runs["eager"]
    # the same work; only the wire differs (per edge against per client)
    for field in ("steps", "samples", "comms"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_allclose(got.grad_norm, want.grad_norm, rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(jax.tree.leaves(got.final_avg_state),
                    jax.tree.leaves(want.final_avg_state)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_gossip_validates_like_the_reference():
    ref, port = _quad_pair(4, "ring")
    for kw, match in ((dict(population=None), "needs population"),
                      (dict(population=PopulationConfig(n=4, cohort=2)),
                       "full-participation"),
                      (dict(population=PopulationConfig(
                          n=4, cohort=4, max_staleness=2.0)),
                       "synchronous")):
        for drv, cfg_cls in ((port, PopulationConfig),
                             (ref, RefPopulationConfig)):
            pop = kw["population"]
            drv.population = (None if pop is None else cfg_cls(
                **dataclasses.asdict(pop)))
            with pytest.raises(ValueError, match=match):
                drv.run(2)


# ------------------------------------------------------------ the kernel

@pytest.mark.parametrize("m, n", [(8, 4096), (1, 1001), (3, 3)])
def test_per_row_adafbio_equals_loop_of_shared(m, n):
    """One call over [M, n] rows of ``a`` equals M calls of the shared
    version, bit for bit, on the plain path the CPU runs."""
    g = torch.Generator().manual_seed(m * n)
    p, w = torch.randn(m, n, generator=g), torch.randn(m, n, generator=g)
    a = torch.rand(m, n, generator=g)
    lr, rho = torch.tensor(0.01), torch.tensor(1e-4)
    got = adafbio_update(p, w, a, lr, rho)
    loop = torch.cat([adafbio_update(p[i:i + 1], w[i:i + 1], a[i], lr, rho)
                      for i in range(m)])
    assert torch.equal(got.view(torch.int32), loop.view(torch.int32))
    torch.testing.assert_close(got, ref.adafbio_update_ref(p, w, a, lr, rho),
                               rtol=0, atol=0)
    # the tree wrapper: per-row accumulators of a stacked tree
    tree = lambda t: {"u": t[:, :1], "v": t[:, 1:]}       # noqa: E731
    out = ops.adafbio_update_tree(tree(p), tree(w), tree(a), 0.01, 1e-4)
    assert torch.equal(torch.cat([out["u"], out["v"]], 1), got)
