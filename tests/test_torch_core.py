"""The port's core against the reference's, on the quadratic problem and on
hyper-representation at the default ``HyperRepConfig``: the Eq. 15
hypergradient (generic and factored), the adaptive matrices of every kind,
and AdaFBiO's local step and sync with the fused path on and off, plus
every Table-1 baseline. Inputs come from numpy seeds and the reference's
own batches; the Neumann depths are the reference's draws. Tolerance 1e-5
(the reference's engine-parity tolerance, tests/test_round_engine.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_harness import (assert_trees_close, neumann_k, to_jax,
                                to_torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.paper_tasks import HyperRepConfig as RefHyperRepConfig  # noqa: E402
from repro.core import adafbio as ref_adafbio  # noqa: E402
from repro.core import adaptive as ref_ada  # noqa: E402
from repro.core import baselines as ref_baselines  # noqa: E402
from repro.core import bilevel as ref_bilevel  # noqa: E402
from repro.core import hypergrad as ref_hg  # noqa: E402
from repro.tasks.hyperrep import build_hyperrep as ref_build_hyperrep  # noqa: E402
from repro_torch.configs import FedConfig, HyperRepConfig  # noqa: E402
from repro_torch.core import adafbio, adaptive as ada, baselines  # noqa: E402
from repro_torch.core import bilevel, hypergrad as hg  # noqa: E402
from repro_torch.core.tree_util import tree_stack  # noqa: E402
from repro_torch.tasks import build_hyperrep  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = ("adam", "adabelief", "amsgrad", "adagrad", "none")


def fed_pair(**kw):
    """The same FedConfig in both packages (fields move by asdict)."""
    ref = RefFedConfig(**kw)
    return ref, FedConfig(**dataclasses.asdict(ref))


# ------------------------------------------------------------ problems

def quadratic(seed=0, d=8, p=6):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((p, p)).astype(np.float32)
    H = (A @ A.T / p + 0.5 * np.eye(p)).astype(np.float32)
    Bm = (rng.standard_normal((p, d)) * 0.3).astype(np.float32)
    c = rng.standard_normal(p).astype(np.float32)
    Q = (np.eye(d) * 0.2).astype(np.float32)
    consts = (H, Bm, c, Q)
    ref = ref_bilevel.quadratic_bilevel_problem(*map(jnp.asarray, consts))
    port = bilevel.quadratic_bilevel_problem(*map(torch.from_numpy, consts))
    theta = float(1.0 / np.linalg.eigvalsh(H)[-1])
    return ref, port, consts, theta


def quad_batches(K, m=None):
    b = {"f": np.float32(0), "g": np.float32(0), "g0": np.float32(0),
         "gi": np.zeros((K,), np.float32)}
    if m is not None:
        b = jax.tree.map(lambda a: np.stack([a] * m), b)
    return b


_HYPER = {}


def hyperrep():
    """Reference and port problems of the default HyperRepConfig, the
    reference's batches for 8 clients at step 0, and perturbed params."""
    if not _HYPER:
        cfg = RefHyperRepConfig()
        ref_task = ref_build_hyperrep(cfg)
        port_task = build_hyperrep(
            HyperRepConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                              if k != "fed"}, fed=FedConfig(
                **dataclasses.asdict(cfg.fed))), device="cpu")
        xp, yp = ref_task["init_xy"](jax.random.PRNGKey(0))
        rng = np.random.default_rng(5)
        yp = {"heads": (0.3 * rng.standard_normal(yp["heads"].shape)
                        ).astype(np.float32)}
        xp = jax.tree.map(np.asarray, xp)
        batches = [jax.tree.map(np.asarray, ref_task["batch_fn"](m, 0))
                   for m in range(cfg.n_clients)]
        _HYPER.update(cfg=cfg, ref=ref_task["problem"],
                      port=port_task["problem"], xp=xp, yp=yp,
                      batches=batches)
    return _HYPER


def step_depths(step_keys, K):
    """The depths AdaFBiO's local step draws from its step keys: the first
    half of ``split(key)`` (core/adafbio.py:125)."""
    return torch.tensor([neumann_k(jax.random.split(k)[0], K)
                         for k in step_keys])


def stacked(trees):
    return jax.tree.map(lambda *a: np.stack(a), *trees)


# ------------------------------------------------------------ hypergrad

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hypergrad_quadratic(seed):
    ref, port, _, theta = quadratic()
    K = 8
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(8).astype(np.float32)
    y = rng.standard_normal(6).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = ref_hg.hypergrad(ref, jnp.asarray(x), jnp.asarray(y),
                            to_jax(quad_batches(K)), key, K, theta)
    got = hg.hypergrad(port, torch.from_numpy(x), torch.from_numpy(y),
                       to_torch(quad_batches(K)),
                       torch.tensor(neumann_k(key, K)), K, theta)
    assert_trees_close(got, want, **TOL)


def test_hypergrad_hyperrep_batched_clients_mask_their_depths():
    """One vmapped call over 8 clients, each with its own depth k, equals
    the reference's per-client estimator (the K-1 masked iterations)."""
    h = hyperrep()
    K, theta = h["cfg"].fed.neumann_k, h["cfg"].fed.theta
    keys = [jax.random.PRNGKey(10 + m) for m in range(h["cfg"].n_clients)]
    ks = [neumann_k(k, K) for k in keys]
    assert len(set(ks)) > 1
    fn = hg.hypergrad_fn(h["port"], K, theta)
    got = torch.func.vmap(lambda b, k: fn(to_torch(h["xp"]),
                                          to_torch(h["yp"]), b, k))(
        to_torch(stacked(h["batches"])), torch.tensor(ks))
    ref_fn = jax.jit(lambda b, k: ref_hg.hypergrad(
        h["ref"], to_jax(h["xp"]), to_jax(h["yp"]), b, k, K, theta))
    want = stacked([jax.tree.map(np.asarray, ref_fn(to_jax(b), k))
                    for b, k in zip(h["batches"], keys)])
    assert_trees_close(got, want, **TOL)


def _factored_pair(nu):
    """A factored hyper-representation problem in both packages: features
    are the representation MLP, the head is y."""
    def make(lib, xent, sqnorm, to_f32):
        def features(xp, batch):
            h = lib.tanh(batch["a"] @ xp["w1"] + xp["b1"])
            return lib.tanh(h @ xp["w2"] + xp["b2"])

        def head_loss(yp, feats, batch):
            head = yp["heads"][batch["client"]] if lib is jnp else \
                torch.index_select(yp["heads"], 0,
                                   batch["client"].reshape(1).long())[0]
            return xent(to_f32(feats) @ head, batch["b"])

        def g_from_feats(yp, feats, batch):
            return head_loss(yp, feats, batch) + 0.5 * nu * sqnorm(yp)
        return dict(features=features, f_from_feats=head_loss,
                    g_from_feats=g_from_feats,
                    f=lambda x, y, b: head_loss(y, features(x, b), b),
                    g=lambda x, y, b: g_from_feats(y, features(x, b), b))
    from repro.core.tree_util import tree_sqnorm as ref_sq
    from repro_torch.core.tree_util import tree_sqnorm
    ref = ref_bilevel.BilevelProblem(**make(
        jnp, ref_bilevel.softmax_xent, ref_sq, lambda a: a))
    port = bilevel.BilevelProblem(**make(
        torch, bilevel.softmax_xent, tree_sqnorm, lambda a: a.float()))
    return ref, port


def test_hypergrad_factored_hyperrep():
    """The factored path caches the Neumann batches' features in bf16, in
    both packages. The same f32 features can round to neighbouring bf16
    values when the two packages' f32 features differ in the last bit, so
    this holds to 1e-4 (one bf16 step, 2^-8, scaled by θ·K and the loss's
    1/batch)."""
    h = hyperrep()
    K, theta = h["cfg"].fed.neumann_k, h["cfg"].fed.theta
    ref, port = _factored_pair(h["cfg"].fed.nu)
    for m in (0, 3):
        key = jax.random.PRNGKey(20 + m)
        b = h["batches"][m]
        want = ref_hg.hypergrad_factored(ref, to_jax(h["xp"]),
                                         to_jax(h["yp"]), to_jax(b), key, K,
                                         theta)
        got = hg.hypergrad_factored(port, to_torch(h["xp"]),
                                    to_torch(h["yp"]), to_torch(b),
                                    torch.tensor(neumann_k(key, K)), K, theta)
        assert_trees_close(got, want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ adaptive

@pytest.mark.parametrize("kind", KINDS)
def test_update_adaptive_every_kind(kind):
    rng = np.random.default_rng(7)
    x_like = {"w": np.zeros((4, 3), np.float32), "b": np.zeros(3, np.float32)}
    state = jax.tree.map(np.asarray, ref_ada.init_adaptive_state(
        to_jax(x_like), kind))
    for _ in range(3):        # a few regenerations from non-zero states
        w_bar = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), x_like)
        v_bar = rng.standard_normal(5).astype(np.float32)
        want = ref_ada.update_adaptive(to_jax(state), to_jax(w_bar),
                                       jnp.asarray(v_bar), kind=kind,
                                       varrho=0.9)
        got = ada.update_adaptive(to_torch(state), to_torch(w_bar),
                                  torch.from_numpy(v_bar), kind=kind,
                                  varrho=0.9)
        assert_trees_close(got, want, **TOL, what=kind)
        w = to_torch(w_bar)
        assert_trees_close(
            ada.precondition_x(got, w, kind=kind, rho=1e-4),
            ref_ada.precondition_x(want, to_jax(w_bar), kind=kind, rho=1e-4),
            **TOL)
        state = jax.tree.map(np.asarray, want)


# ------------------------------------------------------------ steps

def _quad_states(ref_alg, ref_fed, m, K):
    """Reference init of m clients (keys split from PRNGKey(7)) and its
    warm server, exported to numpy, with the port's depths for the init."""
    xp, yp = jnp.ones((8,)) * 2.0, jnp.zeros((6,))
    keys = jax.random.split(jax.random.PRNGKey(7), m)
    b_m = to_jax(quad_batches(K, m))
    states = jax.vmap(lambda k, b: ref_alg.init_client_state(xp, yp, b, k))(
        keys, b_m)
    server = ref_alg.init_server_state(xp)
    if ref_fed.adaptive != "none":
        server = ref_adafbio.warm_adaptive(
            server, jax.tree.map(lambda a: a.mean(0), states), ref_fed)
    init_k = torch.tensor([neumann_k(k, K) for k in keys])
    return (jax.tree.map(np.asarray, states),
            jax.tree.map(np.asarray, server), init_k, (xp, yp), b_m)


@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("kind", ["adam", "amsgrad", "none"])
def test_quadratic_init_local_step_and_sync(fused, kind):
    ref_p, port_p, _, theta = quadratic()
    K, m = 8, 4
    ref_fed, fed = fed_pair(q=4, neumann_k=K, lr_x=0.3, lr_y=0.3, theta=theta,
                            adaptive=kind, fused=fused)
    ref_alg = ref_baselines.make_algorithm("adafbio", ref_fed, ref_p)
    states, server, init_k, (xp, yp), b_m = _quad_states(ref_alg, ref_fed,
                                                         m, K)
    # init
    got0 = adafbio.init_client_state(port_p, fed, to_torch(xp), to_torch(yp),
                                     to_torch(quad_batches(K, m)), init_k)
    assert_trees_close(got0, states, **TOL, what="init")
    # one local step at t = 3 for all clients
    t = 3
    keys = [jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(1), i),
                               t) for i in range(m)]
    want = jax.jit(jax.vmap(lambda st, b, k: ref_adafbio.local_step(
        ref_p, ref_fed, st, to_jax(server)["adaptive"], b, k, jnp.int32(t),
        m)))(to_jax(states), b_m, jnp.stack(keys))
    got = adafbio.local_step(port_p, fed, to_torch(states),
                             to_torch(server)["adaptive"],
                             to_torch(quad_batches(K, m)),
                             step_depths(keys, K),
                             torch.tensor(t, dtype=torch.int32), m)
    assert_trees_close(got, want, **TOL, what="local_step")
    # sync on the averaged state
    avg = jax.tree.map(lambda a: np.asarray(a).mean(0), want)
    srv = dict(server, t=np.int32(t + 1))
    want_c, want_s = ref_adafbio.sync_update(ref_fed, to_jax(srv),
                                             to_jax(avg), m)
    got_c, got_s = adafbio.sync_update(fed, to_torch(srv), to_torch(avg), m)
    assert_trees_close(got_c, want_c, **TOL, what="sync client")
    assert_trees_close(got_s, want_s, **TOL, what="sync server")


@pytest.mark.parametrize("fused", ["off", "on"])
def test_hyperrep_local_step_and_sync(fused):
    h = hyperrep()
    cfg = h["cfg"]
    m, K = cfg.n_clients, cfg.fed.neumann_k
    ref_fed, fed = fed_pair(**dict(dataclasses.asdict(cfg.fed), fused=fused))
    rng = np.random.default_rng(11)
    states = {"x": stacked([h["xp"]] * m), "y": stacked([h["yp"]] * m)}
    states["v"] = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)
                                          ).astype(np.float32), states["y"])
    states["w"] = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)
                                          ).astype(np.float32), states["x"])
    adaptive = {"b": np.float32(0.7), "a": jax.tree.map(
        lambda a: np.abs(0.01 * rng.standard_normal(a.shape[1:])).astype(
            np.float32), states["x"])}
    t = 5
    keys = [jax.random.PRNGKey(30 + i) for i in range(m)]
    b_m = stacked(h["batches"])
    want = jax.jit(jax.vmap(lambda st, b, k: ref_adafbio.local_step(
        h["ref"], ref_fed, st, to_jax(adaptive), b, k, jnp.int32(t), m)))(
        to_jax(states), to_jax(b_m), jnp.stack(keys))
    got = adafbio.local_step(h["port"], fed, to_torch(states),
                             to_torch(adaptive), to_torch(b_m),
                             step_depths(keys, K),
                             torch.tensor(t, dtype=torch.int32), m)
    assert_trees_close(got, want, **TOL, what="local_step")
    avg = jax.tree.map(lambda a: np.asarray(a).mean(0), want)
    srv = {"adaptive": adaptive, "t": np.int32(t + 1)}
    want_c, want_s = ref_adafbio.sync_update(ref_fed, to_jax(srv),
                                             to_jax(avg), m)
    got_c, got_s = adafbio.sync_update(fed, to_torch(srv), to_torch(avg), m)
    assert_trees_close(got_c, want_c, **TOL, what="sync client")
    assert_trees_close(got_s, want_s, **TOL, what="sync server")


@pytest.mark.parametrize("name", baselines.ALGORITHMS)
def test_every_algorithm_step_and_sync(name):
    assert baselines.ALGORITHMS == ref_baselines.ALGORITHMS
    ref_p, port_p, _, theta = quadratic(seed=4)
    K, m = 8, 3
    ref_fed, fed = fed_pair(q=4, neumann_k=K, lr_x=0.3, lr_y=0.3, theta=theta)
    ref_alg = ref_baselines.make_algorithm(name, ref_fed, ref_p)
    alg = baselines.make_algorithm(name, fed, port_p)
    assert alg.name == ref_alg.name and alg.fed == FedConfig(
        **dataclasses.asdict(ref_alg.fed))
    states, server, _, _, b_m = _quad_states(ref_alg, ref_alg.fed, m, K)
    t = 2
    keys = jax.random.split(jax.random.PRNGKey(9), m)
    split_step = name not in ("fednest", "localbsgvrm")
    ks = [neumann_k(jax.random.split(k)[0] if split_step else k, K)
          for k in keys]
    want = jax.jit(jax.vmap(lambda st, b, k: ref_alg.local_step(
        st, to_jax(server)["adaptive"], b, k, jnp.int32(t), m)))(
        to_jax(states), b_m, keys)
    got = alg.local_step(to_torch(states), to_torch(server)["adaptive"],
                         to_torch(quad_batches(K, m)), torch.tensor(ks),
                         torch.tensor(t, dtype=torch.int32), m)
    assert_trees_close(got, want, **TOL, what=f"{name} local_step")
    avg = jax.tree.map(lambda a: np.asarray(a).mean(0), want)
    want_c, want_s = ref_alg.sync_update(to_jax(server), to_jax(avg), m)
    got_c, got_s = alg.sync_update(to_torch(server), to_torch(avg), m)
    assert_trees_close(got_c, want_c, **TOL, what=f"{name} sync client")
    assert_trees_close(got_s, want_s, **TOL, what=f"{name} sync server")


def test_schedules_match_reference():
    ref_fed, fed = fed_pair()
    for t in (0, 1, 7, 100, 12345):
        want_eta = ref_adafbio.eta_t(ref_fed, jnp.int32(t), 8)
        got_eta = adafbio.eta_t(fed, torch.tensor(t, dtype=torch.int32), 8)
        assert got_eta.dtype == torch.float32
        np.testing.assert_allclose(got_eta.numpy(), np.asarray(want_eta),
                                   rtol=1e-6)
        for g, w in zip(adafbio.alpha_beta(fed, got_eta),
                        ref_adafbio.alpha_beta(ref_fed, want_eta)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_stacked_batches_layout():
    """tree_stack of per-client reference batches keeps every leaf's
    client axis first (the layout the client-batched steps expect)."""
    h = hyperrep()
    b = tree_stack([to_torch(x) for x in h["batches"]])
    assert b["gi"]["a"].shape[:2] == (h["cfg"].n_clients,
                                      h["cfg"].fed.neumann_k)
