"""The LM trainer's pieces of the port against the JAX reference at
``reduced(qwen1.5-4b)`` (2 layers, d_model 256, vocab 512, QKV bias):
``lm_bilevel_problem`` (f, g, the microbatched gradients at one and two
chunks, the factored hypergradient) in f32 at 1e-5 and in bf16 at 2e-2
normwise; the leaf-table update path's plain version bit for bit against
the reference's tree wrappers on mixed bf16/f32 trees; ``FederatedTrainer``
(init, local step, sync, an eager run, eval) with ``fused="on"`` on both
sides, in f32 at 1e-4 normwise, stage by stage at the launcher's rho, and
one local step on the per-leaf path (``fused="off"``); the local step and
the stages also at a key whose Neumann depths are K-1 and 0 by turns, with
w held as the bf16 feature cache allows (CACHE_REL). The scan rounds, the codec round and the bf16 run are in
``test_torch_lm_round.py``. The reference's draws (params, tokens, Neumann
depths) are carried across through numpy."""
import functools

import numpy as np
import pytest
import torch

from test_torch_harness import (CPU, assert_trees_close, neumann_k,
                                reference_draws, to_torch)

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.configs import FedConfig as RefFed  # noqa: E402
from repro.configs import get_arch as ref_arch, reduced as ref_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.core import bilevel as ref_bilevel  # noqa: E402
from repro.core import hypergrad as ref_hg  # noqa: E402
from repro.data.synthetic import FederatedLMData as RefData  # noqa: E402
from repro.data.synthetic import make_client_batch as ref_batch  # noqa: E402
from repro.fed import runtime as ref_rt  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models.model import ModelCtx as RefCtx  # noqa: E402
from repro.models.model import model_specs as ref_specs  # noqa: E402
from repro.models.params import init_params as ref_init  # noqa: E402
from repro_torch.configs import FedConfig, ShapeConfig, get_arch, reduced  # noqa: E402
from repro_torch.core import bilevel, hypergrad  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.fed import runtime  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.model import ModelCtx  # noqa: E402

ARCH = "qwen1.5-4b"
SEQ, BATCH = 32, 2
# every Neumann depth of the trainer runs below (init and 4 steps) is 0
# at this key, so the runs read no bf16 feature cache (see CACHE_REL)
SEED = 20
KEY = jax.random.PRNGKey(SEED)
# at this key the depths are K-1 at init and 1, 0, 1, 0 at the four steps:
# the Neumann HVPs and the bf16 feature cache run, and a trainer that took
# another step's depth would part from the reference
DEEP_SEED = 2
PARAM_SALT = 0x9142A           # the reference trainer's parameter key salt
STEPS, Q, K = 4, 2, 2
TOL = {"float32": dict(rtol=1e-5, atol=1e-6)}
# the trainer in f32, normwise per leaf, at SEED (every depth 0): worst
# readings 1.04e-5 after a local step and 3.39e-5 after the eager run
TRAIN_REL = 1e-4
BF16_REL = 2e-2
# The launcher's rho (1e-4) with the warm start's a = w_0^2 scales the x
# step of an element whose first hypergradient was ~0 (an embedding row of
# a token the init batch lacks) by up to 1/rho, and f32 rounding then grows
# 20-50x a step between any two implementations (port and reference part
# by 1e-5, 5e-4, 7e-3, 0.13 over four steps here). Free multi-step runs are
# held at RHO = 1e-2 (3.4e-5 after four steps); the launcher's rho is held
# stage by stage, each stage from the reference's own state.
RHO, LAUNCHER_RHO = 1e-2, 1e-4
# At DEEP_SEED the Neumann loop reads the bf16 feature cache, and the
# features that round to another bf16 neighbour move w, and through it the
# warm start's a = w_0^2 and every later step. Worst normwise readings,
# stage by stage: w 1.12e-4 at init and 2.04e-3, 1.6e-6, 7.5e-4, 2.1e-6
# at steps 0-3 (depths 1, 0, 1, 0; 1.49e-3 at step 0 at the launcher's
# rho), a 1.83e-4 at init, x, y and v below 4e-7. Free-running (init, a
# step, a sync): w 7.46e-4, x 4.78e-4, v 1.03e-4, a 1.83e-4, y 5.8e-7.
# With the cache kept in f32 on both sides every reading falls below
# 2.7e-5, and a local step run at depth 0 instead parts from the
# reference by 3.9-5.4 in w (0.25 at init).
CACHE_REL = 5e-3


def cache_rel(seed):
    return CACHE_REL if seed == DEEP_SEED else TRAIN_REL


# The server's b is a norm of v: the reference's f32 vdot over the head's
# 131,072 elements is 1.4e-4 from the float64 norm, the port's 6e-7
B_REL = 2e-4


def _cfgs(dtype):
    return (ref_reduced(ref_arch(ARCH), dtype=dtype),
            reduced(get_arch(ARCH), dtype=dtype))


def rel_errs(got, want):
    """Normwise relative error of each leaf (port against reference)."""
    out = []
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        g = g.detach().double().numpy()
        w = np.asarray(w, np.float64)
        out.append(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    return out


def assert_rel(got, want, tol, what):
    errs = rel_errs(got, want)
    assert len(errs) == len(jax.tree.leaves(want)), what
    assert max(errs) <= tol, (what, ["%.2e" % e for e in errs])


def check(got, want, dtype, what):
    if dtype == "float32":
        assert_trees_close(got, want, **TOL[dtype], what=what)
    else:
        worst = max(rel_errs(got, want))
        assert worst <= BF16_REL, (what, worst)


# ------------------------------------------------------------ the problem

@functools.lru_cache(maxsize=None)
def _problem_inputs(dtype):
    """Params (a point away from zero-init biases) and batches of both
    packages: ``f``/``g`` batches of 2 sequences (two microbatches of one),
    ``g0`` one sequence and ``gi`` K Neumann batches."""
    ref_cfg, cfg = _cfgs(dtype)
    params = ref_init(ref_specs(ref_cfg), jax.random.PRNGKey(1), dtype)
    params = jax.tree.map(lambda a: a + (0.05 * jax.random.normal(
        jax.random.PRNGKey(2), a.shape)).astype(a.dtype), params)
    rng = np.random.default_rng(0)

    def toks(*shape):
        return rng.integers(0, cfg.vocab, shape).astype(np.int32)
    batches = {"f": {"tokens": toks(2, SEQ)}, "g": {"tokens": toks(2, SEQ)},
               "g0": {"tokens": toks(1, 64)},
               "gi": {"tokens": toks(K, 1, 64)}}
    return ref_cfg, cfg, params, batches


def _problems(dtype, microbatch):
    ref_cfg, cfg, _, _ = _problem_inputs(dtype)
    return (ref_bilevel.lm_bilevel_problem(ref_cfg, RefCtx(kind="train"),
                                           1e-3, microbatch=microbatch),
            bilevel.lm_bilevel_problem(cfg, ModelCtx(kind="train"), 1e-3,
                                       microbatch=microbatch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nc", [1, 2])
def test_lm_problem_values_and_grads_match_reference(dtype, nc):
    _, _, params, batches = _problem_inputs(dtype)
    rp, pp = _problems(dtype, 1 if nc == 2 else None)
    rx, ry = params["x"], params["y"]
    px, py = to_torch(rx), to_torch(ry)
    jb, tb = jax.tree.map(jnp.asarray, batches), to_torch(batches)
    for name in ("f", "g"):
        got = float(getattr(pp, name)(px, py, tb[name]))
        want = float(getattr(rp, name)(rx, ry, jb[name]))
        np.testing.assert_allclose(got, want, rtol=1e-5 if dtype == "float32"
                                   else BF16_REL, err_msg=name)
    check(pp.grad_f_xy(px, py, tb["f"]), rp.grad_f_xy(rx, ry, jb["f"]),
          dtype, f"grad_f_xy nc={nc}")
    check(pp.grad_g_y(px, py, tb["g"]), rp.grad_g_y(rx, ry, jb["g"]),
          dtype, f"grad_g_y nc={nc}")


def test_microbatched_grad_divides_each_chunk_before_the_add():
    """bf16 accumulation in the param dtype, ``acc + (g / nc)`` chunk by
    chunk in order: the reference's bits, not those of summing first."""
    _, _, params, batches = _problem_inputs("bfloat16")
    rp, pp = _problems("bfloat16", 1)
    got = pp.grad_g_y(to_torch(params["x"]), to_torch(params["y"]),
                      to_torch(batches["g"]))
    want = rp.grad_g_y(params["x"], params["y"],
                       jax.tree.map(jnp.asarray, batches["g"]))
    one = [bilevel.microbatched_grad(pp.g, 1, 1)(
        to_torch(params["x"]), to_torch(params["y"]),
        {"tokens": to_torch(batches["g"]["tokens"][i:i + 1])})
        for i in range(2)]
    for g, w, a, b in zip(tree_leaves(got), jax.tree.leaves(want),
                          tree_leaves(one[0]), tree_leaves(one[1])):
        assert g.dtype == a.dtype
        by_chunk = (torch.zeros_like(a) + (a / 2)) + (b / 2)
        assert torch.equal(g, by_chunk)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=BF16_REL,
                                   atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [0, K - 1])
def test_hypergrad_factored_on_the_lm_problem_matches_reference(dtype, k):
    """At depth 0 the Neumann loop reads no cached feature: f32 at 1e-5.
    At depth K - 1 it reads the bf16 feature cache, whose rounding moves a
    few f32 features to another bf16 neighbour: f32 at TRAIN_REL
    normwise."""
    _, _, params, batches = _problem_inputs(dtype)
    rp, pp = _problems(dtype, 1)
    key = next(jax.random.PRNGKey(s) for s in range(100)
               if neumann_k(jax.random.PRNGKey(s), K) == k)
    want = ref_hg.hypergrad_factored(rp, params["x"], params["y"],
                                     jax.tree.map(jnp.asarray, batches),
                                     key, K, 1.0)
    got = hypergrad.hypergrad_factored(
        pp, to_torch(params["x"]), to_torch(params["y"]), to_torch(batches),
        torch.tensor(k), K, 1.0)
    if dtype == "float32" and k > 0:
        assert_rel(got, want, TRAIN_REL, "hypergrad_factored")
    else:
        check(got, want, dtype, "hypergrad_factored")


# ------------------------------------------------------------ leaf tables

def _mixed_tree(rng, lead):
    """reduced qwen1.5-4b's x tree (bf16, the norms f32) with random values,
    as numpy (bf16 as ml_dtypes' bfloat16)."""
    specs = ref_specs(ref_reduced(ref_arch(ARCH)))["x"]

    def leaf(s):
        a = rng.standard_normal(lead + s.shape).astype(np.float32)
        return np.asarray(jnp.asarray(a).astype(s.dtype or jnp.bfloat16))
    return jax.tree.map(leaf, specs,
                        is_leaf=lambda s: hasattr(s, "init"))


def _bit_equal(got, want):
    g_l = [t.float().numpy() for t in tree_leaves(got)]
    w_l = [np.asarray(jnp.asarray(w).astype(jnp.float32))
           for w in jax.tree.leaves(want)]
    assert [t.dtype for t in tree_leaves(got)] == [
        to_torch(np.asarray(w)).dtype for w in jax.tree.leaves(want)]
    for g, w in zip(g_l, w_l):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("m", [1, 3])
def test_leaf_table_storm_plain_version_equals_reference(m):
    rng = np.random.default_rng(m)
    gn, go, est = (_mixed_tree(rng, (m,)) for _ in range(3))
    got = ops.storm_update_tree(to_torch(gn), to_torch(go), to_torch(est),
                                torch.tensor(0.3))
    want = jax.vmap(lambda a, b, c: ref_ops.storm_update_tree(
        a, b, c, jnp.float32(0.3), use_pallas=False))(
            *(jax.tree.map(jnp.asarray, t) for t in (gn, go, est)))
    _bit_equal(got, want)


@pytest.mark.parametrize("m,per_row", [(1, False), (3, False), (3, True)])
def test_leaf_table_adafbio_plain_version_equals_reference(m, per_row):
    rng = np.random.default_rng(10 + m)
    p, w = _mixed_tree(rng, (m,)), _mixed_tree(rng, (m,))
    a = jax.tree.map(np.abs, _mixed_tree(rng, (m,) if per_row else ()))
    got = ops.adafbio_update_tree(to_torch(p), to_torch(w), to_torch(a),
                                  torch.tensor(0.05), 1e-4)

    def one(pp, ww, aa):
        return ref_ops.adafbio_update_tree(pp, ww, aa, jnp.float32(0.05),
                                           1e-4, use_pallas=False)
    pj, wj, aj = (jax.tree.map(jnp.asarray, t) for t in (p, w, a))
    want = jax.vmap(one, in_axes=(0, 0, 0 if per_row else None))(pj, wj, aj)
    _bit_equal(got, want)


# ------------------------------------------------------------ the trainer

@functools.lru_cache(maxsize=None)
def _trainers(dtype="float32", fused="on", codec="none", rho=RHO):
    ref_cfg, cfg = _cfgs(dtype)
    kw = dict(q=Q, neumann_k=K, lr_x=1e-2, lr_y=1e-1, fused=fused,
              codec=codec, error_feedback=True, rho=rho)
    ref_tr = ref_rt.FederatedTrainer(ref_cfg, RefFed(**kw),
                                     RefShape("t", SEQ, BATCH, "train"))
    tr = runtime.FederatedTrainer(cfg, FedConfig(**kw),
                                  ShapeConfig("t", SEQ, BATCH, "train"),
                                  device="cpu")
    return ref_tr, tr


@functools.lru_cache(maxsize=None)
def _batches(dtype="float32"):
    ref_tr, _ = _trainers(dtype)
    specs, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, 1,
                                         ref_tr.fed)
    data = RefData(vocab=ref_tr.cfg.vocab, n_clients=1)
    return [jax.tree.map(np.asarray, ref_batch(data, ref_tr.cfg, specs, t))
            for t in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _init(dtype="float32", fused="on", codec="none", rho=RHO, seed=SEED):
    """Both trainers' init from ``PRNGKey(seed)``: the reference's states
    and server, and the port's from the reference's params and init
    depths."""
    ref_tr, tr = _trainers(dtype, fused, codec, rho)
    b0 = _batches(dtype)[0]
    key = jax.random.PRNGKey(seed)
    ref_states, ref_server = jax.jit(ref_tr.init_states)(
        key, jax.tree.map(jnp.asarray, b0))
    params = ref_init(ref_tr.specs, jax.random.fold_in(key, PARAM_SALT),
                      ref_tr.cfg.dtype)
    draws = reference_draws(key, 1, STEPS, Q, K)
    states, server = tr.init_states(to_torch(params), to_torch(b0),
                                    draws.init)
    return (ref_states, ref_server), (states, server), draws


def assert_states(got, want, what, rel=TRAIN_REL, w_rel=TRAIN_REL):
    """Client states: x, y and v at ``rel``, w at ``w_rel``."""
    for name in ("x", "y", "v"):
        assert_rel(got[name], want[name], rel, f"{what}: {name}")
    assert_rel(got["w"], want["w"], w_rel, f"{what}: w")


def assert_server(got, want, what, rel=TRAIN_REL):
    """The server state: the accumulators at ``rel``, b at B_REL, the step
    counter exactly."""
    assert_rel(got["adaptive"]["a"], want["adaptive"]["a"], rel, what)
    assert int(got["t"]) == int(want["t"]), what
    b, rb = float(got["adaptive"]["b"]), float(want["adaptive"]["b"])
    assert abs(b - rb) <= B_REL * abs(rb), (what, b, rb)


def test_batch_specs_match_reference():
    ref_tr, tr = _trainers()
    want, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, 1,
                                        ref_tr.fed)
    got = runtime.client_batch_specs(tr.cfg, tr.shape, tr.m, tr.fed)
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert got[k].shape == tuple(s.shape)
        assert got[k].dtype == torch.int32 and s.dtype == jnp.int32
    got_abs = tr.abstract_client_states()
    want_abs = ref_tr.abstract_client_states()
    assert [s.shape for s in tree_leaves(got_abs)] == [
        tuple(s.shape) for s in jax.tree.leaves(want_abs)]
    assert [s.shape for s in tree_leaves(tr.abstract_server_state())] == [
        tuple(s.shape) for s in jax.tree.leaves(
            ref_tr.abstract_server_state())]


def test_trainer_init_matches_reference():
    (rs, rv), (ps, pv), _ = _init()
    assert_rel(ps, rs, TRAIN_REL, "init states")
    assert_server(pv, rv, "init server")
    # b at the warm start is the norm of v: the port's is the nearer to the
    # float64 norm of the reference's own v
    exact = np.sqrt(sum((np.asarray(a, np.float64) ** 2).sum()
                        for a in jax.tree.leaves(rs["v"])))
    assert (abs(float(pv["adaptive"]["b"]) - exact)
            <= abs(float(rv["adaptive"]["b"]) - exact))


@pytest.mark.parametrize("seed", [SEED, DEEP_SEED])
def test_trainer_local_step_and_sync_match_reference(seed):
    ref_tr, tr = _trainers()
    (rs, rv), (ps, pv), draws = _init(seed=seed)
    tol = dict(rel=cache_rel(seed), w_rel=cache_rel(seed))
    assert_states(ps, rs, "init states", **tol)
    assert_server(pv, rv, "init server", cache_rel(seed))
    b0 = _batches()[0]
    rs1, rv1 = jax.jit(ref_tr.local_step_fn())(
        rs, rv, jax.tree.map(jnp.asarray, b0), jax.random.PRNGKey(seed))
    ps1, pv1 = tr.local_step_fn()(ps, pv, to_torch(b0), draws.steps[0])
    assert_states(ps1, rs1, "local step", **tol)
    assert_server(pv1, rv1, "server after the step", cache_rel(seed))
    rs2, rv2 = jax.jit(ref_tr.sync_step_fn())(rs1, rv1)
    ps2, pv2 = tr.sync_step_fn()(ps1, pv1)
    assert_states(ps2, rs2, "sync states", **tol)
    assert_server(pv2, rv2, "sync server", cache_rel(seed))


def _eager(step, sync, states, server, batches, ks, after=None):
    """The launcher's eager loop: a sync before each step t > 0 with
    t % q == 0; ``after(stage, states, server)`` sees every stage."""
    for t, b in enumerate(batches):
        if t > 0 and t % Q == 0:
            states, server = sync(states, server)
            if after:
                states, server = after(("sync", t), states, server)
        states, server = step(states, server, b, ks[t])
        if after:
            states, server = after(("step", t), states, server)
    return states, server


def test_trainer_eager_run_and_eval_match_reference():
    """The eager loop, free-running in both packages (one key every step:
    the reference folds t into it), then eval."""
    ref_tr, tr = _trainers()
    (rs, rv), (ps, pv), draws = _init()
    r_local = jax.jit(ref_tr.local_step_fn())
    rs, rv = _eager(lambda s, v, b, k: r_local(s, v, jax.tree.map(
        jnp.asarray, b), k), jax.jit(ref_tr.sync_step_fn()), rs, rv,
        _batches(), [KEY] * STEPS)
    p_local = tr.local_step_fn()
    ps, pv = _eager(lambda s, v, b, k: p_local(s, v, to_torch(b), k),
                    tr.sync_step_fn(), ps, pv, _batches(), draws.steps)
    assert_rel(ps, rs, TRAIN_REL, "eager run")
    assert_server(pv, rv, "eager run server")
    assert int(pv["t"]) == STEPS + (STEPS - 1) // Q
    b = _batches()[-1]
    want = float(jax.jit(ref_tr.eval_fn())(rs, jax.tree.map(jnp.asarray, b)))
    got = float(tr.eval_fn()(ps, to_torch(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("seed", [SEED, DEEP_SEED])
def test_trainer_stages_at_the_launchers_rho_match_reference(seed):
    """The eager loop at the launcher's rho, stage by stage: every local
    step and sync of the port starts from the reference's state before it
    (see RHO)."""
    ref_tr, tr = _trainers(rho=LAUNCHER_RHO)
    (rs, rv), _, draws = _init(rho=LAUNCHER_RHO, seed=seed)
    key = jax.random.PRNGKey(seed)
    r_local = jax.jit(ref_tr.local_step_fn())
    r_sync = jax.jit(ref_tr.sync_step_fn())
    p_local, p_sync = tr.local_step_fn(), tr.sync_step_fn()
    for t, b in enumerate(_batches()):
        if t > 0 and t % Q == 0:
            want = r_sync(rs, rv)
            got = p_sync(to_torch(rs), to_torch(rv))
            assert_states(got[0], want[0], f"sync before {t}",
                          w_rel=cache_rel(seed))
            assert_server(got[1], want[1], f"sync server before {t}")
            rs, rv = want
        want = r_local(rs, rv, jax.tree.map(jnp.asarray, b), key)
        got = p_local(to_torch(rs), to_torch(rv), to_torch(b),
                      draws.steps[t])
        assert_states(got[0], want[0], f"step {t}", w_rel=cache_rel(seed))
        assert_server(got[1], want[1], f"server after step {t}")
        rs, rv = want


def test_trainer_per_leaf_path_matches_reference():
    """``fused="off"``: the reference's per-leaf jnp updates against the
    port's per-leaf PyTorch updates, one local step and one sync."""
    ref_tr, tr = _trainers(fused="off")
    (rs, rv), (ps, pv), draws = _init(fused="off")
    b0 = _batches()[0]
    rs, rv = jax.jit(ref_tr.local_step_fn())(
        rs, rv, jax.tree.map(jnp.asarray, b0), KEY)
    ps, pv = tr.local_step_fn()(ps, pv, to_torch(b0), draws.steps[0])
    rs, rv = jax.jit(ref_tr.sync_step_fn())(rs, rv)
    ps, pv = tr.sync_step_fn()(ps, pv)
    assert_rel(ps, rs, TRAIN_REL, "per-leaf step and sync")
    assert_server(pv, rv, "per-leaf server")


def test_not_ported_builders_name_their_roadmap_item():
    _, tr = _trainers()
    # the multi-round builders (2a) are ported:
    # tests/test_torch_lm_megascan.py; the cohort round (2c) too:
    # tests/test_torch_lm_spill.py; a mesh on one device too
    # (tests/test_torch_mesh.py), and a mesh over several devices is
    # ROADMAP item 1j
    for build in (tr.multi_population_round_fn,
                  tr.multi_async_population_round_fn,
                  tr.multi_gossip_round_fn, tr.cohort_round_fn):
        assert callable(build(4))
    from repro_torch.sharding import Mesh
    devs = np.empty(2, dtype=object)
    devs[:] = [CPU, torch.device("cuda", 0)]
    with pytest.raises(NotImplementedError, match="1j"):
        runtime.FederatedTrainer(tr.cfg, tr.fed, tr.shape,
                                 mesh=Mesh(devs.reshape(2, 1),
                                           ("data", "model")), device=CPU)
