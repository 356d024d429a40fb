"""Shared pieces of the LM parity files of the families after the dense
one (``test_torch_lm_ssm.py``, ``test_torch_lm_ssm_train.py``,
``test_torch_lm_hybrid_train.py``, ``test_torch_lm_hybrid_tail.py`` for
the ssm and hybrid families; ``test_torch_lm_moe.py`` and
``test_torch_lm_vlm.py`` for the moe, vlm and dense ones;
``test_torch_lm_encdec.py`` for the encdec one): the cases and
their chunk, the SSD witness, both packages' trainers on a case, the LM
problem's test and the trainer tests. A test
file imports the trainer tests it runs and picks their cases with the
fixtures ``case`` (the trainer's cases) and ``family_case`` (one case of
the family: the population round and the CLI), so that each test is one
function whose cases are spread over files that each stay within a few
minutes.

The LM problem's test: f, g and their gradients in f32 at one and two
microbatches, with the prefix embeddings or the encoder's frame
embeddings where the arch takes them.

The trainer tests, in f32 with ``fused="on"`` on both sides:

- the init, a local step and a sync at TRAIN_REL normwise, at a key whose
  Neumann depths are all 0; an eager run of 4 steps stage by stage (each
  stage from the reference's state) at TRAIN_REL, free-running at
  EAGER_REL, and eval; the scan rounds equal to the port's eager calls bit
  for bit;
- one population round (N 4, C 2, broadcast) from the reference's states;
- the train CLI's checkpoint of the family: served by the serve CLI, read
  by the reference's bridge, and a reference checkpoint read by the
  port's.

The reference's draws (params, tokens, Neumann depths) are carried across
through numpy, as in ``test_torch_lm_train.py``, whose tolerances apply.
The encdec batches' frame embeddings (bf16 in both packages' batch specs)
are widened to f32 for the f32 trainers (:func:`frames_in_f32`): the
reference's encoder scan refuses a bf16 carry that its f32 layers turn
into f32 (ROADMAP section 3); the port casts them to the model's dtype
itself."""
import functools

import numpy as np
import pytest
import torch

import test_torch_lm_train as L
from test_torch_harness import (assert_trees_close, neumann_k,
                                reference_draws, to_torch)

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro.configs import FedConfig as RefFed  # noqa: E402
from repro.configs import get_arch as ref_arch, reduced as ref_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.core import bilevel as ref_bilevel  # noqa: E402
from repro.core.tree_util import tree_stack as ref_stack  # noqa: E402
from repro.data.synthetic import FederatedLMData as RefData  # noqa: E402
from repro.data.synthetic import make_client_batch as ref_batch  # noqa: E402
from repro.data.synthetic import make_cohort_batch as ref_cohort  # noqa: E402
from repro.fed import runtime as ref_rt  # noqa: E402
from repro.models.model import ModelCtx as RefCtx  # noqa: E402
from repro.models.model import model_specs as ref_specs  # noqa: E402
from repro.models.params import init_params as ref_init  # noqa: E402
from repro.serve import bridge as ref_bridge  # noqa: E402
from repro_torch.configs import FedConfig, ShapeConfig, get_arch, reduced  # noqa: E402
from repro_torch.core import bilevel  # noqa: E402
from repro_torch.core.tree_util import tree_leaves, tree_stack  # noqa: E402
from repro_torch.fed import runtime  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import ModelCtx  # noqa: E402
from repro_torch.serve import bridge  # noqa: E402

# case -> (arch, overrides of ``reduced``): 2 mamba1 layers; 2 mamba2
# layers with the shared block after them; a segment of 2 and a tail layer
# with no shared block after it (the reference's ``_hybrid_seq`` ``rem``);
# 2 moe layers of 4 experts (top 2; top 1 beside the shared FFN, with 8
# prefix embeddings); 2 vlm layers with 8 prefix embeddings; 2 dense
# layers; the attention archs GQA at 2 kv heads; whisper-tiny at 2
# encoder and 2 decoder layers (MHA, 4 heads)
CASES = {"falcon-mamba-7b": ("falcon-mamba-7b", {}),
         "zamba2-1.2b": ("zamba2-1.2b", {}),
         "zamba2-1.2b-3L": ("zamba2-1.2b", {"n_layers": 3}),
         "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {"n_kv_heads": 2}),
         "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e",
                                   {"n_kv_heads": 2}),
         "internvl2-76b": ("internvl2-76b", {"n_kv_heads": 2}),
         "deepseek-67b": ("deepseek-67b", {"n_kv_heads": 2}),
         "whisper-tiny": ("whisper-tiny", {})}
# the scans' chunk: the training sequences (L.SEQ = 32) span 2 chunks, the
# zeta_0 and Neumann sequences (64) 4, so the state carried between chunks
# is differentiated
CHUNK = 16
# A free-running eager run (4 steps and a sync) parts from the reference
# by more than any one stage: each stage, run from the reference's state,
# parts by at most 3.3e-6 (w at init; the rest below 1e-6), and the
# adaptive step, whose warm start a = w_0^2 divides by sqrt(a) + rho,
# magnifies a leaf's difference 3-40x a step, as the dense family's at the
# launcher's rho (test_torch_lm_train.RHO). Readings after 4 steps: 1.54e-4
# (zamba2 3 layers, w), 1.5e-4 (zamba2 2 layers), below 1e-4 (falcon).
EAGER_REL = 1e-3
# The stages of the trainer tests are held at TRAIN_REL, but for
# whisper-tiny's at ENCDEC_STAGE_REL. Its first local step parts from the
# reference by up to 1.28e-4 normwise in w's cross-attention leaves
# (cln_attn, cwq, cwk; every other leaf below 2e-5), and both packages are
# that far from a float64 witness of the same stage (the port 1.03e-4,
# the reference 1.16e-4): over the stub frames the cross-attention is
# near uniform at init, so those gradients are small and their f32
# rounding relatively large; the adaptive step's warm start then
# magnifies it (test_torch_lm_encdec.py holds the witness rule). Later
# stages read below 3.9e-5. Free-running, that first difference grows as
# EAGER_REL's note says: 1.22e-3 after the 4 steps (the encoder's wq and
# wk in w), held at ENCDEC_EAGER_REL; each package's free run then sits
# 2.3e-3 (the port) and 1.6e-4 (the reference) from a float64 run of the
# port, while stage by stage, each from the same state, the port is no
# farther from that witness than the reference.
ENCDEC_STAGE_REL = 3e-4
ENCDEC_EAGER_REL = 5e-3


def stage_rel(case):
    return (ENCDEC_STAGE_REL if CASES[case][0] == "whisper-tiny"
            else L.TRAIN_REL)


def eager_rel(case):
    return ENCDEC_EAGER_REL if CASES[case][0] == "whisper-tiny" else EAGER_REL


# the population round: N clients, round 0's cohort. At SEED its second
# client draws depth K-1 at the second step (the bf16 feature cache), so
# the round is held at CACHE_REL, as the dense family's population rounds
N, COHORT = 4, (0, 2)


def _cfgs(case, dtype="float32"):
    arch, kw = CASES[case]
    return (ref_reduced(ref_arch(arch), dtype=dtype, **kw),
            reduced(get_arch(arch), dtype=dtype, **kw))


def frames_in_f32(cfg, batch):
    """``batch`` (numpy or JAX leaves) with its ``*enc_embeds`` leaves
    widened to f32 (exact) where ``cfg`` is an f32 encdec model; else as
    it is."""
    if cfg.family != "encdec" or cfg.dtype != "float32":
        return batch
    return {k: (np.asarray(v, np.float32) if k.endswith("enc_embeds")
                else v) for k, v in batch.items()}


def _ctxs(chunk=CHUNK):
    return RefCtx(kind="train", ssm_chunk=chunk), ModelCtx(
        kind="train", ssm_chunk=chunk)


def ssd_mask_first(xh, Bc, Cc, dtc, A, h0, chunk):
    """The SSD repair's witness: the reference's ``_ssd_chunk_dual``
    (``src/repro/models/ssm.py``) with the mask applied to the gap before
    the exponential; everything else as the reference writes it."""
    b, S, H, P = xh.shape
    nchunks = max(S // chunk, 1)
    c = S // nchunks

    def split(t):
        return t.reshape(b, nchunks, c, *t.shape[2:]).swapaxes(0, 1)

    def body(h, xs_c):
        x_c, B_c, C_c, dt_c = xs_c
        seg = jnp.cumsum(dt_c * A, axis=1)
        gap = seg[:, :, None, :] - seg[:, None, :, :]
        mask = jnp.tril(jnp.ones((c, c), bool))
        decay = jnp.exp(jnp.where(mask[None, :, :, None], gap, -jnp.inf))
        cb = jnp.einsum("bin,bjn->bij", C_c, B_c)
        scores = cb[..., None] * decay
        xdt = x_c * dt_c[..., None]
        y = jnp.einsum("bijh,bjhp->bihp", scores, xdt)
        y = y + jnp.einsum("bin,bhpn,bih->bihp", C_c, h, jnp.exp(seg))
        last = seg[:, -1:, :]
        w = jnp.exp(last - seg)
        h_new = (h * jnp.exp(last)[:, 0, :, None, None]
                 + jnp.einsum("bch,bchp,bcn->bhpn", w * dt_c, x_c, B_c))
        return h_new, y

    h_last, ys = jax.lax.scan(body, h0, (split(xh), split(Bc), split(Cc),
                                         split(dtc)))
    return ys.swapaxes(0, 1).reshape(b, S, H, P), h_last


# ------------------------------------------------------------ the problem

@functools.lru_cache(maxsize=None)
def problem_inputs(case):
    """f32 params (away from the zero-init biases) and the ``f``/``g``
    batches of 2 sequences of L.SEQ, as numpy, with n_prefix_embeds
    prefix embeddings a sequence where the arch takes them, and L.SEQ
    frames of encoder embeddings a sequence for an encdec arch."""
    ref_cfg, cfg = _cfgs(case)
    params = ref_init(ref_specs(ref_cfg), jax.random.PRNGKey(1), "float32")
    params = jax.tree.map(lambda a: a + (0.05 * jax.random.normal(
        jax.random.PRNGKey(2), a.shape)).astype(a.dtype), params)
    rng = np.random.default_rng(0)

    def batch():
        b = {"tokens": rng.integers(0, cfg.vocab, (2, L.SEQ)).astype(
            np.int32)}
        if cfg.n_prefix_embeds:
            b["prefix_embeds"] = rng.standard_normal(
                (2, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            b["enc_embeds"] = rng.standard_normal(
                (2, L.SEQ, cfg.d_model)).astype(np.float32)
        return b
    return params, {"f": batch(), "g": batch()}


@functools.lru_cache(maxsize=None)
def _problem_results(case, microbatch):
    """The reference's (jitted) and the port's f, g, grad_f_xy and
    grad_g_y on ``problem_inputs``."""
    ref_cfg, cfg = _cfgs(case)
    rctx, pctx = _ctxs()
    rp = ref_bilevel.lm_bilevel_problem(ref_cfg, rctx, 1e-3,
                                        microbatch=microbatch)
    pp = bilevel.lm_bilevel_problem(cfg, pctx, 1e-3, microbatch=microbatch)
    params, b = problem_inputs(case)

    def results(problem, xp, yp, b):
        return (problem.f(xp, yp, b["f"]), problem.g(xp, yp, b["g"]),
                problem.grad_f_xy(xp, yp, b["f"]),
                problem.grad_g_y(xp, yp, b["g"]))
    want = jax.jit(lambda x, y, b: results(rp, x, y, b))(
        params["x"], params["y"], jax.tree.map(jnp.asarray, b))
    got = results(pp, to_torch(params["x"]), to_torch(params["y"]),
                  to_torch(b))
    return want, got


@pytest.mark.parametrize("nc", [1, 2])
def test_lm_problem_matches_reference(case, nc):
    """f, g, grad_f_xy and grad_g_y in f32, at one and two microbatches
    (the prefix embeddings split with the tokens): 1e-5, the dense
    family's limit (test_torch_lm_train.TOL)."""
    want, got = _problem_results(case, 1 if nc == 2 else None)
    for name, g, w in zip(("f", "g"), got[:2], want[:2]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5,
                                   err_msg=name)
    for name, g, w in zip(("grad_f_xy", "grad_g_y"), got[2:], want[2:]):
        assert_trees_close(g, w, **L.TOL["float32"], what=f"{name} nc={nc}")


# ------------------------------------------------------------ the trainers

def trainers(case, chunk=CHUNK):
    return _trainers(case, chunk)


def ref_fns(case, chunk=CHUNK, witness=False):
    return _ref_fns(case, chunk, witness)


# cached under the full argument list: ``lru_cache`` keys ``f(case)`` and
# ``f(case, CHUNK)`` apart, and each key would compile the reference anew
@functools.lru_cache(maxsize=None)
def _trainers(case, chunk):
    """Both packages' trainers on ``case``; at ``chunk`` None the
    trainers' own LM problem (the default chunk of 256 steps), else the
    same problem at ``ModelCtx(kind="train", ssm_chunk=chunk)``."""
    ref_cfg, cfg = _cfgs(case)
    kw = dict(q=L.Q, neumann_k=L.K, lr_x=1e-2, lr_y=1e-1, fused="on",
              rho=L.RHO)
    ref_fed, fed = RefFed(**kw), FedConfig(**kw)
    ref_prob = prob = None
    if chunk is not None:
        rctx, pctx = _ctxs(chunk)
        ref_prob = ref_bilevel.lm_bilevel_problem(ref_cfg, rctx, ref_fed.nu,
                                                  microbatch=1)
        prob = bilevel.lm_bilevel_problem(cfg, pctx, fed.nu, microbatch=1)
    ref_tr = ref_rt.FederatedTrainer(ref_cfg, ref_fed, RefShape(
        "t", L.SEQ, L.BATCH, "train"), problem=ref_prob)
    tr = runtime.FederatedTrainer(cfg, fed, ShapeConfig(
        "t", L.SEQ, L.BATCH, "train"), problem=prob, device="cpu")
    return ref_tr, tr


@functools.lru_cache(maxsize=None)
def _ref_fns(case, chunk, witness):
    """The reference's jitted init, local step, sync and eval. Each is
    jitted through a fresh function, so that JAX traces it anew: the
    ``witness`` entry is traced under its test's patch of the reference."""
    ref_tr, _ = trainers(case, chunk)

    def jit(fn):
        # numpy arguments: a state that a jitted call returned carries weak
        # types where the init's does not, and would be traced again
        jitted = jax.jit(lambda *a: fn(*a))
        return lambda *a: jitted(*jax.tree.map(np.asarray, a))
    return dict(init=jit(ref_tr.init_states),
                local=jit(ref_tr.local_step_fn()),
                sync=jit(ref_tr.sync_step_fn()), eval=jit(ref_tr.eval_fn()))


@functools.lru_cache(maxsize=None)
def batches(case):
    ref_tr, _ = trainers(case)
    specs, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, 1,
                                         ref_tr.fed)
    data = RefData(vocab=ref_tr.cfg.vocab, n_clients=1)
    return [frames_in_f32(ref_tr.cfg, jax.tree.map(
        np.asarray, ref_batch(data, ref_tr.cfg, specs, t)))
        for t in range(L.STEPS)]


def init(case, seed=L.SEED, chunk=CHUNK, witness=False):
    """Both packages' init from ``PRNGKey(seed)``: the reference's states
    and server, and the port's from the reference's params and depths."""
    ref_tr, tr = trainers(case, chunk)
    b0 = batches(case)[0]
    key = jax.random.PRNGKey(seed)
    ref = ref_fns(case, chunk, witness)["init"](
        key, jax.tree.map(jnp.asarray, b0))
    params = ref_init(ref_tr.specs, jax.random.fold_in(key, L.PARAM_SALT),
                      ref_tr.cfg.dtype)
    draws = reference_draws(key, 1, L.STEPS, L.Q, L.K)
    port = tr.init_states(to_torch(params), to_torch(b0), draws.init)
    return ref, port, draws


def step_and_sync(case, ref, port, draws, seed, chunk=CHUNK,
                  witness=False):
    """One local step (batch 0) and then a sync in both packages, each
    from its own state; returns both stages' ``(ref, port)``."""
    _, tr = trainers(case, chunk)
    fns = ref_fns(case, chunk, witness)
    b0 = batches(case)[0]
    ref = fns["local"](*ref, jax.tree.map(jnp.asarray, b0),
                       jax.random.PRNGKey(seed))
    port = tr.local_step_fn()(*port, to_torch(b0), draws.steps[0])
    return (ref, port), (fns["sync"](*ref), tr.sync_step_fn()(*port))


# ------------------------------------------------------------ the tests

def test_trainer_init_step_and_sync_match_reference(case):
    """At SEED every depth is 0: the init, a local step and a sync at
    TRAIN_REL normwise (readings below 3.4e-6; whisper-tiny's stages at
    ENCDEC_STAGE_REL)."""
    (rs, rv), (ps, pv), draws = init(case)
    rel = stage_rel(case)
    L.assert_rel(ps, rs, L.TRAIN_REL, "init states")
    L.assert_server(pv, rv, "init server")
    for what, ((rs, rv), (ps, pv)) in zip(
            ("local step", "sync"),
            step_and_sync(case, (rs, rv), (ps, pv), draws, L.SEED)):
        L.assert_states(ps, rs, what, rel, rel)
        L.assert_server(pv, rv, f"server after the {what}", rel)


def test_trainer_eager_run_scan_rounds_and_eval(case):
    """The eager loop (4 steps, a sync before step 2): stage by stage, the
    port from the reference's state before each stage, at TRAIN_REL
    (whisper-tiny's at ENCDEC_STAGE_REL); free running at EAGER_REL
    (whisper-tiny's at ENCDEC_EAGER_REL); eval of the reference's final
    state at 1e-5. Then the port's scan rounds from the init, each equal bit for bit to
    its eager calls (q local steps and the sync)."""
    _, tr = trainers(case)
    fns = ref_fns(case)
    (rs, rv), (ps0, pv0), draws = init(case)
    p_local, p_sync = tr.local_step_fn(), tr.sync_step_fn()

    def staged(stage, states, server):
        nonlocal rs, rv
        kind, t = stage
        if kind == "sync":
            got = p_sync(to_torch(rs), to_torch(rv))
            rs, rv = fns["sync"](rs, rv)
        else:
            got = p_local(to_torch(rs), to_torch(rv),
                          to_torch(batches(case)[t]), draws.steps[t])
            rs, rv = fns["local"](rs, rv, jax.tree.map(
                jnp.asarray, batches(case)[t]), L.KEY)
        L.assert_states(got[0], rs, f"{kind} {t}", stage_rel(case),
                        stage_rel(case))
        L.assert_server(got[1], rv, f"server after {kind} {t}",
                        stage_rel(case))
        return states, server
    ps, pv = L._eager(lambda s, v, b, k: p_local(s, v, to_torch(b), k),
                      p_sync, ps0, pv0, batches(case), draws.steps,
                      after=staged)
    L.assert_rel(ps, rs, eager_rel(case), "eager run")
    L.assert_server(pv, rv, "eager run server", eager_rel(case))
    b = batches(case)[-1]
    want = float(fns["eval"](rs, jax.tree.map(jnp.asarray, b)))
    np.testing.assert_allclose(float(tr.eval_fn()(to_torch(rs), to_torch(b))),
                               want, rtol=1e-5)
    eager = scan = (ps0, pv0)
    for r in range(L.STEPS // L.Q):
        bs = [to_torch(b) for b in batches(case)[r * L.Q:(r + 1) * L.Q]]
        k_q = draws.steps[r * L.Q:(r + 1) * L.Q]
        for j in range(L.Q):
            eager = p_local(*eager, bs[j], k_q[j])
        eager = p_sync(*eager)
        scan = tr.round_step_fn()(dict(scan[0]), dict(scan[1]),
                                  tree_stack(bs), k_q)
        for a, e in zip(tree_leaves(scan), tree_leaves(eager)):
            assert torch.equal(a, e), f"round {r}"


def test_population_round_matches_reference(family_case):
    """One population round (gather the cohort, q cohort steps, the
    aggregate, the server step, the broadcast) over a bank of N clients,
    both packages from the reference's states: each client's init by the
    reference's compiled ``init_states`` from its own batch, the server's
    from client 0's. At CACHE_REL normwise (see COHORT); ``last_sync``
    exactly."""
    case = family_case
    ref_tr, tr = trainers(case)
    specs_c, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape,
                                           len(COHORT), ref_tr.fed)
    data = RefData(vocab=ref_tr.cfg.vocab, n_clients=N)
    one = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, 1,
                                    ref_tr.fed)[0]
    key = jax.random.PRNGKey(L.SEED)
    inits = [ref_fns(case)["init"](jax.random.fold_in(key, i), frames_in_f32(
        ref_tr.cfg, ref_cohort(data, ref_tr.cfg, one, 0, [i])))
        for i in range(N)]
    bank = jax.tree.map(lambda *a: jnp.concatenate(a), *[s for s, _ in inits])
    server, last = inits[0][1], jnp.zeros((N,), jnp.int32)
    cohort_b = ref_stack([frames_in_f32(ref_tr.cfg, ref_cohort(
        data, ref_tr.cfg, specs_c, j, np.asarray(COHORT)))
        for j in range(L.Q)])
    want = jax.jit(ref_tr.population_round_fn(N))(
        bank, last, server, jnp.asarray(COHORT), cohort_b, key,
        jnp.int32(0))
    k_q = torch.tensor([[neumann_k(jax.random.split(jax.random.fold_in(
        jax.random.fold_in(key, g), j))[0], L.K) for g in COHORT]
        for j in range(L.Q)])
    assert int(k_q.max()) == L.K - 1, k_q
    got = tr.population_round_fn(N)(
        to_torch(bank), to_torch(last), to_torch(server),
        torch.tensor(COHORT), to_torch(cohort_b), k_q, 0)
    for name in ("x", "y", "v", "w"):
        L.assert_rel(got[0][name], want[0][name], L.CACHE_REL,
                     f"bank {name}")
    assert torch.equal(got[1], to_torch(want[1]))
    L.assert_server(got[2], want[2], "population server", L.CACHE_REL)


def test_train_cli_checkpoint_is_served_and_read_by_both_bridges(
        family_case, tmp_path):
    """The train CLI on the reduced family (4 steps, two scan rounds, a
    checkpoint in 2 shards): the bridge's params are the trained client
    mean, the reference's bridge reads the same params from it, and the
    serve CLI serves 3 requests from it. A checkpoint the reference writes
    (the plain layout over 2 clients, random values) is read by the port's
    bridge as by the reference's."""
    arch = CASES[family_case][0]
    ck = str(tmp_path / "ck")
    run = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--seq", "32", "--batch", "2", "--q", "2",
                          "--steps", "4", "--ckpt", ck, "--ckpt-shards",
                          "2"])
    assert run["step"] == 4 and all(np.isfinite(run["losses"]))
    cfg, ref_cfg = reduced(get_arch(arch)), ref_reduced(ref_arch(arch))
    params, info = bridge.load_serve_params(ck, cfg, device="cpu")
    assert info == {"layout": "plain[adaptive=adam]", "clients": 1,
                    "step": 4}
    for a, b in zip(tree_leaves(params), tree_leaves(
            {"x": run["states"]["x"], "y": run["states"]["y"]})):
        assert torch.equal(a, b.mean(dim=0))
    ref_params, ref_info = ref_bridge.load_serve_params(ck, ref_cfg)
    assert ref_info == info
    for a, b in zip(tree_leaves(params), jax.tree.leaves(ref_params)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    done = serve_cli.main(["--arch", arch, "--reduced", "--ckpt", ck,
                           "--device", "cpu", "--requests", "3",
                           "--max-len", "48"])
    assert sorted(c.rid for c in done) == [0, 1, 2]
    tmpl = dict(ref_bridge._candidate_templates(ref_cfg, 2, "none", 8,
                                                0.05))["plain[adaptive=adam]"]
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda s: (
        rng.integers(0, 100, s.shape).astype(s.dtype)
        if jnp.issubdtype(s.dtype, jnp.integer)
        else np.asarray(jnp.asarray(rng.standard_normal(s.shape).astype(
            np.float32)).astype(s.dtype))), tmpl)
    ref_ckpt.save_checkpoint(tmp_path / "ref", tree, step=7, shards=2)
    want, want_info = ref_bridge.load_serve_params(tmp_path / "ref", ref_cfg)
    got, got_info = bridge.load_serve_params(tmp_path / "ref", cfg,
                                             device="cpu")
    assert got_info == want_info and got_info["clients"] == 2
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
