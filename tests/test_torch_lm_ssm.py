"""The LM problem on the ssm and hybrid families against the JAX reference,
on the CPU, at ``lm_family``'s cases: ``reduced(falcon-mamba-7b)``
(mamba1), ``reduced(zamba2-1.2b)`` (2 mamba2 layers, the shared block
after them) and ``reduced(zamba2-1.2b, n_layers=3)`` (a segment, then a
tail layer with no shared block after it); the attention families' cases
too (whisper-tiny's batches with the encoder's frames in the model's
dtype, widened with the params for the f32 witness). Every case runs the chunked
scans at ``ModelCtx(kind="train", ssm_chunk=CHUNK)`` on both sides, so that
each sequence spans two chunks or more and the state carried between
chunks is differentiated.

- ``lm_bilevel_problem``: f, g and the microbatched gradients at one and two
  microbatches, in f32 at 1e-5 and in bf16 beside an f32 witness; the
  factored hypergradient.
- The SSD's masked exponential (``models/ssm.py`` ``_ssd_chunk_dual``): the
  port masks before the exponential, where the reference's gradient is NaN
  once a head's decay within a chunk overflows f32, against a witness:
  the reference with the mask moved (on the hybrid trainer:
  ``test_torch_lm_hybrid_tail.py``).
- Per-layer rematerialisation (``models/remat.py``): the training forward's
  values and every derivative the hypergradient takes, bit for bit against
  the layers called directly, on the dense, ssm, hybrid and encdec
  families (the encdec decoder layers take their cross-attention's K and
  V, projected from the encoder's output, as inputs).

The trainer's cases are in ``test_torch_lm_ssm_train.py`` (ssm),
``test_torch_lm_hybrid_train.py`` and ``test_torch_lm_hybrid_tail.py``
(hybrid). The reference's draws are
carried across through numpy, as in ``test_torch_lm_train.py``, whose
tolerances apply."""
import functools

import numpy as np
import pytest
import torch

import lm_family as F
import test_torch_lm_train as L
from lm_family import CASES, CHUNK, ssd_mask_first
from test_torch_harness import assert_trees_close, neumann_k, to_torch

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.core import bilevel as ref_bilevel  # noqa: E402
from repro.core import hypergrad as ref_hg  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.model import model_specs as ref_specs  # noqa: E402
from repro.models.params import init_params as ref_init  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core import bilevel, hypergrad  # noqa: E402
from repro_torch.core.tree_util import (tree_leaves, tree_map,  # noqa: E402
                                        tree_vdot)
from repro_torch.models import model, ssm  # noqa: E402
from repro_torch.models.model import ModelCtx  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

# bf16 against an f32 witness, as test_torch_lm_round.py's bf16 round: the
# port's normwise distance from the reference's f32 run (from the same
# params widened) at most WITNESS times the reference's bf16 run's, plus
# WITNESS_MARGIN
WITNESS = 2.0
WITNESS_MARGIN = 1e-3


def _dist(leaves, witness):
    """Normwise distance of each leaf from the witness's."""
    return [np.linalg.norm(np.asarray(a, np.float64) - w)
            / max(np.linalg.norm(w), 1e-30) for a, w in zip(leaves, witness)]


def _numpy_leaves(tree):
    """Float64 numpy leaves of a port or a reference tree, in one order."""
    return [np.asarray(t.detach().double() if isinstance(t, torch.Tensor)
                       else t, np.float64) for t in jax.tree.leaves(tree)]


def assert_witnessed(got, want, witness, what):
    """The port's bf16 result no farther from the f32 witness than WITNESS
    times the reference's bf16 result, plus WITNESS_MARGIN, leaf by leaf."""
    wit = _numpy_leaves(witness)
    port, ref = _dist(_numpy_leaves(got), wit), _dist(_numpy_leaves(want),
                                                      wit)
    assert len(port) == len(ref) == len(wit), what
    for i, (p_e, r_e) in enumerate(zip(port, ref)):
        assert p_e <= WITNESS * r_e + WITNESS_MARGIN, (what, i, p_e, r_e)


# ------------------------------------------------------------ the problem

@functools.lru_cache(maxsize=None)
def _problem_inputs(case, dtype):
    """Params (away from the zero-init biases) and batches of both
    packages, as ``test_torch_lm_train._problem_inputs``: ``f``/``g`` 2
    sequences of L.SEQ, ``g0`` one of 64, ``gi`` K Neumann batches of one."""
    ref_cfg, cfg = F._cfgs(case, dtype)
    params = ref_init(ref_specs(ref_cfg), jax.random.PRNGKey(1), dtype)
    params = jax.tree.map(lambda a: a + (0.05 * jax.random.normal(
        jax.random.PRNGKey(2), a.shape)).astype(a.dtype), params)
    rng = np.random.default_rng(0)

    def toks(*shape):
        return rng.integers(0, cfg.vocab, shape).astype(np.int32)
    batches = {"f": {"tokens": toks(2, L.SEQ)},
               "g": {"tokens": toks(2, L.SEQ)},
               "g0": {"tokens": toks(1, 64)},
               "gi": {"tokens": toks(L.K, 1, 64)}}
    if cfg.family == "encdec":
        # frames as many as tokens, in the model's dtype
        for b in batches.values():
            b["enc_embeds"] = np.asarray(jnp.asarray(rng.standard_normal(
                b["tokens"].shape + (cfg.d_model,)).astype(
                    np.float32)).astype(dtype))
    return params, batches


def _problems(case, dtype, microbatch):
    ref_cfg, cfg = F._cfgs(case, dtype)
    rctx, pctx = F._ctxs()
    return (ref_bilevel.lm_bilevel_problem(ref_cfg, rctx, 1e-3,
                                           microbatch=microbatch),
            bilevel.lm_bilevel_problem(cfg, pctx, 1e-3,
                                       microbatch=microbatch))


def _problem_results(problem, xp, yp, b):
    return (problem.f(xp, yp, b["f"]), problem.g(xp, yp, b["g"]),
            problem.grad_f_xy(xp, yp, b["f"]),
            problem.grad_g_y(xp, yp, b["g"]))


@functools.lru_cache(maxsize=None)
def _results(case, dtype, microbatch, widened=False):
    """The reference's (jitted) and the port's f, g, grad_f_xy and
    grad_g_y on ``_problem_inputs``; ``widened``: the reference's f32 run
    from the bf16 params widened (the bf16 cases' witness)."""
    params, batches = _problem_inputs(case, "bfloat16" if widened else dtype)
    rp, pp = _problems(case, dtype, microbatch)
    if widened:
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
        batches = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32)
                               if a.dtype.kind == "V" or a.dtype.itemsize
                               == 2 else a, batches)
    want = jax.jit(lambda x, y, b: _problem_results(rp, x, y, b))(
        params["x"], params["y"], jax.tree.map(jnp.asarray, batches))
    if widened:
        return want, None
    got = _problem_results(pp, to_torch(params["x"]), to_torch(params["y"]),
                           to_torch(batches))
    return want, got


@pytest.mark.parametrize("nc", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_problem_f32_matches_reference(case, nc):
    """f, g, grad_f_xy and grad_g_y through the chunked scans in f32, at
    one and two microbatches: 1e-5, the dense family's limit
    (test_torch_lm_train.TOL)."""
    want, got = _results(case, "float32", 1 if nc == 2 else None)
    for name, g, w in zip(("f", "g"), got[:2], want[:2]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5,
                                   err_msg=name)
    for name, g, w in zip(("grad_f_xy", "grad_g_y"), got[2:], want[2:]):
        assert_trees_close(g, w, **L.TOL["float32"], what=f"{name} nc={nc}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_problem_bf16_beside_an_f32_witness(case):
    """The same in bf16 at two microbatches (the trainer's accumulation in
    the params' dtype), each result held against the reference's f32 run
    from the bf16 params widened (the witness). zamba2's bf16 gradients
    part from the reference's by up to 2.7e-2 normwise (A_log; the shared
    wq and wk 2.2e-2), past the dense family's fixed 2e-2: each package
    rounds at other places, so both are held to the witness."""
    want, got = _results(case, "bfloat16", 1)
    witness, _ = _results(case, "float32", 1, widened=True)
    for name, g, w, f in zip(("f", "g", "grad_f_xy", "grad_g_y"), got, want,
                             witness):
        assert_witnessed(g, w, f, name)


@functools.lru_cache(maxsize=None)
def _ref_hypergrad(case):
    rp, _ = _problems(case, "float32", 1)
    return jax.jit(lambda x, y, b, key: ref_hg.hypergrad_factored(
        rp, x, y, b, key, L.K, 1.0))


@pytest.mark.parametrize("k", [0, L.K - 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_hypergrad_factored_matches_reference(case, k):
    """At depth 0 the Neumann loop reads no cached feature: 1e-5. At depth
    K - 1 it reads the bf16 feature cache: TRAIN_REL normwise, as the
    dense family's."""
    params, batches = _problem_inputs(case, "float32")
    _, pp = _problems(case, "float32", 1)
    key = next(jax.random.PRNGKey(s) for s in range(100)
               if neumann_k(jax.random.PRNGKey(s), L.K) == k)
    want = _ref_hypergrad(case)(params["x"], params["y"],
                                jax.tree.map(jnp.asarray, batches), key)
    got = hypergrad.hypergrad_factored(
        pp, to_torch(params["x"]), to_torch(params["y"]), to_torch(batches),
        torch.tensor(k), L.K, 1.0)
    if k > 0:
        L.assert_rel(got, want, L.TRAIN_REL, "hypergrad_factored")
    else:
        assert_trees_close(got, want, **L.TOL["float32"],
                           what="hypergrad_factored")


# ------------------------------------------------------------ the SSD repair

def _ssd_inputs(steps, dt, A, seed=0, P=4, N=8):
    """One sequence for ``_ssd_chunk_dual``: x, B and C normal, dt constant
    per head, A per head, a zero initial state; as numpy."""
    rng = np.random.default_rng(seed)
    H = len(A)
    return dict(
        xh=rng.standard_normal((1, steps, H, P)).astype(np.float32),
        Bc=rng.standard_normal((1, steps, N)).astype(np.float32),
        Cc=rng.standard_normal((1, steps, N)).astype(np.float32),
        dtc=np.broadcast_to(np.asarray(dt, np.float32),
                            (1, steps, H)).copy(),
        A=np.asarray(A, np.float32),
        h0=np.zeros((1, H, P, N), np.float32))


def _ssd_loss(fn, chunk, xh, Bc, Cc, dtc, A, h0, lib):
    y, h = fn(xh, Bc, Cc, dtc, A, h0, chunk)
    return lib.sum(y * y) + lib.sum(h)


def _port_ssd_grads(inp, chunk, fn=None):
    fn = fn or ssm._ssd_chunk_dual
    args = {k: torch.from_numpy(v) for k, v in inp.items()}
    names = ("xh", "Bc", "Cc", "dtc")
    gr = torch.func.grad(lambda *a: _ssd_loss(
        fn, chunk, *a, args["A"], args["h0"], torch),
        argnums=(0, 1, 2, 3))(*(args[k] for k in names))
    return dict(zip(names, gr))


def _ref_ssd_grads(inp, chunk, fn=None):
    fn = fn or ref_ssm._ssd_chunk_dual
    args = {k: jnp.asarray(v) for k, v in inp.items()}
    names = ("xh", "Bc", "Cc", "dtc")
    gr = jax.grad(lambda *a: _ssd_loss(fn, chunk, *a, args["A"], args["h0"],
                                       jnp), argnums=(0, 1, 2, 3))(
        *(args[k] for k in names))
    return dict(zip(names, gr))


def ssd_select_after(xh, Bc, Cc, dtc, A, h0, chunk):
    """The port's ``_ssd_chunk_dual`` as it stood before the repair (the
    reference's order: the select after the exponential), to show the
    repair leaves the forward as it was."""
    b, S, H, P = xh.shape
    c = S // max(S // chunk, 1)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool))
    h, ys = h0, []
    for x_c, B_c, C_c, dt_c in zip(*(ssm._chunked(t, S // c, c)
                                     for t in (xh, Bc, Cc, dtc))):
        seg = torch.cumsum(dt_c * A, dim=1)
        gap = seg[:, :, None, :] - seg[:, None, :, :]
        decay = torch.where(mask[None, :, :, None], torch.exp(gap), 0.0)
        cb = torch.einsum("bin,bjn->bij", C_c, B_c)
        y = torch.einsum("bijh,bjhp->bihp", cb[..., None] * decay,
                         x_c * dt_c[..., None])
        y = y + torch.einsum("bin,bhpn,bih->bihp", C_c, h, torch.exp(seg))
        last = seg[:, -1:, :]
        h = (h * torch.exp(last)[:, 0, :, None, None]
             + torch.einsum("bch,bchp,bcn->bhpn",
                            torch.exp(last - seg) * dt_c, x_c, B_c))
        ys.append(y)
    return torch.stack(ys).transpose(0, 1).reshape(b, S, H, P), h


# A = -1, -4, -16, -64 over 64 steps at dt 0.1: the decay within the chunk
# reaches 6.4, 25.6, 102.4 and 409.6, so exp of the gap above the diagonal
# overflows f32 (past 88.7) in the last two heads
OVERFLOW = dict(steps=64, dt=[0.1] * 4, A=[-1.0, -4.0, -16.0, -64.0])
# the gradients normwise per input: a dt gradient sums terms of either sign
# and parts elementwise by up to 8e-5 where it cancels
SSD_REL = 1e-5


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """The reference's dt gradient is NaN in exactly the heads whose decay
    overflows (the fault the port does not copy); the port's every
    gradient is finite, and matches the witness (the reference with the
    mask moved before the exponential) at SSD_REL."""
    inp = _ssd_inputs(**OVERFLOW)
    ref = _ref_ssd_grads(inp, 64)
    nan_heads = np.isnan(np.asarray(ref["dtc"])).any(axis=(0, 1))
    assert nan_heads.tolist() == [False, False, True, True]
    assert np.isfinite(np.asarray(ref["xh"])).all()
    got = _port_ssd_grads(inp, 64)
    for name in got:
        assert torch.isfinite(got[name]).all(), name
    L.assert_rel(got, _ref_ssd_grads(inp, 64, ssd_mask_first), SSD_REL,
                 "SSD gradients against the witness")


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_repair_keeps_the_forward_where_nothing_overflows(chunk):
    """Where no head overflows (decays up to 3.2 a chunk of 32): the
    repaired forward bit for bit the pre-repair one, the forward against
    the reference at 1e-5 and the gradients at SSD_REL, over 2 and 4
    chunks."""
    inp = _ssd_inputs(steps=64, dt=[0.05, 0.1, 0.02, 0.1],
                      A=[-1.0, -0.5, -2.0, -1.0], seed=1)
    args = [torch.from_numpy(inp[k]) for k in ("xh", "Bc", "Cc", "dtc", "A",
                                               "h0")]
    got = ssm._ssd_chunk_dual(*args, chunk)
    before = ssd_select_after(*args, chunk)
    for g, b in zip(got, before):
        assert torch.equal(g, b)
    want = ref_ssm._ssd_chunk_dual(*(jnp.asarray(a.numpy()) for a in args),
                                   chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    L.assert_rel(_port_ssd_grads(inp, chunk), _ref_ssd_grads(inp, chunk),
                 SSD_REL, "SSD gradients")


# ------------------------------------------------------------ remat

REMAT_ARCHS = {"dense": ("qwen1.5-4b", {}),
               "ssm": ("falcon-mamba-7b", {}),
               "hybrid": ("zamba2-1.2b", {"n_layers": 3}),
               "encdec": ("whisper-tiny", {})}


def _remat_results(cfg, params, batches, ctx):
    """Everything the trainer differentiates through the features: the
    features, grad in (x, y), vmap of the features over K batches, jvp of
    grad_y (the Neumann HVP), the mixed x-y term, a plain autograd
    backward."""
    xp, yp = params["x"], params["y"]
    b, gi = batches["f"], batches["gi"]

    def loss(xp, yp, b):
        lg = model.forward(cfg, {"x": xp, "y": yp}, b, ctx)
        return torch.log_softmax(lg.float(), -1)[..., 0].mean()

    def grad_y(xp, yp):
        return torch.func.grad(loss, argnums=1)(xp, yp, b)
    u = tree_map(torch.ones_like, yp)
    xr = tree_map(lambda t: t.detach().requires_grad_(), xp)
    loss(xr, yp, b).backward()
    return {
        "features": model.features(cfg, xp, b, ctx),
        "grad": torch.func.grad(loss, argnums=(0, 1))(xp, yp, b),
        "vmap": torch.func.vmap(lambda bb: model.features(cfg, xp, bb,
                                                          ctx))(gi),
        "jvp": torch.func.jvp(lambda y: grad_y(xp, y), (yp,), (u,))[1],
        "mixed": torch.func.grad(lambda x: tree_vdot(grad_y(x, yp), u))(xp),
        "backward": [t.grad for t in tree_leaves(xr)]}


@pytest.mark.parametrize("family", sorted(REMAT_ARCHS))
def test_remat_equals_the_direct_layers_bit_for_bit(family, monkeypatch):
    """The training forward through ``remat_layer`` against the same
    layers called directly (``remat_layer`` replaced by a plain call):
    every result bit for bit, and finite. One remat'd call a layer, the
    encdec encoder's included, and none for the hybrid's shared block (its
    attention weights never reach ``remat_layer``), as the reference's
    ``_hybrid_seq``."""
    arch, kw = REMAT_ARCHS[family]
    cfg = reduced(get_arch(arch), dtype="float32", **kw)
    gen = torch.Generator().manual_seed(0)
    params = init_params(model.model_specs(cfg), gen, "float32", "cpu")
    batches = {"f": {"tokens": torch.randint(0, cfg.vocab, (2, 32),
                                             generator=gen)},
               "gi": {"tokens": torch.randint(0, cfg.vocab, (2, 1, 32),
                                              generator=gen)}}
    want = [sorted(params["x"]["layers"])] * cfg.n_layers
    if cfg.family == "encdec":
        for b in batches.values():
            b["enc_embeds"] = torch.randn(b["tokens"].shape + (
                cfg.d_model,), generator=gen)
        # the encoder's layers, then the decoder's with their
        # cross-attention's K and V among their inputs in place of the
        # leaves that project them
        want = ([sorted(params["x"]["encoder"]["layers"])]
                * cfg.encoder.n_layers
                + [sorted([n for n in params["x"]["layers"]
                           if n not in model.CROSS_KV_LEAVES]
                          + list(model.CROSS_KV))] * cfg.n_layers)
    ctx = ModelCtx(kind="train", ssm_chunk=CHUNK)
    seen = []
    real = model.remat_layer

    def counted(body, h, p):
        seen.append(sorted(p))
        return real(body, h, p)
    monkeypatch.setattr(model, "remat_layer", counted)
    model.features(cfg, params["x"], batches["f"], ctx)
    assert seen == want
    remat = _remat_results(cfg, params, batches, ctx)
    monkeypatch.setattr(model, "remat_layer", lambda body, h, p: body(h, p))
    direct = _remat_results(cfg, params, batches, ctx)
    for name in remat:
        got, want = tree_leaves(remat[name]), tree_leaves(direct[name])
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert torch.isfinite(g).all(), name
            assert torch.equal(g, w), name


def test_remat_backward_is_first_order_only():
    """The remat'd layer's backward recomputes the layer detached from the
    enclosing graph, so that ``torch.func.grad`` (which builds the graph
    of every backward) keeps no layer's recompute: a derivative of its
    gradients in x (a Hessian-vector product through the layers, which the
    trainer never takes) raises instead of coming out wrong."""
    cfg = reduced(get_arch("qwen1.5-4b"), dtype="float32")
    params = init_params(model.model_specs(cfg),
                         torch.Generator().manual_seed(0), "float32", "cpu")
    ctx = ModelCtx(kind="train")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int64)}

    def loss(xp):
        return model.features(cfg, xp, batch, ctx).square().mean()
    u = tree_map(torch.ones_like, params["x"])
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.func.grad(lambda x: tree_vdot(torch.func.grad(loss)(x), u))(
            params["x"])


def test_serve_kinds_run_the_layers_directly(monkeypatch):
    """Only the training forward rematerialises: prefill-kind features
    never reach ``remat_layer``."""
    cfg = reduced(get_arch("falcon-mamba-7b"), dtype="float32")
    params = init_params(model.model_specs(cfg),
                         torch.Generator().manual_seed(0), "float32", "cpu")
    monkeypatch.setattr(model, "remat_layer", None)
    feats = model.features(cfg, params["x"], {"tokens": torch.zeros(
        (1, 8), dtype=torch.int64)}, ModelCtx(kind="prefill"))
    assert feats.shape == (1, 8, cfg.d_model)
