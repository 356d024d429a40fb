"""The port's ssm and hybrid serve paths against the JAX package's, on the
CPU.

- The configs (falcon-mamba-7b, zamba2-1.2b) field for field, and the
  weights carried across through ``interop``; the ``ssm_a`` init equal to
  the reference's, the ``ssm_dt`` init in its range.
- The scan: ``ref.mamba_scan_ref`` (the kernel's plain version, and the
  CUDA wrapper on CPU tensors) against the JAX oracle at the reference's
  test shapes, a ragged Di, strided B and C, and a carried state (1e-5,
  the reference's own kernel tolerance); the port's chunked associative
  scan against ``_selective_scan_chunk``.
- The mixers ``mamba1_seq``/``mamba1_decode`` and ``mamba2_seq``/
  ``mamba2_decode`` in f32 at reduced widths, and the whole models:
  forward, prefill (logits and every cache leaf) and decode of reduced
  falcon-mamba-7b and zamba2-1.2b (5 layers, the shared block every 2, so
  that both a segment and the tail run) against ``repro.models.decode``:
  1e-5 on the reference path, 1e-4 on the kernel and plain paths (the
  reference's kernel-vs-model tolerance, tests/test_kernels.py:259-260).
- The engine: the reference engine's greedy tokens for both families, and
  ``kv_quant=True`` refused as the reference refuses it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_harness import CPU, to_torch

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.models import decode as ref_decode  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro.serve import Engine as RefEngine  # noqa: E402
from repro.serve import LoadSpec as RefLoadSpec  # noqa: E402
from repro.serve import generate_requests as ref_generate  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_arch, list_arch_ids, reduced  # noqa: E402
from repro_torch.kernels import mamba_scan as mk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import decode, model, ssm  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serve import Engine, LoadSpec, generate_requests  # noqa: E402

ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")
SCAN_TOL = 1e-5            # tests/test_kernels.py:236
MODEL_RTOL = 1e-5          # the reference path: the reference's own ops
KERNEL_RTOL = 1e-4         # the scan's paths: tests/test_kernels.py:259-260
MAX_LEN = 24


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32),
        rtol=tol, atol=tol, err_msg=what)


def _small(arch_id, **kw):
    """The reduced configs of both packages, f32 unless ``dtype`` is given;
    zamba2 at 5 layers with the shared block every 2 (two segments and a
    one-layer tail)."""
    kw.setdefault("dtype", "float32")
    if arch_id == "zamba2-1.2b":
        kw.setdefault("n_layers", 5)
        kw.setdefault("shared_attn_every", 2)
    return (ref_reduced(ref_get_arch(arch_id), **kw),
            reduced(get_arch(arch_id), **kw))


def _params(cfg_ref, cfg, seed=0):
    """The reference's init, carried into the port. The init leaves the
    conv bias at zero and D at one: give them values, so that their paths
    are exercised."""
    tree = ref_init_params(ref_model.model_specs(cfg_ref),
                           jax.random.PRNGKey(seed), cfg_ref.dtype)
    rng = np.random.default_rng(seed)
    layers = tree["x"]["layers"]
    for name, scale, shift in (("conv_b", 0.1, 0.0), ("D", 0.1, 1.0)):
        leaf = layers[name]
        layers[name] = jnp.asarray(
            rng.standard_normal(leaf.shape).astype(np.float32) * scale
            + shift).astype(leaf.dtype)
    return tree, interop.serve_params_from_reference(
        cfg, jax.tree.map(np.asarray, tree), CPU)


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch_id", ARCHS)
def test_configs_match_reference_field_for_field(arch_id):
    assert arch_id in list_arch_ids()
    assert (dataclasses.asdict(get_arch(arch_id))
            == dataclasses.asdict(ref_get_arch(arch_id)))
    for kw in ({}, {"dtype": "float32"}, {"n_layers": 5}):
        assert (dataclasses.asdict(reduced(get_arch(arch_id), **kw))
                == dataclasses.asdict(ref_reduced(ref_get_arch(arch_id),
                                                  **kw)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_reference_params_carry_into_the_port(arch_id, dtype):
    """Every leaf (A_log, D, dt_b, conv_w, ..., zamba2's x["shared"]) with
    the reference's path, shape, dtype and bits."""
    cfg_ref, cfg = _small(arch_id, dtype=dtype)
    tree = ref_init_params(ref_model.model_specs(cfg_ref),
                           jax.random.PRNGKey(1), dtype)
    got = interop.serve_params_from_reference(
        cfg, jax.tree.map(np.asarray, tree), CPU)
    flat_ref = dict(interop._named(jax.tree.map(np.asarray, tree)))
    flat = dict(interop._named(got))
    assert sorted(flat) == sorted(flat_ref)
    assert {"x/layers/A_log", "x/layers/D", "x/layers/dt_b",
            "x/layers/conv_w"} <= set(flat)
    if arch_id == "zamba2-1.2b":
        assert {"x/shared/wq", "x/shared/wd"} <= set(flat)
    for name, t in flat.items():
        want = flat_ref[name]
        assert tuple(t.shape) == want.shape, name
        assert str(t.dtype).removeprefix("torch.") == want.dtype.name, name
        np.testing.assert_array_equal(t.float().numpy(),
                                      want.astype(np.float32))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_ssm_inits(arch_id):
    """``ssm_a`` equals the reference's bit for bit; ``ssm_dt`` (drawn
    from the port's generator) is softplus^-1 of a dt in [1e-3, 1e-1]."""
    cfg_ref, cfg = _small(arch_id)
    tree = ref_init_params(ref_model.model_specs(cfg_ref),
                           jax.random.PRNGKey(0), "float32")
    got = init_params(model.model_specs(cfg), torch.Generator().manual_seed(0),
                      "float32")
    a_log = got["x"]["layers"]["A_log"]
    np.testing.assert_array_equal(
        a_log.numpy(), np.asarray(tree["x"]["layers"]["A_log"]))
    dt = torch.nn.functional.softplus(got["x"]["layers"]["dt_b"])
    assert dt.dtype == torch.float32
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert float(dt.max()) / float(dt.min()) > 10        # log-uniform spread


# ------------------------------------------------------------ the scan

def _scan_inputs(rng, b, s, di, n, proj_cols=0):
    """The reference kernel test's inputs (tests/test_kernels.py:225),
    drawn with numpy; with ``proj_cols`` B and C are column slices of a
    [B, S, proj_cols + 2N] projection, as ``mamba1_seq`` hands them in."""
    x = rng.standard_normal((b, s, di)).astype(np.float32) * 0.1
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)))).astype(np.float32)
    A = -np.abs(rng.standard_normal((di, n))).astype(np.float32)
    proj = rng.standard_normal((b, s, proj_cols + 2 * n)).astype(
        np.float32) * 0.1
    return x, dt, A, proj[..., proj_cols:proj_cols + n], proj[
        ..., proj_cols + n:]


@pytest.mark.parametrize("b,s,di,n,proj_cols,carry", [
    (1, 32, 256, 8, 0, False),     # the reference's test shapes
    (2, 64, 1024, 16, 0, False),
    (1, 40, 1000, 16, 0, False),   # ragged Di
    (2, 33, 96, 16, 256, False),   # B and C as strided projection slices
    (1, 17, 64, 4, 0, True),       # a carried state h0
])
def test_mamba_scan_plain_matches_reference_oracle(b, s, di, n, proj_cols,
                                                   carry):
    rng = np.random.default_rng(b * 100 + s + di)
    x, dt, A, Bm, Cm = _scan_inputs(rng, b, s, di, n, proj_cols)
    h0 = (rng.standard_normal((b, di, n)).astype(np.float32) if carry
          else None)
    y_r, h_r = ref_ref.mamba_scan_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                      h0=None if h0 is None
                                      else jnp.asarray(h0))
    t = [torch.from_numpy(a) for a in (x, dt, A)] + [
        torch.from_numpy(np.ascontiguousarray(a)) for a in (Bm, Cm)]
    if proj_cols:
        full = torch.from_numpy(np.concatenate(
            [np.zeros((b, s, proj_cols), np.float32), Bm, Cm], -1))
        t[3], t[4] = full[..., proj_cols:proj_cols + n], full[
            ..., proj_cols + n:]
        assert t[3].stride(1) == proj_cols + 2 * n
    y, h = ref.mamba_scan_ref(*t, h0=None if h0 is None
                              else torch.from_numpy(h0))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(y, y_r, SCAN_TOL, "y")
    _close(h, h_r, SCAN_TOL, "h_last")
    if h0 is None:
        # the wrapper on CPU tensors is the plain version, and counts
        # nothing
        before = dict(mk.launches)
        y2, h2 = mk.mamba_scan(*t)
        assert mk.launches == before
        torch.testing.assert_close(y2, y, rtol=0, atol=0)
        torch.testing.assert_close(h2, h, rtol=0, atol=0)


def test_mamba_scan_plain_keeps_x_dtype():
    rng = np.random.default_rng(5)
    x, dt, A, Bm, Cm = (torch.from_numpy(np.ascontiguousarray(a))
                        for a in _scan_inputs(rng, 1, 9, 32, 8))
    y, h = ref.mamba_scan_ref(x.bfloat16(), dt, A, Bm.bfloat16(), Cm)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


@pytest.mark.parametrize("c", [1, 2, 7, 16, 33])
def test_chunk_scan_matches_reference_selective_scan_chunk(c):
    """The port's copy of ``jax.lax.associative_scan`` over one chunk, at
    odd and even lengths, from a nonzero state."""
    rng = np.random.default_rng(c)
    b, di, n = 2, 24, 8
    a = np.exp(-np.abs(rng.standard_normal((b, c, di, n)))).astype(
        np.float32)
    bx = rng.standard_normal((b, c, di, n)).astype(np.float32)
    h0 = rng.standard_normal((b, di, n)).astype(np.float32)
    hs_r, last_r = ref_ssm._selective_scan_chunk(
        *map(jnp.asarray, (a, bx, h0)))
    hs, last = ssm._selective_scan_chunk(
        *map(torch.from_numpy, (a, bx, h0)))
    _close(hs, hs_r, SCAN_TOL, "hs")
    _close(last, last_r, SCAN_TOL, "h_last")
    # and it is the recurrence h_t = a_t h_{t-1} + bx_t
    h, seq = torch.from_numpy(h0), []
    for t in range(c):
        h = torch.from_numpy(a[:, t]) * h + torch.from_numpy(bx[:, t])
        seq.append(h)
    torch.testing.assert_close(hs, torch.stack(seq, 1), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------ the mixers

def _layer(tree, params, i=0):
    lt = jax.tree.map(lambda a: a[i], tree["x"]["layers"])
    return lt, model.layer(params["x"]["layers"], i)


@pytest.mark.parametrize("path", ["reference", "plain", "kernel"])
@pytest.mark.parametrize("s", [12, 300])
def test_mamba1_seq_and_decode_match_reference(s, path):
    """One mamba1 layer over a prompt (at 300 steps the reference path
    runs one chunk of 300; its chunking is not split), then three decode
    steps from the prompt's state and conv tail."""
    cfg_ref, cfg = _small("falcon-mamba-7b")
    tree, params = _params(cfg_ref, cfg)
    lt, lp = _layer(tree, params, 1)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    y_r, (h_r, c_r) = ref_ssm.mamba1_seq(cfg_ref, lt, jnp.asarray(x))
    y, (h, c) = ssm.mamba1_seq(cfg, lp, torch.from_numpy(x), path=path)
    tol = MODEL_RTOL if path == "reference" else KERNEL_RTOL
    for got, want, what in ((y, y_r, "y"), (h, h_r, "h"), (c, c_r, "conv")):
        _close(got, want, tol, what)
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        y_r, (h_r, c_r) = ref_ssm.mamba1_decode(cfg_ref, lt, jnp.asarray(xt),
                                                h_r, c_r)
        y, (h, c) = ssm.mamba1_decode(cfg, lp, torch.from_numpy(xt), h, c)
        for got, want, what in ((y, y_r, "y"), (h, h_r, "h"),
                                (c, c_r, "conv")):
            _close(got, want, tol, f"decode {step} {what}")


def test_mamba1_seq_carried_state_runs_the_chunk_scan():
    """With a state to start from (h0, conv0) every path takes the
    reference's chunk scan, as the reference does."""
    cfg_ref, cfg = _small("falcon-mamba-7b")
    tree, params = _params(cfg_ref, cfg)
    lt, lp = _layer(tree, params)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 9, cfg.d_model)).astype(np.float32)
    di, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
    h0 = rng.standard_normal((1, di, n)).astype(np.float32) * 0.1
    c0 = rng.standard_normal((1, cfg.ssm.conv_width - 1, di)).astype(
        np.float32)
    y_r, (h_r, _) = ref_ssm.mamba1_seq(cfg_ref, lt, jnp.asarray(x),
                                       jnp.asarray(h0), jnp.asarray(c0))
    before = dict(mk.launches)
    y, (h, _) = ssm.mamba1_seq(cfg, lp, torch.from_numpy(x),
                               torch.from_numpy(h0), torch.from_numpy(c0),
                               path="kernel")
    assert mk.launches == before
    _close(y, y_r, MODEL_RTOL, "y")
    _close(h, h_r, MODEL_RTOL, "h")


def test_reference_path_raises_where_the_reference_chunking_does():
    """A property of the reference (ROADMAP section 3): ``mamba1_seq``
    cuts S into S // chunk chunks of S // nchunks steps and reshapes, so a
    length those do not divide raises (S 600 at chunk 256: 2 chunks of
    300, 600 = 2 x 300 works; S 601 does not). The port's reference path
    raises there too; the scan's paths take any length."""
    cfg_ref, cfg = _small("falcon-mamba-7b")
    tree, params = _params(cfg_ref, cfg)
    lt, lp = _layer(tree, params)
    x = np.random.default_rng(0).standard_normal(
        (1, 601, cfg.d_model)).astype(np.float32)
    with pytest.raises(TypeError, match="reshape"):
        ref_ssm.mamba1_seq(cfg_ref, lt, jnp.asarray(x))
    with pytest.raises(RuntimeError, match="shape"):
        ssm.mamba1_seq(cfg, lp, torch.from_numpy(x), path="reference")
    y, _ = ssm.mamba1_seq(cfg, lp, torch.from_numpy(x), path="plain")
    assert y.shape == (1, 601, cfg.d_model) and torch.isfinite(y).all()


@pytest.mark.parametrize("s,chunk", [(12, 256), (64, 16)])
def test_mamba2_seq_and_decode_match_reference(s, chunk):
    """One mamba2 layer (the SSD dual form over one chunk, and over four
    chunks with a carried state), then three decode steps."""
    cfg_ref, cfg = _small("zamba2-1.2b")
    tree, params = _params(cfg_ref, cfg)
    lt, lp = _layer(tree, params, 2)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    y_r, (h_r, c_r) = ref_ssm.mamba2_seq(cfg_ref, lt, jnp.asarray(x),
                                         chunk=chunk)
    y, (h, c) = ssm.mamba2_seq(cfg, lp, torch.from_numpy(x), chunk=chunk)
    for got, want, what in ((y, y_r, "y"), (h, h_r, "h"), (c, c_r, "conv")):
        _close(got, want, MODEL_RTOL, what)
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        y_r, (h_r, c_r) = ref_ssm.mamba2_decode(cfg_ref, lt, jnp.asarray(xt),
                                                h_r, c_r)
        y, (h, c) = ssm.mamba2_decode(cfg, lp, torch.from_numpy(xt), h, c)
        for got, want, what in ((y, y_r, "y"), (h, h_r, "h"),
                                (c, c_r, "conv")):
            _close(got, want, MODEL_RTOL, f"decode {step} {what}")


# ------------------------------------------------------------ the models

@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_matches_reference(arch_id):
    cfg_ref, cfg = _small(arch_id)
    tree, params = _params(cfg_ref, cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 11),
                                               dtype=np.int32)
    want = ref_model.forward(cfg_ref, tree, {"tokens": jnp.asarray(tokens)},
                             ref_model.ModelCtx())
    got = model.forward(cfg, params, {"tokens": torch.from_numpy(tokens)},
                        model.ModelCtx())
    _close(got, want, MODEL_RTOL)


@pytest.mark.parametrize("path", ["reference", "plain", "kernel"])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_prefill_and_decode_match_reference(arch_id, path):
    """Prefill (logits and every cache leaf), then three decode steps at a
    scalar and at per-row ``[B]`` positions; the prefill's logits also
    equal the last position of the forward."""
    cfg_ref, cfg = _small(arch_id)
    tree, params = _params(cfg_ref, cfg)
    tol = MODEL_RTOL if path == "reference" else KERNEL_RTOL
    rng = np.random.default_rng(1)
    b, s, w = 2, 7, 12
    tokens = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    ctx_r = ref_model.ModelCtx(kind="prefill", kv_kernel="xla")
    cache_r = ref_decode.init_cache(cfg_ref, b, w, dtype=jnp.float32)
    lg_r, cache_r = ref_decode.prefill(cfg_ref, tree,
                                       {"tokens": jnp.asarray(tokens)},
                                       cache_r, ctx_r)
    cache = decode.init_cache(cfg, b, w, dtype=torch.float32, device=CPU)
    assert sorted(cache) == sorted(cache_r)
    for key in cache:
        assert tuple(cache[key].shape) == cache_r[key].shape, key
        assert (str(cache[key].dtype).removeprefix("torch.")
                == cache_r[key].dtype.name), key
    lg, cache = decode.prefill(cfg, params,
                               {"tokens": torch.from_numpy(tokens)}, cache,
                               model.ModelCtx(kind="prefill", attn=path))
    _close(lg, lg_r, tol, "prefill logits")
    for key in cache_r:
        _close(cache[key], cache_r[key], tol, f"prefill {key}")
    full = model.forward(cfg, params, {"tokens": torch.from_numpy(tokens)},
                         model.ModelCtx())
    torch.testing.assert_close(lg[:, 0], full[:, -1], rtol=tol, atol=tol)
    for step, pos in enumerate((np.int32(7), np.array([8, 5], np.int32),
                                np.array([9, 11], np.int32))):
        token = rng.integers(0, cfg.vocab, (b, 1), dtype=np.int32)
        lg_r, cache_r = ref_decode.decode_step(
            cfg_ref, tree, cache_r, jnp.asarray(token), jnp.asarray(pos),
            ref_model.ModelCtx(kind="decode", kv_kernel="xla"))
        lg, cache = decode.decode_step(
            cfg, params, cache, torch.from_numpy(token),
            torch.from_numpy(np.asarray(pos)),
            model.ModelCtx(kind="decode", attn=path))
        _close(lg, lg_r, tol, f"decode {step} logits")
        for key in cache_r:
            _close(cache[key], cache_r[key], tol, f"decode {step} {key}")


# ------------------------------------------------------------ engine

@pytest.mark.parametrize("arch_id", ARCHS)
def test_engine_tokens_match_reference_engine(arch_id):
    """The port's engine ("auto": the scan's plain version on the CPU)
    serves the reference engine's tokens on the reference's own test
    workload (tests/test_serve_engine.py)."""
    cfg_ref, cfg = _small(arch_id)
    tree, params = _params(cfg_ref, cfg)
    spec = dict(n_requests=5, prompt_lens=(4, 7), mean_new_tokens=4.0,
                max_new_cap=6, seed=3)
    reqs = generate_requests(LoadSpec(**spec), cfg.vocab)
    want = RefEngine(cfg_ref, tree, slots=3, max_len=MAX_LEN,
                     kv_kernel="xla").run(ref_generate(RefLoadSpec(**spec),
                                                       cfg.vocab))
    got = Engine(cfg, params, slots=3, max_len=MAX_LEN, device="cpu").run(
        reqs)
    assert ({c.rid: c.tokens for c in got}
            == {c.rid: c.tokens for c in want})
    assert ({c.rid: (c.finish_reason, c.decode_ticks) for c in got}
            == {c.rid: (c.finish_reason, c.decode_ticks) for c in want})


@pytest.mark.parametrize("arch_id,what", [("falcon-mamba-7b", "SSM state"),
                                          ("zamba2-1.2b", "hybrid state")])
def test_kv_quant_raises_as_in_the_reference(arch_id, what):
    cfg_ref, cfg = _small(arch_id)
    tree, params = _params(cfg_ref, cfg)
    with pytest.raises(ValueError, match=what) as want:
        RefEngine(cfg_ref, tree, slots=2, max_len=MAX_LEN, kv_quant=True)
    with pytest.raises(ValueError, match=what) as got:
        Engine(cfg, params, slots=2, max_len=MAX_LEN, kv_quant=True,
               device="cpu")
    assert str(got.value) == str(want.value)
