"""The encdec family (whisper-tiny) against the JAX package, on the CPU:

- the config field for field, and ``reduced``'s;
- ``model_specs`` leaf for leaf (the encoder's ``x/encoder/layers/*`` and
  ``ln_out``, the decoder's ``c*`` cross-attention leaves), and the
  reference's params carried by ``serve_params_from_reference``;
- at full width (4 encoder and 4 decoder layers, d_model 384, 6 heads,
  vocab 51865) in f32, 64 frames and 16 tokens: ``encoder_forward``,
  ``features`` and ``forward`` at 1e-5 (the dense family's limit,
  ``test_torch_serve.MODEL_RTOL``), also through the reference's chunked
  attention past a small ``attn_chunk``;
- ``cache_spec`` in the reference's argument order, the cross cache dense
  under ``quant``;
- prefill (logits, ``k``, ``v``, ``ck``, ``cv``) and 4 decode ticks at
  per-row positions, with the int8 cache off and on, at 1e-5, through the
  kernels' plain versions and through the reference's paths past a small
  ``attn_chunk``;
- the engine's greedy tokens equal to the reference ``Engine``'s
  (``kv_kernel="xla"``) with and without ``kv_quant``; the int8 pool keeps
  the cross cache dense; a request without ``enc_embeds`` is refused.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import test_torch_serve as SV
from test_torch_harness import CPU, to_torch

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.kernels.quant_decode import (  # noqa: E402
    quantize_kv as ref_quantize_kv)
from repro.models import decode as ref_decode  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro.serve import Engine as RefEngine  # noqa: E402
from repro.serve import LoadSpec as RefLoadSpec  # noqa: E402
from repro.serve import generate_requests as ref_generate  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.models import decode, model  # noqa: E402
from repro_torch.serve import Engine, LoadSpec, generate_requests  # noqa: E402

ARCH = "whisper-tiny"
RTOL = SV.MODEL_RTOL
FRAMES, TOKENS = 64, 16
# a chunk small enough that the reference's chunked attention runs at
# FRAMES frames and TOKENS tokens (both multiples of it)
SMALL_CHUNK = 8
MAX_LEN = 24


def _cfgs(**kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(ref_get_arch(ARCH), **kw),
            dataclasses.replace(get_arch(ARCH), **kw))


@functools.lru_cache(maxsize=None)
def _full(seed=0):
    """Full-width f32 whisper-tiny: both configs, the reference's params
    and the port's copy of them."""
    cfg_ref, cfg = _cfgs()
    tree = ref_init_params(ref_model.model_specs(cfg_ref),
                           jax.random.PRNGKey(seed), "float32")
    return cfg_ref, cfg, tree, interop.serve_params_from_reference(
        cfg, jax.tree.map(np.asarray, tree), CPU)


def _batch(cfg, rng, b, s, frames):
    return {"tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32),
            "enc_embeds": rng.standard_normal(
                (b, frames, cfg.d_model)).astype(np.float32)}


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda t: hasattr(t, "axes"))[0]}


# ------------------------------------------------------------ configs

def test_config_matches_reference_field_for_field():
    assert (dataclasses.asdict(get_arch(ARCH))
            == dataclasses.asdict(ref_get_arch(ARCH)))
    for kw in ({}, {"dtype": "float32"}, {"n_layers": 3}):
        got = reduced(get_arch(ARCH), **kw)
        assert (dataclasses.asdict(got)
                == dataclasses.asdict(ref_reduced(ref_get_arch(ARCH), **kw)))
        assert got.encoder.n_layers == 2


def test_model_specs_match_reference_leaf_for_leaf():
    for cfg_ref, cfg in (_cfgs(dtype="bfloat16"),
                         (ref_reduced(ref_get_arch(ARCH)),
                          reduced(get_arch(ARCH)))):
        want = _flat(ref_model.model_specs(cfg_ref))
        got = _flat(model.model_specs(cfg))
        assert sorted(got) == sorted(want)
        assert {"x/encoder/ln_out", "x/encoder/layers/wq",
                "x/layers/cwq", "x/layers/cln_attn"} <= set(got)
        for name, spec in got.items():
            w = want[name]
            assert (spec.shape, spec.axes, spec.init, spec.scale,
                    spec.dtype) == (w.shape, w.axes, w.init, w.scale,
                                    w.dtype), name


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_params_carry_into_the_port(dtype):
    """Every leaf of the reference's full-width params, the encoder's and
    the cross-attention's included, bit for bit."""
    cfg_ref, cfg = _cfgs(dtype=dtype)
    tree = ref_init_params(ref_model.model_specs(cfg_ref),
                           jax.random.PRNGKey(1), dtype)
    got = interop.serve_params_from_reference(
        cfg, jax.tree.map(np.asarray, tree), CPU)
    flat = dict(interop._named(got))
    want = _flat(tree)
    assert sorted(flat) == sorted(want)
    assert len([k for k in flat if k.startswith("x/encoder/")]) == 10
    for name, t in flat.items():
        w = np.asarray(want[name])
        assert tuple(t.shape) == w.shape, name
        assert str(t.dtype).removeprefix("torch.") == w.dtype.name, name
        np.testing.assert_array_equal(t.float().numpy(),
                                      w.astype(np.float32), err_msg=name)


def test_cache_spec_keeps_the_reference_argument_order():
    """Positional (batch, max_len, window, enc_len) as the reference's; the
    cross cache stays in the model dtype under ``quant``."""
    cfg_ref, cfg = _cfgs()
    for quant in (False, True):
        want = ref_decode.cache_spec(cfg_ref, 3, 24, None, 40,
                                     jnp.float32, quant)[0]
        got = decode.cache_spec(cfg, 3, 24, None, 40, torch.float32,
                                quant)[0]
        assert sorted(got) == sorted(want)
        for key, spec in got.items():
            assert tuple(spec.shape) == want[key].shape, key
            assert (str(spec.dtype).removeprefix("torch.")
                    == want[key].dtype.name), key
        assert got["ck"].dtype == torch.float32
        assert got["ck"].shape == (4, 3, 40, 6, 64)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("chunk", [1024, SMALL_CHUNK])
def test_encoder_features_and_forward_match_reference(chunk):
    """Full width, f32, FRAMES frames and TOKENS tokens: the encoder's
    output, the features and the logits at 1e-5; at SMALL_CHUNK every
    attention (the encoder's, the decoder's self- and cross-attention)
    takes the chunked ``attend_flash`` in both packages."""
    cfg_ref, cfg, tree, params = _full()
    batch = _batch(cfg, np.random.default_rng(0), 2, TOKENS, FRAMES)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rctx = ref_model.ModelCtx(attn_chunk=chunk)
    ctx = model.ModelCtx(attn_chunk=chunk)
    enc_r = jax.jit(lambda x, e: ref_model.encoder_forward(
        cfg_ref, x, e, rctx))(tree["x"], jb["enc_embeds"])
    enc = model.encoder_forward(cfg, params["x"],
                                to_torch(batch["enc_embeds"]), ctx)
    SV._close(enc, enc_r, RTOL, "encoder_forward")
    want = jax.jit(lambda p, b: ref_model.forward(cfg_ref, p, b, rctx))(
        tree, jb)
    feats = model.features(cfg, params["x"], to_torch(batch), ctx)
    got = model.head_logits(cfg, params["y"], feats)
    SV._close(got, want, RTOL, "forward")
    torch.testing.assert_close(
        got, model.forward(cfg, params, to_torch(batch), ctx), rtol=0,
        atol=0)
    # the serving forward (no remat) gives the training one's values
    direct = model.forward(cfg, params, to_torch(batch),
                           model.ModelCtx(kind="prefill", attn_chunk=chunk))
    torch.testing.assert_close(direct, got, rtol=0, atol=0)


def _ref_prefill_decode(cfg_ref, tree, batch, w, quant, chunk, steps):
    """The reference's prefill, then its decode ticks at ``steps`` from the
    prefill's cache (quantized by the reference's ``quantize_kv`` with
    ``quant``). Returns (prefill logits, the prefill's cache, the cache
    the ticks start from, [(logits, cache) of each tick])."""
    rctx = ref_model.ModelCtx(kind="prefill", attn_chunk=chunk)
    dctx = ref_model.ModelCtx(kind="decode", kv_kernel="xla")
    cache = ref_decode.init_cache(cfg_ref, batch["tokens"].shape[0], w,
                                  enc_len=batch["enc_embeds"].shape[1],
                                  dtype=jnp.float32)
    lg, cache = jax.jit(lambda p, b, c: ref_decode.prefill(
        cfg_ref, p, b, c, rctx))(tree, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, cache)
    start = dict(cache)
    if quant:
        start["k"], start["k_scale"] = ref_quantize_kv(cache["k"])
        start["v"], start["v_scale"] = ref_quantize_kv(cache["v"])
    step = jax.jit(lambda p, c, t, pos: ref_decode.decode_step(
        cfg_ref, p, c, t, pos, dctx))
    ticks, c = [], start
    for token, pos in steps:
        out, c = step(tree, c, jnp.asarray(token), jnp.asarray(pos))
        ticks.append((out, c))
    return lg, cache, start, ticks


@pytest.mark.parametrize("attn,chunk,kv_quant", [
    ("kernel", 1024, False), ("kernel", 1024, True),
    ("reference", 1024, False), ("reference", 1024, True),
    ("reference", SMALL_CHUNK, False)])
def test_prefill_and_decode_match_reference(attn, chunk, kv_quant):
    """Full width, f32: prefill (logits, k, v, ck, cv) of 11 tokens over
    FRAMES frames, then 4 decode ticks at a scalar and at per-row
    positions (logits and every cache leaf; int8 levels exactly), at 1e-5.
    "kernel" runs the kernels' plain versions on the CPU; "reference" the
    reference's paths (the int8 cache dequantized, then ``attend_decode``),
    and at SMALL_CHUNK the prefill's encoder and cross-attention take
    ``attend_flash``. A tick attends over its cache whatever the chunk.
    With ``kv_quant`` both start from the reference's quantized prefill
    cache."""
    cfg_ref, cfg, tree, params = _full()
    rng = np.random.default_rng(1)
    b, s, w = 2, 11, 16
    batch = _batch(cfg, rng, b, s, FRAMES)
    steps = [(rng.integers(0, cfg.vocab, (b, 1), dtype=np.int32), pos)
             for pos in (np.int32(s), np.array([s + 1, 8], np.int32),
                         np.array([s + 2, 9], np.int32),
                         np.array([s + 3, w - 1], np.int32))]
    lg_r, cache_r, start, ticks = _ref_prefill_decode(
        cfg_ref, tree, batch, w, kv_quant, chunk, steps)
    cache = decode.init_cache(cfg, b, w, enc_len=FRAMES, dtype=torch.float32,
                              device=CPU)
    lg, cache = decode.prefill(cfg, params, to_torch(batch), cache,
                               model.ModelCtx(kind="prefill", attn=attn,
                                              attn_chunk=chunk))
    SV._close(lg, lg_r, RTOL, "prefill logits")
    for key in ("k", "v", "ck", "cv"):
        SV._close(cache[key], cache_r[key], RTOL, f"prefill {key}")
    full = model.forward(cfg, params, to_torch(batch), model.ModelCtx())
    torch.testing.assert_close(lg[:, 0], full[:, -1], rtol=RTOL, atol=RTOL)
    if kv_quant:
        cache = {k: to_torch(a) for k, a in start.items()}
    for i, ((token, pos), (lg_r, cache_r)) in enumerate(zip(steps, ticks)):
        lg, cache = decode.decode_step(
            cfg, params, cache, torch.from_numpy(token),
            torch.from_numpy(np.asarray(pos)),
            model.ModelCtx(kind="decode", attn=attn))
        SV._close(lg, lg_r, RTOL, f"decode {i} logits")
        assert sorted(cache) == sorted(cache_r)
        for key in cache_r:
            if cache[key].dtype == torch.int8:
                np.testing.assert_array_equal(
                    cache[key].numpy(), np.asarray(cache_r[key]),
                    err_msg=f"decode {i} {key}")
            else:
                SV._close(cache[key], cache_r[key], RTOL,
                          f"decode {i} {key}")
        assert cache["ck"].dtype == torch.float32


# ------------------------------------------------------------ the engine

def _workload(cfg, n=5, seed=3):
    spec = dict(n_requests=n, prompt_lens=(4, 7), mean_new_tokens=4.0,
                max_new_cap=6, seed=seed)
    enc = (MAX_LEN, cfg.d_model)
    return (generate_requests(LoadSpec(**spec), cfg.vocab, enc_shape=enc),
            ref_generate(RefLoadSpec(**spec), cfg.vocab, enc_shape=enc))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_tokens_match_reference_engine(kv_quant):
    """Full-width f32 whisper-tiny through the port's engine ("auto": the
    plain kernels on the CPU) and the reference's (``kv_kernel="xla"``),
    each request with its MAX_LEN frames from the load generator: the
    same greedy tokens, finish reasons and ticks."""
    cfg_ref, cfg, tree, params = _full()
    reqs, reqs_r = _workload(cfg)
    assert all(r.enc_embeds.shape == (MAX_LEN, cfg.d_model) for r in reqs)
    for a, b in zip(reqs, reqs_r):
        np.testing.assert_array_equal(a.enc_embeds, b.enc_embeds)
    want = RefEngine(cfg_ref, tree, slots=3, max_len=MAX_LEN,
                     kv_quant=kv_quant, kv_kernel="xla").run(reqs_r)
    got = Engine(cfg, params, slots=3, max_len=MAX_LEN, kv_quant=kv_quant,
                 device="cpu").run(reqs)
    assert SV._tokens(got) == SV._tokens(want)
    assert ({c.rid: (c.finish_reason, c.decode_ticks) for c in got}
            == {c.rid: (c.finish_reason, c.decode_ticks) for c in want})


def test_int8_pool_keeps_the_cross_cache_dense():
    """An admission into the int8 pool: k/v quantized per (token, head)
    as the reference's ``quantize_kv`` gives them, ck/cv in the cache's
    dtype (bf16, the serve cache's as the reference's), equal to the
    prefill row's bit for bit."""
    cfg_ref, cfg = (ref_reduced(ref_get_arch(ARCH), dtype="float32"),
                    reduced(get_arch(ARCH), dtype="float32"))
    tree, params = SV._params(cfg_ref, cfg)
    reqs, _ = _workload(cfg, n=1)
    eng = Engine(cfg, params, slots=2, max_len=MAX_LEN, kv_quant=True,
                 device="cpu")
    rows = []
    real = eng._prefill

    def keep(*a):
        logits, row = real(*a)
        rows.append({k: v.clone() for k, v in row.items()})
        return logits, row
    eng._prefill = keep
    eng.submit(reqs[0])
    eng.step()
    pool, row = eng._pool, rows[0]
    assert pool["k"].dtype == torch.int8
    assert pool["ck"].dtype == row["ck"].dtype == torch.bfloat16
    assert pool["ck"].shape == (cfg.n_layers, 2, MAX_LEN, cfg.n_kv_heads,
                                cfg.resolved_head_dim)
    for key in ("ck", "cv"):
        assert torch.equal(pool[key][:, 0], row[key][:, 0])
        assert not pool[key][:, 1].any()
    k8, ks = ref_quantize_kv(jnp.asarray(row["k"][:, 0].float().numpy()
                                         ).astype(jnp.bfloat16))
    plen = len(reqs[0].tokens)
    np.testing.assert_array_equal(pool["k"][:, 0, :plen].numpy(),
                                  np.asarray(k8)[:, :plen])
    np.testing.assert_array_equal(pool["k_scale"][:, 0, :plen].numpy(),
                                  np.asarray(ks)[:, :plen])


def test_request_without_enc_embeds_is_refused():
    cfg = reduced(get_arch(ARCH), dtype="float32")
    _, params = SV._params(ref_reduced(ref_get_arch(ARCH), dtype="float32"),
                           cfg)
    reqs, _ = _workload(cfg, n=1)
    reqs[0].enc_embeds = None
    eng = Engine(cfg, params, slots=2, max_len=MAX_LEN, device="cpu")
    eng.submit(reqs[0])
    with pytest.raises(ValueError, match="request 0: encoder-decoder arch "
                                         "needs enc_embeds"):
        eng.step()
