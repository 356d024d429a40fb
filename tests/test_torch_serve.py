"""The port's serve path against the JAX package's, on the CPU.

- The configs: ``reduced`` gives the reference's config field for field.
- The weights: the reference's ``init_params(model_specs(cfg))`` carries
  into the port with the same keys, shapes and dtypes, bit for bit.
- The kernels' plain versions against ``repro.kernels.ref`` (MHA, GQA,
  MQA, causal and not, windowed, ragged lengths; 1e-6 in f32, 2e-2 in
  bf16, the reference's own kernel tolerances) and, for the int8 decode at
  a ``[B]`` position, against the reference's dequant path; ``quantize_kv``
  level for level.
- The models: ``prefill``/``decode_step`` logits and caches, and the whole
  sequence ``forward``, at 1e-5 on f32 configs of the three dense shapes
  (MHA with bias, MQA, GQA), with the int8 cache off and on.
- The engine: the same greedy tokens as the reference ``Engine`` on its
  own test workload (``tests/test_serve_engine.py``); the load generator's
  requests equal the reference's; the CLI's README flag table matches its
  argparse.

The scheduler's own properties (one request at a time, EOS, capacity,
rejections, slot lifecycle) are in ``tests/test_torch_serve_engine.py``.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_harness import CPU, to_torch

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import list_arch_ids as ref_list_arch_ids  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.kernels.quant_decode import (  # noqa: E402
    quantize_kv as ref_quantize_kv)
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import decode as ref_decode  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro.serve import Engine as RefEngine  # noqa: E402
from repro.serve import LoadSpec as RefLoadSpec  # noqa: E402
from repro.serve import generate_requests as ref_generate  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ShapeConfig, get_arch, list_arch_ids, reduced)
from repro_torch.kernels import flash_attention as fkern  # noqa: E402
from repro_torch.kernels import quant_decode as qkern  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import decode, model  # noqa: E402
from repro_torch.serve import Engine, LoadSpec, generate_requests  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DENSE = ("qwen1.5-4b", "granite-20b", "qwen2.5-14b")
MODEL_RTOL = 1e-5          # the reference's engine tolerance
MAX_LEN = 24


def _tol(dtype):
    """The reference's kernel tolerances (tests/test_kernels.py:45)."""
    return 2e-2 if dtype == "bfloat16" else 1e-6


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32),
        rtol=tol, atol=tol, err_msg=what)


def _small(arch_id, **kw):
    """The reduced configs of both packages, f32 unless ``dtype`` is given.
    qwen2.5-14b keeps GQA at n_kv_heads=2 (plain ``reduced`` makes it
    MHA)."""
    kw.setdefault("dtype", "float32")
    if arch_id == "qwen2.5-14b":
        kw.setdefault("n_kv_heads", 2)
    return (ref_reduced(ref_get_arch(arch_id), **kw),
            reduced(get_arch(arch_id), **kw))


def _params(cfg_ref, cfg, seed=0):
    tree = ref_init_params(ref_model.model_specs(cfg_ref),
                           jax.random.PRNGKey(seed), cfg_ref.dtype)
    # the init leaves biases at zero: give them values, so that the bias
    # paths are exercised
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in tree["x"]["layers"]:
            leaf = tree["x"]["layers"][name]
            tree["x"]["layers"][name] = jnp.asarray(
                rng.standard_normal(leaf.shape).astype(np.float32) * 0.1)
    return tree, interop.serve_params_from_reference(
        cfg, jax.tree.map(np.asarray, tree), CPU)


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch_id", DENSE)
def test_configs_match_reference_field_for_field(arch_id):
    assert arch_id in list_arch_ids()
    assert (dataclasses.asdict(get_arch(arch_id))
            == dataclasses.asdict(ref_get_arch(arch_id)))
    for kw in ({}, {"dtype": "float32"}, {"n_kv_heads": 2}):
        assert (dataclasses.asdict(reduced(get_arch(arch_id), **kw))
                == dataclasses.asdict(ref_reduced(ref_get_arch(arch_id),
                                                  **kw)))


def test_every_reference_arch_and_family_is_ported():
    """The registry is the reference's, in its order; every family of its
    architectures is one the model runs; an unknown family raises."""
    assert list_arch_ids() == ref_list_arch_ids()
    for arch_id in ref_list_arch_ids():
        assert ref_get_arch(arch_id).family in model.PORTED_FAMILIES
    cfg = dataclasses.replace(get_arch("qwen1.5-4b"), family="rnn")
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        model.model_specs(cfg)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("whisper-base")


# ------------------------------------------------------------ weights

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch_id", DENSE)
def test_reference_params_carry_into_the_port(arch_id, dtype):
    cfg_ref, cfg = _small(arch_id, dtype=dtype)
    tree = ref_init_params(ref_model.model_specs(cfg_ref),
                           jax.random.PRNGKey(1), dtype)
    got = interop.serve_params_from_reference(
        cfg, jax.tree.map(np.asarray, tree), CPU)
    specs = model.model_specs(cfg)
    assert sorted(got) == sorted(specs) == ["x", "y"]
    for part in ("x", "y"):
        flat_ref = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                    for path, leaf in jax.tree_util.tree_flatten_with_path(
                        tree[part])[0]}
        flat = dict(interop._named(got[part]))
        assert sorted(flat) == sorted(flat_ref)
        for name, t in flat.items():
            want = np.asarray(flat_ref[name])
            assert tuple(t.shape) == want.shape, name
            assert str(t.dtype).removeprefix("torch.") == want.dtype.name
            np.testing.assert_array_equal(t.float().numpy(),
                                          want.astype(np.float32))


def test_params_mismatch_names_the_leaf():
    cfg_ref, cfg = _small("qwen1.5-4b")
    tree = jax.tree.map(np.asarray, ref_init_params(
        ref_model.model_specs(cfg_ref), jax.random.PRNGKey(0), "float32"))
    wider = dataclasses.replace(cfg, d_ff=cfg.d_ff * 2)
    with pytest.raises(ValueError, match="leaf x/layers/wd"):
        interop.serve_params_from_reference(wider, tree, CPU)
    with pytest.raises(ValueError, match="leaf x/embed: reference has"):
        interop.serve_params_from_reference(
            dataclasses.replace(cfg, dtype="bfloat16"), tree, CPU)


# ------------------------------------------------ kernels' plain versions

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (False, 48)])
@pytest.mark.parametrize("b,h,kv,s,d", [
    (1, 4, 4, 128, 64),      # MHA
    (2, 4, 2, 200, 64),      # GQA, Sq not a multiple of 128
    (1, 8, 1, 256, 128),     # MQA
])
def test_flash_plain_matches_reference_oracle(b, h, kv, s, d, causal, window,
                                              dtype):
    rng = np.random.default_rng(b * 1000 + h * 100 + s)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    jdt = jnp.dtype(dtype)
    want = ref_ref.flash_attention_ref(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal,
        window=window)
    tq, tk, tv = (to_torch(jnp.asarray(a).astype(jdt)) for a in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype
    _close(got, want.astype(jnp.float32), _tol(dtype))
    # the wrapper on CPU tensors is the plain version, also through the
    # [B, S, H, D] layout the prefill hands it (strided views)
    before = dict(fkern.launches)
    got_v = fkern.flash_attention(
        *(t.transpose(1, 2).contiguous().transpose(1, 2)
          for t in (tq, tk, tv)), causal=causal, window=window)
    assert fkern.launches == before
    torch.testing.assert_close(got_v, got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,d,pos", [
    (1, 4, 4, 256, 64, 249), (2, 8, 2, 100, 64, 1), (2, 8, 1, 130, 128, 130)])
def test_quant_decode_plain_matches_reference_oracle(b, h, kv, s, d, pos,
                                                     dtype):
    """At a scalar position (the only one the JAX oracle takes)."""
    rng = np.random.default_rng(s + pos)
    jdt = jnp.dtype(dtype)
    q = jnp.asarray(rng.standard_normal((b, h, d)).astype(np.float32)
                    ).astype(jdt)
    k8, ks = ref_quantize_kv(jnp.asarray(
        rng.standard_normal((b, kv, s, d)).astype(np.float32)))
    v8, vs = ref_quantize_kv(jnp.asarray(
        rng.standard_normal((b, kv, s, d)).astype(np.float32)))
    want = ref_ref.quant_decode_ref(q, k8, ks, v8, vs, pos)
    args = [to_torch(a) for a in (q, k8, ks, v8, vs)]
    got = ref.quant_decode_ref(*args, pos)
    assert got.dtype == args[0].dtype
    _close(got, want.astype(jnp.float32), _tol(dtype))
    before = dict(qkern.launches)
    torch.testing.assert_close(qkern.quant_decode_attention(*args, pos), got,
                               rtol=0, atol=0)
    assert qkern.launches == before


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2), (8, 1)])
def test_quant_decode_plain_per_row_positions_match_reference_xla_path(h, kv):
    """At a ``[B]`` position, against the reference's own int8 path there:
    dequantize, then ``attend_decode`` (models/decode.py:146-149), in f32,
    through the [B, W, KV, Dh] pool layout."""
    b, w, d = 4, 70, 64
    rng = np.random.default_rng(h * kv)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k8, ks = ref_quantize_kv(jnp.asarray(
        rng.standard_normal((b, w, kv, d)).astype(np.float32)))
    v8, vs = ref_quantize_kv(jnp.asarray(
        rng.standard_normal((b, w, kv, d)).astype(np.float32)))
    pos = np.array([1, 70, 33, 64], np.int32)
    kd = k8.astype(jnp.float32) * ks[..., None]
    vd = v8.astype(jnp.float32) * vs[..., None]
    want = ref_attn.attend_decode(jnp.asarray(q)[:, None], kd, vd,
                                  pos=jnp.asarray(pos))[:, 0]
    tk8, tks, tv8, tvs = (to_torch(a) for a in (k8, ks, v8, vs))
    got = ref.quant_decode_ref(torch.from_numpy(q), tk8.transpose(1, 2),
                               tks.transpose(1, 2), tv8.transpose(1, 2),
                               tvs.transpose(1, 2), torch.from_numpy(pos))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_levels_equal_reference(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 17, 4, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0                           # an all-zero row
    x[1] *= 1e-3
    x[2, :, :, ::7] *= 50.0
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    want_q, want_s = ref_quantize_kv(jx)
    got_q, got_s = qkern.quantize_kv(to_torch(jx))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-7,
                               atol=0)


# ------------------------------------------------ attention primitives

def test_rope_and_plain_attention_match_reference():
    rng = np.random.default_rng(3)
    b, s, h, kv, d = 2, 40, 4, 2, 64
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    pos = np.arange(s)
    _close(attn.rope(torch.from_numpy(q), torch.from_numpy(pos), 1e4),
           ref_attn.rope(jnp.asarray(q), jnp.asarray(pos), 1e4), 1e-6)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for window in (None, 9):
        _close(attn.attend_full(tq, tk, tv, window=window),
               ref_attn.attend_full(q, k, v, window=window), 1e-6)
        _close(attn.attend_flash(tq, tk, tv, window=window, chunk=8),
               ref_attn.attend_flash(q, k, v, window=window, chunk=8), 1e-6)
    for p in (17, np.array([40, 3], np.int32)):
        _close(attn.attend_decode(tq[:, :1], tk, tv, pos=torch.as_tensor(p)),
               ref_attn.attend_decode(q[:, :1], k, v, pos=p), 1e-6)


# ------------------------------------------------------------ models

def _ref_ctx(kind):
    return ref_model.ModelCtx(kind=kind, kv_kernel="xla")


@pytest.mark.parametrize("arch_id", DENSE)
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


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch_id", DENSE)
def test_prefill_and_decode_match_reference(arch_id, kv_quant):
    """Prefill (logits and cache), then three decode steps at a scalar and
    at per-row ``[B]`` positions (logits and every cache leaf), at 1e-5;
    with ``kv_quant`` both start from the reference's quantized prefill
    cache, and each decode quantizes its token's K/V on both sides. The
    port's prefill logits also equal the last position of its forward."""
    cfg_ref, cfg = _small(arch_id)
    tree, params = _params(cfg_ref, cfg)
    rng = np.random.default_rng(1)
    b, s, w = 2, 7, 12
    tokens = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    cache_r = ref_decode.init_cache(cfg_ref, b, w, dtype=jnp.float32)
    lg_r, cache_r = ref_decode.prefill(cfg_ref, tree,
                                       {"tokens": jnp.asarray(tokens)},
                                       cache_r, _ref_ctx("prefill"))
    cache = decode.init_cache(cfg, b, w, dtype=torch.float32, device=CPU)
    lg, cache = decode.prefill(cfg, params,
                               {"tokens": torch.from_numpy(tokens)}, cache,
                               model.ModelCtx(kind="prefill"))
    _close(lg, lg_r, MODEL_RTOL, "prefill logits")
    for key in ("k", "v"):
        _close(cache[key], cache_r[key], MODEL_RTOL, f"prefill {key}")
    full = model.forward(cfg, params, {"tokens": torch.from_numpy(tokens)},
                         model.ModelCtx())
    torch.testing.assert_close(lg[:, 0], full[:, -1], rtol=MODEL_RTOL,
                               atol=MODEL_RTOL)
    if kv_quant:
        k8, ks = ref_quantize_kv(cache_r["k"])
        v8, vs = ref_quantize_kv(cache_r["v"])
        cache_r = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
        cache = {k: to_torch(a) for k, a in cache_r.items()}
    for step, pos in enumerate((np.int32(7), np.array([8, 5], np.int32),
                                np.array([9, 11], np.int32))):
        token = rng.integers(0, cfg.vocab, (b, 1), dtype=np.int32)
        lg_r, cache_r = ref_decode.decode_step(
            cfg_ref, tree, cache_r, jnp.asarray(token), jnp.asarray(pos),
            _ref_ctx("decode"))
        lg, cache = decode.decode_step(
            cfg, params, cache, torch.from_numpy(token),
            torch.from_numpy(np.asarray(pos)), model.ModelCtx(kind="decode"))
        _close(lg, lg_r, MODEL_RTOL, f"decode {step} logits")
        for key in cache_r:
            if cache[key].dtype == torch.int8:
                np.testing.assert_array_equal(
                    cache[key].numpy(), np.asarray(cache_r[key]),
                    err_msg=f"decode {step} {key}")
            else:
                _close(cache[key], cache_r[key], MODEL_RTOL,
                       f"decode {step} {key}")


# ------------------------------------------------------------ engine

def _workload(cfg, n=5, seed=3, max_new=6):
    spec = dict(n_requests=n, prompt_lens=(4, 7), mean_new_tokens=4.0,
                max_new_cap=max_new, seed=seed)
    return (generate_requests(LoadSpec(**spec), cfg.vocab),
            ref_generate(RefLoadSpec(**spec), cfg.vocab))


def _tokens(completions):
    return {c.rid: c.tokens for c in completions}


@pytest.mark.parametrize("arch_id,kv_quant", [
    ("qwen1.5-4b", False), ("qwen1.5-4b", True), ("granite-20b", True),
    ("qwen2.5-14b", True)])
def test_engine_tokens_match_reference_engine(arch_id, kv_quant):
    """The port's engine ("auto": the plain kernels on the CPU) serves the
    reference engine's tokens on the reference's own test workload, with
    the int8 pool against the reference's dequant path (``"xla"``)."""
    cfg_ref, cfg = _small(arch_id)
    tree, params = _params(cfg_ref, cfg)
    reqs, reqs_r = _workload(cfg)
    want = RefEngine(cfg_ref, tree, slots=3, max_len=MAX_LEN,
                     kv_quant=kv_quant, kv_kernel="xla").run(reqs_r)
    got = Engine(cfg, params, slots=3, max_len=MAX_LEN, kv_quant=kv_quant,
                 device="cpu").run(reqs)
    assert _tokens(got) == _tokens(want)
    assert ({c.rid: (c.finish_reason, c.decode_ticks) for c in got}
            == {c.rid: (c.finish_reason, c.decode_ticks) for c in want})


def test_engine_xla_path_serves_the_same_tokens():
    """On the CPU the reference's paths ("xla": ``attend_full`` prefill,
    the dequant decode) and the kernels' plain versions ("auto") serve the
    same tokens."""
    cfg_ref, cfg = _small("qwen1.5-4b")
    _, params = _params(cfg_ref, cfg)
    reqs, _ = _workload(cfg, n=4)
    runs = [_tokens(Engine(cfg, params, slots=3, max_len=MAX_LEN,
                           kv_quant=True, kv_kernel=kk,
                           device="cpu").run(reqs))
            for kk in ("auto", "xla")]
    assert runs[0] == runs[1]


# ------------------------------------------------------------ load generator

@pytest.mark.parametrize("rate,weights", [(0.0, None), (5.0, (1.0, 3.0))])
def test_generate_requests_equal_reference(rate, weights):
    kw = dict(n_requests=9, rate=rate, prompt_lens=(3, 8),
              prompt_weights=weights, mean_new_tokens=5.0, max_new_cap=7,
              seed=11)
    got = generate_requests(LoadSpec(**kw), 97, prefix_shape=(2, 5))
    want = ref_generate(RefLoadSpec(**kw), 97, prefix_shape=(2, 5))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.rid, g.max_new_tokens, g.arrival_s) == (
            w.rid, w.max_new_tokens, w.arrival_s)
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_array_equal(g.prefix_embeds, w.prefix_embeds)


# ------------------------------------------------ CLI and entry points

def _check_docs():
    spec = importlib.util.spec_from_file_location(
        "check_docs", ROOT / "scripts" / "check_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_cli_flag_table_matches_argparse():
    """The README's flag table of ``python -m repro_torch.launch.serve``
    and the launcher's argparse, in both directions (the reference's
    ``scripts/check_docs.py`` readers, applied to the port's CLI)."""
    docs = _check_docs()
    in_src = docs.source_flags(ROOT / "src/repro_torch/launch/serve.py")
    sections = docs.readme_sections(ROOT / "README.md")
    in_doc = sections["### `python -m repro_torch.launch.serve`"]
    assert in_src and in_src == in_doc, (sorted(in_src - in_doc),
                                         sorted(in_doc - in_src))


def test_serve_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.launch import serve as cli
    cfg_ref, cfg = _small("qwen1.5-4b")
    _, params = _params(cfg_ref, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params, slots=1, max_len=12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--arch", "qwen1.5-4b", "--reduced", "--requests", "1"])


def test_unported_options_raise():
    from repro_torch.fed.serve import build_serve_fns
    from repro_torch.launch import serve as cli
    cfg_ref, cfg = _small("qwen1.5-4b")
    _, params = _params(cfg_ref, cfg)
    with pytest.raises(NotImplementedError, match="telemetry"):
        Engine(cfg, params, slots=1, max_len=12, telemetry=object(),
               device="cpu")
    with pytest.raises(NotImplementedError, match="sharding slice"):
        Engine(cfg, params, slots=1, max_len=12, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="sharding slice"):
        build_serve_fns(cfg, ShapeConfig("s", 12, 1, "decode"),
                        mesh=object())
    for flags, what in ((["--mesh", "local"], "sharding slice"),
                        (["--metrics-out", "m.jsonl"], "obs/ slice")):
        with pytest.raises(NotImplementedError, match=what):
            cli.main(["--arch", "qwen1.5-4b", "--reduced", *flags])
