"""The serve path of the MoE and vlm slice against the JAX package, on the
CPU: reduced f32 ``qwen3-moe-30b-a3b`` (4 experts, top 2),
``llama4-scout-17b-a16e`` (top 1 with the shared FFN, 8 prefix
embeddings), ``internvl2-76b`` (vlm, 8 prefix embeddings) and
``deepseek-67b`` (dense), each GQA at ``n_kv_heads=2``:

- the whole-sequence ``forward`` (the training forward, with the prefix
  embeddings where the arch takes them) at 1e-5;
- ``prefill`` (logits and cache) and three decode steps at a scalar and
  at per-row positions, with the int8 cache off and on, at 1e-5 (the
  dense family's limit, ``test_torch_serve.py``); a moe prefill routes
  the prompt at its own length, a decode step one token a row;
- the engine's greedy tokens equal to the reference ``Engine``'s on a
  workload whose prompts are longer than the prefix, each request with
  its own prefix embeddings from the load generator.
"""
import numpy as np
import pytest
import torch

import test_torch_serve as SV
from test_torch_harness import CPU, to_torch

import jax.numpy as jnp  # noqa: E402  (after the harness: it shims jax first)

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.kernels.quant_decode import (  # noqa: E402
    quantize_kv as ref_quantize_kv)
from repro.models import decode as ref_decode  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.serve import Engine as RefEngine  # noqa: E402
from repro.serve import LoadSpec as RefLoadSpec  # noqa: E402
from repro.serve import generate_requests as ref_generate  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.models import decode, model  # noqa: E402
from repro_torch.serve import Engine, LoadSpec, generate_requests  # noqa: E402

ARCHS = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e", "internvl2-76b",
         "deepseek-67b")
RTOL = SV.MODEL_RTOL
MAX_LEN = 24


def _small(arch_id):
    kw = dict(dtype="float32", n_kv_heads=2)
    return (ref_reduced(ref_get_arch(arch_id), **kw),
            reduced(get_arch(arch_id), **kw))


def _batch(cfg, rng, b, s):
    """Tokens [b, s] and, where the arch takes them, prefix embeddings
    [b, n_prefix, d], as numpy."""
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.standard_normal(
            (b, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_matches_reference(arch_id):
    cfg_ref, cfg = _small(arch_id)
    tree, params = SV._params(cfg_ref, cfg)
    batch = _batch(cfg, np.random.default_rng(0), 2, 13)
    want = ref_model.forward(cfg_ref, tree, {k: jnp.asarray(v) for k, v in
                                             batch.items()},
                             ref_model.ModelCtx())
    got = model.forward(cfg, params, to_torch(batch), model.ModelCtx())
    SV._close(got, want, RTOL)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_prefill_and_decode_match_reference(arch_id, kv_quant):
    """Prefill (logits and cache), then three decode steps at a scalar and
    at per-row ``[B]`` positions (logits and every cache leaf), at 1e-5;
    with ``kv_quant`` both start from the reference's quantized prefill
    cache. The port's prefill logits also equal the last position of its
    forward on the same batch."""
    cfg_ref, cfg = _small(arch_id)
    tree, params = SV._params(cfg_ref, cfg)
    rng = np.random.default_rng(1)
    b, s, w = 2, 11, 16
    batch = _batch(cfg, rng, b, s)
    cache_r = ref_decode.init_cache(cfg_ref, b, w, dtype=jnp.float32)
    lg_r, cache_r = ref_decode.prefill(
        cfg_ref, tree, {k: jnp.asarray(v) for k, v in batch.items()},
        cache_r, SV._ref_ctx("prefill"))
    cache = decode.init_cache(cfg, b, w, dtype=torch.float32, device=CPU)
    lg, cache = decode.prefill(cfg, params, to_torch(batch), cache,
                               model.ModelCtx(kind="prefill"))
    SV._close(lg, lg_r, RTOL, "prefill logits")
    for key in ("k", "v"):
        SV._close(cache[key], cache_r[key], RTOL, f"prefill {key}")
    full = model.forward(cfg, params, to_torch(batch), model.ModelCtx())
    torch.testing.assert_close(lg[:, 0], full[:, -1], rtol=RTOL, atol=RTOL)
    if kv_quant:
        k8, ks = ref_quantize_kv(cache_r["k"])
        v8, vs = ref_quantize_kv(cache_r["v"])
        cache_r = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
        cache = {k: to_torch(a) for k, a in cache_r.items()}
    for step, pos in enumerate((np.int32(s), np.array([s + 1, 8], np.int32),
                                np.array([s + 2, w - 1], np.int32))):
        token = rng.integers(0, cfg.vocab, (b, 1), dtype=np.int32)
        lg_r, cache_r = ref_decode.decode_step(
            cfg_ref, tree, cache_r, jnp.asarray(token), jnp.asarray(pos),
            SV._ref_ctx("decode"))
        lg, cache = decode.decode_step(
            cfg, params, cache, torch.from_numpy(token),
            torch.from_numpy(np.asarray(pos)), model.ModelCtx(kind="decode"))
        SV._close(lg, lg_r, RTOL, f"decode {step} logits")
        for key in cache_r:
            if cache[key].dtype == torch.int8:
                np.testing.assert_array_equal(
                    cache[key].numpy(), np.asarray(cache_r[key]),
                    err_msg=f"decode {step} {key}")
            else:
                SV._close(cache[key], cache_r[key], RTOL,
                          f"decode {step} {key}")


def _workload(cfg, n=5, seed=3, max_new=6):
    """The reference engine test's workload; prompts past the prefix
    (9 and 12 tokens) where the arch takes prefix embeddings."""
    lens = (9, 12) if cfg.n_prefix_embeds else (4, 7)
    spec = dict(n_requests=n, prompt_lens=lens, mean_new_tokens=4.0,
                max_new_cap=max_new, seed=seed)
    pre = ((cfg.n_prefix_embeds, cfg.d_model) if cfg.n_prefix_embeds
           else None)
    return (generate_requests(LoadSpec(**spec), cfg.vocab, prefix_shape=pre),
            ref_generate(RefLoadSpec(**spec), cfg.vocab, prefix_shape=pre))


@pytest.mark.parametrize("arch_id,kv_quant", [
    ("qwen3-moe-30b-a3b", False), ("qwen3-moe-30b-a3b", True),
    ("llama4-scout-17b-a16e", True), ("internvl2-76b", True),
    ("deepseek-67b", True)])
def test_engine_tokens_match_reference_engine(arch_id, kv_quant):
    """The port's engine ("auto": the plain kernels on the CPU) serves the
    reference engine's tokens, the int8 pool against the reference's
    dequant path ("xla")."""
    cfg_ref, cfg = _small(arch_id)
    tree, params = SV._params(cfg_ref, cfg)
    reqs, reqs_r = _workload(cfg)
    if cfg.n_prefix_embeds:
        assert all(r.prefix_embeds.shape == (cfg.n_prefix_embeds,
                                             cfg.d_model) for r in reqs)
    want = RefEngine(cfg_ref, tree, slots=3, max_len=MAX_LEN,
                     kv_quant=kv_quant, kv_kernel="xla").run(reqs_r)
    got = Engine(cfg, params, slots=3, max_len=MAX_LEN, kv_quant=kv_quant,
                 device="cpu").run(reqs)
    assert SV._tokens(got) == SV._tokens(want)
    assert ({c.rid: (c.finish_reason, c.decode_ticks) for c in got}
            == {c.rid: (c.finish_reason, c.decode_ticks) for c in want})
