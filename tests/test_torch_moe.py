"""The MoE layer and the four attention architectures of the MoE and vlm
slice against the JAX package, on the CPU.

- The configs: ``deepseek-67b``, ``internvl2-76b``, ``qwen3-moe-30b-a3b``
  and ``llama4-scout-17b-a16e`` equal the reference's field for field,
  plain and ``reduced``.
- ``apply_moe`` (``models/moe.py``) against the reference's in f32 at 1e-5,
  at reduced qwen3-moe (4 experts, top 2) and reduced llama4-scout (top 1
  with the shared FFN): random routing, a router tilted so that one expert
  passes its capacity (dropped pairs), and tied router logits (ties go to
  the lower expert index, as ``jax.lax.top_k`` breaks them); in bf16
  beside an f32 witness; ``aux_load_balance_loss``.
- A moe layer under ``models/remat.py`` against the direct layer, values
  and gradients bit for bit.
- The reference's moe params (``[L, E, d, f]`` expert leaves) carried into
  the port.

The serve paths of the four are in ``test_torch_moe_serve.py``; the LM
problem and the trainer in ``test_torch_lm_moe.py`` and
``test_torch_lm_vlm.py``.
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
from repro.models import model as ref_model  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_arch, list_arch_ids, reduced  # noqa: E402
from repro_torch.core.bilevel import softmax_xent  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.models import model, moe  # noqa: E402

NEW = ("deepseek-67b", "internvl2-76b", "qwen3-moe-30b-a3b",
       "llama4-scout-17b-a16e")
MOE = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e")
RTOL = 1e-5
# bf16 against an f32 witness (test_torch_lm_ssm.py's rule): the port's
# normwise distance from the reference's f32 run on the bf16 inputs
# widened at most WITNESS times the reference's bf16 run's, plus MARGIN
WITNESS, MARGIN = 2.0, 1e-3
S = 9                      # tokens a row: capacity max(int(9 k 1.25 / 4), 4)


def _cfgs(arch_id, dtype="float32"):
    return (ref_reduced(ref_get_arch(arch_id), dtype=dtype),
            reduced(get_arch(arch_id), dtype=dtype))


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch_id", NEW)
def test_configs_match_reference_field_for_field(arch_id):
    assert arch_id in list_arch_ids()
    cfg = get_arch(arch_id)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref_get_arch(arch_id))
    for kw in ({}, {"dtype": "float32"}, {"n_kv_heads": 2}):
        assert (dataclasses.asdict(reduced(cfg, **kw))
                == dataclasses.asdict(ref_reduced(ref_get_arch(arch_id),
                                                  **kw)))
    model.check_family(cfg)
    assert sorted(model.model_specs(reduced(cfg))["x"]["layers"]) == sorted(
        ref_model.model_specs(ref_reduced(ref_get_arch(arch_id)))["x"][
            "layers"])


# ------------------------------------------------------------ the layer

def _layer(arch_id, case, dtype="float32", seed=0):
    """One layer's params of both packages (the reference's first layer,
    carried across) and a batch x [2, S, d], shaped for ``case``:
    "random"; "dropped" (every token's first choice is expert 0, so
    2 S pairs queue for its 4 or 5 slots); "tied" (router columns 1 and 3
    copy 0 and 2, so each row's logits tie in pairs); "zero" (a zero
    router: every logit ties)."""
    cfg_r, cfg = _cfgs(arch_id, dtype)
    tree = ref_init_params(ref_model.model_specs(cfg_r),
                           jax.random.PRNGKey(seed), "float32")
    lp = {k: np.array(v[0]) for k, v in tree["x"]["layers"].items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    r = lp["router"]
    if case == "dropped":
        u = np.full(cfg.d_model, cfg.d_model ** -0.5, np.float32)
        x = x + 4.0 * u
        r[:, 0] += u
    elif case == "tied":
        r[:, 1], r[:, 3] = r[:, 0], r[:, 2]
    elif case == "zero":
        r[:] = 0.0
    lp = {k: np.asarray(jnp.asarray(v).astype(dtype)) for k, v in lp.items()}
    x = np.asarray(jnp.asarray(x).astype(dtype))
    return cfg_r, cfg, lp, x


def _port_route(cfg, lp, x):
    logits, gates, eids = moe.route(cfg, lp["router"], x)
    slot, keep = moe.slots(eids, cfg.moe.n_experts, moe.capacity(cfg, S))
    return logits, eids, keep


@pytest.mark.parametrize("case", ["random", "dropped", "tied", "zero"])
@pytest.mark.parametrize("arch_id", MOE)
def test_apply_moe_matches_reference(arch_id, case):
    """f32 at 1e-5; the port's own routing shows what the case is for:
    pairs dropped past capacity, logits that tie, ties given to the lower
    expert index (the reference's top_k order)."""
    cfg_r, cfg, lp, x = _layer(arch_id, case)
    want = ref_moe.apply_moe(cfg_r, jax.tree.map(jnp.asarray, lp),
                             jnp.asarray(x))
    tp, tx = to_torch(lp), torch.from_numpy(x.copy())
    got = moe.apply_moe(cfg, tp, tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)
    logits, eids, keep = _port_route(cfg, tp, tx)
    k = cfg.moe.top_k
    _, ref_eids = jax.lax.top_k(jnp.asarray(logits.numpy()), k)
    np.testing.assert_array_equal(eids.numpy(), np.asarray(ref_eids))
    if case == "dropped":
        assert 0 < int(keep.sum()) < keep.numel(), keep
    if case == "tied":
        assert torch.equal(logits[..., 0], logits[..., 1])
        assert torch.equal(logits[..., 2], logits[..., 3])
    if case == "zero":
        assert torch.equal(eids, torch.arange(k).expand_as(eids))


@pytest.mark.parametrize("arch_id", MOE)
def test_apply_moe_bf16_beside_an_f32_witness(arch_id):
    """bf16 against the reference's f32 run on the bf16 inputs widened: the
    port no farther from it than WITNESS times the reference's bf16 run,
    plus MARGIN."""
    cfg_r, cfg, lp, x = _layer(arch_id, "random", "bfloat16")
    cfg_w = dataclasses.replace(cfg_r, dtype="float32")
    widen = {k: jnp.asarray(v, jnp.float32) for k, v in lp.items()}
    wit = np.asarray(ref_moe.apply_moe(cfg_w, widen, jnp.asarray(
        x, jnp.float32)), np.float64)
    want = np.asarray(ref_moe.apply_moe(
        cfg_r, {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in
                lp.items()}, jnp.asarray(x).astype(jnp.bfloat16)),
        np.float64)
    got = moe.apply_moe(cfg, to_torch({k: np.asarray(jnp.asarray(v).astype(
        jnp.bfloat16)) for k, v in lp.items()}), to_torch(
        np.asarray(jnp.asarray(x).astype(jnp.bfloat16))))
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()

    def dist(a):
        return np.linalg.norm(a - wit) / np.linalg.norm(wit)
    assert dist(got) <= WITNESS * dist(want) + MARGIN, (dist(got),
                                                        dist(want))


@pytest.mark.parametrize("arch_id", MOE)
def test_aux_load_balance_loss_matches_reference(arch_id):
    cfg_r, cfg, lp, x = _layer(arch_id, "random")
    logits = np.asarray(jnp.asarray(x[0]) @ jnp.asarray(lp["router"]))
    _, eids = jax.lax.top_k(jnp.asarray(logits), cfg.moe.top_k)
    want = ref_moe.aux_load_balance_loss(jnp.asarray(logits), eids,
                                         cfg.moe.n_experts)
    got = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                    torch.from_numpy(np.asarray(eids)).long(),
                                    cfg.moe.n_experts)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


# ------------------------------------------------------------ remat

@pytest.mark.parametrize("arch_id", MOE)
def test_moe_layer_under_remat_equals_the_direct_layer(arch_id):
    """The training forward (every layer under ``remat_layer``) against the
    same layers called directly: the features and the gradients of the LM
    loss in every layer leaf and the head, bit for bit, also under
    ``vmap`` over two batches (the Neumann features' transform)."""
    _, cfg = _cfgs(arch_id)
    from repro_torch.models.params import init_params
    params = init_params(model.model_specs(cfg),
                         torch.Generator().manual_seed(0), cfg.dtype, CPU)
    tokens = torch.randint(0, cfg.vocab, (2, 2, 17),
                           generator=torch.Generator().manual_seed(1))
    ctx = model.ModelCtx(kind="train")

    def loss(xp, yp, toks):
        feats = model.features(cfg, xp, {"tokens": toks[:, :-1]}, ctx)
        return softmax_xent(model.head_logits(cfg, yp, feats),
                            toks[:, 1:]), feats

    def run():
        grad = torch.func.grad(loss, argnums=(0, 1), has_aux=True)
        (gx, gy), feats = grad(params["x"], params["y"], tokens[0])
        (vx, vy), vfeats = torch.func.vmap(grad, in_dims=(None, None, 0))(
            params["x"], params["y"], tokens)
        gx = {k: v for k, v in gx.items() if k != "embed"}
        vx = {k: v for k, v in vx.items() if k != "embed"}
        return [feats, vfeats] + tree_leaves((gx, gy, vx, vy))

    real, calls = model.remat_layer, []

    def counted(body, h, p):
        calls.append(1)
        return real(body, h, p)
    model.remat_layer = counted
    try:
        remat = run()
        model.remat_layer = lambda body, h, p: body(h, p)
        direct = run()
    finally:
        model.remat_layer = real
    assert len(calls) == 2 * cfg.n_layers
    assert len(remat) == len(direct)
    for i, (a, b) in enumerate(zip(remat, direct)):
        assert torch.equal(a, b), i


# ------------------------------------------------------------ weights

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch_id", MOE)
def test_reference_moe_params_carry_into_the_port(arch_id, dtype):
    cfg_r, cfg = _cfgs(arch_id, dtype)
    tree = ref_init_params(ref_model.model_specs(cfg_r),
                           jax.random.PRNGKey(1), dtype)
    got = interop.serve_params_from_reference(
        cfg, jax.tree.map(np.asarray, tree), CPU)
    e = cfg.moe
    assert tuple(got["x"]["layers"]["we_gate"].shape) == (
        cfg.n_layers, e.n_experts, cfg.d_model, e.d_ff_expert)
    assert ("ws_down" in got["x"]["layers"]) == bool(e.d_ff_shared)
    flat = dict(interop._named(got))
    flat_ref = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    tree)[0]}
    assert sorted(flat) == sorted(flat_ref)
    for name, t in flat.items():
        want = np.asarray(flat_ref[name])
        assert tuple(t.shape) == want.shape, name
        np.testing.assert_array_equal(t.float().numpy(),
                                      want.astype(np.float32), err_msg=name)
