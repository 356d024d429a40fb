"""The LM trainer on the encdec family against the JAX reference on the
CPU: reduced whisper-tiny (2 encoder and 2 decoder layers, d_model 256, 4
heads, vocab 512), every batch with the encoder's frame embeddings
(``enc_embeds``: L.SEQ frames a training sequence, a quarter as many
decoder tokens), through the tests of ``lm_family``: the LM problem's f, g
and gradients at one and two microbatches (the frames split with the
tokens); the trainer's init, a local step and a sync (the update kernels'
leaf table over the nested ``x["encoder"]`` tree); the eager run stage by
stage and free-running, eval, and the scan rounds equal to the eager
calls bit for bit; one population round; the train CLI's checkpoint
through both bridges, served by the serve CLI.

Also: the batch specs and the stub draws' shapes against the reference's;
the frames' dtype: both packages' batch specs carry them in bf16, which
the reference's f32 encoder refuses (its layer scan's carry turns f32),
while the port casts them to the model's dtype, so that an f32 trainer on
the bf16 stubs equals one on the stubs widened to f32 bit for bit
(ROADMAP section 3)."""
import dataclasses

import numpy as np
import pytest
import torch

import lm_family as LF
import test_torch_lm_train as L
from lm_family import (  # noqa: F401  (the tests this file runs)
    test_lm_problem_matches_reference,
    test_population_round_matches_reference,
    test_train_cli_checkpoint_is_served_and_read_by_both_bridges,
    test_trainer_eager_run_scan_rounds_and_eval,
    test_trainer_init_step_and_sync_match_reference)
from test_torch_harness import to_torch

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import FederatedLMData as RefData  # noqa: E402
from repro.data.synthetic import make_client_batch as ref_batch  # noqa: E402
from repro.fed import runtime as ref_rt  # noqa: E402
from repro_torch.core.tree_util import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,  # noqa: E402
                                        make_client_batch)
from repro_torch.fed import runtime  # noqa: E402

CASE = "whisper-tiny"
# the witness rule (test_trainer_stages_against_a_float64_witness): the
# port's distance from a float64 run of the stage at most this many times
# the reference's, with a floor for leaves the reference rounds to nothing
WITNESS_FACTOR = 2.0
WITNESS_FLOOR = 1e-6


@pytest.fixture(params=[CASE])
def case(request):
    return request.param


@pytest.fixture(params=[CASE])
def family_case(request):
    return request.param


def test_batch_specs_and_stub_draws_match_reference():
    """The step's inputs: decoder tokens at a quarter of the frames (at
    least 8), the frames' embeddings [m, b, S, d] in bf16 under every
    prefix (LL, UL, zeta_0, Neumann), as the reference's; the port's draws
    of them have those shapes and dtypes, and the stubs' scale (0.02)."""
    ref_tr, tr = LF.trainers(CASE)
    want, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, 1,
                                        ref_tr.fed)
    got = runtime.client_batch_specs(tr.cfg, tr.shape, tr.m, tr.fed)
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert got[k].shape == tuple(s.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == s.dtype.name, k
    assert got["tokens"].shape == (1, L.BATCH, 8)
    assert got["neumann_enc_embeds"].shape == (1, L.K, 1, 64, 256)
    ref = ref_batch(RefData(vocab=ref_tr.cfg.vocab, n_clients=1),
                    ref_tr.cfg, want, 0)
    port = make_client_batch(FederatedLMData(
        vocab=tr.cfg.vocab, n_clients=1, draws=TorchLMDraws(0, "cpu")),
        tr.cfg, got, 0, "cpu")
    for k in want:
        assert tuple(port[k].shape) == ref[k].shape, k
        assert str(port[k].dtype).removeprefix("torch.") == ref[k].dtype.name
        if k.endswith("enc_embeds"):
            for t in (port[k].float(), torch.from_numpy(np.asarray(
                    ref[k], np.float32))):
                assert 0.015 < float(t.std()) < 0.025, k


def test_bf16_frames_enter_an_f32_model_in_its_dtype():
    """The reference's f32 trainer refuses the bf16 frames its own batch
    specs give (TypeError from the encoder's layer scan); the port's init,
    local step and sync on them equal the port's on the same frames
    widened to f32, bit for bit."""
    ref_tr, tr = LF.trainers(CASE)
    specs, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, 1,
                                         ref_tr.fed)
    raw = jax.tree.map(np.asarray, ref_batch(
        RefData(vocab=ref_tr.cfg.vocab, n_clients=1), ref_tr.cfg, specs, 0))
    assert raw["enc_embeds"].dtype.name == "bfloat16"
    with pytest.raises(TypeError, match="carry"):
        jax.eval_shape(ref_tr.init_states, jax.random.PRNGKey(L.SEED),
                       jax.tree.map(jnp.asarray, raw))
    wide = LF.frames_in_f32(ref_tr.cfg, raw)
    _, (ps, _), draws = LF.init(CASE)
    params = {k: first_client(ps[k]) for k in ("x", "y")}
    runs = []
    for b in (raw, wide):
        states = tr.init_states(params, to_torch(b), draws.init)
        states = tr.local_step_fn()(*states, to_torch(b), draws.steps[0])
        runs.append(tree_leaves(tr.sync_step_fn()(*states)))
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def first_client(tree):
    """A client-stacked tree's first client: after the init, the params
    every client started from."""
    return {k: (first_client(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


def test_trainer_stages_against_a_float64_witness():
    """Each stage of the eager loop (4 local steps, the sync before step
    2), run from the reference's state before it by the reference, the
    port in f32 and the port in float64 (the witness; the plain update
    path): the port's every leaf no farther from the witness than
    WITNESS_FACTOR times the reference's (or WITNESS_FLOOR), the rule
    behind lm_family.ENCDEC_STAGE_REL."""
    _, tr = LF.trainers(CASE)
    fns = LF.ref_fns(CASE)
    (rs, rv), _, draws = LF.init(CASE)
    tr64 = runtime.FederatedTrainer(
        tr.cfg, dataclasses.replace(tr.fed, fused="off"), tr.shape,
        problem=tr.problem, device="cpu")

    def wide(tree):
        return tree_map(lambda a: a.double() if a.is_floating_point()
                        else a, to_torch(tree))

    for t, b in enumerate(LF.batches(CASE)):
        if t > 0 and t % L.Q == 0:
            rs, rv = fns["sync"](rs, rv)
        got = tr.local_step_fn()(to_torch(rs), to_torch(rv), to_torch(b),
                                 draws.steps[t])[0]
        wit = tr64.local_step_fn()(wide(rs), wide(rv), wide(b),
                                   draws.steps[t])[0]
        rs, rv = fns["local"](rs, rv, jax.tree.map(jnp.asarray, b), L.KEY)
        wit = tree_map(lambda a: a.numpy(), wit)
        port = L.rel_errs(got, wit)
        ref = L.rel_errs(tree_map(torch.from_numpy, jax.tree.map(
            lambda a: np.asarray(a, np.float32), rs)), wit)
        worst = max(p / max(r, WITNESS_FLOOR) for p, r in zip(port, ref))
        assert worst <= WITNESS_FACTOR, (t, worst, max(port), max(ref))
