"""``FederatedTrainer`` on the hybrid family against the JAX reference on
the CPU, at reduced zamba2-1.2b with 3 layers (a segment of 2 mamba2
layers, the shared block, then a tail layer with no shared block after it,
the reference's ``_hybrid_seq`` ``rem``): the trainer tests of
``lm_family`` (the init, a local step and a sync; the eager run stage by
stage and free-running, eval, the scan rounds against the eager calls).
Then the SSD repair on the trainer at 2 layers, the trainers' own chunk and
DEEP_SEED. The 2-layer trainer cases are in
``test_torch_lm_hybrid_train.py``."""
import numpy as np
import pytest
import torch

import lm_family as F
import test_torch_lm_train as L
from lm_family import (  # noqa: F401  (the tests this file runs)
    ssd_mask_first, test_trainer_eager_run_scan_rounds_and_eval,
    test_trainer_init_step_and_sync_match_reference)

import jax  # noqa: E402  (after the harness: it shims jax first)

from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402


@pytest.fixture(params=["zamba2-1.2b-3L"])
def case(request):
    return request.param


def test_ssd_repair_keeps_the_hybrid_trainer_finite(monkeypatch):
    """reduced zamba2-1.2b at the trainers' own chunk (256: the zeta_0 and
    Neumann sequences of 64 are one chunk each) and DEEP_SEED (depth K-1
    at init): the decays of the fast heads overflow f32 within the chunk.
    The reference's w is NaN after init (the fault), and so is its
    server's a. The port's states stay finite through the init, a local
    step and a sync, and match the witness, the reference with
    ``_ssd_chunk_dual`` masked before the exponential
    (``lm_family.ssd_mask_first``), at CACHE_REL: the Neumann loop reads
    the bf16 feature cache, as the dense family's at DEEP_SEED."""
    case, seed = "zamba2-1.2b", L.DEEP_SEED
    (rs, rv), port, draws = F.init(case, seed, chunk=None)
    assert int(draws.init.max()) == L.K - 1
    assert any(np.isnan(np.asarray(a)).any()
               for a in jax.tree.leaves(rs["w"]))
    assert any(np.isnan(np.asarray(a)).any()
               for a in jax.tree.leaves(rv["adaptive"]["a"]))
    monkeypatch.setattr(ref_ssm, "_ssd_chunk_dual", ssd_mask_first)
    ref, _, _ = F.init(case, seed, chunk=None, witness=True)
    stepped, synced = F.step_and_sync(case, ref, port, draws, seed,
                                      chunk=None, witness=True)
    for what, ((rs, rv), (ps, pv)) in zip(("init", "local step", "sync"),
                                          ((ref, port), stepped, synced)):
        for t in tree_leaves((ps, pv)):
            assert torch.isfinite(t).all(), what
        L.assert_states(ps, rs, what, rel=L.CACHE_REL, w_rel=L.CACHE_REL)
        L.assert_server(pv, rv, f"server after the {what}", L.CACHE_REL)
