"""The LM trainer on the moe family against the JAX reference on the CPU:
reduced qwen3-moe-30b-a3b (2 layers of 4 experts, top 2) and reduced
llama4-scout-17b-a16e (top 1 beside the shared FFN, 8 prefix embeddings),
through the tests of ``lm_family``: the LM problem's f, g and gradients
at one and two microbatches; the trainer's init, a local step and a sync;
the eager run stage by stage and free-running, eval, and the scan rounds
equal to the eager calls bit for bit.
For qwen3-moe also the train CLI's checkpoint through ``checkpoint/ckpt.py``
and both bridges, served by the serve CLI, and a reference checkpoint
read by the port's bridge (the ``[L, E, d, f]`` expert leaves both ways).
The vlm and dense cases are in ``test_torch_lm_vlm.py``."""
import pytest

from lm_family import (  # noqa: F401  (the tests this file runs)
    test_lm_problem_matches_reference,
    test_trainer_eager_run_scan_rounds_and_eval,
    test_train_cli_checkpoint_is_served_and_read_by_both_bridges,
    test_trainer_init_step_and_sync_match_reference)


@pytest.fixture(params=["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"])
def case(request):
    return request.param


@pytest.fixture(params=["qwen3-moe-30b-a3b"])
def family_case(request):
    return request.param
