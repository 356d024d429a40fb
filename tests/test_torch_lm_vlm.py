"""The LM trainer on the vlm and dense families' new archs against the JAX
reference on the CPU: reduced internvl2-76b (2 layers, 8 prefix
embeddings in every batch: the LL, UL, zeta_0 and Neumann samples) and
reduced deepseek-67b (2 dense layers), through the tests of
``lm_family``: the LM problem's f, g and gradients at one and two
microbatches, with the prefix embeddings; the trainer's init, a local
step and a sync; the eager run stage by stage and free-running, eval, and
the scan rounds equal to the eager calls bit for bit. The moe cases are in
``test_torch_lm_moe.py``."""
import pytest

from lm_family import (  # noqa: F401  (the tests this file runs)
    test_lm_problem_matches_reference,
    test_trainer_eager_run_scan_rounds_and_eval,
    test_trainer_init_step_and_sync_match_reference)


@pytest.fixture(params=["internvl2-76b", "deepseek-67b"])
def case(request):
    return request.param
