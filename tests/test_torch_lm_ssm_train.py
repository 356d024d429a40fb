"""``FederatedTrainer`` on the ssm family, reduced falcon-mamba-7b (2 mamba1
layers), against the JAX reference on the CPU: the trainer tests of
``lm_family`` (the init, a local step and a sync; the eager run stage by
stage and free-running, eval, the scan rounds against the eager calls; a
population round; the train CLI's checkpoint through both bridges and the
serve CLI). The hybrid family's cases are in
``test_torch_lm_hybrid_train.py``, the problem-level cases in
``test_torch_lm_ssm.py``."""
import pytest

from lm_family import (  # noqa: F401  (the tests this file runs)
    test_population_round_matches_reference,
    test_train_cli_checkpoint_is_served_and_read_by_both_bridges,
    test_trainer_eager_run_scan_rounds_and_eval,
    test_trainer_init_step_and_sync_match_reference)


@pytest.fixture(params=["falcon-mamba-7b"])
def case(request):
    return request.param


@pytest.fixture(params=["falcon-mamba-7b"])
def family_case(request):
    return request.param
