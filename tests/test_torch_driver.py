"""The port's FedDriver against the reference's, engine by engine: port
eager against reference eager and port scan against reference scan, for 2
rounds of q=2 local steps, with the reference's batches, init and Neumann
draws. The accounting (steps, samples, comms, bytes) must be equal; the
recorded norms and the final averaged state agree to 1e-5 on the quadratic
problem and to 1e-4 on hyper-representation, where both packages sum in
different orders through the tanh MLP and its hypergradient, and four
steps of the adaptive update carry those differences on."""
import dataclasses
import functools
import time

import numpy as np
import pytest
import torch

from test_torch_harness import (assert_trees_close, quadratic_pair,
                                reference_draws, to_torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.paper_tasks import HyperRepConfig as RefHyperRepConfig  # noqa: E402
from repro.core.bilevel import quadratic_bilevel_problem as ref_quad  # noqa: E402
from repro.core.bilevel import quadratic_true_grad as ref_true_grad  # noqa: E402
from repro.core.tree_util import tree_norm as ref_tree_norm  # noqa: E402
from repro.tasks.driver import FedDriver as RefFedDriver  # noqa: E402
from repro.tasks.hyperrep import build_hyperrep as ref_build_hyperrep  # noqa: E402
from repro_torch.configs import FedConfig  # noqa: E402
from repro_torch.core.bilevel import (quadratic_bilevel_problem,  # noqa: E402
                                      quadratic_true_grad)
from repro_torch.core.tree_util import tree_norm  # noqa: E402
from repro_torch.tasks import Draws, FedDriver, build_hyperrep  # noqa: E402
from repro_torch.configs import HyperRepConfig, PopulationConfig  # noqa: E402

STEPS, Q = 4, 2
KEY = jax.random.PRNGKey(0)
ENGINES = ("eager", "scan")


def _compare(res, ref_res, rtol):
    for field in ("steps", "samples", "comms", "bytes_up", "bytes_down"):
        assert getattr(res, field) == getattr(ref_res, field), field
    np.testing.assert_allclose(res.grad_norm, ref_res.grad_norm, rtol=rtol,
                               atol=rtol)
    assert_trees_close(res.final_avg_state, ref_res.final_avg_state,
                       rtol=rtol, atol=rtol, what="final_avg_state")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algorithm", ["adafbio", "fednest"])
def test_quadratic_driver_matches_reference(engine, algorithm):
    consts, theta = quadratic_pair()
    K, m, d, p = 8, 4, 8, 6
    ref_fed = RefFedConfig(q=Q, neumann_k=K, lr_x=0.3, lr_y=0.3, theta=theta)
    jc = tuple(map(jnp.asarray, consts))
    ref = RefFedDriver(
        ref_quad(*jc), ref_fed, n_clients=m,
        batch_fn=lambda c, s: {"f": 0.0, "g": 0.0, "g0": 0.0,
                               "gi": jnp.zeros((K,))},
        init_xy=lambda k: (jnp.ones((d,)) * 2.0, jnp.zeros((p,))),
        grad_norm_fn=lambda x, y: jnp.linalg.norm(ref_true_grad(*jc, x)),
        algorithm=algorithm, engine=engine)
    ref_res = ref.run(STEPS, key=KEY, eval_every=2)

    tc = tuple(map(torch.from_numpy, consts))
    zero, gi = torch.zeros(()), torch.zeros(K)
    port = FedDriver(
        quadratic_bilevel_problem(*tc),
        FedConfig(**dataclasses.asdict(ref_fed)), n_clients=m,
        batch_fn=lambda c, s: {"f": zero, "g": zero, "g0": zero, "gi": gi},
        init_xy=lambda g: (torch.ones(d) * 2.0, torch.zeros(p)),
        grad_norm_fn=lambda x, y: torch.linalg.norm(
            quadratic_true_grad(*tc, x)),
        algorithm=algorithm, engine=engine, device="cpu")
    draws = reference_draws(KEY, m, STEPS, Q, K,
                            split_step_key=algorithm == "adafbio")
    _compare(port.run(STEPS, eval_every=2, draws=draws), ref_res, 1e-5)


@functools.lru_cache(maxsize=None)
def _hyperrep_batch(task_id, client, step):
    return jax.tree.map(np.asarray, _HYPER_TASKS[task_id]["batch_fn"](
        client, step))


_HYPER_TASKS = {}


@pytest.mark.parametrize("engine", ENGINES)
def test_hyperrep_driver_matches_reference(engine):
    ref_cfg = RefHyperRepConfig(fed=dataclasses.replace(
        RefHyperRepConfig().fed, q=Q))
    ref_task = ref_build_hyperrep(ref_cfg)
    _HYPER_TASKS[id(ref_task)] = ref_task
    norm_ref = lambda x, y: ref_tree_norm(x)
    ref = RefFedDriver(ref_task["problem"], ref_cfg.fed, ref_cfg.n_clients,
                       ref_task["batch_fn"], ref_task["init_xy"],
                       grad_norm_fn=norm_ref, engine=engine)
    ref_res = ref.run(STEPS, key=KEY, eval_every=2)

    cfg = HyperRepConfig(**{k: v for k, v in dataclasses.asdict(
        ref_cfg).items() if k != "fed"}, fed=FedConfig(
        **dataclasses.asdict(ref_cfg.fed)))
    task = build_hyperrep(cfg, device="cpu")
    init = to_torch(ref_task["init_xy"](KEY))
    port = FedDriver(
        task["problem"], cfg.fed, cfg.n_clients,
        batch_fn=lambda c, s: to_torch(_hyperrep_batch(id(ref_task), c, s)),
        init_xy=lambda g: init,
        grad_norm_fn=lambda x, y: tree_norm(x), engine=engine, device="cpu")
    draws = reference_draws(KEY, cfg.n_clients, STEPS, Q, cfg.fed.neumann_k)
    _compare(port.run(STEPS, eval_every=2, draws=draws), ref_res, 1e-4)


def _tiny_driver(**kw):
    zero = torch.zeros(())
    consts, theta = quadratic_pair()
    return FedDriver(
        quadratic_bilevel_problem(*map(torch.from_numpy, consts)),
        kw.pop("fed", FedConfig(q=2, neumann_k=2, theta=theta)), n_clients=2,
        batch_fn=lambda c, s: {"f": zero, "g": zero, "g0": zero,
                               "gi": torch.zeros(2)},
        init_xy=lambda g: (torch.ones(8), torch.zeros(6)), device="cpu",
        **kw)


def test_engine_and_draws_are_validated():
    with pytest.raises(ValueError, match="engine"):
        _tiny_driver(engine="ring")
    # the gossip engine is valid but needs a population, as the
    # reference's (tasks/driver.py _run_gossip)
    with pytest.raises(ValueError, match="engine='gossip' needs population"):
        _tiny_driver(engine="gossip").run(2)
    drv = _tiny_driver()
    short = Draws(init=torch.zeros(2, dtype=torch.int64),
                  steps=torch.zeros(3, 2, dtype=torch.int64))
    with pytest.raises(ValueError, match="draws"):
        drv.run(4, draws=short)


def test_standalone_runs_are_seeded_and_engines_agree():
    """Without handed-in draws the driver draws from a seeded generator:
    the same seed repeats a run, and both engines see the same draws."""
    eager = _tiny_driver().run(6, seed=3, eval_every=2)
    again = _tiny_driver().run(6, seed=3, eval_every=2)
    scan = _tiny_driver(engine="scan").run(6, seed=3, eval_every=2)
    for a, b in ((eager, again), (eager, scan)):
        for x, y in zip(a.final_avg_state.values(),
                        b.final_avg_state.values()):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
def test_round_clock_leaves_out_batches_and_evaluation(engine):
    """Both engines time the same span of a round: the sync and the local
    steps, not the building of its batches nor an evaluation inside it. Each
    batch call and each evaluation sleeps far longer than a round of the tiny
    problem takes; a clock that held either would exceed the sleep."""
    nap = 0.25
    zero = torch.zeros(())
    consts, theta = quadratic_pair()

    def slow_batch(c, s):
        time.sleep(nap)
        return {"f": zero, "g": zero, "g0": zero, "gi": torch.zeros(2)}

    def slow_metric(x, y):
        time.sleep(nap)
        return torch.zeros(())
    drv = FedDriver(
        quadratic_bilevel_problem(*map(torch.from_numpy, consts)),
        FedConfig(q=2, neumann_k=2, theta=theta), n_clients=2,
        batch_fn=slow_batch, init_xy=lambda g: (torch.ones(8), torch.zeros(6)),
        metric_fn=slow_metric, engine=engine, device="cpu")
    res = drv.run(6, seed=0, eval_every=1)
    assert len(drv.round_seconds) == 2 and res.compile_seconds > 0
    assert max(drv.round_seconds) < nap, drv.round_seconds
