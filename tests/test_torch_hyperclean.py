"""The port's hyper-cleaning task (paper Problem (4)), its data and the
consensus metrics against the reference's.

Both packages run on one data set, the reference's ``all_clients()``, with
the reference's batches, init and Neumann draws, at a small size (4 clients,
feat 8, 24 training and 12 validation samples each, batch 6, q 2). ``g``,
``f`` and the hypergradient agree to 1e-5; the exact diagnostics
(``true_grad_norm``, ``val_loss``: 12 Newton steps on the LL, a solve and a
VJP) to 1e-4 relative; the closed-form chunked LL Hessian equals
``torch.func.hessian``'s; the eager and scan drivers with AdaFBiO and
FedNest follow the reference engine of the same name to 1e-4 (the
hyper-representation driver's tolerance), with the accounting equal; the
consensus error and the eager engine's ``consensus_log`` to 1e-5. Dirichlet
priors and partitions from the reference's draws equal the reference's."""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.func import hessian, vmap

from test_torch_harness import (assert_trees_close, neumann_k,
                                reference_draws, to_torch)

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_tasks import HyperCleanConfig as RefHyperCleanConfig  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core.hypergrad import hypergrad as ref_hypergrad  # noqa: E402
from repro.data import partition as ref_partition  # noqa: E402
from repro.tasks.driver import FedDriver as RefFedDriver  # noqa: E402
from repro.tasks.hyperclean import build_hyperclean as ref_build  # noqa: E402
from repro_torch.configs import FedConfig, HyperCleanConfig  # noqa: E402
from repro_torch.configs import PopulationConfig  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core.hypergrad import hypergrad  # noqa: E402
from repro_torch.data import (HyperCleanData, dirichlet_class_priors,  # noqa: E402
                              dirichlet_partition, label_histogram)
from repro_torch.tasks import FedDriver, build_hyperclean  # noqa: E402

KEY = jax.random.PRNGKey(0)
Q, STEPS = 2, 6


@functools.lru_cache(maxsize=None)
def _tasks():
    """The reference's small hyper-cleaning task and the port's on the
    reference's data, built once per worker."""
    ref_cfg = RefHyperCleanConfig(
        n_clients=4, n_train_per_client=24, n_val_per_client=12, feat_dim=8,
        batch=6, fed=dataclasses.replace(RefHyperCleanConfig().fed, q=Q))
    ref_task = ref_build(ref_cfg)
    cfg = HyperCleanConfig(**{k: v for k, v in dataclasses.asdict(
        ref_cfg).items() if k != "fed"}, fed=FedConfig(
        **dataclasses.asdict(ref_cfg.fed)))
    task = build_hyperclean(cfg, device="cpu", data=jax.tree.map(
        np.asarray, ref_task["data"]))
    return ref_cfg, ref_task, cfg, task


@functools.lru_cache(maxsize=None)
def _batch(client, step):
    return jax.tree.map(np.asarray, _tasks()[1]["batch_fn"](client, step))


def _point():
    """A point (x, y) away from the init, as reference arrays."""
    ref_task = _tasks()[1]
    xp, yp = ref_task["init_xy"](KEY)
    xp = xp + 0.5 * jax.random.normal(jax.random.PRNGKey(5), xp.shape)
    yp = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(
        jax.random.PRNGKey(6), a.shape), yp)
    return xp, yp


def test_g_f_and_hypergrad_match_reference():
    _, ref_task, cfg, task = _tasks()
    xp, yp = _point()
    tx, ty = to_torch(xp), to_torch(yp)
    K = cfg.fed.neumann_k
    ref_hg = jax.jit(lambda x, y, b, k: ref_hypergrad(
        ref_task["problem"], x, y, b, k, K, cfg.fed.theta))
    for client in (0, 3):
        b = jax.tree.map(jnp.asarray, _batch(client, 3))
        tb = to_torch(b)
        for name in ("g", "f"):
            got = getattr(task["problem"], name)(tx, ty, tb[name])
            want = getattr(ref_task["problem"], name)(xp, yp, b[name])
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        key = jax.random.PRNGKey(10 + client)
        want = ref_hg(xp, yp, b, key)
        got = hypergrad(task["problem"], tx, ty, tb,
                        torch.tensor(neumann_k(key, K)), K, cfg.fed.theta)
        assert_trees_close(got, want, rtol=1e-5, atol=1e-6,
                           what=f"hypergrad client {client}")
    # the client-batched form the driver runs: one vmap over the clients
    batches = jax.tree.map(lambda *a: jnp.stack(a), *[
        _batch(c, 3) for c in range(cfg.n_clients)])
    ks = [jax.random.PRNGKey(10 + c) for c in range(cfg.n_clients)]
    want = jax.jit(jax.vmap(lambda b, k: ref_hg(xp, yp, b, k)))(
        batches, jnp.stack(ks))
    got = vmap(lambda b, k: hypergrad(task["problem"], tx, ty, b, k, K,
                                      cfg.fed.theta))(
        to_torch(batches), torch.tensor([neumann_k(k, K) for k in ks]))
    assert_trees_close(got, want, rtol=1e-5, atol=1e-6, what="vmapped")


def test_exact_diagnostics_match_reference():
    _, ref_task, _, task = _tasks()
    xp, yp = _point()
    tx, ty = to_torch(xp), to_torch(yp)
    for name in ("true_grad_norm", "val_loss"):
        want = float(ref_task[name](xp, yp))
        got = float(task[name](tx, ty))
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=name)
        # the float64 witness of the same diagnostic agrees too
        np.testing.assert_allclose(float(task[name](tx.double(), ty)), want,
                                   rtol=1e-4, err_msg=f"{name} float64")


@pytest.mark.parametrize("chunk_rows", [None, 5, 1])
def test_chunked_hessian_equals_autodiff(chunk_rows):
    """The closed-form LL Hessian, assembled over the samples in chunks,
    equals torch.func.hessian of the full LL objective (all directions at
    once), in f32 and float64."""
    task = _tasks()[3]
    xp, yp = _point()
    tx, ty = to_torch(xp), to_torch(yp)
    y_vec = torch.cat([ty["w"].reshape(-1), ty["b"]])
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        x, y = tx.to(dtype), y_vec.to(dtype)
        got = task["ll_hessian"](x, y, chunk_rows)
        want = hessian(task["g_full"], argnums=1)(x, y)
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def _driver_pair(engine, algorithm, track_consensus=False):
    """The reference's driver and the port's on the shared task."""
    ref_cfg, ref_task, cfg, task = _tasks()
    ref = RefFedDriver(ref_task["problem"], ref_cfg.fed, ref_cfg.n_clients,
                       ref_task["batch_fn"], ref_task["init_xy"],
                       metric_fn=ref_task["val_loss"],
                       grad_norm_fn=ref_task["true_grad_norm"],
                       algorithm=algorithm, engine=engine,
                       track_consensus=track_consensus)
    init = to_torch(ref_task["init_xy"](KEY))
    port = FedDriver(task["problem"], cfg.fed, cfg.n_clients,
                     batch_fn=lambda c, s: to_torch(_batch(c, s)),
                     init_xy=lambda g: init, metric_fn=task["val_loss"],
                     grad_norm_fn=task["true_grad_norm"],
                     algorithm=algorithm, engine=engine,
                     track_consensus=track_consensus, device="cpu")
    return ref, port


@pytest.mark.parametrize("engine", ["eager", "scan"])
@pytest.mark.parametrize("algorithm", ["adafbio", "fednest"])
def test_hyperclean_driver_matches_reference(engine, algorithm):
    """Three rounds of q 2 with the exact diagnostics recorded as the metric
    (val loss at y*(x̄)) and the grad norm (‖∇F(x̄)‖); the eager engine also
    tracks the consensus error before each sync."""
    eager = engine == "eager"
    ref, port = _driver_pair(engine, algorithm, track_consensus=eager)
    ref_res = ref.run(STEPS, key=KEY, eval_every=2)
    res = port.run(STEPS, eval_every=2, draws=reference_draws(
        KEY, 4, STEPS, Q, 4, split_step_key=algorithm == "adafbio"))
    for field in ("steps", "samples", "comms", "bytes_up", "bytes_down"):
        assert getattr(res, field) == getattr(ref_res, field), field
    np.testing.assert_allclose(res.metric, ref_res.metric, rtol=1e-4)
    np.testing.assert_allclose(res.grad_norm, ref_res.grad_norm, rtol=1e-4)
    assert_trees_close(res.final_avg_state, ref_res.final_avg_state,
                       rtol=1e-4, atol=1e-4, what="final_avg_state")
    if eager:
        _compare_consensus(port.consensus_log, ref.consensus_log)


def _compare_consensus(got, want):
    """Row by row: the same steps and fields, each value within 1e-5 of the
    reference's relative to the field's largest value over the run."""
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert len(want) == STEPS // Q - 1
    for field in ("x", "y", "v", "w"):
        g = np.array([r[field] for r in got])
        w = np.array([r[field] for r in want])
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=field)


def test_consensus_error_matches_reference():
    rng = np.random.default_rng(3)
    states = {"x": rng.standard_normal((5, 7)).astype(np.float32),
              "y": {"w": rng.standard_normal((5, 3, 2)).astype(np.float32),
                    "b": rng.standard_normal((5, 2)).astype(np.float32)},
              "v": rng.standard_normal((5, 4)).astype(np.float32)}
    got = metrics.consensus_error(to_torch(states))
    want = ref_metrics.consensus_error(jax.tree.map(jnp.asarray, states))
    assert sorted(got) == sorted(want) == ["v", "x", "y"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    log, ref_log = metrics.MetricsLog(), ref_metrics.MetricsLog()
    for lg in (log, ref_log):
        lg.log(3, a=1.5, b=torch.tensor(2.0) if lg is log else 2.0)
    assert log.rows == ref_log.rows and log.last() == ref_log.last()
    assert log.column("a") == [1.5]


@pytest.mark.parametrize("engine, population", [
    ("scan", None), ("eager", PopulationConfig(n=4, cohort=2)),
    ("gossip", PopulationConfig(n=4, cohort=4))])
def test_track_consensus_needs_the_eager_engine(engine, population):
    """Where the reference refuses ``track_consensus`` (every engine but
    the masked eager one), the port raises the same ValueError."""
    _, ref_task, cfg, task = _tasks()
    port = FedDriver(task["problem"], cfg.fed, cfg.n_clients,
                     task["batch_fn"], task["init_xy"], engine=engine,
                     population=population, track_consensus=True,
                     device="cpu")
    with pytest.raises(ValueError, match="track_consensus"):
        port.run(2)


def test_dirichlet_priors_from_reference_draws():
    """The reference's Dirichlet draw is the softmax of log-gamma draws:
    fed the reference's log-gamma draws, the port's priors and partition
    equal the reference's."""
    key = jax.random.PRNGKey(7)
    for alpha in (0.1, 1.0):
        lg = np.asarray(jax.random.loggamma(key, jnp.float32(alpha), (6, 5)))
        got = dirichlet_class_priors(0, 6, 5, alpha, log_gamma=lg)
        want = np.asarray(ref_partition.dirichlet_class_priors(key, 6, 5,
                                                               alpha))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    labels = np.random.default_rng(0).integers(0, 4, 60)
    lg = np.asarray(jax.random.loggamma(key, jnp.float32(0.5), (4, 5)))
    perms = [np.asarray(jax.random.permutation(
        jax.random.fold_in(key, 1 + k), int((labels == k).sum())))
        for k in range(4)]
    got = dirichlet_partition(0, labels, 5, 0.5, log_gamma=lg, perms=perms)
    want = ref_partition.dirichlet_partition(key, labels, 5, 0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        label_histogram(labels, got, 4),
        ref_partition.label_histogram(labels, want, 4))


def test_standalone_data_and_partition_properties():
    """Without the reference's arrays the port draws its own: seeded,
    corrupted in the configured fraction, labels in range, skewed by
    ``label_alpha``; a standalone partition is disjoint and covers every
    index."""
    d = HyperCleanData(3, 40, 10, 5, 4, 0.25, seed=2)
    a, b = d.all_clients("cpu"), d.all_clients("cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["a_tr"].shape == (3, 40, 5) and a["b_val"].shape == (3, 10)
    assert a["b_tr"].dtype == torch.int32
    assert (a["corrupted"].sum(dim=1) == 10).all()
    assert int(a["b_tr"].min()) >= 0 and int(a["b_tr"].max()) < 4
    other = HyperCleanData(3, 40, 10, 5, 4, 0.25, seed=3).all_clients("cpu")
    assert not torch.equal(a["a_tr"], other["a_tr"])
    skew = HyperCleanData(4, 400, 10, 5, 4, 0.0, seed=0,
                          label_alpha=0.05).all_clients("cpu")
    counts = [torch.bincount(skew["b_tr"][m].long(), minlength=4)
              for m in range(4)]
    assert max(int(c.max()) for c in counts) > 300     # concentrated
    priors = dirichlet_class_priors(1, 4, 3, 0.5)
    torch.testing.assert_close(priors.sum(dim=1), torch.ones(4))
    labels = np.random.default_rng(1).integers(0, 3, 50)
    parts = dirichlet_partition(4, labels, 6, 0.3)
    joined = np.sort(np.concatenate(parts))
    np.testing.assert_array_equal(joined, np.arange(50))
