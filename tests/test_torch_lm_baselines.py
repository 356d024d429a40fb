"""The LM trainer's Table-1 baselines against the JAX reference on the CPU,
at ``reduced(qwen1.5-4b)`` in f32 (``test_torch_lm_train.py``'s trainer
settings: q 2, K 2, rho 1e-2, ``fused="on"``): for ``adafbio_na``,
``fedbioacc``, ``fedavg_sgd`` (AdaFBiO with other knobs), ``fednest`` and
``localbsgvrm`` (their own local steps) through ``FederatedTrainer``, the
init, one local step and a sync at TRAIN_REL normwise (the server's b at
B_REL, integer leaves exactly), at SEED, where every Neumann depth is 0.
The reference's trainer runs them only at ``FedConfig(adaptive="none")``:
at its default ``"adam"`` it warms the server's accumulators by the
trainer's FedConfig, which the baselines' (all ``adaptive="none"``) do not
hold, and raises ``KeyError('a')`` at init. The port warms by the
algorithm's own FedConfig (ROADMAP section 3), so at the default FedConfig
it runs them, and equals the reference at ``adaptive="none"``; the fault
is recorded below.
Also one population round of ``fednest`` over a bank of 2, both clients
in the cohort (its clients' gradients one client at a time, as AdaFBiO's:
``adafbio.per_client``), and ``launch/train.py --algorithm fednest`` on
the CPU, with its checkpoint read back.

No baseline reaches the remat backward's second derivative
(``models/remat.py`` ``_Once``): every local step below runs the training
forward under remat and would raise there."""
import functools

import numpy as np
import pytest
import torch

import test_torch_lm_train as L
from test_torch_harness import neumann_k, reference_draws, to_torch

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.configs import FedConfig as RefFed  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.data.synthetic import FederatedLMData as RefData  # noqa: E402
from repro.data.synthetic import make_cohort_batch as ref_cohort  # noqa: E402
from repro.core.tree_util import tree_stack as ref_stack  # noqa: E402
from repro.fed import runtime as ref_rt  # noqa: E402
from repro.models.params import init_params as ref_init  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.configs import FedConfig, ShapeConfig  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core.tree_util import tree_leaves, tree_map  # noqa: E402
from repro_torch.fed import runtime  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

ALGORITHMS = ("adafbio_na", "fedbioacc", "fedavg_sgd", "fednest",
              "localbsgvrm")
# the baselines with their own local step draw a step's Neumann depth from
# the client's step key itself, AdaFBiO's knobs from its split
# (test_torch_harness.reference_draws)
OWN_STEP = ("fednest", "localbsgvrm")


KW = dict(q=L.Q, neumann_k=L.K, lr_x=1e-2, lr_y=1e-1, fused="on",
          rho=L.RHO)


@functools.lru_cache(maxsize=None)
def _trainers(algorithm, adaptive="adam"):
    """The reference's trainer at ``adaptive="none"`` (where it runs the
    baselines) and the port's at ``adaptive``."""
    ref_cfg, cfg = L._cfgs("float32")
    ref_tr = ref_rt.FederatedTrainer(ref_cfg, RefFed(**KW, adaptive="none"),
                                     RefShape("t", L.SEQ, L.BATCH, "train"),
                                     algorithm=algorithm)
    tr = runtime.FederatedTrainer(cfg, FedConfig(**KW, adaptive=adaptive),
                                  ShapeConfig("t", L.SEQ, L.BATCH, "train"),
                                  algorithm=algorithm, device="cpu")
    return ref_tr, tr


def _jit(fn):
    # numpy arguments: a state a jitted call returned carries weak types
    # where the init's does not, and would be traced again
    jitted = jax.jit(lambda *a: fn(*a))
    return lambda *a: jitted(*jax.tree.map(np.asarray, a))


def assert_tree(got, want, what, rel=L.TRAIN_REL):
    """Every leaf: integers exactly, the 0-d floats (the server's b, a
    norm) at B_REL, the rest at ``rel`` normwise."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, (what, i)
        if not a.is_floating_point():
            np.testing.assert_array_equal(a.numpy(), b, err_msg=what)
            continue
        tol = L.B_REL if a.dim() == 0 else rel
        err = L.rel_errs(a, b)[0] if a.dim() else abs(
            float(a) - float(b)) / max(abs(float(b)), 1e-30)
        assert err <= tol, (what, i, err)


@functools.lru_cache(maxsize=None)
def _ref_stages(algorithm):
    """The reference's params and its (states, server) after its jitted
    init, a local step on batch 0 at L.KEY and the sync."""
    ref_tr, _ = _trainers(algorithm)
    b0 = L._batches()[0]
    stages = [_jit(ref_tr.init_states)(L.KEY, b0)]
    stages.append(_jit(ref_tr.local_step_fn())(*stages[-1], b0, L.KEY))
    stages.append(_jit(ref_tr.sync_step_fn())(*stages[-1]))
    params = ref_init(ref_tr.specs, jax.random.fold_in(L.KEY, L.PARAM_SALT),
                      ref_tr.cfg.dtype)
    return params, stages


@pytest.mark.parametrize("adaptive", ["adam", "none"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_baseline_init_step_and_sync_match_reference(algorithm, adaptive):
    """Init from the reference's params, one local step on batch 0 and the
    sync, each from the port's own previous stage, against the
    reference's jitted init, local step and sync; the port's trainer at
    the default FedConfig and at ``adaptive="none"`` alike."""
    ref_tr, tr = _trainers(algorithm, adaptive)
    assert tr.alg.name == ref_tr.alg.name == algorithm
    b0 = L._batches()[0]
    params, want = _ref_stages(algorithm)
    draws = reference_draws(L.KEY, 1, L.STEPS, L.Q, L.K,
                            split_step_key=algorithm not in OWN_STEP)
    ps, pv = tr.init_states(to_torch(params), to_torch(b0), draws.init)
    assert_tree((ps, pv), want[0], f"{algorithm} init")
    ps, pv = tr.local_step_fn()(ps, pv, to_torch(b0), draws.steps[0])
    assert_tree((ps, pv), want[1], f"{algorithm} local step")
    ps, pv = tr.sync_step_fn()(ps, pv)
    assert_tree((ps, pv), want[2], f"{algorithm} sync")


def test_reference_trainer_refuses_baselines_at_its_default_fedconfig():
    """The reference fault the port does not copy: at ``adaptive="adam"``
    the reference's init warms accumulators that a baseline's server
    state lacks."""
    ref_cfg, _ = L._cfgs("float32")
    for algorithm in ALGORITHMS:
        ref_tr = ref_rt.FederatedTrainer(ref_cfg, RefFed(**KW), RefShape(
            "t", L.SEQ, L.BATCH, "train"), algorithm=algorithm)
        with pytest.raises(KeyError, match="'a'"):
            jax.eval_shape(ref_tr.init_states, L.KEY, jax.tree.map(
                jnp.asarray, L._batches()[0]))
        _, tr = _trainers(algorithm)
        assert "a" not in tr.abstract_server_state()["adaptive"]


def test_fednest_population_round_matches_reference():
    """One population round (q cohort steps, the aggregate, the server
    step, the broadcast) of fednest over a bank of N = 2, both clients in
    the cohort, from the reference's compiled init of each client: the
    port steps the cohort one client at a time. At SEED the second client
    draws depth K-1 at the second step (the bf16 feature cache), so the
    round is held at CACHE_REL, as the LM population rounds are;
    ``last_sync`` exactly."""
    n, cohort = 2, (0, 1)
    ref_tr, tr = _trainers("fednest")
    one, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, 1,
                                       ref_tr.fed)
    specs_c, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, n,
                                           ref_tr.fed)
    data = RefData(vocab=ref_tr.cfg.vocab, n_clients=n)
    key = L.KEY
    init = _jit(ref_tr.init_states)
    inits = [init(jax.random.fold_in(key, i), ref_cohort(
        data, ref_tr.cfg, one, 0, [i])) for i in range(n)]
    bank = jax.tree.map(lambda *a: jnp.concatenate(a), *[s for s, _ in inits])
    server, last = inits[0][1], jnp.zeros((n,), jnp.int32)
    cohort_b = ref_stack([ref_cohort(data, ref_tr.cfg, specs_c, j,
                                     np.asarray(cohort))
                          for j in range(L.Q)])
    want = jax.jit(ref_tr.population_round_fn(n))(
        bank, last, server, jnp.asarray(cohort), cohort_b, key,
        jnp.int32(0))
    k_q = torch.tensor([[neumann_k(jax.random.fold_in(
        jax.random.fold_in(key, g), j), L.K) for g in cohort]
        for j in range(L.Q)])
    assert int(k_q.max()) == L.K - 1, k_q
    got = tr.population_round_fn(n)(
        to_torch(bank), to_torch(last), to_torch(server),
        torch.tensor(cohort), to_torch(cohort_b), k_q, 0)
    assert_tree(got[0], want[0], "fednest bank", L.CACHE_REL)
    assert torch.equal(got[1], to_torch(want[1]))
    assert_tree(got[2], want[2], "fednest server", L.CACHE_REL)
    # the broadcast: every row of the bank holds the new global state
    for leaf in tree_leaves(got[0]):
        assert torch.equal(leaf[0], leaf[1])


def test_baselines_map_clients_as_adafbio_does():
    """fednest's and localbsgvrm's local steps on a client-stacked state
    of 2 equal one-client steps of each client's slices, leaf for leaf:
    the LM problem's clients run one at a time (its ``client_loop``)."""
    _, tr = _trainers("fednest")
    assert tr.problem.client_loop
    b0 = to_torch(L._batches()[0])
    params = tr.init_params(torch.Generator().manual_seed(0))
    for algorithm in ("fednest", "localbsgvrm"):
        alg = baselines.make_algorithm(algorithm, tr.fed, tr.problem)
        two = runtime.split_client_batch(tr.cfg, {
            k: torch.cat([v, v.flip(1) if v.dtype == torch.int32 else v])
            for k, v in b0.items()})
        k = torch.zeros(2, dtype=torch.int64)
        states = alg.init_client_state(params["x"], params["y"], two, k)
        server = tr.init_states(params, b0, k[:1])[1]
        t = torch.zeros((), dtype=torch.int32)
        both = alg.local_step(states, server["adaptive"], two, k, t, 2)
        for i in range(2):
            def one(tree, i=i):
                return tree_map(lambda a: a[i:i + 1], tree)
            row = alg.local_step(one(states), server["adaptive"], one(two),
                                 k[i:i + 1], t, 2)
            for a, b in zip(tree_leaves(both), tree_leaves(row)):
                assert torch.equal(a[i:i + 1], b), algorithm


def test_train_cli_runs_fednest_and_checkpoints(tmp_path):
    """``launch/train.py --algorithm fednest`` on the CPU: two scan rounds,
    finite losses, a checkpoint whose states read back equal to the
    run's."""
    ck = str(tmp_path / "ck")
    run = train_cli.main(["--arch", "qwen1.5-4b", "--reduced", "--device",
                          "cpu", "--seq", "32", "--batch", "2", "--q", "2",
                          "--steps", "4", "--algorithm", "fednest",
                          "--ckpt", ck])
    assert run["step"] == 4 and all(np.isfinite(run["losses"]))
    (states, server), step = load_checkpoint(
        ck, (run["states"], run["server"]))
    assert step == 4
    for a, b in zip(tree_leaves((states, server)),
                    tree_leaves((run["states"], run["server"]))):
        assert torch.equal(a, b)
