"""The LM trainer's mega-scan builders and the train CLI's chunk paths
(ROADMAP 2a).

``FederatedTrainer.multi_population_round_fn``,
``multi_async_population_round_fn`` and ``multi_gossip_round_fn`` against
the reference's on a reduced family of ``tests/lm_family.py``
(deepseek-67b, 2 layers, f32, ``fused="on"``, K = 1), both from the
reference's init, the port fed the reference's cohorts, tokens, Neumann
depths and delay draws (the async state and the gossip banks built
around the reference's population init, as its own inits build them). A
chunk of 3 rounds runs 6 local steps and 3 syncs free from the
reference, so it is held at the family's free-running limit,
``lm_family.EAGER_REL`` (1e-3 normwise; the adaptive step grows the
packages' f32 rounding a step, and w of the population chunk reads
1.4e-4 after its 3 rounds), the async chunk's stacked stats and the
bookkeeping vectors exactly. (Each builder's chunk equals the port's own
single rounds bit for bit in the CLI tests below, which run both.)
The train CLI's four chunk paths (the scan engine plain and int8, the
population, async and gossip modes) at ``--rounds-per-scan 2`` equal
``--rounds-per-scan 1`` (chunks of one round) bit for bit over 3 rounds
(a partial chunk at the end), no chunk of either reading the device
back; a run stopped after round 0
and resumed at R = 3 (a chunk of rounds 1-3) equals the uninterrupted
R = 1 and R = 3 runs,
the int8 noise and the cohorts read at the absolute round; the launcher
refuses R > 1 where the reference's does."""
import functools

import numpy as np
import pytest
import torch

import lm_family as F
import test_torch_lm_train as L
from test_torch_async import ReferenceDelayDraws
from test_torch_harness import chunks_read_nothing, neumann_k, to_torch

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.configs import FedConfig as RefFed  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.core.tree_util import tree_bcast_axis0 as ref_tree_bcast  # noqa: E402
from repro.core.tree_util import tree_stack as ref_stack  # noqa: E402
from repro.data.synthetic import FederatedLMData as RefData  # noqa: E402
from repro.data.synthetic import make_client_batch as ref_batch  # noqa: E402
from repro.data.synthetic import make_cohort_batch as ref_cohort  # noqa: E402
from repro.fed import population as ref_pop  # noqa: E402
from repro.fed import runtime as ref_rt  # noqa: E402
from repro_torch.configs import FedConfig, ShapeConfig  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.fed import population, runtime  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

CASE = "deepseek-67b"
N, C, Q, K = 4, 2, 2, 1
# overlapping cohorts: client 3 is sampled again while its first update
# may still be in flight (async), and round 1 holds a client round 0 did
# not
COHORTS = ([0, 3], [1, 3], [2, 1])
R = len(COHORTS)
SEED = L.SEED
KEY = jax.random.PRNGKey(SEED)
FREE_REL = F.EAGER_REL
ASYNC = dict(max_staleness=2, max_delay=2, delay_eta=0.5,
             sync_mode="participants", staleness_decay=0.5)


@functools.lru_cache(maxsize=None)
def _trainers():
    ref_cfg, cfg = F._cfgs(CASE)
    kw = dict(q=Q, neumann_k=K, lr_x=1e-2, lr_y=1e-1, fused="on",
              rho=L.RHO)
    return (ref_rt.FederatedTrainer(ref_cfg, RefFed(**kw), RefShape(
        "t", L.SEQ, L.BATCH, "train")),
        runtime.FederatedTrainer(cfg, FedConfig(**kw), ShapeConfig(
            "t", L.SEQ, L.BATCH, "train"), device="cpu"))


@functools.lru_cache(maxsize=None)
def _data():
    """The bank's init batch ([N, ...]), the chunk's cohort batches ([R,
    q, C, ...]) and its batches of every node ([R, q, N, ...]), numpy."""
    ref_tr, _ = _trainers()
    specs_c, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, C,
                                           ref_tr.fed)
    specs_n, _ = ref_rt.client_batch_specs(ref_tr.cfg, ref_tr.shape, N,
                                           ref_tr.fed)
    data = RefData(vocab=ref_tr.cfg.vocab, n_clients=N)
    b0 = jax.tree.map(np.asarray, ref_batch(data, ref_tr.cfg, specs_n, 0))
    cohort = ref_stack([ref_stack([
        ref_cohort(data, ref_tr.cfg, specs_c, r * Q + j, np.asarray(ids))
        for j in range(Q)]) for r, ids in enumerate(COHORTS)])
    every = ref_stack([ref_stack([
        ref_batch(data, ref_tr.cfg, specs_n, r * Q + j) for j in range(Q)])
        for r in range(1, R + 1)])
    return b0, jax.tree.map(np.asarray, cohort), jax.tree.map(np.asarray,
                                                              every)


@functools.lru_cache(maxsize=None)
def _ref_init():
    """The reference's bank init over N clients: ``(bank, last_sync,
    server)``; the async state and the gossip banks are built around it
    as the reference's own inits build them."""
    ref_tr, _ = _trainers()
    return jax.jit(ref_tr.init_population_states, static_argnums=2)(
        KEY, _data()[0], N)


def _depth(gid, t):
    return neumann_k(jax.random.split(jax.random.fold_in(
        jax.random.fold_in(KEY, gid), t))[0], K)


def _depths(t0s, ids_of):
    """[R, q, C] depths of R rounds whose first local steps run at the
    server counters ``t0s``, per global id."""
    return torch.tensor([[[_depth(g, t0 + j) for g in ids_of(i)]
                          for j in range(Q)] for i, t0 in enumerate(t0s)])


def _assert_bank(got, want, rel, what):
    for name in ("x", "y", "v", "w"):
        L.assert_rel(got[name], want[name], rel, f"{what} {name}")


def _equal(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert (x is None and y is None) or torch.equal(x, y), (
            f"{what} leaf {i}")


def test_multi_population_round_matches_reference():
    ref_tr, tr = _trainers()
    _, cohort, _ = _data()
    bank, last, server = _ref_init()
    ids_R = np.asarray(COHORTS)
    want = jax.jit(ref_tr.multi_population_round_fn(N))(
        bank, last, server, jnp.asarray(ids_R), cohort, KEY, jnp.int32(0))
    # the population round syncs at its end: round r steps from r(q + 1)
    k_R = _depths([r * (Q + 1) for r in range(R)], lambda i: COHORTS[i])
    t_ids = torch.from_numpy(ids_R)
    got = tr.multi_population_round_fn(N)(
        to_torch(bank), to_torch(last), to_torch(server), t_ids,
        to_torch(cohort), k_R, 0)
    _assert_bank(got[0], want[0], FREE_REL, "bank")
    assert torch.equal(got[1], to_torch(want[1]))
    L.assert_server(got[2], want[2], "server", FREE_REL)


def test_multi_async_round_matches_reference():
    ref_tr, tr = _trainers()
    _, cohort, _ = _data()
    bank, _, server = _ref_init()
    state = ref_pop.init_async_state(bank, server, N)
    kw = dict(ASYNC)
    ref_dm = ref_pop.make_delay_model("uniform", 2).resolve(KEY, N)
    draws = ReferenceDelayDraws(KEY)
    dm = population.make_delay_model("uniform", 2).resolve(draws, N)
    ids_R = np.asarray(COHORTS)
    want, ref_stats = jax.jit(ref_tr.multi_async_population_round_fn(
        N, delay_model=ref_dm, **kw))(state, jnp.asarray(ids_R), cohort, KEY,
                                      jnp.int32(0))
    # a round's steps start one tick after its server step, which happens
    # only when it accepted an arrival
    t, ts = 0, []
    for r in range(R):
        t += int(ref_stats["accepted"][r] > 0)
        ts.append(t)
        t += Q
    k_R = _depths(ts, lambda i: COHORTS[i])
    multi = tr.multi_async_population_round_fn(
        N, delay_model=dm, delay_draws=draws, **kw)
    got, stats = multi(to_torch(state), torch.from_numpy(ids_R),
                       to_torch(cohort), k_R, 0)
    for k in ref_stats:
        np.testing.assert_array_equal(
            np.asarray(stats[k].numpy(), np.float32),
            np.asarray(ref_stats[k], np.float32), k)
    assert int(stats["accepted"].sum()) > 0
    for key in ("bank", "pending", "anchor"):
        _assert_bank(got[key], want[key], FREE_REL, key)
    L.assert_server(got["server"], want["server"], "server", FREE_REL)
    for key in ("last_sync", "in_flight", "dispatch_round", "return_round"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


def test_multi_gossip_round_matches_reference():
    """Rounds 1..R on a ring from the init bank, each opening with its
    mix (round 0's peel is the caller's)."""
    ref_tr, tr = _trainers()
    _, _, every = _data()
    bank, _, server = _ref_init()
    srv = ref_tree_bcast(server, N)
    want = jax.jit(ref_tr.multi_gossip_round_fn(N, topology="ring"))(
        bank, srv, None, every, KEY, jnp.int32(1))
    # each round opens with its mix (a tick), then steps
    k_R = _depths([i * (Q + 1) + 1 for i in range(R)], lambda i: range(N))
    got = tr.multi_gossip_round_fn(N, topology="ring")(
        to_torch(bank), to_torch(srv), None, to_torch(every), k_R, 1)
    _assert_bank(got[0], want[0], FREE_REL, "bank")
    L.assert_rel(got[1]["adaptive"]["a"], want[1]["adaptive"]["a"],
                 FREE_REL, "per-node a")
    assert got[1]["t"].tolist() == [(Q + 1) * R] * N
    assert got[2] is None


# ------------------------------------------------------------ the CLI

SMALL = ["--arch", "qwen1.5-4b", "--reduced", "--device", "cpu", "--seq",
         "32", "--batch", "2", "--q", "2", "--eval-every", "2"]
MODES = {
    "scan": ([], ("states", "server")),
    "scan-int8": (["--codec", "int8"], ("states", "server", "ef")),
    "population-int8": (["--population", "4", "--cohort", "2", "--codec",
                         "int8"], ("bank", "last_sync", "ef", "server")),
    "async": (["--population", "4", "--cohort", "2", "--max-staleness", "2",
               "--delay-model", "tiers", "--tiers", "0.5:1:1,0.5:2:3"],
              ("state",)),
    "gossip-int8": (["--population", "4", "--engine", "gossip", "--codec",
                     "int8"], ("bank", "srv_bank", "ef")),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_cli_chunks_equal_single_rounds(mode):
    """3 rounds: R = 2 runs a chunk of 2 and one of 1 (the gossip mode
    round 0 alone, then rounds 1-2), bit for bit the R = 1 run's (a chunk
    a round) states, wire totals and async staleness log; no chunk of
    either reads the device back (``test_torch_harness.NoHostRead``)."""
    flags, keys = MODES[mode]
    runs, n_chunks = [], []
    for r in (1, 2):
        chunks = []
        with chunks_read_nothing(chunks):
            runs.append(train_cli.main(SMALL + flags + [
                "--steps", "6", "--rounds-per-scan", str(r)]))
        n_chunks.append(len(chunks))
    # the gossip mode's round 0 runs alone, outside the chunk builder
    assert n_chunks == ([2, 1] if mode.startswith("gossip") else [3, 2])
    for k in keys:
        if runs[0][k] is None:
            assert runs[1][k] is None, k
        else:
            _equal(runs[0][k], runs[1][k], f"{mode} {k}")
    for k in ("step", "bytes_up", "bytes_down", "log"):
        assert runs[0].get(k) == runs[1].get(k), k
    if mode == "async":
        np.testing.assert_array_equal(runs[0]["hist"], runs[1]["hist"])
    assert len(runs[1]["seconds"]) == 3
    assert runs[1]["losses"][-1] == runs[0]["losses"][-1]


def test_resume_mid_chunk_equals_uninterrupted(tmp_path):
    """Population mode with int8 + EF, 4 rounds of q 2 at seq 16: stop
    after round 0, resume at R = 3 (a chunk of rounds 1-3, across the
    uninterrupted R = 3 run's chunks 0-2 and 3); the final state equals
    the uninterrupted R = 1 and R = 3 runs bit for bit, the EF bank
    too."""
    flags = SMALL + ["--seq", "16", "--population", "4", "--cohort", "2",
                     "--codec", "int8"]
    keys = ("bank", "last_sync", "ef", "server")
    full_r1 = train_cli.main(flags + ["--steps", "8"])
    full_r3 = train_cli.main(flags + ["--steps", "8", "--rounds-per-scan",
                                      "3"])
    ck = str(tmp_path / "part")
    train_cli.main(flags + ["--steps", "2", "--rounds-per-scan", "3",
                            "--ckpt", ck])
    resumed = train_cli.main(flags + ["--steps", "8", "--rounds-per-scan",
                                      "3", "--ckpt", ck, "--resume"])
    assert resumed["step"] == 8
    for k in keys:
        _equal(full_r1[k], full_r3[k], f"R 3 {k}")
        _equal(full_r1[k], resumed[k], f"resumed {k}")


@pytest.mark.parametrize("flags,why", [
    (["--population", "4", "--spill", "host"], "mega-scan tier"),
    (["--engine", "eager"], "use --engine scan or a --population mode")])
def test_train_cli_keeps_the_references_refusals(flags, why):
    """``--spill host`` and the eager engine refuse R > 1, with a
    ``SystemExit``, as the reference's launcher; R < 1 too."""
    with pytest.raises(SystemExit, match=why):
        train_cli.main(SMALL + flags + ["--rounds-per-scan", "2"])
    with pytest.raises(SystemExit, match="must be >= 1"):
        train_cli.main(SMALL + flags + ["--rounds-per-scan", "0"])
