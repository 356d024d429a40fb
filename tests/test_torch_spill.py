"""The host-spill bank and the cohort-only round (``repro_torch.fed.spill``,
``repro_torch.fed.population.make_cohort_round``) on the CPU, against the
reference's.

The bank: the last-wins mask, duplicate scatters, the lazy broadcast with
``materialize`` and ``lazy_leaves``, and the prefetch consumed, dropped by
a write and mismatched, on the reference's sequences
(``tests/test_bank_sharding.py``); after every call the port's bank (rows,
``fresh``, ``base``, the dense view) and what it gathered equal the
reference's ``HostSpillBank`` after the same call. The round: a spilled run
(the port's bank, cohort round and host write-back) against the port's
dense population round and against the reference's spilled run, on the
reference's toy pieces with duplicate-heavy cohorts, lossless and topk +
EF. Tolerance: none, every comparison is bit for bit, but for the lossy
round's final state against the reference's, held at REF_RTOL: XLA fuses
the EF residual's f32 arithmetic in another order, and one element in
twelve parts by an ulp."""
import numpy as np
import pytest
import torch

from test_torch_harness import to_jax, to_torch

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.fed import compress as ref_compress  # noqa: E402
from repro.fed import population as ref_pop  # noqa: E402
from repro.fed import spill as ref_spill  # noqa: E402
from repro_torch.checkpoint.ckpt import LazyRows  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.fed import compress, population, spill  # noqa: E402


# ------------------------------------------------------------ the bank

@pytest.mark.parametrize("ids", [[3, 1, 3, 2, 1], [4, 4, 4], [0, 5, 2],
                                 [1]])
def test_last_wins_mask_matches_reference(ids):
    got = spill._last_wins_mask(np.asarray(ids))
    np.testing.assert_array_equal(got, ref_spill._last_wins_mask(
        np.asarray(ids)))
    if ids == [3, 1, 3, 2, 1]:
        np.testing.assert_array_equal(got, [False, False, True, True, True])


def _np_bank(n=6, d=2):
    return {"x": np.arange(n * d, dtype=np.float32).reshape(n, d)}


def _pair(n=6):
    """The port's bank and the reference's on the same rows."""
    return (spill.HostSpillBank(rows=to_torch(_np_bank(n)), n=n),
            ref_spill.HostSpillBank(rows=_np_bank(n), n=n))


def _same(port, ref, got=None, want=None):
    """The two banks hold the same state, and what they gathered is the
    same."""
    np.testing.assert_array_equal(port.rows["x"].numpy(), ref.rows["x"])
    np.testing.assert_array_equal(port.fresh, ref.fresh)
    assert (port.base is None) == (ref.base is None)
    if ref.base is not None:
        np.testing.assert_array_equal(port.base["x"].numpy(),
                                      np.asarray(ref.base["x"]))
    np.testing.assert_array_equal(port.materialize()["x"].numpy(),
                                  ref.materialize()["x"])
    lazy = port.lazy_leaves()["x"]
    assert isinstance(lazy, LazyRows) and lazy.shape == (port.n, 2)
    np.testing.assert_array_equal(lazy.fetch(2, 5).numpy(),
                                  ref.materialize()["x"][2:5])
    if want is not None:
        np.testing.assert_array_equal(got["x"].numpy(),
                                      np.asarray(want["x"]))


def test_spill_scatter_gather_duplicates_match_reference():
    port, ref = _pair()
    vals = {"x": np.stack([np.full(2, 7.0, np.float32),
                           np.full(2, 9.0, np.float32)])}
    port.scatter(np.asarray([4, 4]), to_torch(vals))
    ref.scatter(np.asarray([4, 4]), vals)
    ids = np.asarray([4, 0])
    _same(port, ref, port.gather(ids), ref.gather(ids))
    np.testing.assert_array_equal(port.gather(ids)["x"][0].numpy(),
                                  np.full(2, 9.0))
    # device-side ids and a [3, ...] scatter with every slot a duplicate
    vals3 = {"x": np.arange(6, dtype=np.float32).reshape(3, 2) - 10.0}
    port.scatter(torch.tensor([1, 1, 1]), to_torch(vals3))
    ref.scatter(np.asarray([1, 1, 1]), vals3)
    ids = torch.tensor([1, 4, 1])
    _same(port, ref, port.gather(ids), ref.gather(np.asarray(ids)))


def test_spill_broadcast_is_lazy_and_materialize_matches_reference():
    port, ref = _pair()
    before = port.rows["x"].clone()
    one = {"x": np.full(2, 5.0, np.float32)}
    port.broadcast(to_torch(one))
    ref.broadcast(one)
    # lazy: the rows are untouched, only base/fresh changed
    assert torch.equal(port.rows["x"], before) and not port.fresh.any()
    ids = np.asarray([0, 3])
    _same(port, ref, port.gather(ids), ref.gather(ids))
    # a scatter after the broadcast re-freshens exactly its rows
    row = {"x": np.full((1, 2), 8.0, np.float32)}
    port.scatter(np.asarray([2]), to_torch(row))
    ref.scatter(np.asarray([2]), row)
    ids = np.asarray([2, 0, 2])
    _same(port, ref, port.gather(ids), ref.gather(ids))
    np.testing.assert_array_equal(port.materialize()["x"][2].numpy(),
                                  np.full(2, 8.0))
    np.testing.assert_array_equal(port.materialize()["x"][0].numpy(),
                                  np.full(2, 5.0))
    # a second broadcast reuses base and clears every row again
    two = {"x": np.full(2, -3.0, np.float32)}
    port.broadcast(to_torch(two))
    ref.broadcast(two)
    _same(port, ref)


def test_spill_prefetch_consumed_dropped_and_mismatched_match_reference():
    port, ref = _pair()
    for b in (port, ref):
        b.prefetch(np.asarray([1, 2]))
    assert port._prefetched is not None
    ids = np.asarray([1, 2])
    _same(port, ref, port.gather(ids), ref.gather(ids))   # consumed
    assert port._prefetched is None
    for b in (port, ref):
        b.prefetch(np.asarray([1, 2]))
    row = {"x": np.full((1, 2), -1.0, np.float32)}
    port.scatter(np.asarray([1]), to_torch(row))          # drops it
    ref.scatter(np.asarray([1]), row)
    assert port._prefetched is None
    got, want = port.gather(ids), ref.gather(ids)
    _same(port, ref, got, want)
    np.testing.assert_array_equal(got["x"][0].numpy(), np.full(2, -1.0))
    for b in (port, ref):
        b.prefetch(np.asarray([0, 1]))
    ids = np.asarray([3, 4])                              # mismatched
    _same(port, ref, port.gather(ids), ref.gather(ids))
    # a broadcast drops a pending prefetch too
    port.prefetch(np.asarray([0, 1]))
    port.broadcast({"x": torch.full((2,), 4.0)})
    assert port._prefetched is None
    assert torch.equal(port.gather(np.asarray([0]))["x"],
                       torch.full((1, 2), 4.0))


def test_allocate_from_device_and_nbytes():
    like = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
            "b": {"c": torch.zeros(3, 5, dtype=torch.float32)}}
    bank = spill.HostSpillBank.allocate(like, "cpu", zero=True)
    assert bank.n == 3 and not bank.pinned
    assert bank.nbytes == 3 * 4 * 2 + 3 * 5 * 4
    assert all(float(t.abs().sum()) == 0 for t in tree_leaves(bank.rows))
    # the leaves are views of one allocation, each on its own bytes
    src = {"a": torch.randn(3, 4).to(torch.bfloat16),
           "b": {"c": torch.randn(3, 5)}}
    copy = spill.HostSpillBank.from_device(src)
    for a, b in zip(tree_leaves(copy.materialize()), tree_leaves(src)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    out = copy.gather([2, 0])
    assert torch.equal(out["b"]["c"], src["b"]["c"][[2, 0]])


# ------------------------------------------------------------ the round

def _port_pieces(lossy):
    """The reference test's toy round (``_toy_round_pieces``) in torch: the
    local step moves each cohort state by a function of (global id,
    batch); the sync averages and halves."""
    def local(states, server, batch, k, ids):
        return {"x": states["x"] + batch[:, None] * (ids[:, None] + 1.0)}, \
            server

    def sync_update(server, avg):
        return {"x": avg["x"] * 0.5 + server["s"]}, {"s": server["s"] + 1.0}

    codec = compress.make_codec("topk", topk_frac=0.5) if lossy else None
    return local, sync_update, codec


def _ref_pieces(lossy):
    def local(states, server, batch, key, ids):
        return {"x": states["x"] + batch[:, None] * (ids[:, None] + 1.0)}, \
            server

    def sync_update(server, avg):
        return {"x": avg["x"] * 0.5 + server["s"]}, {"s": server["s"] + 1.0}

    codec = ref_compress.make_codec("topk", topk_frac=0.5) if lossy else None
    return local, sync_update, codec


N, C, Q, ROUNDS = 6, 3, 2, 4
REF_RTOL = 1e-6
# duplicate-heavy cohorts (a trace sampler's shortfall cycling)
COHORTS = ([0, 0, 1], [2, 5, 2], [4, 4, 4], [1, 3, 1])


def _batches(r):
    return np.arange(Q * C, dtype=np.float32).reshape(Q, C) + r


def _port_dense(lossy):
    local, sync_update, codec = _port_pieces(lossy)
    round_fn = population.make_population_round(local, sync_update, Q,
                                                codec=codec)
    bank = to_torch(_np_bank(N))
    ef = compress.zeros_ef(codec, bank) if lossy else None
    last_sync, server = torch.zeros(N, dtype=torch.int32), {
        "s": torch.zeros(())}
    draws = torch.zeros(Q, C, dtype=torch.int64)
    for r in range(ROUNDS):
        ids = torch.tensor(COHORTS[r])
        batches = torch.from_numpy(_batches(r))
        if lossy:
            bank, last_sync, ef, server = round_fn(
                bank, last_sync, ef, server, ids, batches, draws, r, None)
        else:
            bank, last_sync, server = round_fn(bank, last_sync, server, ids,
                                               batches, draws, r)
    return bank, last_sync, ef, server


def _port_spilled(lossy):
    local, sync_update, codec = _port_pieces(lossy)
    round_fn = population.make_cohort_round(local, sync_update, Q,
                                            codec=codec)
    bank = spill.HostSpillBank.from_device(to_torch(_np_bank(N)))
    ef = (spill.HostSpillBank.allocate(to_torch(_np_bank(N)), zero=True)
          if lossy else None)
    last_sync, server = torch.zeros(N, dtype=torch.int32), {
        "s": torch.zeros(())}
    draws = torch.zeros(Q, C, dtype=torch.int64)
    for r in range(ROUNDS):
        ids = torch.tensor(COHORTS[r])
        batches = torch.from_numpy(_batches(r))
        cur = bank.gather(ids)
        if lossy:
            new_client, ef_c, server = round_fn(
                cur, last_sync[ids], ef.gather(ids), server, ids, batches,
                draws, r, None)
            ef.scatter(ids, ef_c)
        else:
            new_client, server = round_fn(cur, last_sync[ids], server, ids,
                                          batches, draws, r)
        assert cur == {}          # the round took the gathered rows
        bank.broadcast(new_client)
        last_sync.fill_(r + 1)
        if r + 1 < ROUNDS:
            bank.prefetch(COHORTS[r + 1])
    return bank, last_sync, ef, server


def _ref_spilled(lossy):
    """The reference test's spilled run (``test_cohort_round_matches_dense_
    population_round``)."""
    local, sync_update, codec = _ref_pieces(lossy)
    round_fn = ref_pop.make_cohort_round(local, sync_update, Q, codec=codec)
    key = jax.random.PRNGKey(0)
    bank0 = to_jax(_np_bank(N))
    bank = ref_spill.HostSpillBank.from_device(bank0)
    ef = (ref_spill.HostSpillBank.from_device(ref_compress.zeros_ef(
        codec, bank0)) if lossy else None)
    ls, server = np.zeros(N, np.int32), {"s": jnp.zeros(())}
    for r in range(ROUNDS):
        ids = np.asarray(COHORTS[r])
        cur = bank.gather(ids)
        jids = jnp.asarray(ids, jnp.int32)
        if lossy:
            new_client, ef_c, server = round_fn(
                cur, jnp.asarray(ls[ids]), ef.gather(ids), server, jids,
                jnp.asarray(_batches(r)), key, jnp.int32(r))
            ef.scatter(ids, ef_c)
        else:
            new_client, server = round_fn(cur, jnp.asarray(ls[ids]), server,
                                          jids, jnp.asarray(_batches(r)),
                                          key, jnp.int32(r))
        bank.broadcast(new_client)
        ls[:] = r + 1
        if r + 1 < ROUNDS:
            bank.prefetch(np.asarray(COHORTS[r + 1]))
    return bank, ls, ef, server


@pytest.mark.parametrize("lossy", [False, True])
def test_cohort_round_matches_dense_round_and_reference(lossy):
    """A spilled run replays the dense population round's trajectory bit
    for bit, and the reference's spilled run."""
    d_bank, d_ls, d_ef, d_srv = _port_dense(lossy)
    s_bank, s_ls, s_ef, s_srv = _port_spilled(lossy)
    r_bank, r_ls, r_ef, r_srv = _ref_spilled(lossy)
    assert torch.equal(s_bank.materialize()["x"], d_bank["x"])
    assert torch.equal(s_ls, d_ls) and torch.equal(s_srv["s"], d_srv["s"])
    rtol = REF_RTOL if lossy else 0.0
    np.testing.assert_allclose(s_bank.materialize()["x"].numpy(),
                               r_bank.materialize()["x"], rtol=rtol, atol=0)
    np.testing.assert_array_equal(s_ls.numpy(), r_ls)
    np.testing.assert_array_equal(s_srv["s"].numpy(), np.asarray(r_srv["s"]))
    if lossy:
        assert torch.equal(s_ef.materialize()["x"], d_ef["x"])
        np.testing.assert_allclose(s_ef.materialize()["x"].numpy(),
                                   r_ef.materialize()["x"], rtol=rtol,
                                   atol=0)
        assert float(d_ef["x"].abs().sum()) > 0   # EF carried something


def test_cohort_round_needs_a_local_step():
    local, sync_update, _ = _port_pieces(False)
    with pytest.raises(ValueError, match="q >= 1"):
        population.make_cohort_round(local, sync_update, 0)
