"""The LM trainer's round functions against the JAX reference at
``reduced(qwen1.5-4b)``, with ``fused="on"`` on both sides: the scan round
(q local steps and the sync) in f32 at 1e-4 normwise and equal, bit for
bit, to the port's own eager calls; the int8 + error-feedback uplink leg
on the same states, and a whole codec round (the reference's rounding
noise carried across);
and a bf16 round held at 2e-2 against the reference beside an f32 witness
run from the same params. The shared inputs, tolerances and draws are
``test_torch_lm_train``'s."""
import numpy as np
import torch

import test_torch_lm_train as L
from test_torch_harness import ReferenceNoise, to_torch

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.core.tree_util import tree_stack as ref_stack  # noqa: E402
from repro.models.params import init_params as ref_init  # noqa: E402
from repro_torch.core.tree_util import (tree_index, tree_leaves,  # noqa: E402
                                        tree_stack)

# bf16 runs against the f32 witness, as chip_smoke.py's bf16 serve checks:
# the port no farther than twice the reference's distance (plus 2e-2)
WITNESS = 2.0
# a codec round, normwise: 1.1e-4 measured (level flips, see the test)
CODEC_REL = 1e-3


def _round_inputs(dtype, r):
    """Round r's stacked batches (reference and port) and [q, 1] depths."""
    bs = L._batches(dtype)[r * L.Q:(r + 1) * L.Q]
    draws = L._init(dtype)[2]
    return (ref_stack([jax.tree.map(jnp.asarray, b) for b in bs]),
            tree_stack([to_torch(b) for b in bs]),
            draws.steps[r * L.Q:(r + 1) * L.Q])


def _port_eager_round(tr, states, server, batches_q, k_q):
    local, sync = tr.local_step_fn(), tr.sync_step_fn()
    for j in range(L.Q):
        states, server = local(states, server, tree_index(batches_q, j),
                               k_q[j])
    return sync(states, server)


def test_scan_round_matches_reference_and_the_eager_calls():
    ref_tr, tr = L._trainers()
    (rs, rv), (ps, pv), _ = L._init()
    ref_round = jax.jit(ref_tr.round_step_fn())
    for r in range(L.STEPS // L.Q):
        rb, pb, k_q = _round_inputs("float32", r)
        want = ref_round(rs, rv, rb, L.KEY)
        eager = _port_eager_round(tr, ps, pv, pb, k_q)
        got = tr.round_step_fn()(dict(ps), dict(pv), pb, k_q)
        for a, b in zip(tree_leaves(got), tree_leaves(eager)):
            assert torch.equal(a, b)
        L.assert_rel(got[0], want[0], L.TRAIN_REL, f"round {r}")
        L.assert_server(got[1], want[1], f"round {r} server")
        (rs, rv), (ps, pv) = want, got


def test_round_donation_empties_the_arguments():
    _, tr = L._trainers()
    _, (ps, pv), _ = L._init()
    _, pb, k_q = _round_inputs("float32", 0)
    states, server = dict(ps), dict(pv)
    tr.round_step_fn()(states, server, pb, k_q)
    assert states == {} and server == {}
    assert sorted(ps) == ["v", "w", "x", "y"]      # the caller's copies stay


def test_codec_leg_matches_reference_on_the_same_states():
    """The int8 + EF uplink leg alone, both packages on the reference's own
    round-start and post-local-step states with a non-zero residual: the
    reconstructions agree to 1e-6 and the new residuals to 1e-5 (the
    quantize levels are bit-exact)."""
    ref_tr, tr = L._trainers(codec="int8")
    (rs, rv), _, _ = L._init(codec="int8")
    r_local = jax.jit(ref_tr.local_step_fn())
    cur, srv = rs, rv
    for b in L._batches()[:L.Q]:
        cur, srv = r_local(cur, srv, jax.tree.map(jnp.asarray, b), L.KEY)
    ef = jax.tree.map(lambda a: 1e-3 * jnp.sign(a) * jnp.abs(a) ** 0.5,
                      jax.tree.map(lambda a: a.astype(jnp.float32), cur))
    want = jax.jit(lambda r, c, e: ref_tr.star_aggregator().messages(
        L.KEY, jnp.int32(1), jnp.arange(1), r, c, e))(rs, cur, ef)
    sizes = [t[0].numel() for t in tree_leaves(to_torch(rs))]
    u = ReferenceNoise(L.KEY, sizes)(1, torch.arange(1))
    got = tr.star_aggregator().messages(to_torch(rs), to_torch(cur),
                                        to_torch(ef), u)
    L.assert_rel(got[0], want[0], 1e-6, "reconstruction")
    # the residual is a remainder (delta - sent, under one level an
    # element): the delta's f32 rounding is relative to the message
    L.assert_rel(got[1], want[1], 1e-5, "EF residual")


def test_codec_round_int8_with_error_feedback_matches_reference():
    """A whole codec round (q local steps, the int8 + EF leg, the sync),
    the port's noise the reference's key chain. The leg itself agrees to
    f32 rounding (above, with a non-zero residual in); across the local
    steps' rounding, a delta that rounds across an int8 level boundary
    moves that element by one level (max |delta| / 127 of its leaf: the
    codec's level flips), and error feedback carries the flip into later
    rounds, so one round is held, at CODEC_REL normwise."""
    ref_tr, tr = L._trainers(codec="int8")
    (rs, rv), (ps, pv), _ = L._init(codec="int8")
    r_ef, p_ef = ref_tr.init_ef_bank(1), tr.init_ef_bank(1)
    rb, pb, k_q = _round_inputs("float32", 0)
    rs, rv, _, r_ef = jax.jit(ref_tr.round_step_codec_fn())(
        rs, rv, rs, r_ef, rb, L.KEY, jnp.int32(0))
    sizes = [t[0].numel() for t in tree_leaves(ps)]
    u = ReferenceNoise(L.KEY, sizes)(0, torch.arange(1))
    ps, pv, _, p_ef = tr.round_step_codec_fn()(ps, pv, ps, p_ef, pb, k_q, u)
    L.assert_rel(ps, rs, CODEC_REL, "codec round")
    L.assert_server(pv, rv, "codec round server")
    assert max(float(np.abs(np.asarray(a)).max())
               for a in jax.tree.leaves(r_ef)) > 0
    assert max(float(t.abs().max()) for t in tree_leaves(p_ef)) > 0


def test_bf16_round_matches_reference_beside_an_f32_witness():
    """A bf16 scan round beside an f32 witness, the port's f32 run from the
    same (widened) params, batches and draws: leaf by leaf, the port's bf16
    run is no farther from the witness than WITNESS times the reference's
    bf16 run, plus 2e-2 normwise. Each bf16 run rounds at other places
    (XLA's fusions, PyTorch's operations), and the two part by up to 0.11
    in a leaf (a zero-initialized bias, whose steps are all rounding), so
    they are held to the witness and not to each other."""
    ref_tr, tr = L._trainers("bfloat16")
    (rs, rv), (ps, pv), draws = L._init("bfloat16")
    rb, pb, k_q = _round_inputs("bfloat16", 0)
    want = jax.jit(ref_tr.round_step_fn())(rs, rv, rb, L.KEY)
    got = tr.round_step_fn()(dict(ps), dict(pv), pb, k_q)
    # the witness: f32, the bf16 run's params widened
    _, tr32 = L._trainers("float32")
    params = ref_init(ref_tr.specs, jax.random.fold_in(L.KEY, L.PARAM_SALT),
                      "bfloat16")
    wide = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    ws, wv = tr32.init_states(to_torch(wide), to_torch(L._batches()[0]),
                              draws.init)
    witness = tr32.round_step_fn()(ws, wv, pb, k_q)
    wit = [t.double().numpy() for t in tree_leaves(witness)]

    def dist(leaves):
        return [np.linalg.norm(np.asarray(a, np.float64) - w)
                / max(np.linalg.norm(w), 1e-30) for a, w in zip(leaves, wit)]
    port = dist([t.double().numpy() for t in tree_leaves(got)])
    ref = dist(jax.tree.leaves(want))
    print("bf16 round, normwise from the f32 witness, port / reference:",
          ["%.1e/%.1e" % pr for pr in zip(port, ref)])
    for i, (p_e, r_e) in enumerate(zip(port, ref)):
        assert p_e <= WITNESS * r_e + L.BF16_REL, (i, p_e, r_e)
