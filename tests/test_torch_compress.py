"""The port's update codecs against the reference's.

The quantize kernels' plain versions must equal the reference's Pallas
kernels (interpret mode) and its ``kernels/ref.py`` oracles bit for bit,
segment by segment, at ragged lengths and 8, 4 and 2 bits. The int8 codec's
round trip and ``client_messages`` run on the reference's exported noise
and agree with the reference's to 1e-6 (the reference's kernel tolerance,
tests/test_kernels.py); topk keeps the same values; error feedback
telescopes; and the byte counts equal the reference's exactly."""
import numpy as np
import pytest
import torch

from test_torch_harness import (ReferenceNoise, assert_trees_close, to_jax,
                                to_torch)

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.fed import compress as ref_compress  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.kernels.quantize import dequantize as pallas_dequantize  # noqa: E402
from repro.kernels.quantize import quantize_stoch as pallas_quantize  # noqa: E402
from repro_torch.core.tree_util import tree_map  # noqa: E402
from repro_torch.fed import compress  # noqa: E402
from repro_torch.kernels import ops, quantize as kern  # noqa: E402

KEY = jax.random.PRNGKey(5)


def _segmented(seed, rows, sizes):
    """[rows, n] f32 with per-segment magnitudes that differ by orders of
    magnitude, its noise, and the offsets of the segments."""
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    x = rng.standard_normal((rows, offsets[-1])).astype(np.float32)
    for s, (a, b) in enumerate(zip(offsets, offsets[1:])):
        x[:, a:b] *= np.float32(10.0 ** (s % 5 - 2))
    u = rng.random((rows, offsets[-1])).astype(np.float32)
    return x, u, offsets


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("sizes", [(1, 3, 1000), (7, 65536 + 5),
                                   (4096, 1, 513)])
def test_quantize_plain_matches_pallas_and_oracle(bits, sizes):
    qmax = (1 << (bits - 1)) - 1
    rows = 2
    x, u, offsets = _segmented(bits * 31 + len(sizes), rows, sizes)
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    t_off = torch.from_numpy(offsets)
    scale = ops.leaf_scales(tx, tuple(int(o) for o in offsets), qmax)
    q = kern.quantize_stoch(tx, tu, scale, t_off, qmax)
    back = kern.dequantize(q, scale, t_off)
    assert q.dtype == torch.int8 and back.dtype == torch.float32
    for r in range(rows):
        for s, (a, b) in enumerate(zip(offsets, offsets[1:])):
            xs, us = jnp.asarray(x[r, a:b]), jnp.asarray(u[r, a:b])
            # the scale as compress.py:131 computes it
            sc = jnp.maximum(jnp.max(jnp.abs(xs)), 1e-30) / qmax
            assert scale[r, s].item() == float(sc), (r, s)
            want_q = np.asarray(pallas_quantize(xs, us, sc, qmax,
                                                interpret=True))
            np.testing.assert_array_equal(
                np.asarray(ref_ref.quantize_stoch_ref(xs, us, sc, qmax)),
                want_q)
            np.testing.assert_array_equal(q[r, a:b].numpy(), want_q)
            want_x = np.asarray(pallas_dequantize(jnp.asarray(want_q), sc,
                                                  interpret=True))
            np.testing.assert_array_equal(
                np.asarray(ref_ref.dequantize_ref(jnp.asarray(want_q), sc)),
                want_x)
            np.testing.assert_array_equal(back[r, a:b].numpy(), want_x)


def _client_trees(seed, c=3):
    """A stacked [c, ...] client-state tree with leaves of mixed sizes, as
    numpy (reference order: keys sorted)."""
    rng = np.random.default_rng(seed)
    shapes = {"v": (5,), "w": {"a": (3, 4), "b": (1,)}, "x": (2, 7)}

    def leaf(shape):
        return rng.standard_normal((c,) + shape).astype(np.float32)
    return jax.tree.map(leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def _sizes(tree):
    return [int(np.prod(a.shape[1:])) for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("bits", [8, 4])
def test_int8_roundtrip_matches_reference(bits):
    tree = _client_trees(bits)
    ids = [4, 0, 9]
    codec = compress.make_codec("int8", bits=bits)
    ref_codec = ref_compress.make_codec("int8", bits=bits)
    base = jax.random.fold_in(jax.random.fold_in(KEY, 0xC0DEC), 3)
    u = ReferenceNoise(KEY, _sizes(tree))(3, torch.tensor(ids))
    got = codec.roundtrip(to_torch(tree), u)
    for i, g in enumerate(ids):
        want = ref_codec.roundtrip(jax.random.fold_in(base, g),
                                   jax.tree.map(lambda a: jnp.asarray(a[i]),
                                                tree))
        assert_trees_close(tree_map(lambda a: a[i], got), want, rtol=1e-6,
                           atol=1e-6, what=f"client {g}")


@pytest.mark.parametrize("name, kw", [("int8", dict(bits=8)),
                                      ("int8", dict(bits=2)),
                                      ("topk", dict(topk_frac=0.3)),
                                      ("topk", dict(topk_frac=1.0))])
@pytest.mark.parametrize("ef_on", [True, False])
def test_client_messages_match_reference(name, kw, ef_on):
    ref_tree = _client_trees(1)
    cur_tree = jax.tree.map(lambda a: a + 0.1 * np.float32(np.sign(a)),
                            _client_trees(2))
    ef_tree = (jax.tree.map(lambda a: 0.01 * a, _client_trees(3))
               if ef_on else None)
    ids = np.array([2, 7, 5], np.int32)
    codec = compress.make_codec(name, error_feedback=ef_on, **kw)
    ref_codec = ref_compress.make_codec(name, error_feedback=ef_on, **kw)
    want = ref_compress.client_messages(
        ref_codec, KEY, jnp.int32(6), jnp.asarray(ids),
        *(jax.tree.map(jnp.asarray, t) if t is not None else None
          for t in (ref_tree, cur_tree, ef_tree)))
    u = None
    if name == "int8":
        u = ReferenceNoise(KEY, _sizes(ref_tree))(6, torch.from_numpy(ids))
    got = compress.client_messages(
        codec, to_torch(ref_tree), to_torch(cur_tree),
        to_torch(ef_tree) if ef_on else None, u)
    assert_trees_close(got[0], want[0], rtol=1e-6, atol=1e-6, what="recon")
    if ef_on:
        assert_trees_close(got[1], want[1], rtol=1e-6, atol=1e-6, what="ef")
    else:
        assert got[1] is None and want[1] is None


def test_topk_keeps_the_largest_values_of_each_client_leaf():
    tree = _client_trees(4)
    codec = compress.make_codec("topk", topk_frac=0.25)
    got = codec.roundtrip(to_torch(tree))
    want = jax.vmap(lambda t: ref_compress.make_codec(
        "topk", topk_frac=0.25).roundtrip(None, t))(
        jax.tree.map(jnp.asarray, tree))
    assert_trees_close(got, want, rtol=0, atol=0, what="topk")
    for g, a in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        k = compress._leaf_k(int(np.prod(a.shape[1:])), 0.25)
        assert (g.reshape(g.shape[0], -1) != 0).sum(1).tolist() == \
            [k] * a.shape[0]


@pytest.mark.parametrize("name", ["int8", "topk"])
def test_error_feedback_telescopes(name):
    """sent + e' == delta + e: what the codec dropped is kept, exactly up
    to the one f32 rounding of e' = (delta + e) - sent."""
    ref_t, cur_t = to_torch(_client_trees(5)), to_torch(_client_trees(6))
    ef = tree_map(lambda a: 0.05 * a, to_torch(_client_trees(7)))
    codec = compress.make_codec(name, topk_frac=0.2)
    u = compress.CodecNoise(0, "cpu")(0, torch.arange(3))
    recon, ef_new = compress.client_messages(codec, ref_t, cur_t, ef, u)
    for r, c, e, e2, x in zip(*(jax.tree.leaves(t) for t in (
            ref_t, cur_t, ef, ef_new, recon))):
        delta = c - r + e
        sent = x - r
        torch.testing.assert_close(sent + e2, delta, rtol=1e-6, atol=1e-6)
        assert e2.dtype == torch.float32


@pytest.mark.parametrize("name, kw", [("none", {}), ("int8", dict(bits=8)),
                                      ("int8", dict(bits=4)),
                                      ("int8", dict(bits=2)),
                                      ("topk", dict(topk_frac=0.1)),
                                      ("topk", dict(topk_frac=1.0))])
def test_bytes_match_reference(name, kw):
    tree = _client_trees(8, c=4)
    tree["x"] = tree["x"].astype(np.float16)
    codec = compress.make_codec(name, **kw)
    ref_codec = ref_compress.make_codec(name, **kw)
    jtree = jax.tree.map(jnp.asarray, tree)
    assert compress.wire_costs(codec, to_torch(tree)) == \
        ref_compress.wire_costs(ref_codec, jtree)
    one = jax.tree.map(lambda a: a[0], jtree)
    assert codec.message_bytes(tree_map(lambda a: a[0], to_torch(tree))) \
        == ref_codec.message_bytes(one)
    assert compress.state_bytes(to_torch(tree)) == \
        ref_compress.state_bytes(jtree)


def test_codec_validation_and_ef_helpers():
    for kw in (dict(name="gzip"), dict(name="int8", bits=9),
               dict(name="topk", topk_frac=0.0)):
        with pytest.raises(ValueError):
            compress.make_codec(**kw)
        with pytest.raises(ValueError):
            ref_compress.make_codec(**kw)
    states = to_torch(_client_trees(9))
    assert compress.zeros_ef(compress.make_codec("int8",
                                                 error_feedback=False),
                             states) is None
    assert compress.zeros_ef(compress.make_codec("none"), states) is None
    ef = compress.zeros_ef(compress.make_codec("topk"), states)
    assert all(a.dtype == torch.float32 and not a.any()
               for a in jax.tree.leaves(ef))
    keep = torch.tensor([True, False, True])
    new = tree_map(lambda a: a + 1.0, states)
    got = compress.mask_rows(keep, new, states)
    want = ref_compress.mask_rows(jnp.asarray(keep.numpy()), to_jax(new),
                                  to_jax(states))
    assert_trees_close(got, want, rtol=0, atol=0, what="mask_rows")
    assert compress.mask_rows(keep, None, states) is None


def test_codec_noise_is_seeded_by_run_and_round():
    """A sync's noise source gives each leaf ``[C, size]`` uniform[0, 1)
    draws, a function of (seed, round, leaf)."""
    ids = torch.arange(3)
    a = compress.CodecNoise(0, "cpu")(2, ids)(1, 10)
    assert a.shape == (3, 10) and a.dtype == torch.float32
    assert ((a >= 0) & (a < 1)).all()
    torch.testing.assert_close(compress.CodecNoise(0, "cpu")(2, ids)(1, 10),
                               a, rtol=0, atol=0)
    assert not torch.equal(compress.CodecNoise(0, "cpu")(3, ids)(1, 10), a)
    assert not torch.equal(compress.CodecNoise(1, "cpu")(2, ids)(1, 10), a)
    assert not torch.equal(compress.CodecNoise(0, "cpu")(2, ids)(0, 10), a)
