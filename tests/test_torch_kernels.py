"""The port's fused update kernels on the CPU path (their plain versions)
against the reference's Pallas kernels in interpret mode and its
``kernels/ref.py`` oracles, at 1e-6 in f32 (the reference's own kernel
tolerance, tests/test_kernels.py), including ragged lengths; plus the flat
buffer packing and the tree-level wrappers."""
import numpy as np
import pytest
import torch

from test_torch_harness import assert_trees_close, to_torch

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro.core import tree_util as ref_tu  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.kernels.storm_update import adafbio_update as pallas_adafbio  # noqa: E402
from repro.kernels.storm_update import storm_update as pallas_storm  # noqa: E402
from repro_torch.core import tree_util as tu  # noqa: E402
from repro_torch.kernels import ops, storm_update as kern  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("n", [1, 3, 1000, 2 * 65536 + 5])
@pytest.mark.parametrize("beta", [0.0, 0.3, 1.0])
def test_storm_plain_matches_pallas_and_oracle(n, beta):
    rng = _rng(n)
    gn, go, est = (rng.standard_normal(n).astype(np.float32)
                   for _ in range(3))
    got = kern.storm_update(*(torch.from_numpy(a)[None] for a in
                              (gn, go, est)), torch.tensor(beta))[0]
    pallas = pallas_storm(jnp.asarray(gn), jnp.asarray(go), jnp.asarray(est),
                          beta, interpret=True)
    oracle = ref_ref.storm_update_ref(jnp.asarray(gn), jnp.asarray(go),
                                      jnp.asarray(est), jnp.float32(beta))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("rows,n", [(1, 5), (3, 512), (2, 65536 + 3)])
def test_adafbio_plain_matches_pallas_and_oracle(rows, n):
    rng = _rng(rows * n)
    p = rng.standard_normal((rows, n)).astype(np.float32)
    w = rng.standard_normal((rows, n)).astype(np.float32)
    a = np.abs(rng.standard_normal(n)).astype(np.float32)
    lr_eta, rho = 0.01, 1e-4
    got = kern.adafbio_update(torch.from_numpy(p), torch.from_numpy(w),
                              torch.from_numpy(a), torch.tensor(lr_eta),
                              torch.tensor(rho)).numpy()
    for r in range(rows):
        pallas = pallas_adafbio(jnp.asarray(p[r]), jnp.asarray(w[r]),
                                jnp.asarray(a), lr_eta, rho, interpret=True)
        oracle = ref_ref.adafbio_update_ref(
            jnp.asarray(p[r]), jnp.asarray(w[r]), jnp.asarray(a),
            jnp.float32(lr_eta), rho)
        np.testing.assert_allclose(got[r], np.asarray(pallas), **TOL)
        np.testing.assert_allclose(got[r], np.asarray(oracle), **TOL)


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    before = dict(kern.launches)
    x = torch.ones(2, 8)
    kern.storm_update(x, x, x, torch.tensor(0.5))
    kern.adafbio_update(x, x, x[0], torch.tensor(0.1), torch.tensor(1e-4))
    assert kern.launches == before
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kern.storm_update(meta, meta, meta, torch.empty((), device="meta"))
    with pytest.raises(ValueError, match="one device"):
        kern.storm_update(x, x, meta, torch.tensor(0.5))


def _tree(rng, lead=()):
    return {"w1": rng.standard_normal(lead + (4, 5)).astype(np.float32),
            "b1": rng.standard_normal(lead + (5,)).astype(np.float32),
            "z": {"s": rng.standard_normal(lead + ()).astype(np.float32)}}


def test_tree_pack_matches_reference_layout_and_roundtrips():
    tree = _tree(_rng(0))
    flat, spec = tu.tree_pack(to_torch(tree))
    ref_flat, ref_spec = ref_tu.tree_pack(jax.tree.map(jnp.asarray, tree))
    assert (spec.size, spec.padded_size) == (ref_spec.size,
                                             ref_spec.padded_size)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref_flat))
    assert_trees_close(tu.tree_unpack(flat, spec), tree, rtol=0, atol=0)


@pytest.mark.parametrize("align", [1, 128])
def test_tree_pack_stacked_rows_are_client_packs(align):
    """Each unpadded row is the reference's pack of that client's tree, up to
    the reference's zero padding to ``align``."""
    m = 3
    tree = _tree(_rng(1), (m,))
    flat, spec = tu.tree_pack_stacked(to_torch(tree))
    assert flat.shape == (m, spec.size) and spec.padded_size == spec.size
    for i in range(m):
        one = jax.tree.map(lambda a: jnp.asarray(a[i]), tree)
        ref_flat, ref_spec = ref_tu.tree_pack(one, align=align)
        assert ref_spec.size == spec.size
        ref_flat = np.asarray(ref_flat)
        np.testing.assert_array_equal(flat[i].numpy(), ref_flat[:spec.size])
        assert not ref_flat[spec.size:].any()
    assert_trees_close(tu.tree_unpack_stacked(flat, spec), tree, rtol=0,
                       atol=0)


def test_bare_tensor_is_a_tree():
    x = torch.arange(6, dtype=torch.float32)
    flat, spec = tu.tree_pack(x)
    assert flat.shape == (128,)
    assert torch.equal(tu.tree_unpack(flat, spec), x)


def test_storm_update_tree_matches_reference_per_client():
    m = 3
    rng = _rng(2)
    gn, go, est = (_tree(rng, (m,)) for _ in range(3))
    got = ops.storm_update_tree(to_torch(gn), to_torch(go), to_torch(est),
                                0.25)
    want = jax.vmap(lambda a, b, c: ref_ops.storm_update_tree(
        a, b, c, jnp.float32(0.25), use_pallas=False))(
            *(jax.tree.map(jnp.asarray, t) for t in (gn, go, est)))
    assert_trees_close(got, want, **TOL, what="storm_update_tree")


@pytest.mark.parametrize("stacked", [True, False])
def test_adafbio_update_tree_matches_reference(stacked):
    m = 3
    rng = _rng(3)
    lead = (m,) if stacked else ()
    p, w = _tree(rng, lead), _tree(rng, lead)
    a = jax.tree.map(np.abs, _tree(rng))
    got = ops.adafbio_update_tree(to_torch(p), to_torch(w), to_torch(a),
                                  torch.tensor(0.05), 1e-4)

    def one(pp, ww):
        return ref_ops.adafbio_update_tree(
            pp, ww, jax.tree.map(jnp.asarray, a), jnp.float32(0.05), 1e-4,
            use_pallas=False)
    pj, wj = (jax.tree.map(jnp.asarray, t) for t in (p, w))
    want = jax.vmap(one)(pj, wj) if stacked else one(pj, wj)
    assert_trees_close(got, want, **TOL, what="adafbio_update_tree")
