"""Checkpoints and the serve bridge of the port against the JAX reference at
``reduced(qwen1.5-4b)``: the port writes and the reference loads, the
reference writes and the port loads, dense and in 3 shards, with the same
sidecar (the structure string JAX writes, dtypes, shapes, the sharded
leaves) for every layout the bridge knows; ``load_serve_params`` on the
reference's checkpoints of every layout gives the reference's params
exactly; mismatches raise ``ValueError`` naming the leaf's path."""
import functools
import json

import numpy as np
import pytest
import torch

from test_torch_harness import to_torch

import jax  # noqa: E402  (after the harness: it shims jax first)
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro.configs import get_arch as ref_arch, reduced as ref_reduced  # noqa: E402
from repro.serve import bridge as ref_bridge  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.interop import to_numpy  # noqa: E402
from repro_torch.serve import bridge  # noqa: E402

ARCH = "qwen1.5-4b"
N = 3                      # bank rows: every bank leaf splits over 3 shards


@functools.lru_cache(maxsize=None)
def _layouts(codec):
    """(name, reference template of ShapeDtypeStructs) of every layout."""
    cfg = ref_reduced(ref_arch(ARCH))
    return tuple(ref_bridge._candidate_templates(cfg, N, codec, 8, 0.05))


def _fill(template, seed):
    """Random numpy values of a reference template (bf16 as ml_dtypes)."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if jnp.issubdtype(s.dtype, jnp.integer):
            return rng.integers(0, 100, s.shape).astype(s.dtype)
        a = rng.standard_normal(s.shape).astype(np.float32)
        return np.asarray(jnp.asarray(a).astype(s.dtype))
    return jax.tree.map(leaf, template)


def _tuple_to_torch(tree):
    return tuple(to_torch(t) for t in tree)


def _assert_same(got, want):
    """Port tensors against reference arrays, leaf by leaf, exactly."""
    g_l, w_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(g_l) == len(w_l)
    for g, w in zip(g_l, w_l):
        assert g.dtype == to_torch(np.asarray(w)).dtype
        np.testing.assert_array_equal(to_numpy(g),
                                      np.asarray(w).astype(to_numpy(g).dtype))


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_treedef_string_is_jax_s_for_every_layout(codec):
    port = {n: t for n, t in bridge.candidate_templates(
        reduced(get_arch(ARCH)), N, codec, 8, 0.05)}
    for name, tmpl in _layouts(codec):
        assert ckpt.treedef_str(port[name]) == str(jax.tree.structure(tmpl))


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("layout", ["plain[adaptive=adam]",
                                    "population+ef[adaptive=adam]",
                                    "gossip[adaptive=adabelief]"])
def test_checkpoints_cross_between_the_packages(tmp_path, shards, layout):
    tmpl = dict(_layouts("int8"))[layout]
    tree = _fill(tmpl, 0)
    # the reference writes, the port reads
    ref_ckpt.save_checkpoint(tmp_path / "r", tree, step=7, shards=shards)
    got, step = ckpt.load_checkpoint(tmp_path / "r", _tuple_to_torch(tree))
    assert step == 7 and isinstance(got, tuple)
    _assert_same(got, tree)
    # the port writes the same files, the reference reads them
    ckpt.save_checkpoint(tmp_path / "p", _tuple_to_torch(tree), step=7,
                         shards=shards)
    assert (json.loads((tmp_path / "p.json").read_text())
            == json.loads((tmp_path / "r.json").read_text()))
    back, step = ref_ckpt.load_checkpoint(tmp_path / "p", tmpl)
    assert step == 7
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    if shards > 1:
        meta = json.loads((tmp_path / "p.json").read_text())
        assert meta["sharded_leaves"] and all(
            (tmp_path / f"p.shard{k}.npz").is_file() for k in range(shards))


def test_a_template_of_specs_loads_on_the_device_asked(tmp_path):
    tmpl = dict(_layouts("none"))["plain[adaptive=adam]"]
    tree = _fill(tmpl, 1)
    ref_ckpt.save_checkpoint(tmp_path / "r", tree, step=3)
    port_tmpl = dict(bridge.candidate_templates(
        reduced(get_arch(ARCH)), N, "none", 8, 0.05))["plain[adaptive=adam]"]
    got, step = ckpt.load_checkpoint(tmp_path / "r", port_tmpl, device="cpu")
    assert step == 3
    _assert_same(got, tree)


def test_lazy_rows_write_the_dense_files(tmp_path):
    x = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    lazy = ckpt.LazyRows(lambda lo, hi: x[lo:hi].numpy(), (6, 4), np.float32)
    ckpt.save_checkpoint(tmp_path / "lazy", {"a": lazy, "b": x[0]}, shards=3)
    ckpt.save_checkpoint(tmp_path / "dense", {"a": x, "b": x[0]}, shards=3)
    got, _ = ckpt.load_checkpoint(tmp_path / "lazy", {"a": x, "b": x[0]})
    assert torch.equal(got["a"], x) and torch.equal(got["b"], x[0])
    assert ckpt.shard_bounds(7, 3) == [(0, 3), (3, 5), (5, 7)]
    assert (json.loads((tmp_path / "lazy.json").read_text())
            == json.loads((tmp_path / "dense.json").read_text()))


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_serve_params_from_reference_checkpoints_of_every_layout(tmp_path,
                                                                 codec):
    cfg_ref, cfg = ref_reduced(ref_arch(ARCH)), reduced(get_arch(ARCH))
    for i, (name, tmpl) in enumerate(_layouts(codec)):
        path = tmp_path / f"ck{i}"
        ref_ckpt.save_checkpoint(path, _fill(tmpl, 10 + i), step=i,
                                 shards=3 if i % 2 else 1)
        want, want_info = ref_bridge.load_serve_params(path, cfg_ref,
                                                       codec=codec)
        got, info = bridge.load_serve_params(path, cfg, codec=codec,
                                             device="cpu")
        assert info == want_info, name
        _assert_same(got, want)


def test_mismatches_raise_naming_the_leaf_path(tmp_path):
    tmpl = dict(_layouts("none"))["plain[adaptive=adam]"]
    tree = _fill(tmpl, 2)
    ref_ckpt.save_checkpoint(tmp_path / "r", tree, step=1)
    wrong = _tuple_to_torch(tree)
    wrong[0]["x"]["layers"]["wq"] = wrong[0]["x"]["layers"]["wq"][..., :1]
    with pytest.raises(ValueError, match=r"\[0\]\['x'\]\['layers'\]\['wq'\]"):
        ckpt.load_checkpoint(tmp_path / "r", wrong)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_checkpoint(tmp_path / "r", _tuple_to_torch(tree)[:1])
    # another arch's params against this checkpoint: the bridge names a leaf
    other = reduced(get_arch(ARCH), d_model=128, head_dim=32)
    with pytest.raises(ValueError, match=r"leaf \d+ at \[0\]\['"):
        bridge.load_serve_params(tmp_path / "r", other, device="cpu")
    with pytest.raises(ValueError, match="sidecar"):
        bridge.load_serve_params(tmp_path / "missing", reduced(get_arch(ARCH)),
                                 device="cpu")
