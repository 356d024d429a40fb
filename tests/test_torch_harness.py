"""Parity harness of the PyTorch port against the JAX reference.

Importing this module applies a runtime shim that lets the reference import
under jax 0.9: ``repro/core/tree_util.py`` tests ``prim in
batching.primitive_batchers``, and jax 0.9's proxy object has no
``__contains__``. The shim answers that test from the table the proxy wraps;
``src/repro/`` itself is untouched. The port's test files import the
helpers below from here, so the shim is in place before any ``import
repro``. Because pytest collects test files in order, the reference's test
files collected after these (``test_train_resume.py``) import too.

Inputs are made with numpy from a seed and handed to both packages; the
reference's random draws (Neumann depths, the int8 codec's rounding noise,
cohorts) are exported through numpy as the port's draw inputs.

``chunks_read_nothing`` runs every mega-scan chunk under
:class:`NoHostRead`, the CPU's stand-in for the card's sync debug mode.
"""
from jax._src.interpreters import batching as _batching

if not hasattr(_batching.PrimitiveBatchersProxy, "__contains__"):
    _batching.PrimitiveBatchersProxy.__contains__ = (
        lambda self, p: p in _batching.fancy_primitive_batchers)

import contextlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from repro_torch.fed.sampling import CohortSampler  # noqa: E402
from repro_torch.interop import from_reference, to_numpy  # noqa: E402

CPU = torch.device("cpu")
# the tests run several workers side by side on a few cores, at small
# sizes: one intra-op thread per worker (8 contending OpenMP threads make
# every small op two orders of magnitude slower)
torch.set_num_threads(1)


def to_torch(tree):
    """A reference (JAX) tree -> the port's CPU tensors."""
    return from_reference(jax.tree.map(np.asarray, tree), CPU)


def to_jax(tree):
    """A port tree (or numpy tree) -> JAX arrays."""
    if isinstance(tree, torch.Tensor) or (
            isinstance(tree, dict) and any(isinstance(v, torch.Tensor)
                                           for v in jax.tree.leaves(tree))):
        tree = to_numpy(tree)
    return jax.tree.map(jnp.asarray, tree)


def assert_trees_close(got, want, *, rtol, atol, what=""):
    """``got`` (port tensors) against ``want`` (reference arrays), leaf by
    leaf in the reference's leaf order."""
    got_l = [np.asarray(a) for a in jax.tree.leaves(to_numpy(got))]
    want_l = [np.asarray(a) for a in jax.tree.leaves(want)]
    assert len(got_l) == len(want_l), (what, len(got_l), len(want_l))
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g.astype(np.float64),
                                   np.asarray(w, np.float64), rtol=rtol,
                                   atol=atol, err_msg=f"{what} leaf {i}")


# ------------------------------------------------------------ draws

def neumann_k(key, K: int) -> int:
    """The reference's Neumann depth for ``key`` (core/hypergrad.py:52)."""
    return int(jax.random.randint(key, (), 0, K))


def reference_draws(key, n_clients: int, total_steps: int, q: int, K: int,
                    *, split_step_key: bool = True):
    """The port's draw tensors, filled from the reference driver's keys.

    Init: ``split(key, M)[i]`` (tasks/driver.py:171). Local step ``s`` of
    client ``i`` uses ``fold_in(fold_in(key, i), t)`` (driver.py:182) with
    ``t = s + s // q`` (the server counter also advances at each sync);
    AdaFBiO draws from ``split(...)[0]`` of that key (adafbio.py:125), the
    fednest/localbsgvrm baselines from the key itself.
    """
    from repro_torch.tasks import Draws
    init = [neumann_k(k, K) for k in jax.random.split(key, n_clients)]
    steps = np.zeros((total_steps, n_clients), np.int64)
    for s in range(total_steps):
        t = s + s // q
        for i in range(n_clients):
            kk = jax.random.fold_in(jax.random.fold_in(key, i), t)
            if split_step_key:
                kk = jax.random.split(kk)[0]
            steps[s, i] = neumann_k(kk, K)
    return Draws(init=torch.tensor(init, dtype=torch.int64),
                 steps=torch.from_numpy(steps))


def quadratic_pair(seed=0, d=8, p=6):
    """Constants (H, B, c, Q) of the quadratic bilevel problem as numpy f32,
    and a Neumann step theta = 1 / L_g."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((p, p)).astype(np.float32)
    H = (A @ A.T / p + 0.5 * np.eye(p)).astype(np.float32)
    Bm = (rng.standard_normal((p, d)) * 0.3).astype(np.float32)
    c = rng.standard_normal(p).astype(np.float32)
    Q_ = (np.eye(d) * 0.2).astype(np.float32)
    return (H, Bm, c, Q_), float(1.0 / np.linalg.eigvalsh(H)[-1])


def reference_leaf_keys(key, round_id: int, gid: int, n_leaves: int):
    """The int8 codec's noise keys of client ``gid`` at ``round_id`` in the
    reference, one a leaf: ``fold_in(fold_in(fold_in(key, 0xC0DEC),
    round_id), gid)`` (fed/compress.py:239, :248) split over the leaves
    (:121)."""
    k = jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(key, 0xC0DEC), round_id), gid)
    return jax.random.split(k, max(n_leaves, 1))


def reference_codec_noise(key, round_id: int, gid: int, sizes):
    """The reference's noise of client ``gid`` at ``round_id``, one
    ``uniform`` a leaf, flattened in leaf order."""
    keys = reference_leaf_keys(key, round_id, gid, len(sizes))
    return np.concatenate([np.asarray(jax.random.uniform(kk, (s,)))
                           for kk, s in zip(keys, sizes)])


class ReferenceNoise:
    """The port's noise source filled from the reference's key chain, for
    leaves of ``sizes`` elements: ``(round_id, ids)`` gives the sync's
    ``(leaf, size) -> [C, size]``, row c from client ``ids[c]``'s key of
    that leaf."""

    def __init__(self, key, sizes):
        self.key, self.sizes = key, list(sizes)

    def __call__(self, round_id, ids):
        keys = [reference_leaf_keys(self.key, round_id, g, len(self.sizes))
                for g in ids.cpu().tolist()]

        def leaf(i, size):
            assert size == self.sizes[i], (i, size, self.sizes)
            rows = [np.asarray(jax.random.uniform(k[i], (size,)))
                    for k in keys]
            return torch.from_numpy(np.stack(rows)).to(ids.device)
        return leaf


class ReplaySampler(CohortSampler):
    """A port sampler that replays a reference sampler's cohorts."""

    def __init__(self, ref_sampler):
        self.ref, self.n, self.c = ref_sampler, ref_sampler.n, ref_sampler.c

    def cohort(self, round_id):
        return torch.from_numpy(np.asarray(self.ref.cohort(round_id),
                                           np.int64))


# ------------------------------------------------------------ chunks

# what reads the card back to the host (or waits for it) when its tensor
# lies on a CUDA device; boolean-mask indexing too (see NoHostRead)
_HOST_READS = {"item", "tolist", "__bool__", "__int__", "__float__",
               "__index__", "nonzero", "numpy", "cpu", "unique",
               "masked_select", "bincount", "repeat_interleave", "tensor",
               "as_tensor"}


class NoHostRead(TorchFunctionMode):
    """Raise on every operation that would read a CUDA tensor back to the
    host or wait for the card: ``.item()``, ``bool``/``int``/``float`` of
    a tensor, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``nonzero``,
    ``unique``, ``masked_select``, ``bincount``, ``repeat_interleave``
    without ``output_size``, boolean-mask indexing, and a tensor made from
    host data straight onto a ``device``. On the CPU it stands in for the
    card's ``torch.cuda.set_sync_debug_mode("error")``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        bad = name in _HOST_READS
        if name in ("tensor", "as_tensor"):
            bad = (not isinstance(args[0], torch.Tensor)
                   and kwargs.get("device") is not None)
        elif name == "repeat_interleave":
            bad = kwargs.get("output_size") is None
        elif name in ("__getitem__", "__setitem__") and len(args) > 1:
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            bad = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                      for i in idx)
        if bad:
            raise AssertionError(f"a host read inside a chunk: {name}")
        return func(*args, **kwargs)


@contextlib.contextmanager
def chunks_read_nothing(counter=None):
    """Every mega-scan chunk built in the block (``make_multi_round``, as
    the driver, the population builders, the trainer and the launcher
    import it) runs under :class:`NoHostRead`; ``counter`` (a list) gets
    one entry a chunk."""
    import repro_torch.fed.round as fround
    from repro_torch.fed import population, runtime
    from repro_torch.launch import train
    from repro_torch.tasks import driver
    real = fround.make_multi_round

    def make(round_fn):
        multi = real(round_fn)

        def run(*a, **k):
            with NoHostRead():
                out = multi(*a, **k)
            if counter is not None:
                counter.append(1)
            return out
        return run

    mods = (driver, population, runtime, train)
    for m in mods:
        m.make_multi_round = make
    try:
        yield
    finally:
        for m in mods:
            m.make_multi_round = real


# ------------------------------------------------------------ tests

def test_shim_lets_the_reference_import():
    from repro.core import adafbio  # noqa: F401
    from repro.tasks.driver import FedDriver  # noqa: F401


def test_interop_roundtrip_keeps_dtypes():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "t": np.int32(7),
            "nested": {"b": rng.standard_normal(4).astype(np.float32)}}
    got = from_reference(tree, CPU)
    assert got["w"].dtype == torch.float32 and got["t"].dtype == torch.int32
    back = to_numpy(got)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_interop_carries_bfloat16_bits():
    x = jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32)).astype(
        jnp.bfloat16)
    got = from_reference(np.asarray(x), CPU)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def test_no_host_read_flags_the_reads_it_names():
    x = torch.ones(3)
    with NoHostRead():
        torch.tensor([1, 2])                  # host data, host tensor
        torch.as_tensor(x, device="cpu")      # no copy
        x.repeat_interleave(2, output_size=6)
        x[torch.tensor([0, 2])]
        for read in (lambda: x[0].item(), lambda: bool(x[0]),
                     lambda: x.tolist(), lambda: x.nonzero(),
                     lambda: x[x > 0], lambda: x.cpu(),
                     lambda: torch.tensor(0.5, device="cpu")):
            with pytest.raises(AssertionError, match="host read"):
                read()


def test_reference_draws_match_reference_keys():
    """The draw helper reproduces the keys the reference driver uses."""
    key = jax.random.PRNGKey(3)
    d = reference_draws(key, 2, 5, 2, 4)
    kk = jax.random.fold_in(jax.random.fold_in(key, 1), 4 + 2)
    assert int(d.steps[4, 1]) == neumann_k(jax.random.split(kk)[0], 4)
    assert int(d.init[0]) == neumann_k(jax.random.split(key, 2)[0], 4)
