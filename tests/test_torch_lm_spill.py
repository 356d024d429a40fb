"""The train launcher's host-spill population mode (``--spill host``) on the
CPU, at the shape of the reference's ``tests/test_train_resume.py``:
reduced qwen1.5-4b in f32, ``FedConfig(q=2, neumann_k=2, lr_x=1e-2,
lr_y=1e-1)``, ``ShapeConfig("t", 16, 2)``, N 4, C 2, 8 steps.

The spilled runner's checkpoints equal the port's dense runner's (always
written in the single-file layout), for the codecs none, topk + EF and
int8 + EF, in the single-file and the 2-shard layouts, and across a
resume from dense to spilled and back; the bank built row by row on the
host equals the dense init. The dense runner is
held against the reference by ``tests/test_torch_lm_population.py``, and
the reference's own spilled run equals its dense one
(``test_spill_checkpoint_matches_dense``), so these close the chain
without compiling the reference here. Tolerance: none, bit for bit."""
import json

import numpy as np
import pytest
import torch

from test_torch_harness import CPU

from repro_torch import device as devlib
from repro_torch.configs import FedConfig, ShapeConfig, get_arch, reduced
from repro_torch.core.tree_util import tree_leaves
from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                        make_client_batch)
from repro_torch.fed.runtime import (FederatedTrainer, NeumannDraws,
                                     client_batch_specs)
from repro_torch.launch import train as train_cli

N, C, STEPS = 4, 2, 8


def _trainer(codec):
    cfg = reduced(get_arch("qwen1.5-4b"), dtype="float32")
    fed = FedConfig(q=2, neumann_k=2, lr_x=1e-2, lr_y=1e-1, codec=codec,
                    topk_frac=0.5)
    shape = ShapeConfig("t", 16, 2, "train")
    return cfg, fed, shape, FederatedTrainer(cfg, fed, shape, device=CPU)


def _run(path, codec="none", steps=STEPS, spill="none", shards=1,
         resume=False):
    """One population run of the launcher (``run_cli``, the f32 config in
    place of the CLI's); returns the run's dict and its checkpoint's
    arrays (either layout) and step."""
    args = train_cli.parse_args(
        ["--arch", "qwen1.5-4b", "--device", "cpu", "--steps", str(steps),
         "--q", "2", "--population", str(N), "--cohort", str(C), "--codec",
         codec, "--topk-frac", "0.5", "--eval-every", "100", "--spill",
         spill, "--ckpt", str(path), "--ckpt-shards", str(shards)]
        + (["--resume"] if resume else []))
    train_cli.check_ported(args)
    cfg, fed, shape, tr = _trainer(codec)
    return train_cli.run_cli(args, cfg, fed, shape, tr), _load(str(path))


def _load(path):
    meta = json.loads(open(path + ".json").read())
    data = dict(np.load(path + ".npz").items())
    for i in meta.get("sharded_leaves", []):
        data[f"leaf_{i}"] = np.concatenate(
            [np.load(f"{path}.shard{k}.npz")[f"leaf_{i}"]
             for k in range(meta["shards"])], axis=0)
    return data, meta


def _assert_same(got, want):
    (a, meta_a), (b, meta_b) = got, want
    assert meta_a["step"] == meta_b["step"]
    assert meta_a["treedef"] == meta_b["treedef"]
    assert sorted(a) == sorted(b)
    for k in sorted(a):
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """The dense runner's 8-step run of each codec, made once."""
    runs = {}

    def get(codec):
        if codec not in runs:
            path = tmp_path_factory.mktemp("dense") / codec
            runs[codec] = _run(path, codec)
        return runs[codec]
    return get


# every codec, and each layout (none in both)
@pytest.mark.parametrize("codec,shards", [("none", 1), ("none", 2),
                                          ("topk", 2), ("int8", 1)])
def test_spilled_checkpoint_equals_dense(tmp_path, dense, capsys, codec,
                                         shards):
    want_run, want = dense(codec)
    capsys.readouterr()
    run, got = _run(tmp_path / "spilled", codec, spill="host", shards=shards)
    _assert_same(got, want)
    assert got[1].get("shards", 1) == shards
    assert run["step"] == STEPS and run["bank"] is None
    assert (run["bytes_up"], run["bytes_down"], run["wire"]) == (
        want_run["bytes_up"], want_run["bytes_down"], want_run["wire"])
    assert np.isfinite(run["losses"]).all()
    assert (run["ef_spill"] is not None) == (codec != "none")
    out = capsys.readouterr().out
    nbytes = run["spill"].nbytes
    assert (f"spilled population mode: N={N} clients "
            f"({nbytes / 1e6:.1f}MB host bank), C={C} cohort/round") in out
    assert (f"wire totals ({codec}): bytes_up={run['bytes_up']} "
            f"bytes_down={run['bytes_down']}") in out
    assert "saved population checkpoint to" in out


@pytest.mark.parametrize("first,then,codec", [("none", "host", "int8"),
                                              ("host", "none", "topk")])
def test_resume_across_dense_and_spilled(tmp_path, dense, first, then,
                                         codec):
    """Half the run in one mode, the rest resumed in the other: the final
    checkpoint equals the uninterrupted dense run's. A spilled resume
    loads the checkpoint to the host."""
    path = tmp_path / "ck"
    _, (_, meta) = _run(path, codec, steps=STEPS // 2, spill=first)
    assert meta["step"] == STEPS // 2
    _, got = _run(path, codec, spill=then, resume=True)
    _assert_same(got, dense(codec)[1])


def test_row_by_row_init_equals_dense_init():
    """The bank built one client at a time into host memory, and the warm
    start taken leaf by leaf, equal ``init_population_states``."""
    cfg, fed, shape, tr = _trainer("int8")
    specs_c = client_batch_specs(cfg, shape, C, fed)
    specs_n = {k: type(v)((N,) + tuple(v.shape[1:]), v.dtype)
               for k, v in specs_c.items()}
    data = FederatedLMData(vocab=cfg.vocab, n_clients=N,
                           draws=TorchLMDraws(3, CPU))
    params = tr.init_params(devlib.generator(CPU, 3, train_cli.PARAM_SALT))
    batch0 = make_client_batch(data, cfg, specs_n, 0, CPU)
    k = NeumannDraws(3, fed.neumann_k, N, CPU).init()
    bank, last_sync, server = tr.init_population_states(params, batch0, k)
    spilled, ls, srv = tr.init_spilled_population_states(params, batch0, k)
    assert spilled.fresh.all() and spilled.base is None
    dense_l, host_l = tree_leaves(bank), tree_leaves(spilled.materialize())
    assert len(dense_l) == len(host_l)
    for a, b in zip(host_l, dense_l):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(ls, last_sync) and ls.device.type == "cpu"
    for a, b in zip(tree_leaves(srv), tree_leaves(server)):
        assert torch.equal(a, b)
    ef = tr.init_spilled_ef_bank(N)
    for a, b in zip(tree_leaves(ef.materialize()),
                    tree_leaves(tr.init_ef_bank(N))):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
