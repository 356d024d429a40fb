"""The port's train launcher (``python -m repro_torch.launch.train``) on the
CPU at ``reduced(qwen1.5-4b)``: two scan rounds write a checkpoint that the
port's serve launcher serves and the reference's bridge reads; a resumed
run equals an uninterrupted one; the eager engine and the int8 codec round
run; the population (codec none and int8), async and gossip modes run,
bill the bytes their pricing gives and resume equal to an uninterrupted
run, and the bridge serves a population checkpoint and refuses an async
one; the flags that need a later part of the port raise naming their
ROADMAP item, and ``--spill host`` refuses what the reference's refuses;
the README's flag table matches the argparse."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from test_torch_harness import to_torch  # noqa: F401  (shims jax first)

import jax  # noqa: E402

from repro.configs import get_arch as ref_arch, reduced as ref_reduced  # noqa: E402
from repro.serve import bridge as ref_bridge  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core.tree_util import tree_leaves  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.serve import bridge  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--arch", "qwen1.5-4b", "--reduced", "--device", "cpu", "--seq",
         "32", "--batch", "2", "--q", "2"]


def test_train_cli_checkpoint_is_served_and_read_by_the_reference(tmp_path):
    ck = str(tmp_path / "ck")
    run = train_cli.main(SMALL + ["--steps", "4", "--ckpt", ck,
                                  "--ckpt-shards", "2"])
    assert run["step"] == 4 and len(run["seconds"]) == 2
    assert all(np.isfinite(run["losses"]))
    params, info = bridge.load_serve_params(ck, reduced(get_arch(
        "qwen1.5-4b")), device="cpu")
    assert info == {"layout": "plain[adaptive=adam]", "clients": 1,
                    "step": 4}
    want = {"x": run["states"]["x"], "y": run["states"]["y"]}
    for a, b in zip(tree_leaves(params), tree_leaves(want)):
        assert torch.equal(a, b[0])
    ref_params, ref_info = ref_bridge.load_serve_params(
        ck, ref_reduced(ref_arch("qwen1.5-4b")))
    assert ref_info == info
    for a, b in zip(tree_leaves(params), jax.tree.leaves(ref_params)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    done = serve_cli.main(["--arch", "qwen1.5-4b", "--reduced", "--ckpt",
                           ck, "--device", "cpu", "--requests", "3",
                           "--max-len", "48"])
    assert sorted(c.rid for c in done) == [0, 1, 2]


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """The draws are functions of (seed, step): resuming from a checkpoint
    continues the same run."""
    ck = str(tmp_path / "ck")
    train_cli.main(SMALL + ["--steps", "2", "--ckpt", ck])
    resumed = train_cli.main(SMALL + ["--steps", "4", "--ckpt", ck,
                                      "--resume"])
    whole = train_cli.main(SMALL + ["--steps", "4"])
    assert resumed["step"] == whole["step"] == 4
    for a, b in zip(tree_leaves((resumed["states"], resumed["server"])),
                    tree_leaves((whole["states"], whole["server"]))):
        assert torch.equal(a, b)


def test_eager_engine_and_codec_round_run(tmp_path):
    eager = train_cli.main(SMALL + ["--steps", "3", "--engine", "eager",
                                    "--eval-every", "1"])
    assert len(eager["losses"]) == 3 and all(np.isfinite(eager["losses"]))
    assert int(eager["server"]["t"]) == 3 + 1
    ck = str(tmp_path / "ck8")
    int8 = train_cli.main(SMALL + ["--steps", "4", "--codec", "int8",
                                   "--ckpt", ck])
    assert int8["ef"] is not None and all(np.isfinite(int8["losses"]))
    _, info = bridge.load_serve_params(ck, reduced(get_arch("qwen1.5-4b")),
                                       codec="int8", device="cpu")
    assert info["layout"] == "plain+ef[adaptive=adam]"
    with pytest.raises(SystemExit, match="engine scan"):
        train_cli.main(SMALL + ["--codec", "int8", "--engine", "eager"])


# the population modes: (flags, the run's state keys compared on resume)
MODES = {
    "population": (["--population", "4", "--cohort", "2"],
                   ("bank", "last_sync", "server")),
    "population-int8": (["--population", "4", "--cohort", "2", "--codec",
                         "int8"], ("bank", "last_sync", "ef", "server")),
    "async": (["--population", "4", "--cohort", "2", "--max-staleness", "2",
               "--delay-model", "tiers", "--tiers", "0.5:1:1,0.5:2:3"],
              ("state",)),
    "gossip": (["--population", "4", "--engine", "gossip", "--topology",
                "complete", "--codec", "int8"], ("bank", "srv_bank", "ef"))}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_population_modes_run_and_resume(mode, tmp_path, capsys):
    """Each mode runs 2 rounds of q = 2, prints its wire totals (equal to
    the run's message and downlink prices times the messages it billed),
    and a run resumed from its checkpoint after round 0 ends equal, bit
    for bit, to an uninterrupted one: the draws are functions of the seed,
    the round and the global client id."""
    flags, keys = MODES[mode]
    ck = str(tmp_path / "ck")
    train_cli.main(SMALL + flags + ["--steps", "2", "--ckpt", ck])
    resumed = train_cli.main(SMALL + flags + ["--steps", "4", "--ckpt", ck,
                                              "--resume"])
    whole = train_cli.main(SMALL + flags + ["--steps", "4"])
    out = capsys.readouterr().out
    assert resumed["step"] == whole["step"] == 4
    assert f"wire totals ({'int8' if 'int8' in flags else 'none'}): " \
        f"bytes_up={whole['bytes_up']} bytes_down={whole['bytes_down']}" \
        in out
    assert all(np.isfinite(whole["losses"]))
    msg_b, down_b = whole["wire"]
    if mode.startswith("population"):
        # two rounds, two distinct clients a cohort, broadcast to all 4
        assert (whole["bytes_up"], whole["bytes_down"]) == (
            2 * 2 * msg_b, 2 * 4 * down_b)
    elif mode == "gossip":
        # one mix (round 1's, closing round 0) over 12 directed edges
        assert whole["bytes_up"] == whole["bytes_down"] == 12 * msg_b
    else:
        log = whole["log"]
        assert whole["bytes_up"] == sum(r["arrived"] for r in log) * msg_b
        assert whole["bytes_down"] == sum(r["synced"] for r in log) * down_b
        assert "accepted-staleness histogram (rounds):" in out
        assert "tier 0 (delay 1..1, 2 clients)" in out
    for key in keys:
        for a, b in zip(tree_leaves(resumed[key]), tree_leaves(whole[key])):
            assert torch.equal(a, b), (mode, key)


def test_bridge_serves_population_checkpoints_and_refuses_async(tmp_path):
    """The bridge reads a population checkpoint (with and without the EF
    bank) as its bank's client mean, and refuses an async one, as the
    reference's does."""
    cfg = reduced(get_arch("qwen1.5-4b"))
    for mode, codec, layout in (("population", "none", "population"),
                                ("population-int8", "int8",
                                 "population+ef")):
        ck = str(tmp_path / mode)
        run = train_cli.main(SMALL + MODES[mode][0] + ["--steps", "2",
                                                       "--ckpt", ck])
        params, info = bridge.load_serve_params(ck, cfg, codec=codec,
                                                device="cpu")
        assert info == {"layout": f"{layout}[adaptive=adam]", "clients": 4,
                        "step": 2}
        for a, b in zip(tree_leaves(params), tree_leaves(
                {"x": run["bank"]["x"], "y": run["bank"]["y"]})):
            assert torch.equal(a, b.mean(dim=0))
    ck = str(tmp_path / "async")
    train_cli.main(SMALL + MODES["async"][0] + ["--steps", "2", "--ckpt",
                                                ck])
    with pytest.raises(ValueError, match="async-engine checkpoints are not "
                                         "servable"):
        bridge.load_serve_params(ck, cfg, device="cpu")


@pytest.mark.parametrize("flags,item", [
    (["--mesh", "local"], "1f"), (["--rounds-per-scan", "2"], "2a"),
    (["--metrics-out", "m.jsonl"], "2b"), (["--profile", "p"], "2b")])
def test_unported_flags_name_their_roadmap_item(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        train_cli.main(SMALL + flags)


@pytest.mark.parametrize("flags,why", [
    ([], "run with --population N"),
    (["--population", "4", "--engine", "gossip"], "device-resident"),
    (["--population", "4", "--cohort", "2", "--max-staleness", "2"],
     "async pending buffer"),
    (["--population", "4", "--rounds-per-scan", "2"], "mega-scan tier")])
def test_spill_refusals_are_the_references(flags, why):
    """``--spill host`` refuses what the reference's launcher refuses,
    with a ``SystemExit``: no population, gossip, async rounds, more than
    one round a scan."""
    with pytest.raises(SystemExit, match=why):
        train_cli.main(SMALL + ["--spill", "host"] + flags)


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen1.5-4b", "--reduced", "--steps", "2"])


def test_train_cli_flag_table_matches_argparse():
    """The README's flag table of ``python -m repro_torch.launch.train``
    and the launcher's argparse, in both directions (the reference's
    ``scripts/check_docs.py`` readers, applied to the port's CLI)."""
    spec = importlib.util.spec_from_file_location(
        "check_docs", ROOT / "scripts" / "check_docs.py")
    docs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(docs)
    in_src = docs.source_flags(ROOT / "src/repro_torch/launch/train.py")
    in_doc = docs.readme_sections(ROOT / "README.md")[
        "### `python -m repro_torch.launch.train`"]
    assert in_src and in_src == in_doc, (sorted(in_src - in_doc),
                                         sorted(in_doc - in_src))
    # the reference's flags, and the port's --device
    ref = docs.source_flags(ROOT / "src/repro/launch/train.py")
    assert in_src == ref | {"--device"}
