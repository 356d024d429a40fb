"""Training launcher of the port: AdaFBiO (or a baseline) on an
architecture, the plain all-clients path (``src/repro/launch/train.py``
``run_cli`` without a population).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --reduced --steps 8 --q 4 --engine scan --ckpt build/ck

runs on the CUDA card (``--device cpu`` runs the plain PyTorch paths on the
CPU, for a ``--reduced`` model). Without a mesh the trainer has one client.
``--engine eager`` calls the local step once a step and syncs before each
step ``t > 0`` with ``t % q == 0``; ``--engine scan`` runs whole rounds, q
local steps and the sync. ``--ckpt`` writes the state at the end (and
``--resume`` continues from it), in the JAX package's files; ``--codec
int8/topk`` runs the codec round (scan engine). The random draws (params,
data, Neumann depths, the int8 codec's noise) derive from ``--seed``.

The flags are the JAX launcher's. Those that need a part of the port still
to come keep the reference's default and raise ``NotImplementedError``
naming the ROADMAP item when set: ``--mesh`` (1f), ``--population`` and
the cohort, sampler, async and gossip knobs with ``--engine gossip`` (1g),
``--rounds-per-scan`` above 1 (2a), ``--metrics-out``, ``--metrics-every``
and ``--profile`` (2b), ``--spill`` (2c).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as devlib
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import FedConfig, get_arch, reduced
from repro_torch.configs.base import DELAY_MODELS, TOPOLOGIES, ShapeConfig
from repro_torch.core.tree_util import tree_index, tree_stack
from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                        make_client_batch)
from repro_torch.fed.compress import CodecNoise, message_elements
from repro_torch.fed.round import ENGINES
from repro_torch.fed.runtime import (FederatedTrainer, NeumannDraws,
                                     client_batch_specs)
from repro_torch.fed.sampling import SAMPLERS

# seed salt of the parameter draw (the reference's fold_in(key, 0x9142A))
PARAM_SALT = 0x9142A
_POPULATION = "1g (the LM trainer's population, async and gossip rounds)"
# flags of the reference that need a later part of the port: (attribute,
# the reference's default, ROADMAP item)
NOT_PORTED = (
    ("mesh", "none", "1f (sharding.py, launch/mesh.py)"),
    ("spill", "none", "2c (fed/spill.py, the host-spill bank)"),
    ("population", 0, _POPULATION),
    ("cohort", 8, _POPULATION),
    ("sampler", "uniform", _POPULATION),
    ("topology", "ring", _POPULATION),
    ("er_p", 0.4, _POPULATION),
    ("time_varying", False, _POPULATION),
    ("topology_seed", 0, _POPULATION),
    ("trace_file", None, _POPULATION),
    ("max_staleness", 0.0, _POPULATION),
    ("max_delay", 1, _POPULATION),
    ("delay_eta", 0.0, _POPULATION),
    ("delay_model", "uniform", _POPULATION),
    ("tiers", None, _POPULATION),
    ("delay_mu", 0.0, _POPULATION),
    ("delay_sigma", 0.5, _POPULATION),
    ("metrics_out", None, "2b (obs/, telemetry)"),
    ("metrics_every", 8, "2b (obs/, telemetry)"),
    ("profile", None, "2b (obs/, telemetry)"),
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--algorithm", default="adafbio")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size variant of the same family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--neumann-k", type=int, default=2)
    ap.add_argument("--mesh", default="none", choices=["none", "local", "prod",
                                                       "prod-multi"],
                    help="not ported (raises unless none): ROADMAP 1f")
    ap.add_argument("--seed", type=int, default=0,
                    help="run seed (params, data, Neumann depths and codec "
                         "noise all derive from it)")
    ap.add_argument("--spill", default="none", choices=["none", "host"],
                    help="not ported (raises unless none): ROADMAP 2c")
    ap.add_argument("--ckpt", default=None,
                    help="write the training state here at the end (the "
                         "JAX package's .npz/.json files)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --ckpt")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--engine", default="scan", choices=list(ENGINES),
                    help="scan: each round, q local steps and the sync, as "
                         "one call; eager: one call a local step; gossip "
                         "is not ported for the LM (ROADMAP 1g)")
    ap.add_argument("--rounds-per-scan", type=int, default=1,
                    help="not ported above 1 (raises): ROADMAP 2a")
    ap.add_argument("--population", type=int, default=0,
                    help="not ported (raises unless 0): ROADMAP 1g")
    ap.add_argument("--cohort", type=int, default=8,
                    help="population mode only (ROADMAP 1g)")
    ap.add_argument("--sampler", default="uniform", choices=list(SAMPLERS),
                    help="population mode only (ROADMAP 1g)")
    ap.add_argument("--topology", default="ring", choices=list(TOPOLOGIES),
                    help="gossip engine only (ROADMAP 1g)")
    ap.add_argument("--er-p", type=float, default=0.4,
                    help="gossip engine only (ROADMAP 1g)")
    ap.add_argument("--time-varying", action="store_true",
                    help="gossip engine only (ROADMAP 1g)")
    ap.add_argument("--topology-seed", type=int, default=0,
                    help="gossip engine only (ROADMAP 1g)")
    ap.add_argument("--ckpt-shards", type=int, default=1,
                    help="split bank-sized checkpoint leaves over K "
                         "<path>.shard{k}.npz files (row-contiguous); 1 = "
                         "the single-file layout. Sharded and dense runs "
                         "resume from each other's files")
    ap.add_argument("--trace-file", default=None,
                    help="population mode only (ROADMAP 1g)")
    ap.add_argument("--max-staleness", type=float, default=0.0,
                    help="async rounds, not ported (raises unless 0): "
                         "ROADMAP 1g")
    ap.add_argument("--max-delay", type=int, default=1,
                    help="async rounds only (ROADMAP 1g)")
    ap.add_argument("--delay-eta", type=float, default=0.0,
                    help="async rounds only (ROADMAP 1g)")
    ap.add_argument("--delay-model", default="uniform",
                    choices=list(DELAY_MODELS),
                    help="async rounds only (ROADMAP 1g)")
    ap.add_argument("--tiers", default=None,
                    help="async rounds only (ROADMAP 1g)")
    ap.add_argument("--delay-mu", type=float, default=0.0,
                    help="async rounds only (ROADMAP 1g)")
    ap.add_argument("--delay-sigma", type=float, default=0.5,
                    help="async rounds only (ROADMAP 1g)")
    ap.add_argument("--codec", default="none",
                    choices=["none", "int8", "topk"],
                    help="client→server update codec (scan engine): none "
                         "(full precision), int8 (stochastic uniform "
                         "quantization), topk (magnitude sparsification "
                         "with error feedback)")
    ap.add_argument("--codec-bits", type=int, default=8,
                    help="int8 codec quantization bit width (2..8)")
    ap.add_argument("--topk-frac", type=float, default=0.1,
                    help="topk codec: fraction of each tensor's entries "
                         "transmitted")
    ap.add_argument("--ef", default="on", choices=["on", "off"],
                    help="error feedback: carry per-client compression "
                         "residuals into the next transmission")
    ap.add_argument("--metrics-out", default=None,
                    help="not ported (raises): ROADMAP 2b")
    ap.add_argument("--metrics-every", type=int, default=8,
                    help="with --metrics-out only (ROADMAP 2b)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="not ported (raises): ROADMAP 2b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for a flag set away from the
    reference's default that needs a part of the port still to come."""
    for attr, default, item in NOT_PORTED:
        if getattr(args, attr) != default:
            flag = "--" + attr.replace("_", "-")
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP "
                                      f"item {item}")
    if args.engine == "gossip":
        raise NotImplementedError(f"--engine gossip is not ported yet for "
                                  f"the LM: ROADMAP item {_POPULATION}")
    if args.rounds_per_scan < 1:
        raise SystemExit("--rounds-per-scan must be >= 1")
    if args.rounds_per_scan > 1:
        raise NotImplementedError("--rounds-per-scan > 1 is not ported yet: "
                                  "ROADMAP item 2a (mega-scan)")


def progress_line(*, loss: float, elapsed: float, step: int, round=None,
                  round_seconds=None) -> str:
    """The reference's progress line (``repro/obs/progress.py``) for the
    plain path: ``step N`` for eager, ``round R (step N)`` with the round's
    time for scan."""
    segs = [f"step {step:5d}" if round is None
            else f"round {round:4d} (step {step:5d})",
            f"f(x̄,ȳ) = {loss:.4f}"]
    if round_seconds is not None:
        segs.append(f"round={round_seconds*1e3:.1f}ms")
    segs.append(f"({elapsed:.1f}s)")
    return "  ".join(segs)


def server_step(s: int, q: int) -> int:
    """The server counter at local step ``s``: one tick a local step and
    one a sync, q steps to a sync."""
    return s + s // q


def main(argv=None):
    args = parse_args(argv)
    check_ported(args)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    fed = FedConfig(q=args.q, neumann_k=args.neumann_k, lr_x=1e-2, lr_y=1e-1,
                    codec=args.codec, codec_bits=args.codec_bits,
                    topk_frac=args.topk_frac,
                    error_feedback=args.ef == "on")
    if args.codec != "none" and args.engine != "scan":
        raise SystemExit("--codec int8/topk rides the round programs: run "
                         "the plain --engine scan path (per-client EF rides "
                         "the round)")
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    dev = devlib.resolve(args.device)
    tr = FederatedTrainer(cfg, fed, shape, algorithm=args.algorithm,
                          device=dev)
    return run_cli(args, cfg, fed, shape, tr)


def run_cli(args, cfg, fed, shape, tr: FederatedTrainer):
    """The plain path: init (or resume), the eager or scan loop, the
    checkpoint. Returns the run's final state, step, losses and steady
    round (scan) or step (eager) seconds."""
    dev = tr.device
    specs = client_batch_specs(cfg, shape, tr.m, fed)
    data = FederatedLMData(vocab=cfg.vocab, n_clients=tr.m,
                           draws=TorchLMDraws(args.seed, dev))
    depths = NeumannDraws(args.seed, fed.neumann_k, tr.m, dev)

    def batch_of(t):
        return make_client_batch(data, cfg, specs, t, dev)

    params = tr.init_params(devlib.generator(dev, args.seed, PARAM_SALT))
    states, server = tr.init_states(params, batch_of(0), depths.init())
    del params
    # the scan round's codec leg takes ref == states at every round
    # boundary (each round ends by broadcasting the new global state), so
    # only the EF residual is carried and checkpointed
    lossy = tr.codec.lossy
    ef = tr.init_ef_bank(tr.m) if lossy else None
    start = 0
    if args.resume and args.ckpt:
        tmpl = (states, server, ef) if ef is not None else (states, server)
        loaded, start = load_checkpoint(args.ckpt, tmpl)
        if ef is not None:
            states, server, ef = loaded
        else:
            states, server = loaded
        print(f"resumed from step {start}")

    ev = tr.eval_fn()
    losses, seconds = [], []
    t0 = time.time()
    steps_done = args.steps
    q = fed.q
    if args.engine == "scan":
        n_rounds = max((args.steps - start) // q, 1)
        steps_done = start + n_rounds * q
        if steps_done != args.steps:
            print(f"engine=scan runs whole rounds: {steps_done - start} steps "
                  f"instead of the requested {args.steps - start} "
                  f"(use --steps divisible by q={q})", flush=True)
        round0 = start // q
        round_fn = tr.round_step_codec_fn() if lossy else tr.round_step_fn()
        noise = CodecNoise(args.seed, dev)
        ids = torch.arange(tr.m, device=dev)
        for r in range(n_rounds):
            t = start + r * q
            batch_q = tree_stack([batch_of(t + j) for j in range(q)])
            k_q = torch.stack([depths.step(server_step(t + j, q))
                               for j in range(q)])
            r0 = time.time()
            if lossy:
                u = (noise(round0 + r, ids, message_elements(states))
                     if tr.codec.name == "int8" else None)
                states, server, _, ef = round_fn(states, server, states, ef,
                                                 batch_q, k_q, u)
            else:
                states, server = round_fn(states, server, batch_q, k_q)
            devlib.fence(dev)
            dt = time.time() - r0
            seconds.append(dt)
            if r % max(args.eval_every // q, 1) == 0 or r == n_rounds - 1:
                loss = float(ev(states, tree_index(batch_q, q - 1)))
                losses.append(loss)
                print(progress_line(loss=loss, elapsed=time.time() - t0,
                                    step=t + q - 1, round=r,
                                    round_seconds=dt), flush=True)
    else:
        local, sync = tr.local_step_fn(), tr.sync_step_fn()
        for t in range(start, args.steps):
            r0 = time.time()
            if t > 0 and t % q == 0:
                states, server = sync(states, server)
            batch = batch_of(t)
            states, server = local(states, server, batch,
                                   depths.step(server_step(t, q)))
            devlib.fence(dev)
            seconds.append(time.time() - r0)
            if t % args.eval_every == 0 or t == args.steps - 1:
                loss = float(ev(states, batch))
                losses.append(loss)
                print(progress_line(loss=loss, elapsed=time.time() - t0,
                                    step=t), flush=True)
    if args.ckpt:
        state = (states, server, ef) if ef is not None else (states, server)
        save_checkpoint(args.ckpt, state, steps_done,
                        shards=args.ckpt_shards)
        print(f"saved checkpoint to {args.ckpt} at step {steps_done}")
    return {"states": states, "server": server, "ef": ef,
            "step": steps_done, "losses": losses, "seconds": seconds}


if __name__ == "__main__":
    main()
