"""Training launcher of the port: AdaFBiO (or a baseline) on an
architecture (``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --reduced --steps 8 --q 4 --engine scan --ckpt build/ck

runs on the CUDA card (``--device cpu`` runs the plain PyTorch paths on the
CPU, for a ``--reduced`` model). Four modes, as the reference's:

  plain        one client (no mesh). ``--engine eager`` calls the local
               step once a step and syncs before each step ``t > 0`` with
               ``t % q == 0``; ``--engine scan`` runs whole rounds, q local
               steps and the sync; ``--codec int8/topk`` runs the codec
               round (scan engine).
  population   ``--population N --cohort C``: N client states in a bank, a
               ``--sampler`` cohort of C stepped a round, the broadcast
               sync, the codec's EF residuals in a bank.
  async        ``--max-staleness`` above 0: overlapping cohorts, delayed
               arrivals (``--delay-model``, ``--max-delay``, ``--tiers``,
               ``--trace-file``), the staleness gate and delay-adaptive
               steps; ends with the staleness histogram (by tier).
  gossip       ``--engine gossip --population N``: no server, every node
               steps and mixes over ``--topology``.

Each prints the reference's progress lines and, but for the plain mode,
``wire totals (codec): bytes_up=... bytes_down=...``. ``--ckpt`` writes
the state at the end (``--resume`` continues from it) in the JAX package's
files and layouts. The random draws (params, data, cohorts, Neumann
depths, the int8 codec's noise, the delays) derive from ``--seed``, as
functions of the round and the global client id, so a resumed run equals
an uninterrupted one.

The flags are the JAX launcher's. Those that need a part of the port still
to come keep the reference's default and raise ``NotImplementedError``
naming the ROADMAP item when set: ``--mesh`` (1f), ``--rounds-per-scan``
above 1 (2a), ``--metrics-out``, ``--metrics-every`` and ``--profile``
(2b), ``--spill`` (2c).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as devlib
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import FedConfig, get_arch, reduced
from repro_torch.configs.base import DELAY_MODELS, TOPOLOGIES, ShapeConfig
from repro_torch.core.tree_util import tree_index, tree_map, tree_stack
from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                        make_client_batch, make_cohort_batch)
from repro_torch.fed import compress
from repro_torch.fed.population import (DelayDraws, accum_staleness_hist,
                                        accum_tier_hists, make_delay_model,
                                        parse_tier_spec)
from repro_torch.fed.round import ENGINES
from repro_torch.fed.runtime import (FederatedTrainer, NeumannDraws,
                                     client_batch_specs, round_depths)
from repro_torch.fed.sampling import SAMPLERS, load_delay_trace, make_sampler

# seed salts of the parameter draw (the reference's fold_in(key, 0x9142A))
# and of the cohort sampler (its fold_in(key, 23))
PARAM_SALT = 0x9142A
SAMPLER_SALT = 23
# flags of the reference that need a later part of the port: (attribute,
# the reference's default, ROADMAP item)
NOT_PORTED = (
    ("mesh", "none", "1f (sharding.py, launch/mesh.py)"),
    ("spill", "none", "2c (fed/spill.py, the host-spill bank)"),
    ("metrics_out", None, "2b (obs/, telemetry)"),
    ("metrics_every", 8, "2b (obs/, telemetry)"),
    ("profile", None, "2b (obs/, telemetry)"),
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="architecture id (repro_torch.configs."
                         "list_arch_ids(): whisper-tiny, zamba2-1.2b, "
                         "qwen2.5-14b, internvl2-76b, qwen3-moe-30b-a3b, "
                         "falcon-mamba-7b, deepseek-67b, granite-20b, "
                         "llama4-scout-17b-a16e, qwen1.5-4b)")
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
                         "one call; eager: one call a local step; gossip: "
                         "decentralized rounds over --topology (needs "
                         "--population N)")
    ap.add_argument("--rounds-per-scan", type=int, default=1,
                    help="not ported above 1 (raises): ROADMAP 2a")
    ap.add_argument("--population", type=int, default=0,
                    help="client population size N: keep N persistent "
                         "client states and step a sampled cohort a round "
                         "(0 = the plain one-client path)")
    ap.add_argument("--cohort", type=int, default=8,
                    help="per-round cohort size C (population mode)")
    ap.add_argument("--sampler", default="uniform", choices=list(SAMPLERS),
                    help="cohort sampling policy (population mode)")
    ap.add_argument("--topology", default="ring", choices=list(TOPOLOGIES),
                    help="gossip graph (--engine gossip): ring, torus2d, "
                         "complete or erdos, Metropolis-weighted")
    ap.add_argument("--er-p", type=float, default=0.4,
                    help="erdos topology edge probability")
    ap.add_argument("--time-varying", action="store_true",
                    help="redraw the erdos gossip graph every round")
    ap.add_argument("--topology-seed", type=int, default=0,
                    help="seed of the erdos graph draw")
    ap.add_argument("--ckpt-shards", type=int, default=1,
                    help="split bank-sized checkpoint leaves over K "
                         "<path>.shard{k}.npz files (row-contiguous); 1 = "
                         "the single-file layout. Sharded and dense runs "
                         "resume from each other's files")
    ap.add_argument("--trace-file", default=None,
                    help="JSONL availability trace (the trace-file sampler, "
                         "the trace delay model)")
    ap.add_argument("--max-staleness", type=float, default=0.0,
                    help="0 = synchronous rounds; > 0 runs asynchronous "
                         "rounds and drops arrivals staler than this many "
                         "rounds (inf = no gate)")
    ap.add_argument("--max-delay", type=int, default=1,
                    help="async dispatch delay, uniform over [1, max-delay] "
                         "rounds")
    ap.add_argument("--delay-eta", type=float, default=0.0,
                    help="delay-adaptive server step: scale the model's "
                         "move by 1/(1 + delay_eta*(mean_staleness - 1))")
    ap.add_argument("--delay-model", default="uniform",
                    choices=list(DELAY_MODELS),
                    help="async per-client delay model: uniform, tiers, "
                         "lognormal or trace")
    ap.add_argument("--tiers", default=None,
                    help="tiers delay model spec frac:lo:hi[,...], e.g. "
                         "0.2:1:1,0.6:2:4,0.2:4:8")
    ap.add_argument("--delay-mu", type=float, default=0.0,
                    help="lognormal delay model: log-latency location")
    ap.add_argument("--delay-sigma", type=float, default=0.5,
                    help="lognormal delay model: log-latency scale")
    ap.add_argument("--codec", default="none",
                    choices=["none", "int8", "topk"],
                    help="client→server update codec (population modes, "
                         "or the scan engine): none (full precision), int8 "
                         "(stochastic uniform "
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
    if args.rounds_per_scan < 1:
        raise SystemExit("--rounds-per-scan must be >= 1")
    if args.rounds_per_scan > 1:
        raise NotImplementedError("--rounds-per-scan > 1 is not ported yet: "
                                  "ROADMAP item 2a (mega-scan)")


def progress_line(*, loss: float, elapsed: float, step: int, round=None,
                  round_seconds=None, bytes_up=None, bytes_down=None,
                  cohort=None, arrived=None, dropped=None,
                  mean_staleness=None, eta_scale=None) -> str:
    """The reference's progress line (``repro/obs/progress.py``): ``step
    N`` for eager, ``round R (step N)`` with the round's time for the
    round engines; ``arrived`` &c. add the async segment, ``bytes_up`` /
    ``bytes_down`` the wire segment, ``cohort`` its first 8 ids."""
    segs = [f"step {step:5d}" if round is None
            else f"round {round:4d} (step {step:5d})",
            f"f(x̄,ȳ) = {loss:.4f}"]
    if round_seconds is not None:
        segs.append(f"round={round_seconds*1e3:.1f}ms")
    if arrived is not None:
        segs.append(f"arrived={int(arrived)} dropped={int(dropped)} "
                    f"tau={float(mean_staleness):.2f} "
                    f"eta_scale={float(eta_scale):.3f}")
    if bytes_up is not None:
        segs.append(f"up={bytes_up/1e6:.2f}MB down={bytes_down/1e6:.2f}MB")
    if cohort is not None:
        segs.append(f"cohort={list(cohort[:8])}...")
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
    if args.codec != "none" and not args.population and args.engine != "scan":
        raise SystemExit("--codec int8/topk rides the fused round programs: "
                         "run with --population N (EF residuals live in "
                         "the bank) or the plain --engine scan path "
                         "(per-client EF rides the round carry, "
                         "docs/compression.md)")
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    dev = devlib.resolve(args.device)
    tr = FederatedTrainer(cfg, fed, shape, algorithm=args.algorithm,
                          device=dev)
    return run_cli(args, cfg, fed, shape, tr)


def run_cli(args, cfg, fed, shape, tr: FederatedTrainer):
    """Dispatch to the gossip, population (sync or async) or plain path.
    The plain path: init (or resume), the eager or scan loop, the
    checkpoint. Returns the run's final state, step, losses and steady
    round (scan) or step (eager) seconds."""
    if args.engine == "gossip":
        if not args.population:
            raise SystemExit("--engine gossip is decentralized over a "
                             "population bank: run with --population N "
                             "(full participation, docs/topology.md)")
        if args.max_staleness != 0:
            raise SystemExit("--engine gossip runs synchronous lockstep "
                             "rounds: set --max-staleness 0")
        return run_gossip(args, cfg, fed, shape, tr)
    if args.population:
        return run_population(args, cfg, fed, shape, tr)
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
        noise = compress.CodecNoise(args.seed, dev)
        ids = torch.arange(tr.m, device=dev)
        for r in range(n_rounds):
            t = start + r * q
            batch_q = tree_stack([batch_of(t + j) for j in range(q)])
            k_q = torch.stack([depths.step(server_step(t + j, q))
                               for j in range(q)])
            r0 = time.time()
            if lossy:
                u = (noise(round0 + r, ids) if tr.codec.name == "int8"
                     else None)
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


# ------------------------------------------------------------ population

def wire_costs(tr: FederatedTrainer, n: int):
    """(uplink bytes per client->server message, downlink bytes per
    receiving client) for one client state of this trainer, from the
    shapes alone (:func:`repro_torch.fed.compress.wire_costs`)."""
    meta = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"),
                    tr.abstract_population_states(n))
    return compress.wire_costs(tr.codec, meta)


def make_cli_delay_model(args, n: int):
    """The DelayModel the CLI delay flags describe (loads the per-client
    delay table from --trace-file for --delay-model trace)."""
    tier_fracs = tier_delays = None
    if args.tiers is not None:
        if args.delay_model != "tiers":
            raise SystemExit("--tiers only applies to --delay-model tiers "
                             f"(got --delay-model {args.delay_model})")
        tier_fracs, tier_delays = parse_tier_spec(args.tiers)
    table = None
    if args.delay_model == "trace":
        if not args.trace_file:
            raise SystemExit("--delay-model trace replays the trace file's "
                             "per-client 'delay' field: pass --trace-file "
                             "(format: docs/async.md)")
        table = load_delay_trace(args.trace_file, n)
    return make_delay_model(args.delay_model, args.max_delay,
                            tier_fracs=tier_fracs, tier_delays=tier_delays,
                            mu=args.delay_mu, sigma=args.delay_sigma,
                            table=table)


def _bank_setup(args, cfg, fed, shape, tr: FederatedTrainer, n: int,
                c: int):
    """What every population and gossip run starts from: the cohort's and
    the bank's batch specs, the data, the depth source of the n clients,
    the params and the bank's init batch."""
    dev = tr.device
    specs_c = client_batch_specs(cfg, shape, c, fed)
    specs_n = {k: type(v)((n,) + tuple(v.shape[1:]), v.dtype)
               for k, v in specs_c.items()}
    data = FederatedLMData(vocab=cfg.vocab, n_clients=n,
                           draws=TorchLMDraws(args.seed, dev))
    depths = NeumannDraws(args.seed, fed.neumann_k, n, dev)
    params = tr.init_params(devlib.generator(dev, args.seed, PARAM_SALT))
    batch0 = make_client_batch(data, cfg, specs_n, 0, dev)
    return specs_c, specs_n, data, depths, params, batch0


def _rounds(args, q: int, start: int, mode: str):
    start_round = start // q
    n_rounds = max(args.steps // q, start_round + 1)
    if n_rounds * q != args.steps:
        print(f"{mode} mode runs whole rounds: {n_rounds * q} steps "
              f"instead of the requested {args.steps} "
              f"(use --steps divisible by q={q})", flush=True)
    return start_round, n_rounds


def run_population(args, cfg, fed, shape, tr: FederatedTrainer):
    """Population mode: N persistent client states, a sampled cohort of C
    stepped a round (gather, q local steps, the broadcast sync), only the
    cohort's batches built. ``--max-staleness`` above 0 runs the async
    rounds (:func:`run_population_async`)."""
    n, c = args.population, args.cohort
    dev = tr.device
    sampler = make_sampler(args.sampler, n, c,
                           devlib.mix_seed(args.seed, SAMPLER_SALT),
                           trace_file=args.trace_file)
    if args.max_staleness != 0:
        return run_population_async(args, cfg, fed, shape, tr, sampler)
    if args.delay_model != "uniform" or args.tiers is not None:
        raise SystemExit("--delay-model / --tiers are async knobs: set "
                         "--max-staleness != 0 to enable asynchronous "
                         "execution")
    specs_c, _, data, depths, params, batch0 = _bank_setup(
        args, cfg, fed, shape, tr, n, c)
    bank, last_sync, server = tr.init_population_states(params, batch0,
                                                        depths.init())
    del params, batch0
    lossy = tr.codec.lossy
    ef = tr.init_ef_bank(n)          # None unless the codec keeps EF state
    start = 0
    if args.resume and args.ckpt:
        tmpl = (bank, last_sync, ef, server) if lossy else (bank, last_sync,
                                                            server)
        loaded, start = load_checkpoint(args.ckpt, tmpl)
        if lossy:
            bank, last_sync, ef, server = loaded
        else:
            bank, last_sync, server = loaded
        print(f"resumed population run from step {start}")
    round_fn = tr.population_round_fn(n)
    ev = tr.eval_fn()
    noise = compress.CodecNoise(args.seed, dev)
    msg_b, down_b = wire_costs(tr, n)
    bytes_up = bytes_down = 0
    q = fed.q
    start_round, n_rounds = _rounds(args, q, start, "population")
    print(f"population mode: N={n} clients, C={c} cohort/round "
          f"({args.sampler} sampler), rounds {start_round}..{n_rounds - 1} "
          f"of q={q}", flush=True)
    eval_rounds = max(args.eval_every // q, 1)
    losses, seconds = [], []
    t0 = time.time()
    for r in range(start_round, n_rounds):
        t = r * q
        ids_host = sampler.cohort(r)
        ids = devlib.to_device(ids_host, dev)
        batch_q = tree_stack([make_cohort_batch(data, cfg, specs_c, t + j,
                                                ids_host, dev)
                              for j in range(q)])
        k_q = round_depths(depths, r, q, ids)
        r0 = time.time()
        if lossy:
            u = noise(r, ids) if tr.codec.name == "int8" else None
            bank, last_sync, ef, server = round_fn(
                bank, last_sync, ef, server, ids, batch_q, k_q, r, u)
        else:
            bank, last_sync, server = round_fn(bank, last_sync, server, ids,
                                               batch_q, k_q, r)
        devlib.fence(dev)
        dt = time.time() - r0
        seconds.append(dt)
        # each UNIQUE cohort member uploads one codec message (a duplicate
        # id fills two aggregation slots, one client shipped one message);
        # every bank row downloads the broadcast
        bytes_up += int(np.unique(np.asarray(ids_host)).size) * msg_b
        bytes_down += n * down_b
        if r % eval_rounds == 0 or r == n_rounds - 1:
            loss = float(ev(bank, tree_index(batch_q, q - 1)))
            losses.append(loss)
            print(progress_line(loss=loss, elapsed=time.time() - t0,
                                step=t + q - 1, round=r, round_seconds=dt,
                                bytes_up=bytes_up, bytes_down=bytes_down,
                                cohort=np.asarray(ids_host).tolist()),
                  flush=True)
    print(f"wire totals ({tr.codec.name}): bytes_up={bytes_up} "
          f"bytes_down={bytes_down}", flush=True)
    if args.ckpt:
        state = (bank, last_sync, ef, server) if lossy else (bank, last_sync,
                                                             server)
        save_checkpoint(args.ckpt, state, n_rounds * q,
                        shards=args.ckpt_shards)
        print(f"saved population checkpoint to {args.ckpt}")
    return {"bank": bank, "last_sync": last_sync, "ef": ef,
            "server": server, "step": n_rounds * q, "losses": losses,
            "seconds": seconds, "bytes_up": bytes_up,
            "bytes_down": bytes_down, "wire": (msg_b, down_b)}


def run_gossip(args, cfg, fed, shape, tr: FederatedTrainer):
    """Gossip mode (--engine gossip): no server, every node steps every
    round (full participation; --cohort and --sampler are unused), and each
    round opens with one Metropolis mixing step over --topology that
    closes the previous round. Every directed edge's codec message is
    billed on both legs (the sender's uplink is the receiver's downlink;
    there is no full-precision broadcast)."""
    n = args.population
    dev = tr.device
    _, specs_n, data, depths, params, batch0 = _bank_setup(
        args, cfg, fed, shape, tr, n, n)
    topo = dict(topology=args.topology, er_p=args.er_p,
                seed=args.topology_seed, time_varying=args.time_varying)
    try:
        agg = tr.gossip_aggregator(n, **topo)
    except ValueError as e:          # a bad topology spec: a CLI exit
        raise SystemExit(str(e))
    bank, srv_bank = tr.init_gossip_states(params, batch0, depths.init())
    del params, batch0
    ef = tr.init_ef_bank(n)          # None unless the codec keeps EF state
    start = 0
    if args.resume and args.ckpt:
        tmpl = (bank, srv_bank, ef) if ef is not None else (bank, srv_bank)
        loaded, start = load_checkpoint(args.ckpt, tmpl)
        if ef is not None:
            bank, srv_bank, ef = loaded
        else:
            bank, srv_bank = loaded
        print(f"resumed gossip run from step {start}")
    round_fn = tr.gossip_round_fn(n, **topo)
    ev = tr.eval_fn()
    noise = compress.CodecNoise(args.seed, dev)
    msg_b, down_b = wire_costs(tr, n)
    # static graphs bill a constant edge count; time-varying ones replay
    # each round's draw on the host
    static_edges = None if args.time_varying else agg.edges(0)
    bytes_up = bytes_down = 0
    q = fed.q
    start_round, n_rounds = _rounds(args, q, start, "gossip")
    print(f"gossip mode: N={n} nodes over {args.topology} "
          f"(spectral gap {agg.gap:.4f}"
          f"{', time-varying' if args.time_varying else ''}), "
          f"rounds {start_round}..{n_rounds - 1} of q={q}", flush=True)
    ids = torch.arange(n, device=dev)
    eval_rounds = max(args.eval_every // q, 1)
    losses, seconds = [], []
    t0 = time.time()
    for r in range(start_round, n_rounds):
        t = r * q
        batch_q = tree_stack([make_client_batch(data, cfg, specs_n, t + j,
                                                dev) for j in range(q)])
        k_q = round_depths(depths, r, q, ids)
        u = noise(r, ids) if tr.codec.name == "int8" else None
        r0 = time.time()
        bank, srv_bank, ef = round_fn(bank, srv_bank, ef, batch_q, k_q, r, u,
                                      sync_first=r > 0)
        devlib.fence(dev)
        dt = time.time() - r0
        seconds.append(dt)
        if r > 0:
            # round r's opening mix closes round r - 1
            edges = (static_edges if static_edges is not None
                     else agg.edges(r - 1))
            up, down = agg.wire_round(msg_b, down_b, edges=edges)
            bytes_up += up
            bytes_down += down
        if r % eval_rounds == 0 or r == n_rounds - 1:
            loss = float(ev(bank, tree_index(batch_q, q - 1)))
            losses.append(loss)
            print(progress_line(loss=loss, elapsed=time.time() - t0,
                                step=t + q - 1, round=r, round_seconds=dt,
                                bytes_up=bytes_up, bytes_down=bytes_down),
                  flush=True)
    print(f"wire totals ({tr.codec.name}): bytes_up={bytes_up} "
          f"bytes_down={bytes_down}", flush=True)
    if args.ckpt:
        state = (bank, srv_bank, ef) if ef is not None else (bank, srv_bank)
        save_checkpoint(args.ckpt, state, n_rounds * q,
                        shards=args.ckpt_shards)
        print(f"saved gossip checkpoint to {args.ckpt}")
    return {"bank": bank, "srv_bank": srv_bank, "ef": ef,
            "step": n_rounds * q, "losses": losses, "seconds": seconds,
            "bytes_up": bytes_up, "bytes_down": bytes_down,
            "wire": (msg_b, down_b)}


def run_population_async(args, cfg, fed, shape, tr: FederatedTrainer,
                         sampler):
    """Asynchronous population mode: overlapping cohorts with delayed
    arrivals (per-client delays from --delay-model), the bounded-staleness
    gate, delay-adaptive server steps. Prints per-eval arrival stats and
    the accepted-staleness histogram (by speed tier for --delay-model
    tiers)."""
    n, c = args.population, args.cohort
    dev = tr.device
    delay_draws = DelayDraws(args.seed, dev)
    # the permanent per-client delay quantities, drawn once
    dm = make_cli_delay_model(args, n).resolve(delay_draws, n)
    specs_c, _, data, depths, params, batch0 = _bank_setup(
        args, cfg, fed, shape, tr, n, c)
    state = tr.init_async_population_states(params, batch0, depths.init())
    del params, batch0
    start = 0
    if args.resume and args.ckpt:
        state, start = load_checkpoint(args.ckpt, state)
        print(f"resumed async population run from step {start}")
    round_fn = tr.async_population_round_fn(
        n, max_staleness=args.max_staleness, max_delay=args.max_delay,
        delay_eta=args.delay_eta, delay_model=dm, delay_draws=delay_draws)
    ev = tr.eval_fn()
    noise = compress.CodecNoise(args.seed, dev)
    q = fed.q
    start_round, n_rounds = _rounds(args, q, start, "async population")
    print(f"async population mode: N={n} clients, C={c} cohort/round "
          f"({args.sampler} sampler), max_staleness={args.max_staleness}, "
          f"delay_model={args.delay_model} (bound {dm.bound}), "
          f"delay_eta={args.delay_eta}, "
          f"rounds {start_round}..{n_rounds - 1} of q={q}", flush=True)
    tier_of = (dm.tiers(delay_draws, n).cpu().numpy()
               if args.delay_model == "tiers" else None)
    hist = np.zeros(0, np.int64)
    hist_by_tier = {}
    msg_b, down_b = wire_costs(tr, n)
    bytes_up = bytes_down = 0
    eval_rounds = max(args.eval_every // q, 1)
    losses, seconds, log = [], [], []
    t0 = time.time()
    for r in range(start_round, n_rounds):
        t = r * q
        ids_host = sampler.cohort(r)
        ids = devlib.to_device(ids_host, dev)
        batch_q = tree_stack([make_cohort_batch(data, cfg, specs_c, t + j,
                                                ids_host, dev)
                              for j in range(q)])
        k_q = round_depths(depths, r, q, ids)
        u = noise(r, ids) if tr.codec.name == "int8" else None
        r0 = time.time()
        state, stats = round_fn(state, ids, batch_q, k_q, r, u)
        devlib.fence(dev)
        dt = time.time() - r0
        seconds.append(dt)
        host = {k: v.cpu().numpy() for k, v in stats.items()}
        stale = host["staleness"]
        if (stale >= 0).any():
            hist = accum_staleness_hist(hist, stale[stale >= 0])
        if tier_of is not None:
            accum_tier_hists(hist_by_tier, stale, tier_of,
                             len(dm.tier_fracs))
        row = {k: int(host[k]) for k in ("arrived", "accepted", "dropped",
                                         "dispatched", "synced")}
        row["mean_staleness"] = float(host["mean_staleness"])
        row["eta_scale"] = float(host["eta_scale"])
        log.append(row)
        # uplink per arrival (dropped ones shipped before the gate),
        # downlink per row that received the new global model
        bytes_up += row["arrived"] * msg_b
        bytes_down += row["synced"] * down_b
        if r % eval_rounds == 0 or r == n_rounds - 1:
            loss = float(ev(state["bank"], tree_index(batch_q, q - 1)))
            losses.append(loss)
            print(progress_line(loss=loss, elapsed=time.time() - t0,
                                step=t + q - 1, round=r, round_seconds=dt,
                                arrived=row["arrived"],
                                dropped=row["dropped"],
                                mean_staleness=row["mean_staleness"],
                                eta_scale=row["eta_scale"],
                                bytes_up=bytes_up, bytes_down=bytes_down),
                  flush=True)
    print(f"wire totals ({tr.codec.name}): bytes_up={bytes_up} "
          f"bytes_down={bytes_down}", flush=True)
    print("accepted-staleness histogram (rounds): "
          + " ".join(f"{s}:{int(k)}" for s, k in enumerate(hist) if k),
          flush=True)
    if tier_of is not None:
        for ti in range(len(dm.tier_fracs)):
            lo, hi = dm.tier_delays[ti]
            print(f"  tier {ti} (delay {lo}..{hi}, "
                  f"{int((tier_of == ti).sum())} clients): "
                  + (" ".join(f"{s}:{int(k)}" for s, k in
                              enumerate(hist_by_tier.get(ti, ())) if k)
                     or "-"),
                  flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, state, n_rounds * q,
                        shards=args.ckpt_shards)
        print(f"saved async population checkpoint to {args.ckpt}")
    return {"state": state, "step": n_rounds * q, "losses": losses,
            "seconds": seconds, "log": log, "hist": hist,
            "hist_by_tier": hist_by_tier, "bytes_up": bytes_up,
            "bytes_down": bytes_down, "wire": (msg_b, down_b)}


if __name__ == "__main__":
    main()
