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
               sync, the codec's EF residuals in a bank. ``--spill host``
               keeps both banks in (pinned) host memory and moves only the
               cohort's rows to the card each round: the same trajectory
               and checkpoints, with the card's memory independent of N.
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

``--mesh local`` builds the (n, 1) mesh of the visible cards (n = 1 on
one card and on the CPU): M and the zero mode's data shards follow from it,
and the banks are placed by its specs (:mod:`repro_torch.sharding`);
``prod`` and ``prod-multi`` need 256 and 512 devices. A mesh over several
cards raises (ROADMAP item 1j). ``--metrics-out`` writes the run's
telemetry stream (manifest, a ``round`` record a round, the on-device
``stats`` drained every ``--metrics-every`` rounds, the summary;
``scripts/report.py --check`` validates it), and ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the run to ``DIR/trace.json``
(:mod:`repro_torch.obs`). Telemetry only observes: the states are the same
bit for bit. Its stat ring keeps one client mean of the states on the
device (one state row: 13.54 GiB for qwen1.5-4b at 36 layers, which fits
an 80 GB card with it; at 40 the run does not).

The flags are the JAX launcher's. The scan engine and the population,
async and gossip modes run their rounds in chunks of up to
``--rounds-per-scan R`` (the mega-scan tier, :func:`repro_torch.fed.
round.make_multi_round`; the default R = 1 is a chunk a round), through
one loop (:func:`chunk_loop`): a chunk's batches, depths, cohorts and
noise sources are staged on the device before it starts, nothing is read
back inside it, and a run equals the R = 1 run bit for bit. Chunks start
at the first round (on ``--resume``, the checkpoint's), the gossip mode
peels round 0 (no mix before it) off as a single round, the stat ring
samples once a chunk, and each round keeps its ``round`` record with the
chunk's seconds over its rounds. ``--spill host`` and the eager engine
refuse R above 1, as the reference's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as devlib
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import FedConfig
from repro_torch.configs.base import DELAY_MODELS, TOPOLOGIES, ShapeConfig
from repro_torch.core.tree_util import take, tree_index, tree_map, tree_stack
from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                        make_client_batch, make_cohort_batch)
from repro_torch.fed import compress
from repro_torch.fed.population import (DelayDraws, accum_staleness_hist,
                                        accum_tier_hists, make_delay_model,
                                        parse_tier_spec)
from repro_torch.fed.round import (ENGINES, chunk_calls, chunk_plan,
                                   make_multi_round, stack_chunk_batches)
from repro_torch.fed.runtime import (FederatedTrainer, NeumannDraws,
                                     client_batch_specs, round_depths)
from repro_torch.fed.sampling import SAMPLERS, load_delay_trace, make_sampler
from repro_torch.fed.spill import HostSpillBank
from repro_torch.launch import arch_config
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.params import TensorSpec
from repro_torch.obs import (NULL, StatAccum, make_telemetry, progress_line,
                             ring_close, ring_update)
from repro_torch.sharding import device_put

# seed salts of the parameter draw (the reference's fold_in(key, 0x9142A))
# and of the cohort sampler (its fold_in(key, 23))
PARAM_SALT = 0x9142A
SAMPLER_SALT = 23


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
                    help="local: the (n, 1) mesh of the visible cards (the "
                         "clients and the zero mode's data shards follow "
                         "from it; over several cards it raises, ROADMAP "
                         "1j); prod/prod-multi: 16x16 / 2x16x16")
    ap.add_argument("--seed", type=int, default=0,
                    help="run seed (params, data, Neumann depths and codec "
                         "noise all derive from it)")
    ap.add_argument("--spill", default="none", choices=["none", "host"],
                    help="host: keep the population bank in pinned host "
                         "memory and move only each round's cohort to the "
                         "card (population mode, synchronous rounds)")
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
                    help="mega-scan: run up to R whole rounds as one call "
                         "(the scan engine and the population, async and "
                         "gossip modes; not with --spill host)")
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
                    help="write the run's telemetry stream (manifest, "
                         "per-round records, on-device stats, summary) to "
                         "this JSONL file (scripts/report.py renders it; "
                         "--check validates it). The stats keep one client "
                         "mean of the states on the device, a state row "
                         "more at the peak: full-width qwen1.5-4b fits an "
                         "80 GB H100 with it up to 36 of its 40 layers "
                         "(scripts/obs_memory.py)")
    ap.add_argument("--metrics-every", type=int, default=8,
                    help="drain the on-device stats (and flush the buffered "
                         "round records) every K rounds: one host copy a K "
                         "rounds")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run to "
                         "DIR/trace.json (batch_build, round_program and "
                         "the round/* regions by name)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def check_ported(args) -> None:
    """``SystemExit`` for the reference's refusals of ``--spill host`` and
    ``--rounds-per-scan``, in the reference's order."""
    if args.spill != "none" and not args.population:
        raise SystemExit("--spill host spills the population bank: run "
                         "with --population N")
    if args.rounds_per_scan < 1:
        raise SystemExit("--rounds-per-scan must be >= 1")
    if args.rounds_per_scan > 1:
        if args.spill != "none":
            raise SystemExit("--spill host streams the bank through host "
                             "memory round-by-round: the mega-scan tier "
                             "needs device-resident rounds (set "
                             "--rounds-per-scan 1 or --spill none)")
        if not args.population and args.engine != "scan":
            raise SystemExit("--rounds-per-scan > 1 fuses whole rounds into "
                             "one program: use --engine scan or a "
                             "--population mode")


def server_step(s: int, q: int) -> int:
    """The server counter at local step ``s``: one tick a local step and
    one a sync, q steps to a sync."""
    return s + s // q


def make_mesh(name: str, device):
    """``--mesh``'s mesh over ``device``'s type, or None."""
    if name == "none":
        return None
    if name == "local":
        return make_local_mesh(device)
    return make_production_mesh(multi_pod=name == "prod-multi",
                                device=device)


def main(argv=None, cfg=None):
    """Run the launcher on ``argv``; ``cfg``, when given, is trained in
    place of ``--arch``'s config (a depth-cut variant of it)."""
    args = parse_args(argv)
    check_ported(args)
    cfg, record = arch_config(args, cfg)
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
    tr = FederatedTrainer(cfg, fed, shape, mesh=make_mesh(args.mesh, dev),
                          algorithm=args.algorithm, device=dev)
    tele = make_telemetry(args.metrics_out, args.metrics_every,
                          args.profile)
    tele.manifest(config=record, seed=args.seed, mesh=tr.mesh)
    try:
        return run_cli(args, cfg, fed, shape, tr, tele)
    finally:
        # the closing summary record, and the profiler's trace
        tele.close()


def run_cli(args, cfg, fed, shape, tr: FederatedTrainer, tele=NULL):
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
        if args.spill != "none":
            raise SystemExit("--engine gossip mixes the whole bank every "
                             "round: the bank must stay device-resident "
                             "(--spill none)")
        return run_gossip(args, cfg, fed, shape, tr, tele)
    if args.population:
        return run_population(args, cfg, fed, shape, tr, tele)
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
        noise = compress.CodecNoise(args.seed, dev)
        ids = torch.arange(tr.m, device=dev)
        acc = StatAccum.for_bus(tele, states)
        multi = scan_multi_round(tr)

        def stage(r, L):
            t = start + r * q
            return dict(batches=stack_chunk_batches(batch_of, t, q, L),
                        k=torch.stack([torch.stack([
                            depths.step(server_step(t + j * q + jj, q))
                            for jj in range(q)]) for j in range(L)]),
                        u=[noise(round0 + r + j, ids)
                           if tr.codec.name == "int8" else None
                           for j in range(L)])

        def run(st, r, L):
            nonlocal states, server, ef
            (states, server, ef), _ = multi(
                (states, server, ef), None, st["batches"],
                (st["k"], st["u"]), round0 + r)
            return states, None

        def account(rr, j, st, host, dt):
            step = start + rr * q + q - 1
            tele.round(rr, step=step, round_seconds=dt)
            return dict(step=step)

        chunk_loop(args, tr, tele, acc, ev, 0, n_rounds, losses, seconds,
                   stage=stage, run=run, account=account)
        ring_close(tele, acc)
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


# ------------------------------------------------------------ mega-scan

def scan_multi_round(tr: FederatedTrainer):
    """The scan engine's rounds as one call a chunk: ``multi((states,
    server, ef), None, batches_R, (k_R, noise_R), round0)``. With a lossy
    codec the round's ``ref`` is the carried states (each round ends by
    broadcasting the new global state), so only the EF residual rides
    along; ``ef`` is None otherwise. Each round takes the entries out of
    the carried dicts (as the plain round does), so a chunk holds no
    round's input past the round."""
    if tr.codec.lossy:
        base = tr.round_step_codec_fn()

        def one(c, _, batch_q, dr, rid):
            states, server, ef = (take(d) for d in c)
            states, server, _, ef = base(states, server, states, ef,
                                         batch_q, dr[0], dr[1])
            return (states, server, ef), None
    else:
        base = tr.round_step_fn()

        def one(c, _, batch_q, dr, rid):
            return base(c[0], c[1], batch_q, dr[0]) + (c[2],), None
    return make_multi_round(one)


def chunk_loop(args, tr: FederatedTrainer, tele, acc, ev, begin: int,
               n_rounds: int, losses, seconds, *, stage, run, account,
               peel_first: bool = False):
    """The launcher's round loop over rounds ``begin .. n_rounds - 1`` in
    chunks of up to ``--rounds-per-scan`` (round 0 alone with
    ``peel_first``; :func:`repro_torch.fed.round.chunk_plan`); at R = 1
    a chunk is a round. ``stage(r, L)`` builds a chunk's inputs on the
    device (its ``batches`` [L, q, ...]), ``run(staged, r, L)`` runs its L
    rounds as one call and returns the states the stat ring and the eval
    read and its stacked per-round outputs (None: none), which the host
    reads once (:func:`repro_torch.fed.round.chunk_calls`); ``account(r +
    j, j, staged, host, dt / L)`` bills each round, writes its ``round``
    record and returns its progress fields (``step`` among them). The stat
    ring samples once a chunk, and the eval reads the chunk's last
    batch."""
    q = tr.fed.q
    eval_rounds = max(args.eval_every // q, 1)
    plan = chunk_plan([q] * (n_rounds - begin), q, args.rounds_per_scan,
                      peel_first=peel_first and begin == 0)
    t0 = time.time()
    for r, L, staged, states, host, dt in chunk_calls(
            [(begin + r, L) for r, L in plan], tele, tr.device,
            stage=stage, call=run):
        for j in range(L):
            seconds.append(dt / L)
            fields = account(r + j, j, staged, host, dt / L)
        ring_update(tele, acc, states)
        rr = r + L - 1
        if (any((r + j) % eval_rounds == 0 for j in range(L))
                or rr == n_rounds - 1):
            loss = float(ev(states, tree_map(lambda x: x[-1, -1],
                                             staged["batches"])))
            losses.append(loss)
            print(progress_line(loss=loss, elapsed=time.time() - t0,
                                round=rr, round_seconds=dt / L, **fields),
                  flush=True)
        # a round takes its input dicts, as JAX donates buffers; what the
        # loop still held of this chunk would stay alive beside the next
        del states, staged


def stage_cohorts(data, cfg, specs_c, sampler, depths, dev, r: int, L: int,
                  q: int):
    """A population chunk's inputs: its L cohorts drawn on the host
    (``hosts``) and staged as one [L, C] tensor (``ids``), their [L, q,
    ...] batches and [L, q, C] Neumann depths."""
    hosts = [sampler.cohort(r + j) for j in range(L)]
    ids = devlib.to_device(torch.stack(hosts), dev)
    batches = tree_stack([tree_stack([
        make_cohort_batch(data, cfg, specs_c, (r + j) * q + jj, hosts[j],
                          dev) for jj in range(q)]) for j in range(L)])
    k = torch.stack([round_depths(depths, r + j, q, ids[j])
                     for j in range(L)])
    return dict(hosts=hosts, ids=ids, batches=batches, k=k)


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


def run_population(args, cfg, fed, shape, tr: FederatedTrainer, tele=NULL):
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
        if args.spill != "none":
            raise SystemExit("--spill host replays the synchronous "
                             "broadcast rounds: the async pending buffer "
                             "is device-resident (set --max-staleness 0)")
        return run_population_async(args, cfg, fed, shape, tr, sampler,
                                    tele)
    if args.delay_model != "uniform" or args.tiers is not None:
        raise SystemExit("--delay-model / --tiers are async knobs: set "
                         "--max-staleness != 0 to enable asynchronous "
                         "execution")
    if args.spill != "none":
        return run_population_spill(args, cfg, fed, shape, tr, sampler,
                                    tele)
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
    if tr.mesh is not None:
        # the bank's leading population axis over the mesh's client axes
        bank = device_put(bank, tr.population_state_shardings(n))
        last_sync = device_put(last_sync, tr.bank_vector_sharding(n))
        if ef is not None:
            ef = device_put(ef, tr.population_state_shardings(n))
    ev = tr.eval_fn()
    noise = compress.CodecNoise(args.seed, dev)
    msg_b, down_b = wire_costs(tr, n)
    bytes_up = bytes_down = 0
    q = fed.q
    start_round, n_rounds = _rounds(args, q, start, "population")
    print(f"population mode: N={n} clients, C={c} cohort/round "
          f"({args.sampler} sampler), rounds {start_round}..{n_rounds - 1} "
          f"of q={q}", flush=True)
    losses, seconds = [], []
    acc = StatAccum.for_bus(tele, bank)
    multi = tr.multi_population_round_fn(n)

    def stage(r, L):
        st = stage_cohorts(data, cfg, specs_c, sampler, depths, dev, r,
                           L, q)
        st["u"] = [noise(r + j, st["ids"][j]) if tr.codec.name == "int8"
                   else None for j in range(L)]
        return st

    def run(st, r, L):
        nonlocal bank, last_sync, ef, server
        if lossy:
            bank, last_sync, ef, server = multi(
                bank, last_sync, ef, server, st["ids"], st["batches"],
                st["k"], r, st["u"])
        else:
            bank, last_sync, server = multi(
                bank, last_sync, server, st["ids"], st["batches"],
                st["k"], r)
        return bank, None

    def account(rr, j, st, host, dt):
        nonlocal bytes_up, bytes_down
        ids_host = st["hosts"][j]
        # each UNIQUE cohort member uploads one codec message (a duplicate
        # id fills two aggregation slots, one client shipped one message);
        # every bank row downloads the broadcast
        bytes_up += int(np.unique(np.asarray(ids_host)).size) * msg_b
        bytes_down += n * down_b
        tele.round(rr, step=rr * q + q - 1, round_seconds=dt,
                   bytes_up=bytes_up, bytes_down=bytes_down)
        return dict(step=rr * q + q - 1, bytes_up=bytes_up,
                    bytes_down=bytes_down,
                    cohort=np.asarray(ids_host).tolist())

    chunk_loop(args, tr, tele, acc, ev, start_round, n_rounds, losses,
               seconds, stage=stage, run=run, account=account)
    ring_close(tele, acc)
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


def run_population_spill(args, cfg, fed, shape, tr: FederatedTrainer,
                         sampler, tele=NULL):
    """Host-spill population mode (``--spill host``): the [N, ...] bank and
    the EF bank live in host memory (:class:`repro_torch.fed.spill.
    HostSpillBank`, pinned on the card), only each round's C sampled rows
    travel to the card, and the round is the cohort-only
    ``tr.cohort_round_fn``: the dense broadcast rounds' math, so the run
    and its checkpoints equal the dense runner's bit for bit, and the
    card's memory does not grow with N. The bank is built one row at a
    time (``tr.init_spilled_population_states``); ``--resume`` loads the
    checkpoint to the host without passing through the card. The next
    round's cohort is prefetched on a side stream while this round's
    progress line and the next round's batches are built. The spans
    ``spill_gather``, ``round_program``, ``spill_scatter`` and
    ``spill_prefetch`` time each phase's host side (the copies and the
    round are queued on the card; the one fence ends the round), and the
    run records no ``stats``, as the reference's. Returns
    :func:`run_population`'s dict with the two host banks (``spill``,
    ``ef_spill``) in place of the dense ``bank`` and ``ef`` (None)."""
    n, c = args.population, args.cohort
    dev = tr.device
    specs_c, _, data, depths, params, batch0 = _bank_setup(
        args, cfg, fed, shape, tr, n, c)
    lossy = tr.codec.lossy
    start = 0
    if args.resume and args.ckpt:
        # the banks come to the host as TensorSpecs on the CPU; the
        # server's template is real, on the card
        spec_n = tr.abstract_population_states(n)
        spec_ef = (tree_map(lambda s: TensorSpec(s.shape, torch.float32),
                            spec_n) if tr.codec.stateful else None)
        srv = tr.alg.init_server_state(params["x"])
        ls = TensorSpec((n,), torch.int32)
        tmpl = (spec_n, ls, spec_ef, srv) if lossy else (spec_n, ls, srv)
        del params, batch0
        loaded, start = load_checkpoint(args.ckpt, tmpl, device="cpu")
        if lossy:
            bank, last_sync, ef, server = loaded
        else:
            bank, last_sync, server = loaded
            ef = None
        spill = HostSpillBank.from_device(bank, dev)
        ef_spill = (HostSpillBank.from_device(ef, dev) if ef is not None
                    else None)
        del bank, ef, loaded
        print(f"resumed spilled population run from step {start}")
    else:
        spill, last_sync, server = tr.init_spilled_population_states(
            params, batch0, depths.init())
        ef_spill = tr.init_spilled_ef_bank(n)
        del params, batch0
    round_fn = tr.cohort_round_fn(n)
    ev = tr.eval_fn()
    noise = compress.CodecNoise(args.seed, dev)
    msg_b, down_b = wire_costs(tr, n)
    bytes_up = bytes_down = 0
    q = fed.q
    start_round, n_rounds = _rounds(args, q, start, "population")
    print(f"spilled population mode: N={n} clients "
          f"({spill.nbytes / 1e6:.1f}MB host bank), C={c} cohort/round "
          f"({args.sampler} sampler), rounds {start_round}..{n_rounds - 1} "
          f"of q={q}", flush=True)
    eval_rounds = max(args.eval_every // q, 1)
    losses, seconds = [], []
    t0 = time.time()
    ids_host = sampler.cohort(start_round)
    for r in range(start_round, n_rounds):
        t = r * q
        with tele.span("batch_build"):
            ids = devlib.to_device(ids_host, dev)
            batch_q = tree_stack([make_cohort_batch(data, cfg, specs_c,
                                                    t + j, ids_host, dev)
                                  for j in range(q)])
            k_q = round_depths(depths, r, q, ids)
        r0 = time.time()
        with tele.span("spill_gather"):
            cur = spill.gather(ids_host)
            ls_c = devlib.to_device(
                last_sync.index_select(0, ids_host.long()), dev)
            ef_c = (ef_spill.gather(ids_host)
                    if lossy and ef_spill is not None else None)
        with tele.span("round_program"):
            if lossy:
                u = noise(r, ids) if tr.codec.name == "int8" else None
                new_client, ef_c, server = round_fn(cur, ls_c, ef_c, server,
                                                    ids, batch_q, k_q, r, u)
            else:
                new_client, server = round_fn(cur, ls_c, server, ids,
                                              batch_q, k_q, r)
        with tele.span("spill_scatter"):
            # the broadcast write-back, on the host: every row :=
            # new_client (lazily), last_sync := r + 1; the cohort's EF rows
            # scattered
            spill.broadcast(new_client)
            last_sync.fill_(r + 1)
            if lossy and ef_spill is not None:
                ef_spill.scatter(ids_host, ef_c)
                del ef_c
        next_ids = sampler.cohort(r + 1) if r + 1 < n_rounds else None
        if next_ids is not None:
            with tele.span("spill_prefetch"):
                spill.prefetch(next_ids)
                if ef_spill is not None:
                    ef_spill.prefetch(next_ids)
        devlib.fence(dev)
        dt = time.time() - r0
        seconds.append(dt)
        bytes_up += int(np.unique(np.asarray(ids_host)).size) * msg_b
        bytes_down += n * down_b
        tele.round(r, step=t + q - 1, round_seconds=dt, bytes_up=bytes_up,
                   bytes_down=bytes_down)
        if r % eval_rounds == 0 or r == n_rounds - 1:
            loss = float(ev(tree_map(lambda v: v.unsqueeze(0), new_client),
                            tree_index(batch_q, q - 1)))
            losses.append(loss)
            print(progress_line(loss=loss, elapsed=time.time() - t0,
                                step=t + q - 1, round=r, round_seconds=dt,
                                bytes_up=bytes_up, bytes_down=bytes_down,
                                cohort=np.asarray(ids_host).tolist()),
                  flush=True)
        del new_client, batch_q
        if next_ids is not None:
            ids_host = next_ids
    print(f"wire totals ({tr.codec.name}): bytes_up={bytes_up} "
          f"bytes_down={bytes_down}", flush=True)
    if args.ckpt:
        # lazy leaves: the save pulls one shard's rows at a time, so the
        # dense bank is never built (one pull with --ckpt-shards 1)
        bank_l = spill.lazy_leaves()
        ef_l = ef_spill.lazy_leaves() if ef_spill is not None else None
        state = ((bank_l, last_sync, ef_l, server) if lossy
                 else (bank_l, last_sync, server))
        save_checkpoint(args.ckpt, state, n_rounds * q,
                        shards=args.ckpt_shards)
        print(f"saved population checkpoint to {args.ckpt}")
    return {"bank": None, "last_sync": last_sync, "ef": None,
            "server": server, "step": n_rounds * q, "losses": losses,
            "seconds": seconds, "bytes_up": bytes_up,
            "bytes_down": bytes_down, "wire": (msg_b, down_b),
            "spill": spill, "ef_spill": ef_spill}


def run_gossip(args, cfg, fed, shape, tr: FederatedTrainer, tele=NULL):
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
    if tr.mesh is not None:
        # the bank's node axis over the mesh's client axes
        bank = device_put(bank, tr.population_state_shardings(n))
        srv_bank = device_put(srv_bank, tr.gossip_server_shardings(n))
        if ef is not None:
            ef = device_put(ef, tr.population_state_shardings(n))
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
    losses, seconds = [], []
    acc = StatAccum.for_bus(tele, bank)
    multi = tr.multi_gossip_round_fn(n, **topo)

    def stage(r, L):
        return dict(
            batches=stack_chunk_batches(
                lambda t: make_client_batch(data, cfg, specs_n, t, dev),
                r * q, q, L),
            k=torch.stack([round_depths(depths, r + j, q, ids)
                           for j in range(L)]),
            u=[noise(r + j, ids) if tr.codec.name == "int8" else None
               for j in range(L)])

    def run(st, r, L):
        nonlocal bank, srv_bank, ef
        if r == 0:
            # round 0 has no round to close: the single round without
            # its opening mix
            bank, srv_bank, ef = round_fn(
                bank, srv_bank, ef, tree_index(st["batches"], 0),
                st["k"][0], 0, st["u"][0], sync_first=False)
        else:
            bank, srv_bank, ef = multi(bank, srv_bank, ef, st["batches"],
                                       st["k"], r, st["u"])
        return bank, None

    def account(rr, j, st, host, dt):
        nonlocal bytes_up, bytes_down
        if rr > 0:
            # round rr's opening mix closes round rr - 1
            up, down = agg.wire_round(
                msg_b, down_b, edges=(static_edges if static_edges
                                      is not None
                                      else agg.edges(rr - 1)))
            bytes_up += up
            bytes_down += down
        tele.round(rr, step=rr * q + q - 1, round_seconds=dt,
                   bytes_up=bytes_up, bytes_down=bytes_down)
        return dict(step=rr * q + q - 1, bytes_up=bytes_up,
                    bytes_down=bytes_down)

    chunk_loop(args, tr, tele, acc, ev, start_round, n_rounds, losses,
               seconds, stage=stage, run=run, account=account,
               peel_first=True)
    ring_close(tele, acc)
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
                         sampler, tele=NULL):
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
    if tr.mesh is not None:
        # the bank, pending buffer, EF bank and [N] vectors over the mesh's
        # client axes; the anchor and server replicate
        state = device_put(state, tr.async_state_shardings(n))
    multi = tr.multi_async_population_round_fn(
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
    losses, seconds, log = [], [], []
    acc = StatAccum.for_bus(tele, state["bank"])

    def note_round(r, host, dt):
        """One round's stats, read to the host: the staleness histograms,
        the log row, the wire bill and the round record. Returns the
        row."""
        nonlocal hist, bytes_up, bytes_down
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
        tele.round(r, step=r * q + q - 1, round_seconds=dt,
                   bytes_up=bytes_up, bytes_down=bytes_down, **row)
        return row

    def stage(r, L):
        st = stage_cohorts(data, cfg, specs_c, sampler, depths, dev, r,
                           L, q)
        st["u"] = [noise(r + j, st["ids"][j]) if tr.codec.name == "int8"
                   else None for j in range(L)]
        return st

    def run(st, r, L):
        nonlocal state
        state, stats_R = multi(state, st["ids"], st["batches"], st["k"],
                               r, st["u"])
        return state["bank"], stats_R

    def account(rr, j, st, host, dt):
        row = note_round(rr, {k: v[j] for k, v in host.items()}, dt)
        return dict(step=rr * q + q - 1, bytes_up=bytes_up,
                    bytes_down=bytes_down, **{k: row[k] for k in (
                        "arrived", "dropped", "mean_staleness",
                        "eta_scale")})

    chunk_loop(args, tr, tele, acc, ev, start_round, n_rounds, losses,
               seconds, stage=stage, run=run, account=account)
    ring_close(tele, acc)
    tele.note(staleness_hist=[int(k) for k in hist])
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
