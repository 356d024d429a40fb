#!/usr/bin/env python3
"""Per-leaf magnitudes of the LM trainer's state over its first local steps,
at full width on the card, under one or more FedConfigs: to see where (and
under which settings) a run diverges.

    PYTHONPATH=src python3 scripts/lm_train_diag.py --arch falcon-mamba-7b \
        --layers 32 --config rho=1e-2 --config rho=1e-2,theta=0.1

Each ``--config`` is a comma-separated list of FedConfig fields laid over
``chip_smoke.py``'s LM_FED (q 4, K 2, lr_x 1e-2, lr_y 1e-1). For each, the
trainer (ShapeConfig("cli", --seq, 8), bf16 params from a seed, one client)
runs ``--steps`` local steps from its init; after the init and each step the
script prints whether every state leaf is finite, the largest |x| and |w|
of each stacked layer leaf and of the embedding, and the step's seconds;
at the end the eval loss. ``--device cpu --reduced`` runs it here at the
reduced width.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LM_FED = dict(q=4, neumann_k=2, lr_x=1e-2, lr_y=1e-1)


def parse_config(text):
    out = {}
    for item in filter(None, text.split(",")):
        key, value = item.split("=")
        out[key.strip()] = float(value)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the arch's own)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--config", action="append", default=None,
                    help="FedConfig fields over LM_FED, e.g. rho=1e-2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from repro_torch import device as devlib
    from repro_torch.configs import FedConfig, ShapeConfig, get_arch, reduced
    from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                            make_client_batch)
    from repro_torch.fed.runtime import (FederatedTrainer, NeumannDraws,
                                         client_batch_specs)
    from repro_torch.launch.train import PARAM_SALT, server_step

    dev = devlib.resolve(args.device)
    if dev.type == "cuda":
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    def peak(t):
        return "%.3g" % float(t.abs().max().float())

    for text in args.config or [""]:
        fed = FedConfig(**dict(LM_FED, **parse_config(text)))
        shape = ShapeConfig("cli", args.seq, 8, "train")
        tr = FederatedTrainer(cfg, fed, shape, device=dev)
        specs = client_batch_specs(cfg, shape, 1, fed)
        data = FederatedLMData(vocab=cfg.vocab, n_clients=1,
                               draws=TorchLMDraws(0, dev))
        depths = NeumannDraws(0, fed.neumann_k, 1, dev)
        batches = [make_client_batch(data, cfg, specs, t, dev)
                   for t in range(args.steps)]
        params = tr.init_params(devlib.generator(dev, 0, PARAM_SALT))
        states, server = tr.init_states(params, batches[0], depths.init())
        del params

        def report(tag):
            finite = all(bool(torch.isfinite(t).all())
                         for name in ("x", "y", "v", "w")
                         for t in _leaves(states[name]))
            print(f"{tag}: finite {finite}; |x| "
                  f"{ {k: peak(v) for k, v in states['x']['layers'].items()} }"
                  f" embed {peak(states['x']['embed'])}; |w| "
                  f"{ {k: peak(v) for k, v in states['w']['layers'].items()} }"
                  f" embed {peak(states['w']['embed'])}", flush=True)

        print(f"{cfg.name}, {cfg.n_layers} layers, seq {args.seq}, "
              f"FedConfig over LM_FED: {text or 'none'}", flush=True)
        report("init")
        local = tr.local_step_fn()
        for t in range(args.steps):
            t0 = time.time()
            k = depths.step(server_step(t, fed.q))
            states, server = local(states, server, batches[t], k)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            report(f"step {t} (depth {int(k[0])}, {time.time() - t0:.1f} s)")
        print(f"eval loss {float(tr.eval_fn()(states, batches[-1])):.5f}",
              flush=True)
        del states, server, batches, tr
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
