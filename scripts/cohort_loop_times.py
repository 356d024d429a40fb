#!/usr/bin/env python3
"""Times the MNIST-width federated paths with their clients' gradients
under ``vmap`` and one client at a time (``BilevelProblem.client_loop``,
``core/adafbio.per_client``), the choice the LM problem makes the other
way.

Two paths of ``chip_smoke.py``, at its widths (hyper-representation,
in_dim 784, hidden 1024, rep_dim 256, batch 256):

- ``main``: 8 clients, the scan engine, codec none;
- ``population``: 32 clients in a bank, cohorts of 8, participants sync,
  int8 with error feedback.

Each runs ``--rounds`` rounds under ``vmap``, the loop, the loop and
``vmap`` again (so a drift of the host's speed shows as a gap between the
two runs of one setting), and prints per run the steady ms a round
(``FedDriver.round_seconds``, the first round left out), the peak memory
(``max_memory_allocated``) and the largest normwise relative distance of
the final averaged state from the first ``vmap`` run's.

Usage, on a machine with one CUDA card and ``nvcc``::

    PYTHONPATH=src python3 scripts/cohort_loop_times.py [--rounds R]

At the paths' theta 1 the Neumann product multiplies f32 rounding by up
to 22 a factor (``chip_smoke.py``, ``CHECK_THETA``), so runs that order
their sums differently part whatever their code; ``--theta 0.1`` keeps
the rounds under 1/L_g, where the distance says whether the two settings
compute the same function. ``--device cpu --small`` checks the script on
the CPU at a narrow width (no device numbers). Prints the card's name and
power limit first, then one JSON line per run. Imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--theta", type=float, default=None,
                    help="the Neumann step (default: the paths' own)")
    ap.add_argument("--small", action="store_true",
                    help="a narrow width, to check the script on the CPU")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.configs import HyperRepConfig, PopulationConfig
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.tasks import FedDriver, build_hyperrep

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        print(gpu_line(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def width(n):
        if args.small:
            return HyperRepConfig(n_clients=n, in_dim=16, hidden=32,
                                  rep_dim=8, n_classes=10, batch=8)
        return HyperRepConfig(n_clients=n, in_dim=784, hidden=1024,
                              rep_dim=256, n_classes=10, batch=256)

    paths = {
        "main": (width(8), {"engine": "scan"}, {}),
        "population": (width(32), {"population": PopulationConfig(
            n=32, cohort=8, sync_mode="participants", staleness_decay=0.5)},
            {"codec": "int8", "error_feedback": True}),
    }
    for path, (cfg, kw, fed_kw) in paths.items():
        task = build_hyperrep(cfg, device=dev)
        if args.theta is not None:
            fed_kw = {**fed_kw, "theta": args.theta}
        fed = dataclasses.replace(cfg.fed, **fed_kw)
        steps = args.rounds * fed.q
        first = None
        for loop in (False, True, True, False):
            problem = dataclasses.replace(task["problem"], client_loop=loop)
            drv = FedDriver(problem, fed, cfg.n_clients, task["batch_fn"],
                            task["init_xy"], device=dev, **kw)
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            res = drv.run(steps, seed=0, eval_every=steps)
            if cuda:
                torch.cuda.synchronize()
            final = [t.double() for t in tree_leaves(res.final_avg_state)]
            if first is None:
                first = final
            dist = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                       for a, b in zip(final, first))
            rs = drv.round_seconds
            print(json.dumps({
                "path": path, "clients": "loop" if loop else "vmap",
                "theta": fed.theta,
                "rounds_timed": len(rs),
                "ms_round": 1e3 * sum(rs) / len(rs),
                "ms_rounds": [1e3 * s for s in rs],
                "first_round_s": res.compile_seconds,
                "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if cuda else None),
                "rel_to_first_vmap": dist}), flush=True)
            del drv, res, final
    return 0


if __name__ == "__main__":
    sys.exit(main())
