"""Where one round of the main path spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_round

Runs AdaFBiO through ``FedDriver.round_segment`` at the main path's
hyper-representation width (the configuration of ``chip_smoke.py``), times
``ROUNDS`` steady rounds (the sync, then q local steps) with the host clock
around a synchronise, then traces one more round with ``torch.profiler``: device busy
time (the sum of kernel and copy durations), the device's idle share of the
traced round, the number of device operations, and the kernels that take
the most device time (the first ``TOP``). Needs a CUDA device.
"""
from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import HyperRepConfig
from repro_torch.fed.round import stack_round_batches
from repro_torch.tasks import FedDriver, build_hyperrep

MAIN_PATH = HyperRepConfig(n_clients=8, in_dim=784, hidden=1024,
                           rep_dim=256, n_classes=10, batch=256)
ROUNDS = 3      # steady rounds timed before the traced one
TOP = 12        # kernels listed by device time


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = MAIN_PATH
    task = build_hyperrep(cfg, device="cuda")
    drv = FedDriver(task["problem"], cfg.fed, cfg.n_clients, task["batch_fn"],
                    task["init_xy"], engine="scan", device="cuda")
    q = cfg.fed.q
    draws = drv.draws((ROUNDS + 2) * q, seed=0)
    states, server = drv.init_run(0, draws)

    def one_round(r):
        batches_q = stack_round_batches(drv.batches, r * q, q)
        # the main path's codec is lossless: the states are their own
        # messages, with no residuals and no noise
        return drv.round_segment(states, server, states, None, batches_q,
                                 draws.steps[r * q:(r + 1) * q], n_steps=q,
                                 sync_first=r > 0)[:2]

    states, server = one_round(0)            # warm-up: build, allocator
    torch.cuda.synchronize()
    walls = []
    for r in range(1, ROUNDS + 1):
        t0 = time.perf_counter()
        states, server = one_round(r)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        states, server = one_round(ROUNDS + 1)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    print(f"steady rounds (q={q}), host clock: "
          f"{[round(w * 1e3, 2) for w in walls]} ms")
    print(f"traced round: wall {traced * 1e3:.2f} ms, device busy "
          f"{busy_ms:.2f} ms, idle share {1 - busy_ms / (traced * 1e3):.4f},"
          f" {len(dev)} device operations")
    by_name = {}
    for e in dev:
        by_name.setdefault(e.name, [0, 0.0])
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :TOP]:
        print(f"{ms:9.3f} ms {n:6d}x  {name[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
