"""Where one local step of the LM trainer spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--seq 1024]

Builds ``FederatedTrainer`` on qwen1.5-4b at full width and depth (the
configuration of ``chip_smoke.py``'s lm-train-qwen1.5-4b phase: one
client, launch/train.py's FedConfig, an LL batch of 8 sequences), runs one
local step as warm-up, times ``STEPS`` steady steps with the host clock
around a synchronise, then traces one more with ``torch.profiler``: device
busy time (the sum of kernel and copy durations), the device's idle share
of the traced step, the number of device operations, the device time by
kernel class (cuBLAS GEMMs, the update kernels, copies, the rest) and the
kernels that take the most device time (the first ``TOP``). Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import device as devlib
from repro_torch.configs import FedConfig, ShapeConfig, get_arch
from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                        make_client_batch)
from repro_torch.fed.runtime import (FederatedTrainer, NeumannDraws,
                                     client_batch_specs)
from repro_torch.launch.train import PARAM_SALT, server_step

ARCH = "qwen1.5-4b"
FED = dict(q=4, neumann_k=2, lr_x=1e-2, lr_y=1e-1)
STEPS = 2       # steady steps timed before the traced one
TOP = 15        # kernels listed by device time


def kernel_class(name: str) -> str:
    """A coarse class of a device operation's name."""
    low = name.lower()
    if "leaves_kernel" in low:
        return "update kernels (leaf tables)"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "GEMMs (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise, reductions and the rest"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(ARCH)
    fed = FedConfig(**FED)
    shape = ShapeConfig("profile", args.seq, args.batch, "train")
    tr = FederatedTrainer(cfg, fed, shape, device="cuda")
    specs = client_batch_specs(cfg, shape, tr.m, fed)
    data = FederatedLMData(vocab=cfg.vocab, n_clients=tr.m,
                           draws=TorchLMDraws(0, "cuda"))
    depths = NeumannDraws(0, fed.neumann_k, tr.m, "cuda")
    batches = [make_client_batch(data, cfg, specs, t, "cuda")
               for t in range(STEPS + 2)]
    params = tr.init_params(devlib.generator("cuda", 0, PARAM_SALT))
    states, server = tr.init_states(params, batches[0], depths.init())
    del params
    local = tr.local_step_fn()

    def step(t):
        return local(states, server, batches[t],
                     depths.step(server_step(t, fed.q)))

    states, server = step(0)                 # warm-up: build, allocator
    torch.cuda.synchronize()
    walls = []
    for t in range(1, STEPS + 1):
        t0 = time.perf_counter()
        states, server = step(t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        states, server = step(STEPS + 1)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    print(f"{ARCH} local step (seq {args.seq}, LL batch {args.batch}), "
          f"host clock: {[round(w * 1e3, 2) for w in walls]} ms")
    print(f"traced step: wall {traced * 1e3:.2f} ms, device busy "
          f"{busy_ms:.2f} ms, idle share {1 - busy_ms / (traced * 1e3):.4f},"
          f" {len(dev)} device operations")
    by_class, by_name = {}, {}
    for e in dev:
        ms = e.time_range.elapsed_us() / 1e3
        c = kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + ms
        by_name.setdefault(e.name, [0, 0.0])
        by_name[e.name][0] += 1
        by_name[e.name][1] += ms
    for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"{ms:10.3f} ms  {c}")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :TOP]:
        print(f"{ms:10.3f} ms {n:6d}x  {name[:100]}")
    print(f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
