"""Where the serve path spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch qwen2.5-14b | falcon-mamba-7b | zamba2-1.2b]

Builds the architecture at full width (seeded bf16 params, the
configurations of ``chip_smoke.py``'s serve phases) behind
``Engine(slots=8, max_len=2048)``, with the int8 KV pool for the families
that have an attention KV cache (qwen2.5-14b; the ssm and hybrid families
refuse it), fills the 8 slots with prompts of ``PROMPT`` tokens (the
first admission warms up), then traces one more admission (a prefill) and
``TICKS`` decode ticks with ``torch.profiler``: the host-clock time of
each, the device's busy time (the sum of kernel and copy durations) and
idle share, the number of device operations, and the operations that take
the most device time (the first ``TOP``). ``--reduced --device cpu``
rehearses the script on the CPU (no device numbers then). Needs a CUDA
device otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import device as devlib
from repro_torch.configs import get_arch, reduced
from repro_torch.models import init_params, model_specs
from repro_torch.serve import Engine, Request
from repro_torch.serve.engine import QUANT_FAMILIES

PROMPT = 1024   # tokens per prompt
TICKS = 4       # decode ticks traced
TOP = 15        # operations listed by device time


def report(label, prof, wall_s):
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    print(f"{label}: wall {wall_s * 1e3:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / (wall_s * 1e3):.4f}, {len(ops)} device "
          f"operations")
    by_name = {}
    for e in ops:
        by_name.setdefault(e.name, [0, 0.0])
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    for name, (n, ms) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:TOP]:
        print(f"  {ms:9.3f} ms {n:6d}x  {name[:100]}")
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    print("  host operators by self time:")
    for a in host[:TOP]:
        print(f"  {a.self_cpu_time_total / 1e3:9.3f} ms {a.count:6d}x  "
              f"{a.key[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = devlib.resolve(args.device)
    cfg = get_arch(args.arch)
    prompt = PROMPT
    if args.reduced:
        cfg, prompt = reduced(cfg), 16
    params = init_params(model_specs(cfg), devlib.generator(dev, 0),
                         cfg.dtype)
    kv_quant = cfg.family in QUANT_FAMILIES
    eng = Engine(cfg, params, slots=8, max_len=2 * prompt,
                 kv_quant=kv_quant, device=dev)
    rng = np.random.default_rng(0)

    def request(rid):
        return Request(rid=rid, tokens=rng.integers(
            0, cfg.vocab, prompt).astype(np.int32), max_new_tokens=prompt)

    for rid in range(7):                      # warm-up admissions and ticks
        eng.submit(request(rid))
        eng.step()
    devlib.fence(dev)
    eng.submit(request(7))
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        eng._admit(eng._queue.popleft(), eng._free.pop(), [])
        devlib.fence(dev)
        wall = time.perf_counter() - t0
    report(f"admission ({prompt}-token prefill, "
           f"{'int8 quantize and ' if kv_quant else ''}scatter)", prof, wall)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(TICKS):
            eng.step()
        devlib.fence(dev)
        wall = time.perf_counter() - t0
    report(f"{TICKS} decode ticks (8 active slots)", prof, wall)
    ms = {k: [round(1e3 * t, 2) for t in v] for k, v in eng.timings.items()}
    print(f"host clock: admissions {ms['prefill']} ms; ticks {ms['decode']} "
          f"ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
