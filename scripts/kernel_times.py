#!/usr/bin/env python3
"""Times the PyTorch port's flash_attention, mamba_scan and
quant_decode_attention kernels of one checkout at chip_smoke.py's flash,
scan and decode shapes, two ways:

- ``ms``: the card's time, as chip_smoke.py's ``time_ms`` takes it (a spin
  kernel queued before each call, so the host's issue is hidden);
- ``one_call_ms``: one call between two events on an idle card, the host's
  issue of the call included (how chip_smoke.py timed kernels before it
  hid the issue);

and the decode also ``cold_ms``: the card's time of a call whose pool is
outside L2 (chip_smoke.py's ``qd_cold``: a rotation of pools, 100 MB in
all), as each layer of a serve tick finds it.

Usage, on a machine with one CUDA card and ``nvcc``::

    python3 scripts/kernel_times.py [--src DIR] [--kernels NAME ...]

``--src`` is the ``src`` directory of the checkout whose kernels are timed
(default: this checkout's); they are built into that checkout's
``build/kernels/``. To compare two commits like for like, unpack the other
one's ``src/repro_torch`` with ``git archive`` into a directory that
``.gitignore`` lists and run both in one machine call, in the order other,
this, this, other. The three wrappers' signatures have not changed since
they were added. ``--kernels`` times only the kernels named. Prints the
card's name and power limit, then one JSON line per kernel and shape.
Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("flash_attention", "mamba_scan", "quant_decode_attention")


def one_call_ms(torch, fn, reps=30, warmup=3):
    """Median time of one call of ``fn`` between two CUDA events, the card
    idle before each: the host's issue of the call counts."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="the src directory whose repro_torch to time")
    parser.add_argument("--kernels", nargs="+", default=list(KERNELS),
                        choices=KERNELS, help="the kernels to time")
    opts = parser.parse_args()
    src = Path(opts.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as fkern
    from repro_torch.kernels import mamba_scan as mk
    from repro_torch.kernels import quant_decode as qd
    for mod in (fkern, mk, qd):
        if not Path(mod.__file__).resolve().is_relative_to(src):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, "
                               f"not from {src}")
    # chip_smoke.py's shapes, inputs and device timing; imported after the
    # kernels, so the path it puts first does not replace them
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(cs.gpu_line(), flush=True)
    print(f"kernels of {src}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def report(name, label, fn, **extra):
        print(json.dumps({"kernel": name, "case": label, "src": str(src),
                          "ms": cs.time_ms(torch, fn),
                          "one_call_ms": one_call_ms(torch, fn),
                          **{k: cs.time_ms(torch, f)
                             for k, f in extra.items()}}), flush=True)

    if "flash_attention" in opts.kernels:
        for (label, b, h, kv, sq, sk, d, dtype, window,
             causal) in cs.FLASH_CASES:
            q, k, v = cs.flash_inputs(torch, gen, b, h, kv, sq, sk, d,
                                      getattr(torch, dtype))
            report("flash_attention", label,
                   lambda: fkern.flash_attention(q, k, v, causal=causal,
                                                 window=window))
    if "mamba_scan" in opts.kernels:
        for label, b, s, di, n, dtype in cs.SCAN_CASES:
            if label in cs.SCAN_TIMED:
                args = cs.scan_inputs(torch, gen, b, s, di, n,
                                      getattr(torch, dtype))
                report("mamba_scan", label, lambda: mk.mamba_scan(*args))
    if "quant_decode_attention" in opts.kernels:
        for label, b, h, kv, w, pos in cs.QD_CASES:
            q = torch.randn(b, h, 128, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            pool = cs.qd_pool(torch, qd, gen, b, kv, w, 128)
            p = cs.qd_positions(torch, pos)
            cold, _, _ = cs.qd_cold(torch, qd, gen, q, p, b, kv, w, 128)
            report("quant_decode_attention", label,
                   lambda: qd.quant_decode_attention(q, *pool, p),
                   cold_ms=cold)
            del cold
    return 0


if __name__ == "__main__":
    sys.exit(main())
