#!/usr/bin/env python3
"""Seconds to get page-locked host memory for the host-spill bank, three
ways, on one CUDA card:

    python3 scripts/pin_times.py [--gb 15.8]

  register   ``torch.empty`` then ``cudaHostRegister`` (the exact size);
  caching    ``torch.empty(..., pin_memory=True)``: PyTorch's caching host
             allocator (``cudaHostAlloc`` of the size rounded up to a power
             of two);
  driver     ``repro_torch.fed.spill._pinned_bytes`` (``cuMemHostAlloc`` of
             the exact size), what the bank uses.

Each is followed by a host-to-device copy of a quarter of it (its GB/s
shows the memory is pinned) and freed before the next. Prints the card's
name and power limit first.
"""
from __future__ import annotations

import argparse
import gc
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def h2d_gbs(torch, host):
    n = host.numel() // 4
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    dev.copy_(host[:n], non_blocking=True)
    torch.cuda.synchronize()
    return n / (time.time() - t0) / 1e9


def main() -> int:
    import torch
    from repro_torch.fed.spill import _pinned_bytes

    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=15.8)
    nb = int(ap.parse_args().gb * 1e9)
    if not torch.cuda.is_available():
        print("pin_times: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.zeros(1, device="cuda")
    rt = torch.cuda.cudart()

    def register():
        t = torch.empty(nb, dtype=torch.uint8)
        torch.cuda.check_error(rt.cudaHostRegister(t.data_ptr(), nb, 0))
        return t

    def unregister(t):
        torch.cuda.check_error(rt.cudaHostUnregister(t.data_ptr()))

    ways = [("register", register, unregister),
            ("caching", lambda: torch.empty(nb, dtype=torch.uint8,
                                            pin_memory=True), None),
            ("driver", lambda: _pinned_bytes(nb), None)]
    for name, get, release in ways:
        t0 = time.time()
        host = get()
        secs = time.time() - t0
        if not host.is_pinned():
            raise AssertionError(f"{name}: the memory is not pinned")
        print(f"{name}: {nb / 1e9:.2f} GB pinned in {secs:.2f} s, H2D "
              f"{h2d_gbs(torch, host):.1f} GB/s", flush=True)
        if release is not None:
            release(host)
        del host
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
