#!/usr/bin/env python3
"""The mega-scan phases of ``chip_smoke.py`` on their own, on one CUDA card.

Usage, from the root of a checkout on a machine with one CUDA card::

    python3 scripts/megascan_phases.py

Builds the kernels, then runs ``chip_smoke.megascan_phases``: every
``FedDriver`` engine at MNIST width at ``rounds_per_scan`` 4 against 1,
and the train CLI on qwen1.5-4b at full width (4 layers) at
``--rounds-per-scan 2`` against 1, each chunk under
``torch.cuda.set_sync_debug_mode("error")``, bit for bit; prints each
run's steady ms a round and peak memory, the seconds each phase took and
the launches. Prints the card's name and power limit first. Imports no
JAX.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("megascan_phases: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fkern
    from repro_torch.kernels import mamba_scan as mk
    from repro_torch.kernels import quant_decode as qd
    from repro_torch.kernels import quantize as qkern
    from repro_torch.kernels import storm_update as kern

    print(chip_smoke.gpu_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    _build.build_all()
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    launches = chip_smoke.megascan_phases(torch, (kern, qkern, fkern, qd,
                                                  mk))
    print(f"megascan phases: {time.time() - t0:.1f} s, launches "
          f"{launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
