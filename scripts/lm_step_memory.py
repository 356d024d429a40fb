#!/usr/bin/env python3
"""Device memory of the port's LM trainer on one CUDA card: the peak of
the init and of one local step, and the allocations live at the step's
peak, grouped by size and by the innermost frames of the port that made
them (replayed from the caching allocator's trace).

Usage, on a machine with one CUDA card::

    python3 scripts/lm_step_memory.py --arch internvl2-76b --layers 1 2 \\
        [--seq 1024] [--batch 8] [--src DIR]

Each ``--layers`` depth runs in turn: the arch at full width with its
depth cut, bf16 params from a seed, chip_smoke.py's LM_FAMILY_FED
FedConfig, one client, ``ShapeConfig("cli", seq, batch)``. A depth that
runs out of memory prints so and the next one runs. ``--src`` is the
``src`` directory of the checkout to measure (default: this checkout's);
to compare two commits, unpack the other one's ``src/repro_torch`` with
``git archive`` into a directory that ``.gitignore`` lists and run both in
one machine call. Allocations made before the step (the states, the
params' views) hold no trace entry and show as the difference between the
step's peak and the traced one. Prints the card's name and power limit
first. Imports no JAX.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GIB = 2 ** 30


def where(frames, depth=3):
    """The innermost ``depth`` frames of the port (or of this script)."""
    out = []
    for f in frames or ():
        name = f["filename"]
        if "repro_torch" in name or name.endswith("lm_step_memory.py"):
            out.append(f"{name.split('/')[-1]}:{f['line']}")
            if len(out) == depth:
                break
    return " < ".join(out) or "(no Python frame: made inside autograd)"


def at_peak(snapshot, top):
    """Replay the trace: the live allocations when the traced total
    peaked, grouped by (frames, size)."""
    live, cur, best, best_live = {}, 0, 0, {}
    for ev in snapshot["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > best:
                best, best_live = cur, dict(live)
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
    total, count = collections.Counter(), collections.Counter()
    for ev in best_live.values():
        key = (where(ev.get("frames")), ev["size"])
        total[key] += ev["size"]
        count[key] += 1
    print(f"  traced peak {best / GIB:.2f} GiB; the largest groups:",
          flush=True)
    for (frames, size), nbytes in total.most_common(top):
        print(f"  {nbytes / GIB:7.2f} GiB  {count[(frames, size)]:3d} x "
              f"{size / 2 ** 20:9.1f} MiB  {frames}", flush=True)


def measure(torch, cs, arch, layers, seq, batch, top):
    from repro_torch import device as devlib
    from repro_torch.configs import FedConfig, ShapeConfig, get_arch
    from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                            make_client_batch)
    from repro_torch.fed.runtime import (FederatedTrainer, NeumannDraws,
                                         client_batch_specs)
    from repro_torch.launch.train import PARAM_SALT

    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    fed = FedConfig(**cs.LM_FAMILY_FED)
    shape = ShapeConfig("cli", seq, batch, "train")
    tr = FederatedTrainer(cfg, fed, shape, device="cuda")
    specs = client_batch_specs(cfg, shape, tr.m, fed)
    data = FederatedLMData(vocab=cfg.vocab, n_clients=tr.m,
                           draws=TorchLMDraws(0, "cuda"))
    depths = NeumannDraws(0, fed.neumann_k, tr.m, "cuda")
    b = make_client_batch(data, cfg, specs, 0, "cuda")
    what = f"{arch} at {layers} of {get_arch(arch).n_layers} layers, seq {seq}"
    torch.cuda.reset_peak_memory_stats()
    try:
        params = tr.init_params(devlib.generator("cuda", 0, PARAM_SALT))
        states, server = tr.init_states(params, b, depths.init())
        del params
        torch.cuda.synchronize()
        print(f"{what}: init peak "
              f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB, the "
              f"states {torch.cuda.memory_allocated() / GIB:.2f} GiB",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(max_entries=400_000)
        states, server = tr.local_step_fn()(states, server, b,
                                            depths.step(0))
        torch.cuda.synchronize()
        print(f"{what}: local step peak "
              f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB",
              flush=True)
        at_peak(torch.cuda.memory._snapshot(), top)
    except torch.cuda.OutOfMemoryError as e:
        print(f"{what}: out of memory ({str(e).splitlines()[0]})",
              flush=True)
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    states = server = None
    cs.free_device_memory(torch)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--arch", required=True)
    parser.add_argument("--layers", type=int, nargs="+", required=True)
    parser.add_argument("--seq", type=int, default=1024)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--top", type=int, default=12,
                        help="groups of live allocations to print")
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="the src directory whose repro_torch to measure")
    opts = parser.parse_args()
    src = Path(opts.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("lm_step_memory: no CUDA device available", file=sys.stderr)
        return 1
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}, "
                           f"not from {src}")
    # chip_smoke.py's FedConfig and helpers; imported after repro_torch, so
    # the path it puts first does not replace it
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    print(cs.gpu_line(), flush=True)
    print(f"repro_torch from {src}", flush=True)
    for layers in opts.layers:
        measure(torch, cs, opts.arch, layers, opts.seq, opts.batch,
                opts.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
