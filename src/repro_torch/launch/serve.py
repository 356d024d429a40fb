"""Serving launcher of the port: continuous-batching greedy decode on one
CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
        --slots 8 --max-len 2048 --kv-quant --requests 16 \
        --prompt-lens 256,1024,1536

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --slots 8 --max-len 2048 --requests 16 --prompt-lens 256,1024,1536

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
        --reduced --ckpt build/ck --requests 4

serves the global model of a training checkpoint (``--ckpt``, written by
either package's train launcher, dense or sharded; ``--codec`` names the
training run's codec for EF-bank layouts; ``repro_torch.serve.bridge``
takes the client mean), or without ``--ckpt`` seed-initialized params (the
weights' values do not change the work): the dense family (qwen2.5-14b,
qwen1.5-4b, granite-20b, deepseek-67b), the vlm family (internvl2-76b,
with prefix embeddings), the moe family (qwen3-moe-30b-a3b,
llama4-scout-17b-a16e), the ssm family (falcon-mamba-7b, its prefill on
the ``mamba_scan`` kernel), the hybrid family (zamba2-1.2b) and the encdec
family (whisper-tiny: each request carries ``--max-len`` frames of
encoder embeddings from the load generator); ``--kv-quant`` needs an
attention KV cache, so the ssm and hybrid families refuse it. ``--device cpu`` runs the plain PyTorch paths on the CPU, for a
``--reduced`` model. The flags are the JAX launcher's; those that need a
part of the port still to come raise and name it: ``--mesh local`` (the
sharding slice), ``--metrics-out`` (the obs/ slice).
"""
from __future__ import annotations

import argparse
import time

from repro_torch import device as devlib
from repro_torch.configs import get_arch, reduced
from repro_torch.models import init_params, model_specs
from repro_torch.fed.serve import KV_KERNELS
from repro_torch.serve import (Engine, LoadSpec, generate_requests,
                               load_serve_params, replay)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="architecture id (repro_torch.configs."
                         "list_arch_ids(): whisper-tiny, zamba2-1.2b, "
                         "qwen2.5-14b, internvl2-76b, qwen3-moe-30b-a3b, "
                         "falcon-mamba-7b, deepseek-67b, granite-20b, "
                         "llama4-scout-17b-a16e, qwen1.5-4b)")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size variant of the same family")
    ap.add_argument("--ckpt", default=None,
                    help="serve the global model of this training "
                         "checkpoint (either package's train launcher, "
                         "dense or --ckpt-shards; the bridge takes the "
                         "client mean)")
    ap.add_argument("--codec", default="none",
                    help="the training run's codec (none/int8/topk), read "
                         "with --ckpt: lossy runs checkpoint an EF bank")
    ap.add_argument("--slots", type=int, default=8,
                    help="continuous-batching slot-pool size (the shared "
                         "decode step's batch)")
    ap.add_argument("--max-len", type=int, default=256,
                    help="per-slot KV-cache capacity (prompt + generated)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV-cache pool: prefill rows quantize on the "
                         "way in, decode attends through the int8 kernel "
                         "(the attention families; ssm and hybrid raise; "
                         "the encdec cross cache stays dense)")
    ap.add_argument("--kv-kernel", default="auto", choices=list(KV_KERNELS),
                    help="path of prefill and int8 decode: kernel (the "
                         "CUDA kernels: flash attention, int8 decode, the "
                         "selective scan), xla (the reference's paths: "
                         "attend_full, dequantize then attend_decode, the "
                         "chunked scan); auto = the kernels on a CUDA "
                         "device, their plain versions on the CPU")
    ap.add_argument("--mesh", default="none", choices=["none", "local"],
                    help="local raises: sharded serving comes with the "
                         "port's sharding slice")
    ap.add_argument("--requests", type=int, default=32,
                    help="synthetic open-loop request count")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate, requests/sec (0 = all "
                         "arrive at t=0: max-throughput drain)")
    ap.add_argument("--prompt-lens", default="8,16,32",
                    help="comma-separated prompt-length buckets")
    ap.add_argument("--max-new", type=int, default=32,
                    help="per-request generation budget cap")
    ap.add_argument("--mean-new", type=float, default=16.0,
                    help="mean of the geometric output-length draw")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="retire a slot when this token is generated")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the params and of the load generator")
    ap.add_argument("--metrics-out", default=None,
                    help="telemetry JSONL; not ported yet (raises): it "
                         "comes with the obs/ slice")
    ap.add_argument("--metrics-every", type=int, default=8,
                    help="flush telemetry every K ticks (with "
                         "--metrics-out)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError("--mesh local: sharded serving comes with "
                                  "the port's sharding slice")
    if args.metrics_out:
        raise NotImplementedError("--metrics-out: telemetry comes with the "
                                  "port's obs/ slice")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.slots < 1:
        raise SystemExit("--slots must be >= 1")
    prompt_lens = tuple(int(x) for x in args.prompt_lens.split(","))
    if max(prompt_lens) >= args.max_len:
        raise SystemExit(f"--prompt-lens {max(prompt_lens)} must stay below "
                         f"--max-len {args.max_len} (the cache holds prompt "
                         f"+ generated tokens)")
    dev = devlib.resolve(args.device)
    if args.ckpt:
        params, info = load_serve_params(args.ckpt, cfg, codec=args.codec,
                                         device=dev)
        print(f"loaded {args.ckpt}: layout={info['layout']} "
              f"clients={info['clients']} step={info['step']}")
    else:
        params = init_params(model_specs(cfg),
                             devlib.generator(dev, args.seed), cfg.dtype)
        print(f"serving seed-initialized {cfg.name} params on {dev}")
    engine = Engine(cfg, params, slots=args.slots, max_len=args.max_len,
                    kv_quant=args.kv_quant, kv_kernel=args.kv_kernel,
                    eos_id=args.eos_id, device=dev)
    spec = LoadSpec(n_requests=args.requests, rate=args.rate,
                    prompt_lens=prompt_lens, mean_new_tokens=args.mean_new,
                    max_new_cap=args.max_new, seed=args.seed)
    pre = ((cfg.n_prefix_embeds, cfg.d_model) if cfg.n_prefix_embeds
           else None)
    enc = ((args.max_len, cfg.d_model) if cfg.family == "encdec"
           else None)
    reqs = generate_requests(spec, cfg.vocab, enc_shape=enc,
                             prefix_shape=pre)
    t0 = time.perf_counter()
    done = replay(engine, reqs)
    wall = time.perf_counter() - t0
    toks = sum(len(c.tokens) for c in done)
    lats = sorted(c.latency_s for c in done)
    p = lambda q: lats[min(int(q * len(lats)), len(lats) - 1)]  # noqa: E731
    print(f"served {len(done)} requests in {wall:.2f}s — "
          f"{len(done) / wall:.2f} req/s, {toks / wall:.1f} tok/s, "
          f"p50 {p(0.5):.3f}s, p99 {p(0.99):.3f}s")
    return done


if __name__ == "__main__":
    main()
