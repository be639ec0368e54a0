"""Serving CLI of the PyTorch port — the twin of ``repro/launch/serve.py``.

Batched generation with random weights from a seed:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --batch 4 --prompt-len 32 --gen 16

Continuous batching of N requests through the replica router, paged KV,
both CUDA kernels:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --requests 16 --replicas 1 --slots 8 --prompt-len 512 --gen 64 \
      --block-size 16 --paged-kernel --impl kernel

The recurrent families serve the same way (``--arch mamba2-370m`` or
``--arch recurrentgemma-2b``).  A Mamba-2 prompt must be at most one SSD
chunk (128 tokens; 32 reduced) or a whole number of chunks, since prefill
is never padded:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --reduced --device cpu --requests 4 --replicas 1 --slots 2 \
      --prompt-len 32 --gen 8

Runs on the card; ``--device cpu`` runs the plain PyTorch path instead
(with ``--reduced`` for a size the CPU can take).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Sequence, Tuple

import torch

from repro_torch.config import get_arch, reduced
from repro_torch.data.synthetic import make_token_stream
from repro_torch.models import transformer as tf
from repro_torch.models.layers import resolve_device
from repro_torch.serve import (DecodeEngine, FaultRoutedServer, Request,
                               ServeParams, ServeReport, synthetic_requests)


def serve_max_len(prompt_len: int, gen: int, chunk: int,
                  block_size: int) -> int:
    """Cache capacity per slot: prompt + generation + one chunk of
    overshoot, rounded up to whole blocks in paged mode."""
    max_len = prompt_len + gen + chunk
    if block_size:
        max_len += (-max_len) % block_size
    return max_len


def serve(engine: DecodeEngine, params, requests: Sequence[Request],
          sp: ServeParams) -> Tuple[ServeReport, float]:
    """Serve ``requests`` through the replica router; returns the report and
    the wall-clock seconds of the run (the device is synchronised at the
    end, so the time covers the work)."""
    server = FaultRoutedServer(engine, params, sp)
    t0 = time.perf_counter()
    report = server.run(requests)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return report, time.perf_counter() - t0


def profile_serve(engine: DecodeEngine, params, requests: Sequence[Request],
                  sp: ServeParams, path: Path) -> Tuple[ServeReport, float]:
    """:func:`serve` under ``torch.profiler`` (CPU and CUDA activity).
    Writes to ``path`` (JSON) the wall time, the summed device time of
    the kernels, the device's busy share of the wall time, and the kernels
    by device time; returns what :func:`serve` returns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if engine.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        report, secs = serve(engine, params, requests, sp)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    out = {"wall_s": secs, "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / secs,
           "kernels": [{"name": e.key, "count": e.count,
                        "device_ms": e.self_device_time_total / 1e3}
                       for e in kernels]}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return report, secs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="gemma-2b | mamba2-370m | recurrentgemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--impl", default="dense",
                    help="prefill attention: dense | kernel (alias pallas)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=0,
                    help="serve N queued requests through the replica "
                         "router instead of one batched generate")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=0,
                    help="paged KV block size in tokens (0 = contiguous)")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="paged decode via the CUDA block-table kernel "
                         "instead of the gather (needs --block-size)")
    ap.add_argument("--profile", type=Path, default=None,
                    help="with --requests: profile the run and write the "
                         "device-time breakdown to this JSON file")
    args = ap.parse_args(argv)
    if args.paged_kernel and not args.block_size:
        ap.error("--paged-kernel needs a paged cache (--block-size)")

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tf.init_params(cfg, gen, device=device)
    engine = DecodeEngine(cfg, impl=args.impl, paged_kernel=args.paged_kernel,
                          device=device)

    if args.requests > 0:
        sp = ServeParams(replicas=args.replicas, slots=args.slots,
                         chunk=args.chunk,
                         max_len=serve_max_len(args.prompt_len, args.gen,
                                               args.chunk, args.block_size),
                         seed=args.seed, block_size=args.block_size)
        reqs = synthetic_requests(cfg, args.requests,
                                  prompt_len=args.prompt_len, gen=args.gen,
                                  seed=args.seed)
        if args.profile is not None:
            report, dt = profile_serve(engine, params, reqs, sp, args.profile)
        else:
            report, dt = serve(engine, params, reqs, sp)
        pct = report.percentiles
        print(f"arch={cfg.name} device={device} replicas={args.replicas} "
              f"slots={args.slots}: {report.tokens_out} tokens in {dt:.2f}s "
              f"wall ({report.tokens_out / max(dt, 1e-9):.1f} tok/s), "
              f"sim_time={report.sim_time:.0f} ticks={report.ticks}")
        print(f"latency p50={pct['p50']:.1f} p95={pct['p95']:.1f} "
              f"p99={pct['p99']:.1f} (decode-step units)  shapes: "
              f"decode={report.decode_compiles} "
              f"prefill={report.prefill_compiles}")
        if report.unfinished:
            print(f"WARNING: max_ticks={sp.max_ticks} hit with "
                  f"{report.unfinished} requests unfinished")
        print("log:", report.log.summary())
        return

    prompts = make_token_stream(args.batch, args.prompt_len, cfg.vocab_size,
                                seed=args.seed)
    t0 = time.perf_counter()
    toks = engine.generate(params, prompts, args.gen)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={device} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}: {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample continuation:", toks[0][:16].tolist())


if __name__ == "__main__":
    main()
