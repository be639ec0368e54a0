"""Serving CLI of the PyTorch port — the twin of ``repro/launch/serve.py``.

Batched generation with random weights from a seed:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --batch 4 --prompt-len 32 --gen 16

Continuous batching of N requests through the replica router, paged KV,
both CUDA kernels:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --requests 16 --replicas 1 --slots 8 --prompt-len 512 --gen 64 \
      --block-size 16 --paged-kernel --impl kernel

The other dense families (``--arch gemma3-12b``, ``stablelm-12b`` with
its LayerNorm and head_dim 160, ``qwen2.5-32b`` with its qkv biases) serve
the same way, as do the Mixture-of-Experts models (``--arch olmoe-1b-7b``,
13.8 GB in bf16, and ``phi3.5-moe-42b-a6.6b``, 83.7 GB: more than one
card holds) and the recurrent families (``--arch mamba2-370m`` or
``--arch recurrentgemma-2b``).  A Mamba-2 prompt must be at most one SSD
chunk (128 tokens; 32 reduced) or a whole number of chunks, since prefill
is never padded:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --reduced --device cpu --requests 4 --replicas 1 --slots 2 \
      --prompt-len 32 --gen 8

Fault-routed serving under a ``repro_torch.sim`` scenario, with SLOs,
autoscaling, a smaller paged pool, self-drafting speculative decode, or
the client -> edge -> server stages (``--mode split``, default cuts the
WSSL config's), as the JAX CLI takes them:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
      --reduced --device cpu --requests 8 --replicas 2 --slots 2 \
      --prompt-len 24 --gen 8 --block-size 8 --scenario replica-drop \
      --speculate --deadline-slack 4 --autoscale-max 3

Runs on the card; ``--device cpu`` runs the plain PyTorch path instead
(with ``--reduced`` for a size the CPU can take).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.config import Scenario, WSSLConfig, get_arch, reduced
from repro_torch.data.synthetic import make_token_stream
from repro_torch.models import transformer as tf
from repro_torch.models.layers import resolve_device
from repro_torch.serve import (DecodeEngine, FaultRoutedServer, Request,
                               ServeParams, ServeReport, synthetic_requests)
from repro_torch.sim import get_scenario


def serve_max_len(prompt_len: int, gen: int, margin: int,
                  block_size: int) -> int:
    """Cache capacity per slot: prompt + generation + the overshoot
    ``margin`` (one chunk, or a speculative round's drafts if longer),
    rounded up to whole blocks in paged mode."""
    max_len = prompt_len + gen + margin
    if block_size:
        max_len += (-max_len) % block_size
    return max_len


def serve(engine: DecodeEngine, params, requests: Sequence[Request],
          sp: ServeParams, scenario: Optional[Scenario] = None
          ) -> Tuple[ServeReport, float]:
    """Serve ``requests`` through the replica router under ``scenario``
    (default clean); returns the report and the wall-clock seconds of the
    run (the device is synchronised at the end, so the time covers the
    work)."""
    server = FaultRoutedServer(engine, params, sp, scenario=scenario)
    t0 = time.perf_counter()
    report = server.run(requests)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return report, time.perf_counter() - t0


def profile_serve(engine: DecodeEngine, params, requests: Sequence[Request],
                  sp: ServeParams, path: Path,
                  scenario: Optional[Scenario] = None
                  ) -> Tuple[ServeReport, float]:
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
        report, secs = serve(engine, params, requests, sp, scenario)
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
                    help="gemma-2b | gemma3-12b | stablelm-12b | "
                         "qwen2.5-32b | olmoe-1b-7b | phi3.5-moe-42b-a6.6b | "
                         "mamba2-370m | recurrentgemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--impl", default="dense",
                    help="prefill attention: dense | kernel (alias pallas)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", choices=["merged", "split"], default="merged")
    ap.add_argument("--cuts", default=None,
                    help="comma-separated cut layers for --mode split "
                         "(default: the WSSL config's resolved cuts)")
    ap.add_argument("--requests", type=int, default=0,
                    help="serve N queued requests through the replica "
                         "router instead of one batched generate")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--scenario", default="clean")
    ap.add_argument("--block-size", type=int, default=0,
                    help="paged KV block size in tokens (0 = contiguous)")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="paged KV pool size (0 = full residency)")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="paged decode via the CUDA block-table kernel "
                         "instead of the gather (needs --block-size)")
    ap.add_argument("--speculate", action="store_true",
                    help="self-drafting speculative decode (greedy only)")
    ap.add_argument("--draft-k", type=int, default=4)
    ap.add_argument("--deadline-slack", type=float, default=0.0,
                    help="attach deadline = arrival + ideal_latency x slack "
                         "to every request (0 = no SLOs)")
    ap.add_argument("--autoscale-max", type=int, default=0,
                    help="replica ceiling for queue-driven autoscaling "
                         "(0 = fixed fleet)")
    ap.add_argument("--profile", type=Path, default=None,
                    help="with --requests: profile the run and write the "
                         "device-time breakdown to this JSON file")
    args = ap.parse_args(argv)
    if args.cuts and args.mode != "split":
        ap.error("--cuts only takes effect with --mode split")
    if args.paged_kernel and not args.block_size:
        ap.error("--paged-kernel needs a paged cache (--block-size)")

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tf.init_params(cfg, gen, device=device)
    cuts = None
    if args.mode == "split":
        cuts = (tuple(int(c) for c in args.cuts.split(","))
                if args.cuts else WSSLConfig().resolve_cuts(cfg))
    engine = DecodeEngine(cfg, impl=args.impl, cuts=cuts,
                          paged_kernel=args.paged_kernel, device=device)

    if args.requests > 0:
        sc = get_scenario(args.scenario)
        margin = max(args.chunk, args.draft_k if args.speculate else 0)
        sp = ServeParams(replicas=args.replicas, slots=args.slots,
                         chunk=args.chunk,
                         max_len=serve_max_len(args.prompt_len, args.gen,
                                               margin, args.block_size),
                         seed=args.seed, block_size=args.block_size,
                         pool_blocks=args.pool_blocks,
                         speculate=args.speculate, draft_k=args.draft_k,
                         autoscale_max=args.autoscale_max)
        reqs = synthetic_requests(cfg, args.requests,
                                  prompt_len=args.prompt_len, gen=args.gen,
                                  seed=args.seed)
        if args.deadline_slack > 0:
            reqs = [dataclasses.replace(
                r, deadline=r.arrival + (r.prompt_len * sp.prefill_unit
                                         + r.max_new) * args.deadline_slack)
                    for r in reqs]
        if args.profile is not None:
            report, dt = profile_serve(engine, params, reqs, sp, args.profile,
                                       sc)
        else:
            report, dt = serve(engine, params, reqs, sp, sc)
        pct = report.percentiles
        print(f"arch={cfg.name} device={device} mode={args.mode} "
              f"scenario={sc.name} replicas={args.replicas} "
              f"slots={args.slots}: {report.tokens_out} tokens in {dt:.2f}s "
              f"wall ({report.tokens_out / max(dt, 1e-9):.1f} tok/s), "
              f"sim_time={report.sim_time:.0f} ticks={report.ticks} "
              f"reroutes={report.reroutes} rejected={len(report.rejected)} "
              f"peak_replicas={report.peak_replicas}")
        print(f"latency p50={pct['p50']:.1f} p95={pct['p95']:.1f} "
              f"p99={pct['p99']:.1f} (decode-step units)  shapes: "
              f"decode={report.decode_compiles} "
              f"prefill={report.prefill_compiles} "
              f"draft={report.draft_compiles} "
              f"verify={report.verify_compiles}")
        if report.drafted:
            print(f"speculative: {report.spec_rounds} rounds, "
                  f"acceptance {report.acceptance:.2f} "
                  f"({report.accepted}/{report.drafted} drafts)")
        if report.slo and args.deadline_slack > 0:
            print("slo:", report.slo)
        if report.unfinished:
            print(f"WARNING: max_ticks={sp.max_ticks} hit with "
                  f"{report.unfinished} requests unfinished — the trace "
                  f"was truncated, not drained")
        print("log:", report.log.summary())
        return

    prompts = make_token_stream(args.batch, args.prompt_len, cfg.vocab_size,
                                seed=args.seed)
    t0 = time.perf_counter()
    toks = engine.generate(params, prompts, args.gen)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={device} mode={args.mode} "
          f"batch={args.batch} prompt={args.prompt_len} gen={args.gen}: "
          f"{dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample continuation:", toks[0][:16].tolist())


if __name__ == "__main__":
    main()
