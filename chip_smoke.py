#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printing its lines before the last:

1. build   — compile the CUDA kernels of ``src/repro_torch/kernels/csrc``
             with nvcc for sm_90a.
2. kernels — hold each kernel against its plain PyTorch version
             (``kernels/ref.py``) on the card, in bf16 and fp32, at the
             serving path's shapes and a few edge cases; time the kernel,
             the plain version and, as a yardstick only, one library call.
3. serve   — serve full Gemma-2B (18 layers, bf16, random weights from a
             seed) through the port's serving path: 16 requests, one
             replica of 8 slots, paged KV, both kernels; every kernel must
             have launched on this run.
4. parity  — serve the same requests through the plain path (dense
             prefill, gathered paged decode) on the same weights; prefill
             logits must agree within a band, and greedy tokens wherever the
             top-2 margin exceeds twice that band.
5. card    — the card's name and power limit, as nvidia-smi gives them.

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the script
exits non-zero before that line; it also exits non-zero, printing no
result, when no card is present or the package is not beside it.

    python3 chip_smoke.py --record out/chip_smoke.json

also writes the full record of every phase to that JSON file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): memory rate, dense bf16 tensor-core
# rate, fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain version, max |diff|, per kernel and dtype.  Both sides
# keep fp32 scores, softmax and sums and round once at the end, so in bf16
# they differ by at most one rounding flip of an output: one bf16 ulp at
# the outputs' magnitude.  Flash outputs reach [2, 4) in the first causal
# rows (means of a few V rows), ulp 7.8e-3; paged outputs are means over
# >= 60 keys and stay below 1, ulp 3.9e-3 in [0.5, 1).  Observed on the
# H100: 1.95e-3 (flash) and 9.5e-7 (paged) in bf16.
BANDS = {"flash_attention": {"bfloat16": 8e-3, "float32": 1e-4},
         "paged_decode_attention": {"bfloat16": 4e-3, "float32": 1e-4}}
# prefill logits, kernel path vs plain path, bf16, max |diff|: the plain
# path rounds scores and probabilities to bf16 where the kernel keeps fp32,
# compounded over 18 layers; an 18-layer d_model-512 cut of the same model
# differs by 0.066-0.086 on logits of std ~1 (CPU run of these plain ops),
# so the band is 0.25.
LOGIT_BAND = 0.25


def _time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def check_flash(torch, ops, ref, *, b, hq, hkv, s, hd, dtype, window=None,
                softcap=None, seed=0):
    """Flash kernel vs its plain version on one case; returns its record."""
    import torch.nn.functional as F
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, hq, hd), generator=g, device="cuda").to(dt)
    k = torch.randn((b, s, hkv, hd), generator=g, device="cuda").to(dt)
    v = torch.randn((b, s, hkv, hd), generator=g, device="cuda").to(dt)
    kw = dict(causal=True, window=window, logit_softcap=softcap)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    plain = ref.flash_attention(qt, kt, vt, **kw).transpose(1, 2)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    rec = {"kernel": "flash_attention", "B": b, "S": s, "Hq": hq, "Hkv": hkv,
           "hd": hd, "dtype": dtype, "window": window, "softcap": softcap,
           "max_abs_err": err, "band": BANDS["flash_attention"][dtype]}
    rec["ms"] = _time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw))
    rec["plain_ms"] = _time_ms(torch, lambda: ref.flash_attention(
        qt, kt, vt, **kw))
    rec["library_ms"] = None
    if window is None and softcap is None:
        # yardstick only: SDPA on the same inputs, kv heads expanded first
        ke = kt.repeat_interleave(hq // hkv, dim=1)
        ve = vt.repeat_interleave(hq // hkv, dim=1)
        rec["library_ms"] = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, ke, ve, is_causal=True))
    pairs = sum(min(i + 1, window or s) for i in range(s))
    isz = q.element_size()
    nbytes = isz * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, 4.0 * b * hq * hd * pairs,
                                              dtype)
    return rec


def _paged_inputs(torch, *, b, hq, hkv, hd, bs, nb, dtype, pos_lo, seed,
                  dead_row):
    """Pool blocks dealt to rows by a random permutation; each row's entries
    hold their logical position up to pos[b].  Row 0 sits on a block
    boundary; with ``dead_row``, row 1 has no valid entry at all.  Returns
    the kernel's arguments on the card and (ppos, table, pos) in numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_blocks = b * nb + b
    perm = rng.permutation(n_blocks)[:b * nb].reshape(b, nb)
    pos = rng.integers(pos_lo, nb * bs, size=(b,))
    pos[0] = (pos[0] // bs) * bs
    ppos = np.full((n_blocks, bs), -1, np.int32)
    for r in range(b):
        if dead_row and r == 1:
            continue
        live = np.arange(nb * bs) <= pos[r]
        flat = np.where(live, np.arange(nb * bs), -1).reshape(nb, bs)
        ppos[perm[r]] = flat
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, hq, hd), generator=g, device="cuda").to(dt)
    pk = torch.randn((n_blocks, bs, hkv, hd), generator=g, device="cuda").to(dt)
    pv = torch.randn((n_blocks, bs, hkv, hd), generator=g, device="cuda").to(dt)
    as_i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device="cuda")
    return ((q, pk, pv, as_i32(ppos), as_i32(perm), as_i32(pos)),
            (ppos, perm, pos))


def check_paged(torch, ops, ref, *, b, hq, hkv, hd, bs, nb, dtype,
                pos_lo=0, seed=0, dead_row=True):
    """Paged decode kernel vs its plain version on one case."""
    args, (ppos, table, pos) = _paged_inputs(
        torch, b=b, hq=hq, hkv=hkv, hd=hd, bs=bs, nb=nb, dtype=dtype,
        pos_lo=pos_lo, seed=seed, dead_row=dead_row)
    out = ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    plain = ref.paged_decode_attention(*args)
    torch.cuda.synchronize()
    if dead_row and torch.count_nonzero(out[1]).item() != 0:
        raise AssertionError("paged kernel: the all-invalid row is not 0")
    err = (out.float() - plain.float()).abs().max().item()
    # the work the function needs: each row reads the table entries and
    # positions of its blocks j <= pos // bs, and the K and V of (and
    # computes with) only the entries whose position is in [0, pos]
    walked = [table[r, :min(int(pos[r]) // bs, nb - 1) + 1] for r in range(b)]
    valid = sum(int(((ppos[blks] >= 0) & (ppos[blks] <= pos[r])).sum())
                for r, blks in enumerate(walked))
    n_walked = sum(len(blks) for blks in walked)
    rec = {"kernel": "paged_decode_attention", "B": b, "Hq": hq, "Hkv": hkv,
           "hd": hd, "bs": bs, "nb": nb, "dtype": dtype, "dead_row": dead_row,
           "valid_entries": valid, "max_abs_err": err,
           "band": BANDS["paged_decode_attention"][dtype]}
    rec["ms"] = _time_ms(torch, lambda: ops.paged_decode_attention(*args))
    rec["plain_ms"] = _time_ms(torch, lambda: ref.paged_decode_attention(*args))
    rec["library_ms"] = None     # no single PyTorch call computes it
    isz = args[0].element_size()
    nbytes = (2 * b * hq * hd * isz              # q in, out
              + valid * hkv * hd * isz * 2       # valid K and V entries
              + n_walked * (bs + 1) * 4 + b * 4)  # ppos, table, pos
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, 4.0 * hq * hd * valid,
                                              dtype)
    return rec


def _check_band(rec):
    line = (f"  {rec['kernel']} " + " ".join(
        f"{k}={rec[k]}" for k in ("B", "S", "Hq", "Hkv", "hd", "bs", "nb",
                                  "dtype", "window", "softcap") if k in rec)
            + f": max|diff| {rec['max_abs_err']:.3g} (band {rec['band']:g}), "
            f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"library {rec['library_ms'] if rec['library_ms'] is None else round(rec['library_ms'], 4)} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    print(line, flush=True)
    if not rec["max_abs_err"] <= rec["band"]:
        raise AssertionError(f"{rec['kernel']} disagrees with its plain "
                             f"version: {rec}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", type=Path, default=None,
                    help="also write the full record of the run to this "
                         "JSON file")
    record_path = ap.parse_args(argv).record
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.config import get_arch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch.serve import serve, serve_max_len
    from repro_torch.models import transformer as tf
    from repro_torch.serve import DecodeEngine, ServeParams, synthetic_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"build: {len(paths)} kernels in {record['build_s']:.1f} s "
          f"({', '.join(p.name for p in paths.values())})", flush=True)

    # -- 2. kernels against their plain versions --------------------------
    print("kernels:", flush=True)
    checks = []
    main_flash = main_paged = None
    for dtype in ("bfloat16", "float32"):
        for s in (512, 397):
            checks.append(check_flash(torch, ops, ref, b=2, hq=8, hkv=1, s=s,
                                      hd=256, dtype=dtype, seed=s))
        checks.append(check_flash(torch, ops, ref, b=1, hq=8, hkv=1, s=300,
                                  hd=128, dtype=dtype, window=64, softcap=50.0,
                                  seed=3))
        checks.append(check_flash(torch, ops, ref, b=2, hq=4, hkv=2, s=200,
                                  hd=64, dtype=dtype, seed=4))
        checks.append(check_paged(torch, ops, ref, b=8, hq=8, hkv=1, hd=256,
                                  bs=16, nb=40, dtype=dtype, seed=5))
    # the serving path's own shapes: one 512-token prefill; 8 decode rows
    # over a 37-block table, live positions 256..591, every row live
    main_flash = check_flash(torch, ops, ref, b=1, hq=8, hkv=1, s=512,
                             hd=256, dtype="bfloat16", seed=6)
    main_paged = check_paged(torch, ops, ref, b=8, hq=8, hkv=1, hd=256, bs=16,
                             nb=37, dtype="bfloat16", pos_lo=256, seed=7,
                             dead_row=False)
    checks += [main_flash, main_paged]
    for rec in checks:
        _check_band(rec)
        torch.cuda.synchronize()
    record["kernel_checks"] = checks

    # -- 3. serve full Gemma-2B through the kernels -----------------------
    cfg = get_arch("gemma-2b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(cfg, gen, device="cuda")
    sp = ServeParams(replicas=1, slots=8, chunk=8, block_size=16,
                     max_len=serve_max_len(512, 64, 8, 16))
    reqs = synthetic_requests(cfg, 16, prompt_len=512, gen=64, seed=0)
    engine = DecodeEngine(cfg, impl="kernel", paged_kernel=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    report, secs = serve(engine, params, reqs, sp)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if report.unfinished or sorted(report.outputs) != list(range(len(reqs))):
        raise AssertionError(f"serve: unfinished requests ({report.unfinished})")
    for r in reqs:
        if len(report.outputs[r.rid]) != r.max_new:
            raise AssertionError(f"serve: request {r.rid} has "
                                 f"{len(report.outputs[r.rid])} tokens")
    chunks = len(report.log.ticks)      # one chunk per logged replica tick
    want = {"flash_attention": cfg.num_layers * len(reqs),
            "paged_decode_attention": cfg.num_layers * chunks * sp.chunk}
    if counts != want:
        raise AssertionError(f"serve: launches {counts}, expected {want}")
    record["serve"] = {"requests": len(reqs), "tokens": report.tokens_out,
                       "seconds": secs, "tokens_per_s": report.tokens_out / secs,
                       "chunks": chunks, "decode_steps": chunks * sp.chunk,
                       "launches": counts, "peak_bytes": peak,
                       "max_len": sp.max_len}
    print(f"serve: gemma-2b bf16, {len(reqs)} requests, {report.tokens_out} "
          f"tokens in {secs:.2f} s ({report.tokens_out / secs:.1f} tok/s), "
          f"{chunks * sp.chunk} decode steps, launches {counts}, peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)

    # -- 4. parity with the plain path on the same weights ---------------
    plain_engine = DecodeEngine(cfg, impl="dense", paged_kernel=False)
    ops.reset_launch_counts()
    plain_report, plain_secs = serve(plain_engine, params, reqs, sp)
    if any(ops.launch_counts().values()):
        raise AssertionError("the plain path launched a kernel")
    worst = 0.0
    compared = 0
    diverged = []
    for r in reqs:
        prompt = torch.as_tensor(r.prompt, dtype=torch.int32,
                                 device="cuda")[None]
        lk, _ = tf.prefill(params, cfg, prompt, impl="kernel", last_only=True)
        ld, _ = tf.prefill(params, cfg, prompt, impl="dense", last_only=True)
        if not torch.isfinite(lk).all():
            raise AssertionError(f"parity: non-finite logits, request {r.rid}")
        worst = max(worst, (lk - ld).abs().max().item())
        got, ref_toks = report.outputs[r.rid], plain_report.outputs[r.rid]
        for t, (a, b) in enumerate(zip(got, ref_toks)):
            compared += 1
            if a == b:
                continue
            # first divergence: allowed only where the plain path's top-2
            # margin at this step is within twice the band
            ctx = np.concatenate([r.prompt, np.asarray(ref_toks[:t], np.int32)])
            lg, _ = tf.prefill(params, cfg, torch.as_tensor(
                ctx, dtype=torch.int32, device="cuda")[None], impl="dense",
                last_only=True)
            top2 = torch.topk(lg[0, -1], 2).values
            margin = (top2[0] - top2[1]).item()
            if margin > 2 * LOGIT_BAND:
                raise AssertionError(
                    f"parity: request {r.rid} token {t} differs ({a} vs {b}) "
                    f"with top-2 margin {margin:.3f} > {2 * LOGIT_BAND}")
            diverged.append({"rid": r.rid, "token": t, "margin": margin})
            break
    if worst > LOGIT_BAND:
        raise AssertionError(f"parity: prefill logits differ by {worst:.4f} "
                             f"> band {LOGIT_BAND}")
    record["parity"] = {"logit_band": LOGIT_BAND, "max_logit_diff": worst,
                        "tokens_compared": compared, "diverged": diverged,
                        "plain_seconds": plain_secs,
                        "plain_tokens_per_s": plain_report.tokens_out / plain_secs}
    print(f"parity: prefill logits max|diff| {worst:.4f} (band {LOGIT_BAND}); "
          f"{compared} greedy tokens compared, {len(diverged)} requests "
          f"diverged within 2x band; plain path {plain_secs:.2f} s", flush=True)

    # -- 5. the card ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    record["nvidia_smi"] = smi
    print(smi.splitlines()[0], flush=True)

    sources = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:74"),
               "paged_decode_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                                          "src/repro/kernels/paged_attention.py:91")}
    kernels = []
    for rec in (main_flash, main_paged):
        src, replaces = sources[rec["kernel"]]
        kernels.append({"name": rec["kernel"], "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[rec["kernel"]],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    record["kernels"] = kernels
    if record_path is not None:
        record_path.parent.mkdir(parents=True, exist_ok=True)
        record_path.write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
