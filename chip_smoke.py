#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printing its lines before the last:

1. build   — compile the CUDA kernels of ``src/repro_torch/kernels/csrc``
             with nvcc for sm_90a, one nvcc per source, all at once;
             print the build's time and, for the attention and scan
             sources (built with -Xptxas -v), each kernel's registers and
             spills.
2d. scan kernels (run first, on an empty card) — the Mamba-2 SSD scan
             and the RG-LRU recurrence against their plain versions at the
             prefill step's shapes (SSD x (2, 4096, 32, 64) bf16, N 128,
             on the tensor-core pair; RG-LRU (2, 4096, 2560) fp32,
             bit-exact; both timed as CUDA-graph replays, the eager
             per-call rate beside, and the SSD pair's device time split
             by kernel from the profiler) and at edge cases (S = chunk,
             S = 64 < chunk, B = 3, fp32 on the SIMT body, a ragged P; the
             reduced config's P 32 / N 32 at S 100 on the tensor-core
             pair, and a bf16 P 40 / N 24 outside the pair's shapes on the
             SIMT body — each case's body asserted, and at most 1% of
             every bf16 case's outputs differing; W not a multiple of
             the RG-LRU CTA's 32 channels, S not a multiple of its 64-step
             stages, bf16); the flash kernel's tensor-core body at
             RecurrentGemma's 10 query heads over 1, window 2048, S 4096
             (every launch on that body).
10. prefill step — ``launch/steps.py::make_prefill_step`` of full
             Mamba-2-370M (48 layers) and full RecurrentGemma-2B (26
             layers), random weights from seed 0, tokens B 2 x S 4096,
             through the kernels (exactly 48 SSD scans; 18 RG-LRU scans
             and 8 flash launches; the bf16 SSD and flash launches all on
             their tensor-core bodies) and then the plain path: last-
             position logits within ``FAMILY_LOGIT_BAND`` and the greedy argmax
             equal wherever the plain path's top-2 margin exceeds 0.5, in
             bf16 (timed: medians of 3) and in fp32.
11. family serve — both models through the router and engine
             (``impl="kernel"``, greedy), then the plain path: Mamba-2 8
             requests of 128-512 tokens, contiguous cache; RecurrentGemma
             8 requests of 256-2304 tokens (past its window: the ring
             wraps), paged (which pages none of its layers); 32 new
             tokens each, one replica of 4 slots, decode chunk 8.  Tokens
             equal wherever the margin exceeds 0.5; flash launches 8 per
             RecurrentGemma admission, all on the tensor-core body, and
             nothing else launches (the engine's prefill runs the
             recurrent blocks' plain scans).
2. kernels — hold each serving kernel against its plain PyTorch version
             (``kernels/ref.py``) on the card, in bf16 and fp32, at the
             serving path's shapes and a few edge cases (flash at hd 256,
             128, 64 and 32, S 1 and 5, once not causal: bf16 on the
             tensor-core body within one bf16
             ulp at max|plain| and at most 1% of outputs differing, fp32
             on the SIMT body within 1e-4; paged decode, split-K, also at
             B 1 and with short rows whose splits are mostly neutral);
             time the kernel, the plain version and, as a yardstick only,
             one library call.  The attention kernels and SDPA are timed
             as CUDA-graph replays (device time: at the serving shapes a
             call's host cost exceeds its device time), with the eager
             per-call rate beside, and at the serving shapes each
             kernel's device time per call from the profiler.
2b. training kernels — the same for fused masked AdamW and the weighted
             client average, at one full-size Gemma-2B client leaf (the
             MLP gate of the 4-layer client stage, 2 clients: (2,
             134217728)) in fp32 and bf16 params; fused AdamW must be
             bit-exact in fp32 and keep the masked row.
3. serve   — serve full Gemma-2B (18 layers, bf16, random weights from a
             seed) through the port's serving path: 16 requests, one
             replica of 8 slots, paged KV, both kernels; every kernel must
             have launched on this run, flash always on the tensor-core
             body and paged decode always split-K.
4. parity  — serve the same requests through the plain path (dense
             prefill, gathered paged decode) on the same weights; prefill
             logits must agree within a band, and greedy tokens wherever the
             top-2 margin exceeds twice that band.
5. card    — the card's name and power limit, as nvidia-smi gives them.
6. train   — 3 synchronous WSSL rounds of full Gemma-2B (18 layers, fp32
             params, bf16 activations, random weights from a seed) through
             the port's training path (``launch/train.py``): 2 clients at
             participation 0.5 (round 0 selects both, rounds 1-2 one, so
             the mask freeze runs), cut at layer 4, seq 128, batch 2 per
             client, fused AdamW; then the trained client stack is
             aggregated through the weighted-average kernel and held
             against the plain average.  Both kernels must have launched
             in this run (21 fused-AdamW launches a round).  2 clients,
             because p, m, v and g in fp32 are 16 B x 3,995,166,720
             elements = 63.9 GB; 4 clients would need 94.8 GB.
7. train parity — the same rounds at full width and 2 layers (cut 1),
             once through the kernels and once with AdamW through its plain
             version (``ops.fused_adamw_plain``) and the plain aggregate,
             from the same seed and Gumbel draws: masks equal, losses and
             params within stated bands.
2c. compression kernels (runs after 2b) — stochastic quantize, dequantize
             and the top-k mask against their plain versions, bit-exact,
             at the same full-size client leaf (2, 134217728) fp32 (timed,
             levels 127, rate 0.05) and at levels 7, all-zero rows, a
             ragged M (1,000,003), the activation shape (256, 2048) and
             M = 0 (no launch).
8. compressed train — 3 rounds of full-width Gemma-2B at 6 layers, cuts
             (2, 4) (one edge stage, so the relay has two hops), 2
             clients, through ``make_round_fn``: once uncompressed, once
             under int8 and once under top-k at rate 0.05, error feedback
             and activation compression on.  Checks: each compression
             kernel launched once per client leaf a round and per hop
             crossing of each selected client; ``bytes_update_comp`` =
             selected x ``compressed_update_bytes``; a participant's
             residual non-zero and the masked client's unchanged by the
             round that masked it; finite losses; every round's selection
             draw reads the generator state the uncompressed run's read,
             and the masks are equal wherever the importance entering the
             round is (the compressed run's validation losses move it).
             Full depth does not fit with the residual, the pre-step rows
             and the per-leaf transients.
9. compressed parity — both schemes at full width and 3 layers (cuts
             1, 2), once through the kernels and once with ``ops``'
             quantize / dequantize / top-k mask patched to their plain
             versions, the same seed and so the same draws: masks, losses,
             trained stages, the aggregate and the residuals bit-exact.

12. family training — 3 WSSL rounds of full Mamba-2-370M (48 layers, 4
             clients, cut 8, seq 256: two SSD chunks) and full
             RecurrentGemma-2B (26 layers, 2 clients, cut 3, seq 128)
             through ``launch/train.py``: fp32 params, bf16 activations,
             participation 0.5, fused AdamW, the plain scans (as the JAX
             package trains).  Checks: finite losses; fused-AdamW launches
             = leaves x rounds; no SSD-scan, RG-LRU or flash launch; a
             masked client's AdamW moment rows unchanged by the round that
             masked it (fp64 row sums).  Reports round 0 and rounds 1-2,
             the peak memory and one more round under the profiler.
13. family train parity — both families at full width and a cut depth
             (Mamba-2 4 layers, cut 2; RecurrentGemma 8 layers, cut 3),
             through the AdamW kernel and then ``ops.fused_adamw_plain``,
             the same seed and Gumbel draws: masks equal, losses and
             stages within phase 7's bands.
14. the paper experiment — ``core/paper_loop.py`` at full width in fp32
             on the synthetic stand-ins: the gait FFN WSSL at 2 and 10
             clients (20 rounds x 10 local steps, ``make_gait_like(n=
             20000)``, split by subject) and its centralized baseline;
             ResNet-18 (``CifarConfig``) WSSL at 4 clients (10 x 10, batch
             128, lr 2e-3, ``make_image_like`` 12,000 images, stratified)
             and its baseline.  Checks: fused-AdamW launches = leaves x
             local steps taken, exactly, and nothing else launches; finite
             losses; final test accuracy above chance (a sanity floor).
             Reports accuracy by round, the best, a round's seconds, the
             peak memory and one profiled round of each model.
15. paper parity — gait and ResNet-18 WSSL, 2 clients x 3 rounds x 3
             steps, through the AdamW kernel and its plain version under
             ``cudnn.flags(deterministic=True, allow_tf32=False)``:
             selections, losses, accuracies and final params bit-exact.

16. the round under faults — full Mamba-2-370M (48 layers, 8 clients,
             cut 8, seq 256, batch 2, participation 1.0; fp32 params, bf16
             activations, fused AdamW, the plain scans), every client on a
             token stream of its own: no scenario against ``clean``, 2
             rounds each, the whole state bit-exact; then
             ``scaled-grad-adversary`` (clients 0-1 at x32) under the
             importance mean and under Krum (f = 2), 3 rounds each.
             Checks: finite losses, fused-AdamW launches = leaves x
             rounds, Krum never picks client 0 or 1.  Reports the rounds'
             seconds, peak memory, the adversaries' importance against the
             honest mean and the global model's validation loss.
17. fault parity — Mamba-2-370M at full width and 4 layers, cuts (1, 3)
             (one edge stage, 2 hop replicas), 8 clients, seq 128 (one SSD
             chunk; phase 16 crosses chunks), participation 0.5, 2 rounds: each fault scenario of ``FAULT_SCENARIOS``
             under the importance mean and each robust rule under
             ``scaled-grad-adversary``, through the AdamW kernel and
             through ``ops.fused_adamw_plain`` with the same seed and
             Gumbel draws: masks, losses, stages and moments bit-exact;
             a masked client's moment rows unchanged by its round; AdamW
             launches = client leaves a round + shared leaves a round with
             a survivor.
18. the paper's robustness — the paper loop on its own models: the gait
             FFN at 10 clients (10 rounds x 10 steps, ``make_gait_like(n=
             20000)`` by subject) under seven scenarios with the importance
             mean, Krum and the median under the two model-poisoning
             scenarios, int8 and top-k uploads; ResNet-18 (``CifarConfig``)
             at 8 clients (5 x 10) under ``label-flip-adversary`` with the
             importance mean and Krum.  Checks: ``clean`` equals no
             scenario bit for bit (cuDNN deterministic, no TF32);
             ``history["dropped"]`` is the numpy replay of the loop's fault
             generator; AdamW launches = leaves x steps taken (stragglers
             take fewer); each compression kernel once per client leaf a
             round; finite losses.  Two 2-round gait runs under
             ``sign-flip-adversary`` and Krum, one with int8 and one with
             top-k uploads, through the kernels against their plain
             versions (AdamW and the scheme's compression kernels at the
             gait leaves' shapes): bit-exact.  Reports accuracy
             by round and each adversary cohort's importance.

Each of phases 12-18 prints its wall time.  Then one JSON line with every
kernel's numbers (nine kernels), and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the script
exits non-zero before that line; it also exits non-zero, printing no
result, when no card is present or the package is not beside it.

    python3 chip_smoke.py --record out/chip_smoke.json

also writes the full record of every phase to that JSON file.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import math
import os
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
         "paged_decode_attention": {"bfloat16": 4e-3, "float32": 1e-4},
         # in ulps at the output's magnitude (check_wavg): the kernel sums
         # the N products in index order with fmaf, cuBLAS in an order and
         # with fusions of its own, a few roundings apart in fp32; the bf16
         # outputs round once from those fp32 sums, one bf16 ulp apart
         "weighted_average": {"float32": 4, "bfloat16": 1},
         # (atol, rtol) for fp32 output, as tests/test_kernels.py holds the
         # TPU kernel; a bf16 output gets one bf16 ulp at max|y| (check_ssd)
         "ssd_scan": {"float32": (5e-4, 1e-3)},
         # in fp32 ulps at max|h|: kernel and plain version round each
         # step's exp, product and sum once, so they differ only where
         # expf and torch's CUDA exp do
         "rg_lru_scan": {"float32": 4, "bfloat16": 1}}
# prefill step (phase 10), kernel path vs plain path, last-position logits
# max |diff|, by model and dtype, set from this phase's readings on an H100
# 80GB HBM3 at 700 W (seed 0).  In fp32 the paths differ by summation order
# only: read 8.8e-4 (Mamba-2) and 2.6e-5 (RecurrentGemma).  In bf16 they
# round at different places (the kernels keep fp32 inside; the plain SSD
# path rounds its intra-chunk weights and carries its state in bf16, the
# plain attention rounds scores), and at random weights those roundings
# compound over the depth: Mamba-2's 48 layers read 2.17 on logits of std
# ~1, and either bf16 path lies 1.7-2.1 from the fp32 plain path (the
# kernel path the nearer); RecurrentGemma read 0.139.  The greedy argmax
# must agree wherever the plain path's top-2 margin exceeds ARGMAX_MARGIN.
FAMILY_LOGIT_BAND = {"mamba2-370m": {"bfloat16": 4.0, "float32": 5e-3},
                     "recurrentgemma-2b": {"bfloat16": 0.25,
                                           "float32": 5e-4}}
ARGMAX_MARGIN = 0.5
# prefill logits, kernel path vs plain path, bf16, max |diff|: the plain
# path rounds scores and probabilities to bf16 where the kernel keeps fp32,
# compounded over 18 layers; an 18-layer d_model-512 cut of the same model
# differs by 0.066-0.086 on logits of std ~1 (CPU run of these plain ops),
# so the band is 0.25.
LOGIT_BAND = 0.25
# train parity (phase 7), kernel path vs plain path, set from readings on
# an H100 80GB HBM3 at 700 W.  The paths differ in the AdamW step (the
# kernel vs its plain version, bit-exact in fp32: phase 2b) and in the
# aggregate taken after training (the wavg kernel vs an fp32 product).
# Read: losses and val losses equal (rel diff 0); params max |diff|
# 5.8e-11, in the aggregate only.  Bands: losses rel 1e-6, a few fp32
# ulps; the trained stages max |diff| 1e-8, 170x the reading and about
# 1/13 of what a dropped weight decay would move them (lr * wd * |p| over
# the 3 warm-up rounds: 6e-4 * 0.01 * 0.022 = 1.3e-7 at a typical
# embedding entry) — a frozen row that stepped would move ~lr = 1e-4; the
# aggregate within the wavg band of BANDS.
TRAIN_LOSS_RTOL = 1e-6
TRAIN_STAGE_BAND = 1e-8
FLASH_DIFFERING_MAX = 0.01
# the share of a bf16 SSD call's outputs that may differ from the plain
# version's.  The tensor-core pair carries the state, G and w x as bf16
# hi + lo; on the H100 its cases read 0.06-0.13%, the SIMT body's bf16
# case 0.10%, while the CPU rehearsal moves ~30% with those operands (or G
# alone) in bf16 alone, at a max|diff| still inside the one-ulp band.
SSD_DIFFERING_MAX = 0.01


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


def _time_graph_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the replay timed with CUDA events over the count.  For kernels
    whose device time is below the host's cost of a call (the attention
    kernels at the serving shapes), where ``_time_ms`` would time the
    host's enqueue rate instead; the eager rate is kept beside it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def _kernel_device_ms(torch, fn, reps: int = 20):
    """Device ms per call of each kernel that ``fn`` launches, by name,
    from ``torch.profiler`` over ``reps`` calls: where a graph-timed call's
    time goes between its kernels."""
    prof = _device_profile(torch, lambda: [fn() for _ in range(reps)], top=8)
    return {k["name"][:60]: k["device_ms"] / reps for k in prof["kernels"]}


def _bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def check_flash(torch, ops, ref, *, b, hq, hkv, s, hd, dtype, window=None,
                softcap=None, seed=0, causal=True, profile=False):
    """Flash kernel vs its plain version on one case; returns its record.
    bf16 takes the tensor-core body: its band is one bf16 ulp at
    max|plain|, and at most FLASH_DIFFERING_MAX of its outputs may differ
    from the plain version's; fp32 takes the SIMT body, band 1e-4."""
    import torch.nn.functional as F
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, hq, hd), generator=g, device="cuda").to(dt)
    k = torch.randn((b, s, hkv, hd), generator=g, device="cuda").to(dt)
    v = torch.randn((b, s, hkv, hd), generator=g, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    plain = ref.flash_attention(qt, kt, vt, **kw).transpose(1, 2)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    bf16 = dtype == "bfloat16"
    rec = {"kernel": "flash_attention", "B": b, "S": s, "Hq": hq, "Hkv": hkv,
           "hd": hd, "dtype": dtype, "causal": causal, "window": window,
           "softcap": softcap,
           "body": "tensor cores" if bf16 else "simt", "max_abs_err": err,
           "band": (_ulps(torch, plain, 1, dtype) if bf16
                    else BANDS["flash_attention"][dtype]),
           "old_band": BANDS["flash_attention"][dtype],
           "differing_share": (out != plain).float().mean().item()}
    if bf16 and rec["differing_share"] > FLASH_DIFFERING_MAX:
        raise AssertionError(f"flash kernel: {rec['differing_share']:.4%} of the "
                             f"bf16 outputs differ from the plain version "
                             f"(at most {FLASH_DIFFERING_MAX:.0%}): {rec}")
    call = lambda: ops.flash_attention(q, k, v, **kw)
    rec["ms"] = _time_graph_ms(torch, call)
    rec["eager_ms"] = _time_ms(torch, call)
    if profile:
        rec["device_ms_by_kernel"] = _kernel_device_ms(torch, call)
    rec["plain_ms"] = _time_ms(torch, lambda: ref.flash_attention(
        qt, kt, vt, **kw))
    rec["library_ms"] = None
    if softcap is None:
        # yardstick only: SDPA on the same inputs, kv heads expanded first;
        # a window as a boolean band mask (built outside the timing)
        ke = kt.repeat_interleave(hq // hkv, dim=1)
        ve = vt.repeat_interleave(hq // hkv, dim=1)
        if window is None:
            sdpa = lambda: F.scaled_dot_product_attention(qt, ke, ve,
                                                          is_causal=causal)
        else:
            i = torch.arange(s, device="cuda")
            band = ((i[None, :] <= i[:, None]) | (not causal)) & (
                i[:, None] - i[None, :] < window)
            sdpa = lambda: F.scaled_dot_product_attention(qt, ke, ve,
                                                          attn_mask=band)
        rec["library_ms"] = _time_graph_ms(torch, sdpa)
        rec["library_eager_ms"] = _time_ms(torch, sdpa)
    pairs = sum(min(i + 1 if causal else s, window or s) for i in range(s))
    isz = q.element_size()
    nbytes = isz * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, 4.0 * b * hq * hd * pairs,
                                              dtype)
    return rec


def _paged_inputs(torch, *, b, hq, hkv, hd, bs, nb, dtype, pos_lo, seed,
                  dead_row, pos_hi=None):
    """Pool blocks dealt to rows by a random permutation; each row's entries
    hold their logical position up to pos[b], drawn from [pos_lo, pos_hi)
    (default: the table's length).  Row 0 sits on a block boundary; with
    ``dead_row``, row 1 has no valid entry at all.  Returns the kernel's
    arguments on the card and (ppos, table, pos) in numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_blocks = b * nb + b
    perm = rng.permutation(n_blocks)[:b * nb].reshape(b, nb)
    pos = rng.integers(pos_lo, pos_hi or nb * bs, size=(b,))
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
                pos_lo=0, pos_hi=None, seed=0, dead_row=True, profile=False):
    """Paged decode kernel vs its plain version on one case."""
    from repro_torch.kernels.paged_attention import split_plan
    args, (ppos, table, pos) = _paged_inputs(
        torch, b=b, hq=hq, hkv=hkv, hd=hd, bs=bs, nb=nb, dtype=dtype,
        pos_lo=pos_lo, pos_hi=pos_hi, seed=seed, dead_row=dead_row)
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
    splits, bps = split_plan(b, hkv, nb, bs)
    live = [min(int(p) // bs, nb - 1) if p >= 0 else -1 for p in pos]
    rec = {"kernel": "paged_decode_attention", "B": b, "Hq": hq, "Hkv": hkv,
           "hd": hd, "bs": bs, "nb": nb, "dtype": dtype, "dead_row": dead_row,
           "pos_range": [int(pos.min()), int(pos.max())], "splits": splits,
           "blocks_per_split": bps,
           "neutral_ctas": hkv * sum(splits - (j // bps + 1) for j in live),
           "valid_entries": valid, "max_abs_err": err,
           "band": BANDS["paged_decode_attention"][dtype]}
    call = lambda: ops.paged_decode_attention(*args)
    rec["ms"] = _time_graph_ms(torch, call)
    rec["eager_ms"] = _time_ms(torch, call)
    if profile:
        rec["device_ms_by_kernel"] = _kernel_device_ms(torch, call)
    rec["plain_ms"] = _time_ms(torch, lambda: ref.paged_decode_attention(*args))
    rec["library_ms"] = None     # no single PyTorch call computes it
    isz = args[0].element_size()
    nbytes = (2 * b * hq * hd * isz              # q in, out
              + valid * hkv * hd * isz * 2       # valid K and V entries
              + n_walked * (bs + 1) * 4 + b * 4)  # ppos, table, pos
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, 4.0 * hq * hd * valid,
                                              dtype)
    return rec


def _ulps(torch, t, n, dtype):
    """n units in the last place of ``dtype`` at the magnitude of max|t|."""
    mag = t.float().abs().max().item()
    return n * torch.finfo(getattr(torch, dtype)).eps * 2.0 ** math.floor(
        math.log2(mag)) if mag > 0 else 0.0


def check_fused_adamw(torch, ops, ref, *, rows, cols, dtype, seed=0):
    """Fused AdamW kernel vs its plain version on one (N, M) leaf with the
    freeze mask [1, 0, ...] (row 0 steps, the rest stay).  fp32 must be
    bit-exact; bf16 within BANDS; the masked rows must keep p, m and v."""
    from repro_torch.optim.optimizers import adam_scalars
    dt = getattr(torch, dtype)
    g_ = torch.Generator(device="cuda").manual_seed(seed)
    p = (torch.randn((rows, cols), generator=g_, device="cuda") * 0.02).to(dt)
    g = (torch.randn((rows, cols), generator=g_, device="cuda") * 1e-3).to(dt)
    m = torch.randn((rows, cols), generator=g_, device="cuda") * 1e-4
    v = torch.rand((rows, cols), generator=g_, device="cuda") * 1e-6
    mask = torch.zeros((rows,), device="cuda")
    mask[0] = 1.0
    # the round's hypers at step 3: lr 1e-3, AdamW defaults, wd 0.01
    scalars = adam_scalars(3, lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8,
                           weight_decay=0.01)
    want = ref.fused_adamw_2d(p, g, m, v, mask, scalars)
    kp, km, kv = p.clone(), m.clone(), v.clone()
    ops.fused_adamw(kp, g, km, kv, mask, scalars)
    torch.cuda.synchronize()
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip((kp, km, kv), want)]
    bits = lambda t: t.view(torch.int16 if t.element_size() == 2
                            else torch.int32)
    bitwise = all(torch.equal(bits(a), bits(b))
                  for a, b in zip((kp, km, kv), want))
    frozen = all(torch.equal(a[1:], b[1:]) for a, b in ((kp, p), (km, m),
                                                        (kv, v)))
    if not frozen:
        raise AssertionError("fused_adamw: a masked row moved")
    del want, kp, km, kv
    band = 0.0 if dtype == "float32" else _ulps(torch, p, 1, dtype)
    rec = {"kernel": "fused_adamw", "N": rows, "M": cols, "dtype": dtype,
           "max_abs_err": max(errs), "bit_exact": bitwise, "band": band,
           "mask": mask.tolist()}
    if dtype == "float32" and not bitwise:
        raise AssertionError(f"fused_adamw fp32 is not bit-exact: {errs}")
    rec["ms"] = _time_ms(torch, lambda: ops.fused_adamw(p, g, m, v, mask,
                                                        scalars), reps=10)
    rec["plain_ms"] = _time_ms(torch, lambda: ref.fused_adamw_2d(
        p, g, m, v, mask, scalars), reps=5, warmup=1)
    # no single PyTorch call computes it: torch._fused_adamw_ applies the
    # weight decay elsewhere and has no per-row freeze mask
    rec["library_ms"] = None
    n = rows * cols
    isz = p.element_size()
    nbytes = n * (2 * isz + g.element_size() + 16) + rows * 4
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, 20.0 * n, "float32")
    return rec


def check_wavg(torch, ops, ref, *, rows, cols, dtype, seed=0):
    """Weighted-average kernel vs its plain version (an fp32 matrix
    product) on one (N, M) stack; time beside cuBLAS's ``weights @
    stacked`` in fp32 as the library yardstick."""
    dt = getattr(torch, dtype)
    g_ = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, cols), generator=g_, device="cuda") * 0.02).to(dt)
    w = torch.softmax(torch.randn((rows,), generator=g_, device="cuda"), 0)
    out = ops.weighted_average(x, w)
    torch.cuda.synchronize()
    plain = ref.weighted_average_2d(x, w)
    err = (out.float() - plain.float()).abs().max().item()
    rec = {"kernel": "weighted_average", "N": rows, "M": cols, "dtype": dtype,
           "max_abs_err": err,
           "band": _ulps(torch, plain, BANDS["weighted_average"][dtype], dtype)}
    del out, plain
    rec["ms"] = _time_ms(torch, lambda: ops.weighted_average(x, w), reps=10)
    rec["plain_ms"] = _time_ms(torch, lambda: ref.weighted_average_2d(x, w),
                               reps=10)
    if dtype == "float32":
        rec["library_ms"] = _time_ms(torch, lambda: w @ x, reps=10)
    else:
        rec["library_ms"] = None
    isz = x.element_size()
    rec["bound_ms"], rec["bound_by"] = _bound(rows * cols * isz + cols * isz,
                                              2.0 * rows * cols, "float32")
    return rec


# a Gemma-2B client leaf at the default cut (4 layers): the MLP gate,
# 4 x 2048 x 16384 values per client
CLIENT_WG_COLS = 4 * 2048 * 16384


def _compress_inputs(torch, *, rows, cols, seed, zero_row):
    """An update-like (N, M) fp32 leaf (std 1e-3) with an all-zero row,
    its uniform draws, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, cols), generator=g, device="cuda") * 1e-3
    if zero_row is not None:
        x[zero_row] = 0.0
    u = torch.rand((rows, cols), generator=g, device="cuda")
    return x, u


def _bit_diffs(torch, a, b) -> int:
    """How many elements differ bit for bit (fp32 as int32 patterns)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum().item())


def check_quantize(torch, ops, ref, *, rows, cols, levels, seed,
                   zero_row=None, timed=False):
    """Quantize and dequantize kernels vs their plain versions on one leaf:
    codes and reconstructions bit-exact.  Returns the two records."""
    x, u = _compress_inputs(torch, rows=rows, cols=cols, seed=seed,
                            zero_row=zero_row)
    scale = x.abs().amax(dim=1) if cols else torch.zeros(rows, device="cuda")
    lv = torch.full((), levels, device="cuda")
    step = torch.where(scale > 0, scale / lv, 0.0)
    inv = torch.where(scale > 0, lv / scale, 0.0)
    before = ops.launch_counts()
    q = ops.quantize_stochastic(x, u, inv, levels)
    d = ops.dequantize(q, step)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
    want_launch = 1 if cols else 0      # m = 0 returns without a launch
    if (launched["quantize_stochastic"], launched["dequantize"]) != (
            want_launch, want_launch) or q.shape != (rows, cols):
        raise AssertionError(f"quantize/dequantize ({rows}, {cols}): "
                             f"launches {launched}, shape {tuple(q.shape)}")
    qp = ref.quantize_stochastic_2d(x, u, inv, levels)
    dp = ref.dequantize_2d(q, step)
    torch.cuda.synchronize()
    if zero_row is not None and cols and bool(q[zero_row].any()):
        raise AssertionError("quantize: the all-zero row has non-zero codes")
    recs = []
    for name, got, want in (("quantize_stochastic", q, qp),
                            ("dequantize", d, dp)):
        diff = _bit_diffs(torch, got, want)
        err = ((got.float() - want.float()).abs().max().item()
               if got.numel() else 0.0)
        recs.append({"kernel": name, "N": rows, "M": cols, "levels": levels,
                     "dtype": "float32", "zero_row": zero_row,
                     "differing": diff, "max_abs_err": err, "band": 0.0})
    del qp, dp
    if timed:
        n = rows * cols
        qrec, drec = recs
        qrec["ms"] = _time_ms(torch, lambda: ops.quantize_stochastic(
            x, u, inv, levels), reps=10)
        qrec["plain_ms"] = _time_ms(torch, lambda: ref.quantize_stochastic_2d(
            x, u, inv, levels), reps=3, warmup=1)
        # no PyTorch call draws a stochastic rounding from given uniforms
        qrec["library_ms"] = None
        qrec["bound_ms"], qrec["bound_by"] = _bound(9.0 * n + 4.0 * rows,
                                                    4.0 * n, "float32")
        drec["ms"] = _time_ms(torch, lambda: ops.dequantize(q, step), reps=10)
        drec["plain_ms"] = _time_ms(torch, lambda: ref.dequantize_2d(q, step),
                                    reps=10)
        # one PyTorch call computes the same function: int8 * fp32 promotes
        drec["library_ms"] = _time_ms(torch, lambda: q * step[:, None],
                                      reps=10)
        drec["bound_ms"], drec["bound_by"] = _bound(5.0 * n + 4.0 * rows,
                                                    1.0 * n, "float32")
    return recs


def check_topk_mask(torch, ops, ref, *, rows, cols, seed, zero_row=None,
                    timed=False):
    """Top-k mask kernel vs its plain version at the rate-0.05 threshold
    (a zero row has threshold 0): bit-exact."""
    from repro_torch.compress import topk_threshold
    x, _ = _compress_inputs(torch, rows=rows, cols=cols, seed=seed,
                            zero_row=zero_row)
    t = topk_threshold(x, 0.05)
    before = ops.launch_counts()["topk_mask"]
    out = ops.topk_mask(x, t)
    torch.cuda.synchronize()
    if ops.launch_counts()["topk_mask"] - before != (1 if cols else 0):
        raise AssertionError(f"topk_mask ({rows}, {cols}): launches")
    want = ref.topk_mask_2d(x, t)
    diff = _bit_diffs(torch, out, want)
    err = (out - want).abs().max().item() if out.numel() else 0.0
    rec = {"kernel": "topk_mask", "N": rows, "M": cols, "dtype": "float32",
           "zero_row": zero_row, "differing": diff, "max_abs_err": err,
           "band": 0.0, "kept": int((out != 0).sum().item())}
    del want, out
    if timed:
        n = rows * cols
        rec["ms"] = _time_ms(torch, lambda: ops.topk_mask(x, t), reps=10)
        rec["plain_ms"] = _time_ms(torch, lambda: ref.topk_mask_2d(x, t),
                                   reps=10)
        # no one PyTorch call: the mask needs abs, a comparison and where
        rec["library_ms"] = None
        rec["bound_ms"], rec["bound_by"] = _bound(8.0 * n + 4.0 * rows,
                                                  2.0 * n, "float32")
        # the plain per-row threshold that feeds the mask on the round's path
        rec["threshold_ms"] = _time_ms(torch, lambda: topk_threshold(x, 0.05),
                                       reps=3, warmup=1)
    return [rec]


def run_compress_kernels(torch, ops, ref):
    """Phase 2c: the three compression kernels against their plain
    versions, bit-exact, at the full-size client leaf (timed) and at the
    edge cases: levels 127 and 7, an all-zero row, a ragged M, M = 0."""
    main = (check_quantize(torch, ops, ref, rows=2, cols=CLIENT_WG_COLS,
                           levels=127.0, seed=21, zero_row=None, timed=True)
            + check_topk_mask(torch, ops, ref, rows=2, cols=CLIENT_WG_COLS,
                              seed=22, timed=True))
    torch.cuda.empty_cache()
    checks = list(main)
    for rows, cols, levels, zero_row, seed in (
            (2, CLIENT_WG_COLS, 7.0, 1, 23), (3, 1_000_003, 127.0, 2, 24),
            (3, 1_000_003, 7.0, 0, 25), (256, 2048, 127.0, 5, 26),
            (2, 0, 127.0, None, 27)):
        checks += check_quantize(torch, ops, ref, rows=rows, cols=cols,
                                 levels=levels, seed=seed, zero_row=zero_row)
        checks += check_topk_mask(torch, ops, ref, rows=rows, cols=cols,
                                  seed=seed, zero_row=zero_row)
        torch.cuda.empty_cache()
    for rec in checks:
        timing = (f", kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
                  f" ms, library {rec['library_ms'] if rec['library_ms'] is None else round(rec['library_ms'], 4)} ms, "
                  f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                  if "ms" in rec else "")
        if "threshold_ms" in rec:
            timing += f"; its threshold (torch.topk) {rec['threshold_ms']:.4f} ms"
        print(f"  {rec['kernel']} N={rec['N']} M={rec['M']}"
              + (f" levels={rec['levels']:g}" if "levels" in rec else "")
              + f" zero_row={rec['zero_row']}: {rec['differing']} elements "
              f"differ, max|diff| {rec['max_abs_err']:.3g} (bit-exact "
              f"required){timing}", flush=True)
        if rec["differing"]:
            raise AssertionError(f"{rec['kernel']} is not bit-exact against "
                                 f"its plain version: {rec}")
    return checks, {r["kernel"]: r for r in main}


def _train_setup(num_layers=None):
    """Full Gemma-2B (or its first ``num_layers`` layers) under the
    launcher's defaults, 2 clients."""
    from repro_torch.config import TrainConfig, WSSLConfig, get_arch
    cfg = get_arch("gemma-2b")
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    wssl_cfg = WSSLConfig(num_clients=2, participation_fraction=0.5)
    train_cfg = TrainConfig(rounds=3, learning_rate=1e-3, remat=True)
    return cfg, wssl_cfg, train_cfg


TRAIN_RUN = dict(rounds=3, batch_per_client=2, seq_len=128, val_batch=2,
                 seed=0, device="cuda", impl="dense")


def run_train(torch, ops):
    """Phase 6: 3 rounds of full Gemma-2B through both training kernels,
    the checks, then where a round's time goes."""
    from repro_torch.core.aggregation import aggregate_clients
    from repro_torch.core.protocol import tree_bytes
    from repro_torch.launch.train import train
    cfg, wssl_cfg, train_cfg = _train_setup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, hist = train(cfg, wssl_cfg, train_cfg, **TRAIN_RUN,
                        log=lambda line: print("  train " + line, flush=True))
    everyone = torch.ones(2, device="cuda")
    glob = aggregate_clients(state.client_stack, state.importance, everyone,
                             wssl_cfg, use_kernel=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    plain = aggregate_clients(state.client_stack, state.importance, everyone,
                              wssl_cfg)
    # each leaf within 4 fp32 ulps at its own magnitude
    errs = [((a.float() - b.float()).abs().max().item(),
             _ulps(torch, b, BANDS["weighted_average"]["float32"], "float32"))
            for a, b in zip(_leaves(glob), _leaves(plain))]
    del glob, plain
    agg_err, agg_band = max(e for e, _ in errs), max(b for _, b in errs)
    stages = (state.client_stack, state.server_params)
    leaves = len(_leaves(stages))
    n_elems = sum(t.numel() for t in _leaves(stages))
    want_adam = leaves * TRAIN_RUN["rounds"]
    if counts["fused_adamw"] != want_adam or counts["weighted_average"] < 1:
        raise AssertionError(f"train: launches {counts}, expected "
                             f"{want_adam} fused_adamw and >= 1 wavg")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["mean_val_loss"])
               for h in hist):
        raise AssertionError(f"train: non-finite loss {hist}")
    if [h["selected"] for h in hist] != [2, 1, 1]:
        raise AssertionError(f"train: selected {[h['selected'] for h in hist]}"
                             f", expected [2, 1, 1]")
    if not all(e <= band for e, band in errs):
        raise AssertionError(f"train: wavg aggregate outside its band, "
                             f"(max|diff|, band) by leaf: {errs}")
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "clients": 2,
           "cut": wssl_cfg.resolve_cuts(cfg)[0], "rounds": hist,
           "round_s": [h["dt_s"] for h in hist],
           "tokens_per_round": 2 * TRAIN_RUN["batch_per_client"]
           * TRAIN_RUN["seq_len"], "peak_bytes": peak,
           "stepped_elements": n_elems, "leaves": leaves,
           "state_bytes": 3 * 4 * n_elems, "launches": counts,
           "agg_max_abs_err": agg_err, "agg_band": agg_band,
           "client_stage_bytes": tree_bytes(state.client_stack) // 2}
    print(f"train: gemma-2b fp32 params, 2 clients, {leaves} leaves, "
          f"{n_elems} elements stepped a round, rounds "
          f"{', '.join(f'{t:.3f}' for t in rec['round_s'])} s, "
          f"{rec['tokens_per_round']} tokens a round, losses "
          f"{[round(h['loss'], 4) for h in hist]}, launches {counts}, "
          f"aggregate max|diff| {agg_err:.3g} (band {agg_band:.3g}), peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    rec.update(profile_train(torch, state, cfg, wssl_cfg, train_cfg))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train: one fused-AdamW step of every leaf {rec['opt_step_ms']:.2f}"
          f" ms (bound {rec['opt_step_bound_ms']:.2f} ms); a profiled round: "
          + _profile_line(rec["profile"], top=6), flush=True)
    return rec, counts


def profile_train(torch, state, cfg, wssl_cfg, train_cfg):
    """Where a training round's time goes, after the main-path run (its
    launches are not counted): one fused-AdamW step of every leaf alone,
    timed with CUDA events against its bound, then one more round under
    ``torch.profiler``.  Both move the state, which nothing reads after."""
    from torch.utils._pytree import tree_map
    from repro_torch.core.round import make_round_fn
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch.train import round_batch
    from repro_torch.optim import adamw_update
    dev = state.importance.device
    g_c = tree_map(torch.zeros_like, state.client_stack)
    g_s = tree_map(torch.zeros_like, state.server_params)
    mask = torch.tensor([1.0, 0.0], device=dev)

    def step():
        adamw_update(state.client_stack, g_c, state.opt_client, lr=1e-4,
                     mask=mask)
        adamw_update(state.server_params, g_s, state.opt_server, lr=1e-4)

    n_elems = sum(t.numel() for t in _leaves((g_c, g_s)))
    out = {"opt_step_ms": _time_ms(torch, step, reps=3, warmup=1),
           "opt_step_bound_ms": _bound(28.0 * n_elems, 20.0 * n_elems,
                                       "float32")[0]}
    del g_c, g_s
    torch.cuda.empty_cache()
    s = TRAIN_RUN["seq_len"]
    batch = round_batch(cfg, 2, TRAIN_RUN["batch_per_client"], s, 3, dev)
    val = {k: torch.as_tensor(v, device=dev) for k, v in lm_batch(
        TRAIN_RUN["val_batch"], s, cfg.vocab_size, seed=10_000).items()}
    round_fn = make_round_fn(cfg, wssl_cfg, train_cfg)
    out["profile"] = _device_profile(torch, lambda: round_fn(state, batch,
                                                             val))
    return out


def _device_profile(torch, fn, top: int = 25):
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activity)
    from a synchronised start to a synchronise after it: the wall time,
    the device's busy time (the kernels' summed device time) and share of
    the wall, the launches, and the ``top`` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "launches": sum(e.count for e in kernels),
            "kernels": [{"name": e.key, "count": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in kernels[:top]]}


def _profile_line(prof, top: int = 5) -> str:
    return (f"{prof['wall_s']:.3f} s wall, device busy "
            f"{prof['device_busy_s']:.3f} s (share "
            f"{prof['device_busy_share']:.3f}), {prof['launches']} kernel "
            f"launches; top: " + ", ".join(
                f"{k['name'][:48]} {k['device_ms']:.1f} ms x{k['count']}"
                for k in prof["kernels"][:top]))


def _leaves(tree):
    from torch.utils._pytree import tree_leaves
    return tree_leaves(tree)


def run_train_parity(torch, ops):
    """Phase 7: 3 rounds at full width and 2 layers, through the kernels
    and then with AdamW through its plain version and the plain
    aggregate."""
    from unittest import mock
    import numpy as np
    from repro_torch.core.aggregation import aggregate_clients
    from repro_torch.launch.train import train
    rng = np.random.default_rng(7)
    gumbels = [torch.as_tensor(rng.gumbel(size=2).astype(np.float32))
               for _ in range(TRAIN_RUN["rounds"])]
    runs = {}
    for name, kernels in (("kernel", True), ("plain", False)):
        cfg, wssl_cfg, train_cfg = _train_setup(num_layers=2)
        ops.reset_launch_counts()
        with mock.patch.object(ops, "fused_adamw", ops.fused_adamw if kernels
                               else ops.fused_adamw_plain):
            state, hist = train(cfg, wssl_cfg, train_cfg, **TRAIN_RUN,
                                gumbels=gumbels, log=lambda line: print(
                                    f"  parity {name} " + line, flush=True))
        glob = aggregate_clients(state.client_stack, state.importance,
                                 torch.ones(2, device="cuda"), wssl_cfg,
                                 use_kernel=kernels)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if kernels != (counts["fused_adamw"] > 0
                       and counts["weighted_average"] > 0) or (
                not kernels and any(counts.values())):
            raise AssertionError(f"parity {name}: launches {counts}")
        stages = [t.detach().cpu() for t in _leaves((
            state.client_stack, state.server_params))]
        runs[name] = (hist, stages, [t.cpu() for t in _leaves(glob)])
        del state, glob
        gc.collect()
        torch.cuda.empty_cache()
    (hk, sk, gk), (hp, sp, gp) = runs["kernel"], runs["plain"]
    if [h["mask"] for h in hk] != [h["mask"] for h in hp]:
        raise AssertionError(f"train parity: masks differ {hk} {hp}")
    loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                   for a, b in zip(hk, hp) for k in ("loss", "mean_val_loss"))
    stage_max = max((a - b).abs().max().item() for a, b in zip(sk, sp))
    stage_mean = (sum((a - b).abs().sum().item() for a, b in zip(sk, sp))
                  / sum(a.numel() for a in sk))
    # each aggregate leaf within the wavg band at its own magnitude
    agg = [((a - b).abs().max().item(),
            _ulps(torch, b, BANDS["weighted_average"]["float32"], "float32"))
           for a, b in zip(gk, gp)]
    agg_max, agg_band = max(e for e, _ in agg), max(b for _, b in agg)
    rec = {"layers": 2, "rounds": len(hk), "masks": [h["mask"] for h in hk],
           "kernel_losses": [h["loss"] for h in hk],
           "plain_losses": [h["loss"] for h in hp],
           "loss_rel_err": loss_err, "stage_max_abs_err": stage_max,
           "stage_mean_abs_err": stage_mean, "agg_max_abs_err": agg_max,
           "bands": {"loss_rtol": TRAIN_LOSS_RTOL,
                     "stage_max": TRAIN_STAGE_BAND, "agg_max": agg_band}}
    print(f"train parity: gemma-2b width, 2 layers, masks "
          f"{rec['masks']} equal; loss/val rel diff {loss_err:.3g} (band "
          f"{TRAIN_LOSS_RTOL:g}); trained stages max|diff| {stage_max:.3g} "
          f"(band {TRAIN_STAGE_BAND:g}), mean {stage_mean:.3g}; aggregate "
          f"max|diff| {agg_max:.3g} (band {agg_band:.3g})", flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and stage_max <= TRAIN_STAGE_BAND
            and all(e <= b for e, b in agg)):
        raise AssertionError(f"train parity outside its bands: {rec}")
    return rec


# phases 8-9: compressed rounds at full Gemma-2B width and a cut depth
# (module values, so a CPU rehearsal can shrink them)
COMP_RUN = dict(arch="gemma-2b", reduced=False, rounds=3, batch_per_client=2,
                seq_len=128, val_batch=2, seed=0, device="cuda", rate=0.05)
COMP_SCHEMES = ("int8", "topk")
COMP_KERNELS = {"int8": ("quantize_stochastic", "dequantize"),
                "topk": ("topk_mask",)}


def _comp_setup(scheme, num_layers, cuts):
    """Gemma-2B cut to ``num_layers`` at ``cuts``, 2 clients at
    participation 0.5, with ``scheme`` on updates and activations, error
    feedback on."""
    from repro_torch.config import (CompressionConfig, TrainConfig,
                                    WSSLConfig, get_arch, reduced)
    cfg = get_arch(COMP_RUN["arch"])
    if COMP_RUN["reduced"]:
        cfg = reduced(cfg)
    cfg = cfg.replace(num_layers=num_layers)
    comp = (CompressionConfig() if scheme == "none" else CompressionConfig(
        scheme=scheme, rate=COMP_RUN["rate"], error_feedback=True,
        activations=True))
    wssl_cfg = WSSLConfig(num_clients=2, participation_fraction=0.5,
                          split_layers=cuts, compression=comp)
    train_cfg = TrainConfig(rounds=COMP_RUN["rounds"], learning_rate=1e-3,
                            remat=not COMP_RUN["reduced"])
    return cfg, wssl_cfg, train_cfg


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _drive_rounds(torch, cfg, wssl_cfg, train_cfg, before_round=None):
    """The port's training entry points, round by round: ``init_state``
    from the seed, then ``make_round_fn``'s round on each round's batch.
    Returns the state and one record per round."""
    from repro_torch.core.round import init_state, make_round_fn
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch.train import round_batch
    dev = torch.device(COMP_RUN["device"])
    n, b, s = (wssl_cfg.num_clients, COMP_RUN["batch_per_client"],
               COMP_RUN["seq_len"])
    gen = torch.Generator(device=dev).manual_seed(COMP_RUN["seed"])
    state = init_state(gen, cfg, wssl_cfg, train_cfg, device=dev)
    round_fn = make_round_fn(cfg, wssl_cfg, train_cfg)
    val = {k: torch.as_tensor(v, device=dev) for k, v in lm_batch(
        COMP_RUN["val_batch"], s, cfg.vocab_size, seed=10_000).items()}
    recs = []
    for r in range(COMP_RUN["rounds"]):
        batch = round_batch(cfg, n, b, s, COMP_RUN["seed"] * 1000 + r, dev)
        if before_round is not None:
            before_round(state, r)
        # what the selection draw of this round reads: the selection
        # generator's state and the importance entering the round
        stream = hashlib.sha256(state.rng.get_state().numpy().tobytes()
                                ).hexdigest()
        importance_in = state.importance.cpu().tolist()
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, m = round_fn(state, batch, val)
        _sync(torch, dev)
        dt = time.perf_counter() - t0
        recs.append({"round": r, "dt_s": dt, "stream": stream,
                     "importance_in": importance_in, "loss": float(m.loss),
                     "val_loss": m.val_loss.cpu().tolist(),
                     "mask": m.mask.cpu().tolist(),
                     "selected": int(m.mask.sum()),
                     **{f: float(getattr(m, f)) for f in (
                         "bytes_update_raw", "bytes_update_comp", "bytes_sync",
                         "bytes_act_raw", "bytes_act_comp")}})
    return state, recs


def _free(torch):
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_comp_train(torch, ops):
    """Phase 8: 3 compressed rounds of full-width Gemma-2B at 6 layers
    (cuts 2, 4: one edge stage), under int8 and under top-k at rate 0.05,
    error feedback and activation compression on; and the same rounds
    with compression off, whose masks the compressed runs must repeat."""
    import numpy as np
    from repro_torch import compress
    from repro_torch.core.protocol import compressed_update_bytes
    layers, cuts = 6, (2, 4)
    runs = {}
    for scheme in ("none",) + COMP_SCHEMES:
        cfg, wssl_cfg, train_cfg = _comp_setup(scheme, layers, cuts)
        held = {}

        def before(state, r):
            # the residual before the last round, to hold the client that
            # round masks to it (a host copy: it stays out of the peak)
            if r == COMP_RUN["rounds"] - 1:
                held["res"] = [t.cpu() for t in
                               compress.tree_leaves(state.ef_residual)]

        _free(torch)
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        state, recs = _drive_rounds(torch, cfg, wssl_cfg, train_cfg,
                                    before_round=before)
        counts = ops.launch_counts()
        peak = (torch.cuda.max_memory_allocated()
                if torch.cuda.is_available() else 0)
        stack_leaves = compress.tree_leaves(state.client_stack)
        leaves = sum(1 for l in stack_leaves if l[0].numel())
        run = {"scheme": scheme, "layers": layers, "cuts": list(cuts),
               "rounds": recs, "round_s": [r["dt_s"] for r in recs],
               "peak_bytes": peak, "launches": counts,
               "client_stage_elements": sum(l[0].numel()
                                            for l in stack_leaves)}
        if not all(math.isfinite(r["loss"]) and all(map(math.isfinite,
                                                         r["val_loss"]))
                   for r in recs):
            raise AssertionError(f"compressed train {scheme}: non-finite "
                                 f"loss {recs}")
        if scheme != "none":
            # compression leaves the selection stream alone: each round's
            # draw reads the same generator state as the uncompressed run,
            # so the masks are equal wherever the importance entering the
            # round is (round 0 always; later the validation losses of the
            # compressed run move the importance, and the mask may follow)
            same = []
            for r, b in zip(recs, runs["none"]["rounds"]):
                if r["stream"] != b["stream"]:
                    raise AssertionError(f"compressed train {scheme}: round "
                                         f"{r['round']} drew from another "
                                         f"selection state")
                if r["importance_in"] == b["importance_in"]:
                    if r["mask"] != b["mask"]:
                        raise AssertionError(
                            f"compressed train {scheme}: round {r['round']} "
                            f"masks {r['mask']} != {b['mask']} at equal "
                            f"importance")
                    same.append(r["round"])
            run["masks_held_rounds"] = same
            run["masks_equal_uncompressed"] = [
                r["mask"] == b["mask"]
                for r, b in zip(recs, runs["none"]["rounds"])]
            # every wire upload and every hop crossing through the kernels
            hops = 2 * len(cuts)         # up and down, per selected client
            want = (COMP_RUN["rounds"] * leaves
                    + sum(r["selected"] for r in recs) * hops)
            for name in ("quantize_stochastic", "dequantize", "topk_mask"):
                expect = want if name in COMP_KERNELS[scheme] else 0
                if counts[name] != expect:
                    raise AssertionError(f"compressed train {scheme}: "
                                         f"launches {counts}, expected "
                                         f"{expect} {name}")
            cub = compressed_update_bytes(state.client_stack, scheme,
                                          COMP_RUN["rate"], num_clients=2)
            run["compressed_update_bytes"] = cub
            for r in recs:
                if r["bytes_update_comp"] != float(np.float32(
                        r["selected"] * cub)):
                    raise AssertionError(
                        f"compressed train {scheme}: bytes_update_comp "
                        f"{r['bytes_update_comp']} != {r['selected']} x {cub}")
            mask = recs[-1]["mask"]
            on, off = mask.index(1.0), mask.index(0.0)
            res = compress.tree_leaves(state.ef_residual)
            if not any(bool(t[on].any()) for t in res):
                raise AssertionError(f"compressed train {scheme}: the "
                                     f"participant's residual is zero")
            moved = sum(int((a[off].cpu() != b[off]).sum())
                        for a, b in zip(res, held["res"]))
            if moved:
                raise AssertionError(f"compressed train {scheme}: the masked "
                                     f"client's residual moved ({moved})")
            run["update_ratio"] = (recs[-1]["bytes_update_raw"]
                                   / recs[-1]["bytes_update_comp"])
            run["act_ratio"] = (recs[-1]["bytes_act_raw"]
                                / recs[-1]["bytes_act_comp"])
        runs[scheme] = run
        print(f"compressed train {scheme}: gemma-2b width, {layers} layers "
              f"cut {cuts}, 2 clients, rounds "
              f"{', '.join(f'{t:.3f}' for t in run['round_s'])} s, losses "
              f"{[round(r['loss'], 4) for r in recs]}, masks "
              f"{[r['mask'] for r in recs]}, peak memory "
              f"{peak / 2**30:.2f} GiB, launches {counts}"
              + (f", update ratio {run['update_ratio']:.7f}, activation "
                 f"ratio {run['act_ratio']:.4f}, selection stream equal to "
                 f"the uncompressed run's, masks equal to its "
                 f"{run['masks_equal_uncompressed']} (held at equal "
                 f"importance in rounds {run['masks_held_rounds']})"
                 if scheme != "none" else ""),
              flush=True)
        del state, held
        _free(torch)
    return runs


def run_comp_parity(torch, ops, ref):
    """Phase 9: 3 compressed rounds at full width and 3 layers (cuts 1, 2)
    through the compression kernels, then with ``ops``' three compression
    entry points patched to their plain versions; the same seed, so the
    same draws.  Masks, losses, the trained stages, the aggregate (the
    client rows after the sync) and the residuals must be bit-exact."""
    import contextlib
    from unittest import mock
    from repro_torch import compress
    out = {}
    for scheme in COMP_SCHEMES:
        sides = {}
        for side in ("kernel", "plain"):
            cfg, wssl_cfg, train_cfg = _comp_setup(scheme, 3, (1, 2))
            patch = (contextlib.nullcontext() if side == "kernel" else
                     mock.patch.multiple(
                         ops, quantize_stochastic=ref.quantize_stochastic_2d,
                         dequantize=ref.dequantize_2d,
                         topk_mask=ref.topk_mask_2d))
            _free(torch)
            ops.reset_launch_counts()
            with patch:
                state, recs = _drive_rounds(torch, cfg, wssl_cfg, train_cfg)
            counts = ops.launch_counts()
            comp_launches = sum(counts[k] for k in COMP_KERNELS[scheme])
            if (comp_launches > 0) != (side == "kernel") or not counts[
                    "fused_adamw"]:
                raise AssertionError(f"comp parity {scheme} {side}: "
                                     f"launches {counts}")
            host = lambda ts: [t.detach().cpu() for t in ts]
            sides[side] = {
                "recs": recs,
                "aggregate": host(t[0] for t in compress.tree_leaves(
                    state.client_stack)),
                "stages": host(compress.tree_leaves(
                    (state.server_params, state.edge_stages))),
                "residual": host(compress.tree_leaves(state.ef_residual))}
            del state
            _free(torch)
        k, p = sides["kernel"], sides["plain"]
        rec = {"scheme": scheme, "layers": 3, "masks": [r["mask"] for r in
                                                        k["recs"]]}
        rec["masks_equal"] = rec["masks"] == [r["mask"] for r in p["recs"]]
        rec["losses_equal"] = all(
            a["loss"] == b["loss"] and a["val_loss"] == b["val_loss"]
            for a, b in zip(k["recs"], p["recs"]))
        for part in ("aggregate", "stages", "residual"):
            rec[f"{part}_differing"] = sum(_bit_diffs(torch, a, b)
                                           for a, b in zip(k[part], p[part]))
            rec[f"{part}_elements"] = sum(a.numel() for a in k[part])
        print(f"compressed parity {scheme}: gemma-2b width, 3 layers, masks "
              f"{rec['masks']} equal {rec['masks_equal']}, losses equal "
              f"{rec['losses_equal']}; elements differing bit for bit: "
              f"aggregate {rec['aggregate_differing']} of "
              f"{rec['aggregate_elements']}, stages {rec['stages_differing']} "
              f"of {rec['stages_elements']}, residual "
              f"{rec['residual_differing']} of {rec['residual_elements']}",
              flush=True)
        if not (rec["masks_equal"] and rec["losses_equal"]
                and rec["aggregate_differing"] == rec["stages_differing"]
                == rec["residual_differing"] == 0):
            raise AssertionError(f"compressed parity {scheme}: the kernel "
                                 f"path is not bit-exact: {rec}")
        out[scheme] = rec
        del sides
        _free(torch)
    return out


# ---------------------------------------------------------------------------
# The recurrent families (phases 2d, 10, 11)
# ---------------------------------------------------------------------------

# module values, so a CPU rehearsal can shrink them: the prefill step's
# batch and sequence, and the serving runs' requests
FAMILY_RUN = dict(device="cuda", reduced=False, batch=2, seq=4096,
                  mamba_prompts=(128, 256, 384, 512) * 2,
                  rg_prompts=(256, 512, 1024, 1536, 1792, 2048, 2200, 2304),
                  gen=32, slots=4, chunk=8, block_size=16)
FAMILY_ARCHS = ("mamba2-370m", "recurrentgemma-2b")


def _ssd_inputs(torch, *, b, s, h, p, n, dtype, seed, dt_hi=0.5):
    """SSD scan inputs as the Mamba-2 block makes them: x, B and C of unit
    scale in ``dtype``; dt in [0.01, dt_hi) and a in [-16, -1) in fp32."""
    dt_, dev = getattr(torch, dtype), FAMILY_RUN["device"]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device=dev).to(dt_)
    dt = torch.rand((b, s, h), generator=g, device=dev) * (dt_hi - 0.01) + 0.01
    a = -(torch.rand((h,), generator=g, device=dev) * 15.0 + 1.0)
    b_ = torch.randn((b, s, n), generator=g, device=dev).to(dt_)
    c_ = torch.randn((b, s, n), generator=g, device=dev).to(dt_)
    return x, dt, a, b_, c_


def check_ssd(torch, ops, ref, *, b, s, h, p, n, dtype, seed, body,
              chunk=128, timed=False, profile=False, dt_hi=0.5):
    """SSD scan kernel vs its plain (sequential fp32) version.  Band: bf16
    output one bf16 ulp at max|y| (both sides keep fp32 and round once),
    and at most SSD_DIFFERING_MAX of the outputs differing; fp32 the JAX
    kernel tests' band, |diff| <= 5e-4 + 1e-3 |y|.  ``body`` is the body
    the case must take, "tc" (the tensor-core pair) or "simt"; the source's
    ``tc_body`` decides it."""
    args = _ssd_inputs(torch, b=b, s=s, h=h, p=p, n=n, dtype=dtype,
                       seed=seed, dt_hi=dt_hi)
    block_h = max(d for d in range(1, min(8, h) + 1) if h % d == 0)
    kw = dict(chunk=chunk, block_h=block_h)
    before = ops.launch_counts()["ssd_scan"]
    tc_before = ops.body_launches()["ssd_scan_tc"]
    y = ops.ssd_scan(*args, **kw)
    torch.cuda.synchronize()
    if ops.launch_counts()["ssd_scan"] - before != 1:
        raise AssertionError("ssd_scan: the kernel did not launch once")
    tc = ops.body_launches()["ssd_scan_tc"] - tc_before == 1
    if tc != (body == "tc"):
        raise AssertionError(f"ssd_scan {dtype} P {p} N {n}: took the "
                             f"{'tensor-core' if tc else 'SIMT'} body, "
                             f"want {body}")
    plain = ref.ssd_scan(*args)
    torch.cuda.synchronize()
    diff = (y.float() - plain.float()).abs()
    err = diff.max().item()
    differing = (y != plain).float().mean().item()
    if dtype == "bfloat16":
        band = _ulps(torch, plain, 1, dtype)
        ok = err <= band and differing <= SSD_DIFFERING_MAX
    else:
        atol, rtol = BANDS["ssd_scan"]["float32"]
        band = atol
        ok = bool((diff <= atol + rtol * plain.float().abs()).all())
    rec = {"kernel": "ssd_scan", "B": b, "S": s, "H": h, "P": p, "N": n,
           "dtype": dtype, "dt_hi": dt_hi, "chunk": chunk,
           "max_abs_err": err, "band": band, "ok": ok, "max_abs_y": plain.float().abs().max().item(),
           "body": "tensor cores" if tc else "simt",
           "differing_share": differing}
    del y, plain, diff
    if timed:
        call = lambda: ops.ssd_scan(*args, **kw)
        rec["ms"] = _time_graph_ms(torch, call)
        rec["eager_ms"] = _time_ms(torch, call)
        if profile:
            rec["device_ms_by_kernel"] = _kernel_device_ms(torch, call)
        rec["plain_ms"] = _time_ms(torch, lambda: ref.ssd_scan(*args),
                                   reps=2, warmup=1)
        # no PyTorch call computes the SSD scan
        rec["library_ms"] = None
        isz = args[0].element_size()
        nbytes = (2 * b * s * h * p * isz        # x in, y out
                  + b * s * h * 4 + h * 4        # dt, a
                  + 2 * b * s * n * isz)         # B, C
        q = min(chunk, s)
        # the SSD form per chunk: C.B^T (shared by the heads), then per
        # head the masked product with x, C . state and the state update
        flops = 2.0 * b * (s // q) * (q * q * n + h * q * q * p
                                      + 2 * h * q * n * p)
        rec["flops"] = flops
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops, dtype)
    return rec


def check_rglru(torch, ops, ref, *, b, s, w, dtype, seed, timed=False):
    """RG-LRU kernel vs its plain version: log_a as the gates make it
    (in (-0.105, 0): a^(1/r) in [0.9, 0.999]), b of scale 0.1.  Band:
    BANDS["rg_lru_scan"] fp32 ulps at max|h|; bit-exact is recorded."""
    dt_, dev = getattr(torch, dtype), FAMILY_RUN["device"]
    g = torch.Generator(device=dev).manual_seed(seed)
    log_a = -(torch.rand((b, s, w), generator=g, device=dev) * 0.105 + 1e-5)
    bb = (torch.randn((b, s, w), generator=g, device=dev) * 0.1).to(dt_)
    chunk, block_w = min(128, s), 512
    while w % block_w:
        block_w //= 2
    kw = dict(chunk=chunk, block_w=max(block_w, 1))
    before = ops.launch_counts()["rg_lru_scan"]
    h = ops.rg_lru_scan(log_a, bb, **kw)
    torch.cuda.synchronize()
    if ops.launch_counts()["rg_lru_scan"] - before != 1:
        raise AssertionError("rg_lru_scan: the kernel did not launch once")
    plain = ref.rg_lru_scan(log_a, bb)
    torch.cuda.synchronize()
    err = (h.float() - plain.float()).abs().max().item()
    band = _ulps(torch, plain, BANDS["rg_lru_scan"][dtype], dtype)
    rec = {"kernel": "rg_lru_scan", "B": b, "S": s, "W": w, "dtype": dtype,
           "max_abs_err": err, "band": band, "ok": err <= band,
           "differing": _bit_diffs(torch, h, plain),
           "max_abs_h": plain.float().abs().max().item()}
    del h, plain
    if timed:
        call = lambda: ops.rg_lru_scan(log_a, bb, **kw)
        rec["ms"] = _time_graph_ms(torch, call)
        rec["eager_ms"] = _time_ms(torch, call)
        rec["plain_ms"] = _time_ms(torch, lambda: ref.rg_lru_scan(log_a, bb),
                                   reps=2, warmup=1)
        # no PyTorch call computes a linear recurrence
        rec["library_ms"] = None
        n = b * s * w
        nbytes = n * (4 + 2 * bb.element_size())
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, 3.0 * n, "float32")
    return rec


def run_scan_kernels(torch, ops, ref):
    """Phase 2d: the SSD-scan and RG-LRU kernels against their plain
    versions at the prefill step's shapes (timed) and at edge cases, and
    the flash kernel at RecurrentGemma's 10-over-1 heads and window."""
    main_ssd = check_ssd(torch, ops, ref, b=2, s=4096, h=32, p=64, n=128,
                         dtype="bfloat16", seed=31, body="tc", timed=True,
                         profile=True)
    main_rg = check_rglru(torch, ops, ref, b=2, s=4096, w=2560,
                          dtype="float32", seed=32, timed=True)
    checks = [main_ssd, main_rg]
    # S = chunk, S = 64 < chunk, B = 3, fp32, a ragged P and a small N;
    # the reduced config's P 32 / N 32 with S not a multiple of 64 (the
    # tensor-core pair), and a bf16 P 40 / N 24 outside the pair's shapes
    # (the SIMT body); dt up to 8, where a chunk's decay spans far beyond
    # fp32's range (the tensor-core pair's factored decay must not
    # overflow)
    for kw in (dict(b=2, s=128, h=32, p=64, n=128, dtype="bfloat16",
                    body="tc"),
               dict(b=1, s=64, h=32, p=64, n=128, dtype="bfloat16",
                    body="tc"),
               dict(b=3, s=384, h=8, p=64, n=128, dtype="bfloat16",
                    body="tc"),
               dict(b=2, s=512, h=16, p=64, n=128, dtype="float32",
                    body="simt"),
               dict(b=1, s=96, h=4, p=40, n=24, dtype="float32", chunk=32,
                    body="simt"),
               dict(b=2, s=100, h=4, p=32, n=32, dtype="bfloat16", chunk=4,
                    body="tc"),
               dict(b=1, s=96, h=4, p=40, n=24, dtype="bfloat16", chunk=32,
                    body="simt"),
               dict(b=1, s=512, h=8, p=64, n=128, dtype="bfloat16",
                    dt_hi=8.0, body="tc")):
        checks.append(check_ssd(torch, ops, ref, seed=33 + len(checks),
                                **kw))
    # W not a multiple of 512 nor of the kernel's 32-channel CTAs, S below
    # one 128-step chunk and not a multiple of the kernel's 64-step
    # stages, and bf16 b
    for kw in (dict(b=3, s=384, w=1000, dtype="float32"),
               dict(b=2, s=100, w=2560, dtype="float32"),
               dict(b=1, s=128, w=768, dtype="bfloat16")):
        checks.append(check_rglru(torch, ops, ref, seed=40 + len(checks),
                                  **kw))
    torch.cuda.empty_cache()
    for rec in checks:
        dims = " ".join(f"{k}={rec[k]}" for k in ("B", "S", "H", "P", "N",
                                                   "W", "dtype", "dt_hi")
                        if k in rec)
        timing = (f", kernel {rec['ms']:.4f} ms (graph-timed; eager per "
                  f"call {rec['eager_ms']:.4f} ms), plain {rec['plain_ms']:.4f} "
                  f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                  if "ms" in rec else "")
        extra = (f", {rec['differing']} elements differ bit for bit"
                 if "differing" in rec else
                 f", {rec['body']} body, {rec['differing_share']:.4%} of "
                 f"outputs differ"
                 + (f" (at most {SSD_DIFFERING_MAX:.0%})"
                    if rec["dtype"] == "bfloat16" else ""))
        if "device_ms_by_kernel" in rec:
            timing += "; device ms a call by kernel (profiler): " + ", ".join(
                f"{name[:40]} {ms:.4f}"
                for name, ms in rec["device_ms_by_kernel"].items())
        print(f"  {rec['kernel']} {dims}: max|diff| {rec['max_abs_err']:.3g} "
              f"(band {rec['band']:.3g}){extra}{timing}", flush=True)
        if not rec["ok"]:
            raise AssertionError(f"{rec['kernel']} disagrees with its plain "
                                 f"version: {rec}")
    ops.reset_launch_counts()
    flash = check_flash(torch, ops, ref, b=2, hq=10, hkv=1, s=4096, hd=256,
                        dtype="bfloat16", window=2048, seed=45)
    flash["bodies"] = _check_bodies(ops, "flash g = 10")
    _check_band(flash)
    torch.cuda.empty_cache()
    return checks, main_ssd, main_rg, flash


def _family_cfg(arch, dtype="bfloat16"):
    from repro_torch.config import get_arch, reduced
    cfg = get_arch(arch)
    if FAMILY_RUN["reduced"]:
        cfg = reduced(cfg)
    return cfg.replace(dtype=dtype)


def _family_launches(cfg):
    """The kernel launches of one kernel-path prefill step of ``cfg``."""
    from repro_torch.config import ATTN_GLOBAL, ATTN_LOCAL, MIX_RGLRU, MIX_SSM
    kinds = [spec.mixer for spec in cfg.layer_specs()]
    return {"ssd_scan": kinds.count(MIX_SSM),
            "rg_lru_scan": kinds.count(MIX_RGLRU),
            "flash_attention": kinds.count(ATTN_LOCAL)
            + kinds.count(ATTN_GLOBAL)}


def _top2_margin(torch, logits):
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def run_prefill_step(torch, ops):
    """Phase 10: the prefill step (``launch/steps.py::make_prefill_step``)
    of both families at full width and depth, B 2 x S 4096, random weights
    from seed 0: once through the kernels (the counted run), then the plain
    path; bf16 (the main path, timed) and fp32 (the same weights in fp32,
    where the two paths differ only by fp32 summation order)."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tf
    dev = torch.device(FAMILY_RUN["device"])
    b, s = FAMILY_RUN["batch"], FAMILY_RUN["seq"]
    out = {}
    for arch in FAMILY_ARCHS:
        rec = {"arch": arch}
        logits = {}
        for dtype in ("bfloat16", "float32"):
            cfg = _family_cfg(arch, dtype)
            gen = torch.Generator(device=dev).manual_seed(0)
            params = tf.init_params(cfg, gen, device=dev)
            tg = torch.Generator(device=dev).manual_seed(1)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                             generator=tg, device=dev,
                                             dtype=torch.int32)}
            steps = {impl: make_prefill_step(cfg, impl)
                     for impl in ("kernel", "dense")}
            _free(torch)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            for impl in ("kernel", "dense"):
                _sync(torch, dev)
                ops.reset_launch_counts()
                lg = steps[impl](params, batch)
                _sync(torch, dev)
                counts = ops.launch_counts()
                want = ({**{k: 0 for k in counts}, **_family_launches(cfg)}
                        if impl == "kernel" else {k: 0 for k in counts})
                if counts != want:
                    raise AssertionError(f"prefill step {arch} {dtype} {impl}: "
                                         f"launches {counts}, expected {want}")
                _check_bodies(ops, f"prefill step {arch} {dtype} {impl}",
                              bf16=dtype == "bfloat16")
                if lg.shape != (b, 1, cfg.vocab_size) or not bool(
                        torch.isfinite(lg).all()):
                    raise AssertionError(f"prefill step {arch} {dtype} "
                                         f"{impl}: logits {tuple(lg.shape)}, "
                                         f"finite {bool(torch.isfinite(lg).all())}")
                logits[(dtype, impl)] = lg
                if dtype == "bfloat16":
                    if impl == "kernel":
                        rec["launches"] = counts
                        rec["peak_bytes"] = (torch.cuda.max_memory_allocated()
                                             if dev.type == "cuda" else 0)
                    times = []
                    for _ in range(3):
                        _sync(torch, dev)
                        t0 = time.perf_counter()
                        steps[impl](params, batch)
                        _sync(torch, dev)
                        times.append(time.perf_counter() - t0)
                    rec[f"{impl}_step_s"] = sorted(times)[1]
                    rec[f"{impl}_step_times"] = times
                    if impl == "kernel" and dev.type == "cuda":
                        # where a kernel-path step's time goes
                        rec["profile"] = _device_profile(
                            torch, lambda: steps[impl](params, batch))
            del params, batch
            _free(torch)
        for dtype in ("bfloat16", "float32"):
            lk, ld = logits[(dtype, "kernel")], logits[(dtype, "dense")]
            band = FAMILY_LOGIT_BAND[arch][dtype]
            err = (lk - ld).abs().max().item()
            margin = _top2_margin(torch, ld[:, -1])
            differ = (lk[:, -1].argmax(-1) != ld[:, -1].argmax(-1))
            bad = [i for i in range(b) if bool(differ[i])
                   and margin[i].item() > ARGMAX_MARGIN]
            rec[dtype] = {"max_logit_diff": err, "band": band,
                          "argmax_equal": (~differ).tolist(),
                          "plain_margins": margin.tolist()}
            if err > band or bad:
                raise AssertionError(f"prefill step {arch} {dtype}: kernel vs "
                                     f"plain logits max|diff| {err:.4g} (band "
                                     f"{band}), argmax differs at margin > "
                                     f"{ARGMAX_MARGIN} in rows {bad}")
        # how far each bf16 path lies from the fp32 plain path
        f32 = logits[("float32", "dense")]
        rec["bf16_vs_fp32"] = {impl: (logits[("bfloat16", impl)] - f32).abs()
                               .max().item() for impl in ("kernel", "dense")}
        out[arch] = rec
        print(f"prefill step: {arch} bf16 B {b} S {s}: kernel path "
              f"{rec['kernel_step_s']:.4f} s, plain {rec['dense_step_s']:.4f} "
              f"s (medians of 3), launches {rec['launches']}, peak memory "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB; kernel vs plain logits "
              f"max|diff| bf16 {rec['bfloat16']['max_logit_diff']:.4g} (band "
              f"{rec['bfloat16']['band']}), fp32 "
              f"{rec['float32']['max_logit_diff']:.4g} (band "
              f"{rec['float32']['band']}); argmax equal bf16 "
              f"{rec['bfloat16']['argmax_equal']} fp32 "
              f"{rec['float32']['argmax_equal']}; bf16 paths vs fp32 plain: "
              f"kernel {rec['bf16_vs_fp32']['kernel']:.4g}, plain "
              f"{rec['bf16_vs_fp32']['dense']:.4g}", flush=True)
        if "profile" in rec:
            print(f"prefill step: {arch} a profiled kernel-path step: "
                  + _profile_line(rec["profile"]), flush=True)
        del logits
        _free(torch)
    return out


def _family_requests(cfg, prompts, gen):
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.serve import Request
    return [Request(rid=i, prompt=make_token_stream(1, n, cfg.vocab_size,
                                                     seed=100 + i)[0],
                    max_new=gen) for i, n in enumerate(prompts)]


def _plain_margin(torch, tf, params, cfg, prompt, toks, t, dev):
    """Top-2 margin of the plain path's logits for token ``t`` of a
    request: prefill the prompt, then decode its first ``t`` tokens (a
    Mamba-2 context is not a whole number of SSD chunks, so no re-prefill)."""
    cache = tf.init_cache(cfg, 1, len(prompt) + t + 1, device=dev)
    lg, _ = tf.prefill(params, cfg, torch.as_tensor(
        prompt, dtype=torch.int32, device=dev)[None], cache=cache,
        impl="dense", last_only=True)
    for i in range(t):
        lg, _ = tf.decode_step(params, cfg, torch.full(
            (1, 1), int(toks[i]), dtype=torch.int32, device=dev), cache,
            torch.full((1,), len(prompt) + i, dtype=torch.int32, device=dev))
    return _top2_margin(torch, lg[0, -1]).item()


def _profile_serving(torch, cfg, params, reqs, sp, dev):
    """One admission of the longest prompt into a fresh batch, the other
    slots admitted unprofiled, then one decode chunk of every slot, each
    under the profiler.  A contiguous cache: RecurrentGemma's paged mode
    pages none of its layers, so the computation is the same."""
    import numpy as np
    from repro_torch.serve import DecodeEngine
    engine = DecodeEngine(cfg, impl="kernel", device=dev)
    state = engine.new_batch_state(sp.slots, sp.max_len)
    by_len = sorted(reqs, key=lambda r: r.prompt_len, reverse=True)
    out = {"admit_profile": _device_profile(
        torch, lambda: engine.admit(state, params, by_len[0].prompt, 0))}
    for slot, r in enumerate(by_len[1:sp.slots], start=1):
        engine.admit(state, params, r.prompt, slot)
    forced = np.zeros((sp.slots, sp.chunk), np.int32)
    out["chunk_profile"] = _device_profile(
        torch, lambda: engine.decode_chunk(state, params, forced,
                                           np.zeros((sp.slots,), np.int32)))
    return out


def run_family_serve(torch, ops):
    """Phase 11: serve both families at full width and depth through the
    router and engine (``impl="kernel"``, greedy), then the same requests
    through the plain path; tokens equal wherever the plain path's top-2
    margin exceeds 0.5.  The engine's prefill runs the recurrent blocks'
    plain scans (they return the final state), so only RecurrentGemma's
    local-attention layers launch a kernel: flash, once per admission and
    layer."""
    from repro_torch.launch.serve import serve, serve_max_len
    from repro_torch.models import transformer as tf
    from repro_torch.serve import DecodeEngine, ServeParams
    dev = torch.device(FAMILY_RUN["device"])
    gen_n, chunk = FAMILY_RUN["gen"], FAMILY_RUN["chunk"]
    out = {}
    for arch, prompts, block in (
            ("mamba2-370m", FAMILY_RUN["mamba_prompts"], 0),
            ("recurrentgemma-2b", FAMILY_RUN["rg_prompts"],
             FAMILY_RUN["block_size"])):
        cfg = _family_cfg(arch)
        params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                device=dev)
        reqs = _family_requests(cfg, prompts, gen_n)
        sp = ServeParams(replicas=1, slots=FAMILY_RUN["slots"], chunk=chunk,
                         max_len=serve_max_len(max(prompts), gen_n, chunk,
                                               block),
                         block_size=block)
        runs = {}
        for impl in ("kernel", "dense"):
            engine = DecodeEngine(cfg, impl=impl, device=dev)
            _free(torch)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            report, secs = serve(engine, params, reqs, sp)
            counts = ops.launch_counts()
            if report.unfinished or any(len(report.outputs[r.rid]) != gen_n
                                        for r in reqs):
                raise AssertionError(f"serve {arch} {impl}: unfinished or "
                                     f"short requests")
            admissions = report.log.summary()["admitted"]
            want = {k: 0 for k in counts}
            if impl == "kernel":
                want["flash_attention"] = int(
                    _family_launches(cfg)["flash_attention"] * admissions)
            if counts != want:
                raise AssertionError(f"serve {arch} {impl}: launches "
                                     f"{counts}, expected {want}")
            _check_bodies(ops, f"serve {arch} {impl}")
            runs[impl] = {"report": report, "seconds": secs,
                          "tokens_per_s": report.tokens_out / secs,
                          "launches": counts, "admissions": admissions,
                          "peak_bytes": (torch.cuda.max_memory_allocated()
                                         if dev.type == "cuda" else 0)}
        if dev.type == "cuda":
            # where a kernel-path serving run's time goes, sampled (not
            # counted; profiling the whole run's ~200k launches would add
            # minutes): one admission of the longest prompt, then one
            # decode chunk of a full batch
            runs["kernel"].update(_profile_serving(torch, cfg, params, reqs,
                                                   sp, dev))
        got, ref_out = runs["kernel"]["report"].outputs, \
            runs["dense"]["report"].outputs
        compared, diverged = 0, []
        for r in reqs:
            for t, (a, b_) in enumerate(zip(got[r.rid], ref_out[r.rid])):
                compared += 1
                if a == b_:
                    continue
                margin = _plain_margin(torch, tf, params, cfg, r.prompt,
                                       ref_out[r.rid], t, dev)
                if margin > ARGMAX_MARGIN:
                    raise AssertionError(
                        f"serve {arch}: request {r.rid} token {t} differs "
                        f"({a} vs {b_}) at top-2 margin {margin:.3f} > "
                        f"{ARGMAX_MARGIN}")
                diverged.append({"rid": r.rid, "token": t, "margin": margin})
                break
        rec = {"arch": arch, "prompts": list(prompts), "gen": gen_n,
               "slots": sp.slots, "block_size": block, "max_len": sp.max_len,
               "tokens_compared": compared, "diverged": diverged,
               **{f"{impl}_{k}": v for impl, run in runs.items()
                  for k, v in run.items() if k != "report"},
               "tokens": runs["kernel"]["report"].tokens_out}
        out[arch] = rec
        print(f"serve: {arch} bf16, {len(reqs)} requests (prompts "
              f"{min(prompts)}-{max(prompts)}), {rec['tokens']} tokens: "
              f"kernel path {rec['kernel_seconds']:.2f} s "
              f"({rec['kernel_tokens_per_s']:.1f} tok/s), plain "
              f"{rec['dense_seconds']:.2f} s "
              f"({rec['dense_tokens_per_s']:.1f} tok/s), launches "
              f"{rec['kernel_launches']}, peak memory "
              f"{rec['kernel_peak_bytes'] / 2**30:.2f} GiB; {compared} greedy "
              f"tokens compared, {len(diverged)} requests diverged at "
              f"margin <= {ARGMAX_MARGIN}", flush=True)
        if "kernel_admit_profile" in rec:
            print(f"serve: {arch} profiled, kernel path: one admission of "
                  f"{max(prompts)} tokens: "
                  + _profile_line(rec["kernel_admit_profile"], top=3)
                  + f"; one decode chunk ({sp.slots} slots x {chunk} steps): "
                  + _profile_line(rec["kernel_chunk_profile"]), flush=True)
        del params, runs
        _free(torch)
    return out


# ---------------------------------------------------------------------------
# Training the recurrent families and the paper's experiment (12-15)
# ---------------------------------------------------------------------------

# module values, so a CPU rehearsal can shrink them.  Phase 12: each
# family's full depth (``layers`` None), clients, cut, sequence and batch a
# client; phase 13: the reduced depth and cut of the parity runs.
FAMILY_TRAIN_RUN = dict(device="cuda", reduced=False, rounds=3, val_batch=2,
                        seed=0, parity_seq=128)
FAMILY_TRAIN = {
    # 11.7 GB of p, m, v and g (16 B x 732,544,768 elements); sequence
    # 256 is two SSD chunks, so the state crosses a chunk boundary
    "mamba2-370m": dict(layers=None, clients=4, cut=8, seq=256, batch=2,
                        parity_layers=4, parity_cut=2),
    # 71.4 GB (16 B x 4,462,200,320 elements): 2 clients
    "recurrentgemma-2b": dict(layers=None, clients=2, cut=3, seq=128,
                              batch=2, parity_layers=8, parity_cut=3),
}
SCAN_KERNELS = ("ssd_scan", "rg_lru_scan", "flash_attention")


def _family_train_setup(arch, layers, cut, clients):
    from repro_torch.config import TrainConfig, WSSLConfig, get_arch, reduced
    cfg = get_arch(arch)
    if FAMILY_TRAIN_RUN["reduced"]:
        cfg = reduced(cfg)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    wssl_cfg = WSSLConfig(num_clients=clients, participation_fraction=0.5,
                          split_layer=cut)
    train_cfg = TrainConfig(rounds=FAMILY_TRAIN_RUN["rounds"],
                            learning_rate=1e-3,
                            remat=not FAMILY_TRAIN_RUN["reduced"],
                            fused_adam=True)
    return cfg, wssl_cfg, train_cfg


def _moment_sums(torch, state):
    """Per client, the fp64 sums of its rows of every AdamW moment leaf:
    a masked client's rows are frozen bit for bit, so its sums are equal
    before and after the round that masked it."""
    rows = [t.reshape(t.shape[0], -1).double().sum(1)
            for t in _leaves((state.opt_client.m, state.opt_client.v))]
    return torch.stack(rows, 1).cpu()


def _profile_family_round(torch, state, cfg, wssl_cfg, train_cfg, run):
    """One more round under ``torch.profiler``, after the counted run (its
    launches are not counted; it moves the state, which nothing reads
    after)."""
    from repro_torch.core.round import make_round_fn
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch.train import round_batch
    dev = state.importance.device
    batch = round_batch(cfg, run["clients"], run["batch"], run["seq"], 99,
                        dev)
    val = {k: torch.as_tensor(v, device=dev) for k, v in lm_batch(
        FAMILY_TRAIN_RUN["val_batch"], run["seq"], cfg.vocab_size,
        seed=10_000).items()}
    round_fn = make_round_fn(cfg, wssl_cfg, train_cfg)
    return _device_profile(torch, lambda: round_fn(state, batch, val))


def run_family_train(torch, ops):
    """Phase 12: 3 WSSL rounds of full Mamba-2-370M and full
    RecurrentGemma-2B through ``launch/train.py`` (fp32 params, bf16
    activations, participation 0.5, fused AdamW, the plain scans as the
    JAX package trains)."""
    from repro_torch.launch.train import train
    dev = torch.device(FAMILY_TRAIN_RUN["device"])
    rounds = FAMILY_TRAIN_RUN["rounds"]
    out = {}
    for arch, run in FAMILY_TRAIN.items():
        t_phase = time.perf_counter()
        cfg, wssl_cfg, train_cfg = _family_train_setup(
            arch, run["layers"], run["cut"], run["clients"])
        sums = []
        _free(torch)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        state, hist = train(
            cfg, wssl_cfg, train_cfg, rounds=rounds,
            batch_per_client=run["batch"], seq_len=run["seq"],
            val_batch=FAMILY_TRAIN_RUN["val_batch"],
            seed=FAMILY_TRAIN_RUN["seed"], device=dev,
            before_round=lambda st, r: sums.append(_moment_sums(torch, st)),
            log=lambda line: print(f"  {arch} " + line, flush=True))
        _sync(torch, dev)
        counts = ops.launch_counts()
        peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else 0)
        sums.append(_moment_sums(torch, state))
        stages = (state.client_stack, state.server_params, state.edge_stages)
        leaves = len(_leaves(stages))
        n_elems = sum(t.numel() for t in _leaves(stages))
        want = leaves * rounds
        if counts["fused_adamw"] != want or any(counts[k]
                                                for k in SCAN_KERNELS):
            raise AssertionError(f"family train {arch}: launches {counts}, "
                                 f"expected {want} fused_adamw ({leaves} "
                                 f"leaves x {rounds} rounds) and no scan or "
                                 f"flash launch")
        if not all(math.isfinite(h["loss"]) and math.isfinite(
                h["mean_val_loss"]) for h in hist):
            raise AssertionError(f"family train {arch}: non-finite loss "
                                 f"{hist}")
        frozen = []
        for r, h in enumerate(hist):
            for i, sel in enumerate(h["mask"]):
                same = torch.equal(sums[r][i], sums[r + 1][i])
                if same != (sel == 0.0):
                    raise AssertionError(
                        f"family train {arch}: round {r} client {i} (mask "
                        f"{sel}) moments {'unchanged' if same else 'moved'}")
                frozen += [(r, i)] if same else []
        if not frozen:
            raise AssertionError(f"family train {arch}: no client was masked "
                                 f"in {[h['mask'] for h in hist]}")
        prof = (_profile_family_round(torch, state, cfg, wssl_cfg, train_cfg,
                                      run) if dev.type == "cuda" else None)
        rec = {"arch": arch, "layers": cfg.num_layers,
               "clients": run["clients"], "cut": run["cut"],
               "seq": run["seq"], "batch_per_client": run["batch"],
               "rounds": hist, "round0_s": hist[0]["dt_s"],
               "round_s": [h["dt_s"] for h in hist[1:]],
               "peak_bytes": peak, "leaves": leaves,
               "stepped_elements": n_elems, "state_bytes": 16 * n_elems,
               "launches": counts, "masked_frozen": frozen,
               "profile": prof, "phase_s": time.perf_counter() - t_phase}
        print(f"family train: {arch} {cfg.num_layers} layers, "
              f"{run['clients']} clients, cut {run['cut']}, seq "
              f"{run['seq']}, {leaves} leaves, {n_elems} elements stepped "
              f"(p, m, v, g {16 * n_elems / 1e9:.1f} GB); round 0 "
              f"{rec['round0_s']:.3f} s, rounds 1-{rounds - 1} "
              f"{', '.join(f'{t:.3f}' for t in rec['round_s'])} s; losses "
              f"{[round(h['loss'], 4) for h in hist]}; launches {counts}; "
              f"masked rows frozen {frozen}; peak memory "
              f"{peak / 2**30:.2f} GiB; phase {rec['phase_s']:.1f} s",
              flush=True)
        if prof is not None:
            print(f"family train: {arch} one more round, profiled: "
                  + _profile_line(prof, top=5), flush=True)
        out[arch] = rec
        del state
        _free(torch)
    return out


def run_family_train_parity(torch, ops):
    """Phase 13: both families at full width and a cut depth, 3 rounds
    through the AdamW kernel and then through its plain version, the same
    seed and Gumbel draws: masks equal, losses and stages within phase 7's
    bands."""
    from unittest import mock
    import numpy as np
    from repro_torch.launch.train import train
    dev = torch.device(FAMILY_TRAIN_RUN["device"])
    rounds = FAMILY_TRAIN_RUN["rounds"]
    out = {}
    for arch, run in FAMILY_TRAIN.items():
        t_phase = time.perf_counter()
        rng = np.random.default_rng(17)
        gumbels = [torch.as_tensor(rng.gumbel(size=run["clients"]).astype(
            np.float32)) for _ in range(rounds)]
        runs = {}
        for name, kernel in (("kernel", True), ("plain", False)):
            cfg, wssl_cfg, train_cfg = _family_train_setup(
                arch, run["parity_layers"], run["parity_cut"],
                run["clients"])
            ops.reset_launch_counts()
            with mock.patch.object(ops, "fused_adamw", ops.fused_adamw
                                   if kernel else ops.fused_adamw_plain):
                state, hist = train(
                    cfg, wssl_cfg, train_cfg, rounds=rounds,
                    batch_per_client=run["batch"],
                    seq_len=FAMILY_TRAIN_RUN["parity_seq"],
                    val_batch=FAMILY_TRAIN_RUN["val_batch"],
                    seed=FAMILY_TRAIN_RUN["seed"], device=dev,
                    gumbels=gumbels, log=lambda line: None)
            _sync(torch, dev)
            counts = ops.launch_counts()
            if (counts["fused_adamw"] > 0) != kernel or any(
                    counts[k] for k in SCAN_KERNELS):
                raise AssertionError(f"family parity {arch} {name}: "
                                     f"launches {counts}")
            runs[name] = (hist, [t.detach().cpu() for t in _leaves((
                state.client_stack, state.server_params))])
            del state
            _free(torch)
        (hk, sk), (hp, sp) = runs["kernel"], runs["plain"]
        if [h["mask"] for h in hk] != [h["mask"] for h in hp]:
            raise AssertionError(f"family parity {arch}: masks differ "
                                 f"{hk} {hp}")
        loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                       for a, b in zip(hk, hp)
                       for k in ("loss", "mean_val_loss"))
        stage_max = max((a - b).abs().max().item() for a, b in zip(sk, sp))
        rec = {"arch": arch, "layers": run["parity_layers"],
               "cut": run["parity_cut"], "masks": [h["mask"] for h in hk],
               "kernel_losses": [h["loss"] for h in hk],
               "plain_losses": [h["loss"] for h in hp],
               "loss_rel_err": loss_err, "stage_max_abs_err": stage_max,
               "bands": {"loss_rtol": TRAIN_LOSS_RTOL,
                         "stage_max": TRAIN_STAGE_BAND},
               "phase_s": time.perf_counter() - t_phase}
        print(f"family train parity: {arch} {run['parity_layers']} layers, "
              f"cut {run['parity_cut']}: masks {rec['masks']} equal; "
              f"loss/val rel diff {loss_err:.3g} (band {TRAIN_LOSS_RTOL:g});"
              f" trained stages max|diff| {stage_max:.3g} (band "
              f"{TRAIN_STAGE_BAND:g}); {rec['phase_s']:.1f} s", flush=True)
        if not (loss_err <= TRAIN_LOSS_RTOL
                and stage_max <= TRAIN_STAGE_BAND):
            raise AssertionError(f"family parity {arch} outside its bands: "
                                 f"{rec}")
        out[arch] = rec
    return out


# phases 14-15: the paper's experiment (gait FFN, ResNet-18) at full width
PAPER_RUN = dict(device="cuda", parity_clients=2, parity_rounds=3,
                 parity_steps=3,
                 gait=dict(n=20_000, clients=(2, 10), rounds=20, steps=10,
                           lr=1e-3, cfg="GaitConfig", batch=128),
                 resnet=dict(n=12_000, clients=(4,), rounds=10, steps=10,
                             lr=2e-3, cfg="CifarConfig", batch=128))
# a sanity floor on the final test accuracy (chance: 0.5 and 0.1), not a
# claim about the paper's numbers
PAPER_ACC_FLOOR = {"gait": 0.5, "resnet": 0.1}


def _paper_experiment(kind):
    """The paper benchmark's 70 / 10 / 20 split of the synthetic stand-in,
    the adapter, the leaves a step updates, and a loader factory (by
    subject for gait, stratified for images)."""
    import numpy as np
    from repro_torch.configs import wssl_paper
    from repro_torch.core import paper_loop as pl
    from repro_torch.data import partition, pipeline, synthetic
    run = PAPER_RUN[kind]
    n = run["n"]
    cfg = getattr(wssl_paper, run["cfg"])(batch_size=run["batch"])
    if kind == "gait":
        data, ad = synthetic.make_gait_like(n=n, seed=0), pl.gait_adapter(cfg)
    else:
        data = synthetic.make_image_like(n=n, seed=0)
        ad = pl.resnet_adapter(cfg)
    n_tr, n_val = int(n * 0.7), int(n * 0.1)
    xy = lambda lo, hi: {k: data[k][lo:hi] for k in ("x", "y")}
    tr, val, test = xy(0, n_tr), xy(n_tr, n_tr + n_val), xy(n_tr + n_val, n)

    def loaders(nc):
        parts = (partition.partition_by_subject(data["subject"][:n_tr], nc)
                 if kind == "gait" else
                 partition.partition_stratified(tr["y"], nc, seed=0))
        return [pipeline.ClientLoader(tr, p, cfg.batch_size, seed=i)
                for i, p in enumerate(parts)]

    def central():
        return pipeline.ClientLoader(tr, np.arange(n_tr), cfg.batch_size,
                                     seed=0)

    return ad, cfg, val, test, loaders, central


def _paper_leaves(torch, ad):
    stages = ad.init_split(torch.Generator().manual_seed(0))
    return len(_leaves(stages[0])), len(_leaves(stages[1]))


def _paper_summary(h, n_test):
    return {k: h[k] for k in ("test_acc", "test_loss", "best_acc",
                              "final_acc", "round_s", "train_loss",
                              "val_loss", "selected", "importance",
                              "participation", "bytes_up_total",
                              "bytes_sync_total") if k in h} | {
        "n_test": n_test}


def run_paper(torch, ops):
    """Phase 14: the paper's experiment at full width in fp32 — the gait
    FFN WSSL at 2 and 10 clients and its centralized baseline, then
    ResNet-18 WSSL at 4 clients and its baseline — with exact AdamW launch
    counts, finite losses, an accuracy floor, and one profiled round of
    each model."""
    from repro_torch.config import WSSLConfig
    from repro_torch.core import paper_loop as pl
    dev = torch.device(PAPER_RUN["device"])
    out = {}
    for kind in ("gait", "resnet"):
        ad, cfg, val, test, loaders, central = _paper_experiment(kind)
        n_client, n_server = _paper_leaves(torch, ad)
        per_step = n_client + n_server
        run = PAPER_RUN[kind]
        rounds, steps, lr, clients = (run["rounds"], run["steps"], run["lr"],
                                      tuple(run["clients"]))
        runs = {}
        for nc in clients + (None,):
            name = f"wssl-{nc}" if nc else "centralized"
            _free(torch)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ops.reset_launch_counts()
            if nc:
                h = pl.train_wssl(ad, loaders(nc), val, test,
                                  WSSLConfig(num_clients=nc,
                                             participation_fraction=0.5),
                                  rounds=rounds, local_steps=steps, lr=lr,
                                  seed=0, device=dev)
                taken = steps * sum(len(s) for s in h["selected"])
            else:
                h = pl.train_centralized(ad, central(), test, rounds=rounds,
                                         steps_per_round=steps, lr=lr,
                                         seed=0, device=dev)
                taken = steps * rounds
            _sync(torch, dev)
            counts = ops.launch_counts()
            wall = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                    else 0)
            want = per_step * taken
            losses = h["test_loss"] + h.get("train_loss", []) + [
                v for vs in h.get("val_loss", []) for v in vs]
            if counts["fused_adamw"] != want or sum(counts.values()) != want:
                raise AssertionError(
                    f"paper {kind} {name}: launches {counts}, expected "
                    f"{want} fused_adamw ({per_step} leaves x {taken} "
                    f"steps) and nothing else")
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"paper {kind} {name}: non-finite loss")
            if not h["final_acc"] > PAPER_ACC_FLOOR[kind]:
                raise AssertionError(
                    f"paper {kind} {name}: final test accuracy "
                    f"{h['final_acc']} at or below {PAPER_ACC_FLOOR[kind]}")
            rec = _paper_summary(h, len(test["y"])) | {
                "steps_taken": taken, "leaves_per_step": per_step,
                "client_leaves": n_client, "server_leaves": n_server,
                "launches": counts, "wall_s": wall, "peak_bytes": peak}
            print(f"paper: {kind} {name}, {rounds} rounds x {steps} steps, "
                  f"{taken} steps taken x {per_step} leaves = "
                  f"{counts['fused_adamw']} AdamW launches; test accuracy "
                  f"by round {[round(a, 4) for a in h['test_acc']]}, best "
                  f"{h['best_acc']:.4f}; median round "
                  f"{sorted(h['round_s'])[len(h['round_s']) // 2]:.3f} s; "
                  f"{wall:.1f} s in all; peak memory {peak / 2**30:.2f} GiB",
                  flush=True)
            runs[name] = rec
        # one more round 0 (every client selected) of the largest WSSL run,
        # under the profiler; its launches are not counted
        nc = max(clients)
        prof = _device_profile(torch, lambda: pl.train_wssl(
            ad, loaders(nc), val, test,
            WSSLConfig(num_clients=nc, participation_fraction=0.5),
            rounds=1, local_steps=steps, lr=lr, seed=1, device=dev)) \
            if dev.type == "cuda" else None
        if prof is not None:
            print(f"paper: {kind} one profiled round ({nc} clients, all "
                  f"selected): " + _profile_line(prof, top=5), flush=True)
        runs["profile"] = prof
        out[kind] = runs
    return out


def run_paper_parity(torch, ops):
    """Phase 15: gait and ResNet-18 WSSL, 2 clients x 3 rounds x 3 local
    steps, through the AdamW kernel and through its plain version, cuDNN
    deterministic and without TF32: selections, losses, accuracies and
    the final params bit-exact."""
    from unittest import mock
    from repro_torch.config import WSSLConfig
    from repro_torch.core import paper_loop as pl
    dev = torch.device(PAPER_RUN["device"])
    nc = PAPER_RUN["parity_clients"]
    out = {}
    for kind in ("gait", "resnet"):
        ad, cfg, val, test, loaders, _ = _paper_experiment(kind)
        lr = PAPER_RUN[kind]["lr"]
        runs = {}
        for name, kernel in (("kernel", True), ("plain", False)):
            ops.reset_launch_counts()
            with mock.patch.object(ops, "fused_adamw", ops.fused_adamw
                                   if kernel else ops.fused_adamw_plain), \
                    torch.backends.cudnn.flags(
                        enabled=True, benchmark=False, deterministic=True,
                        allow_tf32=False):
                h = pl.train_wssl(ad, loaders(nc), val, test,
                                  WSSLConfig(num_clients=nc,
                                             participation_fraction=0.5),
                                  rounds=PAPER_RUN["parity_rounds"],
                                  local_steps=PAPER_RUN["parity_steps"],
                                  lr=lr, seed=0, device=dev)
            _sync(torch, dev)
            counts = ops.launch_counts()
            if (counts["fused_adamw"] > 0) != kernel:
                raise AssertionError(f"paper parity {kind} {name}: launches "
                                     f"{counts}")
            runs[name] = (h, [t.detach().cpu() for t in _leaves(
                h.pop("params"))])
        (hk, pk), (hp, pp) = runs["kernel"], runs["plain"]
        fields = ("selected", "test_acc", "test_loss", "train_loss",
                  "val_loss", "importance")
        differ = [f for f in fields if hk[f] != hp[f]]
        params_bits = sum(_bit_diffs(torch, a, b) for a, b in zip(pk, pp))
        rec = {"clients": nc, "rounds": PAPER_RUN["parity_rounds"],
               "local_steps": PAPER_RUN["parity_steps"],
               "selected": hk["selected"], "test_acc": hk["test_acc"],
               "fields_differing": differ,
               "param_elements_differing": params_bits,
               "param_elements": sum(t.numel() for t in pk)}
        print(f"paper parity: {kind}, {nc} clients x "
              f"{PAPER_RUN['parity_rounds']} rounds x "
              f"{PAPER_RUN['parity_steps']} steps: selections "
              f"{hk['selected']}, test accuracy {hk['test_acc']}; fields "
              f"differing {differ}; {params_bits} of {rec['param_elements']} "
              f"final param elements differ (bit-exact required)",
              flush=True)
        if differ or params_bits:
            raise AssertionError(f"paper parity {kind}: kernel and plain "
                                 f"runs differ: {rec}")
        out[kind] = rec
    return out


# ---------------------------------------------------------------------------
# Faults and robust aggregation (phases 16-18)
# ---------------------------------------------------------------------------

# phases 16-17: the round under fault scenarios.  Full Mamba-2-370M at 8
# clients: p, m, v and g in fp32 are 16 B x ~1.14e9 elements, ~18.3 GB
# (reckoned); the pre-step rows and Krum's (8, D) matrix ~3.3 GB each
FAULT_RUN = dict(device="cuda", reduced=False, arch="mamba2-370m",
                 clients=8, cut=8, seq=256, batch=2, val_batch=2, seed=0,
                 clean_rounds=2, rounds=3, byzantine_f=2,
                 parity_layers=4, parity_cuts=(1, 3), parity_rounds=2,
                 parity_participation=0.5, parity_seq=128)
FAULT_SCENARIOS = ("label-flip-adversary", "grad-noise-adversary",
                   "sign-flip-adversary", "dropout-30", "stragglers",
                   "adaptive-scaled", "edge-dropout", "edge-latency")
ROBUST_RULES = ("trimmed_mean", "median", "krum", "multi_krum",
                "geometric_median", "norm_clip")


def _fault_setup(layers, cuts, participation, rule="importance"):
    from repro_torch.config import (AggregationConfig, TrainConfig,
                                    WSSLConfig, get_arch, reduced)
    cfg = get_arch(FAULT_RUN["arch"])
    if FAULT_RUN["reduced"]:
        cfg = reduced(cfg)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    cut = dict(split_layers=tuple(cuts), hop_replicas=2) if len(cuts) > 1 \
        else dict(split_layer=cuts[0])
    wssl_cfg = WSSLConfig(num_clients=FAULT_RUN["clients"],
                          participation_fraction=participation,
                          agg=AggregationConfig(
                              rule=rule, byzantine_f=FAULT_RUN["byzantine_f"]),
                          **cut)
    train_cfg = TrainConfig(learning_rate=1e-3,
                            remat=not FAULT_RUN["reduced"], fused_adam=True)
    return cfg, wssl_cfg, train_cfg


def _client_streams(torch, cfg, n, b, s, r, dev):
    """One round's batch with every client on a token stream of its own
    (a Markov mixture seeded per client, as the robustness benchmark
    draws under skew): tokens/labels (n, b, s) on ``dev``."""
    import numpy as np
    from repro_torch.data.synthetic import make_token_stream
    toks = np.stack([make_token_stream(b, s + 1, cfg.vocab_size,
                                       seed=10_000 * (i + 1) + r)
                     for i in range(n)])
    return {"tokens": torch.as_tensor(toks[:, :, :-1], device=dev),
            "labels": torch.as_tensor(toks[:, :, 1:], device=dev)}


def _global_val_loss(torch, state, cfg, val):
    """The synced global model's loss on the validation batch."""
    from torch.utils._pytree import tree_map
    from repro_torch.models import transformer as tf
    with torch.no_grad():
        a = tf.client_forward(tree_map(lambda t: t[0], state.client_stack),
                              cfg, val["tokens"], remat=False)
        for j, ep in enumerate(state.edge_stages):
            a = tf.stage_forward(ep, cfg, a, j + 1, remat=False)
        loss, _ = tf.server_loss(state.server_params, cfg, a, val["labels"],
                                 remat=False)
    return float(loss)


def _drive_fault_rounds(torch, cfg, wssl_cfg, train_cfg, scenario, rounds,
                        gumbels=None, before_round=None, seq=None):
    """``init_state`` from the seed, then ``make_round_fn``'s round under
    ``scenario`` on per-client streams of ``seq`` tokens (default
    ``FAULT_RUN["seq"]``).  Returns the state, one record per round (with
    the client Krum picked, when the rule ran it) and the validation
    batch."""
    from unittest import mock
    from repro_torch.core import aggregation
    from repro_torch.core.round import init_state, make_round_fn
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.sim import scenario_params
    dev = torch.device(FAULT_RUN["device"])
    n, b, s = (wssl_cfg.num_clients, FAULT_RUN["batch"],
               seq or FAULT_RUN["seq"])
    sp = None if scenario is None else scenario_params(scenario)
    gen = torch.Generator(device=dev).manual_seed(FAULT_RUN["seed"])
    state = init_state(gen, cfg, wssl_cfg, train_cfg, device=dev)
    round_fn = make_round_fn(cfg, wssl_cfg, train_cfg)
    val = {k: torch.as_tensor(v, device=dev) for k, v in lm_batch(
        FAULT_RUN["val_batch"], s, cfg.vocab_size, seed=10_000).items()}
    picked = []
    real_scores = aggregation.krum_scores

    def spy(stacked, mask, f):
        scores = real_scores(stacked, mask, f)
        picked.append(scores.cpu().tolist())
        return scores

    recs = []
    with mock.patch.object(aggregation, "krum_scores", spy):
        for r in range(rounds):
            batch = _client_streams(torch, cfg, n, b, s, r, dev)
            if before_round is not None:
                before_round(state, r)
            picked.clear()
            _sync(torch, dev)
            t0 = time.perf_counter()
            state, m = round_fn(state, batch, val, sp,
                                gumbel=None if gumbels is None
                                else gumbels[r])
            _sync(torch, dev)
            dt = time.perf_counter() - t0
            rec = {"round": r, "dt_s": dt, "loss": float(m.loss),
                   "val_loss": m.val_loss.cpu().tolist(),
                   "mask": m.mask.cpu().tolist(),
                   "importance": m.importance.cpu().tolist()}
            if picked:
                rec["krum_scores"] = picked[0]
                rec["krum_pick"] = min(range(n), key=lambda i: (
                    picked[0][i], i))
            recs.append(rec)
    return state, recs, val


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _fault_launches(state, recs):
    """Fused-AdamW launches a run of ``recs`` must make: every client leaf
    each round, the shared stages' leaves each round with a survivor."""
    client = len(_leaves(state.client_stack))
    shared = len(_leaves((state.server_params, state.edge_stages)))
    return sum(client + (shared if sum(r["mask"]) > 0 else 0) for r in recs)


def run_fault_train(torch, ops):
    """Phase 16: full Mamba-2-370M at 8 clients under faults — no scenario
    against ``clean`` (2 rounds each, state bit-exact), then
    ``scaled-grad-adversary`` (clients 0-1 at x32) under the importance
    mean and under Krum (f = 2), 3 rounds each."""
    from repro_torch.core import fairness
    from repro_torch.sim import get_scenario
    dev = torch.device(FAULT_RUN["device"])
    out = {}
    sides = {}
    for name, sc in (("none", None), ("clean", get_scenario("clean"))):
        cfg, wssl_cfg, train_cfg = _fault_setup(None, (FAULT_RUN["cut"],),
                                                1.0)
        _free(torch)
        ops.reset_launch_counts()
        state, recs, _ = _drive_fault_rounds(
            torch, cfg, wssl_cfg, train_cfg, sc, FAULT_RUN["clean_rounds"])
        counts = ops.launch_counts()
        want = _fault_launches(state, recs)
        if counts["fused_adamw"] != want:
            raise AssertionError(f"fault train {name}: launches {counts}, "
                                 f"expected {want} fused_adamw")
        sides[name] = (state, recs)
    (a, ra), (b, rb) = sides["none"], sides["clean"]
    tensors = lambda st: _leaves((st.client_stack, st.server_params,
                                  st.edge_stages, st.opt_client.m,
                                  st.opt_client.v, st.opt_server.m,
                                  st.opt_server.v, st.importance))
    differing = sum(_bit_diffs(torch, x, y) for x, y in zip(tensors(a),
                                                           tensors(b)))
    same_recs = all(x["loss"] == y["loss"] and x["mask"] == y["mask"]
                    and x["val_loss"] == y["val_loss"]
                    for x, y in zip(ra, rb))
    out["clean"] = {"rounds": FAULT_RUN["clean_rounds"],
                    "state_elements_differing": differing,
                    "state_elements": sum(t.numel() for t in tensors(a)),
                    "records_equal": same_recs,
                    "round_s": [r["dt_s"] for r in rb]}
    secs = ", ".join(f"{r['dt_s']:.3f}" for r in rb)
    print(f"fault train: {cfg.name} {cfg.num_layers} layers, "
          f"{FAULT_RUN['clients']} clients, cut {FAULT_RUN['cut']}: clean "
          f"scenario vs none, {FAULT_RUN['clean_rounds']} rounds: "
          f"{differing} of {out['clean']['state_elements']} state elements "
          f"differ, records equal {same_recs}; clean rounds {secs} s",
          flush=True)
    if differing or not same_recs:
        raise AssertionError(f"fault train: clean differs from no scenario: "
                             f"{out['clean']}")
    del sides, a, b, state
    _free(torch)

    sc = get_scenario("scaled-grad-adversary")
    bad = sc.adversary_ids(FAULT_RUN["clients"])
    for rule in ("importance", "krum"):
        cfg, wssl_cfg, train_cfg = _fault_setup(None, (FAULT_RUN["cut"],),
                                                1.0, rule)
        _free(torch)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        state, recs, val = _drive_fault_rounds(
            torch, cfg, wssl_cfg, train_cfg, sc, FAULT_RUN["rounds"])
        counts = ops.launch_counts()
        peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else 0)
        want = _fault_launches(state, recs)
        if counts["fused_adamw"] != want:
            raise AssertionError(f"fault train {rule}: launches {counts}, "
                                 f"expected {want} fused_adamw")
        if not all(math.isfinite(r["loss"]) and all(
                math.isfinite(v) for v in r["val_loss"]) for r in recs):
            raise AssertionError(f"fault train {rule}: non-finite loss")
        picks = [r.get("krum_pick") for r in recs]
        if rule == "krum" and (None in picks or set(picks) & set(bad)):
            raise AssertionError(f"fault train: Krum picked {picks}, the "
                                 f"adversaries are {bad}")
        gap = fairness.importance_gap(recs[-1]["importance"], bad)
        rec = {"rule": rule, "scenario": sc.name, "adversaries": bad,
               "rounds": recs, "round_s": [r["dt_s"] for r in recs],
               "peak_bytes": peak, "launches": counts,
               "krum_picks": picks if rule == "krum" else None,
               "importance_gap": gap,
               "global_val_loss": _global_val_loss(torch, state, cfg, val)}
        secs = ", ".join(f"{t:.3f}" for t in rec["round_s"])
        print(f"fault train: {sc.name} under {rule}, "
              f"{FAULT_RUN['rounds']} rounds of {cfg.num_layers} layers: "
              f"rounds {secs} s; "
              f"losses {[round(r['loss'], 4) for r in recs]}; adversaries "
              f"{bad} importance {gap['corrupt_mean']:.4f} against the "
              f"honest mean {gap['clean_mean']:.4f}; Krum picks "
              f"{rec['krum_picks']}; global model's validation loss "
              f"{rec['global_val_loss']:.4f}; launches {_nonzero(counts)}; "
              f"peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        out[rule] = rec
        del state
        _free(torch)
    return out


def run_fault_parity(torch, ops):
    """Phase 17: Mamba-2-370M at full width and 4 layers, cuts (1, 3) (one
    edge stage, 2 hop replicas), 8 clients, seq 128, 2 rounds, under each
    fault scenario (importance) and each robust rule
    (``scaled-grad-adversary``), through the AdamW kernel and through its
    plain version, the same seed and Gumbel draws: masks, losses and
    stages bit-exact, dropped and unselected clients' moment rows
    unchanged."""
    from unittest import mock
    import numpy as np
    from repro_torch.sim import get_scenario
    dev = torch.device(FAULT_RUN["device"])
    rounds = FAULT_RUN["parity_rounds"]
    rng = np.random.default_rng(23)
    gumbels = [torch.as_tensor(rng.gumbel(size=FAULT_RUN["clients"]).astype(
        np.float32)) for _ in range(rounds)]
    cases = ([(name, "importance") for name in FAULT_SCENARIOS]
             + [("scaled-grad-adversary", rule) for rule in ROBUST_RULES])
    out = []
    for name, rule in cases:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        sides = {}
        for side in ("kernel", "plain"):
            cfg, wssl_cfg, train_cfg = _fault_setup(
                FAULT_RUN["parity_layers"], FAULT_RUN["parity_cuts"],
                FAULT_RUN["parity_participation"], rule)
            sums = []
            ops.reset_launch_counts()
            with mock.patch.object(ops, "fused_adamw", ops.fused_adamw
                                   if side == "kernel"
                                   else ops.fused_adamw_plain):
                state, recs, _ = _drive_fault_rounds(
                    torch, cfg, wssl_cfg, train_cfg, get_scenario(name),
                    rounds, gumbels=gumbels, seq=FAULT_RUN["parity_seq"],
                    before_round=lambda st, r: sums.append(
                        _moment_sums(torch, st)))
            sums.append(_moment_sums(torch, state))
            counts = ops.launch_counts()
            want = _fault_launches(state, recs) if side == "kernel" else 0
            if counts["fused_adamw"] != want:
                raise AssertionError(f"fault parity {name} {rule} {side}: "
                                     f"launches {counts}, expected {want}")
            for r, rec in enumerate(recs):
                for i, sel in enumerate(rec["mask"]):
                    if sel == 0.0 and not torch.equal(sums[r][i],
                                                      sums[r + 1][i]):
                        raise AssertionError(
                            f"fault parity {name} {rule} {side}: round {r} "
                            f"client {i} was masked and its moments moved")
            sides[side] = (state, recs)
        (sk, rk), (sp, rp) = sides["kernel"], sides["plain"]
        fields = ("mask", "loss", "val_loss", "importance")
        differ = sorted({f for a, b in zip(rk, rp) for f in fields
                         if a[f] != b[f]})
        tensors = lambda st: _leaves((st.client_stack, st.server_params,
                                      st.edge_stages, st.opt_client.m,
                                      st.opt_client.v))
        bits = sum(_bit_diffs(torch, a, b) for a, b in zip(tensors(sk),
                                                          tensors(sp)))
        rec = {"scenario": name, "rule": rule,
               "masks": [r["mask"] for r in rk],
               "losses": [r["loss"] for r in rk],
               "krum_picks": [r.get("krum_pick") for r in rk],
               "fields_differing": differ, "state_elements_differing": bits,
               "seconds": time.perf_counter() - t0,
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        print(f"fault parity: {name} under {rule}, {cfg.num_layers} layers, "
              f"cuts {FAULT_RUN['parity_cuts']}: masks {rec['masks']}, "
              f"losses {[round(v, 5) for v in rec['losses']]}; fields "
              f"differing {differ}, {bits} state elements differ (bit-exact "
              f"required); peak {rec['peak_gib']:.2f} GiB (both sides' "
              f"states live); {rec['seconds']:.1f} s", flush=True)
        if differ or bits:
            raise AssertionError(f"fault parity {name} {rule}: kernel and "
                                 f"plain runs differ: {rec}")
        out.append(rec)
        del sides, sk, sp, state
        _free(torch)
    return out


# phase 18: the paper's robustness on its own models
PAPER_ROBUST = dict(gait_clients=10, gait_rounds=10, resnet_clients=8,
                    resnet_rounds=5, steps=10, parity_rounds=2)
PAPER_ROBUST_GAIT = (
    [(sc, "importance", "none") for sc in (
        "clean", "label-flip-adversary", "sign-flip-adversary",
        "scaled-grad-adversary", "adaptive-scaled", "dropout-30",
        "stragglers")]
    + [(sc, rule, "none") for rule in ("krum", "median")
       for sc in ("scaled-grad-adversary", "adaptive-scaled")]
    + [("clean", "importance", scheme) for scheme in ("int8", "topk")])
PAPER_ROBUST_RESNET = [("label-flip-adversary", rule, "none")
                       for rule in ("importance", "krum")]
PAPER_COMP_KERNELS = {"int8": ("quantize_stochastic", "dequantize"),
                      "topk": ("topk_mask",), "none": ()}


def _paper_robust_cfg(nc, rule, scheme):
    from repro_torch.config import (AggregationConfig, CompressionConfig,
                                    WSSLConfig)
    return WSSLConfig(num_clients=nc, participation_fraction=0.5,
                      agg=AggregationConfig(rule=rule),
                      compression=CompressionConfig(scheme=scheme))


def _steps_taken(h, sc, nc, steps):
    """Local steps the loop took: stragglers take round(steps / slowdown)."""
    strag = set(sc.straggler_ids(nc))
    slow = max(1, int(round(steps / max(sc.straggler_slowdown, 1.0))))
    return sum(slow if i in strag else steps for sel in h["selected"]
               for i in sel)


def _replay_dropped(h, sc, seed):
    """``history["dropped"]`` replayed from the loop's numpy generator."""
    import numpy as np
    rng = np.random.default_rng(sc.seed + 7919 * seed + 1)
    return [[i for i in sorted(sel + dropped)
             if rng.random() < sc.dropout_prob]
            for sel, dropped in zip(h["selected"], h["dropped"])]


def run_paper_robust(torch, ops):
    """Phase 18: the paper loop under faults, robust rules and compressed
    uploads on its own models — the gait FFN at 10 clients (10 rounds x 10
    steps) and ResNet-18 at 8 (5 x 10) — with exact launch counts, the
    dropout replay, clean against no scenario bit for bit, and 2-round
    gait runs (int8, top-k) through the kernels against their plain
    versions."""
    import contextlib
    from unittest import mock
    from repro_torch.core import fairness
    from repro_torch.core import paper_loop as pl
    from repro_torch.kernels import ref
    from repro_torch.sim import get_scenario
    dev = torch.device(PAPER_RUN["device"])
    steps = PAPER_ROBUST["steps"]
    det = lambda: torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=True, allow_tf32=False)
    out = {"gait": {}, "resnet": {}}
    for kind, cases in (("gait", PAPER_ROBUST_GAIT),
                        ("resnet", PAPER_ROBUST_RESNET)):
        ad, cfg, val, test, loaders, _ = _paper_experiment(kind)
        n_client, n_server = _paper_leaves(torch, ad)
        nc = PAPER_ROBUST[f"{kind}_clients"]
        rounds = PAPER_ROBUST[f"{kind}_rounds"]
        lr = PAPER_RUN[kind]["lr"]
        extra = [("none", "importance", "none")] if kind == "gait" else []
        for name, rule, scheme in extra + cases:
            sc = None if name == "none" else get_scenario(name)
            sc_ = sc if sc is not None else get_scenario("clean")
            _free(torch)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with det():
                h = pl.train_wssl(ad, loaders(nc), val, test,
                                  _paper_robust_cfg(nc, rule, scheme),
                                  rounds=rounds, local_steps=steps, lr=lr,
                                  seed=0, scenario=sc, device=dev)
            _sync(torch, dev)
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            taken = _steps_taken(h, sc_, nc, steps)
            want = {"fused_adamw": (n_client + n_server) * taken,
                    **{k: n_client * rounds
                       for k in PAPER_COMP_KERNELS[scheme]}}
            if {k: v for k, v in counts.items() if v} != want:
                raise AssertionError(f"paper robust {kind} {name} {rule} "
                                     f"{scheme}: launches {counts}, expected "
                                     f"{want}")
            losses = h["test_loss"] + h["train_loss"] + [
                v for vs in h["val_loss"] for v in vs]
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"paper robust {kind} {name} {rule}: "
                                     f"non-finite loss")
            if h["dropped"] != _replay_dropped(h, sc_, 0):
                raise AssertionError(f"paper robust {kind} {name}: dropped "
                                     f"{h['dropped']} is not the numpy "
                                     f"replay")
            bad = sc_.adversary_ids(nc)
            gap = fairness.importance_gap(h["importance"][-1], bad)
            key = f"{name}/{rule}/{scheme}"
            params = [t.detach().cpu() for t in _leaves(h.pop("params"))]
            rec = _paper_summary(h, len(test["y"])) | {
                "scenario": name, "rule": rule, "compression": scheme,
                "adversaries": bad, "importance_gap": gap,
                "dropped": h["dropped"], "steps_taken": taken,
                "launches": counts, "wall_s": wall}
            print(f"paper robust: {kind} {nc} clients, {name} / {rule} / "
                  f"{scheme}: test accuracy by round "
                  f"{[round(a, 4) for a in h['test_acc']]}, best "
                  f"{h['best_acc']:.4f}; adversaries {bad} importance "
                  f"{gap['corrupt_mean']:.4f} against the others' "
                  f"{gap['clean_mean']:.4f}; dropped "
                  f"{sum(len(d) for d in h['dropped'])}; {taken} steps, "
                  f"launches {_nonzero(counts)}; {wall:.1f} s", flush=True)
            out[kind][key] = rec
            if kind == "gait" and name in ("none", "clean") and \
                    rule == "importance" and scheme == "none":
                out[kind][key]["_params"] = params
        if kind == "gait":
            a = out["gait"]["none/importance/none"]
            b = out["gait"]["clean/importance/none"]
            fields = ("selected", "test_acc", "test_loss", "train_loss",
                      "val_loss", "importance")
            bits = sum(_bit_diffs(torch, x, y) for x, y in zip(
                a.pop("_params"), b.pop("_params")))
            differ = [f for f in fields if a[f] != b[f]]
            print(f"paper robust: gait clean vs no scenario: fields "
                  f"differing {differ}, {bits} final param elements differ "
                  f"(bit-exact required)", flush=True)
            if differ or bits:
                raise AssertionError("paper robust: the clean scenario is "
                                     "not the loop without one")
            out["gait"]["clean_vs_none"] = {"fields_differing": differ,
                                            "param_elements_differing": bits}

    # parity: 2 gait rounds under sign flips and Krum, with int8 and with
    # top-k uploads, the kernels against their plain versions
    ad, cfg, val, test, loaders, _ = _paper_experiment("gait")
    nc = PAPER_ROBUST["gait_clients"]
    plain = {"int8": dict(quantize_stochastic=ref.quantize_stochastic_2d,
                          dequantize=ref.dequantize_2d),
             "topk": dict(topk_mask=ref.topk_mask_2d)}
    out["parity"] = {}
    for scheme in COMP_SCHEMES:
        sides = {}
        for side in ("kernel", "plain"):
            patch = (contextlib.nullcontext() if side == "kernel" else
                     mock.patch.multiple(
                         ops, fused_adamw=ops.fused_adamw_plain,
                         **plain[scheme]))
            ops.reset_launch_counts()
            with patch, det():
                h = pl.train_wssl(ad, loaders(nc), val, test,
                                  _paper_robust_cfg(nc, "krum", scheme),
                                  rounds=PAPER_ROBUST["parity_rounds"],
                                  local_steps=steps,
                                  lr=PAPER_RUN["gait"]["lr"], seed=0,
                                  scenario=get_scenario(
                                      "sign-flip-adversary"),
                                  device=dev)
            counts = ops.launch_counts()
            want = ({"fused_adamw", *PAPER_COMP_KERNELS[scheme]}
                    if side == "kernel" else set())
            if {k for k, v in counts.items() if v} != want:
                raise AssertionError(f"paper robust parity {scheme} {side}: "
                                     f"launches {counts}")
            sides[side] = (h, [t.detach().cpu() for t in _leaves(
                h.pop("params"))])
        (hk, pk), (hp, pp) = sides["kernel"], sides["plain"]
        fields = ("selected", "test_acc", "test_loss", "train_loss",
                  "val_loss", "importance", "bytes_sync")
        differ = [f for f in fields if hk[f] != hp[f]]
        bits = sum(_bit_diffs(torch, a, b) for a, b in zip(pk, pp))
        rec = {"fields_differing": differ, "param_elements_differing": bits,
               "param_elements": sum(t.numel() for t in pk),
               "test_acc": hk["test_acc"]}
        out["parity"][scheme] = rec
        print(f"paper robust parity: gait {nc} clients x "
              f"{PAPER_ROBUST['parity_rounds']} rounds, sign-flip-adversary, "
              f"krum, {scheme}: fields differing {differ}; {bits} of "
              f"{rec['param_elements']} final param elements differ "
              f"(bit-exact required)", flush=True)
        if differ or bits:
            raise AssertionError(f"paper robust parity {scheme}: kernel and "
                                 f"plain runs differ: {rec}")
    return out


def _check_bodies(ops, where, bf16=True):
    """The counted run's flash and SSD-scan launches all took their
    tensor-core bodies (bf16, at the models' shapes; none of them in fp32)
    and its paged launches the split-K pair."""
    counts, bodies = ops.launch_counts(), ops.body_launches()
    want = {"flash_attention_tc": counts["flash_attention"] if bf16 else 0,
            "paged_decode_attention_split": counts["paged_decode_attention"],
            "ssd_scan_tc": counts["ssd_scan"] if bf16 else 0}
    if bodies != want:
        raise AssertionError(f"{where}: launches by body {bodies}, expected "
                             f"{want} (launches {counts})")
    return bodies


def _check_band(rec):
    line = (f"  {rec['kernel']} " + " ".join(
        f"{k}={rec[k]}" for k in ("B", "S", "Hq", "Hkv", "hd", "bs", "nb",
                                  "N", "M", "dtype", "causal", "window",
                                  "softcap")
        if k in rec)
            + f": max|diff| {rec['max_abs_err']:.3g} (band {rec['band']:g}), "
            f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"library {rec['library_ms'] if rec['library_ms'] is None else round(rec['library_ms'], 4)} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    if "eager_ms" in rec:
        line += (f"; graph-timed, eager per call: kernel "
                 f"{rec['eager_ms']:.4f} ms"
                 + (f", library {rec['library_eager_ms']:.4f} ms"
                    if rec.get("library_eager_ms") is not None else ""))
    if "device_ms_by_kernel" in rec:
        line += "; device ms a call by kernel (profiler): " + ", ".join(
            f"{name[:40]} {ms:.4f}"
            for name, ms in rec["device_ms_by_kernel"].items())
    if "old_band" in rec:
        line += (f"; {rec['body']} body, {rec['differing_share']:.4%} of "
                 f"outputs differ from the plain version; old absolute band "
                 f"{rec['old_band']:g}")
    if "splits" in rec:
        line += (f"; positions {rec['pos_range']}, {rec['splits']} splits of "
                 f"{rec['blocks_per_split']} blocks, {rec['neutral_ctas']} "
                 f"neutral CTAs")
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
    # phase 6 holds ~70 GB of one card; expandable segments keep the
    # caching allocator from fragmenting it
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    record["ptxas"] = dict(_build.BUILD_LOG)
    print(f"build: {len(paths)} kernels in {record['build_s']:.1f} s "
          f"({', '.join(p.name for p in paths.values())})", flush=True)
    for name, lines in _build.BUILD_LOG.items():
        for ln in lines:
            print(f"  ptxas {name}: {ln}", flush=True)

    # -- 2d. the scan kernels (and flash at g = 10) against their plain
    # versions; first, while the card is empty
    print("scan kernels:", flush=True)
    (record["scan_kernel_checks"], main_ssd, main_rg,
     record["flash_g10"]) = run_scan_kernels(torch, ops, ref)
    # -- 10. the prefill step of both recurrent families -----------------
    record["prefill_step"] = run_prefill_step(torch, ops)
    # -- 11. serve both recurrent families --------------------------------
    record["family_serve"] = run_family_serve(torch, ops)

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
        checks.append(check_flash(torch, ops, ref, b=2, hq=4, hkv=1, s=150,
                                  hd=32, dtype=dtype, seed=9))
        # prompts shorter than one tile (a 5-token prompt, one token at
        # g = 10) and attention that is not causal
        checks.append(check_flash(torch, ops, ref, b=1, hq=8, hkv=1, s=5,
                                  hd=256, dtype=dtype, seed=10))
        checks.append(check_flash(torch, ops, ref, b=3, hq=10, hkv=1, s=1,
                                  hd=256, dtype=dtype, seed=11))
        checks.append(check_flash(torch, ops, ref, b=2, hq=4, hkv=1, s=200,
                                  hd=64, dtype=dtype, seed=12, causal=False))
        checks.append(check_paged(torch, ops, ref, b=8, hq=8, hkv=1, hd=256,
                                  bs=16, nb=40, dtype=dtype, seed=5))
        # one row (37 splits, 1 CTA each); short rows, most splits neutral
        checks.append(check_paged(torch, ops, ref, b=1, hq=8, hkv=1, hd=256,
                                  bs=16, nb=37, dtype=dtype, seed=8,
                                  dead_row=False))
        checks.append(check_paged(torch, ops, ref, b=8, hq=8, hkv=1, hd=256,
                                  bs=16, nb=37, dtype=dtype, pos_hi=48,
                                  seed=9))
    # the serving path's own shapes: one 512-token prefill; 8 decode rows
    # over a 37-block table, live positions 256..591, every row live
    main_flash = check_flash(torch, ops, ref, b=1, hq=8, hkv=1, s=512,
                             hd=256, dtype="bfloat16", seed=6, profile=True)
    main_paged = check_paged(torch, ops, ref, b=8, hq=8, hkv=1, hd=256, bs=16,
                             nb=37, dtype="bfloat16", pos_lo=256, seed=7,
                             dead_row=False, profile=True)
    checks += [main_flash, main_paged]
    for rec in checks:
        _check_band(rec)
        torch.cuda.synchronize()
    record["kernel_checks"] = checks

    # -- 2b. training kernels against their plain versions ----------------
    print("training kernels:", flush=True)
    train_checks = []
    for dtype in ("float32", "bfloat16"):
        for rows, cols, seed in ((3, 100003, 11), (2, CLIENT_WG_COLS, 12)):
            train_checks.append(check_fused_adamw(torch, ops, ref, rows=rows,
                                                  cols=cols, dtype=dtype,
                                                  seed=seed))
            train_checks.append(check_wavg(torch, ops, ref, rows=rows,
                                           cols=cols, dtype=dtype, seed=seed))
    main_adam = [r for r in train_checks if r["kernel"] == "fused_adamw"
                 and r["dtype"] == "float32" and r["M"] == CLIENT_WG_COLS][0]
    main_wavg = [r for r in train_checks if r["kernel"] == "weighted_average"
                 and r["dtype"] == "float32" and r["M"] == CLIENT_WG_COLS][0]
    for rec in train_checks:
        _check_band(rec)
    record["train_kernel_checks"] = train_checks
    torch.cuda.empty_cache()

    # -- 2c. compression kernels against their plain versions -------------
    print("compression kernels:", flush=True)
    record["compress_kernel_checks"], main_comp = run_compress_kernels(
        torch, ops, ref)

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
    want = {**{k: 0 for k in counts},
            "flash_attention": cfg.num_layers * len(reqs),
            "paged_decode_attention": cfg.num_layers * chunks * sp.chunk}
    if counts != want:
        raise AssertionError(f"serve: launches {counts}, expected {want}")
    bodies = _check_bodies(ops, "serve gemma-2b")
    record["serve"] = {"requests": len(reqs), "tokens": report.tokens_out,
                       "seconds": secs, "tokens_per_s": report.tokens_out / secs,
                       "chunks": chunks, "decode_steps": chunks * sp.chunk,
                       "launches": counts, "bodies": bodies,
                       "peak_bytes": peak,
                       "max_len": sp.max_len}
    print(f"serve: gemma-2b bf16, {len(reqs)} requests, {report.tokens_out} "
          f"tokens in {secs:.2f} s ({report.tokens_out / secs:.1f} tok/s), "
          f"{chunks * sp.chunk} decode steps, launches {counts}, by body "
          f"{bodies}, peak memory "
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
    del params, engine, plain_engine
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. the card ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    record["nvidia_smi"] = smi
    print(smi.splitlines()[0], flush=True)

    # -- 6. train full Gemma-2B through the kernels -----------------------
    record["train"], train_counts = run_train(torch, ops)
    # -- 7. train parity with the plain path -------------------------------
    record["train_parity"] = run_train_parity(torch, ops)
    # -- 8. compressed training at full width -----------------------------
    record["comp_train"] = run_comp_train(torch, ops)
    # -- 9. compressed kernel path vs plain path ---------------------------
    record["comp_parity"] = run_comp_parity(torch, ops, ref)
    # -- 12-18. the families' training, the paper's experiment, faults -----
    for key, label, fn in (
            ("family_train", "12. family training", run_family_train),
            ("family_train_parity", "13. family train parity",
             run_family_train_parity),
            ("paper", "14. the paper experiment", run_paper),
            ("paper_parity", "15. paper parity", run_paper_parity),
            ("fault_train", "16. the round under faults", run_fault_train),
            ("fault_parity", "17. fault parity", run_fault_parity),
            ("paper_robust", "18. the paper's robustness",
             run_paper_robust)):
        t0 = time.perf_counter()
        record[key] = fn(torch, ops)
        record[f"{key}_s"] = time.perf_counter() - t0
        print(f"{label}: {record[f'{key}_s']:.1f} s", flush=True)
        _free(torch)

    sources = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:74"),
               "paged_decode_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                                          "src/repro/kernels/paged_attention.py:91"),
               "fused_adamw": ("src/repro_torch/kernels/csrc/fused_adam.cu",
                               "src/repro/kernels/fused_adam.py:63"),
               "weighted_average": ("src/repro_torch/kernels/csrc/wavg.cu",
                                    "src/repro/kernels/wavg.py:30"),
               "quantize_stochastic": ("src/repro_torch/kernels/csrc/compress.cu",
                                       "src/repro/kernels/compress.py:53"),
               "dequantize": ("src/repro_torch/kernels/csrc/compress.cu",
                              "src/repro/kernels/compress.py:89"),
               "topk_mask": ("src/repro_torch/kernels/csrc/compress.cu",
                             "src/repro/kernels/compress.py:120"),
               "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan.py:70"),
               "rg_lru_scan": ("src/repro_torch/kernels/csrc/rg_lru.cu",
                               "src/repro/kernels/rg_lru.py:43")}
    # each kernel's launches on its own main path: serving for the
    # attention kernels, the training run of phase 6 for AdamW and wavg,
    # phase 8's int8 run for quantize / dequantize and its top-k run for
    # the mask, phase 10's prefill steps for the two scans
    comp = record["comp_train"]
    steps = record["prefill_step"]
    launches = {**counts, "fused_adamw": train_counts["fused_adamw"],
                "weighted_average": train_counts["weighted_average"],
                **{k: comp[scheme]["launches"][k]
                   for scheme, names in COMP_KERNELS.items() for k in names},
                "ssd_scan": steps["mamba2-370m"]["launches"]["ssd_scan"],
                "rg_lru_scan":
                    steps["recurrentgemma-2b"]["launches"]["rg_lru_scan"]}
    kernels = []
    for rec in (main_flash, main_paged, main_adam, main_wavg,
                main_comp["quantize_stochastic"], main_comp["dequantize"],
                main_comp["topk_mask"], main_ssd, main_rg):
        src, replaces = sources[rec["kernel"]]
        kernels.append({"name": rec["kernel"], "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[rec["kernel"]],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    record["kernels"] = kernels
    if record_path is not None:
        record_path.parent.mkdir(parents=True, exist_ok=True)
        record_path.write_text(json.dumps(record, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
