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

12. family training — 2 WSSL rounds of Mamba-2-370M (full width at 8
             of its 48 layers, 4 clients, cut 4, seq 256: two SSD
             chunks) and RecurrentGemma-2B (full width at 13 of its 26
             layers, 2 clients, cut 3, seq 128)
             through ``launch/train.py``: fp32 params, bf16 activations,
             participation 0.5, fused AdamW, the plain scans (as the JAX
             package trains).  Checks: finite losses; fused-AdamW launches
             = leaves x rounds; no SSD-scan, RG-LRU or flash launch; a
             masked client's AdamW moment rows unchanged by the round that
             masked it (fp64 row sums).  Reports round 0 and rounds 1-2,
             the peak memory and one more round under the profiler.
13. family train parity — both families at full width and a cut depth
             (Mamba-2 2 layers, cut 1; RecurrentGemma 6 layers, cut 3),
             through the AdamW kernel and then ``ops.fused_adamw_plain``,
             the same seed and Gumbel draws: masks equal, losses and
             stages within phase 7's bands.
14. the paper experiment — ``core/paper_loop.py`` at full width in fp32
             on the synthetic stand-ins: the gait FFN WSSL at 2 and 10
             clients (3 rounds x 10 local steps, ``make_gait_like(n=
             20000)``, split by subject) and its centralized baseline;
             ResNet-18 (``CifarConfig``) WSSL at 4 clients (2 x 10, batch
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

16. the round under faults — Mamba-2-370M (full width at 16 of its 48
             layers since PR 24, 8 clients,
             cut 8, seq 256, batch 2, participation 1.0; fp32 params, bf16
             activations, fused AdamW, the plain scans), every client on a
             token stream of its own: no scenario against ``clean``, 1
             round each, the whole state bit-exact; then
             ``scaled-grad-adversary`` (clients 0-1 at x32) under the
             importance mean and under Krum (f = 2), 1 round each.
             Checks: finite losses, fused-AdamW launches = leaves x
             rounds, Krum never picks client 0 or 1.  Reports the rounds'
             seconds, peak memory, the adversaries' importance against the
             honest mean and the global model's validation loss.
17. fault parity — Mamba-2-370M at full width and 3 layers, cuts (1, 2)
             (one edge stage, 2 hop replicas), 8 clients, seq 128 (one SSD
             chunk; phase 16 crosses chunks), participation 0.5, 1 round: each fault scenario of
             ``FAULT_SCENARIOS``
             under the importance mean and each robust rule under
             ``scaled-grad-adversary``, through the AdamW kernel and
             through ``ops.fused_adamw_plain`` with the same seed and
             Gumbel draws: masks, losses, stages and moments bit-exact;
             a masked client's moment rows unchanged by its round; AdamW
             launches = client leaves a round + shared leaves a round with
             a survivor.
18. the paper's robustness — the paper loop on its own models: the gait
             FFN at 10 clients (3 rounds x 10 steps, ``make_gait_like(n=
             20000)`` by subject) under seven scenarios with the importance
             mean, Krum and the median under the two model-poisoning
             scenarios, int8 and top-k uploads; ResNet-18 (``CifarConfig``)
             at 8 clients (2 x 10) under ``label-flip-adversary`` with the
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
19. Gemma-3-12B serving — Gemma-3-12B at full width and 18 of its 48
             layers (15 local with window 1024 and 3 global, 16 query
             heads over 8 kv heads, hd 256; cut in depth to make room for
             phases 23 and 25) in bf16 at random weights (output projections x3),
             through the fault-routed router: 16 ``bursty_trace`` requests
             (prompts 768-1536, 16-32 new tokens, half with deadlines), 2
             replicas x 8 slots, chunk 8, paged KV of block 16, prefill
             priced at the card's 0.002 decode steps a token
             (``GEMMA3_RUN``), flash prefill and paged decode.  Nine runs: clean, ``replica-drop``, ``slow-host``,
             ``flash-crowd`` and ``degraded-fleet`` (both autoscaling to 4
             replicas), a pool of 60% of full residency, speculative
             decode (4 drafts from the client stage at cut 6) under
             ``replica-drop``, split mode at cuts (6, 12), and the plain
             path (dense prefill, gathered decode).  Checks: exact launch
             counts (flash 18 per admission, re-admissions included; paged
             3 per decode and verify step, 1 per draft step), every one on
             the tensor-core / split-K body; every request served or shed,
             shed ones with deadlines, none unfinished; re-routes under
             drops, a grown fleet under the flash crowd; runs 2, 3, 6, 7
             and 8 carry the clean run's tokens exactly on every request
             both served; the plain path equals them wherever its top-2
             margin exceeds 0.5.  Flash (local and global) and paged
             decode at these shapes against their plain versions, graph-
             timed beside SDPA (a band mask for the local layers); one
             admission and two decode steps of the kernel path profiled.

20. the async round — see ``run_async``: the bounded-staleness round of
             Mamba-2-370M (full width, 8 layers at cut 4) under
             ``async-stragglers`` (20a), a 3-layer
             cut against the plain AdamW and compression bit for bit
             (20b), the gait loop under deadlines (20c).
21. StableLM-2-12B and Qwen2.5-32B — 21a: flash (bf16 on the tensor-
             core body, fp32 on the SIMT body) and paged decode against
             their plain versions at StableLM's 32 query heads over 8 at
             head dim 160 (the tensor-core body pads it to 192 through
             TMA's zero fill) and Qwen's 40 over 8 at 128 (g 5), a ragged
             admission too, graph-timed beside SDPA.  21b: full
             StableLM-2-12B (40 layers, LayerNorm, bf16, its LayerNorm
             scale and bias moved off their init) serving 8 requests
             (prompts 256-1024, 16-32 new) on 2 replicas x 8 slots, chunk
             8, block 16, through flash and paged decode, then the plain
             path teacher-forced on the kernel path's tokens: exact launch
             counts on the tensor-core / split-K bodies, every served token
             equal to the plain path's argmax wherever that path's top-2
             margin exceeds 0.5.  21c: Qwen2.5-32B at 32 of its 64 layers (65.5 GB
             whole; qkv biases
             moved off zero) the same way, 4 requests (prompts 512-1024)
             on 1 replica x 8 slots; both print their peak memory.  21d:
             StableLM-2-12B at full width cut to 4 layers (cut 2, 2
             clients, seq 128, fp32 params, 2 rounds) through the AdamW
             kernel and then its plain version: AdamW launches = leaves x
             rounds exactly, masks and losses equal, 0 stage elements
             differ, the moments' fingerprints equal.
22. OLMoE-1B-7B and Phi-3.5-MoE — 22a: flash and paged decode at
             OLMoE's 16 query heads over 16 (g 1) and Phi's 32 over 8 (g
             4), both at head dim 128, as in 21a; the MoE dispatch
             (``models/moe.py::route``) on the card equal to the CPU's in
             every field on 4096 tokens with planted router ties and
             overflowing experts; OLMoE's full-width MoE layer run twice,
             bit-identical.  22b: full OLMoE-1B-7B (16 layers, 64 experts
             top-8, bf16) serving 8 requests (prompts 256-1024, 16-32
             new) on 2 x 8 slots; 22c: Phi-3.5-MoE at 8 of its 32
             layers (LayerNorm moved off its init, 16 experts top-2), 8
             requests (prompts 512-1024) on 1 x 8; each kernel path vs the
             plain path as in 21b, the plain path also replaying the kernel
             path's expert choices (``models/moe.py::top_k``), so the
             comparison holds the attention kernels and not the router's
             near-ties; the rows where the plain path's own top-k picks
             other experts are counted and printed.  22d: OLMoE at full
             width cut to 4 layers, cuts (1, 3), 4 clients at
             participation 0.5, fp32, 2 rounds (every client runs: the
             edge and server aux enter for all N), as 21d.
23. MusicGen-medium and Qwen2-VL-72B — 23a: flash and paged decode at
             MusicGen's 24 query heads over 24 (g 1) at head dim 64 and
             Qwen2-VL's 64 over 8 (g 8) at 128, flash at the vision
             prefill's 2,048 positions and at MusicGen's 6,144-token
             windowed admission, as in 21a.  23b: full MusicGen-medium (48
             layers, ungated GELU MLP, LayerNorm moved off its init)
             serving 8 requests (prompts 256-1024) on 2 x 8 slots; 23c:
             Qwen2-VL-72B at 20 of its 80 layers (M-RoPE, qkv biases moved
             off zero), 4 text requests (prompts 512-1024) on 1 x 8; each
             as 21b; then Qwen2-VL's prefill step on 1,024 patch
             embeddings before 1,024 text tokens through the kernels
             against the same step with flash's plain version: flash once
             a layer, the last position's argmax equal wherever the plain
             top-2 margin exceeds 0.5, max|diff| beside LOGIT_BAND, and the
             gap to the dense path's temporal-stream mask as a reading.
             23d: MusicGen at full size, cuts (4, 44), 4 clients, fp32, 2
             rounds, as 21d.  23e: reduced Qwen2-VL's round with 16 patch
             embeddings a row, 4 clients, cut 1, fp32, the sync round and
             a round of client chunks of 2, through the AdamW kernel and
             its plain version: 0 elements differ.  23f: MusicGen whole
             under the decode window 4096: 2 requests of 4608-6144 tokens,
             64 new each, on 1 x 4 slots (every ring wraps), as 21b: flash
             48 launches an admission, paged none.
24. the chunked / flash training path — 24a: full Gemma-2B (fp32
             params, bf16 activations), 2 clients at cut 4, one sequence
             a client, one WSSL round through ``launch/train.py`` at S
             4096 with ``impl="chunked"`` (the flash path: an online
             softmax over 256-key blocks whose backward recomputes the
             probability tiles) and one with ``impl="dense"``, the same
             seed and Gumbel draw: fused AdamW launches = leaves and
             nothing else launched, the training and validation losses
             within 1e-2 relative; then one chunked round at S 8192; each
             round's time and peak.  24b: the flash attention Function
             alone against the dense path's autograd at Gemma-2B's layer
             (8 over 1 heads) and Gemma-3-12B's local one (16 over 8,
             window 1024), S 4096: out, dq, dk, dv within 1e-4 of
             max|dense| in fp32; forward + backward timed in bf16 beside
             the dense autograd and SDPA's, each path's peak.  24c:
             Gemma-3-12B at 6 of its 48 layers (one super-block: 5 local,
             1 global), ``tf.loss_fn`` and its gradients at S 4096 with
             nested remat (the span's checkpoint and one a layer inside
             it, counted) and without: every element equal, each peak.
25. the client axis — phase 16's Mamba-2-370M (full width, 16 layers,
             cut 8, 8 clients, seq 256) in fp32 activations (in bf16 the
             rounding of the activations, not the sharding, moves the
             validation losses past the bands), participation 0.5, 2
             rounds a case.  The flat kernel-path rounds first
             (importance, trimmed_mean, async at deadline 4), whose Gumbel
             draws every sharded run takes; 25a: the sharded sync round
             at S 1 over NCCL in this process, every state element equal
             to the flat round's; S 2 (importance, trimmed_mean) and S 4
             (importance) as processes sharing the card over gloo
             (``launch/mesh.py::spawn_client_shards``): masks equal, the
             global client stage after round 0 within 1e-5 of the flat
             round's (the tree's reassociated sum), the client and server
             stages after round 1, validation losses and the loss within
             5e-3, the cross-shard bytes equal to
             ``hierarchical_sync_bytes``, AdamW launches on every rank
             equal to the flat round's; 25b int8 at S 2: quantize and
             dequantize launches = client leaves x the rounds the shard
             uploads in, and the rounds through their plain versions bit
             for bit; 25c the async round at S 2 under
             ``async-stragglers``: at deadline inf the sharded sync round
             bit for bit, at deadline 4 the flat async round's admission
             counts and the 25a bands.  Each case prints its round times,
             each rank's peak, rank 0's busy share and the collectives'
             share of round 0.
26. the roofline — three whole steps of full Gemma-2B, each on objects
             an earlier phase built: 26a the prefill step
             (``make_prefill_step(cfg, "kernel")``, B 2 x S 4096) and 26b
             one decode step (``make_serve_step``, a contiguous cache at
             phase 3's engine shape: 8 slots, its max_len) on phase 3's
             serving params, run right after phase 4; 26c one round at
             phase 24a's shape (2 clients, S 4096, ``impl="chunked"``) on
             the state 24a trained, run inside 24a.  For each: (a) the
             dry run's predicted argument bytes (``launch/specs.py``,
             ``core/round.py::abstract_state``, placed by
             ``sharding.device_bytes`` on one card) equal the summed
             ``nbytes`` of the objects on the card exactly; (b) the op
             counter (``roofline/op_cost.py``) on one untimed call on the
             card and on the same step on the meta device agree exactly
             in FLOPs, bytes, elementwise operations and kernel credits
             (the round with every client selected on both, as the dry
             run's host decision); (c) the step's time (CUDA events, the
             mean of 3 calls after a warm-up; the counted step itself:
             for 26c ``make_train_step``, a round without validation,
             its round index zeroed before each call) beside its
             ``t_compute`` and ``t_memory``, ``mfu = model_flops /
             (t x peak)`` at bf16, and the meta peak estimate beside
             the ``max_memory_allocated`` of one more call.

Each of phases 12-25 prints its wall time.  Then one JSON line with every
kernel's numbers (the nine kernels, then flash and paged decode at
Gemma-3-12B's, StableLM-2-12B's, Qwen2.5-32B's, OLMoE-1B-7B's,
Phi-3.5-MoE's, MusicGen-medium's and Qwen2-VL-72B's shapes), and as the
last line
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the script
exits non-zero before that line; it also exits non-zero, printing no
result, when no card is present or the package is not beside it.

    python3 chip_smoke.py --record out/chip_smoke.json

also writes the full record of every phase to that JSON file.
"""

from __future__ import annotations

import argparse
import contextlib
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


def _cost():
    """``repro_torch.roofline.analysis``: the card's peaks and each
    kernel's (flops, bytes), from which every bound here is taken
    (imported once ``main`` has put ``src`` on the path)."""
    from repro_torch.roofline import analysis
    return analysis


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
    an = _cost()
    cost = an.flash_attention_cost(b, hq, hkv, s, hd, q.element_size(),
                                   causal=causal, window=window)
    rec["bound_ms"], rec["bound_by"] = an.bound_ms(cost.bytes, cost.flops,
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
    an = _cost()
    valid, n_walked = an.paged_live_entries(ppos, table, pos, bs)
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
    cost = an.paged_decode_cost(b, hq, hkv, hd, args[0].element_size(),
                                block_size=bs, valid=valid, walked=n_walked)
    rec["bound_ms"], rec["bound_by"] = an.bound_ms(cost.bytes, cost.flops,
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
    an = _cost()
    cost = an.fused_adamw_cost(rows * cols, rows=rows,
                               itemsize=p.element_size(),
                               grad_itemsize=g.element_size())
    rec["bound_ms"], rec["bound_by"] = an.bound_ms(cost.bytes, cost.flops,
                                                   "float32")
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
    an = _cost()
    cost = an.wavg_cost(rows, cols, x.element_size())
    rec["bound_ms"], rec["bound_by"] = an.bound_ms(cost.bytes, cost.flops,
                                                   "float32")
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
        qrec, drec = recs
        qrec["ms"] = _time_ms(torch, lambda: ops.quantize_stochastic(
            x, u, inv, levels), reps=10)
        qrec["plain_ms"] = _time_ms(torch, lambda: ref.quantize_stochastic_2d(
            x, u, inv, levels), reps=3, warmup=1)
        # no PyTorch call draws a stochastic rounding from given uniforms
        qrec["library_ms"] = None
        an = _cost()
        cost = an.quantize_cost(rows, cols)
        qrec["bound_ms"], qrec["bound_by"] = an.bound_ms(
            cost.bytes, cost.flops, "float32")
        drec["ms"] = _time_ms(torch, lambda: ops.dequantize(q, step), reps=10)
        drec["plain_ms"] = _time_ms(torch, lambda: ref.dequantize_2d(q, step),
                                    reps=10)
        # one PyTorch call computes the same function: int8 * fp32 promotes
        drec["library_ms"] = _time_ms(torch, lambda: q * step[:, None],
                                      reps=10)
        cost = an.dequantize_cost(rows, cols)
        drec["bound_ms"], drec["bound_by"] = an.bound_ms(
            cost.bytes, cost.flops, "float32")
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
        rec["ms"] = _time_ms(torch, lambda: ops.topk_mask(x, t), reps=10)
        rec["plain_ms"] = _time_ms(torch, lambda: ref.topk_mask_2d(x, t),
                                   reps=10)
        # no one PyTorch call: the mask needs abs, a comparison and where
        rec["library_ms"] = None
        an = _cost()
        cost = an.topk_mask_cost(rows, cols)
        rec["bound_ms"], rec["bound_by"] = an.bound_ms(cost.bytes, cost.flops,
                                                       "float32")
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
    adam = _cost().fused_adamw_cost(n_elems)
    out = {"opt_step_ms": _time_ms(torch, step, reps=3, warmup=1),
           "opt_step_bound_ms": _cost().bound_ms(adam.bytes, adam.flops,
                                                 "float32")[0]}
    del g_c, g_s
    torch.cuda.empty_cache()
    s = TRAIN_RUN["seq_len"]
    batch = round_batch(cfg, 2, TRAIN_RUN["batch_per_client"], s, 3, dev)
    val = {k: torch.as_tensor(v, device=dev) for k, v in lm_batch(
        TRAIN_RUN["val_batch"], s, cfg.vocab_size, seed=10_000).items()}
    round_fn = make_round_fn(cfg, wssl_cfg, train_cfg, impl="dense")
    out["profile"] = _device_profile(torch, lambda: round_fn(state, batch,
                                                             val))
    return out


def _device_profile(torch, fn, top: int = 25, cpu: bool = True):
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activity, or
    CUDA alone without ``cpu``: a round's ~10^5 launches make the host
    events' processing, not the card, the cost) from a synchronised start
    to a synchronise after it: the wall time, the device's busy time (the
    kernels' summed device time) and share of the wall, the launches, and
    the ``top`` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
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
    round_fn = make_round_fn(cfg, wssl_cfg, train_cfg, impl="dense")
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
        an = _cost()
        cost = an.ssd_scan_cost(b, s, h, p, n, args[0].element_size(), chunk)
        rec["flops"] = cost.flops
        rec["bound_ms"], rec["bound_by"] = an.bound_ms(cost.bytes,
                                                       cost.flops, dtype)
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
        an = _cost()
        cost = an.rg_lru_cost(b, s, w, bb.element_size())
        rec["bound_ms"], rec["bound_by"] = an.bound_ms(cost.bytes, cost.flops,
                                                       "float32")
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


def _taped_engine(torch, cfg, impl, dev, tape, reqs=None,
                  decode_window_override=None):
    """A ``DecodeEngine`` on ``impl``'s path that writes what each of its
    admissions and decode chunks emits onto ``tape`` (batch number, in the
    order the router opens batches -> the calls' tokens in order).  Given
    ``reqs`` it replays instead a tape taken from another run of the same
    requests through the same router schedule: each admission and every
    slot of each chunk, dead ones too, emits the taped tokens (the
    teacher-forced ``forced`` lane of ``decode_chunk``), so both runs see
    the same tokens, and ``engine.seen[rid]`` keeps, for every token the
    request emits, this path's own (argmax, top-2 margin) of the logits
    behind it (read off ``tf.prefill`` and ``tf.decode_step``).
    ``decode_window_override`` serves every global layer within that
    window (a ring cache, never paged)."""
    from unittest import mock
    import numpy as np
    from repro_torch.models import transformer as tf
    from repro_torch.serve import DecodeEngine
    reqs = list(reqs or ())
    rid_of = {r.prompt.tobytes(): r.rid for r in reqs}
    max_new = {r.rid: r.max_new for r in reqs}

    class Engine(DecodeEngine):
        def __init__(self):
            super().__init__(cfg, impl=impl, paged_kernel=impl == "kernel",
                             decode_window_override=decode_window_override,
                             device=dev)
            self.batches = {}
            self.slot_rid = {}          # (batch, slot) -> [rid, next token]
            self.seen = {r.rid: [] for r in reqs}

        def _spy(self, fn, rows):
            """``fn`` reporting the argmax and margin of its last logits
            (``rows`` picks them out of its output) into ``rows.out``."""
            def spied(*a, **kw):
                out = fn(*a, **kw)
                lg = rows(out[0])
                spied.out.append((lg.argmax(-1), _top2_margin(torch, lg)))
                return out
            spied.out = []
            return spied

        def admit(self, state, params, prompt, slot, blocks=None):
            n = self.batches.setdefault(id(state), len(self.batches))
            if not reqs:
                tok = super().admit(state, params, prompt, slot,
                                    blocks=blocks)
                tape.setdefault(n, []).append(tok)
                return tok
            spy = self._spy(tf.prefill, lambda lg: lg[0, -1])
            with mock.patch.object(tf, "prefill", spy):
                super().admit(state, params, prompt, slot, blocks=blocks)
            rid = rid_of[prompt.tobytes()]
            (am, mg), = spy.out
            self.seen[rid] = [(int(am), float(mg))]
            self.slot_rid[(n, slot)] = [rid, 1]
            tok = tape[n].pop(0)
            state.tok[slot] = tok
            return tok

        def decode_chunk(self, state, params, forced, force_len, *a, **kw):
            n = self.batches.setdefault(id(state), len(self.batches))
            if not reqs:
                out = super().decode_chunk(state, params, forced, force_len,
                                           *a, **kw)
                tape.setdefault(n, []).append(out)
                return out
            taped = tape[n].pop(0)
            spy = self._spy(tf.decode_step, lambda lg: lg[:, -1])
            with mock.patch.object(tf, "decode_step", spy):
                out = super().decode_chunk(
                    state, params, taped,
                    np.full((taped.shape[0],), taped.shape[1], np.int32),
                    *a, **kw)
            steps = [(am.cpu().tolist(), mg.cpu().tolist())
                     for am, mg in spy.out]
            for (b, slot), at in self.slot_rid.items():
                if b != n:
                    continue
                rid, t = at
                for am, mg in steps:
                    if t < max_new[rid]:
                        self.seen[rid].append((am[slot], mg[slot]))
                    t += 1
                at[1] = t
            return out

    return Engine()


class _Routing:
    """The MoE expert choices of one run, recorded call by call (the top-k
    step, ``models/moe.py::top_k``), then replayed into another run that
    makes the same calls in the same order: the plain path held against
    the kernel path under one routing, so the comparison holds the
    attention kernels and not the router's near-ties (at bf16 a router's
    k-th and (k+1)-th probabilities often tie, and a whole expert's
    contribution then follows the last bit).  The replay counts the rows
    where the replaying path's own top-k picks another set of experts."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe.top_k
        self.calls, self.at = [], 0
        self.flips = self.rows = 0

    def record(self):
        from unittest import mock

        def rec(probs, k):
            vals, ids = self.real(probs, k)
            self.calls.append(ids)
            return vals, ids
        return mock.patch.object(self.moe, "top_k", rec)

    def replay(self):
        from unittest import mock

        def rep(probs, k):
            ids = self.calls[self.at]
            self.at += 1
            if ids.shape != (probs.shape[0], k):
                raise AssertionError(f"routing replay: call {self.at} "
                                     f"routes {probs.shape[0]} tokens, the "
                                     f"recording {tuple(ids.shape)}")
            own = self.real(probs, k)[1]
            # the set of experts decides the dispatch, not their rank
            self.flips = self.flips + (own.sort(1).values
                                       != ids.sort(1).values).any(1).sum()
            self.rows += ids.shape[0]
            return probs.gather(1, ids), ids
        return mock.patch.object(self.moe, "top_k", rep)


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
FAMILY_TRAIN_RUN = dict(device="cuda", reduced=False, rounds=2, val_batch=2,
                        seed=0, parity_seq=128)
FAMILY_TRAIN = {
    # full width at 8 of its 48 layers, to make room for phases 23 and 25
    # (every check as at full depth); sequence 256
    # is two SSD chunks, so the state crosses a chunk boundary
    "mamba2-370m": dict(layers=8, clients=4, cut=4, seq=256, batch=2,
                        parity_layers=2, parity_cut=1),
    # 2 clients; 13 of its 26 layers (71.4 GB of p, m, v and g whole: 16 B
    # x 4,462,200,320 elements), to make room for phase 25
    "recurrentgemma-2b": dict(layers=13, clients=2, cut=3, seq=128,
                              batch=2, parity_layers=6, parity_cut=3),
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
    round_fn = make_round_fn(cfg, wssl_cfg, train_cfg, impl="dense")
    return _device_profile(torch, lambda: round_fn(state, batch, val))


def run_family_train(torch, ops):
    """Phase 12: 2 WSSL rounds of Mamba-2-370M (full width, 8 layers)
    and RecurrentGemma-2B (full width, 13 layers) through ``launch/train.py`` (fp32 params, bf16
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
    """Phase 13: both families at full width and a cut depth, 2 rounds
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
                 gait=dict(n=20_000, clients=(2, 10), rounds=3, steps=10,
                           lr=1e-3, cfg="GaitConfig", batch=128),
                 resnet=dict(n=12_000, clients=(4,), rounds=2, steps=10,
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

# phases 16-17: the round under fault scenarios.  Mamba-2-370M at full
# width and 16 of its 48 layers (phase 16; cut in depth to make room for
# phase 24, as phases 12 and 20a were for phase 23) at 8 clients: p, m, v
# and g in fp32 are 16 B x ~1.14e9 elements at 48 layers, ~18.3 GB
# (reckoned); the pre-step rows and Krum's (8, D) matrix ~3.3 GB each
FAULT_RUN = dict(device="cuda", reduced=False, arch="mamba2-370m",
                 layers=16, clients=8, cut=8, seq=256, batch=2, val_batch=2,
                 seed=0,
                 clean_rounds=1, rounds=1, byzantine_f=2,
                 parity_layers=3, parity_cuts=(1, 2), parity_rounds=1,
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
    round_fn = make_round_fn(cfg, wssl_cfg, train_cfg, impl="dense")
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
    """Phase 16: Mamba-2-370M (full width, ``FAULT_RUN["layers"]`` of its
    48 layers) at 8 clients under faults — no scenario
    against ``clean`` (1 round each, state bit-exact), then
    ``scaled-grad-adversary`` (clients 0-1 at x32) under the importance
    mean and under Krum (f = 2), 1 round each."""
    from repro_torch.core import fairness
    from repro_torch.sim import get_scenario
    dev = torch.device(FAULT_RUN["device"])
    out = {}
    sides = {}
    for name, sc in (("none", None), ("clean", get_scenario("clean"))):
        cfg, wssl_cfg, train_cfg = _fault_setup(
            FAULT_RUN["layers"], (FAULT_RUN["cut"],), 1.0)
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
        cfg, wssl_cfg, train_cfg = _fault_setup(
            FAULT_RUN["layers"], (FAULT_RUN["cut"],), 1.0, rule)
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
    """Phase 17: Mamba-2-370M at full width and 3 layers, cuts (1, 2) (one
    edge stage, 2 hop replicas), 8 clients, seq 128, 1 round, under each
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
PAPER_ROBUST = dict(gait_clients=10, gait_rounds=3, resnet_clients=8,
                    resnet_rounds=2, steps=10, parity_rounds=2)
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
    uploads on its own models — the gait FFN at 10 clients (3 rounds x 10
    steps) and ResNet-18 at 8 (2 x 10) — with exact launch counts, the
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


# ---------------------------------------------------------------------------
# Gemma-3-12B through the whole serving plane (phase 19)
# ---------------------------------------------------------------------------

# module values, so a CPU rehearsal can shrink them.  Gemma-3-12B at full
# width in bf16 at random weights from seed 0, cut to 18 of its 48 layers
# (to make room for phases 23 and 25)
# and to 16 bursty requests (from 48 and 24, to make room for phase 23:
# two bursts of 8 still fill both replicas, and every check holds) of
# 768-1536 prompt tokens (they cross the 1024 window: the local rings wrap)
# and 16-32 new tokens, half of them with deadlines; 2 replicas x 8 slots,
# chunk 8, paged KV of block 16; split runs at cuts (6, 12), two hops.
#
# The simulated clock prices a prefilled token at ``prefill_unit`` decode
# steps.  The router's default, 0.25, prices a 1152-token admission at 288
# steps, where the card takes about one: this phase's profile on an H100
# 80GB HBM3 at 700 W (both under the profiler; PERF.md §5) read 0.152 s
# for an admission of 1,514 tokens against 1.071 s for a decode chunk of
# 8 steps, 1.0e-4 s a token against 0.134 s a step.  At 0.25 a replica that admits its 8 slots is
# busy for ~290 ticks, and under replica-drop (p 0.25 a tick) it is
# dropped before it finishes: nothing is served, in the JAX package as
# here (tests/test_torch_serve_faults.py::
# test_long_admissions_livelock_replica_drop_at_the_default_clock).  So
# the cell prices prefill at 0.002, and scales the trace's deadline slack,
# which ``bursty_trace`` reckons at 0.25 a token, by the ratio of the two
# ideal latencies at the mean prompt ((0.002 x 1152 + 24) / (0.25 x 1152
# + 24) = 0.084): (1.5, 20) -> (0.125, 1.7).
#
# ``out_scale`` multiplies every layer's output projections (``wo``,
# ``wd``): at the init scale the layers barely move the residual stream,
# the client stage's early-exit draft agrees with the whole model almost
# always (the reduced configs accept every draft at the JAX package's
# init, tests/test_torch_spec.py), and the speculative rollback would go
# unexercised.
GEMMA3_RUN = dict(device="cuda", reduced=False, layers=18, requests=16,
                  prompt_len=1536, gen=32, replicas=2, slots=8, chunk=8,
                  block_size=16,
                  burst_every=8, burst_size=8, deadline_frac=0.5,
                  slack=(0.125, 1.7), prefill_unit=0.002, out_scale=3.0,
                  draft_k=4, cuts=(6, 12), autoscale_max=4, scale_up_queue=4,
                  pool_share=0.6)
# (run, scenario, ServeParams overrides, DecodeEngine overrides); the first
# is the reference of the comparisons below
GEMMA3_CASES = (
    ("clean", "clean", {}, {}),
    ("replica-drop", "replica-drop", {}, {}),
    ("slow-host", "slow-host", {}, {}),
    ("flash-crowd", "flash-crowd", {"autoscale": True}, {}),
    ("degraded-fleet", "degraded-fleet", {"autoscale": True}, {}),
    ("pool-60", "clean", {"pool": True}, {}),
    ("speculative", "replica-drop", {"speculate": True}, {}),
    ("split", "clean", {}, {"split": True}),
    ("plain", "clean", {}, {"impl": "dense", "paged_kernel": False}))
# runs whose served requests must carry the clean run's tokens exactly:
# every one computes the same kernel calls on the same rows
GEMMA3_EXACT = ("replica-drop", "slow-host", "pool-60", "speculative",
                "split")


def _gemma3_setup(torch):
    from repro_torch.config import get_arch, reduced
    from repro_torch.launch.serve import serve_max_len
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ServeParams, bursty_trace
    run = GEMMA3_RUN
    dev = torch.device(run["device"])
    cfg = get_arch("gemma3-12b")
    if run["reduced"]:
        cfg = reduced(cfg).replace(dtype="bfloat16")
    elif run["layers"]:
        cfg = cfg.replace(num_layers=run["layers"])
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    for layer in params["stack"] + params["rem"]:
        layer["mixer"]["wo"].mul_(run["out_scale"])
        layer["mlp"]["wd"].mul_(run["out_scale"])
    reqs = bursty_trace(run["requests"], prompt_len=run["prompt_len"],
                        gen=run["gen"], vocab_size=cfg.vocab_size,
                        burst_every=run["burst_every"],
                        burst_size=run["burst_size"],
                        deadline_frac=run["deadline_frac"],
                        slack=run["slack"])
    margin = max(run["chunk"], run["draft_k"])
    base = ServeParams(replicas=run["replicas"], slots=run["slots"],
                       chunk=run["chunk"], block_size=run["block_size"],
                       prefill_unit=run["prefill_unit"],
                       max_len=serve_max_len(run["prompt_len"], run["gen"],
                                             margin, run["block_size"]))
    return dev, cfg, params, reqs, base


def _gemma3_params(base, over):
    import dataclasses
    run = GEMMA3_RUN
    kw = {}
    if over.get("autoscale"):
        kw.update(autoscale_max=run["autoscale_max"],
                  scale_up_queue=run["scale_up_queue"])
    if over.get("pool"):
        full = base.slots * (base.max_len // base.block_size + 1)
        kw["pool_blocks"] = int(full * run["pool_share"])
    if over.get("speculate"):
        kw.update(speculate=True, draft_k=run["draft_k"])
    return dataclasses.replace(base, **kw)


def _gemma3_launches(cfg, engine):
    """The attention kernels' launches a serving run must make: flash once
    per attention layer and admission; paged once per global layer and
    decode step, a draft step reaching only the client stage's; under the
    decode-window override no layer pages, so paged never."""
    from repro_torch.config import ATTN_GLOBAL
    kinds = [s.mixer for s in cfg.layer_specs()]
    paging = lambda ks: (0 if engine.decode_window_override
                         else ks.count(ATTN_GLOBAL))
    n_glob = paging(kinds)
    n_draft = paging(kinds[:engine.spec_cut])
    steps = engine.steps
    return lambda admissions: {
        "flash_attention": _family_launches(cfg)["flash_attention"]
        * admissions,
        "paged_decode_attention": n_glob * (steps["decode"] + steps["verify"])
        + n_draft * steps["draft"]}


def _gemma3_kernel_checks(torch, ops, ref, cfg):
    """Flash and paged decode at Gemma-3-12B's serving shapes (16 query
    heads over 8 kv heads, hd 256): a 1536-token admission through a
    local layer (window 1024, SDPA with a band mask beside) and a global
    one, a ragged prompt, and a decode step of 8 rows over 99 blocks of
    16, graph-timed."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s, w = GEMMA3_RUN["prompt_len"], cfg.window
    nb = (s + GEMMA3_RUN["gen"] + GEMMA3_RUN["chunk"] + 15) // 16
    local = check_flash(torch, ops, ref, b=1, hq=hq, hkv=hkv, s=s, hd=hd,
                        dtype="bfloat16", window=w, seed=19, profile=True)
    glob = check_flash(torch, ops, ref, b=1, hq=hq, hkv=hkv, s=s, hd=hd,
                       dtype="bfloat16", seed=20, profile=True)
    paged = check_paged(torch, ops, ref, b=8, hq=hq, hkv=hkv, hd=hd, bs=16,
                        nb=nb, dtype="bfloat16", pos_lo=s // 2, seed=21,
                        dead_row=False, profile=True)
    extra = [check_flash(torch, ops, ref, b=1, hq=hq, hkv=hkv, s=s - 425,
                         hd=hd, dtype=dtype, window=w, seed=22)
             for dtype in ("bfloat16", "float32")]
    extra.append(check_paged(torch, ops, ref, b=8, hq=hq, hkv=hkv, hd=hd,
                             bs=16, nb=nb, dtype="float32", seed=23))
    for rec in (local, glob, paged, *extra):
        _check_band(rec)
    return {"local": local, "global": glob, "paged": paged}, extra


def _profile_paged_serving(torch, cfg, params, reqs, sp, dev, label,
                           decode_window_override=None):
    """Where a kernel-path serving run's time goes, sampled as in phase 11
    (a whole run's ~200k launches a replica would keep the profiler's
    event processing busy for minutes): one admission of the longest
    prompt into a fresh paged batch, then two decode steps of all its
    slots (a step's thousands of launches make the profiler's event
    processing, not the card, the cost of a longer window)."""
    import numpy as np
    from repro_torch.serve import BlockAllocator, DecodeEngine
    engine = DecodeEngine(cfg, impl="kernel", paged_kernel=True,
                          decode_window_override=decode_window_override,
                          device=dev)
    state = engine.new_batch_state(sp.slots, sp.max_len,
                                   block_size=sp.block_size)
    alloc = BlockAllocator(sp.slots * (sp.max_len // sp.block_size + 1),
                           sp.block_size, reserved=sp.slots)
    by_len = sorted(reqs, key=lambda r: r.prompt_len, reverse=True)
    blocks = [alloc.allocate(min(r.prompt_len + r.max_new + sp.chunk,
                                 sp.max_len))
              for r in by_len[:sp.slots]]
    out = {"admit_profile": _device_profile(torch, lambda: engine.admit(
        state, params, by_len[0].prompt, 0, blocks=blocks[0]))}
    for slot, r in enumerate(by_len[1:sp.slots], start=1):
        engine.admit(state, params, r.prompt, slot, blocks=blocks[slot])
    forced = np.zeros((sp.slots, 2), np.int32)
    out["chunk_profile"] = _device_profile(
        torch, lambda: engine.decode_chunk(state, params, forced,
                                           np.zeros((sp.slots,), np.int32)))
    print(f"{label} profiled, kernel path: one admission of "
          f"{by_len[0].prompt_len} tokens: "
          + _profile_line(out["admit_profile"], top=3)
          + f"; two decode steps of {sp.slots} slots: "
          + _profile_line(out["chunk_profile"]), flush=True)
    return out


def run_gemma3_serve(torch, ops):
    """Phase 19: Gemma-3-12B (full width, 24 layers) through the whole
    serving plane — the fault-routed router with every serving scenario,
    EDF shedding, autoscaling, a 60% pool, speculative decode under
    replica drops, split mode at cuts (6, 12), and the plain path — then
    the attention kernels
    at its shapes.  Every kernel-path run: exact launch counts, all on the
    tensor-core / split-K bodies; every request served or shed, shed ones
    with finite deadlines, none unfinished.  Runs 2, 3, 6, 7 and 8 carry
    the clean run's tokens exactly on every request both served; the plain
    path equals them wherever its top-2 margin exceeds ARGMAX_MARGIN."""
    from repro_torch.config import ATTN_LOCAL
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.serve import DecodeEngine
    from repro_torch.sim import get_scenario
    t0 = time.perf_counter()
    dev, cfg, params, reqs, base = _gemma3_setup(torch)
    out = {"arch": cfg.name, "requests": len(reqs), "max_len": base.max_len,
           "prompt_lens": [r.prompt_len for r in reqs],
           "deadlines": sum(math.isfinite(r.deadline) for r in reqs),
           "runs": {}, "setup_s": time.perf_counter() - t0}
    if dev.type == "cuda":
        t0 = time.perf_counter()
        out["kernel_checks"], out["extra_kernel_checks"] = \
            _gemma3_kernel_checks(torch, ops, ref, cfg)
        out["kernel_checks_s"] = time.perf_counter() - t0
    n_local = [s.mixer for s in cfg.layer_specs()].count(ATTN_LOCAL)
    reports = {}
    for name, scenario, sp_over, eng_over in GEMMA3_CASES:
        sp = _gemma3_params(base, sp_over)
        kw = {"impl": "kernel", "paged_kernel": True}
        kw.update({k: v for k, v in eng_over.items() if k != "split"})
        if eng_over.get("split"):
            kw["cuts"] = GEMMA3_RUN["cuts"]
        engine = DecodeEngine(cfg, device=dev, **kw)
        _free(torch)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        report, secs = serve(engine, params, reqs, sp, get_scenario(scenario))
        counts = ops.launch_counts()
        admissions = int(report.log.summary()["admitted"])
        want = {k: 0 for k in counts}
        if kw["impl"] == "kernel":
            want.update(_gemma3_launches(cfg, engine)(admissions))
        if counts != want:
            raise AssertionError(f"serve gemma3 {name}: launches {counts}, "
                                 f"expected {want} (steps {engine.steps})")
        bodies = _check_bodies(ops, f"serve gemma3 {name}")
        # the flash launches the local layers made, counted by the wrapper
        windowed = ops.body_launches()["flash_attention_window"]
        if windowed != (n_local * admissions if kw["impl"] == "kernel"
                        else 0):
            raise AssertionError(f"serve gemma3 {name}: {windowed} windowed "
                                 f"flash launches, {admissions} admissions "
                                 f"of {n_local} local layers")
        served, shed = set(report.outputs), set(report.rejected)
        by_rid = {r.rid: r for r in reqs}
        if (report.unfinished or served & shed
                or served | shed != set(by_rid)):
            raise AssertionError(f"serve gemma3 {name}: unfinished "
                                 f"{report.unfinished}, served {sorted(served)}"
                                 f", shed {sorted(shed)}")
        if any(not math.isfinite(by_rid[rid].deadline) for rid in shed):
            raise AssertionError(f"serve gemma3 {name}: shed a request "
                                 f"without a deadline")
        if any(len(report.outputs[rid]) != by_rid[rid].max_new
               for rid in served):
            raise AssertionError(f"serve gemma3 {name}: short outputs")
        if scenario in ("replica-drop", "degraded-fleet") and not \
                report.reroutes:
            raise AssertionError(f"serve gemma3 {name}: nothing re-routed")
        if name == "flash-crowd" and report.peak_replicas <= base.replicas:
            raise AssertionError(f"serve gemma3 {name}: the fleet never grew "
                                 f"({report.peak_replicas} replicas)")
        if sp.speculate and not report.spec_rounds:
            raise AssertionError(f"serve gemma3 {name}: no speculative round")
        reports[name] = report
        pct = report.percentiles
        rec = {"scenario": scenario, "seconds": secs,
               "tokens": report.tokens_out,
               "tokens_per_s": report.tokens_out / secs,
               "sim_p50": pct["p50"], "sim_p99": pct["p99"],
               "slo": report.slo, "reroutes": report.reroutes,
               "rejected": len(report.rejected), "served": len(served),
               "admissions": admissions,
               "peak_replicas": report.peak_replicas,
               "acceptance": report.acceptance, "drafted": report.drafted,
               "spec_rounds": report.spec_rounds, "steps": dict(engine.steps),
               "launches": counts, "bodies": bodies,
               "flash_windowed": windowed,
               "hops": report.log.num_hops,
               "peak_bytes": (torch.cuda.max_memory_allocated()
                              if dev.type == "cuda" else 0),
               "pool_blocks": sp.pool_blocks}
        t0 = time.perf_counter()
        if name in GEMMA3_EXACT or name == "plain":
            ref_out = reports["clean"].outputs
            both = sorted(served & set(ref_out))
            if name == "plain":
                rec["diverged"] = diverged = []
                for rid in both:
                    for t, (a, b) in enumerate(zip(ref_out[rid],
                                                   report.outputs[rid])):
                        if a == b:
                            continue
                        margin = _plain_margin(torch, tf, params, cfg,
                                               by_rid[rid].prompt,
                                               report.outputs[rid], t, dev)
                        if margin > ARGMAX_MARGIN:
                            raise AssertionError(
                                f"serve gemma3 plain: request {rid} token {t} "
                                f"differs ({a} vs {b}) at top-2 margin "
                                f"{margin:.3f} > {ARGMAX_MARGIN}")
                        diverged.append({"rid": rid, "token": t,
                                         "margin": margin})
                        break
            else:
                bad = [rid for rid in both
                       if report.outputs[rid] != ref_out[rid]]
                if bad:
                    raise AssertionError(f"serve gemma3 {name}: requests {bad} "
                                         f"differ from the clean run's tokens")
            rec["compared_requests"] = len(both)
        rec["compare_s"] = time.perf_counter() - t0
        out["runs"][name] = rec
        print(f"serve gemma3 {name}: {scenario}, {rec['tokens']} tokens in "
              f"{secs:.2f} s ({rec['tokens_per_s']:.1f} tok/s); sim p50 "
              f"{pct['p50']:.1f} p99 {pct['p99']:.1f}; SLO attainment "
              f"{report.slo.get('attainment', 1.0):.3f}; served "
              f"{len(served)}, rejected {len(shed)}, reroutes "
              f"{report.reroutes}, peak replicas {report.peak_replicas}, "
              f"acceptance {report.acceptance:.3f} ({report.accepted}/"
              f"{report.drafted}); steps {engine.steps}; launches "
              f"{ {k: v for k, v in counts.items() if v} } (flash with a "
              f"window {windowed}); peak memory "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB"
              + (f"; {rec['compared_requests']} requests compared with the "
                 f"clean run" if "compared_requests" in rec else "")
              + (f", {len(rec['diverged'])} diverged at margin <= "
                 f"{ARGMAX_MARGIN}" if "diverged" in rec else ""), flush=True)
        del engine, report
    # the clean run's measured launches, flash split by window, for the
    # kernels line
    clean = out["runs"]["clean"]
    out["clean_launches"] = {
        "flash_local": clean["flash_windowed"],
        "flash_global": (clean["launches"]["flash_attention"]
                         - clean["flash_windowed"]),
        "paged": clean["launches"]["paged_decode_attention"]}
    if dev.type == "cuda":
        t0 = time.perf_counter()
        out.update(_profile_paged_serving(torch, cfg, params, reqs, base,
                                          dev, "serve gemma3"))
        out["profile_s"] = time.perf_counter() - t0
    print(f"serve gemma3: setup {out['setup_s']:.1f} s, kernel checks "
          f"{out.get('kernel_checks_s', 0.0):.1f} s, runs "
          f"{sum(r['seconds'] for r in out['runs'].values()):.1f} s, "
          f"comparisons {sum(r['compare_s'] for r in out['runs'].values()):.1f}"
          f" s, profile {out.get('profile_s', 0.0):.1f} s", flush=True)
    del params
    _free(torch)
    return out


# ---------------------------------------------------------------------------
# The bounded-staleness async round (phase 20)
# ---------------------------------------------------------------------------

# module values, so a CPU rehearsal can shrink them.  20a: phase 16's
# Mamba-2-370M at full width and 8 clients (FAULT_RUN), its depth cut to 16
# of 48 layers to make room for phase 23 and to 8 at cut 4 for phase 25
# (every check as at full depth),
# participation 1.0, under async-stragglers (clients 4-7 at 8x); the buffer
# adds 8 client stages in fp32, ~3.5 GB (reckoned: the 51.5 M embedding
# and 8 layers).  20b: phase
# 17's 3-layer cut; 20c: phase 18's gait FFN at 10 clients.
ASYNC_RUN = dict(layers=8, cut=4, inf_rounds=2, park_rounds=3, int8_rounds=2,
                 chunk=4,
                 chunk_rounds=1, parity_rounds=3, parity_byz_rounds=4,
                 paper_clients=10, paper_rounds=6, paper_steps=10)
# 20b: (scenario, deadline, rule, compression at delivery)
ASYNC_PARITY = (("async-stragglers", 4.0, "importance", "none"),
                ("async-byzantine", 2.0, "krum", "none"),
                ("async-stragglers", 4.0, "importance", "int8"),
                ("async-stragglers", 4.0, "importance", "topk"))


def _async_setup(layers, cuts, participation, rule="importance",
                 scheme="none", chunk=None, **acfg):
    """Phase 16's configs with an async block, a compression scheme and a
    client chunk."""
    import dataclasses
    from repro_torch.config import AsyncRoundsConfig, CompressionConfig
    cfg, wssl_cfg, train_cfg = _fault_setup(layers, cuts, participation, rule)
    wssl_cfg = dataclasses.replace(
        wssl_cfg, async_rounds=AsyncRoundsConfig(**acfg),
        compression=CompressionConfig(scheme=scheme))
    return cfg, wssl_cfg, dataclasses.replace(train_cfg, client_chunk=chunk)


def _latencies(sc, n):
    """The fault plan's latencies of ``sc``'s stragglers, as the round
    computes them in fp32: 1 / (1 / slowdown)."""
    import numpy as np
    f = np.float32
    slow = f(1.0) / max(f(sc.straggler_slowdown), f(1.0))
    strag = set(sc.straggler_ids(n))
    return np.asarray([f(1.0) / slow if i in strag else f(1.0)
                       for i in range(n)], f)


def _replay_async(lat, acfg, n, rounds):
    """The async round's admission rule on the host, in fp32 as the round
    computes it, for rounds in which every idle client is drawn (the
    participation is 1.0 and the preset drops nobody): per round the
    on-time, parked, arrived and evicted counts, the fresh-work mask and
    the counters after it."""
    import numpy as np
    f = np.float32
    cap = n if acfg.buffer_size is None else acfg.buffer_size
    delay = np.maximum(np.ceil(lat / f(acfg.deadline)) - f(1.0), f(0.0))
    pending, stale = np.zeros(n, int), np.zeros(n, int)
    out = []
    for _ in range(rounds):
        mask = (pending == 0).astype(f)
        on_time, late = mask * (delay == 0), mask * (delay > 0)
        evict = late * (delay >= f(acfg.max_staleness))
        admit = late - evict
        order = np.cumsum(admit) - admit
        over = admit * ((f((pending > 1).sum()) + order) >= f(cap))
        admit = admit - over
        out.append({"on_time": float(on_time.sum()),
                    "buffered": float(admit.sum()),
                    "arrived": float((pending == 1).sum()),
                    "evicted": float((evict + over).sum()),
                    "mask": (on_time + admit).tolist()})
        d = delay.astype(int)
        pending, stale = (np.where(admit > 0, d, np.maximum(pending - 1, 0)),
                          np.where(admit > 0, d,
                                   np.where(pending > 1, stale, 0)))
        out[-1].update(pending=pending.tolist(), staleness=stale.tolist())
    return out


ASYNC_FIELDS = ("on_time", "buffered", "arrived", "evicted", "mask",
                "pending", "staleness")


def _drive_async_rounds(torch, cfg, wssl_cfg, train_cfg, scenario, rounds, *,
                        sync=False, gumbels=None, before_round=None,
                        seq=None):
    """``init_state`` from the seed, then ``make_async_round_fn``'s round
    (``make_round_fn``'s with ``sync``) under ``scenario`` on per-client
    streams.  Returns the state, the async state (None with ``sync``) and
    one record per round: every metric as host numbers, the counters after
    the round and the global model's validation loss."""
    from repro_torch.core.async_round import (init_async_state,
                                              make_async_round_fn)
    from repro_torch.core.round import init_state, make_round_fn
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.sim import scenario_params
    dev = torch.device(FAULT_RUN["device"])
    n, b, s = (wssl_cfg.num_clients, FAULT_RUN["batch"],
               seq or FAULT_RUN["seq"])
    sp = None if scenario is None else scenario_params(scenario)
    gen = torch.Generator(device=dev).manual_seed(FAULT_RUN["seed"])
    state = init_state(gen, cfg, wssl_cfg, train_cfg, device=dev)
    astate = None if sync else init_async_state(state)
    round_fn = (make_round_fn if sync else make_async_round_fn)(
        cfg, wssl_cfg, train_cfg, impl="dense")
    val = {k: torch.as_tensor(v, device=dev) for k, v in lm_batch(
        FAULT_RUN["val_batch"], s, cfg.vocab_size, seed=10_000).items()}
    host = lambda v: (v.cpu().tolist() if torch.is_tensor(v) and v.dim()
                      else float(v))
    recs = []
    for r in range(rounds):
        batch = _client_streams(torch, cfg, n, b, s, r, dev)
        if before_round is not None:
            before_round(state, r)
        gumbel = None if gumbels is None else gumbels[r]
        _sync(torch, dev)
        t0 = time.perf_counter()
        if sync:
            state, m = round_fn(state, batch, val, sp, gumbel=gumbel)
            extra = {}
        else:
            state, astate, am = round_fn(state, astate, batch, val, sp,
                                         gumbel=gumbel)
            m = am.base
            extra = {f: float(getattr(am, f)) for f in am._fields
                     if f != "base"}
            extra.update(pending=astate.pending.cpu().tolist(),
                         staleness=astate.staleness.cpu().tolist())
        _sync(torch, dev)
        dt = time.perf_counter() - t0
        rec = {"round": r, "dt_s": dt,
               **{f: host(getattr(m, f)) for f in m._fields}, **extra,
               "global_val_loss": _global_val_loss(torch, state, cfg, val)}
        recs.append(rec)
    return state, astate, recs


def _state_tensors(st, ast=None):
    tensors = _leaves((st.client_stack, st.server_params, st.edge_stages,
                       st.opt_client.m, st.opt_client.v, st.opt_server.m,
                       st.opt_server.v, [o.m for o in st.opt_edge],
                       [o.v for o in st.opt_edge], st.importance,
                       st.ef_residual))
    if ast is not None:
        tensors += _leaves((ast.pending, ast.staleness, ast.buffer))
    return tensors


def _check_async_recs(where, recs, replay, stage_bytes):
    """Counts, masks and counters equal to the host replay, the resync in
    bytes_sync at fp32, finite losses."""
    import numpy as np
    for r, (rec, want) in enumerate(zip(recs, replay)):
        got = {f: rec[f] for f in ASYNC_FIELDS}
        if got != {f: want[f] for f in ASYNC_FIELDS}:
            raise AssertionError(f"{where}: round {r} admission {got} is "
                                 f"not the host replay {want}")
        resync = float(np.float32(rec["evicted"]) * np.float32(stage_bytes))
        if rec["bytes_resync"] != resync:
            raise AssertionError(f"{where}: round {r} bytes_resync "
                                 f"{rec['bytes_resync']} != {resync}")
        if not (math.isfinite(rec["loss"])
                and all(map(math.isfinite, rec["val_loss"]))):
            raise AssertionError(f"{where}: round {r} non-finite loss")


def _check_frozen(where, recs, sums):
    """A client without fresh work in a round (busy, evicted, masked) keeps
    its AdamW moment rows bit for bit."""
    for r, rec in enumerate(recs):
        for i, part in enumerate(rec["mask"]):
            if part == 0.0 and not sums[r][i].equal(sums[r + 1][i]):
                raise AssertionError(f"{where}: round {r} client {i} had no "
                                     f"fresh work and its moments moved")


def _profile_async_round(torch, state, astate, cfg, wssl_cfg, train_cfg, sc,
                         r):
    from repro_torch.core.async_round import make_async_round_fn
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.sim import scenario_params
    dev = state.importance.device
    batch = _client_streams(torch, cfg, wssl_cfg.num_clients,
                            FAULT_RUN["batch"], FAULT_RUN["seq"], r, dev)
    val = {k: torch.as_tensor(v, device=dev) for k, v in lm_batch(
        FAULT_RUN["val_batch"], FAULT_RUN["seq"], cfg.vocab_size,
        seed=10_000).items()}
    round_fn = make_async_round_fn(cfg, wssl_cfg, train_cfg, impl="dense")
    return _device_profile(torch, lambda: round_fn(
        state, astate, batch, val, scenario_params(sc)), cpu=False)


def run_async_train(torch, ops):
    """Phase 20a: Mamba-2-370M (full width, 8 layers, cut 4) at 8 clients
    through the async round under async-stragglers: deadline inf against
    the sync round bit for bit; deadline 4 (the stragglers park, land at staleness 1, park
    again); deadline 1 (evicted and resynced); deadline 2 with two buffer
    slots (overflow); deadline 4 with int8 uploads; a chunked round."""
    import numpy as np
    from repro_torch import compress
    from repro_torch.core import fairness
    from repro_torch.core.round import client_stage_bytes
    from repro_torch.sim import get_scenario
    dev = torch.device(FAULT_RUN["device"])
    sc = get_scenario("async-stragglers")
    n = FAULT_RUN["clients"]
    strag = sc.straggler_ids(n)
    lat = _latencies(sc, n)
    cut = (ASYNC_RUN["cut"],)
    out = {}

    # run 1: deadline inf against the sync round, both states live
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sides = {}
    for side in ("sync", "async"):
        cfg, wssl_cfg, train_cfg = _async_setup(ASYNC_RUN["layers"], cut, 1.0)
        ops.reset_launch_counts()
        st, ast, recs = _drive_async_rounds(
            torch, cfg, wssl_cfg, train_cfg, sc, ASYNC_RUN["inf_rounds"],
            sync=side == "sync")
        counts = ops.launch_counts()
        if counts["fused_adamw"] != _fault_launches(st, recs):
            raise AssertionError(f"async train inf {side}: launches {counts}")
        sides[side] = (st, ast, recs)
    (a, _, ra), (b, bst, rb) = sides["sync"], sides["async"]
    bits = sum(_bit_diffs(torch, x, y) for x, y in zip(_state_tensors(a),
                                                       _state_tensors(b)))
    metric_keys = [k for k in ra[0] if k not in ("dt_s",)]
    differ = sorted({k for x, y in zip(ra, rb) for k in metric_keys
                     if x[k] != y[k]})
    if any(rec["buffered"] or rec["arrived"] or rec["evicted"] for rec in rb):
        raise AssertionError(f"async train inf: the buffer moved {rb}")
    out["inf"] = {"rounds": ASYNC_RUN["inf_rounds"],
                  "state_elements": sum(t.numel() for t in _state_tensors(a)),
                  "state_elements_differing": bits,
                  "metrics_differing": differ,
                  "wall_s": time.perf_counter() - t0,
                  "peak_bytes": (torch.cuda.max_memory_allocated()
                                 if dev.type == "cuda" else 0),
                  "sync_round_s": [r["dt_s"] for r in ra],
                  "async_round_s": [r["dt_s"] for r in rb],
                  "sync_global_val_loss": [r["global_val_loss"] for r in ra],
                  "sync_importance_gap": fairness.importance_gap(
                      ra[-1]["importance"], strag)}
    print(f"async train: {cfg.name} {cfg.num_layers} layers, {n} clients, "
          f"cut {FAULT_RUN['cut']}, {sc.name}: deadline inf vs the sync "
          f"round, {ASYNC_RUN['inf_rounds']} rounds: {bits} of "
          f"{out['inf']['state_elements']} state elements differ, metrics "
          f"differing {differ} (bit-exact required); sync rounds "
          f"{', '.join(f'{t:.3f}' for t in out['inf']['sync_round_s'])} s, "
          f"async {', '.join(f'{t:.3f}' for t in out['inf']['async_round_s'])}"
          f" s; peak memory {out['inf']['peak_bytes'] / 2**30:.2f} GiB (both "
          f"states live)", flush=True)
    if bits or differ:
        raise AssertionError(f"async train: deadline inf differs from the "
                             f"sync round: {out['inf']}")
    sync_recs = ra
    del sides, a, b, bst, st, ast
    _free(torch)

    # runs 2-6
    runs = (("park", dict(deadline=4.0), "none", None,
             ASYNC_RUN["park_rounds"]),
            ("evict", dict(deadline=1.0), "none", None, 1),
            ("overflow", dict(deadline=2.0, buffer_size=2), "none", None, 1),
            ("int8", dict(deadline=4.0), "int8", None,
             ASYNC_RUN["int8_rounds"]),
            ("chunked", dict(deadline=4.0), "none", ASYNC_RUN["chunk"],
             ASYNC_RUN["chunk_rounds"]))
    for name, acfg_kw, scheme, chunk, rounds in runs:
        cfg, wssl_cfg, train_cfg = _async_setup(ASYNC_RUN["layers"], cut, 1.0,
                                                scheme=scheme, chunk=chunk,
                                                **acfg_kw)
        _free(torch)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sums = []
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        st, ast, recs = _drive_async_rounds(
            torch, cfg, wssl_cfg, train_cfg, sc, rounds,
            before_round=lambda s, r: sums.append(_moment_sums(torch, s)))
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else 0)
        sums.append(_moment_sums(torch, st))
        where = f"async train {name}"
        stage = client_stage_bytes(st)
        _check_async_recs(where, recs, _replay_async(
            lat, wssl_cfg.async_rounds, n, rounds), stage)
        _check_frozen(where, recs, sums)
        leaves = sum(1 for l in compress.tree_leaves(st.client_stack)
                     if l[0].numel())
        want = {"fused_adamw": _fault_launches(st, recs)}
        if scheme == "int8":
            want.update(quantize_stochastic=rounds * leaves,
                        dequantize=rounds * leaves)
        if _nonzero(counts) != want:
            raise AssertionError(f"{where}: launches {counts}, expected "
                                 f"{want}")
        prof = None
        if name == "park" and dev.type == "cuda":
            # one more round (the stragglers land) under the profiler; its
            # launches are not counted
            t1 = time.perf_counter()
            prof = _profile_async_round(torch, st, ast, cfg, wssl_cfg,
                                        train_cfg, sc, rounds)
            prof["profile_s"] = time.perf_counter() - t1
            print(f"async train {name}: one profiled round (4 fresh, 4 "
                  f"arriving; CUDA activity only): " + _profile_line(prof)
                  + f"; {prof['profile_s']:.1f} s with the profiler's "
                  f"processing", flush=True)
        gap = fairness.importance_gap(recs[-1]["importance"], strag)
        rec = {"profile": prof,
               "async": acfg_kw, "compression": scheme, "client_chunk": chunk,
               "rounds": recs, "round_s": [r["dt_s"] for r in recs],
               "wall_s": wall, "peak_bytes": peak, "launches": counts,
               "stage_bytes": stage, "importance_gap": gap,
               "buffer_bytes": sum(t.numel() * t.element_size()
                                   for t in _leaves(ast.buffer))}
        counts_line = [(r["on_time"], r["buffered"], r["arrived"],
                        r["evicted"]) for r in recs]
        print(f"async train {name}: {acfg_kw}, {scheme}, chunk {chunk}: "
              f"(on time, parked, arrived, evicted) by round {counts_line} "
              f"= the host replay; rounds "
              f"{', '.join(f'{t:.3f}' for t in rec['round_s'])} s; losses "
              f"{[round(r['loss'], 4) for r in recs]}; stragglers {strag} "
              f"importance {gap['corrupt_mean']:.4f} against the others' "
              f"{gap['clean_mean']:.4f}; global validation loss by round "
              f"{[round(r['global_val_loss'], 4) for r in recs]}; resync "
              f"{[r['bytes_resync'] for r in recs]} B; launches "
              f"{_nonzero(counts)}; peak memory {peak / 2**30:.2f} GiB",
              flush=True)
        out[name] = rec
        del st, ast
        _free(torch)
    park, k = out["park"]["rounds"], ASYNC_RUN["inf_rounds"] - 1
    out["global_val_loss_vs_sync"] = {
        "round": k, "async_deadline_4": park[k]["global_val_loss"],
        "sync": sync_recs[k]["global_val_loss"]}
    print(f"async train: global validation loss after {k + 1} rounds under "
          f"{sc.name}: deadline 4 {park[k]['global_val_loss']:.4f}, sync "
          f"{sync_recs[k]['global_val_loss']:.4f} (a reading)", flush=True)
    return out


def run_async_parity(torch, ops):
    """Phase 20b: the async round at full width and 3 layers, cuts (1, 2),
    8 clients, participation 0.5, through the AdamW and compression
    kernels and through their plain versions, the same seed and Gumbel
    draws: masks, losses, stages, moments, residuals, the buffer and the
    counters bit-exact."""
    import contextlib
    from unittest import mock
    import numpy as np
    from repro_torch import compress
    from repro_torch.kernels import ref
    from repro_torch.sim import get_scenario
    dev = torch.device(FAULT_RUN["device"])
    rng = np.random.default_rng(29)
    rounds_max = max(ASYNC_RUN["parity_rounds"],
                     ASYNC_RUN["parity_byz_rounds"])
    gumbels = [torch.as_tensor(rng.gumbel(size=FAULT_RUN["clients"]).astype(
        np.float32)) for _ in range(rounds_max)]
    plain = {"none": {}, "int8": dict(
        quantize_stochastic=ref.quantize_stochastic_2d,
        dequantize=ref.dequantize_2d),
        "topk": dict(topk_mask=ref.topk_mask_2d)}
    out = []
    for name, deadline, rule, scheme in ASYNC_PARITY:
        rounds = (ASYNC_RUN["parity_byz_rounds"] if name == "async-byzantine"
                  else ASYNC_RUN["parity_rounds"])
        t0 = time.perf_counter()
        sides = {}
        for side in ("kernel", "plain"):
            cfg, wssl_cfg, train_cfg = _async_setup(
                FAULT_RUN["parity_layers"], FAULT_RUN["parity_cuts"],
                FAULT_RUN["parity_participation"], rule, scheme=scheme,
                deadline=deadline)
            patch = (contextlib.nullcontext() if side == "kernel" else
                     mock.patch.multiple(ops,
                                         fused_adamw=ops.fused_adamw_plain,
                                         **plain[scheme]))
            sums = []
            ops.reset_launch_counts()
            with patch:
                st, ast, recs = _drive_async_rounds(
                    torch, cfg, wssl_cfg, train_cfg, get_scenario(name),
                    rounds, gumbels=gumbels, seq=FAULT_RUN["parity_seq"],
                    before_round=lambda s, r: sums.append(
                        _moment_sums(torch, s)))
            sums.append(_moment_sums(torch, st))
            counts = ops.launch_counts()
            leaves = sum(1 for l in compress.tree_leaves(st.client_stack)
                         if l[0].numel())
            want = {}
            if side == "kernel":
                want = {"fused_adamw": _fault_launches(st, recs),
                        **{k: rounds * leaves
                           for k in PAPER_COMP_KERNELS[scheme]}}
            if _nonzero(counts) != want:
                raise AssertionError(f"async parity {name} {scheme} {side}: "
                                     f"launches {counts}, expected {want}")
            _check_frozen(f"async parity {name} {side}", recs, sums)
            sides[side] = (st, ast, recs, counts)
        (sk, ak, rk, ck), (sp, ap, rp, _) = sides["kernel"], sides["plain"]
        keys = [k for k in rk[0] if k not in ("dt_s",)]
        differ = sorted({k for a, b in zip(rk, rp) for k in keys
                         if a[k] != b[k]})
        bits = sum(_bit_diffs(torch, a, b) for a, b in zip(
            _state_tensors(sk, ak), _state_tensors(sp, ap)))
        rec = {"scenario": name, "deadline": deadline, "rule": rule,
               "compression": scheme, "rounds": rounds,
               "counts": [(r["on_time"], r["buffered"], r["arrived"],
                           r["evicted"]) for r in rk],
               "masks": [r["mask"] for r in rk],
               "losses": [r["loss"] for r in rk],
               "fields_differing": differ, "state_elements_differing": bits,
               "state_elements": sum(t.numel() for t in _state_tensors(
                   sk, ak)), "launches": ck,
               "seconds": time.perf_counter() - t0}
        print(f"async parity: {name} at deadline {deadline} under {rule}, "
              f"{scheme}, {cfg.num_layers} layers, cuts "
              f"{FAULT_RUN['parity_cuts']}, {rounds} rounds: (on time, "
              f"parked, arrived, evicted) {rec['counts']}, losses "
              f"{[round(v, 5) for v in rec['losses']]}; kernel launches "
              f"{_nonzero(ck)}; fields differing "
              f"{differ}, {bits} of {rec['state_elements']} state elements "
              f"differ (bit-exact required); {rec['seconds']:.1f} s",
              flush=True)
        if differ or bits:
            raise AssertionError(f"async parity {name} {scheme}: kernel and "
                                 f"plain runs differ: {rec}")
        out.append(rec)
        del sides, sk, sp, ak, ap, st, ast
        _free(torch)
    return out


def _replay_paper_async(sc, nc, acfg, rounds):
    """The paper loop's admission on the host (participation 1.0, no
    dropout): per round the selected, parked, arrived and evicted
    clients."""
    import numpy as np
    strag = set(sc.straggler_ids(nc))
    latency = np.asarray([sc.straggler_slowdown if i in strag else 1.0
                          for i in range(nc)], np.float64)
    delay = np.maximum(np.ceil(latency / acfg.deadline) - 1, 0).astype(int)
    cap = nc if acfg.buffer_size is None else acfg.buffer_size
    parked, out = {}, []
    for _ in range(rounds):
        sel = [i for i in range(nc) if i not in parked]
        arrivals = sorted(i for i, p in parked.items() if p == 1)
        free, evicted, late = cap - (len(parked) - len(arrivals)), [], []
        for i in sel:
            if delay[i] > 0 and (delay[i] >= acfg.max_staleness or free <= 0):
                evicted.append(i)
            elif delay[i] > 0:
                free -= 1
                late.append(i)
        out.append({"selected": [i for i in sel if i not in evicted],
                    "buffered": late, "arrived": arrivals,
                    "evicted": len(evicted)})
        parked = {i: p - 1 for i, p in parked.items() if p > 1}
        parked.update({i: int(delay[i]) for i in late})
    return out


def run_async_paper(torch, ops):
    """Phase 20c: the paper loop with a finite deadline — the gait FFN at
    10 clients under async-stragglers (clients 5-9 at 8x), 6 rounds x 10
    steps, participation 1.0, at deadline 4 and 1 and synchronously."""
    from repro_torch.config import AsyncRoundsConfig, WSSLConfig
    from repro_torch.core import paper_loop as pl
    from repro_torch.sim import get_scenario
    dev = torch.device(PAPER_RUN["device"])
    ad, cfg, val, test, loaders, _ = _paper_experiment("gait")
    n_client, n_server = _paper_leaves(torch, ad)
    nc, rounds, steps = (ASYNC_RUN["paper_clients"], ASYNC_RUN["paper_rounds"],
                         ASYNC_RUN["paper_steps"])
    sc = get_scenario("async-stragglers")
    det = lambda: torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=True, allow_tf32=False)
    out = {}
    for deadline in (4.0, 1.0, float("inf")):
        acfg = AsyncRoundsConfig(deadline=deadline)
        _free(torch)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with det():
            h = pl.train_wssl(ad, loaders(nc), val, test, WSSLConfig(
                num_clients=nc, participation_fraction=1.0,
                async_rounds=acfg), rounds=rounds, local_steps=steps,
                lr=PAPER_RUN["gait"]["lr"], seed=0, scenario=sc, device=dev)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        where = f"async paper deadline {deadline}"
        if acfg.enabled:
            taken = steps * sum(len(s) for s in h["selected"])
            replay = _replay_paper_async(sc, nc, acfg, rounds)
            got = [{k: h[k][r] for k in ("selected", "buffered", "arrived",
                                         "evicted")} for r in range(rounds)]
            if got != replay:
                raise AssertionError(f"{where}: history {got} is not the host "
                                     f"replay {replay}")
        else:
            taken = _steps_taken(h, sc, nc, steps)
        want = {"fused_adamw": (n_client + n_server) * taken}
        if _nonzero(counts) != want:
            raise AssertionError(f"{where}: launches {counts}, expected "
                                 f"{want}")
        losses = h["test_loss"] + h["train_loss"] + [
            v for vs in h["val_loss"] for v in vs]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{where}: non-finite loss")
        h.pop("params")
        key = "sync" if not acfg.enabled else f"deadline-{deadline:g}"
        out[key] = _paper_summary(h, len(test["y"])) | {
            k: h[k] for k in ("buffered", "arrived", "evicted",
                              "mean_staleness")} | {
            "steps_taken": taken, "launches": counts, "wall_s": wall}
        print(f"async paper: gait {nc} clients, {sc.name}, deadline "
              f"{deadline}: parked {[len(b) for b in h['buffered']]}, "
              f"arrived {[len(a) for a in h['arrived']]}, evicted "
              f"{h['evicted']} by round"
              f"{' (the host replay)' if acfg.enabled else ''}; {taken} steps, "
              f"launches {_nonzero(counts)}; test accuracy by round "
              f"{[round(a, 4) for a in h['test_acc']]}; {wall:.1f} s",
              flush=True)
    return out


def run_async(torch, ops):
    """Phase 20: 20a, 20b and 20c, each timed."""
    out = {}
    for key, label, fn in (("train", "20a", run_async_train),
                           ("parity", "20b", run_async_parity),
                           ("paper", "20c", run_async_paper)):
        t0 = time.perf_counter()
        out[key] = fn(torch, ops)
        out[f"{key}_s"] = time.perf_counter() - t0
        print(f"{label}. async {key}: {out[f'{key}_s']:.1f} s", flush=True)
        _free(torch)
    return out


# ---------------------------------------------------------------------------
# StableLM-2-12B and Qwen2.5-32B: LayerNorm, biases, head_dim 160 (phase 21)
# ---------------------------------------------------------------------------

# module values, so a CPU rehearsal can shrink them.  Both models at full
# size in bf16, random weights from seed 0 (StableLM-2-12B 40 layers, 32
# query heads over 8 at hd 160, LayerNorm: 24.3 GB reckoned; Qwen2.5-32B
# 64 layers, 40 over 8 at hd 128, qkv biases: 65.5 GB, ~14 GB left for KV
# and transients).  JAX initialises every bias to zero and LayerNorm's
# scale to one, so the serving runs first move them (``bias_std``,
# ``norm_std``: seeded normal draws), or the biased path would compute
# what the unbiased one does.  Prompt and generation lengths are drawn
# uniformly from the given ranges.
DENSE_RUN = dict(device="cuda", reduced=False, seed=0, chunk=8,
                 block_size=16, bias_std=0.5, norm_std=0.2)
DENSE_SERVE = {
    "stablelm-12b": dict(requests=8, prompts=(256, 1024), gen=(16, 32),
                         replicas=2, slots=8, flash_s=1536),
    "qwen2.5-32b": dict(layers=32, requests=4, prompts=(512, 1024),
                        gen=(16, 32),
                        replicas=1, slots=8, flash_s=1024),
}
# 21d: StableLM-2-12B at full width, depth cut to 4 layers, cut 2, 2
# clients, fp32 params: 2 client stages (embedding + 2 layers) and the
# server (2 layers + head) hold 3,208,775,680 elements, 51.3 GB of p, m,
# v and g (reckoned; peak 50.77 GiB on an H100 80GB HBM3), through the
# AdamW kernel and then its plain version
DENSE_TRAIN = dict(arch="stablelm-12b", layers=4, clients=2, cuts=(2,),
                   seq=128, batch=2, rounds=2, val_batch=2, seed=0,
                   gumbel_seed=21)


def _serve_cfg(arch, cut_to=None, small=False):
    """``arch`` in bf16, its depth cut to ``cut_to`` layers, or
    ``reduced()`` when ``small`` (a CPU rehearsal)."""
    from repro_torch.config import get_arch, reduced
    cfg = get_arch(arch)
    if small:
        cfg = reduced(cfg)
    elif cut_to:
        cfg = cfg.replace(num_layers=cut_to)
    return cfg.replace(dtype="bfloat16")


def _dense_params(torch, cfg, dev):
    """Random params from the seed, then LayerNorm's scale and bias and
    the qkv biases moved off their init by seeded normal draws."""
    from repro_torch.models import transformer as tf
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(
        DENSE_RUN["seed"]), device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)

    def add(t, std):
        t.add_(torch.randn(t.shape, generator=gen, device=dev).mul_(std)
               .to(t.dtype))

    norms = [params["final_norm"]]
    for layer in params["stack"] + params["rem"]:
        norms += [layer["norm1"], layer["norm2"]]
        if cfg.qkv_bias:
            for k in ("bq", "bk", "bv"):
                add(layer["mixer"][k], DENSE_RUN["bias_std"])
    if cfg.norm == "layernorm":
        for p in norms:
            add(p["scale"], DENSE_RUN["norm_std"])
            add(p["bias"], DENSE_RUN["norm_std"])
    return params


def _dense_requests(cfg, run):
    import numpy as np
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.serve import Request
    rng = np.random.default_rng(DENSE_RUN["seed"] + 21)
    reqs = []
    for rid in range(run["requests"]):
        n = int(rng.integers(run["prompts"][0], run["prompts"][1] + 1))
        g = int(rng.integers(run["gen"][0], run["gen"][1] + 1))
        reqs.append(Request(rid=rid, prompt=make_token_stream(
            1, n, cfg.vocab_size, seed=2100 + rid)[0], max_new=g))
    return reqs


def _dense_kernel_checks(torch, ops, ref, cfg, run):
    """Flash and paged decode at the model's serving shapes: an admission
    of ``flash_s`` tokens (bf16 on the tensor-core body, graph-timed beside
    SDPA and profiled), a ragged one (the last 64-row tile partial) in
    bf16 and fp32 (the SIMT body), and a decode step of 8 rows over 100
    blocks of 16 in bf16 (profiled) and fp32."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = run["flash_s"]
    flash = check_flash(torch, ops, ref, b=1, hq=hq, hkv=hkv, s=s, hd=hd,
                        dtype="bfloat16", seed=210, profile=True)
    paged = check_paged(torch, ops, ref, b=8, hq=hq, hkv=hkv, hd=hd, bs=16,
                        nb=100, dtype="bfloat16", pos_lo=512, seed=211,
                        dead_row=False, profile=True)
    extra = [check_flash(torch, ops, ref, b=1, hq=hq, hkv=hkv, s=s - 5,
                         hd=hd, dtype=dtype, seed=212)
             for dtype in ("bfloat16", "float32")]
    extra.append(check_paged(torch, ops, ref, b=8, hq=hq, hkv=hkv, hd=hd,
                             bs=16, nb=100, dtype="float32", seed=213))
    for rec in (flash, paged, *extra):
        _check_band(rec)
    return {"flash": flash, "paged": paged}, extra


def _serve_kernel_checks(torch, ops, table, small):
    """:func:`_dense_kernel_checks` at each served model's shapes."""
    from repro_torch.kernels import ref
    out = {}
    for arch, run in table.items():
        cfg = _serve_cfg(arch, run.get("layers"), small)
        out[arch], out[f"{arch}_extra"] = _dense_kernel_checks(
            torch, ops, ref, cfg, run)
    return out


def run_dense_kernels(torch, ops):
    """21a: flash and paged decode at both models' shapes against their
    plain versions: StableLM-2-12B's head dim 160 at g 4, Qwen2.5-32B's g
    5 (a 64-row tile of 12 positions and 4 padding rows)."""
    return _serve_kernel_checks(torch, ops, DENSE_SERVE, DENSE_RUN["reduced"])


def _serve_vs_plain(torch, ops, label, arch, cfg, params, reqs, run, dev,
                    chunk, block, decode_window_override=None):
    """One model at full width through the router and engine (flash
    prefill, paged decode), then the plain path (dense prefill, gathered
    decode) on the same weights and requests through the same schedule,
    teacher-forced on the kernel path's tokens (:func:`_taped_engine`):
    exact launch counts, all on the tensor-core / split-K bodies, every
    request served in full, and every served token equal to the plain
    path's argmax wherever the plain path's top-2 margin exceeds
    ARGMAX_MARGIN; tok/s, peak memory and a sampled profile (busy share)
    printed.  An MoE model's plain run also replays the kernel run's
    expert choices (:class:`_Routing`).  ``decode_window_override`` serves
    both runs within that window (no layer pages: no paged launch)."""
    from repro_torch.launch.serve import serve, serve_max_len
    from repro_torch.serve import ServeParams
    t0 = time.perf_counter()
    sp = ServeParams(replicas=run["replicas"], slots=run["slots"],
                     chunk=chunk, block_size=block,
                     max_len=serve_max_len(run["prompts"][1], run["gen"][1],
                                           chunk, block))
    rec = {"arch": arch, "layers": cfg.num_layers,
           "decode_window_override": decode_window_override,
           "requests": len(reqs), "replicas": sp.replicas,
           "slots": sp.slots, "max_len": sp.max_len,
           "prompt_lens": [r.prompt_len for r in reqs],
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in _leaves(params))}
    runs = {}
    pinned = any(spec.mlp == "moe" for spec in cfg.layer_specs())
    routing, tape = _Routing(), {}
    for impl in ("kernel", "dense"):
        engine = _taped_engine(torch, cfg, impl, dev, tape,
                               reqs if impl == "dense" else None,
                               decode_window_override)
        _free(torch)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            if pinned:
                stack.enter_context(routing.record() if impl == "kernel"
                                    else routing.replay())
            report, secs = serve(engine, params, reqs, sp)
        counts = ops.launch_counts()
        admissions = int(report.log.summary()["admitted"])
        if report.unfinished or any(
                len(report.outputs[r.rid]) != r.max_new for r in reqs):
            raise AssertionError(f"serve {arch} {impl}: unfinished or "
                                 f"short requests")
        want = {k: 0 for k in counts}
        if impl == "kernel":
            want.update(_gemma3_launches(cfg, engine)(admissions))
        if counts != want or ops.body_launches()["flash_attention_window"]:
            raise AssertionError(f"serve {arch} {impl}: launches {counts}, "
                                 f"expected {want} (steps {engine.steps})")
        bodies = _check_bodies(ops, f"serve {arch} {impl}")
        runs[impl] = report
        rec[impl] = {"seconds": secs, "tokens": report.tokens_out,
                     "tokens_per_s": report.tokens_out / secs,
                     "admissions": admissions,
                     "steps": dict(engine.steps), "launches": counts,
                     "bodies": bodies,
                     "peak_bytes": (torch.cuda.max_memory_allocated()
                                    if dev.type == "cuda" else 0)}
        seen = engine.seen
        del engine
    got = runs["kernel"].outputs
    if (runs["dense"].outputs != got or any(tape.values())
            or any(len(seen[r.rid]) != r.max_new for r in reqs)):
        raise AssertionError(f"serve {arch}: the plain run was not "
                             f"teacher-forced on every kernel-path token")
    if pinned:
        if routing.at != len(routing.calls):
            raise AssertionError(f"serve {arch}: the plain run made "
                                 f"{routing.at} routing calls, the kernel "
                                 f"run {len(routing.calls)}")
        rec["routing"] = {"calls": routing.at, "rows": routing.rows,
                          "rows_own_routing_differs": int(routing.flips)}
    del routing
    if dev.type == "cuda":
        rec.update(_profile_paged_serving(torch, cfg, params, reqs, sp, dev,
                                          f"{label}. serve {arch}",
                                          decode_window_override))
    compared, low = 0, []
    for r in reqs:
        for t, (tok, (plain, margin)) in enumerate(zip(got[r.rid],
                                                         seen[r.rid])):
            compared += 1
            if tok == plain:
                continue
            if margin > ARGMAX_MARGIN:
                raise AssertionError(
                    f"serve {arch}: request {r.rid} token {t} is {tok}, the "
                    f"plain path's argmax {plain} at top-2 margin "
                    f"{margin:.3f} > {ARGMAX_MARGIN}")
            low.append({"rid": r.rid, "token": t, "margin": margin})
    rec.update(tokens_compared=compared, differing=low,
               serve_s=time.perf_counter() - t0)
    k, d = rec["kernel"], rec["dense"]
    print(f"{label}. serve {arch} bf16, {cfg.num_layers} layers, "
          + (f"decode window {decode_window_override}, "
             if decode_window_override else "")
          + f"{rec['param_bytes'] / 1e9:.2f} GB of params; "
          f"{len(reqs)} requests (prompts {min(rec['prompt_lens'])}-"
          f"{max(rec['prompt_lens'])}), {sp.replicas} x {sp.slots} "
          f"slots: kernel path {k['tokens']} tokens in "
          f"{k['seconds']:.2f} s ({k['tokens_per_s']:.1f} tok/s), "
          f"launches {k['launches']} by body {k['bodies']}, steps "
          f"{k['steps']}, peak memory {k['peak_bytes'] / 2**30:.2f} GiB; "
          f"plain path teacher-forced {d['seconds']:.2f} s "
          f"({d['tokens_per_s']:.1f} tok/s), peak "
          f"{d['peak_bytes'] / 2**30:.2f} GiB; {compared} served tokens "
          f"held, {len(low)} differ from the plain argmax, all at margin <= "
          f"{ARGMAX_MARGIN} (largest "
          f"{max((x['margin'] for x in low), default=0.0):.3f})"
          + (f"; the plain path replaying the kernel path's expert "
             f"choices: {rec['routing']['calls']} routing calls, its own "
             f"top-k picks other experts on "
             f"{rec['routing']['rows_own_routing_differs']} of "
             f"{rec['routing']['rows']} rows" if pinned else "")
          + f"; {rec['serve_s']:.1f} s", flush=True)
    return rec


def _serve_models(torch, ops, labels, table, run, after=None):
    """Each model of ``table`` through :func:`_serve_vs_plain`, its
    LayerNorm and qkv biases moved off their init first; then
    ``after(label, cfg, params, dev)`` on the same weights, its readings
    added to the model's record."""
    dev = torch.device(run["device"])
    out = {}
    for label, (arch, spec) in zip(labels, table.items()):
        t0 = time.perf_counter()
        cfg = _serve_cfg(arch, spec.get("layers"), run["reduced"])
        _free(torch)
        params = _dense_params(torch, cfg, dev)
        reqs = _dense_requests(cfg, spec)
        setup_s = time.perf_counter() - t0
        out[arch] = _serve_vs_plain(torch, ops, label, arch, cfg, params,
                                    reqs, spec, dev, run["chunk"],
                                    run["block_size"])
        if after is not None:
            _free(torch)
            out[arch].update(after(label, cfg, params, dev) or {})
        out[arch].update(setup_s=setup_s,
                         phase_s=time.perf_counter() - t0)
        del params
        _free(torch)
    return out


def run_dense_serve(torch, ops):
    """21b / 21c: StableLM-2-12B and Qwen2.5-32B at full size."""
    return _serve_models(torch, ops, ("21b", "21c"), DENSE_SERVE, DENSE_RUN)


def _fingerprint(torch, t, piece: int = 1 << 26):
    """Two int64 sums of an fp32 tensor's bit patterns, plain and weighted
    by position mod 65521, a piece at a time: equal tensors give equal
    fingerprints."""
    flat = t.detach().contiguous().view(-1).view(torch.int32)
    plain = weighted = 0
    for lo in range(0, flat.numel(), piece):
        bits = flat[lo:lo + piece].long()
        w = (torch.arange(lo, lo + bits.numel(), device=bits.device)
             % 65521 + 1)
        plain += int(bits.sum())
        weighted += int((bits * w).sum())
    return plain, weighted


def _train_kernel_vs_plain(torch, ops, label, run, dev, small, after=None):
    """WSSL rounds of ``run["arch"]`` at full width, its depth cut to
    ``run["layers"]``, at cuts ``run["cuts"]``, through
    ``launch/train.py``, once through the AdamW kernel and once through
    its plain version, the same seed and Gumbel draws.  Checks: AdamW
    launches = leaves x rounds exactly, finite losses, masks and losses
    equal, 0 elements of the trained stages differ, the moments'
    fingerprints equal.  ``after(state, cfg)`` -> a dict of readings
    taken from each run's trained state, added to its record and
    printed."""
    from unittest import mock
    import numpy as np
    from repro_torch.config import TrainConfig, WSSLConfig, get_arch, reduced
    from repro_torch.launch.train import train
    cfg = get_arch(run["arch"])
    if small:
        cfg = reduced(cfg)
    cfg = cfg.replace(num_layers=run["layers"])
    rng = np.random.default_rng(run["gumbel_seed"])
    gumbels = [torch.as_tensor(rng.gumbel(size=run["clients"]).astype(
        np.float32)) for _ in range(run["rounds"])]
    out = {"arch": run["arch"], "layers": run["layers"],
           "cuts": list(run["cuts"]), "clients": run["clients"],
           "seq": run["seq"]}
    kept = None
    for name, kernel in (("kernel", True), ("plain", False)):
        wssl_cfg = WSSLConfig(num_clients=run["clients"],
                              participation_fraction=0.5,
                              split_layers=run["cuts"])
        train_cfg = TrainConfig(rounds=run["rounds"], learning_rate=1e-3,
                                remat=not small, fused_adam=True)
        _free(torch)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with mock.patch.object(ops, "fused_adamw", ops.fused_adamw if kernel
                               else ops.fused_adamw_plain):
            state, hist = train(
                cfg, wssl_cfg, train_cfg, rounds=run["rounds"],
                batch_per_client=run["batch"], seq_len=run["seq"],
                val_batch=run["val_batch"], seed=run["seed"], device=dev,
                gumbels=gumbels, log=lambda line: print(
                    f"  {label} {name} " + line, flush=True))
        _sync(torch, dev)
        counts = ops.launch_counts()
        stages = _leaves((state.client_stack, state.edge_stages,
                          state.server_params))
        moments = _leaves([(o.m, o.v) for o in (state.opt_client,
                                                 *state.opt_edge,
                                                 state.opt_server)])
        want = {k: 0 for k in counts}
        if kernel:
            want["fused_adamw"] = len(stages) * run["rounds"]
        if counts != want:
            raise AssertionError(f"{label} {name}: launches {counts}, "
                                 f"expected {want} ({len(stages)} leaves x "
                                 f"{run['rounds']} rounds)")
        if not all(math.isfinite(h["loss"]) and math.isfinite(
                h["mean_val_loss"]) for h in hist):
            raise AssertionError(f"{label} {name}: non-finite loss {hist}")
        out[name] = {"rounds": hist, "round_s": [h["dt_s"] for h in hist],
                     "launches": counts, "leaves": len(stages),
                     "stepped_elements": sum(t.numel() for t in stages),
                     "peak_bytes": (torch.cuda.max_memory_allocated()
                                    if dev.type == "cuda" else 0),
                     "readings": after(state, cfg) if after else {}}
        prints = [_fingerprint(torch, t) for t in moments]
        if kept is None:
            # the kernel run's trained stages on the host, leaf by leaf
            kept = (hist, [t.detach().cpu() for t in stages], prints)
        else:
            hk, sk, pk = kept
            if [h["mask"] for h in hk] != [h["mask"] for h in hist]:
                raise AssertionError(f"{label}: masks differ {hk} {hist}")
            out["masks"] = [h["mask"] for h in hist]
            out["losses_equal"] = all(a["loss"] == b["loss"] and
                                      a["mean_val_loss"] == b["mean_val_loss"]
                                      for a, b in zip(hk, hist))
            out["stage_elements_differing"] = sum(
                int((a.to(b.device) != b.detach()).sum())
                for a, b in zip(sk, stages))
            out["moment_leaves_differing"] = sum(a != b for a, b in
                                                 zip(pk, prints))
        del state, stages, moments
        _free(torch)
    k = out["kernel"]
    readings = "".join(f", {key} {val}" for key, val in
                       k["readings"].items())
    print(f"{label}. train {run['arch']} fp32 params, {run['layers']} "
          f"layers, cuts {tuple(run['cuts'])}, {run['clients']} clients, seq "
          f"{run['seq']}: {k['leaves']} leaves, {k['stepped_elements']} "
          f"elements stepped (p, m, v, g "
          f"{16 * k['stepped_elements'] / 1e9:.1f} GB); rounds "
          f"{', '.join(f'{t:.3f}' for t in k['round_s'])} s (plain AdamW "
          f"{', '.join(f'{t:.3f}' for t in out['plain']['round_s'])} s); "
          f"losses {[round(h['loss'], 4) for h in k['rounds']]}{readings}; "
          f"launches {k['launches']}; peak memory "
          f"{k['peak_bytes'] / 2**30:.2f} GiB; masks {out['masks']} equal, "
          f"losses equal {out['losses_equal']}, "
          f"{out['stage_elements_differing']} stage elements and "
          f"{out['moment_leaves_differing']} moment leaves differ",
          flush=True)
    if (out["stage_elements_differing"] or out["moment_leaves_differing"]
            or not out["losses_equal"]):
        raise AssertionError(f"{label}: the AdamW kernel and its plain "
                             f"version differ: {out}")
    return out


def run_dense_train(torch, ops):
    """21d: StableLM-2-12B through :func:`_train_kernel_vs_plain` (no
    attention kernel: training is dense)."""
    return _train_kernel_vs_plain(torch, ops, "21d", DENSE_TRAIN,
                                  torch.device(DENSE_RUN["device"]),
                                  DENSE_RUN["reduced"])


def _run_parts(torch, ops, device, parts):
    """A phase's parts in order, each timed; the kernel checks (the part
    keyed ``kernels``) run only on the card."""
    out = {}
    for key, label, fn in parts:
        if key == "kernels" and device != "cuda":
            continue
        t0 = time.perf_counter()
        out[key] = fn(torch, ops)
        out[f"{key}_s"] = time.perf_counter() - t0
        print(f"{label}: {out[f'{key}_s']:.1f} s", flush=True)
        _free(torch)
    return out


def run_dense(torch, ops):
    """Phase 21: 21a, 21b-c and 21d, each timed."""
    return _run_parts(torch, ops, DENSE_RUN["device"], (
        ("kernels", "21a. kernels", run_dense_kernels),
        ("serve", "21b-c. serve", run_dense_serve),
        ("train", "21d. train", run_dense_train)))


# ---------------------------------------------------------------------------
# Mixture-of-Experts: OLMoE-1B-7B and Phi-3.5-MoE (phase 22)
# ---------------------------------------------------------------------------

# module values, so a CPU rehearsal can shrink them.  OLMoE-1B-7B whole
# (16 layers, 64 experts top-8, 16 query over 16 kv heads at hd 128,
# RMSNorm: 13.8 GB in bf16, reckoned) and Phi-3.5-MoE at 8 of its 32
# layers (16 experts top-2, 32 over 8 heads, LayerNorm moved off its init
# as in phase 21: 83.7 GB whole, 42.1 GB at the cut), random weights from
# seed 0, the configs' capacity factor 1.25.
MOE_RUN = dict(device="cuda", reduced=False, chunk=8, block_size=16)
MOE_SERVE = {
    "olmoe-1b-7b": dict(layers=None, requests=8, prompts=(256, 1024),
                        gen=(16, 32), replicas=2, slots=8, flash_s=1024),
    "phi3.5-moe-42b-a6.6b": dict(layers=8, requests=8, prompts=(512, 1024),
                                 gen=(16, 32), replicas=1, slots=8,
                                 flash_s=1024),
}
# 22a: the dispatch of 4096 tokens at OLMoE's 64 experts top-8 and
# capacity factor 1.0 (bf16-rounded logits, so ties, two planted twin
# experts and a hot one, so overflow); the layer at a 1024-token
# admission and an 8-slot decode step
MOE_DISPATCH = dict(tokens=4096, capacity_factor=1.0, layer_tokens=(1024, 8))
# 22d: OLMoE at full width cut to 4 layers, cuts (1, 3) (a client stage,
# one edge stage and the server, so both aux terms enter), 4 clients at
# participation 0.5, fp32 params: 3,452,073,984 elements, 55.2 GB of p,
# m, v and g (reckoned), through the AdamW kernel and then its plain
# version
MOE_TRAIN = dict(arch="olmoe-1b-7b", layers=4, clients=4, cuts=(1, 3),
                 seq=128, batch=2, rounds=2, val_batch=2, seed=0,
                 gumbel_seed=22)


def _check_moe_dispatch(torch):
    """The dispatch plan (``models/moe.py::route``) on the card against
    the CPU's on the same fp32 router probabilities: expert ids, gate
    values, the sort, kept mask, slots and counts equal exactly.  The
    logits are rounded to bf16 (as the router forms them), experts 1 and
    7 are planted twins of 0 and 5, and expert 3 is made hot, so ties fall
    at the k-th place and experts overflow.  ``torch.topk`` on the card is
    counted beside it (rows whose chosen set or order differs from the
    stable sort's): what finding the ties would have cost."""
    from repro_torch.models import moe
    cfg = _serve_cfg("olmoe-1b-7b", small=MOE_RUN["reduced"]).replace(
        moe_capacity_factor=MOE_DISPATCH["capacity_factor"])
    t, e, k = MOE_DISPATCH["tokens"], cfg.num_experts, cfg.experts_per_token
    g = torch.Generator().manual_seed(22)
    logits = torch.randn((t, e), generator=g).mul_(2.0)
    logits[:, 3] += 2.0
    logits[:, 1], logits[:, 7] = logits[:, 0], logits[:, 5]
    probs = torch.softmax(logits.bfloat16().float(), dim=-1)
    cap = moe._capacity(cfg, t)
    host = moe.route(cfg, probs, cap)
    card = moe.route(cfg, probs.cuda(), cap)
    torch.cuda.synchronize()
    for field in moe.Dispatch._fields:
        if not torch.equal(getattr(card, field).cpu(), getattr(host, field)):
            raise AssertionError(f"22a dispatch: {field} differs between "
                                 f"the card and the CPU")
    ids = host.expert_ids
    twins = sum(int(((ids == a).any(1) != (ids == b).any(1)).sum())
                for a, b in ((0, 1), (5, 7)))
    dropped = int((~host.keep).sum())
    if not (twins and dropped):
        raise AssertionError(f"22a dispatch: no tie at the k-th place "
                             f"({twins}) or no drop ({dropped})")
    top = torch.topk(probs.cuda(), k, dim=-1).indices.cpu()
    rec = {"tokens": t, "experts": e, "top_k": k, "capacity": cap,
           "max_count": int(host.counts.max()), "dropped": dropped,
           "twin_splits": twins,
           "topk_rows_differing": int((top != ids).any(1).sum()),
           "route_ms": _time_ms(torch, lambda: moe.route(cfg, probs.cuda(),
                                                         cap))}
    print(f"  22a dispatch of {t} tokens, {e} experts top-{k}, capacity "
          f"{cap}: card = CPU in every field; {dropped} assignments dropped "
          f"(max load {rec['max_count']}), {twins} rows split a planted "
          f"twin pair at the k-th place; torch.topk would differ on "
          f"{rec['topk_rows_differing']} rows; route {rec['route_ms']:.3f} "
          f"ms", flush=True)
    return rec


def _check_moe_layer(torch):
    """OLMoE's MoE layer at full width (one layer's router and 64 experts,
    bf16, random from a seed) run twice on the card at an admission's and
    an 8-slot decode step's token counts: bit-identical (no atomics in
    the dispatch or the combine), finite, timed."""
    from repro_torch.models import moe
    cfg = _serve_cfg("olmoe-1b-7b", small=MOE_RUN["reduced"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    p = moe.moe_init(gen, cfg, dtype=torch.bfloat16, device=dev)
    out = {}
    for tokens in MOE_DISPATCH["layer_tokens"]:
        x = torch.randn((1, tokens, cfg.d_model), generator=gen,
                        device=dev).bfloat16()
        a, aux_a = moe.apply_moe(cfg, p, x)
        b, aux_b = moe.apply_moe(cfg, p, x)
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(aux_a, aux_b)
                and torch.isfinite(a).all()):
            raise AssertionError(f"22a layer at {tokens} tokens: two runs "
                                 f"differ or are not finite")
        out[tokens] = {"ms": _time_ms(torch, lambda: moe.apply_moe(cfg, p, x),
                                      reps=10),
                       "capacity": moe._capacity(cfg, tokens),
                       "aux": aux_a.item()}
        print(f"  22a MoE layer, {tokens} tokens: two runs bit-identical, "
              f"aux {out[tokens]['aux']:.6f}, {out[tokens]['ms']:.3f} ms "
              f"a call (capacity {out[tokens]['capacity']})", flush=True)
    del p
    return out


def run_moe_kernels(torch, ops):
    """22a: flash and paged decode at OLMoE's (16 over 16 heads, g 1) and
    Phi's (32 over 8, g 4) shapes at hd 128 against their plain versions,
    the dispatch on the card against the CPU's, the layer's determinism."""
    out = _serve_kernel_checks(torch, ops, MOE_SERVE, MOE_RUN["reduced"])
    out["dispatch"] = _check_moe_dispatch(torch)
    out["layer"] = _check_moe_layer(torch)
    return out


def run_moe_serve(torch, ops):
    """22b / 22c: OLMoE-1B-7B whole and Phi-3.5-MoE at 16 layers (Phi's
    LayerNorm moved off its init first)."""
    return _serve_models(torch, ops, ("22b", "22c"), MOE_SERVE, MOE_RUN)


def _aux_readings(state, cfg):
    """The aux part of the loss after the last round: client 0's stage on
    the validation batch, then each edge stage's and the server's aux."""
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as tf
    run = MOE_TRAIN
    dev = _leaves(state.server_params)[0].device
    with torch.no_grad():
        vt = torch.as_tensor(lm_batch(run["val_batch"], run["seq"],
                                      cfg.vocab_size, seed=10_000)["tokens"],
                             device=dev)
        x = tf.client_forward(tree_map(lambda a: a[0], state.client_stack),
                              cfg, vt, remat=False)
        edge_aux = []
        for j, ep in enumerate(state.edge_stages):
            x, a = tf.stage_forward(ep, cfg, x, j + 1, remat=False,
                                    with_aux=True)
            edge_aux.append(round(a.item(), 5))
        _, srv_aux = tf.server_hidden(state.server_params, cfg, x,
                                      remat=False)
    return {"edge_aux": edge_aux, "server_aux": round(srv_aux.item(), 5)}


def run_moe_train(torch, ops):
    """22d: OLMoE at full width, cut in depth, cuts (1, 3), through
    :func:`_train_kernel_vs_plain`: every client runs each round (the
    edge and server aux enter for all N); the aux part read after the
    last round."""
    return _train_kernel_vs_plain(torch, ops, "22d", MOE_TRAIN,
                                  torch.device(MOE_RUN["device"]),
                                  MOE_RUN["reduced"], after=_aux_readings)


def run_moe(torch, ops):
    """Phase 22: 22a, 22b-c and 22d, each timed."""
    return _run_parts(torch, ops, MOE_RUN["device"], (
        ("kernels", "22a. kernels", run_moe_kernels),
        ("serve", "22b-c. serve", run_moe_serve),
        ("train", "22d. train", run_moe_train)))


# ---------------------------------------------------------------------------
# The modality frontend and the decode window: MusicGen-medium and
# Qwen2-VL-72B (phase 23)
# ---------------------------------------------------------------------------

# module values, so a CPU rehearsal can shrink them.  MusicGen-medium
# whole (48 layers, 24 query over 24 kv heads at hd 64, an ungated GELU
# MLP, LayerNorm moved off its init as in phase 21: 2.73 GB in bf16,
# reckoned) and Qwen2-VL-72B at 20 of its 80 layers (64 over 8 at hd 128,
# M-RoPE, qkv biases moved off zero: 75.3 GB at the cut, 145.4 GB whole),
# random weights from seed 0.  ``flash_s`` is the flash check's sequence:
# an admission for MusicGen, the vision prefill's 1,024 patches before
# 1,024 text tokens for Qwen2-VL; ``long_s`` MusicGen's longest admission
# under the decode window.
FRONT_RUN = dict(device="cuda", reduced=False, chunk=8, block_size=16,
                 seed=0, patches=1024, text=1024)
FRONT_SERVE = {
    "musicgen-medium": dict(layers=None, requests=8, prompts=(256, 1024),
                            gen=(16, 32), replicas=2, slots=8, flash_s=1024,
                            long_s=6144),
    "qwen2-vl-72b": dict(layers=20, requests=4, prompts=(512, 1024),
                         gen=(16, 32), replicas=1, slots=8, flash_s=2048),
}
# 23d: MusicGen at full size, cuts (4, 44) (a client stage of 4 layers, an
# edge stage of 40, the server's 4 and the head), 4 clients at
# participation 0.5, fp32: 1.715 G elements stepped, 27.4 GB of p, m, v
# and g (reckoned), through the AdamW kernel and then its plain version
FRONT_TRAIN = dict(arch="musicgen-medium", layers=48, clients=4,
                   cuts=(4, 44), seq=128, batch=2, rounds=2, val_batch=2,
                   seed=0, gumbel_seed=23)
# 23e: reduced Qwen2-VL (2 layers, d 256, 16 patches), 4 clients, cut 1,
# fp32: the sync round, then one round of client chunks of 2.  Full width
# cannot fit: even at cut 0 with one layer a stage, two clients'
# embeddings and the head come to 4.75 G elements, 76 GB at 16 B each.
FRONT_IMAGE = dict(clients=4, cuts=(1,), seq=32, batch=2, chunk=2, seed=0,
                   gumbel_seed=24)
# 23f: MusicGen whole under the long-context decode window: 2 requests of
# 4608-6144 tokens, 64 new each, on 1 x 4 slots, so every ring wraps
FRONT_WINDOW = dict(arch="musicgen-medium", window=4096, requests=2,
                    prompts=(4608, 6144), gen=(64, 64), replicas=1, slots=4)


def run_front_kernels(torch, ops):
    """23a: flash and paged decode at MusicGen's (24 over 24, g 1, hd 64)
    and Qwen2-VL's (64 over 8, g 8, hd 128; flash at the vision prefill's
    2,048 positions) shapes against their plain versions, as in 21a, and
    flash at MusicGen's longest windowed admission (6,144 positions)."""
    from repro_torch.kernels import ref
    out = _serve_kernel_checks(torch, ops, FRONT_SERVE, FRONT_RUN["reduced"])
    cfg = _serve_cfg("musicgen-medium", small=FRONT_RUN["reduced"])
    rec = check_flash(torch, ops, ref, b=1, hq=cfg.num_heads,
                      hkv=cfg.num_kv_heads,
                      s=FRONT_SERVE["musicgen-medium"]["long_s"],
                      hd=cfg.head_dim, dtype="bfloat16", seed=230)
    _check_band(rec)
    out["musicgen_long_flash"] = rec
    return out


def _vision_prefill(label, cfg, params, dev):
    """23c(ii): ``make_prefill_step(cfg, "kernel")`` on B 1 with 1,024
    patch embeddings (0.1 x N(0, 1) from the seed, bf16) before 1,024 text
    tokens, against the same step with the flash kernel's plain version in
    its place (on the card): flash launched once per layer, none in the
    plain run; the last position's argmax equal wherever the plain run's
    top-2 margin exceeds ARGMAX_MARGIN; its max|diff| reported beside
    LOGIT_BAND, and the gap to ``impl="dense"``, which masks by M-RoPE's
    temporal stream (every patch at t = 0) where the kernel masks by index:
    a reading, not a check."""
    import torch
    from unittest import mock
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import make_prefill_step
    run = FRONT_RUN
    f, s = run["patches"], run["text"]
    if FRONT_RUN["reduced"]:
        f, s = cfg.frontend_tokens, 48
    gen = torch.Generator(device=dev).manual_seed(run["seed"] + 23)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                                     device=dev, dtype=torch.int32),
             "embeds": (torch.randn((1, f, cfg.d_model), generator=gen,
                                    device=dev) * 0.1).bfloat16()}

    def plain_flash(q, k, v, **kw):
        t = lambda a: a.transpose(1, 2)
        return t(ref.flash_attention(t(q), t(k), t(v), **kw))

    step = make_prefill_step(cfg, "kernel")
    ops.reset_launch_counts()
    lk = step(params, batch)
    _sync(torch, dev)
    launched = ops.launch_counts()["flash_attention"]
    with mock.patch.object(ops, "flash_attention", plain_flash):
        ops.reset_launch_counts()
        lp = step(params, batch)
        _sync(torch, dev)
        plain_launched = sum(ops.launch_counts().values())
    ld = make_prefill_step(cfg, "dense")(params, batch)
    if launched != cfg.num_layers or plain_launched:
        raise AssertionError(f"{label} vision prefill: {launched} flash "
                             f"launches ({cfg.num_layers} layers), "
                             f"{plain_launched} in the plain run")
    if not (torch.isfinite(lk).all() and lk.shape == (1, 1, cfg.vocab_size)):
        raise AssertionError(f"{label} vision prefill: logits {lk.shape} "
                             f"not finite or of the wrong shape")
    margin = _top2_margin(torch, lp[0, -1]).item()
    same = int(lk[0, -1].argmax()) == int(lp[0, -1].argmax())
    if not same and margin > ARGMAX_MARGIN:
        raise AssertionError(f"{label} vision prefill: argmax differs from "
                             f"the plain flash's at top-2 margin "
                             f"{margin:.3f} > {ARGMAX_MARGIN}")
    rec = {"patches": f, "text": s, "flash_launches": launched,
           "max_abs_diff": (lk - lp).abs().max().item(),
           "logit_band": LOGIT_BAND, "argmax_equal": same,
           "plain_margin": margin,
           "dense_gap": (lk - ld).abs().max().item(),
           "dense_argmax_equal": int(lk[0, -1].argmax())
           == int(ld[0, -1].argmax())}
    if dev.type == "cuda":
        rec["ms"] = _time_ms(torch, lambda: step(params, batch), reps=3,
                             warmup=1)
    print(f"{label}. vision prefill, {f} patches before {s} text tokens: "
          f"{launched} flash launches; last-position logits against the "
          f"plain flash max|diff| {rec['max_abs_diff']:.4f} (LOGIT_BAND "
          f"{LOGIT_BAND}), argmax equal {same} (plain top-2 margin "
          f"{margin:.3f}); gap to the dense path's temporal-stream mask "
          f"{rec['dense_gap']:.4f} (a reading), argmax equal "
          f"{rec['dense_argmax_equal']}"
          + (f"; {rec['ms']:.1f} ms a step" if "ms" in rec else ""),
          flush=True)
    return {"vision_prefill": rec}


def run_front_serve(torch, ops):
    """23b / 23c: MusicGen-medium whole and Qwen2-VL-72B at 40 layers
    through :func:`_serve_vs_plain` (its LayerNorm or qkv biases moved off
    their init first), then Qwen2-VL's vision prefill on the same weights
    (:func:`_vision_prefill`)."""
    return _serve_models(
        torch, ops, ("23b", "23c"), FRONT_SERVE, FRONT_RUN,
        after=lambda label, cfg, params, dev: (
            _vision_prefill(label, cfg, params, dev)
            if cfg.frontend == "vision" else None))


def run_front_train(torch, ops):
    """23d: MusicGen-medium at full size, cuts (4, 44), 4 clients, through
    :func:`_train_kernel_vs_plain`."""
    return _train_kernel_vs_plain(torch, ops, "23d", FRONT_TRAIN,
                                  torch.device(FRONT_RUN["device"]),
                                  FRONT_RUN["reduced"])


def run_front_image_round(torch, ops):
    """23e: the round with image patches on the card.  Reduced Qwen2-VL,
    each client's 16 patch embeddings before its tokens, 4 clients at
    participation 0.5, cut 1, fp32 params: the sync round, then a round in
    client chunks of 2, once through the AdamW kernel and once through its
    plain version, the same seed and Gumbel draws.  Checks: AdamW launches
    = leaves x rounds, finite losses, masks and losses equal, 0 elements of
    the stages and moments differ."""
    import numpy as np
    from unittest import mock
    from repro_torch.config import TrainConfig, WSSLConfig, get_arch, reduced
    from repro_torch.core.round import init_state, make_round_fn
    from repro_torch.data.synthetic import lm_batch
    run = FRONT_IMAGE
    dev = torch.device(FRONT_RUN["device"])
    cfg = reduced(get_arch("qwen2-vl-72b"))
    n, b, s, f = run["clients"], run["batch"], run["seq"], cfg.frontend_tokens
    w = WSSLConfig(num_clients=n, participation_fraction=0.5,
                   split_layers=run["cuts"])
    rng = np.random.default_rng(run["gumbel_seed"])
    gumbels = [torch.as_tensor(rng.gumbel(size=n).astype(np.float32))
               for _ in range(2)]
    gen = torch.Generator(device=dev).manual_seed(run["seed"] + 1)
    batches = []
    for r in range(2):
        d = lm_batch(n * b, s, cfg.vocab_size, seed=r)
        batch = {k: torch.as_tensor(v, device=dev).reshape(n, b, s)
                 for k, v in d.items()}
        batch["embeds"] = torch.randn((n, b, f, cfg.d_model), generator=gen,
                                      device=dev) * 0.1
        batches.append(batch)
    val = {k: torch.as_tensor(v, device=dev)
           for k, v in lm_batch(2, s, cfg.vocab_size, seed=999).items()}
    out, kept = {}, None
    for name, kernel in (("kernel", True), ("plain", False)):
        state = init_state(torch.Generator(device=dev).manual_seed(
            run["seed"]), cfg, w, TrainConfig(), device=dev)
        ops.reset_launch_counts()
        hist = []
        with mock.patch.object(ops, "fused_adamw", ops.fused_adamw if kernel
                               else ops.fused_adamw_plain):
            for r, chunk in enumerate((None, run["chunk"])):
                rf = make_round_fn(cfg, w, TrainConfig(
                    learning_rate=1e-3, client_chunk=chunk, fused_adam=True),
                    impl="dense")
                _, m = rf(state, batches[r], val, gumbel=gumbels[r])
                hist.append({"loss": float(m.loss),
                             "mask": m.mask.cpu().tolist(),
                             "bytes_per_hop": [int(x) for x in
                                               m.bytes_per_hop]})
        _sync(torch, dev)
        counts = ops.launch_counts()
        tensors = _leaves((state.client_stack, state.edge_stages,
                           state.server_params))
        stages = len(tensors)
        tensors += _leaves([(o.m, o.v) for o in (state.opt_client,
                                                  *state.opt_edge,
                                                  state.opt_server)])
        want = {k: 0 for k in counts}
        if kernel:
            want["fused_adamw"] = stages * 2
        if counts != want or not all(math.isfinite(h["loss"]) for h in hist):
            raise AssertionError(f"23e {name}: launches {counts}, expected "
                                 f"{want}; rounds {hist}")
        out[name] = {"rounds": hist, "launches": counts}
        if kept is None:
            kept = (hist, [t.detach().clone() for t in tensors])
        else:
            out["elements_differing"] = sum(
                _bit_diffs(torch, a, t.detach())
                for a, t in zip(kept[1], tensors))
            out["equal"] = kept[0] == hist
        del state
    print(f"23e. image round: reduced {cfg.name}, {f} patches before {s} "
          f"tokens, {n} clients, cuts {run['cuts']}, fp32; the sync round "
          f"then client chunks of {run['chunk']}: losses "
          f"{[round(h['loss'], 5) for h in out['kernel']['rounds']]}, masks "
          f"{[h['mask'] for h in out['kernel']['rounds']]}, per-hop bytes "
          f"{out['kernel']['rounds'][0]['bytes_per_hop']}; launches "
          f"{ {k: v for k, v in out['kernel']['launches'].items() if v} }; "
          f"kernel vs plain AdamW: metrics equal {out['equal']}, "
          f"{out['elements_differing']} elements of the stages and moments "
          f"differ", flush=True)
    if out["elements_differing"] or not out["equal"]:
        raise AssertionError(f"23e: the AdamW kernel and its plain version "
                             f"differ: {out}")
    return out


def run_front_window(torch, ops):
    """23f: MusicGen whole with ``decode_window_override=4096`` through
    :func:`_serve_vs_plain`: 4 prompts of 4608-6144 tokens on 1 x 4 slots,
    so every global layer's ring wraps; flash 48 launches an admission
    (the prompt attends in full), paged none (no layer pages)."""
    run = dict(FRONT_WINDOW)
    dev = torch.device(FRONT_RUN["device"])
    cfg = _serve_cfg(run["arch"], small=FRONT_RUN["reduced"])
    window = run["window"]
    if FRONT_RUN["reduced"]:
        window = cfg.long_context_window
    t0 = time.perf_counter()
    params = _dense_params(torch, cfg, dev)
    reqs = _dense_requests(cfg, run)
    setup_s = time.perf_counter() - t0
    rec = _serve_vs_plain(torch, ops, "23f", run["arch"], cfg, params, reqs,
                          run, dev, FRONT_RUN["chunk"],
                          FRONT_RUN["block_size"],
                          decode_window_override=window)
    if rec["kernel"]["launches"]["paged_decode_attention"] or min(
            r.prompt_len for r in reqs) <= window:
        raise AssertionError(f"23f: paged launches "
                             f"{rec['kernel']['launches']} or a prompt "
                             f"within the window {window}")
    rec.update(setup_s=setup_s, phase_s=time.perf_counter() - t0)
    del params
    return rec


def run_front(torch, ops):
    """Phase 23: 23a, 23b-c, 23d, 23e and 23f, each timed."""
    return _run_parts(torch, ops, FRONT_RUN["device"], (
        ("kernels", "23a. kernels", run_front_kernels),
        ("serve", "23b-c. serve", run_front_serve),
        ("train", "23d. train", run_front_train),
        ("image", "23e. image round", run_front_image_round),
        ("window", "23f. decode window", run_front_window)))


# ---------------------------------------------------------------------------
# The chunked / flash training path (phase 24)
# ---------------------------------------------------------------------------

# module values, so a CPU rehearsal can shrink them.  24a: full Gemma-2B
# (arXiv:2403.08295: 18 layers, d 2048, 8 query heads over 1 kv head at
# hd 256, vocab 256,000), fp32 params, bf16 activations, 2 clients at cut
# 4, one sequence a client; 24b: the attention Function alone at
# Gemma-2B's global layer and Gemma-3-12B's local one (16 over 8 heads,
# window 1024); 24c: Gemma-3-12B at 6 of its 48 layers, one super-block
# of 5 local layers and a global one.
FLASH_RUN = dict(device="cuda", reduced=False, seed=0, gumbel_seed=24,
                 seqs=(4096, 8192), val_batch=1, loss_rtol=1e-2,
                 fn_seq=4096, fn_band=1e-4, fn_cases=(("gemma-2b", None),
                                                      ("gemma3-12b", 1024)),
                 remat_layers=6, remat_seq=4096)


def _peak_reset(torch, dev):
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        return torch.cuda.memory_allocated(dev)
    return 0


def _peak(torch, dev, base=0):
    """Bytes allocated at the peak since ``_peak_reset`` above ``base`` (0
    off the card)."""
    _sync(torch, dev)
    if dev.type == "cuda":
        return torch.cuda.max_memory_allocated(dev) - base
    return 0


ROOFLINE_RUN = dict(device="cuda", prefill_batch=2, prefill_seq=4096,
                    decode_pos=512, reps=3, seed=0)


def _step_ms(torch, dev, fn, reps):
    """ms a call: CUDA events on the card, the host clock elsewhere (a
    CPU rehearsal)."""
    if dev.type == "cuda":
        return _time_ms(torch, fn, reps=reps, warmup=1)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _tensor_bytes(torch, leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _count(torch, dev, call):
    """The op counter (``roofline/op_cost.py``) over one call."""
    from repro_torch.roofline import op_cost
    with op_cost.OpCounter() as counter:
        call()
    _sync(torch, dev)
    return counter


def _hold_counts(label, card, meta):
    """26 (b): the card's count of one call equals the meta count of the
    same step: FLOPs, bytes, elementwise operations, kernel credits."""
    ct, mt = card.totals(), meta.totals()
    bad = {k: (ct[k], mt[k]) for k in ("flops", "bytes", "elementwise_ops",
                                       "kernels") if ct[k] != mt[k]}
    if bad:
        ops_diff = {op: (card.by_op.get(op), meta.by_op.get(op))
                    for op in sorted(set(card.by_op) | set(meta.by_op))
                    if card.by_op.get(op) != meta.by_op.get(op)}
        raise AssertionError(f"26{label}: the card's count differs from the "
                             f"meta count: {bad}; by op (card, meta) "
                             f"{ops_diff}")
    return ct


def _roofline_reading(label, cfg, shape, totals, predicted, card_bytes,
                      step_s, meta_peak, card_peak, dtype="bfloat16"):
    """26 (a) and (c) of one step: its record, printed on a line."""
    from repro_torch.roofline import analysis as an
    if predicted != card_bytes:
        raise AssertionError(f"26{label}: the dry run predicts {predicted} "
                             f"argument bytes, the card holds {card_bytes}")
    rep_ = an.RooflineReport(
        arch=cfg.name, shape=shape.name, mesh="1",
        flops_per_device=totals["flops"], bytes_per_device=totals["bytes"],
        coll_bytes_per_device=0.0,
        model_flops_global=an.model_flops(cfg, shape), chips=1, dtype=dtype)
    rec = {"argument_bytes": card_bytes, "flops": totals["flops"],
           "bytes": totals["bytes"],
           "elementwise_ops": totals["elementwise_ops"],
           "kernels": totals["kernels"],
           "model_flops": rep_.model_flops_global,
           "t_compute_s": rep_.t_compute, "t_memory_s": rep_.t_memory,
           "bottleneck": rep_.bottleneck, "mfu_bound": rep_.mfu_bound,
           "step_s": step_s,
           "mfu": an.mfu(rep_.model_flops_global, step_s, dtype),
           "meta_peak_bytes": meta_peak, "card_peak_bytes": card_peak}
    print(f"26{label}: {cfg.name} {shape.name}: argument bytes "
          f"{card_bytes} = dry run's; counts equal (flops {totals['flops']:.6g}"
          f", bytes {totals['bytes']:.6g}); step {step_s * 1e3:.2f} ms vs "
          f"t_compute {rep_.t_compute * 1e3:.2f} ms, t_memory "
          f"{rep_.t_memory * 1e3:.2f} ms; mfu {rec['mfu']:.4f} (bound "
          f"{rep_.mfu_bound:.4f}); peak meta {meta_peak / 2**30:.2f} GiB, "
          f"card {card_peak / 2**30:.2f} GiB", flush=True)
    return rec


def run_roofline_serve(torch, cfg, params, max_len, slots):
    """26a and 26b on phase 3's serving params (see the docstring)."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import specs as sp
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import MESHES
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import device_bytes
    run = ROOFLINE_RUN
    dev = torch.device(run["device"])
    mesh = MESHES["1"]
    g = torch.Generator(device=dev).manual_seed(run["seed"])
    meta_params, p_axes = sp.serve_param_specs(cfg)
    out = {}
    for label, shape in (
            ("a", ShapeConfig(f"prefill_b{run['prefill_batch']}_s"
                              f"{run['prefill_seq']}", run["prefill_seq"],
                              run["prefill_batch"], "prefill")),
            ("b", ShapeConfig("decode_phase3", max_len, slots, "decode"))):
        rules = sp.build_rules(mesh, cfg, shape.kind, shape.global_batch)
        meta_batch, b_axes = sp.batch_specs(cfg, shape)
        predicted = (device_bytes(mesh, rules, p_axes, meta_params)
                     + device_bytes(mesh, rules, b_axes, meta_batch))
        b = shape.global_batch
        if shape.kind == "prefill":
            batch = {"tokens": torch.randint(
                0, cfg.vocab_size, (b, shape.seq_len), generator=g,
                device=dev, dtype=torch.int32)}
            step = st.make_prefill_step(cfg, "kernel")
            call = lambda: step(params, batch)
            meta_call = lambda: step(meta_params, meta_batch)
            cache = ()
        else:
            meta_cache, c_axes = sp.cache_specs(cfg, shape)
            predicted += device_bytes(mesh, rules, c_axes, meta_cache)
            cache = tf.init_cache(cfg, b, shape.seq_len, device=dev)
            batch = {"tokens": torch.randint(
                0, cfg.vocab_size, (b, 1), generator=g, device=dev,
                dtype=torch.int32),
                "pos": torch.full((b,), run["decode_pos"], device=dev,
                                  dtype=torch.int32)}
            step = st.make_serve_step(cfg, shape)
            call = lambda: step(params, cache, batch)
            meta_call = lambda: step(meta_params, meta_cache, meta_batch)
        card_bytes = _tensor_bytes(torch, tree_leaves((params, batch, cache)))
        ms = _step_ms(torch, dev, call, run["reps"])
        base = _peak_reset(torch, dev)
        call()
        card_peak = _peak(torch, dev, base)
        meta = _count(torch, torch.device("meta"), meta_call)
        totals = _hold_counts(label, _count(torch, dev, call), meta)
        out[shape.name] = _roofline_reading(
            label, cfg, shape, totals, predicted, card_bytes, ms / 1e3,
            meta.peak_temp_bytes, card_peak)
        del cache, batch
    return out


def _roofline_round(torch, cfg, wssl_cfg, train_cfg, state, seq):
    """26c on the state 24a trained (see the docstring)."""
    from repro_torch import sharding
    from repro_torch.config import ShapeConfig
    from repro_torch.core.round import abstract_state
    from repro_torch.launch import specs as sp
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import MESHES
    dev = state.importance.device
    mesh = MESHES["1"]
    n = wssl_cfg.num_clients
    shape = ShapeConfig(f"round_s{seq}", seq, n, "train")
    rules = sp.build_rules(mesh, cfg, "train", n)
    meta_state, s_axes = abstract_state(cfg, wssl_cfg, train_cfg)
    meta_batch, b_axes = sp.batch_specs(cfg, shape, wssl_cfg)
    predicted = (sharding.device_bytes(mesh, rules, s_axes, meta_state)
                 + sharding.device_bytes(mesh, rules, b_axes, meta_batch))
    g = torch.Generator(device=dev).manual_seed(ROOFLINE_RUN["seed"])
    batch = {k: torch.randint(0, cfg.vocab_size, tuple(v.shape), generator=g,
                              device=dev, dtype=torch.int32)
             for k, v in meta_batch.items()}
    card_bytes = _tensor_bytes(torch, sharding.tree_leaves_state(state)
                               + list(batch.values()))
    step = st.make_train_step(cfg, wssl_cfg, train_cfg, impl="chunked")

    def call():
        # round 0 selects every client: the dry run's host decision
        state.round_index.zero_()
        step(state, batch)

    ms = _step_ms(torch, dev, call, ROOFLINE_RUN["reps"])
    _peak_reset(torch, dev)
    call()
    card_peak = _peak(torch, dev)
    state.round_index.zero_()
    card = _count(torch, dev, lambda: step(state, batch))
    meta = _count(torch, torch.device("meta"),
                  lambda: step(meta_state, meta_batch))
    totals = _hold_counts("c", card, meta)
    meta_peak = predicted + meta.peak_temp_bytes
    return _roofline_reading("c", cfg, shape, totals, predicted, card_bytes,
                             ms / 1e3, meta_peak, card_peak)


def run_flash_rounds(torch, ops):
    """24a: one WSSL round of full Gemma-2B at S 4096 through
    ``launch/train.py`` with ``impl="chunked"`` (the flash path) and one
    with ``impl="dense"``, from the same seed and Gumbel draw, then one
    ``chunked`` round at S 8192 (dense is not run there: one layer's
    (1, 1, 8, 8192, 8192) fp32 scores alone are 2 GiB, on top of the
    state's ~64 GB).  Checks: the fused AdamW launched leaves x 1 times
    and nothing else launched, finite losses, the round's training loss
    and mean validation loss within ``loss_rtol`` of dense's.  Reports
    each round's time and peak memory."""
    import numpy as np
    from repro_torch.config import TrainConfig, WSSLConfig, get_arch, reduced
    from repro_torch.launch.train import train
    dev = torch.device(FLASH_RUN["device"])
    cfg = get_arch("gemma-2b")
    if FLASH_RUN["reduced"]:
        cfg = reduced(cfg)
    wssl_cfg = WSSLConfig(num_clients=2, participation_fraction=0.5)
    train_cfg = TrainConfig(rounds=1, learning_rate=1e-3, remat=True)
    rng = np.random.default_rng(FLASH_RUN["gumbel_seed"])
    gumbels = [torch.as_tensor(rng.gumbel(size=2).astype(np.float32))]
    s0, s1 = FLASH_RUN["seqs"]
    out = {"arch": cfg.name, "cut": wssl_cfg.resolve_cuts(cfg)[0],
           "clients": 2, "runs": {}}
    for impl, s in (("chunked", s0), ("dense", s0), ("chunked", s1)):
        _free(torch)
        base = _peak_reset(torch, dev)
        ops.reset_launch_counts()
        state, hist = train(cfg, wssl_cfg, train_cfg, rounds=1,
                            batch_per_client=1, seq_len=s,
                            val_batch=FLASH_RUN["val_batch"],
                            seed=FLASH_RUN["seed"], device=dev, impl=impl,
                            gumbels=gumbels, log=lambda line: print(
                                f"  24a {impl} S {s} " + line, flush=True))
        peak = _peak(torch, dev, base)
        counts = ops.launch_counts()
        leaves = len(_leaves((state.client_stack, state.server_params)))
        if (impl, s) == ("chunked", s0):
            # 26c on this state
            out["roofline_round"] = _roofline_round(
                torch, cfg, wssl_cfg, train_cfg, state, s)
        del state
        want = {**{k: 0 for k in counts}, "fused_adamw": leaves}
        h = hist[0]
        if counts != want:
            raise AssertionError(f"24a {impl} S {s}: launches {counts}, "
                                 f"expected {want}")
        if not (math.isfinite(h["loss"]) and math.isfinite(
                h["mean_val_loss"])) or h["selected"] != 2:
            raise AssertionError(f"24a {impl} S {s}: {h}")
        out["runs"][f"{impl}/{s}"] = {
            "impl": impl, "seq": s, "round_s": h["dt_s"], "loss": h["loss"],
            "mean_val_loss": h["mean_val_loss"], "val_loss": h["val_loss"],
            "peak_bytes": peak, "launches": counts, "leaves": leaves}
    ch, de = out["runs"][f"chunked/{s0}"], out["runs"][f"dense/{s0}"]
    out["rel_diff"] = {k: abs(ch[k] - de[k]) / abs(de[k])
                       for k in ("loss", "mean_val_loss")}
    for key, r in out["runs"].items():
        print(f"24a: {cfg.name} {key}: round {r['round_s']:.3f} s, loss "
              f"{r['loss']:.6f}, val {r['mean_val_loss']:.6f}, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB, AdamW launches "
              f"{r['launches']['fused_adamw']} (leaves {r['leaves']})",
              flush=True)
    rel = out["rel_diff"]
    print(f"24a: chunked vs dense at S {s0}: loss rel diff "
          f"{rel['loss']:.3g}, val {rel['mean_val_loss']:.3g} (band "
          f"{FLASH_RUN['loss_rtol']:g})", flush=True)
    if not all(v <= FLASH_RUN["loss_rtol"] for v in out["rel_diff"].values()):
        raise AssertionError(f"24a: chunked vs dense outside the band: {out}")
    return out


def _fwd_bwd(torch, fn, cfg, q, k, v, do, pos, window):
    """``fn``'s output and the gradients of q, k and v for cotangent
    ``do``."""
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fn(cfg, qq, kk, vv, pos, pos, window)
    return (o.detach(),) + torch.autograd.grad(o, (qq, kk, vv), do)


def run_flash_function(torch, ops):
    """24b: the flash attention Function (``_attn_flash``: the forward
    scan, the recomputing backward) alone against the dense path's
    autograd, forward and backward, at Gemma-2B's global layer and
    Gemma-3-12B's local one, B 1.  Held in fp32: out, dq, dk, dv within
    ``fn_band`` of max|dense|.  On the card, timed in bf16 (CUDA events,
    one forward + backward a call) beside the dense autograd and SDPA's
    forward + backward (a band mask for the window: the yardstick of a
    CUDA flash backward), and each path's peak above its inputs."""
    from repro_torch.config import get_arch, reduced
    from repro_torch.models import attention as attn
    import torch.nn.functional as F
    dev = torch.device(FLASH_RUN["device"])
    s = FLASH_RUN["fn_seq"]
    out = {}
    for arch, window in FLASH_RUN["fn_cases"]:
        cfg = get_arch(arch)
        if FLASH_RUN["reduced"]:
            cfg = reduced(cfg)
        hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        gen = torch.Generator(device=dev).manual_seed(24)
        q, do = (torch.randn(1, s, hq, hd, generator=gen, device=dev)
                 for _ in range(2))
        k, v = (torch.randn(1, s, hkv, hd, generator=gen, device=dev)
                for _ in range(2))
        pos = torch.arange(s, device=dev)[None]
        flash = _fwd_bwd(torch, attn._attn_flash, cfg, q, k, v, do, pos,
                         window)
        dense = _fwd_bwd(torch, attn._attn_dense, cfg, q, k, v, do, pos,
                         window)
        errs = {n: ((a - b).abs().max() / b.abs().max()).item()
                for n, a, b in zip(("out", "dq", "dk", "dv"), flash, dense)}
        del flash, dense
        rec = {"arch": arch, "S": s, "Hq": hq, "Hkv": hkv, "hd": hd,
               "window": window, "rel_err_fp32": errs,
               "band": FLASH_RUN["fn_band"]}
        if dev.type == "cuda":
            qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
            mask = None
            if window is not None:
                i = torch.arange(s, device=dev)
                mask = (i[None, :] <= i[:, None]) & (
                    i[:, None] - i[None, :] < window)

            def sdpa():
                qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                              for t in (qb, kb, vb))
                o = F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, is_causal=mask is None,
                    scale=attn._scale(cfg), enable_gqa=True)
                return torch.autograd.grad(o, (qs, ks, vs),
                                           dob.transpose(1, 2))

            paths = {"flash": lambda: _fwd_bwd(torch, attn._attn_flash, cfg,
                                               qb, kb, vb, dob, pos, window),
                     "dense": lambda: _fwd_bwd(torch, attn._attn_dense, cfg,
                                               qb, kb, vb, dob, pos, window),
                     "sdpa": sdpa}
            for name, fn in paths.items():
                base = _peak_reset(torch, dev)
                fn()
                rec[f"{name}_peak_bytes"] = _peak(torch, dev, base)
                rec[f"{name}_ms"] = _time_ms(torch, fn, reps=5, warmup=1)
            del qb, kb, vb, dob, mask
        out[arch] = rec
        del q, k, v, do
        _free(torch)
        line = (f"24b: {arch} S {s} {hq} over {hkv} hd {hd} window {window}:"
                f" fp32 max|diff| / max|dense| " + ", ".join(
                    f"{n} {e:.3g}" for n, e in errs.items())
                + f" (band {FLASH_RUN['fn_band']:g})")
        if "flash_ms" in rec:
            line += (f"; bf16 forward + backward: flash {rec['flash_ms']:.3f}"
                     f" ms, dense {rec['dense_ms']:.3f} ms, SDPA "
                     f"{rec['sdpa_ms']:.3f} ms; peak above the inputs: flash "
                     f"{rec['flash_peak_bytes'] / 2**20:.1f} MiB, dense "
                     f"{rec['dense_peak_bytes'] / 2**20:.1f} MiB, SDPA "
                     f"{rec['sdpa_peak_bytes'] / 2**20:.1f} MiB")
        print(line, flush=True)
        if not all(e <= FLASH_RUN["fn_band"] for e in errs.values()):
            raise AssertionError(f"24b: the flash Function outside its band "
                                 f"against dense: {rec}")
    return out


def run_flash_remat(torch, ops):
    """24c: nested remat at full width.  Gemma-3-12B at 6 of its 48
    layers (one super-block: 5 local layers at window 1024 and a global
    one), fp32 params, bf16 activations, B 1 x S 4096: ``tf.loss_fn`` and
    its gradients with ``impl="chunked"``, ``remat=True`` (the span's
    checkpoint and one a layer inside it, counted) and ``remat=False``.
    Held: the loss and every gradient equal bit for bit.  Reports each
    one's time and peak."""
    from unittest import mock
    import numpy as np
    from repro_torch.config import get_arch, reduced
    from repro_torch.models import transformer as tf
    dev = torch.device(FLASH_RUN["device"])
    cfg = get_arch("gemma3-12b")
    if FLASH_RUN["reduced"]:
        cfg = reduced(cfg)
    cfg = cfg.replace(num_layers=FLASH_RUN["remat_layers"])
    gen = torch.Generator(device=dev).manual_seed(FLASH_RUN["seed"])
    params = tf.init_params(cfg, gen, device=dev, dtype=torch.float32)
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    rng = np.random.default_rng(24)
    s = FLASH_RUN["remat_seq"]
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, s)),
                                dtype=torch.int32, device=dev)
             for k in ("tokens", "labels")}
    calls = []
    real = tf.checkpoint

    def counted(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)

    out = {"arch": cfg.name, "layers": cfg.num_layers, "S": s,
           "period": cfg.period}
    grads = {}
    for remat in (True, False):
        calls.clear()
        base = _peak_reset(torch, dev)
        t0 = time.perf_counter()
        with mock.patch.object(tf, "checkpoint", counted):
            loss = tf.loss_fn(params, cfg, batch, impl="chunked", remat=remat)
            grads[remat] = (loss.detach(),) + torch.autograd.grad(loss, leaves)
        _sync(torch, dev)
        out[f"remat_{remat}"] = {
            "s": time.perf_counter() - t0, "loss": loss.item(),
            "peak_bytes": _peak(torch, dev, base),
            "checkpoints": len(calls),
            "nested": calls.count("_apply_layer")}
        del loss
    blocks = cfg.num_layers // cfg.period
    if out["remat_True"]["nested"] != 2 * cfg.num_layers or out[
            "remat_True"]["checkpoints"] != blocks + 2 * cfg.num_layers or \
            out["remat_False"]["checkpoints"]:
        raise AssertionError(f"24c: checkpoint regions {out}")
    differ = sum(int((a != b).sum()) for a, b in zip(grads[True],
                                                     grads[False]))
    out["elements"] = sum(t.numel() for t in grads[True])
    out["differ"] = differ
    del grads, params, leaves
    r, p = out["remat_True"], out["remat_False"]
    print(f"24c: {cfg.name} at {cfg.num_layers} layers (period "
          f"{cfg.period}), S {s}, chunked: nested remat {r['s']:.3f} s, "
          f"peak {r['peak_bytes'] / 2**30:.2f} GiB, {r['checkpoints']} "
          f"checkpoint regions ({r['nested']} a layer); no remat "
          f"{p['s']:.3f} s, peak {p['peak_bytes'] / 2**30:.2f} GiB; "
          f"{differ} of {out['elements']} loss and gradient elements "
          f"differ", flush=True)
    if differ:
        raise AssertionError(f"24c: nested remat changed {differ} elements")
    return out


def run_flash(torch, ops):
    """Phase 24: 24a, 24b and 24c, each timed."""
    return _run_parts(torch, ops, FLASH_RUN["device"], (
        ("rounds", "24a. Gemma-2B rounds", run_flash_rounds),
        ("function", "24b. the flash Function", run_flash_function),
        ("remat", "24c. nested remat", run_flash_remat)))


# ---------------------------------------------------------------------------
# The client axis (phase 25)
# ---------------------------------------------------------------------------

# phase 16's Mamba-2-370M (full width, FAULT_RUN["layers"] of its 48
# layers, cut 8, 8 clients, seq 256, fp32 params, fused AdamW) at
# participation 0.5, ``rounds`` rounds a case.  S = 1 runs over NCCL in
# this process; S = 2 and 4 are processes sharing the card over gloo (NCCL
# refuses two ranks on one GPU): one spawn of four ranks, in which two
# pairs run their S = 2 cases side by side (a process pays ~11 s of CUDA
# warm-up on its first round), then all four the S = 4 case.
# 25c's async round: ``async-stragglers`` (the slow half 8x) at deadline
# inf and at ``deadline`` (the slow half parks in round 0, lands in 1).
SHARD_RUN = dict(device="cuda", dtype="float32", rounds=2, participation=0.5,
                 deadline=4.0, max_staleness=4, timeout=600.0,
                 scenario="async-stragglers")
SHARD_PAIRS = (((0, 1), ("importance", "trimmed_mean")),
               ((2, 3), ("int8", "async")))
SHARD_ALL = ("importance",)
# the bands of tests/test_sharded_round.py: the client stack, then the
# server stage, the validation losses and the loss
SHARD_CLIENT_BAND, SHARD_SHARED_BAND = 1e-5, 5e-3


def _shard_setup(rule="importance", scheme="none", deadline=None):
    import dataclasses
    from repro_torch.config import AsyncRoundsConfig, CompressionConfig
    cfg, w, t = _fault_setup(FAULT_RUN["layers"], (FAULT_RUN["cut"],),
                             SHARD_RUN["participation"], rule)
    cfg = cfg.replace(dtype=SHARD_RUN["dtype"])
    if scheme != "none":
        w = dataclasses.replace(w, compression=CompressionConfig(
            scheme=scheme))
    if deadline is not None:
        w = dataclasses.replace(w, async_rounds=AsyncRoundsConfig(
            deadline=deadline, max_staleness=SHARD_RUN["max_staleness"]))
    return cfg, w, t


def _shard_drive(torch, ops, dev, cfgs, *, kind, gumbels, group=None,
                 profile=False, first=False):
    """``SHARD_RUN["rounds"]`` rounds of ``kind`` (``sync``; ``sync-sc``,
    the sync round under the scenario; ``async``) from the seed's initial
    state with the Gumbel draws ``gumbels`` (None: the selection
    generator's own, drawn ahead and recorded): flat without ``group``,
    else as its shard.  Round 0 times the collectives; with ``profile``, round
    1 runs under the profiler; with ``first``, round 0's record keeps the
    global client stage on the host (``client0``).  Returns the state,
    the async state (or None) and one record a round."""
    from repro_torch import sharding, sim
    from repro_torch.core import async_round as ar
    from repro_torch.core import round as rnd
    from repro_torch.core import wssl
    from repro_torch.data.synthetic import lm_batch
    cfg, w, t = cfgs
    n = w.num_clients
    gen = torch.Generator(device=dev).manual_seed(FAULT_RUN["seed"])
    sc = (None if kind == "sync" else
          sim.scenario_params(sim.get_scenario(SHARD_RUN["scenario"])))
    if group is None:
        state = rnd.init_state(gen, cfg, w, t, device=dev)
        fn = (ar.make_async_round_fn(cfg, w, t) if kind == "async"
              else rnd.make_round_fn(cfg, w, t))
        place = lambda b: b
    else:
        state = sharding.init_shard_state(gen, cfg, w, t, group.num_shards,
                                          group.index, device=dev)
        fn = (ar.make_sharded_async_round_fn(cfg, w, t, group)
              if kind == "async" else
              rnd.make_sharded_round_fn(cfg, w, t, group))
        place = fn.place_batch
    astate = ar.init_async_state(state) if kind == "async" else None
    if gumbels is None:
        # the draws the rounds would take from the selection generator,
        # from a copy of it
        copy = torch.Generator()
        copy.set_state(state.rng.get_state())
        gumbels = [wssl.gumbel_noise((n,), copy).numpy()
                   for _ in range(SHARD_RUN["rounds"])]
    val = {k: torch.as_tensor(v, device=dev) for k, v in lm_batch(
        FAULT_RUN["val_batch"], FAULT_RUN["seq"], cfg.vocab_size,
        seed=10_000).items()}
    recs = []
    for r in range(SHARD_RUN["rounds"]):
        batch = place(_client_streams(torch, cfg, n, FAULT_RUN["batch"],
                                      FAULT_RUN["seq"], r, dev))
        g = torch.as_tensor(gumbels[r], device=dev)
        out = []

        def call():
            if kind == "async":
                out.append(fn(state, astate, batch, val, sc, gumbel=g)[2])
            else:
                out.append(fn(state, batch, val, sc, gumbel=g)[1])

        before = ops.launch_counts()
        sharding.reset_collective_stats(timing=r == 0)
        _sync(torch, dev)
        prof = None
        if profile and r == 1:
            prof = _device_profile(torch, call, cpu=False)
            dt = prof["wall_s"]
        else:
            t0 = time.perf_counter()
            call()
            _sync(torch, dev)
            dt = time.perf_counter() - t0
        m = out[0]
        base = m.base if kind == "async" else m
        after = ops.launch_counts()
        rec = {"round": r, "dt_s": dt, "gumbel": gumbels[r],
               "loss": float(base.loss),
               "mask": base.mask.cpu().tolist(),
               "val_loss": base.val_loss.cpu().tolist(),
               "bytes_cross_shard": float(base.bytes_cross_shard),
               "bytes_intra_shard": float(base.bytes_intra_shard),
               "launches": {k: after[k] - before[k] for k in after
                            if after[k] != before[k]},
               "collectives": sharding.collective_stats()}
        if kind == "async":
            rec.update({f: float(getattr(m, f)) for f in (
                "on_time", "buffered", "arrived", "evicted")})
        if prof is not None:
            rec["busy_share"] = prof["device_busy_share"]
        if first and r == 0:
            rec["client0"] = [t[0].detach().cpu()
                              for t in _leaves(state.client_stack)]
        recs.append(rec)
    sharding.reset_collective_stats()
    return state, astate, recs


def _shard_snapshot(torch, state):
    """What the parent holds a sharded run to: the global client stage
    (every row equals it after the sync) and the server stage, on the
    host."""
    host = lambda tree: [t.detach().cpu() for t in _leaves(tree)]
    return {"client": host([t[0] for t in _leaves(state.client_stack)]),
            "server": host((state.server_params, state.edge_stages))}


def _state_prints(torch, state, astate=None):
    """Every tensor of a state (and its async state) as fingerprints."""
    return [_fingerprint(torch, t.float() if t.is_floating_point()
                         else t.to(torch.int32))
            for t in _state_tensors(state, astate)]


def _shard_case(torch, ops, ref, group, dev, name, gumbels):
    """One rank's case of phase 25; returns its records, its peak, and
    for the parent's comparisons rank 0's snapshot and every rank's
    fingerprints of the replicated stages."""
    import contextlib
    from unittest import mock
    t0 = time.perf_counter()
    deadline = SHARD_RUN["deadline"] if name == "async" else None
    cfgs = _shard_setup("trimmed_mean" if name == "trimmed_mean"
                        else "importance",
                        "int8" if name == "int8" else "none", deadline)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    kind = "async" if name == "async" else "sync"
    # rank 0 keeps what the parent holds to the flat round (int8 has no
    # flat reference: it is held to its plain run, here)
    snap = group.index == 0 and name != "int8"
    state, astate, recs = _shard_drive(torch, ops, dev, cfgs, kind=kind,
                                       gumbels=gumbels, group=group,
                                       profile=cuda, first=snap)
    counts = ops.launch_counts()
    out = {"recs": recs, "launches": counts,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0,
           "client_leaves": len(_leaves(state.client_stack)),
           "shared_leaves": len(_leaves((state.server_params,
                                         state.edge_stages))),
           "server_prints": [_fingerprint(torch, t) for t in _leaves(
               (state.server_params, state.edge_stages))]}
    if snap:
        out["snapshot"] = _shard_snapshot(torch, state)
    if name == "int8":
        # 25b: the same rounds with the compression entry points patched
        # to their plain versions: bit for bit
        kernel = _state_prints(torch, state)
        del state, astate
        _free(torch)
        ops.reset_launch_counts()
        with mock.patch.multiple(ops,
                                 quantize_stochastic=ref.quantize_stochastic_2d,
                                 dequantize=ref.dequantize_2d):
            plain, _, plain_recs = _shard_drive(torch, ops, dev, cfgs,
                                                kind="sync", gumbels=gumbels,
                                                group=group)
        out["plain_launches"] = ops.launch_counts()
        out["plain_equal"] = (kernel == _state_prints(torch, plain) and all(
            a[f] == b[f] for a, b in zip(recs, plain_recs)
            for f in ("loss", "mask", "val_loss")))
        del plain
    elif name == "async":
        # 25c: at deadline inf the async round is the sync round under the
        # same scenario, bit for bit
        del state, astate
        _free(torch)
        inf = _shard_setup(deadline=math.inf)
        s_sync, _, r_sync = _shard_drive(torch, ops, dev, inf, kind="sync-sc",
                                         gumbels=gumbels, group=group)
        prints = _state_prints(torch, s_sync)
        del s_sync
        _free(torch)
        s_inf, a_inf, r_inf = _shard_drive(torch, ops, dev, inf, kind="async",
                                           gumbels=gumbels, group=group)
        out["inf_equal"] = (prints == _state_prints(torch, s_inf) and all(
            a[f] == b[f] for a, b in zip(r_sync, r_inf)
            for f in ("loss", "mask", "val_loss")))
        out["inf_buffered"] = [r["buffered"] for r in r_inf]
        del s_inf, a_inf
    _free(torch)
    out["case_s"] = time.perf_counter() - t0
    return out


def _shard_rank(group, dev, gumbels, fault_run, shard_run):
    """The body of one spawned rank of phase 25, with the parent's
    ``FAULT_RUN`` / ``SHARD_RUN``: its pair's S = 2 cases (the pair a
    group of its own), then, after a barrier, the S = 4 cases.  Returns
    (S, case) -> the case's output."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import ClientGroup
    FAULT_RUN.update(fault_run)
    SHARD_RUN.update(shard_run)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the round's two collectives straight on the card's tensors over the
    # group's backend (gloo takes CUDA tensors itself: nothing is staged)
    s, i = group.num_shards, group.index
    t = torch.full((3,), float(i + 1), device=dev)
    dist.all_reduce(t, group=group.group)
    parts = [torch.empty_like(t) for _ in range(s)]
    dist.all_gather(parts, torch.full((3,), float(i), device=dev),
                    group=group.group)
    if (t.tolist() != [s * (s + 1) / 2] * 3 or
            torch.cat(parts).tolist() != [float(j) for j in range(s)
                                          for _ in range(3)]):
        raise AssertionError(f"{group.backend} collectives on {dev} tensors "
                             f"came back wrong: {t.tolist()}")
    out = {}
    # every rank creates every pair's group, in the same order
    pairs = [(ranks, cases, dist.new_group(list(ranks)))
             for ranks, cases in SHARD_PAIRS]
    for ranks, cases, pg in pairs:
        if i in ranks:
            pair = ClientGroup(group=pg, num_shards=len(ranks),
                               index=ranks.index(i), backend=group.backend)
            for name in cases:
                out[(2, name)] = _shard_case(torch, ops, ref, pair, dev,
                                             name, gumbels)
    dist.barrier(group=group.group)
    for name in SHARD_ALL:
        out[(s, name)] = _shard_case(torch, ops, ref, group, dev, name,
                                     gumbels)
    return out


def _shard_compare(where, ref, got, got0, recs, ref_recs, *, shards,
                   stage_bytes, decomposes, adamw):
    """A sharded run against its flat reference: masks equal; the global
    client stage after round 0 within SHARD_CLIENT_BAND (the tree's
    reassociated sum: every client's update is the flat round's there);
    the client stage after the last round, the server stage, the
    validation losses and the loss within SHARD_SHARED_BAND (from round 1
    on the clients' updates carry the server stage's differences, which
    AdamW amplifies, as the bands of tests/test_sharded_round.py say of
    the server); the cross-shard bytes equal to the byte model; AdamW
    ``adamw`` launches a round."""
    import torch
    from repro_torch.core.protocol import hierarchical_sync_bytes
    n = FAULT_RUN["clients"]
    diff = lambda a, b: max(float((x - y).abs().max()) for x, y in zip(a, b))
    client0 = diff(got0, ref_recs[0]["client0"])
    client = diff(got["client"], ref["client"])
    server = diff(got["server"], ref["server"])
    val = max(abs(a - b) for r, fr in zip(recs, ref_recs)
              for a, b in zip(r["val_loss"], fr["val_loss"]))
    loss = max(abs(r["loss"] - fr["loss"]) for r, fr in zip(recs, ref_recs))
    if any(r["mask"] != fr["mask"] for r, fr in zip(recs, ref_recs)):
        raise AssertionError(f"{where}: masks differ from the flat round's")
    if client0 > SHARD_CLIENT_BAND or max(client, server, val, loss) > \
            SHARD_SHARED_BAND:
        per_round = [(max(abs(a - b) for a, b in zip(
            r["val_loss"], fr["val_loss"])), abs(r["loss"] - fr["loss"]))
            for r, fr in zip(recs, ref_recs)]
        raise AssertionError(
            f"{where}: client after round 0 {client0:.3g} (band "
            f"{SHARD_CLIENT_BAND:g}); client {client:.3g}, server "
            f"{server:.3g}, val {val:.3g}, loss {loss:.3g} (band "
            f"{SHARD_SHARED_BAND:g}); (val, loss) by round {per_round}")
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    for r in recs:
        up = (r["on_time"] + r["arrived"]) if "on_time" in r \
            else sum(r["mask"])
        cross, intra = hierarchical_sync_bytes(f32(up), n, shards,
                                               f32(stage_bytes), decomposes)
        if (r["bytes_cross_shard"], r["bytes_intra_shard"]) != (
                float(cross), float(intra)):
            raise AssertionError(f"{where}: cross / intra bytes "
                                 f"{r['bytes_cross_shard']} / "
                                 f"{r['bytes_intra_shard']}, model "
                                 f"{float(cross)} / {float(intra)}")
        if r["launches"].get("fused_adamw") != adamw[r["round"]]:
            raise AssertionError(f"{where}: AdamW launches {r['launches']} "
                                 f"in round {r['round']}, the flat round "
                                 f"{adamw[r['round']]}")
    return {"client0_max_diff": client0, "client_max_diff": client,
            "server_max_diff": server, "val_max_diff": val,
            "loss_max_diff": loss}


def run_shards(torch, ops):
    """Phase 25: the client axis on the card.  The flat kernel-path
    rounds first (the references; their Gumbel draws go to every sharded
    run), then 25a: S = 1 over NCCL in this process, bit for bit against
    the flat round; S = 2 (importance, trimmed_mean) and S = 4
    (importance) over gloo ranks sharing the card, each against its flat
    round in the bands of tests/test_sharded_round.py, cross-shard bytes
    against the byte model, AdamW launches on each rank equal to the flat
    round's; 25b: int8 at S 2, quantize and dequantize launches = client
    leaves x the rounds in which the rank's shard uploads (> 0) on each
    rank, and the same rounds through the plain versions bit for bit; 25c: the async round at S 2 under
    ``async-stragglers``, at deadline inf against the sharded sync round
    bit for bit, at ``SHARD_RUN["deadline"]`` against the flat async round
    in the same bands with equal admission counts.  Each case prints its
    round times, each rank's peak, rank 0's busy share (round 1, under
    the profiler) and the collectives' share of round 0."""
    from repro_torch.core import aggregation
    from repro_torch.core import round as rnd
    from repro_torch.launch.mesh import (client_process_group,
                                         spawn_client_shards)
    dev = torch.device(SHARD_RUN["device"])
    out = {"flat": {}, "cases": {}}
    refs, gumbels = {}, None
    # -- the flat references ----------------------------------------------
    for name, rule, kind, deadline in (
            ("importance", "importance", "sync", None),
            ("trimmed_mean", "trimmed_mean", "sync", None),
            ("async", "importance", "async", SHARD_RUN["deadline"])):
        cfgs = _shard_setup(rule, deadline=deadline)
        _free(torch)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, astate, recs = _shard_drive(torch, ops, dev, cfgs, kind=kind,
                                           gumbels=gumbels, first=True)
        gumbels = gumbels or [r["gumbel"] for r in recs]
        refs[name] = {"snapshot": _shard_snapshot(torch, state),
                      "recs": recs,
                      "adamw": [r["launches"]["fused_adamw"] for r in recs],
                      "stage_bytes": rnd.client_stage_bytes(state)}
        out["flat"][name] = {"round_s": [r["dt_s"] for r in recs],
                             "run_s": time.perf_counter() - t0,
                             "loss": [r["loss"] for r in recs],
                             "adamw": refs[name]["adamw"]}
        if name == "importance":
            # 25a, S = 1: one rank over NCCL, bit for bit
            backend = "nccl" if dev.type == "cuda" else "gloo"
            with client_process_group(1, 0, backend=backend,
                                      timeout=SHARD_RUN["timeout"]) as group:
                one, _, one_recs = _shard_drive(torch, ops, dev, cfgs,
                                                kind="sync", gumbels=gumbels,
                                                group=group)
            a, b = _state_tensors(one), _state_tensors(state)
            differing = sum(int((x != y).sum()) for x, y in zip(a, b))
            same_recs = all(x[f] == y[f] for x, y in zip(one_recs, recs)
                            for f in ("loss", "mask", "val_loss"))
            if len(a) != len(b) or differing or not same_recs:
                raise AssertionError(f"25a S 1 (nccl): {differing} state "
                                     f"elements differ, records equal "
                                     f"{same_recs}")
            out["cases"]["importance/1"] = {
                "backend": backend, "round_s": [r["dt_s"] for r in one_recs],
                "state_elements_differing": 0,
                "state_elements": sum(x.numel() for x in a)}
            times = lambda rs: ", ".join(f"{r['dt_s']:.3f}" for r in rs)
            print(f"  25a importance S 1 ({backend}, in process): rounds "
                  f"{times(one_recs)} s (flat {times(recs)}); "
                  f"{sum(x.numel() for x in a)} state elements, 0 differ",
                  flush=True)
            del one, a, b
        del state, astate
        _free(torch)
    print("  25 flat references: " + ", ".join(
        f"{k} {v['run_s']:.1f} s (rounds "
        f"{', '.join(f'{t:.3f}' for t in v['round_s'])})"
        for k, v in out["flat"].items()), flush=True)
    # -- 25a-c on gloo ranks sharing the card -----------------------------
    t0 = time.perf_counter()
    ranks = spawn_client_shards(_shard_rank, 4, gumbels, dict(FAULT_RUN),
                                dict(SHARD_RUN), device=dev, backend="gloo",
                                timeout=SHARD_RUN["timeout"])
    spawn_s = time.perf_counter() - t0
    out["spawn_s"] = spawn_s
    print(f"  25 S 2 and 4: one spawn of 4 ranks, {spawn_s:.1f} s", flush=True)
    runs = [(2, name, members) for members, cases in SHARD_PAIRS
            for name in cases] + [(4, name, range(4)) for name in SHARD_ALL]
    for shards, name, members in runs:
        per = [ranks[r][(shards, name)] for r in members]
        recs = per[0]["recs"]
        rec = {"backend": "gloo", "spawn_s": spawn_s,
               "case_s": [p["case_s"] for p in per],
               "round_s": [r["dt_s"] for r in recs],
               "peak_bytes": [p["peak_bytes"] for p in per],
               "busy_share_rank0": recs[1].get("busy_share"),
               "collective_share": (recs[0]["collectives"]["seconds"]
                                    / recs[0]["dt_s"]),
               "collectives": recs[0]["collectives"],
               "launches": [p["launches"] for p in per]}
        if any(p["server_prints"] != per[0]["server_prints"]
               for p in per):
            raise AssertionError(f"25 {name} S {shards}: the ranks' "
                                 f"server stages differ")
        where = f"25 {name} S {shards}"
        if name in ("importance", "trimmed_mean", "async"):
            ref = refs[name]
            cfgs = _shard_setup(name if name == "trimmed_mean"
                                else "importance")
            # every rank's records (its own launches), rank 0's stages
            for p in reversed(per):
                rec.update(_shard_compare(
                    where, ref["snapshot"], per[0]["snapshot"],
                    recs[0]["client0"], p["recs"], ref["recs"],
                    shards=shards,
                    stage_bytes=ref["stage_bytes"],
                    decomposes=aggregation.rule_decomposes(cfgs[1]),
                    adamw=ref["adamw"]))
        if name == "async":
            for f in ("on_time", "buffered", "arrived", "evicted"):
                got = [r[f] for r in recs]
                want = [r[f] for r in refs["async"]["recs"]]
                if got != want:
                    raise AssertionError(f"{where}: {f} {got}, flat "
                                         f"{want}")
            if not all(p["inf_equal"] for p in per):
                raise AssertionError(f"{where}: deadline inf differs "
                                     f"from the sharded sync round")
            rec["admission"] = {f: [r[f] for r in recs] for f in (
                "on_time", "buffered", "arrived", "evicted")}
            rec["inf_equal_sync"] = True
        if name == "int8":
            n_loc = FAULT_RUN["clients"] // shards
            for i, p in enumerate(per):
                # a client leaf a round in which the shard uploads (a
                # shard none of whose clients is selected sends
                # nothing, as an all-dropped flat round)
                want = per[0]["client_leaves"] * sum(
                    any(m > 0 for m in r["mask"][i * n_loc:
                                                 (i + 1) * n_loc])
                    for r in recs)
                got = (p["launches"]["quantize_stochastic"],
                       p["launches"]["dequantize"])
                if got != (want, want) or not want or \
                        p["launches"]["fused_adamw"] <= 0:
                    raise AssertionError(f"{where}: launches "
                                         f"{p['launches']}, quantize / "
                                         f"dequantize want {want}")
                if p["plain_launches"]["quantize_stochastic"] or \
                        p["plain_launches"]["dequantize"] or \
                        not p["plain_equal"]:
                    raise AssertionError(
                        f"{where}: plain run launches "
                        f"{p['plain_launches']}, bit-equal "
                        f"{p['plain_equal']}")
            rec["plain_equal"] = True
        out["cases"][f"{name}/{shards}"] = rec
        extra = "".join(
            f", {k} {rec[k]:.3g}" for k in (
                "client0_max_diff", "client_max_diff", "server_max_diff",
                "val_max_diff", "loss_max_diff") if k in rec)
        rounds = ", ".join(f"{t:.3f}" for t in rec["round_s"])
        peaks = ", ".join(f"{b / 2**30:.2f}" for b in rec["peak_bytes"])
        beside = " beside the other pair" if shards == 2 else ""
        busy = rec["busy_share_rank0"]
        busy = "not measured" if busy is None else f"{busy:.3f}"
        print(f"  25 {name} S {shards} (gloo, {shards} processes on one "
              f"card{beside}): case {max(rec['case_s']):.1f} s, rounds "
              f"{rounds} s; peaks {peaks} GiB; rank 0 "
              f"busy {busy}; collectives {rec['collective_share']:.3f} of round 0 "
              f"({rec['collectives']['calls']} calls, "
              f"{rec['collectives']['bytes'] / 2**20:.1f} MiB a rank)"
              f"{extra}; launches rank 0 {_nonzero(rec['launches'][0])}",
              flush=True)
    return out


def _check_bodies(ops, where, bf16=True):
    """The counted run's flash and SSD-scan launches all took their
    tensor-core bodies (bf16, at the models' shapes; none of them in fp32)
    and its paged launches the split-K pair."""
    counts = ops.launch_counts()
    want = {"flash_attention_tc": counts["flash_attention"] if bf16 else 0,
            "paged_decode_attention_split": counts["paged_decode_attention"],
            "ssd_scan_tc": counts["ssd_scan"] if bf16 else 0}
    bodies = {k: ops.body_launches()[k] for k in want}
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
    # -- 26a, 26b. the roofline of the prefill and decode steps ----------
    t0 = time.perf_counter()
    record["roofline_serve"] = run_roofline_serve(torch, cfg, params,
                                                  sp.max_len, sp.slots)
    record["roofline_serve_s"] = time.perf_counter() - t0
    print(f"26a-b. the roofline of serving: {record['roofline_serve_s']:.1f}"
          f" s", flush=True)
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
             run_paper_robust),
            ("gemma3_serve", "19. Gemma-3-12B serving", run_gemma3_serve),
            ("async", "20. the async round", run_async),
            ("dense", "21. StableLM-2-12B and Qwen2.5-32B", run_dense),
            ("moe", "22. OLMoE-1B-7B and Phi-3.5-MoE", run_moe),
            ("front", "23. MusicGen-medium and Qwen2-VL-72B", run_front),
            ("flash", "24. the flash training path", run_flash),
            ("shards", "25. the client axis", run_shards)):
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
    # the attention kernels again at Gemma-3-12B's shapes (16 query heads
    # over 8 kv heads), launches from phase 19's clean run
    g3 = record["gemma3_serve"]
    for label, key, n in (("local", "local", "flash_local"),
                          ("global", "global", "flash_global"),
                          ("decode", "paged", "paged")):
        rec = g3["kernel_checks"][key]
        src, replaces = sources[rec["kernel"]]
        kernels.append({"name": f"{rec['kernel']}/gemma3-12b/{label}",
                        "route": "cuda", "source": src, "replaces": replaces,
                        "launches": g3["clean_launches"][n],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    # and at StableLM-2-12B's (32 over 8 heads, hd 160), Qwen2.5-32B's
    # (40 over 8, g 5), OLMoE-1B-7B's (16 over 16, g 1), Phi-3.5-MoE's
    # (32 over 8, g 4), MusicGen-medium's (24 over 24 at hd 64) and
    # Qwen2-VL-72B's (64 over 8, g 8; flash at the vision prefill's 2,048
    # positions) shapes, launches from phases 21-23's kernel-path serving
    # runs
    for phase, arch in ([("dense", a) for a in DENSE_SERVE]
                        + [("moe", a) for a in MOE_SERVE]
                        + [("front", a) for a in FRONT_SERVE]):
        launched = record[phase]["serve"][arch]["kernel"]["launches"]
        for key in ("flash", "paged"):
            rec = record[phase]["kernels"][arch][key]
            src, replaces = sources[rec["kernel"]]
            kernels.append({"name": f"{rec['kernel']}/{arch}", "route": "cuda",
                            "source": src, "replaces": replaces,
                            "launches": launched[rec["kernel"]],
                            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                            "plain_ms": rec["plain_ms"],
                            "bound_ms": rec["bound_ms"],
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
