"""Three-term roofline of one step on one H100, and the cost of each
hand-written kernel.

  compute    = FLOPs_per_device / peak FLOP/s at the step's compute dtype
  memory     = bytes_per_device / HBM bytes/s
  collective = collective_bytes_per_device / inter-card bytes/s

The counterpart of ``repro/roofline/analysis.py``, with the H100's
constants in place of the TPU's.  Its inputs come from
``roofline/op_cost.py`` (a step counted op by op, on the meta device by
the dry run or on the card) instead of compiled HLO.  Collective bytes
weight an all-reduce 2x (a reduce-scatter and an all-gather), as JAX's
``collective_bytes`` does.

**The kernels' costs.**  One function a kernel returns ``(flops,
bytes)`` of one call from its arguments' shapes (and, for paged decode,
from the entries the call's data make live): bytes are each input read
once and each output written once, operations are what the function
computes.  ``chip_smoke.py`` bounds every kernel with them
(:func:`bound_ms`), and each wrapper of ``kernels/ops.py`` credits the
op counter with them in place of the ops its plain version would run.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional

# H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet): HBM3 memory
# rate; dense (no sparsity) bf16 tensor-core rate; fp32 rate outside the
# tensor cores; memory; NVLink 4 bandwidth, 900 GB/s a card summed over
# both directions, so 450e9 B/s each way (a data-sheet figure, not
# measured here)
HBM_BW = 3.35e12                                      # bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # FLOP/s
HBM_PER_DEVICE = 80e9                                 # bytes
LINK_BW = 450e9                                       # bytes/s, one way

_COLL_WEIGHT = {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1,
                "all-to-all": 1, "collective-permute": 1}


def weighted_collective_bytes(coll: Dict[str, float]) -> float:
    """Collective result bytes by op kind -> the weighted total (an
    all-reduce 2x)."""
    return float(sum(w * coll.get(k, 0.0) for k, w in _COLL_WEIGHT.items()))


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops_global: float
    chips: int
    dtype: str = "bfloat16"       # the step's compute dtype (its peak)
    coll_detail: Dict[str, float] = field(default_factory=dict)
    memory_per_device: Optional[Dict[str, float]] = None

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.dtype]

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def model_flops_ratio(self) -> float:
        """Useful MODEL_FLOPS / counted FLOPs (global)."""
        counted = self.flops_per_device * self.chips
        return self.model_flops_global / max(counted, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Upper bound on MFU implied by the dominant term."""
        t_total = max(self.t_compute, self.t_memory, self.t_collective)
        t_useful = self.model_flops_global / (self.chips * self.peak_flops)
        return t_useful / max(t_total, 1e-30)

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "dtype": self.dtype,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "model_flops_global": self.model_flops_global,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_ratio": self.model_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "coll_detail": self.coll_detail,
            "memory_per_device": self.memory_per_device,
        }


def model_flops(model_cfg, shape_cfg, wssl_cfg=None) -> float:
    """Useful FLOPs: 6·N_active·tokens for training, 2·N_active·tokens fwd."""
    n_active = model_cfg.active_param_count()
    if shape_cfg.kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 6.0 * n_active * tokens
    if shape_cfg.kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape_cfg.global_batch


def mfu(model_flops_: float, seconds: float, dtype: str = "bfloat16",
        chips: int = 1) -> float:
    """The share of the cards' peak a step reached: useful FLOPs over
    (its time x the peak at ``dtype`` x the cards)."""
    return model_flops_ / (seconds * PEAK_FLOPS[dtype] * chips)


def summarize_memory(argument_bytes: float, peak_bytes: float, *,
                     output_bytes: float = 0.0,
                     source: str = "meta") -> Dict[str, float]:
    """A device's memory for one step: its arguments, and the peak of
    what is live (``source`` "meta": the op counter's estimate of the
    arguments plus the step's live temporaries; "cuda": the allocator's
    ``max_memory_allocated``), and whether the peak fits the card."""
    return {"argument_size_in_bytes": float(argument_bytes),
            "output_size_in_bytes": float(output_bytes),
            "temp_size_in_bytes": float(max(peak_bytes - argument_bytes,
                                            0.0)),
            "peak_estimate_bytes": float(peak_bytes),
            "peak_source": source,
            "fits_80GB": bool(peak_bytes < HBM_PER_DEVICE)}


def fused_adam_bytes(num_params: float, itemsize: int = 4
                     ) -> Dict[str, float]:
    """Analytic HBM traffic of one masked-AdamW step over ``num_params``
    parameters (moments are always fp32; ``itemsize`` is the param width).

    Unfused baseline — the per-leaf op chain executed op by op: the moment
    update reads (p, g, m, v) and writes (m', v'), the step reads (p, m',
    v') and writes p', and the masked blend re-reads the old (p, m, v) —
    ~8 operand-sized round-trips.  The fused kernel makes ONE streaming
    pass: read (p, g, m, v), write (p', m', v').
    """
    op = num_params * itemsize
    unfused = 8 * 2.0 * op      # ~8 round-trips, read + write each
    fused = (4 + 3.0) * op      # 4 operand reads + 3 operand writes
    return {"bytes_unfused": unfused, "bytes_fused": fused,
            "speedup": unfused / fused}


def num_paged_layers(model_cfg) -> int:
    """Attention layers whose KV pages in a paged decode cache: the
    effectively-global ones (``window is None``)."""
    return sum(1 for s in model_cfg.layer_specs()
               if s.mixer in ("global", "local") and s.window is None)


def paged_attention_bytes(model_cfg, *, block_size: int, num_blocks: int,
                          live_entries: float, batch: int = 1,
                          kv_itemsize: int = 4) -> Dict[str, float]:
    """Per-decode-token HBM traffic of the two paged-attention paths.

    One logical KV entry costs ``2·Hkv·hd·itemsize`` (K + V) plus 4 bytes
    of ``ppos``.  The gather path materializes the ``(B, nb·bs, ...)``
    logical views every step (3 passes over ``nb·bs`` entries a row); the
    kernel streams each *live* entry once (``live_entries`` may be
    fractional — a trajectory average).  ``view_bytes`` is the exact size
    of the gathered views (one pass).
    """
    entry = 2 * model_cfg.num_kv_heads * model_cfg.head_dim * kv_itemsize + 4
    layers = num_paged_layers(model_cfg)
    view = batch * layers * num_blocks * block_size * entry
    return {
        "entry_bytes": entry,
        "paged_layers": layers,
        "view_bytes": float(view),
        "gather_bytes": float(3 * view),
        "kernel_bytes": float(batch * layers * live_entries * entry),
    }


# ---------------------------------------------------------------------------
# The kernels' costs
# ---------------------------------------------------------------------------


class KernelCost(NamedTuple):
    flops: float      # operations the function computes
    bytes: float      # each input read once, each output written once


# kernels whose operations are matrix products (the FLOPs JAX's
# ``hlo_cost`` counts as dot / convolution); the others' are elementwise
KERNEL_OP_KIND = {"flash_attention": "matmul",
                  "paged_decode_attention": "matmul",
                  "ssd_scan": "matmul", "weighted_average": "matmul",
                  "rg_lru_scan": "elementwise", "fused_adamw": "elementwise",
                  "quantize_stochastic": "elementwise",
                  "dequantize": "elementwise", "topk_mask": "elementwise"}


def bound_ms(nbytes: float, flops: float, dtype: str):
    """(the least time in ms the card takes for a function, what bounds
    it): the larger of its bytes over the memory rate and its operations
    over the peak at ``dtype``."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def attention_pairs(sq: int, sk: int, causal: bool = True,
                    window: Optional[int] = None) -> int:
    """(query, key) pairs flash attention computes: query i sees
    ``min(i + 1, sk)`` keys when causal (all ``sk`` when not), at most
    ``window`` of them."""
    cap = min(sk, window) if window else sk
    if not causal:
        return sq * cap
    if sq <= cap:
        return sq * (sq + 1) // 2
    return cap * (cap + 1) // 2 + (sq - cap) * cap


def flash_attention_cost(b: int, hq: int, hkv: int, sq: int, hd: int,
                         itemsize: int, *, sk: Optional[int] = None,
                         causal: bool = True,
                         window: Optional[int] = None) -> KernelCost:
    """q, out (B, Sq, Hq, hd) and k, v (B, Sk, Hkv, hd) once; QKᵀ and PV
    over the pairs the mask keeps, 2 FLOPs a multiply-add each."""
    sk = sq if sk is None else sk
    pairs = attention_pairs(sq, sk, causal, window)
    nbytes = itemsize * (2 * b * sq * hq * hd + 2 * b * sk * hkv * hd)
    return KernelCost(4.0 * b * hq * hd * pairs, float(nbytes))


def paged_decode_cost(b: int, hq: int, hkv: int, hd: int, itemsize: int, *,
                      block_size: int, valid: int,
                      walked: int) -> KernelCost:
    """q in and out; the K and V of the ``valid`` live entries; the table
    entries and positions of the ``walked`` blocks; pos."""
    nbytes = (2 * b * hq * hd * itemsize          # q in, out
              + valid * hkv * hd * itemsize * 2   # valid K and V entries
              + walked * (block_size + 1) * 4 + b * 4)  # ppos, table, pos
    return KernelCost(4.0 * hq * hd * valid, float(nbytes))


def paged_live_entries(ppos, table, pos, block_size: int):
    """(valid entries, walked blocks) of one paged call from host arrays
    (numpy or CPU tensors): each row walks its table's blocks j <= pos //
    bs and reads the entries whose position lies in [0, pos]."""
    import numpy as np
    ppos, table, pos = (np.asarray(a) for a in (ppos, table, pos))
    nb = table.shape[1]
    valid = walked = 0
    for r in range(table.shape[0]):
        blks = table[r, :min(int(pos[r]) // block_size, nb - 1) + 1]
        valid += int(((ppos[blks] >= 0) & (ppos[blks] <= pos[r])).sum())
        walked += len(blks)
    return valid, walked


def ssd_scan_cost(b: int, s: int, h: int, p: int, n: int, itemsize: int,
                  chunk: int) -> KernelCost:
    """x in and y out, dt and a (fp32), B and C; per chunk C·Bᵀ (shared by
    the heads), then per head the masked product with x, C·state and the
    state update."""
    nbytes = (2 * b * s * h * p * itemsize        # x in, y out
              + b * s * h * 4 + h * 4             # dt, a
              + 2 * b * s * n * itemsize)         # B, C
    q = min(chunk, s)
    flops = 2.0 * b * (s // q) * (q * q * n + h * q * q * p
                                  + 2 * h * q * n * p)
    return KernelCost(flops, float(nbytes))


def rg_lru_cost(b: int, s: int, w: int, itemsize: int) -> KernelCost:
    """log_a (fp32) and b in, h out; exp, product and sum a step."""
    n = b * s * w
    return KernelCost(3.0 * n, float(n * (4 + 2 * itemsize)))


def fused_adamw_cost(n: int, *, rows: int = 0, itemsize: int = 4,
                     grad_itemsize: int = 4) -> KernelCost:
    """p read and written, g read, m and v (fp32) read and written; the
    mask's ``rows`` fp32 entries; 20 operations an element."""
    return KernelCost(20.0 * n,
                      float(n * (2 * itemsize + grad_itemsize + 16)
                            + rows * 4))


def wavg_cost(rows: int, cols: int, itemsize: int) -> KernelCost:
    """The (rows, cols) stack in, the (cols,) average out; a multiply-add
    an element."""
    return KernelCost(2.0 * rows * cols,
                      float(rows * cols * itemsize + cols * itemsize))


def quantize_cost(rows: int, cols: int) -> KernelCost:
    """x and u (fp32) in, int8 codes out, a scale a row."""
    n = rows * cols
    return KernelCost(4.0 * n, 9.0 * n + 4.0 * rows)


def dequantize_cost(rows: int, cols: int) -> KernelCost:
    """int8 codes in, fp32 out, a step a row."""
    n = rows * cols
    return KernelCost(1.0 * n, 5.0 * n + 4.0 * rows)


def topk_mask_cost(rows: int, cols: int) -> KernelCost:
    """x (fp32) in and out, a threshold a row."""
    n = rows * cols
    return KernelCost(2.0 * n, 8.0 * n + 4.0 * rows)
