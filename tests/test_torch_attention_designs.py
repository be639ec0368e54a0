"""The arithmetic of the two attention kernels' Hopper designs, rehearsed
in plain PyTorch on the CPU and held against the port's plain versions
(``repro_torch.kernels.ref``) and the JAX oracles (``repro.kernels.ref``).

Run as a script, it prints the flash arithmetic's distance from the plain
version at Gemma-2B's serving shape (B 1, S 512, 8 query heads over 1,
hd 256), with P in bf16 and with P_hi + P_lo:

    PYTHONPATH=src python tests/test_torch_attention_designs.py

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against the plain versions there).  What is rehearsed here is the order of
their arithmetic:

* flash, bf16 body (``csrc/flash_attention.cu``): 64-row tiles of
  floor(64 / g) positions x g heads with zero padding rows, 64-key tiles,
  bf16 products summed in fp32, the online softmax per key tile, and P
  split into bf16 P_hi + P_lo for the two P V products.  A head dim that
  is not whole 64-column boxes (StableLM-2-12B's 160) is padded with zero
  columns to whole boxes (192), as TMA fills them: S = Q K^T over the true
  columns, P V over the padded ones, hd columns kept.  Tolerance: one
  bf16 ulp at max|plain| and at most 1% of the bf16 outputs differing
  from the plain version (both round fp32 results once; only the order of
  the fp32 sums and the ~16-bit P differ).
* paged decode, split-K (``csrc/paged_attention.cu``): the wrapper's
  split plan (``paged_attention.split_plan``), the per-split partials
  (m, l, acc) over the split's live blocks and the merge.  Tolerance: fp32
  atol = rtol = 1e-5 (the same fp32 math merged in another order); a row
  with no valid entry is exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import split_plan

BM = BN = 64          # the flash kernel's query-row and key tiles
NEG = -1e30
DIFFERING_MAX = 0.01
FP32 = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# flash: the tensor-core body's arithmetic
# ---------------------------------------------------------------------------


def padded_head_dim(hd):
    """The head dim of the bf16 body's tiles: whole swizzled boxes of 64
    columns (one box of hd below 64), the last one zero-filled past hd."""
    sw = min(hd, 64)
    return -(-hd // sw) * sw


def emulate_flash_tc(q, k, v, *, window=None, softcap=None, split_p=True,
                     padded_out=False):
    """The bf16 body's arithmetic, causal: q (B, S, Hq, hd), k, v
    (B, S, Hkv, hd) bf16 (the model layout) -> (B, S, Hq, hd) bf16.
    ``split_p=False`` rounds P to bf16 once, as the usual kernels do.
    The tiles hold :func:`padded_head_dim` columns, zero past hd;
    ``padded_out`` returns the padded accumulator's columns too."""
    b, s, hq, hd = q.shape
    hdp = padded_head_dim(hd)
    scale = 1.0 / np.sqrt(hd)
    # TMA's zero fill past hd; S = Q K^T steps over the true columns only
    q, k, v = (torch.nn.functional.pad(x, (0, hdp - hd)) for x in (q, k, v))
    hd_true, hd = hd, hdp
    hkv = k.shape[2]
    g = hq // hkv
    tile_pos = BM // g
    rows = tile_pos * g
    n_qt = -(-s // tile_pos)
    # grouped tiles: row r of tile i is position i * tile_pos + r // g,
    # head r % g of its kv head; padding rows and positions >= S are zero
    qp = torch.arange(n_qt)[:, None] * tile_pos + torch.arange(BM)[None] // g
    qp = torch.where(torch.arange(BM)[None] < rows, qp, torch.full_like(qp, s))
    qf = torch.zeros((b, n_qt * tile_pos, hkv, g, hd))
    qf[:, :s] = q.float().reshape(b, s, hkv, g, hd)
    qg = torch.zeros((b, hkv, n_qt, BM, hd))
    qg[:, :, :, :rows] = qf.reshape(b, n_qt, tile_pos, hkv, g, hd).permute(
        0, 3, 1, 2, 4, 5).reshape(b, hkv, n_qt, rows, hd)
    kf = k.float().permute(0, 2, 1, 3)            # (B, Hkv, S, hd)
    vf = v.float().permute(0, 2, 1, 3)
    o = torch.zeros((b, hkv, n_qt, BM, hd))
    m = torch.full((b, hkv, n_qt, BM), NEG)
    l = torch.zeros((b, hkv, n_qt, BM))
    for t in range(-(-s // BN)):
        kp = torch.arange(t * BN, (t + 1) * BN)
        kt = torch.zeros((b, hkv, BN, hd))
        vt = torch.zeros((b, hkv, BN, hd))
        n = min(BN, s - t * BN)
        kt[:, :, :n], vt[:, :, :n] = kf[:, :, t * BN:t * BN + n], \
            vf[:, :, t * BN:t * BN + n]
        # the products of bf16 values are exact in fp32
        z = torch.einsum("bkird,bknd->bkirn", qg[..., :hd_true],
                         kt[..., :hd_true]) * scale
        if softcap is not None:
            z = softcap * torch.tanh(z / softcap)
        ok = (kp < s) & (qp[..., None] < s) & (kp <= qp[..., None])
        if window is not None:
            ok &= (qp[..., None] - kp) < window
        z = torch.where(ok, z, torch.tensor(-np.inf))
        m_new = torch.maximum(m, z.amax(-1).clamp_min(NEG))
        corr = torch.exp(m - m_new)
        p = torch.exp(z - m_new[..., None])
        l = l * corr + p.sum(-1)
        m = m_new
        o = o * corr[..., None]
        hi = p.bfloat16().float()
        if split_p:
            lo = (p - hi).bfloat16().float()
            o = o + hi @ vt[:, :, None] + lo @ vt[:, :, None]
        else:
            o = o + hi @ vt[:, :, None]
    o = (o / l.clamp_min(1e-30)[..., None]).bfloat16()
    o = o[:, :, :, :rows].reshape(b, hkv, n_qt, tile_pos, g, hd)
    o = o.permute(0, 2, 3, 1, 4, 5).reshape(b, n_qt * tile_pos, hq, hd)[:, :s]
    return o if padded_out else o[..., :hd_true]


def _bf16_inputs(b, hq, hkv, s, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=(b, s, h, hd)).astype(np.float32)
                            ).bfloat16() for h in (hq, hkv, hkv)]


def _plain_flash(q, k, v, **kw):
    """The port's plain version in the model layout."""
    return ref.flash_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                               **kw).transpose(1, 2)


def _jax_flash(q, k, v, **kw):
    """The JAX oracle on the same bf16 inputs, in the model layout."""
    js = [jnp.asarray(x.float().transpose(1, 2).numpy(), jnp.bfloat16)
          for x in (q, k, v)]
    out = np.array(jref.flash_attention(*js, **kw).astype(jnp.float32))
    return torch.as_tensor(out).transpose(1, 2)


def _ulp_bf16(t):
    mag = t.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# (B, Hq, Hkv, S, hd, window, softcap): Gemma's g 8, RecurrentGemma's g 10
# with a window, ragged S (397, 200), a softcap, a GQA pair of kv heads;
# StableLM-2-12B's 32 over 8 heads at hd 160 (padded to 192; S 131 leaves
# the last 16-position tile 3 positions) and Qwen2.5-32B's 40 over 8 at hd
# 128 (g 5: a tile holds 12 positions and 4 padding rows)
FLASH_CASES = [
    (1, 8, 1, 397, 32, None, None),
    (2, 8, 1, 200, 64, 48, 30.0),
    (1, 10, 1, 397, 32, 100, None),
    (2, 10, 1, 200, 32, None, 20.0),
    (1, 8, 2, 130, 64, None, None),
    (1, 32, 8, 131, 160, None, None),
    (1, 40, 8, 125, 128, None, None),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_tc_arithmetic_matches_plain_and_jax(case):
    b, hq, hkv, s, hd, window, cap = case
    q, k, v = _bf16_inputs(b, hq, hkv, s, hd, seed=s + hq)
    got = emulate_flash_tc(q, k, v, window=window, softcap=cap)
    for want in (_plain_flash(q, k, v, window=window, logit_softcap=cap),
                 _jax_flash(q, k, v, window=window, logit_softcap=cap)):
        diff = (got.float() - want.float()).abs()
        assert diff.max().item() <= _ulp_bf16(want)
        assert (got.float() != want.float()).float().mean().item() \
            <= DIFFERING_MAX


def test_flash_tc_padding_rows_and_ragged_edge_are_inert():
    """g = 10 packs 60 of 64 rows; S = 61 leaves the last tile 1 position
    and the last key tile 61 keys: every stored output is the plain
    version's within one ulp, and no padding row reaches an output."""
    q, k, v = _bf16_inputs(1, 10, 1, 61, 32, seed=7)
    got = emulate_flash_tc(q, k, v)
    want = _plain_flash(q, k, v)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= _ulp_bf16(want)


def test_flash_tc_padded_head_dim_is_exact_zero_past_hd():
    """hd 160 in tiles of 192: the zero-filled columns of V leave the
    accumulator's padded columns exactly 0, and the 160 stored columns
    are the plain version's within one ulp, at most 1% differing."""
    assert [padded_head_dim(h) for h in (32, 64, 128, 160, 256)] == \
        [32, 64, 128, 192, 256]
    q, k, v = _bf16_inputs(1, 32, 8, 70, 160, seed=13)
    got = emulate_flash_tc(q, k, v, padded_out=True)
    assert got.shape[-1] == 192
    assert torch.count_nonzero(got[..., 160:]) == 0
    want = _plain_flash(q, k, v)
    kept = got[..., :160].float()
    assert (kept - want.float()).abs().max().item() <= _ulp_bf16(want)
    assert (kept != want.float()).float().mean().item() <= DIFFERING_MAX


def test_flash_bf16_p_alone_moves_many_more_outputs():
    """Why P is split: rounding P to bf16 once moves far more outputs off
    the plain version than P_hi + P_lo does."""
    q, k, v = _bf16_inputs(1, 8, 1, 256, 64, seed=11)
    want = _plain_flash(q, k, v)
    share = {split: (emulate_flash_tc(q, k, v, split_p=split).float()
                     != want.float()).float().mean().item()
             for split in (True, False)}
    assert share[True] <= DIFFERING_MAX
    assert share[False] > 10 * max(share[True], 1e-3)


# ---------------------------------------------------------------------------
# paged decode: the split plan, the partials and the merge
# ---------------------------------------------------------------------------


def split_runs(pos, b, hkv, nb, bs):
    """Per row, per split: the logical blocks the split CTA reads, as the
    kernel chooses them (its run of ``bps`` blocks cut at pos // bs)."""
    splits, bps = split_plan(b, hkv, nb, bs)
    runs = []
    for p in pos:
        jmax = -1 if p < 0 else min(int(p) // bs, nb - 1)
        row = []
        for sp in range(splits):
            j0 = sp * bps
            n_blk = min(j0 + bps - 1, jmax) - j0 + 1
            row.append(list(range(j0, j0 + max(n_blk, 0))))
        runs.append(row)
    return runs


@pytest.mark.parametrize("b,hkv,nb,bs", [(8, 1, 37, 16), (1, 1, 37, 16),
                                         (4, 2, 5, 8), (64, 1, 100, 16),
                                         (3, 1, 7, 1), (2, 4, 260, 4)])
def test_split_plan_covers_each_live_block_once(b, hkv, nb, bs):
    splits, bps = split_plan(b, hkv, nb, bs)
    assert 1 <= bps <= nb and (splits - 1) * bps < nb <= splits * bps
    assert bps * bs >= min(16, nb * bs)
    for p in range(-1, nb * bs):
        jmax = -1 if p < 0 else p // bs
        read = [j for run in split_runs([p], b, hkv, nb, bs)[0] for j in run]
        assert sorted(read) == list(range(jmax + 1))   # once each, none past


def test_split_plan_fills_the_card_at_the_serving_shape():
    splits, bps = split_plan(8, 1, 37, 16)
    assert (splits, bps) == (37, 1)
    assert splits * 8 * 1 >= 2 * 132         # two CTAs on each SM


def emulate_paged_split(q, pk, pv, ppos, table, pos, *, softcap=None):
    """The split-K design in plain PyTorch, fp32: per (row, kv head, split)
    the partial (m, l, acc) of the split's live blocks, block by block with
    the online softmax; then the merge, rounding once."""
    b, hq, hd = q.shape
    _, bs, hkv, _ = pk.shape
    nb = table.shape[1]
    g = hq // hkv
    scale = 1.0 / np.sqrt(hd)
    runs = split_runs(pos.tolist(), b, hkv, nb, bs)
    out = torch.empty((b, hq, hd), dtype=torch.float32)
    for r in range(b):
        for kh in range(hkv):
            qh = q[r, kh * g:(kh + 1) * g].float()
            parts = []
            for run in runs[r]:
                m = torch.full((g,), NEG)
                l = torch.zeros(g)
                acc = torch.zeros((g, hd))
                for j in run:                  # a split wholly past pos: []
                    phys = int(table[r, j])
                    kb = pk[phys, :, kh].float()
                    vb = pv[phys, :, kh].float()
                    z = (qh @ kb.T) * scale
                    if softcap is not None:
                        z = softcap * torch.tanh(z / softcap)
                    pp = ppos[phys]
                    ok = (pp >= 0) & (pp <= int(pos[r]))
                    z = torch.where(ok[None], z, torch.tensor(-np.inf))
                    m_new = torch.maximum(m, z.amax(-1).clamp_min(NEG))
                    corr = torch.exp(m - m_new)
                    p = torch.exp(z - m_new[:, None])
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[:, None] + p @ vb
                    m = m_new
                parts.append((m, l, acc))
            ms = torch.stack([p[0] for p in parts])
            mx = ms.amax(0)
            w = torch.exp(ms - mx)
            lt = (torch.stack([p[1] for p in parts]) * w).sum(0)
            at = (torch.stack([p[2] for p in parts]) * w[..., None]).sum(0)
            out[r, kh * g:(kh + 1) * g] = at / lt.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _paged_case(seed, *, b, hq, hkv, hd, bs, nb, pos, dead=()):
    """Pool blocks dealt to rows through a random permutation; row r's
    entries hold their logical positions up to pos[r]; rows in ``dead``
    hold none."""
    rng = np.random.default_rng(seed)
    n_blocks = b * nb + 2
    table = rng.permutation(n_blocks)[:b * nb].reshape(b, nb).astype(np.int32)
    ppos = np.full((n_blocks, bs), -1, np.int32)
    for r in range(b):
        if r in dead:
            continue
        flat = np.arange(nb * bs)
        ppos[table[r]] = np.where(flat <= pos[r], flat, -1).reshape(nb, bs)
    arrays = (rng.normal(size=(b, hq, hd)), rng.normal(size=(n_blocks, bs, hkv, hd)),
              rng.normal(size=(n_blocks, bs, hkv, hd)))
    q, pk, pv = (torch.as_tensor(a.astype(np.float32)) for a in arrays)
    return (q, pk, pv, torch.as_tensor(ppos), torch.as_tensor(table),
            torch.as_tensor(np.asarray(pos, np.int32)))


# (name, kwargs): a dead row; short rows (most splits wholly past pos);
# pos on a block boundary; pos < 0; one row; GQA with a softcap
PAGED_CASES = [
    ("dead_row", dict(b=4, hq=4, hkv=1, hd=32, bs=8, nb=9,
                      pos=[40, 65, 17, 71], dead=(1,))),
    ("short_rows", dict(b=3, hq=8, hkv=1, hd=32, bs=16, nb=37,
                        pos=[3, 20, 47])),
    ("block_boundary", dict(b=2, hq=4, hkv=1, hd=16, bs=8, nb=6,
                            pos=[16, 40])),
    ("pos_negative", dict(b=3, hq=4, hkv=1, hd=16, bs=4, nb=5,
                          pos=[-1, 7, 19])),
    ("one_row", dict(b=1, hq=8, hkv=1, hd=32, bs=16, nb=37, pos=[160])),
    ("gqa_softcap", dict(b=2, hq=8, hkv=2, hd=16, bs=4, nb=12,
                         pos=[30, 47], softcap=20.0)),
]


@pytest.mark.parametrize("name,kw", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_split_merge_matches_plain_and_jax(name, kw):
    kw = dict(kw)
    softcap = kw.pop("softcap", None)
    args = _paged_case(len(name), **kw)
    got = emulate_paged_split(*args, softcap=softcap)
    want = ref.paged_decode_attention(*args, logit_softcap=softcap)
    jwant = np.asarray(jref.paged_decode_attention(
        *(jnp.asarray(a.numpy()) for a in args), logit_softcap=softcap))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FP32)
    np.testing.assert_allclose(got.numpy(), jwant, **FP32)
    pos = kw["pos"]
    for r in range(kw["b"]):
        if pos[r] < 0 or r in kw.get("dead", ()):
            assert torch.count_nonzero(got[r]) == 0   # exactly 0
    if name == "short_rows":
        # most of the 37 splits of every row lie wholly past pos: neutral
        runs = split_runs(pos, kw["b"], kw["hkv"], kw["nb"], kw["bs"])
        assert sum(not run for row in runs for run in row) > 0.9 * 3 * 37


def test_paged_split_merge_bf16_rounds_once():
    args = _paged_case(5, b=2, hq=8, hkv=1, hd=32, bs=16, nb=10,
                       pos=[90, 159])
    q, pk, pv = (a.bfloat16() for a in args[:3])
    got = emulate_paged_split(q, pk, pv, *args[3:])
    want = ref.paged_decode_attention(q, pk, pv, *args[3:])
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= _ulp_bf16(want)


def main():
    q, k, v = _bf16_inputs(1, 8, 1, 512, 256, seed=6)
    want = _plain_flash(q, k, v)
    print(f"plain max|out| {want.float().abs().max().item():.4f}, one bf16 "
          f"ulp there {_ulp_bf16(want):g}")
    for split, name in ((False, "P in bf16"), (True, "P_hi + P_lo")):
        got = emulate_flash_tc(q, k, v, split_p=split).float()
        print(f"{name}: max|diff| {(got - want.float()).abs().max().item():g}, "
              f"{(got != want.float()).float().mean().item():.4%} of "
              f"{got.numel()} outputs differ")


if __name__ == "__main__":
    main()
