"""The arithmetic of the two scan kernels' Hopper designs, rehearsed in
plain PyTorch on the CPU and held against the port's plain versions
(``repro_torch.kernels.ref``) and the JAX oracles (``repro.kernels.ref``).

Run as a script, it prints the SSD arithmetic's distance from the plain
version at Mamba-2-370M's prefill shape (B 2, S 4096, H 32, P 64, N 128,
bf16) for each choice of the three fp32 MMA operands (bf16 hi + lo, or
bf16 alone):

    PYTHONPATH=src python tests/test_torch_scan_designs.py

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against the plain versions there).  What is rehearsed here is the order of
their arithmetic:

* SSD scan, bf16 tensor-core body (``csrc/ssd_scan.cu``): C.B^T per
  (batch, 64-position chunk) in fp32 from the exact bf16 inputs (the
  kernel computes it in every CTA, the same values; here once); per
  (batch, head, 32-column slice of P) a sequential loop over the chunks
  with the fp32 state carried across them; per chunk
  y = G.x + exp(cum_i) (C.S) with G[i][j] = CB[i][j] exp(cum_i - cum_j)
  dt_j for j <= i, and S <- exp(cum_end) S + B^T.(w x) with w_q =
  exp(cum_end - cum_q) dt_q; the chunk pass factors G's exp through the
  last positions of the 8-blocks when j's block lies before i's, and in
  i's own block multiplies the per-step decays exp(dt a) as the plain
  recurrence does (each factor at most 1 or dt, however large the decay).  The three fp32
  operands of those products (the state S, G and w x) enter the tensor
  cores in bf16, each either as hi + lo (two products into one fp32 sum)
  or rounded once.  Tolerance: one bf16 ulp at max|y| against the plain
  version and the JAX oracle (both keep fp32 and round y once), and at
  most ``SSD_DIFFERING_MAX`` of the outputs differing from the plain
  version; the emulation's fp32 y within the fp32 band of
  ``chip_smoke.py`` (5e-4 + 1e-3 |y|).
* RG-LRU scan (``csrc/rg_lru.cu``): 32 channels of one batch row per
  CTA, a ring of 64-step stages; the loader threads turn log_a into
  exp(log_a) stage by stage, the chain then rounds one product and one sum
  a step; positions past S and channels past W are zero-filled (exp 1,
  b 0) and never stored.  Tolerance: bit for bit against the plain
  version; the JAX oracle within the repo's scan band (atol = rtol =
  1e-5, as ``tests/test_torch_rglru.py``: XLA may contract the step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.kernels import ref as jref
from repro_torch.kernels import ref

Q = 64                 # the SSD kernel's chunk (QT in the source)
PT = 32                # state columns a CTA
SSD_DIFFERING_MAX = 0.01
FP32_BAND = (5e-4, 1e-3)
RG_CHANNELS, RG_STEPS = 32, 64     # a RG-LRU CTA's channels, a stage's steps
SCAN = dict(atol=1e-5, rtol=1e-5)
HI_LO = dict(state=True, g=True, wx=True)


# ---------------------------------------------------------------------------
# SSD: the tensor-core body's arithmetic
# ---------------------------------------------------------------------------


def _bf16_operand(t, split):
    """An fp32 MMA operand as the tensor cores see it: hi + lo (both bf16,
    summed in fp32 by the two products) or rounded to bf16 once."""
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float() if split else hi


def emulate_ssd_tc(x, dt, a, b_, c_, split=HI_LO, out_fp32=False):
    """The bf16 body's arithmetic: x (B, S, H, P) bf16, dt (B, S, H) fp32,
    a (H,) fp32, b_, c_ (B, S, N) bf16 -> y (B, S, H, P) bf16 (fp32 with
    ``out_fp32``).  ``split`` picks hi + lo (True) or bf16 alone (False)
    for the state, G and w x."""
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    nch = -(-s // Q)
    pad = nch * Q - s

    def padded(t):
        return torch.nn.functional.pad(t.float(), (0,) * (2 * (t.dim() - 2))
                                       + (0, pad))

    # positions past S: x, B, C and dt zero (no decay, no input)
    xp = padded(x).reshape(bsz, nch, Q, h, p)
    dtp = padded(dt).reshape(bsz, nch, Q, h)
    bp = padded(b_).reshape(bsz, nch, Q, n)
    cp = padded(c_).reshape(bsz, nch, Q, n)
    # C.B^T per (batch, chunk): every CTA of the kernel computes the same
    # values, so one product here serves the heads and column slices
    cb = torch.einsum("bcin,bcjn->bcij", cp, bp)
    cum = torch.cumsum(dtp * a.float(), dim=2)                 # (B, nch, Q, H)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    blk = torch.arange(Q) // 8                                  # j's 8-block
    before = blk[None, :] < blk[:, None]                        # (i, j)
    own = (blk[None, :] == blk[:, None]) & mask
    y = torch.empty((bsz, nch, Q, h, p))
    for p0 in range(0, p, PT):                                 # column slices
        cols = slice(p0, min(p0 + PT, p))
        state = torch.zeros((bsz, h, n, cols.stop - p0))
        for c in range(nch):
            xc = xp[:, c, :, :, cols]                          # (B, Q, H, pt)
            cu, d = cum[:, c], dtp[:, c]                       # (B, Q, H)
            inter = torch.einsum("bin,bhnp->bihp", cp[:, c],
                                 _bf16_operand(state, split["state"]))
            inter = inter * torch.exp(cu)[..., None]
            # exp(cum_i - cum_j) dt_j as the chunk pass factors it: for j
            # in an earlier 8-block J than i's block I, alpha_i
            # beta_I-1,J u_j with e(J) the block's last position, alpha_i
            # = exp(cum_i - cum_e(I-1)), beta_KJ = exp(cum_e(K) -
            # cum_e(J)), u_j = exp(cum_e(J) - cum_j) dt_j
            last = cu[:, 7::8]                                 # (B, 8, H)
            u = torch.exp(last[:, blk] - cu) * d               # (B, Q, H)
            prev = last[:, (blk - 1).clamp_min(0)]             # (B, Q, H)
            alpha = torch.exp(cu - prev)
            beta = torch.exp(last[:, :, None, :] - last[:, None, :, :])  # (B, K, J, H)
            v = alpha[:, :, None, :] * beta[:, (blk - 1).clamp_min(0)]   # (B, i, J, H)
            # in i's own block, dt_j times the per-step decays exp(dt_t a)
            # of j < t <= i, multiplied from t = i down
            step = torch.exp(d * a.float())                    # (B, Q, H)
            dm = torch.zeros((bsz, Q, Q, h))
            for i in range(Q):
                run = torch.ones((bsz, h))
                for j in range(i, 8 * (i // 8) - 1, -1):
                    dm[:, i, j] = run * d[:, j]
                    run = run * step[:, j]
            f = torch.where(before[None, :, :, None],
                            v[:, :, blk, :] * u[:, None, :, :],
                            torch.where(own[None, :, :, None], dm,
                                        torch.zeros(())))
            g = cb[:, c, :, :, None] * f
            y[:, c, :, :, cols] = inter + torch.einsum(
                "bijh,bjhp->bihp", _bf16_operand(g, split["g"]), xc)
            w = torch.exp(cu[:, -1:] - cu) * d                 # (B, Q, H)
            wx = _bf16_operand(w[..., None] * xc, split["wx"])
            state = (torch.exp(cu[:, -1])[:, :, None, None] * state
                     + torch.einsum("bqn,bqhp->bhnp", bp[:, c], wx))
    y = y.reshape(bsz, nch * Q, h, p)[:, :s]
    return y if out_fp32 else y.to(x.dtype)


def _ssd_inputs(b, s, h, p, n, seed, dt_hi=0.5):
    """As the Mamba-2 block makes them (and ``chip_smoke._ssd_inputs``):
    x, B, C of unit scale in bf16; dt in [0.01, dt_hi), a in [-16, -1)."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(b, s, h, p)).astype(np.float32))
    dt = torch.as_tensor(rng.uniform(0.01, dt_hi, (b, s, h)).astype(np.float32))
    a = torch.as_tensor(-rng.uniform(1.0, 16.0, (h,)).astype(np.float32))
    bm = torch.as_tensor(rng.normal(size=(b, s, n)).astype(np.float32))
    cm = torch.as_tensor(rng.normal(size=(b, s, n)).astype(np.float32))
    return x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16()


def _jax_ssd(x, dt, a, b_, c_):
    """The JAX oracle on the same bf16 inputs."""
    js = [jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype ==
                      torch.bfloat16 else jnp.float32)
          for t in (x, dt, a, b_, c_)]
    return torch.as_tensor(np.array(jref.ssd_scan(*js).astype(jnp.float32)))


def _ulp_bf16(t):
    mag = t.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _reading(got, want):
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), (got.float() != want.float()).float().mean().item()


# (B, S, H, P, N, dt_hi): S a multiple of the chunk, S ragged (200, 100,
# 1), Mamba-2's P 64 / N 128 (two column slices), the reduced P 32 / N 32;
# dt up to 8 (a step's decay up to e^-128: exp(cum_i - cum_j) spans far
# beyond fp32 within one chunk)
SSD_CASES = [
    (2, 128, 4, 64, 128, 0.5),
    (1, 200, 2, 64, 128, 0.5),
    (2, 256, 4, 32, 32, 0.5),
    (2, 100, 3, 32, 32, 0.5),
    (1, 1, 2, 32, 32, 0.5),
    (1, 192, 4, 64, 128, 8.0),
]


@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_tc_arithmetic_matches_plain_and_jax(case):
    args = _ssd_inputs(*case[:5], seed=sum(case[:5]), dt_hi=case[5])
    got = emulate_ssd_tc(*args)
    plain = ref.ssd_scan(*args)
    for want in (plain, _jax_ssd(*args)):
        err, _ = _reading(got, want)
        assert err <= _ulp_bf16(want)
    assert _reading(got, plain)[1] <= SSD_DIFFERING_MAX
    # before the one rounding: the fp32 band of the fp32 kernel
    got32 = emulate_ssd_tc(*args, out_fp32=True)
    want32 = ref.ssd_scan(*(t.float() if t.dtype == torch.bfloat16 else t
                            for t in args))
    atol, rtol = FP32_BAND
    assert ((got32 - want32).abs() <= atol + rtol * want32.abs()).all()


def test_ssd_bf16_alone_moves_many_more_outputs():
    """Why the three fp32 operands are split: rounding each to bf16 once
    moves far more outputs off the plain version than hi + lo does, and
    lies further from it."""
    args = _ssd_inputs(2, 256, 4, 64, 128, seed=5)
    want = ref.ssd_scan(*args)
    split = _reading(emulate_ssd_tc(*args), want)
    alone = _reading(emulate_ssd_tc(*args, split=dict(state=False, g=False,
                                                      wx=False)), want)
    assert split[0] <= _ulp_bf16(want) and split[0] < alone[0]
    assert split[1] <= SSD_DIFFERING_MAX
    assert alone[1] > 10 * max(split[1], 1e-3)


@pytest.mark.parametrize("operand", ["state", "g", "wx"])
def test_ssd_each_operand_alone_in_bf16_moves_more_outputs(operand):
    """Each of the three operands, rounded to bf16 while the other two stay
    hi + lo, moves more outputs than all three split: none may go alone."""
    args = _ssd_inputs(1, 256, 4, 64, 128, seed=9)
    want = ref.ssd_scan(*args)
    split = _reading(emulate_ssd_tc(*args), want)
    one = _reading(emulate_ssd_tc(*args, split={**HI_LO, operand: False}),
                   want)
    assert one[1] > 2 * max(split[1], 1e-3)


# ---------------------------------------------------------------------------
# RG-LRU: the ring's staging order
# ---------------------------------------------------------------------------


def emulate_rglru_ring(log_a, b):
    """The staged kernel's order: per CTA 32 channels of one batch row; per
    64-step stage the loaders' exp(log_a) over the whole stage, then the
    chain's rounded product and sum a step.  Zero-filled past S and W."""
    bsz, s, w = b.shape
    ws = -(-w // RG_CHANNELS) * RG_CHANNELS
    ss = -(-s // RG_STEPS) * RG_STEPS
    la = torch.zeros((bsz, ss, ws))
    bv = torch.zeros((bsz, ss, ws))
    la[:, :s, :w], bv[:, :s, :w] = log_a.float(), b.float()
    h = torch.zeros((bsz, s, w))
    for c0 in range(0, ws, RG_CHANNELS):                       # the CTAs
        chan = slice(c0, c0 + RG_CHANNELS)
        hc = torch.zeros((bsz, RG_CHANNELS))
        for t0 in range(0, ss, RG_STEPS):                      # the ring
            e = torch.exp(la[:, t0:t0 + RG_STEPS, chan])       # loaders
            for u in range(RG_STEPS):                          # the chain
                hc = e[:, u] * hc + bv[:, t0 + u, chan]
                if t0 + u < s:
                    h[:, t0 + u, c0:min(c0 + RG_CHANNELS, w)] = \
                        hc[:, :min(RG_CHANNELS, w - c0)]
    return h.to(b.dtype)


def _rglru_inputs(b, s, w, dtype, seed):
    """As the gates make them (and ``chip_smoke.check_rglru``): log_a in
    (-0.105, 0), b of scale 0.1."""
    rng = np.random.default_rng(seed)
    log_a = -(rng.uniform(0, 0.105, (b, s, w)) + 1e-5).astype(np.float32)
    bb = (rng.normal(size=(b, s, w)) * 0.1).astype(np.float32)
    return torch.as_tensor(log_a), torch.as_tensor(bb).to(dtype)


# (B, S, W, dtype): whole stages and CTAs; W 1000 (the last CTA 8 of 32
# channels); S 100 (the last stage 36 of 64 steps); bf16 b; S 1
RG_CASES = [
    (2, 128, 64, torch.float32),
    (3, 192, 1000, torch.float32),
    (2, 100, 96, torch.float32),
    (1, 128, 80, torch.bfloat16),
    (2, 1, 40, torch.float32),
]


@pytest.mark.parametrize("case", RG_CASES, ids=[str(c) for c in RG_CASES])
def test_rglru_ring_is_bit_exact(case):
    b, s, w, dtype = case
    log_a, bb = _rglru_inputs(b, s, w, dtype, seed=s + w)
    got = emulate_rglru_ring(log_a, bb)
    assert got.dtype == dtype
    assert torch.equal(got, ref.rg_lru_scan(log_a, bb))
    want = jref.rg_lru_scan(jnp.asarray(log_a.numpy()),
                            jnp.asarray(bb.float().numpy(),
                                        jnp.bfloat16 if dtype == torch.bfloat16
                                        else jnp.float32))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **SCAN)


def main():
    args = _ssd_inputs(2, 4096, 32, 64, 128, seed=31)
    want = ref.ssd_scan(*args)
    print(f"plain max|y| {want.float().abs().max().item():.4f}, one bf16 ulp "
          f"there {_ulp_bf16(want):g}, {want.numel()} outputs")
    choices = [("all three hi + lo", HI_LO),
               ("all three bf16 alone", dict(state=False, g=False, wx=False))]
    choices += [(f"{op} bf16 alone, the others hi + lo", {**HI_LO, op: False})
                for op in ("state", "g", "wx")]
    for name, split in choices:
        err, share = _reading(emulate_ssd_tc(*args, split=split), want)
        print(f"{name}: max|diff| {err:g}, {share:.4%} of outputs differ")


if __name__ == "__main__":
    main()
