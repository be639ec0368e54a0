"""The port's plain kernel versions against ``repro.kernels.ref``, and the
dispatch by device.

The CUDA kernels themselves run only on the card and are held against these
plain versions by ``chip_smoke.py``; here the CPU dispatch must take the
plain version and the CUDA-only wrappers must refuse CPU tensors.
Tolerance: fp32 atol = rtol = 1e-4 (same fp32 math on both sides; the
softmax sums in another order); the bf16 case atol = rtol = 5e-2 (outputs
rounded to bf16).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_fallback import given, settings, st
from _torch_threads import one_torch_thread  # noqa: F401
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

FP32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=5e-2, rtol=5e-2)
NO_LAUNCHES = {"flash_attention": 0, "paged_decode_attention": 0,
               "ssd_scan": 0, "rg_lru_scan": 0, "fused_adamw": 0,
               "weighted_average": 0, "quantize_stochastic": 0,
               "dequantize": 0, "topk_mask": 0}


def _flash_inputs(b, hq, hkv, s, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, s, hd)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    return q, k, v


# (B, Hq, Hkv, S, hd, window, softcap): MQA as in Gemma, ragged S, GQA,
# window + softcap, MHA, RecurrentGemma's 10 heads over 1 with a window,
# StableLM-2-12B's head dim 160 at g 4, Qwen2.5-32B's g 5
FLASH_CASES = [
    (2, 4, 1, 32, 16, None, None),
    (1, 8, 1, 45, 32, None, None),
    (1, 4, 2, 37, 32, 8, 30.0),
    (2, 2, 2, 13, 16, None, 5.0),
    (2, 10, 1, 50, 16, 16, None),
    (1, 8, 2, 41, 160, None, None),
    (1, 10, 2, 29, 128, None, None),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_flash_matches_jax_ref(case):
    b, hq, hkv, s, hd, window, cap = case
    q, k, v = _flash_inputs(b, hq, hkv, s, hd, seed=s)
    want = np.asarray(jref.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, logit_softcap=cap))
    got = ref.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), causal=True, window=window,
                              logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_plain_flash_bf16_matches_jax_ref():
    q, k, v = _flash_inputs(1, 8, 1, 40, 32, seed=3)
    want = np.asarray(jref.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))).astype(jnp.float32))
    got = ref.flash_attention(*(torch.as_tensor(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def _paged_inputs(seed, b=4, hq=4, hkv=1, hd=32, bs=8, nb=5):
    """A pool whose blocks are dealt to rows through a random permutation;
    each row's entries hold their logical positions up to pos[b], the rest
    are empty.  Row 0 sits on a block boundary, row 1 is all-empty."""
    rng = np.random.default_rng(seed)
    n_blocks = b * nb + 3
    perm = rng.permutation(n_blocks)[:b * nb].reshape(b, nb).astype(np.int32)
    pos = rng.integers(0, nb * bs, size=(b,)).astype(np.int32)
    pos[0] = 2 * bs                       # first entry of a new block
    pk = rng.normal(size=(n_blocks, bs, hkv, hd)).astype(np.float32)
    pv = rng.normal(size=(n_blocks, bs, hkv, hd)).astype(np.float32)
    ppos = np.full((n_blocks, bs), -1, np.int32)
    for r in range(b):
        if r == 1:
            continue                      # no valid entry at all
        for j in range(nb):
            for t in range(bs):
                if j * bs + t <= pos[r]:
                    ppos[perm[r, j], t] = j * bs + t
    q = rng.normal(size=(b, hq, hd)).astype(np.float32)
    return q, pk, pv, ppos, perm, pos


@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_paged_matches_jax_ref(seed, softcap):
    args = _paged_inputs(seed, hq=4, hkv=2 if seed else 1)
    want = np.asarray(jref.paged_decode_attention(
        *(jnp.asarray(a) for a in args), logit_softcap=softcap))
    got = ref.paged_decode_attention(*(torch.as_tensor(a) for a in args),
                                     logit_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       bs=st.sampled_from([1, 3, 8, 16]), nb=st.integers(1, 6))
def test_plain_paged_is_blind_to_which_pool_blocks_a_row_holds(seed, bs, nb):
    """Dealing the same logical blocks to other physical blocks (a new
    permutation, same contents) leaves every output bit-identical."""
    q, pk, pv, ppos, table, pos = _paged_inputs(seed, bs=bs, nb=nb)
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(pk.shape[0])             # old block -> new block
    inv = np.argsort(perm)
    moved = (pk[inv], pv[inv], ppos[inv], perm[table].astype(np.int32))
    a = ref.paged_decode_attention(*(torch.as_tensor(x) for x in
                                     (q, pk, pv, ppos, table, pos)))
    b = ref.paged_decode_attention(
        torch.as_tensor(q), *(torch.as_tensor(x) for x in moved),
        torch.as_tensor(pos))
    assert torch.equal(a, b)


def test_plain_paged_all_invalid_row_is_exactly_zero():
    args = _paged_inputs(2)
    got = ref.paged_decode_attention(*(torch.as_tensor(a) for a in args))
    assert torch.count_nonzero(got[1]) == 0
    assert torch.count_nonzero(got[0]) > 0


def test_cpu_dispatch_takes_plain_version_and_launches_nothing():
    ops.reset_launch_counts()
    q, k, v = _flash_inputs(1, 4, 1, 21, 16, seed=5)
    qt, kt, vt = (torch.as_tensor(a).transpose(1, 2).contiguous()
                  for a in (q, k, v))                  # model layout
    got = ops.flash_attention(qt, kt, vt, window=6)
    want = ref.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                               window=6).transpose(1, 2)
    assert torch.equal(got, want)
    args = [torch.as_tensor(a) for a in _paged_inputs(3)]
    assert torch.equal(ops.paged_decode_attention(*args),
                       ref.paged_decode_attention(*args))
    x, w = torch.randn(3, 5), torch.tensor([0.2, 0.3, 0.5])
    assert torch.equal(ops.weighted_average(x, w),
                       ref.weighted_average_2d(x, w))
    p, m = torch.randn(3, 5), torch.zeros(3, 5)
    ops.fused_adamw(p, torch.randn(3, 5), m, m.clone(), w,
                    torch.tensor([1e-3, 0.9, 0.95, 0.1, 0.05, 1e-8, 0.0,
                                  0.1, 0.05]))
    x, dt = torch.randn(1, 8, 2, 4), torch.rand(1, 8, 2)
    a, bc = -torch.rand(2), torch.randn(1, 8, 3)
    assert torch.equal(ops.ssd_scan(x, dt, a, bc, bc, chunk=4, block_h=2),
                       ref.ssd_scan(x, dt, a, bc, bc))
    la, b = -torch.rand(2, 8, 6), torch.randn(2, 8, 6)
    assert torch.equal(ops.rg_lru_scan(la, b, chunk=4, block_w=3),
                       ref.rg_lru_scan(la, b))
    assert ops.launch_counts() == NO_LAUNCHES


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bshd(q, q[:, :, :1].contiguous(),
                                q[:, :, :1].contiguous())
    # any whole query-head group up to the 64-row tile (10 for
    # RecurrentGemma) gets as far as the device check; 65 does not
    q10, k1 = torch.zeros(1, 8, 10, 32), torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bshd(q10, k1, k1)
    with pytest.raises(ValueError, match="group size"):
        fa.flash_attention_bshd(torch.zeros(1, 8, 65, 32), k1, k1)
    args = [torch.as_tensor(a) for a in _paged_inputs(4)]
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode_attention(*args)
    assert ops.launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("hd,ok", [(32, True), (64, True), (128, True),
                                   (160, True), (256, True), (96, False),
                                   (192, False)])
def test_flash_wrapper_head_dims(hd, ok):
    """The CUDA source is built for head dims 32, 64, 128, 160 (StableLM-
    2-12B's, padded to 192 in the tensor-core tiles) and 256: those get as
    far as the device check, any other is refused by name."""
    q, k = torch.zeros(1, 4, 8, hd), torch.zeros(1, 4, 2, hd)
    with pytest.raises(ValueError, match="CUDA" if ok else "head_dim"):
        fa.flash_attention_bshd(q, k, k)
    assert ops.launch_counts() == NO_LAUNCHES


def test_dispatch_refuses_other_devices():
    # the meta device takes the plain version's shape (the dry run);
    # any device other than the CPU, the card and meta raises
    q = torch.zeros(1, 8, 4, 16, device="meta")
    out = ops.flash_attention(q, q, q)
    assert out.is_meta and out.shape == q.shape
    other = types.SimpleNamespace(shape=q.shape, is_meta=False,
                                  device=torch.device("xla"))
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(other, other, other)
