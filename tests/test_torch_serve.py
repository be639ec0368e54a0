"""The port's serving engine and router against the JAX package's, at the
reduced Gemma-2B size in fp32, on the same params and the same requests.

Greedy tokens must be equal exactly: both sides compute the same fp32
logits to ~1e-6 (see test_torch_model.py), far inside the top-2 margins
of these inputs.  Latencies and tick counts come from the same host-side
scheduling and must be equal exactly too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import transformer as jtf
from repro.serve import DecodeEngine as JaxEngine
from repro.serve import FaultRoutedServer as JaxServer
from repro.serve import ServeParams as JaxServeParams
from repro.serve import synthetic_requests as jax_requests
from repro_torch._bridge import params_from_jax
from repro_torch.config import get_arch, reduced
from repro_torch.data.synthetic import make_token_stream
from repro_torch.serve import (DecodeEngine, FaultRoutedServer, ServeParams,
                               synthetic_requests)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_arch("gemma-2b"))
    cfg = reduced(get_arch("gemma-2b"))
    jp, _ = jtf.init_params(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, tp, jp


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_generate_greedy_matches_jax_engine(model, impl):
    cfg, jcfg, tp, jp = model
    prompts = make_token_stream(3, 12, cfg.vocab_size, seed=4)
    want = np.asarray(JaxEngine(jcfg, impl="dense").generate(jp, prompts, 6))
    eng = DecodeEngine(cfg, impl=impl, device="cpu")
    got = eng.generate(tp, prompts, 6)
    np.testing.assert_array_equal(got, want)
    eng.generate(tp, prompts, 6)                 # same shapes: no new key
    assert (eng.prefill_compiles, eng.decode_compiles) == (1, 1)


PAGED = dict(replicas=2, slots=2, chunk=4, max_len=40, block_size=8)


@pytest.fixture(scope="module")
def jax_paged_report(model):
    """The JAX router on four mixed-length requests, paged (gather)."""
    _, jcfg, _, jp = model
    return JaxServer(JaxEngine(jcfg, impl="dense"), jp,
                     JaxServeParams(**PAGED)).run(
        jax_requests(jcfg, 4, prompt_len=20, gen=10, seed=1))


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_router_outputs_match_jax_router(model, jax_paged_report,
                                         paged_kernel):
    """Four mixed-length requests, two replicas of two slots, paged KV with
    block size 8, clean scenario."""
    cfg, jcfg, tp, jp = model
    kw = PAGED
    reqs = synthetic_requests(cfg, 4, prompt_len=20, gen=10, seed=1)
    for a, b in zip(reqs, jax_requests(jcfg, 4, prompt_len=20, gen=10,
                                       seed=1)):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.max_new == b.max_new
    want = jax_paged_report
    engine = DecodeEngine(cfg, impl="kernel", paged_kernel=paged_kernel,
                          device="cpu")
    got = FaultRoutedServer(engine, tp, ServeParams(**kw)).run(reqs)
    assert got.unfinished == 0 and want.unfinished == 0
    assert got.outputs == want.outputs
    assert got.latencies == want.latencies
    assert (got.ticks, got.sim_time) == (want.ticks, want.sim_time)
    assert got.log.summary() == want.log.summary()


def test_router_contiguous_matches_jax_router(model):
    cfg, jcfg, tp, jp = model
    kw = dict(replicas=1, slots=2, chunk=4, max_len=36)
    want = JaxServer(JaxEngine(jcfg, impl="dense"), jp,
                     JaxServeParams(**kw)).run(
        jax_requests(jcfg, 3, prompt_len=16, gen=8, seed=2))
    got = FaultRoutedServer(DecodeEngine(cfg, device="cpu"), tp,
                            ServeParams(**kw)).run(
        synthetic_requests(cfg, 3, prompt_len=16, gen=8, seed=2))
    assert got.outputs == want.outputs
    assert got.latencies == want.latencies


def test_unported_engine_modes_raise(model):
    cfg, _, tp, _ = model
    with pytest.raises(ValueError, match="unknown attn impl"):
        DecodeEngine(cfg, impl="chunked", device="cpu")


def test_released_slot_decodes_past_max_len_without_touching_others(model):
    """A released slot keeps decoding garbage from its old position, which
    runs past the cache length; its writes wrap inside its own row and the
    live slot's tokens stay those of a solo generation."""
    cfg, _, tp, _ = model
    eng = DecodeEngine(cfg, device="cpu")
    prompt = make_token_stream(1, 3, cfg.vocab_size, seed=7)[0]
    state = eng.new_batch_state(2, 16)
    state.pos[1] = 14
    first = eng.admit(state, tp, prompt, 0)
    toks = eng.decode_chunk(state, tp, np.zeros((2, 6), np.int32),
                            np.zeros((2,), np.int32))
    solo = eng.generate(tp, prompt[None], 7)[0]
    assert [first] + toks[0].tolist() == solo.tolist()
    assert int(state.pos[1]) == 20


def test_temperature_sampling_draws_from_the_given_generator(model):
    cfg, _, tp, _ = model
    eng = DecodeEngine(cfg, device="cpu")
    prompts = make_token_stream(2, 5, cfg.vocab_size, seed=8)
    with pytest.raises(ValueError, match="Generator"):
        eng.generate(tp, prompts, 4, temperature=1.0)
    runs = [eng.generate(tp, prompts, 6, temperature=2.0,
                         generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].shape == (2, 6) and (runs[0] < cfg.vocab_size).all()
    assert not np.array_equal(runs[0][:, 1:], runs[2][:, 1:])


def test_generate_bf16_matches_jax_engine_within_the_band(model):
    """bf16 greedy generation against the JAX engine: tokens must agree
    up to the first step whose JAX top-2 logit margin is within twice the
    bf16 logit band (atol = rtol = 5e-2, see test_torch_model.py); past
    such a step the two sequences may legitimately part."""
    _, _, _, jp = model
    jcfg = jax_reduced(jax_get_arch("gemma-2b")).replace(dtype="bfloat16")
    cfg = reduced(get_arch("gemma-2b")).replace(dtype="bfloat16")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    prompts = make_token_stream(2, 10, cfg.vocab_size, seed=9)
    want = np.asarray(JaxEngine(jcfg, impl="dense").generate(jp, prompts, 6))
    got = DecodeEngine(cfg, impl="kernel", device="cpu").generate(
        tp, prompts, 6)
    for row in range(2):
        for t in range(6):
            if got[row, t] == want[row, t]:
                continue
            ctx = np.concatenate([prompts[row], want[row, :t]])[None]
            lg, _ = jtf.prefill(jp, jcfg, jnp.asarray(ctx), impl="dense")
            top2 = np.sort(np.asarray(lg, np.float32)[0, -1])[-2:]
            band = 5e-2 * (1 + abs(top2[1]))
            assert top2[1] - top2[0] <= 2 * band, (row, t)
            break
