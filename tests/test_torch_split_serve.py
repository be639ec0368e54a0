"""Split-mode serving in the port: the decode step through the client ->
edge -> server stages at the WSSL cuts (``transformer.stage_decode_step``,
``split_decode_step``, ``partition_cache``), the engine's ``cuts`` and the
router's hop accounting, against the merged model and the JAX package.

Split decoding runs the same layers in the same order as the merged step,
so the port's split tokens equal its merged tokens exactly; its split
logits are held to the JAX package's ``split_decode_step`` within the fp32
band of test_torch_model.py (atol = rtol = 1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
import repro.serve as jserve
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import transformer as jtf
from repro_torch._bridge import params_from_jax
from repro_torch.config import get_arch, reduced
from repro_torch.models import transformer as tf
from repro_torch.serve import (DecodeEngine, FaultRoutedServer, PendingWork,
                               Request, ServeParams)
from repro_torch.sim import get_scenario

FP32 = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = jax_reduced(jax_get_arch(arch))
    cfg = reduced(get_arch(arch))
    jp, _ = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, tp, jp


# every family, one hop and two (an embedding-only client, cut 0, too)
SPLITS = [("gemma3-12b", (0,)), ("gemma3-12b", (0, 2)),
          ("mamba2-370m", (1,)), ("mamba2-370m", (0, 1, 2)),
          ("recurrentgemma-2b", (0, 2))]


def test_partition_cache_hands_out_views():
    cfg, _, _, _ = _model("mamba2-370m")
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    stages = tf.partition_cache(cache, cfg, (1,))
    assert len(stages) == 2 and "rem" in stages[1]
    stages[1]["stack"][0]["state"].fill_(3.0)
    assert float(cache["stack"][0]["state"][1:].min()) == 3.0
    assert float(cache["stack"][0]["state"][0].abs().max()) == 0.0
    joined = tf.join_cache_stages(stages)
    for d, j in zip(cache["stack"], joined["stack"]):
        for key in d:
            assert torch.equal(d[key], j[key])
            assert j[key].data_ptr() != d[key].data_ptr()


@pytest.mark.parametrize("arch,cuts", SPLITS)
def test_split_generate_equals_merged(arch, cuts):
    cfg, _, tp, _ = _model(arch)
    rng = np.random.default_rng(5)
    s = 32 if arch == "mamba2-370m" else 70     # past the reduced window
    prompts = rng.integers(0, cfg.vocab_size, size=(2, s))
    split = DecodeEngine(cfg, cuts=cuts, device="cpu")
    assert split.num_hops == len(cuts) and split.num_stages == len(cuts) + 1
    assert split.spec_cut == cuts[0]
    np.testing.assert_array_equal(
        split.generate(tp, prompts, 8),
        DecodeEngine(cfg, device="cpu").generate(tp, prompts, 8))


@pytest.mark.parametrize("arch,cuts", [("gemma3-12b", (0, 2)),
                                       ("mamba2-370m", (1,))])
def test_split_decode_step_logits_match_jax(arch, cuts):
    """Prefill the same prompt, then three split decode steps on both
    sides: fp32 logits within 1e-4."""
    cfg, jcfg, tp, jp = _model(arch)
    rng = np.random.default_rng(6)
    s = 32 if arch == "mamba2-370m" else 70
    toks = rng.integers(0, cfg.vocab_size, size=(2, s)).astype(np.int32)
    max_len = s + 4
    # the JAX side jitted: one compile each, where run eagerly every op
    # would compile on its own first use
    jl, jc = jax.jit(lambda p, t: jtf.prefill(p, jcfg, t, max_len=max_len,
                                              impl="dense"))(jp, toks)
    cache = tf.init_cache(cfg, 2, max_len, device="cpu")
    tl, _ = tf.prefill(tp, cfg, torch.as_tensor(toks), cache=cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
    jstages = jtf.partition_params(jp, jcfg, cuts)
    jcs = jtf.partition_cache(jc, jcfg, cuts)
    tstages = tf.partition_params(tp, cfg, cuts, copy=False)
    tcs = tf.partition_cache(cache, cfg, cuts)
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    jstep = jax.jit(lambda st, t, c, pos: jtf.split_decode_step(
        st, jcfg, t, c, pos))
    for t in range(3):
        pos = np.full((2,), s + t, np.int32)
        jlg, jcs = jstep(jstages, tok, jcs, pos)
        tlg, _ = tf.split_decode_step(tstages, cfg, torch.as_tensor(tok), tcs,
                                      torch.as_tensor(pos))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **FP32)
        tok = np.argmax(np.asarray(jlg)[:, 0], -1).astype(np.int32)[:, None]


def _requests(cfg, lens, gens, n=6, seed=11):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=lens[i % len(lens)]),
                    max_new=gens[i % len(gens)]) for i in range(n)]


def test_split_serving_report_equals_jax():
    """The router in split mode against the JAX router (clean scenario):
    the same tokens, the same hop bytes in every log tick."""
    cfg, jcfg, tp, jp = _model("mamba2-370m")
    reqs = _requests(cfg, [8, 12, 10], [4, 6, 5])
    kw = dict(replicas=2, slots=2, chunk=4, max_len=32, seed=3)
    want = jserve.FaultRoutedServer(
        jserve.DecodeEngine(jcfg, impl="dense", cuts=(cfg.period,)), jp,
        jserve.ServeParams(**kw)).run(reqs)
    got = FaultRoutedServer(DecodeEngine(cfg, cuts=(cfg.period,),
                                         device="cpu"), tp,
                            ServeParams(**kw)).run(reqs)
    assert got.outputs == want.outputs
    assert got.latencies == want.latencies
    assert [t.bytes_per_hop for t in got.log.ticks] == [
        t.bytes_per_hop for t in want.log.ticks]
    assert got.log.summary() == want.log.summary()
    assert got.log.summary()["hop0_MB"] > 0.0 and got.log.num_hops == 1


def test_split_paged_speculative_serving_under_replica_drop_equals_merged():
    """Two hops, paged KV through the kernel wrapper (its plain version on
    the CPU), rings that wrap, speculation drafting at cuts[0], replica
    drops: the merged clean run's tokens."""
    cfg, _, tp, _ = _model("gemma3-12b")
    reqs = _requests(cfg, [70, 76, 66], [6, 8, 5])
    kw = dict(replicas=2, slots=2, chunk=4, max_len=96, seed=3,
              block_size=16)
    merged = FaultRoutedServer(DecodeEngine(cfg, device="cpu"), tp,
                               ServeParams(**kw)).run(reqs)
    split = FaultRoutedServer(
        DecodeEngine(cfg, cuts=(0, 2), impl="kernel", paged_kernel=True,
                     device="cpu"), tp,
        ServeParams(**kw, speculate=True, draft_k=4),
        scenario=get_scenario("replica-drop")).run(reqs)
    assert split.outputs == merged.outputs
    assert split.reroutes > 0 and split.spec_rounds > 0
    assert split.log.num_hops == 2


def test_replayed_final_chunk_logs_hop_bytes():
    """A final chunk whose slots all finish by replay credits no token and
    empties every slot, but it still crossed the wire."""
    cfg, _, tp, _ = _model("mamba2-370m")
    eng = DecodeEngine(cfg, cuts=(cfg.period,), device="cpu")
    prompt = np.arange(1, 7) % cfg.vocab_size
    sp = ServeParams(replicas=1, slots=1, chunk=4, max_len=32)
    pre = FaultRoutedServer(eng, tp, sp).run(
        [Request(rid=0, prompt=prompt, max_new=5)])
    done = list(pre.outputs[0])
    assert len(done) == 5
    work = PendingWork(Request(rid=0, prompt=prompt, max_new=5), done=done)
    rep = FaultRoutedServer(eng, tp, sp).run([], preloaded=[(0, work)])
    t0 = rep.log.ticks[0]
    assert t0.tokens == 0
    want = (1 * 4 + len(prompt)) * cfg.d_model * 4       # fp32
    assert t0.bytes_per_hop == (want,)
    assert rep.outputs[0] == done


def test_get_engine_caches_and_pool_sizing_raises():
    from repro_torch.serve import get_engine
    cfg, _, _, _ = _model("gemma3-12b")
    eng = get_engine(cfg, cuts=(0, 2), device="cpu")
    assert get_engine(cfg, cuts=(0, 2), device="cpu") is eng
    assert get_engine(cfg, device="cpu") is not eng
    with pytest.raises(ValueError, match="multiple of block_size"):
        eng.new_batch_state(2, 40, block_size=16)
    with pytest.raises(ValueError, match="no allocatable blocks"):
        eng.new_batch_state(2, 32, block_size=16, pool_blocks=2)
    st = eng.new_batch_state(2, 32, block_size=16, pool_blocks=5)
    assert st.cache["stack"][1]["pk"].shape[1] == 5      # the global layer
    with pytest.raises(ValueError, match="cut"):
        DecodeEngine(cfg, cuts=(1,), device="cpu")       # not on a period
