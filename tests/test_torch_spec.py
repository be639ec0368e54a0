"""Self-drafting speculative decode in the port: the client stage drafts
through the early-exit head, one teacher-forced pass of the whole model
verifies, and every cache family rolls back exactly.

At the JAX package's initial params the reduced Gemma-3 and
RecurrentGemma drafts (cut 0: the embedding alone) are always accepted —
the layers barely move the residual stream — so no rollback would run.
These tests scale every layer's output projections (``wo``, ``wd``) by 4
for those two (Mamba-2 as initialized already rejects), on both sides,
and assert that drafts were rejected.  Tokens are then held equal to
greedy decoding exactly (fp32, the same engine), the rolled-back cache
equal to sequential decoding's, and every round's (tokens, accepted,
emitted) equal to the JAX engine's.

A cut-0 draft writes no ring.  The deep-draft cases take reduced
Gemma-3 at 4 layers and draft at cut 2 (its period: one local and one
global layer), so the draft writes ring lines the verify must not see;
the prompts wrap the window of 64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401
import repro.serve as jserve
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import transformer as jtf
from repro_torch._bridge import params_from_jax
from repro_torch.config import get_arch, reduced
from repro_torch.serve import (BlockAllocator, DecodeEngine,
                               FaultRoutedServer, Request, ServeParams)
from repro_torch.serve.engine import _layer_caches
from repro_torch.sim import get_scenario

FAMILIES = ("gemma3-12b", "mamba2-370m", "recurrentgemma-2b")
AMPLIFY = {"gemma3-12b": 4.0, "mamba2-370m": 1.0, "recurrentgemma-2b": 4.0}


DEEP_LAYERS, DEEP_CUT = 4, 2       # reduced Gemma-3 drafted through a ring


@functools.lru_cache(maxsize=None)
def _model(arch, num_layers=None):
    """(port cfg, JAX cfg, port params, JAX params), the layers' output
    projections scaled by AMPLIFY[arch] on both sides; ``num_layers``
    deepens the reduced config."""
    jcfg = jax_reduced(jax_get_arch(arch))
    cfg = reduced(get_arch(arch))
    if num_layers is not None:
        jcfg = jcfg.replace(num_layers=num_layers)
        cfg = cfg.replace(num_layers=num_layers)
    jp, _ = jtf.init_params(jax.random.PRNGKey(0), jcfg)

    def amp(path, x):
        name = jax.tree_util.keystr(path)
        scale = AMPLIFY[arch] if ("'wo'" in name or "'wd'" in name) else 1.0
        return np.asarray(x) * np.asarray(scale, np.asarray(x).dtype)

    jp = jax.tree_util.tree_map_with_path(amp, jp)
    tp = params_from_jax(jp, cfg, device="cpu")
    return cfg, jcfg, tp, jax.tree.map(jnp.asarray, jp)


def _prompts(arch, vocab):
    if arch == "gemma3-12b":   # past the reduced window of 64: rings wrap
        return ([(np.arange(2, 60) * 3) % vocab, (np.arange(1, 50) * 7) % vocab],
                [20, 18], 80)
    return ([np.arange(1, 7) % vocab, (np.arange(3, 15) * 5) % vocab],
            [10, 7], 32)


def serve_tokens(eng, params, prompts, gens, max_len, *, block_size=0,
                 spec=0, alloc_cls=BlockAllocator, rng=None):
    """The JAX test's minimal slot loop, for either package's engine:
    admit every prompt, then decode (or speculate) until every budget is
    spent.  Returns (token streams, per-round (tokens, accepted, emitted))."""
    slots = len(prompts)
    alloc = None
    if block_size:
        nb = max_len // block_size
        alloc = alloc_cls(slots * (nb + 1), block_size, reserved=slots)
        st = eng.new_batch_state(slots, max_len, block_size=block_size)
    else:
        st = eng.new_batch_state(slots, max_len)
    outs = []
    for i, p in enumerate(prompts):
        blocks = None
        if alloc is not None:
            blocks = alloc.allocate(min(len(p) + gens[i] + max(8, spec),
                                        max_len))
        outs.append([eng.admit(st, params, p, i, blocks=blocks)])
    need = [g - 1 for g in gens]
    rounds = []
    while any(n > 0 for n in need):
        if spec:
            toks, acc, cnt = eng.spec_chunk(st, params, spec)
            rounds.append((np.asarray(toks), np.asarray(acc),
                           np.asarray(cnt)))
            steps = [min(int(cnt[i]), need[i]) for i in range(slots)]
        else:
            args = (np.zeros((slots, 4), np.int32), np.zeros((slots,),
                                                              np.int32))
            toks = eng.decode_chunk(st, params, *args, *(
                () if rng is None else (rng,)))
            steps = [min(4, need[i]) for i in range(slots)]
        for i in range(slots):
            outs[i].extend(int(t) for t in toks[i, :steps[i]])
            need[i] -= steps[i]
    return outs, rounds


def _rejected(rounds, k=4):
    return sum(int((acc < k).sum()) for _, acc, _ in rounds)


@pytest.mark.parametrize("arch", FAMILIES)
def test_speculative_decode_matches_greedy(arch):
    cfg, _, tp, _ = _model(arch)
    prompts, gens, max_len = _prompts(arch, cfg.vocab_size)
    ref, _ = serve_tokens(DecodeEngine(cfg, device="cpu"), tp, prompts, gens,
                          max_len)
    eng = DecodeEngine(cfg, device="cpu")
    spc, rounds = serve_tokens(eng, tp, prompts, gens, max_len, spec=4)
    assert spc == ref
    assert _rejected(rounds) > 0 and any(int(a.max()) > 0
                                         for _, a, _ in rounds)
    assert eng.draft_compiles == 1 and eng.verify_compiles == 1
    assert 0.0 < eng.draft_fraction < 1.0
    assert eng.steps["draft"] == eng.steps["verify"] == 4 * len(rounds)


@pytest.mark.parametrize("block_size", [0, 16])
def test_speculative_ring_wrap_rollback(block_size):
    """A ring (window 64) smaller than max_len 80, where a rejected draft's
    write wraps onto a still-visible entry: the pre-round line copies must
    restore it exactly; paged global layers combined on the same shapes."""
    cfg, _, tp, _ = _model("gemma3-12b")
    prompts, gens, max_len = _prompts("gemma3-12b", cfg.vocab_size)
    ref, _ = serve_tokens(DecodeEngine(cfg, device="cpu"), tp, prompts, gens,
                          max_len)
    spc, rounds = serve_tokens(DecodeEngine(cfg, device="cpu"), tp, prompts,
                               gens, max_len, block_size=block_size, spec=4)
    assert spc == ref
    assert _rejected(rounds) > 0


@pytest.mark.parametrize("block_size", [0, 16])
def test_speculative_ring_wrap_rollback_deep_draft(block_size):
    """As above, drafting at cut 2 through a local layer: the draft's ring
    writes must not reach the verify, whose lines for later steps still
    hold in-window keys."""
    cfg, _, tp, _ = _model("gemma3-12b", DEEP_LAYERS)
    prompts, gens, max_len = _prompts("gemma3-12b", cfg.vocab_size)
    ref, _ = serve_tokens(DecodeEngine(cfg, device="cpu"), tp, prompts, gens,
                          max_len)
    spc, rounds = serve_tokens(
        DecodeEngine(cfg, spec_cut=DEEP_CUT, device="cpu"), tp, prompts,
        gens, max_len, block_size=block_size, spec=4)
    assert spc == ref
    assert _rejected(rounds) > 0


def _valid_equal(a, b, valid):
    m = valid.reshape(valid.shape + (1,) * (a.dim() - valid.dim()))
    assert bool(((a == b) | ~m).all())


def _assert_spec_rounds_track_sequential(cfg, tp, prompt, max_len,
                                         block_size, **engine_kw):
    eng = DecodeEngine(cfg, device="cpu", **engine_kw)
    kw = dict(block_size=block_size) if block_size else {}
    a = eng.new_batch_state(1, max_len, **kw)
    b = eng.new_batch_state(1, max_len, **kw)
    blocks = list(range(1, max_len // block_size + 1)) if block_size else None
    for st in (a, b):
        eng.admit(st, tp, prompt, 0, blocks=blocks)
    emitted = []
    while int(a.pos[0]) + 4 <= max_len - 4:
        _, acc, n = eng.spec_chunk(a, tp, 4)
        emitted.append(int(n[0]))
        n0 = int(n[0])
        eng.decode_chunk(b, tp, np.zeros((1, n0), np.int32),
                         np.zeros((1,), np.int32))
        assert int(a.pos[0]) == int(b.pos[0]) and int(a.tok[0]) == int(b.tok[0])
        for (_, da), (_, db) in zip(_layer_caches(a.cache),
                                    _layer_caches(b.cache)):
            pos_key = "ppos" if "ppos" in da else "pos"
            if pos_key not in da:                  # recurrent: exact
                for key in da:
                    assert bool((da[key] == db[key]).all()), key
                continue
            assert bool((da[pos_key] == db[pos_key]).all())
            valid = da[pos_key] >= 0
            for key in (("pk", "pv") if pos_key == "ppos" else ("k", "v")):
                _valid_equal(da[key], db[key], valid)
    assert min(emitted) < 4


# Mamba-2 has no attention layer to page
@pytest.mark.parametrize("arch,block_size", [
    ("gemma3-12b", 0), ("gemma3-12b", 16), ("mamba2-370m", 0),
    ("recurrentgemma-2b", 0), ("recurrentgemma-2b", 16)])
def test_spec_round_leaves_the_cache_of_sequential_decoding(arch,
                                                            block_size):
    """One slot: after each speculative round that emitted n tokens, the
    cache equals that of a twin state decoded n plain greedy steps —
    recurrent states exactly, ring, full-length and paged KV in every
    position and in every valid entry."""
    cfg, _, tp, _ = _model(arch)
    prompts, _, max_len = _prompts(arch, cfg.vocab_size)
    _assert_spec_rounds_track_sequential(cfg, tp, prompts[0], max_len,
                                         block_size)


@pytest.mark.parametrize("block_size", [0, 16])
def test_deep_draft_round_leaves_the_cache_of_sequential_decoding(
        block_size):
    """The same with the draft at cut 2, through a wrapped local ring."""
    cfg, _, tp, _ = _model("gemma3-12b", DEEP_LAYERS)
    prompts, _, max_len = _prompts("gemma3-12b", cfg.vocab_size)
    _assert_spec_rounds_track_sequential(cfg, tp, prompts[0], max_len,
                                         block_size, spec_cut=DEEP_CUT)


@pytest.fixture(scope="module", params=[
    ("gemma3-12b", 16, None), ("mamba2-370m", 0, None),
    ("gemma3-12b", 0, DEEP_CUT), ("gemma3-12b", 16, DEEP_CUT)],
    ids=["gemma3-12b-paged", "mamba2-370m", "gemma3-12b-cut2",
         "gemma3-12b-paged-cut2"])
def jax_spec_run(request):
    arch, block_size, cut = request.param
    _, jcfg, _, jp = _model(arch, None if cut is None else DEEP_LAYERS)
    prompts, gens, max_len = _prompts(arch, jcfg.vocab_size)
    outs, rounds = serve_tokens(jserve.DecodeEngine(jcfg, spec_cut=cut), jp,
                                prompts, gens, max_len,
                                block_size=block_size, spec=4,
                                alloc_cls=jserve.BlockAllocator)
    return arch, block_size, cut, outs, rounds


def test_speculative_rounds_equal_jax(jax_spec_run):
    arch, block_size, cut, want, want_rounds = jax_spec_run
    cfg, _, tp, _ = _model(arch, None if cut is None else DEEP_LAYERS)
    prompts, gens, max_len = _prompts(arch, cfg.vocab_size)
    got, rounds = serve_tokens(
        DecodeEngine(cfg, impl="kernel", paged_kernel=bool(block_size),
                     spec_cut=cut, device="cpu"),
        tp, prompts, gens, max_len, block_size=block_size, spec=4)
    assert got == want
    assert len(rounds) == len(want_rounds)
    for (g, a, n), (wg, wa, wn) in zip(rounds, want_rounds):
        np.testing.assert_array_equal(g, wg)
        np.testing.assert_array_equal(a, wa)
        np.testing.assert_array_equal(n, wn)
    assert _rejected(rounds) > 0


def test_speculative_serving_under_replica_drop_matches_clean():
    """Router level: speculative serving under replica drops gives the
    plain clean run's outputs (speculation never overlaps a replay)."""
    cfg, _, tp, _ = _model("mamba2-370m")
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=[8, 12, 10][i % 3]),
                    max_new=[4, 6, 5][i % 3]) for i in range(6)]
    sp = dict(replicas=2, slots=2, chunk=4, max_len=32, seed=3)
    clean = FaultRoutedServer(DecodeEngine(cfg, device="cpu"), tp,
                              ServeParams(**sp)).run(reqs)
    rep = FaultRoutedServer(DecodeEngine(cfg, device="cpu"), tp,
                            ServeParams(**sp, speculate=True, draft_k=4),
                            scenario=get_scenario("replica-drop")).run(reqs)
    assert rep.outputs == clean.outputs
    assert rep.reroutes > 0 and rep.spec_rounds > 0
    assert rep.drafted >= rep.accepted >= 0
