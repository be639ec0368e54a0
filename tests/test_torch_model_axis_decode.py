"""The model axis on the decode step: the port's sharded
``make_serve_step`` (and ``tf.prefill`` into a cache, and
``tf.split_decode_step``) over a ``data x model`` grid of gloo ranks on the
CPU, against JAX's jitted prefill and ``make_serve_step`` and the port's
one-rank step.

* Grids 1x2, 2x1 and 2x2 (``launch/mesh.py::spawn_grid``, gloo, one
  intra-op thread; one spawn a grid runs every case of that grid, from
  ``tests/_torch_grid.py``, which imports no JAX).  Reduced Gemma-2B (4
  query heads over 1 kv head) and reduced OLMoE (4 over 4, 4 experts
  top-2, capacity factor 1.0), fp32, JAX's initial params with the norm
  scales perturbed.  Each case binds ``build_rules(grid, cfg, "decode",
  B)``: ``kv_seq`` on ``model`` at B 2, on ``("data", "model")`` at B 1
  below a data axis of 2 (the rows whole on every rank).  Each rank builds
  its cache blocks, prefills the prompts (B x S) into them and decodes 6
  steps, row 1 three positions behind row 0, on given tokens.
* Bands: every step's logits within 1e-4 of max |logit| of JAX's (the
  same ops, other summation orders) and within 1e-5 of the port's one-rank
  step (the grid reassociates the row-parallel sums and the softmax's);
  ranks holding the same rows return them bit for bit.  At data 2 JAX's
  prefill takes the per-shard MoE branch the decode rules bind
  (``moe_tokens`` on ``data``: ``vmap(_moe_core)`` over the shards and the
  aux mean wherever a shard has 8 x E tokens), as the one-rank step does
  under the bare mesh shape ``{"data": 2, "model": 1}``.
* The caches after the prefill: each rank's blocks against the same
  slices of the one-rank cache.  ``pos`` is bit-equal everywhere, every
  entry on the data-only grid, and the first layer's ``k`` / ``v`` where
  a rank projects every kv head (Gemma's one): the embedding is exact on
  the grid and the product the one rank's.  A rank's block of split kv
  heads (OLMoE's) is a product of another width, and past the first layer
  the residual stream carries the row-parallel sums' reassociation, so
  those entries are held within 1e-5 of max |entry|.
* A decode-window ring (window 16, prompt 24, 8 slots a rank) that wraps
  across the ranks' blocks, against JAX's ``decode_step`` under
  ``decode_window_override=16``; OLMoE at B 1 on 2x2 (a ring of 256, 64
  slots a rank) leaves two ranks' blocks empty through every step, their
  logits finite and equal to the rest; ``split_decode_step`` at cut 1 on
  1x2 against the one-rank split decode.
* Each rank holds exactly ``device_bytes`` of the params (equal under the
  prefill and the decode rules) and of the caches; the first step's
  collective bytes by kind equal a count by hand on Gemma at 1x2.
* The MoE layer on rows that arrive whole at data 2 (B 1 under the decode
  rules): 32 tokens a shard against ``jax.vmap(_moe_core)`` over the
  shards and the aux mean; 8 a shard, the global stream, against JAX's
  unsharded layer, drops included (bands of ``tests/test_torch_moe.py``).
* In process: a paged cache on a grid raises, naming the JAX package's
  missing placement; so does an SSD or RG-LRU block's cache (Mamba-2,
  RecurrentGemma) on a data-only grid, naming ROADMAP 13b (c), in
  ``init_cache``, ``decode_step`` and ``prefill``.
"""

import concurrent.futures
import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_grid as tg
from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import INPUT_SHAPES as JAX_SHAPES
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.launch.steps import make_serve_step as jax_serve_step
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import _bridge, sharding
from repro_torch.config import INPUT_SHAPES, get_arch, reduced
from repro_torch.launch.mesh import ProcessGrid, spawn_grid
from repro_torch.launch.specs import build_rules, decode_window
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves

ARCHS = {"gemma": "gemma-2b", "olmoe": "olmoe-1b-7b"}
JAX_BAND, ONE_RANK_BAND, CACHE_BAND = 1e-4, 1e-5, 1e-5
MOE_BAND, AUX_RTOL = 1e-5, 1e-5
STEPS, BEHIND = 6, 3
# name -> (arch, grid, B, S, shape, max_len, decode window or None, cuts)
DECODE = {
    "gemma-1x2": ("gemma", (1, 2), 2, 12, "decode_32k", 20, None, None),
    "gemma-2x2": ("gemma", (2, 2), 2, 12, "decode_32k", 20, None, None),
    "gemma-2x1": ("gemma", (2, 1), 1, 12, "decode_32k", 20, None, None),
    "gemma-ring": ("gemma", (1, 2), 2, 24, "long_500k", 32, 16, None),
    "gemma-split": ("gemma", (1, 2), 2, 12, "decode_32k", 20, None, (1,)),
    "olmoe-b2": ("olmoe", (2, 2), 2, 16, "decode_32k", 24, None, None),
    "olmoe-b1": ("olmoe", (2, 2), 1, 64, "long_500k", 256, 256, None),
}
GRIDS = sorted({c[1] for c in DECODE.values()})
# the MoE layer on whole rows at data 2: name -> tokens (B 1)
MOE = {"moe-per-shard": 64, "moe-global": 16}


def _perturb(tree, seed, scale=0.3):
    rng = np.random.default_rng(seed)

    def f(path, x):
        if getattr(path[-1], "key", None) == "scale":
            return x + jnp.asarray(rng.normal(0.0, scale, x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


@functools.lru_cache(maxsize=None)
def _setup(key, window=None):
    over = dict(moe_capacity_factor=1.0) if key == "olmoe" else {}
    if window:
        over["long_context_window"] = window
    cfg = reduced(get_arch(ARCHS[key])).replace(**over)
    jcfg = jax_reduced(jax_get_arch(ARCHS[key])).replace(**over)
    jp, _ = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    jp = _perturb(jp, seed=len(key))
    return cfg, jcfg, jp, jax.tree.map(np.asarray, jp)


def _inputs(name):
    """(prompts (B, S), fed tokens (B, STEPS), first positions (B,))."""
    key, _, b, s, *_ = DECODE[name]
    cfg = _setup(key)[0]
    rng = np.random.default_rng(s + b)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (b, STEPS)).astype(np.int32)
    pos0 = (s - BEHIND * np.arange(b)).astype(np.int32)
    return tokens, feed, pos0


def _cases(grid):
    cases = {}
    for name, (key, g, b, s, shape, max_len, win, cuts) in DECODE.items():
        if g != grid:
            continue
        tokens, feed, pos0 = _inputs(name)
        cases[name] = {"kind": "decode", "cfg": _setup(key, win)[0],
                       "params": _setup(key, win)[3], "tokens": tokens,
                       "feed": feed, "pos0": pos0, "max_len": max_len,
                       "shape": shape, "cuts": cuts}
    if grid[0] == 2:
        cfg, _, _, np_layer = _moe_layer()
        for name, s in MOE.items():
            cases[name] = {"kind": "moe", "cfg": cfg, "params": np_layer,
                           "x": _moe_x(s, cfg.d_model), "rules": "decode"}
    return cases


@pytest.fixture(scope="module")
def runs():
    """(data, model) -> every rank's results, one spawn a grid, the
    spawns at once."""
    with concurrent.futures.ThreadPoolExecutor(len(GRIDS)) as pool:
        futures = {g: pool.submit(spawn_grid, tg.run_grid, *g, _cases(g),
                                  device="cpu", backend="gloo",
                                  timeout=120.0, threads=1)
                   for g in GRIDS}
        return {g: f.result() for g, f in futures.items()}


def _grid_rows(ranks, name, key, data, model):
    """The grid's rows in order; the ranks that hold the same rows (a model
    group, or every rank where the rows are whole) must agree bit for
    bit."""
    b = DECODE[name][2] if name in DECODE else 1
    whole = b < data
    rows = []
    for d in range(data):
        group = [ranks[d * model + m][name][key] for m in range(model)]
        if whole:
            group += [r[name][key] for r in ranks]
        for g in group[1:]:
            np.testing.assert_array_equal(g, group[0])
        rows.append(group[0])
        if whole:
            break
    return np.concatenate(rows)


def _within(got, want, band, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= band * scale, (f"{what}: max|diff| {err:.3g} > {band} x "
                                 f"{scale:.3g}")


@contextlib.contextmanager
def _jax_moe_shards(dp):
    """JAX's ``apply_moe`` as it runs under the decode rules of a data axis
    of ``dp`` (``moe_tokens`` on ``data``): its per-shard branch,
    ``vmap(_moe_core)`` over the shards and the aux mean, wherever a shard
    has 8 x E tokens (``repro/models/moe.py:63-74``; the ``spmd_axis_name``
    there only places the shards)."""
    real = jmoe.apply_moe

    def apply(cfg, p, x):
        b, s, d = x.shape
        t = b * s
        if dp > 1 and t % dp == 0 and t // dp >= 8 * cfg.num_experts:
            out, aux = jax.vmap(lambda xs: jmoe._moe_core(cfg, p, xs))(
                x.reshape(dp, t // dp, d))
            return out.reshape(b, s, d), aux.mean()
        return real(cfg, p, x)

    with mock.patch.object(jmoe, "apply_moe", apply):
        yield


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """JAX's jitted prefill (the last position's logits) and its jitted
    ``make_serve_step`` over the steps -> (B, 1 + STEPS, V)."""
    key, (data, _), b, s, shape, max_len, win, _ = DECODE[name]
    _, jcfg, jp, _ = _setup(key, win)
    tokens, feed, pos0 = _inputs(name)
    override = jcfg.long_context_window if shape == "long_500k" else None
    cache = jtf.init_cache(jcfg, b, max_len, decode_window_override=override)
    with _jax_moe_shards(data):
        logits, cache = jax.jit(lambda p, t, c: jtf.prefill(
            p, jcfg, t, cache=c, impl="dense"))(jp, jnp.asarray(tokens),
                                                cache)
    step = jax.jit(jax_serve_step(jcfg, JAX_SHAPES[shape]))
    out = [np.asarray(logits[:, -1])]
    for i in range(STEPS):
        lg, cache = step(jp, cache, {"tokens": jnp.asarray(feed[:, i:i + 1]),
                                     "pos": jnp.asarray(pos0 + i)})
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, axis=1)


@functools.lru_cache(maxsize=None)
def _one_rank(name):
    """The port's one-rank prefill and steps (under the bare mesh shape
    ``{"data": D, "model": 1}`` at data D > 1) -> (logits (B, 1 + STEPS,
    V), the cache's leaves after the prefill)."""
    key, (data, _), b, s, shape, max_len, win, cuts = DECODE[name]
    cfg, _, _, np_params = _setup(key, win)
    whole = _bridge.params_from_jax(np_params, cfg, device="cpu")
    tokens, feed, pos0 = _inputs(name)
    override = decode_window(cfg, INPUT_SHAPES[shape])
    mesh = {"data": data, "model": 1}
    bind = (sharding.use_sharding_rules(mesh, build_rules(mesh, cfg, "decode",
                                                          b))
            if data > 1 else contextlib.nullcontext())
    cache = tf.init_cache(cfg, b, max_len, decode_window_override=override,
                          device="cpu")
    with torch.no_grad(), bind:
        logits, _ = tf.prefill(whole, cfg, torch.as_tensor(tokens),
                               cache=cache, impl="kernel", last_only=True)
        leaves = [t.clone().numpy() for t in tree_leaves(cache)]
        out = [logits[:, 0].numpy()]
        if cuts:
            stages = tf.partition_params(whole, cfg, cuts, copy=False)
            cstages = tf.partition_cache(cache, cfg, cuts)
        for i in range(STEPS):
            t = torch.as_tensor(feed[:, i:i + 1])
            p = torch.as_tensor(pos0 + i)
            if cuts:
                lg, _ = tf.split_decode_step(stages, cfg, t, cstages, p,
                                             decode_window_override=override)
            else:
                lg, _ = make_serve_step(cfg, INPUT_SHAPES[shape])(
                    whole, cache, {"tokens": t, "pos": p})
            out.append(lg[:, 0].numpy())
    return np.stack(out, axis=1), leaves


def _logits(ranks, name, grid):
    pre = _grid_rows(ranks, name, "prefill", *grid)
    steps = _grid_rows(ranks, name, "steps", *grid)
    return np.concatenate([pre, steps[:, :, 0]], axis=1)


@pytest.mark.parametrize("name", list(DECODE))
def test_sharded_decode_matches_jax_and_one_rank(runs, name):
    grid = DECODE[name][1]
    got = _logits(runs[grid], name, grid)
    assert np.isfinite(got).all()
    want, _ = _one_rank(name)
    for i in range(1 + STEPS):
        _within(got[:, i], want[:, i], ONE_RANK_BAND, f"one rank, step {i}")
        _within(got[:, i], _jax_run(name)[:, i], JAX_BAND, f"JAX, step {i}")


@pytest.mark.parametrize("name", list(DECODE))
def test_cache_blocks_against_the_one_rank_cache(runs, name):
    key, grid, b, _, shape, max_len, win, _ = DECODE[name]
    data, model = grid
    cfg = _setup(key, win)[0]
    override = decode_window(cfg, INPUT_SHAPES[shape])
    rules = build_rules({"data": data, "model": model}, cfg, "decode", b)
    axes = sharding.axes_leaves(tf.cache_axes(
        cfg, decode_window_override=override))
    _, whole = _one_rank(name)
    names = [k for d in tf.cache_axes(cfg)["stack"] for k in sorted(d)]
    for r, res in enumerate(runs[grid]):
        g = ProcessGrid(data, model, r)
        assert res[name]["cache_held_bytes"] == res[name]["cache_device_bytes"]
        for i, (ax, leaf, got) in enumerate(zip(axes, whole,
                                                res[name]["cache"])):
            want = leaf[sharding.block_slices(sharding.resolve_spec(
                g, rules, ax, leaf.shape), leaf.shape, g)]
            assert got.shape == want.shape
            if names[i % len(names)] == "pos" or model == 1:
                np.testing.assert_array_equal(got, want)
                continue
            if cfg.num_kv_heads % model:      # every kv head on each rank
                np.testing.assert_array_equal(got[0], want[0])   # layer 0
            scale = max(float(np.abs(leaf).max()), 1e-30)
            assert float(np.abs(got - want).max()) <= CACHE_BAND * scale


def test_kv_seq_placements(runs):
    """The decode rules put ``kv_seq`` on ``model`` at B 2 and on ``data x
    model`` at B 1: a rank's ``k`` block holds max_len / 2 or / 4 slots of
    every kv head, ``pos`` whole; the ring's blocks wrap (the prompt of 24
    fills the 16-slot ring's both blocks past position 15)."""
    for name, want in (("gemma-1x2", 10), ("olmoe-b2", 12),
                       ("olmoe-b1", 64), ("gemma-ring", 8),
                       ("gemma-2x1", 10)):
        key, grid, b, s, _, max_len, win, _ = DECODE[name]
        cfg = _setup(key, win)[0]
        for res in runs[grid]:
            k, pos = res[name]["cache"][0], res[name]["cache"][1]
            rows = b // grid[0] if b >= grid[0] else b
            assert k.shape == (cfg.num_layers, rows, want,
                               cfg.num_kv_heads, cfg.head_dim)
            assert pos.shape[-1] == (win or max_len)
    for res in runs[(1, 2)]:
        pos = res["gemma-ring"]["cache"][1]
        assert pos.min() == 8 and pos.max() == 23


def test_empty_blocks_stay_empty_and_finite(runs):
    """OLMoE at B 1 on 2x2: the prompt of 64 fills rank 0's 64 ring slots
    and the steps write into rank 1's; ranks 2 and 3 hold no entry at any
    step, and return the same finite logits as the others (their masked
    scores add exact zeros)."""
    ranks = runs[(2, 2)]
    for r, res in enumerate(ranks):
        k = res["olmoe-b1"]["cache"][0]
        if r >= 2:
            assert not k.any()
        assert np.isfinite(res["olmoe-b1"]["steps"]).all()
        np.testing.assert_array_equal(res["olmoe-b1"]["steps"],
                                      ranks[0]["olmoe-b1"]["steps"])
    assert ranks[0]["olmoe-b1"]["cache"][0].all(axis=(-1, -2)).all()


@pytest.mark.parametrize("name", list(DECODE))
def test_held_bytes_equal_device_bytes(runs, name):
    for res in runs[DECODE[name][1]]:
        r = res[name]
        assert r["held_bytes"] == r["device_bytes"] == r["prefill_device_bytes"]
        assert r["cache_held_bytes"] == r["cache_device_bytes"] > 0


def test_collective_bytes_by_hand_gemma_1x2(runs):
    """Gemma at 1x2, B 2, one decode step, fp32: all-reduce the embedding
    (B, 1, D); a layer gathers the query heads (B, Hq, hd), reduces the
    softmax's max (``all-reduce-max``) and sum (B, Hq), the weighted values
    (B, Hq, hd), ``wo``'s and the MLP's products (B, D); the logits (B, V)
    are gathered; no data-group collective (data 1)."""
    cfg = _setup("gemma")[0]
    b, hq, hd, d, v = (2, cfg.num_heads, cfg.head_dim, cfg.d_model,
                       cfg.vocab_size)
    layers = cfg.num_layers
    for res in runs[(1, 2)]:
        r = res["gemma-1x2"]
        assert r["coll"]["all-reduce"] == 4 * (b * d + layers * (
            b * hq + b * hq * hd + 2 * b * d))
        assert r["coll"]["all-reduce-max"] == 4 * layers * b * hq
        assert r["coll"]["all-gather"] == 4 * (layers * b * hq * hd + b * v)
        assert r["stats"]["calls"] == 2 + 6 * layers
        assert r["stats"]["bytes"] == 4 * (
            b * d + layers * (2 * b * hq + b * hq * hd // 2 + b * hq * hd
                              + 2 * b * d) + b * v // 2)


def test_split_decode_on_a_grid_matches_the_one_rank_split(runs):
    """The cut only moves activations: the split grid step is the merged
    one bit for bit, as on one rank."""
    np.testing.assert_array_equal(
        _logits(runs[(1, 2)], "gemma-split", (1, 2)),
        _logits(runs[(1, 2)], "gemma-1x2", (1, 2)))


# ---------------------------------------------------------------------------
# The MoE layer on whole rows
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _moe_layer():
    cfg, jcfg, _, _ = _setup("olmoe")
    p, _ = jmoe.moe_init(jax.random.PRNGKey(7), jcfg)
    return cfg, jcfg, p, {k: np.asarray(v) for k, v in p.items()}


def _moe_x(s, d):
    return np.random.default_rng(4).normal(0.0, 1.0, (1, s, d)).astype(
        np.float32)


def _drops(cfg, p, xt):
    x = torch.as_tensor(np.array(xt))
    probs = torch.softmax((x @ torch.as_tensor(np.array(p["router"])))
                          .float(), dim=-1)
    r = moe.route(cfg, probs, moe._capacity(cfg, x.shape[0]))
    dropped = torch.zeros(x.shape[0] * cfg.experts_per_token,
                          dtype=torch.bool)
    dropped[r.order] = ~r.keep
    return dropped.numpy()


@pytest.mark.parametrize("grid", [g for g in GRIDS if g[0] == 2],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_moe_per_shard_branch_on_whole_rows(runs, grid):
    """B 1 x 64 tokens under the decode rules at data 2: the rows arrive
    whole, each data rank dispatches its 32-token shard (>= 8 x 4 experts)
    and the shards' outputs are gathered, the aux their mean: JAX's
    ``vmap(_moe_core)`` over the shards."""
    cfg, jcfg, p, _ = _moe_layer()
    data = grid[0]
    s, d = MOE["moe-per-shard"], cfg.d_model
    x = _moe_x(s, d)
    shards = jnp.asarray(x).reshape(data, s // data, d)
    want, aux = jax.jit(jax.vmap(lambda xs: jmoe._moe_core(jcfg, p, xs)))(
        shards)
    want = np.asarray(want).reshape(1, s, d)
    per_shard = np.concatenate([_drops(cfg, p, xs) for xs in shards])
    assert per_shard.any()
    assert not np.array_equal(per_shard, _drops(cfg, p, x.reshape(s, d)))
    for r in runs[grid]:
        np.testing.assert_allclose(r["moe-per-shard"]["out"], want,
                                   atol=MOE_BAND * np.abs(want).max(),
                                   rtol=MOE_BAND)
        assert r["moe-per-shard"]["aux"] == pytest.approx(
            float(aux.mean()), rel=AUX_RTOL)


@pytest.mark.parametrize("grid", [g for g in GRIDS if g[0] == 2],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_moe_global_branch_on_whole_rows(runs, grid):
    """B 1 x 16 tokens at data 2 (8 a shard, < 8 x 4): every rank
    dispatches the whole stream it holds, capacity from all 16 tokens,
    as JAX's unsharded layer, its drops included, with no data-group
    gather."""
    cfg, jcfg, p, _ = _moe_layer()
    s = MOE["moe-global"]
    x = _moe_x(s, cfg.d_model)
    want, aux = jax.jit(lambda v: jmoe.apply_moe(jcfg, p, v))(jnp.asarray(x))
    want = np.asarray(want)
    assert _drops(cfg, p, x.reshape(s, -1)).any()
    for r in runs[grid]:
        np.testing.assert_allclose(r["moe-global"]["out"], want,
                                   atol=MOE_BAND * np.abs(want).max(),
                                   rtol=MOE_BAND)
        assert r["moe-global"]["aux"] == pytest.approx(float(aux),
                                                       rel=AUX_RTOL)


# ---------------------------------------------------------------------------
# In process: refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where", ("init_cache", "decode_step"))
def test_paged_cache_on_a_grid_raises(where):
    cfg = _setup("gemma")[0]
    grid = ProcessGrid(1, 2, 0)
    rules = build_rules(grid, cfg, "decode", 2)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    paged = tf.init_cache(cfg, 2, 16, paged=(4, 8), device="cpu")
    table = torch.arange(4, dtype=torch.int32).view(2, 2)
    with sharding.use_sharding_rules(grid, rules), \
            pytest.raises(NotImplementedError,
                          match="places no paged pool on a mesh"):
        if where == "init_cache":
            tf.init_cache(cfg, 2, 16, paged=(4, 8), device="cpu")
        else:
            tf.decode_step(params, cfg, torch.zeros((2, 1), dtype=torch.int32),
                           paged, torch.zeros(2, dtype=torch.int32),
                           table=table)


@pytest.mark.parametrize("where", ("init_cache", "decode_step", "prefill"))
@pytest.mark.parametrize("arch", ("mamba2-370m", "recurrentgemma-2b"))
def test_recurrent_cache_on_a_grid_raises(arch, where):
    cfg = reduced(get_arch(arch))
    grid = ProcessGrid(2, 1, 0)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    tokens = torch.zeros((2, 1), dtype=torch.int32)
    with sharding.use_sharding_rules(grid, build_rules(grid, cfg, "decode",
                                                       2)), \
            pytest.raises(NotImplementedError, match=r"RG-LRU.*13b \(c\)"):
        if where == "init_cache":
            tf.init_cache(cfg, 2, 16, device="cpu")
        elif where == "decode_step":
            tf.decode_step(params, cfg, tokens, cache,
                           torch.zeros(2, dtype=torch.int32))
        else:
            tf.prefill(params, cfg, tokens, cache=cache)


def test_prefill_on_a_grid_needs_its_cache_blocks():
    cfg = _setup("gemma")[0]
    grid = ProcessGrid(1, 2, 0)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with sharding.use_sharding_rules(grid, build_rules(grid, cfg, "decode",
                                                       2)):
        with pytest.raises(ValueError, match="cache blocks"):
            tf.prefill(params, cfg, torch.zeros((2, 4), dtype=torch.int32))
