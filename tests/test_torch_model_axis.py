"""The model axis on the serving prefill step: the port's sharded
``make_prefill_step`` over a ``data x model`` grid of gloo ranks on the
CPU, against JAX's forward and the port's one-rank step.

* Grids 1x2, 2x1 and 2x2 (``launch/mesh.py::spawn_grid``, gloo, one
  intra-op thread, rendezvous and join within 120 s; one spawn a grid runs
  every case of that grid, from ``tests/_torch_grid.py``, which imports no
  JAX).  Reduced Gemma-2B (4 query heads over 1 kv head, tied embeddings)
  and reduced OLMoE (4 over 4, 4 experts top-2) at capacity factor 1.0,
  fp32, with JAX's initial params (norm scales perturbed) through
  ``params_from_jax`` and ``_bridge.shard_params``; each under the
  prefill rules of ``build_rules``, and once with ``fsdp`` bound to the
  data axis too (the full-size rules bind it; the reduced configs are
  small enough that the rule drops it), that case the step's forward under
  the overridden rules (``_torch_grid.prefill_under``).
* Bands: last-position logits within 1e-4 of max |logit| of JAX's
  ``tf.forward(..., impl="dense", last_only=True)`` (the same ops, other
  summation orders), and within 1e-5 of the port's one-rank step (the
  grid's sums reassociate the row-parallel products); the model group's
  ranks return the same rows bit for bit.  OLMoE's B 2 x S 8 has 8
  tokens a data shard, below 8 x 4, so JAX dispatches the global stream;
  at S 32 (32 a shard) it dispatches per shard, which the unsharded JAX
  forward does not, so that case is held against the one-rank step under
  the bare mesh shape ``{"data": 2, "model": 1}`` (the per-shard branch
  itself is held against JAX below).
* Each rank holds exactly ``sharding.device_bytes`` of the tree, and the
  op counter's collective bytes equal the log's and, on Gemma at 1x2, a
  count by hand.
* The MoE layer (``apply_moe``) at data 2 and capacity factor 1.0: 32
  tokens a shard against JAX's own branch, ``jax.vmap(_moe_core)`` over
  the shards and the aux mean (bands of ``tests/test_torch_moe.py``:
  fp32 1e-5 of max |out|, aux rel 1e-5), the shards' drops differing from
  the global stream's; 8 tokens a shard, the global stream across the
  data ranks, against JAX's unsharded layer, drops included.
* In process: ``shard_params``' blocks reassemble the whole tree exactly,
  ``init_shard_params`` equals ``shard_params`` of
  ``init_params_by_layer``; the binding contracts of
  ``use_sharding_rules`` / ``bound_axes`` / ``current_mesh`` /
  ``shard_activation``; each binding no slice executes yet raises,
  naming its ROADMAP item.
"""

import concurrent.futures
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_grid as tg
from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import _bridge, sharding
from repro_torch.config import get_arch, reduced
from repro_torch.launch.mesh import ProcessGrid, spawn_grid
from repro_torch.launch.specs import build_rules
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves

GRIDS = ((1, 2), (2, 1), (2, 2))
ARCHS = {"gemma": "gemma-2b", "olmoe": "olmoe-1b-7b"}
JAX_BAND, ONE_RANK_BAND = 1e-4, 1e-5
MOE_BAND, AUX_RTOL = 1e-5, 1e-5
# name -> (arch, B, S, overrides, per_shard)
PREFILL = {"gemma": ("gemma", 2, 16, None, False),
           "gemma-fsdp": ("gemma", 2, 16, {"fsdp": "data"}, False),
           "olmoe": ("olmoe", 2, 8, None, False),
           "olmoe-fsdp": ("olmoe", 2, 8, {"fsdp": "data"}, False),
           "olmoe-per-shard": ("olmoe", 2, 32, None, True)}
# MoE layer cases at data 2: name -> (B, S); 32 tokens a shard take the
# per-shard branch (8 x 4 experts), 8 the global stream
MOE = {"moe-per-shard": (2, 32), "moe-global": (2, 8)}


def _perturb(tree, seed, scale=0.3):
    rng = np.random.default_rng(seed)

    def f(path, x):
        if getattr(path[-1], "key", None) == "scale":
            return x + jnp.asarray(rng.normal(0.0, scale, x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


@functools.lru_cache(maxsize=None)
def _setup(key):
    over = dict(moe_capacity_factor=1.0) if key == "olmoe" else {}
    cfg = reduced(get_arch(ARCHS[key])).replace(**over)
    jcfg = jax_reduced(jax_get_arch(ARCHS[key])).replace(**over)
    jp, _ = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    jp = _perturb(jp, seed=len(key))
    return cfg, jcfg, jp, jax.tree.map(np.asarray, jp)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _moe_layer():
    cfg, jcfg, _, _ = _setup("olmoe")
    p, _ = jmoe.moe_init(jax.random.PRNGKey(7), jcfg)
    return cfg, jcfg, p, {k: np.asarray(v) for k, v in p.items()}


def _moe_x(b, s, d):
    return np.random.default_rng(3).normal(0.0, 1.0, (b, s, d)).astype(
        np.float32)


def _cases(data):
    cases = {}
    for name, (key, b, s, over, per_shard) in PREFILL.items():
        if (per_shard or over) and data == 1:
            continue        # the data axis binds nothing at data 1
        cfg, _, _, np_params = _setup(key)
        cases[name] = {"kind": "prefill", "cfg": cfg, "params": np_params,
                       "tokens": _tokens(cfg, b, s), "overrides": over}
    if data == 2:
        cfg, _, _, np_layer = _moe_layer()
        for name, (b, s) in MOE.items():
            cases[name] = {"kind": "moe", "cfg": cfg, "params": np_layer,
                           "x": _moe_x(b, s, cfg.d_model)}
    return cases


@pytest.fixture(scope="module")
def runs():
    """(data, model) -> every rank's results, one spawn a grid, the three
    spawns at once."""
    with concurrent.futures.ThreadPoolExecutor(len(GRIDS)) as pool:
        futures = {g: pool.submit(spawn_grid, tg.run_grid, *g,
                                  _cases(g[0]), device="cpu",
                                  backend="gloo", timeout=120.0, threads=1)
                   for g in GRIDS}
        return {g: f.result() for g, f in futures.items()}


def _rows(ranks, name, key, data, model):
    """The grid's rows in order (one rank of each model group), after
    checking that a model group's ranks agree bit for bit."""
    rows = []
    for d in range(data):
        group = [ranks[d * model + m][name][key] for m in range(model)]
        for g in group[1:]:
            np.testing.assert_array_equal(g, group[0])
        rows.append(group[0])
    return np.concatenate(rows)


def _within(got, want, band, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= band * scale, f"{what}: max|diff| {err:.3g} > {band} x {scale:.3g}"


def _jax_logits(name):
    key, b, s, _, _ = PREFILL[name]
    return _jax_forward(key, b, s)


@functools.lru_cache(maxsize=None)
def _jax_forward(key, b, s):
    cfg, jcfg, jp, _ = _setup(key)
    logits, _ = jtf.forward(jp, jcfg, jnp.asarray(_tokens(cfg, b, s)),
                            impl="dense", remat=False, last_only=True)
    return np.asarray(logits)


@functools.lru_cache(maxsize=None)
def _one_rank_logits(name, data):
    key, b, s, _, per_shard = PREFILL[name]
    cfg, _, _, np_params = _setup(key)
    whole = _bridge.params_from_jax(np_params, cfg, device="cpu")
    mesh = {"data": data, "model": 1} if per_shard else None
    step = make_prefill_step(cfg, "kernel", grid=mesh)
    return step(whole, {"tokens": torch.as_tensor(_tokens(cfg, b, s))}).numpy()


@pytest.mark.parametrize("name,grid", [
    (n, g) for n in PREFILL for g in GRIDS
    if g[0] > 1 or not (PREFILL[n][3] or PREFILL[n][4])],
    ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_sharded_prefill_matches_jax_and_one_rank(runs, name, grid):
    data, model = grid
    ranks = runs[grid]
    got = _rows(ranks, name, "logits", data, model)
    _within(got, _one_rank_logits(name, data), ONE_RANK_BAND, "one rank")
    if not PREFILL[name][4]:
        _within(got, _jax_logits(name), JAX_BAND, "JAX")
    for r in ranks:
        res = r[name]
        assert res["held_bytes"] == res["device_bytes"]
        # one tally: the op counter's bytes by kind are the log's
        assert res["stats"]["calls"] > 0
        sent = {"all-reduce": 0.0, "all-gather": 0.0}
        for kind, v in res["coll"].items():
            sent[kind.removeprefix("coll_")] = v
        assert sum(sent.values()) >= res["stats"]["bytes"] > 0


def test_collective_bytes_by_hand_gemma_1x2(runs):
    """Gemma at 1x2, B 2 x S 16: an all-reduce of the (B, S, D) fp32
    activations for the embedding and for each layer's attention and MLP,
    and one all-gather of the (B, 1, V) fp32 logits; no data-group
    collective (data 1)."""
    cfg = _setup("gemma")[0]
    _, b, s, _, _ = PREFILL["gemma"]
    act = b * s * cfg.d_model * 4
    for r in runs[(1, 2)]:
        res = r["gemma"]
        assert res["coll"]["coll_all-reduce"] == (1 + 2 * cfg.num_layers) * act
        assert res["coll"]["coll_all-gather"] == b * cfg.vocab_size * 4
        assert res["stats"]["calls"] == 2 + 2 * cfg.num_layers
        assert res["stats"]["bytes"] == (1 + 2 * cfg.num_layers) * act + \
            b * cfg.vocab_size // 2 * 4


def _drops(cfg, jcfg, p, xt):
    """The (token, k) assignments the dispatch of ``xt`` drops, as a
    boolean (T, k) array (the port's router; its routing equals JAX's,
    tests/test_torch_moe.py)."""
    x = torch.as_tensor(np.array(xt))
    probs = torch.softmax((x @ torch.as_tensor(np.array(p["router"])))
                          .float(), dim=-1)
    r = moe.route(cfg, probs, moe._capacity(cfg, x.shape[0]))
    dropped = torch.zeros(x.shape[0] * cfg.experts_per_token, dtype=torch.bool)
    dropped[r.order] = ~r.keep
    return dropped.view(x.shape[0], -1).numpy()


@pytest.mark.parametrize("grid", [g for g in GRIDS if g[0] == 2],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_moe_per_shard_branch_matches_jax(runs, grid):
    """32 tokens a data shard (>= 8 x 4 experts): each shard dispatched
    alone, capacity from its 32 tokens, aux the shards' mean, as JAX's
    ``vmap`` branch (``repro/models/moe.py:67-71``)."""
    data, model = grid
    cfg, jcfg, p, _ = _moe_layer()
    b, s = MOE["moe-per-shard"]
    x = _moe_x(b, s, cfg.d_model)
    t, d = b * s, cfg.d_model
    shards = jnp.asarray(x).reshape(data, t // data, d)
    # jitted: in fp32 XLA rounds the router logits as the eager ops do
    want, aux = jax.jit(jax.vmap(lambda xs: jmoe._moe_core(jcfg, p, xs)))(
        shards)
    want = np.asarray(want).reshape(b, s, d)
    ranks = runs[grid]
    got = _rows(ranks, "moe-per-shard", "out", data, model)
    np.testing.assert_allclose(got, want, atol=MOE_BAND * np.abs(want).max(),
                               rtol=MOE_BAND)
    for r in ranks:
        assert r["moe-per-shard"]["aux"] == pytest.approx(
            float(aux.mean()), rel=AUX_RTOL)
        assert r["moe-per-shard"]["experts"] == cfg.num_experts // model
    per_shard = np.concatenate([_drops(cfg, jcfg, p, xs) for xs in shards])
    whole = _drops(cfg, jcfg, p, jnp.asarray(x).reshape(t, d))
    assert per_shard.any() and not np.array_equal(per_shard, whole)


@pytest.mark.parametrize("grid", [g for g in GRIDS if g[0] == 2],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_moe_global_branch_across_data_ranks(runs, grid):
    """8 tokens a data shard (< 8 x 4): JAX dispatches the global stream,
    capacity from all 16 tokens; the ranks gather the tokens over the
    data group and equal JAX's unsharded layer, its drops included."""
    data, model = grid
    cfg, jcfg, p, _ = _moe_layer()
    b, s = MOE["moe-global"]
    x = _moe_x(b, s, cfg.d_model)
    want, aux = jax.jit(lambda v: jmoe.apply_moe(jcfg, p, v))(jnp.asarray(x))
    want = np.asarray(want)
    assert _drops(cfg, jcfg, p, jnp.asarray(x).reshape(b * s, -1)).any()
    got = _rows(runs[grid], "moe-global", "out", data, model)
    np.testing.assert_allclose(got, want, atol=MOE_BAND * np.abs(want).max(),
                               rtol=MOE_BAND)
    for r in runs[grid]:
        assert r["moe-global"]["aux"] == pytest.approx(float(aux),
                                                       rel=AUX_RTOL)


# ---------------------------------------------------------------------------
# In process: blocks, bindings, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp", (None, "data"))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("key", list(ARCHS))
def test_shard_params_blocks_reassemble_the_tree(key, grid, fsdp):
    data, model = grid
    cfg = _setup(key)[0]
    whole = tf.init_params_by_layer(cfg, 5, device="cpu")
    grid_shape = {"data": data, "model": model}
    rules = build_rules(grid_shape, cfg, "prefill", 2,
                        overrides={"fsdp": fsdp})
    axes = tf.param_axes_tree(cfg)
    leaves = tree_leaves(whole)
    built = [torch.full_like(t, float("nan")) for t in leaves]
    for rank in range(data * model):
        g = ProcessGrid(data, model, rank)
        blocks = _bridge.shard_params(whole, g, rules, axes)
        assert sum(t.numel() * t.element_size() for t in tree_leaves(
            blocks)) == sharding.device_bytes(grid_shape, rules, axes, whole)
        for t, b, out, ax in zip(leaves, tree_leaves(blocks), built,
                                 sharding.axes_leaves(axes)):
            sl = sharding.block_slices(sharding.resolve_spec(
                g, rules, ax, t.shape), t.shape, g)
            assert b.is_contiguous()
            out[sl] = b
        drawn = _bridge.init_shard_params(cfg, 5, g, rules, device="cpu")
        for a, b in zip(tree_leaves(drawn), tree_leaves(blocks)):
            assert torch.equal(a, b)
    for t, out in zip(leaves, built):
        assert torch.equal(out, t)


def test_sharding_rules_binding_contracts():
    x = torch.arange(24.0).view(4, 3, 2)
    assert sharding.current_mesh() is None
    assert sharding.bound_axes("batch") == (None, 1)
    assert sharding.shard_activation(x, "batch", None, None) is x
    shape = {"data": 2, "model": 1}
    outer = {"batch": ("data",), "heads": "model", "moe_tokens": ("data",)}
    grid = ProcessGrid(2, 2, 3)                       # (d, m) = (1, 1)
    inner = {"batch": "data", "heads": "model", "both": ("data", "model")}
    with sharding.use_sharding_rules(shape, outer):
        assert sharding.current_mesh() is shape
        assert sharding.current_grid() is None
        assert sharding.bound_axes("moe_tokens") == ("data", 2)
        assert sharding.bound_axes("embed") == (None, 1)
        # a bare mesh shape: one process holds the whole, checked
        assert sharding.shard_activation(x, "batch", None, None) is x
        with pytest.raises(ValueError, match="2 axes for rank-3"):
            sharding.shard_activation(x, "batch", None)
        with sharding.use_sharding_rules(grid, inner):
            assert sharding.current_mesh() is grid
            assert sharding.current_grid() is grid
            assert sharding.bound_axes("both") == (("data", "model"), 4)
            # a grid: the block the rules give this rank of a whole value
            torch.testing.assert_close(
                sharding.shard_activation(x, "batch", None, "heads"),
                x[2:4, :, 1:2], rtol=0, atol=0)
            # a non-dividing dim stays whole (3 over 2 model ranks)
            torch.testing.assert_close(
                sharding.shard_activation(x, None, "heads", None), x,
                rtol=0, atol=0)
            # the other thread sees no binding
            seen = []
            t = threading.Thread(target=lambda: seen.append(
                sharding.current_mesh()))
            t.start()
            t.join()
            assert seen == [None]
        assert sharding.current_mesh() is shape
        assert sharding.bound_axes("heads") == ("model", 1)
        with pytest.raises(RuntimeError, match="inside"):
            with sharding.use_sharding_rules(grid, inner):
                raise RuntimeError("inside")
        assert sharding.current_mesh() is shape
    assert sharding.current_mesh() is None
    assert sharding.bound_axes("batch") == (None, 1)


def _refused(key, grid, overrides=None, cfg=None):
    """The sharded prefill step on rank 0 of ``grid``; with ``overrides``
    of its rules, what it computes under them."""
    cfg = cfg or _setup(key)[0]
    g = ProcessGrid(*grid, 0)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    if overrides:
        rules = build_rules(g, cfg, "prefill", 2, overrides=overrides)
        return lambda: tg.prefill_under(cfg, g, rules, params, tokens)
    step = make_prefill_step(cfg, "kernel", grid=g)
    return lambda: step(params, {"tokens": tokens})


REFUSED = {
    "attn_seq": (lambda: _refused("gemma", (1, 2), {"attn_seq": "model"}),
                 r"13b \(c\)"),
    "attn_din": (lambda: _refused("gemma", (1, 2), {"attn_din": "model"}),
                 r"13b \(c\)"),
    "heads-not-dividing": (lambda: _refused("gemma", (1, 3)), r"13b \(c\)"),
    "ssm": (lambda: _refused(None, (1, 2), cfg=reduced(get_arch(
        "mamba2-370m"))), r"13b \(c\)"),
    "lru": (lambda: _refused(None, (1, 2), cfg=reduced(get_arch(
        "recurrentgemma-2b"))), r"13b \(c\)"),
    "vision": (lambda: _refused(None, (2, 1), cfg=reduced(get_arch(
        "qwen2-vl-72b"))), r"13b \(c\)"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_unexecuted_bindings_raise(name):
    make, item = REFUSED[name]
    with pytest.raises(NotImplementedError, match=item):
        make()()


def test_decode_and_training_refuse_a_grid():
    cfg = _setup("gemma")[0]
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    cache = tf.init_cache(cfg, 2, 16, paged=(4, 8), device="cpu")
    table = torch.arange(4, dtype=torch.int32).view(2, 2)
    tokens = torch.zeros((2, 1), dtype=torch.int32)
    grid = ProcessGrid(1, 2, 0)
    with sharding.use_sharding_rules(grid, build_rules(grid, cfg, "decode",
                                                       2)):
        # a paged pool has no placement in the JAX package
        with pytest.raises(NotImplementedError, match="no paged pool"):
            tf.decode_step(params, cfg, tokens, cache,
                           torch.zeros(2, dtype=torch.int32), table=table)
        with pytest.raises(NotImplementedError, match=r"13b \(b\)"):
            tf.client_forward(params, cfg, tokens)
    # a batch that does not divide the data axis would be replicated
    g = ProcessGrid(2, 1, 0)
    step = make_prefill_step(cfg, "kernel", grid=g)
    with pytest.raises(ValueError, match="must split over the data axis"):
        step(params, {"tokens": torch.zeros((3, 4), dtype=torch.int32)})
