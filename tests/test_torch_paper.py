"""The paper's own experiment in the port — the data, the gait FFN and
ResNet-18, selection and the paper loop — against the JAX package on the
same inputs.

* ``data/{synthetic,partition,pipeline}.py`` and
  ``configs/wssl_paper.py`` are copies: every array, index set and batch
  equals JAX's exactly.
* ``models/paper_models.py``: the parameter trees have JAX's leaf order,
  shapes and bytes; the forward logits, the cut activation and the split
  grads on bridged params agree with JAX within rel 1e-5 (fp32, other
  summation orders: measured 2.5e-6 at most on CifarLite); the SAME
  padding of a convolution equals ``lax.conv_general_dilated``'s at stride
  1 and 2 on even and odd inputs (a 3x3 stride-2 convolution on an even
  input pads (0, 1)).
* ``core/wssl.py::select_clients`` with JAX's Gumbel draw: exact.
* ``core/paper_loop.py``: ``train_wssl`` on gait (3 clients x 3 rounds x 2
  local steps) and on CifarLite (2 clients x 2 rounds x 2 steps) against
  the live JAX loop, with JAX's initial params and Gumbel draws injected;
  ``train_centralized`` on gait.  Selections, participation and byte
  counts exact.  Bands: AdamW's first steps are +-lr wherever a
  gradient's sign rides on rounding noise, and one such coordinate moves
  every later output a little, more in the deeper ResNet.  Gait: test
  and validation losses atol 1e-5 (measured 1.2e-7), importance atol
  1e-6 (measured 0), accuracy within one test example (measured 0).
  CifarLite: test and validation losses atol 5e-3 (measured 1.1e-3),
  importance atol 5e-4 (measured 7.6e-5), accuracy within 3 of 120 test
  examples (measured 1).
* A finite async deadline, the one option not ported, raises naming its
  ROADMAP item (scenarios, robust rules and compressed uploads run:
  ``tests/test_torch_{sim,robust}.py``); the entry points default to the
  card and raise without one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.config import WSSLConfig as JWSSLConfig
from repro.configs import wssl_paper as jcfgs
from repro.core import paper_loop as jpl
from repro.core import wssl as jwssl
from repro.data import partition as jpart
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import paper_models as jpm
from repro_torch._bridge import paper_params_from_jax, paper_params_to_numpy
from repro_torch.config import AsyncRoundsConfig, Scenario, WSSLConfig
from repro_torch.configs import wssl_paper as cfgs
from repro_torch.core import paper_loop as pl
from repro_torch.core import wssl
from repro_torch.core.protocol import tree_bytes
from repro_torch.core.split import split_grads
from repro_torch.data import partition, pipeline, synthetic
from repro_torch.models import paper_models as pm


def _eq(a, b):
    assert type(a) is type(b) or isinstance(a, np.ndarray)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Data and configs: copies, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("maker,kw", [
    ("make_gait_like", dict(n=3000, seed=3)),
    ("make_gait_like", dict(n=500, num_subjects=7, noise=0.3, seed=1)),
    ("make_image_like", dict(n=200, seed=2)),
    ("make_image_like", dict(n=50, size=16, label_flip=0.0, seed=5)),
])
def test_synthetic_makers_equal_jax(maker, kw):
    _eq(getattr(synthetic, maker)(**kw), getattr(jsyn, maker)(**kw))


@functools.lru_cache(maxsize=None)
def _labels():
    d = synthetic.make_gait_like(n=2000, seed=4)
    return d["y"], d["subject"]


@pytest.mark.parametrize("name,call", [
    ("iid", lambda m, y, s: m.partition_iid(len(y), 5, seed=2)),
    ("stratified", lambda m, y, s: m.partition_stratified(y, 4, seed=1)),
    ("dirichlet", lambda m, y, s: m.partition_dirichlet(y, 6, alpha=0.3,
                                                        seed=3)),
    ("dirichlet-floor", lambda m, y, s: m.partition_dirichlet(
        y[:40], 8, alpha=0.05, seed=0, min_per_client=8)),
    ("scenario-clean", lambda m, y, s: m.partition_for_scenario(y, 3)),
    ("scenario-skew", lambda m, y, s: m.partition_for_scenario(
        y, 3, Scenario(skew_alpha=0.5, seed=2), seed=1)),
    ("subject", lambda m, y, s: m.partition_by_subject(s, 7)),
])
def test_partitions_equal_jax(name, call):
    y, s = _labels()
    _eq(call(partition, y, s), call(jpart, y, s))


def test_client_loaders_equal_jax():
    """Epoch wrap-around, the data-poor client's draws with replacement,
    and the stacked batch of every client."""
    d = synthetic.make_gait_like(n=600, seed=6)
    data = {"x": d["x"], "y": d["y"]}
    parts = partition.partition_by_subject(d["subject"], 3)
    parts.append(parts[0][:5])                 # fewer rows than a batch
    mine = [pipeline.ClientLoader(data, p, 64, seed=i)
            for i, p in enumerate(parts)]
    theirs = [jpipe.ClientLoader(data, p, 64, seed=i)
              for i, p in enumerate(parts)]
    assert [len(l) for l in mine] == [len(l) for l in theirs]
    for _ in range(6):
        for a, b in zip(mine, theirs):
            _eq(a.next_batch(), b.next_batch())
        _eq(pipeline.stacked_client_batch(mine),
            jpipe.stacked_client_batch(theirs))


def test_paper_configs_equal_jax():
    for name in ("GaitConfig", "CifarConfig", "CifarLiteConfig"):
        mine, theirs = getattr(cfgs, name)(), getattr(jcfgs, name)()
        assert vars(mine) == vars(theirs), name
    assert cfgs.GaitConfig().param_count() == jcfgs.GaitConfig().param_count()


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


def _jax_split(kind, cfg_name, key=1):
    jc = getattr(jcfgs, cfg_name)()
    if kind == "gait":
        return jc, jpm.gait_split_params(jc, jpm.gait_init(
            jax.random.PRNGKey(key), jc))
    return jc, jpm.resnet_init_split(jax.random.PRNGKey(key), jc)


@pytest.mark.parametrize("kind,cfg_name,leaves", [
    ("gait", "GaitConfig", (4, 6)),
    ("resnet", "CifarConfig", (15, 47)),
    ("resnet", "CifarLiteConfig", (9, 29)),
])
def test_param_trees_match_jax_layout(kind, cfg_name, leaves):
    """The port's own init: JAX's nesting, leaf order, shapes and bytes,
    every leaf fp32 and contiguous (AdamW views each as one row)."""
    jc, jstages = _jax_split(kind, cfg_name)
    cfg = getattr(cfgs, cfg_name)()
    ad = pl.gait_adapter(cfg) if kind == "gait" else pl.resnet_adapter(cfg)
    stages = ad.init_split(torch.Generator().manual_seed(0))
    for st, jst, count in zip(stages, jstages, leaves):
        assert jax.tree.structure(jax.tree.map(lambda t: 0, st)) == \
            jax.tree.structure(jax.tree.map(lambda t: 0, jst))
        assert [tuple(t.shape) for t in tree_leaves(st)] == \
            [tuple(t.shape) for t in jax.tree.leaves(jst)]
        assert len(tree_leaves(st)) == count
        assert all(t.dtype == torch.float32 and t.is_contiguous()
                   for t in tree_leaves(st))
        assert tree_bytes(st) == sum(t.nbytes for t in jax.tree.leaves(jst))


@pytest.mark.parametrize("size,k,stride", [
    (8, 3, 2), (7, 3, 2), (8, 1, 2), (7, 1, 2), (6, 3, 1), (5, 3, 3)])
def test_conv_same_padding_matches_xla(size, k, stride):
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = pm._conv(torch.as_tensor(x).permute(0, 3, 1, 2),
                   torch.as_tensor(w), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("kind,cfg_name", [("gait", "GaitConfig"),
                                           ("resnet", "CifarLiteConfig")])
def test_forward_and_split_grads_match_jax(kind, cfg_name):
    """Logits, the cut activation and the split step's grads on bridged
    params.  CifarLite's stages 2-4 open with a stride-2 block on an even
    input (32 -> 16 -> 8 -> 4), where XLA pads (0, 1)."""
    jc, jstages = _jax_split(kind, cfg_name)
    cfg = getattr(cfgs, cfg_name)()
    jad = jpl.gait_adapter(jc) if kind == "gait" else jpl.resnet_adapter(jc)
    ad = pl.gait_adapter(cfg) if kind == "gait" else pl.resnet_adapter(cfg)
    stages = paper_params_from_jax(jax.tree.map(np.asarray, jstages),
                                   device="cpu")
    rng = np.random.default_rng(0)
    if kind == "gait":
        x = rng.normal(size=(16, cfg.in_features)).astype(np.float32)
        y = rng.integers(0, 2, 16).astype(np.int32)
    else:
        x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, 4).astype(np.int32)
    ja = jad.client_apply(jstages[0], jnp.asarray(x))
    ta = ad.client_apply(stages[0], torch.as_tensor(x))
    if kind == "resnet":
        assert ta.shape == (4, cfg.widths[0], 32, 32)
        ta_nhwc = ta.permute(0, 2, 3, 1)
    else:
        ta_nhwc = ta
    assert _rel(ta_nhwc.detach().numpy(), np.asarray(ja)) <= 1e-5
    jl = jad.server_apply(jstages[1], ja)
    tl = ad.server_apply(stages[1], ta)
    assert _rel(tl.detach().numpy(), np.asarray(jl)) <= 1e-5

    def jloss(cp, sp):
        return jad.loss(jad.server_apply(sp, jad.client_apply(
            cp, jnp.asarray(x))), jnp.asarray(y))

    jval, jg = jax.value_and_grad(jloss, argnums=(0, 1))(*jstages)
    res = split_grads(lambda p: ad.client_apply(p, torch.as_tensor(x)),
                      lambda p, a: ad.loss(ad.server_apply(p, a),
                                           torch.as_tensor(y)),
                      stages[0], stages[1])
    np.testing.assert_allclose(float(res.loss), float(jval), rtol=1e-5)
    got = paper_params_to_numpy((res.grads_client, res.grads_server))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jg)):
        assert _rel(a, np.asarray(b)) <= 1e-5


def test_bridge_roundtrip():
    _, jstages = _jax_split("resnet", "CifarLiteConfig")
    np_stages = jax.tree.map(np.asarray, jstages)
    back = paper_params_to_numpy(paper_params_from_jax(np_stages,
                                                       device="cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_stages)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("round_index,beta", [(0, 0.0), (1, 0.0), (3, 0.0),
                                              (2, 0.7)])
def test_select_clients_matches_jax(round_index, beta):
    n = 6
    jc = JWSSLConfig(num_clients=n, participation_fraction=0.5,
                     select_staleness_beta=beta)
    c = WSSLConfig(num_clients=n, participation_fraction=0.5,
                   select_staleness_beta=beta)
    key = jax.random.PRNGKey(round_index + 11)
    w = np.asarray(jax.random.dirichlet(key, jnp.ones(n)), np.float32)
    pen = np.arange(n, dtype=np.float32) / n
    jidx, jmask = jwssl.select_clients(key, jnp.asarray(w), jc, round_index,
                                       penalty=jnp.asarray(pen))
    idx, mask = wssl.select_clients(
        torch.tensor(w), c, round_index,
        gumbel=torch.tensor(np.asarray(jax.random.gumbel(key, (n,)))),
        penalty=torch.as_tensor(pen))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


# ---------------------------------------------------------------------------
# The paper loop against the live JAX loop
# ---------------------------------------------------------------------------

# name: (model, clients, rounds, local steps, n, batch, lr, bands)
LOOPS = {"gait": ("gait", 3, 3, 2, 3000, 128, 2e-3,
                  dict(loss=1e-5, importance=1e-6, examples=1)),
         "cifarlite": ("resnet", 2, 2, 2, 600, 32, 2e-3,
                       dict(loss=5e-3, importance=5e-4, examples=3))}


@functools.lru_cache(maxsize=None)
def _experiment(name):
    """The paper benchmark's 70 / 10 / 20 split of a synthetic dataset,
    the adapters of both packages and a loader factory."""
    kind, nc, _, _, n, bs, _, _ = LOOPS[name]
    if kind == "gait":
        data = synthetic.make_gait_like(n=n, seed=0)
        jad, ad = (jpl.gait_adapter(jcfgs.GaitConfig()),
                   pl.gait_adapter(cfgs.GaitConfig()))
    else:
        data = synthetic.make_image_like(n=n, seed=0)
        jad, ad = (jpl.resnet_adapter(jcfgs.CifarLiteConfig()),
                   pl.resnet_adapter(cfgs.CifarLiteConfig()))
    n_tr, n_val = int(n * 0.7), int(n * 0.1)
    xy = lambda lo, hi: {k: data[k][lo:hi] for k in ("x", "y")}
    tr, val, test = xy(0, n_tr), xy(n_tr, n_tr + n_val), xy(n_tr + n_val, n)
    parts = (partition.partition_by_subject(data["subject"][:n_tr], nc)
             if kind == "gait" else
             partition.partition_stratified(tr["y"], nc, seed=0))

    def loaders(mod):
        return [mod.ClientLoader(tr, p, bs, seed=i)
                for i, p in enumerate(parts)]

    return jad, ad, tr, val, test, loaders


@functools.lru_cache(maxsize=None)
def _jax_wssl(name):
    """The JAX loop's history, its initial params (numpy) and each round's
    Gumbel draw, rebuilt from its key chain."""
    _, nc, rounds, steps, _, _, lr, _ = LOOPS[name]
    jad, _, _, val, test, loaders = _experiment(name)
    rng, sub = jax.random.split(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jad.init_split(sub))
    gumbels = []
    for _ in range(rounds):
        rng, sub = jax.random.split(rng)
        gumbels.append(np.asarray(jax.random.gumbel(sub, (nc,))))
    hist = jpl.train_wssl(jad, loaders(jpipe), val, test,
                          JWSSLConfig(num_clients=nc,
                                      participation_fraction=0.5),
                          rounds=rounds, local_steps=steps, lr=lr, seed=0)
    return hist, init, gumbels


@pytest.mark.parametrize("name", list(LOOPS))
def test_train_wssl_matches_live_jax_loop(name):
    _, nc, rounds, steps, _, _, lr, band = LOOPS[name]
    _, ad, _, val, test, loaders = _experiment(name)
    jh, init, gumbels = _jax_wssl(name)
    h = pl.train_wssl(ad, loaders(pipeline), val, test,
                      WSSLConfig(num_clients=nc, participation_fraction=0.5),
                      rounds=rounds, local_steps=steps, lr=lr, seed=0,
                      device="cpu", init=init,
                      gumbels=[torch.tensor(g) for g in gumbels])
    for k in ("round", "selected", "dropped", "participation", "bytes_up",
              "bytes_sync", "bytes_up_total", "bytes_sync_total", "arrived",
              "buffered", "evicted", "mean_staleness", "scenario", "comm"):
        assert h[k] == jh[k], k
    assert set(jh) <= set(h)
    for k in ("test_loss", "val_loss"):
        np.testing.assert_allclose(h[k], jh[k], rtol=0, atol=band["loss"],
                                   err_msg=k)
    np.testing.assert_allclose(h["importance"], jh["importance"], rtol=0,
                               atol=band["importance"])
    n_test = len(test["y"])
    acc_diff = np.abs(np.asarray(h["test_acc"]) - np.asarray(jh["test_acc"]))
    assert np.all(acc_diff * n_test <= band["examples"] + 1e-3), acc_diff
    assert all(np.isfinite(h["train_loss"]))
    assert h["best_acc"] == max(h["test_acc"])


def test_train_centralized_matches_jax_gait():
    _, _, rounds, steps, _, bs, lr, band = LOOPS["gait"]
    jad, ad, tr, _, test, _ = _experiment("gait")
    init = jax.tree.map(np.asarray, jad.init_split(jax.random.PRNGKey(0)))
    idx = np.arange(len(tr["y"]))
    jh = jpl.train_centralized(jad, jpipe.ClientLoader(tr, idx, bs, seed=0),
                               test, rounds=rounds, steps_per_round=steps,
                               lr=lr, seed=0)
    h = pl.train_centralized(ad, pipeline.ClientLoader(tr, idx, bs, seed=0),
                             test, rounds=rounds, steps_per_round=steps,
                             lr=lr, seed=0, device="cpu", init=init)
    assert h["round"] == jh["round"]
    np.testing.assert_allclose(h["test_loss"], jh["test_loss"], rtol=0,
                               atol=band["loss"])
    acc_diff = np.abs(np.asarray(h["test_acc"]) - np.asarray(jh["test_acc"]))
    assert np.all(acc_diff * len(test["y"]) <= band["examples"] + 1e-3)


def test_own_init_trains_and_is_seeded():
    """Without injected draws the loop takes its params and Gumbel noise
    from ``torch.Generator(seed)``: the same seed gives the same history,
    and the gait FFN learns the planted rule."""
    _, ad, _, val, test, loaders = _experiment("gait")
    run = lambda seed: pl.train_wssl(
        ad, loaders(pipeline), val, test,
        WSSLConfig(num_clients=3, participation_fraction=0.5), rounds=3,
        local_steps=4, lr=2e-3, seed=seed, device="cpu")
    a, b = run(0), run(0)
    assert a["selected"] == b["selected"] and a["test_acc"] == b["test_acc"]
    assert a["best_acc"] > 0.6


# ---------------------------------------------------------------------------
# What is not ported, and the default device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what,item", [("async", "item 10")])
def test_unported_options_raise(what, item):
    _, ad, _, val, test, loaders = _experiment("gait")
    with pytest.raises(NotImplementedError, match=item):
        cfg = WSSLConfig(num_clients=3,
                         async_rounds=AsyncRoundsConfig(deadline=2.0))
        pl.train_wssl(ad, loaders(pipeline), val, test, cfg, rounds=1,
                      local_steps=1, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour does not apply")
    _, ad, tr, val, test, loaders = _experiment("gait")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pl.train_wssl(ad, loaders(pipeline), val, test,
                      WSSLConfig(num_clients=3), rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pl.train_centralized(ad, pipeline.ClientLoader(
            tr, np.arange(10), 4), test, rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_params_from_jax({"w": np.zeros(2, np.float32)})


def test_true_fp32_is_scoped():
    """The loop's TF32 switch restores the flags it found."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
              cudnn.allow_tf32, matmul.allow_tf32)
    with pl.true_fp32():
        assert not cudnn.allow_tf32 and not matmul.allow_tf32
        assert cudnn.enabled == before[0]
    assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
            cudnn.allow_tf32, matmul.allow_tf32) == before
