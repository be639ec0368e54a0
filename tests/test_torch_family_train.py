"""The recurrent families trained through the port's WSSL round, against
the live JAX round on the same inputs.

* ``reduced(mamba2-370m)`` (2 SSD layers, cut 1) at sequence 64, two SSD
  chunks of 32, so the state crosses a chunk boundary in the forward and
  the backward; the same at 3 layers with two cuts (1, 2), so one edge
  stage relays.
* ``reduced(recurrentgemma-2b)`` at 5 layers (two RG-LRU + local
  super-blocks and one RG-LRU remainder layer, which the server holds),
  cut 2, at sequence 96, past the reduced window of 64.

Both packages train with ``impl="dense"``: the plain scans (JAX's
associative scan and ``ssd_chunked``), as the JAX package trains them.
Two rounds of 4 clients at participation 0.5, the JAX Gumbel draws
injected, fp32.  Bands, as ``tests/test_torch_round.py`` holds the dense
round: masks and byte counts exact; losses, per-client losses, validation
losses and importance rel 1e-5 (measured at most 2.2e-6); trained stages
max |diff| 2 lr per round (AdamW's first step is +-lr wherever a
gradient's sign rides on rounding noise; measured max 5.4e-4, on the
multi-hop edge stage), mean |diff| 1e-7 (measured at most 3.2e-8) and
99.9th percentile 5e-6 (measured at most 9.0e-7); moments atol 1e-6
(measured at most 3.6e-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import TrainConfig as JTrainConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.core.round import init_state as jax_init_state
from repro.core.round import make_round_fn as jax_make_round_fn
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro_torch._bridge import state_from_jax, state_to_numpy
from repro_torch.config import TrainConfig, WSSLConfig, get_arch, reduced
from repro_torch.core.round import make_round_fn
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch import train as launch_train

TRAIN_KW = dict(remat=False, learning_rate=1e-3, warmup_steps=0,
                schedule="constant")
LR = 1e-3
# name: (arch, layers, cut keyword, sequence length)
CASES = {"mamba2": ("mamba2-370m", 2, {"split_layer": 1}, 64),
         "mamba2-multihop": ("mamba2-370m", 3, {"split_layers": (1, 2)}, 64),
         "recurrentgemma": ("recurrentgemma-2b", 5, {"split_layer": 2}, 96)}


def _np_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


@functools.lru_cache(maxsize=None)
def _jax_rounds(name):
    """JAX: the initial state (numpy), each round's Gumbel draw and
    metrics, and the final state (numpy)."""
    arch, layers, cut, seq = CASES[name]
    jm = jax_reduced(jax_get_arch(arch)).replace(num_layers=layers)
    w = JWSSLConfig(num_clients=4, participation_fraction=0.5, **cut)
    t = JTrainConfig(**TRAIN_KW)
    # one jitted init: run eagerly, every op would compile on its own
    state = jax.jit(lambda key: jax_init_state(key, jm, w, t)[0])(
        jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state)
    rf = jax_make_round_fn(jm, w, t, impl="dense", donate=True)
    val = {k: jnp.asarray(v) for k, v in
           jax_lm_batch(2, seq, jm.vocab_size, seed=999).items()}
    gumbels, metrics = [], []
    for r in range(2):
        _, rng_sel = jax.random.split(state.rng)
        gumbels.append(np.asarray(jax.random.gumbel(rng_sel, (4,))))
        d = jax_lm_batch(8, seq, jm.vocab_size, seed=r)
        batch = {k: jnp.asarray(v).reshape(4, 2, seq) for k, v in d.items()}
        state, m = rf(state, batch, val)
        metrics.append(jax.tree.map(np.asarray, m._asdict()))
    return init, gumbels, metrics, jax.tree.map(np.asarray, state)


@functools.lru_cache(maxsize=None)
def _torch_rounds(name):
    """The port: the same two rounds from the bridged JAX state, the JAX
    Gumbel draws injected.  Returns the state and each round's metrics."""
    arch, layers, cut, seq = CASES[name]
    init, gumbels, _, _ = _jax_rounds(name)
    cfg = reduced(get_arch(arch)).replace(num_layers=layers)
    state = state_from_jax(init, cfg, device="cpu")
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(
        (state.client_stack, state.server_params, state.edge_stages)))
    rf = make_round_fn(cfg, WSSLConfig(num_clients=4,
                                       participation_fraction=0.5, **cut),
                       TrainConfig(**TRAIN_KW), impl="dense")
    val = {k: torch.as_tensor(v) for k, v in
           lm_batch(2, seq, cfg.vocab_size, seed=999).items()}
    metrics = []
    for r in range(2):
        d = lm_batch(8, seq, cfg.vocab_size, seed=r)
        batch = {k: torch.as_tensor(v).reshape(4, 2, seq)
                 for k, v in d.items()}
        state, m = rf(state, batch, val, gumbel=torch.tensor(gumbels[r]))
        metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("name", list(CASES))
def test_two_rounds_match_live_jax_round(name):
    _, _, jmetrics, jstate = _jax_rounds(name)
    state, metrics = _torch_rounds(name)
    for m, jm in zip(metrics, jmetrics):
        np.testing.assert_array_equal(m.mask.numpy(), jm["mask"])
        for f in ("loss", "per_client_loss", "val_loss", "importance"):
            np.testing.assert_allclose(getattr(m, f).numpy(), jm[f],
                                       rtol=1e-5, atol=1e-7, err_msg=f)
        for f in ("bytes_up", "bytes_down", "bytes_per_hop", "bytes_sync",
                  "bytes_update_raw", "bytes_update_comp"):
            np.testing.assert_array_equal(np.asarray(getattr(m, f)), jm[f],
                                          err_msg=f)
    got = state_to_numpy(state)
    assert int(got["round_index"]) == int(jstate.round_index) == 2
    diffs = []
    for f in ("client_stack", "server_params", "edge_stages"):
        a, b = _np_leaves(got[f]), _np_leaves(getattr(jstate, f))
        assert [x.shape for x in a] == [x.shape for x in b]
        diffs += [np.abs(x - y).ravel() for x, y in zip(a, b)]
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * LR * 2, diffs.max()
    assert diffs.mean() <= 1e-7, diffs.mean()
    assert np.quantile(diffs, 0.999) <= 5e-6
    for f, jf in (("opt_client", jstate.opt_client),
                  ("opt_server", jstate.opt_server)):
        assert int(got[f]["step"]) == int(jf.step) == 2
        for k in ("m", "v"):
            for a, b in zip(_np_leaves(got[f][k]), _np_leaves(getattr(jf, k))):
                np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(got["importance"], jstate.importance,
                               rtol=1e-5)


def test_server_holds_the_remainder_layer():
    """RecurrentGemma at 5 layers, cut 2: the client holds one super-block,
    the server the other and the RG-LRU remainder layer, whose fp32 gate
    and decay leaves train like any other and land where JAX's do."""
    init, _, _, jstate = _jax_rounds("recurrentgemma")
    state, _ = _torch_rounds("recurrentgemma")
    assert len(state.server_params["rem"]) == 1
    assert state.client_stack["stack"][0]["mixer"]["w_r"].shape[:2] == (4, 1)
    rem = state.server_params["rem"][0]["mixer"]
    before = init.server_params["rem"][0]["mixer"]
    after = jstate.server_params["rem"][0]["mixer"]
    for k in ("w_r", "w_i", "b_r", "b_i", "lambda"):
        assert rem[k].dtype == torch.float32
        assert not np.array_equal(np.asarray(before[k]), rem[k].numpy()), k
        np.testing.assert_allclose(rem[k].numpy(), np.asarray(after[k]),
                                   atol=2 * LR * 2, err_msg=k)


@pytest.mark.parametrize("arch,seq,ok", [
    ("mamba2-370m", 48, False),       # neither one chunk of 32 nor two
    ("mamba2-370m", 24, True),        # under one chunk
    ("recurrentgemma-2b", 48, True),  # no SSD layer: any length
])
def test_cli_trains_the_families_and_keeps_the_ssd_rule(capsys, arch, seq, ok):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--clients", "2",
            "--rounds", "2", "--seq-len", str(seq), "--batch-per-client", "1"]
    if not ok:
        with pytest.raises(ValueError, match="multiple of the chunk"):
            launch_train.main(argv)
        return
    launch_train.main(argv)
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out and out.count("loss=") == 2
    assert "nan" not in out
