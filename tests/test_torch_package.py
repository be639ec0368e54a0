"""Package rules of the PyTorch port.

* No module of ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or anything of the JAX package ``repro`` (AST scan).
* Entry points default to the card and raise when there is none; the port
  never goes on on the CPU unless the caller passes ``device="cpu"``.
* Layer kinds and options that are not ported yet raise
  ``NotImplementedError``; the ported ones (local attention, the
  decode-window override) build.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch._bridge import params_from_jax
from repro_torch.config import (ATTN_LOCAL, TrainConfig, WSSLConfig,
                                get_arch, reduced)
from repro_torch.launch.mesh import spawn_client_shards
from repro_torch.sharding import init_shard_state
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as tf
from repro_torch.serve import DecodeEngine

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour does not apply")


def test_entry_points_raise_without_a_card():
    _no_card()
    cfg = reduced(get_arch("gemma-2b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"x": {"scale": np.zeros(2, np.float32)}}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "gemma-2b", "--reduced"])
    # the client axis: spawned shards default to the card too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_client_shards(print, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_shard_state(torch.Generator(), cfg, WSSLConfig(num_clients=4),
                         TrainConfig(), 2, 0)


def test_unported_layer_kinds_raise():
    cfg = reduced(get_arch("gemma-2b"))
    # the decode-window override is ported: the engine builds ring-sized
    # caches of the window for the global layers, paged or not
    eng = DecodeEngine(cfg, decode_window_override=16, device="cpu")
    for block_size in (0, 8):
        st = eng.new_batch_state(2, 64, block_size=block_size)
        for d in st.cache["stack"] + st.cache["rem"]:
            assert "pk" not in d and d["k"].shape[-3] == 16
    # local attention is ported: it builds and serves
    DecodeEngine(cfg.replace(pattern=(ATTN_LOCAL,), window=16), device="cpu")


@pytest.mark.parametrize("arch,extra", [
    ("gemma-2b", ["--prompt-len", "12", "--block-size", "8",
                  "--paged-kernel"]),
    # a Mamba-2 prompt of at most one reduced SSD chunk (32 tokens)
    ("mamba2-370m", ["--prompt-len", "32"]),
    ("olmoe-1b-7b", ["--prompt-len", "12", "--block-size", "8",
                     "--paged-kernel"]),
])
def test_cli_serves_requests_on_cpu(capsys, arch, extra):
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "3", "--replicas", "1", "--slots", "2",
                       "--gen", "6", "--impl", "kernel", *extra])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "tok/s" in out and arch in out
    assert "WARNING" not in out
