"""The dry run (``launch/dryrun.py``): every architecture x input shape
built and counted on the meta device, and its record.

* Tier 1: every arch x ``INPUT_SHAPES`` entry at reduced size on one
  card's mesh, full Gemma-2B ``prefill_32k``, the 16x16 and 2x16x16
  meshes (the sharded round over a ``MetaGroup``: collectives by kind),
  and the CLI.  Every tensor of the device path is a meta tensor: the
  only others are the round's host scalars, as on the card.
* The collective term of a 2-rank gloo sharded round: the aggregation's
  all-reduce, weighted 2x and summed over the ranks, is PR 25's byte
  model (``protocol.hierarchical_sync_bytes``, the decomposable branch);
  the rest is the shared stages' gradients and the round's scalars.
* ``slow``: every full-size entry on one card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_shards as ts
from _torch_threads import one_torch_thread  # noqa: F401
from repro.roofline import analysis as jan
from repro_torch.config import (INPUT_SHAPES, TrainConfig, WSSLConfig,
                                get_arch, list_archs, reduced)
from repro_torch.core.protocol import hierarchical_sync_bytes
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn_client_shards

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = list_archs()
JAX_KEYS = set(jan.RooflineReport(
    arch="a", shape="s", mesh="m", flops_per_device=1.0,
    bytes_per_device=1.0, coll_bytes_per_device=1.0,
    model_flops_global=1.0, chips=1).to_dict())


def _check_record(rec, arch, shape, mesh="1"):
    assert JAX_KEYS <= set(rec)
    assert rec["arch"] == arch and rec["shape"] == shape
    assert rec["mesh"] == mesh and rec["device"] == "meta"
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["model_flops_global"] > 0 and rec["mfu_bound"] > 0
    mem = rec["memory_per_device"]
    assert mem["peak_estimate_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert isinstance(mem["fits_80GB"], bool)
    assert sum(rec["argument_bytes"].values()) == \
        mem["argument_size_in_bytes"]
    devices = rec["op_outputs_by_device"]
    assert devices.get("meta", 0) > 0 and set(devices) <= {"meta", "cpu"}
    if INPUT_SHAPES[shape].kind != "train":
        # serving runs no host op at all
        assert set(devices) == {"meta"}
    else:
        # the round's host scalars only: the selection draw, the AdamW
        # scalars, the round and step counters
        host = rec["op_output_bytes_by_device"].get("cpu", 0)
        assert host <= 1024, host
        assert rec["host_decisions"]
    want = {"train": "fused_adamw", "prefill": None, "decode": None}
    kernel = want[INPUT_SHAPES[shape].kind]
    if kernel:
        assert rec["kernels"][kernel]["launches"] > 0


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_reduced_every_entry(arch, shape):
    rec = dryrun.count_one(arch, shape, reduce=True, verbose=False)
    _check_record(rec, arch, shape)
    cfg = reduced(get_arch(arch))
    assert rec["config"] == cfg.name
    if shape == "prefill_32k":
        # the card's prefill path: every attention, SSD and RG-LRU layer
        # credited at its kernel
        kinds = {s.mixer for s in cfg.layer_specs()}
        if kinds & {"global", "local"}:
            assert rec["kernels"]["flash_attention"]["launches"] > 0
        if "ssm" in kinds:
            assert rec["kernels"]["ssd_scan"]["launches"] > 0
        if "rglru" in kinds:
            assert rec["kernels"]["rg_lru_scan"]["launches"] > 0


def test_dryrun_full_gemma_prefill_32k():
    rec = dryrun.count_one("gemma-2b", "prefill_32k", verbose=False)
    _check_record(rec, "gemma-2b", "prefill_32k")
    cfg = get_arch("gemma-2b")
    assert rec["kernels"]["flash_attention"]["launches"] == cfg.num_layers
    # serving params in bf16 (fp32 norm scales), tokens (32, 32768) int32
    n = cfg.param_count()
    assert 2 * n < rec["argument_bytes"]["params"] < 2 * n + 4 * 40 * 2048
    assert rec["argument_bytes"]["batch"] == 32 * 32768 * 4
    assert rec["bottleneck"] == "compute"
    assert rec["t_count_s"] < 30


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_dryrun_meshes(mesh):
    rec = dryrun.count_one("gemma-2b", "train_4k", mesh=mesh, reduce=True,
                           verbose=False)
    _check_record(rec, "gemma-2b", "train_4k", mesh)
    assert rec["chips"] == (256 if mesh == "16x16" else 512)
    assert rec["model_axis"] == "even split" and rec["count_split"] == 16
    # one rank of the sharded round: the shared stages' gradients and the
    # aggregation tree's partial all-reduced, the losses gathered
    assert rec["coll_detail"]["all-reduce"] > 0
    assert rec["coll_detail"]["all-gather"] > 0
    assert rec["t_collective_s"] > 0
    one = dryrun.count_one("gemma-2b", "train_4k", reduce=True,
                           verbose=False)
    # a device holds 1/data of the client stacks' arguments
    assert rec["argument_bytes"]["state"] < one["argument_bytes"]["state"]
    dec = dryrun.count_one("gemma-2b", "decode_32k", mesh=mesh,
                           reduce=True, verbose=False)
    _check_record(dec, "gemma-2b", "decode_32k", mesh)
    assert dec["coll_bytes_per_device"] == 0
    lng = dryrun.count_one("gemma-2b", "long_500k", mesh=mesh, reduce=True,
                           verbose=False)
    # one row over every device: the whole batch counted, divided by all
    assert lng["count_split"] == lng["chips"]


def test_dryrun_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "decode_32k", "--reduced", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=120,
        env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.load(open(tmp_path / "mamba2-370m_decode_32k_1_reduced.json"))
    _check_record(rec, "mamba2-370m", "decode_32k")
    assert rec["reduced"] is True
    assert "dry-run complete" in r.stdout


def test_collective_term_of_a_gloo_sharded_round():
    cfg = reduced(get_arch("gemma-2b"))
    wssl_cfg = WSSLConfig(num_clients=4)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 1, 16)).astype(np.int32)
    ranks = spawn_client_shards(ts.count_round, 2,
                                (cfg, wssl_cfg, TrainConfig()), tokens,
                                device="cpu", backend="gloo", timeout=120.0,
                                threads=1)
    agg = sum(2 * r["by_site"]["aggregation"]["all-reduce"]
              for r in ranks)
    assert all(r["cross"] == ranks[0]["cross"] for r in ranks)
    stage = ranks[0]["cross"] / (2 * 2)
    cross, _ = hierarchical_sync_bytes(4.0, 4, 2, stage, True)
    assert agg == ranks[0]["cross"] == cross
    for r in ranks:
        coll = r["coll"]
        rest = coll["coll_all-reduce"] - r["by_site"][
            "aggregation"]["all-reduce"]
        # the shared stages' gradients (fp32) and a few fp32 scalars
        assert r["shared_bytes"] <= rest <= r["shared_bytes"] + 64
        # the per-client losses gathered: (N,) fp32
        assert coll["coll_all-gather"] == 4 * 4
        assert coll["coll_weighted"] == 2 * coll["coll_all-reduce"] + \
            coll["coll_all-gather"]


@pytest.mark.slow
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_full_size(arch, shape):
    rec = dryrun.count_one(arch, shape, verbose=False)
    _check_record(rec, arch, shape)
    assert rec["config"] == get_arch(arch).name
