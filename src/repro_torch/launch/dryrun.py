"""The dry run: every (architecture x input shape) step built and counted
on the meta device, and its roofline terms against one H100.

The twin of ``repro/launch/dryrun.py``.  JAX lowers and compiles each
step for 512 placeholder devices and parses the HLO; here each step runs
once on meta tensors (shapes and dtypes, no storage) under the op counter
(``roofline/op_cost.py``), which counts its FLOPs, bytes, collective
bytes and live-memory peak, with every hand-written kernel credited at
its cost (``roofline/analysis.py``).  Nothing is allocated and no card is
needed: the run is the same on the CPU as on the card's machine.

* ``train_4k``: one WSSL round (``launch/steps.py::make_train_step``),
  ``impl="chunked"``; ``prefill_32k``: the prefill step,
  ``impl="kernel"`` (flash, SSD-scan and RG-LRU kernels credited);
  ``decode_32k`` / ``long_500k``: one decode step against the cache
  (``long_500k`` under the config's long-context window).
* **Host decisions.**  A meta tensor has no values, so the round's host
  reads take host values: every client selected (round 0 selects every
  client anyway) and no fault plan; the record says so.
* **Meshes** (``--mesh``): ``1`` is one H100.  On ``16x16`` and
  ``2x16x16`` a device's share of the arguments is exact, from the
  placements of ``sharding.resolve_spec`` under ``specs.build_rules``.
  The step is counted for one data shard (a train step: one rank of the
  sharded round over a ``sharding.MetaGroup``, its collectives logged by
  kind; a serve step: the shard's rows, or the whole batch over every
  device when it has fewer rows than data shards) and divided evenly over
  the model axis: the record says ``model_axis: "even split"``, since no
  model axis runs yet.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh 16x16] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import sharding
from repro_torch.config import (INPUT_SHAPES, TrainConfig, WSSLConfig,
                                get_arch, list_archs, reduced)
from repro_torch.core import round as rnd
from repro_torch.launch import specs as sp
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import (MESHES, ClientGroup, data_axis_size,
                                     mesh_name, mesh_size, model_axis_size)
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import op_cost

# the impl each step kind runs when ``impl="auto"``: the card's paths
STEP_IMPLS = {"train": "chunked", "prefill": "kernel", "decode": None}


def _wssl_for_mesh(mesh) -> WSSLConfig:
    return WSSLConfig(num_clients=data_axis_size(mesh))


def build_step(model_cfg, shape, mesh, impl: str = "auto"):
    """(the step's zero-argument call on meta inputs, the arguments' bytes
    a device by part, how the count divides over the devices, the impl
    run, the rules).  Nothing is allocated."""
    kind = shape.kind
    impl = STEP_IMPLS[kind] if impl == "auto" else impl
    rules = sp.build_rules(mesh, model_cfg, kind, shape.global_batch)
    dsize, msize = data_axis_size(mesh), model_axis_size(mesh)
    dev_bytes = lambda axes, tree: sharding.device_bytes(mesh, rules, axes,
                                                         tree)
    if kind == "train":
        wssl_cfg, train_cfg = _wssl_for_mesh(mesh), TrainConfig()
        state, state_axes = rnd.abstract_state(model_cfg, wssl_cfg,
                                               train_cfg)
        batch, batch_axes = sp.batch_specs(model_cfg, shape, wssl_cfg)
        args = {"state": dev_bytes(state_axes, state),
                "batch": dev_bytes(batch_axes, batch)}
        if dsize == 1:
            step = st.make_train_step(model_cfg, wssl_cfg, train_cfg, impl)
        else:
            # one rank of the sharded round: its N/S clients' rows
            del state
            state = sharding.init_shard_state(None, model_cfg, wssl_cfg,
                                              train_cfg, dsize, 0,
                                              device="meta")
            batch = sharding.shard_batch(batch, dsize, 0)
            group = ClientGroup(group=sharding.MetaGroup(dsize),
                                num_shards=dsize, index=0, backend="meta")
            step = rnd.make_sharded_round_fn(model_cfg, wssl_cfg, train_cfg,
                                             group, impl=impl)
        call = lambda: step(state, batch)
        return call, args, msize, impl, rules
    params, param_axes = sp.serve_param_specs(model_cfg)
    batch, batch_axes = sp.batch_specs(model_cfg, shape)
    args = {"params": dev_bytes(param_axes, params),
            "batch": dev_bytes(batch_axes, batch)}
    gb = shape.global_batch
    rows, split = ((gb // dsize, msize) if gb % dsize == 0
                   else (gb, dsize * msize))
    batch = {k: v[:rows] for k, v in batch.items()}
    if kind == "prefill":
        step = st.make_prefill_step(model_cfg, impl)
        call = lambda: step(params, batch)
        return call, args, split, impl, rules
    cache, cache_axes = sp.cache_specs(model_cfg, shape)
    args["cache"] = dev_bytes(cache_axes, cache)
    if rows != gb:
        cache = sharding.map_axes(lambda ax, t: _rows(ax, t, rows),
                                  cache_axes, cache)
    step = st.make_serve_step(model_cfg, shape)
    call = lambda: step(params, cache, batch)
    return call, args, split, impl, rules


def _rows(axes, t: torch.Tensor, rows: int) -> torch.Tensor:
    """The first ``rows`` rows of ``t`` along its ``"batch"`` axis."""
    return t.narrow(axes.index("batch"), 0, rows) if "batch" in axes else t


def count_one(arch: str, shape_name: str, *, mesh: str = "1",
              impl: str = "auto", reduce: bool = False,
              verbose: bool = True) -> Dict[str, Any]:
    """Build and count one (arch, shape, mesh) on meta; return its
    record."""
    model_cfg = get_arch(arch)
    if reduce:
        model_cfg = reduced(model_cfg)
    shape = INPUT_SHAPES[shape_name]
    mesh_shape = MESHES[mesh]
    chips = mesh_size(mesh_shape)
    t0 = time.time()
    call, args, split, impl_run, rules = build_step(model_cfg, shape,
                                                    mesh_shape, impl)
    with op_cost.OpCounter() as counter:
        call()
    t_count = time.time() - t0
    tot = counter.totals()
    flops, nbytes = tot["flops"] / split, tot["bytes"] / split
    coll = {k.removeprefix("coll_"): v / split for k, v in tot.items()
            if k.startswith("coll_") and k != "coll_weighted"}
    arg_bytes = float(sum(args.values()))
    mem = ra.summarize_memory(arg_bytes,
                              arg_bytes + tot["peak_temp_bytes"] / split)
    report = ra.RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name(mesh_shape),
        flops_per_device=flops, bytes_per_device=nbytes,
        coll_bytes_per_device=ra.weighted_collective_bytes(coll),
        model_flops_global=ra.model_flops(model_cfg, shape),
        chips=chips, dtype=model_cfg.dtype, coll_detail=coll,
        memory_per_device=mem)
    rec = report.to_dict()
    rec.update(
        config=model_cfg.name, reduced=bool(reduce), impl=impl_run,
        device="meta", argument_bytes=args, count_split=split,
        model_axis=("even split" if model_axis_size(mesh_shape) > 1
                    else "none"),
        elementwise_ops_per_device=tot["elementwise_ops"] / split,
        transfer_bytes=tot["transfer_bytes"],
        kernels=tot["kernels"], op_outputs_by_device=tot["devices"],
        op_output_bytes_by_device=tot["device_output_bytes"],
        top_ops=counter.top_ops(10), t_count_s=t_count,
        rules={k: str(v) for k, v in rules.items()})
    if shape.kind == "train":
        rec["host_decisions"] = "every client selected; no fault plan"
    if verbose:
        print(f"== {arch} x {shape_name} x {rec['mesh']} "
              f"({impl_run}, counted in {t_count:.1f}s)")
        print(f"   memory/device: args={arg_bytes / 2**30:.2f}GiB "
              f"peak~{mem['peak_estimate_bytes'] / 2**30:.2f}GiB "
              f"fits80GB={mem['fits_80GB']}")
        print(f"   flops/dev={flops:.3e} bytes/dev={nbytes:.3e} "
              f"coll/dev={report.coll_bytes_per_device:.3e}")
        print(f"   t_comp={report.t_compute * 1e3:.2f}ms "
              f"t_mem={report.t_memory * 1e3:.2f}ms "
              f"t_coll={report.t_collective * 1e3:.2f}ms -> "
              f"{report.bottleneck}-bound, MODEL/counted="
              f"{report.model_flops_ratio:.2f} mfu_bound="
              f"{report.mfu_bound:.2f}")
    return rec


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="1", choices=list(MESHES))
    ap.add_argument("--impl", default="auto",
                    help="auto: chunked for train, kernel for prefill")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs (tests)")
    ap.add_argument("--out", default="out/dryrun")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            # a reduced record never stands in for a full-size one
            tag = (f"{arch}_{shape}_{args.mesh}"
                   + ("_reduced" if args.reduced else ""))
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"-- skip {tag} (exists)")
                continue
            try:
                rec = count_one(arch, shape, mesh=args.mesh, impl=args.impl,
                                reduce=args.reduced)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                failures.append((tag, str(e)))
    if failures:
        print("FAILURES:")
        for tag, err in failures:
            print(" ", tag, err.splitlines()[0] if err else "")
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
