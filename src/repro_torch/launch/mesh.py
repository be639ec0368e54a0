"""The mesh shapes of the placement arithmetic, the client axis of a
sharded round, and the (data x model) grid of ranks of a sharded step:
``torch.distributed`` process groups, one rank a device of the mesh.

**Mesh shapes** (the twin of ``repro/launch/mesh.py``'s
``make_production_mesh``, ``mesh_info``, ``data_axis_size`` and
``model_axis_size``): a mesh here is its axis-name -> size map, e.g.
``{"data": 16, "model": 16}``.  It feeds the logical-axis rules of
``sharding.py`` and the dry run (``launch/dryrun.py``) and creates no
process group.  Every function also takes an object with a ``.shape``
map (a JAX mesh, a :class:`ProcessGrid`, or a test's stand-in).

**The client axis** (the twin of ``make_client_mesh(shards)``).  JAX
builds a mesh of devices and runs the round once per shard under
``shard_map``; here each shard is a process, and the process group is
the mesh's data axis:

* :func:`make_client_group` describes the group a rank is in
  (:class:`ClientGroup`: the group, ``num_shards``, ``index``, backend);
* :func:`client_process_group` joins one rank to a group over a
  ``FileStore`` and leaves it on exit (the in-process S = 1 case);
* :func:`spawn_client_shards` runs a function in one process a shard and
  returns each rank's result.

**The grid** (the twin of ``make_client_mesh(shards, model)``, a mesh
with a ``model`` axis).  :class:`ProcessGrid` is one rank's view of a
``data x model`` grid: rank ``d * M + m`` sits at coordinates ``(d, m)``
and joins two subgroups, its **model group** (the ranks with its ``d``)
and its **data group** (the ranks with its ``m``); the default group is
the whole grid (``group_of(("data", "model"))``).  ``.shape`` is the
axis-size map, so ``launch/specs.py::build_rules`` and
``sharding.resolve_spec`` / ``device_bytes`` take a grid as they take a
mesh shape.  :func:`make_grid` builds it on an initialized default group
and :func:`spawn_grid` runs a function on every rank of a new grid, as
:func:`spawn_client_shards` runs the client axis.

NCCL takes one rank a card, so it is the default only when every rank
has a card of its own; on the CPU, or when ranks share a card, the
backend is gloo (which takes CUDA tensors, copying them through host
memory).  Every rendezvous, collective and join waits at most
``timeout`` seconds, a rank's exception re-raises in the caller, and a
rank asked for ``cuda`` without a card raises: there is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist


MeshShape = Dict[str, int]

# the meshes the dry run places on: one card, a 16x16 pod, two pods
MESHES = {"1": {"data": 1, "model": 1},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    """16x16 single pod (256 devices) or 2x16x16 (512 devices, 2 pods), as
    ``make_production_mesh`` lays them out."""
    return dict(MESHES["2x16x16" if multi_pod else "16x16"])


def _shape(mesh) -> MeshShape:
    return dict(getattr(mesh, "shape", mesh))


def mesh_info(mesh) -> MeshShape:
    return _shape(mesh)


def mesh_size(mesh) -> int:
    n = 1
    for v in _shape(mesh).values():
        n *= v
    return n


def mesh_name(mesh) -> str:
    """"1" for one device, else the axis sizes joined by "x"."""
    sizes = list(_shape(mesh).values())
    return "1" if mesh_size(mesh) == 1 else "x".join(map(str, sizes))


def data_axis_size(mesh) -> int:
    shape = _shape(mesh)
    n = 1
    for a in ("pod", "data"):
        if a in shape:
            n *= shape[a]
    return n


def model_axis_size(mesh) -> int:
    return _shape(mesh).get("model", 1)


@dataclass(frozen=True)
class ClientGroup:
    """The client axis as seen from one rank."""

    group: Any          # the torch.distributed process group
    num_shards: int     # S, the group's size
    index: int          # this rank's shard: clients index*N/S .. (index+1)*N/S-1
    backend: str        # "nccl" or "gloo"


def default_backend(device, shards: int) -> str:
    """NCCL when each of ``shards`` ranks has a card of its own, gloo on
    the CPU or when ranks share a card (NCCL refuses two ranks on one
    GPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= shards:
        return "nccl"
    return "gloo"


def make_client_group(shards: int,
                      num_clients: Optional[int] = None) -> ClientGroup:
    """This rank's view of a client axis of ``shards`` shards: the default
    process group, which must be initialized, must have exactly
    ``shards`` ranks, and ``num_clients``, when given, must divide evenly
    over them."""
    if not dist.is_initialized():
        raise RuntimeError("make_client_group: no process group; join one "
                           "first (client_process_group, or a rank of "
                           "spawn_client_shards)")
    group = dist.group.WORLD
    world = dist.get_world_size(group)
    if world != shards:
        raise ValueError(f"make_client_group({shards}) needs {shards} ranks, "
                         f"have {world}")
    if num_clients is not None and num_clients % shards != 0:
        raise ValueError(f"num_clients={num_clients} must divide evenly over "
                         f"{shards} client shards")
    return ClientGroup(group=group, num_shards=shards,
                       index=dist.get_rank(group),
                       backend=dist.get_backend(group))


def _rank_device(device, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a shard was asked for cuda "
                           "(pass device='cpu' to run on the CPU)")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


@dataclass(frozen=True)
class ProcessGrid:
    """A ``data x model`` grid of ranks as seen from rank ``rank``: its
    coordinates ``(d, m) = divmod(rank, model)``, its model group (the
    ranks ``d * model + 0 .. model - 1``), its data group (the ranks
    ``0 * model + m .. (data - 1) * model + m``).  Without groups (None)
    it still places blocks (``sharding.block_slices``), and runs no
    collective."""

    data: int
    model: int
    rank: int
    model_group: Any = None
    data_group: Any = None

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"a grid needs data, model >= 1, got "
                             f"{self.data} x {self.model}")
        if not 0 <= self.rank < self.data * self.model:
            raise ValueError(f"rank {self.rank} out of range for a "
                             f"{self.data} x {self.model} grid")

    @property
    def shape(self) -> MeshShape:
        return {"data": self.data, "model": self.model}

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each mesh axis."""
        d, m = divmod(self.rank, self.model)
        return {"data": d, "model": m}

    def group_of(self, axes):
        """The process group along mesh axis ``axes``, or along a tuple of
        them: ``("data", "model")`` is the whole grid, whose rank order (``d
        * M + m``) is a ``PartitionSpec`` entry's (the first axis major);
        a one-axis tuple is that axis."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        groups = {("data",): self.data_group, ("model",): self.model_group,
                  ("data", "model"): dist.group.WORLD}
        if axes not in groups:
            raise ValueError(f"no process group along {axes} on a "
                             f"{self.data} x {self.model} grid")
        return groups[axes]


def make_grid(data: int, model: int) -> ProcessGrid:
    """This rank's :class:`ProcessGrid` on the default process group,
    which must be initialized with exactly ``data * model`` ranks.  Every
    rank creates every subgroup, in the same order (``new_group``'s
    contract)."""
    if not dist.is_initialized():
        raise RuntimeError("make_grid: no process group; join one first "
                           "(grid_process_group, or a rank of spawn_grid)")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"make_grid({data}, {model}) needs {data * model} "
                         f"ranks, have {world}")
    rank = dist.get_rank()
    d, m = divmod(rank, model)
    model_groups = [dist.new_group([i * model + j for j in range(model)])
                    for i in range(data)]
    data_groups = [dist.new_group([i * model + j for i in range(data)])
                   for j in range(model)]
    return ProcessGrid(data=data, model=model, rank=rank,
                       model_group=model_groups[d],
                       data_group=data_groups[m])


@contextlib.contextmanager
def _joined(world: int, rank: int, backend: str, store_path: Optional[str],
            timeout: float) -> Iterator[None]:
    """Join rank ``rank`` of ``world`` to the default process group over a
    ``FileStore`` at ``store_path`` (a fresh temporary file when None,
    for a group of one), and leave it on exit."""
    with contextlib.ExitStack() as stack:
        if store_path is None:
            if world != 1:
                raise ValueError("a group of more than one rank needs a "
                                 "shared store_path")
            store_path = os.path.join(
                stack.enter_context(tempfile.TemporaryDirectory()), "store")
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout))
        try:
            yield
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def client_process_group(shards: int, rank: int, *, backend: str,
                         store_path: Optional[str] = None,
                         timeout: float = 60.0) -> Iterator[ClientGroup]:
    """Join rank ``rank`` of ``shards`` to the default process group over
    a ``FileStore`` at ``store_path`` (a fresh temporary file when None,
    for a group of one), and leave it on exit.  ``timeout`` bounds the
    rendezvous and every collective."""
    with _joined(shards, rank, backend, store_path, timeout):
        yield make_client_group(shards)


@contextlib.contextmanager
def grid_process_group(data: int, model: int, rank: int, *, backend: str,
                       store_path: Optional[str] = None,
                       timeout: float = 60.0) -> Iterator[ProcessGrid]:
    """Join rank ``rank`` of a ``data x model`` grid (as
    :func:`client_process_group` joins a client axis) and yield its
    :class:`ProcessGrid`."""
    with _joined(data * model, rank, backend, store_path, timeout):
        yield make_grid(data, model)


def _rank_main(rank: int, fn: Callable, layout: Tuple[int, ...],
               backend: str, device, store_path: str, out_dir: str,
               timeout: float, threads: Optional[int], args) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    dev = _rank_device(device, rank)
    if len(layout) == 1:
        join = client_process_group(layout[0], rank, backend=backend,
                                    store_path=store_path, timeout=timeout)
    else:
        join = grid_process_group(*layout, rank, backend=backend,
                                  store_path=store_path, timeout=timeout)
    with join as group:
        result = fn(group, dev, *args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def _spawn(fn: Callable, layout: Tuple[int, ...], args, *, device,
           backend: Optional[str], timeout: float, threads: Optional[int],
           what: str) -> List[Any]:
    import torch.multiprocessing as mp
    world = math.prod(layout)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: {what} was asked for cuda "
                           f"(pass device='cpu' to run on the CPU)")
    backend = default_backend(dev, world) if backend is None else backend
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, layout, backend, str(dev),
                              os.path.join(tmp, "store"), tmp, timeout,
                              threads, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{what}: {world} ranks still running "
                                   f"after {timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]


def spawn_client_shards(fn: Callable, shards: int, *args, device="cuda",
                        backend: Optional[str] = None,
                        timeout: float = 60.0,
                        threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(group, device, *args)`` in ``shards`` processes
    (``torch.multiprocessing``, spawned), rank r as shard r of a
    :class:`ClientGroup`; returns each rank's result in rank order
    (saved with ``torch.save``: return CPU tensors, numbers and numpy).

    ``device``: each rank's device; ``cuda`` places rank r on card ``r %
    device_count`` and raises without one.  ``backend``: default
    :func:`default_backend`.  ``timeout`` bounds the rendezvous, every
    collective and the join of the whole run: past it the ranks are
    terminated and ``TimeoutError`` raises.  ``threads``: each rank's
    intra-op thread count.  ``fn`` and ``args`` must pickle."""
    return _spawn(fn, (shards,), args, device=device, backend=backend,
                  timeout=timeout, threads=threads,
                  what="spawn_client_shards")


def spawn_grid(fn: Callable, data: int, model: int, *args, device="cuda",
               backend: Optional[str] = None, timeout: float = 60.0,
               threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(grid, device, *args)`` on every rank of a new ``data x
    model`` grid (a :class:`ProcessGrid` each), under the contract of
    :func:`spawn_client_shards`: results in rank order (rank ``d * model
    + m``), every wait bounded by ``timeout``, a rank's exception
    re-raised here, gloo where ranks share a card, and ``cuda`` without
    a card raising."""
    return _spawn(fn, (data, model), args, device=device, backend=backend,
                  timeout=timeout, threads=threads, what="spawn_grid")
