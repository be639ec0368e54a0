"""Structural cost of one step, counted op by op: its FLOPs, its HBM
bytes, its collective bytes and its peak of live memory.

The port's counterpart of ``repro/roofline/hlo_cost.py``.  That module
parses the XLA HLO of a compiled step, which the port never produces;
here :class:`OpCounter` is a ``TorchDispatchMode`` held around the step,
which sees every ATen op that eager PyTorch dispatches (the backward's
too), on the meta device (the dry run: shapes only, nothing allocated),
the CPU or the card:

* **FLOPs**: 2·|out|·contract of each matmul-class op (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``mv``, ``dot``, ``convolution`` and its
  backward), the ops ``hlo_cost`` counts as ``dot`` / ``convolution``.
  Elementwise work is not counted, as there.
* **Bytes**: operand plus result bytes of every op that moves data.  Eager
  PyTorch runs every op as scheduled, so this is the post-fusion estimate
  ``hlo_cost`` makes per scheduled op.  Views, and ``empty`` allocations,
  move nothing and count nothing.  A copy between the host and the device
  (the round's host draws going to the card) is kept apart, in
  ``transfer_bytes``: it is not the device's memory traffic, and a step
  run on the CPU has none.
* **Peak**: the bytes of storages the step creates that are still alive
  (a finalizer a storage), so ``peak_temp_bytes`` is the most the step
  held beyond its arguments at any point.  Inside a kernel's region only
  what outlives it (the output) counts, not the plain version's
  temporaries.
* **Collective bytes**: result bytes by op kind, credited by
  ``sharding.py``'s transport (:func:`credit_collective`): the one
  per-kind tally of a step's collectives; and by site where a
  :class:`collective_site` labels them (the aggregation tree's);
  ``coll_weighted`` weights an all-reduce 2x, a max one
  (``all-reduce-max``, a kind of its own) too
  (``analysis.weighted_collective_bytes``).
* **Kernels**: the hand-written kernels launch through ctypes, which no
  dispatch mode sees.  Each wrapper of ``kernels/ops.py`` runs inside
  :func:`kernel`, which stops the count of the ops inside it (the plain
  version on the CPU and meta devices, the launch's own bookkeeping on the
  card) and credits the kernel's cost from ``roofline/analysis.py``
  instead: a matmul-class kernel's operations to ``flops``, an
  elementwise kernel's to ``elementwise_ops``.  A count then describes the
  path the card runs, and a meta count, a CPU count and a card count of
  the same step agree exactly, with one exception: paged decode's cost
  reads the live table entries from a real tensor's values, and counts
  every entry live on meta, which has none.

:func:`analyze` runs a function under a counter and returns the keys of
``hlo_cost.analyze_text`` (``flops``, ``bytes``, ``coll_*``,
``coll_weighted``) and more; :meth:`OpCounter.top_ops` is the
counterpart of ``top_tensors``.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.roofline import analysis as an

aten = torch.ops.aten

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
# ops that allocate without writing: they move no bytes
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided}

_ACTIVE: List["OpCounter"] = []


def current() -> Optional["OpCounter"]:
    """The innermost active counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> float:
    # 2 x (the outputs) x (the inputs each sums: C_in/groups x the kernel)
    # for a forward convolution; a transposed one the other way round
    k = _numel(w_shape[2:])
    if transposed:
        return 2.0 * _numel(x_shape) * w_shape[1] * k
    return 2.0 * _numel(out_shape) * w_shape[1] * k


def _matmul_flops(func, args, out) -> float:
    p = func.overloadpacket
    if p is aten.mm:
        return 2.0 * args[0].shape[0] * args[0].shape[1] * args[1].shape[1]
    if p is aten.addmm:
        return 2.0 * args[1].shape[0] * args[1].shape[1] * args[2].shape[1]
    if p is aten.bmm:
        b, m, k = args[0].shape
        return 2.0 * b * m * k * args[1].shape[2]
    if p is aten.baddbmm:
        b, m, k = args[1].shape
        return 2.0 * b * m * k * args[2].shape[2]
    if p is aten.mv:
        return 2.0 * args[0].shape[0] * args[0].shape[1]
    if p is aten.dot:
        return 2.0 * args[0].shape[0]
    if p in (aten.convolution, aten._convolution):
        return _conv_flops(args[0].shape, args[1].shape, out.shape,
                           bool(args[6]))
    if p is aten.convolution_backward:
        # (grad_out, input, weight, bias_sizes, stride, padding, dilation,
        # transposed, output_padding, groups, output_mask): each of the
        # input and weight gradients is a convolution the forward's size
        fwd = _conv_flops(args[1].shape, args[2].shape, args[0].shape,
                          bool(args[7]))
        mask = args[10]
        return fwd * (int(bool(mask[0])) + int(bool(mask[1])))
    return 0.0


_MATMUL = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.mv, aten.dot,
           aten.convolution, aten._convolution, aten.convolution_backward}


def _is_view_or_inplace(func) -> bool:
    return any(r.alias_info is not None for r in func._schema.returns)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (``with OpCounter() as
    c:``); see the module docstring."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.elementwise_ops = 0.0
        self.transfer_bytes = 0.0
        self.num_ops = 0
        self.coll: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
        self.coll_by_site: Dict[str, Dict[str, float]] = {}
        self._site: List[str] = []
        self.by_op: Dict[str, List[float]] = {}      # name -> [n, flops, bytes]
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.devices: Dict[str, int] = {}            # op outputs by device
        self.device_output_bytes: Dict[str, float] = {}
        self.live_bytes = 0
        self.peak_temp_bytes = 0
        self._storages: Dict[int, int] = {}
        self._suspended = 0

    # -- activation ---------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    # -- memory -------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live_bytes += n
        if not self._suspended:
            self.peak_temp_bytes = max(self.peak_temp_bytes,
                                       self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    # -- the ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        aliased = _is_view_or_inplace(func)
        if not aliased:
            for t in outs:
                self._track(t)
        if self._suspended or func.overloadpacket in _NO_TRAFFIC \
                or _is_view(func):
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if len({t.device for t in ins + outs}) > 1:
            # a copy between the host and the device: not the device's own
            # memory traffic, and absent where the step runs on the CPU
            self.transfer_bytes += float(sum(map(_nbytes, outs)))
            return out
        nbytes = float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
        flops = (_matmul_flops(func, args, outs[0] if outs else None)
                 if func.overloadpacket in _MATMUL else 0.0)
        self.num_ops += 1
        self.bytes += nbytes
        self.flops += flops
        rec = self.by_op.setdefault(str(func.overloadpacket), [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        for t in outs:
            dev = t.device.type
            self.devices[dev] = self.devices.get(dev, 0) + 1
            self.device_output_bytes[dev] = (
                self.device_output_bytes.get(dev, 0.0) + _nbytes(t))
        return out

    # -- credits ------------------------------------------------------------
    def credit_kernel(self, name: str, cost: an.KernelCost) -> None:
        rec = self.kernels.setdefault(
            name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        rec["launches"] += 1
        rec["flops"] += cost.flops
        rec["bytes"] += cost.bytes
        self.bytes += cost.bytes
        if an.KERNEL_OP_KIND[name] == "matmul":
            self.flops += cost.flops
        else:
            self.elementwise_ops += cost.flops

    def credit_collective(self, kind: str, nbytes: float) -> None:
        self.coll[kind] = self.coll.get(kind, 0.0) + float(nbytes)
        if self._site:
            site = self.coll_by_site.setdefault(self._site[-1], {})
            site[kind] = site.get(kind, 0.0) + float(nbytes)

    # -- readings -----------------------------------------------------------
    def totals(self) -> Dict[str, Any]:
        """The keys of ``hlo_cost.analyze_text`` and the counter's own."""
        out: Dict[str, Any] = {"flops": self.flops, "bytes": self.bytes,
                               "coll_weighted":
                                   an.weighted_collective_bytes(self.coll)}
        out.update({f"coll_{k}": v for k, v in self.coll.items()})
        out["collectives_by_site"] = {k: dict(v)
                               for k, v in self.coll_by_site.items()}
        out.update(elementwise_ops=self.elementwise_ops,
                   transfer_bytes=self.transfer_bytes, num_ops=self.num_ops,
                   peak_temp_bytes=float(self.peak_temp_bytes),
                   kernels={k: dict(v) for k, v in self.kernels.items()},
                   devices=dict(self.devices),
                   device_output_bytes=dict(self.device_output_bytes))
        return out

    def top_ops(self, n: int = 15) -> List[Tuple[float, str, int, float]]:
        """The ``n`` ops that move the most bytes: (bytes, op, calls,
        flops), kernels credited among them."""
        rows = [(b, name, int(c), f) for name, (c, f, b) in
                self.by_op.items()]
        rows += [(k["bytes"], f"kernel:{name}", int(k["launches"]),
                  k["flops"]) for name, k in self.kernels.items()]
        rows.sort(reverse=True)
        return rows[:n]


class _Kernel:
    """The context of one kernel call under a counter (see :func:`kernel`)."""

    __slots__ = ("counter", "name", "cost")

    def __init__(self, counter: OpCounter, name: str, cost):
        self.counter, self.name, self.cost = counter, name, cost

    def __enter__(self):
        self.counter._suspended += 1

    def __exit__(self, exc_type, *exc):
        c = self.counter
        c._suspended -= 1
        # the plain version's temporaries are gone; what stays is the
        # kernel's output
        c.peak_temp_bytes = max(c.peak_temp_bytes, c.live_bytes)
        if exc_type is None:
            cost = self.cost() if callable(self.cost) else self.cost
            self.counter.credit_kernel(self.name, cost)


class _Null:
    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, *exc):
        pass


_NULL = _Null()


def kernel(name: str, cost: "an.KernelCost | Callable[[], an.KernelCost]"):
    """The context a kernel wrapper runs its body in: with a counter
    active, the ops inside are not counted and ``cost`` (or ``cost()``,
    evaluated only then) is credited once the body returns; without one,
    nothing."""
    c = current()
    return _NULL if c is None else _Kernel(c, name, cost)


class collective_site:
    """Label the collectives inside the block (``coll_by_site`` of the
    active counter): the aggregation tree's, say, apart from the
    gradients' all-reduce."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        c = current()
        if c is not None:
            c._site.append(self.name)

    def __exit__(self, *exc):
        c = current()
        if c is not None and c._site:
            c._site.pop()


def credit_collective(kind: str, nbytes: float) -> None:
    """Add a collective's result bytes to the active counter, if any."""
    c = current()
    if c is not None:
        c.credit_collective(kind, nbytes)


def analyze(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, Any]]:
    """``(fn(), the counter's totals)``: one call counted."""
    with OpCounter() as c:
        out = fn()
    return out, c.totals()
