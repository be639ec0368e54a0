"""Serving: the decode engine (merged, split and speculative), the
continuous-batching scheduler, the paged KV block allocator, the
fault-aware replica router, serving metrics, and the model-free
``SimEngine`` with bursty traces (see ``repro/serve/__init__.py`` for the
JAX twins)."""

from repro_torch.serve.blocks import BlockAllocator
from repro_torch.serve.engine import BatchState, DecodeEngine, get_engine
from repro_torch.serve.metrics import (acceptance_rate, latency_percentiles,
                                       output_agreement, slo_attainment)
from repro_torch.serve.router import FaultRoutedServer, ServeParams, ServeReport
from repro_torch.serve.scheduler import (PendingWork, Request, SlotScheduler,
                                         synthetic_requests)
from repro_torch.serve.trace import SimConfig, SimEngine, bursty_trace

__all__ = [
    "BatchState", "BlockAllocator", "DecodeEngine", "get_engine",
    "acceptance_rate", "latency_percentiles", "output_agreement",
    "slo_attainment",
    "FaultRoutedServer", "ServeParams", "ServeReport",
    "PendingWork", "Request", "SlotScheduler", "synthetic_requests",
    "SimConfig", "SimEngine", "bursty_trace",
]
