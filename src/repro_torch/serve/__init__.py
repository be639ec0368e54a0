"""Serving: the decode engine, continuous-batching scheduler, paged KV
block allocator, replica router and serving metrics (see
``repro/serve/__init__.py`` for the JAX twins)."""

from repro_torch.serve.blocks import BlockAllocator
from repro_torch.serve.engine import BatchState, DecodeEngine
from repro_torch.serve.metrics import (acceptance_rate, latency_percentiles,
                                       output_agreement, slo_attainment)
from repro_torch.serve.router import FaultRoutedServer, ServeParams, ServeReport
from repro_torch.serve.scheduler import (PendingWork, Request, SlotScheduler,
                                         synthetic_requests)

__all__ = [
    "BatchState", "BlockAllocator", "DecodeEngine",
    "acceptance_rate", "latency_percentiles", "output_agreement",
    "slo_attainment",
    "FaultRoutedServer", "ServeParams", "ServeReport",
    "PendingWork", "Request", "SlotScheduler", "synthetic_requests",
]
