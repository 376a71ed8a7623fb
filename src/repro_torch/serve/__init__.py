"""Continuous-batching ensemble service (the port of `repro.serve`).

Async submit/poll serving of DE ensemble solves over fixed-width resumable
slots: finished lanes retire early and are refilled from the request queue,
so heterogeneous small requests share one lanes engine at full lane
occupancy; non-resumable methods coalesce into one-shot batches, on the
hand-written kernels with ``backend="cuda"``.
"""
from .service import (Backpressure, EnsembleService, ServeResult,
                      SolveRequest, Ticket)
from .slots import BatchPool, SlotPool

__all__ = ["Backpressure", "EnsembleService", "ServeResult", "SolveRequest",
           "Ticket", "BatchPool", "SlotPool"]
