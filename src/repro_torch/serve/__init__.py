"""Slot-based continuous-batching serving (port of ``repro.serve``).

The public surface is the :class:`Engine` protocol — ``submit(request) ->
RequestHandle``, ``step() -> list[TokenEvent]``, ``drain()``, ``run``,
``retire`` and ``cancel`` — implemented by ``ServeEngine`` (continuous
batching, mixed-tier decode, per-request KV precision, mid-stream tier
migration) and ``BatchServeEngine`` (batch-at-a-time baseline).
Admission is a ``SchedulerPolicy``: ``FIFOPolicy`` or the deadline-aware
``SLOPolicy``.
"""
from repro_torch.serve.engine import (BatchServeEngine, Engine, EngineStats,
                                      ServeEngine, prepare_params)
from repro_torch.serve.handle import RequestHandle, RequestStatus, TokenEvent
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import (ANY_TIER, FIFOPolicy, Scheduler,
                                         SchedulerPolicy, SLOPolicy, SlotState)
from repro_torch.serve.slots import SlotArena
from repro_torch.spec import SamplingParams, SpecConfig

__all__ = ["ANY_TIER", "BatchServeEngine", "Engine", "EngineStats",
           "FIFOPolicy", "Request", "RequestHandle", "RequestStatus",
           "SLOPolicy", "SamplingParams", "SchedulerPolicy", "Scheduler",
           "ServeEngine", "SlotArena", "SlotState", "SpecConfig",
           "TokenEvent", "prepare_params"]
