"""Slot-based continuous-batching serving (port of ``repro.serve``)."""
from repro_torch.serve.engine import EngineStats, ServeEngine, prepare_params
from repro_torch.serve.handle import RequestHandle, RequestStatus, TokenEvent
from repro_torch.serve.request import Request

__all__ = ["EngineStats", "ServeEngine", "prepare_params",
           "Request", "RequestHandle", "RequestStatus", "TokenEvent"]
