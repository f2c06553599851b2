"""Serving: the token-serving engine (waves of prompts, prefill + decode)
and the DSE service (concurrent clients' (model, spec) queries packed into
campaign waves over the batched engine, answered from a shared result
cache); both form their waves with ``form_wave``."""
from .dse_service import DSEService, DSETicket
from .engine import Request, Result, ServeEngine, form_wave

__all__ = ["DSEService", "DSETicket", "ServeEngine", "Request", "Result",
           "form_wave"]
