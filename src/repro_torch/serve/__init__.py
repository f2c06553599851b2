"""The DSE service: concurrent clients' (model, spec) queries packed into
campaign waves over the batched engine, answered from a shared result
cache."""
from .dse_service import DSEService, DSETicket
from .engine import form_wave

__all__ = ["DSEService", "DSETicket", "form_wave"]
