"""Multi-tenant adapter serving (reference: ``repro/serving``): registry +
continuous-batching scheduler + engine over one frozen base model."""

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.registry import AdapterRegistry, RegistryFullError
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["AdapterRegistry", "RegistryFullError", "Request", "Scheduler",
           "ServingEngine"]
