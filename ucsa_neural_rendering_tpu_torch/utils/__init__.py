from .device import resolve_device
from .logger import MetricsLogger
from .profiling import StepTimer, maybe_trace

__all__ = ["resolve_device", "MetricsLogger", "StepTimer", "maybe_trace"]
