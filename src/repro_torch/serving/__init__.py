"""Continuous-batching serving: the engine, its scheduler and sampling.

The port's counterpart of ``repro/serving`` (engine, scheduler, sampling,
the overload layer and its fault injection; the cluster is not ported yet).
"""

from repro_torch.runtime.fault_tolerance import FaultInjector, StepWatchdog
from repro_torch.serving.engine import Engine, Request, percentile
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import AdmissionPolicy, RejectedOverload

__all__ = ["Engine", "Request", "SamplingParams", "AdmissionPolicy", "RejectedOverload", "FaultInjector",
           "StepWatchdog", "percentile"]
