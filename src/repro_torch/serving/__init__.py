"""Continuous-batching serving: the engine, its scheduler and sampling, and the
replicated cluster.

The port's counterpart of ``repro/serving``: the engine (flat or paged pool,
chunked prefill, prefix sharing, the overload layer and its fault
injection), its scheduler and sampling, and :class:`Cluster` /
:class:`EventLog`: N thread-backed engine replicas behind one shared queue,
with heartbeat failure detection, bit-exact failover under a
:class:`FailoverBudget` (capped backoff), :class:`RoutingPolicy`'s
least-loaded routing and a JSON-lines event log.
"""

from repro_torch.runtime.fault_tolerance import FaultInjector, StepWatchdog
from repro_torch.serving.cluster import Cluster, EventLog
from repro_torch.serving.engine import Engine, Request, percentile
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import AdmissionPolicy, FailoverBudget, RejectedOverload, RoutingPolicy

__all__ = ["Engine", "Request", "SamplingParams", "AdmissionPolicy", "RejectedOverload", "FaultInjector",
           "StepWatchdog", "percentile", "Cluster", "EventLog", "RoutingPolicy", "FailoverBudget"]
