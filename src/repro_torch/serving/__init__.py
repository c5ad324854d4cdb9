"""Continuous-batching serving: the engine, its scheduler and sampling.

The port's counterpart of ``repro/serving`` (engine, scheduler, sampling;
the cluster is not ported yet).
"""

from repro_torch.serving.engine import Engine, Request, percentile
from repro_torch.serving.sampling import SamplingParams

__all__ = ["Engine", "Request", "SamplingParams", "percentile"]
