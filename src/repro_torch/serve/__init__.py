"""Serving tier of the port: the replicated and lane_zero3 serve steps,
continuous batching, and serving weights from a checkpoint."""
from .engine import (ContinuousBatcher, Request, termination_reason,
                     DEFAULT_BUCKETS)
from .sampling import GREEDY, SamplerConfig, sample_token
from .steps import (ServeContext, ServeStep, build_serve_step,
                    load_serve_params, serve_hostings)
from .scenarios import make_scenario, scenario_families, SCENARIO_KINDS

__all__ = [
    "ContinuousBatcher", "Request", "termination_reason", "DEFAULT_BUCKETS",
    "GREEDY", "SamplerConfig", "sample_token",
    "ServeContext", "ServeStep", "build_serve_step", "load_serve_params",
    "serve_hostings", "make_scenario", "scenario_families", "SCENARIO_KINDS",
]
