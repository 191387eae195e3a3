"""Serving tier of the port: replicated serve step + continuous batching."""
from .engine import (ContinuousBatcher, Request, termination_reason,
                     DEFAULT_BUCKETS)
from .sampling import GREEDY, SamplerConfig, sample_token
from .steps import ServeContext, ServeStep, build_serve_step
from .scenarios import make_scenario, SCENARIO_KINDS

__all__ = [
    "ContinuousBatcher", "Request", "termination_reason", "DEFAULT_BUCKETS",
    "GREEDY", "SamplerConfig", "sample_token",
    "ServeContext", "ServeStep", "build_serve_step",
    "make_scenario", "SCENARIO_KINDS",
]
