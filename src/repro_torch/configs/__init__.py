"""Config registry: importing this package registers all assigned archs."""
from .base import ModelConfig, RunConfig, ShapeConfig, SHAPES, resolve, \
    all_archs, cells, register

# one module per assigned architecture (import = register)
from . import h2o_danube3_4b    # noqa: F401
from . import granite_34b       # noqa: F401
from . import qwen15_110b       # noqa: F401
from . import llama32_3b        # noqa: F401
from . import zamba2_7b         # noqa: F401
from . import dbrx_132b         # noqa: F401
from . import granite_moe_3b    # noqa: F401
from . import mamba2_780m       # noqa: F401
from . import llava_next_mistral_7b  # noqa: F401
from . import whisper_large_v3  # noqa: F401

__all__ = ["ModelConfig", "RunConfig", "ShapeConfig", "SHAPES", "resolve",
           "all_archs", "cells", "register"]
