"""Assigned architecture configs. `get_config(name)` / `get_smoke_config(name)`
(the port of ``repro.configs``; the ten configs are the reference's values)."""
from .base import (  # noqa: F401
    ARCHS,
    SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    get_smoke_config,
    input_specs,
    list_archs,
)
