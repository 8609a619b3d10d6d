"""Configuration of the port's training stages."""

from .config import (ModelParams, OptimizationParams,  # noqa: F401
                     add_dataclass_args, extract_dataclass)
