"""Configuration of the port's training stages."""

from .config import OptimizationParams  # noqa: F401
