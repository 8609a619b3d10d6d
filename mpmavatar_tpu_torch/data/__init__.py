"""Configuration and capture loaders of the port."""

from .config import (ModelParams, OptimizationParams,  # noqa: F401
                     PipelineParams, add_dataclass_args, dump_config,
                     extract_dataclass, load_config)
from .datasets import (ActorsHQDataset, DRESS4DDataset,  # noqa: F401
                       PreloadedDataset, Scene)
