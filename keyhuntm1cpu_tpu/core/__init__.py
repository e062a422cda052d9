"""Core runtime services: config, logging, errors, checkpoints, metrics.

Re-implementation of the reference's header-only "modern core"
scaffolding (reference include/keyhunt/core/*, SURVEY.md §2.3) — but wired
into the shipped engines instead of being test-only interface stubs.
"""

from .config import Config, load_config
from .errors import (
    ConfigError,
    EngineError,
    KeyhuntError,
    TargetParseError,
    ValidationError,
)
from .log import Logger, get_logger, set_level
from .checkpoint import Checkpoint, CheckpointManager

__all__ = [
    "Config",
    "load_config",
    "Logger",
    "get_logger",
    "set_level",
    "Checkpoint",
    "CheckpointManager",
    "KeyhuntError",
    "ConfigError",
    "EngineError",
    "TargetParseError",
    "ValidationError",
]
