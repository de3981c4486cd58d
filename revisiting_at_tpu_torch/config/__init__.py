from .config import (
    AdvSection,
    Config,
    DataSection,
    DistSection,
    LoggingSection,
    LRSection,
    MiscSection,
    ModelSection,
    ResolutionSection,
    TrainingSection,
    ValidationSection,
    load_params_json,
)

__all__ = [
    "AdvSection",
    "Config",
    "DataSection",
    "DistSection",
    "LoggingSection",
    "LRSection",
    "MiscSection",
    "ModelSection",
    "ResolutionSection",
    "TrainingSection",
    "ValidationSection",
    "load_params_json",
]
