# Unified serving layer: one Engine protocol + registry over the execution
# backends, and the InferenceSession facade (ingest / query / hot-swap).
# Importing this package registers the built-in engines.
from .registry import (Engine, EngineOption, UpdateResult,  # noqa: F401
                       canonical_name, engine_names, engine_options,
                       make_engine, normalize_options, register_engine)
from . import engines  # noqa: F401  (registers the engines)
from .session import (InferenceSession, IngestReport,  # noqa: F401
                      SessionConfig)
