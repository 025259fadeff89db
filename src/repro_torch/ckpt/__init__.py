from .checkpoint import (CheckpointManager, restore_pytree,  # noqa: F401
                         save_pytree)
from .journal import UpdateJournal  # noqa: F401
