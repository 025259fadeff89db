"""Training substrate, the port of ``repro``'s ``train`` package: the
optimizers, clipping and gradient compression (``optim.py``), and
``value_and_grad`` over parameter trees (``grad.py``)."""
from .grad import value_and_grad  # noqa: F401
from .optim import (AdafactorState, AdamWState, CompressionState,  # noqa: F401
                    adafactor_init, adafactor_update, adamw_init,
                    adamw_update, clip_by_global_norm, compress_grads,
                    compression_init, make_optimizer, tree_map)
