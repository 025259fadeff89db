"""Optimized variants of deepseek-v3-671b's cells (the reference's
``configs/deepseek_v3_opt.py``):

train_4k   + microbatch=8 gradient accumulation (activation live-range /8)
decode_32k + serving shardings (parameters not FSDP-sharded over `data`,
             experts expert-parallel over data x model) with the
             sequence-sharded cache.
"""
import dataclasses

from .common import Cell
from .deepseek_v3_671b import CONFIG as BASE
from .lm_common import _mk_builder

TRAIN_MB = dataclasses.replace(BASE, microbatch=8)
DECODE_LTP = dataclasses.replace(BASE, serving_shardings=True)

CELLS = [
    Cell("deepseek-v3-opt", "train_4k", "train",
         _mk_builder(TRAIN_MB, "train", 4096, 256)),
    Cell("deepseek-v3-opt", "decode_32k", "decode",
         _mk_builder(DECODE_LTP, "decode", 32768, 128)),
]
