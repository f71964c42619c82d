"""Config system (SURVEY.md §7.6): the reference bakes tuning into common.h
macros (bin boundaries, group sizes [R]); here they are a dataclass so
tuning is runtime-configurable and testable.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class SpGemmConfig:
    """Tuning knobs for the SpGEMM pipeline."""

    # stage-2 bin widths: rows with nnzCt <= width are handled by the tiled
    # sort kernel of that width; beyond the last width rows take the global
    # ESC path (the merge-method analogue). Reference: 38 bins, heap<=32 /
    # ESC<=256 / merge beyond (SURVEY.md §4 stage 2) — collapsed here to powers
    # of two (the per-row sort widths).
    bin_widths: Tuple[int, ...] = (8, 32, 128, 512)
    # numeric method: auto|esc|binned
    method: str = "auto"
    value_dtype: object = jnp.float32
    index_dtype: object = jnp.int32
    # growth-bucket minimum (pad_bucket floor)
    min_capacity: int = 8
    # trim outputs to pad_bucket(nnzC) on the host after compute
    trim: bool = True


DEFAULT = SpGemmConfig()
