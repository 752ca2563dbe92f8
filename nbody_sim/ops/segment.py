"""Masked neighbor-axis reductions — the static-shape replacement for
``torch_scatter.scatter`` (reference ``contconv.py:95-98``).

Because neighbors live in dense ``(N, k)`` arrays (see ``ops.knn``), the
scatter of the reference collapses to a plain masked reduction over the
neighbor axis — a regular-shaped op XLA fuses for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def masked_sum(values: jax.Array, valid: jax.Array, axis: int = 1) -> jax.Array:
    """Sum ``values`` over ``axis`` counting only ``valid`` slots.

    :param values: (..., k, d) per-neighbor values.
    :param valid: broadcastable bool mask (without the trailing feature dim).
    """
    v = jnp.where(valid[..., None], values, 0.0)
    return jnp.sum(v, axis=axis)


def masked_mean(values: jax.Array, valid: jax.Array, axis: int = 1) -> jax.Array:
    """Mean over valid slots; nodes with zero valid neighbors get 0
    (matching ``torch_scatter.scatter(..., reduce='mean')`` with dim_size)."""
    s = masked_sum(values, valid, axis=axis)
    cnt = jnp.sum(valid.astype(values.dtype), axis=axis)[..., None]
    return s / jnp.maximum(cnt, 1.0)


def masked_aggregate(values, valid, how: str, axis: int = 1):
    """Dispatch on the reference's ``aggr``/``agg`` string ('sum' | 'mean')."""
    if how == "sum":
        return masked_sum(values, valid, axis=axis)
    if how == "mean":
        return masked_mean(values, valid, axis=axis)
    raise ValueError(f"unknown aggregation {how!r}")
