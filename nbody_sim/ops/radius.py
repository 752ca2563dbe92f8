"""Fixed-radius neighbor search with padded output — the static-shape
replacement for ``torch_cluster.radius_graph`` (reference ``contconv.py:225``).

Returns the nearest ``k_max`` candidates and a validity mask ``d^2 < r^2``.
Overflow policy: like PyG's ``radius_graph`` (whose default
``max_num_neighbors=32`` silently truncates), nodes with more than ``k_max``
in-radius neighbors keep only the *nearest* ``k_max`` — a strictly better
truncation than PyG's arbitrary first-found order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from nbody_sim.ops.knn import knn_neighbors


def radius_neighbors(
    pos: jax.Array,
    radius: float,
    k_max: int = 32,
    mask: Optional[jax.Array] = None,
    include_self: bool = True,
    chunk_size: Optional[int] = None,
    method: str = "exact",
) -> Tuple[jax.Array, jax.Array]:
    """Neighbors within ``radius``, padded to ``(N, k_max)``.

    :param pos: (N, 3) positions.
    :param radius: cutoff distance.
    :param k_max: static per-node neighbor capacity.
    :param mask: optional (N,) validity for padded slots.
    :param include_self: include the self edge (PyG ``loop=True``; the
        reference ContConv uses ``self_loops=True``, ``contconv.py:109,225``).
    :param chunk_size: forwarded to the large-N streamed kNN path.
    :param method: inner candidate search — "exact" (streamed O(N^2) kNN) or
        "morton" (the O(N·W) curve search, the production large-N path that
        the fixed-cell hash grid could not provide on clustered profiles).
    :return: (idx, valid) — (N, k_max) int32 indices, (N, k_max) bool mask.
    """
    n = pos.shape[0]
    k_max = min(k_max, n)
    # Nearest-k_max first (shares the dense/streamed kNN machinery), then the
    # radius cutoff — this is exactly "nearest k_max within r".
    if method == "morton":
        from nbody_sim.ops.spatial import knn_morton

        idx, valid = knn_morton(
            pos, k_max, mask=mask, include_self=include_self
        )
    else:
        idx, valid = knn_neighbors(
            pos, k_max, mask=mask, include_self=include_self,
            chunk_size=chunk_size,
        )
    d2_sel = jnp.sum(
        (pos[idx] - pos[:, None, :]) ** 2, axis=-1
    )  # (N, k_max) exact distances of the selected candidates
    valid = valid & (d2_sel < jnp.asarray(radius, d2_sel.dtype) ** 2)
    idx = jnp.where(valid, idx, 0)
    return idx.astype(jnp.int32), valid


def batched_radius_neighbors(pos, radius, k_max=32, mask=None,
                             include_self=True, method="exact"):
    """vmap of :func:`radius_neighbors` over a leading batch axis."""
    fn = lambda p, m: radius_neighbors(
        p, radius, k_max=k_max, mask=m, include_self=include_self,
        method=method,
    )
    if mask is None:
        return jax.vmap(lambda p: fn(p, None))(pos)
    return jax.vmap(fn)(pos, mask)
