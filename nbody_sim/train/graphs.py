"""Graph construction dispatch: every model declares a ``graph_spec`` and the
engine builds the matching padded neighbor lists on device, inside the jitted
step — replacing the reference's host-side graph builds (``datautils.py:36``
at load time; ``contconv.py:225`` per forward)."""

from __future__ import annotations

from nbody_sim.ops.knn import batched_knn_neighbors
from nbody_sim.ops.radius import batched_radius_neighbors
from nbody_sim.ops.spatial import batched_knn_morton


def build_graph(graph_spec, pos, mask=None):
    """:param graph_spec: ("knn", {k, include_self[, method, window]}) or
        ("radius", {radius, k_max, include_self}) from ``model.graph_spec``.
        kNN methods: "exact" (default; streamed O(N^2) top_k), "approx"
        (``approx_max_k`` selection), "morton" (O(N·W) space-filling-curve
        search — the large-N production path, ``ops/spatial.py``).
    :param pos: (B, N, 3) positions.
    :param mask: optional (B, N) node validity.
    :return: (idx, valid) padded neighbor lists, both (B, N, k).
    """
    kind, kw = graph_spec
    if kind == "knn":
        method = kw.get("method", "approx" if kw.get("approx") else "exact")
        if method == "morton":
            return batched_knn_morton(
                pos,
                kw["k"],
                mask=mask,
                include_self=kw.get("include_self", False),
                window=kw.get("window", 64),
                block=kw.get("block", 256),
                n_copies=kw.get("n_copies", 4),
            )
        return batched_knn_neighbors(
            pos,
            kw["k"],
            mask=mask,
            include_self=kw.get("include_self", False),
            approx=method == "approx",
        )
    if kind == "radius":
        return batched_radius_neighbors(
            pos,
            kw["radius"],
            k_max=kw.get("k_max", 32),
            mask=mask,
            include_self=kw.get("include_self", True),
            method=kw.get("method", "exact"),
        )
    raise ValueError(f"unknown graph spec kind {kind!r}")
