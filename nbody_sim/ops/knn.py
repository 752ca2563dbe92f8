"""Fixed-degree k-nearest-neighbor search — the static-shape replacement for
``torch_cluster.knn_graph`` (used at reference ``datautils.py:36`` and
``gnn.py:13``).

XLA compiles static shapes, so instead of a COO ``edge_index`` with a
data-dependent edge count we return a dense ``(N, k)`` neighbor-index array
plus a ``(N, k)`` validity mask. Downstream message passing becomes a regular
gather + masked reduction — no scatter at all (see SURVEY.md §2.9a).

Semantics parity with ``knn_graph(pos, k, loop=False)``:
- self edges excluded (``loop=False``) unless ``include_self``;
- when a snapshot has fewer than ``k`` other valid particles, the surplus
  slots are marked invalid (PyG simply emits fewer edges).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

# Plain Python float: creating a jax array at import time would force
# backend initialisation on `import nbody_sim`.
_INF = float(jnp.finfo(jnp.float32).max)


from nbody_sim.core.forces import _pairwise_d2  # noqa: E402  (shared helper)


# Above this size the (N, N) distance matrix stops fitting comfortably and we
# stream row chunks instead (exact result, O(chunk * N) memory).
_CHUNKED_THRESHOLD = 4096
_DEFAULT_CHUNK = 1024


def knn_neighbors(
    pos: jax.Array,
    k: int,
    mask: Optional[jax.Array] = None,
    include_self: bool = False,
    chunk_size: Optional[int] = None,
    approx: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """k nearest neighbors of every particle: dense O(N^2) distances +
    ``lax.top_k`` for small N, a streamed row-chunk scan for large N
    (100k-body scale — SURVEY.md §7 hard part (a)).

    :param pos: (N, 3) positions.
    :param k: neighbor count (static).
    :param mask: optional (N,) validity for padded slots.
    :param include_self: count the particle itself as its nearest neighbor
        (PyG ``loop=True``).
    :param chunk_size: row-chunk size for the streamed path; None picks
        automatically (dense below ~4k bodies).
    :return: (idx, valid) — (N, k) int32 neighbor indices and (N, k) bool
        validity. Invalid slots point at index 0; always apply the mask.
    """
    n = pos.shape[0]
    k = min(k, n)
    if chunk_size is None:
        chunk_size = n if n <= _CHUNKED_THRESHOLD else _DEFAULT_CHUNK
    if chunk_size < n:
        return _knn_chunked(pos, k, mask, include_self, chunk_size, approx=approx)
    d2 = _pairwise_d2(pos)
    eye = jnp.eye(n, dtype=bool)
    if not include_self:
        d2 = jnp.where(eye, _INF, d2)
    if mask is not None:
        m = mask.astype(bool)
        d2 = jnp.where(m[None, :], d2, _INF)  # never select padded cols
    neg_d2, idx = jax.lax.top_k(-d2, k)
    valid = neg_d2 > -_INF
    if mask is not None:
        valid = valid & mask.astype(bool)[:, None]  # padded rows have no nbrs
    idx = jnp.where(valid, idx, 0)
    return idx.astype(jnp.int32), valid


def _knn_chunked(pos, k, mask, include_self, chunk_size, approx=False):
    """Exact kNN over row chunks: each chunk computes its (chunk, Npad)
    distance block (norm-expansion form — no (chunk, N, 3) temporary) and
    top_k's it. Memory O(chunk * N); one compile, sequential chunks via
    ``lax.map``. Columns are padded to a multiple of 128 (an aligned matmul
    width).

    ``approx`` switches top_k to ``jax.lax.approx_max_k`` (recall target
    0.95), a cheaper selection for 100k-body surrogate graphs.
    """
    n = pos.shape[0]
    n_rows = -(-n // chunk_size) * chunk_size
    n_cols = -(-n // 128) * 128
    posp_r = jnp.pad(pos, ((0, n_rows - n), (0, 0)))
    posp_c = jnp.pad(pos, ((0, n_cols - n), (0, 0)))
    col_valid = jnp.arange(n_cols) < n
    if mask is not None:
        col_valid = col_valid & jnp.pad(mask.astype(bool), (0, n_cols - n))
    sq = jnp.sum(posp_c * posp_c, axis=-1)
    cols = jnp.arange(n_cols)[None, :]

    starts = jnp.arange(n_rows // chunk_size) * chunk_size

    def one_chunk(start):
        rows = start + jnp.arange(chunk_size)
        pr = jax.lax.dynamic_slice(posp_r, (start, 0), (chunk_size, 3))
        sqr = jnp.sum(pr * pr, axis=-1)
        d2 = (
            sqr[:, None]
            + sq[None, :]
            - 2.0 * jnp.matmul(pr, posp_c.T, precision=jax.lax.Precision.HIGHEST)
        )
        d2 = jnp.maximum(d2, 0.0)
        if not include_self:
            d2 = jnp.where(cols == rows[:, None], _INF, d2)
        d2 = jnp.where(col_valid[None, :], d2, _INF)
        if approx:
            neg, idx = jax.lax.approx_max_k(-d2, k, recall_target=0.95)
        else:
            neg, idx = jax.lax.top_k(-d2, k)
        return idx.astype(jnp.int32), neg > -_INF

    idx, valid = jax.lax.map(one_chunk, starts)
    idx = idx.reshape(n_rows, k)[:n]
    valid = valid.reshape(n_rows, k)[:n]
    if mask is not None:
        valid = valid & mask.astype(bool)[:, None]
    idx = jnp.where(valid, idx, 0)
    return idx, valid


def knn_query(
    pos_q: jax.Array,
    pos_c: jax.Array,
    k: int,
    q_offset=0,
    include_self: bool = False,
    mask_c: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """k nearest *candidates* for a separate query set — the asymmetric kNN
    used by the particle-sharded surrogate (``parallel/surrogate.py``): each
    device's query shard searches the all-gathered candidate array.

    :param pos_q: (Nq, 3) query positions (a shard of the candidates).
    :param pos_c: (Nc, 3) candidate positions (the full array).
    :param q_offset: global index of query row 0 within the candidate array
        (used to exclude each query's own candidate slot). May be traced
        (e.g. ``axis_index * shard``).
    :param mask_c: optional (Nc,) candidate validity.
    :return: (idx, valid) — (Nq, k) int32 indices into the candidate array.
    """
    nq, nc = pos_q.shape[0], pos_c.shape[0]
    k = min(k, nc)
    d2 = (
        jnp.sum(pos_q * pos_q, axis=1)[:, None]
        + jnp.sum(pos_c * pos_c, axis=1)[None, :]
        - 2.0 * jnp.matmul(pos_q, pos_c.T, precision=jax.lax.Precision.HIGHEST)
    )
    d2 = jnp.maximum(d2, 0.0)
    cols = jnp.arange(nc)[None, :]
    if not include_self:
        rows = q_offset + jnp.arange(nq)
        d2 = jnp.where(cols == rows[:, None], _INF, d2)
    if mask_c is not None:
        d2 = jnp.where(mask_c.astype(bool)[None, :], d2, _INF)
    neg, idx = jax.lax.top_k(-d2, k)
    valid = neg > -_INF
    return jnp.where(valid, idx, 0).astype(jnp.int32), valid


def batched_knn_neighbors(pos, k, mask=None, include_self=False, approx=False):
    """vmap of :func:`knn_neighbors` over a leading batch axis.

    Replaces PyG's batch-vector trick (``knn_graph(..., batch=batch)``,
    reference ``gnn.py:13``): each snapshot in the (B, N, 3) batch gets an
    independent neighbor graph.
    """
    fn = lambda p, m: knn_neighbors(
        p, k, mask=m, include_self=include_self, approx=approx
    )
    if mask is None:
        return jax.vmap(lambda p: fn(p, None))(pos)
    return jax.vmap(fn)(pos, mask)
