"""Space-filling-curve kNN — the production large-N neighbor search
(SURVEY.md §7 hard part (a); the role of ``torch_cluster.knn_graph`` at
reference ``datautils.py:36`` / ``contconv.py:225`` at 100k-body scale).

The exact streamed search (``ops/knn.py``) is O(N^2) distances, which costs
more than the direct-sum force evaluation it is meant to replace, so
surrogates have no large-N reason to exist on top of it. A fixed-cell hash
grid needs quasi-uniform density and fails on clustered galaxy profiles.

This module is the adaptive replacement: sort particles along Morton
(Z-order) curves and take each particle's candidates from a window of its
sorted neighborhood. Because the curve is hierarchical, the window adapts to
*local* density automatically — in a dense cluster the window spans a tiny
region, in the sparse rim a wide one — exactly what a fixed-cell hash grid
cannot do. Design choices, each validated by a recall sweep on the actual
galaxy IC distributions (``experiments/knn_recall.py``):

- **Isotropic quantisation** (one scale for all axes). Per-axis scaling
  stretches a thin disk's z-axis ~20x and destroys physical locality along
  the curve — recall collapsed from 0.96 to 0.39 on disks.
- **Shifted + rotated curve copies** (Connor & Kumar-style). A single curve
  misses neighbors across cell-boundary discontinuities; axis-permuted
  interleavings share the same discontinuity planes and gain little
  (+0.05). Translated copies move the cell boundaries; 45-degree-rotated
  copies move the *directions* of the boundary planes.
- **Blocked sliding windows in sorted order.** No random row gathers:
  positions are carried through the sort as extra ``lax.sort`` operands;
  candidate windows are *contiguous slices* of the sorted array processed in
  blocks of B rows, so candidate distances are one (B, B+2W) norm-expansion
  matmul per block; per-block selection is a k-pass min-extraction; results
  return to original row order with a single scatter (OOB rows dropped). A
  block row sees candidates spanning its whole block, so the effective
  window is W..W+B per side, wider than the nominal W.

Everything is static-shape, O(N·(B+2W)) work, one payload sort per copy per
call — jittable, vmappable, and cheap enough to rebuild per rollout step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

_INF = float(jnp.finfo(jnp.float32).max)
_BIG = 1e15  # sentinel coordinate for padded/masked rows (d2 ~ 1e30 < _INF)
_N_BITS = 10  # 1024^3 virtual grid; 3*10 bits fit an int32 Morton key
_MAX_Q = 2**_N_BITS - 1

_SQ2 = 2.0**-0.5
# (rotation, shift) per curve copy: identity / shifted / rotated-about-z /
# rotated-about-y, shifts chosen irrational-ish so boundaries never realign.
_COPIES = (
    (None, 0.0),
    (None, 0.41),
    (((_SQ2, -_SQ2, 0.0), (_SQ2, _SQ2, 0.0), (0.0, 0.0, 1.0)), 0.17),
    (((_SQ2, 0.0, -_SQ2), (0.0, 1.0, 0.0), (_SQ2, 0.0, _SQ2)), 0.59),
)


def _part1by2(x: jax.Array) -> jax.Array:
    """Spread the low 10 bits of ``x`` out to every 3rd bit (int32-safe)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_keys(
    pos: jax.Array,
    mask: Optional[jax.Array] = None,
    shift: float = 0.0,
    rot=None,
) -> jax.Array:
    """(N,) int32 Z-order keys of (N, 3) positions, quantised isotropically
    (shared scale = the largest axis span of the masked bounding box) to a
    1024^3 grid. ``shift`` translates the grid by that fraction of the box;
    ``rot`` optionally pre-rotates positions (3x3 row-major tuple). Masked
    rows get INT32_MAX keys so they sort to the end."""
    if rot is not None:
        pos = pos @ jnp.asarray(rot, pos.dtype).T
    if mask is not None:
        m = mask.astype(bool)[:, None]
        lo = jnp.min(jnp.where(m, pos, jnp.inf), axis=0)
        hi = jnp.max(jnp.where(m, pos, -jnp.inf), axis=0)
    else:
        lo = jnp.min(pos, axis=0)
        hi = jnp.max(pos, axis=0)
    span = jnp.maximum(jnp.max(hi - lo), 1e-30)
    q = jnp.clip(
        (pos - lo) * (_MAX_Q / span) + shift * _MAX_Q, 0, _MAX_Q
    ).astype(jnp.int32)
    key = (
        _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)
    )
    if mask is not None:
        key = jnp.where(mask.astype(bool), key, jnp.int32(0x7FFFFFFF))
    return key


def _select_k(d2: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Per-row k smallest of d2 (B, C) -> (sel (B, k) col indices, d2 (B, k)).

    k-pass min-extraction: each pass takes the row minimum and masks its
    column; falls back to ``lax.top_k`` for large k."""
    if k > 16:
        neg, sel = jax.lax.top_k(-d2, k)
        return sel, -neg
    cols = jnp.arange(d2.shape[1])[None, :]
    sels, vals = [], []
    for _ in range(k):
        am = jnp.argmin(d2, axis=1)
        vals.append(jnp.min(d2, axis=1))
        sels.append(am.astype(jnp.int32))
        d2 = jnp.where(cols == am[:, None], _INF, d2)
    return jnp.stack(sels, axis=1), jnp.stack(vals, axis=1)


def _copy_pass(pos, gid, k, block, window, rot, shift, include_self, mask):
    """One curve copy: payload-sort into curve order, blocked sliding-window
    distances + selection, results keyed by original row ids.

    :return: (qg (nb*B,), idx (nb*B, k) global ids, d2 (nb*B, k)) — rows in
        sorted order; ``qg`` maps each row back to its original id (pad rows
        carry qg = n, one past the valid range, for scatter-drop)."""
    n = pos.shape[0]
    b, w = block, window
    keys = morton_keys(pos, mask, shift=shift, rot=rot)
    if mask is not None:  # masked rows: sentinel coords, never neighbors
        pos = jnp.where(mask.astype(bool)[:, None], pos, _BIG)
    _, sx, sy, sz, sg = jax.lax.sort(
        (keys, pos[:, 0], pos[:, 1], pos[:, 2], gid), num_keys=1
    )
    spos = jnp.stack([sx, sy, sz], axis=1)

    nb = -(-n // b)
    spos_p = jnp.pad(spos, ((0, nb * b - n), (0, 0)), constant_values=_BIG)
    sg_p = jnp.pad(sg, (0, nb * b - n), constant_values=n)
    padded = jnp.pad(spos_p, ((w, w), (0, 0)), constant_values=_BIG)
    padded_g = jnp.pad(sg_p, (w, w), constant_values=n)

    iw = jnp.arange(b)[:, None]
    cols = jnp.arange(b + 2 * w)[None, :]

    def blk(i):
        q = jax.lax.dynamic_slice(spos_p, (i * b, 0), (b, 3))
        qg = jax.lax.dynamic_slice(sg_p, (i * b,), (b,))
        c = jax.lax.dynamic_slice(padded, (i * b, 0), (b + 2 * w, 3))
        cg = jax.lax.dynamic_slice(padded_g, (i * b,), (b + 2 * w,))
        d2 = (
            jnp.sum(q * q, axis=1)[:, None]
            + jnp.sum(c * c, axis=1)[None, :]
            - 2.0 * jnp.matmul(q, c.T, precision=jax.lax.Precision.HIGHEST)
        )
        bad = d2 >= 1e29  # sentinel pads / masked rows
        if not include_self:
            bad |= cols == iw + w  # row j's own column is j + w
        d2 = jnp.where(bad, _INF, jnp.maximum(d2, 0.0))
        sel, sd2 = _select_k(d2, k)
        gidx = cg[sel]  # (b, k) gather from a tiny (b+2w,) vector
        return qg, gidx, sd2

    qg, gidx, sd2 = jax.lax.map(blk, jnp.arange(nb))
    return qg.reshape(-1), gidx.reshape(-1, k), sd2.reshape(-1, k)


def _merge_dedup(cand, d2, k, chunk=512):
    """Merge copies' candidates (N, C) -> unique k nearest per row.

    k-pass extraction with *id masking*: each pass takes the row-min distance
    and masks every slot holding the same candidate id, which performs the
    cross-copy dedup for free. Chunked via lax.map (a memory knob: the
    per-pass (chunk, C) temporaries stay small)."""
    n, c = cand.shape
    nch = -(-n // chunk)
    cand_p = jnp.pad(cand, ((0, nch * chunk - n), (0, 0)), constant_values=-1)
    d2_p = jnp.pad(d2, ((0, nch * chunk - n), (0, 0)), constant_values=_INF)

    def mrg(i):
        cc = jax.lax.dynamic_slice(cand_p, (i * chunk, 0), (chunk, c))
        dd = jax.lax.dynamic_slice(d2_p, (i * chunk, 0), (chunk, c))
        ids, vals = [], []
        for _ in range(k):
            am = jnp.argmin(dd, axis=1)
            mn = jnp.min(dd, axis=1)
            picked = jnp.take_along_axis(cc, am[:, None], axis=1)  # (chunk, 1)
            ids.append(picked[:, 0])
            vals.append(mn)
            dd = jnp.where(cc == picked, _INF, dd)  # masks ALL duplicates
        return jnp.stack(ids, axis=1), jnp.stack(vals, axis=1)

    idx, val = jax.lax.map(mrg, jnp.arange(nch))
    return idx.reshape(-1, k)[:n], val.reshape(-1, k)[:n]


def knn_morton(
    pos: jax.Array,
    k: int,
    mask: Optional[jax.Array] = None,
    include_self: bool = False,
    window: int = 64,
    block: int = 256,
    n_copies: int = 4,
) -> Tuple[jax.Array, jax.Array]:
    """Approximate (measured >=0.99-recall on galaxy profiles) k nearest
    neighbors in O(N·(B+2W)).

    Same contract as :func:`nbody_sim.ops.knn.knn_neighbors`: returns
    ``(idx, valid)`` dense (N, k) neighbor indices + validity.

    :param window: nominal half-window (a block row actually sees W..W+B
        candidates per side). Defaults measured >=0.996 recall at k=10 on
        disk/spiral profiles; scale up with k.
    :param block: rows per blocked-distance step.
    :param n_copies: how many curve copies to union (<= 4: identity, shifted,
        two rotated — see ``_COPIES``).
    """
    n = pos.shape[0]
    k = min(k, n)
    n_copies = min(n_copies, len(_COPIES))

    if n <= max(2 * window + 1, 2 * block):
        # Small-N degenerate case: one dense block covers everything.
        d = pos[None, :, :] - pos[:, None, :]
        d2 = jnp.sum(d * d, axis=-1)
        bad = jnp.zeros(d2.shape, bool)
        if not include_self:
            bad |= jnp.eye(n, dtype=bool)
        if mask is not None:
            m = mask.astype(bool)
            bad |= ~m[None, :]
        d2 = jnp.where(bad, _INF, d2)
        sel, sd2 = _select_k(d2, k)
        valid = sd2 < 1e29
        if mask is not None:
            valid = valid & mask.astype(bool)[:, None]
        return jnp.where(valid, sel, 0).astype(jnp.int32), valid

    idx_bufs, d2_bufs = [], []
    gid = jnp.arange(n, dtype=jnp.int32)
    for rot, shift in _COPIES[:n_copies]:
        qg, gidx, sd2 = _copy_pass(
            pos, gid, k, block, window, rot, shift, include_self, mask
        )
        # Scatter back to original row order; pad rows (qg == n) drop. One
        # whole-row scatter per copy (scattering into a column slice of a
        # shared wide buffer is far slower than whole rows).
        idx_bufs.append(
            jnp.full((n, k), -1, jnp.int32).at[qg].set(gidx, mode="drop")
        )
        d2_bufs.append(
            jnp.full((n, k), _INF, jnp.float32).at[qg].set(sd2, mode="drop")
        )
    idx, d2 = _merge_dedup(
        jnp.concatenate(idx_bufs, axis=1),
        jnp.concatenate(d2_bufs, axis=1), k
    )
    valid = d2 < 1e29
    if mask is not None:
        valid = valid & mask.astype(bool)[:, None]
    idx = jnp.where(valid, idx, 0)
    return jnp.clip(idx, 0, n - 1).astype(jnp.int32), valid


def batched_knn_morton(
    pos, k, mask=None, include_self=False, window=64, block=256, n_copies=4,
):
    """vmap of :func:`knn_morton` over a leading batch axis."""
    fn = lambda p, m: knn_morton(
        p, k, mask=m, include_self=include_self, window=window, block=block,
        n_copies=n_copies,
    )
    if mask is None:
        return jax.vmap(lambda p: fn(p, None))(pos)
    return jax.vmap(fn)(pos, mask)
