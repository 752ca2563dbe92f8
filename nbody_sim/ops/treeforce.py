"""Block-multipole approximate gravity ("Barnes-Hut-lite") — beyond-parity
large-N classical forces.

The reference's only classical engine is the dense O(N^2) direct sum
(``/root/reference/src/galaxify/simulation.py:80-88``), which caps ground
truth at ~10^4 bodies. This backend reuses the Morton-curve machinery of
``ops/spatial.py`` to build a two-level approximation that is
accelerator-shaped end to end (static shapes, contiguous slices, fused
pairwise and multipole kernels, no tree pointers):

1. sort particles into Morton order and cut the sorted array into ``nb``
   contiguous blocks of ``B`` rows — equal-*count* Z-order blocks are
   spatially compact and automatically shrink in dense regions, so they
   double as the nodes of a one-level adaptive tree;
2. every block keeps an exact softened interaction with its ``M = n_near``
   nearest blocks (by center-of-mass distance, self always included —
   distance 0), computed by the pairwise kernel of ``ops/pairwise.py`` (or,
   in the XLA path, the norm-expansion + matmul contraction of
   ``core.forces.pairwise_accelerations``);
3. every other block contributes through its multipole moments about the
   COM — monopole + traceless quadrupole (the dipole vanishes about the
   COM):

       a = G [ -M r / s^3  +  Q r / s^5  -  (5/2) (r^T Q r) r / s^7 ],
       Q_ab = sum_k m_k (3 d_ka d_kb - |d_k|^2 delta_ab),
       s^2 = r^2 + eps^2  (softened radii; r = particle - COM)

   evaluated over *all* blocks in one pass, then the near set's multipole
   contribution is subtracted exactly (no double counting).

Cost: O(N · (M·B + N/B)) instead of O(N^2). Accuracy is set by the
effective opening angle: raising ``n_near`` monotonically approaches the
exact force (at ``M >= nb`` the far set is empty and the result IS the
direct sum); the quadrupole term buys ~(block extent / distance) over a
monopole-only far field.

The partition (sort permutation + near sets) may be *stale*: forces are
always evaluated with fresh positions/moments under the stored assignment,
so a partition refreshed every R steps (like the surrogate's
``graph_refresh``) amortises the sort without changing what is computed —
only how well the blocks still hug the particles.

Self-interactions need no masking: the softened force kernel
``(r_j - r_i) / (|r_j - r_i|^2 + eps^2)^{3/2}`` vanishes at r_j = r_i.
Momentum is not exactly conserved across the exact/multipole seam (the
COM-top-M near relation is mostly but not perfectly symmetric) — the same
tradeoff every one-sided treecode makes.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from jax.experimental import pallas as pl

from nbody_sim.ops.dispatch import resolve_impl
from nbody_sim.ops.spatial import morton_keys, _select_k

_HI = jax.lax.Precision.HIGHEST
_ADJ = 4  # structural near-window half-width (see build_bh_partition)
# Floor under the softened squared distance. At softening == 0 a self-pair
# (or a particle sitting on a block's COM) hits d2 == 0; the floor must
# keep every radial power finite in float32 — the quadrupole term uses
# inv^7, so the floor must satisfy floor^-3.5 < f32 max with real margin
# (1e-10 gives inv7 ~ 1e35, ~3000x below f32 max; 1e-11 left only ~7%).
# The zero displacement then cancels the (huge but finite) coefficients
# exactly. No effect at production softening (eps^2 = 2.5e-3 >> floor).
_D2_FLOOR = 1e-10
assert _D2_FLOOR ** -3.5 < 3.4e38 / 100, "inv^7 must stay finite in f32"


class BHPartition(NamedTuple):
    """Morton partition of the particle set.

    :param sorted_gid: (nb*B,) int32 — original row id of each sorted slot;
        pad slots carry ``n`` (one past the valid range) and sit at the END
        of slot space.
    :param near: (nb, M) int32 — block ids of each block's exact set.
    :param inv_rank: (n,) int32 — sorted slot of each original row (the
        inverse permutation). Lets fresh state be brought into sorted order
        by a payload *sort* instead of a row gather by permutation.
    """

    sorted_gid: jax.Array
    near: jax.Array
    inv_rank: jax.Array

    @property
    def n_blocks(self) -> int:
        return self.near.shape[0]


def _gather_sorted(pos, mass, partition):
    """Fresh positions/masses in sorted-slot order; pad slots (end of slot
    space) get zero mass. Implemented as one payload sort keyed on the
    stored inverse ranks (see :class:`BHPartition`)."""
    n = pos.shape[0]
    n_slots = partition.sorted_gid.shape[0]
    _, sx, sy, sz, sm = jax.lax.sort(
        (partition.inv_rank, pos[:, 0], pos[:, 1], pos[:, 2], mass),
        num_keys=1,
    )
    spos = jnp.stack([sx, sy, sz], axis=1)
    spos = jnp.pad(spos, ((0, n_slots - n), (0, 0)))
    sm = jnp.pad(sm, (0, n_slots - n))
    return spos, sm


def _unsort_acc(acc, sorted_gid, n):
    """Sorted-slot accelerations back to original row order via one payload
    sort keyed on the original ids (pad slots carry ``n`` and sort last)."""
    _, ax, ay, az = jax.lax.sort(
        (sorted_gid, acc[:, 0], acc[:, 1], acc[:, 2]), num_keys=1
    )
    return jnp.stack([ax, ay, az], axis=1)[:n]


def _block_moments(spos, smass, nb, block):
    """Per-block mass, COM and traceless quadrupole (pads are inert)."""
    bp = spos.reshape(nb, block, 3)
    bm = smass.reshape(nb, block)
    msum = jnp.sum(bm, axis=1)
    com = jnp.sum(bm[..., None] * bp, axis=1) / jnp.maximum(
        msum, 1e-30
    )[..., None]
    d = bp - com[:, None, :]  # (nb, B, 3)
    # sum m d d^T at full float32 precision (a default-precision product may
    # round its operands to ~3 digits), symmetrised so that the kernel's
    # upper-triangle rows (_blk_rows) and the XLA path's full matrices are
    # the same numbers — the telescoped far field cancels them exactly
    outer = jnp.einsum("nba,nbc->nac", bm[..., None] * d, d, precision=_HI)
    outer = 0.5 * (outer + jnp.swapaxes(outer, 1, 2))
    tr = jnp.trace(outer, axis1=1, axis2=2)
    quad = 3.0 * outer - tr[:, None, None] * jnp.eye(3, dtype=spos.dtype)
    return bp, bm, msum, com, quad


@partial(jax.jit, static_argnames=("n_near", "block"))
def build_bh_partition(
    pos: jax.Array, mass: jax.Array, n_near: int = 16, block: int = 256
) -> BHPartition:
    """Sort into Morton order and pick every block's ``n_near`` *worst
    separated* blocks (self always included — separation 0).

    Selection uses the treecode opening criterion, not raw COM distance:
    blocks are ranked by d^2 / (rad_i + rad_j)^2, the squared inverse
    opening angle, where ``rad`` is the block's bounding radius about its
    COM. Equal-count Morton blocks in a galaxy's sparse rim are spatially
    huge — by COM distance they look "far" while their surfaces overlap the
    receiver, which is exactly where a multipole expansion diverges.
    O(N log N) sort + O(nb^2) block pass."""
    n = pos.shape[0]
    nb = -(-n // block)
    n_near = min(n_near, nb)
    keys = morton_keys(pos)
    gid = jnp.arange(n, dtype=jnp.int32)
    # one payload sort carries ids AND positions/masses into curve order
    # (no permutation gathers anywhere — see BHPartition.inv_rank)
    _, sg, sx, sy, sz, smass = jax.lax.sort(
        (keys, gid, pos[:, 0], pos[:, 1], pos[:, 2], mass), num_keys=1
    )
    sg_p = jnp.pad(sg, (0, nb * block - n), constant_values=n)
    _, inv_rank = jax.lax.sort((sg, gid), num_keys=1)

    spos = jnp.pad(jnp.stack([sx, sy, sz], axis=1),
                   ((0, nb * block - n), (0, 0)))
    sm = jnp.pad(smass, (0, nb * block - n))
    bp, bm, _, com, _ = _block_moments(spos, sm, nb, block)
    d = bp - com[:, None, :]
    d2m = jnp.sum(d * d, axis=-1)
    rad = jnp.sqrt(jnp.max(jnp.where(bm > 0, d2m, 0.0), axis=1))  # (nb,)
    d2 = (
        jnp.sum(com * com, axis=1)[:, None]
        + jnp.sum(com * com, axis=1)[None, :]
        - 2.0 * jnp.matmul(com, com.T, precision=_HI)
    )
    sep2 = jnp.maximum(d2, 0.0) / jnp.maximum(
        (rad[:, None] + rad[None, :]) ** 2, 1e-30
    )
    # Straggler guard: a block that spans a Morton-curve jump has members
    # far from its own COM, so *its members'* spatial neighbors are not
    # captured by any block-level criterion — but Morton locality puts them
    # in curve-adjacent blocks. Force the +-_ADJ structural window into the
    # near set (sep -1 sorts ahead of every real pair), criterion fills the
    # remaining slots. No duplicates: forcing replaces, not appends.
    ii = jnp.arange(nb)
    adj = jnp.abs(ii[:, None] - ii[None, :]) <= min(_ADJ, (n_near - 1) // 2)
    sep2 = jnp.where(adj, -1.0, sep2)
    sel, _ = _select_k(sep2, n_near)
    return BHPartition(sorted_gid=sg_p, near=sel, inv_rank=inv_rank)


def _multipole_acc(q, com, msum, quad, g, eps2):
    """Softened monopole+quadrupole pull of blocks on rows ``q``.

    :param q: (P, 3); :param com: (K, 3); :param msum: (K,);
    :param quad: (K, 3, 3) traceless quadrupoles.
    :return: (P, 3). Materialises (P, K, 3) — callers chunk P.
    """
    r = q[:, None, :] - com[None, :, :]  # (P, K, 3)
    s2 = jnp.sum(r * r, axis=-1) + eps2  # (P, K)
    inv = jax.lax.rsqrt(jnp.maximum(s2, _D2_FLOOR))
    inv2 = inv * inv
    inv3 = inv * inv2
    inv5 = inv3 * inv2
    inv7 = inv5 * inv2
    # HIGHEST precision: this term must cancel exactly against the near
    # set's contribution computed elsewhere; a default-precision product
    # may round Q·r to a few digits and leave a large-term residual
    qr = jnp.einsum("pkd,kde->pke", r, quad, precision=_HI)  # (P, K, 3)
    rqr = jnp.sum(qr * r, axis=-1)  # (P, K)
    acc = (
        -(msum[None, :] * inv3)[..., None] * r
        + inv5[..., None] * qr
        - (2.5 * rqr * inv7)[..., None] * r
    )
    return g * jnp.sum(acc, axis=1)


def _multipole_kernel(tile_k, scal_ref, q_ref, blk_ref, ax_ref, ay_ref,
                      az_ref):
    """Monopole+quadrupole pull of one group's block rows on one receiver
    tile, looping over the blocks in tiles of ``tile_k``.

    scal_ref: (2,) [g_const, eps^2]
    q_ref:    (TI, 4) receiver rows [x, y, z, 0]
    blk_ref:  (K, 16) block rows (see :func:`_blk_rows`); zero-mass/zero-Q
              padding contributes nothing
    a*_ref:   (TI,) acceleration components

    The arithmetic is cancellation-critical: the near pass subtracts this
    same expansion (``_grouped_mult`` over the near sets), so far and near
    must both run here (or both in :func:`_multipole_acc`) to cancel at
    rounding level.
    """
    from nbody_sim.ops.pairwise import _load_cols

    g = scal_ref[0]
    eps2 = scal_ref[1]
    ti = q_ref.shape[0]
    qx, qy, qz = (c[:, None] for c in _load_cols(q_ref, slice(None), 3))

    def body(k, carry):
        ax, ay, az = carry
        rows = pl.ds(pl.multiple_of(k * tile_k, tile_k), tile_k)
        cx, cy, cz, m, qxx, qyy, qzz, qxy, qxz, qyz = (
            c[None, :] for c in _load_cols(blk_ref, rows, 10))
        rx = qx - cx  # (TI, TK) r = q - com
        ry = qy - cy
        rz = qz - cz
        s2 = rx * rx + ry * ry + rz * rz + eps2
        inv = jax.lax.rsqrt(jnp.maximum(s2, _D2_FLOOR))
        inv2 = inv * inv
        inv3 = inv * inv2
        inv5 = inv3 * inv2
        inv7 = inv5 * inv2
        qr_x = qxx * rx + qxy * ry + qxz * rz
        qr_y = qxy * rx + qyy * ry + qyz * rz
        qr_z = qxz * rx + qyz * ry + qzz * rz
        rqr = qr_x * rx + qr_y * ry + qr_z * rz
        cr = -m * inv3 - 2.5 * rqr * inv7  # radial coefficient
        return (ax + (cr * rx + inv5 * qr_x), ay + (cr * ry + inv5 * qr_y),
                az + (cr * rz + inv5 * qr_z))

    # (TI, TK) accumulators, reduced once (see ops/pairwise._force_kernel)
    zero = jnp.zeros((ti, tile_k), jnp.float32)
    ax, ay, az = jax.lax.fori_loop(
        0, blk_ref.shape[0] // tile_k, body, (zero, zero, zero))
    ax_ref[...] = g * jnp.sum(ax, axis=1)
    ay_ref[...] = g * jnp.sum(ay, axis=1)
    az_ref[...] = g * jnp.sum(az, axis=1)


TILE_I = 64
TILE_K = 32


@partial(jax.jit, static_argnames=("tile_i", "tile_k", "interpret"))
def pallas_grouped_multipole_acc(qg, blkg, g, eps2, tile_i: int = TILE_I,
                                 tile_k: int = TILE_K,
                                 interpret: bool = False):
    """Per-group multipole pull: group a's receivers see ONLY group a's
    block rows — one kernel launch for all groups (grid (G, P / tile_i)).

    :param qg: (G, P, 3) grouped receiver rows.
    :param blkg: (G, K, 16) grouped block rows (see :func:`_blk_rows`;
        zero-mass/zero-Q padding is inert).
    :return: (G, P, 3).
    """
    from nbody_sim.ops.pairwise import (
        _compiler_params, _pow2_tile, _round_up)

    ng, p_, _ = qg.shape
    k_ = blkg.shape[1]
    ti = _pow2_tile(tile_i, p_)
    tk = _pow2_tile(tile_k, k_)
    p_pad = _round_up(p_, ti)
    k_pad = _round_up(k_, tk)
    q4 = jnp.pad(jnp.asarray(qg, jnp.float32),
                 ((0, 0), (0, p_pad - p_), (0, 1)))
    blk = jnp.pad(blkg, ((0, 0), (0, k_pad - k_), (0, 0)))
    scal = jnp.stack([jnp.asarray(g, jnp.float32),
                      jnp.asarray(eps2, jnp.float32)])
    ax, ay, az = pl.pallas_call(
        partial(_multipole_kernel, tk),
        grid=(ng, p_pad // ti),
        in_specs=[
            pl.BlockSpec((2,), lambda a, i: (0,)),
            pl.BlockSpec((None, ti, 4), lambda a, i: (a, i, 0)),
            pl.BlockSpec((None, k_pad, 16), lambda a, i: (a, 0, 0)),
        ],
        out_specs=[pl.BlockSpec((None, ti), lambda a, i: (a, i))] * 3,
        out_shape=[jax.ShapeDtypeStruct((ng, p_pad), jnp.float32)] * 3,
        compiler_params=_compiler_params(),
        backend="triton",
        interpret=interpret,
        name="multipole_far",
    )(scal, q4, blk)
    return jnp.stack([ax, ay, az], axis=-1)[:, :p_]


def pallas_multipole_acc(q, com, msum, quad, g, eps2, tile_i: int = TILE_I,
                         tile_k: int = TILE_K, interpret: bool = False):
    """Softened monopole+quadrupole pull of all (com, msum, quad) blocks on
    rows ``q`` — the kernel twin of :func:`_multipole_acc` (no (P, K, 3)
    intermediates): :func:`pallas_grouped_multipole_acc` with one group.

    :param q: (P, 3); :param com: (K, 3); :param msum: (K,);
    :param quad: (K, 3, 3) symmetric traceless quadrupoles.
    :return: (P, 3).
    """
    return pallas_grouped_multipole_acc(
        q[None], _blk_rows(com, msum, quad)[None], g, eps2, tile_i=tile_i,
        tile_k=tile_k, interpret=interpret)[0]


@partial(jax.jit,
         static_argnames=("n_near", "block", "i_chunk", "near_impl",
                          "interpret"))
def bh_accelerations(
    pos: jax.Array,
    mass: jax.Array,
    g_const: float,
    softening: float,
    partition: Optional[BHPartition] = None,
    n_near: int = 16,
    block: int = 256,
    i_chunk: int = 64,
    near_impl: str = "auto",
    interpret: bool = False,
) -> jax.Array:
    """Approximate softened gravitational accelerations, O(N·(M·B + N/B)).

    :param partition: reusable (possibly stale) :class:`BHPartition`; built
        fresh from ``pos`` when None. Moments/distances always use fresh
        positions.
    :param i_chunk: receiver blocks per ``lax.map`` step (memory knob: the
        (i_chunk·B, M·B) distance tile is the peak intermediate of the XLA
        path; each step must also launch enough kernel programs to fill
        the device).
    :param near_impl: force evaluation backend — "pallas" (the pairwise
        and multipole kernels, for the near AND far passes), "xla", or
        "auto" (see :func:`nbody_sim.ops.dispatch.resolve_impl`).
    :param interpret: run the kernels on the CPU interpreter (tests).
    :return: (N, 3) accelerations.
    """
    near_impl = resolve_impl(near_impl)
    n = pos.shape[0]
    if partition is None:
        partition = build_bh_partition(pos, mass, n_near=n_near, block=block)
    nb = partition.near.shape[0]

    spos, sm = _gather_sorted(pos, mass, partition)
    acc = bh_sorted_range_acc(
        spos, sm, partition.near, g_const, softening, jnp.int32(0), nb,
        i_chunk=i_chunk, near_impl=near_impl, interpret=interpret,
    )
    # back to original row order; pad slots (gid == n) sort last and drop
    return _unsort_acc(acc, partition.sorted_gid, n)


@partial(jax.jit,
         static_argnames=("nbl", "i_chunk", "near_impl", "interpret"))
def bh_sorted_range_acc(
    spos: jax.Array,
    sm: jax.Array,
    near: jax.Array,
    g_const,
    softening,
    blk0,
    nbl: int,
    i_chunk: int = 64,
    near_impl: str = "xla",
    interpret: bool = False,
) -> jax.Array:
    """Accelerations for the ``nbl`` receiver blocks starting at traced
    block index ``blk0``, in sorted order — the shardable core of
    :func:`bh_accelerations` (``parallel.bh`` splits receiver blocks across
    the mesh; every device runs this on the gathered sorted arrays).

    :param spos/sm: (nb*B,) sorted positions/masses (zero-mass pads ok).
    :param near: (nb, M) near sets for ALL blocks.
    :return: (nbl*B, 3) accelerations of the receiver range.
    """
    nb, m = near.shape
    b = spos.shape[0] // nb
    g = jnp.asarray(g_const, spos.dtype)
    eps2 = jnp.asarray(softening, spos.dtype) ** 2
    blk_pos, blk_m, msum, com, quad = _block_moments(spos, sm, nb, b)

    def rng(x):
        return jax.lax.dynamic_slice_in_dim(x, blk0, nbl, axis=0)

    q_blocks = rng(blk_pos)  # (nbl, B, 3) receiver rows
    near_r = rng(near)  # (nbl, M)

    i_chunk = min(i_chunk, nbl)  # never pad past the receiver range
    nc = -(-nbl // i_chunk)
    pad = nc * i_chunk - nbl

    def pad0(x):
        return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))

    # candidate data is gathered per chunk inside the lax.map below — the
    # full (nbl, M*B, .) gather would dwarf the documented (i_chunk*B, M*B)
    # peak intermediate (~200 MB at 1M bodies)
    q_c = pad0(q_blocks).reshape(nc, i_chunk * b, 3)
    near_c = pad0(near_r).reshape(nc, i_chunk, m)

    use_pallas = near_impl == "pallas"
    if use_pallas:
        # far field for the whole receiver range in one streamed kernel
        # launch (no (P, K, 3) intermediates), outside the chunked near loop
        blk_f = _blk_rows(com, msum, quad)
        far_all = pallas_grouped_multipole_acc(
            q_blocks.reshape(1, nbl * b, 3), blk_f[None], g, eps2,
            interpret=interpret,
        ).reshape(nbl, b, 3)
        far_all = jnp.pad(far_all, ((0, pad), (0, 0), (0, 0))).reshape(
            nc, i_chunk * b, 3)

    def chunk_fn(args):
        if use_pallas:
            q_flat, nearc, far = args
        else:
            q_flat, nearc = args
            # far field: ALL blocks' multipoles on this chunk's particles
            far = _multipole_acc(q_flat, com, msum, quad, g, eps2)
        near_terms = _near_chunk(
            q_flat, nearc, blk_pos, blk_m, com, msum, quad,
            blk_f if use_pallas else None, g, eps2, interpret,
        )
        return far + near_terms

    xs = (q_c, near_c)
    if use_pallas:
        xs = xs + (far_all,)
    return jax.lax.map(chunk_fn, xs).reshape(
        nc * i_chunk * b, 3)[: nbl * b]


def _near_chunk(q_flat, nearc, blk_pos, blk_m, com, msum, quad, blk_f, g,
                eps2, interpret):
    """``exact(near) - multipole(near)`` for one receiver chunk, shared by
    the one- and two-level engines. The near blocks' multipole term uses the
    SAME arithmetic as the far pass so the two cancel at rounding level: the
    kernel when ``blk_f`` (the :func:`_blk_rows` of all fine blocks) is
    given, :func:`_multipole_acc` otherwise.

    :param q_flat: (i_chunk*B, 3) receiver rows; :param nearc: (i_chunk, M)
        near-set block ids.
    :return: (i_chunk*B, 3).
    """
    use_pallas = blk_f is not None
    q = q_flat.reshape(nearc.shape[0], -1, 3)
    if use_pallas:
        a_nm = _grouped_mult(q, blk_f, nearc, g, eps2, True, interpret)
    else:
        a_nm = jax.vmap(
            lambda qb, cb, mb, Qb: _multipole_acc(qb, cb, mb, Qb, g, eps2)
        )(q, com[nearc], msum[nearc], quad[nearc])
    a_exact = _exact_near(q_flat, nearc, blk_pos, blk_m, g, eps2, use_pallas,
                          interpret)
    return a_exact - a_nm.reshape(q_flat.shape)


def _exact_near(q_flat, sel, row_pos, row_m, g, eps2, use_pallas,
                interpret):
    """Exact pull of each receiver block's selected source rows.

    :param q_flat: (G*B, 3) receiver rows, G blocks of B.
    :param sel: (G, S) ids of the source groups each receiver block sees.
    :param row_pos/row_m: (n_groups, R, 3)/(n_groups, R) source rows by
        group (fine blocks or sub-blocks); zero-mass pads are inert.
    :return: (G*B, 3). Self-pairs need no masking (zero displacement =>
        zero force).
    """
    n_grp, s_sel = sel.shape
    r = row_pos.shape[1]
    c = row_pos[sel].reshape(n_grp, s_sel * r, 3)
    w_m = row_m[sel].reshape(n_grp, s_sel * r)
    q = q_flat.reshape(n_grp, -1, 3)
    if use_pallas:
        from nbody_sim.ops.pairwise import pallas_partial_accelerations

        a = jax.vmap(
            lambda qb, cb, mb: pallas_partial_accelerations(
                qb, cb, mb, g, jnp.sqrt(eps2), interpret=interpret)
        )(q, c, w_m)
    else:
        d2 = (
            jnp.sum(q * q, axis=-1)[..., None]
            + jnp.sum(c * c, axis=-1)[:, None, :]
            - 2.0 * jnp.einsum("ibd,icd->ibc", q, c, precision=_HI)
        )
        inv = jax.lax.rsqrt(
            jnp.maximum(jnp.maximum(d2, 0.0) + eps2, _D2_FLOOR))
        w = w_m[:, None, :] * (inv * inv * inv)  # (G, B, S*R)
        a = g * (
            jnp.einsum("ibc,icd->ibd", w, c, precision=_HI)
            - q * jnp.sum(w, axis=-1, keepdims=True)
        )
    return a.reshape(q_flat.shape[0], 3)


# ---------------------------------------------------------------------------
# Two-level ("coarse") far field — the 1M+ engine.
#
# The one-level far pass above is O(N * nb) = O(N^2 / B); at 1M bodies it
# dominates the force eval. Here Morton blocks are additionally grouped into
# superblocks of ``coarse`` consecutive blocks (contiguous in curve order, so
# coarse structures are SLICES — the gather-free shape recorded after round
# 2's reverted FMM-lite attempt). Each coarse group carries its own
# monopole+quadrupole moments computed directly from its particles, and each
# group of receivers owns a REFINED set of ``rc`` coarse groups — chosen by
# the same worst-separation opening criterion used for the fine near sets,
# one level up, with the +-w structural curve window forced. Then
#
#   acc = coarse_far(ALL superblocks)
#       - coarse_mult(refined superblocks)        } telescoped refinement
#       + fine_far(their member fine blocks)      }
#       + exact(near) - fine_mult(near)             (unchanged near pass)
#
# Exact telescoping requires every near block to be fine-refined for its
# receivers, so the fine near selection is RESTRICTED to blocks whose parent
# superblock is in the receiver's refined set ("forced parent inclusion" by
# construction). The structural +-_ADJ fine window always qualifies because
# coarse >= _ADJ and w >= 1 bound its parent distance by 1.
#
# Cost: O(N * (M*B + N/(C*B) + rc*C + rc)) — the fine far shrinks from nb
# to rc*C evaluated blocks plus nb/C coarse ones (~20x fewer multipole
# evaluations at 1M with the defaults).
# ---------------------------------------------------------------------------


class BH2Partition(NamedTuple):
    """Two-level Morton partition: the fine fields of :class:`BHPartition`
    (with the near sets restricted to refined regions) plus the per-group
    refined superblock sets.

    :param refined: (nbc, rc) int32 — coarse group ids whose member fine
        blocks are evaluated at fine level for this group's receivers.
    """

    sorted_gid: jax.Array
    near: jax.Array
    inv_rank: jax.Array
    refined: jax.Array

    @property
    def base(self) -> BHPartition:
        return BHPartition(self.sorted_gid, self.near, self.inv_rank)

    @property
    def n_blocks(self) -> int:
        return self.near.shape[0]


def _blk_rows(com, msum, quad):
    """(K, 16) block rows for the multipole kernel:
    ``[com_x, com_y, com_z, msum, Qxx, Qyy, Qzz, Qxy, Qxz, Qyz, 0 x 6]``
    (16 floats: a power-of-two row, as Triton block shapes require)."""
    rows = jnp.stack([
        com[:, 0], com[:, 1], com[:, 2], msum,
        quad[:, 0, 0], quad[:, 1, 1], quad[:, 2, 2],
        quad[:, 0, 1], quad[:, 0, 2], quad[:, 1, 2],
    ], axis=1)
    return jnp.pad(rows, ((0, 0), (0, 6)))


def _grouped_mult(qg, blk, sel, g, eps2, use_pallas, interpret):
    """Multipole pull of each group's selected blocks on its rows.

    :param qg: (G, P, 3); :param blk: (K, 16) all blocks (:func:`_blk_rows`);
    :param sel: (G, S) selected block ids per group.
    :return: (G, P, 3).
    """
    grouped = blk[sel]  # (G, S, 16)
    if use_pallas:
        return pallas_grouped_multipole_acc(
            qg, grouped, g, eps2, interpret=interpret)
    com = grouped[..., 0:3]  # (G, S, 3)
    msum = grouped[..., 3]  # (G, S)
    qd = grouped[..., 4:10]  # (G, S, 6): xx yy zz xy xz yz
    # (G, S, 3, 3) symmetric quadrupole back from the 6 columns
    quad = jnp.stack([
        qd[..., 0], qd[..., 3], qd[..., 4],
        qd[..., 3], qd[..., 1], qd[..., 5],
        qd[..., 4], qd[..., 5], qd[..., 2],
    ], axis=-1).reshape(qd.shape[:2] + (3, 3))
    return jax.vmap(
        lambda qb, cb, mb, Qb: _multipole_acc(qb, cb, mb, Qb, g, eps2)
    )(qg, com, msum, quad)


def _bh2_partition_arrays(pos, mass, n_near, block, coarse, rc, w):
    """Shared core of :func:`build_bh2_partition` and
    :func:`build_bh3_partition`: the Morton sort, the refined-superblock
    selection, and the (refined-restricted) fine near selection. Returns
    ``(sg_p, near, inv_rank, refined, spos, sm)`` — the last two are the
    sorted/padded position+mass arrays the bh3 builder reuses for its
    sub-block selection."""
    assert coarse >= _ADJ and w >= 1, \
        "structural fine window must stay inside the forced coarse window"
    n = pos.shape[0]
    nb = -(-n // block)
    nb = -(-nb // coarse) * coarse  # whole superblocks
    nbc = nb // coarse
    n_near = min(n_near, nb)
    rc = min(rc, nbc)
    if nbc > 2 and rc < 3:
        # the forced fine near window (+-_ADJ curve blocks) can cross a
        # superblock boundary; exact telescoping needs that parent forced
        # into the refined set, i.e. a coarse window of at least +-1 —
        # (rc-1)//2 >= 1. rc < 3 would leave a near block whose fine
        # multipole is subtracted but never re-added by refinement.
        raise ValueError(
            f"build_bh2_partition needs rc >= 3 (got rc={rc} with "
            f"{nbc} superblocks) — the forced +-{_ADJ}-block fine near "
            "window must stay inside refined parents")
    # near selection is restricted to refined parents: only rc*coarse fine
    # blocks are allowed per receiver, so more slots would select
    # _INF-masked disallowed blocks and break the telescoping
    n_near = min(n_near, rc * coarse)

    keys = morton_keys(pos)
    gid = jnp.arange(n, dtype=jnp.int32)
    _, sg, sx, sy, sz, smass = jax.lax.sort(
        (keys, gid, pos[:, 0], pos[:, 1], pos[:, 2], mass), num_keys=1
    )
    sg_p = jnp.pad(sg, (0, nb * block - n), constant_values=n)
    _, inv_rank = jax.lax.sort((sg, gid), num_keys=1)

    spos = jnp.pad(jnp.stack([sx, sy, sz], axis=1),
                   ((0, nb * block - n), (0, 0)))
    sm = jnp.pad(smass, (0, nb * block - n))

    from nbody_sim.ops.spatial import _INF

    def sep_matrix(bpos, bm, k_blocks, blk_rows):
        bp = bpos.reshape(k_blocks, blk_rows, 3)
        bmm = bm.reshape(k_blocks, blk_rows)
        msum = jnp.sum(bmm, axis=1)
        com = jnp.sum(bmm[..., None] * bp, axis=1) / jnp.maximum(
            msum, 1e-30)[..., None]
        d = bp - com[:, None, :]
        d2m = jnp.sum(d * d, axis=-1)
        rad = jnp.sqrt(jnp.max(jnp.where(bmm > 0, d2m, 0.0), axis=1))
        d2 = (
            jnp.sum(com * com, axis=1)[:, None]
            + jnp.sum(com * com, axis=1)[None, :]
            - 2.0 * jnp.matmul(com, com.T, precision=_HI)
        )
        sep2 = jnp.maximum(d2, 0.0) / jnp.maximum(
            (rad[:, None] + rad[None, :]) ** 2, 1e-30)
        return jnp.where((msum > 0)[None, :], sep2, _INF), msum

    # coarse refined sets
    sep2c, _ = sep_matrix(spos, sm, nbc, coarse * block)
    iic = jnp.arange(nbc)
    adjc = jnp.abs(iic[:, None] - iic[None, :]) <= min(w, (rc - 1) // 2)
    sep2c = jnp.where(adjc, -1.0, sep2c)
    refined, _ = _select_k(sep2c, rc)

    # fine near sets, restricted to refined parents. The (nb, nb) parent
    # mask is expanded by broadcast+reshape, NOT by an (nb, nb) gather
    # with fine_par[:, None] (the expansion is ~free).
    sep2f, _ = sep_matrix(spos, sm, nb, block)
    allowed_c = jnp.zeros((nbc, nbc), bool).at[
        jnp.arange(nbc)[:, None], refined
    ].set(True)
    allowed = jnp.broadcast_to(
        allowed_c[:, None, :, None], (nbc, coarse, nbc, coarse)
    ).reshape(nb, nb)
    sep2f = jnp.where(allowed, sep2f, _INF)
    iif = jnp.arange(nb)
    adjf = jnp.abs(iif[:, None] - iif[None, :]) <= min(
        _ADJ, (n_near - 1) // 2)
    sep2f = jnp.where(adjf, -1.0, sep2f)
    near, _ = _select_k(sep2f, n_near)

    return sg_p, near, inv_rank, refined, spos, sm


@partial(jax.jit,
         static_argnames=("n_near", "block", "coarse", "rc", "w"))
def build_bh2_partition(
    pos: jax.Array,
    mass: jax.Array,
    n_near: int = 16,
    block: int = 256,
    coarse: int = 16,
    rc: int = 32,
    w: int = 1,
) -> BH2Partition:
    """Two-level partition: fine Morton blocks (padded to a multiple of
    ``coarse``), per-group refined superblock sets by the coarse opening
    criterion (+- ``w`` curve window forced), and fine near sets restricted
    to refined regions so the two-level far field telescopes exactly.

    Empty (all-pad) fine blocks and superblocks are masked out of both
    selections — their COM sits at the origin, which is typically mid-scene
    and would otherwise soak up selection slots."""
    sg_p, near, inv_rank, refined, _, _ = _bh2_partition_arrays(
        pos, mass, n_near, block, coarse, rc, w)
    return BH2Partition(sorted_gid=sg_p, near=near, inv_rank=inv_rank,
                        refined=refined)


@partial(jax.jit,
         static_argnames=("nbl", "i_chunk", "near_impl", "interpret"))
def bh2_sorted_range_acc(
    spos: jax.Array,
    sm: jax.Array,
    near: jax.Array,
    refined: jax.Array,
    g_const,
    softening,
    blk0,
    nbl: int,
    i_chunk: int = 64,
    near_impl: str = "xla",
    interpret: bool = False,
) -> jax.Array:
    """Two-level accelerations for ``nbl`` receiver blocks starting at
    traced fine-block index ``blk0`` (both must be multiples of the coarse
    factor — derived from the array shapes as nb/nbc — so receiver groups
    align with superblocks).

    :return: (nbl*B, 3) accelerations of the receiver range in sorted order.
    """
    nb, m = near.shape
    b = spos.shape[0] // nb
    nbc, rc = refined.shape
    coarse = nb // nbc
    assert nb % nbc == 0 and nbl % coarse == 0
    gr = nbl // coarse
    g = jnp.asarray(g_const, spos.dtype)
    eps2 = jnp.asarray(softening, spos.dtype) ** 2
    use_pallas = near_impl == "pallas"

    blk_pos, blk_m, msum, com, quad = _block_moments(spos, sm, nb, b)
    _, _, msum_c, com_c, quad_c = _block_moments(spos, sm, nbc, coarse * b)

    def rng(x, start, size):
        return jax.lax.dynamic_slice_in_dim(x, start, size, axis=0)

    q_blocks = rng(blk_pos, blk0, nbl)  # (nbl, B, 3)
    near_r = rng(near, blk0, nbl)
    refined_r = rng(refined, blk0 // coarse, gr)  # (gr, rc)

    rows = q_blocks.reshape(nbl * b, 3)
    qg = rows.reshape(gr, coarse * b, 3)

    # far level 1: every superblock's multipoles on every receiver
    if use_pallas:
        far = pallas_multipole_acc(rows, com_c, msum_c, quad_c, g, eps2,
                                   interpret=interpret)
    else:
        far = _multipole_acc(rows, com_c, msum_c, quad_c, g, eps2)

    # far level 2 (telescoped refinement): swap each refined superblock's
    # coarse term for its member fine blocks' terms. Fine members of
    # refined[a] are the contiguous slice refined[a]*coarse + [0, coarse).
    blk_f = _blk_rows(com, msum, quad)  # (nb, 16)
    blk_c = _blk_rows(com_c, msum_c, quad_c)  # (nbc, 16)
    fine_ids = (refined_r[:, :, None] * coarse
                + jnp.arange(coarse)[None, None, :]).reshape(gr, rc * coarse)
    far_g = (
        _grouped_mult(qg, blk_f, fine_ids, g, eps2, use_pallas, interpret)
        - _grouped_mult(qg, blk_c, refined_r, g, eps2, use_pallas,
                        interpret)
    )
    far = far + far_g.reshape(nbl * b, 3)

    # near pass: exact - fine multipole over the (restricted) near sets
    i_chunk = min(i_chunk, nbl)  # never pad past the receiver range
    nc = -(-nbl // i_chunk)
    pad = nc * i_chunk - nbl

    def pad0(x):
        return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))

    q_c = pad0(q_blocks).reshape(nc, i_chunk * b, 3)
    near_c = pad0(near_r).reshape(nc, i_chunk, m)

    near_rows = jax.lax.map(
        lambda args: _near_chunk(args[0], args[1], blk_pos, blk_m, com,
                                 msum, quad, blk_f if use_pallas else None,
                                 g, eps2, interpret),
        (q_c, near_c),
    ).reshape(nc * i_chunk * b, 3)[: nbl * b]
    return far + near_rows


@partial(jax.jit, static_argnames=("n_near", "block", "coarse", "rc",
                                   "i_chunk", "near_impl", "interpret"))
def bh2_accelerations(
    pos: jax.Array,
    mass: jax.Array,
    g_const: float,
    softening: float,
    partition: Optional[BH2Partition] = None,
    n_near: int = 16,
    block: int = 256,
    coarse: int = 16,
    rc: int = 32,
    i_chunk: int = 64,
    near_impl: str = "auto",
    interpret: bool = False,
) -> jax.Array:
    """Two-level block-multipole accelerations,
    O(N*(M*B + N/(C*B) + rc*C)) — the coarse far field drops the one-level
    engine's O(N*nb) term by ~C at large N. Error adds the coarse-vs-fine
    residual of out-of-refined-set superblocks on top of
    :func:`bh_accelerations`'s fine multipole error; both selections are
    criterion-adaptive, so raising ``rc``/``n_near`` tightens it
    monotonically.

    :param partition: reusable (possibly stale) :class:`BH2Partition`.
    """
    near_impl = resolve_impl(near_impl)
    n = pos.shape[0]
    if partition is None:
        partition = build_bh2_partition(
            pos, mass, n_near=n_near, block=block, coarse=coarse, rc=rc)
    nb = partition.near.shape[0]

    spos, sm = _gather_sorted(pos, mass, partition.base)
    acc = bh2_sorted_range_acc(
        spos, sm, partition.near, partition.refined, g_const, softening,
        jnp.int32(0), nb, i_chunk=i_chunk, near_impl=near_impl,
        interpret=interpret,
    )
    return _unsort_acc(acc, partition.sorted_gid, n)


# ---------------------------------------------------------------------------
# Three-level ("sub-refined") near pass — the Verlet-list engine.
#
# At 1M+ the cost ceiling of bh2 is the NEAR pass: every receiver evaluates
# M*B exact pairs (4096 at B=128/M=32) because the near/far split is
# quantised to whole Morton blocks — and smaller blocks double the fine-far
# multipole evaluations and the partition build.
#
# Here the near set keeps its block granularity (so the far field and the
# fine-refinement bracket are untouched), but the near evaluation telescopes
# one level further: each near block's B rows are split into S = B/Bs
# contiguous Morton SUB-blocks of Bs rows, each with its own
# monopole+quadrupole moments, and each receiver block statically selects
# the K worst-separated sub-blocks (by the same opening criterion, with the
# receiver's +-1 curve-block window forced) for exact evaluation:
#
#   near_terms = exact(K selected sub-blocks)          (K*Bs true pairs)
#              + sub_mult(the M*S - K unselected)       (32-row quadrupoles)
#              - fine_mult(near blocks)                  (unchanged subtract)
#
# which equals the exact three-level telescope
#   [sub_mult(ALL near subs) - fine_mult(near)] + [exact(sel) - sub_mult(sel)]
# with the selected sub-multipoles cancelled algebraically instead of at
# rounding level. Unselected sub-blocks — the far corners of near blocks —
# are represented by their own (4x smaller) quadrupole instead of exactly;
# their residual is the same (rad/d)^3 tier as the just-outside-near-set
# blocks' fine-multipole error, so K tunes cost against the SAME error knob
# the block engine already has.
#
# Cost per particle: K*Bs exact pairs + (M*S - K) sub-mult evals, vs M*B
# exact pairs — ~3-4x less near work at the adopted 1M config
# (K=20, Bs=32: 640 pairs + 108 evals vs 4096 pairs). This is the "hybrid
# per-particle *block* list" variant of a Verlet list: selection is per
# receiver block, so candidate gathers stay at block granularity instead of
# a per-particle (N, L) row gather.
# Staleness is handled exactly like bh/bh2: selection is part of the
# partition, refreshed every bh_refresh steps, forces always use fresh
# positions (the Verlet-skin condition maps to K's selection margin).
# ---------------------------------------------------------------------------


class BH3Partition(NamedTuple):
    """Two-level Morton partition plus the per-receiver-block sub-block
    split of the near evaluation.

    :param sub_near: (nb, K) int32 — global sub-block ids (sub id =
        fine_block_id * S + s) evaluated EXACTLY for this receiver block.
    :param sub_far: (nb, M*S - K) int32 — the complement: near-set
        sub-blocks represented by their own multipole moments.
    The sub factor S is implied: S = (K + U) / M; Bs = B / S.
    """

    sorted_gid: jax.Array
    near: jax.Array
    inv_rank: jax.Array
    refined: jax.Array
    sub_near: jax.Array
    sub_far: jax.Array

    @property
    def base(self) -> BHPartition:
        return BHPartition(self.sorted_gid, self.near, self.inv_rank)

    @property
    def n_blocks(self) -> int:
        return self.near.shape[0]


@partial(jax.jit,
         static_argnames=("n_near", "block", "coarse", "rc", "sub_block",
                          "n_sub", "w"))
def build_bh3_partition(
    pos: jax.Array,
    mass: jax.Array,
    n_near: int = 16,
    block: int = 256,
    coarse: int = 16,
    rc: int = 32,
    sub_block: int = 32,
    n_sub: int = 24,
    w: int = 1,
) -> BH3Partition:
    """:func:`build_bh2_partition` plus the sub-block exact/multipole split
    of each receiver block's near candidates (see the section comment).

    :param sub_block: rows per near-evaluation sub-block (divides ``block``).
    :param n_sub: sub-blocks evaluated exactly per receiver block; clamped
        to [3*S, M*S] — the receiver's own +-1 curve-block window (3*S subs)
        is always forced exact, because a receiver INSIDE a sub-block would
        otherwise see that sub-block's multipole evaluated at an interior
        point, where the expansion diverges.
    """
    if block % sub_block:
        raise ValueError(
            f"sub_block={sub_block} must divide block={block}")
    s = block // sub_block
    sg_p, near, inv_rank, refined, spos, sm = _bh2_partition_arrays(
        pos, mass, n_near, block, coarse, rc, w)
    nb, m = near.shape
    nbs = nb * s
    n_sub = max(min(3 * s, m * s), min(n_sub, m * s))

    from nbody_sim.ops.spatial import _INF

    # sub-block COM + bounding radius from the sorted arrays
    sp = spos.reshape(nbs, sub_block, 3)
    smm = sm.reshape(nbs, sub_block)
    msum_s = jnp.sum(smm, axis=1)
    com_s = jnp.sum(smm[..., None] * sp, axis=1) / jnp.maximum(
        msum_s, 1e-30)[..., None]
    ds = sp - com_s[:, None, :]
    rad_s = jnp.sqrt(jnp.max(
        jnp.where(smm > 0, jnp.sum(ds * ds, axis=-1), 0.0), axis=1))

    # receiver fine-block COM + radius
    bp = spos.reshape(nb, block, 3)
    bm = sm.reshape(nb, block)
    msum_b = jnp.sum(bm, axis=1)
    com_b = jnp.sum(bm[..., None] * bp, axis=1) / jnp.maximum(
        msum_b, 1e-30)[..., None]
    db = bp - com_b[:, None, :]
    rad_b = jnp.sqrt(jnp.max(
        jnp.where(bm > 0, jnp.sum(db * db, axis=-1), 0.0), axis=1))

    # candidates: every sub-block of every near block, in near-set order
    cand = (near[:, :, None] * s
            + jnp.arange(s, dtype=near.dtype)[None, None, :]
            ).reshape(nb, m * s)
    diff = com_b[:, None, :] - com_s[cand]  # (nb, M*S, 3)
    d2 = jnp.sum(diff * diff, axis=-1)
    sep2 = jnp.maximum(d2, 0.0) / jnp.maximum(
        (rad_b[:, None] + rad_s[cand]) ** 2, 1e-30)
    # empty (all-pad) sub-blocks never earn an exact slot (zero mass makes
    # them inert either way — this just keeps the slots useful)
    sep2 = jnp.where(msum_s[cand] > 0, sep2, _INF)
    # force the receiver's +-1 curve-block window exact (self sub-blocks
    # included): the opening criterion cannot rank sub-blocks the receiver
    # sits inside, and Morton-jump stragglers live in curve neighbors
    forced = jnp.abs(cand // s - jnp.arange(nb, dtype=cand.dtype)[:, None]
                     ) <= 1
    sep2 = jnp.where(forced, -1.0, sep2)
    # one row sort splits exact (first K) from multipole (the rest)
    _, order = jax.lax.sort((sep2, cand), num_keys=1)
    return BH3Partition(
        sorted_gid=sg_p, near=near, inv_rank=inv_rank, refined=refined,
        sub_near=order[:, :n_sub], sub_far=order[:, n_sub:])


def _near_chunk_sub(q_flat, selc, farc, nearc, sub_pos, sub_m, blk_s,
                    blk_f, g, eps2, use_pallas, interpret):
    """``exact(selected subs) + sub_mult(unselected subs) - fine_mult(near)``
    for one receiver chunk — the sub-refined twin of :func:`_near_chunk`.

    :param q_flat: (i_chunk*B, 3) receiver rows.
    :param selc: (i_chunk, K) exact sub ids; :param farc: (i_chunk, U)
        multipole sub ids; :param nearc: (i_chunk, M) near block ids.
    :param sub_pos/sub_m: (nbs, Bs, 3)/(nbs, Bs) sorted rows by sub-block.
    :param blk_s: (nbs, 16) sub-block moments; :param blk_f: (nb, 16)
        fine-block moments (rows as in :func:`_blk_rows`).
    :return: (i_chunk*B, 3).
    """
    q = q_flat.reshape(selc.shape[0], -1, 3)
    acc = _exact_near(q_flat, selc, sub_pos, sub_m, g, eps2, use_pallas,
                      interpret).reshape(q.shape)
    acc = acc - _grouped_mult(q, blk_f, nearc, g, eps2, use_pallas,
                              interpret)
    if farc.shape[1]:
        acc = acc + _grouped_mult(q, blk_s, farc, g, eps2, use_pallas,
                                  interpret)
    return acc.reshape(q_flat.shape[0], 3)


@partial(jax.jit,
         static_argnames=("nbl", "i_chunk", "near_impl", "interpret"))
def bh3_sorted_range_acc(
    spos: jax.Array,
    sm: jax.Array,
    near: jax.Array,
    refined: jax.Array,
    sub_near: jax.Array,
    sub_far: jax.Array,
    g_const,
    softening,
    blk0,
    nbl: int,
    i_chunk: int = 64,
    near_impl: str = "xla",
    interpret: bool = False,
) -> jax.Array:
    """Sub-refined two-level accelerations for ``nbl`` receiver blocks
    starting at traced fine-block index ``blk0`` — the far field of
    :func:`bh2_sorted_range_acc` with the near pass replaced by the
    sub-block exact/multipole split (see the section comment).

    :return: (nbl*B, 3) accelerations of the receiver range in sorted order.
    """
    nb, m = near.shape
    b = spos.shape[0] // nb
    nbc, rc = refined.shape
    coarse = nb // nbc
    assert nb % nbc == 0 and nbl % coarse == 0
    s = (sub_near.shape[1] + sub_far.shape[1]) // m
    assert s * m == sub_near.shape[1] + sub_far.shape[1] and b % s == 0
    bs = b // s
    nbs = nb * s
    gr = nbl // coarse
    g = jnp.asarray(g_const, spos.dtype)
    eps2 = jnp.asarray(softening, spos.dtype) ** 2
    use_pallas = near_impl == "pallas"

    blk_pos, _, msum, com, quad = _block_moments(spos, sm, nb, b)
    _, _, msum_c, com_c, quad_c = _block_moments(spos, sm, nbc, coarse * b)
    sub_pos, sub_m, msum_s, com_s, quad_s = _block_moments(spos, sm, nbs, bs)

    def rng(x, start, size):
        return jax.lax.dynamic_slice_in_dim(x, start, size, axis=0)

    q_blocks = rng(blk_pos, blk0, nbl)  # (nbl, B, 3)
    near_r = rng(near, blk0, nbl)
    sel_r = rng(sub_near, blk0, nbl)
    far_r = rng(sub_far, blk0, nbl)
    refined_r = rng(refined, blk0 // coarse, gr)  # (gr, rc)

    rows = q_blocks.reshape(nbl * b, 3)
    qg = rows.reshape(gr, coarse * b, 3)

    # far level 1 + telescoped level-2 refinement: identical to bh2
    if use_pallas:
        far = pallas_multipole_acc(rows, com_c, msum_c, quad_c, g, eps2,
                                   interpret=interpret)
    else:
        far = _multipole_acc(rows, com_c, msum_c, quad_c, g, eps2)
    blk_f = _blk_rows(com, msum, quad)  # (nb, 16)
    blk_c = _blk_rows(com_c, msum_c, quad_c)  # (nbc, 16)
    blk_s = _blk_rows(com_s, msum_s, quad_s)  # (nbs, 16)
    fine_ids = (refined_r[:, :, None] * coarse
                + jnp.arange(coarse)[None, None, :]).reshape(gr, rc * coarse)
    far_g = (
        _grouped_mult(qg, blk_f, fine_ids, g, eps2, use_pallas, interpret)
        - _grouped_mult(qg, blk_c, refined_r, g, eps2, use_pallas,
                        interpret)
    )
    far = far + far_g.reshape(nbl * b, 3)

    # near pass: sub-refined exact/multipole split
    i_chunk = min(i_chunk, nbl)  # never pad past the receiver range
    nc = -(-nbl // i_chunk)
    pad = nc * i_chunk - nbl

    def pad0(x):
        return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))

    q_c = pad0(q_blocks).reshape(nc, i_chunk * b, 3)
    near_c = pad0(near_r).reshape(nc, i_chunk, m)
    sel_c = pad0(sel_r).reshape(nc, i_chunk, sel_r.shape[1])
    far_c = pad0(far_r).reshape(nc, i_chunk, far_r.shape[1])

    near_rows = jax.lax.map(
        lambda args: _near_chunk_sub(
            args[0], args[1], args[2], args[3], sub_pos, sub_m, blk_s,
            blk_f, g, eps2, use_pallas, interpret),
        (q_c, sel_c, far_c, near_c),
    ).reshape(nc * i_chunk * b, 3)[: nbl * b]
    return far + near_rows


@partial(jax.jit, static_argnames=("n_near", "block", "coarse", "rc",
                                   "sub_block", "n_sub", "i_chunk",
                                   "near_impl", "interpret"))
def bh3_accelerations(
    pos: jax.Array,
    mass: jax.Array,
    g_const: float,
    softening: float,
    partition: Optional[BH3Partition] = None,
    n_near: int = 16,
    block: int = 256,
    coarse: int = 16,
    rc: int = 32,
    sub_block: int = 32,
    n_sub: int = 24,
    i_chunk: int = 64,
    near_impl: str = "auto",
    interpret: bool = False,
) -> jax.Array:
    """Sub-refined two-level block-multipole accelerations,
    O(N*(K*Bs + M*S + N/(C*B) + rc*C)) — :func:`bh2_accelerations` with the
    near pass's M*B exact pairs cut to K*Bs true-nearest sub-block pairs
    plus (M*S - K) sub-quadrupole evaluations. Raising ``n_sub`` tightens
    the near error monotonically; at n_sub = M*S the near pass IS bh2's.

    :param partition: reusable (possibly stale) :class:`BH3Partition` —
        sub_block/n_sub are implied by its array shapes when provided.
    """
    near_impl = resolve_impl(near_impl)
    n = pos.shape[0]
    if partition is None:
        partition = build_bh3_partition(
            pos, mass, n_near=n_near, block=block, coarse=coarse, rc=rc,
            sub_block=sub_block, n_sub=n_sub)
    nb = partition.near.shape[0]

    spos, sm = _gather_sorted(pos, mass, partition.base)
    acc = bh3_sorted_range_acc(
        spos, sm, partition.near, partition.refined, partition.sub_near,
        partition.sub_far, g_const, softening, jnp.int32(0), nb,
        i_chunk=i_chunk, near_impl=near_impl, interpret=interpret,
    )
    return _unsort_acc(acc, partition.sorted_gid, n)
