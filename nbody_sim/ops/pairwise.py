"""Tiled all-pairs gravity kernels (Pallas through Triton) — the fused
replacement for the reference's broadcasted O(N^2) torch evaluation
(``/root/reference/src/galaxify/simulation.py:80-88``).

The reference materialises the full (N, N, 3) displacement tensor in device
memory every step. Here every pair lives only in registers: one program owns
a tile of ``tile_i`` receivers and loops over the source array in tiles of
``tile_j`` rows, accumulating in float32. Nothing is carried between
programs, so the grid has no order to respect.

Bodies enter the kernels packed as (N, 4) rows ``[x, y, z, m]`` (16 bytes,
power-of-two width as Triton block shapes require), zero-padded to whole
tiles; zero-mass padding exerts no force and has no energy. Per-coordinate
broadcasts (TI, 1) - (1, TJ) keep the arithmetic exact (no
|a|^2 + |b|^2 - 2ab cancellation).

The force kernel is *rectangular*: it computes forces exerted by a source
set J on a target set I and needs no self-pair mask — a coincident pair's
force is w * dx == w * 0 == 0 exactly (``_D2_FLOOR`` keeps w finite even at
softening 0). So the same kernel serves the single-device full product, each
step of the multi-device ring (``nbody_sim.parallel.ring``) and the near
pass of the block-multipole engines (``ops/treeforce.py``). The energy
kernel emits one partial sum per receiver, ``sum_{j != i} m_j / (d + eps)``,
and XLA finishes the sum: U = -G/2 sum_i m_i u_i, the symmetric form of the
reference's upper-triangle sum.

``interpret=True`` runs the same kernels on the CPU interpreter; it is a test
argument, never a fallback.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Floor keeps rsqrt(d2)^3 finite for coincident slots when softening == 0:
# it must be >= ~1e-25 or inv^3 overflows float32 (1e-30 -> 1e15^3 = inf,
# and inf * 0 displacement = NaN). Matters for callers that rely on the zero
# displacement to cancel self-pairs (the ring and ops/treeforce.py's near
# pass). Real coincident distinct pairs with softening == 0 are singular in
# the reference too — the floor turns that into a huge-but-finite force.
_D2_FLOOR = 1e-18

TILE_I = 16
TILE_J = 64
NUM_WARPS = 4
NUM_STAGES = 2


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_tile(tile: int, n: int) -> int:
    """Largest power-of-two tile <= ``tile`` that does not exceed n's next
    power of two (never below 16 — Triton's smallest useful block)."""
    t = max(16, min(tile, pl.next_power_of_2(max(n, 1))))
    assert t & (t - 1) == 0, f"tile {tile} must be a power of two"
    return t


def pack_bodies(pos, mass, rows: int) -> jax.Array:
    """(N, 3) positions + (N,) masses -> (rows, 4) float32 ``[x, y, z, m]``,
    zero-padded (zero mass: no force, no energy)."""
    n = pos.shape[0]
    body = jnp.concatenate(
        [jnp.asarray(pos, jnp.float32),
         jnp.asarray(mass, jnp.float32)[:, None]], axis=1)
    return jnp.pad(body, ((0, rows - n), (0, 0)))


def _load_cols(ref, rows, n_cols):
    """Column vectors of a row-major ref's rows (strided loads, no
    in-register slicing — which the Triton route cannot lower)."""
    return [ref[rows, c] for c in range(n_cols)]


def _compiler_params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES)


def _force_kernel(tile_j, scal_ref, tgt_ref, src_ref, ax_ref, ay_ref, az_ref):
    """Accelerations of one receiver tile from every source row.

    scal_ref: (2,) [g_const, softening^2]
    tgt_ref:  (TI, 4) receiver rows (mass column unused)
    src_ref:  (NJ, 4) all source rows, NJ a multiple of ``tile_j``
    a*_ref:   (TI,) acceleration components
    """
    g = scal_ref[0]
    eps2 = scal_ref[1]
    ti = tgt_ref.shape[0]
    xi, yi, zi = (c[:, None] for c in _load_cols(tgt_ref, slice(None), 3))

    def body(j, carry):
        ax, ay, az = carry
        rows = pl.ds(pl.multiple_of(j * tile_j, tile_j), tile_j)
        xj, yj, zj, mj = (c[None, :] for c in _load_cols(src_ref, rows, 4))
        dx = xj - xi  # (TI, TJ) = r_j - r_i, matching simulation.py:80
        dy = yj - yi
        dz = zj - zi
        d2 = dx * dx + dy * dy + dz * dz + eps2
        inv = jax.lax.rsqrt(jnp.maximum(d2, _D2_FLOOR))
        w = mj * (inv * inv * inv)
        return ax + w * dx, ay + w * dy, az + w * dz

    # (TI, TJ) accumulators, reduced across the tile once at the end: a
    # per-iteration row sum costs cross-thread shuffles on every source tile
    zero = jnp.zeros((ti, tile_j), jnp.float32)
    ax, ay, az = jax.lax.fori_loop(
        0, src_ref.shape[0] // tile_j, body, (zero, zero, zero))
    ax_ref[...] = g * jnp.sum(ax, axis=1)
    ay_ref[...] = g * jnp.sum(ay, axis=1)
    az_ref[...] = g * jnp.sum(az, axis=1)


def _energy_kernel(masked, tile_j, eps_ref, tgt_ref, src_ref, u_ref):
    """Per-receiver potential sum ``sum_j m_j / (d_ij + eps)`` (reference
    softening: eps added to the distance, simulation.py:104-113). With
    ``masked`` the global self-pair (same row in one shared array) is
    excluded; unmasked, every (i, j) pair counts — the cross-set form."""
    eps = eps_ref[0]
    ti = tgt_ref.shape[0]
    xi, yi, zi = (c[:, None] for c in _load_cols(tgt_ref, slice(None), 3))
    row = pl.program_id(0) * ti + jax.lax.broadcasted_iota(
        jnp.int32, (ti, tile_j), 0)

    def body(j, acc):
        start = pl.multiple_of(j * tile_j, tile_j)
        xj, yj, zj, mj = (
            c[None, :] for c in _load_cols(src_ref, pl.ds(start, tile_j), 4))
        dx = xj - xi
        dy = yj - yi
        dz = zj - zi
        # floor avoids 0/0 for coincident zero-mass padding when eps == 0
        dist = jnp.maximum(jnp.sqrt(dx * dx + dy * dy + dz * dz) + eps, 1e-30)
        pair = mj / dist
        if masked:
            col = start + jax.lax.broadcasted_iota(jnp.int32, (ti, tile_j), 1)
            pair = jnp.where(row == col, 0.0, pair)
        return acc + pair

    acc = jax.lax.fori_loop(0, src_ref.shape[0] // tile_j, body,
                            jnp.zeros((ti, tile_j), jnp.float32))
    u_ref[...] = jnp.sum(acc, axis=1)


def _pair_call(kernel, n_out, tgt, src, scal, ti, tj, interpret, name):
    """Launch ``kernel`` over receiver tiles: one program per ``ti`` rows of
    ``tgt``, the whole ``src`` visible to every program."""
    ni_pad, nj_pad = tgt.shape[0], src.shape[0]
    out = pl.pallas_call(
        partial(kernel, tj),
        grid=(ni_pad // ti,),
        in_specs=[
            pl.BlockSpec(scal.shape, lambda i: (0,)),
            pl.BlockSpec((ti, 4), lambda i: (i, 0)),
            pl.BlockSpec((nj_pad, 4), lambda i: (0, 0)),
        ],
        out_specs=[pl.BlockSpec((ti,), lambda i: (i,))] * n_out,
        out_shape=[jax.ShapeDtypeStruct((ni_pad,), jnp.float32)] * n_out,
        compiler_params=_compiler_params(),
        backend="triton",
        interpret=interpret,
        name=name,
    )(scal, tgt, src)
    return out


@partial(jax.jit, static_argnames=("tile_i", "tile_j", "interpret"))
def pallas_partial_accelerations(
    pos_i: jax.Array,
    pos_j: jax.Array,
    mass_j: jax.Array,
    g_const,
    softening,
    diag_delta=None,
    tile_i: int = TILE_I,
    tile_j: int = TILE_J,
    interpret: bool = False,
) -> jax.Array:
    """Accelerations exerted on targets ``pos_i`` (Ni, 3) by sources
    ``(pos_j, mass_j)``. A coincident self-pair contributes an exact zero
    (w * dx == 0 — see the module docstring), so no diagonal mask exists.
    Any sizes: both sets are zero-padded to whole tiles here.

    :param diag_delta: DEPRECATED, ignored. The kernel has no diagonal
        mask, so this parameter cannot exclude a pair whose displacement is
        nonzero — passing any value warns.
    :return: (Ni, 3) float32.
    """
    if diag_delta is not None:
        import warnings

        warnings.warn(
            "pallas_partial_accelerations(diag_delta=...) is deprecated "
            "and IGNORED: the force kernel has no diagonal mask (a "
            "coincident self-pair cancels to exact zero) and cannot "
            "exclude a non-coincident pair.",
            DeprecationWarning,
            stacklevel=2,
        )
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    ti = _pow2_tile(tile_i, ni)
    tj = _pow2_tile(tile_j, nj)
    tgt = pack_bodies(pos_i, jnp.zeros((ni,), jnp.float32), _round_up(ni, ti))
    src = pack_bodies(pos_j, mass_j, _round_up(nj, tj))
    scal = jnp.stack([jnp.asarray(g_const, jnp.float32),
                      jnp.asarray(softening, jnp.float32) ** 2])
    ax, ay, az = _pair_call(_force_kernel, 3, tgt, src, scal, ti, tj,
                            interpret, "pairwise_force")
    return jnp.stack([ax, ay, az], axis=1)[:ni]


@partial(jax.jit, static_argnames=("tile_i", "tile_j", "interpret"))
def pallas_accelerations(
    pos: jax.Array,
    mass: jax.Array,
    g_const,
    softening,
    mask: Optional[jax.Array] = None,
    tile_i: int = TILE_I,
    tile_j: int = TILE_J,
    interpret: bool = False,
) -> jax.Array:
    """Softened direct-sum accelerations via the tiled kernel.

    Numerically equivalent to ``nbody_sim.core.forces.pairwise_accelerations``
    (tested against it); O(N^2) compute with O(N) memory.

    :param pos: (N, 3) float32 positions.
    :param mass: (N,) float32 masses.
    :param mask: optional (N,) validity mask — folded into the masses, so
        padded slots exert no force; their output rows are zeroed.
    :return: (N, 3) float32 accelerations.
    """
    mass = jnp.asarray(mass, jnp.float32)
    if mask is not None:
        mass = mass * mask.astype(jnp.float32)
    acc = pallas_partial_accelerations(
        pos, pos, mass, g_const, softening, tile_i=tile_i, tile_j=tile_j,
        interpret=interpret)
    if mask is not None:
        acc = acc * mask[:, None].astype(acc.dtype)
    return acc


def _potential_sum(pos_i, mass_i, pos_j, mass_j, softening, masked, tile_i,
                   tile_j, interpret):
    """sum_i m_i sum_j m_j / (d_ij + eps) over the kernel's per-receiver
    partials (self-pairs excluded when ``masked``)."""
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    ti, tj = _pow2_tile(tile_i, ni), _pow2_tile(tile_j, nj)
    tgt = pack_bodies(pos_i, mass_i, _round_up(ni, ti))
    src = pack_bodies(pos_j, mass_j, _round_up(nj, tj))
    eps = jnp.asarray(softening, jnp.float32)[None]
    (u,) = _pair_call(partial(_energy_kernel, masked), 1, tgt, src,
                      eps, ti, tj, interpret, "pairwise_potential")
    return jnp.sum(tgt[:, 3] * u)


@partial(jax.jit, static_argnames=("tile_i", "tile_j", "interpret"))
def pallas_potential_energy(
    pos: jax.Array,
    mass: jax.Array,
    g_const,
    softening,
    mask: Optional[jax.Array] = None,
    tile_i: int = TILE_I,
    tile_j: int = TILE_J,
    interpret: bool = False,
) -> jax.Array:
    """Total pairwise PE via the tiled kernel — numerically equivalent to
    ``core.forces.potential_energy`` with O(N) memory.
    U = -G/2 sum_{i != j} m_i m_j / (d_ij + eps)."""
    mass = jnp.asarray(mass, jnp.float32)
    if mask is not None:
        mass = mass * mask.astype(jnp.float32)  # zero-mass slots: no pairs
    s = _potential_sum(pos, mass, pos, mass, softening, True, tile_i, tile_j,
                       interpret)
    return -0.5 * jnp.asarray(g_const, jnp.float32) * s


@partial(jax.jit, static_argnames=("tile_i", "tile_j", "interpret"))
def pallas_cross_potential(
    pos_i: jax.Array,
    mass_i: jax.Array,
    pos_j: jax.Array,
    mass_j: jax.Array,
    g_const,
    softening,
    tile_i: int = TILE_I,
    tile_j: int = TILE_J,
    interpret: bool = False,
) -> jax.Array:
    """PE of every (i, j) pair between two DISJOINT particle sets,
    U = -G sum_{i in I, j in J} m_i m_j / (d_ij + eps) — the rectangular,
    unmasked twin of :func:`pallas_potential_energy`.

    Exists for chunked exact-energy audits at scales where one triangular
    evaluation is too long a single device execution: split the particles
    into C chunks, sum ``pallas_potential_energy`` over the C diagonal chunks
    plus this kernel over the C(C-1)/2 unordered chunk pairs. The sets MUST
    be disjoint (a shared particle would self-pair at distance 0,
    contributing -G m^2/eps).
    """
    s = _potential_sum(pos_i, mass_i, pos_j, mass_j, softening, False,
                       tile_i, tile_j, interpret)
    return -jnp.asarray(g_const, jnp.float32) * s


def chunked_potential_energy(pos, mass, g_const, softening, chunk: int,
                             interpret: bool = False) -> float:
    """Exact total pairwise PE as a float, computed in C diagonal +
    C(C-1)/2 cross kernel launches of ~``chunk`` rows each (block-triangle
    decomposition; see :func:`pallas_cross_potential`). Host-side f64
    accumulation of the per-launch f32 partials."""
    n = pos.shape[0]
    nc = -(-n // chunk)
    bounds = [(k * chunk, min((k + 1) * chunk, n)) for k in range(nc)]
    total = 0.0
    for a, (lo, hi) in enumerate(bounds):
        total += float(pallas_potential_energy(
            pos[lo:hi], mass[lo:hi], g_const, softening,
            interpret=interpret))
        for lo2, hi2 in bounds[a + 1:]:
            total += float(pallas_cross_potential(
                pos[lo:hi], mass[lo:hi], pos[lo2:hi2], mass[lo2:hi2],
                g_const, softening, interpret=interpret))
    return total
