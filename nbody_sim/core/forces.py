"""Direct-sum gravitational forces and energies (dense XLA reference path).

Physics semantics match the reference engine
(``/root/reference/src/galaxify/simulation.py:71-115``):

    a_i = G * sum_{j != i} m_j * (r_j - r_i) / (|r_j - r_i|^2 + eps^2)^(3/2)
    K   = sum_i 1/2 m_i |v_i|^2
    U   = -G * sum_{i<j} m_i m_j / (|r_i - r_j| + eps)

This module is the *dense* O(N^2) path used for tests and small N, plus
row-chunked versions of the same arithmetic (O(chunk * N) memory) that are
the plain XLA reference for the kernels at large N; the hot path for large N
is the tiled kernel in ``nbody_sim.ops.pairwise`` and the multi-device ring
in ``nbody_sim.parallel.ring`` — all agree numerically (see
tests/test_forces.py).

The contraction sum_j W_ij (r_j - r_i) is expressed as
``W @ pos - pos * rowsum(W)`` so XLA runs it as a matrix product instead of
reducing a materialised (N, N, 3) tensor.

All functions take an optional validity ``mask`` so padded particle slots
(static shapes) contribute nothing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _pairwise_d2(pos):
    """(N, N) squared distances via exact displacement differences.

    Exact subtraction (no |a|^2+|b|^2-2ab cancellation) to match the
    reference's broadcasted-diff numerics (``simulation.py:80-82``).
    """
    diff = pos[None, :, :] - pos[:, None, :]
    return jnp.sum(diff * diff, axis=-1)


def _interaction_weights(pos, mass, softening, mask=None):
    """(N, N) matrix W_ij = m_j / (|r_j - r_i|^2 + eps^2)^{3/2}, zero diagonal.

    Uses rsqrt^3 instead of pow(-1.5) (one special-function op).
    """
    n = pos.shape[0]
    d2 = _pairwise_d2(pos) + jnp.asarray(softening, pos.dtype) ** 2
    inv_d = jax.lax.rsqrt(d2)
    inv_d3 = inv_d * inv_d * inv_d
    eye = jnp.eye(n, dtype=bool)
    w = jnp.where(eye, 0.0, inv_d3) * mass[None, :]
    if mask is not None:
        w = w * mask[None, :].astype(w.dtype)
    return w


def pairwise_accelerations(pos, mass, g_const, softening, mask=None):
    """Softened direct-sum gravitational accelerations (reference
    ``simulation.py:71-89``), O(N^2), matrix-product contraction.

    :param pos: (N, 3) positions.
    :param mass: (N,) masses.
    :param mask: optional (N,) bool/0-1 validity for padded slots.
    :return: (N, 3) accelerations.
    """
    w = _interaction_weights(pos, mass, softening, mask)
    acc = jnp.asarray(g_const, pos.dtype) * (
        jnp.matmul(w, pos, precision=_HI)
        - pos * jnp.sum(w, axis=1, keepdims=True)
    )
    if mask is not None:
        acc = acc * mask[:, None].astype(acc.dtype)
    return acc


def _row_chunks(n, chunk):
    """(chunk, n_pad) for a row-chunked ``lax.map`` over n rows."""
    chunk = min(chunk, n)
    return chunk, -(-n // chunk) * chunk


def chunked_accelerations(pos, mass, g_const, softening, chunk=1024):
    """:func:`pairwise_accelerations` one (chunk, N) row block at a time
    under ``lax.map`` — the same arithmetic in O(chunk * N) memory, so it
    runs at sizes whose (N, N) matrices cannot exist (the plain XLA
    reference for the kernel at 1e5 bodies)."""
    n = pos.shape[0]
    chunk, n_pad = _row_chunks(n, chunk)
    pos_p = jnp.pad(pos, ((0, n_pad - n), (0, 0)))
    eps2 = jnp.asarray(softening, pos.dtype) ** 2
    cols = jnp.arange(n)

    def one(start):
        pi = jax.lax.dynamic_slice(pos_p, (start, 0), (chunk, 3))
        diff = pos[None, :, :] - pi[:, None, :]
        inv = jax.lax.rsqrt(jnp.sum(diff * diff, axis=-1) + eps2)
        self_pair = cols[None, :] == (start + jnp.arange(chunk))[:, None]
        w = jnp.where(self_pair, 0.0, inv * inv * inv) * mass[None, :]
        return jnp.asarray(g_const, pos.dtype) * (
            jnp.matmul(w, pos, precision=_HI)
            - pi * jnp.sum(w, axis=1, keepdims=True))

    starts = jnp.arange(n_pad // chunk) * chunk
    return jax.lax.map(one, starts).reshape(n_pad, 3)[:n]


def chunked_potential_energy(pos, mass, g_const, softening, chunk=1024,
                             pos_src=None, mass_src=None):
    """U = -G sum m_i m_j / (d_ij + eps) over (chunk, N) row blocks with
    exact displacement differences (no norm expansion, so close pairs keep
    their digits).

    Without ``pos_src`` each unordered pair of ``pos`` counts once (the
    reference's upper triangle); with ``pos_src``/``mass_src`` every pair
    (i in pos, j in pos_src) counts — the cross-set energy of two disjoint
    sets."""
    n = pos.shape[0]
    cross = pos_src is not None
    src, msrc = (pos_src, mass_src) if cross else (pos, mass)
    chunk, n_pad = _row_chunks(n, chunk)
    pos_p = jnp.pad(pos, ((0, n_pad - n), (0, 0)))
    mass_p = jnp.pad(mass, (0, n_pad - n))  # zero mass: no pairs
    eps = jnp.asarray(softening, pos.dtype)
    cols = jnp.arange(src.shape[0])

    def one(start):
        pi = jax.lax.dynamic_slice(pos_p, (start, 0), (chunk, 3))
        mi = jax.lax.dynamic_slice(mass_p, (start,), (chunk,))
        diff = src[None, :, :] - pi[:, None, :]
        dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1)) + eps
        pair = mi[:, None] * msrc[None, :] / dist
        if not cross:
            upper = cols[None, :] > (start + jnp.arange(chunk))[:, None]
            pair = jnp.where(upper, pair, 0.0)
        return jnp.sum(pair)

    starts = jnp.arange(n_pad // chunk) * chunk
    return -jnp.asarray(g_const, pos.dtype) * jnp.sum(
        jax.lax.map(one, starts))


def kinetic_energy(vel, mass, mask=None):
    """Total kinetic energy sum(1/2 m |v|^2) (reference ``simulation.py:100-101``)."""
    k = 0.5 * mass * jnp.sum(vel * vel, axis=-1)
    if mask is not None:
        k = k * mask.astype(k.dtype)
    return jnp.sum(k)


# Above this size the dense (N, N) energy matrix stops fitting; stream row
# chunks instead (exact, O(chunk * N) memory).
_ENERGY_CHUNK_THRESHOLD = 4096
_ENERGY_CHUNK = 1024


def potential_energy(pos, mass, g_const, softening, mask=None, chunk_size=None):
    """Total pairwise potential energy (reference ``simulation.py:104-113``):

        U = -G * sum_{i<j} m_i m_j / (|r_i - r_j| + eps)

    Note the reference softens PE by *adding eps to the distance* (not in
    quadrature); we reproduce that choice exactly. Large N automatically
    streams row chunks so the (N, N) pair matrix is never materialised.
    """
    n = pos.shape[0]
    if chunk_size is None:
        chunk_size = n if n <= _ENERGY_CHUNK_THRESHOLD else _ENERGY_CHUNK
    if chunk_size < n:
        if mask is not None:
            mass = mass * mask.astype(mass.dtype)  # zero mass: no pairs
        return chunked_potential_energy(pos, mass, g_const, softening,
                                        chunk_size)
    dist = jnp.sqrt(_pairwise_d2(pos)) + jnp.asarray(softening, pos.dtype)
    mm = mass[:, None] * mass[None, :]
    if mask is not None:
        m01 = mask.astype(pos.dtype)
        mm = mm * m01[:, None] * m01[None, :]
    # strict upper triangle == each unordered pair once (simulation.py:113)
    iu = jnp.triu(jnp.ones((n, n), dtype=bool), k=1)
    pair = jnp.where(iu, -mm / dist, 0.0)
    return jnp.asarray(g_const, pos.dtype) * jnp.sum(pair)


def energies(pos, vel, mass, g_const, softening, mask=None):
    """(U, K) tuple, matching ``BaseSimulator.compute_energies``."""
    return (
        potential_energy(pos, mass, g_const, softening, mask),
        kinetic_energy(vel, mass, mask),
    )
