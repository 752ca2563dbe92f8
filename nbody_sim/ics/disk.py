"""Disk-galaxy initial conditions (reference ``src/galaxify/galaxies.py:54-192``),
rebuilt as a jit/vmap-able ``jax.random``-keyed generator.

Distributional parity with the reference (different RNG stream, same
distributions): exponential radial sampling, rim-tapered heights, Hernquist
mass weights, enclosed-mass circular velocities. The reference's O(N^2)
Python loop for enclosed mass (``galaxies.py:143-152``) becomes a
sort + prefix-sum + searchsorted — O(N log N), exact under distance ties.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def euler_rotation_matrix(angle) -> jax.Array:
    """Composed rotation ``R = Rz @ Ry @ Rx`` applied as ``x @ R.T`` —
    identical to the reference's ``pos @ rx.T @ ry.T @ rz.T``
    (``galaxies.py:159-185``)."""
    ax, ay, az = angle[0], angle[1], angle[2]
    cx, sx = jnp.cos(ax), jnp.sin(ax)
    cy, sy = jnp.cos(ay), jnp.sin(ay)
    cz, sz = jnp.cos(az), jnp.sin(az)
    rx = jnp.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], jnp.float32)
    ry = jnp.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], jnp.float32)
    rz = jnp.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], jnp.float32)
    return rz @ ry @ rx


def enclosed_mass(distances: jax.Array, masses: jax.Array) -> jax.Array:
    """m_enc[i] = sum of masses at strictly smaller radius (exact under ties),
    replacing the reference's per-body loop (``galaxies.py:146``)."""
    order = jnp.argsort(distances)
    d_sorted = distances[order]
    m_sorted = masses[order]
    csum = jnp.cumsum(m_sorted)
    # index of the first element with d_sorted >= d  == count of strictly smaller
    idx = jnp.searchsorted(d_sorted, distances, side="left")
    return jnp.where(idx > 0, csum[jnp.maximum(idx - 1, 0)], 0.0)


@partial(
    jax.jit,
    static_argnames=("n_bodies", "clockwise"),
)
def generate_disk(
    key: jax.Array,
    n_bodies: int,
    total_mass: float = 1.0,
    radial_scale: float = 3.0,
    height_scale: float = 0.3,
    g_const: float = 4.5e-6,
    black_hole_mass: float = 0.01,
    offset=(0.0, 0.0, 0.0),
    initial_vel=(0.0, 0.0, 0.0),
    clockwise: bool = True,
    angle=(0.0, 0.0, 0.0),
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Disk galaxy with a central black hole (reference ``generate_disk``).

    Body 0 is the black hole (mass fraction ``black_hole_mass`` of
    ``total_mass``) at the origin; stars get exponential radii, rim-tapered
    heights, Hernquist-weighted masses and circular orbital velocities from
    the enclosed mass.

    :param key: jax PRNG key (replaces ``np.random.seed``, ``galaxies.py:89``).
    :return: (positions (N,3), velocities (N,3), masses (N,)) float32.
    """
    from nbody_sim.ics.profiles import spherical_hernquist_distribution

    k_r, k_z, k_phi = jax.random.split(key, 3)
    f32eps = np.finfo(np.float32).eps
    is_star = jnp.arange(n_bodies) != 0  # body 0 = black hole (galaxies.py:92-93)

    # Exponential radial sampling: -R_d * log(1 - U) (galaxies.py:99-101)
    u = jax.random.uniform(k_r, (n_bodies,), jnp.float32, f32eps, 1.0)
    distances = -radial_scale * jnp.log(1.0 - u)
    distances = jnp.where(is_star, distances, 0.0)

    # Height tapering toward the rim (galaxies.py:106-110); the reference
    # keeps the (possibly negative) 1 - sqrt(d) factor as-is — so do we.
    zs = (
        jax.random.uniform(k_z, (n_bodies,), jnp.float32, -1.0, 1.0)
        * height_scale
        * (1.0 - jnp.sqrt(distances))
    )
    zs = jnp.where(is_star, zs, 0.0)

    phi = jax.random.uniform(k_phi, (n_bodies,), jnp.float32, 0.0, 2 * jnp.pi)
    positions = jnp.stack(
        [jnp.cos(phi) * distances, jnp.sin(phi) * distances, zs], axis=1
    )

    # Masses: BH fraction + Hernquist-weighted stars normalised to the
    # remainder (galaxies.py:124-137).
    mass_bh = total_mass * black_hole_mass
    star_weights = spherical_hernquist_distribution(
        r=jnp.where(is_star, distances, 1.0), r0=1.0, total_mass=total_mass
    )
    star_weights = jnp.where(is_star, star_weights, 0.0)
    masses = star_weights * ((total_mass - mass_bh) / jnp.sum(star_weights))
    masses = jnp.where(is_star, masses, mass_bh)

    # Circular velocities from enclosed mass (galaxies.py:142-152).
    m_enc = enclosed_mass(distances, masses)
    v = jnp.sqrt(g_const * m_enc / jnp.where(is_star, distances, 1.0))
    v = jnp.where(is_star, v, 0.0)
    velocities = jnp.stack(
        [
            v * jnp.cos(phi + jnp.pi / 2),
            v * jnp.sin(phi + jnp.pi / 2),
            jnp.zeros_like(v),
        ],
        axis=1,
    )
    if clockwise:  # galaxies.py:154-157
        velocities = velocities * jnp.array([-1.0, -1.0, 1.0], jnp.float32)

    rot = euler_rotation_matrix(jnp.asarray(angle, jnp.float32))
    positions = positions @ rot.T
    velocities = velocities @ rot.T

    positions = positions + jnp.asarray(offset, jnp.float32)
    velocities = velocities + jnp.asarray(initial_vel, jnp.float32)
    return positions, velocities, masses
