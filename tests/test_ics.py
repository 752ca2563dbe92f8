"""Initial-condition generators vs the reference's distributions
(``/root/reference/src/galaxify/galaxies.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_sim.ics import generate_disk, generate_spiral
from nbody_sim.ics.disk import enclosed_mass
from nbody_sim.ics.profiles import spherical_hernquist_distribution

G = 4.5e-6


def test_hernquist_profile_values():
    r = np.array([0.5, 1.0, 2.0])
    got = np.asarray(spherical_hernquist_distribution(r, r0=1.0, total_mass=1.0))
    want = (1.0 / (2 * np.pi)) * (1.0 / (r * (1.0 + r) ** 3))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # zero-radius guard (galaxies.py:44-45)
    at_zero = float(spherical_hernquist_distribution(np.array([0.0]))[0])
    assert np.isfinite(at_zero) and at_zero > 0


def test_enclosed_mass_matches_loop():
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 5, 64).astype(np.float32)
    d[5] = d[9]  # tie
    m = rng.uniform(0.1, 1, 64).astype(np.float32)
    got = np.asarray(enclosed_mass(jnp.asarray(d), jnp.asarray(m)))
    want = np.array([m[d < d[i]].sum() for i in range(64)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gen", [generate_disk, generate_spiral])
def test_generator_invariants(gen):
    key = jax.random.PRNGKey(0)
    n, total = 500, 1.0
    pos, vel, mass = gen(key, n, total_mass=total, black_hole_mass=0.01, g_const=G)
    assert pos.shape == (n, 3) and vel.shape == (n, 3) and mass.shape == (n,)
    # black hole: body 0 at origin, at rest, with the mass fraction
    np.testing.assert_allclose(np.asarray(pos[0]), 0.0, atol=1e-7)
    np.testing.assert_allclose(np.asarray(vel[0]), 0.0, atol=1e-7)
    assert abs(float(mass[0]) - 0.01 * total) < 1e-7
    # total mass (galaxies.py:130-137 / 238-242)
    assert abs(float(jnp.sum(mass)) - total) < 1e-5
    assert np.all(np.asarray(mass) > 0)


def test_disk_velocities_are_circular():
    """v = sqrt(G m_enc / r), tangential (galaxies.py:142-152), clockwise."""
    key = jax.random.PRNGKey(1)
    n = 200
    pos, vel, mass = generate_disk(
        key, n, total_mass=1.0, radial_scale=3.0, height_scale=0.3,
        g_const=G, black_hole_mass=0.01,
    )
    pos, vel, mass = map(np.asarray, (pos, vel, mass))
    r_xy = np.linalg.norm(pos[1:, :2], axis=1)
    speed = np.linalg.norm(vel[1:], axis=1)
    m_enc = np.array([mass[np.linalg.norm(pos[:, :2], axis=1) < r].sum() for r in r_xy])
    want = np.sqrt(G * m_enc / r_xy)
    np.testing.assert_allclose(speed, want, rtol=1e-3)
    # tangential: v . r_xy == 0
    dots = np.abs((vel[1:, :2] * pos[1:, :2]).sum(1))
    assert np.all(dots < 1e-6 + 1e-4 * speed * r_xy)
    # z-velocity exactly 0 for an unrotated disk
    np.testing.assert_allclose(vel[:, 2], 0.0, atol=1e-7)


def test_disk_rotation_and_offset():
    key = jax.random.PRNGKey(2)
    angle = (0.3, -0.2, 1.0)
    off = (5.0, -1.0, 2.0)
    ivel = (0.1, 0.2, -0.3)
    p0, v0, _ = generate_disk(key, 64, angle=(0, 0, 0))
    p1, v1, _ = generate_disk(key, 64, angle=angle, offset=off, initial_vel=ivel)
    # same key => same pre-rotation draws; verify R acts as pos @ Rx.T @ Ry.T @ Rz.T
    ax, ay, az = angle
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
    rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    want_p = np.asarray(p0) @ rx.T @ ry.T @ rz.T + np.array(off)
    want_v = np.asarray(v0) @ rx.T @ ry.T @ rz.T + np.array(ivel)
    np.testing.assert_allclose(np.asarray(p1), want_p, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v1), want_v, rtol=1e-4, atol=1e-5)


def test_spiral_velocity_magnitude_tracks_vcirc():
    key = jax.random.PRNGKey(3)
    n = 2000
    pos, vel, mass = generate_spiral(key, n, total_mass=1.0, radial_scale=3.0,
                                     height_scale=0.3, g_const=G, black_hole_mass=0.01)
    pos, vel = np.asarray(pos), np.asarray(vel)
    r = np.linalg.norm(pos[1:, :2], axis=1)
    m_enc = 1.0 * (1 - np.exp(-r / 3.0) * (1 + r / 3.0))
    v_circ = np.sqrt(G * m_enc / r)
    v_xy = np.linalg.norm(vel[1:, :2], axis=1)
    # dispersions are ~12% of v_circ; the mean ratio should be ~1
    ratio = v_xy / v_circ
    assert 0.95 < ratio.mean() < 1.05
    assert ratio.std() < 0.25


def test_disk_radial_distribution_is_exponential():
    key = jax.random.PRNGKey(4)
    rs = 2.0
    pos, _, _ = generate_disk(key, 5000, radial_scale=rs, black_hole_mass=0.01)
    r = np.linalg.norm(np.asarray(pos)[1:, :2], axis=1)
    # -Rd log(1-U) is Exp(Rd): mean ~ Rd
    assert abs(r.mean() - rs) < 0.1 * rs
