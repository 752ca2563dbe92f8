"""Integrator semantics and physics sanity (SURVEY.md §4: energy conservation
of leapfrog on a 2-body circular orbit with closed-form solution)."""

import jax.numpy as jnp
import numpy as np

from nbody_sim.core.forces import pairwise_accelerations
from nbody_sim.core.integrators import leapfrog_step, euler_step
from nbody_sim.core.simulate import SimulationConfig, simulate


def circular_two_body(g=1.0, m=1.0, r=1.0):
    """Two equal masses on a circular orbit about their barycentre.

    Separation d = 2r; a = G m / d^2 must equal v^2 / r  =>  v = sqrt(G m / (4 r)).
    """
    v = np.sqrt(g * m / (4 * r))
    pos = np.array([[r, 0, 0], [-r, 0, 0]], np.float32)
    vel = np.array([[0, v, 0], [0, -v, 0]], np.float32)
    mass = np.array([m, m], np.float32)
    return pos, vel, mass


def test_leapfrog_circular_orbit_radius_conserved():
    pos, vel, mass = circular_two_body()
    cfg = SimulationConfig(
        g_const=1.0, softening=0.0, dt=1e-3, integrator="leapfrog",
        calc_energy=True, force_backend="dense",
    )
    period = 2 * np.pi * 1.0 / vel[0, 1]
    steps = int(period / cfg.dt)
    traj = simulate(pos, vel, mass, steps, cfg)
    radii = np.linalg.norm(np.asarray(traj.positions)[:, 0, :], axis=-1)
    # symplectic leapfrog: bounded radius oscillation, no secular drift
    assert np.abs(radii - 1.0).max() < 1e-3
    # after one full period the body returns near its start
    end = np.asarray(traj.positions)[-1, 0]
    assert np.linalg.norm(end - pos[0]) < 5e-3


def test_leapfrog_energy_conservation():
    pos, vel, mass = circular_two_body()
    cfg = SimulationConfig(
        g_const=1.0, softening=0.0, dt=1e-3, integrator="leapfrog",
        calc_energy=True, force_backend="dense",
    )
    traj = simulate(pos, vel, mass, 2000, cfg)
    e = np.asarray(traj.u_energy) + np.asarray(traj.k_energy)
    assert np.abs(e - e[0]).max() < 1e-4 * abs(e[0])


def test_step_functions_match_reference_order():
    """One hand-rolled KDK / Euler step vs the step functions, verifying the
    exact reference update order (simulation.py:153-187)."""
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(5, 3)).astype(np.float32)
    vel = rng.normal(size=(5, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1, 5).astype(np.float32)
    g, eps, dt = 1.0, 0.1, 0.01
    acc_fn = lambda p: pairwise_accelerations(p, jnp.asarray(mass), g, eps)
    acc0 = np.asarray(acc_fn(jnp.asarray(pos)))

    # leapfrog KDK (simulation.py:163-170)
    v_half = vel + 0.5 * dt * acc0
    x1 = pos + dt * v_half
    a1 = np.asarray(acc_fn(jnp.asarray(x1)))
    v1 = v_half + 0.5 * dt * a1
    p_got, v_got, a_got = leapfrog_step(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(acc0), acc_fn, dt
    )
    np.testing.assert_allclose(np.asarray(p_got), x1, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(v_got), v1, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(a_got), a1, rtol=1e-6)

    # euler: v then x with *updated* v (simulation.py:182-187)
    a_e = acc0
    v_e = vel + dt * a_e
    x_e = pos + dt * v_e
    p_got, v_got, a_got = euler_step(
        jnp.asarray(pos), jnp.asarray(vel), jnp.zeros_like(jnp.asarray(acc0)), acc_fn, dt
    )
    np.testing.assert_allclose(np.asarray(p_got), x_e, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(v_got), v_e, rtol=1e-6)


def test_simulate_matches_python_loop():
    """lax.scan trajectory == explicit per-step python loop."""
    rng = np.random.default_rng(11)
    pos = rng.normal(size=(8, 3)).astype(np.float32)
    vel = rng.normal(size=(8, 3)).astype(np.float32) * 0.1
    mass = rng.uniform(0.5, 1, 8).astype(np.float32)
    cfg = SimulationConfig(
        g_const=4.5e-6, softening=0.05, dt=1e-3, integrator="leapfrog",
        calc_energy=False, force_backend="dense",
    )
    traj = simulate(pos, vel, mass, 5, cfg)

    acc_fn = lambda p: pairwise_accelerations(p, jnp.asarray(mass), cfg.g_const, cfg.softening)
    p, v = jnp.asarray(pos), jnp.asarray(vel)
    a = acc_fn(p)
    for s in range(5):
        p, v, a = leapfrog_step(p, v, a, acc_fn, cfg.dt)
        np.testing.assert_allclose(
            np.asarray(traj.positions[s]), np.asarray(p), rtol=2e-6, atol=1e-7
        )
