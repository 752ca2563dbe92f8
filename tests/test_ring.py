"""Multi-device ring all-pairs vs single-device dense, on the virtual
8-device CPU mesh (SURVEY.md §4: sharding testable without accelerators)."""

import jax
import jax.numpy as jnp
import numpy as np

from nbody_sim.core.forces import pairwise_accelerations, energies
from nbody_sim.core.simulate import SimulationConfig, simulate
from nbody_sim.parallel.ring import ring_accelerations, ring_energies, ring_simulate

G, EPS = 4.5e-6, 0.05


def _system(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 3
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    mass = rng.uniform(0.1, 1, n).astype(np.float32)
    return jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass)


def test_ring_acc_matches_dense(mesh8):
    pos, _, mass = _system(256)
    ring = np.asarray(ring_accelerations(pos, mass, G, EPS, mesh8))
    dense = np.asarray(pairwise_accelerations(pos, mass, G, EPS))
    scale = np.abs(dense).max()
    np.testing.assert_allclose(ring / scale, dense / scale, atol=1e-5)


def test_ring_energies_match_dense(mesh8):
    pos, vel, mass = _system(128, seed=1)
    u_r, k_r = ring_energies(pos, vel, mass, G, EPS, mesh8)
    u, k = energies(pos, vel, mass, G, EPS)
    assert abs(float(u_r) - float(u)) < 1e-6 * abs(float(u))
    assert abs(float(k_r) - float(k)) < 1e-6 * abs(float(k))


def test_ring_simulate_matches_dense_simulate(mesh8):
    pos, vel, mass = _system(64, seed=2)
    steps, dt = 20, 1e-3
    (p_r, v_r, a_r), _ = ring_simulate(
        pos, vel, mass, steps, G, EPS, dt, mesh8, integrator="leapfrog"
    )
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=dt,
                           integrator="leapfrog", calc_energy=False,
                           force_backend="dense")
    traj = simulate(pos, vel, mass, steps, cfg)
    np.testing.assert_allclose(
        np.asarray(p_r), np.asarray(traj.positions[-1]), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(v_r), np.asarray(traj.velocities[-1]), rtol=1e-4, atol=1e-6
    )


def test_ring_pallas_interpret_matches_dense(mesh8):
    """Cross-shard diag_delta logic of the Pallas kernel, via interpret mode
    on the CPU mesh."""
    pos, _, mass = _system(128, seed=5)
    ring_p = np.asarray(
        ring_accelerations(pos, mass, G, EPS, mesh8, backend="pallas",
                          interpret=True)
    )
    dense = np.asarray(pairwise_accelerations(pos, mass, G, EPS))
    scale = np.abs(dense).max()
    np.testing.assert_allclose(ring_p / scale, dense / scale, atol=2e-5)


def test_ring_simulate_full_trajectory(mesh8):
    pos, vel, mass = _system(64, seed=7)
    steps, dt = 8, 1e-3
    (ps, vs, accs), (us, ks) = ring_simulate(
        pos, vel, mass, steps, G, EPS, dt, mesh8,
        calc_energy=True, return_trajectory=True,
    )
    assert ps.shape == (steps, 64, 3) and us.shape == (steps,)
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=dt,
                           integrator="leapfrog", calc_energy=True,
                           force_backend="dense")
    traj = simulate(pos, vel, mass, steps, cfg)
    np.testing.assert_allclose(np.asarray(ps), np.asarray(traj.positions),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(us), np.asarray(traj.u_energy),
                               rtol=1e-5, atol=1e-12)
