"""Particle-sharded Barnes-Hut forces vs the single-device backend
(``parallel/bh.py``) on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_sim.ics import generate_spiral
from nbody_sim.ops.treeforce import bh_accelerations, build_bh_partition
from nbody_sim.parallel.bh import sharded_bh_accelerations

G, EPS = 4.5e-6, 0.05


def test_sharded_bh_matches_single_device(mesh8):
    pos, _, mass = generate_spiral(jax.random.PRNGKey(0), 2048)
    a1 = bh_accelerations(pos, mass, G, EPS, n_near=8, block=128,
                          near_impl="xla")
    a8 = sharded_bh_accelerations(pos, mass, G, EPS, mesh8,
                                  n_near=8, block=128, near_impl="xla")
    np.testing.assert_array_equal(np.asarray(a8), np.asarray(a1))


def test_sharded_bh_uneven_blocks(mesh8):
    """nb = 14 receiver blocks over 8 devices: the block-padding to 16 must
    not corrupt real rows. Padded far reductions (K=16 with two zero blocks
    vs K=14) reduce in a different order, so equality here is to rounding
    (measured max 2.3e-10 on ~1e-7 forces), not bitwise."""
    pos, _, mass = generate_spiral(jax.random.PRNGKey(1), 1792)
    a1 = bh_accelerations(pos, mass, G, EPS, n_near=6, block=128,
                          near_impl="xla")
    a8 = sharded_bh_accelerations(pos, mass, G, EPS, mesh8,
                                  n_near=6, block=128, near_impl="xla")
    np.testing.assert_allclose(np.asarray(a8), np.asarray(a1),
                               rtol=1e-4, atol=1e-9)


def test_sharded_bh_reused_partition(mesh8):
    pos, vel, mass = generate_spiral(jax.random.PRNGKey(2), 2048)
    part = build_bh_partition(pos, mass, n_near=8, block=128)
    drifted = pos + vel * 1e-3
    a1 = bh_accelerations(drifted, mass, G, EPS, partition=part,
                          near_impl="xla")
    a8 = sharded_bh_accelerations(drifted, mass, G, EPS, mesh8,
                                  partition=part, near_impl="xla")
    np.testing.assert_array_equal(np.asarray(a8), np.asarray(a1))


def test_sharded_bh_program_is_cached(mesh8):
    """Repeated calls must reuse the jitted shard_map program — rebuilding
    the closure per call retraces/recompiles every force evaluation."""
    from nbody_sim.parallel.bh import _sharded_fn

    pos, _, mass = generate_spiral(jax.random.PRNGKey(3), 2048)
    _sharded_fn.cache_clear()
    for _ in range(3):
        sharded_bh_accelerations(pos, mass, G, EPS, mesh8,
                                 n_near=8, block=128, near_impl="xla")
    info = _sharded_fn.cache_info()
    assert info.misses == 1 and info.hits == 2, info


def test_bh_simulate_matches_single_device(mesh8):
    """The scanned multi-device BH rollout tracks simulate's single-device
    bh path (same partition-refresh schedule; rounding-level equality from
    the per-device chunk padding)."""
    from nbody_sim.core.simulate import SimulationConfig, simulate
    from nbody_sim.parallel.bh import bh_simulate

    pos, vel, mass = generate_spiral(jax.random.PRNGKey(5), 2048)
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=1e-4,
                           integrator="leapfrog", calc_energy=False,
                           force_backend="bh", bh_near=8, bh_block=128,
                           bh_refresh=4)
    ref = simulate(pos, vel, mass, 10, cfg)
    p, v, a = bh_simulate(pos, vel, mass, 10, G, EPS, 1e-4, mesh8,
                          n_near=8, block=128, refresh=4, near_impl="xla")
    np.testing.assert_allclose(np.asarray(p), np.asarray(ref.positions[-1]),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(v), np.asarray(ref.velocities[-1]),
                               rtol=1e-5, atol=1e-8)


def test_sharded_bh2_matches_single_device(mesh8):
    """Two-level engine: coarse receiver groups sharded over 8 devices ==
    the single-device bh2 path. nbc = 16 groups / 8 devices: no padding,
    identical per-range arithmetic => exact equality."""
    from nbody_sim.ops.treeforce import bh2_accelerations
    from nbody_sim.parallel.bh import sharded_bh2_accelerations

    pos, _, mass = generate_spiral(jax.random.PRNGKey(7), 2048)
    kw = dict(n_near=6, block=64, coarse=4, rc=4, near_impl="xla")
    a1 = bh2_accelerations(pos, mass, G, EPS, **kw)
    a8 = sharded_bh2_accelerations(pos, mass, G, EPS, mesh8, **kw)
    np.testing.assert_array_equal(np.asarray(a8), np.asarray(a1))


def test_sharded_bh2_uneven_groups(mesh8):
    """nbc = 14 coarse groups over 8 devices: whole-group padding to 16
    must not corrupt real rows (padded groups are massless; far reductions
    tile differently => rounding-level equality, like the bh1 twin)."""
    from nbody_sim.ops.treeforce import bh2_accelerations
    from nbody_sim.parallel.bh import sharded_bh2_accelerations

    pos, _, mass = generate_spiral(jax.random.PRNGKey(8), 1792)
    kw = dict(n_near=6, block=64, coarse=4, rc=4, near_impl="xla")
    a1 = bh2_accelerations(pos, mass, G, EPS, **kw)
    a8 = sharded_bh2_accelerations(pos, mass, G, EPS, mesh8, **kw)
    np.testing.assert_allclose(np.asarray(a8), np.asarray(a1),
                               rtol=1e-4, atol=1e-9)


def test_sharded_bh2_reused_partition(mesh8):
    from nbody_sim.ops.treeforce import bh2_accelerations, build_bh2_partition
    from nbody_sim.parallel.bh import sharded_bh2_accelerations

    pos, _, mass = generate_spiral(jax.random.PRNGKey(9), 2048)
    part = build_bh2_partition(pos, mass, n_near=6, block=64, coarse=4, rc=4)
    a1 = bh2_accelerations(pos, mass, G, EPS, partition=part,
                           near_impl="xla")
    a8 = sharded_bh2_accelerations(pos, mass, G, EPS, mesh8, partition=part,
                                   rc=4, near_impl="xla")
    np.testing.assert_array_equal(np.asarray(a8), np.asarray(a1))


def test_bh2_simulate_matches_single_device(mesh8):
    """The scanned multi-device two-level rollout tracks simulate's
    single-device bh2 path (same refresh schedule; rounding-level equality
    from the per-device chunk padding, like the bh1 twin)."""
    from nbody_sim.core.simulate import SimulationConfig, simulate
    from nbody_sim.parallel.bh import bh2_simulate

    pos, vel, mass = generate_spiral(jax.random.PRNGKey(10), 2048)
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=1e-4,
                           integrator="leapfrog", calc_energy=False,
                           force_backend="bh2", bh_near=8, bh_block=64,
                           bh_coarse=4, bh_rc=4, bh_refresh=4)
    ref = simulate(pos, vel, mass, 10, cfg)
    p, v, a = bh2_simulate(pos, vel, mass, 10, G, EPS, 1e-4, mesh8,
                           n_near=8, block=64, coarse=4, rc=4, refresh=4,
                           near_impl="xla")
    np.testing.assert_allclose(np.asarray(p), np.asarray(ref.positions[-1]),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(v), np.asarray(ref.velocities[-1]),
                               rtol=1e-5, atol=1e-8)


def test_sharded_bh3_matches_single_device(mesh8):
    """Sub-refined engine: coarse receiver groups sharded over 8 devices ==
    the single-device bh3 path (no group padding => exact equality)."""
    from nbody_sim.ops.treeforce import bh3_accelerations
    from nbody_sim.parallel.bh import sharded_bh3_accelerations

    pos, _, mass = generate_spiral(jax.random.PRNGKey(11), 2048)
    kw = dict(n_near=6, block=64, coarse=4, rc=4, sub_block=16, n_sub=12,
              near_impl="xla")
    a1 = bh3_accelerations(pos, mass, G, EPS, **kw)
    a8 = sharded_bh3_accelerations(pos, mass, G, EPS, mesh8, **kw)
    np.testing.assert_array_equal(np.asarray(a8), np.asarray(a1))


def test_sharded_bh3_reused_partition(mesh8):
    """With a prebuilt partition every selection knob derives from its
    shapes — caller values must neither matter nor recompile."""
    from nbody_sim.ops.treeforce import bh3_accelerations, build_bh3_partition
    from nbody_sim.parallel.bh import sharded_bh3_accelerations

    pos, _, mass = generate_spiral(jax.random.PRNGKey(12), 2048)
    part = build_bh3_partition(pos, mass, n_near=6, block=64, coarse=4,
                               rc=4, sub_block=16, n_sub=12)
    a1 = bh3_accelerations(pos, mass, G, EPS, partition=part,
                           near_impl="xla")
    a8 = sharded_bh3_accelerations(pos, mass, G, EPS, mesh8, partition=part,
                                   rc=99, n_sub=99, near_impl="xla")
    np.testing.assert_array_equal(np.asarray(a8), np.asarray(a1))


def test_bh3_simulate_matches_single_device(mesh8):
    """The scanned multi-device sub-refined rollout tracks simulate's
    single-device bh3 path (same refresh schedule)."""
    from nbody_sim.core.simulate import SimulationConfig, simulate
    from nbody_sim.parallel.bh import bh3_simulate

    pos, vel, mass = generate_spiral(jax.random.PRNGKey(13), 2048)
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=1e-4,
                           integrator="leapfrog", calc_energy=False,
                           force_backend="bh3", bh_near=8, bh_block=64,
                           bh_coarse=4, bh_rc=4, bh_sub_block=16,
                           bh_n_sub=16, bh_refresh=4)
    ref = simulate(pos, vel, mass, 10, cfg)
    p, v, a = bh3_simulate(pos, vel, mass, 10, G, EPS, 1e-4, mesh8,
                           n_near=8, block=64, coarse=4, rc=4, sub_block=16,
                           n_sub=16, refresh=4, near_impl="xla")
    np.testing.assert_allclose(np.asarray(p), np.asarray(ref.positions[-1]),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(v), np.asarray(ref.velocities[-1]),
                               rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("engine", ["bh2", "bh3"])
def test_sharded_fresh_partition_unaligned_superblocks(mesh8, engine):
    """N / block not a multiple of the coarse factor: the partition pads to
    whole superblocks, so the gathered sorted result is longer than the
    blocks N alone implies; the unsort must use the partition's slots."""
    from nbody_sim.ops import treeforce
    from nbody_sim.parallel import bh

    pos, _, mass = generate_spiral(jax.random.PRNGKey(14), 64 * 18)
    kw = dict(n_near=6, block=64, coarse=4, rc=4, near_impl="xla")
    if engine == "bh3":
        kw.update(sub_block=16, n_sub=12)
    one = getattr(treeforce, f"{engine}_accelerations")(pos, mass, G, EPS,
                                                         **kw)
    sharded = getattr(bh, f"sharded_{engine}_accelerations")(
        pos, mass, G, EPS, mesh8, **kw)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(one),
                               rtol=1e-5, atol=1e-9)
