"""Block-monopole (Barnes-Hut-lite) forces vs the exact direct sum
(``ops/treeforce.py``; exact anchor: reference ``simulation.py:80-88``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_sim.core.forces import pairwise_accelerations
from nbody_sim.ics import generate_disk, generate_spiral
from nbody_sim.ops.treeforce import BHPartition, bh_accelerations, build_bh_partition

G, EPS = 4.5e-6, 0.05


def _rel_err(approx, exact):
    num = jnp.linalg.norm(approx - exact, axis=-1)
    den = jnp.linalg.norm(exact, axis=-1) + 1e-30
    return float(jnp.median(num / den)), float(jnp.mean(num / den))


@pytest.mark.parametrize("gen,med_tol,mean_tol", [
    (generate_spiral, 1e-2, 5e-2),   # measured: med 3.6e-3, mean 1.8e-2
    (generate_disk, 5e-4, 5e-3),     # measured: med 3.1e-5, mean 9.0e-5
])
def test_bh_close_to_exact_on_galaxies(gen, med_tol, mean_tol):
    pos, _, mass = gen(jax.random.PRNGKey(0), 3000)
    exact = pairwise_accelerations(pos, mass, G, EPS)
    approx = bh_accelerations(pos, mass, G, EPS, n_near=16, block=128)
    med, mean = _rel_err(approx, exact)
    assert med < med_tol, med
    assert mean < mean_tol, mean


def test_bh_error_decreases_with_n_near():
    pos, _, mass = generate_spiral(jax.random.PRNGKey(1), 2000)
    exact = pairwise_accelerations(pos, mass, G, EPS)
    errs = []
    for m in (9, 12, 16):
        approx = bh_accelerations(pos, mass, G, EPS, n_near=m, block=128)
        errs.append(_rel_err(approx, exact)[1])
    assert errs[0] > errs[1] > errs[2], errs


def test_bh_exact_when_all_blocks_near():
    """M >= nb makes the far set empty: the result IS the direct sum."""
    pos, _, mass = generate_disk(jax.random.PRNGKey(2), 700)
    exact = pairwise_accelerations(pos, mass, G, EPS)
    approx = bh_accelerations(pos, mass, G, EPS, n_near=64, block=128)
    np.testing.assert_allclose(
        np.asarray(approx), np.asarray(exact), rtol=2e-3, atol=1e-12
    )


def test_bh_stale_partition_still_accurate():
    """A partition built from slightly drifted positions (the graph_refresh
    pattern) stays accurate: assignment is stale, physics is fresh."""
    key = jax.random.PRNGKey(3)
    pos, vel, mass = generate_spiral(key, 2000)
    part = build_bh_partition(pos, mass, n_near=12, block=128)
    drifted = pos + vel * 1e-2  # many dt of drift
    exact = pairwise_accelerations(drifted, mass, G, EPS)
    approx = bh_accelerations(drifted, mass, G, EPS, partition=part)
    med, mean = _rel_err(approx, exact)
    assert med < 1e-2, med
    assert mean < 8e-2, mean


def test_bh_partition_shapes_and_padding():
    pos, _, mass = generate_spiral(jax.random.PRNGKey(4), 1000)  # 1000 % 128 != 0
    part = build_bh_partition(pos, mass, n_near=4, block=128)
    nb = -(-1000 // 128)
    assert part.near.shape == (nb, 4)
    assert part.sorted_gid.shape == (nb * 128,)
    gid = np.asarray(part.sorted_gid)
    # every real row appears exactly once; pads carry n
    assert sorted(gid[gid < 1000].tolist()) == list(range(1000))
    assert (gid >= 1000).sum() == nb * 128 - 1000
    # self block always in the near set
    near = np.asarray(part.near)
    assert all(i in near[i] for i in range(nb))


def test_bh_jit_and_grad_safe():
    """Usable inside scan/jit pipelines (static n_near/block args only)."""
    pos, _, mass = generate_spiral(jax.random.PRNGKey(5), 512)

    @jax.jit
    def f(p):
        return jnp.sum(bh_accelerations(p, mass, G, EPS, n_near=4, block=128) ** 2)

    v1 = f(pos)
    assert np.isfinite(float(v1))
    # gradient path: payload sorts + floored rsqrt must differentiate finite
    g = jax.jit(jax.grad(f))(pos)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.sum(g * g)) > 0.0


def test_simulate_bh_backend_tracks_exact():
    """A short leapfrog rollout under force_backend='bh' (with partition
    refresh) stays close to the exact dense rollout and keeps total energy
    drift at leapfrog levels (energies are computed exactly)."""
    from nbody_sim.core.simulate import SimulationConfig, simulate

    pos, vel, mass = generate_disk(jax.random.PRNGKey(6), 1500)
    base = dict(g_const=G, softening=EPS, dt=1e-4, integrator="leapfrog",
                calc_energy=True)
    t_ex = simulate(pos, vel, mass, 50,
                    SimulationConfig(force_backend="dense", **base))
    t_bh = simulate(pos, vel, mass, 50,
                    SimulationConfig(force_backend="bh", bh_near=12,
                                     bh_block=128, bh_refresh=8, **base))
    d = np.linalg.norm(
        np.asarray(t_bh.positions[-1]) - np.asarray(t_ex.positions[-1]),
        axis=-1)
    scale = float(np.linalg.norm(np.asarray(t_ex.positions[-1]), axis=-1).mean())
    assert np.max(d) / scale < 1e-4, np.max(d) / scale

    e = np.asarray(t_bh.u_energy) + np.asarray(t_bh.k_energy)
    assert np.abs(e - e[0]).max() < 1e-3 * abs(e[0])


def test_bh_near_impl_pallas_matches_xla():
    """The Pallas near-pass backend (interpret mode on CPU) computes the
    same forces as the XLA norm-expansion path."""
    pos, _, mass = generate_spiral(jax.random.PRNGKey(7), 1200)
    part = build_bh_partition(pos, mass, n_near=8, block=128)
    a_x = bh_accelerations(pos, mass, G, EPS, partition=part, i_chunk=2,
                           near_impl="xla")
    a_p = bh_accelerations(pos, mass, G, EPS, partition=part, i_chunk=2,
                           near_impl="pallas", interpret=True)
    # the two paths differ by d^2 rounding only: the XLA path's norm
    # expansion carries ~1e-6 absolute cancellation error in d^2, the
    # kernel's direct differences do not — so compare at that level
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_x),
                               rtol=2e-3, atol=5e-9)


def test_bh_finite_at_zero_softening():
    """Self-pairs rely on the zero displacement cancelling the (floored)
    kernel — at softening 0 every backend must stay finite (the d2 floor
    must not let rsqrt^3 overflow float32)."""
    pos, _, mass = generate_spiral(jax.random.PRNGKey(8), 1000)
    for impl in ("xla", "pallas"):
        a = bh_accelerations(pos, mass, G, 0.0, n_near=8, block=128,
                             near_impl=impl, interpret=impl == "pallas")
        assert bool(jnp.isfinite(a).all()), impl


# --- two-level (coarse) engine ---------------------------------------------


def test_bh2_close_to_exact_and_comparable_to_bh1():
    """Two-level error tiers stay in the same regime as the one-level
    engine at matched near budgets (the coarse residual is second-order)."""
    pos, _, mass = generate_spiral(jax.random.PRNGKey(10), 6000)
    from nbody_sim.ops.treeforce import bh2_accelerations

    exact = pairwise_accelerations(pos, mass, G, EPS)
    a1 = bh_accelerations(pos, mass, G, EPS, n_near=16, block=128)
    a2 = bh2_accelerations(pos, mass, G, EPS, n_near=16, block=128,
                           coarse=4, rc=8)
    med1, mean1 = _rel_err(a1, exact)
    med2, mean2 = _rel_err(a2, exact)
    assert med2 < 4 * med1 + 1e-3, (med1, med2)
    assert mean2 < 4 * mean1 + 1e-2, (mean1, mean2)


def test_bh2_full_refinement_telescopes_to_bh1():
    """rc = nbc refines every superblock: the coarse far field cancels and
    the result matches the one-level engine (up to f32 summation-order
    rounding through the near-multipole cancellation)."""
    from nbody_sim.ops.treeforce import bh2_accelerations

    pos, _, mass = generate_spiral(jax.random.PRNGKey(11), 4096)
    nb = -(-4096 // 128)
    nbc = -(-nb // 4)
    a1 = bh_accelerations(pos, mass, G, EPS, n_near=8, block=128)
    a2 = bh2_accelerations(pos, mass, G, EPS, n_near=8, block=128,
                           coarse=4, rc=nbc)
    num = jnp.linalg.norm(a2 - a1, axis=-1)
    den = jnp.linalg.norm(a1, axis=-1) + 1e-30
    assert float(jnp.median(num / den)) < 1e-4


def test_bh2_error_decreases_with_rc():
    from nbody_sim.ops.treeforce import bh2_accelerations

    pos, _, mass = generate_spiral(jax.random.PRNGKey(12), 4096)
    exact = pairwise_accelerations(pos, mass, G, EPS)
    errs = []
    for rc in (3, 5, 8):
        a = bh2_accelerations(pos, mass, G, EPS, n_near=8, block=128,
                              coarse=4, rc=rc)
        errs.append(_rel_err(a, exact)[1])
    assert errs[0] >= errs[1] >= errs[2], errs


def test_bh2_partition_consistency_and_reuse():
    """Near sets are restricted to refined parents (exact telescoping by
    construction); a stale partition stays usable."""
    from nbody_sim.ops.treeforce import bh2_accelerations, build_bh2_partition

    key = jax.random.PRNGKey(13)
    pos, vel, mass = generate_spiral(key, 4000)
    part = build_bh2_partition(pos, mass, n_near=8, block=128, coarse=4,
                               rc=6)
    near = np.asarray(part.near)
    refined = np.asarray(part.refined)
    nb = near.shape[0]
    assert nb % 4 == 0
    for i in range(nb):
        for j in near[i]:
            assert (j // 4) in refined[i // 4], (i, j)
    # self group always refined, self block always near
    assert all(a in refined[a] for a in range(refined.shape[0]))
    assert all(i in near[i] for i in range(nb))

    drifted = pos + vel * 1e-2
    exact = pairwise_accelerations(drifted, mass, G, EPS)
    approx = bh2_accelerations(drifted, mass, G, EPS, partition=part)
    med, mean = _rel_err(approx, exact)
    # loose budget on purpose (M=8, rc=6/8): one-level at M=8 measures
    # ~5e-2 med on this profile; this checks usability, not a tier
    assert med < 6e-2, med


def test_bh2_pallas_interpret_matches_xla():
    """The grouped Pallas multipole kernel (interpret) + Pallas near pass
    == the pure-XLA two-level path."""
    from nbody_sim.ops.treeforce import bh2_accelerations, build_bh2_partition

    pos, _, mass = generate_spiral(jax.random.PRNGKey(14), 2048)
    part = build_bh2_partition(pos, mass, n_near=8, block=128, coarse=4,
                               rc=4)
    a_x = bh2_accelerations(pos, mass, G, EPS, partition=part, i_chunk=2,
                            near_impl="xla")
    a_p = bh2_accelerations(pos, mass, G, EPS, partition=part, i_chunk=2,
                            near_impl="pallas", interpret=True)
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_x),
                               rtol=2e-3, atol=5e-9)


def test_bh2_jit_finite_and_zero_softening():
    from nbody_sim.ops.treeforce import bh2_accelerations

    pos, _, mass = generate_spiral(jax.random.PRNGKey(15), 2048)

    @jax.jit
    def f(p):
        return jnp.sum(
            bh2_accelerations(p, mass, G, EPS, n_near=8, block=128,
                              coarse=4, rc=4) ** 2)

    assert np.isfinite(float(f(pos)))
    a0 = bh2_accelerations(pos, mass, G, 0.0, n_near=8, block=128,
                           coarse=4, rc=4)
    assert bool(jnp.isfinite(a0).all())


def test_simulate_bh2_backend_tracks_exact():
    """force_backend='bh2' (two-level, with partition refresh) stays close
    to the dense rollout at a config where the far field is genuinely
    approximate (near covers 8/48 blocks, refined 6/12 superblocks)."""
    from nbody_sim.core.simulate import SimulationConfig, simulate

    pos, vel, mass = generate_disk(jax.random.PRNGKey(16), 3000)
    base = dict(g_const=G, softening=EPS, dt=1e-4, integrator="leapfrog",
                calc_energy=True)
    t_ex = simulate(pos, vel, mass, 50,
                    SimulationConfig(force_backend="dense", **base))
    t_bh = simulate(pos, vel, mass, 50,
                    SimulationConfig(force_backend="bh2", bh_near=8,
                                     bh_block=64, bh_coarse=4, bh_rc=6,
                                     bh_refresh=8, **base))
    d = np.linalg.norm(
        np.asarray(t_bh.positions[-1]) - np.asarray(t_ex.positions[-1]),
        axis=-1)
    scale = float(np.linalg.norm(np.asarray(t_ex.positions[-1]), axis=-1).mean())
    assert 0 < np.max(d) / scale < 1e-4, np.max(d) / scale

    e = np.asarray(t_bh.u_energy) + np.asarray(t_bh.k_energy)
    assert np.abs(e - e[0]).max() < 1e-3 * abs(e[0])


# --- sub-refined (Verlet-list) near pass ------------------------------------


def test_bh3_full_selection_matches_bh2():
    """n_sub = M*S selects every near sub-block for exact evaluation: the
    near pass evaluates the same rows as bh2's (the sub-mult bracket is
    empty), so the engines agree up to f32 summation-order rounding — the
    selection sort visits candidates in priority order, not near-set
    order, and the exact-minus-multipole near field amplifies the
    reordering residue relative to the (partially cancelled) total."""
    from nbody_sim.ops.treeforce import bh2_accelerations, bh3_accelerations

    pos, _, mass = generate_spiral(jax.random.PRNGKey(20), 6000)
    a2 = bh2_accelerations(pos, mass, G, EPS, n_near=16, block=128,
                           coarse=4, rc=8)
    a3 = bh3_accelerations(pos, mass, G, EPS, n_near=16, block=128,
                           coarse=4, rc=8, sub_block=32, n_sub=16 * 4)
    num = jnp.linalg.norm(a3 - a2, axis=-1)
    den = jnp.linalg.norm(a2, axis=-1) + 1e-30
    assert float(jnp.median(num / den)) < 5e-4  # measured 4.8e-5
    assert float(jnp.mean(num / den)) < 5e-3


def test_bh3_error_decreases_with_n_sub():
    from nbody_sim.ops.treeforce import bh3_accelerations

    pos, _, mass = generate_spiral(jax.random.PRNGKey(21), 6000)
    exact = pairwise_accelerations(pos, mass, G, EPS)
    errs = []
    for n_sub in (16, 24, 48):
        a = bh3_accelerations(pos, mass, G, EPS, n_near=16, block=128,
                              coarse=4, rc=8, sub_block=32, n_sub=n_sub)
        errs.append(_rel_err(a, exact)[1])
    assert errs[0] > errs[1] > errs[2], errs


def test_bh3_close_to_exact_on_galaxies():
    """At a production-shaped selection (K*Bs = 768 exact pairs vs bh2's
    M*B = 2048) the error stays in the bh2 tier on both profiles."""
    from nbody_sim.ops.treeforce import bh2_accelerations, bh3_accelerations

    for gen, key in ((generate_spiral, 22), (generate_disk, 23)):
        pos, _, mass = gen(jax.random.PRNGKey(key), 8000)
        exact = pairwise_accelerations(pos, mass, G, EPS)
        a2 = bh2_accelerations(pos, mass, G, EPS, n_near=16, block=128,
                               coarse=4, rc=8)
        a3 = bh3_accelerations(pos, mass, G, EPS, n_near=16, block=128,
                               coarse=4, rc=8, sub_block=32, n_sub=24)
        med2, mean2 = _rel_err(a2, exact)
        med3, mean3 = _rel_err(a3, exact)
        assert med3 < 3 * med2 + 1e-3, (gen.__name__, med2, med3)
        assert mean3 < 3 * mean2 + 1e-2, (gen.__name__, mean2, mean3)


def test_bh3_partition_invariants():
    """sub_near/sub_far partition the near sets' sub-blocks exactly; the
    receiver's own sub-blocks (and its +-1 curve-block window, when in the
    near set) are always selected exact."""
    from nbody_sim.ops.treeforce import build_bh3_partition

    pos, _, mass = generate_spiral(jax.random.PRNGKey(24), 5000)
    part = build_bh3_partition(pos, mass, n_near=8, block=128, coarse=4,
                               rc=6, sub_block=32, n_sub=16)
    near = np.asarray(part.near)
    sel = np.asarray(part.sub_near)
    far = np.asarray(part.sub_far)
    nb, m = near.shape
    s = (sel.shape[1] + far.shape[1]) // m
    assert s == 128 // 32
    for i in range(nb):
        cand = {j * s + k for j in near[i] for k in range(s)}
        both = sel[i].tolist() + far[i].tolist()
        assert sorted(both) == sorted(cand), i  # exact partition, no dups
        own = {i * s + k for k in range(s)}
        assert own <= set(sel[i].tolist()), i  # self subs always exact
    # sub ids point into near parents only
    assert set((sel // s).flatten()) <= set(near.flatten())


def test_bh3_stale_partition_and_jit_grad():
    from nbody_sim.ops.treeforce import bh3_accelerations, build_bh3_partition

    key = jax.random.PRNGKey(25)
    pos, vel, mass = generate_spiral(key, 4000)
    part = build_bh3_partition(pos, mass, n_near=8, block=128, coarse=4,
                               rc=6, sub_block=32, n_sub=16)
    drifted = pos + vel * 1e-2
    exact = pairwise_accelerations(drifted, mass, G, EPS)
    approx = bh3_accelerations(drifted, mass, G, EPS, partition=part)
    med, _ = _rel_err(approx, exact)
    # looser than bh2's stale test: n_sub=16 of 32 adds sub-mult near error
    assert med < 9e-2, med

    @jax.jit
    def f(p):
        return jnp.sum(
            bh3_accelerations(p, mass, G, EPS, n_near=8, block=128,
                              coarse=4, rc=6, sub_block=32, n_sub=16) ** 2)

    assert np.isfinite(float(f(pos)))
    g = jax.jit(jax.grad(f))(pos)
    assert np.isfinite(np.asarray(g)).all()


def test_bh3_pallas_interpret_matches_xla():
    from nbody_sim.ops.treeforce import bh3_accelerations, build_bh3_partition

    pos, _, mass = generate_spiral(jax.random.PRNGKey(26), 2048)
    part = build_bh3_partition(pos, mass, n_near=8, block=128, coarse=4,
                               rc=4, sub_block=32, n_sub=16)
    a_x = bh3_accelerations(pos, mass, G, EPS, partition=part, i_chunk=2,
                            near_impl="xla")
    a_p = bh3_accelerations(pos, mass, G, EPS, partition=part, i_chunk=2,
                            near_impl="pallas", interpret=True)
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_x),
                               rtol=2e-3, atol=2e-8)


def test_bh3_finite_at_zero_softening():
    from nbody_sim.ops.treeforce import bh3_accelerations

    pos, _, mass = generate_spiral(jax.random.PRNGKey(27), 2048)
    a0 = bh3_accelerations(pos, mass, G, 0.0, n_near=8, block=128,
                           coarse=4, rc=4, sub_block=32, n_sub=16)
    assert bool(jnp.isfinite(a0).all())


def test_simulate_bh3_backend_tracks_exact():
    from nbody_sim.core.simulate import SimulationConfig, simulate

    pos, vel, mass = generate_disk(jax.random.PRNGKey(28), 3000)
    base = dict(g_const=G, softening=EPS, dt=1e-4, integrator="leapfrog",
                calc_energy=True)
    t_ex = simulate(pos, vel, mass, 50,
                    SimulationConfig(force_backend="dense", **base))
    t_bh = simulate(pos, vel, mass, 50,
                    SimulationConfig(force_backend="bh3", bh_near=8,
                                     bh_block=64, bh_coarse=4, bh_rc=6,
                                     bh_sub_block=16, bh_n_sub=16,
                                     bh_refresh=8, **base))
    d = np.linalg.norm(
        np.asarray(t_bh.positions[-1]) - np.asarray(t_ex.positions[-1]),
        axis=-1)
    scale = float(np.linalg.norm(np.asarray(t_ex.positions[-1]), axis=-1).mean())
    assert 0 < np.max(d) / scale < 1e-4, np.max(d) / scale

    e = np.asarray(t_bh.u_energy) + np.asarray(t_bh.k_energy)
    assert np.abs(e - e[0]).max() < 1e-3 * abs(e[0])
