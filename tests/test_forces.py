"""Force/energy engine vs an independent NumPy transliteration of the
reference math (``/root/reference/src/galaxify/simulation.py:71-115``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_sim.core.forces import (
    pairwise_accelerations,
    potential_energy,
    kinetic_energy,
)
from nbody_sim.ops.pairwise import pallas_accelerations

G, EPS = 4.5e-6, 0.05


def numpy_reference_acc(pos, mass, g, eps):
    """Literal NumPy port of simulation.py:80-88 (float64 oracle)."""
    pos = np.asarray(pos, np.float64)
    mass = np.asarray(mass, np.float64)
    diff = pos[None, :, :] - pos[:, None, :]
    dist_sq = (diff**2).sum(-1) + eps**2
    inv = dist_sq ** -1.5
    np.fill_diagonal(inv, 0.0)
    return g * (diff * inv[:, :, None] * mass[None, :, None]).sum(1)


def numpy_reference_energies(pos, vel, mass, g, eps):
    """Literal NumPy port of simulation.py:91-115."""
    pos, vel, mass = (np.asarray(a, np.float64) for a in (pos, vel, mass))
    k = (0.5 * mass * (vel**2).sum(-1)).sum()
    diff = pos[None, :, :] - pos[:, None, :]
    dist = np.sqrt((diff**2).sum(-1)) + eps
    np.fill_diagonal(dist, np.inf)
    pot = -g * (mass[None, :] * mass[:, None]) / dist
    u = np.triu(pot, 1).sum()
    return u, k


def _random_system(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 3
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    mass = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    return pos, vel, mass


@pytest.mark.parametrize("n", [2, 3, 17, 100])
def test_dense_matches_reference_math(n):
    pos, _, mass = _random_system(n)
    got = np.asarray(pairwise_accelerations(pos, mass, G, EPS))
    want = numpy_reference_acc(pos, mass, G, EPS)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)


@pytest.mark.parametrize("n", [3, 64, 300])
def test_pallas_matches_dense(n):
    pos, _, mass = _random_system(n, seed=n)
    dense = np.asarray(pairwise_accelerations(pos, mass, G, EPS))
    pal = np.asarray(pallas_accelerations(pos, mass, G, EPS, interpret=True))
    scale = np.abs(dense).max() + 1e-30
    np.testing.assert_allclose(pal / scale, dense / scale, atol=2e-5)


def test_energies_match_reference_math():
    pos, vel, mass = _random_system(50)
    u = float(potential_energy(pos, mass, G, EPS))
    k = float(kinetic_energy(vel, mass))
    u_ref, k_ref = numpy_reference_energies(pos, vel, mass, G, EPS)
    assert abs(u - u_ref) < 1e-9 + 1e-5 * abs(u_ref)
    assert abs(k - k_ref) < 1e-9 + 1e-5 * abs(k_ref)


def test_mask_equals_smaller_system():
    """Padded slots must be exactly inert."""
    pos, vel, mass = _random_system(40)
    n_valid = 25
    mask = np.arange(40) < n_valid

    full = pairwise_accelerations(
        pos, mass, G, EPS, mask=jnp.asarray(mask)
    )
    small = pairwise_accelerations(pos[:n_valid], mass[:n_valid], G, EPS)
    scale = float(jnp.max(jnp.abs(small)))
    np.testing.assert_allclose(
        np.asarray(full[:n_valid]) / scale, np.asarray(small) / scale, atol=1e-6
    )
    assert np.all(np.asarray(full[n_valid:]) == 0)

    u_m = float(potential_energy(pos, mass, G, EPS, mask=jnp.asarray(mask)))
    u_s = float(potential_energy(pos[:n_valid], mass[:n_valid], G, EPS))
    assert abs(u_m - u_s) < 1e-10 + 1e-5 * abs(u_s)

    k_m = float(kinetic_energy(vel, mass, mask=jnp.asarray(mask)))
    k_s = float(kinetic_energy(vel[:n_valid], mass[:n_valid]))
    assert abs(k_m - k_s) < 1e-10 + 1e-5 * abs(k_s)


def test_pallas_mask_zeroes_padded_rows():
    pos, _, mass = _random_system(40, seed=7)
    mask = jnp.arange(40) < 30
    acc = pallas_accelerations(pos, mass, G, EPS, mask=mask, interpret=True)
    dense = pairwise_accelerations(pos[:30], mass[:30], G, EPS)
    scale = float(jnp.max(jnp.abs(dense))) + 1e-30
    np.testing.assert_allclose(
        np.asarray(acc[:30]) / scale, np.asarray(dense) / scale, atol=2e-5
    )
    assert np.all(np.asarray(acc[30:]) == 0)


def test_pallas_potential_energy_matches_dense():
    from nbody_sim.ops.pairwise import pallas_potential_energy

    pos, vel, mass = _random_system(200, seed=9)
    u_ref = float(potential_energy(pos, mass, G, EPS))
    u_pal = float(
        pallas_potential_energy(pos, mass, G, EPS, interpret=True)
    )
    assert abs(u_pal - u_ref) < 1e-5 * abs(u_ref)

    mask = jnp.arange(200) < 150
    u_ref_m = float(potential_energy(pos, mass, G, EPS, mask=mask))
    u_pal_m = float(
        pallas_potential_energy(pos, mass, G, EPS, mask=mask, interpret=True)
    )
    assert abs(u_pal_m - u_ref_m) < 1e-5 * abs(u_ref_m)


def test_chunked_potential_energy_matches_full():
    """Block-triangle decomposition (C diagonal + C(C-1)/2 cross launches)
    counts every unordered pair exactly once — the 10M-scale exact-audit
    path where one triangular launch exceeds the safe execution time."""
    from nbody_sim.ops.pairwise import (chunked_potential_energy,
                                        pallas_cross_potential,
                                        pallas_potential_energy)

    pos, _, mass = _random_system(500, seed=11)
    u_full = float(pallas_potential_energy(pos, mass, G, EPS,
                                           interpret=True))
    u_chunk = chunked_potential_energy(pos, mass, G, EPS, chunk=140,
                                       interpret=True)
    assert abs(u_chunk - u_full) < 1e-5 * abs(u_full)

    # cross kernel alone: disjoint halves == dense cross-pair sum
    a, b = pos[:250], pos[250:]
    ma, mb = mass[:250], mass[250:]
    d = jnp.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    u_ref = float(-G * jnp.sum(ma[:, None] * mb[None, :] / (d + EPS)))
    u_x = float(pallas_cross_potential(a, ma, b, mb, G, EPS,
                                       interpret=True))
    assert abs(u_x - u_ref) < 1e-5 * abs(u_ref)


def test_partial_acc_diag_delta_deprecated():
    """diag_delta is ignored by the force kernel — passing it must warn
    (a dead argument whose name implies exclusion is a trap)."""
    from nbody_sim.ops.pairwise import pallas_partial_accelerations

    pos, _, mass = _random_system(64)
    with pytest.warns(DeprecationWarning, match="diag_delta"):
        got = pallas_partial_accelerations(
            jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(mass), G, EPS,
            diag_delta=7, interpret=True,
        )
    want = pallas_partial_accelerations(
        jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(mass), G, EPS,
        interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
