"""Card-only tests: the kernels as compiled for the GPU (no interpret mode)
against the plain XLA references. Run on the card, in one process:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py

Elsewhere every test here skips (see the ``gpu`` fixture in conftest.py).
"""

import jax
import jax.numpy as jnp
import pytest

from nbody_sim.core import forces
from nbody_sim.ics import generate_spiral
from nbody_sim.ops import pairwise, treeforce

pytestmark = pytest.mark.gpu

G, EPS = 4.5e-6, 0.05


def _rel(a, b):
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


@pytest.fixture(scope="module")
def spiral():
    pos, vel, mass = generate_spiral(jax.random.PRNGKey(0), 20_000)
    return pos, vel, mass


def test_force_kernel_matches_xla(gpu, spiral):
    pos, _, mass = spiral
    got = pairwise.pallas_accelerations(pos, mass, G, EPS)
    with jax.default_matmul_precision("highest"):
        want = forces.chunked_accelerations(pos, mass, G, EPS)
    assert _rel(got, want) <= 1e-4


def test_energy_kernels_match_xla(gpu, spiral):
    pos, _, mass = spiral
    u = float(pairwise.pallas_potential_energy(pos, mass, G, EPS))
    assert u == pytest.approx(
        float(forces.chunked_potential_energy(pos, mass, G, EPS)), rel=1e-4)
    h = pos.shape[0] // 2
    ux = float(pairwise.pallas_cross_potential(pos[:h], mass[:h], pos[h:],
                                               mass[h:], G, EPS))
    assert ux == pytest.approx(float(forces.chunked_potential_energy(
        pos[:h], mass[:h], G, EPS, pos_src=pos[h:], mass_src=mass[h:])),
        rel=1e-4)


def test_multipole_kernel_matches_xla(gpu, spiral):
    pos, _, mass = spiral
    part = treeforce.build_bh_partition(pos, mass, n_near=16, block=256)
    spos, sm = treeforce._gather_sorted(pos, mass, part)
    nb = part.near.shape[0]
    _, _, msum, com, quad = treeforce._block_moments(spos, sm, nb, 256)
    got = treeforce.pallas_multipole_acc(spos, com, msum, quad, G, EPS ** 2)
    want = treeforce._multipole_acc(spos, com, msum, quad, G, EPS ** 2)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("engine", ["bh", "bh2", "bh3"])
def test_tree_engines_kernel_matches_xla(gpu, spiral, engine):
    pos, _, mass = spiral
    fn = {"bh": treeforce.bh_accelerations,
          "bh2": treeforce.bh2_accelerations,
          "bh3": treeforce.bh3_accelerations}[engine]
    kw = dict(n_near=16, block=128)
    if engine != "bh":
        kw.update(coarse=8, rc=8)
    got = fn(pos, mass, G, EPS, near_impl="pallas", **kw)
    want = fn(pos, mass, G, EPS, near_impl="xla", **kw)
    assert bool(jnp.isfinite(got).all())
    assert _rel(got, want) <= 1e-3


def test_auto_resolves_to_kernel(gpu):
    from nbody_sim.core.simulate import SimulationConfig, _resolve_backend
    from nbody_sim.ops.dispatch import resolve_impl

    assert resolve_impl() == "pallas"
    assert _resolve_backend(SimulationConfig(), 100_000) == "pallas"
