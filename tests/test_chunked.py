"""Large-N streamed (chunked) paths vs their dense equivalents."""

import jax.numpy as jnp
import numpy as np

from nbody_sim.core.forces import potential_energy
from nbody_sim.ops.knn import knn_neighbors
from nbody_sim.ops.radius import radius_neighbors


def _pos(n, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 2)


def test_chunked_knn_matches_dense():
    pos = _pos(300)
    idx_d, val_d = knn_neighbors(pos, 8)
    idx_c, val_c = knn_neighbors(pos, 8, chunk_size=64)
    assert np.array_equal(np.asarray(val_d), np.asarray(val_c))
    # neighbor SETS equal per row (order may differ on fp ties)
    for i in range(300):
        assert set(np.asarray(idx_d)[i].tolist()) == set(np.asarray(idx_c)[i].tolist())


def test_chunked_knn_with_mask():
    pos = _pos(200, seed=1)
    mask = jnp.arange(200) < 150
    idx_c, val_c = knn_neighbors(pos, 6, mask=mask, chunk_size=64)
    idx_d, val_d = knn_neighbors(pos, 6, mask=mask)
    assert np.array_equal(np.asarray(val_d), np.asarray(val_c))
    assert np.all(np.asarray(idx_c)[np.asarray(val_c)] < 150)
    assert not np.asarray(val_c)[150:].any()


def test_chunked_radius_matches_dense():
    pos = _pos(257, seed=2)  # non-multiple of chunk
    idx_d, val_d = radius_neighbors(pos, 1.5, k_max=16)
    idx_c, val_c = radius_neighbors(pos, 1.5, k_max=16, chunk_size=64)
    for i in range(257):
        got_d = set(np.asarray(idx_d)[i][np.asarray(val_d)[i]].tolist())
        got_c = set(np.asarray(idx_c)[i][np.asarray(val_c)[i]].tolist())
        assert got_d == got_c


def test_chunked_potential_energy_matches_dense():
    rng = np.random.default_rng(3)
    pos = _pos(500, seed=3)
    mass = jnp.asarray(rng.uniform(0.1, 1, 500).astype(np.float32))
    u_dense = float(potential_energy(pos, mass, 4.5e-6, 0.05))
    u_chunk = float(potential_energy(pos, mass, 4.5e-6, 0.05, chunk_size=128))
    assert abs(u_dense - u_chunk) < 1e-5 * abs(u_dense)

    mask = jnp.arange(500) < 400
    u_dense_m = float(potential_energy(pos, mass, 4.5e-6, 0.05, mask=mask))
    u_chunk_m = float(
        potential_energy(pos, mass, 4.5e-6, 0.05, mask=mask, chunk_size=128)
    )
    assert abs(u_dense_m - u_chunk_m) < 1e-5 * abs(u_dense_m)
