"""Neighbor-list kernels vs brute force (SURVEY.md §4) — the torch-cluster
replacements (``ops/knn.py``, ``ops/radius.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_sim.ops.knn import knn_neighbors, batched_knn_neighbors
from nbody_sim.ops.radius import radius_neighbors


def brute_knn(pos, k, include_self=False):
    n = len(pos)
    d2 = ((pos[None] - pos[:, None]) ** 2).sum(-1)
    if not include_self:
        np.fill_diagonal(d2, np.inf)
    return np.argsort(d2, axis=1, kind="stable")[:, :k], d2


@pytest.mark.parametrize("n,k", [(30, 5), (100, 10), (5, 10)])
def test_knn_matches_bruteforce(n, k):
    rng = np.random.default_rng(n * 7 + k)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    idx, valid = knn_neighbors(jnp.asarray(pos), k)
    idx, valid = np.asarray(idx), np.asarray(valid)
    want_idx, d2 = brute_knn(pos, k)
    k_eff = min(k, n)
    # valid count: min(k, n-1) neighbors (self excluded)
    assert np.all(valid.sum(1) == min(k_eff, n - 1))
    for i in range(n):
        got = set(idx[i][valid[i][:k_eff]] if k_eff < k else idx[i][valid[i]])
        want = set(want_idx[i][: min(k_eff, n - 1)])
        # sets equal up to distance ties
        sym = got ^ want
        for j in sym:
            partner_ds = sorted(d2[i][list(want)])
            assert np.isclose(d2[i, j], partner_ds[-1], rtol=1e-5)


def test_knn_never_returns_self():
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(50, 3)).astype(np.float32)
    idx, valid = knn_neighbors(jnp.asarray(pos), 8)
    rows = np.arange(50)[:, None]
    assert not np.any((np.asarray(idx) == rows) & np.asarray(valid))


def test_knn_mask_excludes_padded():
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(40, 3)).astype(np.float32)
    mask = jnp.arange(40) < 25
    idx, valid = knn_neighbors(jnp.asarray(pos), 6, mask=mask)
    idx, valid = np.asarray(idx), np.asarray(valid)
    assert not np.any(valid[25:])  # padded rows have no neighbors
    assert np.all(idx[valid] < 25)  # nobody points at padding
    # equivalence with the unpadded system
    idx_s, valid_s = knn_neighbors(jnp.asarray(pos[:25]), 6)
    assert np.array_equal(valid[:25], np.asarray(valid_s))
    assert np.array_equal(idx[:25][valid[:25]], np.asarray(idx_s)[np.asarray(valid_s)])


def test_radius_matches_bruteforce():
    rng = np.random.default_rng(2)
    pos = rng.uniform(-1, 1, size=(80, 3)).astype(np.float32)
    r = 0.7
    idx, valid = radius_neighbors(jnp.asarray(pos), r, k_max=80, include_self=True)
    idx, valid = np.asarray(idx), np.asarray(valid)
    d2 = ((pos[None] - pos[:, None]) ** 2).sum(-1)
    for i in range(80):
        want = set(np.flatnonzero(d2[i] < r * r))
        got = set(idx[i][valid[i]])
        assert got == want


def test_radius_truncates_to_nearest():
    rng = np.random.default_rng(3)
    pos = rng.uniform(-0.1, 0.1, size=(50, 3)).astype(np.float32)  # all in radius
    idx, valid = radius_neighbors(jnp.asarray(pos), 1.0, k_max=8, include_self=False)
    d2 = ((pos[None] - pos[:, None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    assert np.all(np.asarray(valid).sum(1) == 8)
    for i in range(50):
        got = np.sort(d2[i][np.asarray(idx)[i]])
        want = np.sort(d2[i])[:8]
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_radius_morton_methods():
    """The morton-backed radius search (the production large-N path for the
    ContConv graph, replacing torch_cluster.radius_graph at contconv.py:225)
    must recover (nearly) the exact in-radius sets; cutoff semantics are
    exact because distances are recomputed on the selected candidates."""
    from nbody_sim.ics import generate_disk

    pos, _, _ = generate_disk(jax.random.PRNGKey(8), 900)
    r = 0.5
    idx_e, valid_e = radius_neighbors(pos, r, k_max=16, include_self=True)
    hits = tot = 0
    for method in ("morton",):
        idx_m, valid_m = radius_neighbors(
            pos, r, k_max=16, include_self=True, method=method
        )
        ie, ve = np.asarray(idx_e), np.asarray(valid_e)
        im, vm = np.asarray(idx_m), np.asarray(valid_m)
        # every returned neighbor really is within r (cutoff is exact)
        pn = np.asarray(pos)
        d2 = ((pn[None] - pn[:, None]) ** 2).sum(-1)
        for i in range(0, 900, 41):
            assert np.all(d2[i][im[i][vm[i]]] < r * r)
        hits = sum(
            len(set(ie[i][ve[i]]) & set(im[i][vm[i]])) for i in range(900)
        )
        tot = sum(ve[i].sum() for i in range(900))
        assert hits / tot >= 0.99, f"{method} recall {hits/tot:.4f}"


def test_batched_knn_is_per_snapshot():
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(3, 20, 3)).astype(np.float32)
    idx_b, valid_b = batched_knn_neighbors(jnp.asarray(pos), 4)
    for b in range(3):
        idx, valid = knn_neighbors(jnp.asarray(pos[b]), 4)
        assert np.array_equal(np.asarray(idx_b[b]), np.asarray(idx))
        assert np.array_equal(np.asarray(valid_b[b]), np.asarray(valid))


def test_trilinear_interpolation_matches_manual():
    from nbody_sim.ops.interpolate import trilinear_interpolate

    rng = np.random.default_rng(5)
    d, ci, co = 4, 2, 3
    filters = rng.normal(size=(d, d, d, ci, co)).astype(np.float32)
    coords = rng.uniform(0, d - 1, size=(16, 3)).astype(np.float32)

    got = np.asarray(trilinear_interpolate(jnp.asarray(filters), jnp.asarray(coords)))

    def manual(c):
        x0, y0, z0 = np.floor(c).astype(int)
        x0, y0, z0 = min(x0, d - 2), min(y0, d - 2), min(z0, d - 2)
        fx, fy, fz = c[0] - x0, c[1] - y0, c[2] - z0
        out = np.zeros((ci, co), np.float64)
        for ox in (0, 1):
            for oy in (0, 1):
                for oz in (0, 1):
                    w = ((fx if ox else 1 - fx) * (fy if oy else 1 - fy)
                         * (fz if oz else 1 - fz))
                    out += w * filters[x0 + ox, y0 + oy, z0 + oz]
        return out

    for e in range(16):
        np.testing.assert_allclose(got[e], manual(coords[e]), rtol=1e-4, atol=1e-5)


def test_trilinear_exact_at_gridpoints():
    from nbody_sim.ops.interpolate import trilinear_interpolate

    rng = np.random.default_rng(6)
    d = 3
    filters = rng.normal(size=(d, d, d, 1, 2)).astype(np.float32)
    coords = jnp.asarray([[0, 0, 0], [2, 2, 2], [1, 0, 2]], jnp.float32)
    got = np.asarray(trilinear_interpolate(jnp.asarray(filters), coords))
    np.testing.assert_allclose(got[0], filters[0, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(got[1], filters[2, 2, 2], rtol=1e-6)
    np.testing.assert_allclose(got[2], filters[1, 0, 2], rtol=1e-6)
