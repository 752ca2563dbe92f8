"""CPU tests of the kernel layer: the Triton-route Pallas kernels in
interpret mode against the dense XLA reference, the wrappers' padding and
masks, the one platform switch, the compile-cache location, the pandas-free
CSV path and chip_smoke.py's contract."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_sim.core import forces
from nbody_sim.ops import dispatch, pairwise, treeforce

G, EPS = 1.0, 0.1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bodies(n, seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    pos = jax.random.normal(k1, (n, 3))
    mass = jax.random.uniform(k2, (n,), minval=0.1, maxval=1.0)
    return pos, mass


# --- exact kernels: sizes, padding, masks -----------------------------------

@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_pallas_accelerations_sizes_and_mask(n):
    """Any N is zero-padded to whole tiles; a mask folds into the masses and
    zeroes the padded rows; the result matches the dense reference."""
    pos, mass = _bodies(n, seed=n)
    mask = jnp.arange(n) < max(1, n - 7)
    got = pairwise.pallas_accelerations(pos, mass, G, EPS, mask=mask,
                                        tile_i=64, tile_j=128, interpret=True)
    want = forces.pairwise_accelerations(pos, mass, G, EPS, mask=mask)
    assert got.shape == (n, 3)
    # the dense reference's W @ pos - pos * rowsum(W) contraction cancels
    # to ~1e-5 of the largest force (the repo's test_forces bound)
    scale = float(jnp.max(jnp.abs(want))) or 1.0
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, atol=2e-5)
    assert not np.asarray(got[~np.asarray(mask)]).any()


@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_pallas_potential_energy_sizes_and_mask(n):
    """Per-receiver partials summed in XLA, self-pairs excluded by global
    index, masked slots inert: U equals the dense upper-triangle sum."""
    pos, mass = _bodies(n, seed=n + 1)
    mask = jnp.arange(n) < max(1, n - 5)
    got = float(pairwise.pallas_potential_energy(
        pos, mass, G, EPS, mask=mask, tile_i=64, tile_j=128, interpret=True))
    want = float(forces.potential_energy(pos, mass, G, EPS, mask=mask,
                                         chunk_size=n))
    assert got == pytest.approx(want, rel=2e-5, abs=1e-12)


@pytest.mark.parametrize("ni,nj", [(1, 37), (300, 129)])
def test_pallas_cross_potential_matches_dense(ni, nj):
    """The rectangular (unmasked) energy of two disjoint sets equals
    U(A u B) - U(A) - U(B) of the dense reference."""
    pos, mass = _bodies(ni + nj, seed=3)
    a, b = pos[:ni], pos[ni:]
    ma, mb = mass[:ni], mass[ni:]
    got = float(pairwise.pallas_cross_potential(a, ma, b, mb, G, EPS,
                                                interpret=True))
    u = lambda p, m: forces.potential_energy(p, m, G, EPS,  # noqa: E731
                                             chunk_size=p.shape[0])
    want = float(u(pos, mass) - u(a, ma) - u(b, mb))
    assert got == pytest.approx(want, rel=1e-4)
    ref = float(forces.chunked_potential_energy(a, ma, G, EPS, chunk=64,
                                                pos_src=b, mass_src=mb))
    assert ref == pytest.approx(want, rel=1e-4)


def test_pack_bodies_and_tiles():
    pos, mass = _bodies(5)
    packed = pairwise.pack_bodies(pos, mass, 16)
    assert packed.shape == (16, 4)
    np.testing.assert_array_equal(np.asarray(packed[:5, :3]), np.asarray(pos))
    np.testing.assert_array_equal(np.asarray(packed[:5, 3]), np.asarray(mass))
    assert not np.asarray(packed[5:]).any()
    assert pairwise._pow2_tile(64, 1) == 16
    assert pairwise._pow2_tile(64, 40) == 64
    assert pairwise._pow2_tile(128, 1000) == 128
    with pytest.raises(AssertionError):
        pairwise._pow2_tile(48, 1000)


def test_chunked_references_match_dense():
    """The row-chunked XLA references equal the dense formulas."""
    pos, mass = _bodies(300, seed=9)
    want = np.asarray(forces.pairwise_accelerations(pos, mass, G, EPS))
    got = np.asarray(forces.chunked_accelerations(pos, mass, G, EPS,
                                                  chunk=64))
    # same arithmetic; the contraction's accumulation order differs
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)
    assert float(forces.chunked_potential_energy(
        pos, mass, G, EPS, chunk=64)) == pytest.approx(
        float(forces.potential_energy(pos, mass, G, EPS, chunk_size=300)),
        rel=1e-5)


# --- multipole kernels ------------------------------------------------------

@pytest.mark.parametrize("n_groups", [2, 5])
def test_grouped_multipole_kernel_matches_xla(n_groups):
    """G > 1 groups, each seeing only its own block rows (padded receivers
    and blocks): the kernel equals the XLA expansion per group."""
    k = jax.random.split(jax.random.PRNGKey(n_groups), 3)
    p_rows, n_blk = 70, 19
    qg = jax.random.normal(k[0], (n_groups, p_rows, 3))
    com = 3.0 * jax.random.normal(k[1], (40, 3))
    msum = jnp.linspace(0.5, 2.0, 40)
    a = jax.random.normal(k[2], (40, 3, 3)) * 0.1
    quad = a + jnp.swapaxes(a, 1, 2)
    quad = quad - jnp.trace(quad, axis1=1, axis2=2)[:, None, None] * (
        jnp.eye(3) / 3.0)
    blk = treeforce._blk_rows(com, msum, quad)
    sel = jnp.stack([(jnp.arange(n_blk) * (g + 1)) % 40
                     for g in range(n_groups)])
    got = treeforce._grouped_mult(qg, blk, sel, G, EPS ** 2, True, True)
    want = treeforce._grouped_mult(qg, blk, sel, G, EPS ** 2, False, False)
    assert got.shape == (n_groups, p_rows, 3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=1e-6)


def test_multipole_kernel_matches_xla():
    pos, mass = _bodies(500, seed=4)
    com = pos[:33] * 4.0
    quad = jnp.zeros((33, 3, 3))
    got = treeforce.pallas_multipole_acc(pos, com, mass[:33], quad, G,
                                         EPS ** 2, interpret=True)
    want = treeforce._multipole_acc(pos, com, mass[:33], quad, G, EPS ** 2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=1e-6)


# --- the one platform switch ------------------------------------------------

@pytest.mark.parametrize("platform,want", [("gpu", "pallas"), ("cpu", "xla"),
                                           ("rocm", None)])
def test_resolve_impl_by_platform(monkeypatch, platform, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if want is None:
        with pytest.raises(RuntimeError, match="no force implementation"):
            dispatch.resolve_impl("auto")
    else:
        assert dispatch.resolve_impl("auto") == want
    # explicit choices pass through on every platform
    assert dispatch.resolve_impl("xla") == "xla"
    assert dispatch.resolve_impl("pallas") == "pallas"


def test_resolve_impl_rejects_unknown_and_interpret():
    for bad in ("pallas_interpret", "triton", ""):
        with pytest.raises(ValueError, match="unknown implementation"):
            dispatch.resolve_impl(bad)


def test_simulate_auto_backend_by_platform(monkeypatch):
    """force_backend='auto': the kernel on the GPU from the threshold up,
    dense below it and on the CPU; energies follow for the tree engines."""
    from nbody_sim.core.simulate import (
        _PALLAS_AUTO_THRESHOLD, SimulationConfig, _resolve_backend)

    cfg = SimulationConfig()
    big, small = _PALLAS_AUTO_THRESHOLD, _PALLAS_AUTO_THRESHOLD - 1
    assert _resolve_backend(cfg, big) == "dense"  # the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _resolve_backend(cfg, big) == "pallas"
    assert _resolve_backend(cfg, small) == "dense"
    assert _resolve_backend(SimulationConfig(force_backend="bh3"), 9) == "bh3"
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError):
        _resolve_backend(cfg, big)


# --- runtime plumbing --------------------------------------------------------

def test_compile_cache_follows_env(monkeypatch, tmp_path):
    from nbody_sim.utils import compile_cache

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_persistent_cache() == str(tmp_path)
    assert updates == []  # JAX reads the variable itself; no other dir set


def test_compile_cache_defaults_to_repo(monkeypatch):
    from nbody_sim.utils import compile_cache

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.enable_persistent_cache() == want
    assert updates == [("jax_compilation_cache_dir", want)]


def test_datagen_csv_without_pandas(monkeypatch, tmp_path):
    """The physics path writes (and the dataset reads) the CSV with pandas
    unimportable."""
    from nbody_sim.data.dataset import SnapshotDataset
    from nbody_sim.data.generate import ScenarioConfig, generate_dataset
    from nbody_sim.data.schema import CSV_FIELDS

    monkeypatch.setitem(sys.modules, "pandas", None)
    out = str(tmp_path / "d.csv")
    generate_dataset(
        [ScenarioConfig(n_bodies=6, steps=3, sim_type="spiral", seed=1,
                        force_backend="dense")], out, verbose=False)
    with open(out) as f:
        assert f.readline().strip().split(",") == CSV_FIELDS
    ds = SnapshotDataset.from_csv(out)
    npz = SnapshotDataset.from_file(out)
    np.testing.assert_allclose(ds.buckets[6].x, npz.buckets[6].x, rtol=1e-6)
    np.testing.assert_allclose(ds.buckets[6].y, npz.buckets[6].y, rtol=1e-6)


def test_numpy_csv_writer_matches_native_format(tmp_path):
    from nbody_sim.data import io_native
    from nbody_sim.data.schema import CSV_FIELDS

    cols = {c: np.arange(3, dtype=np.float64) / 3 for c in CSV_FIELDS}
    cols.update(scene=np.arange(3), step=np.arange(3),
                scene_type=np.array(["disk", "spiral", "disk"], object))
    path = str(tmp_path / "n.csv")
    io_native._write_csv_numpy(cols, path)
    lines = open(path).read().splitlines()
    assert lines[0] == ",".join(CSV_FIELDS)
    assert lines[2].startswith("1,spiral,1,0.333333333,")


# --- chip_smoke.py -----------------------------------------------------------

def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_chip_smoke_refuses_cpu(capsys):
    """Without a GPU the script exits non-zero and prints no result."""
    assert _chip_smoke().main([]) != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_last_line_format(monkeypatch, capsys):
    cs = _chip_smoke()

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda: [Dev()])
    monkeypatch.setattr(cs, "card", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    from nbody_sim.utils import compile_cache

    monkeypatch.setattr(compile_cache, "enable_persistent_cache", lambda: "")
    for name in ("phase_exact", "phase_treecodes", "phase_datagen"):
        monkeypatch.setattr(cs, name, lambda c: None)
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in lines[0]
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_chip_smoke_datagen_phase_small(tmp_path):
    """Phase 3's read-back logic at a tiny size on the CPU."""
    cs = _chip_smoke()
    c = cs.Checks("cpu")
    cs.phase_datagen(c, sizes=(4, 9), steps=3)
    assert c.failed == []
