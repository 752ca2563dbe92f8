"""Datagen: vmapped scenario groups vs sequential; CSV/npz integrity."""

import os

import numpy as np
import pandas as pd
import pytest

from nbody_sim.data.generate import (
    ScenarioConfig,
    generate_dataset,
    scenario_product,
    _group_scenarios,
)


def test_vmapped_matches_sequential(tmp_path):
    cfgs = [
        ScenarioConfig(n_bodies=10, sim_type="spiral", steps=5, seed=s,
                       force_backend="dense")
        for s in (1, 2, 3)
    ]
    generate_dataset(cfgs, str(tmp_path / "v.csv"), verbose=False, vmap_scenes=True)
    generate_dataset(cfgs, str(tmp_path / "s.csv"), verbose=False, vmap_scenes=False)
    dv = pd.read_csv(tmp_path / "v.csv").drop(columns=["step_time"])
    ds = pd.read_csv(tmp_path / "s.csv").drop(columns=["step_time"])
    pd.testing.assert_frame_equal(dv, ds, check_exact=False, rtol=1e-5, atol=1e-9)


def test_grouping():
    scenarios = scenario_product(
        n_bodies=[4, 8], steps=3, sim_type="disk", seed=[1, 2, 3]
    )
    groups = _group_scenarios(scenarios)
    # product order: n=4 x seeds(1,2,3), n=8 x seeds(1,2,3) -> 2 groups of 3
    sizes = sorted(len(g) for g in groups)
    assert sum(sizes) == 6
    assert max(sizes) == 3


def test_mixed_groups_roundtrip(tmp_path):
    scenarios = scenario_product(
        n_bodies=[6, 9], steps=4, sim_type="spiral", seed=[5, 6],
        force_backend="dense",
    )
    generate_dataset(scenarios, str(tmp_path / "m.csv"), verbose=False)
    df = pd.read_csv(tmp_path / "m.csv")
    assert sorted(df["scene"].unique()) == [0, 1, 2, 3]
    assert len(df) == 4 * 6 + 4 * 6 + 4 * 9 + 4 * 9
    assert np.isfinite(df[["x", "y", "z", "u", "k"]].to_numpy()).all()


def test_snapshot_stride_and_npz_only(tmp_path):
    """Strided datasets keep original step numbers (CSV column and npz
    twin agree) and --npz-only skips the CSV entirely."""
    from nbody_sim.data.dataset import SnapshotDataset

    scenarios = scenario_product(
        n_bodies=8, steps=10, sim_type="disk", seed=7, force_backend="dense"
    )
    out = str(tmp_path / "s.csv")
    generate_dataset(scenarios, out, verbose=False, snapshot_stride=4)
    df = pd.read_csv(out)
    assert sorted(df["step"].unique()) == [0, 4, 8]
    ds = SnapshotDataset.from_npz(out[:-4] + ".npz")
    bucket = ds.buckets[8]
    assert sorted(bucket.step.tolist()) == [0, 4, 8]
    np.testing.assert_allclose(
        bucket.x[bucket.step == 4][0, :, 0],
        df[df.step == 4]["x"].to_numpy(np.float32), rtol=1e-6)

    out2 = str(tmp_path / "only.csv")
    generate_dataset(scenarios, out2, verbose=False, snapshot_stride=2,
                     write_csv_file=False)
    assert not (tmp_path / "only.csv").exists()
    ds2 = SnapshotDataset.from_file(out2)  # resolves the npz twin
    assert ds2.n_snapshots == 5


def test_calc_energy_off(tmp_path):
    """calc_energy=False skips the O(N^2) per-snapshot PE (the 1M-body
    datagen enabler): u/k columns become NaN in both CSV and npz, the
    dynamics are untouched, and the dataset loader still reads the npz."""
    from nbody_sim.data.dataset import SnapshotDataset

    base = dict(n_bodies=8, steps=6, sim_type="disk", seed=3,
                force_backend="dense")
    out = str(tmp_path / "e.csv")
    generate_dataset([ScenarioConfig(**base, calc_energy=False)], out,
                     verbose=False)
    df = pd.read_csv(out)
    assert df["u"].isna().all() and df["k"].isna().all()
    z = np.load(out[:-4] + ".npz")
    assert np.isnan(z["scene0_u"]).all() and np.isnan(z["scene0_k"]).all()

    ref = str(tmp_path / "ref.csv")
    generate_dataset([ScenarioConfig(**base)], ref, verbose=False)
    zr = np.load(ref[:-4] + ".npz")
    np.testing.assert_array_equal(z["scene0_pos"], zr["scene0_pos"])
    np.testing.assert_array_equal(z["scene0_acc"], zr["scene0_acc"])
    assert np.isfinite(zr["scene0_u"]).all()

    ds = SnapshotDataset.from_npz(out[:-4] + ".npz")
    assert ds.n_snapshots == 6

    # chunked-timing branch (the large-N recipe) honors the flag too
    out2 = str(tmp_path / "e2.csv")
    generate_dataset([ScenarioConfig(**base, calc_energy=False)], out2,
                     verbose=False, time_chunks=2, write_csv_file=False)
    z2 = np.load(out2[:-4] + ".npz")
    assert np.isnan(z2["scene0_u"]).all()


def test_truncated_npz_detected_and_recovered(tmp_path):
    """A failure chain, designed out: a kill mid-``np.savez_compressed``
    can leave a truncated npz that an existence-only ``--skip-datagen``
    check would trust, crashing training with BadZipFile hours later. Now (a) writes are atomic (temp + os.replace, so
    a truncated file can never sit at the final path), (b) ``valid_npz``
    rejects truncation, and (c) the training loaders recover: npz-only files
    are skipped with a warning, CSV-backed files fall back to the CSV."""
    from nbody_sim.data.dataset import SnapshotDataset
    from nbody_sim.data.generate import valid_npz
    from nbody_sim.train.trainer import Trainer, _list_dataset_files

    base = dict(n_bodies=8, steps=6, sim_type="disk", force_backend="dense")
    good = str(tmp_path / "good.csv")
    generate_dataset([ScenarioConfig(**base, seed=1)], good, verbose=False,
                     write_csv_file=False)
    bad = str(tmp_path / "bad.csv")
    generate_dataset([ScenarioConfig(**base, seed=2)], bad, verbose=False,
                     write_csv_file=False)

    assert valid_npz(good[:-4] + ".npz")
    # no stray temp files from the atomic writer
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]

    # fault injection: truncate one scene mid-file (a killed write)
    with open(bad[:-4] + ".npz", "r+b") as f:
        f.truncate(200)
    assert not valid_npz(bad[:-4] + ".npz")

    # npz-only + corrupt and no CSV twin -> excluded with a warning
    with pytest.warns(UserWarning, match="corrupt"):
        files = _list_dataset_files(str(tmp_path))
    assert files == [good[:-4] + ".npz"]

    # train_from_dir recovers: trains on the surviving scene
    trainer = Trainer(_tiny_model(), learning_rate=0.01, dt=1e-4, seed=0)
    with pytest.warns(UserWarning, match="corrupt"):
        losses, _ = trainer.train_from_dir(str(tmp_path), epochs=1,
                                           batch_size=4, verbose=False)
    assert np.isfinite(losses).all()

    # corrupt npz WITH a CSV twin -> loader falls back to the CSV
    twin = str(tmp_path / "twin.csv")
    generate_dataset([ScenarioConfig(**base, seed=3)], twin, verbose=False)
    with open(twin[:-4] + ".npz", "r+b") as f:
        f.truncate(200)
    with pytest.warns(UserWarning, match="falling back"):
        ds = SnapshotDataset.from_file(twin)
    assert ds.n_snapshots == 6

    # corrupt npz, no fallback -> clear actionable error, not BadZipFile
    with pytest.raises(OSError, match="regenerate"):
        SnapshotDataset.from_file(bad[:-4] + ".npz")


def _tiny_model():
    from nbody_sim.models import GraphModel

    return GraphModel(input_dim=4, gnn_dim=8, message_passing_steps=1,
                      aggr="mean", neighbors=4, scale_factor=1e6)


def test_atomic_writer_leaves_no_partial_on_failure(tmp_path, monkeypatch):
    """If the write itself dies, the final path must hold either the old
    complete file or nothing — never a truncated new one."""
    from nbody_sim.data import generate as gen

    target = str(tmp_path / "x.npz")
    # seed an existing complete file
    gen.save_npz_atomic(target, a=np.arange(3))
    assert gen.valid_npz(target)

    # fail DURING the savez (before os.replace): old file must survive
    monkeypatch.setattr(np, "savez_compressed",
                        lambda path, **kw: (_ for _ in ()).throw(
                            RuntimeError("simulated mid-write kill")))
    with pytest.raises(RuntimeError):
        gen.save_npz_atomic(target, a=np.arange(5))
    z = np.load(target)
    assert z["a"].shape == (3,), "old complete file must be untouched"
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
