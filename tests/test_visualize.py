"""Figure-renderer plumbing: the (filename, scene) -> (n_bodies, step_time)
map must survive deletion of the gitignored raw data dir via the committed
``results/scene_info.json`` sidecar (the reference notebook re-reads the test
CSVs every render, cell 3 — which breaks on a fresh checkout)."""

import json
import os

import pandas as pd
import pytest

from nbody_sim.experiments.visualize import _scene_n_bodies


def _write_test_csv(path, scenes):
    rows = []
    for scene, n in scenes:
        for step in range(2):
            for _ in range(n):
                rows.append({"scene": scene, "step": step,
                             "step_time": 0.25 * (scene + 1)})
    pd.DataFrame(rows).to_csv(path, index=False)


@pytest.fixture
def base(tmp_path):
    (tmp_path / "data" / "test").mkdir(parents=True)
    (tmp_path / "results").mkdir()
    _write_test_csv(tmp_path / "data" / "test" / "output_file_1.csv",
                    [(0, 3), (1, 5)])
    _write_test_csv(tmp_path / "data" / "test" / "output_file_2.csv",
                    [(0, 7)])
    return str(tmp_path)


def test_keyed_by_file_and_scene(base):
    info = _scene_n_bodies(base)
    assert info[("output_file_1.csv", 0)][0] == 3
    assert info[("output_file_1.csv", 1)][0] == 5
    # scene 0 of file 2 must not overwrite scene 0 of file 1
    assert info[("output_file_2.csv", 0)][0] == 7


def test_sidecar_written_and_survives_data_deletion(base):
    info = _scene_n_bodies(base)
    sidecar = os.path.join(base, "results", "scene_info.json")
    assert os.path.exists(sidecar)
    with open(sidecar) as f:
        rows = json.load(f)
    assert len(rows) == 3

    # nuke the raw data dir — a fresh checkout
    for f in os.listdir(os.path.join(base, "data", "test")):
        os.remove(os.path.join(base, "data", "test", f))
    info2 = _scene_n_bodies(base)
    assert info2 == info


def test_no_data_no_sidecar_is_empty(tmp_path):
    assert _scene_n_bodies(str(tmp_path)) == {}


def test_sidecar_merges_with_partial_data(base):
    """Regenerating only SOME test files must not truncate the committed
    mapping for the others."""
    info_full = _scene_n_bodies(base)
    # drop one file from the raw data dir, keep the other
    os.remove(os.path.join(base, "data", "test", "output_file_2.csv"))
    info_partial = _scene_n_bodies(base)
    assert info_partial == info_full  # file-2 entries came from the sidecar
