"""Snapshot dataset + batching — the static-shape rebuild of the reference data
pipeline (``/root/reference/datautils.py``).

The reference parses the CSV into per-(scene, step) torch-geometric ``Data``
graphs with a kNN edge_index baked in at load time (datautils.py:23-44) and
caches them to ``<name>_graph.pt`` — a cache that is silently stale when ``k``
changes (datautils.py:19-20, SURVEY.md §7 bug list).

Here snapshots are plain dense arrays bucketed by body count (static
shapes for the compiler); neighbor lists are built **on device inside the jitted train step**
(they depend on the model's graph_spec, not on the dataset), which both fixes
the stale-k bug and removes the host-side graph build from the hot loop. The
fast-reload cache is the ``.npz`` twin written by ``data.generate`` (keyed by
file mtime, not hyperparameters).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Bucket:
    """All snapshots sharing one body count: x [pos|vel|mass] per node."""

    x: np.ndarray  # (S, N, 7) float32
    y: np.ndarray  # (S, N, 3) float32 accelerations
    scene: np.ndarray  # (S,) int32
    step: np.ndarray  # (S,) int32


class Batch(NamedTuple):
    x: np.ndarray  # (B, N, 7)
    y: np.ndarray  # (B, N, 3)
    node_mask: np.ndarray  # (B, N) bool — False rows are snapshot padding
    scene: np.ndarray  # (B,)
    step: np.ndarray  # (B,)


@dataclasses.dataclass
class SceneTrajectory:
    """One scene's full ground-truth rollout (for autoregressive eval)."""

    scene: int
    pos: np.ndarray  # (steps, N, 3)
    vel: np.ndarray  # (steps, N, 3)
    acc: np.ndarray  # (steps, N, 3)
    mass: np.ndarray  # (N,)


class SnapshotDataset:
    """Snapshots grouped by (scene, step), bucketed by body count."""

    def __init__(self, buckets: Dict[int, Bucket]):
        self.buckets = buckets

    @property
    def n_snapshots(self) -> int:
        return sum(b.x.shape[0] for b in self.buckets.values())

    @classmethod
    def from_file(cls, path: str) -> "SnapshotDataset":
        """Load from a trajectory CSV (reference schema) or its ``.npz``
        twin — preferring the npz when it is at least as new as the CSV.

        A structurally corrupt npz (e.g. truncated by a kill mid-write)
        falls back to the
        CSV twin when one exists; with no fallback it raises a clear error
        naming the file instead of a bare BadZipFile from inside np.load."""
        npz = path[:-4] + ".npz" if path.endswith(".csv") else path
        if (
            npz.endswith(".npz")
            and os.path.exists(npz)
            and (not os.path.exists(path) or os.path.getmtime(npz) >= os.path.getmtime(path))
        ):
            from nbody_sim.data.generate import valid_npz

            if valid_npz(npz):
                return cls.from_npz(npz)
            if os.path.exists(path) and path != npz:
                import warnings

                warnings.warn(
                    f"{npz} is corrupt (truncated write?) — falling back to "
                    f"the CSV twin {path}; regenerate the npz to clear this",
                    stacklevel=2,
                )
                return cls.from_csv(path)
            raise OSError(
                f"dataset file {npz} is corrupt (incomplete zip — likely a "
                "kill mid-write) and has no CSV twin; delete it and "
                "regenerate the scene"
            )
        return cls.from_csv(path)

    @classmethod
    def from_npz(cls, path: str) -> "SnapshotDataset":
        data = np.load(path, allow_pickle=False)
        n_scenes = int(data["n_scenes"])
        raw: Dict[int, List] = {}
        for s in range(n_scenes):
            pos = data[f"scene{s}_pos"]
            vel = data[f"scene{s}_vel"]
            acc = data[f"scene{s}_acc"]
            mass = data[f"scene{s}_mass"]
            steps, n, _ = pos.shape
            x = np.concatenate(
                [pos, vel, np.broadcast_to(mass[None, :, None], (steps, n, 1))],
                axis=-1,
            ).astype(np.float32)
            # strided datasets carry their original step numbers
            step = (
                data[f"scene{s}_step"].astype(np.int32)
                if f"scene{s}_step" in data
                else np.arange(steps, dtype=np.int32)
            )
            raw.setdefault(n, []).append(
                (x, acc.astype(np.float32), np.full(steps, s, np.int32), step)
            )
        return cls(_collate(raw))

    @classmethod
    def from_csv(cls, path: str) -> "SnapshotDataset":
        with open(path) as f:
            header = f.readline().strip().split(",")
        names = ["scene", "step", "x", "y", "z", "vx", "vy", "vz", "mass",
                 "ax", "ay", "az"]
        cols = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2,
                          usecols=[header.index(c) for c in names])
        col = {c: cols[:, i] for i, c in enumerate(names)}
        scene = col["scene"].astype(np.int64)
        step = col["step"].astype(np.int64)
        # (scene, step) groups in sorted key order, rows in file order within
        # a group — the reference's groupby (datautils.py:26)
        order = np.lexsort((step, scene))
        key = np.stack([scene[order], step[order]], axis=1)
        starts = np.flatnonzero(np.r_[True, np.any(key[1:] != key[:-1], 1)])
        x_all = np.stack([col[c] for c in names[2:9]], axis=1)[order]
        y_all = np.stack([col[c] for c in names[9:]], axis=1)[order]
        raw: Dict[int, List] = {}
        for lo, hi in zip(starts, np.r_[starts[1:], len(order)]):
            raw.setdefault(hi - lo, []).append((
                x_all[lo:hi].astype(np.float32)[None],
                y_all[lo:hi].astype(np.float32)[None],
                np.array([key[lo, 0]], np.int32),
                np.array([key[lo, 1]], np.int32),
            ))
        return cls(_collate(raw))

    def scene_ids(self) -> List[int]:
        ids = set()
        for b in self.buckets.values():
            ids.update(np.unique(b.scene).tolist())
        return sorted(ids)

    def scene_trajectory(self, scene: int) -> SceneTrajectory:
        """Reassemble one scene's full trajectory (step-ordered)."""
        for b in self.buckets.values():
            sel = b.scene == scene
            if not sel.any():
                continue
            order = np.argsort(b.step[sel], kind="stable")
            x = b.x[sel][order]
            y = b.y[sel][order]
            return SceneTrajectory(
                scene=scene,
                pos=x[..., :3],
                vel=x[..., 3:6],
                acc=y,
                mass=x[0, :, 6],
            )
        raise KeyError(f"scene {scene} not in dataset")


def _collate(raw: Dict[int, List]) -> Dict[int, Bucket]:
    buckets = {}
    for n, items in raw.items():
        xs, ys, scenes, steps = zip(*items)
        buckets[n] = Bucket(
            x=np.concatenate(xs, axis=0) if xs[0].ndim == 3 else np.stack(xs),
            y=np.concatenate(ys, axis=0) if ys[0].ndim == 3 else np.stack(ys),
            scene=np.concatenate(scenes),
            step=np.concatenate(steps),
        )
    return buckets


class BatchIterator:
    """Yield fixed-shape batches per bucket; the final partial batch of each
    bucket is padded with masked-out snapshots so jit sees few distinct
    shapes. Equivalent role to ``get_dataloader`` (datautils.py:51-53)."""

    def __init__(
        self,
        dataset: SnapshotDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: Optional[int] = None,
        pad_final: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.pad_final = pad_final

    def __iter__(self) -> Iterator[Batch]:
        bucket_keys = list(self.dataset.buckets.keys())
        if self.shuffle:
            self.rng.shuffle(bucket_keys)
        for n in bucket_keys:
            b = self.dataset.buckets[n]
            s = b.x.shape[0]
            order = self.rng.permutation(s) if self.shuffle else np.arange(s)
            for start in range(0, s, self.batch_size):
                sel = order[start : start + self.batch_size]
                bs = len(sel)
                x, y = b.x[sel], b.y[sel]
                scene, step = b.scene[sel], b.step[sel]
                mask = np.ones((bs, n), bool)
                if bs < self.batch_size and self.pad_final:
                    pad = self.batch_size - bs
                    x = np.concatenate([x, np.zeros((pad, n, 7), np.float32)])
                    y = np.concatenate([y, np.zeros((pad, n, 3), np.float32)])
                    mask = np.concatenate([mask, np.zeros((pad, n), bool)])
                    scene = np.concatenate([scene, np.full(pad, -1, np.int32)])
                    step = np.concatenate([step, np.full(pad, -1, np.int32)])
                yield Batch(x, y, mask, scene, step)

    def __len__(self) -> int:
        total = 0
        for b in self.dataset.buckets.values():
            s = b.x.shape[0]
            total += -(-s // self.batch_size)
        return total
