"""Trajectory dataset generation — the compiled rebuild of the reference
datagen pipeline (``/root/reference/src/s01-dataset-generation.py``).

The reference runs a Python loop per step with a host snapshot each iteration
and then a per-particle ``csv.DictWriter`` loop (s01:218-241 — its I/O
bottleneck). Here the whole trajectory is one ``lax.scan`` on device and the
CSV materialisation is one pass of the native C++ writer over numpy columns
(``nbody_sim.data.io_native``; a numpy writer when it cannot be built). A compact ``.npz`` twin
is written alongside for fast reload.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from nbody_sim.core.simulate import SimulationConfig, Trajectory, simulate
from nbody_sim.data.schema import CSV_FIELDS
from nbody_sim.ics import GENERATORS


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """One simulated scene — the unit of the CLI's cartesian fan-out
    (s01:93-104). Defaults match the reference CLI (s01:42-83)."""

    n_bodies: int = 100
    integrator: str = "leapfrog"
    sim_type: str = "disk"  # "disk" | "spiral"
    steps: int = 100
    dt: float = 1e-4
    softening: float = 0.05
    g: float = 4.5e-6
    total_mass: float = 1.0
    radial_scale: float = 3.0
    height_scale: float = 0.3
    black_hole_mass: float = 0.01
    n_arms: int = 2
    pitch_angle: float = -float(np.pi) / 6
    arm_strength: float = 0.3
    seed: Optional[int] = None
    force_backend: str = "auto"
    # "bh" ground-truth knobs (core.simulate.SimulationConfig): exact
    # near-set size and partition refresh interval — M=48 measures
    # ~1.8e-3 median force error on spirals, good surrogate ground truth
    bh_near: int = 32
    bh_refresh: int = 1
    # Energy columns (u, k) are exact O(N^2) pairwise PE per recorded step
    # (simulation.py:91-115 semantics). At 1M bodies that is ~5e11 pairs per
    # snapshot. Training datasets don't consume the energy columns, so
    # large-N pipelines switch this off.
    calc_energy: bool = True


def scenario_product(**kwargs) -> List[ScenarioConfig]:
    """Cartesian product over list-valued parameters (s01:93-104)."""
    params = {}
    for key, value in kwargs.items():
        params[key] = value if isinstance(value, (list, tuple)) else [value]
    keys = list(params.keys())
    return [
        ScenarioConfig(**dict(zip(keys, combo)))
        for combo in itertools.product(*(params[k] for k in keys))
    ]


def scenario_key(cfg: ScenarioConfig) -> jax.Array:
    """Per-scene PRNG key. The reference calls ``np.random.seed(seed)``
    inside every generator invocation (galaxies.py:89,224), so the same seed
    reproduces the same galaxy for identical parameters — we mirror that by
    deriving the key from the seed alone (fresh entropy when seed is None)."""
    if cfg.seed is None:
        return jax.random.PRNGKey(np.random.SeedSequence().entropy % (2**31))
    return jax.random.PRNGKey(cfg.seed)


def make_initial_conditions(cfg: ScenarioConfig, key=None):
    """Dispatch to the galaxify generator for this scene (s01:159-188)."""
    if key is None:
        key = scenario_key(cfg)
    common = dict(
        n_bodies=cfg.n_bodies,
        total_mass=cfg.total_mass,
        radial_scale=cfg.radial_scale,
        height_scale=cfg.height_scale,
        g_const=cfg.g,
        black_hole_mass=cfg.black_hole_mass,
    )
    if cfg.sim_type == "disk":
        return GENERATORS["disk"](key, **common)
    if cfg.sim_type == "spiral":
        return GENERATORS["spiral"](
            key,
            **common,
            n_arms=cfg.n_arms,
            pitch_angle=cfg.pitch_angle,
            arm_strength=cfg.arm_strength,
        )
    raise ValueError(f"unknown sim_type {cfg.sim_type!r}")


def run_scenario(cfg: ScenarioConfig, key=None, time_chunks: int = 1):
    """ICs + full on-device rollout. Returns (trajectory, masses,
    step_time) where step_time is in seconds — a scalar (uniform mean) by
    default, or a per-step array when ``time_chunks > 1``.

    Per-step timing semantics (divergence from ``simulation.py:127-129``):
    the reference times every step individually because its loop is already
    synchronous on the host; inside a fused ``lax.scan`` a per-step wall time
    does not exist. With ``time_chunks=1`` every step gets the uniform mean
    (fastest: one dispatch). With ``time_chunks=C`` the rollout runs as C
    sequentially-timed scan segments and each step gets its own chunk's
    honest wall-time mean — per-step granularity at the cost of C dispatches
    (and C host syncs). Consumers of the CSV ``step_time`` column should
    treat it as amortised device time either way."""
    pos, vel, mass = make_initial_conditions(cfg, key)
    sim_cfg = SimulationConfig(
        g_const=cfg.g,
        softening=cfg.softening,
        dt=cfg.dt,
        integrator=cfg.integrator,
        calc_energy=cfg.calc_energy,
        force_backend=cfg.force_backend,
        bh_near=cfg.bh_near,
        bh_refresh=cfg.bh_refresh,
    )
    from nbody_sim.utils.timing import device_time

    if time_chunks <= 1:
        # pre-warm: compile cost must not be charged to step_time — the
        # reference's step 0 pays no such cost (simulation.py:127-129).
        # AOT-compile WITHOUT executing (lower().compile() populates the
        # jit cache), so the scenario runs exactly once.
        simulate.lower(pos, vel, mass, cfg.steps, sim_cfg).compile()
        traj, elapsed = device_time(
            lambda: simulate(pos, vel, mass, cfg.steps, sim_cfg)
        )
        return traj, np.asarray(mass), elapsed / cfg.steps

    bounds = np.linspace(0, cfg.steps, time_chunks + 1).astype(int)
    # pre-compile every distinct chunk length so the first timed chunk isn't
    # charged for compilation (the reference's step 0 pays no such cost);
    # AOT lower().compile() populates the jit cache without executing
    for n_steps in {int(h - l) for l, h in zip(bounds[:-1], bounds[1:]) if h > l}:
        simulate.lower(pos, vel, mass, n_steps, sim_cfg).compile()
    parts, times = [], np.zeros(cfg.steps)
    p, v = pos, vel
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi == lo:
            continue
        part, elapsed = device_time(
            lambda p=p, v=v, n=int(hi - lo): simulate(p, v, mass, n, sim_cfg)
        )
        parts.append(part)
        times[lo:hi] = elapsed / (hi - lo)
        p, v = part.positions[-1], part.velocities[-1]
    traj = Trajectory(
        *(
            None if parts[0][i] is None
            else jnp.concatenate([pt[i] for pt in parts], axis=0)
            for i in range(5)
        )
    )
    return traj, np.asarray(mass), times


def _energy_col(x, s: int) -> np.ndarray:
    """Energy column as (s,) numpy; NaN-filled when not computed."""
    return np.full(s, np.nan, np.float32) if x is None else np.asarray(x)


def trajectory_to_rows(
    scene_id: int, cfg: ScenarioConfig, traj: Trajectory, mass: np.ndarray,
    step_time: float, step_idx: Optional[np.ndarray] = None,
):
    """Vectorised long-format table for one scene: steps x n_bodies rows in
    the reference column order (s01:222-241), as a dict of numpy columns.

    :param step_idx: recorded step numbers (default ``arange``; strided
        datasets pass the original indices so the ``step`` column stays
        honest about simulation time)."""
    s, n = int(traj.positions.shape[0]), cfg.n_bodies
    if step_idx is None:
        step_idx = np.arange(s)
    p = np.asarray(traj.positions).reshape(s * n, 3)
    v = np.asarray(traj.velocities).reshape(s * n, 3)
    a = np.asarray(traj.accelerations).reshape(s * n, 3)
    # calc_energy=False trajectories carry None energies: keep the schema
    # columns (s01:238-239) but fill NaN
    u = np.repeat(_energy_col(traj.u_energy, s), n)
    k = np.repeat(_energy_col(traj.k_energy, s), n)
    st = (
        np.repeat(np.asarray(step_time, np.float64), n)
        if np.ndim(step_time)
        else np.full(s * n, step_time, np.float64)
    )
    return {
        "scene": np.full(s * n, scene_id, np.int64),
        "scene_type": np.full(s * n, cfg.sim_type, object),
        "step": np.repeat(np.asarray(step_idx), n),
        "step_time": st,
        "mass": np.tile(mass, s),
        "x": p[:, 0], "y": p[:, 1], "z": p[:, 2],
        "vx": v[:, 0], "vy": v[:, 1], "vz": v[:, 2],
        "ax": a[:, 0], "ay": a[:, 1], "az": a[:, 2],
        "u": u, "k": k,
    }


def run_scenario_group(cfgs: Sequence[ScenarioConfig], keys=None):
    """Run scenarios that share every static parameter except the seed as ONE
    vmapped computation: ICs and the whole ``lax.scan`` rollout batch over the
    scene axis — one compile and one dispatch for e.g. 100 x 1k-body rollouts.

    :return: list of (trajectory, masses, mean step_time) like
        :func:`run_scenario` (step_time is the batch mean per scene).
    """
    base = cfgs[0]
    assert all(
        dataclasses.replace(c, seed=base.seed) == base for c in cfgs
    ), "group must differ only by seed"
    if keys is None:
        keys = jnp.stack([scenario_key(c) for c in cfgs])

    sim_cfg = SimulationConfig(
        g_const=base.g,
        softening=base.softening,
        dt=base.dt,
        integrator=base.integrator,
        calc_energy=base.calc_energy,
        force_backend=base.force_backend,
        bh_near=base.bh_near,
        bh_refresh=base.bh_refresh,
    )

    def one(key):
        pos, vel, mass = make_initial_conditions(base, key)
        traj = simulate(pos, vel, mass, base.steps, sim_cfg)
        return traj, mass

    from nbody_sim.utils.timing import device_time

    # pre-warm: compile + IC generation must not be charged to step_time
    # (matches run_scenario's two branches and the reference's step-0
    # semantics, simulation.py:127-129)
    jax.block_until_ready(jax.vmap(one)(keys)[0].positions)
    (trajs, masses), elapsed = device_time(lambda: jax.vmap(one)(keys))
    step_time = elapsed / (base.steps * len(cfgs))
    return [
        (
            Trajectory(*(None if x is None else x[i] for x in trajs)),
            np.asarray(masses[i]),
            step_time,
        )
        for i in range(len(cfgs))
    ]


def _group_scenarios(scenarios: Sequence[ScenarioConfig]):
    """Consecutive runs of scenarios identical up to the seed."""
    groups = []
    for scene_id, cfg in enumerate(scenarios):
        if groups and dataclasses.replace(
            cfg, seed=groups[-1][0][1].seed
        ) == groups[-1][0][1]:
            groups[-1].append((scene_id, cfg))
        else:
            groups.append([(scene_id, cfg)])
    return groups


def generate_dataset(
    scenarios: Sequence[ScenarioConfig],
    output: str,
    write_npz: bool = True,
    verbose: bool = True,
    vmap_scenes: bool = True,
    time_chunks: int = 1,
    check: bool = False,
    snapshot_stride: int = 1,
    write_csv_file: bool = True,
) -> None:
    """Run every scenario and write one long-format CSV (s01:106-243), plus an
    ``.npz`` twin (same stem) for fast reload by ``data.dataset``.

    :param vmap_scenes: batch groups of seed-only-differing scenarios into
        one vmapped device computation (big win for sweeps like 100 rollouts
        of the same configuration).
    :param time_chunks: >1 records per-chunk honest wall times into the
        ``step_time`` column instead of the uniform mean (see
        :func:`run_scenario`); disables scene vmapping (chunked timing needs
        sequential dispatches).
    :param check: checkify NaN/Inf guard on every produced trajectory
        (SURVEY.md §5.2) — raises instead of writing corrupt data.
    :param snapshot_stride: record every this-many-th step (always incl.
        step 0; the ``step`` column keeps original indices). The large-N
        training pipeline's knob: a 20k-body x 1000-step scene at stride 1
        is a ~3 GB CSV, at stride 8 a manageable npz.
    :param write_csv_file: False skips the long-format CSV and writes only
        the npz (large-N datasets where per-row CSV is pure overhead)."""
    if time_chunks > 1:
        vmap_scenes = False

    results = {}
    if vmap_scenes:
        for group in _group_scenarios(scenarios):
            ids = [sid for sid, _ in group]
            cfgs = [c for _, c in group]
            if verbose:
                print(
                    f"[scenes {ids[0]}..{ids[-1]}] {cfgs[0].sim_type} "
                    f"n={cfgs[0].n_bodies} steps={cfgs[0].steps} x{len(cfgs)}"
                )
            if len(cfgs) == 1:
                results[ids[0]] = run_scenario(cfgs[0])
            else:
                for sid, res in zip(ids, run_scenario_group(cfgs)):
                    results[sid] = res

    frames = []
    npz_payload = {}
    for scene_id, cfg in enumerate(scenarios):
        if scene_id in results:
            traj, mass, step_time = results[scene_id]
        else:
            if verbose:
                print(
                    f"[{scene_id + 1}/{len(scenarios)}] {cfg.sim_type} n={cfg.n_bodies} "
                    f"steps={cfg.steps} integrator={cfg.integrator} seed={cfg.seed}"
                )
            traj, mass, step_time = run_scenario(cfg, time_chunks=time_chunks)
        if check:
            from nbody_sim.utils.debug import throw_if_nonfinite

            throw_if_nonfinite(
                (traj.positions, traj.velocities, traj.accelerations),
                what=f"scene {scene_id} trajectory",
            )
        step_idx = np.arange(int(traj.positions.shape[0]))
        if snapshot_stride > 1:
            step_idx = step_idx[::snapshot_stride]
            traj = Trajectory(
                *(None if x is None else x[::snapshot_stride] for x in traj)
            )
            if np.ndim(step_time):
                step_time = np.asarray(step_time)[::snapshot_stride]
        if write_csv_file:
            frames.append(trajectory_to_rows(
                scene_id, cfg, traj, mass, step_time, step_idx))
        npz_payload[f"scene{scene_id}_pos"] = np.asarray(traj.positions)
        npz_payload[f"scene{scene_id}_vel"] = np.asarray(traj.velocities)
        npz_payload[f"scene{scene_id}_acc"] = np.asarray(traj.accelerations)
        npz_payload[f"scene{scene_id}_mass"] = mass
        n_snap = int(traj.positions.shape[0])
        npz_payload[f"scene{scene_id}_u"] = _energy_col(traj.u_energy, n_snap)
        npz_payload[f"scene{scene_id}_k"] = _energy_col(traj.k_energy, n_snap)
        npz_payload[f"scene{scene_id}_step"] = step_idx.astype(np.int32)
        npz_payload[f"scene{scene_id}_meta"] = np.array(
            [scene_id, cfg.steps, cfg.n_bodies, float(np.mean(step_time))],
            np.float64,
        )
        if np.ndim(step_time):
            npz_payload[f"scene{scene_id}_step_time"] = np.asarray(step_time)
        npz_payload[f"scene{scene_id}_type"] = np.array(cfg.sim_type)

    if write_csv_file:
        from nbody_sim.data.io_native import write_csv

        write_csv({c: np.concatenate([f[c] for f in frames])
                   for c in CSV_FIELDS}, output)
    if write_npz:
        save_npz_atomic(_npz_path(output), n_scenes=len(scenarios), **npz_payload)


def _npz_path(csv_path: str) -> str:
    return csv_path[:-4] + ".npz" if csv_path.endswith(".csv") else csv_path + ".npz"


def save_npz_atomic(path: str, **payload) -> None:
    """``np.savez_compressed`` via a temp file + ``os.replace``.

    A SIGKILL/timeout mid-write (say, of a multi-GB 1M-body scene that
    ``--skip-datagen`` would later trust) can then never leave a
    half-written file at the final path — readers see either the old file,
    nothing, or the complete new file.
    """
    import os

    # np.savez appends ".npz" to names lacking it, so the temp name must
    # already end in ".npz" to land where os.replace expects it.
    tmp = path + ".tmp.npz"
    try:
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def valid_npz(path: str) -> bool:
    """True iff ``path`` exists and is a structurally complete zip/npz.

    Checks the end-of-central-directory record (cheap — O(1) reads at the
    file tail), which a truncated ``np.savez_compressed`` write never has.
    Used by resume paths (``--skip-datagen``) before trusting an existing
    scene file instead of the reference-style existence-only check.
    """
    import os
    import zipfile

    if not os.path.exists(path):
        return False
    try:
        with zipfile.ZipFile(path) as z:
            return len(z.namelist()) > 0
    except (zipfile.BadZipFile, OSError):
        return False
