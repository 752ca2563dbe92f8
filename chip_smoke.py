#!/usr/bin/env python3
"""Smoke run of the main path on one NVIDIA GPU, at real sizes.

    python chip_smoke.py               # phases 1-3 on one card
    python chip_smoke.py --four-cards  # the sharded paths on four cards

Phases (one card):

1. exact direct sum — 100k-body spiral, 10 leapfrog steps through
   ``simulate(force_backend="auto", calc_energy=True)``; forces, potential
   energy and cross-set energy compared with row-chunked XLA references;
2. treecodes — bh3 at 1M bodies (16 steps), bh2 and bh at 200k (one force
   evaluation each): the kernel engine against its XLA twin, and both
   against the exact kernel on 4096 sampled receivers;
3. datagen — the datagen CLI in-process (500 and 20000 bodies, 100 steps,
   energies on), its CSV and npz read back.

With ``--four-cards`` only the multi-card paths run: ``ring_simulate`` at
262,144 bodies against single-card ``simulate``, and
``sharded_bh3_accelerations`` at 4M bodies against single-card
``bh3_accelerations``.

Everything runs in this one process (a second JAX process on the card would
run out of memory). It exits non-zero, and prints no result line, when JAX
finds no GPU or any check fails. The last line of standard output is one
JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

G, EPS, DT = 4.5e-6, 0.05, 1e-4
N_EXACT = 100_000
N_SAMPLE = 4096


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Checks:
    """Collects named checks; every failure is reported, then fatal."""

    def __init__(self, card_name: str):
        self.card = card_name
        self.failed = []

    def check(self, name: str, ok: bool, detail: str) -> None:
        print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
        if not ok:
            self.failed.append(name)

    def time(self, name: str, seconds: float, extra: str = "") -> None:
        print(f"[time] {name}: {seconds * 1e3:.3f} ms {extra}"
              f"({self.card})", flush=True)


def warm_time(fn, *args, reps: int = 3) -> float:
    """Seconds per call of an already-compiled ``fn``, device-complete."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def rel_l2(a, b) -> float:
    import jax.numpy as jnp

    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


def per_row_rel(a, b):
    import jax.numpy as jnp

    return jnp.linalg.norm(a - b, axis=1) / jnp.maximum(
        jnp.linalg.norm(b, axis=1), 1e-30)


def phase_exact(c: Checks) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nbody_sim.core import forces
    from nbody_sim.core.simulate import (
        SimulationConfig, _resolve_backend, make_acc_fn, simulate)
    from nbody_sim.ics import generate_spiral
    from nbody_sim.ops.pairwise import (
        pallas_cross_potential, pallas_potential_energy)

    cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT,
                           force_backend="auto", calc_energy=True)
    backend = _resolve_backend(cfg, N_EXACT)
    c.check("exact: auto backend", backend == "pallas",
            f"force_backend='auto' resolved to {backend!r}")
    pos, vel, mass = generate_spiral(jax.random.PRNGKey(0), N_EXACT)

    t0 = time.perf_counter()
    traj = jax.block_until_ready(simulate(pos, vel, mass, 10, cfg))
    c.time("exact: simulate 10 steps, first call (compile + run)",
           time.perf_counter() - t0)
    c.check("exact: trajectory shape and finite",
            traj.positions.shape == (10, N_EXACT, 3)
            and bool(jnp.isfinite(traj.positions).all()),
            f"positions {traj.positions.shape}")
    t_sim = warm_time(lambda: simulate(pos, vel, mass, 10, cfg), reps=2)
    c.time("exact: simulate, per step with energies", t_sim / 10)

    # the trajectory's first row against the plain XLA reference
    p0, a0 = traj.positions[0], traj.accelerations[0]
    with jax.default_matmul_precision("highest"):
        ref_acc = jax.jit(forces.chunked_accelerations)(p0, mass, G, EPS)
    rel = rel_l2(a0, ref_acc)
    p999 = float(jnp.quantile(per_row_rel(a0, ref_acc), 0.999))
    c.check("exact: accelerations vs XLA", rel <= 1e-4 and p999 <= 1e-3,
            f"global rel L2 {rel:.3e} (<= 1e-4), p99.9 per-receiver "
            f"{p999:.3e} (<= 1e-3)")

    u_ref = float(jax.jit(forces.chunked_potential_energy)(p0, mass, G, EPS))
    u_k = float(traj.u_energy[0])
    c.check("exact: potential energy vs XLA",
            abs(u_k - u_ref) <= 1e-4 * abs(u_ref),
            f"U kernel {u_k:.9e} vs XLA {u_ref:.9e} "
            f"(rel {abs(u_k - u_ref) / abs(u_ref):.3e} <= 1e-4)")

    half = N_EXACT // 2
    ux_k = float(pallas_cross_potential(p0[:half], mass[:half], p0[half:],
                                        mass[half:], G, EPS))
    ux_ref = float(jax.jit(
        lambda a, ma, b, mb: forces.chunked_potential_energy(
            a, ma, G, EPS, pos_src=b, mass_src=mb))(
        p0[:half], mass[:half], p0[half:], mass[half:]))
    c.check("exact: cross potential vs XLA",
            abs(ux_k - ux_ref) <= 1e-4 * abs(ux_ref),
            f"U_cross kernel {ux_k:.9e} vs XLA {ux_ref:.9e}")

    e = np.asarray(traj.u_energy, np.float64) + np.asarray(traj.k_energy)
    drift = float(np.abs(e - e[0]).max() / abs(e[0]))
    c.check("exact: energy finite", bool(np.isfinite(e).all()),
            f"relative energy drift over 10 steps {drift:.3e}")

    acc_fn = jax.jit(make_acc_fn(mass, cfg))
    t_k = warm_time(acc_fn, p0)
    c.time("exact: force kernel", t_k,
           f"{N_EXACT ** 2 / t_k:.3e} pairs/s ")
    with jax.default_matmul_precision("highest"):
        xla_fn = jax.jit(lambda p: forces.chunked_accelerations(
            p, mass, G, EPS))
        t_x = warm_time(xla_fn, p0, reps=2)
    c.time("exact: XLA chunked forces", t_x,
           f"{N_EXACT ** 2 / t_x:.3e} pairs/s ")
    t_u = warm_time(jax.jit(lambda p: pallas_potential_energy(
        p, mass, G, EPS)), p0)
    c.time("exact: energy kernel", t_u, f"{N_EXACT ** 2 / t_u:.3e} pairs/s ")
    t_ux = warm_time(jax.jit(lambda p: forces.chunked_potential_energy(
        p, mass, G, EPS)), p0, reps=2)
    c.time("exact: XLA chunked energy", t_ux,
           f"{N_EXACT ** 2 / 2 / t_ux:.3e} pairs/s ")


def phase_treecodes(c: Checks) -> None:
    import jax
    import jax.numpy as jnp

    from nbody_sim.core.simulate import SimulationConfig, simulate
    from nbody_sim.ics import generate_spiral
    from nbody_sim.ops import treeforce as tf
    from nbody_sim.ops.pairwise import pallas_partial_accelerations

    def accuracy(name, n, pos, mass, engine):
        """Kernel engine vs its XLA twin, both vs the exact kernel.

        The engines telescope multipole terms that are huge next to the net
        force (a receiver inside a block sees inv^7 ~ eps^-7 ~ 1e9), so
        float32 rounding of those cancellations, taken in another order by
        each engine, leaves ~1e-4 of the net force: hence 1e-3 between the
        engines, against ~1e-2 (the median accuracy tier) vs exact."""
        t0 = time.perf_counter()
        a_k = jax.block_until_ready(engine(pos, "pallas"))
        c.time(f"{name}: first call (compile + run)",
               time.perf_counter() - t0)
        a_x = engine(pos, "xla")
        rel = rel_l2(a_k, a_x)
        c.check(f"{name}: kernel engine vs XLA engine",
                rel <= 1e-3 and bool(jnp.isfinite(a_k).all()),
                f"rel L2 {rel:.3e} (<= 1e-3)")
        idx = jax.random.choice(jax.random.PRNGKey(n), n, (N_SAMPLE,),
                                replace=False)
        exact = pallas_partial_accelerations(pos[idx], pos, mass, G, EPS)
        for impl, a in (("kernel", a_k), ("XLA", a_x)):
            err = per_row_rel(a[idx], exact)
            med = float(jnp.median(err))
            c.check(f"{name}: {impl} engine vs exact on {N_SAMPLE} "
                    "receivers", med <= 1e-2,
                    f"median rel {med:.3e} (<= 1e-2), "
                    f"p99 {float(jnp.quantile(err, 0.99)):.3e}")
        for impl in ("pallas", "xla"):
            t = warm_time(jax.jit(lambda p, impl=impl: engine(p, impl)), pos)
            c.time(f"{name}: force evaluation, {impl}", t)

    # bh3 at 1M, bench recipe: near 48, block 128, coarse 16, rc 48,
    # sub_block 32, n_sub 48, refresh 8
    n = 1_000_000
    pos, vel, mass = generate_spiral(jax.random.PRNGKey(1), n)
    kw3 = dict(n_near=48, block=128, coarse=16, rc=48, sub_block=32,
               n_sub=48)
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT,
                           calc_energy=False, force_backend="bh3",
                           bh_near=48, bh_block=128, bh_coarse=16, bh_rc=48,
                           bh_sub_block=32, bh_n_sub=48, bh_refresh=8)
    t0 = time.perf_counter()
    traj = jax.block_until_ready(simulate(pos, vel, mass, 16, cfg))
    c.time("bh3 1M: simulate 16 steps, first call (compile + run)",
           time.perf_counter() - t0)
    c.check("bh3 1M: rollout finite",
            bool(jnp.isfinite(traj.positions[-1]).all()),
            f"positions {traj.positions.shape}")
    t = warm_time(lambda: simulate(pos, vel, mass, 16, cfg), reps=1)
    c.time("bh3 1M: simulate, per step", t / 16)
    part = tf.build_bh3_partition(pos, mass, **kw3)
    accuracy("bh3 1M", n, pos, mass, lambda p, impl: tf.bh3_accelerations(
        p, mass, G, EPS, partition=part, near_impl=impl))
    del pos, vel, mass, traj, part

    n = 200_000
    pos, _, mass = generate_spiral(jax.random.PRNGKey(2), n)
    # bh2 bench recipe: block 128, coarse 16, rc 48 (near 32)
    part2 = tf.build_bh2_partition(pos, mass, n_near=32, block=128,
                                   coarse=16, rc=48)
    accuracy("bh2 200k", n, pos, mass, lambda p, impl: tf.bh2_accelerations(
        p, mass, G, EPS, partition=part2, near_impl=impl))

    # the grouped far-field kernel alone against its XLA twin, at bh2's
    # level-2 shape: each superblock's rows vs its refined fine blocks
    spos, sm = tf._gather_sorted(pos, mass, part2.base)
    nb, nbc = part2.near.shape[0], part2.refined.shape[0]
    coarse = nb // nbc
    _, _, msum, com, quad = tf._block_moments(spos, sm, nb, 128)
    blk = tf._blk_rows(com, msum, quad)
    fine = (part2.refined[:, :, None] * coarse
            + jnp.arange(coarse)[None, None, :]).reshape(nbc, -1)
    qg = spos.reshape(nbc, coarse * 128, 3)
    grp_k = jax.jit(lambda q: tf._grouped_mult(q, blk, fine, G, EPS ** 2,
                                               True, False))
    grp_x = jax.jit(lambda q: tf._grouped_mult(q, blk, fine, G, EPS ** 2,
                                               False, False))
    rel = rel_l2(grp_k(qg), grp_x(qg))
    c.check(f"grouped multipole kernel vs XLA ({nbc} groups x "
            f"{coarse * 128} rows x {fine.shape[1]} blocks)", rel <= 1e-4,
            f"rel L2 {rel:.3e} (<= 1e-4)")
    c.time("grouped multipole kernel", warm_time(grp_k, qg))
    c.time("grouped multipole XLA", warm_time(grp_x, qg))
    part1 = tf.build_bh_partition(pos, mass, n_near=32, block=256)
    accuracy("bh 200k", n, pos, mass, lambda p, impl: tf.bh_accelerations(
        p, mass, G, EPS, partition=part1, near_impl=impl))

    # the far-field kernel alone against its XLA twin at the bh shape
    spos, sm = tf._gather_sorted(pos, mass, part1)
    nb = part1.near.shape[0]
    _, _, msum, com, quad = tf._block_moments(spos, sm, nb, 256)
    q = spos[:n]
    far_k = jax.jit(lambda q: tf.pallas_multipole_acc(
        q, com, msum, quad, G, EPS ** 2))
    far_x = jax.jit(lambda q: jax.lax.map(
        lambda r: tf._multipole_acc(r, com, msum, quad, G, EPS ** 2),
        q.reshape(-1, 1000, 3)).reshape(-1, 3))
    rel = rel_l2(far_k(q), far_x(q))
    c.check("multipole kernel vs XLA (200k receivers x 782 blocks)",
            rel <= 1e-4, f"rel L2 {rel:.3e} (<= 1e-4)")
    c.time("multipole kernel", warm_time(far_k, q))
    c.time("multipole XLA", warm_time(far_x, q))


def phase_datagen(c: Checks, sizes=(500, 20_000), steps=100) -> None:
    import numpy as np

    from nbody_sim.cli import datagen
    from nbody_sim.data.schema import CSV_FIELDS

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "smoke.csv")
        t0 = time.perf_counter()
        datagen.main(["--n-bodies", *map(str, sizes), "--steps", str(steps),
                      "--sim-type", "spiral", "--integrator", "leapfrog",
                      "--seed", "0", "--output", out])
        c.time(f"datagen: scenes {sizes} x {steps} steps, CSV + npz",
               time.perf_counter() - t0)
        npz = np.load(out[:-4] + ".npz")
        shapes_ok = all(
            npz[f"scene{s}_pos"].shape == (steps, n, 3)
            and np.isfinite(npz[f"scene{s}_u"]).all()
            for s, n in enumerate(sizes))
        c.check("datagen: npz shapes and energies", shapes_ok,
                ", ".join(str(npz[f"scene{s}_pos"].shape)
                          for s in range(len(sizes))))
        with open(out) as f:
            header = f.readline().strip().split(",")
        cols = np.loadtxt(out, delimiter=",", skiprows=1,
                          usecols=[CSV_FIELDS.index("x"),
                                   CSV_FIELDS.index("u")])
        rows = steps * sum(sizes)
        x_npz = np.concatenate([npz[f"scene{s}_pos"][..., 0].ravel()
                                for s in range(len(sizes))])
        c.check("datagen: CSV read back",
                header == CSV_FIELDS and cols.shape == (rows, 2)
                and np.allclose(cols[:, 0], x_npz, rtol=1e-6, atol=1e-9),
                f"{cols.shape[0]} rows (expect {rows}), x column matches npz")


def phase_four_cards(c: Checks, n_ring=262_144, n_bh=4_000_000) -> None:
    import jax
    import jax.numpy as jnp

    from nbody_sim.core.simulate import SimulationConfig, simulate
    from nbody_sim.ics import generate_spiral
    from nbody_sim.ops.treeforce import bh3_accelerations
    from nbody_sim.parallel.bh import sharded_bh3_accelerations
    from nbody_sim.parallel.mesh import make_mesh
    from nbody_sim.ops.pairwise import pallas_accelerations
    from nbody_sim.parallel.ring import ring_accelerations, ring_simulate

    mesh = make_mesh(4)
    n, steps = n_ring, 4
    pos, vel, mass = generate_spiral(jax.random.PRNGKey(3), n)
    t0 = time.perf_counter()
    (p_r, v_r, a_r), _ = ring_simulate(pos, vel, mass, steps, G, EPS, DT, mesh,
                                     backend="pallas")
    jax.block_until_ready(p_r)
    c.time(f"ring {n}: 4 steps, first call", time.perf_counter() - t0)
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT,
                           force_backend="pallas", calc_energy=False)
    traj = simulate(pos, vel, mass, steps, cfg)
    rel_a = rel_l2(jnp.asarray(a_r), traj.accelerations[-1])
    rel_p = rel_l2(jnp.asarray(p_r) - pos, traj.positions[-1] - pos)
    c.check(f"ring {n} vs one-card simulate",
            rel_a <= 1e-5 and rel_p <= 1e-5,
            f"final accelerations rel L2 {rel_a:.3e}, displacements rel L2 "
            f"{rel_p:.3e} (<= 1e-5)")
    # ring_simulate traces a new program per call, so time the sharded force
    # evaluation itself, beside the one-card kernel at the same N
    ring_acc = jax.jit(lambda p: ring_accelerations(p, mass, G, EPS, mesh,
                                                    backend="pallas"))
    c.time(f"ring {n}: force evaluation on 4 cards", warm_time(ring_acc, pos))
    one_acc = jax.jit(lambda p: pallas_accelerations(p, mass, G, EPS))
    c.time(f"exact {n}: force evaluation on 1 card", warm_time(one_acc, pos))
    del pos, vel, mass, traj

    n = n_bh
    kw = dict(n_near=48, block=128, coarse=16, rc=48, sub_block=32,
              n_sub=48)
    pos, _, mass = generate_spiral(jax.random.PRNGKey(4), n)
    t0 = time.perf_counter()
    a_s = jax.block_until_ready(
        sharded_bh3_accelerations(pos, mass, G, EPS, mesh, **kw))
    c.time(f"sharded bh3 {n}: first call", time.perf_counter() - t0)
    a_1 = bh3_accelerations(pos, mass, G, EPS, **kw)
    rel = rel_l2(jnp.asarray(a_s), a_1)
    c.check(f"sharded bh3 {n} vs one-card bh3", rel <= 1e-5,
            f"rel L2 {rel:.3e} (<= 1e-5)")
    c.time(f"sharded bh3 {n}: force evaluation on 4 cards", warm_time(
        lambda: sharded_bh3_accelerations(pos, mass, G, EPS, mesh, **kw)))
    c.time(f"bh3 {n}: force evaluation on 1 card", warm_time(
        jax.jit(lambda p: bh3_accelerations(p, mass, G, EPS, **kw)), pos))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-card paths, on four cards")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    want = 4 if args.four_cards else 1
    if devices[0].platform != "gpu" or len(devices) < want:
        print(f"chip_smoke: needs {want} GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform} device(s)",
              file=sys.stderr)
        return 2

    from nbody_sim.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    c = Checks(card())
    print(f"card: {c.card}", flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}",
          flush=True)
    phases = ([phase_four_cards] if args.four_cards
              else [phase_exact, phase_treecodes, phase_datagen])
    for phase in phases:
        t0 = time.perf_counter()
        phase(c)
        c.time(f"phase {phase.__name__}", time.perf_counter() - t0)
    if c.failed:
        print(f"chip_smoke: {len(c.failed)} check(s) failed: "
              f"{', '.join(c.failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
