"""Long-horizon Barnes-Hut rollout evidence: 1000 leapfrog steps at 100k
bodies with exact start/end energy audit (``results/large_scale/bh_rollout.json``).

The reference's ground-truth engine caps at ~10^4 bodies (dense O(N^2),
CPU); this demonstrates production-scale classical rollouts on one device
with the approximate engine, audited by the *exact* energy kernels.

Usage (on the GPU):
    python -m nbody_sim.experiments.bh_rollout --n-bodies 100000 \
        --steps 1000 --out results/large_scale/bh_rollout.json
"""

from __future__ import annotations

import argparse
import json
import os

import jax
import jax.numpy as jnp

from nbody_sim.core.simulate import SimulationConfig, simulate
from nbody_sim.ics import generate_spiral
from nbody_sim.ops.pairwise import pallas_potential_energy
from nbody_sim.core.forces import kinetic_energy
from nbody_sim.utils.compile_cache import enable_persistent_cache
from nbody_sim.utils.timing import device_time

G, EPS, DT = 4.5e-6, 0.05, 1e-4


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-bodies", type=int, default=100_000)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--bh-near", type=int, default=32)
    p.add_argument("--block", type=int, default=256,
                   help="fine Morton block size (128 is the measured 1M "
                        "bh2 recipe: halved near volume per particle)")
    p.add_argument("--bh-refresh", type=int, default=8)
    p.add_argument("--engine", default="bh", choices=["bh", "bh2", "bh3"],
                   help="bh2 = two-level coarse far field (the 1M+ "
                        "engine); bh3 = bh2 with the sub-refined "
                        "(Verlet-list) near pass")
    p.add_argument("--coarse", type=int, default=16)
    p.add_argument("--rc", type=int, default=32)
    p.add_argument("--sub-block", type=int, default=32,
                   help="bh3: rows per near-pass sub-block")
    p.add_argument("--n-sub", type=int, default=24,
                   help="bh3: sub-blocks evaluated exactly per receiver "
                        "block")
    p.add_argument("--chunk-steps", type=int, default=0,
                   help="run the rollout as ceil(steps/chunk) sequential "
                        "scans carrying only the end state between chunks "
                        "- REQUIRED above ~300k bodies where the stacked "
                        "(steps, N, 3) trajectory exceeds device memory "
                        "(1M x 1000 "
                        "steps would be 36 GB)")
    p.add_argument("--no-energy-audit", action="store_true",
                   help="skip the exact O(N^2) endpoint energy audit "
                        "(5e13 pairs at 10M); reports a sampled endpoint "
                        "force error instead")
    p.add_argument("--chunked-energy-audit", type=int, default=0,
                   metavar="ROWS",
                   help="compute the exact endpoint PE in ~ROWS-row "
                        "block-triangle chunks (ops.pairwise."
                        "chunked_potential_energy) — the only way to run "
                        "the full 5e13-pair audit at 10M, where one "
                        "triangular launch is a multi-minute execution. "
                        "Composable "
                        "with --no-energy-audit=false only; implies the "
                        "sampled force audit stays off")
    p.add_argument("--error-sample", type=int, default=4096,
                   help="receivers for the sampled endpoint force audit "
                        "when --no-energy-audit is set")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    enable_persistent_cache()

    pos, vel, mass = generate_spiral(jax.random.PRNGKey(0), args.n_bodies)
    jax.block_until_ready(pos)

    def exact_energy(p_, v_):
        if args.no_energy_audit:
            return 0.0, 0.0
        if args.chunked_energy_audit:
            from nbody_sim.ops.pairwise import chunked_potential_energy

            u = chunked_potential_energy(
                p_, mass, G, EPS, chunk=args.chunked_energy_audit)
        else:
            u = pallas_potential_energy(p_, mass, G, EPS)
        return float(u), float(kinetic_energy(v_, mass))

    u0, k0 = exact_energy(pos, vel)
    cfg = SimulationConfig(
        g_const=G, softening=EPS, dt=DT, integrator="leapfrog",
        calc_energy=False, force_backend=args.engine, bh_near=args.bh_near,
        bh_block=args.block, bh_refresh=args.bh_refresh,
        bh_coarse=args.coarse, bh_rc=args.rc,
        bh_sub_block=args.sub_block, bh_n_sub=args.n_sub,
    )
    if args.chunk_steps:
        import time as _time

        n_chunks = -(-args.steps // args.chunk_steps)
        # AOT-compile the chunk program without executing, then time the
        # sequential chunk chain (state carried, trajectories discarded)
        simulate.lower(pos, vel, mass, args.chunk_steps, cfg).compile()
        t0 = _time.perf_counter()
        p_end, v_end = pos, vel
        for _ in range(n_chunks):
            t = simulate(p_end, v_end, mass, args.chunk_steps, cfg)
            p_end, v_end = t.positions[-1], t.velocities[-1]
        jax.block_until_ready(p_end)
        elapsed = _time.perf_counter() - t0
        args.steps = n_chunks * args.chunk_steps
    else:
        # warm compile, then the timed run (device_time stops the clock
        # only once the result is ready — see utils.timing)
        jax.block_until_ready(simulate(pos, vel, mass, args.steps, cfg).positions[-1])
        traj, elapsed = device_time(
            lambda: simulate(pos, vel, mass, args.steps, cfg))
        p_end = traj.positions[-1]
        v_end = traj.velocities[-1]
    u1, k1 = exact_energy(p_end, v_end)
    e0, e1 = u0 + k0, u1 + k1
    audit = {}
    if args.no_energy_audit:
        # sampled endpoint force audit: S receivers vs ALL sources, O(S*N)
        # (self-pairs contribute zero force — no exclusion needed)
        from nbody_sim.ops.pairwise import pallas_partial_accelerations

        n, s = args.n_bodies, args.error_sample
        idx = jax.random.choice(jax.random.PRNGKey(42), n, (s,),
                                replace=False)
        n_pad = -(-n // 1024) * 1024
        pos_p = jnp.pad(p_end, ((0, n_pad - n), (0, 0)))
        mass_p = jnp.pad(mass, (0, n_pad - n))
        exact = jax.jit(lambda q, pj, mj: pallas_partial_accelerations(
            q, pj, mj, G, EPS
        ))(p_end[idx], pos_p, mass_p)
        from nbody_sim.ops.treeforce import (bh2_accelerations,
                                             bh3_accelerations,
                                             bh_accelerations)
        if args.engine == "bh3":
            approx = bh3_accelerations(
                p_end, mass, G, EPS, n_near=args.bh_near, block=args.block,
                coarse=args.coarse, rc=args.rc, sub_block=args.sub_block,
                n_sub=args.n_sub)[idx]
        elif args.engine == "bh2":
            approx = bh2_accelerations(
                p_end, mass, G, EPS, n_near=args.bh_near, block=args.block,
                coarse=args.coarse, rc=args.rc)[idx]
        else:
            approx = bh_accelerations(
                p_end, mass, G, EPS, n_near=args.bh_near,
                block=args.block)[idx]
        rel = jnp.linalg.norm(approx - exact, axis=-1) / (
            jnp.linalg.norm(exact, axis=-1) + 1e-30)
        audit = {"error_sample": s,
                 "end_rel_err_median": float(jnp.median(rel)),
                 "end_rel_err_p99": float(jnp.percentile(rel, 99))}
    row = {
        "n": args.n_bodies, "steps": args.steps, "dt": DT,
        "engine": args.engine,
        "bh_near": args.bh_near, "block": args.block,
        "bh_refresh": args.bh_refresh,
        **({"coarse": args.coarse, "rc": args.rc}
           if args.engine in ("bh2", "bh3") else {}),
        **({"sub_block": args.sub_block, "n_sub": args.n_sub}
           if args.engine == "bh3" else {}),
        **({"chunked_energy_audit": args.chunked_energy_audit}
           if args.chunked_energy_audit else {}),
        **({"chunk_steps": args.chunk_steps} if args.chunk_steps else {}),
        "wall_s": round(elapsed, 3),
        "ms_per_step": round(elapsed / args.steps * 1e3, 3),
        "psteps_per_s": args.n_bodies * args.steps / elapsed,
        **({} if args.no_energy_audit else {
            "E0": e0, "E1": e1,
            "rel_energy_drift": abs(e1 - e0) / abs(e0)}),
        **audit,
        "device": jax.devices()[0].platform,
    }
    print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
