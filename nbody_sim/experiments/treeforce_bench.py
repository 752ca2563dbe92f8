"""Block-multipole (Barnes-Hut-lite) vs exact direct-sum force timing and
accuracy — the beyond-parity large-N classical-force artifact
(``results/large_scale/bh.json``).

For each N: time the exact all-pairs kernel, the BH force with a
fresh partition every call, and the BH force under a reused (stale-capable)
partition — the ``graph_refresh`` economics — plus force accuracy vs exact.

Usage (on the GPU):
    python -m nbody_sim.experiments.treeforce_bench \
        --n-bodies 20000 50000 100000 200000 \
        --out results/large_scale/bh.json
"""

from __future__ import annotations

import argparse
import json
import os

import jax
import jax.numpy as jnp

from nbody_sim.ics import generate_spiral
from nbody_sim.ops.pairwise import pallas_accelerations
from nbody_sim.ops.treeforce import (bh2_accelerations, bh_accelerations,
                                     build_bh2_partition, build_bh_partition)
from nbody_sim.utils.compile_cache import enable_persistent_cache

G, EPS = 4.5e-6, 0.05


def _timed_chain(fn, x0, reps):
    """Async-dispatch timing: queue ``reps`` calls and sync once — the
    device executes launches in order, so the wall time is reps x device
    time + one sync, without compiling a separate scan program per
    config."""
    import time

    jax.block_until_ready(fn(x0))  # compile + warm
    t0 = time.perf_counter()
    outs = [fn(x0) for _ in range(reps)]
    jax.block_until_ready(outs[-1])
    return (time.perf_counter() - t0) / reps


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-bodies", type=int, nargs="+",
                   default=[20_000, 50_000, 100_000, 200_000])
    p.add_argument("--n-near", type=int, default=32)
    p.add_argument("--block", type=int, default=256)
    p.add_argument("--i-chunk", type=int, default=8)
    p.add_argument("--engine", default="bh", choices=["bh", "bh2", "bh3"],
                   help="bh2 = two-level coarse far field "
                        "(O(N*(M*B + N/(C*B) + rc*C)) — the 1M+ engine); "
                        "bh3 = bh2 with the sub-refined (Verlet-list) near "
                        "pass: K*Bs exact pairs instead of M*B")
    p.add_argument("--coarse", type=int, default=16,
                   help="bh2/bh3: fine blocks per superblock")
    p.add_argument("--rc", type=int, default=32,
                   help="bh2/bh3: refined superblocks per receiver group")
    p.add_argument("--sub-block", type=int, default=32,
                   help="bh3: rows per near-pass sub-block")
    p.add_argument("--n-sub", type=int, default=24,
                   help="bh3: sub-blocks evaluated exactly per receiver "
                        "block")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--exact-cap", type=int, default=100_000,
                   help="skip the exact timing above this N")
    p.add_argument("--error-cap", type=int, default=None,
                   help="compute force-error tiers (ONE exact eval, no "
                        "timing chain) up to this N; default = exact-cap")
    p.add_argument("--error-sample", type=int, default=0,
                   help="above error-cap: sample this many receivers and "
                        "grade them against an exact partial force eval "
                        "(O(S*N) — the only affordable exact evidence at "
                        "10M, where the full audit is 5e13 pairs)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    enable_persistent_cache()

    rows = []
    for n in args.n_bodies:
        pos, _, mass = generate_spiral(jax.random.PRNGKey(0), n)
        jax.block_until_ready(pos)
        row = {"n": n, "n_near": args.n_near, "block": args.block}

        error_cap = args.error_cap or args.exact_cap
        if n <= args.exact_cap:
            el = _timed_chain(
                lambda p_: pallas_accelerations(p_, mass, G, EPS), pos,
                args.reps)
            row["exact_ms"] = el * 1e3

        if args.engine == "bh3":
            from nbody_sim.ops.treeforce import (bh3_accelerations,
                                                 build_bh3_partition)

            row.update(coarse=args.coarse, rc=args.rc,
                       sub_block=args.sub_block, n_sub=args.n_sub)

            def fresh(p_):
                return bh3_accelerations(
                    p_, mass, G, EPS, n_near=args.n_near, block=args.block,
                    coarse=args.coarse, rc=args.rc,
                    sub_block=args.sub_block, n_sub=args.n_sub,
                    i_chunk=args.i_chunk)

            part = build_bh3_partition(
                pos, mass, n_near=args.n_near, block=args.block,
                coarse=args.coarse, rc=args.rc, sub_block=args.sub_block,
                n_sub=args.n_sub)

            def reused(p_):
                return bh3_accelerations(
                    p_, mass, G, EPS, partition=part, i_chunk=args.i_chunk)

            def build(p_):
                return build_bh3_partition(
                    p_, mass, n_near=args.n_near, block=args.block,
                    coarse=args.coarse, rc=args.rc,
                    sub_block=args.sub_block, n_sub=args.n_sub).near
        elif args.engine == "bh2":
            row.update(coarse=args.coarse, rc=args.rc)

            def fresh(p_):
                return bh2_accelerations(
                    p_, mass, G, EPS, n_near=args.n_near, block=args.block,
                    coarse=args.coarse, rc=args.rc, i_chunk=args.i_chunk)

            part = build_bh2_partition(
                pos, mass, n_near=args.n_near, block=args.block,
                coarse=args.coarse, rc=args.rc)

            def reused(p_):
                return bh2_accelerations(
                    p_, mass, G, EPS, partition=part, i_chunk=args.i_chunk)

            def build(p_):
                return build_bh2_partition(
                    p_, mass, n_near=args.n_near, block=args.block,
                    coarse=args.coarse, rc=args.rc).near
        else:
            def fresh(p_):
                return bh_accelerations(
                    p_, mass, G, EPS, n_near=args.n_near, block=args.block,
                    i_chunk=args.i_chunk)

            part = build_bh_partition(pos, mass, n_near=args.n_near,
                                      block=args.block)

            def reused(p_):
                return bh_accelerations(
                    p_, mass, G, EPS, partition=part, i_chunk=args.i_chunk)

            def build(p_):
                return build_bh_partition(
                    p_, mass, n_near=args.n_near, block=args.block).near

        el = _timed_chain(fresh, pos, args.reps)
        row["bh_fresh_ms"] = el * 1e3

        el = _timed_chain(reused, pos, args.reps)
        row["bh_reused_ms"] = el * 1e3

        # same amortized protocol as the force timings so the columns are
        # comparable
        el = _timed_chain(build, pos, args.reps)
        row["partition_ms"] = el * 1e3

        if n <= error_cap:
            exact = pallas_accelerations(pos, mass, G, EPS)
            approx = fresh(pos)
        elif args.error_sample:
            # sampled exact: S receivers vs ALL sources, O(S*N). Self-pairs
            # need no exclusion (zero displacement => zero force). Sources
            # zero-mass-padded to the tile multiple (the low-level kernel
            # does no padding).
            from nbody_sim.ops.pairwise import pallas_partial_accelerations

            s = args.error_sample
            idx = jax.random.choice(
                jax.random.PRNGKey(42), n, (s,), replace=False)
            n_pad = -(-n // 1024) * 1024
            pos_p = jnp.pad(pos, ((0, n_pad - n), (0, 0)))
            mass_p = jnp.pad(mass, (0, n_pad - n))
            exact = jax.jit(lambda q, pj, mj: pallas_partial_accelerations(
                q, pj, mj, G, EPS
            ))(pos[idx], pos_p, mass_p)
            approx = fresh(pos)[idx]
            row["error_sample"] = s
        else:
            exact = None
        if exact is not None:
            err = jnp.linalg.norm(approx - exact, axis=-1)
            mag = jnp.linalg.norm(exact, axis=-1)
            rel = err / (mag + 1e-30)
            row["rel_err_median"] = float(jnp.median(rel))
            row["rel_err_p99"] = float(jnp.percentile(rel, 99))
            row["err_over_rms_p99"] = float(
                jnp.percentile(err / jnp.sqrt(jnp.mean(mag**2)), 99))
            if "exact_ms" in row:
                row["speedup_fresh"] = row["exact_ms"] / row["bh_fresh_ms"]
                row["speedup_reused"] = row["exact_ms"] / row["bh_reused_ms"]
        rows.append(row)
        print(json.dumps(row), flush=True)

        # rewrite the artifact after EVERY row: a timeout mid-sweep must not
        # lose the rows already measured
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"device": jax.devices()[0].platform,
                           "reps": args.reps, "rows": rows}, f, indent=1)
    if args.out:
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
