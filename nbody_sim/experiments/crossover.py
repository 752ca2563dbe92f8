"""Direct-sum vs surrogate crossover sweep — the economics behind the
surrogate's large-N reason to exist (reference anchor: the surrogates'
O(N·k) pitch vs ``simulation.py:80-88``'s O(N^2)).

For each N: time the direct-sum leapfrog step and the surrogate
rollout step (on-device kNN rebuild via the Morton search + GNN forward),
both as multi-step scans with honest drained timing.

Usage (on the GPU):
    python -m nbody_sim.experiments.crossover \
        --n-bodies 10000 20000 50000 100000 \
        --out results/large_scale/crossover.json
"""

from __future__ import annotations

import argparse
import json
import os

import jax
import jax.numpy as jnp

from nbody_sim.core.simulate import SimulationConfig, simulate
from nbody_sim.ics import generate_spiral
from nbody_sim.models import GraphModel
from nbody_sim.train.graphs import build_graph
from nbody_sim.train.rollout import autoregressive_rollout
from nbody_sim.utils.timing import device_time

G, EPS, DT = 4.5e-6, 0.05, 1e-4


def _timed(fn):
    out = fn()
    device_time(lambda: out)  # drain compile+warm completely
    _, el = device_time(fn)
    return el


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-bodies", type=int, nargs="+",
                   default=[10_000, 20_000, 50_000, 100_000])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--neighbors", type=int, default=10)
    p.add_argument("--graph-refresh", type=int, nargs="+", default=[1, 8])
    p.add_argument("--knn-copies", type=int, default=4,
                   help="morton curve copies (speed/recall tradeoff)")
    p.add_argument("--knn-block", type=int, default=256,
                   help="morton block rows")
    p.add_argument("--no-fused", action="store_true",
                   help="disable the restructured EdgeConv forward")
    p.add_argument("--bh", action="store_true",
                   help="also time a Barnes-Hut-lite rollout "
                        "(force_backend='bh', bh_refresh=8)")
    p.add_argument("--bh2", action="store_true",
                   help="also time the two-level engine (1M recipe: "
                        "B=128, C=16, rc=48, refresh=8)")
    p.add_argument("--bh3", action="store_true",
                   help="also time the sub-refined (Verlet-list) engine")
    p.add_argument("--bh-near", type=int, default=32)
    p.add_argument("--rc", type=int, default=48)
    p.add_argument("--n-sub", type=int, default=24,
                   help="bh3: exact sub-blocks per receiver block")
    p.add_argument("--load-params", default=None,
                   help="time the GNN surrogate with these trained weights "
                        "(msgpack from train_large) instead of random init; "
                        "rows record which model was timed either way — "
                        "throughput is params-independent but the claim "
                        "should name the model")
    p.add_argument("--only", nargs="+", default=None,
                   choices=["direct", "surrogate", "bh", "bh2", "bh3"],
                   help="restrict to these modes (e.g. --only bh to extend "
                        "an existing artifact one compile at a time)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    modes = set(args.only or ["direct", "surrogate"]
                + (["bh"] if args.bh else [])
                + (["bh2"] if args.bh2 else [])
                + (["bh3"] if args.bh3 else []))
    rows = []

    # when an artifact already exists, load it ONCE up front so the
    # incremental rewrites below merge against it instead of clobbering it
    # after the first row — a mid-sweep crash must never shrink the artifact
    # (same (n, mode) rows are still replaced by the fresh measurement)
    old_rows = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            old = json.load(f)
        if old.get("steps") != args.steps:
            if args.only:
                raise SystemExit(
                    f"{args.out} was measured with steps={old.get('steps')}; "
                    f"rerun with --steps {old.get('steps')} or a fresh --out "
                    "(mixing scan lengths in one artifact is misleading)")
            # full sweep at a new scan length: deliberate re-measurement,
            # start from scratch rather than mixing scan lengths
        else:
            old_rows = old["rows"]

    def _write():
        """Rewrite the artifact after every row: a timeout mid-sweep (each
        1M engine mode is a multi-minute compile) must not lose the rows
        already measured. New rows replace same (n, mode) in the old
        artifact."""
        if not args.out:
            return
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

        fresh = {(r["n"], r["mode"]) for r in rows}
        merged = [r for r in old_rows
                  if (r["n"], r["mode"]) not in fresh] + rows
        merged.sort(key=lambda r: (r["n"], r["mode"]))
        with open(args.out, "w") as f:
            json.dump({"device": jax.devices()[0].platform,
                       "steps": args.steps, "rows": merged}, f, indent=1)
    for n in args.n_bodies:
        pos, vel, mass = generate_spiral(jax.random.PRNGKey(0), n)
        jax.block_until_ready(pos)
        if "direct" in modes:
            cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT,
                                   calc_energy=False, force_backend="auto")
            el = _timed(lambda: simulate(pos, vel, mass, args.steps, cfg))
            rows.append({"n": n, "mode": "direct",
                         "ms_per_step": el / args.steps * 1e3,
                         "psteps_per_s": n * args.steps / el})
            print(json.dumps(rows[-1]), flush=True)
            _write()

        if "bh" in modes:
            cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT,
                                   calc_energy=False, force_backend="bh",
                                   bh_near=args.bh_near, bh_refresh=8)
            el = _timed(lambda: simulate(pos, vel, mass, args.steps, cfg))
            rows.append({"n": n, "mode": f"bh(M={args.bh_near},refresh=8)",
                         "ms_per_step": el / args.steps * 1e3,
                         "psteps_per_s": n * args.steps / el})
            print(json.dumps(rows[-1]), flush=True)
            _write()

        if "bh2" in modes:
            cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT,
                                   calc_energy=False, force_backend="bh2",
                                   bh_near=args.bh_near, bh_block=128,
                                   bh_coarse=16, bh_rc=args.rc,
                                   bh_refresh=8)
            el = _timed(lambda: simulate(pos, vel, mass, args.steps, cfg))
            rows.append({"n": n,
                         "mode": f"bh2(M={args.bh_near},B=128,rc={args.rc},"
                                 "refresh=8)",
                         "ms_per_step": el / args.steps * 1e3,
                         "psteps_per_s": n * args.steps / el})
            print(json.dumps(rows[-1]), flush=True)
            _write()

        if "bh3" in modes:
            cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT,
                                   calc_energy=False, force_backend="bh3",
                                   bh_near=args.bh_near, bh_block=128,
                                   bh_coarse=16, bh_rc=args.rc,
                                   bh_sub_block=32, bh_n_sub=args.n_sub,
                                   bh_refresh=8)
            el = _timed(lambda: simulate(pos, vel, mass, args.steps, cfg))
            rows.append({"n": n,
                         "mode": f"bh3(M={args.bh_near},B=128,rc={args.rc},"
                                 f"K={args.n_sub},refresh=8)",
                         "ms_per_step": el / args.steps * 1e3,
                         "psteps_per_s": n * args.steps / el})
            print(json.dumps(rows[-1]), flush=True)
            _write()

        if "surrogate" not in modes:
            continue
        model = GraphModel(
            input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
            neighbors=args.neighbors, scale_factor=1e6, knn_method="morton",
            knn_copies=args.knn_copies,
            knn_block=args.knn_block, fused_edgeconv=not args.no_fused,
        )
        x0 = jnp.concatenate([pos, vel, mass[:, None]], -1)[None]
        idx, valid = build_graph(model.graph_spec, x0[..., :3])
        variables = jax.jit(model.init)(jax.random.PRNGKey(1), x0, idx, valid)
        if args.load_params:
            from flax import serialization

            with open(args.load_params, "rb") as f:
                variables = serialization.from_bytes(variables, f.read())
            params_tag = args.load_params
        else:
            params_tag = "random-init (timing-only; params-independent)"
        for r in args.graph_refresh:
            el = _timed(lambda r=r: autoregressive_rollout(
                model, variables, pos, vel, mass, args.steps + 1, DT,
                graph_refresh=r,
            ))
            rows.append({"n": n, "mode": f"surrogate(refresh={r})",
                         "ms_per_step": el / args.steps * 1e3,
                         "psteps_per_s": n * args.steps / el,
                         "params": params_tag})
            print(json.dumps(rows[-1]), flush=True)
            _write()

    if args.out:
        print(f"wrote {args.out}")


if __name__ == "__main__":
    from nbody_sim.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    main()
