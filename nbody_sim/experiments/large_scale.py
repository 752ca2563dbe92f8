"""Large-scale demo/benchmark: 100k-body direct-sum vs surrogate rollout
(BASELINE.json config 5: "100k-body Pallas direct-sum vs surrogate hybrid
long-horizon rollout").

- ``direct``: Pallas tiled direct summation under ``lax.scan`` — the exact
  physics at O(N^2).
- ``surrogate``: a GraphModel force surrogate rolled out autoregressively —
  O(N k) force cost once the kNN build is paid (the crossover motivation).
- ``hybrid``: direct-sum for the first ``--hybrid-warmup`` steps (exact early
  dynamics), then the surrogate continues the long horizon.

Usage:
    python -m nbody_sim.experiments.large_scale --n-bodies 100000 --steps 20 \
        [--weights gnn_weights]   # omit to use an untrained surrogate (perf demo)

Prints one JSON line per mode with throughput and, when the direct rollout is
also run, the surrogate's drift vs the exact trajectory.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from nbody_sim.core.simulate import SimulationConfig, simulate
from nbody_sim.ics import generate_spiral
from nbody_sim.models import GraphModel
from nbody_sim.train.graphs import build_graph
from nbody_sim.train.rollout import autoregressive_rollout
from nbody_sim.utils.timing import device_time

G, EPS, DT = 4.5e-6, 0.05, 1e-4


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-bodies", type=int, default=100_000)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--hybrid-warmup", type=int, default=5)
    p.add_argument("--neighbors", type=int, default=10)
    p.add_argument("--model", default="gnn", choices=["gnn", "contconv"],
                   help="surrogate family: gnn (GraphModel) or contconv "
                        "(reference-config ContinuousConvModel, Morton "
                        "radius search)")
    p.add_argument("--modes", nargs="+",
                   default=["direct", "surrogate", "hybrid"])
    p.add_argument("--knn-method", default="morton",
                   choices=["exact", "approx", "morton"],
                   help="surrogate neighbor search (morton = the O(N*W) "
                        "production path, ops/spatial.py)")
    p.add_argument("--knn-window", type=int, default=64)
    p.add_argument("--graph-refresh", type=int, default=1,
                   help="rebuild the surrogate's neighbor graph every this "
                        "many steps (Verlet-list amortisation; 1 = per-step "
                        "reference parity)")
    p.add_argument("--out", default=None, help="JSON artifact path")
    args = p.parse_args(argv)

    n, steps = args.n_bodies, args.steps
    pos, vel, mass = generate_spiral(jax.random.PRNGKey(0), n)

    if args.model == "contconv":
        # Reference ContConv recipe (contconv_experiment.py:62-76) with the
        # Morton radius search for large N.
        from nbody_sim.models import ContinuousConvModel

        model = ContinuousConvModel(
            in_channels=4, out_channels=3, filter_resolution=(6, 4),
            radius=1.0, agg="mean", self_loops=True,
            continuous_conv_layers=2, continuous_conv_dim=128,
            encoder_hiddens=(32, 64), decoder_hiddens=(64, 32),
            scale_factor=1e6, radius_method="morton",
        )
    else:
        model = GraphModel(
            input_dim=4, gnn_dim=64, message_passing_steps=2,
            aggr="mean", neighbors=args.neighbors, scale_factor=1e6,
            knn_method=args.knn_method, knn_window=args.knn_window)
    x0 = jnp.concatenate([pos, vel, mass[:, None]], -1)[None]
    idx, valid = build_graph(model.graph_spec, x0[..., :3])
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), x0, idx, valid)

    cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT,
                           integrator="leapfrog", calc_energy=False,
                           force_backend="auto")

    results = {}
    if "direct" in args.modes:
        jax.block_until_ready(simulate(pos, vel, mass, steps, cfg).positions)  # warm
        traj, el = device_time(lambda: simulate(pos, vel, mass, steps, cfg))
        results["direct"] = {"seconds": el, "psteps_per_s": n * steps / el}
        direct_final = np.asarray(traj.positions[-1])

    if "surrogate" in args.modes:
        # steps+1 rows = `steps` integration updates (row 0 is the seed
        # state), aligning with simulate()'s `steps` updates.
        run = lambda: autoregressive_rollout(
            model, variables, pos, vel, mass, steps + 1, DT,
            graph_refresh=args.graph_refresh,
        )
        jax.block_until_ready(run()[0])
        (ps, _, _), el = device_time(run)
        results["surrogate"] = {"seconds": el, "psteps_per_s": n * steps / el,
                                "graph_refresh": args.graph_refresh}
        if "direct" in results:
            drift = float(
                np.sqrt(((np.asarray(ps[-1]) - direct_final) ** 2).mean())
            )
            results["surrogate"]["final_pos_rmse_vs_direct"] = drift

    if "hybrid" in args.modes and args.hybrid_warmup < steps:
        w = args.hybrid_warmup

        def run_hybrid():
            t = simulate(pos, vel, mass, w, cfg)
            return autoregressive_rollout(
                model, variables, t.positions[-1], t.velocities[-1], mass,
                steps - w + 1, DT,
            )

        jax.block_until_ready(run_hybrid()[0])
        _, el = device_time(run_hybrid)
        results["hybrid"] = {"seconds": el, "psteps_per_s": n * steps / el}

    for mode, r in results.items():
        print(json.dumps({"mode": mode, "n_bodies": n, "steps": steps, **r}))

    if args.out:
        import os

        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(
                {
                    "n_bodies": n,
                    "steps": steps,
                    "knn_method": args.knn_method,
                    "knn_window": args.knn_window,
                    "device": jax.devices()[0].platform,
                    "results": results,
                },
                f,
                indent=1,
            )
        print(f"wrote {args.out}")


if __name__ == "__main__":
    from nbody_sim.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    main()
