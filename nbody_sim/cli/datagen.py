"""Trajectory datagen CLI — flag-compatible rebuild of the reference
``src/s01-dataset-generation.py`` (argparse surface at s01:12-91; list-valued
flags fan out via cartesian product, s01:93-104).

Usage (matches the reference invocation in gnn_experiment.py:28-49):

    python -m nbody_sim.cli.datagen --integrator leapfrog \
        --n-bodies 3 25 50 100 250 500 --output out.csv \
        --steps 1000 --sim-type spiral --n-arms 2 --seed 42
"""

from __future__ import annotations

import argparse

import numpy as np

from nbody_sim.data.generate import generate_dataset, scenario_product


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Galaxy N-body trajectory dataset generation")
    p.add_argument("--n-bodies", type=int, nargs="+", required=True)
    p.add_argument("--integrator", type=str, default="leapfrog",
                   choices=["leapfrog", "euler"], required=True)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--sim-type", type=str, nargs="+",
                   choices=["disk", "spiral"], default=["disk"])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--dt", type=float, default=0.0001)
    p.add_argument("--softening", type=float, default=0.05)
    p.add_argument("--g", type=float, default=4.5e-6)
    p.add_argument("--total-mass", type=float, default=1.0)
    p.add_argument("--radial-scale", type=float, default=3.0)
    p.add_argument("--height-scale", type=float, default=0.3)
    p.add_argument("--black-hole-mass", type=float, default=0.01)
    p.add_argument("--n-arms", type=int, default=2)
    p.add_argument("--pitch-angle", type=float, default=-np.pi / 6)
    p.add_argument("--arm-strength", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=None)
    # Accepted for reference CLI compatibility; placement is JAX's job.
    p.add_argument("--device", type=str, default=None)
    p.add_argument("--force-backend", type=str, default="auto",
                   choices=["auto", "dense", "pallas", "bh"])
    p.add_argument("--no-npz", action="store_true",
                   help="skip the fast-reload .npz twin")
    p.add_argument("--npz-only", action="store_true",
                   help="skip the long-format CSV (large-N datasets where "
                        "per-row CSV is pure overhead)")
    p.add_argument("--snapshot-stride", type=int, default=1,
                   help="record every this-many-th step (incl. step 0; the "
                        "step column keeps original indices) — the large-N "
                        "dataset size knob")
    p.add_argument("--time-chunks", type=int, default=1,
                   help=">1: record per-chunk honest wall times in the "
                        "step_time column instead of the uniform rollout "
                        "mean (see data.generate.run_scenario)")
    p.add_argument("--no-energy", action="store_true",
                   help="skip the exact O(N^2) per-snapshot energy columns "
                        "(u, k become NaN) — required above ~500k bodies "
                        "where one PE evaluation is a multi-minute kernel")
    p.add_argument("--check", action="store_true",
                   help="checkify NaN/Inf guard on every trajectory "
                        "(SURVEY.md §5.2)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of the generation "
                        "into DIR (SURVEY.md §5.1)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    scenarios = scenario_product(
        n_bodies=args.n_bodies,
        integrator=args.integrator,
        sim_type=args.sim_type,
        steps=args.steps,
        dt=args.dt,
        softening=args.softening,
        g=args.g,
        total_mass=args.total_mass,
        radial_scale=args.radial_scale,
        height_scale=args.height_scale,
        black_hole_mass=args.black_hole_mass,
        n_arms=args.n_arms,
        pitch_angle=args.pitch_angle,
        arm_strength=args.arm_strength,
        seed=args.seed,
        force_backend=args.force_backend,
        calc_energy=not args.no_energy,
    )
    print(f"Generating {len(scenarios)} scenarios -> {args.output}")
    run = lambda: generate_dataset(
        scenarios, args.output, write_npz=not args.no_npz,
        time_chunks=args.time_chunks, check=args.check,
        snapshot_stride=args.snapshot_stride,
        write_csv_file=not args.npz_only,
    )
    if args.profile:
        from nbody_sim.utils.profiling import trace_profile

        with trace_profile(args.profile):
            run()
        print(f"profiler trace written to {args.profile}")
    else:
        run()
    print("done")


if __name__ == "__main__":
    from nbody_sim.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    main()
