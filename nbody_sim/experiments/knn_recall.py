"""Measured recall + timing for the large-N neighbor searches — the evidence
artifact behind ``ops/spatial.py``'s design claims (target:
exact-or->=0.99-recall kNN(10) at 100k bodies in <100 ms).

Compares, on the actual galaxy IC distributions:
- ``exact``  : streamed O(N^2) top_k (``ops/knn.py``) — ground truth + its cost
- ``approx`` : streamed approx_max_k selection (recall_target 0.95)
- ``morton`` : O(N·W) shifted/rotated space-filling-curve search

Usage (on the GPU):
    python -m nbody_sim.experiments.knn_recall \
        --n-bodies 20000 100000 --out results/large_scale/knn_recall.json
"""

from __future__ import annotations

import argparse
import json
import os

import jax
import numpy as np

from nbody_sim.ics import generate_disk, generate_spiral
from nbody_sim.ops.knn import knn_neighbors
from nbody_sim.ops.spatial import knn_morton
from nbody_sim.utils.timing import device_time

_PROFILES = {"disk": generate_disk, "spiral": generate_spiral}


def recall_of(idx_a, valid_a, idx_e, valid_e) -> float:
    """Fraction of exact neighbor slots recovered (host-side set math)."""
    ia, va = np.asarray(idx_a), np.asarray(valid_a)
    ie, ve = np.asarray(idx_e), np.asarray(valid_e)
    hits = tot = 0
    for i in range(ie.shape[0]):
        exact = set(ie[i][ve[i]].tolist())
        got = set(ia[i][va[i]].tolist())
        hits += len(exact & got)
        tot += len(exact)
    return hits / max(tot, 1)


def _timed(fn):
    """Warm (compile) then time a second, cached call. The warm call is
    fully drained (block_until_ready) before the timer starts — on async
    backends an un-synced warm call would bleed into the timed region."""
    out = fn()
    device_time(lambda: out)  # drain warm-up completely
    out, el = device_time(fn)
    return out, el


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-bodies", type=int, nargs="+", default=[20_000, 100_000])
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--windows", type=int, nargs="+", default=[64, 96, 128])
    p.add_argument("--pallas-blocks", type=int, nargs="+", default=[128, 256],
                   help="block sizes for the fused-Pallas morton path")
    p.add_argument("--pallas-copies", type=int, nargs="+", default=[4],
                   help="curve-copy counts for the fused-Pallas morton path")
    p.add_argument("--profiles", nargs="+", default=["disk", "spiral"])
    p.add_argument("--out", default=None, help="JSON artifact path")
    args = p.parse_args(argv)

    knn_exact = jax.jit(lambda pos: knn_neighbors(pos, args.k))
    rows = []
    for profile in args.profiles:
        for n in args.n_bodies:
            pos, _, _ = _PROFILES[profile](jax.random.PRNGKey(7), n)
            pos = jax.device_put(pos)

            (idx_e, valid_e), t_exact = _timed(lambda: knn_exact(pos))
            rows.append({
                "profile": profile, "n": n, "k": args.k, "method": "exact",
                "seconds": t_exact, "recall": 1.0,
            })
            print(json.dumps(rows[-1]))

            knn_approx = jax.jit(
                lambda pos: knn_neighbors(pos, args.k, approx=True)
            )
            (idx_a, valid_a), t_approx = _timed(lambda: knn_approx(pos))
            rows.append({
                "profile": profile, "n": n, "k": args.k, "method": "approx",
                "seconds": t_approx,
                "recall": recall_of(idx_a, valid_a, idx_e, valid_e),
            })
            print(json.dumps(rows[-1]))

            for w in args.windows:
                knn_m = jax.jit(
                    lambda pos, w=w: knn_morton(pos, args.k, window=w)
                )
                (idx_m, valid_m), t_m = _timed(lambda: knn_m(pos))
                rows.append({
                    "profile": profile, "n": n, "k": args.k,
                    "method": f"morton(W={w})", "seconds": t_m,
                    "recall": recall_of(idx_m, valid_m, idx_e, valid_e),
                })
                print(json.dumps(rows[-1]))

            for b in args.pallas_blocks:
                for nc in args.pallas_copies:
                    knn_p = jax.jit(
                        lambda pos, b=b, nc=nc: knn_morton(
                            pos, args.k, block=b, n_copies=nc, impl="pallas"
                        )
                    )
                    (idx_p, valid_p), t_p = _timed(lambda: knn_p(pos))
                    tag = f"B={b}" if nc == 4 else f"B={b},C={nc}"
                    rows.append({
                        "profile": profile, "n": n, "k": args.k,
                        "method": f"morton-pallas({tag})", "seconds": t_p,
                        "recall": recall_of(idx_p, valid_p, idx_e, valid_e),
                    })
                    print(json.dumps(rows[-1]))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({
                "device": jax.devices()[0].platform,
                "methodology": (
                    "single-dispatch warm timing closed by "
                    "block_until_ready; every row includes one dispatch. "
                    "Amortised (chained-scan) costs are lower — see "
                    "the crossover experiment, where the search runs "
                    "inside a multi-step scan."
                ),
                "rows": rows,
            }, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    from nbody_sim.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    main()
