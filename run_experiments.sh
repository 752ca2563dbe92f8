#!/bin/bash
# Run both surrogate experiments sequentially (reference run_experiments.sh:3-12).
#
# The per-model flags below regenerate results/ (and, through
# `python -m nbody_sim.experiments.visualize`, figures/) and mirror configs/{gnn_reference,contconv_adopted}.json (the same recipes via
# `python -m nbody_sim.experiments.run --config ...`):
# - GNN: the reference's own recipe (lr 0.01, torch init, train-seed 0) with
#   batch_mode="reference" — PyG mixed-size 64-graph batch composition.
# - ContConv: the stabilized recipe (lr 1e-3, zero-init head, merged files,
#   mixed batches) — the reference recipe collapses to a constant predictor
#   (ROADMAP.md, "Findings kept"). Pass --reference-init --lr 0.01 to reproduce the
#   collapse instead.
#
# Extra args (e.g. --quick --base DIR) are forwarded to both drivers.
set -e

echo "Executing gnn experiment..."
python -m nbody_sim.experiments.gnn_experiment --seed 42 --batch-mode reference "$@"

echo "Executing contconv experiment..."
python -m nbody_sim.experiments.contconv_experiment --seed 42 --merge-files --batch-mode mixed --lr 0.001 "$@"

echo "Both experiments executed successfully."
