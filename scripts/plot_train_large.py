"""Render figures/train_large_loss.png from the large-N training runs'
epoch-loss CSVs (written by ``nbody_sim.experiments.train_large``).

One curve per large-N training run (results/large_scale/train_*_epoch_loss.csv),
log-y scaled-RMSE vs epoch, with the predict-zero baseline for reference.
Encoding: hue family = model (blue GNN / orange ContConv), lightness = N
(ColorBrewer sequential steps), dashed = 4-scene recipes. Missing CSVs are
skipped so the figure regenerates at any point mid-round.

Usage: python scripts/plot_train_large.py
"""

import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd

BASE = os.path.join(os.path.dirname(__file__), "..")
RES = os.path.join(BASE, "results", "large_scale")

# (csv stem, label, color, linestyle, linewidth)
CURVES = [
    ("train_20k", "GNN @20k", "#9ecae1", "-", 1.8),
    ("train_50k", "GNN @50k", "#6baed6", "-", 1.8),
    ("train_100k", "GNN @100k", "#3182bd", "-", 1.8),
    ("train_100k_r3", "GNN @100k, 4 scenes", "#08519c", "--", 1.8),
    ("train_1m", "GNN @1M", "#08306b", "-", 2.6),
    ("train_20k_contconv", "ContConv @20k", "#fdae6b", "-", 1.8),
    ("train_100k_contconv", "ContConv @100k", "#fd8d3c", "-", 1.8),
    ("train_100k_contconv_r3", "ContConv @100k, 4 scenes", "#e6550d", "--", 1.8),
    ("train_1m_contconv", "ContConv @1M", "#7f2704", "-", 2.6),
]

PREDICT_ZERO = 0.092  # scaled-RMSE of the zero predictor (100k spiral scenes)


def main():
    fig, ax = plt.subplots(figsize=(10, 6), dpi=100)
    for stem, label, color, ls, lw in CURVES:
        path = os.path.join(RES, stem + "_epoch_loss.csv")
        if not os.path.exists(path):
            continue
        df = pd.read_csv(path)
        ax.plot(df["epoch"], df["loss"], color=color, linestyle=ls,
                linewidth=lw, label=label)
    ax.axhline(PREDICT_ZERO, color="#888888", linestyle=":", linewidth=1.5)
    ax.text(0.02, PREDICT_ZERO * 1.04,
            f"predict-zero baseline ({PREDICT_ZERO})",
            transform=ax.get_yaxis_transform(), color="#888888", fontsize=10,
            va="bottom")
    ax.set_yscale("log")
    ax.set_xlabel("epoch")
    ax.set_ylabel("train scaled RMSE loss")
    ax.set_title("Large-N surrogate training on BH ground truth "
                 "(spiral scenes)")
    ax.grid(True, which="both", alpha=0.15)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.legend(ncol=2, frameon=False, fontsize=10, loc="lower left")
    out = os.path.join(BASE, "figures", "train_large_loss.png")
    fig.tight_layout()
    fig.savefig(out)
    print("wrote", out)


if __name__ == "__main__":
    main()
