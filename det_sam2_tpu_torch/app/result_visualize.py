"""Hyperparameter-sweep heatmaps from eval_results.json.

Counterpart of the JAX package's ``app/result_visualize.py`` (Det-SAM2's
result_visualize.py): pairwise-parameter heatmaps of pot / collision /
rebound F1 (or precision / recall) averaged over the grid. pandas,
matplotlib and seaborn are imported when called.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import List, Optional


def load_results(path: str) -> "pandas.DataFrame":  # noqa: F821
    import pandas as pd

    with open(path) as f:
        data = json.load(f)
    rows = []
    for entry in data:
        row = dict(entry["params_setting"])
        for event in ("pot", "collision", "rebound"):
            for metric in ("precision", "recall", "f1"):
                row[f"{event}_{metric}"] = entry["average_results"][event][
                    metric
                ]
        rows.append(row)
    return pd.DataFrame(rows)


def plot_heatmaps(
    results_path: str,
    output_dir: str,
    params: Optional[List[str]] = None,
    metric: str = "f1",
    events: List[str] = ("pot", "collision", "rebound"),
) -> List[str]:
    """Pairwise pivot heatmaps; returns saved file paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    df = load_results(results_path)
    os.makedirs(output_dir, exist_ok=True)
    if params is None:
        metric_cols = {
            f"{e}_{m}" for e in ("pot", "collision", "rebound")
            for m in ("precision", "recall", "f1")
        }
        params = [
            c for c in df.columns
            if c not in metric_cols and df[c].nunique() > 1
        ]
    saved = []
    for p1, p2 in itertools.combinations(params, 2):
        fig, axes = plt.subplots(1, len(events), figsize=(6 * len(events), 5))
        if len(events) == 1:
            axes = [axes]
        for ax, event in zip(axes, events):
            pivot = df.pivot_table(
                index=p1, columns=p2, values=f"{event}_{metric}",
                aggfunc="mean",
            )
            sns.heatmap(pivot, annot=True, fmt=".3f", cmap="viridis", ax=ax)
            ax.set_title(f"{event} {metric}")
        out = os.path.join(output_dir, f"heatmap_{p1}_vs_{p2}.png")
        fig.tight_layout()
        fig.savefig(out)
        plt.close(fig)
        saved.append(out)
    return saved
