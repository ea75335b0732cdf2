"""Exploratory data analysis of the raw shower files, in numpy.

Counterpart of the repository's ``eda.py`` (the JAX package's script), with
its files, keys and figures; pandas is replaced by numpy group-bys over the
port's HDF5 reader (``data/hdf5.py``):

- ``summary_stats.json``       event-level stats (overall, per particle,
                               events per particle)
- ``missing_values.json``      NaN count of every raw array, per particle
- ``energy_distribution.png``  per-class distribution of step energies
- ``shower_3d.png``            3-D scatter of a single shower, energy-colored
- ``correlation_matrix.png``   Pearson correlation of the event-level columns
- ``plot.png``                 energy vs hits (``utils/plots.plot_data``)
- ``pairplot.png``             scatter matrix over the 9 tabular features

The last two need an S2PT cache and are skipped without one.  The numbers
are pandas': per event, the steps' energy summed in float32 with
compensation, the step count, the distinct MC particles and the 0.99
quantile of the step times, interpolated linearly; over events, the mean,
median, ``std`` (``ddof=1``), min and max in the column's dtype as pandas
reduces it; per particle in sorted order; the event counts largest first.
The figures need matplotlib; without it the two JSON files are written and
one line says that no figure was drawn.  The pairplot redraws pandas'
``scatter_matrix`` with plain matplotlib, call for call.

Usage: python -m point_cloud_classifier_tpu_torch.eda --data-dir DATA
[--out-dir eda_out] [--sample 1000]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Tuple

import numpy as np

from point_cloud_classifier_tpu_torch.data.hdf5 import find_shower_files, load_shower_file

PARTICLES = ("proton", "piM")
EVENT_COLS = ["total_energy", "n_steps", "n_particles", "elapsed_time"]


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _groups(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(keys, order, starts, counts)``: the sorted distinct ids, the rows
    grouped by id (each group in row order), and each group's first slot in
    ``order`` and its size."""
    keys, inverse = np.unique(ids, return_inverse=True)
    order = np.argsort(inverse, kind="stable")
    counts = np.bincount(inverse, minlength=len(keys))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return keys, order, starts, counts


def _compensated_sums(values: np.ndarray, starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Each group's sum in ``values``' dtype, row by row with Kahan's
    compensation, as pandas' ``groupby().sum()`` adds (``values`` grouped)."""
    total = np.zeros(len(counts), values.dtype)
    carry = np.zeros(len(counts), values.dtype)
    for k in range(int(counts.max(initial=0))):
        live = np.flatnonzero(counts > k)
        y = values[starts[live] + k] - carry[live]
        t = total[live] + y
        c = (t - total[live]) - y
        carry[live] = np.where(np.isnan(c), 0, c)  # an infinite value leaves no carry
        total[live] = t
    return total


def _group_quantile(values: np.ndarray, groups: np.ndarray, q: float) -> np.ndarray:
    """Each group's ``q`` quantile in float64, interpolated linearly between
    the two order statistics around ``q·(n-1)`` (pandas' ``groupby().quantile``)."""
    keys, inverse = np.unique(groups, return_inverse=True)
    order = np.lexsort((values, inverse))
    counts = np.bincount(inverse, minlength=len(keys))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ordered = values[order].astype(np.float64)
    pos = q * (counts - 1)
    idx = pos.astype(np.int64)
    frac = pos - idx
    lo = ordered[starts + idx]
    hi = ordered[starts + np.minimum(idx + 1, counts - 1)]
    return np.where(frac == 0.0, lo, lo + (hi - lo) * frac)


def event_level(raw: Dict[str, np.ndarray], particle: str) -> Dict[str, np.ndarray]:
    """One file's events in event-id order: ``event_id`` and the four
    ``EVENT_COLS``, and ``particle``."""
    keys, order, starts, counts = _groups(raw["event_id"])
    pairs = np.unique(np.stack([raw["event_id"], raw["mcparticle_id"]]), axis=1)
    return {
        "event_id": keys,
        "total_energy": _compensated_sums(raw["energy"][order], starts, counts),
        "n_steps": counts.astype(np.int64),
        "n_particles": np.bincount(np.searchsorted(keys, pairs[0]), minlength=len(keys)).astype(np.int64),
        "elapsed_time": _group_quantile(raw["time"], raw["event_id"], 0.99),
        "particle": np.full(len(keys), particle),
    }


def load_all(data_dir: str):
    """``(events, raws, first_raws)``: the event table over every file (the
    particles in ``PARTICLES``' order, files in discovery order), each
    particle's raw arrays over all its files, and each particle's first file
    (one event-id space, for the single-shower plot)."""
    events, raws, first_raws = [], {}, {}
    for particle in PARTICLES:
        per_file = []
        for path in find_shower_files(data_dir, particle):
            raw = load_shower_file(path)
            per_file.append(raw)
            events.append(event_level(raw, particle))
        if per_file:
            first_raws[particle] = per_file[0]
            raws[particle] = {
                k: np.concatenate([r[k] for r in per_file])
                for k, v in per_file[0].items()
                if isinstance(v, np.ndarray)
            }
    if not events:
        raise FileNotFoundError(
            f"no shower HDF5 files found under {data_dir!r} "
            f"(expected filenames containing one of {PARTICLES})"
        )
    return {k: np.concatenate([e[k] for e in events]) for k in events[0]}, raws, first_raws


def _mean(v: np.ndarray):
    if v.dtype.kind == "f":
        return v.sum(dtype=v.dtype) / v.dtype.type(len(v))
    return v.sum(dtype=np.float64) / np.float64(len(v))


def _std(v: np.ndarray):
    """The sample standard deviation (``ddof=1``): float64 sums, the
    variance rounded to a float column's dtype before the root."""
    dtype = v.dtype if v.dtype.kind == "f" else np.dtype(np.float64)
    v = v.astype(dtype, copy=False)
    count = dtype.type(len(v))
    if count <= 1:
        return np.nan
    avg = v.sum(dtype=np.float64) / count
    var = ((avg - v) ** 2).sum(dtype=np.float64) / (count - dtype.type(1))
    return np.sqrt(np.asarray(var).astype(dtype))


def _median(v: np.ndarray):
    return np.nanmedian(v if v.dtype.kind == "f" else v.astype(np.float64))


_STATS = {"mean": _mean, "median": _median, "std": _std, "min": np.min, "max": np.max}


def _describe(events: Dict[str, np.ndarray], rows, stats) -> dict:
    return {col: {name: float(_STATS[name](events[col][rows])) for name in stats} for col in EVENT_COLS}


def summary_stats(events: Dict[str, np.ndarray], out_dir: str) -> dict:
    every = slice(None)
    particles, first, n = np.unique(events["particle"], return_index=True, return_counts=True)
    # largest first, ties in order of first appearance
    by_count = sorted(range(len(particles)), key=lambda i: (-n[i], first[i]))
    stats = {
        "overall": _describe(events, every, ("mean", "median", "std", "min", "max")),
        "by_particle": {str(p): _describe(events, events["particle"] == p, ("mean", "median", "std"))
                        for p in particles},
        "n_events": {str(particles[i]): int(n[i]) for i in by_count},
    }
    with open(os.path.join(out_dir, "summary_stats.json"), "w") as f:
        json.dump(stats, f, indent=4, default=float)
    return stats


def missing_values(raws: dict, out_dir: str) -> dict:
    audit = {}
    for particle, raw in raws.items():
        audit[particle] = {
            k: int(np.isnan(v).sum()) if np.issubdtype(v.dtype, np.floating) else 0
            for k, v in raw.items()
            if isinstance(v, np.ndarray)
        }
    with open(os.path.join(out_dir, "missing_values.json"), "w") as f:
        json.dump(audit, f, indent=4)
    return audit


def correlation(columns: np.ndarray) -> np.ndarray:
    """Pearson correlation of the columns of ``columns`` [rows, k], by
    Welford's running moments over the rows and clipped to [-1, 1], as
    ``DataFrame.corr()`` computes it."""
    mat = np.asarray(columns, dtype=np.float64)
    k = mat.shape[1]
    mean = np.zeros(k)
    ssq = np.zeros(k)
    cov = np.zeros((k, k))
    for i, row in enumerate(mat):
        d = row - mean
        mean = mean + 1.0 / (i + 1) * d
        ssq = ssq + (row - mean) * d
        cov = cov + np.outer(row - mean, d)  # cov[x, y] += (x - mean_x) · dy
    with np.errstate(all="ignore"):
        divisor = np.sqrt(np.outer(ssq, ssq))
        corr = np.clip(cov / divisor, -1.0, 1.0)
    corr[divisor == 0] = np.nan
    # pandas fills the pair (x, y) with y ≤ x and mirrors it
    return np.tril(corr) + np.tril(corr, -1).T


def plot_energy_distribution(plt, raws: dict, out_dir: str) -> None:
    fig, ax = plt.subplots(figsize=(8, 5))
    all_e = np.concatenate([r["energy"] for r in raws.values()])
    bins = np.linspace(0, np.percentile(all_e, 99), 60)
    for particle, raw in raws.items():
        ax.hist(raw["energy"], bins=bins, alpha=0.55, density=True, label=particle)
    ax.set_xlabel("Step energy (MeV)")
    ax.set_ylabel("Density")
    ax.set_title("Step energy distribution (≤ p99)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "energy_distribution.png"))
    plt.close(fig)


def plot_shower_3d(plt, raws: dict, out_dir: str) -> None:
    fig = plt.figure(figsize=(12, 5))
    for i, (particle, raw) in enumerate(sorted(raws.items())):
        first_event = raw["event_id"][0]
        sel = raw["event_id"] == first_event
        pos, energy = raw["position"][sel], raw["energy"][sel]
        ax = fig.add_subplot(1, len(raws), i + 1, projection="3d")
        sc = ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c=energy, cmap="viridis", s=14)
        ax.set_title(f"{particle} shower (event {first_event})")
        fig.colorbar(sc, ax=ax, shrink=0.6, label="energy")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "shower_3d.png"))
    plt.close(fig)


def plot_correlation(plt, events: Dict[str, np.ndarray], out_dir: str) -> None:
    corr = correlation(np.stack([events[c] for c in EVENT_COLS], axis=1))
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(corr, cmap="coolwarm", vmin=-1, vmax=1)
    ax.set_xticks(range(len(EVENT_COLS)), EVENT_COLS, rotation=45, ha="right")
    ax.set_yticks(range(len(EVENT_COLS)), EVENT_COLS)
    for (i, j), v in np.ndenumerate(corr):
        ax.text(j, i, f"{v:.2f}", ha="center", va="center")
    fig.colorbar(im)
    ax.set_title("Event-level feature correlation")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "correlation_matrix.png"))
    plt.close(fig)


def _s2pt_train(data_dir: str):
    cache = os.path.join(data_dir, "S2PT", "train", "S2PT_train.npz")
    return np.load(cache) if os.path.exists(cache) else None


def plot_energy_vs_hits(data_dir: str, out_dir: str) -> bool:
    """The energy-vs-hits scatter of the S2PT train split (``plot.png``)."""
    data = _s2pt_train(data_dir)
    if data is None:
        return False
    from point_cloud_classifier_tpu_torch.utils.plots import plot_data

    plot_data({k: data[k] for k in ("energy_total", "hits_total", "label")}, save_dir=out_dir)
    return True


def scatter_matrix(plt, columns: Dict[str, np.ndarray], figsize, colors, alpha=0.5, s=8, range_padding=0.05):
    """pandas' ``scatter_matrix(…, diagonal="hist")`` over numeric columns:
    an n×n grid without gaps, histograms on the diagonal, every column's
    limits its range padded by ``range_padding``/2 a side, only the left
    column's y axes and the bottom row's x axes shown, the top-left
    histogram's y ticks relabelled in the first column's values, tick
    labels at size 8 with the x ones turned 90°."""
    names = list(columns)
    n = len(names)
    fig = plt.figure(figsize=figsize)
    axes = np.empty(n * n, dtype=object)
    for i in range(n * n):
        axes[i] = fig.add_subplot(n, n, i + 1)
    axes = axes.reshape(n, n)
    fig.subplots_adjust(wspace=0, hspace=0)
    valid = {a: ~np.isnan(v) if v.dtype.kind == "f" else np.ones(len(v), bool) for a, v in columns.items()}

    bounds = []
    for a in names:
        values = columns[a][valid[a]]
        lo, hi = np.min(values), np.max(values)
        pad = (hi - lo) * range_padding / 2
        bounds.append((lo - pad, hi + pad))
    for i, a in enumerate(names):
        for j, b in enumerate(names):
            ax = axes[i, j]
            if i == j:
                ax.hist(columns[a][valid[a]])
                ax.set_xlim(bounds[i])
            else:
                common = valid[a] & valid[b]
                ax.scatter(columns[b][common], columns[a][common], marker=".", alpha=alpha, c=colors, s=s,
                           edgecolors="none")
                ax.set_xlim(bounds[j])
                ax.set_ylim(bounds[i])
            ax.set_xlabel(b)
            ax.set_ylabel(a)
            if j != 0:
                ax.yaxis.set_visible(False)
            if i != n - 1:
                ax.xaxis.set_visible(False)
    if n > 1:
        lim1 = bounds[0]
        locs = axes[0][1].yaxis.get_majorticklocs()
        locs = locs[(lim1[0] <= locs) & (locs <= lim1[1])]
        adj = (locs - lim1[0]) / (lim1[1] - lim1[0])
        lim0 = axes[0][0].get_ylim()
        axes[0][0].yaxis.set_ticks(adj * (lim0[1] - lim0[0]) + lim0[0])
        if np.all(locs == locs.astype(int)):
            locs = locs.astype(int)
        axes[0][0].yaxis.set_ticklabels(locs)
    for ax in axes.ravel():
        plt.setp(ax.get_xticklabels(), fontsize=8)
        plt.setp(ax.get_xticklabels(), rotation=90)
        plt.setp(ax.get_yticklabels(), fontsize=8)
        plt.setp(ax.get_yticklabels(), rotation=0)
    return fig, axes


def plot_pairplot(plt, data_dir: str, out_dir: str, sample: int) -> bool:
    """Scatter matrix over the 9 engineered tabular features (S2PT cache)."""
    data = _s2pt_train(data_dir)
    if data is None:
        return False
    columns = {k: data[k] for k in data.files if k not in ("event_id", "label")}
    labels = data["label"]
    if len(labels) > sample:
        idx = np.random.default_rng(42).choice(len(labels), sample, replace=False)
        columns, labels = {k: v[idx] for k, v in columns.items()}, labels[idx]
    fig, axes = scatter_matrix(plt, columns, figsize=(16, 16),
                               colors=np.where(labels == 0, "tab:blue", "tab:orange"))
    for ax in axes.ravel():
        ax.xaxis.label.set_rotation(30)
        ax.yaxis.label.set_rotation(60)
        ax.yaxis.label.set_ha("right")
    fig.suptitle("S2PT feature pairplot (blue=proton, orange=piM)")
    fig.savefig(os.path.join(out_dir, "pairplot.png"))
    plt.close("all")
    return True


def run_eda(data_dir: str, out_dir: str, sample: int = 1000) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    events, raws, first_raws = load_all(data_dir)
    stats = summary_stats(events, out_dir)
    audit = missing_values(raws, out_dir)
    plt = _pyplot()
    if plt is None:
        print("eda: matplotlib is not installed; summary_stats.json and missing_values.json only, no figures")
    else:
        plot_energy_distribution(plt, raws, out_dir)
        plot_shower_3d(plt, first_raws, out_dir)
        plot_correlation(plt, events, out_dir)
        plot_energy_vs_hits(data_dir, out_dir)
        plot_pairplot(plt, data_dir, out_dir, sample)
    print(f"EDA artifacts written to {out_dir}")
    return {"stats": stats, "missing": audit}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m point_cloud_classifier_tpu_torch.eda",
                                     description="exploratory data analysis")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--out-dir", default="eda_out")
    parser.add_argument("--sample", type=int, default=1000)
    args = parser.parse_args(argv)
    run_eda(args.data_dir, args.out_dir, args.sample)


if __name__ == "__main__":
    main()
