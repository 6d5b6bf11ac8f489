"""Error plots over analyze_validation_data outputs (port of
``jarvis_hybridnet_tpu/analysis/plotting.py``; reference:
jarvis/analysis/plotting.py:18-194): masked euclidean-mm error histogram +
boxplot (median in the legend), per-keypoint mean bars, and per-keypoint
histograms, each saved as PNGs next to the CSVs. Figure geometry, titles
and seaborn styling are part of the output-compatibility contract (users
compare these PNGs across tools), so those constants match the reference.
Host code only: matplotlib, seaborn and pandas are imported by the plot
functions, not with the module.
"""

from __future__ import annotations

import os

import numpy as np


def _read_points_csv(path: str) -> np.ndarray:
    """(frames, joints, 3) float array from a flat x,y,z-triplet CSV."""
    flat = np.genfromtxt(path, delimiter=",")
    return flat.reshape(-1, flat.shape[1] // 3, 3)


def _load_points(run_dir: str):
    gt = _read_points_csv(os.path.join(run_dir, "points_GroundTruth.csv"))
    net = _read_points_csv(os.path.join(run_dir, "points_HybridNet.csv"))
    return gt, net


def _masked_distances_mm(pred, gt, cutoff=-1) -> np.ndarray:
    """Flat per-labeled-joint euclidean errors; unlabeled GT rows (all-zero
    triplets) are dropped, values above ``cutoff`` are clamped to it."""
    d = np.linalg.norm(pred - gt, axis=2)
    d = d[gt.sum(axis=2) != 0]
    if cutoff != -1:
        d = np.minimum(d, cutoff)
    return d.reshape(-1)


def _setup_style():
    import seaborn as sns

    sns.set_theme()
    sns.set_style("whitegrid", {"axes.grid": False})
    sns.set_context("paper", font_scale=1.25)
    return sns


def _hist_box_figure(plt, sns, frame):
    """The shared histogram-over-boxplot layout (A4-width golden ratio)."""
    fig, (ax_hist, ax_box) = plt.subplots(
        2, sharex=True, gridspec_kw={"height_ratios": (1, 0.2)},
        figsize=(6.92913, 6.92913 / 1.618),
    )
    sns.boxplot(data=frame, fliersize=0, ax=ax_box, orient="h")
    sns.histplot(data=frame, ax=ax_hist, element="step", alpha=0.1)
    return fig, ax_hist, ax_box


def plot_error_histogram(path, additional_data=None, cutoff=-1,
                         interactive=True):
    import matplotlib.pyplot as plt
    import pandas as pd

    sns = _setup_style()
    gt, net = _load_points(path)

    errors = {"JARVIS": _masked_distances_mm(net, gt, cutoff)}
    for name, csv_path in (additional_data or {}).items():
        errors[name] = _masked_distances_mm(
            _read_points_csv(csv_path), gt, cutoff)
    frame = pd.DataFrame(errors)

    fig, ax_hist, ax_box = _hist_box_figure(plt, sns, frame)
    plt.suptitle("Euclidean Distance to Ground Truth across all joints")
    ax_hist.legend(
        labels=[f"{name} ({np.median(errors[name]):.2f} mm)"
                for name in reversed(list(errors))],
        frameon=False,
    )
    plt.xlabel("Deviation from manual annotations [mm]")
    if cutoff != -1:
        # last tick reads ">cutoff" because values were clamped, not cut
        step = 2 if cutoff < 15 else 5
        plt.xlim(0, cutoff + 0.1)
        tick_names = [str(i) for i in range(0, cutoff, step)] + [f">{cutoff}"]
        plt.xticks(list(step * np.arange(len(tick_names) - 1)) + [cutoff])
        ax_box.set_xticklabels(tick_names)
    plt.savefig(os.path.join(path, "error_histogram.png"))
    if interactive:
        plt.show()
    return fig


def _load_project_cfg(project_name):
    from ..config.project_manager import ProjectManager

    pm = ProjectManager()
    pm.load(project_name)
    return pm.get_cfg()


def _joint_names(cfg, num_joints):
    """KEYPOINT_NAMES when it covers every CSV joint, generic labels
    otherwise (projects created from datasets without keypoint_names have
    an empty list — their analysis data must still plot)."""
    names = list(cfg.KEYPOINT_NAMES)
    if len(names) < num_joints:
        return [f"joint_{j}" for j in range(num_joints)]
    return names[:num_joints]


def plot_error_per_keypoint(path, project_name, interactive=True):
    import matplotlib.pyplot as plt

    _setup_style()
    cfg = _load_project_cfg(project_name)

    fig = plt.figure()
    plt.subplots_adjust(left=0.1, right=0.9, top=0.9, bottom=0.3)
    plt.ylabel("Mean Deviation from manual annotations [mm]")
    plt.suptitle("Euclidean Distance to Ground Truth per Joint")

    gt, net = _load_points(path)
    num_joints = net.shape[1]
    # masked mean: a joint never labeled in GT contributes no bar height
    distances = np.ma.array(
        np.linalg.norm(net - gt, axis=2), mask=gt.sum(axis=2) == 0)
    joint_means = np.ma.mean(distances, axis=0)

    cmap = plt.colormaps.get_cmap("jet")
    for j in range(num_joints):
        plt.bar(j, joint_means[j], width=0.8, color=cmap(j / num_joints))
    plt.xticks([j + 0.1 for j in range(num_joints)],
               _joint_names(cfg, num_joints), rotation=90)
    plt.savefig(os.path.join(path, "error_per_joint.png"))
    if interactive:
        plt.show()
    return fig


def plot_error_histogram_per_keypoint(path, project_name, cutoff=-1,
                                      interactive=True):
    import matplotlib.pyplot as plt
    import pandas as pd

    sns = _setup_style()
    cfg = _load_project_cfg(project_name)

    hist_dir = os.path.join(path, "keypoint_histograms")
    os.makedirs(hist_dir, exist_ok=True)
    gt, net = _load_points(path)

    # joint count comes from the CSV, not the config: analysis data must
    # stay plottable on projects without (or with stale) KEYPOINT_NAMES
    num_joints = net.shape[1]
    names = _joint_names(cfg, num_joints)
    grid_h = max(1, int(np.sqrt(num_joints)))
    grid_w = int(np.ceil(num_joints / grid_h))
    # squeeze=False: a 1-row grid (< 4 joints) must still index 2-D
    overview, axs = plt.subplots(grid_h, grid_w, squeeze=False)

    for j, name in enumerate(names):
        frame = pd.DataFrame(
            {name: _masked_distances_mm(net[:, j:j + 1], gt[:, j:j + 1],
                                        cutoff)})
        # tile in the overview grid + a standalone hist/box PNG per joint
        sns.histplot(data=frame, ax=axs[j // grid_w, j % grid_w],
                     element="step", alpha=0.1)
        fig, _, _ = _hist_box_figure(plt, sns, frame)
        fig.savefig(os.path.join(hist_dir, f"{name}.png"))
        plt.close(fig)

    if interactive:
        plt.show()
    return overview
