"""Time-slice figure generator (port of
``jarvis_hybridnet_tpu/visualization/time_slices.py``; reference:
jarvis/visualization/time_slices.py:43-101): renders a row of 3D poses
sampled every ``skip_number`` frames from a data3D.csv. Host code only;
matplotlib is imported by the functions that plot."""

from __future__ import annotations

import os

import numpy as np

from .visualize_dataset import set_axes_equal


def _pick_view_angle(plt, pose, colors, line_idxs):
    """Rotatable preview of one pose; returns the (azim, elev) the user
    left the view at (last mouse release), like the reference's
    projections list (time_slices.py:55-63,76-77)."""
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    picked = [(ax.azim, ax.elev)]

    def on_release(event):
        picked.append((ax.azim, ax.elev))

    fig.canvas.mpl_connect("button_release_event", on_release)
    for i, point in enumerate(pose):
        ax.scatter(point[0], point[1], point[2],
                   color=tuple(np.array(colors[i]) / 255.0), s=10)
    for line in line_idxs:
        a, b = pose[line[0]], pose[line[1]]
        ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                c=tuple(np.array(colors[line[1]]) / 255.0))
    set_axes_equal(ax)
    plt.show()
    plt.close(fig)
    return picked[-1]


def _conf_like(data) -> bool:
    """True when every 4th column holds values in [0, 1] (the confidence
    range) — distinguishes x,y,z,confidence groups from xyz-only rows
    whose width happens to be divisible by 4."""
    cand = data[:, 3::4]
    cand = cand[np.isfinite(cand)]
    return cand.size > 0 and float(cand.min()) >= 0.0 \
        and float(cand.max()) <= 1.0


def plot_slices(csv_file, filename, start_frame, num_frames, skip_number,
                colors=None, line_idxs=None, plot_azim=None, plot_elev=None,
                interactive=False):
    import matplotlib.pyplot as plt

    if not os.path.isfile(csv_file):
        print("3D Coordinate CSV file does not exist!")
        return None
    data = np.genfromtxt(csv_file, delimiter=",")
    from .create_videos3d import _has_text_header

    per_joint = None
    if _has_text_header(csv_file):
        # row 2 labels each column (x,y,z[,confidence] per joint): count
        # the group width exactly instead of guessing from divisibility
        coords = np.genfromtxt(csv_file, delimiter=",", dtype=str,
                               max_rows=2)[1]
        per_joint = (list(coords[1:]) + ["x"]).index("x") + 1
        data = data[2:]
    if per_joint is None:
        # headerless CSV: a width divisible by both 3 and 4 (e.g. 12
        # joints xyz-only = 36 cols) is ambiguous — deleting on %4 alone
        # would destroy real coordinates, so only treat every 4th column
        # as confidence when its values actually look like confidences
        n = data.shape[1]
        if n % 4 == 0 and (n % 3 != 0 or _conf_like(data)):
            per_joint = 4
        else:
            per_joint = 3
    if per_joint == 4:
        data = np.delete(data, list(range(3, data.shape[1], 4)), axis=1)
    data = data.reshape([data.shape[0], -1, 3])

    J = data.shape[1]
    if colors is None:
        import matplotlib

        cmap = matplotlib.colormaps.get_cmap("jet")
        colors = [np.array(cmap(i / J))[:3] * 255 for i in range(J)]
    line_idxs = line_idxs or []

    if plot_azim is not None and plot_elev is not None:
        projection = (float(plot_azim), float(plot_elev))
    elif interactive:
        # Interactive view-angle picker (reference time_slices.py:52-77):
        # show the first frame in a rotatable 3D window and use the last
        # mouse-release orientation for the whole slice row.
        projection = _pick_view_angle(plt, data[start_frame], colors,
                                      line_idxs)
    else:
        projection = (plot_azim or 0.0, plot_elev or 0.0)
    fig, axs = plt.subplots(1, num_frames, subplot_kw={"projection": "3d"})
    if num_frames == 1:
        axs = [axs]
    for frame in range(num_frames):
        ind = frame * skip_number + start_frame
        ax = axs[frame]
        ax.set_axis_off()
        ax.margins(0)
        ax.azim = projection[0]
        ax.elev = projection[1]
        for i, point in enumerate(data[ind]):
            ax.scatter(point[0], point[1], point[2],
                       color=tuple(np.array(colors[i]) / 255.0))
        for line in line_idxs:
            a, b = data[ind][line[0]], data[ind][line[1]]
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                    c=tuple(np.array(colors[line[1]]) / 255.0))
        set_axes_equal(ax)
        ax.autoscale_view("tight")
    plt.subplots_adjust(wspace=0, hspace=0, right=1, left=0, top=1, bottom=0)
    plt.savefig(filename, dpi=800)
    if interactive:
        plt.show()
    return fig
