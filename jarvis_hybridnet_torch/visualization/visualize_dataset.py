"""Dataset sample viewers (port of
``jarvis_hybridnet_tpu/visualization/visualize_dataset.py``; reference:
jarvis/visualization/visualize_dataset.py:36-96). matplotlib and cv2 are
imported by the functions that draw."""

from __future__ import annotations

import numpy as np

from ..utils.skeleton import get_skeleton


def set_axes_equal(ax):
    x_limits = ax.get_xlim3d()
    y_limits = ax.get_ylim3d()
    z_limits = ax.get_zlim3d()
    x_range = abs(x_limits[1] - x_limits[0])
    y_range = abs(y_limits[1] - y_limits[0])
    z_range = abs(z_limits[1] - z_limits[0])
    x_middle = np.mean(x_limits)
    y_middle = np.mean(y_limits)
    z_middle = np.mean(z_limits)
    r = 0.4 * max([x_range, y_range, z_range])
    ax.set_xlim3d([x_middle - r, x_middle + r])
    ax.set_ylim3d([y_middle - r, y_middle + r])
    ax.set_zlim3d([z_middle - r, z_middle + r])


def visualize_2D_sample(dataset, mode, img_idx):
    import cv2
    import matplotlib.pyplot as plt

    fig = plt.figure()
    img, _, keypoints = dataset[img_idx]
    mean = np.asarray(dataset.cfg.DATASET.MEAN)
    std = np.asarray(dataset.cfg.DATASET.STD)
    img = (img * std + mean) * 255
    img = img - np.min(img)
    img = img / np.max(img) * 255
    img = cv2.resize(img.astype(np.float32), None, fx=3, fy=3)
    if mode == "CenterDetect":
        kp = keypoints.reshape(-1)
        if kp[0] + kp[1] != 0:
            img = cv2.circle(img, (int(kp[0] * 3), int(kp[1] * 3)), 4, (255, 0, 0), 6)
    else:
        colors, line_idxs = get_skeleton(dataset.cfg)
        kps = keypoints.reshape(-1, 3)
        for i, kp in enumerate(kps):
            if kp[0] + kp[1] != 0:
                img = cv2.circle(img, (int(kp[0] * 3), int(kp[1] * 3)), 4, colors[i], 6)
        for line in line_idxs:
            a, b = kps[line[0]], kps[line[1]]
            if a[0] + a[1] != 0 and b[0] + b[1] != 0:
                cv2.line(img, (int(a[0] * 3), int(a[1] * 3)),
                         (int(b[0] * 3), int(b[1] * 3)), colors[line[1]], 1)
    plt.imshow(img / 255.0)
    plt.axis("off")
    return fig


def visualize_3D_sample(dataset, img_idx, azim=0, elev=0):
    import matplotlib.pyplot as plt

    colors, line_idxs = get_skeleton(dataset.cfg)
    sample = dataset[img_idx]
    keypoints3D = sample["keypoints3D"]
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.set_axis_off()
    ax.margins(0)
    ax.azim = azim
    ax.elev = elev
    for i, point in enumerate(keypoints3D):
        if np.sum(point) != 0:
            ax.scatter(point[0], point[1], point[2], color=tuple(np.array(colors[i]) / 255.0))
    for line in line_idxs:
        a, b = keypoints3D[line[0]], keypoints3D[line[1]]
        if np.sum(a) != 0 and np.sum(b) != 0:
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                    color=tuple(np.array(colors[line[1]]) / 255.0))
    set_axes_equal(ax)
    ax.autoscale_view("tight")
    return fig
