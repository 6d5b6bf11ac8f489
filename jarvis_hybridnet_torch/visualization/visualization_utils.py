"""Pose overlay drawing primitives (port of
``jarvis_hybridnet_tpu/visualization/visualization_utils.py``; reference:
jarvis/visualization/visualization_utils.py:12-37). ``points2D`` are host
numpy arrays; cv2 draws into the BGR frame in place."""

from __future__ import annotations

import numpy as np


def draw_line(img, line, points2D, img_size, color):
    import cv2

    if np.isnan(np.sum(np.array(points2D))):
        return
    a, b = points2D[line[0]], points2D[line[1]]
    if all(0 < int(p[i]) < img_size[i] - 1 for p in (a, b) for i in (0, 1)):
        cv2.line(
            img, (int(a[0]), int(a[1])), (int(b[0]), int(b[1])),
            tuple(int(c) for c in color), 1,
        )


def draw_point(img, point, img_size, color):
    import cv2

    if np.isnan(np.sum(np.array(point))):
        return
    if 0 < point[0] < img_size[0] - 1 and 0 < point[1] < img_size[1] - 1:
        cv2.circle(
            img, (int(point[0]), int(point[1])), 3,
            tuple(int(c) for c in color), thickness=3,
        )
