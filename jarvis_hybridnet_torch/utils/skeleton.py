"""Skeleton graph coloring for the pose overlays (port of
``jarvis_hybridnet_tpu/utils/skeleton.py``; reference get_skeleton,
jarvis/utils/skeleton.py:13-161).

One color per limb chain (walked from each degree-1 seed joint) and per
cycle of the bone graph; joints shared between chains stay gray; with no
skeleton defined, the joints take the colors of matplotlib's ``jet``
colormap, which :func:`jet` computes as matplotlib does, so that the video
overlays need no matplotlib (the card's machine has none).
"""

from __future__ import annotations

import numpy as np

BASE_COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
    (255, 0, 255), (0, 255, 255), (0, 140, 255), (140, 255, 0),
    (255, 140, 0), (0, 255, 140), (255, 140, 140), (140, 255, 140),
    (140, 140, 255), (140, 140, 140),
]
GRAY = (100, 100, 100)

# matplotlib's ``jet`` segment data (matplotlib/_cm.py): (x, y0, y1) per channel
_JET = (
    ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1, 0.5, 0.5)),
    ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0), (1, 0, 0)),
    ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1, 0, 0)),
)
_JET_N = 256  # entries of matplotlib's lookup table


def _jet_lut() -> np.ndarray:
    """(256, 3) lookup table, built as matplotlib's ``_create_lookup_table``
    builds it."""
    cols = []
    for seg in _JET:
        a = np.array(seg, np.float64)
        x, y0, y1 = a[:, 0] * (_JET_N - 1), a[:, 1], a[:, 2]
        xind = (_JET_N - 1) * np.linspace(0, 1, _JET_N)
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                              [y0[-1]]])
        cols.append(np.clip(lut, 0.0, 1.0))
    return np.stack(cols, axis=1)


def jet(x: float) -> tuple[float, float, float, float]:
    """RGBA of ``matplotlib.colormaps['jet'](x)`` for a float x in [0, 1]."""
    i = min(max(int(x * _JET_N), 0), _JET_N - 1)
    return (*(float(v) for v in _jet_lut()[i]), 1.0)


def _find_cycles(edges: list[list[int]]) -> list[list[int]]:
    """Simple cycles of the undirected bone graph; where cycles share
    joints the longest is kept (the reference Graph class,
    skeleton.py:92-157)."""
    adj: dict[int, set[int]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)

    cycles: list[list[int]] = []
    seen = set()

    def canonical(path):
        n = path.index(min(path))
        rot = path[n:] + path[:n]
        inv = rot[::-1]
        n2 = inv.index(min(inv))
        inv = inv[n2:] + inv[:n2]
        return min(rot, inv)

    def dfs(start, node, path):
        for nxt in adj.get(node, ()):
            if nxt == start and len(path) > 2:
                c = canonical(path)
                if tuple(c) not in seen:
                    seen.add(tuple(c))
                    cycles.append(c)
            elif nxt not in path:
                dfs(start, nxt, path + [nxt])

    for v in list(adj):
        dfs(v, v, [v])

    kept: list[list[int]] = []
    for c in sorted(cycles, key=len, reverse=True):
        if not any(set(c) & set(k) for k in kept):
            kept.append(c)
    return kept


def get_skeleton(cfg):
    """(colors per joint as RGB tuples, bone index pairs). A SKELETON of None
    (the empty list that ``create_new`` writes for a dataset without a
    skeleton reads back as None) is no skeleton; the JAX package's
    ``get_skeleton`` raises on it."""
    if cfg.SKELETON:
        names = list(cfg.KEYPOINT_NAMES)
        colors = [GRAY for _ in names]
        connections = np.zeros(len(names), dtype=int)
        line_idxs = []
        starting_idxs = []
        for bone in cfg.SKELETON:
            a = names.index(bone[0])
            b = names.index(bone[1])
            starting_idxs.append(a)
            line_idxs.append([a, b])
            connections[a] += 1
            connections[b] += 1

        color_idx = 0
        cycles = _find_cycles(line_idxs)
        for cycle in cycles:
            for point in cycle:
                colors[point] = BASE_COLORS[color_idx]
            color_idx = (color_idx + 1) % len(BASE_COLORS)

        in_cycle = {p for c in cycles for p in c}
        accounted: set[int] = set()
        for seed in np.nonzero(connections == 1)[0]:
            if seed not in starting_idxs:
                continue
            idx = int(seed)
            colors[idx] = BASE_COLORS[color_idx]
            accounted.add(idx)
            fwd = [l[1] for l in line_idxs if l[0] == idx]
            back = [l[0] for l in line_idxs if l[1] == idx]
            while len(fwd) == 1 and len(back) < 2:
                idx = fwd[0]
                if connections[idx] < 3 or idx in in_cycle:
                    if idx in accounted:
                        colors[idx] = GRAY
                    else:
                        colors[idx] = BASE_COLORS[color_idx]
                        accounted.add(idx)
                fwd = [l[1] for l in line_idxs if l[0] == idx]
                back = [l[0] for l in line_idxs if l[1] == idx]
            color_idx = (color_idx + 1) % len(BASE_COLORS)

        for point in np.nonzero(connections == 0)[0]:
            colors[point] = BASE_COLORS[color_idx]
            color_idx = (color_idx + 1) % len(BASE_COLORS)
        return colors, line_idxs

    J = int(cfg.KEYPOINTDETECT.NUM_JOINTS)
    colors = [tuple((np.array(jet(i / J)) * 255).astype(int)[:3].tolist()) for i in range(J)]
    return colors, []
