"""Grid points with the reference's ordering: 2D meshgrid with 'xy'
indexing — y varies slowest, x fastest."""

from __future__ import annotations

import numpy as np


def grid_points_2d(x_min, x_max, y_min, y_max, x_n, y_n) -> np.ndarray:
    xs = np.linspace(x_min, x_max, x_n, dtype=np.float32)
    ys = np.linspace(y_min, y_max, y_n, dtype=np.float32)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    return np.stack([X, Y], axis=-1).reshape(-1, 2)
