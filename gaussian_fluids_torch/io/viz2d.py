"""2D figures: the reference's per-frame PNGs (velocity quiver with the
Gaussians' ellipses, the clean velocity, the vorticity and divergence
heatmaps), a copy of the JAX package's ``io/viz2d.py``, and the 3D loss
curves ``loss_{n}.png``.

matplotlib (Agg) is imported inside the drawing functions only, never
when the module is imported: the card's machine has no matplotlib, and
there ``figures_on`` prints one line at the start of a run and the run
draws no PNG (and computes no figure arrays); what else it writes is
written as usual.
"""

from __future__ import annotations

import random

import numpy as np

from gaussian_fluids_torch.utils.grids import grid_points_2d


def available() -> bool:
    """Whether matplotlib can be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def figures_on(viz: bool, what: str) -> bool:
    """Whether a run with ``viz`` draws its PNGs: ``viz`` and matplotlib
    present. With ``viz`` on and matplotlib missing it prints one line
    naming the module and the figures ``what`` it skips."""
    if not viz:
        return False
    if available():
        return True
    print(f"[viz] matplotlib is not installed: {what} are not drawn "
          f"(pass --no_viz to silence this line)", flush=True)
    return False


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def show_field(field_fn, x_min, x_max, y_min, y_max, dim=1,
               x_n=100, y_n=100, additional_drawing=None,
               save_filename=None):
    """Quiver (dim=2) or jet heatmap (dim=1) of a field callable
    ((B, 2) -> (B, dim)) over a grid (reference 2D/GSR.py:675-698)."""
    plt = _pyplot()
    xy = grid_points_2d(x_min, x_max, y_min, y_max, x_n, y_n)
    out = np.asarray(field_fn(xy))
    if dim == 1:
        h = out.reshape(y_n, x_n)
        plt.axis("equal")
        plt.imshow(h, extent=[x_min, x_max, y_min, y_max], origin="lower",
                   cmap="jet")
        plt.colorbar()
    else:
        u, v = out[:, 0], out[:, 1]
        plt.axis("equal")
        if np.any((u ** 2 + v ** 2) != 0):
            plt.quiver(xy[:, 0], xy[:, 1], u, v)
    if additional_drawing:
        additional_drawing()
    if save_filename:
        plt.savefig(save_filename)
        plt.clf()
    plt.close("all")


def draw_ellipses(mix, indices=None, scattering=True, max_ellipses=20):
    """Overlay Gaussian 1-sigma ellipses (reference 2D/GSR.py:701-710);
    ``mix`` holds numpy rows of the alive Gaussians (``compact()``)."""
    plt = _pyplot()
    from matplotlib.patches import Ellipse
    m = mix.compact()
    pos = np.asarray(m.positions)
    sca = np.asarray(m.scalings)
    rot = np.asarray(m.rotations)
    if scattering:
        plt.scatter(pos[:, 0], pos[:, 1], s=0.5, color="red")
    ax = plt.gca()
    n = pos.shape[0]
    ids = (random.sample(range(n), min(max_ellipses, n))
           if indices is None else indices)
    for i in ids:
        width, height = 1.0 / np.exp(sca[i])
        ax.add_patch(Ellipse(pos[i], width, height,
                             angle=rot[i] / np.pi * 180.0, fill=False))


def plot_loss_curves(curves, path):
    """The 3D frame's 2x2 loss-curve figure, the JAX package's
    ``simulate3d._plot_loss_curves`` (reference 3D/advance.py:317-331):
    train vor (log lr on a twin axis), train div, test vor, test div."""
    plt = _pyplot()
    _, axs = plt.subplots(2, 2, figsize=(12, 10))
    axs[0, 0].plot(curves["train_vor"])
    axs[0, 0].twinx().plot(curves["log_lr"], color="orange")
    axs[0, 0].set_title("Vorticity training loss")
    axs[0, 1].plot(curves["train_div"])
    axs[0, 1].set_title("Divergence training loss")
    axs[1, 0].plot(curves["test_vor"])
    axs[1, 0].set_title("Vorticity test loss")
    axs[1, 1].plot(curves["test_div"])
    axs[1, 1].set_title("Divergence test loss")
    plt.tight_layout()
    plt.savefig(path)
    plt.close("all")
