"""Camera-pose visualisation (port of `bags_tpu/eval/vis.py`).

Optimised against ground-truth camera frusta as a matplotlib 3D figure
saved to PNG (`plot_poses`), the same geometry as a plotly figure dict
(`poses_to_plotly`), a stdlib client that pushes it to a visdom server
(`VisdomClient`), and the lens-residual quiver (`vector_field_figure`,
`log_vector_field`). matplotlib is imported only inside the functions
that draw.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..core.camera import CameraParams, pose_w2c


def camera_frustum_points(R_w2c: np.ndarray, t_w2c: np.ndarray,
                          scale: float = 0.1) -> np.ndarray:
    """5-point wireframe frustum (apex + image corners) in world space
    (`get_camera_mesh`)."""
    corners = np.array([
        [0.0, 0.0, 0.0],
        [-0.5, -0.5, 1.0],
        [0.5, -0.5, 1.0],
        [0.5, 0.5, 1.0],
        [-0.5, 0.5, 1.0],
    ]) * scale
    R_c2w = R_w2c.T
    center = -R_c2w @ t_w2c
    return corners @ R_c2w.T + center


def _frustum_lines(pts):
    order = [0, 1, 2, 0, 2, 3, 0, 3, 4, 0, 4, 1, 2, 3, 4, 1]
    return pts[order]


def _frusta(cams: CameraParams, scale: float):
    """Each camera's frustum polyline (16, 3) in world space."""
    R, t = (x.detach().cpu().numpy() for x in pose_w2c(cams))
    return [_frustum_lines(camera_frustum_points(R[i], t[i], scale))
            for i in range(len(R))]


def plot_poses(pred: CameraParams, gt: Optional[CameraParams] = None,
               path: str = "poses.png", scale: float = 0.1,
               title: str = "camera poses") -> None:
    """Matplotlib 3D wireframes, predicted (blue) against GT (red), saved to
    `path` (Agg backend)."""
    import matplotlib
    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")

    def draw(cams, color, label):
        for i, lines in enumerate(_frusta(cams, scale)):
            ax.plot(lines[:, 0], lines[:, 1], lines[:, 2], color=color,
                    linewidth=0.6, label=label if i == 0 else None)

    draw(pred, "tab:blue", "optimized")
    if gt is not None:
        draw(gt, "tab:red", "ground truth")
    ax.set_title(title)
    ax.legend()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def poses_to_plotly(pred: CameraParams, gt: Optional[CameraParams] = None,
                    scale: float = 0.1) -> dict:
    """Plotly figure dict of the frusta (`vis_cameras`' wire format), for
    plotly or a visdom `plotlyplot`."""

    def traces(cams, color, name):
        xs, ys, zs = [], [], []
        for lines in _frusta(cams, scale):
            xs += list(lines[:, 0]) + [None]
            ys += list(lines[:, 1]) + [None]
            zs += list(lines[:, 2]) + [None]
        return dict(type="scatter3d", mode="lines", name=name,
                    x=xs, y=ys, z=zs, line=dict(color=color, width=2))

    data = [traces(pred, "blue", "optimized")]
    if gt is not None:
        data.append(traces(gt, "red", "ground truth"))
    return dict(data=data,
                layout=dict(scene=dict(aspectmode="data"),
                            title="camera poses"))


class VisdomClient:
    """Visdom live-plot client without the visdom package: a JSON POST of
    `{data, win, eid, layout, opts}` to `http://host:port/events`, the
    plotly dict of `poses_to_plotly`. A failed send sets `ok` False and
    returns False (a dead dashboard must not stop a training run)."""

    def __init__(self, server: str = "localhost", port: int = 8600,
                 env: str = "main", timeout: float = 1.0):
        if not server.startswith("http"):
            server = "http://" + server
        self.url = f"{server}:{port}/events"
        self.env = env
        self.timeout = timeout
        self.ok = True

    def _send(self, payload: dict) -> bool:
        import http.client
        import urllib.request

        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                resp.read()
            self.ok = True
        except (OSError, http.client.HTTPException):
            self.ok = False
        return self.ok

    def plot_cameras(self, step: int, pred: CameraParams,
                     gt: Optional[CameraParams] = None,
                     scale: float = 0.1, win: str = "poses") -> bool:
        """Live equivalent of `vis_cameras(opt, vis, step, poses=...)`."""
        fig = poses_to_plotly(pred, gt, scale)
        fig["layout"]["title"] = f"({step})"
        return self._send(dict(
            data=fig["data"], win=win, eid=self.env, layout=fig["layout"],
            opts=dict(title=f"{self.env} poses ({step})")))


def vector_field_figure(residual: np.ndarray,
                        magnification: float = 1e5,
                        grid: int = 10) -> np.ndarray:
    """Quiver image of a lens-flow residual, as an (H, W, 4) uint8 array
    (`log_vector_field_to_wandb`): the (2, H, W) residual block-averaged
    onto a `grid` x `grid` field, magnified, image-style (inverted-y)
    axes."""
    import matplotlib
    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    res = np.asarray(residual)
    if res.ndim == 4:          # (1, 2, H, W), the reference's layout
        res = res[0]
    if res.ndim == 3 and res.shape[-1] == 2:   # (H, W, 2) flow layout
        res = np.moveaxis(res, -1, 0)
    U, V = res[0], res[1]
    h, w = U.shape
    bh, bw = h // grid, w // grid
    U = U[:bh * grid, :bw * grid].reshape(grid, bh, grid, bw).mean((1, 3))
    V = V[:bh * grid, :bw * grid].reshape(grid, bh, grid, bw).mean((1, 3))
    U, V = U * magnification, V * magnification
    X, Y = np.meshgrid(np.arange(grid), np.arange(grid))
    fig = plt.figure(figsize=(6, 6))
    plt.quiver(X, Y, U, V, angles="xy", scale_units="xy", scale=1,
               color="b")
    plt.title(f"Magnified vector field ({grid}x{grid})")
    plt.gca().invert_yaxis()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return img


def log_vector_field(logger, residual: np.ndarray, step: int,
                     path: Optional[str] = None,
                     magnification: float = 1e5) -> None:
    """Log the lens-residual quiver to a PNG at `path`. `logger` and `step`
    keep the JAX signature, whose wandb mirror the port does not have."""
    img = vector_field_figure(residual, magnification)
    if path is not None:
        import matplotlib
        matplotlib.use("agg")
        import matplotlib.pyplot as plt
        plt.imsave(path, img)
