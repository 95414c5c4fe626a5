"""Drawing on the host (torch port of the JAX package's ``obs/visual.py``).

The reference's drawing layer:

* bb8 bounding-box overlay — reference visual.py:8-57
  ``visualize_bounding_box``;
* pose axes — reference val.py:31-47 / utils.py:148-165;
* keypoints, voting-covariance ellipses, mask overlays — reference
  lib/utils/draw_utils.py:9-338;
* :func:`save_eval_panel`, the eval image panel that ``cli/train`` writes
  per held-out eval (the Recorder's image panels, net_utils.py:174-239).

Everything takes numpy arrays and an optional matplotlib axis.  matplotlib
is imported inside the drawing functions (the Agg backend for files), so
importing this module needs only numpy; :func:`bb8_corners` and
:func:`covariance_ellipse` need no plotting library at all.
"""

from __future__ import annotations

import numpy as np

# bb8 edge list: corners ordered as the 8 cuboid vertices (z-minor), the
# connectivity the reference draws
_BB8_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3),
              (4, 5), (4, 6), (5, 7), (6, 7),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def bb8_corners(points_3d: np.ndarray) -> np.ndarray:
    """Axis-aligned bounding-cuboid corners of a point set -> (8, 3)."""
    mn = points_3d.min(axis=0)
    mx = points_3d.max(axis=0)
    return np.array([[x, y, z] for x in (mn[0], mx[0])
                     for y in (mn[1], mx[1]) for z in (mn[2], mx[2])])


def draw_bounding_box(ax, corners_2d: np.ndarray, color='g',
                      linewidth=2.0) -> None:
    """A projected bb8 cuboid (visual.py:8-57).  corners_2d: (8, 2)."""
    for a, b in _BB8_EDGES:
        ax.plot([corners_2d[a, 0], corners_2d[b, 0]],
                [corners_2d[a, 1], corners_2d[b, 1]],
                color=color, linewidth=linewidth)


def _pyplot():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def visualize_bounding_box(image: np.ndarray, corners_pred: np.ndarray,
                           corners_target: np.ndarray | None = None,
                           save: bool = False, save_fn: str | None = None):
    """Image with predicted (green) and target (blue) boxes
    (visual.py:8-57 signature)."""
    plt = _pyplot()
    fig, ax = plt.subplots(1, 1)
    ax.imshow(image, cmap='gray' if image.ndim == 2 else None)
    for c in np.asarray(corners_pred).reshape(-1, 8, 2):
        draw_bounding_box(ax, c, color='g')
    if corners_target is not None:
        for c in np.asarray(corners_target).reshape(-1, 8, 2):
            draw_bounding_box(ax, c, color='b')
    if save and save_fn:
        fig.savefig(save_fn)
        plt.close(fig)
    return ax


def project_axes(q: np.ndarray, r: np.ndarray, K: np.ndarray | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Pixel x and y of the body origin and the three unit axes
    (utils.py:98-120), SPEED's camera unless ``K`` is given."""
    import torch

    from esa_pose_estimation_tpu_torch.core import camera
    Kt = (camera.speed_k() if K is None
          else torch.as_tensor(np.asarray(K), dtype=torch.float32))
    axes = torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    R = camera.quat_to_rotmat(torch.as_tensor(np.asarray(q),
                                              dtype=torch.float32))
    uv = camera.project_points(axes, R, torch.as_tensor(
        np.asarray(r), dtype=torch.float32), Kt).numpy()
    return uv[..., 0], uv[..., 1]


def draw_pose_axes(ax, q: np.ndarray, r: np.ndarray, K=None,
                   colors=('r', 'g', 'b')) -> None:
    """The projected body axes as arrows (utils.py:148-165)."""
    xa, ya = project_axes(q, r, K)
    for i, c in enumerate(colors):
        ax.arrow(xa[0], ya[0], xa[i + 1] - xa[0], ya[i + 1] - ya[0],
                 head_width=30, color=c)


def draw_keypoints(ax, keypoints: np.ndarray, scores=None, cmap='spring',
                   s=14.0):
    """Keypoints, coloured by confidence where given (draw_utils)."""
    kp = np.asarray(keypoints).reshape(-1, 2)
    c = None if scores is None else np.asarray(scores).reshape(-1)
    return ax.scatter(kp[:, 0], kp[:, 1], c=c, cmap=cmap, s=s)


def covariance_ellipse(mean: np.ndarray, cov: np.ndarray,
                       n_std: float = 2.0):
    """(centre, width, height, angle in degrees) of the n-sigma ellipse of a
    2x2 covariance (draw_utils voting ellipses)."""
    vals, vecs = np.linalg.eigh(cov)
    order = vals.argsort()[::-1]
    vals, vecs = vals[order], vecs[:, order]
    angle = np.degrees(np.arctan2(vecs[1, 0], vecs[0, 0]))
    width, height = 2 * n_std * np.sqrt(np.maximum(vals, 0.0))
    return mean, width, height, angle


def draw_covariance_ellipses(ax, means: np.ndarray, covs: np.ndarray,
                             n_std: float = 2.0, color='y') -> None:
    from matplotlib.patches import Ellipse
    for mean, cov in zip(np.asarray(means).reshape(-1, 2),
                         np.asarray(covs).reshape(-1, 2, 2)):
        c, w, h, a = covariance_ellipse(mean, cov, n_std)
        ax.add_patch(Ellipse(c, w, h, angle=a, fill=False, color=color))


def overlay_mask(ax, image: np.ndarray, mask: np.ndarray, alpha=0.4,
                 color=(1.0, 0.0, 0.0)) -> None:
    """An image under a translucent mask (draw_utils mask panels)."""
    ax.imshow(image, cmap='gray' if image.ndim == 2 else None)
    overlay = np.zeros(mask.shape + (4,))
    overlay[..., :3] = color
    overlay[..., 3] = np.asarray(mask, np.float32) * alpha
    ax.imshow(overlay)


def save_eval_panel(path: str, frame: np.ndarray,
                    kp_pred: np.ndarray | None = None,
                    kp_gt: np.ndarray | None = None,
                    heatmaps: np.ndarray | None = None,
                    bbox: np.ndarray | None = None,
                    corners_pred: np.ndarray | None = None,
                    title: str = '') -> str:
    """Write one eval panel PNG: the frame with predicted (x) and
    ground-truth (o) keypoints, the detector box and an optional bb8
    overlay, and, where given, the heatmaps' max over keypoints beside it.

    frame: (H, W) grey levels [0, 255]; heatmaps: (S, S, K) in crop space.
    Returns ``path``.
    """
    plt = _pyplot()
    ncols = 2 if heatmaps is not None else 1
    fig, axes = plt.subplots(1, ncols, figsize=(6 * ncols, 4.2))
    axes = np.atleast_1d(axes)
    ax = axes[0]
    ax.imshow(np.asarray(frame), cmap='gray', vmin=0, vmax=255)
    if bbox is not None:
        x1, y1, x2, y2 = np.asarray(bbox, float)
        ax.plot([x1, x2, x2, x1, x1], [y1, y1, y2, y2, y1], 'c-',
                linewidth=1.0)
    if kp_gt is not None:
        kp_gt = np.asarray(kp_gt)
        ax.plot(kp_gt[:, 0], kp_gt[:, 1], 'o', color='lime', markersize=4,
                markerfacecolor='none', label='gt')
    if kp_pred is not None:
        kp_pred = np.asarray(kp_pred)
        ax.plot(kp_pred[:, 0], kp_pred[:, 1], 'rx', markersize=4,
                label='pred')
    if corners_pred is not None:
        draw_bounding_box(ax, np.asarray(corners_pred), color='y',
                          linewidth=1.0)
    if kp_pred is not None or kp_gt is not None:
        ax.legend(loc='upper right', fontsize=7)
    ax.set_title(title, fontsize=9)
    ax.axis('off')
    if heatmaps is not None:
        axes[1].imshow(np.asarray(heatmaps, np.float32).max(axis=-1),
                       cmap='magma')
        axes[1].set_title('heatmap max-composite', fontsize=9)
        axes[1].axis('off')
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
