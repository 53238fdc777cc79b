"""Visualization (counterpart of ``rustrobotics_tpu/utils/plot.py``).

matplotlib-based and imported only inside the plotting calls, so a path
that does not plot never needs matplotlib. Covers filter-history charts
with covariance ellipses, landmark-map plots and pose-graph scatter plots
per optimizer iteration. Tensors are read through ``.cpu().numpy()``
(``_host``); numpy arrays and lists are taken as they are.
"""

from __future__ import annotations

import numpy as np


def _host(a):
    """A tensor (any device) or array-like -> numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def covariance_ellipse(mean, cov, n_std=1.0, num_points=64):
    """Points (2, num_points) of the n-σ ellipse of a 2x2 covariance, by
    eigendecomposition."""
    mean = _host(mean)[:2]
    cov = _host(cov)[:2, :2]
    vals, vecs = np.linalg.eigh(cov)
    vals = np.maximum(vals, 0.0)
    t = np.linspace(0.0, 2.0 * np.pi, num_points)
    circle = np.stack([np.cos(t), np.sin(t)])
    pts = vecs @ (n_std * np.sqrt(vals)[:, None] * circle)
    return mean[:, None] + pts


def plot_filter_history(history, path, title="localization"):
    """Trajectory chart: truth / dead-reckoning / estimate / observations."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 6))
    x_true = _host(history["x_true"])
    x_dr = _host(history["x_dr"])
    x_est = _host(history["x_est"])
    z = _host(history["z"])
    ax.plot(x_true[:, 0], x_true[:, 1], "b-", label="ground truth")
    ax.plot(x_dr[:, 0], x_dr[:, 1], "k--", label="dead reckoning")
    ax.plot(x_est[:, 0], x_est[:, 1], "r-", label="estimate")
    ax.scatter(z[:, 0], z[:, 1], s=4, c="g", alpha=0.4, label="observations")
    cov = _host(history["cov_est"])[-1]
    ell = covariance_ellipse(x_est[-1], cov)
    ax.plot(ell[0], ell[1], "m-", lw=1, label="final 1σ")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def save_filter_gif(history, path, stride=10, fps=12, title="localization"):
    """Animated filter run: growing truth/dead-reckoning/estimate traces
    plus the current 1-sigma covariance ellipse, rendered with matplotlib
    animation in one pass."""
    from matplotlib.animation import FuncAnimation, PillowWriter

    plt = _mpl()
    x_true = _host(history["x_true"])
    x_dr = _host(history["x_dr"])
    x_est = _host(history["x_est"])
    z = _host(history["z"])
    covs = _host(history["cov_est"])
    frames = range(1, len(x_true) + 1, stride)

    fig, ax = plt.subplots(figsize=(7, 6))
    pad = 1.0
    ax.set_xlim(x_true[:, 0].min() - pad, x_true[:, 0].max() + pad)
    ax.set_ylim(x_true[:, 1].min() - pad, x_true[:, 1].max() + pad)
    ax.set_aspect("equal")
    ax.set_title(title)
    (l_true,) = ax.plot([], [], "b-", label="ground truth")
    (l_dr,) = ax.plot([], [], "k--", label="dead reckoning")
    (l_est,) = ax.plot([], [], "r-", label="estimate")
    sc = ax.scatter([], [], s=4, c="g", alpha=0.4, label="observations")
    (l_ell,) = ax.plot([], [], "m-", lw=1)
    ax.legend(loc="upper left", fontsize=8)

    def draw(k):
        l_true.set_data(x_true[:k, 0], x_true[:k, 1])
        l_dr.set_data(x_dr[:k, 0], x_dr[:k, 1])
        l_est.set_data(x_est[:k, 0], x_est[:k, 1])
        sc.set_offsets(z[:k, :2])
        ell = covariance_ellipse(x_est[k - 1], covs[k - 1])
        l_ell.set_data(ell[0], ell[1])
        return l_true, l_dr, l_est, sc, l_ell

    anim = FuncAnimation(fig, draw, frames=frames, blit=True)
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path


def plot_pose_graph(graph, path, title=None, covariances=None,
                    ellipse_stride=25):
    """Scatter of poses (and landmarks) with the pose sequence polyline.
    ``covariances``: optional (N, 3, 3) per-pose marginals
    (``mapping.pgo.pose_covariances``); draws 3-sigma position ellipses
    every ``ellipse_stride`` poses."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 7))
    poses2 = _host(graph.poses2)
    if poses2.size:
        ax.plot(poses2[:, 0], poses2[:, 1], "r-", lw=0.5)
        ax.scatter(poses2[:, 0], poses2[:, 1], s=4, c="b", label="poses")
        if covariances is not None:
            covs = _host(covariances)
            for i in range(0, len(poses2), ellipse_stride):
                ell = covariance_ellipse(poses2[i], covs[i], n_std=3.0)
                ax.plot(ell[0], ell[1], "c-", lw=0.6, alpha=0.7)
    lms = _host(graph.landmarks2)
    if lms.size:
        ax.scatter(lms[:, 0], lms[:, 1], marker="*", c="r", label="landmarks")
    poses3 = _host(graph.poses3)
    if poses3.size:
        ax.scatter(poses3[:, 0], poses3[:, 1], s=2, c="b", label="poses (xy of 3D)")
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    if (poses2.size and lms.size) or poses3.size:
        ax.legend()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_landmark_localization(states_xy, landmarks_xy, groundtruth_xy, path,
                               title="landmark localization"):
    """UTIAS-style map plot: estimate, ground truth and landmarks."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 6))
    gt = _host(groundtruth_xy)
    st = _host(states_xy)
    lm = _host(landmarks_xy)
    ax.plot(gt[:, 0], gt[:, 1], "b-", lw=0.8, label="ground truth")
    ax.plot(st[:, 0], st[:, 1], "r-", lw=0.8, label="estimate")
    ax.scatter(lm[:, 0], lm[:, 1], marker="*", s=80, c="k", label="landmarks")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path
