"""Map/trajectory export: the `NDTFrame::dumpMap` capability set.

Replicates the reference export surface (`ndtframe.cpp:268-422`):
``<name>.pose.csv``, ``<name>.map.csv``, ``<name>.gnuplot``, a rendered map
image (grid + points + pose path, OpenCV upstream), and the cropped
occupancy-grid PNG — using the native runtime writers (no OpenCV) and NumPy
rasterization.  File-name patterns (including the parameter-stamped image
names) follow `ndtframe.cpp:392,415`.

Design note: the engine does not store raw per-cell point buffers (SURVEY.md
§7 — they are replaced by second moments), so the exported "map points" are
the host-side accumulated point cloud kept by the node (`GlobalMap`), exactly
the role of the reference's export-only ``global_map_`` frame
(`ndtpso_slam_node.cpp:73-74`).  Cell Gaussians can additionally be exported
as a ``.cells.csv`` (mean/covariance per built cell) — a capability the
reference lacks.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ndtpso_slam.config import MapConfig, OccupancyGridConfig, PSOConfig
from ndtpso_slam.utils import native


class GlobalMap:
    """Host-side export-only point/pose container (the reference's
    ``global_map_`` NDTFrame-with-one-cell, `ndtpso_slam_node.cpp:73-74`)."""

    def __init__(self, keep_every: int = 10):
        # SAVE_DATA_TO_FILE_EACH_NUM_ITERS = 10 (`ndtpso_slam_node.hpp:18`)
        self.keep_every = keep_every
        self._points = []
        self._poses = []
        self._odoms = []
        self._timestamps = []
        self._n_scans = 0

    def add_scan(self, points: np.ndarray, valid: np.ndarray, pose: np.ndarray):
        """Store a scan's world-frame points every ``keep_every`` scans
        (`ndtpso_slam_node.cpp:200-205`)."""
        if self._n_scans % self.keep_every == 0:
            c, s = np.cos(pose[2]), np.sin(pose[2])
            p = np.asarray(points, np.float64)[np.asarray(valid, bool)]
            world = np.stack(
                [
                    p[:, 0] * c - p[:, 1] * s + pose[0],
                    p[:, 0] * s + p[:, 1] * c + pose[1],
                ],
                axis=-1,
            )
            self._points.append(world)
        self._n_scans += 1

    def add_pose(self, timestamp: float, pose, odom=None):
        """`NDTFrame::addPose` (`ndtframe.cpp:200-206`), every scan."""
        self._timestamps.append(float(timestamp))
        self._poses.append(np.asarray(pose, np.float64))
        self._odoms.append(
            np.asarray(odom, np.float64) if odom is not None else np.zeros(3)
        )

    @property
    def points(self) -> np.ndarray:
        return (
            np.concatenate(self._points) if self._points else np.zeros((0, 2))
        )

    @property
    def poses(self) -> np.ndarray:
        return np.array(self._poses).reshape(-1, 3)

    @property
    def odoms(self) -> np.ndarray:
        return np.array(self._odoms).reshape(-1, 3)

    @property
    def timestamps(self) -> np.ndarray:
        return np.array(self._timestamps)


def render_map_image(
    points: np.ndarray,
    poses: np.ndarray,
    size_m: float,
    density: int = 100,
) -> np.ndarray:
    """Rasterize the reference's map image (`ndtframe.cpp:297-348`): white
    canvas, 1 m gray grid, black map points, red pose dots with a heading
    tick on every 5th pose.  Returns [H, W, 3] uint8 (y up -> row down)."""
    size = int(size_m * density)
    img = np.full((size, size, 3), 255, np.uint8)
    # Grid lines each meter (gray 180)
    for i in range(0, size, density):
        img[i, :] = 180
        img[:, i] = 180

    def to_px(xy):
        x = (size // 2) + (xy[:, 0] * density).astype(int)
        y = (size // 2) - (xy[:, 1] * density).astype(int)
        ok = (x >= 0) & (x < size) & (y >= 0) & (y < size)
        return x[ok], y[ok]

    if len(points):
        x, y = to_px(np.asarray(points))
        img[y, x] = 0
    if len(poses):
        poses = np.asarray(poses)
        for k, p in enumerate(poses):
            x = (size // 2) + int(p[0] * density)
            y = (size // 2) - int(p[1] * density)
            if not (0 <= x < size and 0 <= y < size):
                continue
            if k % 5 == 0:  # heading tick (`ndtframe.cpp:334-339`)
                dx = 0.5 * np.cos(p[2])
                dy = 0.5 * np.sin(p[2])
                n = max(int(density * 0.5), 1)
                for t in np.linspace(0, 1, n):
                    xx = x + int(t * dx * density)
                    yy = y - int(t * dy * density)
                    if 0 <= xx < size and 0 <= yy < size:
                        img[yy, xx] = (80, 40, 40)
            y0, y1 = max(y - 1, 0), min(y + 2, size)
            x0, x1 = max(x - 1, 0), min(x + 2, size)
            img[y0:y1, x0:x1] = (255, 0, 0)
    return img


def render_og_image(og: np.ndarray, bbox) -> Optional[np.ndarray]:
    """Cropped occupancy-grid raster as grayscale (`ndtframe.cpp:398-419`):
    255 - og*2.55 where occupied, white elsewhere, y flipped."""
    min_x, max_x, min_y, max_y = (int(v) for v in bbox)
    if max_x < min_x or max_y < min_y:
        return None
    crop = np.asarray(og)[min_y : max_y + 1, min_x : max_x + 1]
    img = np.full(crop.shape, 255, np.uint8)
    occ = crop > 0
    img[occ] = (255.0 - crop[occ] * 2.55).astype(np.uint8)
    return img[::-1]  # y up


def dump_map(
    basename: str,
    global_map: Optional[GlobalMap] = None,
    save_poses: bool = True,
    save_points: bool = True,
    save_image: bool = False,
    density: int = 100,
    map_cfg: Optional[MapConfig] = None,
    pso_cfg: Optional[PSOConfig] = None,
    og: Optional[np.ndarray] = None,
    og_bbox=None,
    og_cfg: Optional[OccupancyGridConfig] = None,
    map_state=None,
) -> list:
    """Write the export bundle; returns the list of files written."""
    written = []
    points = global_map.points if global_map else np.zeros((0, 2))
    poses = global_map.poses if global_map else np.zeros((0, 3))
    if save_poses and global_map is not None:
        path = f"{basename}.pose.csv"
        native.write_pose_csv(path, global_map.timestamps, poses, global_map.odoms)
        written.append(path)
    if save_points:
        path = f"{basename}.map.csv"
        native.write_map_csv(path, points)
        written.append(path)
    if save_poses or save_points:
        path = f"{basename}.gnuplot"
        native.write_gnuplot(path, os.path.basename(basename), save_points, save_poses)
        written.append(path)
    if save_image and map_cfg is not None:
        w = int(map_cfg.size_m)
        pop = pso_cfg.population if pso_cfg else 0
        iters = pso_cfg.iterations if pso_cfg else 0
        path = (
            f"{basename}-w{map_cfg.window_slots}-{pop}p{iters}i-"
            f"{w}x{w}-c{map_cfg.cell_side_m:.2f}-{density}ppm.png"
        )
        native.write_png(path, render_map_image(points, poses, map_cfg.size_m, density))
        written.append(path)
    if og is not None and og_bbox is not None and og_cfg is not None and map_cfg is not None:
        img = render_og_image(og, og_bbox)
        if img is not None:
            h, w_ = np.asarray(og).shape
            path = (
                f"{basename}-{w_}x{h}-cell{og_cfg.cell_size_m:.2f}m-"
                f"occupancy-grid.png"
            )
            native.write_png(path, img)
            written.append(path)
    if map_state is not None and map_cfg is not None:
        written.append(export_cells_csv(f"{basename}.cells.csv", map_state, map_cfg))
    return written


def export_cells_csv(path: str, map_state, map_cfg: MapConfig) -> str:
    """Per-built-cell Gaussian summary (engine-only capability)."""
    from ndtpso_slam.models import ndt_map

    snap = ndt_map.snapshot(map_state, map_cfg)
    built = np.asarray(snap.built)
    mean = np.asarray(snap.mean)[built]
    icov = np.asarray(snap.inv_cov)[built]
    count = np.asarray(map_state.g_count)[built]
    with open(path, "w") as f:
        f.write("mean_x,mean_y,icov_xx,icov_xy,icov_yy,count\n")
        for m, ic, n in zip(mean, icov, count):
            f.write(
                f"{m[0]:.5f},{m[1]:.5f},{ic[0]:.6g},{ic[1]:.6g},{ic[2]:.6g},{int(n)}\n"
            )
    return path
