#!/usr/bin/env python3
"""Overlay the SLAM pose path against the odometry path as a PNG.

Equivalent of the reference's rospy helper `src/test/path_publisher:11-32`
(republish `/ndtpso/pose` + `/odom` as `nav_msgs/Path` for RViz overlay) —
without RViz: reads the node's ``.pose.csv`` export (and optionally an odom
CSV from tools/odom_export.py) and renders both trajectories into one image
via the native PNG writer.
"""

import argparse
import sys

import numpy as np


def _read_csv(path, cols):
    rows = []
    with open(path) as f:
        next(f)  # header
        for line in f:
            parts = line.strip().split(",")
            try:
                rows.append([float(parts[c]) for c in cols])
            except (ValueError, IndexError):
                continue
    return np.array(rows)


def main(argv=None):
    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    ap = argparse.ArgumentParser()
    ap.add_argument("pose_csv", help="<name>.pose.csv from the SLAM node")
    ap.add_argument("--odom-csv", help="odom CSV (tools/odom_export.py)")
    ap.add_argument("--out", default=None, help="default: <pose_csv>.paths.png")
    ap.add_argument("--density", type=int, default=20, help="pixels per meter")
    args = ap.parse_args(argv)

    from ndtpso_slam.utils import native

    pose_xy = _read_csv(args.pose_csv, [1, 2])
    odom_xy = (
        _read_csv(args.odom_csv, [1, 2])
        if args.odom_csv
        else _read_csv(args.pose_csv, [4, 5])
    )
    pts = [p for p in (pose_xy, odom_xy) if len(p)]
    allp = np.concatenate(pts) if pts else np.zeros((1, 2))
    lo, hi = allp.min(0) - 2.0, allp.max(0) + 2.0
    size = (np.ceil((hi - lo) * args.density).astype(int) + 1)[::-1]  # rows, cols
    img = np.full((size[0], size[1], 3), 255, np.uint8)

    def draw(xy, color):
        if not len(xy):
            return
        px = ((xy[:, 0] - lo[0]) * args.density).astype(int)
        py = size[0] - 1 - ((xy[:, 1] - lo[1]) * args.density).astype(int)
        # connect consecutive samples with dense interpolation
        for i in range(len(px) - 1):
            n = max(abs(px[i + 1] - px[i]), abs(py[i + 1] - py[i]), 1)
            for t in np.linspace(0, 1, n + 1):
                x = int(px[i] + t * (px[i + 1] - px[i]))
                y = int(py[i] + t * (py[i + 1] - py[i]))
                if 0 <= y < size[0] and 0 <= x < size[1]:
                    img[y, x] = color

    draw(odom_xy, (40, 40, 255))  # odometry: blue
    draw(pose_xy, (255, 0, 0))  # SLAM: red
    out = args.out or args.pose_csv + ".paths.png"
    native.write_png(out, img)
    print(f"wrote {out} (red = SLAM pose, blue = odometry)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
