#!/usr/bin/env python
"""Convert between scan-log containers: ROS1 .bag <-> .npz / .csv / .ndtlog.

The ingestion half of the reference's rosbag workflow
(`/root/reference/README.md` records with `rosbag`, the node replays live):

    python tools/bag_convert.py recording.bag out.npz [--scan-topic /scan]
    python tools/bag_convert.py log.npz out.bag        # back into ROS land
    python tools/bag_convert.py recording.bag out.csv

The output extension picks the writer; odometry (if present) rides along.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="input log (.bag/.npz/.csv/.ndtlog)")
    ap.add_argument("dst", help="output log (.bag/.npz/.csv/.ndtlog)")
    ap.add_argument("--scan-topic", default=None,
                    help="bag input: LaserScan topic (default: first found)")
    ap.add_argument("--odom-topic", default=None,
                    help="bag input: Odometry topic (default: first found)")
    args = ap.parse_args(argv)

    if args.src.endswith(".bag"):
        from ndtpso_slam.io.rosbag import read_bag

        log = read_bag(args.src, scan_topic=args.scan_topic,
                       odom_topic=args.odom_topic)
    else:
        from ndtpso_slam.io.importers import load_log

        log = load_log(args.src)

    t, n = log.ranges.shape
    print(f"[bag_convert] {args.src}: {t} scans x {n} beams, "
          f"angle_min={log.angle_min:.4f}, range_max={log.range_max:.1f}",
          file=sys.stderr)

    if args.dst.endswith(".bag"):
        from ndtpso_slam.io.rosbag import write_bag

        write_bag(
            args.dst, log.ranges, log.timestamps, log.angle_min,
            log.angle_increment, log.range_max,
            odoms=None if log.odoms is None else np.asarray(log.odoms),
        )
    elif args.dst.endswith(".csv"):
        from ndtpso_slam.io.importers import write_scan_csv

        write_scan_csv(
            args.dst, log.ranges, log.timestamps, log.angle_min,
            log.angle_increment, log.range_max,
            odoms=None if log.odoms is None else np.asarray(log.odoms),
        )
    elif args.dst.endswith(".npz"):
        np.savez_compressed(
            args.dst, ranges=log.ranges, timestamps=log.timestamps,
            angle_min=log.angle_min, angle_increment=log.angle_increment,
            range_max=log.range_max,
            **({} if log.poses is None else {"poses": log.poses}),
            **({} if log.odoms is None else {"odoms": log.odoms}),
        )
    else:
        from ndtpso_slam.utils import native

        native.scanlog_write(
            args.dst, log.ranges,
            np.zeros((t, 3)) if log.poses is None else log.poses,
            np.zeros((t, 3)) if log.odoms is None else log.odoms,
            log.timestamps, log.angle_min, log.angle_increment, log.range_max,
        )
    print(f"[bag_convert] wrote {args.dst}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
