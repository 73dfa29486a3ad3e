#!/usr/bin/env python3
"""Dump a scan log's odometry stream as CSV.

Equivalent of the reference's rospy helper `src/test/odom_export:8-14`
(subscribe /odom, print ``t x y theta`` rows) for recorded logs: reads a
``.ndtlog``/``.npz`` scan log and writes the odometry trajectory so it can be
compared offline against the SLAM pose CSV.
"""

import argparse
import sys


def main(argv=None):
    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    ap = argparse.ArgumentParser()
    ap.add_argument("scanlog")
    ap.add_argument("--out", default=None, help="default: <scanlog>.odom.csv")
    args = ap.parse_args(argv)

    from ndtpso_slam.node import _load_log

    log = _load_log(args.scanlog)
    out = args.out or args.scanlog + ".odom.csv"
    with open(out, "w") as f:
        f.write("timestamp,x,y,theta\n")
        for t, o in zip(log.timestamps, log.odoms):
            f.write(f"{t:.6f},{o[0]:.5f},{o[1]:.5f},{o[2]:.5f}\n")
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
