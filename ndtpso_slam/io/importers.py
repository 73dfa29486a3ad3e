"""Plain-text scan-log import/export (CSV) + unified log loading.

The reference's eval tooling exchanges poses as CSV text
(`/root/reference/src/test/odom_export:8-14`); this extends the same idea to
whole scan logs so any recorder that can print numbers can feed the engine.

Format (``# ndtpso-scan-csv v1``)::

    # ndtpso-scan-csv v1
    # angle_min=<float> angle_increment=<float> range_max=<float>
    # columns: timestamp[,odom_x,odom_y,odom_yaw],r0,r1,...
    <ts>,<r0>,<r1>,...

Odometry columns are optional and auto-detected from the header comment.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_MAGIC = "# ndtpso-scan-csv v1"


def write_scan_csv(
    path: str,
    ranges: np.ndarray,  # [T, N]
    timestamps: np.ndarray,  # [T]
    angle_min: float,
    angle_increment: float,
    range_max: float,
    odoms: Optional[np.ndarray] = None,  # [T, 3]
) -> None:
    with open(path, "w") as f:
        f.write(_MAGIC + "\n")
        f.write(
            f"# angle_min={angle_min!r} angle_increment={angle_increment!r} "
            f"range_max={range_max!r}\n"
        )
        cols = "timestamp"
        if odoms is not None:
            cols += ",odom_x,odom_y,odom_yaw"
        f.write(f"# columns: {cols},r0,r1,...\n")
        for i in range(ranges.shape[0]):
            row = [repr(float(timestamps[i]))]
            if odoms is not None:
                row += [repr(float(v)) for v in odoms[i]]
            row += [f"{float(r):.6g}" for r in ranges[i]]
            f.write(",".join(row) + "\n")


def read_scan_csv(path: str):
    from ndtpso_slam.io.synthetic import ScanLog

    with open(path) as f:
        first = f.readline().strip()
        if first != _MAGIC:
            raise IOError(f"{path}: not a {_MAGIC!r} file")
        meta = {}
        has_odom = False
        pos = f.tell()
        line = f.readline()
        while line.startswith("#"):
            if "angle_min=" in line:
                for part in line[1:].split():
                    if "=" in part:
                        k, v = part.split("=", 1)
                        meta[k] = float(v)
            if "columns:" in line:
                has_odom = "odom_x" in line
            pos = f.tell()
            line = f.readline()
        f.seek(pos)
        data = np.loadtxt(f, delimiter=",", ndmin=2)
    for key in ("angle_min", "angle_increment", "range_max"):
        if key not in meta:
            raise IOError(f"{path}: missing header field {key}")
    ts = data[:, 0]
    if has_odom:
        od = data[:, 1:4]
        ranges = data[:, 4:].astype(np.float32)
    else:
        od = np.zeros((data.shape[0], 3))
        ranges = data[:, 1:].astype(np.float32)
    return ScanLog(
        ranges=ranges, poses=od.copy(), odoms=od, timestamps=ts,
        angle_min=meta["angle_min"], angle_increment=meta["angle_increment"],
        range_max=meta["range_max"],
    )


def load_log(path: str):
    """Load a scan log of any supported container by extension:
    ``.bag`` (ROS1), ``.csv``, ``.npz``, ``.ndtlog`` (native runtime)."""
    if path.endswith(".bag"):
        from ndtpso_slam.io.rosbag import read_bag

        return read_bag(path)
    if path.endswith(".csv"):
        return read_scan_csv(path)
    if path.endswith(".npz"):
        from ndtpso_slam.io.synthetic import ScanLog

        d = np.load(path)
        return ScanLog(
            ranges=d["ranges"], poses=d.get("poses"), odoms=d.get("odoms"),
            timestamps=d["timestamps"], angle_min=float(d["angle_min"]),
            angle_increment=float(d["angle_increment"]),
            range_max=float(d["range_max"]),
        )
    from ndtpso_slam.utils import native

    return native.scanlog_read(path)
