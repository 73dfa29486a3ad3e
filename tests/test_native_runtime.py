"""Native runtime IO: scan-log roundtrip, CSV/gnuplot/PNG export."""

import os
import struct
import zlib

import numpy as np
import pytest

from ndtpso_slam.io import synthetic
from ndtpso_slam.utils import native


def test_scanlog_roundtrip(tmp_path):
    log = synthetic.make_log(seed=1, n_scans=7, n_beams=90, world_size=30.0)
    path = str(tmp_path / "log.ndtlog")
    native.scanlog_write(
        path, log.ranges, log.poses, log.odoms, log.timestamps,
        log.angle_min, log.angle_increment, log.range_max,
    )
    back = native.scanlog_read(path)
    np.testing.assert_array_equal(back.ranges, log.ranges)
    np.testing.assert_array_equal(back.poses, log.poses)
    np.testing.assert_array_equal(back.odoms, log.odoms)
    np.testing.assert_array_equal(back.timestamps, log.timestamps)
    assert back.angle_min == log.angle_min
    assert back.range_max == log.range_max


def test_scanlog_read_bad_file(tmp_path):
    path = str(tmp_path / "junk.ndtlog")
    with open(path, "wb") as f:
        f.write(b"NOTALOG" + b"\0" * 100)
    with pytest.raises(IOError):
        native.scanlog_read(path)


def test_pose_csv(tmp_path):
    path = str(tmp_path / "out.pose.csv")
    poses = np.array([[1.0, 2.0, 0.5], [1.1, 2.1, 0.6]])
    odoms = poses + 0.01
    native.write_pose_csv(path, [10.5, 10.6], poses, odoms)
    lines = open(path).read().strip().split("\n")
    assert lines[0] == "timestamp,xP,yP,thP,xO,yO,thO"
    assert lines[1] == "10.500000,1.00000,2.00000,0.50000,1.01000,2.01000,0.51000"
    assert len(lines) == 3


def test_map_csv_and_gnuplot(tmp_path):
    mpath = str(tmp_path / "out.map.csv")
    native.write_map_csv(mpath, np.array([[0.5, -1.25]]))
    assert open(mpath).read() == "x,y\n0.50000,-1.25000\n"
    gpath = str(tmp_path / "out.gnuplot")
    native.write_gnuplot(gpath, "out", True, True)
    text = open(gpath).read()
    assert "out.map.csv" in text and "out.pose.csv" in text
    assert text.startswith("set datafile separator ','")


def _decode_png(path):
    data = open(path, "rb").read()
    assert data[:8] == bytes([137, 80, 78, 71, 13, 10, 26, 10])
    pos, chunks = 8, {}
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        expect_crc = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])[0]
        assert zlib.crc32(ctype + payload) & 0xFFFFFFFF == expect_crc
        if ctype == b"IDAT":
            idat += payload
        else:
            chunks[ctype] = payload
        pos += 12 + length
    w, h, depth, ctype_ = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    raw = zlib.decompress(idat)
    channels = 1 if ctype_ == 0 else 3
    stride = w * channels + 1
    rows = [raw[i * stride + 1 : (i + 1) * stride] for i in range(h)]
    img = np.frombuffer(b"".join(rows), np.uint8).reshape(h, w, channels)
    return img.squeeze()


def test_png_gray_roundtrip(tmp_path):
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (33, 70), dtype=np.uint8)
    path = str(tmp_path / "g.png")
    native.write_png(path, img)
    np.testing.assert_array_equal(_decode_png(path), img)


def test_png_rgb_roundtrip(tmp_path):
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (21, 45, 3), dtype=np.uint8)
    path = str(tmp_path / "c.png")
    native.write_png(path, img)
    np.testing.assert_array_equal(_decode_png(path), img)
