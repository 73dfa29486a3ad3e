#!/usr/bin/env python
"""Regenerate tests/data/realistic.bag + realistic_gt.npy.

A 60-scan 540-beam log with real-LiDAR failure modes (range noise, 5% beam
dropout, two moving clutter boxes, drifting odometry), packed as a ROS1 bag
— the committed end-to-end fixture for the real-data ingestion path.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
from ndtpso_slam.io.rosbag import write_bag
from ndtpso_slam.io.synthetic import make_realistic_log

here = os.path.dirname(os.path.abspath(__file__))
log = make_realistic_log(seed=12, n_scans=60, n_beams=540)
write_bag(
    os.path.join(here, "realistic.bag"), log.ranges, log.timestamps,
    log.angle_min, log.angle_increment, log.range_max,
    odoms=np.asarray(log.odoms),
)
np.save(os.path.join(here, "realistic_gt.npy"), np.asarray(log.poses))
print("wrote realistic.bag +", log.ranges.shape)
