"""Multi-HOST runtime test: 2 real processes, jax.distributed + gloo
collectives over the hierarchical (hosts, cards) mesh (SURVEY §4's
prescription; BASELINE config 5; VERDICT r1 item 1).

The heavy lifting (and all assertions) happens inside
tests/distributed_worker.py, launched twice with a shared coordinator; this
test checks both workers exit 0 and report every phase's OK marker.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_runtime():
    port = _free_port()
    workers = []
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            NDTPSO_COORDINATOR=f"localhost:{port}",
            NDTPSO_NUM_PROCESSES="2",
            NDTPSO_PROCESS_ID=str(pid),
            PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""),
        )
        # Workers configure their own XLA_FLAGS device count; drop the
        # parent conftest's so the values don't conflict.
        env.pop("XLA_FLAGS", None)
        workers.append(
            subprocess.Popen(
                [sys.executable, os.path.join(root, "tests", "distributed_worker.py")],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for pid, w in enumerate(workers):
        out, _ = w.communicate(timeout=560)
        outs.append(out)
        tail = "\n".join(out.splitlines()[-25:])
        assert w.returncode == 0, f"worker {pid} failed:\n{tail}"
    for pid, out in enumerate(outs):
        assert f"[p{pid}] WORKER OK" in out, f"worker {pid} missing OK marker"
        assert "dp solves over 2x4 mesh match local reference" in out
        assert "multi-swarm gbest exchange crossed hosts correctly" in out
        assert "psum map merge across processes equals serial ingestion" in out
