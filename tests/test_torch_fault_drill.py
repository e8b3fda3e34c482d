"""The port's fault drill (tools/fault_drill.py) as a subprocess: a two-rank
closed-loop study with each step's MIQP pool-sharded loses rank 1 after
step 2; the relaunch resumes from the per-step checkpoint, its trajectory
bitwise that of the uninterrupted two-rank study and its final state
within 1e-3 of the single-process study (the reference's
tests/test_multiprocess.py::test_fault_injection_and_resume). About 25 s
on the CPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_fault_drill_resumes_from_the_checkpoint():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "fault_drill.py"),
                        "--device", "cpu"],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "lost rank 1 as planned" in r.stdout
    assert "PASS" in r.stdout
