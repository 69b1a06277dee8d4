"""Real multi-process jax.distributed execution (SURVEY.md §2.4 comm row).

Unlike tests/test_parallel.py (one process faking 8 devices), this spawns
TWO separate worker processes that join a coordination service and run the
sharded SVGP step with psums genuinely crossing the process boundary, then
checks both workers agree with each other and with an in-process reference
run of the same deterministic problem.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _clean_env():
    env = dict(os.environ)
    # the workers configure their own device counts / platform
    env.pop("XLA_FLAGS", None)
    return env



def test_two_process_step_matches_single_process():
    port = _free_port()
    iters = 4
    procs = []
    for pid in (0, 1):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "distributed_worker.py"),
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--local-devices", "4", "--iters", str(iters)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=_clean_env(), text=True, cwd=REPO,
        ))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        line = [l for l in out.splitlines() if l.startswith("{")][-1]
        outs.append(json.loads(line))

    assert outs[0]["global_devices"] == 8
    # replicated outputs must agree across processes (same global program)
    np.testing.assert_allclose(outs[0]["elbo"], outs[1]["elbo"], rtol=1e-12)
    np.testing.assert_allclose(outs[0]["checksum"], outs[1]["checksum"],
                               rtol=1e-12)

    # and match the single-process 8-virtual-device reference (conftest
    # fakes 8 CPU devices in this test process)
    from gpsig.parallel import distributed_check as dc
    from gpsig.parallel import mesh as meshlib

    assert len(jax.devices()) == 8
    mesh = meshlib.make_mesh(data=8, tile=1)
    elbo_ref, checksum_ref = dc.run_steps(mesh, num_iters=iters)
    np.testing.assert_allclose(outs[0]["elbo"], elbo_ref, rtol=1e-10)
    np.testing.assert_allclose(outs[0]["checksum"], checksum_ref,
                               rtol=1e-10)


def test_measure_scaling_two_process_emits_artifact(tmp_path):
    """VERDICT r2 #9: the scaling-efficiency measurement must be
    CI-runnable in 2-process CPU mode so the BASELINE >=80% number is one
    command away on real hardware. Runs scripts/measure_scaling.py with
    two jax.distributed processes (2 virtual devices each) and checks
    process 0 emits a well-formed artifact row."""
    port = _free_port()
    emit = tmp_path / "scaling_row.json"
    common = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
              "--local-devices", "2", "--steps", "3",
              "--batch-per-device", "4", "--num-tensors", "8",
              "--seq-len", "16"]
    procs = []
    for pid in (0, 1):
        cmd = [sys.executable,
               os.path.join(REPO, "scripts", "measure_scaling.py"),
               *common, "--process-id", str(pid)]
        if pid == 0:
            cmd += ["--emit", str(emit)]
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=_clean_env(), text=True, cwd=REPO,
        ))
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"scaling worker failed:\n{err[-3000:]}"
    row = json.load(open(emit))
    assert row["devices"] == 4 and row["num_processes"] == 2
    assert row["steps_per_s"] > 0 and np.isfinite(row["elbo"])
