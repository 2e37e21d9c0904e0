"""Entry-point contract tests.

dryrun_multichip must be SELF-CONTAINED: invoked in a fresh process
with no JAX_PLATFORMS / XLA_FLAGS env vars, it must force the CPU
backend itself and run one sharded step.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_clean_subprocess():
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME")
    }
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c",
         "from __graft_entry__ import dryrun_multichip;"
         "dryrun_multichip(8)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, (
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    )
    assert "8 devices, one sharded step OK" in proc.stdout
