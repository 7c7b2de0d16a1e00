"""The port's lint gate: pblint over ``paddlebox_tpu_torch`` finds no
unwaived finding, the way tests/test_lint_clean.py holds the JAX package.

The CLI runs in a subprocess with ``PBTPU_NO_JAX=1``, exactly as over
``paddlebox_tpu``; each waiver in the port carries its reason (a waiver
without one is itself a ``bad-waiver`` finding).
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_is_lint_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "paddlebox_tpu.analysis.lint",
         "paddlebox_tpu_torch"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PBTPU_NO_JAX": "1"})
    assert proc.returncode == 0, (
        "pblint found unwaived findings in the port:\n"
        + proc.stdout + proc.stderr)
    m = re.search(r"(\d+) finding\(s\), (\d+) waived", proc.stdout)
    assert m is not None, proc.stdout
    assert m.group(1) == "0", proc.stdout
    # the waivers are real: the restored markers suppress their findings
    assert int(m.group(2)) >= 6, proc.stdout
