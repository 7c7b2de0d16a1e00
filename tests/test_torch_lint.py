"""The port's lint gate: pblint over ``paddlebox_tpu_torch`` finds no
unwaived finding, the way tests/test_lint_clean.py holds the JAX package.

The linter runs in a subprocess with ``PBTPU_NO_JAX=1`` over a
``Project`` built through pblint's Python API: the package is the port
(so its ``paddlebox_tpu_torch.config`` flag reads and
``paddlebox_tpu_torch.utils.faultpoint`` sites are the ones resolved)
and the port's own ``monitor/context.py`` is the sanctioned thread
wrapper (its ``spawn`` is how the port starts threads, so no
``thread-context`` waiver is left), while the flag, faultpoint and
event/span name registries stay the JAX package's, so every literal
``monitor.event`` / ``span`` name and faultpoint name in the port is held
to them. Each waiver in the port carries its reason (a waiver without
one is itself a ``bad-waiver`` finding).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LINT = r"""
import json, sys
from paddlebox_tpu.analysis.core import Linter, Project
project = Project(root=sys.argv[1], package="paddlebox_tpu_torch",
                  thread_context_module="paddlebox_tpu_torch/monitor/context.py")
res = Linter(project).lint(["paddlebox_tpu_torch"])
print(json.dumps({
    "files": res.files_linted,
    "findings": [f.render() for f in res.findings],
    "waived": [[f.rule, f.file, f.line] for f, _ in res.waived]}))
"""


def test_port_is_lint_clean():
    proc = subprocess.run(
        [sys.executable, "-c", _LINT, REPO], cwd=REPO, capture_output=True,
        text=True, timeout=300, env={**os.environ, "PBTPU_NO_JAX": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["files"] > 50, out
    assert out["findings"] == [], (
        "pblint found unwaived findings in the port:\n"
        + "\n".join(out["findings"]))
    # the waivers are real (their markers suppress findings), and none is
    # a thread-context one: every port thread spawns through
    # monitor.context
    rules = [w[0] for w in out["waived"]]
    assert "thread-context" not in rules, out["waived"]
    # 15: the remote reads' early-exit pipe, CommandFS's between-attempt
    # cleanup and the checkpoint mirror's own snapshots.donefile writes
    # (the reference's waivers at the same sites) joined the 7 before,
    # then the rendezvous FileStore's two (distributed/store.py, copied
    # with the reference's waivers at the same sites), then the serving
    # fleet's three (serving/fleet.py: a retaken lease's release, the
    # first spawn's missing port file, a replica's health before its
    # HTTP bind — the reference's waivers at the same sites)
    assert len(rules) == 18, out["waived"]
