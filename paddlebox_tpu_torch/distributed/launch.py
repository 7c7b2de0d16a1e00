"""One process per card — ``python -m paddlebox_tpu_torch.distributed.
launch`` (the port of ``distributed/launch.py``).

Spawns ``--nprocs`` workers with the rank, endpoint, coordinator, store
and run-id variables ``RoleMaker.from_env`` reads, plus ``LOCAL_RANK``
(``RoleMaker.init_distributed`` makes that card current before the
process group forms). A worker that exits nonzero stops the others,
unless ``fail_stop=False`` (an elastic launch, where one rank dying is
the event under test).

Usage:
    python -m paddlebox_tpu_torch.distributed.launch --nprocs 2 -- \\
        python train_script.py
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import uuid


def _free_ports(n: int) -> list[int]:
    # all probe sockets stay open until every port is collected, or the
    # kernel can hand a just-released port out twice
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def launch(nprocs: int, cmd: list[str], store_dir: str | None = None,
           base_env: dict | None = None, timeout_s: float | None = None,
           local_ranks: list[int] | None = None, fail_stop: bool = True):
    """Spawn ``nprocs`` workers running ``cmd``.

    ``fail_stop=True``: returns the first nonzero exit code (the others
    are terminated then), 124 when ``timeout_s`` ran out, else 0.
    ``fail_stop=False`` (elastic launches): waits for every worker to
    exit on its own (up to ``timeout_s``, then the live ones are
    terminated) and returns the list of per-rank exit codes.
    ``local_ranks``: each worker's ``LOCAL_RANK`` (default: its rank),
    e.g. ``[0, 0]`` for two ranks on one card."""
    store_dir = store_dir or tempfile.mkdtemp(prefix="pbt_store_")
    ports = _free_ports(nprocs + 1)
    endpoints = ",".join(f"127.0.0.1:{p}" for p in ports[:nprocs])
    coordinator = f"127.0.0.1:{ports[nprocs]}"
    run_id = uuid.uuid4().hex[:12]
    procs: list[subprocess.Popen] = []
    for rank in range(nprocs):
        env = dict(os.environ)
        env.update(base_env or {})
        env["PBTPU_TRAINER_ID"] = str(rank)
        env["PBTPU_TRAINER_ENDPOINTS"] = endpoints
        env["PBTPU_COORDINATOR"] = coordinator
        env["PBTPU_STORE_DIR"] = store_dir
        env["PBTPU_RUN_ID"] = run_id
        env["LOCAL_RANK"] = str(rank if local_ranks is None
                                else local_ranks[rank])
        procs.append(subprocess.Popen(cmd, env=env))
    code = 0
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        live = set(range(nprocs))
        while live and (code == 0 or not fail_stop):
            if deadline is not None and time.monotonic() > deadline:
                if fail_stop:
                    code = 124
                break
            for i in sorted(live):
                rc = procs[i].poll()
                if rc is None:
                    continue
                live.discard(i)
                if rc != 0 and code == 0:
                    code = rc
                    if fail_stop:
                        break
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if not fail_stop:
        return [p.returncode for p in procs]
    return code


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nprocs", type=int, required=True,
                    help="worker processes (one per card) to spawn")
    ap.add_argument("--store-dir", default=None,
                    help="shared rendezvous dir (default: fresh tmpdir)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="worker command (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("missing worker command")
    return launch(args.nprocs, cmd, store_dir=args.store_dir)


if __name__ == "__main__":
    sys.exit(main())
