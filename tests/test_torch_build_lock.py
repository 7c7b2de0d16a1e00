"""The cross-process build lock of ``native/build.py`` (which the CUDA
kernels' build uses too): two processes started together that need the
same library compile it once, with g++, and both load it.

The compile command is g++ behind a wrapper that logs each run and
sleeps a little, so the second process surely arrives while the first
builds. The source carries a fresh token, so no earlier build exists.
"""

import os
import subprocess
import sys
import textwrap
import uuid

import pytest

from paddlebox_tpu_torch.native import build as build_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROC = textwrap.dedent("""
    import ctypes, sys
    sys.path.insert(0, {repo!r})
    from paddlebox_tpu_torch.native import build as build_lib
    path = build_lib.build("libbuildlocktest", [{src!r}], [], {cmd!r})
    lib = ctypes.CDLL(path)
    lib.pbt_token.restype = ctypes.c_int
    print(path, lib.pbt_token())
""")


def test_two_processes_build_once(tmp_path):
    cxx = build_lib.cxx_command()
    if cxx is None:
        pytest.fail("no C++ compiler: the port's host libraries need g++")
    token = uuid.uuid4().int % 100000
    src = tmp_path / "lock_test.cc"
    src.write_text(f'extern "C" int pbt_token() {{ return {token}; }}\n'
                   f"// {uuid.uuid4().hex}\n")
    log = tmp_path / "runs.log"
    wrapper = tmp_path / "cxx.sh"
    wrapper.write_text(f'#!/bin/sh\necho run >> "{log}"\nsleep 1\n'
                       f'exec "$@"\n')
    wrapper.chmod(0o755)
    cmd = [str(wrapper), *cxx]
    script = tmp_path / "proc.py"
    script.write_text(PROC.format(repo=REPO, src=str(src), cmd=cmd))
    procs = [subprocess.Popen([sys.executable, str(script)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    path = build_lib.output_path("libbuildlocktest", [str(src)], cmd)
    try:
        assert [o[0] for o in outs] == [path, path]
        assert [int(o[1]) for o in outs] == [token, token]
        assert log.read_text().splitlines() == ["run"]   # compiled once
        assert not [n for n in os.listdir(build_lib.BUILD_DIR)
                    if n.startswith(os.path.basename(path))
                    and n.endswith(".tmp")]
    finally:
        for p in (path, f"{path}.lock"):
            if os.path.exists(p):
                os.unlink(p)
