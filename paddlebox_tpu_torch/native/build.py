"""Build-on-first-use for the port's native libraries.

Every shared library the port loads (the host key index, the CUDA
kernels) is compiled from the sources in the checkout into
``paddlebox_tpu_torch/_build/``, which git ignores. The output name
carries a hash of the sources and the compile command, so an edited
source rebuilds. Concurrent processes that need the same library (the
ranks of a mesh started together, test workers) build it once: the
build holds an ``fcntl.flock`` on ``_build/<name>.so.lock`` from before
the compiler starts until the library is in place, and a process that
waited on the lock finds the library built and compiles nothing. The
compiler writes a private temporary file that ``os.replace`` moves into
place, so a reader never sees a partial library.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")


class BuildError(RuntimeError):
    """A native source failed to compile; carries the compiler output."""


def cxx_command() -> list[str] | None:
    """The compile command of the host libraries (key index, slot
    parser): ``$CXX`` or g++ with the same flags for each; None when no
    compiler is found."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return None
    return [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]


def output_path(name: str, sources: Sequence[str],
                command: Sequence[str]) -> str:
    """``_build/<name>-<hash>.so`` for these sources and compile flags."""
    h = hashlib.sha256(" ".join(command).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _lock(path: str) -> int:
    """Take the cross-process build lock of library ``path`` (blocks
    while another process builds it); returns the lock's descriptor."""
    fd = os.open(f"{path}.lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
    except BaseException:
        os.close(fd)
        raise
    return fd


def _unlock(fd: int) -> None:
    fcntl.flock(fd, fcntl.LOCK_UN)
    os.close(fd)


def start_build(name: str, sources: Sequence[str], headers: Sequence[str],
                command: Sequence[str]):
    """Start compiling ``sources`` with ``command + [-o out] + sources``,
    under the library's build lock.

    Returns ``(path, pending)``: pending is None when the library is
    already built (also when another process built it while this one
    waited on the lock). ``headers`` join the hash so a changed include
    rebuilds."""
    path = output_path(name, [*sources, *headers], command)
    if os.path.exists(path):
        return path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd = _lock(path)
    if os.path.exists(path):
        _unlock(fd)
        return path, None
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.Popen([*command, "-o", tmp, *sources],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
    except BaseException:
        _unlock(fd)
        raise
    return path, (proc, tmp, fd)


def finish_build(path: str, pending,
                 timeout: float = 600.0) -> tuple[str, str]:
    """Wait for a build started by :func:`start_build`; returns (path,
    compiler output) and raises BuildError with the output on failure."""
    if pending is None:
        return path, ""
    proc, tmp, fd = pending
    try:
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise BuildError(f"building {os.path.basename(path)} timed out")
        if proc.returncode != 0 or not os.path.exists(tmp):
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise BuildError(
                f"building {os.path.basename(path)} failed "
                f"(exit {proc.returncode}):\n"
                f"{out.decode(errors='replace')}")
        os.replace(tmp, path)
    finally:
        _unlock(fd)
    return path, out.decode(errors="replace")


def abandon_build(pending) -> None:
    """Stop a build started by :func:`start_build` that will not be
    finished (a sibling build failed): kill the compiler, drop its output
    and release the lock."""
    if pending is None:
        return
    proc, tmp, fd = pending
    try:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
        if os.path.exists(tmp):
            os.unlink(tmp)
    finally:
        _unlock(fd)


def build(name: str, sources: Sequence[str], headers: Sequence[str],
          command: Sequence[str]) -> str:
    """Compile synchronously; returns the library path."""
    return finish_build(*start_build(name, sources, headers, command))[0]
