"""Filesystems for data, checkpoint and serving roots — the port of
``paddlebox_tpu/utils/fs.py``.

``FileSystem`` is the interface the readers, FleetUtil, PassCheckpointer
and the serving plane go through, with two implementations:

- :class:`LocalFS`: POSIX, for schemeless (and ``file://``) paths;
- :class:`CommandFS`: every operation is a shell-command template
  (``{path}`` / ``{src}`` / ``{dst}``), so one class speaks ``hadoop
  fs``, ``gsutil``, ``aws s3`` or any in-house CLI. ``put`` / ``get`` /
  ``ls`` / ``rm`` / ``mkdir`` retry with exponential backoff
  (``flags.fs_retry_attempts`` / ``fs_retry_backoff_s``), each command is
  bounded by ``flags.fs_command_timeout_s``, ``append`` and ``test``
  never retry, and a failed ``get`` removes its partial download before
  the next attempt.

Paths carry their filesystem by URI scheme (``hdfs://...``,
``afs://...``): :func:`resolve` splits a path into (filesystem, path),
and an unregistered scheme raises ``ValueError``, never a silent local
fallback. :func:`init_afs_api` mirrors the reference's ``InitAfsAPI``
(``box_wrapper.h:577``) and registers a hadoop-style CommandFS for the
``afs`` / ``hdfs`` schemes, with the credentials in
``HADOOP_CLIENT_OPTS`` (never in argv, which ``ps`` shows).
"""

from __future__ import annotations

import os
import re
import shlex
import shutil
import subprocess
import tempfile
import time
from typing import IO, Iterator

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags


class FileSystem:
    """Interface. Paths are fs-native."""

    def open_read(self, path: str) -> IO[bytes]:
        raise NotImplementedError

    def read_lines(self, path: str) -> Iterator[str]:
        with self.open_read(path) as f:
            for raw in f:
                yield raw.decode("utf-8", errors="replace")

    def write_text(self, path: str, text: str, append: bool = False) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def ls(self, path: str) -> list[str]:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def put(self, local: str, remote: str) -> None:
        """Upload a local file or directory tree."""
        raise NotImplementedError

    def get(self, remote: str, local: str) -> None:
        """Download a remote file or directory tree."""
        raise NotImplementedError

    def rm(self, path: str) -> None:
        raise NotImplementedError


class LocalFS(FileSystem):
    def open_read(self, path: str) -> IO[bytes]:
        return open(path, "rb")

    def write_text(self, path: str, text: str, append: bool = False) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a" if append else "w") as f:
            f.write(text)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def ls(self, path: str) -> list[str]:
        return sorted(os.path.join(path, n) for n in os.listdir(path))

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def put(self, local: str, remote: str) -> None:
        if local != remote:
            if os.path.isdir(local):
                shutil.copytree(local, remote, dirs_exist_ok=True)
            else:
                os.makedirs(os.path.dirname(os.path.abspath(remote)),
                            exist_ok=True)
                shutil.copy2(local, remote)

    def get(self, remote: str, local: str) -> None:
        self.put(remote, local)

    def rm(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)


class CommandFS(FileSystem):
    """Shell-command filesystem (hadoop fs / gsutil / aws s3 ...).

    Templates substitute ``{path}``, ``{src}`` and ``{dst}``; the
    defaults speak the ``hadoop fs`` dialect. ``env`` merges into the
    commands' environment (credentials travel there, not in argv).

    ``put`` / ``get`` / ``ls`` / ``rm`` / ``mkdir`` retry with
    exponential backoff (``retries`` attempts in all, the first sleep
    ``retry_backoff`` seconds, doubling), and every non-streaming command
    is bounded by ``timeout`` seconds (None or 0 = unbounded; a hung
    client counts as a failed attempt). A failed ``get``'s partial local
    download is removed before the retry (``-get`` refuses to overwrite).
    Exhaustion raises RuntimeError with the attempt count and the last
    stderr. ``append`` never retries (a partial append that reported
    failure could write a donefile line twice), and ``test``'s
    exists / absent exit codes are both successes. Unset arguments read
    ``flags.fs_retry_attempts`` / ``fs_retry_backoff_s`` /
    ``fs_command_timeout_s`` at call time."""

    _RETRY_OPS = ("put", "get", "ls", "rm", "mkdir")

    def __init__(self, cat: str = "hadoop fs -cat {path}",
                 ls: str = "hadoop fs -ls {path}",
                 put: str = "hadoop fs -put -f {src} {dst}",
                 get: str = "hadoop fs -get {src} {dst}",
                 mkdir: str = "hadoop fs -mkdir -p {path}",
                 test: str = "hadoop fs -test -e {path}",
                 rm: str = "hadoop fs -rm -r -f {path}",
                 append: str | None = None,
                 env: dict | None = None,
                 retries: int | None = None,
                 retry_backoff: float | None = None,
                 timeout: float | None = None):
        self._cmds = {"cat": cat, "ls": ls, "put": put, "get": get,
                      "mkdir": mkdir, "test": test, "rm": rm,
                      "append": append}
        self._env = dict(os.environ, **(env or {}))
        self._retries = retries
        self._retry_backoff = retry_backoff
        self._timeout = timeout

    def _retry_policy(self, op: str) -> tuple[int, float, float | None]:
        """(attempts, first backoff seconds, timeout seconds or None)."""
        attempts = (self._retries if self._retries is not None
                    else flags.fs_retry_attempts)
        if op not in self._RETRY_OPS:
            attempts = 1
        backoff = (self._retry_backoff if self._retry_backoff is not None
                   else flags.fs_retry_backoff_s)
        # 0 means "no timeout" in both the constructor and the flag
        timeout = (self._timeout if self._timeout is not None
                   else flags.fs_command_timeout_s) or None
        return max(1, int(attempts)), float(backoff), timeout

    def _argv(self, op: str, **kw) -> list[str]:
        tpl = self._cmds[op]
        if tpl is None:
            raise NotImplementedError(f"CommandFS has no {op!r} command")
        # only the known placeholders are substituted (not str.format:
        # literal braces are legal in object names and templates), in one
        # pass, so a substituted value holding "{dst}" is never rescanned
        if not kw:
            return shlex.split(tpl)
        pat = re.compile("|".join(re.escape("{" + k + "}") for k in kw))
        return [pat.sub(lambda m: kw[m.group(0)[1:-1]], tok)
                for tok in shlex.split(tpl)]

    def _run(self, op: str, ok_codes: tuple = (0,),
             **kw) -> subprocess.CompletedProcess:
        attempts, backoff, timeout = self._retry_policy(op)
        argv = self._argv(op, **kw)
        # only paths a failed get may have CREATED are cleaned between
        # attempts: a dst (or a member of a dst directory) that existed
        # before the first attempt is never touched
        get_cleanup: list[str] = []
        if op == "get" and attempts > 1 and "dst" in kw:
            dst = kw["dst"]
            if not os.path.exists(dst):
                get_cleanup.append(dst)
            elif os.path.isdir(dst) and "src" in kw:
                member = os.path.join(
                    dst, os.path.basename(kw["src"].rstrip("/")))
                if not os.path.exists(member):
                    get_cleanup.append(member)
        last = "never ran"
        for attempt in range(1, attempts + 1):
            monitor.counter_add(f"fs.{op}.attempts")
            try:
                proc = subprocess.run(argv, env=self._env,
                                      capture_output=True, timeout=timeout)
            except subprocess.TimeoutExpired:
                last = f"timed out after {timeout}s"
                monitor.counter_add(f"fs.{op}.timeouts")
            else:
                if proc.returncode in ok_codes:
                    if attempt > 1:
                        monitor.counter_add(f"fs.{op}.recovered")
                    return proc
                last = (f"exit {proc.returncode}: "
                        f"{proc.stderr.decode(errors='replace')[:500]}")
            if attempt < attempts:
                monitor.counter_add(f"fs.{op}.retries")
                for p in get_cleanup:
                    # a dead or timed-out client may have left a partial
                    # download, and -get would then fail every retry
                    # with 'File exists'
                    try:
                        if os.path.isdir(p):
                            shutil.rmtree(p)
                        elif os.path.exists(p):
                            os.remove(p)
                    # pblint: disable=silent-except -- between-attempt
                    # hygiene: a surviving partial dst makes the retried
                    # -get fail loudly with 'File exists' anyway
                    except OSError:
                        pass
                time.sleep(backoff * (2 ** (attempt - 1)))
        monitor.counter_add(f"fs.{op}.exhausted")
        monitor.event("fs_exhausted", op=op, attempts=attempts,
                      error=last[:300])
        raise RuntimeError(
            f"CommandFS {op} failed after {attempts} attempt"
            f"{'s' if attempts != 1 else ''} ({last})")

    def open_read(self, path: str) -> IO[bytes]:
        # stderr spools to a temp file: a chatty client writing more than
        # a pipe buffer to an undrained PIPE would deadlock the stream
        errf = tempfile.TemporaryFile()
        proc = subprocess.Popen(self._argv("cat", path=path),
                                env=self._env, stdout=subprocess.PIPE,
                                stderr=errf)
        return _CommandStream(proc, errf)

    def write_text(self, path: str, text: str, append: bool = False) -> None:
        if append and self._cmds["append"] is None and self.exists(path):
            # no append command: read-modify-write (donefiles are small)
            with self.open_read(path) as f:
                text = f.read().decode() + text
            append = False
        with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                         delete=False) as tmp:
            tmp.write(text)
            name = tmp.name
        try:
            if append and self._cmds["append"] is not None:
                self._run("append", src=name, dst=path)
            else:
                self._run("put", src=name, dst=path)
        finally:
            os.unlink(name)

    def exists(self, path: str) -> bool:
        """Exit 0 = exists, 1 = absent; anything else (an outage, an auth
        failure) raises: taking an outage for "absent" would let
        write_text's append fallback truncate a donefile."""
        return self._run("test", ok_codes=(0, 1),
                         path=path).returncode == 0

    def ls(self, path: str) -> list[str]:
        out = self._run("ls", path=path).stdout.decode(errors="replace")
        names = []
        for line in out.splitlines():
            if not line.strip() or line.startswith("Found "):
                continue
            # hadoop -ls lines carry 8 whitespace fields with the path
            # last (it may hold spaces: split at most 7 times); bare-name
            # listings are one field
            names.append(line.split(None, 7)[-1])
        return sorted(names)

    def makedirs(self, path: str) -> None:
        self._run("mkdir", path=path)

    def put(self, local: str, remote: str) -> None:
        self._run("put", src=local, dst=remote)

    def get(self, remote: str, local: str) -> None:
        self._run("get", src=remote, dst=local)

    def rm(self, path: str) -> None:
        self._run("rm", path=path)


class _CommandStream:
    """File-like over a streaming command's stdout. ``close`` reaps the
    process and raises if the command failed after its output was read
    to the end: a truncated filelist must never parse as a short
    success."""

    def __init__(self, proc: subprocess.Popen, errf=None):
        self._proc = proc
        self._f = proc.stdout
        self._errf = errf

    def read(self, *a):
        return self._f.read(*a)

    def __iter__(self):
        return iter(self._f)

    def close(self) -> None:
        if self._f.closed:
            return
        # an early-exit consumer (the head of a large remote file) must
        # not pay the whole download inside close(): with bytes left,
        # kill the producer and skip the exit-code check, which is only
        # meaningful for a stream read to its end
        if self._f.read(1):
            self._proc.kill()
            self._proc.wait()
            self._f.close()
            if self._errf is not None:
                self._errf.close()
            return
        rc = self._proc.wait()
        err = ""
        if self._errf is not None:
            self._errf.seek(0)
            err = self._errf.read(4096).decode(errors="replace")
            self._errf.close()
            self._errf = None
        self._f.close()   # before the raise: no fd leak; close idempotent
        if rc != 0:
            raise RuntimeError(f"CommandFS cat failed ({rc}): {err[:500]}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_REGISTRY: dict[str, FileSystem] = {}
_LOCAL = LocalFS()


def register_fs(scheme: str, fs: FileSystem) -> None:
    _REGISTRY[scheme.rstrip(":/").lower()] = fs


def resolve(path: str) -> tuple[FileSystem, str]:
    """Path → (filesystem, path). Schemeless (or file://) paths are local;
    an unregistered scheme is an error, not a silent local fallback."""
    if "://" in path:
        scheme = path.split("://", 1)[0].lower()
        if scheme == "file":
            return _LOCAL, path.split("://", 1)[1]
        fs = _REGISTRY.get(scheme)
        if fs is None:
            raise ValueError(
                f"no filesystem registered for scheme {scheme!r} "
                f"(register_fs / init_afs_api first)")
        return fs, path
    return _LOCAL, path


def is_remote(path: str) -> bool:
    return "://" in path and not path.lower().startswith("file://")


def put_replacing(fs: FileSystem, local: str, remote: str) -> None:
    """Upload a directory (or file) REPLACING any leftover target first:
    ``hadoop fs -put`` into an existing directory nests the source under
    it, while every donefile/manifest consumer expects the content AT
    ``remote``. Every directory upload (the checkpoint mirror, FleetUtil
    models, serving publishes) goes through this rm-then-put."""
    fs.rm(remote)
    fs.put(local, remote)


def init_afs_api(fs_name: str, fs_user: str = "", fs_passwd: str = "",
                 conf_path: str = "", hadoop_bin: str = "hadoop",
                 schemes: tuple = ("afs", "hdfs")) -> CommandFS:
    """The reference's call shape (InitAfsAPI, box_wrapper.h:577):
    configure the cluster client once, and every remote path in
    filelists and checkpoint, model and serving roots then resolves.

    ``fs_name`` is the defaultFS (e.g. ``hdfs://ns1``); the user and
    password ride ``HADOOP_CLIENT_OPTS`` as the ugi, so the launcher's
    argv holds no secret. ``hadoop_bin`` may be any executable speaking
    the ``hadoop fs`` dialect (a stand-in CLI in tests)."""
    opts = f"-Dfs.defaultFS={fs_name}" if fs_name else ""
    env = {}
    if fs_user:
        env["HADOOP_CLIENT_OPTS"] = (
            f"-Dhadoop.job.ugi={fs_user},{fs_passwd}")
    # --config is a launcher option: it must precede the fs subcommand
    conf = f" --config {conf_path}" if conf_path else ""
    base = f"{hadoop_bin}{conf} fs {opts}".strip()
    fs = CommandFS(cat=f"{base} -cat {{path}}",
                   ls=f"{base} -ls {{path}}",
                   put=f"{base} -put -f {{src}} {{dst}}",
                   get=f"{base} -get {{src}} {{dst}}",
                   mkdir=f"{base} -mkdir -p {{path}}",
                   test=f"{base} -test -e {{path}}",
                   rm=f"{base} -rm -r -f {{path}}",
                   env=env)
    for s in schemes:
        register_fs(s, fs)
    return fs
