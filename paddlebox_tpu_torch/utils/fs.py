"""Filesystems for checkpoint roots — the local part of
``paddlebox_tpu/utils/fs.py``.

``FileSystem`` is the interface FleetUtil and PassCheckpointer write
through, ``LocalFS`` the POSIX implementation for schemeless (and
``file://``) paths, and ``register_fs`` / ``resolve`` / ``is_remote`` /
``put_replacing`` the scheme registry around them, as in the reference.

Remote roots (``hdfs://``, ``afs://``, …) go through the reference's
``CommandFS`` (:111, shell-command templates with retry and backoff),
which is not ported yet (ROADMAP): resolving a remote path with no
registered filesystem raises :class:`RemoteFSNotPorted`; it never falls
back to a local path of the same name.
"""

from __future__ import annotations

import os
import shutil
from typing import IO, Iterator


class RemoteFSNotPorted(NotImplementedError):
    """A remote checkpoint root or filelist path: the reference's
    ``CommandFS`` and the remote mirror are not ported yet."""

    def __init__(self, path: str):
        super().__init__(
            f"remote path {path!r}: remote filesystems (the reference's "
            f"CommandFS for hdfs://, afs://, ...) and the checkpoint "
            f"mirror are not ported yet (ROADMAP, queue 1 item 5: remote "
            f"fs and mirror); use a local root")
        self.path = path


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


_REGISTRY: dict[str, FileSystem] = {}
_LOCAL = LocalFS()


def register_fs(scheme: str, fs: FileSystem) -> None:
    _REGISTRY[scheme.rstrip(":/").lower()] = fs


def resolve(path: str) -> tuple[FileSystem, str]:
    """Path → (filesystem, path). Schemeless (or file://) paths are local;
    a scheme with no registered filesystem raises RemoteFSNotPorted."""
    if "://" in path:
        scheme = path.split("://", 1)[0].lower()
        if scheme == "file":
            return _LOCAL, path.split("://", 1)[1]
        fs = _REGISTRY.get(scheme)
        if fs is None:
            raise RemoteFSNotPorted(path)
        return fs, path
    return _LOCAL, path


def is_remote(path: str) -> bool:
    return "://" in path and not path.lower().startswith("file://")


def put_replacing(fs: FileSystem, local: str, remote: str) -> None:
    """Upload a directory (or file) REPLACING any leftover target first:
    a put into an existing directory would nest the source under it,
    while every donefile/manifest consumer expects the content AT
    ``remote``."""
    fs.rm(remote)
    fs.put(local, remote)
