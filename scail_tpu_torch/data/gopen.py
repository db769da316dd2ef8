"""Pluggable URL stream opener for dataset shards (counterpart of
scail_tpu/data/gopen.py; reference: sat/data_utils/webds.py:290-368, the
gopen_rclone / gopen_boto3 backends that stream tar shards from object
storage).

Scheme dispatch:
  <path> / file://     local file
  pipe:<cmd>           stdout of a shell command
  rclone://remote:path `rclone cat` subprocess
  s3://bucket/key      boto3 streaming body when importable, else the
                       aws CLI as a pipe
  http(s)://           `curl -s` pipe

Remote backends are availability-gated: each raises when its tool is
missing.  The tests drive `file` and `pipe:` only, never the network.
Register custom schemes with `register_scheme`.
"""

from __future__ import annotations

import io
import shutil
import subprocess
from typing import Callable, Dict


class Pipe(io.RawIOBase):
    """Readable stream over a subprocess's stdout; checks exit status on
    close (ignoring SIGPIPE-style codes, like the reference's Pipe)."""

    def __init__(self, cmd, bufsize: int = 1 << 22, ignore_status=(141, 23)):
        super().__init__()
        self.cmd = cmd
        self.ignore_status = set(ignore_status) | {0}
        self.proc = subprocess.Popen(cmd, shell=isinstance(cmd, str),
                                     stdout=subprocess.PIPE, bufsize=bufsize)
        self.stream = self.proc.stdout

    def readable(self):
        return True

    def readinto(self, b):
        chunk = self.stream.read(len(b))
        n = len(chunk)
        b[:n] = chunk
        return n

    def read(self, size=-1):
        return self.stream.read(size)

    def close(self):
        if self.closed:
            return
        self.stream.close()
        status = self.proc.wait()
        super().close()
        if status not in self.ignore_status:
            raise OSError(f"{self.cmd!r} exited with status {status}")


def _gopen_file(url: str, bufsize: int):
    path = url[len("file://"):] if url.startswith("file://") else url
    return open(path, "rb", buffering=bufsize)


def _gopen_pipe(url: str, bufsize: int):
    return Pipe(url[len("pipe:"):], bufsize=bufsize)


def _gopen_rclone(url: str, bufsize: int):
    if shutil.which("rclone") is None:
        raise RuntimeError("rclone not installed; cannot open " + url)
    remote = url[len("rclone://"):]
    return Pipe(["rclone", "cat", remote], bufsize=bufsize)


def _gopen_s3(url: str, bufsize: int):
    try:
        import boto3  # noqa: F401

        bucket, _, key = url[len("s3://"):].partition("/")
        obj = boto3.client("s3").get_object(Bucket=bucket, Key=key)
        return obj["Body"]
    except ImportError:
        if shutil.which("aws") is None:
            raise RuntimeError("neither boto3 nor the aws CLI available for " + url)
        return Pipe(["aws", "s3", "cp", url, "-"], bufsize=bufsize)


def _gopen_curl(url: str, bufsize: int):
    if shutil.which("curl") is None:
        raise RuntimeError("curl not installed; cannot open " + url)
    return Pipe(["curl", "-s", "-L", url], bufsize=bufsize)


_SCHEMES: Dict[str, Callable] = {
    "file": _gopen_file,
    "pipe": _gopen_pipe,
    "rclone": _gopen_rclone,
    "s3": _gopen_s3,
    "http": _gopen_curl,
    "https": _gopen_curl,
}


def register_scheme(name: str, opener: Callable):
    _SCHEMES[name] = opener


def gopen(url: str, bufsize: int = 1 << 22):
    """Open `url` as a readable binary stream."""
    scheme = url.split("://", 1)[0] if "://" in url else (
        "pipe" if url.startswith("pipe:") else "file")
    opener = _SCHEMES.get(scheme)
    if opener is None:
        raise ValueError(f"unknown url scheme {scheme!r} in {url!r}")
    return opener(url, bufsize)
