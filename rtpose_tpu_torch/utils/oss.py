"""Object-store path facade.

Counterpart of ``rtpose_tpu/utils/oss.py`` (reference
``det3d/datasets/utils/oss.py``).

The reference vendors a 575-line S3-backed pathlib (dormant: nothing in the
fork constructs it).  This is the capability in facade form: ``OSSPath``
gives a pathlib-like surface over ``oss://bucket/key`` URIs, backed by a
pluggable client (any boto3-style object with ``get_object`` /
``put_object`` / ``head_object`` / ``list_objects``).  Local filesystem
paths pass through unchanged, so call sites can take either.  No cloud SDK
is imported — environments without one get a clear error on first remote
access instead of an import-time failure.
"""

from __future__ import annotations

import os
import posixpath
from typing import Iterator, Optional

_client = None

SCHEMES = ("oss://", "s3://")


def set_client(client) -> None:
    """Install the object-store client used by all OSSPath instances."""
    global _client
    _client = client


def is_oss_path(path: str) -> bool:
    return isinstance(path, str) and path.startswith(SCHEMES)


def open_path(path: str, mode: str = "r"):
    """``open()`` that also accepts ``oss://`` / ``s3://`` URIs — the
    dataset layer reads label/meta files through this so object-store
    roots work (the reference's OSS pathlib is dormant; here it is the
    live IO dispatch for remote roots)."""
    return OSSPath(path).open(mode) if is_oss_path(path) else open(path, mode)


def load_npy(path: str):
    """``np.load`` for local paths or object-store URIs."""
    import numpy as np
    if is_oss_path(path):
        with OSSPath(path).open("rb") as f:
            return np.load(f)
    return np.load(path)


class OSSPath:
    """Pathlib-like handle on ``oss://bucket/key`` (or a local path)."""

    def __init__(self, path: str):
        self._raw = str(path)
        if is_oss_path(self._raw):
            rest = self._raw.split("://", 1)[1]
            self.bucket, _, self.key = rest.partition("/")
            self.remote = True
        else:
            self.bucket, self.key = None, self._raw
            self.remote = False

    # -- construction --------------------------------------------------------
    def __truediv__(self, other: str) -> "OSSPath":
        if self.remote:
            scheme = self._raw.split("://", 1)[0]
            return OSSPath(f"{scheme}://{self.bucket}/"
                           f"{posixpath.join(self.key, other)}")
        return OSSPath(os.path.join(self._raw, other))

    @property
    def name(self) -> str:
        return posixpath.basename(self.key.rstrip("/"))

    @property
    def parent(self) -> "OSSPath":
        if self.remote:
            scheme = self._raw.split("://", 1)[0]
            return OSSPath(f"{scheme}://{self.bucket}/"
                           f"{posixpath.dirname(self.key.rstrip('/'))}")
        return OSSPath(os.path.dirname(self._raw))

    def __str__(self) -> str:
        return self._raw

    def __repr__(self) -> str:
        return f"OSSPath({self._raw!r})"

    def __fspath__(self) -> str:
        if self.remote:
            raise TypeError(f"{self._raw} is remote; read through "
                            "read_bytes()/open(), not the local filesystem")
        return self._raw

    # -- client plumbing -----------------------------------------------------
    def _cli(self):
        if _client is None:
            raise RuntimeError(
                f"no object-store client installed for {self._raw}; call "
                "rtpose_tpu_torch.utils.oss.set_client(client) with a boto3-style "
                "client first")
        return _client

    # -- IO surface ----------------------------------------------------------
    def exists(self) -> bool:
        if not self.remote:
            return os.path.exists(self._raw)
        try:
            self._cli().head_object(Bucket=self.bucket, Key=self.key)
            return True
        except Exception:
            return False

    def read_bytes(self) -> bytes:
        if not self.remote:
            with open(self._raw, "rb") as f:
                return f.read()
        body = self._cli().get_object(Bucket=self.bucket, Key=self.key)["Body"]
        return body.read() if hasattr(body, "read") else bytes(body)

    def read_text(self, encoding: str = "utf-8") -> str:
        return self.read_bytes().decode(encoding)

    def write_bytes(self, data: bytes) -> None:
        if not self.remote:
            with open(self._raw, "wb") as f:
                f.write(data)
            return
        self._cli().put_object(Bucket=self.bucket, Key=self.key, Body=data)

    def open(self, mode: str = "rb"):
        """File-object access; remote paths are fetched whole (read-only)."""
        if not self.remote:
            return open(self._raw, mode)
        import io
        if mode in ("r", "rt"):
            return io.StringIO(self.read_text())
        if mode == "rb":
            return io.BytesIO(self.read_bytes())
        raise ValueError(f"remote open mode {mode!r} unsupported "
                         "(write through write_bytes())")

    def iterdir(self, suffix: Optional[str] = None) -> Iterator["OSSPath"]:
        if not self.remote:
            for n in sorted(os.listdir(self._raw)):
                if suffix is None or n.endswith(suffix):
                    yield self / n
            return
        resp = self._cli().list_objects(Bucket=self.bucket,
                                        Prefix=self.key.rstrip("/") + "/")
        scheme = self._raw.split("://", 1)[0]
        for obj in resp.get("Contents", []):
            k = obj["Key"] if isinstance(obj, dict) else obj
            if suffix is None or k.endswith(suffix):
                yield OSSPath(f"{scheme}://{self.bucket}/{k}")
