"""Content-keyed disk cache for scene-build products (counterpart of the
reference's ``utils/cache.py``, without its XLA compile cache).

The native binned-SAH build of a large scene takes seconds; repeat runs of
the same scene load its rows with one ``np.load`` instead. A key hashes the
exact input arrays, so any change of geometry or parameters misses.

Layout: ``$VKRT_TORCH_SCENE_CACHE`` (default ``~/.cache/vkrt_torch_scene``;
``""``, ``"0"`` or ``"off"`` turns the cache off)/``<key>.npz``. The
directory and the keys are the port's own: a key starts with ``torch-``,
which no key of the reference's cache (``$VKRT_SCENE_CACHE``, 40 hex
digits) does, so neither package can load the other's entries. A corrupt
entry is removed and reads as a miss.
"""

from __future__ import annotations

import hashlib
import os
import zipfile

import numpy as np

ENV = "VKRT_TORCH_SCENE_CACHE"
DEFAULT_DIR = os.path.join("~", ".cache", "vkrt_torch_scene")
KEY_PREFIX = "torch-"


def cache_dir() -> str | None:
    """The cache directory (created), or None when the cache is off or the
    directory cannot be made."""
    d = os.environ.get(ENV, os.path.expanduser(DEFAULT_DIR))
    if d in ("", "0", "off"):
        return None
    try:
        os.makedirs(d, exist_ok=True)
        return d
    except OSError:
        return None


def content_key(tag: str, *parts) -> str:
    """A key of ``tag`` and arrays, scalars or strings: arrays hash their
    dtype, shape and raw bytes."""
    h = hashlib.blake2b(tag.encode(), digest_size=20)
    for p in parts:
        if p is None:
            h.update(b"\x00none")
            continue
        a = np.asarray(p)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return f"{KEY_PREFIX}{tag}-{h.hexdigest()}"


def load(key: str) -> dict | None:
    """The arrays stored under ``key``, or None (off, a miss, or a corrupt
    entry, which is removed)."""
    d = cache_dir()
    if d is None:
        return None
    path = os.path.join(d, key + ".npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        remove(key)
        return None


def remove(key: str) -> None:
    """Drop the entry of ``key`` if there is one."""
    d = cache_dir()
    if d is not None:
        try:
            os.remove(os.path.join(d, key + ".npz"))
        except OSError:
            pass


def save(key: str, **arrays) -> None:
    """Store ``arrays`` under ``key``: written to a file of this process,
    then renamed, so a concurrent reader sees the whole entry or none."""
    d = cache_dir()
    if d is None:
        return
    path = os.path.join(d, key + ".npz")
    # np.savez appends ".npz" to a name without it: the temporary name ends
    # in ".npz" already, so that the rename finds the file.
    tmp = path + f".tmp{os.getpid()}.npz"
    try:
        np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
