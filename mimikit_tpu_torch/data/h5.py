"""The file layer under the feature store and the checkpoint bank.

Files are HDF5 through ``h5py``, in the JAX package's layout, so either
package reads the other's datasets and banks.  Where ``h5py`` is not
installed (the card's machine has none), :func:`File` keeps the same tree —
groups, datasets, attrs — in one npz file under the same name, with a
warning: only ``mimikit_tpu_torch`` reads it back.  :func:`backend` says
which is in use.
"""
from __future__ import annotations

import io
import json
import os
import warnings
from typing import Dict

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover - depends on the machine
    h5py = None

__all__ = ["File", "is_dataset", "backend"]


def backend() -> str:
    """'h5py' or 'npz' (see the module docstring)."""
    return "h5py" if h5py is not None else "npz"


def File(filename: str, mode: str = "r"):
    """An open h5 file (``h5py.File``), or the npz container where h5py is
    not installed."""
    if h5py is not None:
        return h5py.File(filename, mode)
    return NpzFile(filename, mode)


def is_dataset(obj) -> bool:
    if h5py is not None and isinstance(obj, h5py.Dataset):
        return True
    return isinstance(obj, NpzDataset)


# -- the npz container ----------------------------------------------------------------

def _encode(v):
    if isinstance(v, np.ndarray):
        return {"nd": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_encode(x) for x in v]
    return v


def _decode(v):
    if isinstance(v, dict) and "nd" in v:
        return np.asarray(v["nd"], dtype=v["dtype"])
    return v


class NpzDataset:
    def __init__(self, data: np.ndarray):
        self._data = np.asarray(data)
        self.attrs: Dict = {}

    shape = property(lambda self: self._data.shape)
    dtype = property(lambda self: self._data.dtype)

    def __getitem__(self, item):
        return np.array(self._data[item])

    def __setitem__(self, item, value):
        self._data[item] = value


class NpzGroup:
    def __init__(self):
        self._children: Dict[str, object] = {}
        self.attrs: Dict = {}

    def _walk(self, path: str, create: bool = False):
        node = self
        parts = [p for p in path.split("/") if p]
        for p in parts[:-1]:
            if p not in node._children:
                if not create:
                    raise KeyError(path)
                node._children[p] = NpzGroup()
            node = node._children[p]
        return node, parts[-1]

    def __getitem__(self, path: str):
        node, last = self._walk(path)
        return node._children[last]

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
            return True
        except (KeyError, AttributeError):
            return False

    def __delitem__(self, path: str):
        node, last = self._walk(path)
        del node._children[last]

    def keys(self):
        return list(self._children)

    def create_group(self, path: str) -> "NpzGroup":
        node, last = self._walk(path, create=True)
        if last in node._children:
            raise ValueError(f"'{path}' exists")
        node._children[last] = NpzGroup()
        return node._children[last]

    def require_group(self, path: str) -> "NpzGroup":
        return self[path] if path in self else self.create_group(path)

    def create_dataset(self, path: str, data) -> NpzDataset:
        node, last = self._walk(path, create=True)
        node._children[last] = NpzDataset(np.array(data))
        return node._children[last]

    def visititems(self, fn, _prefix: str = ""):
        for name, obj in self._children.items():
            path = f"{_prefix}{name}"
            fn(path, obj)
            if isinstance(obj, NpzGroup):
                obj.visititems(fn, path + "/")


class NpzFile(NpzGroup):
    """An h5-like tree held in memory and written to one npz file on
    ``flush``/``close`` (modes 'w', 'r+', 'a'; 'r' reads only)."""

    def __init__(self, filename: str, mode: str = "r"):
        super().__init__()
        self.filename, self.mode = filename, mode
        self._open = True
        if mode in ("r", "r+") or (mode == "a" and os.path.exists(filename)):
            self._read()
        elif mode not in ("w", "a", "w-", "x"):
            raise ValueError(f"mode {mode!r}")
        if mode != "r":
            warnings.warn(
                f"h5py is not installed: {filename} is written as an npz container that"
                " only mimikit_tpu_torch reads", stacklevel=3,
            )

    def __bool__(self):
        return self._open

    def _read(self):
        with np.load(self.filename, allow_pickle=False) as f:
            meta = json.loads(str(f["__tree__"]))
            for path, kind in meta["nodes"]:
                if kind == "group":
                    self.require_group(path)
                else:
                    self.create_dataset(path, f["d/" + path])
            for path, attrs in meta["attrs"].items():
                node = self if path == "" else self[path]
                node.attrs.update({k: _decode(v) for k, v in attrs.items()})

    def flush(self):
        if self.mode == "r" or not self._open:
            return
        nodes, attrs, arrays = [], {"": {k: _encode(v) for k, v in self.attrs.items()}}, {}

        def visit(path, obj):
            kind = "dataset" if isinstance(obj, NpzDataset) else "group"
            nodes.append((path, kind))
            if kind == "dataset":
                arrays["d/" + path] = obj._data
            if obj.attrs:
                attrs[path] = {k: _encode(v) for k, v in obj.attrs.items()}

        self.visititems(visit)
        buf = io.BytesIO()
        np.savez(buf, __tree__=np.array(json.dumps({"nodes": nodes, "attrs": attrs})), **arrays)
        with open(self.filename, "wb") as f:
            f.write(buf.getvalue())

    def close(self):
        self.flush()
        self._open = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
