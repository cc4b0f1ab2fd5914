"""Pluggable run logger with a no-op default (port of `cppre.utils.runlog`).

The reference hard-depends on the simvue SaaS client
(`Run().init(folder, tags, metadata)`, `run.save_file`,
`run.update_metadata`, `run.save_object`). `Run` keeps that call surface
and writes to a local run directory: `metadata.json` (config-as-metadata),
`<category>/` (copied files and `<name>.npz` objects) and `metrics.jsonl`,
the same files the JAX package writes. `NoOpRun` drops everything (the
default for library use). If the simvue package is importable,
`Run.init(backend="simvue")` delegates to it.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

__all__ = ["Run", "NoOpRun"]


class NoOpRun:
    def init(self, *a, **k):
        return self

    def update_metadata(self, *a, **k):
        pass

    def save_file(self, *a, **k):
        pass

    def save_object(self, *a, **k):
        pass

    def log_metrics(self, *a, **k):
        pass

    def close(self):
        pass


def _array(x):
    """A tensor (on any device) or an array-like as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class Run:
    """Local-filesystem run logger with the simvue call surface."""

    def __init__(self, mode: str = "local"):
        self.mode = mode
        self.dir = None
        self.metadata = {}
        self._metrics = []

    def init(self, name: str | None = None, folder: str = "./runs",
             tags=(), metadata: dict | None = None, backend: str = "local"):
        if backend == "simvue":
            try:
                import simvue

                return simvue.Run().init(name=name, folder=folder, tags=list(tags),
                                         metadata=metadata)
            except ImportError:
                pass  # fall through to local
        name = name or f"run_{int(time.time())}"
        self.dir = os.path.join(folder, name)
        os.makedirs(self.dir, exist_ok=True)
        self.metadata = {"tags": list(tags), **(metadata or {})}
        self._flush_meta()
        return self

    def _flush_meta(self):
        with open(os.path.join(self.dir, "metadata.json"), "w") as f:
            json.dump(self.metadata, f, indent=2, default=str)

    def update_metadata(self, meta: dict):
        self.metadata.update(meta)
        self._flush_meta()

    def save_file(self, path: str, category: str = "artifact"):
        dst = os.path.join(self.dir, category)
        os.makedirs(dst, exist_ok=True)
        shutil.copy(path, dst)

    def save_object(self, obj, name: str = "object", category: str = "artifact"):
        """`<category>/<name>.npz` of a tensor or array (one entry, `name`)
        or of a dict of them (one entry each)."""
        dst = os.path.join(self.dir, category)
        os.makedirs(dst, exist_ok=True)
        np.savez(os.path.join(dst, f"{name}.npz"),
                 **({name: _array(obj)} if not isinstance(obj, dict)
                    else {k: _array(v) for k, v in obj.items()}))

    def log_metrics(self, metrics: dict, step: int | None = None):
        self._metrics.append({"step": step, "time": time.time(), **metrics})
        with open(os.path.join(self.dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(self._metrics[-1]) + "\n")

    def close(self):
        self._flush_meta()
