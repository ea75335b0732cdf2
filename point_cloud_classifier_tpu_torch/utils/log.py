"""Versioned run-directory logger.

Counterpart of ``point_cloud_classifier_tpu/utils/log.py``, byte for byte in
what it writes: each training run gets ``{log_dir}/version_{N}`` (N found by
linear probing), a ``meta.json`` made at setup with ``{"dataset": ...,
"model": ...}`` (json, indent=4), and metrics read-modify-written into
``meta.json["metrics"][name]``.
"""

from __future__ import annotations

import json
import os


class TrainingLogger:
    """Creates a fresh ``version_{N}`` run dir and logs metrics to meta.json."""

    def __init__(self, model_name: str, dataset_name: str, log_dir: str):
        self.model_name = model_name
        self.dataset_name = dataset_name
        self.save_dir = log_dir
        # probe-then-create with a retry: two concurrent runs sharing a
        # log_dir can both probe the same free N — the loser bumps to the
        # next free slot instead of dying on FileExistsError
        for _ in range(1000):
            self.version = self._next_free_version()
            try:
                self._create_run_dir()
                break
            except FileExistsError:
                continue
        else:
            raise RuntimeError(
                f"could not allocate a version dir under {log_dir}"
            )

    def _next_free_version(self) -> str:
        version = 0
        while os.path.exists(os.path.join(self.save_dir, f"version_{version}")):
            version += 1
        return str(version)

    def get_version(self) -> str:
        return self.version

    @property
    def version_dir(self) -> str:
        return os.path.join(self.save_dir, f"version_{self.version}")

    def _create_run_dir(self) -> None:
        os.makedirs(self.version_dir)
        metainfo = {
            "dataset": self.dataset_name,
            "model": self.model_name,
        }
        with open(os.path.join(self.version_dir, "meta.json"), "w") as f:
            json.dump(metainfo, f, indent=4)

    def log_metric(self, name: str, value) -> None:
        meta_path = os.path.join(self.version_dir, "meta.json")
        with open(meta_path, "r") as f:
            meta = json.load(f)
        meta.setdefault("metrics", {})[name] = value
        # atomic replace: a crash mid-write must not truncate meta.json
        tmp_path = f"{meta_path}.tmp{os.getpid()}"
        with open(tmp_path, "w") as f:
            json.dump(meta, f, indent=4)
        os.replace(tmp_path, meta_path)
        print(f"Saved metric '{name}': {value}")
