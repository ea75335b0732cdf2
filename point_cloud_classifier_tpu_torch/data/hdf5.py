"""The raw shower files: discovery, part numbers and reading, without h5py.

Counterpart of ``point_cloud_classifier_tpu/data/hdf5.py``.  One HDF5 file
per (particle, part) holds three groups:

- ``metadata/subdetector_names``: the byte-string lookup table;
- ``steps``: one row per energy deposit: ``energy``, ``event_id``,
  ``position`` [N, 3], ``time``, ``mcparticle_id`` and ``subdetector`` (an
  index into the lookup table);
- ``particles``: the MC-truth tree: ``id``, ``parent_id``, ``event_id``.

:func:`load_shower_file` reads one through ``data/h5lite.read_h5`` (a path,
or the file's bytes as an HTTP request brings them) into the JAX package's
key set, with ``subdetector`` already decoded through the name table.
"""

from __future__ import annotations

import os
from typing import Dict, List, Union

import numpy as np

from point_cloud_classifier_tpu_torch.data.h5lite import read_h5

_ARRAYS = {
    "energy": "steps/energy",
    "event_id": "steps/event_id",
    "position": "steps/position",
    "time": "steps/time",
    "mcparticle_id": "steps/mcparticle_id",
    "particle_id": "particles/id",
    "parent_id": "particles/parent_id",
    "particle_event_id": "particles/event_id",
}


def find_shower_files(data_dir: str, particle: str) -> List[str]:
    """All .h5/.hdf5 files under ``data_dir`` whose name contains ``particle``,
    in ``os.walk`` order."""
    matches = []
    for root, _, files in os.walk(data_dir):
        for fname in files:
            if fname.endswith((".h5", ".hdf5")) and particle in fname:
                matches.append(os.path.join(root, fname))
    print(f"Found {len(matches)} files for {particle}")
    return matches


def parse_part_number(filepath: str) -> int:
    """The part index of a ``..._file{N}.h5`` basename."""
    tail = os.path.basename(filepath).split("_")[-1]
    return int(tail.replace("file", "").replace(".h5", "").replace(".hdf5", ""))


def load_shower_file(source: Union[str, bytes]) -> Dict[str, np.ndarray]:
    """One shower file (a path or its bytes) as host numpy arrays: the JAX
    loader's keys, ``subdetector`` decoded through the name table.  A file
    without the schema's datasets raises ``KeyError`` naming the first one
    missing; one outside the supported part of HDF5 raises ``ValueError``."""
    arrays = read_h5(source)
    for name in ("metadata/subdetector_names", "steps/subdetector", *_ARRAYS.values()):
        if name not in arrays:
            raise KeyError(f"the shower file has no dataset {name}")
    data = {key: arrays[name] for key, name in _ARRAYS.items()}
    data["subdetector"] = arrays["metadata/subdetector_names"][arrays["steps/subdetector"]]
    return {k: data[k] for k in ("energy", "event_id", "position", "time", "mcparticle_id", "subdetector",
                                 "particle_id", "parent_id", "particle_event_id")}


def decode_subdetectors(raw: np.ndarray) -> np.ndarray:
    """Byte strings → unicode, decoded over the unique names and gathered
    back (the per-element decode, done once a name)."""
    uniq, inv = np.unique(np.asarray(raw), return_inverse=True)
    decoded = np.array([s.decode("utf-8") if isinstance(s, bytes) else str(s) for s in uniq])
    return decoded[inv]


def detector_category(subdetector_names: np.ndarray) -> np.ndarray:
    """Decoded subdetector names → HCal if "HCal" appears in the name, else
    ECal if "ECal" does, else Other (over the unique names)."""
    uniq, inv = np.unique(np.asarray(subdetector_names), return_inverse=True)
    cat = np.array(["HCal" if "HCal" in name else ("ECal" if "ECal" in name else "Other") for name in uniq])
    return cat[inv]
