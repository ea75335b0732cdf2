"""YAML config overlay: a base file recursively overlaid by a specific one.

Counterpart of ``point_cloud_classifier_tpu/utils/config.py``.  ``yaml`` is
imported when a file is read, so the package imports without PyYAML (the
GPU machine has none; its callers pass config dicts).
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def merge_dicts(base: Dict[str, Any], specific: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``specific`` into ``base`` (mutates and returns base;
    nested dicts merge key by key, any other value in ``specific`` wins)."""
    for key, value in specific.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, dict):
            merge_dicts(base[key], value)
        else:
            base[key] = value
    return base


def load_config(base_path: str, specific_path: Optional[str] = None) -> Dict[str, Any]:
    """Load ``base_path`` and optionally overlay ``specific_path`` on top.

    An empty or non-dict specific file leaves the base config untouched.
    """
    import yaml

    with open(base_path) as f:
        config = yaml.safe_load(f)
    if specific_path:
        with open(specific_path) as f:
            specific = yaml.safe_load(f)
        if isinstance(specific, dict) and specific:
            config = merge_dicts(config, specific)
    return config
