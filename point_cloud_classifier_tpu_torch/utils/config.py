"""YAML config overlay: a base file recursively overlaid by a specific one,
and the resolved config written into each run directory.

Counterpart of ``point_cloud_classifier_tpu/utils/config.py``.  ``yaml`` is
imported when a file is read, so the package imports without PyYAML (the
GPU machine has none; its callers pass config dicts).  :func:`save_config`
needs no PyYAML at all: a small emitter writes ``config.yaml`` byte for byte
as ``yaml.safe_dump`` does for what configs hold — nested dicts (keys
sorted), lists, strings, ints, floats, bools and None.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, List, Optional


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


# PyYAML's implicit resolvers (YAML 1.1): a plain string matching one would
# read back as another type, so safe_dump quotes it.
_IMPLICIT = re.compile(
    r"""^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF
    |[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)
    |[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
    |~|null|Null|NULL|<<|=
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]
     (?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    re.X,
)
_WIDTH = 80  # safe_dump folds longer strings at their spaces


def _str_scalar(s: str) -> str:
    if not all(" " <= c <= "~" for c in s):
        raise ValueError(f"save_config writes printable ASCII strings only, got {s!r}")
    if " " in s and len(s) > _WIDTH:
        raise ValueError(f"save_config writes no string with spaces over {_WIDTH} chars")
    plain = (
        s != ""
        and not _IMPLICIT.match(s)
        and s[0] not in "#,[]{}&*!|>'\"%@` "
        and not (s[0] in "-?:" and (len(s) == 1 or s[1] == " "))
        and s[-1] not in " :"
        and ": " not in s
        and " #" not in s
    )
    return s if plain else "'" + s.replace("'", "''") + "'"


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(v, str):
        return _str_scalar(v)
    if v == {} or v == []:
        return "{}" if isinstance(v, dict) else "[]"
    raise TypeError(f"save_config cannot write {type(v).__name__}")


def _block(value, indent: int) -> List[str]:
    """Block-style lines of a non-empty dict (keys sorted) or list; a list
    under a key sits at the key's indent, as safe_dump writes it."""
    pad = " " * indent
    lines = []
    if isinstance(value, dict):
        for key in sorted(value):
            v = value[key]
            head = f"{pad}{_scalar(key)}:"
            if isinstance(v, (dict, list)) and v:
                lines.append(head)
                lines += _block(v, indent + 2 if isinstance(v, dict) else indent)
            else:
                lines.append(f"{head} {_scalar(v)}")
        return lines
    for v in value:
        if isinstance(v, (dict, list)) and v:
            sub = _block(v, indent + 2)
            lines.append(f"{pad}- {sub[0][indent + 2:]}")
            lines += sub[1:]
        else:
            lines.append(f"{pad}- {_scalar(v)}")
    return lines


def dump_yaml(config: Dict[str, Any]) -> str:
    """``yaml.safe_dump(config)`` for a config dict, without PyYAML."""
    if not config:
        return "{}\n"
    return "\n".join(_block(config, 0)) + "\n"


def save_config(config: Dict[str, Any], log_dir: str) -> str:
    """Write the resolved config as ``{log_dir}/config.yaml``, byte for byte
    as the JAX package's ``save_config`` (``yaml.safe_dump``) does.  Returns
    the written path."""
    os.makedirs(log_dir, exist_ok=True)
    config_path = os.path.join(log_dir, "config.yaml")
    with open(config_path, "w") as f:
        f.write(dump_yaml(config))
    return config_path
