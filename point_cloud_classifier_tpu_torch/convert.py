"""The JAX package's parameter trees ↔ the port's ``state_dict``.

Counterpart of ``point_cloud_classifier_tpu/convert.py``.  The JAX package
pickles ``{"params", "batch_stats"}`` numpy trees into ``best_model.pt``; the
port's modules are named after the original torch reference's ``state_dict``
keys, so one declarative mapping per model serves both directions:

- ``torch.nn.Linear`` weight ``[out, in]`` ↔ the tree's kernel ``[in, out]``
  (transposed); bias unchanged;
- LayerNorm weight/bias ↔ the tree's ln scale/bias.

Both directions walk the mapping; the state_dict → tree direction must
consume every key, so a wrong mapping cannot pass silently.  numpy only:
this module imports neither torch nor jax.  Only DeepSets is ported so far.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

Tree = Dict[str, object]
# (state_dict key, tree ∈ {"params", "stats"}, path in the tree, transpose)
Entry = Tuple[str, str, Tuple[str, ...], bool]


def _np(v) -> np.ndarray:
    """torch tensor / array-like → float32 numpy."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def _lin(prefix: str, path: Tuple[str, ...]) -> Iterator[Entry]:
    yield f"{prefix}.weight", "params", path + ("kernel",), True
    yield f"{prefix}.bias", "params", path + ("bias",), False


def _ln(prefix: str, scale_path: Tuple[str, ...], bias_path: Tuple[str, ...]) -> Iterator[Entry]:
    yield f"{prefix}.weight", "params", scale_path, False
    yield f"{prefix}.bias", "params", bias_path, False


def _deep_sets_mapping(cfg: dict) -> Iterator[Entry]:
    """φ = [ResidualBlock | Linear (+LN) + act]* + bare Linear;
    ρ = [Linear (+LN) + act]* + head."""
    ln = bool(cfg.get("layer_norm", True))
    residual = bool(cfg.get("residual_block", False))

    last = cfg["input_dim"]
    idx = 0
    for i, h in enumerate(cfg["phi_layers"]):
        if residual and last == h:
            base = f"phi.{idx}"
            yield f"{base}.linear.weight", "params", (f"phi_{i}_kernel",), True
            yield f"{base}.linear.bias", "params", (f"phi_{i}_bias",), False
            if ln:
                yield from _ln(
                    f"{base}.layer_norm", (f"phi_{i}_ln_scale",), (f"phi_{i}_ln_bias",)
                )
            idx += 1
        else:
            yield f"phi.{idx}.weight", "params", (f"phi_{i}_kernel",), True
            yield f"phi.{idx}.bias", "params", (f"phi_{i}_bias",), False
            idx += 1
            if ln:
                yield from _ln(
                    f"phi.{idx}", (f"phi_{i}_ln_scale",), (f"phi_{i}_ln_bias",)
                )
                idx += 1
            idx += 1  # activation
        last = h
    yield f"phi.{idx}.weight", "params", ("phi_final_kernel",), True
    yield f"phi.{idx}.bias", "params", ("phi_final_bias",), False

    idx = 0
    for j in range(len(cfg["rho_layers"])):
        yield from _lin(f"rho.{idx}", ("_MLPStack_0", f"TorchLinear_{j}"))
        idx += 1
        if ln:
            yield from _ln(
                f"rho.{idx}",
                ("_MLPStack_0", f"TorchLayerNorm_{j}", "scale"),
                ("_MLPStack_0", f"TorchLayerNorm_{j}", "bias"),
            )
            idx += 1
        idx += 1  # activation
    yield from _lin(f"rho.{idx}", ("TorchLinear_0",))  # classifier head


_MAPPINGS = {"deep_sets": _deep_sets_mapping}


def _mapping(model_name: str, config: dict) -> List[Entry]:
    if model_name not in _MAPPINGS:
        raise NotImplementedError(
            f"no converter for '{model_name}' in the port yet (ported: "
            f"{sorted(_MAPPINGS)}; the others come with their model slices, "
            "ROADMAP Queue 1)"
        )
    return list(_MAPPINGS[model_name](config["model"]))


def _set(tree: Tree, path: Tuple[str, ...], value: np.ndarray) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get(tree: Tree, path: Tuple[str, ...]) -> np.ndarray:
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            raise KeyError(
                f"checkpoint tree is missing {'/'.join(path)} — wrong "
                "model/config for this checkpoint?"
            )
        tree = tree[k]
    return tree


def convert_torch_state_dict(
    model_name: str, config: dict, state: Dict[str, object]
) -> Tuple[Tree, Tree]:
    """(params, batch_stats) trees from a ``state_dict``."""
    remaining = dict(state)
    trees = {"params": {}, "stats": {}}
    for key, tree_name, path, transpose in _mapping(model_name, config):
        if key not in remaining:
            raise KeyError(
                f"state_dict is missing '{key}' — wrong model/config for this "
                f"checkpoint? (remaining keys: {sorted(remaining)[:8]}…)"
            )
        v = _np(remaining.pop(key))
        _set(trees[tree_name], path, v.T.copy() if transpose else v)
    leftovers = [k for k in remaining if not k.endswith("num_batches_tracked")]
    if leftovers:
        raise ValueError(
            "unconverted keys in the state_dict (naming mismatch or "
            f"unsupported variant): {sorted(leftovers)}"
        )
    return trees["params"], trees["stats"]


def to_torch_state_dict(
    model_name: str, config: dict, params: Tree, batch_stats: Tree
) -> Dict[str, np.ndarray]:
    """A ``state_dict`` (numpy values) from the JAX package's trees."""
    trees = {"params": params, "stats": batch_stats or {}}
    out: Dict[str, np.ndarray] = {}
    for key, tree_name, path, transpose in _mapping(model_name, config):
        v = np.asarray(_get(trees[tree_name], path), dtype=np.float32)
        out[key] = np.ascontiguousarray(v.T) if transpose else v
    return out
