"""The JAX package's parameter trees ↔ the port's ``state_dict``.

Counterpart of ``point_cloud_classifier_tpu/convert.py``.  The JAX package
pickles ``{"params", "batch_stats"}`` numpy trees into ``best_model.pt``; the
port's modules are named after the original torch reference's ``state_dict``
keys, so one declarative mapping per model serves both directions:

- ``torch.nn.Linear`` weight ``[out, in]`` ↔ the tree's kernel ``[in, out]``
  (transposed); bias unchanged;
- LayerNorm weight/bias ↔ the tree's ln scale/bias;
- BatchNorm1d weight/bias ↔ ``MaskedBatchNorm`` scale/bias, and
  running_mean/running_var ↔ the ``batch_stats`` tree (``num_batches_tracked``
  has no counterpart: it is skipped one way and written as 0 the other, as
  the JAX package's ``convert.py`` does);
- torch_geometric's ``GraphConv`` ``lin_rel`` (biased) / ``lin_root``
  (bias-free) ↔ ``GraphConv_k/TorchLinear_0`` / ``TorchLinear_1``, or
  ``DenseGraphConv_k/...`` for a model with ``knn_k > 0``, add or mean
  aggregation and no SAG (Flax names the K5 arm's convolution so; the JAX
  package's converter knows only ``GraphConv_k``);
- torch_geometric's ``SAGPooling`` (its default score network, a
  ``GraphConv`` to one channel): ``pool.gnn.lin_rel`` / ``pool.gnn.lin_root``
  ↔ ``SAGPool_0/GraphConv_0/TorchLinear_0`` / ``TorchLinear_1``, between
  ``bn1`` and ``conv2`` as the JAX model instantiates it.  The JAX package's
  converter refuses SAG checkpoints; the port fixes this layout for its own
  (``docs/parity_torch.md``);
- torch_geometric 2.5's ``GATConv`` (``in_channels`` an int, no edge
  features, no residual): ``lin.weight`` ``[H·dh, in]`` ↔
  ``GATConv_k/Dense_0/kernel`` (transposed), ``att_src``/``att_dst``
  ``[1, H, dh]`` and ``bias [H·dh]`` unchanged.  The JAX package's converter
  refuses GAT checkpoints; the port fixes this one layout for its own.

Both directions walk the mapping; the state_dict → tree direction must
consume every key, so a wrong mapping cannot pass silently.  The mapping
and the two tree functions are numpy only; the file-level functions behind
the command line's ``convert`` (:func:`convert_checkpoint`,
:func:`export_torch_checkpoint`) import torch when called, and never jax.
Ported: the FullyConnectedNet, DeepSets and GraphNet (GraphConv or GAT,
with or without SAG pooling).  ``logistic_regression`` has no mapping, as in the
JAX package: its ``model.pkl`` holds no torch weights.
"""

from __future__ import annotations

import pickle
import zipfile
from typing import Dict, Iterator, List, Tuple

import numpy as np

Tree = Dict[str, object]
# (state_dict key, tree ∈ {"params", "stats"}, path in the tree, transpose)
Entry = Tuple[str, str, Tuple[str, ...], bool]


def _np(v) -> np.ndarray:
    """torch tensor / array-like → a float32 numpy copy (never a view of a
    live parameter, which an optimizer step would change under the tree)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.array(v, dtype=np.float32)


def _lin(prefix: str, path: Tuple[str, ...]) -> Iterator[Entry]:
    yield f"{prefix}.weight", "params", path + ("kernel",), True
    yield f"{prefix}.bias", "params", path + ("bias",), False


def _ln(prefix: str, scale_path: Tuple[str, ...], bias_path: Tuple[str, ...]) -> Iterator[Entry]:
    yield f"{prefix}.weight", "params", scale_path, False
    yield f"{prefix}.bias", "params", bias_path, False


def _bn(prefix: str, name: str) -> Iterator[Entry]:
    yield f"{prefix}.weight", "params", (name, "scale"), False
    yield f"{prefix}.bias", "params", (name, "bias"), False
    yield f"{prefix}.running_mean", "stats", (name, "mean"), False
    yield f"{prefix}.running_var", "stats", (name, "var"), False


def _fcn_mapping(cfg: dict) -> Iterator[Entry]:
    """[Linear, BN?, ReLU]* then the output Linear, all in one ``network``
    Sequential."""
    hidden = list(cfg["hidden_layers"])
    idx = 0
    for i in range(len(hidden)):
        yield from _lin(f"network.{idx}", (f"TorchLinear_{i}",))
        idx += 1
        if cfg["batch_normalization"]:
            yield from _bn(f"network.{idx}", f"MaskedBatchNorm_{i}")
            idx += 1
        idx += 1  # ReLU
    yield from _lin(f"network.{idx}", (f"TorchLinear_{len(hidden)}",))


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


def _graph_conv(prefix: str, path: Tuple[str, ...]) -> Iterator[Entry]:
    yield from _lin(f"{prefix}.lin_rel", path + ("TorchLinear_0",))
    yield f"{prefix}.lin_root.weight", "params", path + ("TorchLinear_1", "kernel"), True


def _graph_net_mapping(cfg: dict) -> Iterator[Entry]:
    """Two convolutions (+BN each, SAG's score network after the first),
    fc1 + bn3, fc2, in the port's ``state_dict`` order."""
    sag = bool(cfg.get("sag_pool"))
    for k in (1, 2):
        if cfg.get("use_gat"):
            conv = f"GATConv_{k - 1}"
            for name in ("att_src", "att_dst", "bias"):
                yield f"conv{k}.{name}", "params", (conv, name), False
            yield f"conv{k}.lin.weight", "params", (conv, "Dense_0", "kernel"), True
        else:
            # the K5 arm (knn_k > 0, add/mean, no SAG) aggregates ahead of
            # the convolution, and Flax names that module DenseGraphConv
            dense = (cfg.get("knn_k", 0) > 0 and not sag
                     and cfg.get("local_pooling", "add") in ("add", "mean"))
            yield from _graph_conv(f"conv{k}", (f"{'DenseGraphConv' if dense else 'GraphConv'}_{k - 1}",))
        yield from _bn(f"bn{k}", f"MaskedBatchNorm_{k - 1}")
        if k == 1 and sag:
            yield from _graph_conv("pool.gnn", ("SAGPool_0", "GraphConv_0"))
    yield from _lin("fc1", ("TorchLinear_0",))
    yield from _bn("bn3", "MaskedBatchNorm_2")
    yield from _lin("fc2", ("TorchLinear_1",))


_MAPPINGS = {
    "fully_connected_net": _fcn_mapping,
    "deep_sets": _deep_sets_mapping,
    "graph_net": _graph_net_mapping,
}


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
    """A ``state_dict`` (numpy values) from the JAX package's trees, with
    ``num_batches_tracked = 0`` beside every BatchNorm's running stats."""
    trees = {"params": params, "stats": batch_stats or {}}
    out: Dict[str, np.ndarray] = {}
    for key, tree_name, path, transpose in _mapping(model_name, config):
        v = np.asarray(_get(trees[tree_name], path), dtype=np.float32)
        out[key] = np.ascontiguousarray(v.T) if transpose else v
        if key.endswith(".running_var"):
            out[key[: -len("running_var")] + "num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    return out


# -- files ----------------------------------------------------------------------


def read_state_dict(model_name: str, config: dict, path: str) -> Dict[str, object]:
    """The ``state_dict`` in a checkpoint file of any of the three layouts:
    a torch ``state_dict`` (the original reference's or the port's, read
    with ``weights_only``) as it is, or the JAX package's pickle of
    ``{"params", "batch_stats"}`` through :func:`to_torch_state_dict`.  The
    pickle is unpickled as the JAX package's ``load`` does: read only
    checkpoints this project wrote."""
    import torch

    if zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        state = pickle.load(f)
    return to_torch_state_dict(
        model_name, config, state["params"], state.get("batch_stats") or {}
    )


def convert_checkpoint(model_name: str, config: dict, torch_ckpt_path: str, out_path: str) -> None:
    """A torch ``state_dict`` file (the original reference's, or the port's
    ``best_model.pt``) → the JAX package's checkpoint pickle."""
    import torch

    state = torch.load(torch_ckpt_path, map_location="cpu", weights_only=True)
    params, stats = convert_torch_state_dict(model_name, config, state)
    with open(out_path, "wb") as f:
        pickle.dump({"params": params, "batch_stats": stats}, f)


def export_torch_checkpoint(model_name: str, config: dict, ckpt_path: str, out_path: str) -> None:
    """A checkpoint of the JAX package or the port → a torch ``state_dict``
    file the original reference loads with ``strict=True``.  Either way the
    keys go through the mapping, so a checkpoint of another model or config
    raises."""
    import torch

    params, stats = convert_torch_state_dict(
        model_name, config, read_state_dict(model_name, config, ckpt_path)
    )
    state = to_torch_state_dict(model_name, config, params, stats)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, out_path)
