"""Carry parameters across from the reference's layout.

The reference keeps its LM and GatedGCN parameters as a pytree whose
``"layers"`` entry stacks every layer on axis 0 (for ``lax.scan``); the
port keeps a list of per-layer dicts.  Every other list (recsys towers,
BST ``blocks``, DCN-v2 ``cross`` and ``tables``, the GNN ``head_mlp``) is a
list on both sides.  The functions here take the reference's tree as numpy
arrays (the caller does the device-to-host copy) and give the port's
parameters, so that both packages compute the same function.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.packing import resolve_device
from repro_torch.models.gnn import GNNConfig
from repro_torch.models.recsys import RecSysConfig
from repro_torch.models.transformer import LMConfig


def _tensor(a, device) -> torch.Tensor:
    """numpy -> tensor, bfloat16 included (numpy has no bfloat16 of its own:
    ml_dtypes' bfloat16 goes through its 16 raw bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def _layer(stacked: Mapping, i: int, device):
    return {k: (_layer(v, i, device) if isinstance(v, Mapping) else _tensor(v[i], device))
            for k, v in stacked.items()}


def lm_params_from_numpy(tree: Mapping, cfg: LMConfig, *, device=None):
    """The reference's LM parameter tree (numpy leaves, ``layers`` stacked
    on axis 0) as the port's parameters on ``device`` (default: the card).
    Covers dense and MoE (``router``/``w1``/``w3``/``w2``) layers and tied
    embeddings (no ``unembed``)."""
    dev = resolve_device(device)
    layers = tree["layers"]
    n = len(np.asarray(layers["ln1"]))
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.n_layers}")
    out = {
        "embed": _tensor(tree["embed"], dev),
        "layers": [_layer(layers, i, dev) for i in range(n)],
        "ln_f": _tensor(tree["ln_f"], dev),
    }
    if cfg.tie_embeddings:
        if "unembed" in tree:
            raise ValueError("tied config but the tree has an unembed matrix")
    else:
        out["unembed"] = _tensor(tree["unembed"], dev)
    return out


def _tree(node, device):
    """A nest of dicts / lists of numpy arrays as the same nest of tensors."""
    if isinstance(node, Mapping):
        return {k: _tree(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, device) for v in node]
    return _tensor(node, device)


def recsys_params_from_numpy(tree: Mapping, cfg: RecSysConfig, *, device=None):
    """The reference's DIN / DIEN / BST / DCN-v2 parameter tree (numpy
    leaves) as the port's parameters on ``device`` (default: the card):
    the same dicts and lists."""
    dev = resolve_device(device)
    if cfg.kind == "dcn":
        if len(tree["tables"]) != cfg.n_sparse or len(tree["cross"]) != cfg.n_cross_layers:
            raise ValueError(f"tree does not match the {cfg.name} config")
    elif np.asarray(tree["item_table"]).shape != (cfg.item_vocab, cfg.embed_dim):
        raise ValueError(f"tree does not match the {cfg.name} config")
    return _tree(tree, dev)


def gnn_params_from_numpy(tree: Mapping, cfg: GNNConfig, *, device=None):
    """The reference's GatedGCN parameter tree (numpy leaves, ``layers``
    stacked on axis 0) as the port's parameters on ``device`` (default:
    the card), ``layers`` split into the per-layer list."""
    dev = resolve_device(device)
    layers = tree["layers"]
    n = len(np.asarray(layers["A"]))
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.n_layers}")
    out = _tree({k: v for k, v in tree.items() if k != "layers"}, dev)
    out["layers"] = [_layer(layers, i, dev) for i in range(n)]
    return out
