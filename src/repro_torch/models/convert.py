"""Carry LM parameters across from the reference's layout.

The reference keeps its parameters as a pytree whose ``"layers"`` entry
stacks every layer on axis 0 (for ``lax.scan``); the port keeps a list of
per-layer dicts.  ``lm_params_from_numpy`` takes the reference's tree as
numpy arrays (the caller does the device-to-host copy) and gives the port's
parameters, so that both packages compute the same function.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.packing import resolve_device
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
