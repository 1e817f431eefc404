"""Shared model building blocks, in PyTorch: plain functions on tensors.

The port's copy of ``repro.models.common``.  Initializers take a
``torch.Generator`` where the reference takes a ``jax.random`` key (there is
no ``KeyGen``: a generator advances its own state), and draw on the
generator's device.  Norms compute in float32 and cast back, as there.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    # float64 is the port's own: chip_smoke.py holds GatedGCN's gradients on
    # the card against the CPU in float64, where no ReLU input sits within
    # rounding of its kink
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16,
            "float64": torch.float64}[name]


# ---------------------------------------------------------------------------
# Initializers (all take (gen, shape, dtype); tensors land on gen.device)
# ---------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, dtype, stddev=0.02) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * stddev).to(dtype)


def scaled_init(fan_in: int):
    def init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
        return normal_init(gen, shape, dtype, stddev=1.0 / math.sqrt(fan_in))

    return init


def zeros_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def ones_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def batchnorm_infer(x, scale, bias, mean, var, eps=1e-5):
    """Inference-mode batch norm (folded stats)."""
    inv = torch.rsqrt(var.float() + eps)
    y = (x.float() - mean) * inv * scale + bias
    return y.to(x.dtype)


ACTIVATIONS: Dict[str, Callable] = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "dice_proxy": torch.sigmoid,  # DIN's Dice ~ data-adaptive PReLU
    "identity": lambda x: x,
}


# ---------------------------------------------------------------------------
# Simple MLP (used by recsys towers and GNN heads)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, dims, dtype, bias=True):
    """dims = [in, h1, h2, ..., out]"""
    layers = []
    for i in range(len(dims) - 1):
        layer = {"w": scaled_init(dims[i])(gen, (dims[i], dims[i + 1]), dtype)}
        if bias:
            layer["b"] = torch.zeros((dims[i + 1],), dtype=dtype, device=gen.device)
        layers.append(layer)
    return layers


def mlp_apply(layers, x, act="relu", final_act="identity"):
    a = ACTIVATIONS[act]
    fa = ACTIVATIONS[final_act]
    for i, layer in enumerate(layers):
        x = x @ layer["w"]
        if "b" in layer:
            x = x + layer["b"]
        x = a(x) if i < len(layers) - 1 else fa(x)
    return x


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example CE; logits (..., V) float, labels (...) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - picked


def binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    labels = labels.float()
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def is_stacked_layers(path, node) -> bool:
    """Whether ``node`` at ``path`` (a tuple of keys) is the port's list of
    per-layer dicts that the reference stacks on axis 0.  The reference
    stacks exactly one list, the one under the key ``layers`` (the LM's
    scanned layers, GatedGCN's vmapped ones); every other list (MLP
    towers, BST ``blocks``, DCN-v2 ``cross`` and ``tables``) is a Python
    list there, its index a path element and its leaves ranked alone."""
    return (isinstance(node, list) and bool(node) and bool(path) and path[-1] == "layers"
            and all(isinstance(x, dict) for x in node))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def tree_leaves(tree) -> list:
    """The tensors of a nest of dicts / lists / tuples, in order."""
    return list(_leaves(tree))


def param_count(params) -> int:
    return sum(x.numel() for x in _leaves(params))


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor of a nest of dicts / lists / tuples
    (NamedTuples included); with ``rest``, to the matching tensors of
    trees of the same structure, as ``fn(leaf, *others)``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return tree
