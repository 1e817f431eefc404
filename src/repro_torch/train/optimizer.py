"""Optimizers, in PyTorch (functional: init / update on trees of tensors).

The port's copy of ``repro.train.optimizer``: AdamW with decoupled weight
decay, global-norm gradient clipping, warmup + cosine schedule.  Moments
are float32 whatever the parameters' dtype; the update runs in float32 and
casts once to the parameter's dtype (bfloat16 at full configs), as there.
``torch.optim.AdamW`` does none of this (it updates bfloat16 parameters in
bfloat16, decays every leaf and does not clip).

The schedule and the bias corrections are float32 tensors, as the
reference's float32 arrays are: Python floats are float64 and would shift
the update's last bits.  Parameters, gradients and moments are nests of
dicts / lists of tensors; ``params["layers"]`` is the port's list of
per-layer dicts, which the reference stacks on axis 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.common import is_stacked_layers, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # scalar int32
    m: dict  # first moments (fp32, param-tree)
    v: dict  # second moments (fp32, param-tree)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = _f32(cfg.peak_lr, step) * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, norm: Optional[torch.Tensor] = None):
    """``norm``: the global norm when ``grads`` are one rank's shards of a
    sharded tree (its squares summed over the shards); default, the tree's own."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _decay_mask(params, path=(), stacked: int = 0):
    """Decay matrices; skip vectors (norm scales, biases, 1-D tables).

    The rank is the reference's: it stacks ``layers`` on axis 0, so a leaf
    inside the port's per-layer list under that key counts one axis more (a
    layer's norm scale is a matrix there, and decays).  Any other list
    (an MLP tower, BST blocks) is a list there too: its leaves keep their
    own rank (``models.common.is_stacked_layers``)."""
    if isinstance(params, torch.Tensor):
        return params.ndim + stacked >= 2
    if isinstance(params, dict):
        return {k: _decay_mask(v, path + (k,), stacked) for k, v in params.items()}
    stacked += is_stacked_layers(path, params)
    return [_decay_mask(v, path + (str(i),), stacked) for i, v in enumerate(params)]


def adamw_init(params, cfg: Optional[AdamWConfig] = None) -> AdamWState:
    del cfg
    leaves = tree_leaves(params)
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        m=tree_map(zeros32, params),
        v=tree_map(zeros32, params),
    )


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 grad_norm: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state, metrics).  ``grad_norm``: the global
    gradient norm, for a rank's shards of sharded trees
    (``train.loop.make_mesh_train_step``)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, grad_norm)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    step32 = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, step32), step32)
    bc2 = 1 - torch.pow(_f32(b2, step32), step32)

    def upd(p, g, m, v, decay):
        g32 = g.float()
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * torch.square(g32)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + (cfg.weight_decay if decay else 0.0) * p.float()
        p_new = (p.float() - lr * delta).to(p.dtype)
        return p_new, m_new, v_new

    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                 tree_leaves(state.v), _flags(_decay_mask(params)))
    with torch.no_grad():
        out = [upd(p, g, m, v, d) for p, g, m, v, d in leaves]
    new_p = _unflatten(params, [o[0] for o in out])
    new_m = _unflatten(params, [o[1] for o in out])
    new_v = _unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step=step, m=new_m, v=new_v), metrics


def _flags(mask) -> list:
    """The decay mask's flags in ``tree_leaves`` order."""
    if isinstance(mask, bool):
        return [mask]
    return [f for v in (mask.values() if isinstance(mask, dict) else mask) for f in _flags(v)]


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def sgd_update(grads, params, lr: float):
    """Plain SGD (used by tiny smoke tests)."""
    with torch.no_grad():
        return tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype), params, grads)
