"""Mixture-of-Experts FFN (GShard/Switch-style capacity dispatch, top-k), in
PyTorch.  Forward only.

The port's copy of ``repro.models.moe``.  Tokens are processed in fixed-size
groups; within a group a (g, E, C) dispatch one-hot routes each token to its
top-k experts (capacity-dropped: the residual carries dropped tokens).  The
reference vmaps one group at a time; here the group axis leads every tensor
and the einsums batch over it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import scaled_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    group_size: int = 4096  # tokens per dispatch group


def capacity(cfg: MoEConfig, group: int) -> int:
    c = int(group * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to multiple of 4


def moe_params_init(gen: torch.Generator, d_model: int, d_ff: int, cfg: MoEConfig, dtype):
    E = cfg.num_experts
    return {
        "router": scaled_init(d_model)(gen, (d_model, E), torch.float32),
        "w1": scaled_init(d_model)(gen, (E, d_model, d_ff), dtype),
        "w3": scaled_init(d_model)(gen, (E, d_model, d_ff), dtype),
        "w2": scaled_init(d_ff)(gen, (E, d_ff, d_model), dtype),
    }


def _route(logits: torch.Tensor, cfg: MoEConfig, cap: int):
    """Dispatch and combine (..., g, E, C) and probs (..., g, E) for groups
    of router logits (..., g, E).

    GShard-style top-k with capacity: each routing round assigns every token
    its next-best expert; a token's slot within an expert's capacity buffer is
    its prefix count (tokens assigned to that expert earlier in the group or
    in earlier rounds), summed in float32 as in the reference.  Tokens past
    capacity are dropped.  Combine gates are the selected softmax probs
    renormalized over the token's selected experts (pre-drop mass).
    """
    E = logits.shape[-1]
    lead = logits.shape[:-1]  # (..., g)
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    dispatch = torch.zeros((*lead, E, cap), dtype=torch.float32, device=dev)
    combine = torch.zeros((*lead, E, cap), dtype=torch.float32, device=dev)
    masked = probs
    prev_count = torch.zeros((*lead[:-1], E), dtype=torch.float32, device=dev)
    gate_total = torch.zeros(lead, dtype=torch.float32, device=dev)
    for _ in range(cfg.top_k):
        idx = torch.argmax(masked, dim=-1)  # first maximum, as jnp.argmax
        onehot = F.one_hot(idx, E).float()  # (..., g, E)
        within = torch.cumsum(onehot, dim=-2) - onehot  # earlier tokens this round
        pos_e = within + prev_count[..., None, :]
        pos = (pos_e * onehot).sum(dim=-1).to(torch.int64)  # (..., g)
        keep = (pos < cap).float()
        gate = (probs * onehot).sum(dim=-1)
        gate_total = gate_total + gate
        # a dropped token's slot row is all zeros (jax.nn.one_hot past the end)
        pos_oh = F.one_hot(torch.clamp(pos, max=cap - 1), cap).float() * keep[..., None]
        sel = onehot * keep[..., None]
        dispatch = dispatch + sel[..., :, None] * pos_oh[..., None, :]
        combine = combine + ((gate * keep)[..., None] * onehot)[..., None] * pos_oh[..., None, :]
        prev_count = prev_count + onehot.sum(dim=-2)
        masked = masked * (1.0 - onehot)  # don't re-pick the same expert
    combine = combine / torch.clamp(gate_total, min=1e-9)[..., None, None]
    return dispatch, combine, probs


def _aux_loss(probs: torch.Tensor, dispatch: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balancing loss, one per group."""
    me = probs.mean(dim=-2)  # (..., E)
    ce = dispatch.sum(dim=-1).mean(dim=-2)  # (..., E) average assignment
    return E * torch.sum(me * ce, dim=-1)


def moe_ffn(
    x: torch.Tensor,  # (T, d_model) flattened tokens
    params: dict,
    cfg: MoEConfig,
    act=F.silu,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (T, d_model), aux_loss scalar)."""
    T, d = x.shape
    g = min(cfg.group_size, T)
    if T % g:
        raise ValueError(f"tokens {T} not divisible by group {g}")
    cap = capacity(cfg, g)
    E = cfg.num_experts

    xg = x.reshape(T // g, g, d)
    logits = xg.float() @ params["router"]  # (n, g, E)
    dispatch, combine, probs = _route(logits, cfg, cap)
    xd = torch.einsum("ngec,ngd->necd", dispatch.to(x.dtype), xg)  # (n, E, C, d)
    h = act(torch.einsum("necd,edf->necf", xd, params["w1"])) * torch.einsum(
        "necd,edf->necf", xd, params["w3"]
    )
    ye = torch.einsum("necf,efd->necd", h, params["w2"])
    y = torch.einsum("ngec,necd->ngd", combine.to(ye.dtype), ye)
    return y.reshape(T, d), _aux_loss(probs, dispatch, E).mean()
