"""Attention, in PyTorch: GQA with RoPE, chunked (flash-style) prefill
attention and single-token decode attention against a KV cache.

The port's copy of ``repro.models.attention``.  The chunked path never
materializes the full (Sq, Skv) score matrix: it loops over KV chunks with
online-softmax accumulators, and iterates Q chunks in an outer loop so the
causal schedule skips fully-masked KV chunks (the triangular schedule).

Where the reference contracts with ``preferred_element_type=float32``, the
port widens both operands to float32 first: the products of bfloat16 values
are exact in float32 and the sum accumulates in float32, as there (a
bfloat16 ``torch.matmul`` would round its output to bfloat16).  The int8
score product of ``decode_attention_q8`` is widened the same way; its sums,
at most 127^2 * head_dim < 2^24, are exact in float32 while TF32 is off
(PyTorch's default for float32 matmuls).
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    if angles.ndim == 2:  # (S, hd/2) -> broadcast over batch
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]  # (B, S, 1, hd/2)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention
# ---------------------------------------------------------------------------

def _chunk_attn_scan(q, k, v, kv_map, qpos0: int, causal: bool, kv_chunk: int, n_kv: int):
    """Online softmax over the first n_kv KV chunks for one Q chunk.

    q: (B, qc, H, hd); k, v: (B, Skv, KVH, hd); kv_map: (H,) head -> kv head.
    """
    B, qc, H, hd = q.shape
    dev = q.device
    qf = q.float()
    o = torch.zeros((B, H, qc, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, qc), dtype=torch.float32, device=dev)
    qpos = qpos0 + torch.arange(qc, device=dev)
    for kv_idx in range(n_kv):
        sl = slice(kv_idx * kv_chunk, (kv_idx + 1) * kv_chunk)
        # GQA expansion of one chunk: (B, kc, KVH, hd) -> (B, kc, H, hd)
        ks = k[:, sl].index_select(2, kv_map)
        vs = v[:, sl].index_select(2, kv_map)
        s = torch.einsum("bqhd,bshd->bhqs", qf, ks.float())
        s = s / math.sqrt(hd)
        if causal:
            kpos = kv_idx * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = qpos[:, None] >= kpos[None, :]
            s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqs,bshd->bhqd", p.to(v.dtype).float(), vs.float())
        o = o * alpha[..., None] + pv
        m = m_new
    return o / torch.clamp(l[..., None], min=1e-30)  # (B, H, qc, hd)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd); returns (B, Sq, H, hd).

    Triangular schedule: each Q chunk only visits the KV chunks its causal
    mask can reach.
    """
    B, Sq, H, hd = q.shape
    _, Skv, KVH, _ = k.shape
    if H % KVH != 0:
        raise ValueError("GQA requires n_heads % n_kv_heads == 0")
    kv_map = torch.from_numpy(np.repeat(np.arange(KVH), H // KVH)).to(q.device)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError("sequence lengths must be multiples of their chunks")

    outs = []
    for qi in range(Sq // q_chunk):
        qpos0 = qi * q_chunk
        if causal:
            n_kv = min((qpos0 + q_chunk + kv_chunk - 1) // kv_chunk, Skv // kv_chunk)
        else:
            n_kv = Skv // kv_chunk
        qs = q[:, qpos0 : qpos0 + q_chunk]
        outs.append(_chunk_attn_scan(qs, k, v, kv_map, qpos0, causal, kv_chunk, n_kv))
    o = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]  # (B, H, Sq, hd)
    return o.transpose(1, 2).to(q.dtype)  # (B, Sq, H, hd)


# ---------------------------------------------------------------------------
# Decode attention (one new token against a KV cache)
# ---------------------------------------------------------------------------

def _valid(cur_len, B: int, S: int, device) -> torch.Tensor:
    """(B, S) bool: cache position < cur_len (a scalar or one per row)."""
    pos = torch.arange(S, device=device)
    cur = torch.as_tensor(cur_len, device=device)
    return pos[None] < torch.broadcast_to(cur[..., None], (B, S))


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S, KVH, hd)
    v_cache: torch.Tensor,
    cur_len,  # int, scalar or (B,) tensor — number of valid cache positions
) -> torch.Tensor:
    B, _, H, hd = q.shape
    _, S, KVH, _ = k_cache.shape
    G = H // KVH
    qg = q.reshape(B, 1, KVH, G, hd)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k_cache.float())
    s = s / math.sqrt(hd)  # (B, KVH, G, 1, S)
    valid = _valid(cur_len, B, S, q.device)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshd->bhgqd", p.to(v_cache.dtype).float(), v_cache.float())
    o = o.movedim(3, 1).reshape(B, 1, H, hd)
    return o.to(q.dtype)


def decode_attention_q8(
    q: torch.Tensor,  # (B, 1, H, hd) activation dtype
    k_q: torch.Tensor,  # (B, S, KVH, hd) int8
    k_scale: torch.Tensor,  # (B, S, KVH) fp32
    v_q: torch.Tensor,  # (B, S, KVH, hd) int8
    v_scale: torch.Tensor,  # (B, S, KVH) fp32
    cur_len,
) -> torch.Tensor:
    """Decode attention reading an int8 KV cache.

    Scores are an int8 x int8 product with the per-(position, kv-head) K
    scales and per-query Q scales factored out of the contraction, which
    runs in float32 on the int8 values (exact: see the module docstring);
    PV folds the V scales into the probabilities and contracts bfloat16
    probabilities with the int8 V rows, accumulating in float32.
    """
    B, _, H, hd = q.shape
    _, S, KVH, _ = k_q.shape
    G = H // KVH
    # per-(B, head) symmetric quantization of the single query
    q32 = q.float()
    q_amax = torch.amax(torch.abs(q32), dim=-1, keepdim=True)  # (B,1,H,1)
    q_scale = torch.clamp(q_amax / 127.0, min=1e-8)
    qq = torch.clamp(torch.round(q32 / q_scale), -127, 127).to(torch.int8)
    qg = qq.reshape(B, 1, KVH, G, hd)
    s_int = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k_q.float())
    qs = q_scale.reshape(B, KVH, G)[:, :, :, None, None]  # (B,KVH,G,1,1)
    ks = k_scale.permute(0, 2, 1)[:, :, None, None, :]  # (B,KVH,1,1,S)
    s = s_int * qs * ks / math.sqrt(hd)
    valid = _valid(cur_len, B, S, q.device)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # PV: fold the per-position V scales into the probabilities so the
    # contraction consumes raw int8 V rows (fp32 accumulation)
    p_scaled = (p * v_scale.permute(0, 2, 1)[:, :, None, None, :]).to(torch.bfloat16)
    pv = torch.einsum("bhgqs,bshd->bhgqd", p_scaled.float(), v_q.to(torch.bfloat16).float())
    o = pv.movedim(3, 1).reshape(B, 1, H, hd)
    return o.to(q.dtype)
