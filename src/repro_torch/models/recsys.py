"""RecSys / ranking models, in PyTorch: DIN, DIEN, BST, DCN-v2.

The port's copy of ``repro.models.recsys``.  Structure shared by all four:
sparse embedding tables (see models/embedding.py) -> feature interaction
(target attention / AUGRU / transformer block / cross network) -> small MLP
tower -> CTR logit.  Parameters are dicts and lists of tensors with the
reference's keys; its lists (MLP towers, BST ``blocks``, DCN-v2 ``cross``
and ``tables``) stay lists.  DIEN's two ``lax.scan``s are Python loops over
the sequence, each step a ``torch.where`` on the mask.

Batch layouts (built by data/recsys_data.py):
  DIN/DIEN: {"hist_items": (B,T), "hist_cates": (B,T), "hist_mask": (B,T),
             "target_item": (B,), "target_cate": (B,), "label": (B,)}
  BST:      same with T=20 (target appended as the 21st sequence position)
  DCN-v2:   {"dense": (B,13), "sparse": (B,26), "label": (B,)}

``logits`` and ``train_loss`` take tensors where the parameters are;
``serve_scores`` and ``retrieval_scores`` also take numpy batches, which go
to ``device`` (default: the card).  ``retrieval_scores`` scores ONE user
against C candidates as batched forwards of up to ``RETRIEVAL_BLOCK``
candidates each, never a loop over single candidates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.packing import resolve_device
from repro_torch.models.common import (
    binary_cross_entropy,
    dtype_of,
    layernorm,
    mlp_apply,
    mlp_init,
    normal_init,
    scaled_init,
    tree_map,
)
from repro_torch.models.embedding import TableSpec, embedding_lookup, init_table
from repro_torch.train.loop import batch_to


# ===========================================================================
# Configs
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    kind: str  # "din" | "dien" | "bst" | "dcn"
    embed_dim: int
    seq_len: int = 0
    item_vocab: int = 1_000_000
    cate_vocab: int = 10_000
    # DIN
    attn_mlp: Tuple[int, ...] = (80, 40)
    mlp: Tuple[int, ...] = (200, 80)
    # DIEN
    gru_dim: int = 0
    # BST
    n_heads: int = 8
    n_blocks: int = 1
    # DCN
    n_dense: int = 13
    n_sparse: int = 26
    n_cross_layers: int = 3
    sparse_vocabs: Tuple[int, ...] = ()
    dtype: str = "float32"
    param_dtype: str = "float32"

    @property
    def pair_dim(self) -> int:
        """item+cate embedding concat width for sequence models."""
        return 2 * self.embed_dim


def dcn_default_vocabs(n_sparse: int = 26) -> Tuple[int, ...]:
    """Criteo-like skewed vocab sizes: a few huge fields, a long small tail."""
    vocabs = [10_000_000] * 3 + [1_000_000] * 5 + [100_000] * 8 + [10_000] * 10
    return tuple(vocabs[:n_sparse])


# ===========================================================================
# Shared init pieces
# ===========================================================================

def _zeros(gen: torch.Generator, n: int, pdt) -> torch.Tensor:
    return torch.zeros((n,), dtype=pdt, device=gen.device)


def _seq_tables(gen: torch.Generator, cfg: RecSysConfig, pdt):
    return {
        "item_table": init_table(gen, TableSpec("item", cfg.item_vocab, cfg.embed_dim), pdt),
        "cate_table": init_table(gen, TableSpec("cate", cfg.cate_vocab, cfg.embed_dim), pdt),
    }


def _pair_embed(params, items, cates):
    """(..., ) ids -> (..., 2*embed_dim) concat of item and category."""
    return torch.cat(
        [embedding_lookup(params["item_table"], items),
         embedding_lookup(params["cate_table"], cates)],
        dim=-1,
    )


# ===========================================================================
# DIN — Deep Interest Network (target attention over behavior sequence)
# ===========================================================================

def din_init(gen: torch.Generator, cfg: RecSysConfig):
    pdt = dtype_of(cfg.param_dtype)
    d = cfg.pair_dim
    p = _seq_tables(gen, cfg, pdt)
    p["attn_mlp"] = mlp_init(gen, [4 * d, *cfg.attn_mlp, 1], pdt)
    p["tower"] = mlp_init(gen, [3 * d, *cfg.mlp, 1], pdt)
    return p


def _din_attention(params, hist, tgt, mask):
    """hist (B,T,d), tgt (B,d) -> pooled (B,d). Raw (unnormalized) scores
    as in the paper; masked positions contribute zero."""
    tgt_b = tgt[:, None, :].expand_as(hist)
    feats = torch.cat([hist, tgt_b, hist - tgt_b, hist * tgt_b], dim=-1)
    scores = mlp_apply(params["attn_mlp"], feats, act="sigmoid")[..., 0]  # (B,T)
    scores = scores * mask.to(scores.dtype)
    return torch.einsum("bt,btd->bd", scores, hist)


def din_logits(params, cfg: RecSysConfig, batch):
    hist = _pair_embed(params, batch["hist_items"], batch["hist_cates"])
    tgt = _pair_embed(params, batch["target_item"], batch["target_cate"])
    pooled = _din_attention(params, hist, tgt, batch["hist_mask"])
    x = torch.cat([pooled, tgt, pooled * tgt], dim=-1)
    return mlp_apply(params["tower"], x, act="sigmoid")[..., 0]


# ===========================================================================
# DIEN — interest evolution: GRU + attentional AUGRU over the sequence
# ===========================================================================

def _gru_init(gen: torch.Generator, d_in: int, d_h: int, pdt):
    return {
        "wz": scaled_init(d_in + d_h)(gen, (d_in + d_h, d_h), pdt),
        "wr": scaled_init(d_in + d_h)(gen, (d_in + d_h, d_h), pdt),
        "wh": scaled_init(d_in + d_h)(gen, (d_in + d_h, d_h), pdt),
        "bz": _zeros(gen, d_h, pdt),
        "br": _zeros(gen, d_h, pdt),
        "bh": _zeros(gen, d_h, pdt),
    }


def _gru_cell(p, h, x, att=None):
    """Standard GRU; if att (scalar per example) given, AUGRU gate scaling."""
    xh = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(xh @ p["wz"] + p["bz"])
    r = torch.sigmoid(xh @ p["wr"] + p["br"])
    xrh = torch.cat([x, r * h], dim=-1)
    cand = torch.tanh(xrh @ p["wh"] + p["bh"])
    if att is not None:
        z = z * att[:, None]  # AUGRU: attention modulates the update gate
    return (1.0 - z) * h + z * cand


def dien_init(gen: torch.Generator, cfg: RecSysConfig):
    pdt = dtype_of(cfg.param_dtype)
    d, dh = cfg.pair_dim, cfg.gru_dim
    p = _seq_tables(gen, cfg, pdt)
    p["gru1"] = _gru_init(gen, d, dh, pdt)
    p["gru2"] = _gru_init(gen, dh, dh, pdt)
    p["att_w"] = scaled_init(dh)(gen, (dh, d), pdt)  # bilinear attention
    p["tower"] = mlp_init(gen, [d + dh, *cfg.mlp, 1], pdt)
    return p


def dien_logits(params, cfg: RecSysConfig, batch):
    hist = _pair_embed(params, batch["hist_items"], batch["hist_cates"])  # (B,T,d)
    tgt = _pair_embed(params, batch["target_item"], batch["target_cate"])  # (B,d)
    mask = batch["hist_mask"].to(hist.dtype)
    B, T, _ = hist.shape
    live = mask[:, :, None] > 0  # (B, T, 1)

    # interest extraction GRU
    h = hist.new_zeros((B, cfg.gru_dim))
    states = []
    for t in range(T):
        h = torch.where(live[:, t], _gru_cell(params["gru1"], h, hist[:, t]), h)
        states.append(h)
    states = torch.stack(states, dim=1)  # (B, T, dh)

    # attention of each interest state w.r.t. the target (bilinear + softmax)
    att_logits = torch.einsum("bth,hd,bd->bt", states, params["att_w"], tgt)
    att_logits = torch.where(mask > 0, att_logits, -1e30)
    att = torch.softmax(att_logits, dim=-1)  # (B, T)

    # interest evolution AUGRU
    h = hist.new_zeros((B, cfg.gru_dim))
    for t in range(T):
        h = torch.where(live[:, t], _gru_cell(params["gru2"], h, states[:, t], att=att[:, t]), h)
    x = torch.cat([tgt, h], dim=-1)
    return mlp_apply(params["tower"], x, act="sigmoid")[..., 0]


# ===========================================================================
# BST — Behavior Sequence Transformer
# ===========================================================================

def bst_init(gen: torch.Generator, cfg: RecSysConfig):
    pdt = dtype_of(cfg.param_dtype)
    d = cfg.pair_dim  # transformer width = item+cate embed
    p = _seq_tables(gen, cfg, pdt)
    p["pos_table"] = normal_init(gen, (cfg.seq_len + 1, d), pdt)
    p["blocks"] = [
        {
            "wq": scaled_init(d)(gen, (d, d), pdt),
            "wk": scaled_init(d)(gen, (d, d), pdt),
            "wv": scaled_init(d)(gen, (d, d), pdt),
            "wo": scaled_init(d)(gen, (d, d), pdt),
            "ln1": torch.ones((d,), dtype=pdt, device=gen.device),
            "ln1_b": _zeros(gen, d, pdt),
            "ln2": torch.ones((d,), dtype=pdt, device=gen.device),
            "ln2_b": _zeros(gen, d, pdt),
            "ff1": scaled_init(d)(gen, (d, 4 * d), pdt),
            "ff2": scaled_init(4 * d)(gen, (4 * d, d), pdt),
        }
        for _ in range(cfg.n_blocks)
    ]
    p["tower"] = mlp_init(gen, [(cfg.seq_len + 1) * d, *cfg.mlp, 1], pdt)
    return p


def _bst_block(blk, x, mask, n_heads, eps=1e-5):
    B, T, d = x.shape
    hd = d // n_heads
    xa = layernorm(x, blk["ln1"], blk["ln1_b"], eps)
    q = (xa @ blk["wq"]).reshape(B, T, n_heads, hd)
    k = (xa @ blk["wk"]).reshape(B, T, n_heads, hd)
    v = (xa @ blk["wv"]).reshape(B, T, n_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    s = torch.where(mask[:, None, None, :] > 0, s, -1e30)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, T, d)
    x = x + o @ blk["wo"]
    xf = layernorm(x, blk["ln2"], blk["ln2_b"], eps)
    return x + F.relu(xf @ blk["ff1"]) @ blk["ff2"]


def bst_logits(params, cfg: RecSysConfig, batch):
    hist = _pair_embed(params, batch["hist_items"], batch["hist_cates"])  # (B,T,d)
    tgt = _pair_embed(params, batch["target_item"], batch["target_cate"])  # (B,d)
    seq = torch.cat([hist, tgt[:, None, :]], dim=1)  # target appended
    B, T1, d = seq.shape
    seq = seq + params["pos_table"][None, :T1, :]
    hm = batch["hist_mask"]
    mask = torch.cat([hm, hm.new_ones((B, 1))], dim=1)
    x = seq
    for blk in params["blocks"]:
        x = _bst_block(blk, x, mask, cfg.n_heads)
    x = (x * mask[..., None].to(x.dtype)).reshape(B, T1 * d)
    return mlp_apply(params["tower"], x, act="relu")[..., 0]


# ===========================================================================
# DCN-v2 — deep & cross network (full-rank cross layers, stacked)
# ===========================================================================

def dcn_init(gen: torch.Generator, cfg: RecSysConfig):
    pdt = dtype_of(cfg.param_dtype)
    vocabs = cfg.sparse_vocabs or dcn_default_vocabs(cfg.n_sparse)
    tables = [
        init_table(gen, TableSpec(f"f{i}", v, cfg.embed_dim), pdt)
        for i, v in enumerate(vocabs)
    ]
    x0_dim = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    cross = [
        {"w": scaled_init(x0_dim)(gen, (x0_dim, x0_dim), pdt), "b": _zeros(gen, x0_dim, pdt)}
        for _ in range(cfg.n_cross_layers)
    ]
    return {
        "tables": tables,
        "cross": cross,
        "tower": mlp_init(gen, [x0_dim, *cfg.mlp, 1], pdt),
    }


def dcn_logits(params, cfg: RecSysConfig, batch):
    dense = batch["dense"].to(dtype_of(cfg.dtype))  # (B, 13)
    sparse = batch["sparse"]  # (B, 26) int
    embs = [embedding_lookup(tab, sparse[:, i]) for i, tab in enumerate(params["tables"])]
    x0 = torch.cat([dense] + embs, dim=-1)  # (B, 429)
    x = x0
    for layer in params["cross"]:
        x = x0 * (x @ layer["w"] + layer["b"]) + x  # DCN-v2 cross
    return mlp_apply(params["tower"], x, act="relu")[..., 0]


# ===========================================================================
# Dispatch + losses + retrieval
# ===========================================================================

# Candidates a retrieval forward scores at once.  One user's history
# repeated over C candidates makes (C, T, .) activations (DIN's attention
# features alone are 57.6 GB at C = 1 M in float32), so larger C runs in
# blocks of this many rows; a row's score reads its own row only, so the
# blocks change no score.
RETRIEVAL_BLOCK = 1 << 18

_INITS = {"din": din_init, "dien": dien_init, "bst": bst_init, "dcn": dcn_init}
_LOGITS = {"din": din_logits, "dien": dien_logits, "bst": bst_logits, "dcn": dcn_logits}


def init_params(gen: torch.Generator, cfg: RecSysConfig, *, device=None):
    """Random parameters drawn from ``gen`` (on its device), placed on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), _INITS[cfg.kind](gen, cfg))


def param_shapes(cfg: RecSysConfig):
    """The parameters' shapes and dtypes, as meta tensors (nothing is
    allocated or drawn: DCN-v2's tables alone hold 574 M floats)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init_params(torch.Generator(), cfg, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def logits(params, cfg: RecSysConfig, batch):
    return _LOGITS[cfg.kind](params, cfg, batch)


def train_loss(params, cfg: RecSysConfig, batch):
    lg = logits(params, cfg, batch)
    return binary_cross_entropy(lg, batch["label"]).mean()


def serve_scores(params, cfg: RecSysConfig, batch, *, device=None):
    """CTR scores of a batch (numpy or tensors), on ``device`` (default:
    the card)."""
    return torch.sigmoid(logits(params, cfg, batch_to(batch, resolve_device(device))))


def retrieval_scores(params, cfg: RecSysConfig, user_batch, candidates, *, device=None):
    """Score ONE user against C candidate items, RETRIEVAL_BLOCK candidates
    a batched forward.

    user_batch: the sequence-model fields with B=1 (or dense/sparse for dcn).
    candidates: (C,) item ids (sequence models) or (C, n_sparse) rows (dcn).
    """
    dev = resolve_device(device)
    user_batch, candidates = batch_to(user_batch, dev), batch_to(candidates, dev)
    return torch.cat([
        _retrieval_block(params, cfg, user_batch, candidates[lo : lo + RETRIEVAL_BLOCK], dev)
        for lo in range(0, max(candidates.shape[0], 1), RETRIEVAL_BLOCK)
    ])


def _retrieval_block(params, cfg: RecSysConfig, user_batch, candidates, dev):
    C = candidates.shape[0]
    if cfg.kind == "dcn":
        batch = {
            "dense": user_batch["dense"].expand(C, cfg.n_dense),
            "sparse": candidates,
        }
        return serve_scores(params, cfg, batch, device=dev)
    T = cfg.seq_len
    batch = {
        "hist_items": user_batch["hist_items"].expand(C, T),
        "hist_cates": user_batch["hist_cates"].expand(C, T),
        "hist_mask": user_batch["hist_mask"].expand(C, T),
        "target_item": candidates,
        "target_cate": candidates % cfg.cate_vocab,
    }
    return serve_scores(params, cfg, batch, device=dev)
