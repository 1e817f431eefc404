"""Synthetic recsys batches (CTR-style) with realistic skew: item popularity
is Zipf-distributed; labels correlate with user-history/target similarity so
models can actually learn in the examples.

The port's copy of ``repro.data.recsys_data``: host numpy, unchanged, so the
same seed gives equal arrays in both packages."""

from __future__ import annotations

import numpy as np


def seq_batch(cfg, batch: int, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    T = cfg.seq_len
    # zipf item popularity
    items = (rng.zipf(1.3, size=(batch, T)) - 1) % cfg.item_vocab
    hist_len = rng.randint(max(1, T // 4), T + 1, size=batch)
    mask = (np.arange(T)[None, :] < hist_len[:, None]).astype(np.float32)
    target = (rng.zipf(1.3, size=batch) - 1) % cfg.item_vocab
    # label correlates with target appearing in the history
    seen = (items == target[:, None]).any(axis=1)
    p = np.where(seen, 0.7, 0.25)
    label = (rng.rand(batch) < p).astype(np.float32)
    return {
        "hist_items": items.astype(np.int32),
        "hist_cates": (items % cfg.cate_vocab).astype(np.int32),
        "hist_mask": mask,
        "target_item": target.astype(np.int32),
        "target_cate": (target % cfg.cate_vocab).astype(np.int32),
        "label": label,
    }


def dcn_batch(cfg, batch: int, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    vocabs = np.asarray(cfg.sparse_vocabs)
    sparse = (rng.zipf(1.2, size=(batch, cfg.n_sparse)) - 1) % vocabs[None, :]
    dense = np.log1p(rng.exponential(1.0, size=(batch, cfg.n_dense))).astype(np.float32)
    logit = dense[:, 0] - 1.0 + 0.3 * ((sparse[:, 0] % 7) == 0)
    label = (rng.rand(batch) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return {
        "dense": dense,
        "sparse": sparse.astype(np.int32),
        "label": label,
    }


def make_batch(cfg, batch: int, seed: int = 0, with_label: bool = True) -> dict:
    b = dcn_batch(cfg, batch, seed) if cfg.kind == "dcn" else seq_batch(cfg, batch, seed)
    if not with_label:
        b.pop("label")
    return b
