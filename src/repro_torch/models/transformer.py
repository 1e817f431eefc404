"""LM-family transformer, in PyTorch: llama-style blocks with GQA + RoPE +
RMSNorm, optional MoE FFN (phi3.5-moe, grok-1), with rematerialized layers
for training.

The port's copy of ``repro.models.transformer``:

  * ``train_loss``     — (B, S) tokens -> scalar CE loss (plus the MoE aux
                         loss), differentiable by autograd;
  * ``prefill``        — (B, S) tokens -> last logits + KV cache;
  * ``decode_step``    — one token + KV cache -> logits, the cache updated;
  * ``decode_step_q8`` — the same against an int8 KV cache.

Parameters are a dict of tensors as in the reference, except that
``params["layers"]`` is a list of per-layer dicts (the reference stacks
them on axis 0 and scans; here a Python loop runs over the list).
``models.convert.lm_params_from_numpy`` turns the reference's pytree into
this layout.  With ``cfg.remat`` each layer of ``backbone`` runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
scanned layer): the backward pass recomputes it, so activation memory is
one layer deep.  The decode steps write the new K/V entries into the
caches in place, at ``pos``, and return them; no other operation here is
in place.

Every forward pass takes the reference's ``constrain(x, name)`` hook,
called with the same names at the same points ("residual", "qkv",
"kv_attn", "ffn_hidden", "moe_in", "logits", "kv_cache", "kv_cache_l",
"kv_cache_scale"); ``dist.sharding.make_constrain`` builds one from an
activation table.  It defaults to the identity.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.packing import resolve_device
from repro_torch.models.attention import (apply_rope, decode_attention,
                                          decode_attention_q8, flash_attention)
from repro_torch.models.common import dtype_of, normal_init, rmsnorm, scaled_init, tree_map
from repro_torch.models.moe import MoEConfig, moe_ffn, moe_params_init


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    moe_experts: int = 0  # 0 => dense FFN
    moe_top_k: int = 2
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    q_chunk: int = 1024
    kv_chunk: int = 1024
    ce_chunk: int = 512
    moe_group: int = 4096
    aux_loss_coef: float = 0.01
    remat: bool = True
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(
            num_experts=self.moe_experts,
            top_k=self.moe_top_k,
            group_size=self.moe_group,
        )

    def _count(self, experts: int) -> int:
        d, f, V = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.is_moe:
            ffn = experts * 3 * d * f + d * self.moe_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        emb = V * d if self.tie_embeddings else V * d * 2
        return emb + self.n_layers * per_layer + d

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        return self._count(self.moe_experts)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        return self._count(self.moe_top_k)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: LMConfig):
    d, hd = cfg.d_model, cfg.head_dim
    pdt = dtype_of(cfg.param_dtype)
    p = {
        "ln1": torch.ones((d,), dtype=pdt, device=gen.device),
        "ln2": torch.ones((d,), dtype=pdt, device=gen.device),
        "wq": scaled_init(d)(gen, (d, cfg.n_heads * hd), pdt),
        "wk": scaled_init(d)(gen, (d, cfg.n_kv_heads * hd), pdt),
        "wv": scaled_init(d)(gen, (d, cfg.n_kv_heads * hd), pdt),
        "wo": scaled_init(cfg.n_heads * hd)(gen, (cfg.n_heads * hd, d), pdt),
    }
    if cfg.is_moe:
        p["moe"] = moe_params_init(gen, d, cfg.d_ff, cfg.moe_cfg, pdt)
    else:
        p["mlp"] = {
            "w1": scaled_init(d)(gen, (d, cfg.d_ff), pdt),
            "w3": scaled_init(d)(gen, (d, cfg.d_ff), pdt),
            "w2": scaled_init(cfg.d_ff)(gen, (cfg.d_ff, d), pdt),
        }
    return p


def init_params(gen: torch.Generator, cfg: LMConfig, *, device=None):
    """Random parameters drawn from ``gen`` (on its device), placed on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    pdt = dtype_of(cfg.param_dtype)
    p = {
        "layers": [_layer_init(gen, cfg) for _ in range(cfg.n_layers)],
        "embed": normal_init(gen, (cfg.vocab, cfg.d_model), pdt),
        "ln_f": torch.ones((cfg.d_model,), dtype=pdt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = normal_init(gen, (cfg.d_model, cfg.vocab), pdt)
    return tree_map(lambda t: t.to(dev), p)


def unembed_matrix(params, cfg: LMConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def param_shapes(cfg: LMConfig):
    """The parameters' shapes and dtypes, as meta tensors (nothing is
    allocated or drawn)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init_params(torch.Generator(), cfg, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _no_constrain(x, name):
    del name
    return x


def _qkv(x, lp, cfg: LMConfig, positions):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ lp["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def _attn_block(h, lp, cfg: LMConfig, positions, constrain=_no_constrain):
    B, S, _ = h.shape
    q, k, v = _qkv(rmsnorm(h, lp["ln1"], cfg.norm_eps), lp, cfg, positions)
    q = constrain(q, "qkv")
    k = constrain(k, "kv_attn")
    v = constrain(v, "kv_attn")
    o = flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return h + (o.reshape(B, S, -1) @ lp["wo"]), (k, v)


def _ffn_block(h, lp, cfg: LMConfig, constrain=_no_constrain):
    B, S, d = h.shape
    x = rmsnorm(h, lp["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        x = constrain(x, "moe_in")
        y, aux = moe_ffn(x.reshape(B * S, d), lp["moe"], cfg.moe_cfg)
        y = y.reshape(B, S, d)
    else:
        hmid = F.silu(x @ lp["mlp"]["w1"]) * (x @ lp["mlp"]["w3"])
        hmid = constrain(hmid, "ffn_hidden")
        y = hmid @ lp["mlp"]["w2"]
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + y, aux


def _layer(h, lp, cfg: LMConfig, positions, constrain):
    h, _ = _attn_block(h, lp, cfg, positions, constrain)
    h, aux = _ffn_block(h, lp, cfg, constrain)
    return constrain(h, "residual"), aux


def _logits(params, cfg: LMConfig, h_last) -> torch.Tensor:
    h_last = rmsnorm(h_last, params["ln_f"], cfg.norm_eps)
    return (h_last @ unembed_matrix(params, cfg)).float()


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def backbone(params, cfg: LMConfig, tokens: torch.Tensor, constrain=_no_constrain):
    """(B, S) int -> (final hidden states (B, S, d), the mean of the layers'
    aux losses; dense layers give 0)."""
    dt = dtype_of(cfg.dtype)
    h = constrain(params["embed"][tokens.long()].to(dt), "residual")
    positions = torch.arange(tokens.shape[1], device=h.device)
    auxs = []
    for lp in params["layers"]:
        if cfg.remat:
            # a layer draws nothing at random: no RNG state to replay
            h, aux = checkpoint(_layer, h, lp, cfg, positions, constrain,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            h, aux = _layer(h, lp, cfg, positions, constrain)
        auxs.append(aux)
    h = rmsnorm(h, params["ln_f"], cfg.norm_eps)
    return h, torch.stack(auxs).mean()


def chunked_ce_loss(h: torch.Tensor, unembed: torch.Tensor, targets: torch.Tensor,
                    chunk: int, constrain=_no_constrain) -> torch.Tensor:
    """Cross-entropy without materializing (B, S, V) logits at once: float32
    logits a chunk of positions at a time, the target logit picked by
    mask-and-sum as in the reference."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the CE chunk {chunk}")
    vocab = torch.arange(unembed.shape[-1], device=h.device)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, S, chunk):
        logits = constrain((h[:, lo : lo + chunk] @ unembed).float(), "logits")  # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        tt = targets[:, lo : lo + chunk].long()
        picked = torch.where(vocab == tt[..., None], logits, 0.0).sum(dim=-1)
        tot = tot + (lse - picked).sum()
    return tot / (B * S)


def train_loss(params, cfg: LMConfig, batch, constrain=_no_constrain) -> torch.Tensor:
    """batch = {"tokens": (B, S), "targets": (B, S)} -> scalar loss."""
    h, aux = backbone(params, cfg, batch["tokens"], constrain)
    loss = chunked_ce_loss(h, unembed_matrix(params, cfg), batch["targets"], cfg.ce_chunk,
                           constrain)
    return loss + cfg.aux_loss_coef * aux


def prefill(params, cfg: LMConfig, tokens: torch.Tensor, constrain=_no_constrain):
    """(B, S) -> (last-token logits (B, V) float32, kcache, vcache
    (L, B, S, KV, hd))."""
    dt = dtype_of(cfg.dtype)
    tokens = tokens.long()
    h = constrain(params["embed"][tokens].to(dt), "residual")
    positions = torch.arange(tokens.shape[1], device=h.device)
    ks, vs = [], []
    for lp in params["layers"]:
        h, (k, v) = _attn_block(h, lp, cfg, positions, constrain)
        h, _ = _ffn_block(h, lp, cfg, constrain)
        h = constrain(h, "residual")
        ks.append(constrain(k, "kv_cache"))
        vs.append(constrain(v, "kv_cache"))
    return _logits(params, cfg, h[:, -1, :]), torch.stack(ks), torch.stack(vs)


def _decode(params, cfg: LMConfig, token, pos: int, write_kv, attend, constrain):
    """The layer loop shared by both decode steps: ``write_kv(l, k, v)``
    stores the new entries at ``pos``, ``attend(l, q)`` reads the cache."""
    dt = dtype_of(cfg.dtype)
    B = token.shape[0]
    h = params["embed"][token.long()].to(dt)  # (B, 1, d)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    for l, lp in enumerate(params["layers"]):
        q, k, v = _qkv(rmsnorm(h, lp["ln1"], cfg.norm_eps), lp, cfg, positions)
        write_kv(l, k, v)
        h = h + (attend(l, q).reshape(B, 1, -1) @ lp["wo"])
        h, _ = _ffn_block(h, lp, cfg, constrain)
    return _logits(params, cfg, h[:, 0, :])


def decode_step(params, cfg: LMConfig, token, pos, kcache, vcache, constrain=_no_constrain):
    """One decoding step.

    token:  (B, 1) int — the newest token.
    pos:    int — its position (the cache has ``pos`` valid entries).
    kcache/vcache: (L, B, S_max, KV, hd), written in place at ``pos``.
    Returns (logits (B, V) float32, kcache, vcache).
    """
    pos = int(pos)

    def write_kv(l, k, v):
        kcache[l, :, pos] = k[:, 0].to(kcache.dtype)
        vcache[l, :, pos] = v[:, 0].to(vcache.dtype)

    def attend(l, q):
        kc, vc = constrain(kcache[l], "kv_cache_l"), constrain(vcache[l], "kv_cache_l")
        return decode_attention(q, kc, vc, pos + 1)

    return _decode(params, cfg, token, pos, write_kv, attend, constrain), kcache, vcache


def make_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, *, device=None):
    dt = dtype or dtype_of(cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return torch.zeros(shape, dtype=dt, device=dev), torch.zeros(shape, dtype=dt, device=dev)


# ---------------------------------------------------------------------------
# int8-quantized KV cache (per-(position, kv-head) scales)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor):
    """x (..., hd) -> (int8 values, fp32 scale over the last dim)."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def make_cache_q8(cfg: LMConfig, batch: int, max_len: int, *, device=None):
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)

    def zero():
        return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                "scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev)}

    return zero(), zero()


def quantize_cache(kc: torch.Tensor, vc: torch.Tensor):
    kq, ks = quantize_kv(kc)
    vq, vs = quantize_kv(vc)
    return {"q": kq, "scale": ks}, {"q": vq, "scale": vs}


def decode_step_q8(params, cfg: LMConfig, token, pos, kcache, vcache,
                   constrain=_no_constrain):
    """decode_step with int8 KV caches: cache dicts {"q": int8, "scale": f32}.

    New K/V entries are quantized before insertion; attention dequantizes on
    read (per-position scales).
    """
    pos = int(pos)

    def write_kv(l, k, v):
        for cache, x in ((kcache, k), (vcache, v)):
            xq, xs = quantize_kv(x[:, 0])
            cache["q"][l, :, pos] = xq
            cache["scale"][l, :, pos] = xs

    def attend(l, q):
        kq, vq = constrain(kcache["q"][l], "kv_cache_l"), constrain(vcache["q"][l], "kv_cache_l")
        ks = constrain(kcache["scale"][l], "kv_cache_scale")
        vs = constrain(vcache["scale"][l], "kv_cache_scale")
        return decode_attention_q8(q, kq, ks, vq, vs, pos + 1)

    return _decode(params, cfg, token, pos, write_kv, attend, constrain), kcache, vcache
