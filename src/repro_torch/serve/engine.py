"""Batched serving engine, in PyTorch: prefill + KV-cache decode with EPSM
stop-string scanning on the generated byte streams (the paper's technique in
the serving data plane).

The port's copy of ``repro.serve.engine``.  Stop scanning is batched on the
device: the engine keeps a device-side (B, 2W - 1) tail ring of generated
bytes and runs exactly one stop scan per decode step, whatever the batch
size and the number of stop strings.  The scan slides a (B, W) window
(W = longest stop string) over the ring, builds a TextIndex over it, and
reads every stop-string PatternPlan's match mask at the single position
where a match can newly END at this step's byte.  On the card the scan's
4-15-byte stops run the multipattern kernel (the engine's full-mask EPSMb
route) and fuzzy stops (``stop_k > 0``) the approx kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import engine as match_engine
from repro_torch.core.packing import resolve_device
from repro_torch.data.pipeline import BOS
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_map
from repro_torch.obs.recorder import NULL as _NULL_REC


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (new_len,) generated token ids (bytes)
    text: bytes
    stopped_by: Optional[bytes] = None


def _stop_scan_step(buf: torch.Tensor, step: int, tokens, plans, *, window: int):
    """Append this step's byte to the tail ring and scan the (B, W) window.

    The ring is (B, 2W - 1): W - 1 bytes of left context plus W live write
    slots, so memory is O(W), independent of max_new.  The write position
    cycles through the live slots; at each wrap-around (step % W == 0,
    step > 0) the last W - 1 bytes slide into the context region, keeping
    the scan window contiguous.  The ring is updated in place.

    Returns (buf, hits bool (B, P), any_hit bool 0-d tensor): hits[b, p]
    iff stop p (plan order) newly matches ENDING at the byte appended this
    step.  Plans compiled with a mismatch budget (k > 0) hit on <= k
    mismatch occurrences, through match_many's per-plan default."""
    W = window
    byte = (torch.as_tensor(tokens, device=buf.device).to(torch.int64) & 0xFF).to(torch.uint8)
    phase = step % W
    if phase == 0 and step > 0:
        buf[:, : W - 1] = buf[:, W:]  # disjoint slices: no copy needed
    buf[:, W - 1 + phase] = byte
    tail = buf[:, phase : phase + W]
    # valid bytes in the window: the generated suffix only (stops never
    # match into the zero-initialized left apron)
    gen_len = min(step + 1, W)
    mask = match_engine.match_many(match_engine.build_index(tail), plans)  # (B, P, W)
    cols = []
    row = 0
    for plan in plans:
        m, P = plan.m, plan.n_patterns
        # a length-m stop newly matches iff it starts at W - m (so it ends
        # exactly at the newest byte) and m bytes have been generated
        col = mask[:, row : row + P, W - m]
        cols.append(col if gen_len >= m else torch.zeros_like(col))
        row += P
    hits = torch.cat(cols, dim=1)
    return buf, hits, hits.any()


class StopScanner:
    """Device-side tail ring + one batched stop scan per step.

    Feed one byte per stream per step and get back a (B, n_stops) bool
    matrix of stops that newly complete at this step.  ``dispatch_count``
    counts scans: exactly one per step regardless of B or the number of
    stop strings.

    ``k`` enables fuzzy stop tolerance: a stop fires when it occurs in the
    generated stream within <= k byte mismatches.  k=0 is exact.

    ``recorder`` traces each step's scan as a fenced ``stop_scan`` span plus
    a ``stop_scan_dispatches`` counter.  The ring and the plans live on
    ``device`` (default: the card).
    """

    def __init__(
        self, stop_strings: Sequence[bytes], batch: int, max_new: int,
        k: int = 0, recorder=None, *, device=None,
    ):
        self.device = resolve_device(device)
        self.stops = [bytes(s) for s in stop_strings]
        if any(len(s) == 0 for s in self.stops):
            raise ValueError("empty stop string")
        self.rec = _NULL_REC if recorder is None else recorder
        self.batch = batch
        self.max_new = max_new
        self.k = int(k)
        self.window = max((len(s) for s in self.stops), default=0)
        self.dispatch_count = 0
        if not self.stops:
            return
        self.plans = match_engine.compile_patterns(self.stops, k=self.k, device=self.device)
        self.order = match_engine.plan_order(self.plans)
        self.buf = torch.zeros((batch, 2 * self.window - 1), dtype=torch.uint8, device=self.device)

    def scan(self, tokens, step: int) -> np.ndarray:
        """One scan: returns bool (B, n_stops) in ORIGINAL stop order;
        ``tokens`` is this step's sampled token ids (B,).

        The hit matrix stays on the device unless a hit is possible: the
        scan also returns a fused ``any`` scalar, and only when that
        one-element sync says True is the matrix copied to the host."""
        if not self.stops:
            return np.zeros((self.batch, 0), bool)
        with self.rec.span("stop_scan", step=step, batch=self.batch) as sp:
            self.buf, hits, any_hit = _stop_scan_step(
                self.buf, step, tokens, self.plans, window=self.window
            )
            sp.fence(any_hit)
        self.dispatch_count += 1
        self.rec.count("stop_scan_dispatches")
        out = np.zeros((self.batch, len(self.stops)), bool)
        if bool(any_hit):
            out[:, self.order] = hits.cpu().numpy()
        return out


class ServeEngine:
    """Greedy / temperature sampling over a byte-level LM on ``device``
    (default: the card); the parameters are moved there."""

    def __init__(self, params, cfg: tf.LMConfig, max_len: int = 512, *, device=None):
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.cfg = cfg
        self.max_len = max_len

    def _sample(self, logits: torch.Tensor, temperature: float, gen: torch.Generator):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def generate(
        self,
        prompts: Sequence[bytes],
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        stop_strings: Sequence[bytes] = (),
        seed: int = 0,
        stop_k: int = 0,
        recorder=None,
    ) -> List[GenerationResult]:
        """Greedy decoding (temperature 0) is the reference's; sampled
        decoding draws from a ``torch.Generator`` seeded with ``seed``, so it
        repeats by seed but not the reference's ``jax.random`` stream.  With
        a ``recorder``, prefill and each decode step are fenced ``prefill``
        / ``decode`` spans beside the scanner's ``stop_scan`` spans."""
        if len({len(p) for p in prompts}) != 1:
            raise ValueError("batched prompts must share a length (pad upstream)")
        rec = _NULL_REC if recorder is None else recorder
        dev, cfg = self.device, self.cfg
        B = len(prompts)
        prompt_tok = np.stack(
            [np.concatenate([[BOS], np.frombuffer(p, np.uint8)]) for p in prompts]
        ).astype(np.int64)
        S0 = prompt_tok.shape[1]
        if S0 + max_new_tokens > self.max_len:
            raise ValueError(f"prompt + max_new_tokens exceeds max_len {self.max_len}")

        with rec.span("prefill", batch=B, seq=S0) as sp:
            logits, kc, vc = tf.prefill(self.params, cfg, torch.from_numpy(prompt_tok).to(dev))
            sp.fence(logits)
        kc_full, vc_full = tf.make_cache(cfg, B, self.max_len, device=dev)
        kc_full[:, :, :S0] = kc.to(kc_full.dtype)
        vc_full[:, :, :S0] = vc.to(vc_full.dtype)

        gen = torch.Generator(device=dev).manual_seed(seed)
        generated = [bytearray() for _ in range(B)]
        stopped: List[Optional[bytes]] = [None] * B
        done = np.zeros(B, bool)
        cur = logits
        scanner = StopScanner(
            stop_strings, B, max_new_tokens, k=stop_k, recorder=recorder, device=dev
        )

        for step in range(max_new_tokens):
            nxt = self._sample(cur, temperature, gen)  # (B,)
            nxt_np = nxt.cpu().numpy()
            # one batched stop scan for ALL streams and ALL stops
            hits = scanner.scan(nxt, step)
            for b in range(B):
                if done[b]:
                    continue
                tok = int(nxt_np[b])
                if tok < 256:
                    generated[b].append(tok)
                    for si in np.nonzero(hits[b])[0]:
                        done[b] = True
                        stopped[b] = scanner.stops[si]
                        break
                if tok == BOS:
                    done[b] = True
            if done.all():
                break
            with rec.span("decode", step=step, batch=B) as sp:
                cur, kc_full, vc_full = tf.decode_step(
                    self.params, cfg, nxt[:, None], S0 + step, kc_full, vc_full
                )
                sp.fence(cur)

        return [
            GenerationResult(
                tokens=np.frombuffer(bytes(g), np.uint8),
                text=bytes(g),
                stopped_by=s,
            )
            for g, s in zip(generated, stopped)
        ]
