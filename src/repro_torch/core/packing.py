"""Byte-packing utilities for packed string matching, in PyTorch.

The PyTorch twin of ``repro.core.packing``.  Four consecutive text bytes are
packed into one 32-bit lane so that a single compare tests a 4-gram (the
analogue of SSE's ``_mm_mpsadbw_epu8`` anchor used by EPSMb), and 8-byte
blocks are fingerprinted by a multiplicative hash (EPSMc).

Dtype rule: the reference carries packed words and fingerprints as uint32.
PyTorch's uint32 has no ``+``, ``<<`` or ``>>`` on the CPU, so this module
carries the same 32 bits in int32, where add and multiply wrap mod 2^32.
``t.numpy().view(np.uint32)`` recovers the reference's values.  Logical right
shifts are written ``(v >> s) & ((1 << (32 - s)) - 1)``.

Device rule: a host input (bytes, str, numpy) goes to the card unless the
caller asks for ``device="cpu"``; a tensor stays where it is.  With no card
and no explicit device the call raises instead of running on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

# Number of bytes packed into one 32-bit lane (the paper's 4-byte anchor).
PACK = 4


def _i32(x: int) -> int:
    """The signed int32 value with the same 32 bits as ``x``."""
    return ((int(x) + 2**31) % 2**32) - 2**31


def resolve_device(device=None) -> torch.device:
    """The device a host input goes to: ``device`` if given, else the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def as_u8_np(x) -> np.ndarray:
    """Coerce bytes / str / ndarray / tensor to a host numpy uint8 array."""
    if isinstance(x, str):
        x = x.encode("utf-8", errors="surrogateescape")
    if isinstance(x, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(x), dtype=np.uint8)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    return arr if arr.dtype == np.uint8 else arr.astype(np.uint8)


def as_u8(x, device=None) -> torch.Tensor:
    """Coerce bytes / str / ndarray / tensor to a contiguous uint8 tensor.

    A tensor stays on its device unless ``device`` is given; any other input
    goes to ``resolve_device(device)``.
    """
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(torch.device(device))
    else:
        t = torch.from_numpy(as_u8_np(x).copy()).to(resolve_device(device))
    if t.dtype != torch.uint8:
        t = t.to(torch.uint8)
    return t.contiguous()


def shift_left(x: torch.Tensor, j: int) -> torch.Tensor:
    """Return y with y[..., i] = x[..., i + j] (zero padded at the tail)."""
    if j == 0:
        return x
    y = torch.zeros_like(x)
    n = x.shape[-1]
    if j < n:
        y[..., : n - j] = x[..., j:]
    return y


def pack_u32(text_u8: torch.Tensor) -> torch.Tensor:
    """w[i] = t[i] | t[i+1]<<8 | t[i+2]<<16 | t[i+3]<<24, as int32 bits."""
    t = text_u8.to(torch.int32)
    w = t
    for j in range(1, PACK):
        w = w | (shift_left(t, j) << (8 * j))
    return w


def count_zero_bytes_u32(x: torch.Tensor) -> torch.Tensor:
    """Number of zero bytes (0..4) in each 32-bit lane, as int32."""
    x = x.to(torch.int32)
    acc = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for s in (0, 8, 16, 24):
        acc = acc + (((x >> s) & 0xFF) == 0).to(torch.int32)
    return acc


def pack_word_u32(four_bytes: torch.Tensor) -> torch.Tensor:
    """Pack exactly 4 uint8 values into a 0-d int32 (little endian)."""
    b = four_bytes.to(torch.int32)
    return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)


def valid_start_mask(n: int, m: int, device=None) -> torch.Tensor:
    """Boolean mask of positions where a length-m occurrence can start."""
    return torch.arange(n, device=device) <= (n - m)


FP_MULT = np.uint32(2654435761)  # Knuth's multiplicative-hash constant
# fixed odd salts mixing the packed words of one window into one fingerprint
WORD_SALTS = np.uint32(
    np.random.RandomState(0xE95).randint(1, 2**30, size=8) * 2 + 1
)


def fp_accum_word(v: torch.Tensor, word: torch.Tensor, salt_index: int) -> torch.Tensor:
    """Add one salted packed-word term to a running window-fingerprint sum."""
    return v + word * _i32(WORD_SALTS[salt_index])


def fp_finalize(v: torch.Tensor, kbits: int) -> torch.Tensor:
    """Final multiplicative mix + top-bits truncation of a salted sum."""
    return ((v * _i32(FP_MULT)) >> (32 - kbits)) & ((1 << kbits) - 1)


def fingerprint_weights(beta: int, seed: int = 12345, device="cpu") -> torch.Tensor:
    """Fixed pseudo-random odd int32 weights for the multiplicative block hash.

    The paper fingerprints 8-byte blocks with crc32; here h(block) =
    (block . r) mod 2^32 masked to k bits, with fixed odd weights r.
    """
    rng = np.random.RandomState(seed)
    w = rng.randint(1, 2**31 - 1, size=(beta,)).astype(np.int64) * 2 + 1
    return torch.from_numpy((w & 0x7FFFFFFF).astype(np.int32)).to(device)


def hash_blocks(blocks_u8: torch.Tensor, weights: torch.Tensor, kbits: int) -> torch.Tensor:
    """k-bit fingerprints of (..., beta) uint8 blocks.

    Written as beta explicit int32 multiply-adds, which wrap mod 2^32 like the
    reference's int32 dot (the card has no int32 matmul).
    """
    w = weights.to(device=blocks_u8.device, dtype=torch.int32)
    h = torch.zeros(blocks_u8.shape[:-1], dtype=torch.int32, device=blocks_u8.device)
    for k in range(blocks_u8.shape[-1]):
        h = h + blocks_u8[..., k].to(torch.int32) * w[k]
    return h & ((1 << kbits) - 1)
