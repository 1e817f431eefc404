"""Parity of repro_torch.core.packing with repro.core.packing, elementwise.

Packed words and fingerprints are int32 in the port and uint32 in the
reference; they are compared through ``.view(np.uint32)``.  No tolerance:
every output is an exact integer.
"""

import numpy as np
import pytest
import torch

from repro.core import packing as ref
from repro_torch.core import packing as port

SIZES = [0, 1, 5, 257]


def _bytes(n, seed):
    # all 256 byte values, including >= 0x80, whose packed words set the sign bit
    return np.random.RandomState(seed).randint(0, 256, size=n).astype(np.uint8)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


def test_constants_equal_reference():
    assert port.PACK == ref.PACK
    assert port.FP_MULT == ref.FP_MULT and port.FP_MULT.dtype == np.uint32
    np.testing.assert_array_equal(port.WORD_SALTS, ref.WORD_SALTS)
    assert port.WORD_SALTS.dtype == np.uint32
    for beta in (4, 8):
        np.testing.assert_array_equal(
            port.fingerprint_weights(beta).numpy(), np.asarray(ref.fingerprint_weights(beta))
        )
        assert port.fingerprint_weights(beta).dtype == torch.int32


@pytest.mark.parametrize(
    "x",
    [b"\x00\x7f\x80\xff", "héllo \udcff", bytearray(b"ab"), np.array([1, 300, -1]),
     torch.tensor([250, 5], dtype=torch.int64)],
    ids=["bytes", "str-surrogate", "bytearray", "ndarray-int", "tensor-int64"],
)
def test_as_u8(x):
    x_ref = x.numpy() if isinstance(x, torch.Tensor) else x
    got = port.as_u8(x, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.as_u8(x_ref)))
    np.testing.assert_array_equal(port.as_u8_np(x), ref.as_u8_np(x_ref))


def test_as_u8_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.as_u8(b"abc")
    t = torch.tensor([1, 2], dtype=torch.uint8)
    assert port.as_u8(t) is t  # a tensor stays where it is


@pytest.mark.parametrize("n", SIZES)
def test_pack_and_shift(n):
    t = _bytes(n, n)
    tt = torch.from_numpy(t)
    np.testing.assert_array_equal(_u32(port.pack_u32(tt)), np.asarray(ref.pack_u32(t)))
    for j in (0, 1, 3, n, n + 2):
        np.testing.assert_array_equal(port.shift_left(tt, j).numpy(), np.asarray(ref.shift_left(t, j)))
    for m in (1, 4, n, n + 1):
        np.testing.assert_array_equal(
            port.valid_start_mask(n, m).numpy(), np.asarray(ref.valid_start_mask(n, m))
        )


def test_pack_word_and_zero_bytes():
    rng = np.random.RandomState(1)
    for four in ([0, 0, 0, 0], [255, 255, 255, 255], [0x80, 0, 0x7F, 0xFF], rng.randint(0, 256, 4)):
        four = np.asarray(four, dtype=np.uint8)
        got = port.pack_word_u32(torch.from_numpy(four))
        assert int(got.numpy().astype(np.int32).view(np.uint32)) == int(ref.pack_word_u32(four))
    words = np.concatenate(
        [rng.randint(0, 2**32, size=200, dtype=np.uint64).astype(np.uint32),
         np.array([0, 0xFF, 0xFF00FF00, 0xFFFFFFFF, 0x80000000], dtype=np.uint32)]
    )
    got = port.count_zero_bytes_u32(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.count_zero_bytes_u32(words)))


@pytest.mark.parametrize("kbits", [11, 17, 20])
def test_fingerprint_accumulate_and_finalize(kbits):
    rng = np.random.RandomState(kbits)
    # sums near and past 2^32 wrap the same way in both
    v = rng.randint(0, 2**32, size=300, dtype=np.uint64).astype(np.uint32)
    v[:3] = [0, 0xFFFFFFFF, 0x80000000]
    words = rng.randint(0, 2**32, size=300, dtype=np.uint64).astype(np.uint32)
    pv, pw = torch.from_numpy(v.view(np.int32)), torch.from_numpy(words.view(np.int32))
    for salt in range(len(ref.WORD_SALTS)):
        got = port.fp_accum_word(pv, pw, salt)
        np.testing.assert_array_equal(_u32(got), np.asarray(ref.fp_accum_word(v, words, salt)))
    got = port.fp_finalize(pv, kbits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.fp_finalize(v, kbits)))


@pytest.mark.parametrize("kbits", [11, 17])
def test_hash_blocks(kbits):
    blocks = _bytes(8 * 500, 7).reshape(500, 8)
    blocks[0] = 255  # the largest products wrap past 2^31
    w_ref = ref.fingerprint_weights(8)
    got = port.hash_blocks(torch.from_numpy(blocks), port.fingerprint_weights(8), kbits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.hash_blocks(blocks, w_ref, kbits)))


def test_engine_constants_equal_reference():
    from repro.core import engine as ref_engine
    from repro_torch.core import engine as port_engine

    for name in ("ENGINE_KBITS", "DICT_BUCKET_MIN_P", "DICT_BBITS_MAX", "DICT_SLOTS_PER_PATTERN",
                 "SLOT_VERIFY_CAP", "AUTOMATON_MIN_P", "DENSE_ROUTE_RHO", "CAND_BLOCK",
                 "SPARSE_B_MIN_ELEMS"):
        assert getattr(port_engine, name) == getattr(ref_engine, name), name
