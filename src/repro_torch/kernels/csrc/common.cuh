// Shared pieces of the kernels: tile staging, windowed byte reads with a
// global-memory fallback, packed 4-byte reads, 16-byte mask stores, the
// fingerprint salts and the k-mismatch count.
//
// Layout shared by the three kernels: one block of THREADS threads owns a
// tile of TILE consecutive start positions [base, base + TILE).  It stages
// the tile plus a right halo of min(m - 1, HALO_MAX) bytes (rounded up to 16)
// and 16 bytes of slack into shared memory with 16-byte loads, zero-filled
// past n.  Bytes further right (patterns longer than HALO_MAX + 1) are read
// from global memory.  Sizes and offsets into the text are 64-bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace epsm {

constexpr int TILE = 4096;
constexpr int THREADS = 256;
constexpr int PER_THREAD = TILE / THREADS;  // 16 positions, one 16-byte store
constexpr long long HALO_MAX = 8192;

static_assert(PER_THREAD == 16, "one thread covers one 16-byte store");

__host__ __device__ inline long long round16(long long x) { return (x + 15) / 16 * 16; }

// Bytes of text staged in shared memory for a pattern of length m.
__host__ __device__ inline int staged_bytes(long long m) {
  long long h = m - 1 < HALO_MAX ? m - 1 : HALO_MAX;
  return (int)(TILE + round16(h) + 16);
}

// Bytes of pattern staged in shared memory (zero-filled past m).
__host__ __device__ inline int pattern_bytes(long long m) {
  return (int)(round16(m < HALO_MAX ? m : HALO_MAX) + 16);
}

// Copy src[base, base + count) into dst (count a multiple of 16), zero past n.
__device__ inline void stage(uint8_t* dst, const uint8_t* __restrict__ src,
                             long long base, long long n, int count) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) + base) & 15) == 0;
  for (int v = threadIdx.x; v < count / 16; v += blockDim.x) {
    const long long g = base + 16LL * v;
    uint4 val;
    if (aligned && g + 16 <= n) {
      val = __ldg(reinterpret_cast<const uint4*>(src + g));
    } else {
      uint32_t q[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (g + k < n) q[k >> 2] |= (uint32_t)src[g + k] << (8 * (k & 3));
      val = make_uint4(q[0], q[1], q[2], q[3]);
    }
    reinterpret_cast<uint4*>(dst)[v] = val;
  }
}

// The text seen from one tile: byte `local` is text[base + local], 0 past n.
struct Window {
  const uint8_t* s;             // shared: staged bytes
  int staged;                   // how many bytes s holds
  const uint8_t* g;             // global text
  long long base, n;

  __device__ uint8_t at(long long local) const {
    if (local < staged) return s[local];
    const long long i = base + local;
    return i < n ? __ldg(g + i) : 0;
  }
  // Little-endian 4-gram starting at `local`, from two aligned shared words.
  __device__ uint32_t gram4(long long local) const {
    if (local + 8 <= staged) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(s) + (local >> 2);
      return __funnelshift_r(w[0], w[1], 8 * (unsigned)(local & 3));
    }
    return at(local) | (at(local + 1) << 8) | (at(local + 2) << 16) |
           ((uint32_t)at(local + 3) << 24);
  }
};

// The pattern: its first `staged` bytes in shared memory, the rest global.
struct Pattern {
  const uint8_t* s;
  int staged;
  const uint8_t* g;
  long long m;

  __device__ uint8_t at(long long j) const { return j < staged ? s[j] : __ldg(g + j); }
  // Packed word of bytes j..j+3; j is a multiple of 4 and j + 4 <= m.
  __device__ uint32_t word(long long j) const {
    if (j + 4 <= staged) return reinterpret_cast<const uint32_t*>(s)[j >> 2];
    return at(j) | (at(j + 1) << 8) | (at(j + 2) << 16) | ((uint32_t)at(j + 3) << 24);
  }
};

__device__ inline void stage_pattern(uint8_t* dst, const uint8_t* __restrict__ pat,
                                     long long m, int count) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) dst[j] = j < m ? pat[j] : 0;
}

// True iff text[base + local + j] == pat[j] for every j in [j0, m):
// packed 4-byte steps, then a byte tail.
__device__ inline bool verify_from(const Window& w, const Pattern& p, long long local,
                                   long long j0) {
  long long j = j0;
  for (; j + 4 <= p.m; j += 4)
    if (w.gram4(local + j) != p.word(j)) return false;
  for (; j < p.m; ++j)
    if (w.at(local + j) != p.at(j)) return false;
  return true;
}

// Store the 16 mask bytes of positions pos0..pos0+15 (each 0 or 1, packed
// little-endian in r[0..3]); only positions below n are written.
__device__ inline void store16(uint8_t* __restrict__ out, long long pos0, long long n,
                               const uint32_t r[4]) {
  if (pos0 + 16 <= n && ((reinterpret_cast<uintptr_t>(out) + pos0) & 15) == 0) {
    *reinterpret_cast<uint4*>(out + pos0) = make_uint4(r[0], r[1], r[2], r[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (pos0 + k < n) out[pos0 + k] = (uint8_t)(r[k >> 2] >> (8 * (k & 3)));
}

// Clear the mask bytes of positions past `last` (the last valid start).
__device__ inline void clear_past(uint32_t r[4], long long pos0, long long last) {
  if (pos0 + 15 <= last) return;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (pos0 + k > last) r[k >> 2] &= ~(0xFFu << (8 * (k & 3)));
}

// The engine's fingerprint salts, one per anchor word (packing.WORD_SALTS).
constexpr int MAX_SALTS = 8;

struct Salts {
  uint32_t s[MAX_SALTS];
};

// Little-endian 4-gram at shared offset `local` (local + 8 <= staged bytes).
__device__ inline uint32_t gram(const uint8_t* s, int local) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(s) + (local >> 2);
  return __funnelshift_r(w[0], w[1], 8 * (unsigned)(local & 3));
}

// The i-th offset of _word_offsets(m): 4i for the m/4 strided words, then
// m - 4 for the overlapping tail word when m % 4 != 0.
__device__ inline int word_offset(int i, int m) { return i < m / 4 ? 4 * i : m - 4; }

// Number of differing bytes of two packed words: __vcmpne4 sets 0xFF in each
// byte lane that differs, 8 bits a byte.
__device__ inline int mism4(uint32_t a, uint32_t b) { return __popc(__vcmpne4(a, b)) >> 3; }

// Mismatches of the window whose first 4-gram is g against the first packed
// word a0 of a pattern (its first byte when m < 4).
__device__ inline int first_mismatches(uint32_t g, uint32_t a0, int m) {
  return m >= 4 ? mism4(g, a0) : (int)((g & 0xFFu) != a0);
}

// Hamming distance of an m-byte window to a pattern, stopped once past k:
// first_mismatches, then the other m/4 - 1 strided words (ap: the packed
// anchor words; the overlapping tail word would double-count), then the
// m % 4 tail bytes (pp: the pattern's bytes).  gram4(j) and byte(j) read the
// window at offset j.
template <class Gram4, class Byte>
__device__ inline int mismatches(uint32_t g, uint32_t a0, int m, int k,
                                 const uint32_t* __restrict__ ap, const uint8_t* __restrict__ pp,
                                 Gram4 gram4, Byte byte) {
  const int nsw = m / 4;
  int mm = first_mismatches(g, a0, m);
  for (int i = 1; i < nsw && mm <= k; ++i) mm += mism4(gram4(4 * i), __ldg(ap + i));
  for (int j = nsw ? 4 * nsw : 1; j < m && mm <= k; ++j) mm += byte(j) != __ldg(pp + j);
  return mm;
}

// Number of TILE-position blocks covering n, or -1 if it exceeds the grid.
inline long long grid_for(long long n) {
  const long long blocks = (n + TILE - 1) / TILE;
  return blocks > 0x7FFFFFFFLL ? -1 : blocks;
}

}  // namespace epsm

extern "C" const char* epsm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
