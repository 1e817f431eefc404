// Fused streaming counts on Hopper: every length group of a plan set, the
// k-mismatch counter and the stream's seam gate over ONE staged text tile.
//
// Replaces the TPU kernel src/repro/kernels/megascan/megascan.py:_mega_kernel
// (with the per-tile sum of its ops.megascan_count_window).  For one
// streaming window of n bytes, L of them valid, and the seam bound ov:
//
//   out[col_g + p] += #{ starts s of group g's pattern p :
//                        s <= L - m  and  s + m - 1 >= ov  and  it matches }
//
// "It matches" is the group's exact matcher ('a' byte compares, 'b' union
// LUT + anchor words, 'c' strided block fingerprints + pattern-id bitmask)
// or, for 'x', at most k mismatching bytes.  The seam gate s <= L - m keeps
// the zero bytes past L (and past n) from completing a pattern ending in 0.
//
// Bound: counts, not masks, come out, so the bytes are the window read once
// (n / 3.35e12 s on an H100 SXM); the integer work per position (P*m byte
// compares for 'a', a fingerprint and a LUT probe for 'b', one block hash
// per stride for 'c', P first-word compares for 'x', plus verification at
// candidates) is what the kernel spends its time on.
//
// Design: one block of 256 threads per 4096-position tile of the window.
//   * Staging: prev | cur | next tiles (12 KiB + 16 bytes of slack) in
//     shared memory, zero outside [0, n) — the kernels/epsmc halo idiom, so
//     a 'b'/'x' window may run into the next tile (m <= 4093) and a 'c'
//     candidate may start in the previous one (stride + m <= 4096).
//   * Groups: a table of Group records built on the host once per plan set
//     and cached; the kernel loops over it at run time, so one build serves
//     every plan set.
//   * Counts: per-pattern int32 counters in shared memory (warp sums with
//     __reduce_add_sync, then shared atomics), added at the block's end with
//     atomicAdd into the caller's (P_total,) accumulator.  Integer atomics
//     are exact in any order.
//   * Fingerprints: the engine's salted strided-word chain.  Each thread
//     keeps, for its 16 positions, the running sum over the strided words
//     done so far; groups come in increasing m, so every fingerprinted group
//     ('b', and 'x' with the relaxed LUT) extends the chain to its own
//     prefix and adds its overlapping tail word, built once per position.
//   * 'b': LUT bitsets read through the read-only cache; a warp none of
//     whose positions hits skips the group (__any_sync); otherwise each
//     pattern's first anchor word is compared at the 16 positions and the
//     other words only at hits.
//   * 'c': each tile owns the inspected blocks (multiples of stride) that
//     start inside it; a thread hashes a block with the eight int32
//     multiply-adds of fingerprint_weights(8), probes lut_any, reads the
//     block's lut_bits row and verifies each flagged pattern at the offsets
//     j < noff_used (start bg - j >= 0), counting an occurrence once, at
//     its one inspected block with offset < stride.
//   * 'x': mismatches of the m/4 strided words by __vcmpne4 and a popcount,
//     then the tail bytes; a position stops once past k.  With the relaxed
//     LUT only its candidate positions are counted.
#include "common.cuh"

using namespace epsm;

constexpr int BETA = 8;
constexpr int STAGED = 3 * TILE + 16;
constexpr int KIND_A = 0, KIND_B = 1, KIND_C = 2, KIND_X = 3;

struct Weights {
  int32_t w[BETA];
};

// One length group (ops.py builds the same layout with ctypes).
struct Group {
  int kind, m, P, kbits, col, k, use_lut, stride, noff, nw, W, pad;
  const uint8_t* pats;      // (P, m)
  const uint32_t* anchors;  // (P, nw): packed words at _word_offsets(m)
  const uint32_t* lut;      // bitset of 2^kbits bits: lut_any ('b', 'c') or relaxed_lut ('x')
  const uint32_t* bits;     // (2^kbits, W) pattern-id bitmask ('c')
};

__device__ inline uint32_t bit_of(const uint32_t* set, uint32_t h) {
  return (__ldg(set + (h >> 5)) >> (h & 31)) & 1u;
}

// Warp sum of c, added by lane 0 to a shared counter.
__device__ inline void warp_count(int* cnt, int c) {
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(cnt, c);
}

__global__ void __launch_bounds__(THREADS)
    mega_kernel(const uint8_t* __restrict__ text, long long n, long long L, long long ov,
                const Group* __restrict__ groups, int ngroups, int p_total, Weights wts,
                Salts salts, uint32_t fp_mult, int* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* s = reinterpret_cast<uint8_t*>(smem_u4);
  int* cnt = reinterpret_cast<int*>(s + STAGED);
  const long long t0 = (long long)blockIdx.x * TILE;
  if (t0 == 0) {
    for (int v = threadIdx.x; v < TILE / 16; v += blockDim.x)
      reinterpret_cast<uint4*>(s)[v] = make_uint4(0, 0, 0, 0);
    stage(s + TILE, text, 0, n, STAGED - TILE);
  } else {
    stage(s, text, t0 - TILE, n, STAGED);
  }
  for (int p = threadIdx.x; p < p_total; p += blockDim.x) cnt[p] = 0;
  __syncthreads();

  const int loc = TILE + threadIdx.x * PER_THREAD;  // local offset of position pos0
  const long long pos0 = t0 + threadIdx.x * PER_THREAD;
  uint32_t g[PER_THREAD];  // the 4-grams starting at the thread's positions
  {
    const uint4 a = reinterpret_cast<const uint4*>(s + loc)[0];
    const uint32_t nx = reinterpret_cast<const uint32_t*>(s + loc)[4];
    const uint32_t wd[5] = {a.x, a.y, a.z, a.w, nx};
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q)
      g[q] = __funnelshift_r(wd[q >> 2], wd[(q >> 2) + 1], 8 * (q & 3));
  }
  uint32_t v[PER_THREAD];  // fingerprint chain: sum over strided words i < done
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) v[q] = 0;
  int done = 0;

  for (int gi = 0; gi < ngroups; ++gi) {
    const Group G = groups[gi];
    const int m = G.m;
    if (G.kind == KIND_C) {
      const long long stride = G.stride;
      const long long first = (t0 + stride - 1) / stride;
      const long long stop = (t0 + TILE + stride - 1) / stride;  // blocks with bg < t0 + TILE
      const uint32_t hmask = (1u << G.kbits) - 1u;
      for (long long bi = first + threadIdx.x; bi < stop; bi += blockDim.x) {
        const long long bg = bi * stride;
        const int lb = (int)(bg - t0) + TILE;
        uint32_t h = 0;
#pragma unroll
        for (int q = 0; q < BETA; ++q) h += (uint32_t)s[lb + q] * (uint32_t)wts.w[q];
        h &= hmask;
        if (!bit_of(G.lut, h)) continue;
        const uint32_t* row = G.bits + (size_t)h * G.W;
        for (int wi = 0; wi < G.W; ++wi) {
          for (uint32_t word = __ldg(row + wi); word; word &= word - 1) {
            const int p = 32 * wi + __ffs(word) - 1;
            const uint8_t* pp = G.pats + (size_t)p * m;
            int c = 0;
            for (int j = 0; j < G.noff; ++j) {
              const long long st = bg - j;
              if (st < 0 || st > L - m || st + m - 1 < ov) continue;
              const int ls = lb - j;
              int q = 0;
              while (q < m && s[ls + q] == __ldg(pp + q)) ++q;
              c += q == m;
            }
            if (c) atomicAdd(&cnt[G.col + p], c);
          }
        }
      }
      continue;
    }
    unsigned valid = 0;
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const long long pos = pos0 + q;
      valid |= (unsigned)(pos <= L - m && pos + m - 1 >= ov) << q;
    }
    if (G.kind == KIND_A) {
      const uint32_t mask = (1u << (8 * m)) - 1u;  // m < 4
      for (int p = 0; p < G.P; ++p) {
        uint32_t pw = 0;
        for (int j = 0; j < m; ++j) pw |= (uint32_t)__ldg(G.pats + (size_t)p * m + j) << (8 * j);
        int c = 0;
#pragma unroll
        for (int q = 0; q < PER_THREAD; ++q) c += ((valid >> q) & 1u) && (g[q] & mask) == pw;
        warp_count(&cnt[G.col + p], c);
      }
      continue;
    }
    // 'b' and 'x': candidate positions, through the LUT when there is one
    unsigned cand = valid;
    if (G.kind == KIND_B || G.use_lut) {
      const int ns = m / 4;
      if (ns < done) {  // groups out of m order: restart the chain
#pragma unroll
        for (int q = 0; q < PER_THREAD; ++q) v[q] = 0;
        done = 0;
      }
      for (; done < ns; ++done) {
#pragma unroll
        for (int q = 0; q < PER_THREAD; ++q) v[q] += gram(s, loc + q + 4 * done) * salts.s[done];
      }
      cand = 0;
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q) {
        if ((valid >> q) & 1u) {
          uint32_t x = v[q];
          if (m % 4) x += gram(s, loc + q + m - 4) * salts.s[ns];
          const uint32_t h = (x * fp_mult) >> (32 - G.kbits);
          cand |= bit_of(G.lut, h) << q;
        }
      }
    }
    if (!__any_sync(0xffffffffu, cand != 0)) continue;
    if (G.kind == KIND_B) {
      for (int p = 0; p < G.P; ++p) {
        const uint32_t* ap = G.anchors + (size_t)p * G.nw;
        const uint32_t a0 = __ldg(ap);
        unsigned hit = 0;
#pragma unroll
        for (int q = 0; q < PER_THREAD; ++q) hit |= (unsigned)(g[q] == a0) << q;
        hit &= cand;
        int c = 0;
        for (unsigned todo = hit; todo; todo &= todo - 1) {
          const int q = __ffs(todo) - 1;
          int i = 1;
          while (i < G.nw && gram(s, loc + q + word_offset(i, m)) == __ldg(ap + i)) ++i;
          c += i == G.nw;
        }
        warp_count(&cnt[G.col + p], c);
      }
    } else if (G.kind == KIND_X) {
      const int k = G.k;
      for (int p = 0; p < G.P; ++p) {
        const uint8_t* pp = G.pats + (size_t)p * m;
        const uint32_t* ap = G.anchors + (size_t)p * G.nw;
        const uint32_t a0 = m >= 4 ? __ldg(ap) : (uint32_t)__ldg(pp);
        unsigned alive = 0;
#pragma unroll
        for (int q = 0; q < PER_THREAD; ++q)
          alive |= (unsigned)(first_mismatches(g[q], a0, m) <= k) << q;
        alive &= cand;
        int c = 0;
        for (unsigned todo = alive; todo; todo &= todo - 1) {
          const int q = __ffs(todo) - 1;
          c += mismatches(
                   g[q], a0, m, k, ap, pp, [&](int j) { return gram(s, loc + q + j); },
                   [&](int j) { return s[loc + q + j]; }) <= k;
        }
        warp_count(&cnt[G.col + p], c);
      }
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < p_total; p += blockDim.x)
    if (cnt[p]) atomicAdd(out + p, cnt[p]);
}

// Launch on `stream`, adding one window's counts into out[0, p_total);
// returns cudaGetLastError() (0 on success).  text: n window bytes, L of
// them valid; groups: ngroups records in device memory.  Requires n >= 1,
// 0 <= L <= n and the ops.py eligibility rules (m <= 4093, 'c': stride + m
// <= 4096, shared memory within the card's 227 KB).
extern "C" int megascan_launch(const uint8_t* text, long long n, long long L, long long ov,
                               const void* groups, int ngroups, int p_total, Weights wts,
                               Salts salts, uint32_t fp_mult, int* out, void* stream) {
  const long long grid = grid_for(n);
  if (n < 1 || L < 0 || L > n || ngroups < 1 || p_total < 1 || grid < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = STAGED + 4 * (size_t)p_total;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mega_kernel<<<(unsigned)grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      text, n, L, ov, static_cast<const Group*>(groups), ngroups, p_total, wts, salts, fp_mult,
      out);
  return (int)cudaGetLastError();
}
