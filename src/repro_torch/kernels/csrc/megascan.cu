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
// "It matches" is the group's exact matcher ('a' one probe of a private
// gram table, 'b' union LUT + one pattern-id lookup + anchor words, 'c'
// strided block fingerprints + pattern-id bitmask) or, for 'x', at most k
// mismatching bytes.  The seam gate s <= L - m keeps the zero bytes past L
// (and past n) from completing a pattern ending in 0.
//
// Bound: counts, not masks, come out, so the bytes are the window read once
// and the counts written once ((n + 4 P) / 3.35e12 s on an H100 SXM).  The
// integer work that any implementation does is a fixed cost per position
// for each group (form the packed word, hash it, probe one table, test; a
// block hash per stride for 'c'; k + 1 word tests for 'x') plus ceil(m/4)
// word compares per counted occurrence.  None of it grows with the number
// of patterns P; the design keeps it that way for 'a', 'b' and 'c'.
//
// Design: one block of 512 threads per 4096-position tile of the window.
//   * Staging: the tile plus the halo the plan set needs, in shared memory,
//     zero outside [0, n): back = the largest 'c' stride - 1 (a candidate
//     may start before its inspected block), forward = the largest m - 1 + 3
//     (the last packed word of a window), each rounded up to 16 bytes, plus
//     16 bytes of slack.  The caller computes both (ops.build_mega_spec).
//   * Groups: a table of Group records built on the host once per plan set
//     and cached; the kernel loops over it at run time, so one build serves
//     every plan set.
//   * Counts: per-pattern int32 counters in shared memory, added at the
//     block's end with atomicAdd into the caller's (P_total,) accumulator.
//     Hits of 'a' and 'b' groups are sparse and scattered over patterns:
//     lanes of a warp holding the same pattern id are merged with
//     __match_any_sync into one shared atomic (warp_add).  Integer atomics
//     are exact in any order.
//   * Fingerprints: the engine's salted strided-word chain.  Each thread
//     keeps, for its 8 positions, the running sum over the strided words
//     done so far; groups come in increasing m, so every fingerprinted group
//     ('b', and 'x' with the relaxed LUT) extends the chain to its own
//     prefix and adds its overlapping tail word, built once per position.
//   * Probes: a thread probes a group's table at its 8 positions before it
//     looks at any result, so the 8 loads are in flight together.
//   * 'a' (m < 4): a private table built once per plan maps the masked
//     gram, hashed by the FP_MULT multiply-shift to 2^abits rows, to a
//     W-word pattern-id bitmask (W = ceil(P/32)), read through the read-only
//     cache (at most 8 KB, so it stays in L1).  One probe a position, then
//     one masked compare per pattern it flags.
//   * 'b': LUT bitsets read through the read-only cache; a warp none of
//     whose positions hits skips the group.  A hit reads its one candidate
//     from the plan's lut_pid when the plan's fingerprints are distinct,
//     else a private (2^kbits, W) pattern-id bitmask built once per plan,
//     and compares only those patterns' anchor words.
//   * 'c': each tile owns the inspected blocks (multiples of stride) that
//     start inside it; a thread hashes a block with the eight int32
//     multiply-adds of fingerprint_weights(8), probes lut_any, reads the
//     block's lut_bits row and verifies each flagged pattern at the offsets
//     j < noff_used (start bg - j >= 0), counting an occurrence once, at
//     its one inspected block with offset < stride.
//   * 'x': mismatches of the m/4 strided words by __vcmpne4 and a popcount,
//     then the tail bytes; a position stops once past k.  With the relaxed
//     LUT only its candidate positions are counted.  This loop still runs
//     over all P patterns.
#include "common.cuh"

using namespace epsm;

constexpr int BETA = 8;
constexpr int KIND_A = 0, KIND_B = 1, KIND_C = 2, KIND_X = 3;
constexpr unsigned FULL = 0xffffffffu;
// A block: 512 threads of 8 positions each over the 4096-position tile, two
// blocks an SM (64 registers a thread at most): load latency, not the
// instruction rate, limits the probes, so the design keeps warps in flight
// rather than positions.
constexpr int MEGA_THREADS = 512;
constexpr int PER = TILE / MEGA_THREADS;
static_assert(PER == 8, "a thread covers 8 positions");

struct Weights {
  int32_t w[BETA];
};

// One length group (megascan.py builds the same layout with ctypes).
struct Group {
  int kind, m, P, kbits, col, k, use_lut, stride, noff, nw, W;
  int abits;                // 'a': rows of the private table, 2^abits
  const uint8_t* pats;      // (P, m)
  const uint32_t* anchors;  // (P, nw): packed words at _word_offsets(m); 'a': (P,) packed pattern
  const uint32_t* lut;      // bitset of 2^kbits bits: lut_any ('b', 'c') or relaxed_lut ('x')
  const uint32_t* bits;     // 'c' lut_bits, 'b' private bitmask (2^kbits, W),
                            // 'a' gram table (2^abits, W)
  const int* pid;           // 'b' with distinct fingerprints: the plan's lut_pid, else null
};

// Bytes of text staged: the back halo, the tile, the forward halo, slack.
__host__ __device__ inline int mega_staged(int back, int fwd) { return back + TILE + fwd + 16; }

// Dynamic shared memory of one block: staged bytes and one int32 counter per
// pattern.
extern "C" long long megascan_smem_bytes(int back, int fwd, int p_total) {
  return (long long)mega_staged(back, fwd) + 4LL * p_total;
}

__device__ inline uint32_t bit_of(const uint32_t* set, uint32_t h) {
  return (__ldg(set + (h >> 5)) >> (h & 31)) & 1u;
}

// Warp sum of c, added by lane 0 to a shared counter.
__device__ inline void warp_count(int* cnt, int c) {
  c = __reduce_add_sync(FULL, c);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(cnt, c);
}

// One count for cnt[key] from every lane whose key >= 0; lanes holding the
// same key share one shared atomic.  Every lane of the warp calls it.
__device__ inline void warp_add(int* cnt, int key) {
  const unsigned active = __ballot_sync(FULL, key >= 0);
  if (key < 0) return;
  const unsigned peers = __match_any_sync(active, key);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(cnt + key, __popc(peers));
}

// Fingerprint of the m-byte window at shared offset `local` from its chain
// value v (the strided words' salted sum): the tail word, FP_MULT, top bits.
__device__ inline uint32_t window_fp(uint32_t v, const uint8_t* s, int local, int m, int kbits,
                                     const Salts& salts, uint32_t fp_mult) {
  if (m % 4) v += gram(s, local + m - 4) * salts.s[m / 4];
  return (v * fp_mult) >> (32 - kbits);
}

// The window at shared offset `local` equals the pattern's nw anchor words.
__device__ inline bool anchors_match(const uint8_t* s, int local, const uint32_t* __restrict__ ap,
                                     int nw, int m) {
  for (int i = 0; i < nw; ++i)
    if (gram(s, local + word_offset(i, m)) != __ldg(ap + i)) return false;
  return true;
}

__global__ void __launch_bounds__(MEGA_THREADS, 2)
    mega_kernel(const uint8_t* __restrict__ text, long long n, long long L, long long ov,
                const Group* __restrict__ groups, int ngroups, int p_total, int back, int fwd,
                Weights wts, Salts salts, uint32_t fp_mult, int* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* s = reinterpret_cast<uint8_t*>(smem_u4);
  const int staged = mega_staged(back, fwd);
  int* cnt = reinterpret_cast<int*>(s + staged);
  for (int p = threadIdx.x; p < p_total; p += blockDim.x) cnt[p] = 0;
  const long long t0 = (long long)blockIdx.x * TILE;
  if (t0 == 0) {  // nothing precedes the window: the back halo is zeros
    for (int v = threadIdx.x; v < back / 16; v += blockDim.x)
      reinterpret_cast<uint4*>(s)[v] = make_uint4(0, 0, 0, 0);
    stage(s + back, text, 0, n, staged - back);
  } else {
    stage(s, text, t0 - back, n, staged);
  }
  __syncthreads();

  const int loc = back + threadIdx.x * PER;  // local offset of position pos0
  const long long pos0 = t0 + threadIdx.x * PER;
  uint32_t g[PER];  // the 4-grams starting at the thread's positions
  {
    const uint2 a = reinterpret_cast<const uint2*>(s + loc)[0];
    const uint32_t nx = reinterpret_cast<const uint32_t*>(s + loc)[2];
    const uint32_t wd[3] = {a.x, a.y, nx};
#pragma unroll
    for (int q = 0; q < PER; ++q)
      g[q] = __funnelshift_r(wd[q >> 2], wd[(q >> 2) + 1], 8 * (q & 3));
  }
  uint32_t v[PER];  // fingerprint chain: sum over strided words i < done
#pragma unroll
  for (int q = 0; q < PER; ++q) v[q] = 0;
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
        const int lb = (int)(bg - t0) + back;
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
    for (int q = 0; q < PER; ++q) {
      const long long pos = pos0 + q;
      valid |= (unsigned)(pos <= L - m && pos + m - 1 >= ov) << q;
    }
    if (G.kind == KIND_A) {
      const uint32_t mask = (1u << (8 * m)) - 1u;  // m < 4
      const uint32_t* __restrict__ tab = G.bits;
      const int sh = 32 - G.abits;
      uint32_t w0[PER];  // the first word of each position's row
#pragma unroll
      for (int q = 0; q < PER; ++q)
        w0[q] = __ldg(tab + (size_t)(((g[q] & mask) * fp_mult) >> sh) * G.W);
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        int key = -1;
        if ((valid >> q) & 1u) {
          const uint32_t x = g[q] & mask;
          const uint32_t* row = tab + (size_t)((x * fp_mult) >> sh) * G.W;
          for (int wi = 0; wi < G.W; ++wi) {
            for (uint32_t word = wi ? __ldg(row + wi) : w0[q]; word; word &= word - 1) {
              const int p = 32 * wi + __ffs(word) - 1;
              if (__ldg(G.anchors + p) != x) continue;
              if (key < 0) key = p;
              else atomicAdd(&cnt[G.col + p], 1);  // a duplicate pattern
            }
          }
        }
        warp_add(cnt + G.col, key);
      }
      continue;
    }
    // 'b' and 'x': candidate positions, through the LUT when there is one
    unsigned cand = valid;
    if (G.kind == KIND_B || G.use_lut) {
      const int ns = m / 4;
      if (ns < done) {  // groups out of m order: restart the chain
#pragma unroll
        for (int q = 0; q < PER; ++q) v[q] = 0;
        done = 0;
      }
      for (; done < ns; ++done) {
#pragma unroll
        for (int q = 0; q < PER; ++q) v[q] += gram(s, loc + q + 4 * done) * salts.s[done];
      }
      cand = 0;
#pragma unroll
      for (int q = 0; q < PER; ++q)
        cand |= bit_of(G.lut, window_fp(v[q], s, loc + q, m, G.kbits, salts, fp_mult)) << q;
      cand &= valid;
    }
    const unsigned wc = __reduce_or_sync(FULL, cand);  // positions any lane must look at
    if (!wc) continue;
    if (G.kind == KIND_B) {
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        if (!((wc >> q) & 1u)) continue;  // warp-uniform
        int key = -1;
        if ((cand >> q) & 1u) {
          const uint32_t h = window_fp(v[q], s, loc + q, m, G.kbits, salts, fp_mult);
          if (G.pid) {
            const int p = __ldg(G.pid + h);
            if (anchors_match(s, loc + q, G.anchors + (size_t)p * G.nw, G.nw, m)) key = p;
          } else {
            const uint32_t* row = G.bits + (size_t)h * G.W;
            for (int wi = 0; wi < G.W; ++wi) {
              for (uint32_t word = __ldg(row + wi); word; word &= word - 1) {
                const int p = 32 * wi + __ffs(word) - 1;
                if (!anchors_match(s, loc + q, G.anchors + (size_t)p * G.nw, G.nw, m)) continue;
                if (key < 0) key = p;
                else atomicAdd(&cnt[G.col + p], 1);  // a duplicate pattern
              }
            }
          }
        }
        warp_add(cnt + G.col, key);
      }
    } else if (G.kind == KIND_X) {
      const int k = G.k;
      for (int p = 0; p < G.P; ++p) {
        const uint8_t* pp = G.pats + (size_t)p * m;
        const uint32_t* ap = G.anchors + (size_t)p * G.nw;
        const uint32_t a0 = m >= 4 ? __ldg(ap) : (uint32_t)__ldg(pp);
        unsigned alive = 0;
#pragma unroll
        for (int q = 0; q < PER; ++q)
          alive |= (unsigned)(first_mismatches(g[q], a0, m) <= k) << q;
        alive &= cand;
        int c = 0;
        for (unsigned todo = alive; todo; todo &= todo - 1) {
          const int q = __ffs(todo) - 1;
          c += mismatches(
                   gram(s, loc + q), a0, m, k, ap, pp,
                   [&](int j) { return gram(s, loc + q + j); },
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
// them valid; groups: ngroups records in device memory; back, fwd: the
// halos (multiples of 16, back < 4096, fwd >= 16).  Requires n >= 1, 0 <= L <= n and the ops.py eligibility rules (m <= 4093, 'c':
// stride + m <= 4096, shared memory within the card's 227 KB).
extern "C" int megascan_launch(const uint8_t* text, long long n, long long L, long long ov,
                               const void* groups, int ngroups, int p_total, int back, int fwd,
                               Weights wts, Salts salts, uint32_t fp_mult, int* out,
                               void* stream) {
  const long long grid = grid_for(n);
  if (n < 1 || L < 0 || L > n || ngroups < 1 || p_total < 1 || grid < 0 || back < 0 ||
      back >= TILE || back % 16 || fwd < 16 || fwd % 16)
    return (int)cudaErrorInvalidValue;
  const long long smem = megascan_smem_bytes(back, fwd, p_total);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mega_kernel<<<(unsigned)grid, MEGA_THREADS, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      text, n, L, ov, static_cast<const Group*>(groups), ngroups, p_total, back, fwd, wts,
      salts, fp_mult, out);
  return (int)cudaGetLastError();
}
