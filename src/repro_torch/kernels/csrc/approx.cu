// k-mismatch multi-pattern matching on Hopper: P same-length patterns x B
// texts in one pass, under a Hamming budget k.
//
// Replaces the TPU kernel src/repro/kernels/approx/approx.py:_approx_kernel
// (with the valid-start masking of its ops._run).  Output:
//
//   out[b, p, i] = 1 iff first <= i <= min(len[b], n) - m  and
//                  #{j < m : text_b[i + j] != pat[p, j]} <= k
//
// with first = max(start_min, 0) and bytes past n read as 0 (a start past
// len - m is never valid, so the padding cannot complete a window).
//
// Bound: bytes.  B*n text bytes in, B*P*n mask bytes out: B*n*(P+1) /
// 3.35e12 s on an H100 SXM.  Every pattern's 16-byte store is written, so
// the work between the stores must stay below them.
//
// Layout: the multipattern kernel's.  One block of 256 threads owns a
// 4096-position tile of one row (grid x: tiles, grid y: rows, looping over
// rows past 65535), stages it with a right halo of min(m - 1, 8192) bytes in
// shared memory (16-byte loads, byte loads for unaligned rows) and reads any
// byte further right from global memory.  Each thread owns 16 positions and
// one 16-byte store per pattern; output offsets are 64-bit.
//
// Two paths, chosen by one static rule (kernels/approx/approx.py
// use_pieces): the pigeonhole filter when every one of the k + 1 pieces
// holds a packed word (m >= 4 (k + 1)) and its tables fit the wrapper's
// cap, else the first-word path.
//
// Pigeonhole filter (approx_pieces_kernel).  Each pattern is cut into k + 1
// disjoint pieces covering [0, m) (the first k + 1 - m % (k + 1) of length
// m / (k + 1), the rest one longer: kernels/approx/approx.py pieces).  A window
// within k mismatches of a pattern matches one of its pieces exactly.  Piece
// j's table maps the engine's salted word chain over the piece's first
// <= MAX_SALTS packed words, FP_MULT-mixed to PIECE_BITS bits, to a W-word
// pattern bitmask (built once per patterns tensor and k by the wrapper, read
// through the read-only cache).  A thread probes piece j at its 16
// positions together, from 4-grams cut out of six aligned words, so that
// the 16 probes are in flight at once.  At each position the k + 1 probes,
// OR'd, name the candidate patterns; only those are counted with
// `mismatches`.  On a random 4-letter text at m = 16, k = 2 that is
// ~3 * 4^-5 of the (position, pattern) pairs instead of the ~26 % the
// first-word test keeps.  The patterns go 32 at a time (one word of each
// row); with W > 1 words (KEEP_ROWS, launched for P > 32) the rows of the
// first word's pass are kept in shared memory (uint16, (k + 1) x 16 x
// THREADS) and the later words read them back, so each piece is hashed
// once a position.
//
// First-word path (approx_kernel), for short pieces and k >= m:
//   * Gate (use_lut): the window fingerprint over ALL anchor words, the
//     overlapping tail word included, probed in the relaxed LUT (a bitset of
//     2^kbits bits read through the read-only cache).  A true <= k window
//     always hits it, so a warp none of whose valid positions hits writes
//     zeros for every pattern; the decision is per warp (__any_sync).
//   * Mismatches: per packed word, __vcmpne4 of text and pattern word (0xFF
//     in each byte lane where their XOR is nonzero) and a popcount (8 bits
//     per differing byte), over the m/4 strided words, then
//     the m % 4 tail byte by byte; for m < 4 the first byte seeds the count.
//     The running count stops as soon as it passes k.
//   * Early exit: per pattern, the first word's (or byte's) mismatches are
//     tested first; if no valid position of the warp is still within k the
//     warp stores zeros for that pattern and moves on.
#include "common.cuh"

using namespace epsm;

constexpr int PIECE_BITS = 12;  // rows of a piece table: 2^PIECE_BITS
constexpr long long SMEM_MAX = 227 * 1024;  // shared memory a block may use

// Dynamic shared memory of approx_pieces_kernel: the staged text, then, for
// more than 32 patterns, every piece's row at every position of the tile.
extern "C" long long approx_pieces_smem_bytes(long long m, int k, long long P) {
  return staged_bytes(m) + (P > 32 ? 2LL * (k + 1) * TILE : 0);
}

template <bool USE_LUT>
__global__ void __launch_bounds__(THREADS)
    approx_kernel(const uint8_t* __restrict__ text, long long B, long long n,
                  const int* __restrict__ lengths, long long start_min,
                  const uint8_t* __restrict__ pats, const uint32_t* __restrict__ anchors,
                  long long P, int m, int nw_all, int k, const uint32_t* __restrict__ lut,
                  int kbits, Salts salts, uint32_t fp_mult, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* s = reinterpret_cast<uint8_t*>(smem_u4);
  const int staged = staged_bytes(m);
  const int loc = threadIdx.x * PER_THREAD;
  const long long base = (long long)blockIdx.x * TILE;
  const long long pos0 = base + loc;
  const long long first = start_min > 0 ? start_min : 0;

  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();  // every thread is done with the previous row's bytes
    stage(s, text + b * n, base, n, staged);
    __syncthreads();
    const Window w{s, staged, text + b * n, base, n};

    const long long len = (long long)lengths[b] < n ? (long long)lengths[b] : n;
    const long long last = len - m;
    unsigned valid = 0;
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const long long pos = pos0 + q;
      valid |= (unsigned)(pos >= first && pos <= last) << q;
    }
    bool gate = valid != 0;
    if (USE_LUT && gate) {  // does any valid position hit the relaxed LUT?
      gate = false;
      for (unsigned todo = valid; todo && !gate; todo &= todo - 1) {
        const int q = __ffs(todo) - 1;
        uint32_t v = 0;
        for (int i = 0; i < nw_all; ++i) v += w.gram4(loc + q + word_offset(i, m)) * salts.s[i];
        const uint32_t h = (v * fp_mult) >> (32 - kbits);
        gate = (__ldg(lut + (h >> 5)) >> (h & 31)) & 1u;
      }
    }
    gate = __any_sync(0xffffffffu, gate);

    uint8_t* orow = out + b * P * n;
    if (!gate) {
      const uint32_t r[4] = {0, 0, 0, 0};
      for (long long p = 0; p < P; ++p) store16(orow + p * n, pos0, n, r);
      continue;
    }
    // the 16 first-word 4-grams of the thread's positions
    uint32_t g[PER_THREAD];
    {
      const uint4 a = reinterpret_cast<const uint4*>(s + loc)[0];
      const uint32_t nx = reinterpret_cast<const uint32_t*>(s + loc)[4];
      const uint32_t wd[5] = {a.x, a.y, a.z, a.w, nx};
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q)
        g[q] = __funnelshift_r(wd[q >> 2], wd[(q >> 2) + 1], 8 * (q & 3));
    }
    for (long long p = 0; p < P; ++p) {
      const uint8_t* pp = pats + p * m;
      const uint32_t* ap = anchors + p * nw_all;
      const uint32_t a0 = m >= 4 ? __ldg(ap) : (uint32_t)__ldg(pp);
      // positions whose first word (first byte when m < 4) is within budget
      unsigned alive = 0;
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q)
        alive |= (unsigned)(first_mismatches(g[q], a0, m) <= k) << q;
      alive &= valid;
      uint32_t r[4] = {0, 0, 0, 0};
      if (__any_sync(0xffffffffu, alive != 0)) {
        for (unsigned todo = alive; todo; todo &= todo - 1) {
          const int q = __ffs(todo) - 1;
          const int mm = mismatches(
              g[q], a0, m, k, ap, pp, [&](int j) { return w.gram4(loc + q + j); },
              [&](int j) { return w.at(loc + q + j); });
          if (mm <= k) r[q >> 2] |= 1u << (8 * (q & 3));
        }
      }
      store16(orow + p * n, pos0, n, r);
    }
  }
}

// The 4-grams at shared offsets local .. local + 15 (local + 24 <= staged):
// six aligned words, shifted once to local's alignment, then per position.
__device__ inline void grams16(const uint8_t* s, int local, uint32_t g[PER_THREAD]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(s) + (local >> 2);
  const unsigned sh = 8 * (unsigned)(local & 3);
  uint32_t a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) a[i] = __funnelshift_r(w[i], w[i + 1], sh);
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q)
    g[q] = __funnelshift_r(a[q >> 2], a[(q >> 2) + 1], 8 * (q & 3));
}

template <bool KEEP_ROWS>  // W > 1: keep the rows of the first word's pass
__global__ void __launch_bounds__(THREADS)
    approx_pieces_kernel(const uint8_t* __restrict__ text, long long B, long long n,
                         const int* __restrict__ lengths, long long start_min,
                         const uint8_t* __restrict__ pats, const uint32_t* __restrict__ anchors,
                         long long P, int m, int nw_all, int k,
                         const uint32_t* __restrict__ tables, Salts salts, uint32_t fp_mult,
                         uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* s = reinterpret_cast<uint8_t*>(smem_u4);
  const int staged = staged_bytes(m);
  const int loc = threadIdx.x * PER_THREAD;
  const long long base = (long long)blockIdx.x * TILE;
  const long long pos0 = base + loc;
  const long long first = start_min > 0 ? start_min : 0;
  const int np = k + 1;
  const int short_len = m / np, big0 = np - m % np;  // the piece layout of approx.py pieces
  const long long W = (P + 31) / 32;
  uint16_t* rows = reinterpret_cast<uint16_t*>(s + staged);  // (np, PER_THREAD, THREADS)

  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();  // every thread is done with the previous row's bytes
    stage(s, text + b * n, base, n, staged);
    __syncthreads();
    const Window w{s, staged, text + b * n, base, n};

    const long long len = (long long)lengths[b] < n ? (long long)lengths[b] : n;
    const long long last = len - m;
    unsigned valid = 0;
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const long long pos = pos0 + q;
      valid |= (unsigned)(pos >= first && pos <= last) << q;
    }
    uint8_t* orow = out + b * P * n;
    for (long long wi = 0; wi < W; ++wi) {  // patterns 32 wi .. 32 wi + 31
      // the candidates of the 16 positions, piece by piece: the 16 probes
      // of a piece do not depend on each other, so they are in flight at once
      uint32_t cand[PER_THREAD];
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q) cand[q] = 0;
      for (int j = 0; j < np; ++j) {
        uint16_t* rj = rows + (size_t)j * TILE + threadIdx.x;  // entry q at rj[q * THREADS]
        uint32_t h[PER_THREAD];  // the piece's row at each position
        if (!KEEP_ROWS || wi == 0) {
          const int len_j = short_len + (j >= big0);
          const int off = j * short_len + (j > big0 ? j - big0 : 0);
          const int nwp = min(len_j / 4 + (len_j % 4 != 0), MAX_SALTS);
#pragma unroll
          for (int q = 0; q < PER_THREAD; ++q) h[q] = 0;
          for (int i = 0; i < nwp; ++i) {
            const int o = loc + off + word_offset(i, len_j);
            uint32_t g[PER_THREAD];
            if (o + PER_THREAD + 8 <= staged) {
              grams16(s, o, g);
            } else {
#pragma unroll
              for (int q = 0; q < PER_THREAD; ++q) g[q] = w.gram4(o + q);
            }
#pragma unroll
            for (int q = 0; q < PER_THREAD; ++q) h[q] += g[q] * salts.s[i];
          }
#pragma unroll
          for (int q = 0; q < PER_THREAD; ++q) {
            h[q] = (h[q] * fp_mult) >> (32 - PIECE_BITS);
            if (KEEP_ROWS) rj[q * THREADS] = (uint16_t)h[q];
          }
        } else {
#pragma unroll
          for (int q = 0; q < PER_THREAD; ++q) h[q] = rj[q * THREADS];
        }
        const uint32_t* tj = tables + ((size_t)j << PIECE_BITS) * W + wi;
#pragma unroll
        for (int q = 0; q < PER_THREAD; ++q) cand[q] |= __ldg(tj + (size_t)h[q] * W);
      }
      uint32_t hit[PER_THREAD];  // bit p % 32: pattern p within k at position q
      uint32_t any = 0;
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q) {
        hit[q] = 0;
        uint32_t c = (valid >> q) & 1u ? cand[q] : 0u;
        if (!c) continue;
        const uint32_t g = w.gram4(loc + q);
        for (; c; c &= c - 1) {
          const int bit = __ffs(c) - 1;
          const long long p = 32 * wi + bit;
          const uint32_t* ap = anchors + p * nw_all;
          const int mm = mismatches(
              g, __ldg(ap), m, k, ap, pats + p * m, [&](int j) { return w.gram4(loc + q + j); },
              [&](int j) { return w.at(loc + q + j); });
          if (mm <= k) hit[q] |= 1u << bit;
        }
        any |= hit[q];
      }
      const int pend = P - 32 * wi < 32 ? (int)(P - 32 * wi) : 32;
      for (int bit = 0; bit < pend; ++bit) {
        uint32_t r[4] = {0, 0, 0, 0};
        if ((any >> bit) & 1u) {
#pragma unroll
          for (int q = 0; q < PER_THREAD; ++q) r[q >> 2] |= ((hit[q] >> bit) & 1u) << (8 * (q & 3));
        }
        store16(orow + (32 * wi + bit) * n, pos0, n, r);
      }
    }
  }
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// text: B rows of n bytes; pats: (P, m) bytes; anchors: (P, nw_all) packed
// words at _word_offsets(m); lut: the relaxed-LUT bitset of 2^kbits bits,
// read only when use_lut; tables: the (k + 1, 2^PIECE_BITS, ceil(P/32))
// piece tables, or null for the first-word path; out: B*P*n.  Requires
// m >= 1, k >= 0, n >= 1, nw_all <= 8 when use_lut, and, with tables,
// m >= 4 (k + 1) and approx_pieces_smem_bytes within SMEM_MAX.
extern "C" int approx_launch(const uint8_t* text, long long B, long long n, const int* lengths,
                             long long start_min, const uint8_t* pats, const uint32_t* anchors,
                             long long P, long long m, int k, const uint32_t* lut, int kbits,
                             int use_lut, const uint32_t* tables, Salts salts, uint32_t fp_mult,
                             uint8_t* out, void* stream) {
  const long long grid = grid_for(n);
  const int nw_all = m >= 4 ? (int)(m / 4 + (m % 4 != 0)) : 0;
  if (m < 1 || m > 0x7FFFFFFFLL || k < 0 || n < 1 || B < 1 || P < 1 || grid < 0 ||
      (use_lut && (kbits < 1 || kbits > 26 || nw_all < 1 || nw_all > MAX_SALTS)) ||
      (tables && (m < 4LL * (k + 1) || approx_pieces_smem_bytes(m, k, P) > SMEM_MAX)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tables ? approx_pieces_smem_bytes(m, k, P) : staged_bytes(m);
  const dim3 blocks((unsigned)grid, (unsigned)(B < 65535 ? B : 65535));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tables && P > 32) {  // smem > 48 KB only here: staged_bytes(m) <= 12,304
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          approx_pieces_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    approx_pieces_kernel<true><<<blocks, THREADS, smem, st>>>(
        text, B, n, lengths, start_min, pats, anchors, P, (int)m, nw_all, k, tables, salts,
        fp_mult, out);
  } else if (tables)
    approx_pieces_kernel<false><<<blocks, THREADS, smem, st>>>(
        text, B, n, lengths, start_min, pats, anchors, P, (int)m, nw_all, k, tables, salts,
        fp_mult, out);
  else if (use_lut)
    approx_kernel<true><<<blocks, THREADS, smem, st>>>(text, B, n, lengths, start_min, pats,
                                                       anchors, P, (int)m, nw_all, k, lut, kbits,
                                                       salts, fp_mult, out);
  else
    approx_kernel<false><<<blocks, THREADS, smem, st>>>(text, B, n, lengths, start_min, pats,
                                                        anchors, P, (int)m, nw_all, k, lut, kbits,
                                                        salts, fp_mult, out);
  return (int)cudaGetLastError();
}
