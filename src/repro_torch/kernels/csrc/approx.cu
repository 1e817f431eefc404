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
// 3.35e12 s on an H100 SXM.  The integer work is about level with it: each
// (position, pattern) pair costs ~5 operations for its first word alone,
// against the CUDA cores' ~16.7 TOP/s of INT32.
//
// Design: the multipattern kernel's layout.  One block of 256 threads owns a
// 4096-position tile of one row (grid x: tiles, grid y: rows, looping over
// rows past 65535), stages it with a right halo of min(m - 1, 8192) bytes in
// shared memory (16-byte loads, byte loads for unaligned rows) and reads any
// byte further right from global memory.  Each thread owns 16 positions and
// one 16-byte store per pattern; output offsets are 64-bit.
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

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// text: B rows of n bytes; pats: (P, m) bytes; anchors: (P, nw_all) packed
// words at _word_offsets(m); lut: the relaxed-LUT bitset of 2^kbits bits,
// read only when use_lut; out: B*P*n.  Requires m >= 1, k >= 0, n >= 1, and
// nw_all <= 8 when use_lut.
extern "C" int approx_launch(const uint8_t* text, long long B, long long n, const int* lengths,
                             long long start_min, const uint8_t* pats, const uint32_t* anchors,
                             long long P, long long m, int k, const uint32_t* lut, int kbits,
                             int use_lut, Salts salts, uint32_t fp_mult, uint8_t* out,
                             void* stream) {
  const long long grid = grid_for(n);
  const int nw_all = m >= 4 ? (int)(m / 4 + (m % 4 != 0)) : 0;
  if (m < 1 || m > 0x7FFFFFFFLL || k < 0 || n < 1 || B < 1 || P < 1 || grid < 0 ||
      (use_lut && (kbits < 1 || kbits > 26 || nw_all < 1 || nw_all > MAX_SALTS)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = staged_bytes(m);
  const dim3 blocks((unsigned)grid, (unsigned)(B < 65535 ? B : 65535));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_lut)
    approx_kernel<true><<<blocks, THREADS, smem, st>>>(text, B, n, lengths, start_min, pats,
                                                       anchors, P, (int)m, nw_all, k, lut, kbits,
                                                       salts, fp_mult, out);
  else
    approx_kernel<false><<<blocks, THREADS, smem, st>>>(text, B, n, lengths, start_min, pats,
                                                        anchors, P, (int)m, nw_all, k, lut, kbits,
                                                        salts, fp_mult, out);
  return (int)cudaGetLastError();
}
