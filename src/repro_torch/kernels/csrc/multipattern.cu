// Multi-pattern EPSMb on Hopper: P same-length patterns x B texts in one
// pass, gated by the engine's union fingerprint LUT.
//
// Replaces the TPU kernel src/repro/kernels/multipattern/multipattern.py:
// _mp_kernel (with the valid-start masking of its ops._run).  Output:
//
//   out[b, p, i] = 1 iff first <= i <= min(len[b], n) - m  and  gate(b, i)
//                  and word(text_b, i + o) == anchor[p, o] for every o in
//                  _word_offsets(m)
//
// with first = max(start_min, 0), bytes past n read as 0, and gate(b, i) true
// when some valid position of i's 512-position warp span hits lut[fp(j)], fp
// being the engine's salted window fingerprint
// fp_finalize(sum_k word(j + o_k) * salt[k]).  A true match always hits its
// own LUT slot, so the gate only saves work.  Without USE_LUT (m >= 16, whose
// plan LUT is keyed by block fingerprints) every position verifies.
//
// Bound: bytes.  B*n text bytes in, B*P*n mask bytes out: B*n*(P+1) / 3.35e12
// s on an H100 SXM.  The LUT (a bitset of 2^kbits bits, kbits up to 22 for
// bucketed plans) and the anchors are small next to that.
//
// Design: one block of 256 threads owns one 4096-position tile of one row
// (grid x: tiles, grid y: rows, looping over rows past 65535).  It stages the
// tile plus an m - 1 byte right halo (m <= 4096, so at most 8 KiB) in shared
// memory with 16-byte loads (byte loads for unaligned rows).  Each thread
// owns 16 positions and one 16-byte store per pattern.  Each thread
// fingerprints its valid positions until one hits the LUT bitset, read
// through the read-only cache (16 KiB at 17 bits stays in L1; staging it in
// shared memory per block measured no faster on the H100); the gate is then
// decided per warp with __any_sync, finer than the reference's per-tile gate
// and without divergence.  A gated-off warp writes its P * 512 zero bytes
// with 16-byte stores and no compare (with 32 patterns in 2^17 slots that is
// most warps).  A gated-on warp compares, per pattern, its 16 precomputed
// 4-grams (one __funnelshift_r of two aligned shared words each) against the
// pattern's first anchor word and verifies the remaining words only at hits.
// Output offsets are 64-bit: B*P*n can pass 2^31.
#include "common.cuh"

using namespace epsm;

// The 16 mask bytes of one pattern at the thread's 16 positions: the first
// anchor word against the 16 precomputed 4-grams, the other words only at hits.
__device__ inline void match16(const uint8_t* s, int loc, const uint32_t g[PER_THREAD],
                               unsigned valid, const uint32_t* __restrict__ ap, int nw, int m,
                               uint32_t r[4]) {
  const uint32_t a0 = __ldg(ap);
  unsigned hits = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) hits |= (unsigned)(g[k] == a0) << k;
  hits &= valid;
  for (unsigned todo = hits; todo; todo &= todo - 1) {
    const int k = __ffs(todo) - 1;
    for (int i = 1; i < nw; ++i) {
      if (gram(s, loc + k + word_offset(i, m)) != __ldg(ap + i)) {
        hits &= ~(1u << k);
        break;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) r[k >> 2] |= ((hits >> k) & 1u) << (8 * (k & 3));
}

template <bool USE_LUT>
__global__ void __launch_bounds__(THREADS)
    mp_kernel(const uint8_t* __restrict__ text, long long B, long long n,
              const int* __restrict__ lengths, long long start_min,
              const uint32_t* __restrict__ anchors, long long P, int m, int nw,
              const uint32_t* __restrict__ lut, int kbits, Salts salts, uint32_t fp_mult,
              uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* s = reinterpret_cast<uint8_t*>(smem_u4);
  const int staged = staged_bytes(m);
  const int loc = threadIdx.x * PER_THREAD;
  const long long pos0 = (long long)blockIdx.x * TILE + loc;
  const long long first = start_min > 0 ? start_min : 0;

  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();  // every thread is done with the previous row's bytes
    stage(s, text + b * n, pos0 - loc, n, staged);
    __syncthreads();

    const long long len = (long long)lengths[b] < n ? (long long)lengths[b] : n;
    const long long last = len - m;
    unsigned valid = 0;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const long long pos = pos0 + k;
      valid |= (unsigned)(pos >= first && pos <= last) << k;
    }
    bool verify = valid != 0;
    if (USE_LUT && verify) {  // does any valid position hit the LUT?
      verify = false;
      for (unsigned todo = valid; todo && !verify; todo &= todo - 1) {
        const int k = __ffs(todo) - 1;
        uint32_t v = 0;
        for (int i = 0; i < nw; ++i) v += gram(s, loc + k + word_offset(i, m)) * salts.s[i];
        const uint32_t h = (v * fp_mult) >> (32 - kbits);
        verify = (__ldg(lut + (h >> 5)) >> (h & 31)) & 1u;
      }
    }
    // one decision per warp keeps its lanes on one path
    verify = __any_sync(0xffffffffu, verify);

    uint8_t* orow = out + b * P * n;
    if (verify) {
      uint32_t g[PER_THREAD];
      const uint4 a = reinterpret_cast<const uint4*>(s + loc)[0];
      const uint32_t nx = reinterpret_cast<const uint32_t*>(s + loc)[4];
      const uint32_t wd[5] = {a.x, a.y, a.z, a.w, nx};
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k)
        g[k] = __funnelshift_r(wd[k >> 2], wd[(k >> 2) + 1], 8 * (k & 3));
      for (long long p = 0; p < P; ++p) {
        uint32_t r[4] = {0, 0, 0, 0};
        match16(s, loc, g, valid, anchors + p * nw, nw, m, r);
        store16(orow + p * n, pos0, n, r);
      }
    } else {
      const uint32_t r[4] = {0, 0, 0, 0};
      for (long long p = 0; p < P; ++p) store16(orow + p * n, pos0, n, r);
    }
  }
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// text: B rows of n bytes; anchors: (P, nw) packed words; lut: the bitset of
// 2^kbits bits (at least one 32-bit word), read only when use_lut; out: B*P*n.
// Requires 4 <= m <= 4096, n >= 1, and nw <= 8 when use_lut.
extern "C" int multipattern_launch(const uint8_t* text, long long B, long long n,
                                   const int* lengths, long long start_min,
                                   const uint32_t* anchors, long long P, long long m,
                                   const uint32_t* lut, int kbits, int use_lut, Salts salts,
                                   uint32_t fp_mult, uint8_t* out, void* stream) {
  const long long grid = grid_for(n);
  const int nw = (int)(m / 4 + (m % 4 != 0));
  if (m < 4 || m > TILE || n < 1 || B < 1 || P < 1 || grid < 0 || kbits < 1 || kbits > 26 ||
      (use_lut && nw > MAX_SALTS))
    return (int)cudaErrorInvalidValue;
  const size_t smem = staged_bytes(m);
  const dim3 blocks((unsigned)grid, (unsigned)(B < 65535 ? B : 65535));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_lut)
    mp_kernel<true><<<blocks, THREADS, smem, st>>>(text, B, n, lengths, start_min, anchors, P,
                                                   (int)m, nw, lut, kbits, salts, fp_mult, out);
  else
    mp_kernel<false><<<blocks, THREADS, smem, st>>>(text, B, n, lengths, start_min, anchors, P,
                                                    (int)m, nw, lut, kbits, salts, fp_mult, out);
  return (int)cudaGetLastError();
}
