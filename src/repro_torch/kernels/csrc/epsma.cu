// EPSMa on Hopper: the AND of m byte-equality tests at every start position.
//
// Replaces the TPU kernel src/repro/kernels/epsma/epsma.py:_epsma_kernel.
// Output: out[i] = 1 iff text[i, i + m) == pat, for every i < n (0 past n - m).
//
// Bound: bytes.  The kernel reads n text bytes and writes n mask bytes; on an
// H100 SXM (3.35 TB/s) the least time is 2n / 3.35e12 s, 0.64 ms at 1 GiB.
// The compares are a few integer ops per byte, far below the card's rate.
//
// Design: one block stages its 4096-byte tile plus the right halo into shared
// memory with 16-byte loads (common.cuh).  For m < 4 (the EPSMa regime) each
// thread reads its 16 positions plus 16 bytes of look-ahead as eight 32-bit
// words, and for each pattern byte compares four positions at once with
// __vcmpeq4 on a funnel-shifted word (the paper's wscmp), ANDing the results.
// The mask goes out as one 16-byte store per thread.  Any other m (the
// reference accepts EPSMa at every length) takes a plain per-position byte
// loop over the same staged tile.
#include "common.cuh"

using namespace epsm;

template <int M>  // 1..3: the pattern length, fixed at compile time; 0: any m
__global__ void __launch_bounds__(THREADS)
    epsma_kernel(const uint8_t* __restrict__ text, long long n,
                 const uint8_t* __restrict__ pat, long long m, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* s = reinterpret_cast<uint8_t*>(smem_u4);
  const long long base = (long long)blockIdx.x * TILE;
  const int staged = staged_bytes(m);
  stage(s, text, base, n, staged);
  __syncthreads();

  const int loc = threadIdx.x * PER_THREAD;
  uint32_t r[4];
  if constexpr (M > 0) {
    const uint4 a = reinterpret_cast<const uint4*>(s + loc)[0];
    const uint32_t nx = reinterpret_cast<const uint32_t*>(s + loc)[4];
    const uint32_t w[5] = {a.x, a.y, a.z, a.w, nx};
#pragma unroll
    for (int q = 0; q < 4; ++q) r[q] = 0x01010101u;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const uint32_t pj = 0x01010101u * __ldg(pat + j);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] &= __vcmpeq4(__funnelshift_r(w[q], w[q + 1], 8 * j), pj);
    }
  } else {
    const Window win{s, staged, text, base, n};
#pragma unroll
    for (int q = 0; q < 4; ++q) r[q] = 0;
    for (int k = 0; k < PER_THREAD; ++k) {
      bool ok = true;
      for (long long j = 0; j < m && ok; ++j) ok = win.at(loc + k + j) == __ldg(pat + j);
      r[k >> 2] |= (uint32_t)ok << (8 * (k & 3));
    }
  }
  const long long pos0 = base + loc;
  clear_past(r, pos0, n - m);
  store16(out, pos0, n, r);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// Requires 1 <= m <= n; out holds n bytes.
extern "C" int epsma_launch(const uint8_t* text, long long n, const uint8_t* pat, long long m,
                            uint8_t* out, void* stream) {
  const long long grid = grid_for(n);
  if (m < 1 || m > n || grid < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = staged_bytes(m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: epsma_kernel<1><<<(unsigned)grid, THREADS, smem, st>>>(text, n, pat, m, out); break;
    case 2: epsma_kernel<2><<<(unsigned)grid, THREADS, smem, st>>>(text, n, pat, m, out); break;
    case 3: epsma_kernel<3><<<(unsigned)grid, THREADS, smem, st>>>(text, n, pat, m, out); break;
    default: epsma_kernel<0><<<(unsigned)grid, THREADS, smem, st>>>(text, n, pat, m, out); break;
  }
  return (int)cudaGetLastError();
}
