// EPSMb on Hopper: packed 4-gram anchor compare, then packed verification.
//
// Replaces the TPU kernel src/repro/kernels/epsmb/epsmb.py:_epsmb_kernel.
// Output with FUSE: out[i] = 1 iff text[i, i + m) == pat (0 past n - m).
// Output without FUSE: out[i] = 1 iff text[i, i + 4) == pat[0, 4) (0 past
// n - 4), the anchor candidates that the wrapper then verifies.
//
// Bound: bytes.  n text bytes in, n mask bytes out: 2n / 3.35e12 s on an H100
// SXM, 0.64 ms at 1 GiB.  Verification runs only at anchor hits, which are
// rare on real text, so its cost follows the data.
//
// Design: one block stages its 4096-byte tile plus the right halo into shared
// memory (common.cuh).  Each thread reads its 16 positions plus look-ahead as
// five 32-bit words and builds the 4-gram at each position with one
// __funnelshift_r of two aligned words (the paper's wsmatch): one 32-bit
// compare per position tests the anchor.  At each hit the rest of the pattern
// is compared in packed 4-byte steps, then a byte tail, from shared memory
// (global memory past the staged halo).  The mask goes out as one 16-byte
// store per thread.
#include "common.cuh"

using namespace epsm;

template <bool FUSE>
__global__ void __launch_bounds__(THREADS)
    epsmb_kernel(const uint8_t* __restrict__ text, long long n,
                 const uint8_t* __restrict__ pat, long long m, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* s = reinterpret_cast<uint8_t*>(smem_u4);
  const long long base = (long long)blockIdx.x * TILE;
  const int staged = staged_bytes(m);
  const int pstaged = pattern_bytes(m);
  uint8_t* ps = s + staged;
  stage(s, text, base, n, staged);
  stage_pattern(ps, pat, m, pstaged);
  __syncthreads();

  const Window win{s, staged, text, base, n};
  const Pattern p{ps, pstaged, pat, m};
  const uint32_t anchor = p.word(0);
  const int loc = threadIdx.x * PER_THREAD;
  const uint4 a = reinterpret_cast<const uint4*>(s + loc)[0];
  const uint32_t nx = reinterpret_cast<const uint32_t*>(s + loc)[4];
  const uint32_t w[5] = {a.x, a.y, a.z, a.w, nx};

  unsigned hits = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k)
    hits |= (unsigned)(__funnelshift_r(w[k >> 2], w[(k >> 2) + 1], 8 * (k & 3)) == anchor) << k;
  if (FUSE) {
    for (unsigned todo = hits; todo; todo &= todo - 1) {
      const int k = __ffs(todo) - 1;
      if (!verify_from(win, p, loc + k, 4)) hits &= ~(1u << k);
    }
  }
  uint32_t r[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) r[k >> 2] |= ((hits >> k) & 1u) << (8 * (k & 3));
  const long long pos0 = base + loc;
  clear_past(r, pos0, FUSE ? n - m : n - 4);
  store16(out, pos0, n, r);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// Requires 4 <= m <= n; out holds n bytes.
extern "C" int epsmb_launch(const uint8_t* text, long long n, const uint8_t* pat, long long m,
                            int fuse_verify, uint8_t* out, void* stream) {
  const long long grid = grid_for(n);
  if (m < 4 || m > n || grid < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = staged_bytes(m) + pattern_bytes(m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fuse_verify)
    epsmb_kernel<true><<<(unsigned)grid, THREADS, smem, st>>>(text, n, pat, m, out);
  else
    epsmb_kernel<false><<<(unsigned)grid, THREADS, smem, st>>>(text, n, pat, m, out);
  return (int)cudaGetLastError();
}
