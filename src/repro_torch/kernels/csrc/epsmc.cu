// EPSMc on Hopper: strided 8-byte block fingerprints, a 2^11-bit table of the
// pattern's substring fingerprints, and verification at candidate blocks.
//
// Replaces the TPU kernel src/repro/kernels/epsmc/epsmc.py:_epsmc_kernel
// (and the apron OR-combine of its wrapper, src/repro/kernels/epsmc/ops.py:_run).
// Output: out[i] = 1 iff text[i, i + m) == pat, for every i < n (0 past n - m).
//
// Bound: bytes.  n text bytes in, n mask bytes out: 2n / 3.35e12 s on an H100
// SXM, 0.64 ms at 1 GiB.  Hashing touches one 8-byte block per stride
// (floor(m/8) - 1) * 8 bytes; verification follows the candidates, so its
// cost depends on the data (every block is a candidate on "A"*n).
//
// Design:
//  * epsmc_table_kernel (one block) hashes the m - 7 pattern substrings
//    p[o, o + 8) and sets their bits in the 256-byte table L (the paper's
//    lookup table), which the wrapper allocates.
//  * epsmc_kernel: one block owns the start positions [base, base + 4096).
//    It stages the tile plus the right halo and the pattern into shared
//    memory (common.cuh), loads L into shared memory, and hashes every
//    inspected block b = i * stride with base <= b <= base + 4095 + (m - 8)
//    and b + 8 <= n: eight 32-bit multiply-adds that wrap mod 2^32 like the
//    reference's int32 dot, masked to 11 bits.  Blocks whose bit is set in L
//    go to a list in shared memory.  Every occurrence x holds an inspected
//    block in [x, x + m - 8], so verifying the starts [b - (m - 8), b] of the
//    listed blocks that fall in the tile finds them all.  The threads share
//    the (block, offset) pairs and compare in packed 4-byte steps.
//  * Races and zeroing: each block writes every byte of its own tile exactly
//    once, from a shared-memory mask that it zeroes first; several threads
//    may store 1 to the same shared byte, which is idempotent.  So the wrapper
//    allocates the output with torch.empty.
#include "common.cuh"

using namespace epsm;

constexpr int BETA = 8;         // must equal repro_torch.core.epsm.EPSMC_BETA
constexpr int KBITS = 11;       // must equal repro_torch.core.epsm.EPSMC_KBITS
constexpr int TABLE_BYTES = (1 << KBITS) / 8;

struct Weights {
  uint32_t w[BETA];
};

__device__ inline uint32_t hash8(const uint8_t b[BETA], const Weights& wt) {
  uint32_t h = 0;
#pragma unroll
  for (int k = 0; k < BETA; ++k) h += (uint32_t)b[k] * wt.w[k];
  return h & ((1u << KBITS) - 1);
}

__global__ void __launch_bounds__(THREADS)
    epsmc_table_kernel(const uint8_t* __restrict__ pat, long long m, Weights wt,
                       uint8_t* __restrict__ table) {
  __shared__ uint32_t bits[TABLE_BYTES / 4];
  for (int i = threadIdx.x; i < TABLE_BYTES / 4; i += blockDim.x) bits[i] = 0;
  __syncthreads();
  for (long long o = threadIdx.x; o + BETA <= m; o += blockDim.x) {
    uint8_t b[BETA];
#pragma unroll
    for (int k = 0; k < BETA; ++k) b[k] = pat[o + k];
    const uint32_t h = hash8(b, wt);
    atomicOr(&bits[h >> 5], 1u << (h & 31));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TABLE_BYTES / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(table)[i] = bits[i];
}

__global__ void __launch_bounds__(THREADS)
    epsmc_kernel(const uint8_t* __restrict__ text, long long n, const uint8_t* __restrict__ pat,
                 long long m, long long stride, Weights wt, const uint8_t* __restrict__ table,
                 int cand_cap, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  const int staged = staged_bytes(m);
  const int pstaged = pattern_bytes(m);
  uint8_t* s = reinterpret_cast<uint8_t*>(smem_u4);
  uint8_t* ps = s + staged;
  uint8_t* mask = ps + pstaged;
  uint32_t* bits = reinterpret_cast<uint32_t*>(mask + TILE);
  int* cand = reinterpret_cast<int*>(bits + TABLE_BYTES / 4);
  __shared__ int ncand;

  const long long base = (long long)blockIdx.x * TILE;
  stage(s, text, base, n, staged);
  stage_pattern(ps, pat, m, pstaged);
  for (int i = threadIdx.x; i < TABLE_BYTES / 4; i += blockDim.x)
    bits[i] = __ldg(reinterpret_cast<const uint32_t*>(table) + i);
  for (int v = threadIdx.x; v < TILE / 16; v += blockDim.x)
    reinterpret_cast<uint4*>(mask)[v] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) ncand = 0;
  __syncthreads();

  const Window win{s, staged, text, base, n};
  const Pattern p{ps, pstaged, pat, m};

  // Filter: hash the inspected blocks whose candidate starts reach the tile.
  const long long hi = min(base + TILE - 1 + (m - BETA), n - BETA);
  const long long i0 = (base + stride - 1) / stride;
  for (long long i = i0 + threadIdx.x; i * stride <= hi; i += blockDim.x) {
    const long long l = i * stride - base;
    uint8_t b[BETA];
    if (l + BETA <= staged) {
      const uint2 v = *reinterpret_cast<const uint2*>(s + l);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        b[k] = (uint8_t)(v.x >> (8 * k));
        b[k + 4] = (uint8_t)(v.y >> (8 * k));
      }
    } else {
#pragma unroll
      for (int k = 0; k < BETA; ++k) b[k] = win.at(l + k);
    }
    const uint32_t h = hash8(b, wt);
    if ((bits[h >> 5] >> (h & 31)) & 1u) cand[atomicAdd(&ncand, 1)] = (int)l;
  }
  __syncthreads();

  // Verify: the starts [b - (m - 8), b] of every candidate block, in the tile.
  const long long noff = m - BETA + 1;
  const long long last = min((long long)TILE - 1, n - m - base);
  const long long pairs = (long long)ncand * noff;
  for (long long q = threadIdx.x; q < pairs; q += blockDim.x) {
    const long long c = q / noff;
    const long long x = cand[c] - (q - c * noff);
    if (x < 0 || x > last || mask[x]) continue;
    if (verify_from(win, p, x, 0)) mask[x] = 1;
  }
  __syncthreads();

  for (int v = threadIdx.x; v < TILE / 16; v += blockDim.x) {
    const uint4 t = reinterpret_cast<const uint4*>(mask)[v];
    const uint32_t r[4] = {t.x, t.y, t.z, t.w};
    store16(out, base + 16LL * v, n, r);
  }
}

// Launch the table build and the scan on `stream`; returns cudaGetLastError()
// (0 on success).  Requires 16 <= m <= n and stride = (m / 8 - 1) * 8;
// weights are the 8 hash weights; table is 256 bytes of device scratch; out
// holds n bytes.
extern "C" int epsmc_launch(const uint8_t* text, long long n, const uint8_t* pat, long long m,
                            long long stride, const int32_t* weights, uint8_t* table,
                            uint8_t* out, void* stream) {
  const long long grid = grid_for(n);
  if (m < 2 * BETA || m > n || stride < BETA || grid < 0) return (int)cudaErrorInvalidValue;
  Weights wt;
  for (int k = 0; k < BETA; ++k) wt.w[k] = (uint32_t)weights[k];
  const int cand_cap = (int)((TILE - 1 + (m - BETA)) / stride + 1);
  const size_t smem = staged_bytes(m) + pattern_bytes(m) + TILE + TABLE_BYTES +
                      sizeof(int) * (size_t)cand_cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  epsmc_table_kernel<<<1, THREADS, 0, st>>>(pat, m, wt, table);
  epsmc_kernel<<<(unsigned)grid, THREADS, smem, st>>>(text, n, pat, m, stride, wt, table,
                                                       cand_cap, out);
  return (int)cudaGetLastError();
}
