// The paper's baseline algorithms (Faro & Kulekci 2012, Tables 1-3) as
// segmented device loops on Hopper: Shift-Or, KMP as a DFA, Lecroq's HASH3
// and BNDM.
//
// Replaces no Pallas kernel.  The reference runs these algorithms as one
// sequential XLA loop over the whole text (src/repro/core/baselines.py:
// shift_or :86 and kmp_dfa :124 are lax.scans, hash3 :179 and bndm :218
// lax.while_loops); one thread over the whole text would leave every other
// lane of the card idle, and an eager PyTorch loop a byte is n launches.
//
// Design: the text is cut into segments of `seg` bytes, one thread a segment,
// and each thread runs the reference's loop unchanged over its segment.  The
// seam rule is exact:
//   * Shift-Or and KMP own the match ENDS in [a, a + seg).  They start from the
//     reference's initial state (D = 0xFFFFFFFF, state 0) at a - (m - 1),
//     clamped at 0: both states depend only on the last m - 1 bytes read, so
//     after that warm-up they equal the sequential scan's.  A hit at end p is
//     written at start p - (m - 1).
//   * HASH3 owns the window ENDS i in [max(a, m - 1), a + seg), BNDM the window
//     STARTS in [a, min(a + seg, n - m + 1)).  Each loop starts at the first
//     position it owns and stops once past its range; its reads may run past
//     the segment.  Both skips are safe from any start (a shift never passes
//     an occurrence), so no occurrence is lost at a seam.
// The output is the reference's start mask: the wrapper hands a zeroed mask
// and threads write only their hits.
//
// Tables are built on the host as the reference builds them and read from
// shared memory: Shift-Or's and BNDM's B[256] (uint32), HASH3's 4096-entry
// shift table, KMP's (m + 1) x 256 int32 DFA while it fits in 48 KB (m <= 46;
// longer patterns read it from global memory through the read-only cache).
//
// Bound: bytes (n read, n written) or integer operations (a few a byte for
// the scans, times 1 + (m - 1) / seg for the warm-up; a few an iteration for
// the skip loops).  What binds each at 4 MiB is printed by chip_smoke.py
// (phase timing-baselines).  Each thread reads its own segment byte by byte,
// so a warp's loads are strided by seg and served from L1; HASH3 and BNDM
// diverge inside a warp, since each lane skips by its own data.
#include "common.cuh"

namespace {

constexpr int BL_THREADS = 256;
constexpr int HASH3_SIZE = 4096;
constexpr long long KMP_SMEM_MAX = 48 * 1024;

enum Algo { SHIFT_OR = 0, KMP = 1, HASH3 = 2, BNDM = 3 };

struct Segment {
  long long a, e;  // owned range [a, e) of the segment; a >= n: no segment
};

__device__ inline Segment segment(long long n, long long seg) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long a = s * seg;
  return {a, a + seg < n ? a + seg : n};
}

template <class T>
__device__ inline void load_table(T* dst, const T* __restrict__ src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(BL_THREADS)
    shift_or_kernel(const uint8_t* __restrict__ text, long long n,
                    const uint32_t* __restrict__ gB, int m, long long seg,
                    uint8_t* __restrict__ out) {
  __shared__ uint32_t B[256];
  load_table(B, gB, 256);
  __syncthreads();
  const Segment sg = segment(n, seg);
  if (sg.a >= n) return;
  const uint32_t bit = 1u << (m - 1);
  long long p = sg.a - (m - 1) > 0 ? sg.a - (m - 1) : 0;
  uint32_t D = 0xFFFFFFFFu;
  for (; p < sg.a; ++p) D = (D << 1) | B[__ldg(text + p)];
  for (; p < sg.e; ++p) {
    D = (D << 1) | B[__ldg(text + p)];
    if (!(D & bit)) out[p - (m - 1)] = 1;
  }
}

__global__ void __launch_bounds__(BL_THREADS)
    kmp_kernel(const uint8_t* __restrict__ text, long long n, const int32_t* __restrict__ gdfa,
               int m, long long seg, int in_smem, uint8_t* __restrict__ out) {
  extern __shared__ int32_t sdfa[];
  const int32_t* dfa = gdfa;
  if (in_smem) {  // uniform across the block
    load_table(sdfa, gdfa, (m + 1) * 256);
    __syncthreads();
    dfa = sdfa;
  }
  const Segment sg = segment(n, seg);
  if (sg.a >= n) return;
  long long p = sg.a - (m - 1) > 0 ? sg.a - (m - 1) : 0;
  int st = 0;
  for (; p < sg.a; ++p) st = dfa[st * 256 + __ldg(text + p)];
  for (; p < sg.e; ++p) {
    st = dfa[st * 256 + __ldg(text + p)];
    if (st == m) out[p - (m - 1)] = 1;
  }
}

__global__ void __launch_bounds__(BL_THREADS)
    hash3_kernel(const uint8_t* __restrict__ text, long long n, const uint8_t* __restrict__ pat,
                 long long m, const int32_t* __restrict__ gshift, long long seg,
                 uint8_t* __restrict__ out) {
  __shared__ int32_t shift[HASH3_SIZE];
  load_table(shift, gshift, HASH3_SIZE);
  __syncthreads();
  const Segment sg = segment(n, seg);
  long long i = sg.a > m - 1 ? sg.a : m - 1;
  while (i < sg.e) {
    const int h = ((int)__ldg(text + i - 2) + ((int)__ldg(text + i - 1) << 3) +
                   ((int)__ldg(text + i) << 6)) & (HASH3_SIZE - 1);
    const int s = shift[h];
    if (s == 0) {
      const long long start = i - m + 1;
      bool ok = true;
      for (long long j = 0; j < m && ok; ++j) ok = __ldg(text + start + j) == __ldg(pat + j);
      if (ok) out[start] = 1;
      i += 1;
    } else {
      i += s;
    }
  }
}

__global__ void __launch_bounds__(BL_THREADS)
    bndm_kernel(const uint8_t* __restrict__ text, long long n, const uint32_t* __restrict__ gB,
                int m, long long seg, uint8_t* __restrict__ out) {
  __shared__ uint32_t B[256];
  load_table(B, gB, 256);
  __syncthreads();
  const Segment sg = segment(n, seg);
  const long long lim = sg.e < n - m + 1 ? sg.e : n - m + 1;
  const uint32_t top = 1u << (m - 1);
  const uint32_t D0 = 0xFFFFFFFFu >> (32 - m);
  long long pos = sg.a;
  while (pos < lim) {
    int j = m, last = m;
    uint32_t D = D0;
    while (D != 0) {
      D &= B[__ldg(text + pos + j - 1)];
      j -= 1;
      if (D & top) {
        if (j == 0) out[pos] = 1;
        else last = j;
      }
      D = j > 0 ? D << 1 : 0;
    }
    pos += last;
  }
}

}  // namespace

// Launch one loop on `stream`; returns cudaGetLastError() (0 on success).
// algo: 0 Shift-Or (1 <= m <= 32, table B[256]), 1 KMP (table (m+1) x 256),
// 2 HASH3 (m >= 3, table shift[4096], pat the pattern), 3 BNDM (1 <= m <= 31,
// table B[256]).  Requires m <= n and seg >= 1; out holds n zeroed bytes.
extern "C" int baselines_launch(int algo, const uint8_t* text, long long n, const uint8_t* pat,
                                long long m, const int32_t* table, long long seg, uint8_t* out,
                                void* stream) {
  if (m < 1 || m > n || seg < 1) return (int)cudaErrorInvalidValue;
  const long long segments = (n + seg - 1) / seg;
  const long long grid = (segments + BL_THREADS - 1) / BL_THREADS;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 g((unsigned)grid), b(BL_THREADS);
  switch (algo) {
    case SHIFT_OR:
      if (m > 32) return (int)cudaErrorInvalidValue;
      shift_or_kernel<<<g, b, 0, st>>>(text, n, reinterpret_cast<const uint32_t*>(table), (int)m,
                                       seg, out);
      break;
    case KMP: {
      if (m > 0x7FFFFF) return (int)cudaErrorInvalidValue;
      const long long bytes = (m + 1) * 256 * 4;
      const int in_smem = bytes <= KMP_SMEM_MAX;
      kmp_kernel<<<g, b, in_smem ? (size_t)bytes : 0, st>>>(text, n, table, (int)m, seg, in_smem,
                                                            out);
      break;
    }
    case HASH3:
      if (m < 3) return (int)cudaErrorInvalidValue;
      hash3_kernel<<<g, b, 0, st>>>(text, n, pat, m, table, seg, out);
      break;
    case BNDM:
      if (m > 31) return (int)cudaErrorInvalidValue;
      bndm_kernel<<<g, b, 0, st>>>(text, n, reinterpret_cast<const uint32_t*>(table), (int)m, seg,
                                   out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
