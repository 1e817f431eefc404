// Aho-Corasick transition scan on Hopper: the state of a packed automaton
// after every byte of B text rows.
//
// Replaces the TPU kernel src/repro/kernels/acscan/acscan.py:_ac_kernel
// together with the class-window build of core/automaton.py
// (_segment_classes).  Output:
//
//   out[b, i] = the automaton state after consuming text_b[0..i]
//
// equal to the sequential scan for any segment width `seg` by the
// bounded-context property: with every pattern at most max_m = ov + 1 bytes
// long, a walk from the root over the ov bytes before position i reaches
// the true state by the time it consumes byte i.  Positions before a row's
// start feed class 0, whose root row stays at the root, so a walk that
// would start before the row starts at the row's first byte instead.
//
// Bound: bytes against operations.  B*n text bytes in, 4*B*n state bytes
// out and the 4*n_cells table read once: (5*B*n + 4*n_cells) / 3.35e12 s on
// an H100 SXM; about 4 integer operations a step (class load, multiply-add,
// table load, store) over B * lanes * (seg + ov) steps against ~16.7 TOP/s
// of INT32.  Neither is the real limit: every step's table load depends on
// the previous step's state, so a lane is a chain of dependent loads, and
// the kernel lives on the latency of that load (shared memory, or L2/HBM
// for a large table) hidden by as many lanes in flight as fit.
//
// Design: one thread per lane; a lane owns `seg` consecutive positions of
// one row (rows never share lanes).  A persistent grid of blocks of L lanes
// loops over (row, tile) pairs; for each it stages the tile's contiguous
// row span, L*seg + ov bytes, into shared memory as class ids (uint8, or
// uint16 past 256 classes) through a shared copy of the class map, with
// coalesced byte loads.  Each thread then walks its seg + ov steps out of
// shared memory and stores its seg owned states.  The transition table
// lives in shared memory when it fits beside the staging (copied once per
// persistent block) and is read through __ldg otherwise; a span too long
// for shared memory (very long patterns) is read from global memory byte
// by byte.  seg/4 odd keeps the threads of a warp on distinct banks when
// they read their staged bytes.  The host side chooses the placement and
// the block width and reports them.
#include "common.cuh"

namespace {

constexpr int CMAP_BYTES = 256 * 2;  // the class map as uint16
constexpr int LANES_MAX = 128;

__host__ __device__ inline long long round16ll(long long x) { return (x + 15) / 16 * 16; }

template <typename ClsT, bool SMEM_TABLE, bool STAGED>
__global__ void __launch_bounds__(LANES_MAX)
    acscan_kernel(const uint8_t* __restrict__ text, long long B, long long n,
                  const int* __restrict__ classes, const int* __restrict__ delta, int n_cells,
                  int ncls, int ov, int seg, long long lanes_row, long long tiles_row,
                  int* __restrict__ out) {
  extern __shared__ uint4 smem_u4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_u4);
  uint16_t* cmap = reinterpret_cast<uint16_t*>(smem);
  int* stab = reinterpret_cast<int*>(smem + CMAP_BYTES);
  ClsT* stage = reinterpret_cast<ClsT*>(
      smem + CMAP_BYTES + (SMEM_TABLE ? round16ll(4LL * n_cells) : 0));
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cmap[i] = (uint16_t)__ldg(classes + i);
  if (SMEM_TABLE)
    for (int i = threadIdx.x; i < n_cells; i += blockDim.x) stab[i] = __ldg(delta + i);

  const int L = blockDim.x;
  const long long span = (long long)L * seg + ov;
  const long long total = B * tiles_row;
  for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const long long b = tile / tiles_row;
    const long long lane0 = (tile % tiles_row) * L;
    const long long pos0 = lane0 * seg - ov;  // row position of the span's first byte
    const uint8_t* row = text + b * n;
    __syncthreads();  // the map and table are in place; the last tile's stage is consumed
    if (STAGED) {
      for (long long i = threadIdx.x; i < span; i += L) {
        const long long p = pos0 + i;
        stage[i] = (p >= 0 && p < n) ? (ClsT)cmap[row[p]] : (ClsT)0;
      }
      __syncthreads();
    }
    const long long lane = lane0 + threadIdx.x;
    if (lane >= lanes_row) continue;
    const long long first = lane * seg;                       // first owned position
    const long long last = first + seg < n ? first + seg : n; // one past the last
    long long p = first - ov > 0 ? first - ov : 0;            // class 0 keeps the root
    int* orow = out + b * n;
    int s = 0;
    auto cls = [&](long long q) -> int {
      if (STAGED) return (int)stage[q - pos0];
      return (int)cmap[__ldg(row + q)];
    };
    auto next = [&](int st, int c) -> int {
      const int idx = st * ncls + c;
      return SMEM_TABLE ? stab[idx] : __ldg(delta + idx);
    };
    for (; p < first; ++p) s = next(s, cls(p));
    for (; p < last; ++p) {
      s = next(s, cls(p));
      orow[p] = s;
    }
  }
}

template <typename ClsT, bool SMEM_TABLE, bool STAGED>
int launch(const uint8_t* text, long long B, long long n, const int* classes, const int* delta,
           int n_cells, int ncls, int ov, int seg, int lanes, size_t smem, int nsm, int* out,
           int* config, cudaStream_t st) {
  auto kernel = acscan_kernel<ClsT, SMEM_TABLE, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, lanes, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long lanes_row = (n + seg - 1) / seg;
  const long long tiles_row = (lanes_row + lanes - 1) / lanes;
  const long long tiles = B * tiles_row;
  const long long cap = (long long)per_sm * nsm;
  const int grid = (int)(tiles < cap ? tiles : cap);
  kernel<<<grid, lanes, smem, st>>>(text, B, n, classes, delta, n_cells, ncls, ov, seg, lanes_row,
                                    tiles_row, out);
  if (config != nullptr) {
    config[0] = SMEM_TABLE;
    config[1] = STAGED;
    config[2] = lanes;
    config[3] = grid;
    config[4] = (int)smem;
    config[5] = per_sm;
  }
  return (int)cudaGetLastError();
}

template <typename ClsT>
int dispatch(bool tab, bool staged, const uint8_t* text, long long B, long long n,
             const int* classes, const int* delta, int n_cells, int ncls, int ov, int seg,
             int lanes, size_t smem, int nsm, int* out, int* config, cudaStream_t st) {
  if (tab && staged)
    return launch<ClsT, true, true>(text, B, n, classes, delta, n_cells, ncls, ov, seg, lanes,
                                    smem, nsm, out, config, st);
  if (tab)
    return launch<ClsT, true, false>(text, B, n, classes, delta, n_cells, ncls, ov, seg, lanes,
                                     smem, nsm, out, config, st);
  if (staged)
    return launch<ClsT, false, true>(text, B, n, classes, delta, n_cells, ncls, ov, seg, lanes,
                                     smem, nsm, out, config, st);
  return launch<ClsT, false, false>(text, B, n, classes, delta, n_cells, ncls, ov, seg, lanes,
                                    smem, nsm, out, config, st);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take (including a
// forced placement that does not fit).
// text: B rows of n bytes; classes: 256 int32 class ids (< ncls); delta: the
// flat (n_cells / ncls, ncls) int32 table; ov = max_m - 1; out: B*n int32.
// force_table / force_staged: -1 lets the launcher choose, 0 or 1 forces the
// table's placement (global / shared) or the staging of the span.
// config (host, 6 ints): table in shared, staged, lanes a block, grid,
// dynamic shared bytes, blocks an SM.  Requires n >= 1, B >= 1, seg >= 1.
extern "C" int acscan_launch(const uint8_t* text, long long B, long long n, const int* classes,
                             const int* delta, long long n_cells, long long ncls, long long ov,
                             long long seg, int force_table, int force_staged, int* out,
                             int* config, void* stream) {
  if (B < 1 || n < 1 || ncls < 1 || ncls > 257 || n_cells < ncls || n_cells % ncls != 0 ||
      n_cells > (1LL << 25) || ov < 0 || ov >= (1LL << 30) || seg < 1 || seg >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  int dev = 0, smem_max = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long cls_bytes = ncls <= 256 ? 1 : 2;
  const long long table = round16ll(4 * n_cells);
  auto need = [&](bool tab, bool staged, int lanes) -> long long {
    return CMAP_BYTES + (tab ? table : 0) +
           (staged ? round16ll(cls_bytes * ((long long)lanes * seg + ov)) : 0);
  };
  // Preference: table in shared memory with at least two warps of lanes,
  // staged first; then the table in global memory, staged, at the widest
  // block that fits; last, neither.
  struct Choice { bool tab, staged; int lanes; };
  const Choice order[] = {{true, true, 128}, {true, true, 64}, {true, false, 128},
                          {false, true, 128}, {false, true, 64}, {false, true, 32},
                          {false, false, 128}};
  for (const Choice& c : order) {
    if ((force_table >= 0 && c.tab != (force_table != 0)) ||
        (force_staged >= 0 && c.staged != (force_staged != 0)))
      continue;
    const long long smem = need(c.tab, c.staged, c.lanes);
    if (smem > smem_max) continue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cls_bytes == 1)
      return dispatch<uint8_t>(c.tab, c.staged, text, B, n, classes, delta, (int)n_cells,
                               (int)ncls, (int)ov, (int)seg, c.lanes, (size_t)smem, nsm, out,
                               config, st);
    return dispatch<uint16_t>(c.tab, c.staged, text, B, n, classes, delta, (int)n_cells,
                              (int)ncls, (int)ov, (int)seg, c.lanes, (size_t)smem, nsm, out,
                              config, st);
  }
  return (int)cudaErrorInvalidValue;
}
