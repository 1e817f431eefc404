// Aho-Corasick transition scan on Hopper, in two modes: the state of a
// packed automaton after every byte of B text rows, or the per-row histogram
// of the terminal states the scan passes through, with no state array
// written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/acscan/acscan.py:_ac_kernel
// together with the class-window build of core/automaton.py
// (_segment_classes), and in the counts mode the emission around it.
//
//   states:  out[b, i] = the automaton state after consuming text_b[0..i]
//   counts:  out[b, t] = #{ i : end_min <= i < lengths[b], state(b, i) = 1 + t }
//            for the n_term terminal states, which the caller's private
//            table numbers 1..n_term (the root stays 0), so "is terminal" is
//            one unsigned compare and the histogram column is the state - 1.
//
// Both equal the sequential scan for any segment width `seg` by the
// bounded-context property: with every pattern at most max_m = ov + 1 bytes
// long, a walk from the root that starts ov or more bytes before position i
// reaches the true state by the time it consumes byte i.  Bytes before a
// row's start feed class 0, whose root row stays at the root.
//
// Bound (counted in chip_smoke.py): bytes, the text read once, the table
// once at its stored width, and either the int32 states (4 B n) or the
// histogram (4 B n_term) written once, over 3.35 TB/s on an H100 SXM; about
// 4 integer operations a transition over the n transitions of the
// sequential scan.  The real limit is neither: each step's table load
// depends on the previous step's state, so a lane is a chain of dependent
// loads and the kernel lives on the latency of that load (shared memory, or
// L1/L2/HBM for a table in global memory) and on how many chains are in
// flight.
//
// Design.  A lane owns `seg` consecutive positions of one row and walks from
// ov bytes before them (from the row's start for the first lanes).  Each
// thread walks K lanes at once, interleaved step by step, so that K
// independent chains of loads are in flight a thread.  A persistent grid of
// blocks of T threads loops over tiles of T * K lanes of one row (rows never
// share a tile).  Lane k of thread t in a tile is lane0 + k T + t, so a
// warp's neighbouring threads walk neighbouring lanes.
//   - Text: each lane takes 16 bytes at a time as one 16-byte load, from a
//     16-byte aligned position at or before its walk start (the extra bytes
//     are more warm-up), the next 16 loaded while these are walked, so that
//     no shared memory goes to text.  The byte -> class map lives in shared
//     memory.  The text must start 16-byte aligned (the wrapper sees to it);
//     a 16-byte load that holds a byte of the text stays inside its 512-byte
//     granular allocation.
//   - Table: uint16 entries where the state ids fit, else int32; in shared
//     memory when it fits beside the rest (copied once per persistent
//     block), else read through the read-only cache.
//   - States mode: each lane buffers a chunk's 16 states in registers and
//     writes them as four 16-byte stores, two whole 32-byte sectors, so that
//     no sector waits half-written in L2 (4-byte stores 528 bytes apart
//     did, and so did 16-byte stores 4 steps apart).
//   - Counts mode: the histogram of one row lives in shared memory
//     (`COUNTS_SHARED`, flushed with one global atomicAdd a nonzero column
//     when the block moves to another row and at its end), or every hit is
//     one global atomicAdd into the (B, n_term) output (`COUNTS_GLOBAL`).
//     Integer adds are exact in any order, so the result is deterministic.
//     A lane's walk starts ov bytes before the first position it counts
//     (end_min included), and ends at the last (lengths included).
// The host side chooses the placements, T, K and whether a block has an SM
// to itself (so that L1 keeps the rest of its memory), and reports them.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int CMAP_BYTES = 256 * 2;  // the class map as uint16
constexpr int CHUNK = 16;  // text bytes a lane takes at a time

enum Mode { STATES = 0, COUNTS_SHARED = 1, COUNTS_GLOBAL = 2 };

__host__ __device__ inline long long round16ll(long long x) { return (x + 15) / 16 * 16; }

struct Args {
  const uint8_t* text;
  long long B, n;
  const int* classes;     // (256,) int32
  const void* table;      // (n_cells,) uint16 or int32
  long long n_cells;
  int ncls, ov, seg, n_term;
  const long long* lengths;  // counts: (B,) valid bytes of each row
  long long end_min;         // counts: first position counted
  long long lanes_row, tiles_row;
  int* out;  // states: (B, n); counts: (B, n_term), zeroed by the caller
};

// One lane a thread fits 1024 threads a block in registers, four 512.
__host__ __device__ constexpr int max_threads(int lanes) { return lanes == 1 ? 1024 : 512; }

template <typename TabT, bool SMEM_TABLE, int MODE, int K>
__global__ void __launch_bounds__(max_threads(K))
    acscan_kernel(const Args a) {
  extern __shared__ uint4 smem_u4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_u4);
  uint16_t* cmap = reinterpret_cast<uint16_t*>(smem);
  long long off = CMAP_BYTES;
  TabT* stab = reinterpret_cast<TabT*>(smem + off);
  if (SMEM_TABLE) off += round16ll((long long)sizeof(TabT) * a.n_cells);
  int* shist = reinterpret_cast<int*>(smem + off);

  const TabT* gtab = static_cast<const TabT*>(a.table);
  const int T = blockDim.x;
  for (int i = threadIdx.x; i < 256; i += T) cmap[i] = (uint16_t)__ldg(a.classes + i);
  if (SMEM_TABLE) {
    // the table's allocation is 16-byte aligned and 512-byte granular
    const long long words = round16ll((long long)sizeof(TabT) * a.n_cells) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(gtab);
    for (long long i = threadIdx.x; i < words; i += T)
      reinterpret_cast<uint4*>(stab)[i] = __ldg(src + i);
  }
  if (MODE == COUNTS_SHARED)
    for (int i = threadIdx.x; i < a.n_term; i += T) shist[i] = 0;

  auto next = [&](int st, int c) -> int {
    const int idx = st * a.ncls + c;
    return SMEM_TABLE ? (int)stab[idx] : (int)__ldg(gtab + idx);
  };
  auto flush = [&](long long row) {  // the shared histogram into row `row`, then zeroed
    int* dst = a.out + row * a.n_term;
    for (int i = threadIdx.x; i < a.n_term; i += T) {
      const int v = shist[i];
      if (v != 0) {
        atomicAdd(dst + i, v);
        shist[i] = 0;
      }
    }
  };

  const long long lanes_tile = (long long)T * K;
  const long long ntiles = a.B * a.tiles_row;
  long long cur_row = -1;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long b = tile / a.tiles_row;
    const long long lane0 = (tile % a.tiles_row) * lanes_tile;
    const long long rs = b * a.n;  // flat index of the row's first byte
    __syncthreads();  // the map, table and histogram are in place
    if (MODE == COUNTS_SHARED && b != cur_row) {
      if (cur_row >= 0) {
        flush(cur_row);
        __syncthreads();
      }
      cur_row = b;
    }
    long long hi_row = a.n;  // one past the last position of the row walked
    long long lo_row = 0;    // the first position emitted
    if (MODE != STATES) {
      const long long len = __ldg(a.lengths + b);
      hi_row = len < 0 ? 0 : (len < a.n ? len : a.n);
      lo_row = a.end_min > 0 ? a.end_min : 0;
    }
    // flat, 16-byte aligned start of the tile's span
    const long long w0 = lane0 * a.seg - a.ov;
    const long long S0 = (rs + (w0 > 0 ? w0 : 0)) & ~15LL;

    // each lane: its offset from S0 (16-byte aligned), its chunk count, the
    // emitted range [lo, lo + len) and the foreign bytes [0, gate) before
    // the row's start, all relative to its own start
    int offs[K], nch[K], lo[K], len[K], gate[K], s[K];
    int nmax = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long lane = lane0 + (long long)k * T + threadIdx.x;
      const long long first = lane * a.seg;
      long long last = first + a.seg < a.n ? first + a.seg : a.n;
      long long e0 = first > lo_row ? first : lo_row;
      if (last > hi_row) last = hi_row;
      s[k] = 0;
      offs[k] = nch[k] = lo[k] = len[k] = gate[k] = 0;
      if (lane < a.lanes_row && e0 < last) {
        const long long ws = e0 - a.ov > 0 ? e0 - a.ov : 0;
        const long long a0 = (rs + ws) & ~15LL;
        offs[k] = (int)(a0 - S0);
        nch[k] = (int)((rs + last - a0 + CHUNK - 1) / CHUNK);
        lo[k] = (int)(rs + e0 - a0);
        len[k] = (int)(last - e0);
        gate[k] = rs > a0 ? (int)(rs - a0) : 0;
        if (nch[k] > nmax) nmax = nch[k];
      }
    }
    int* hist = MODE == COUNTS_SHARED ? shist : a.out + b * a.n_term;

    auto load = [&](int k, int c) -> uint4 {
      return __ldg(reinterpret_cast<const uint4*>(a.text + S0 + offs[k]) + c);
    };
    uint4 cur[K], nxt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cur[k] = nch[k] > 0 ? load(k, 0) : make_uint4(0, 0, 0, 0);
      nxt[k] = cur[k];
    }
    auto walk = [&](int c, auto gated) {
      constexpr bool GATE = decltype(gated)::value;
      int buf[K][CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const uint4& w = cur[k];
          const unsigned word = j < 4 ? w.x : j < 8 ? w.y : j < 12 ? w.z : w.w;
          int cls = cmap[(word >> (8 * (j & 3))) & 0xFF];
          const int rel = CHUNK * c + j;
          if (GATE && rel < gate[k]) cls = 0;
          const int st = s[k] = next(s[k], cls);
          if (MODE == STATES) {
            buf[k][j] = st;
          } else {
            const unsigned t = (unsigned)(st - 1);
            if ((unsigned)(rel - lo[k]) < (unsigned)len[k] && t < (unsigned)a.n_term)
              atomicAdd(hist + t, 1);
          }
        }
      }
      if (MODE == STATES) {
        // the chunk's 16 states: four 16-byte stores, two whole 32-byte
        // sectors, where the lane owns all 16 positions
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int r0 = CHUNK * c;
          int* dst = a.out + S0 + offs[k] + r0;
          if ((unsigned)(r0 - lo[k]) < (unsigned)len[k] &&
              (unsigned)(r0 + CHUNK - 1 - lo[k]) < (unsigned)len[k]) {
#pragma unroll
            for (int q = 0; q < CHUNK / 4; ++q)
              reinterpret_cast<int4*>(dst)[q] =
                  make_int4(buf[k][4 * q], buf[k][4 * q + 1], buf[k][4 * q + 2], buf[k][4 * q + 3]);
          } else {
#pragma unroll
            for (int q = 0; q < CHUNK; ++q)
              if ((unsigned)(r0 + q - lo[k]) < (unsigned)len[k]) dst[q] = buf[k][q];
          }
        }
      }
    };
    for (int c = 0; c < nmax; ++c) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (c + 1 < nch[k]) nxt[k] = load(k, c + 1);
      if (c == 0)
        walk(c, std::integral_constant<bool, true>());
      else
        walk(c, std::integral_constant<bool, false>());
#pragma unroll
      for (int k = 0; k < K; ++k) cur[k] = nxt[k];
    }
  }
  if (MODE == COUNTS_SHARED && cur_row >= 0) {
    __syncthreads();
    flush(cur_row);
  }
}

struct Choice {
  bool tab;
  int mode, lanes, threads;
  bool one_block;  // one block an SM, the rest of its 256 KB left to L1
};

template <typename TabT, bool TAB, int MODE, int K>
int launch(const Args& a, const Choice& c, size_t smem, int nsm, int* config, cudaStream_t st,
           bool run) {
  auto kernel = acscan_kernel<TabT, TAB, MODE, K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  // the smallest shared-memory carveout (percent of 228 KB) that holds one
  // block and its 1 KB reserve, or the CUDA runtime's own choice
  const int carveout = c.one_block ? (int)(((long long)smem + 1024) * 100 / (228 * 1024) + 1) : -1;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               carveout > 100 ? 100 : carveout);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, c.threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (c.one_block) per_sm = 1;
  if (!run) return 0;
  (void)cudaGetLastError();  // a refused candidate's error is not this launch's
  Args args = a;
  args.tiles_row = (a.lanes_row + (long long)c.threads * K - 1) / ((long long)c.threads * K);
  const long long tiles = a.B * args.tiles_row;
  const long long cap = (long long)per_sm * nsm;
  const int grid = (int)(tiles < cap ? tiles : cap);
  kernel<<<grid, c.threads, smem, st>>>(args);
  if (config != nullptr) {
    const int vals[] = {TAB, MODE, K, c.threads, grid, (int)smem, per_sm, (int)sizeof(TabT),
                        c.one_block};
    for (int i = 0; i < 9; ++i) config[i] = vals[i];
  }
  return (int)cudaGetLastError();
}

template <typename TabT, bool TAB, int MODE>
int by_lanes(const Args& a, const Choice& c, size_t smem, int nsm, int* config, cudaStream_t st,
             bool run) {
  if (c.lanes == 4) return launch<TabT, TAB, MODE, 4>(a, c, smem, nsm, config, st, run);
  return launch<TabT, TAB, MODE, 1>(a, c, smem, nsm, config, st, run);
}

template <typename TabT, bool TAB>
int by_mode(const Args& a, const Choice& c, size_t smem, int nsm, int* config, cudaStream_t st,
            bool run) {
  if (c.mode == COUNTS_SHARED)
    return by_lanes<TabT, TAB, COUNTS_SHARED>(a, c, smem, nsm, config, st, run);
  if (c.mode == COUNTS_GLOBAL)
    return by_lanes<TabT, TAB, COUNTS_GLOBAL>(a, c, smem, nsm, config, st, run);
  return by_lanes<TabT, TAB, STATES>(a, c, smem, nsm, config, st, run);
}

template <typename TabT>
int dispatch(const Args& a, const Choice& c, size_t smem, int nsm, int* config, cudaStream_t st,
             bool run) {
  if (c.tab) return by_mode<TabT, true>(a, c, smem, nsm, config, st, run);
  return by_mode<TabT, false>(a, c, smem, nsm, config, st, run);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take (including a
// forced variant that does not fit).
// text: B rows of n bytes, 16-byte aligned; classes: 256 int32 class ids
// (< ncls); table: the flat (n_cells / ncls, ncls) table, tab_bytes = 2
// (uint16) or 4 (int32) an entry; ov = max_m - 1.
// counts = 0: out is B*n int32 states (ids of the table given).
// counts = 1: out is the zeroed B*n_term int32 histogram of states
// 1..n_term at positions end_min <= i < lengths[b] (lengths: B int64).
// force_table (0 global, 1 shared), force_hist (1 shared, 2 global),
// force_lanes (1, 4), force_threads (32..1024, a multiple of 32):
// -1 lets the launcher choose.  one_block = 1 runs one block an SM and sets
// the smallest shared-memory carveout that holds it, so L1 gets the rest (0
// does not, -1 lets the launcher choose).
// config (host, 9 ints): table in shared, mode (0 states, 1 counts in
// shared, 2 counts in global), lanes a thread, threads a block, grid, dynamic
// shared bytes, blocks an SM, table bytes an entry, one_block.
// Requires n >= 1, B >= 1, seg >= 1.
extern "C" int acscan_launch(const uint8_t* text, long long B, long long n, const int* classes,
                             const void* table, long long tab_bytes, long long n_cells,
                             long long ncls, long long ov, long long seg, int counts,
                             long long n_term, const long long* lengths, long long end_min,
                             int force_table, int force_hist, int force_lanes, int force_threads,
                             int one_block, int* out, int* config, void* stream) {
  if (B < 1 || n < 1 || ncls < 1 || ncls > 257 || n_cells < ncls || n_cells % ncls != 0 ||
      n_cells > (1LL << 25) || ov < 0 || ov >= (1LL << 21) || seg < 1 || seg >= (1LL << 21) ||
      (tab_bytes != 2 && tab_bytes != 4) || (counts && (n_term < 1 || n_term >= (1LL << 26))) ||
      (counts && lengths == nullptr) || (reinterpret_cast<uintptr_t>(text) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, smem_max = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  int l2_bytes = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&l2_bytes, cudaDevAttrL2CacheSize, dev);
  if (err != cudaSuccess) return (int)err;

  Args a;
  a.text = text;
  a.B = B;
  a.n = n;
  a.classes = classes;
  a.table = table;
  a.n_cells = n_cells;
  a.ncls = (int)ncls;
  a.ov = (int)ov;
  a.seg = (int)seg;
  a.n_term = counts ? (int)n_term : 0;
  a.lengths = lengths;
  a.end_min = end_min;
  a.lanes_row = (n + seg - 1) / seg;
  a.tiles_row = 1;
  a.out = out;

  const long long table_smem = round16ll(tab_bytes * n_cells);
  const long long hist_smem = round16ll(4 * n_term);
  // Preference (chip_smoke.py timing, H100): in the counts mode the table in
  // shared memory, in the states mode in global memory (its stores, not the
  // table, take the time, and a shared table halves the threads an SM
  // holds); the histogram in shared memory (one global atomic a hit was
  // slower on every main-path shape, the 65536-byte rows of the batch
  // included); 1 lane a thread over 4 (4 need ~110 registers, so an SM
  // holds no more chains), but 4 in the counts mode for a table larger than
  // L2, whose HBM latency more chains hide (bench_dictionary's 71.5 MB
  // table); the widest block that the rows and the SMs keep busy (fewer,
  // wider blocks flush the histogram less often); in the counts mode with
  // the table in global memory and blocks of 512 or more, one block an SM.
  const int modes[2] = {counts ? COUNTS_SHARED : STATES, counts ? COUNTS_GLOBAL : -1};
  const int tab_opts[2] = {counts ? 1 : 0, counts ? 0 : 1};
  const bool in_hbm = counts && tab_bytes * n_cells > l2_bytes;
  const int lanes_opts[2] = {in_hbm ? 4 : 1, in_hbm ? 1 : 4};
  const int thread_opts[6] = {1024, 512, 256, 128, 64, 32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int tab : tab_opts) {
    if (force_table >= 0 && tab != force_table) continue;
    for (int mode : modes) {
      if (mode < 0 || (force_hist >= 0 && counts && mode != force_hist)) continue;
      for (int lanes : lanes_opts) {
        if (force_lanes >= 0 && lanes != force_lanes) continue;
        for (int threads : thread_opts) {
          if ((force_threads >= 0 && threads != force_threads) || threads > max_threads(lanes))
            continue;
          // unless forced or the last option: no tile more than half idle (a
          // row narrower than the tile), and tiles for at least half the SMs
          // (a short single row spread over few SMs is slower)
          const long long tile = (long long)threads * lanes;
          if (force_threads < 0 && threads > 32 &&
              (tile > 2 * a.lanes_row || 2 * B * ((a.lanes_row + tile - 1) / tile) < nsm))
            continue;
          // a tile's span must fit the kernel's 32-bit offsets
          if ((long long)threads * lanes * seg + ov + 4 * CHUNK >= (1LL << 31)) continue;
          const long long smem = CMAP_BYTES + (tab ? table_smem : 0) +
                                 (mode == COUNTS_SHARED ? hist_smem : 0);
          if (smem > smem_max) continue;
          // one block an SM leaves L1 the most room for a table in global
          // memory; it pays only for wide blocks
          const bool one = one_block >= 0 ? one_block > 0 : counts && tab == 0 && threads >= 512;
          const Choice c{tab == 1, mode, lanes, threads, one};
          // the occupancy check first: a block that cannot be resident is skipped
          const int ok = tab_bytes == 2
                             ? dispatch<uint16_t>(a, c, (size_t)smem, nsm, config, st, false)
                             : dispatch<int>(a, c, (size_t)smem, nsm, config, st, false);
          if (ok != 0) continue;
          return tab_bytes == 2 ? dispatch<uint16_t>(a, c, (size_t)smem, nsm, config, st, true)
                                : dispatch<int>(a, c, (size_t)smem, nsm, config, st, true);
        }
      }
    }
  }
  return (int)cudaErrorInvalidValue;
}
