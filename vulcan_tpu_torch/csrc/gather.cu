// T2-T4: chained per-column gather rounds for Hopper (sm_90a).
//
// Replaces the TPU probes of tools/bench_pallas_gather.py: run_pallas (T2,
// f32 table (2048, 128), 32 rounds), run_pallas_i (T3, the same on an int32
// table) and run_pallas2 (T4, f32 table (16384, 128), 4 rounds).  For every
// element (i, j) of idx, in one launch, with idx and the sum in registers:
//   for k in 0 .. rounds-1:
//     v = table[idx, j];  idx = |idx + int(v) + k| % T;  acc = acc + v
// int(v) truncates toward zero (__float2int_rz, as astype(int32) does), the
// remainder is taken of a non-negative int, and acc adds in round order with
// __fadd_rn (int32 adds wrap): bit-exact against the plain version.  idx
// must hold entries in [0, T) on entry; every later index is in range.
//
// What bounds it on the card.  T2/T3 move 3 MB (table, idx, out; 0.94 us at
// the H100 SXM's 3.35 TB/s) and make 8.4M lookups; served from shared
// memory at one 4-byte word per bank per clock (32 banks x 132 SMs x
// 1.98 GHz = 8.4T lookups/s) the lookups take 1.0 us.  T4 moves 25 MB
// (7.5 us at HBM rate) and makes 8.4M lookups into an 8 MB table.  A
// lookup is 4 bytes at a random row, and L2 serves a 32-byte sector for it:
// read through L2, T4's lookups pull 268 MB over the L2-to-SM fabric for
// 33.5 MB used, and the kernel sits at that fabric's sector rate, nine
// times its bound.  So the table has to be on chip, as the TPU kernel had it
// in VMEM: the card's shared memory holds 30 MB, only not in one block.
//
// Design, one path per table height:
//   * smem path (T2/T3, T <= 2048 rows): the gather runs down a column, so a
//     block stages the columns it owns, whole, in shared memory and runs its
//     slab of rows through every round there.  A row of the block's shared
//     memory is always 16 words (2048 x 16 x 4 B = 128 KB, one block per SM):
//     a block owns C columns (2..16, ops/cuda_kernels.py smem_plan) and keeps
//     16 / C copies of each, word (copy q, row r, column j) at r * 16 +
//     q * C + j.  Lane l of a warp reads word l mod 16 of a row, so lane l
//     and lane l + 16 collide only when their random rows share parity (bank
//     = l mod 16 + 16 (r mod 2)): 1.5 wavefronts a request on average, for
//     every C.  The conflict-free layout (32 words a row) would need 256 KB.
//     What C trades is the staging: L / C column groups x SMs / (L / C) row
//     slabs fill the card, and every slab of a group pulls the group's
//     columns from L2 again, 128 KB a block at C = 16 (16 MB in all for the
//     1 MB table), 64 KB at C = 8; below 8 a row's piece is under one
//     32-byte sector and nothing more is saved.  Measured, C = 16 and C = 8
//     tie and fewer lose: half the bytes arrive as one 32-byte piece of
//     every 128-byte line, which L2 serves more slowly than 64-byte pieces,
//     and idx and out then move as 32-byte pieces too.  C = 16 (one copy) is
//     the plan's choice (PERF.md has the table).  The staging is 16-byte
//     loads, all of a thread's in flight together, each stored to every
//     copy; idx is loaded before it, so that trip runs under the staging.
//     The blocks of a
//     thread-block cluster (row slabs of one group) can share one staging
//     pass, each loading a part and writing it to all with 16-byte
//     st.shared::cluster stores: kept as a measured variant, not the
//     default, because the SM-to-SM network takes those stores more slowly
//     than L2 serves the loads they save.  A lookup is 7 instructions for
//     float32 (address, LDS, F2I, a three-input add, IABS, mask, FADD), 6 for
//     int32; a round takes as long on 16 rows of idx as on 2048, so what
//     bounds the lookup phase is the latency of one warp's dependent chain,
//     not the rate the instructions issue at or the banks.
//   * columns path (T4, while one whole column fits a block's 227 KB;
//     16384 x 4 B = 64 KB a column): a block holds 2 whole columns (1 where 2
//     do not fit) in its shared memory, staged from L2 in 8-byte pieces, and
//     runs every row of its slab through all rounds there, idx and the sum in
//     registers; 64 column pairs x 2 row slabs fill 128 SMs.  Every lookup is
//     a shared-memory load: 32 random rows of a column put about 3.5 lanes
//     on the worst bank.  What bounds it now is the other side: idx, out and
//     the staging move as 8-byte pieces of 32-byte sectors, 4.2M sector
//     requests (128 MB) for the 32 MB used, and the L2-to-SM fabric serves
//     about 0.4 sectors a clock an SM.  The same
//     kernel also runs as a thread-block cluster that owns a group of up to
//     16 adjacent columns in distributed shared memory (a block then reads
//     idx and writes out as whole row segments of the group, and a lookup
//     goes to the block that holds the column: mapa + ld.shared::cluster,
//     with a cluster barrier before the first remote access, after staging
//     and before exit).  That form is kept as a measured variant, not as the
//     default: 4 random bytes a request is the worst case for the SM-to-SM
//     network, and it runs several times slower than the L2 path
//     (tools/bench_gather.py variant_times; PERF.md has the table).  The
//     partition (columns a block, blocks a cluster, row slabs) is computed
//     by ops/cuda_kernels.py gather_plan and passed in.
//   * L2 path (taller tables, and the yardstick of the card's gather rate
//     from L2, which is what integrate and ICP see with tables far larger
//     than shared memory): every lookup is an __ldg.
// All keep independent chains in every thread (2 on the smem path, where a
// round is bound by the latency of one warp's chains and 32 warps of 2 hide
// it better than 16 of 4; 8 on the others) so the dependent load -> index -> load sequence of one chain
// overlaps the others.  T must be a power of two (the remainder is a mask),
// L a multiple of 16 and the table 16-byte aligned; the binding checks all
// three (ops/cuda_kernels.py).
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kThreads = 256;    // L2 path
constexpr int kChains = 8;       // L2 path: independent elements a thread
constexpr int kSmemThreads = 1024;
constexpr int kSmemChains = 2;   // independent elements a thread
constexpr int kSmemCols = 16;    // (copy, column) pairs a row of a smem-path block holds
constexpr int kColumnsThreads = 512;
constexpr int kColumnsChains = 8;
constexpr int kMaxGroupCols = 16;   // columns a cluster owns at most
constexpr int kBlockBytes = 232448; // shared memory one block may use

__device__ __forceinline__ int to_int(float v) { return __float2int_rz(v); }
__device__ __forceinline__ int to_int(int v) { return v; }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// |idx + vi + k| % t in wrapping int32 arithmetic, as the reference's
// jnp.abs(...) % T, for a power-of-two t: one three-input add, one absolute
// value (the most negative int stays itself, as in the reference, and its
// low bits are 0) and one mask.
__device__ __forceinline__ int next_index(int idx, int vi, int k, int t) {
  const int s = static_cast<int>(static_cast<unsigned>(idx) +
                                 static_cast<unsigned>(vi) +
                                 static_cast<unsigned>(k));
  int a;
  asm("abs.s32 %0, %1;" : "=r"(a) : "r"(s));
  return a & (t - 1);
}

// Shared-memory words by 32-bit shared-window address: the same code serves
// a block's own memory (kCluster = false) and the cluster's (true).
__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool kCluster>
__device__ __forceinline__ uint32_t owner_address(uint32_t addr, uint32_t rank) {
  if constexpr (kCluster) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(addr), "r"(rank));
    return remote;
  } else {
    return addr;
  }
}

template <bool kCluster>
__device__ __forceinline__ uint32_t load_word(uint32_t addr) {
  uint32_t v;
  if constexpr (kCluster) {
    asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  } else {
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  }
  return v;
}

template <bool kCluster>
__device__ __forceinline__ void store_word(uint32_t addr, uint32_t v) {
  if constexpr (kCluster) {
    asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v));
  } else {
    asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v));
  }
}

template <bool kCluster>
__device__ __forceinline__ void store_quad(uint32_t addr, uint4 q) {
  if constexpr (kCluster) {
    asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
                 "r"(q.x), "r"(q.y), "r"(q.z), "r"(q.w));
  } else {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
                 "r"(q.x), "r"(q.y), "r"(q.z), "r"(q.w));
  }
}

template <bool kCluster>
__device__ __forceinline__ void sync_owners() {
  if constexpr (kCluster) {
    asm volatile("barrier.cluster.arrive.release;\n"
                 "barrier.cluster.wait.acquire;" ::: "memory");
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ float from_word(uint32_t w, float) { return __uint_as_float(w); }
__device__ __forceinline__ int from_word(uint32_t w, int) { return static_cast<int>(w); }

// The smem path.  Grid (row slabs, column groups); cluster (cb, 1, 1), cb = 1
// (kCluster = false) being a plain launch.  A block owns C = 2^kLogC (2..16)
// adjacent columns of the table and keeps 16 / C copies of each: word (copy
// q, row r, column j) at r * 16 + q * C + j, so a row of shared memory is 16
// "virtual columns", one per lane of a half-warp, whatever C is.  The blocks
// of a cluster are row slabs of one column group and need the same words:
// each loads 1 / cb of the table's rows and writes them to every block of
// the cluster.  A block's elements are rows [slab) x C columns of idx, row
// major; 1024 % C == 0, so a thread keeps its column through every pass.
template <typename V, int kLogC, bool kCluster>
__global__ void __launch_bounds__(kSmemThreads)
gather_smem_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                   V* __restrict__ out, int n, int t, int l, int rounds,
                   int rows_per_slab, int log_cb) {
  constexpr int kC = 1 << kLogC;
  static_assert(kC >= 2 && kC <= kSmemCols, "a block owns 2 to 16 columns");
  constexpr int kPieces = kC >= 4 ? kC / 4 : 1;  // 16-byte pieces of a row's C columns
  constexpr int kLogPieces = kC >= 4 ? kLogC - 2 : 0;
  constexpr int kQuads = 4 / kPieces;            // 16-byte stores a piece: the copies
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c0 = blockIdx.y * kC;
  const int r_begin = min(n, static_cast<int>(blockIdx.x) * rows_per_slab);
  const int r_end = min(n, r_begin + rows_per_slab);
  const int elems = (r_end - r_begin) << kLogC;
  // element e of the block (e = threadIdx.x mod C) is word at[e >> kLogC rows down]
  const size_t at0 = static_cast<size_t>(r_begin) * l + c0 + (threadIdx.x & (kC - 1));

  // The first pass's indices, asked for before the staging so that their
  // trip to memory runs under it.
  int id[kSmemChains];
#pragma unroll
  for (int m = 0; m < kSmemChains; ++m) {
    const int e = threadIdx.x + m * kSmemThreads;
    id[m] = e < elems ? idx[at0 + static_cast<size_t>(e >> kLogC) * l] : 0;
  }

  if constexpr (kCluster) sync_owners<true>();  // every block of the cluster has started

  // Staging: 16-byte loads, all of a thread's in flight together.  A piece
  // goes to every copy; the copy a store starts with turns with the row
  // pair, so that the 8 lanes of a 16-byte store phase cover all 32 banks.
  // A thread's rows lie kRowStep apart, a multiple of 8, so its piece and its
  // turn are the same in every pass and a pass is one load and its stores.
  constexpr int kRowStep = kSmemThreads >> kLogPieces;
  static_assert(kRowStep % 8 == 0, "the turn must not change from pass to pass");
  const uint32_t base = smem_address(smem_raw);
  const int t_rows = t >> log_cb;
  const int tr0 = kCluster ? static_cast<int>(blockIdx.x & ((1u << log_cb) - 1u)) * t_rows : 0;
  const int row0 = tr0 + (threadIdx.x >> kLogPieces);
  const int piece = threadIdx.x & (kPieces - 1);
  uint32_t dst[kQuads];
#pragma unroll
  for (int s = 0; s < kQuads; ++s) {
    const int turn = (s + (row0 >> 1)) & (kQuads - 1);
    dst[s] = base + 4u * (row0 * kSmemCols + (kC >= 4 ? turn * kC + piece * 4 : turn * 4));
  }
  const uint32_t* from = reinterpret_cast<const uint32_t*>(table) +
                         static_cast<size_t>(row0) * l + c0 + piece * 4;
#pragma unroll 8
  for (int row = row0; row < tr0 + t_rows; row += kRowStep) {
    uint4 q;
    if constexpr (kC >= 4) {
      q = __ldg(reinterpret_cast<const uint4*>(from));
    } else {
      const uint2 h = __ldg(reinterpret_cast<const uint2*>(from));
      q = make_uint4(h.x, h.y, h.x, h.y);
    }
    const uint32_t off = static_cast<uint32_t>(row - row0) * (kSmemCols * 4);
#pragma unroll
    for (int s = 0; s < kQuads; ++s) {
      if constexpr (kCluster) {
        for (uint32_t b = 0; b < (1u << log_cb); ++b) {
          store_quad<true>(owner_address<true>(dst[s] + off, b), q);
        }
      } else {
        store_quad<false>(dst[s] + off, q);
      }
    }
    from += static_cast<size_t>(kRowStep) * l;
  }
  sync_owners<kCluster>();

  // A lookup is one address (the lane's word of row id), one load, the next
  // index and the sum.
  const uint32_t lane_word = base + 4u * (threadIdx.x & (kSmemCols - 1));
  for (int e0 = threadIdx.x;;) {
    V acc[kSmemChains];
#pragma unroll
    for (int m = 0; m < kSmemChains; ++m) acc[m] = V(0);
    for (int k = 0; k < rounds; ++k) {
#pragma unroll
      for (int m = 0; m < kSmemChains; ++m) {
        const V v = from_word(
            load_word<false>(lane_word + static_cast<uint32_t>(id[m]) * (kSmemCols * 4)), V());
        id[m] = next_index(id[m], to_int(v), k, t);
        acc[m] = add(acc[m], v);
      }
    }
#pragma unroll
    for (int m = 0; m < kSmemChains; ++m) {
      const int e = e0 + m * kSmemThreads;
      if (e < elems) out[at0 + static_cast<size_t>(e >> kLogC) * l] = acc[m];
    }
    e0 += kSmemThreads * kSmemChains;
    if (e0 >= elems) break;
#pragma unroll
    for (int m = 0; m < kSmemChains; ++m) {
      const int e = e0 + m * kSmemThreads;
      id[m] = e < elems ? idx[at0 + static_cast<size_t>(e >> kLogC) * l] : 0;
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_l2_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                 V* __restrict__ out, int n, int t, int l, int rounds) {
  const size_t total = static_cast<size_t>(n) * l;
  const size_t base =
      static_cast<size_t>(blockIdx.x) * kThreads * kChains + threadIdx.x;
  int id[kChains];
  int col[kChains];
  V acc[kChains];
#pragma unroll
  for (int m = 0; m < kChains; ++m) {
    const size_t e = base + static_cast<size_t>(m) * kThreads;
    const bool live = e < total;
    id[m] = live ? idx[e] : 0;
    col[m] = live ? static_cast<int>(e % l) : 0;
    acc[m] = V(0);
  }
  for (int k = 0; k < rounds; ++k) {
#pragma unroll
    for (int m = 0; m < kChains; ++m) {
      const V v = __ldg(&table[static_cast<size_t>(id[m]) * l + col[m]]);
      id[m] = next_index(id[m], to_int(v), k, t);
      acc[m] = add(acc[m], v);
    }
  }
#pragma unroll
  for (int m = 0; m < kChains; ++m) {
    const size_t e = base + static_cast<size_t>(m) * kThreads;
    if (e < total) out[e] = acc[m];
  }
}

// The columns path.  Grid (column groups x blocks a cluster, row slabs);
// cluster (cb, 1, 1), cb = 1 (kCluster = false) being a plain launch.  Block
// `rank` of a cluster holds columns [c0 + rank * cpb, + cpb) of the group
// that starts at c0, whole, planar (word (r, c) at c * t + r) or interleaved
// (at r * cpb + c), takes an equal share of the slab's rows across all of the
// group's columns, and looks each index up in the shared memory of the block
// that holds the column.
template <typename V, bool kCluster>
__global__ void __launch_bounds__(kColumnsThreads)
gather_columns_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                      V* __restrict__ out, int n, int t, int l, int rounds,
                      int log_cpb, int log_cb, int rows_per_slab,
                      int interleaved) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_address(smem_raw);
  const int rows_per_block = (rows_per_slab + (1 << log_cb) - 1) >> log_cb;
  const int log_g = log_cpb + log_cb;
  const int cpb_mask = (1 << log_cpb) - 1;
  const uint32_t rank = blockIdx.x & ((1u << log_cb) - 1u);
  const int c0 = static_cast<int>(blockIdx.x >> log_cb) << log_g;
  const uint32_t col_bytes = interleaved ? 4u : static_cast<uint32_t>(t) * 4u;
  const int row_shift = interleaved ? 2 + log_cpb : 2;

  if constexpr (kCluster) sync_owners<true>();  // every block has started

  // Stage this block's share of the table's rows, each word to its owner.
  const int t_rows = t >> log_cb;
  const int tr0 = static_cast<int>(rank) * t_rows;
  if (log_g >= 2) {
    const int log_v = log_g - 2;                 // 16-byte chunks a row
    const int v = threadIdx.x & ((1 << log_v) - 1);
    uint32_t dst[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int g = 4 * v + k;
      dst[k] = owner_address<kCluster>(base + (g & cpb_mask) * col_bytes,
                                       static_cast<uint32_t>(g >> log_cpb));
    }
    const uint4* src = reinterpret_cast<const uint4*>(table + c0) + v;
    const size_t row4 = static_cast<size_t>(l / 4);
#pragma unroll 4
    for (int e = threadIdx.x; e < (t_rows << log_v); e += kColumnsThreads) {
      const int tr = tr0 + (e >> log_v);
      const uint4 q = __ldg(src + tr * row4);
      const uint32_t off = static_cast<uint32_t>(tr) << row_shift;
      store_word<kCluster>(dst[0] + off, q.x);
      store_word<kCluster>(dst[1] + off, q.y);
      store_word<kCluster>(dst[2] + off, q.z);
      store_word<kCluster>(dst[3] + off, q.w);
    }
  } else {
    const int g = threadIdx.x & ((1 << log_g) - 1);
    const uint32_t dst = owner_address<kCluster>(
        base + (g & cpb_mask) * col_bytes, static_cast<uint32_t>(g >> log_cpb));
    const uint32_t* src = reinterpret_cast<const uint32_t*>(table) + c0 + g;
#pragma unroll 8
    for (int e = threadIdx.x; e < (t_rows << log_g); e += kColumnsThreads) {
      const int tr = tr0 + (e >> log_g);
      store_word<kCluster>(dst + (static_cast<uint32_t>(tr) << row_shift),
                           __ldg(src + static_cast<size_t>(tr) * l));
    }
  }
  sync_owners<kCluster>();

  // kColumnsThreads is a multiple of the group's width: a thread keeps its
  // column, and with it the block it asks, through every pass.
  const int g = threadIdx.x & ((1 << log_g) - 1);
  const uint32_t col = owner_address<kCluster>(
      base + (g & cpb_mask) * col_bytes, static_cast<uint32_t>(g >> log_cpb));
  const long long slab0 = static_cast<long long>(blockIdx.y) * rows_per_slab;
  const int slab_end = static_cast<int>(min(static_cast<long long>(n), slab0 + rows_per_slab));
  const int r_begin = static_cast<int>(
      min(static_cast<long long>(slab_end), slab0 + static_cast<long long>(rank) * rows_per_block));
  const int r_end = min(slab_end, r_begin + rows_per_block);
  const int elems = (r_end - r_begin) << log_g;
  for (int e0 = threadIdx.x; e0 < elems; e0 += kColumnsThreads * kColumnsChains) {
    int id[kColumnsChains];
    V acc[kColumnsChains];
    size_t at[kColumnsChains];
#pragma unroll
    for (int m = 0; m < kColumnsChains; ++m) {
      const int e = e0 + m * kColumnsThreads;
      at[m] = static_cast<size_t>(r_begin + (e >> log_g)) * l + c0 + g;
      id[m] = e < elems ? idx[at[m]] : 0;
      acc[m] = V(0);
    }
    for (int k = 0; k < rounds; ++k) {
#pragma unroll
      for (int m = 0; m < kColumnsChains; ++m) {
        const V v = from_word(
            load_word<kCluster>(col + (static_cast<uint32_t>(id[m]) << row_shift)), V());
        id[m] = next_index(id[m], to_int(v), k, t);
        acc[m] = add(acc[m], v);
      }
    }
#pragma unroll
    for (int m = 0; m < kColumnsChains; ++m) {
      if (e0 + m * kColumnsThreads < elems) out[at[m]] = acc[m];
    }
  }
  if constexpr (kCluster) sync_owners<true>();  // no block leaves while it is read
}

struct Plan {          // ops/cuda_kernels.py SmemPlan (interleaved 0) or GatherPlan
  int cols_per_block;
  int cluster_blocks;
  int row_slabs;
  int rows_per_slab;
  int interleaved;
};

int log2_exact(int v) {  // -1 unless v is a power of two
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return (v > 0 && (1 << lg) == v) ? lg : -1;
}

enum Path { kPathSmem = 0, kPathColumns = 1, kPathL2 = 2 };  // GATHER_PATHS

template <typename V, bool kCluster>
const void* smem_kernel(int log_c) {
  switch (log_c) {
    case 1: return reinterpret_cast<const void*>(gather_smem_kernel<V, 1, kCluster>);
    case 2: return reinterpret_cast<const void*>(gather_smem_kernel<V, 2, kCluster>);
    case 3: return reinterpret_cast<const void*>(gather_smem_kernel<V, 3, kCluster>);
    default: return reinterpret_cast<const void*>(gather_smem_kernel<V, 4, kCluster>);
  }
}

// One launch of the smem or the columns path under `p`: kernel, grid,
// threads, shared memory and cluster size.
struct Launch {
  const void* kernel;
  dim3 grid;
  int threads;
  size_t smem;
  int cluster_blocks;
};

template <typename V>
Launch launch_of(int path, int t, int l, const Plan& p) {
  const bool cluster = p.cluster_blocks > 1;
  if (path == kPathSmem) {
    const int log_c = log2_exact(p.cols_per_block);
    return {cluster ? smem_kernel<V, true>(log_c) : smem_kernel<V, false>(log_c),
            dim3(p.row_slabs, l >> log_c), kSmemThreads,
            static_cast<size_t>(t) * kSmemCols * sizeof(V), p.cluster_blocks};
  }
  return {cluster ? reinterpret_cast<const void*>(gather_columns_kernel<V, true>)
                  : reinterpret_cast<const void*>(gather_columns_kernel<V, false>),
          dim3(l / (p.cols_per_block * p.cluster_blocks) * p.cluster_blocks, p.row_slabs),
          kColumnsThreads, static_cast<size_t>(t) * p.cols_per_block * sizeof(V),
          p.cluster_blocks};
}

// Once a kernel and device, not once a launch: let the kernel use all of a
// block's shared memory and any cluster size the card takes.
cudaError_t allow_all(const void* kernel) {
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({dev, kernel})) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBlockBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) done.insert({dev, kernel});
  return err;
}

cudaError_t configure(const Launch& lc, cudaStream_t s, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = lc.cluster_blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = lc.grid;
  cfg->blockDim = dim3(lc.threads);
  cfg->dynamicSmemBytes = lc.smem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = lc.cluster_blocks > 1 ? 1 : 0;
  return allow_all(lc.kernel);
}

// The smem path: a block owns cols_per_block (2..16) adjacent columns and a
// slab of rows; the blocks of a cluster are row slabs of one column group.
bool smem_plan_ok(int n, int t, const Plan& p) {
  return log2_exact(p.cols_per_block) >= 1 && p.cols_per_block <= kSmemCols &&
         log2_exact(p.cluster_blocks) >= 0 && p.cluster_blocks <= 8 &&
         p.cluster_blocks <= t && p.row_slabs >= 1 &&
         p.row_slabs % p.cluster_blocks == 0 && p.rows_per_slab >= 1 &&
         static_cast<long long>(t) * kSmemCols * 4 <= kBlockBytes &&
         static_cast<long long>(p.rows_per_slab) * p.row_slabs >= n;
}

bool columns_plan_ok(int n, int t, const Plan& p) {
  return log2_exact(p.cols_per_block) >= 0 && log2_exact(p.cluster_blocks) >= 0 &&
         p.cols_per_block * p.cluster_blocks <= kMaxGroupCols &&
         p.cluster_blocks <= t && p.row_slabs >= 1 && p.rows_per_slab >= 1 &&
         static_cast<long long>(t) * p.cols_per_block * 4 <= kBlockBytes &&
         static_cast<long long>(p.rows_per_slab) * p.row_slabs >= n;
}

bool plan_ok(int path, int n, int t, const Plan& p) {
  return path == kPathSmem ? smem_plan_ok(n, t, p)
                           : path != kPathColumns || columns_plan_ok(n, t, p);
}

template <typename V>
cudaError_t launch(const void* table, const int* idx, void* out, int n, int t,
                   int l, int rounds, int path, const Plan& p, cudaStream_t s) {
  const V* tb = static_cast<const V*>(table);
  V* o = static_cast<V*>(out);
  if (path == kPathL2) {
    const size_t total = static_cast<size_t>(n) * l;
    const size_t per_block = static_cast<size_t>(kThreads) * kChains;
    const unsigned blocks =
        static_cast<unsigned>((total + per_block - 1) / per_block);
    gather_l2_kernel<V><<<blocks, kThreads, 0, s>>>(tb, idx, o, n, t, l,
                                                  rounds);
    return cudaGetLastError();
  }
  const Launch lc = launch_of<V>(path, t, l, p);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = configure(lc, s, &cfg, &attr);
  if (err != cudaSuccess) return err;
  int log_cpb = log2_exact(p.cols_per_block);
  int log_cb = log2_exact(p.cluster_blocks);
  int rows_per_slab = p.rows_per_slab;
  int interleaved = p.interleaved;
  void* smem_args[] = {&tb, &idx, &o, &n, &t, &l, &rounds, &rows_per_slab, &log_cb};
  void* columns_args[] = {&tb, &idx, &o, &n, &t, &l, &rounds, &log_cpb,
                          &log_cb, &rows_per_slab, &interleaved};
  return cudaLaunchKernelExC(&cfg, lc.kernel,
                             path == kPathSmem ? smem_args : columns_args);
}

}  // namespace

// table: (t, l) float32 (is_int = 0) or int32 (is_int = 1), t a power of
// two, l a multiple of 16, 16-byte aligned; idx: (n, l) int32 in [0, t);
// out: (n, l) of the table's type.  path (the index in GATHER_PATHS): 0
// stages cols_per_block columns a block, 16 / cols_per_block copies of each,
// in shared memory (t * 16 * 4 bytes must fit a block; cluster_blocks row
// slabs of a column group share one staging pass), 1 holds whole columns in a
// block's or a cluster's shared memory (cols_per_block .. interleaved), 2
// reads the table through L2 and takes no plan.  A plan is refused unless it
// is consistent, fits a block and covers every row.  Returns the launch's
// error: a launch the card refuses is not tried another way.
extern "C" int vulcan_chained_gather(const void* table, const int* idx,
                                     void* out, int n, int t, int l,
                                     int rounds, int is_int, int path,
                                     int cols_per_block, int cluster_blocks,
                                     int row_slabs, int rows_per_slab,
                                     int interleaved, void* stream) {
  if (n < 0 || t <= 0 || (t & (t - 1)) != 0 || l <= 0 || l % kSmemCols != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 || rounds < 0 ||
      path < kPathSmem || path > kPathL2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan = {cols_per_block, cluster_blocks, row_slabs, rows_per_slab,
                     interleaved != 0};
  if (!plan_ok(path, n, t, plan)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_int ? launch<int>(table, idx, out, n, t, l, rounds, path, plan, s)
             : launch<float>(table, idx, out, n, t, l, rounds, path, plan, s);
  return static_cast<int>(err);
}

// How many clusters of the float32 kernel of `path` (0 or 1) the card runs
// at once under this plan (cudaOccupancyMaxActiveClusters; the GPCs of a
// part are not all the same size), or minus the error.  A plan of more
// clusters runs in waves.
extern "C" int vulcan_gather_max_clusters(int path, int t, int l,
                                          int cols_per_block, int cluster_blocks,
                                          int row_slabs, int rows_per_slab) {
  const Plan plan = {cols_per_block, cluster_blocks, row_slabs, rows_per_slab, 0};
  if (t <= 0 || l <= 0 || (path != kPathSmem && path != kPathColumns) ||
      !plan_ok(path, 0, t, plan) || cluster_blocks < 2) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch lc = launch_of<float>(path, t, l, plan);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(lc, nullptr, &cfg, &attr);
  int clusters = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&clusters, lc.kernel, &cfg);
  }
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}
