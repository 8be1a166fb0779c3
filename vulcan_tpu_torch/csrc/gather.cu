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
//     block stages the 16 columns it owns, whole, in shared memory (2048 x
//     16 x 4 B = 128 KB, one block per SM) and runs its rows through every
//     round there.  Layout col[r * 16 + c]: lane c and lane c + 16 of a warp
//     serve column c on two rows, bank = c + 16 (r mod 2), so they collide
//     only when their random rows share parity: 1.5 wavefronts a request on
//     average.  The conflict-free layout (32 columns a block, one per lane)
//     would need 256 KB.  8 column groups x 16 row slabs fill 128 SMs; each
//     block reads its 128 KB from L2 after the first touch from HBM, in
//     16-byte loads with eight in flight a thread, since with one 512-thread
//     block an SM the staging is bound by the loads it keeps in flight.
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
// All keep independent chains in every thread (4 on the smem path, 8 on the
// others) so the dependent load -> index -> load sequence of one chain
// overlaps the others.  T must be a power of two (the remainder is a mask),
// L a multiple of 16 and the table 16-byte aligned; the binding checks all
// three (ops/cuda_kernels.py).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;    // L2 path
constexpr int kChains = 8;       // L2 path: independent elements a thread
constexpr int kSmemThreads = 512;
constexpr int kSmemChains = 4;
constexpr int kSmemCols = 16;    // columns a smem-path block owns
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
// jnp.abs(...) % T, for a power-of-two t.
__device__ __forceinline__ int next_index(int idx, int vi, int k, int t) {
  const unsigned s = static_cast<unsigned>(idx) + static_cast<unsigned>(vi) +
                     static_cast<unsigned>(k);
  const unsigned a = static_cast<int>(s) < 0 ? 0u - s : s;
  return static_cast<int>(a & static_cast<unsigned>(t - 1));
}

template <typename V>
__global__ void __launch_bounds__(kSmemThreads)
gather_smem_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                   V* __restrict__ out, int n, int t, int l, int rounds,
                   int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const V* col = reinterpret_cast<const V*>(smem_raw);  // col[r * kSmemCols + c]
  const int c0 = blockIdx.x * kSmemCols;
  // 16-byte loads, 8 in flight a thread: a row's 16 columns are 4 uint4.
  const uint4* src = reinterpret_cast<const uint4*>(table + c0);
  uint4* dst = reinterpret_cast<uint4*>(smem_raw);
  const int row4 = l / 4;
#pragma unroll 8
  for (int e = threadIdx.x; e < t * 4; e += kSmemThreads) {
    dst[e] = src[static_cast<size_t>(e >> 2) * row4 + (e & 3)];
  }
  __syncthreads();

  const int c = threadIdx.x % kSmemCols;
  constexpr int kRowStep = kSmemThreads / kSmemCols;
  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(r_begin + rows_per_block, n);
  for (int r0 = r_begin + threadIdx.x / kSmemCols; r0 < r_end;
       r0 += kRowStep * kSmemChains) {
    int id[kSmemChains];
    V acc[kSmemChains];
#pragma unroll
    for (int m = 0; m < kSmemChains; ++m) {
      const int r = r0 + m * kRowStep;
      id[m] = r < r_end ? idx[static_cast<size_t>(r) * l + c0 + c] : 0;
      acc[m] = V(0);
    }
    for (int k = 0; k < rounds; ++k) {
#pragma unroll
      for (int m = 0; m < kSmemChains; ++m) {
        const V v = col[id[m] * kSmemCols + c];
        id[m] = next_index(id[m], to_int(v), k, t);
        acc[m] = add(acc[m], v);
      }
    }
#pragma unroll
    for (int m = 0; m < kSmemChains; ++m) {
      const int r = r0 + m * kRowStep;
      if (r < r_end) out[static_cast<size_t>(r) * l + c0 + c] = acc[m];
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

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

struct Plan {          // ops/cuda_kernels.py GatherPlan
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

// The launch of the columns path: grid, cluster and shared memory of `p`.
template <typename V, bool kCluster>
cudaError_t columns_config(int t, int l, const Plan& p, cudaStream_t s,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  auto kernel = gather_columns_kernel<V, kCluster>;
  const size_t smem = static_cast<size_t>(t) * p.cols_per_block * sizeof(V);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && p.cluster_blocks > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster_blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(l / (p.cols_per_block * p.cluster_blocks) * p.cluster_blocks,
                      p.row_slabs);
  cfg->blockDim = dim3(kColumnsThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = kCluster ? 1 : 0;
  return err;
}

template <typename V, bool kCluster>
cudaError_t launch_columns(const V* tb, const int* idx, V* o, int n, int t,
                           int l, int rounds, const Plan& p, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = columns_config<V, kCluster>(t, l, p, s, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, gather_columns_kernel<V, kCluster>, tb, idx, o,
                            n, t, l, rounds, log2_exact(p.cols_per_block),
                            log2_exact(p.cluster_blocks), p.rows_per_slab,
                            p.interleaved);
}

bool plan_ok(int n, int t, const Plan& p) {
  return log2_exact(p.cols_per_block) >= 0 && log2_exact(p.cluster_blocks) >= 0 &&
         p.cols_per_block * p.cluster_blocks <= kMaxGroupCols &&
         p.cluster_blocks <= t && p.row_slabs >= 1 && p.rows_per_slab >= 1 &&
         static_cast<long long>(t) * p.cols_per_block * 4 <= kBlockBytes &&
         static_cast<long long>(p.rows_per_slab) * p.row_slabs >= n;
}

enum Path { kPathSmem = 0, kPathColumns = 1, kPathL2 = 2 };  // GATHER_PATHS

template <typename V>
cudaError_t launch(const void* table, const int* idx, void* out, int n, int t,
                   int l, int rounds, int path, const Plan& plan,
                   cudaStream_t s) {
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
  if (path == kPathColumns) {
    return plan.cluster_blocks == 1
               ? launch_columns<V, false>(tb, idx, o, n, t, l, rounds, plan, s)
               : launch_columns<V, true>(tb, idx, o, n, t, l, rounds, plan, s);
  }
  const size_t smem = static_cast<size_t>(t) * kSmemCols * sizeof(V);
  cudaError_t err = cudaFuncSetAttribute(
      gather_smem_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int groups = l / kSmemCols;
  const int slabs = std::max(1, std::min(n, sm_count() / groups));
  const int rows_per_block = (n + slabs - 1) / slabs;
  const dim3 grid(groups, (n + rows_per_block - 1) / rows_per_block);
  gather_smem_kernel<V><<<grid, kSmemThreads, smem, s>>>(
      tb, idx, o, n, t, l, rounds, rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// table: (t, l) float32 (is_int = 0) or int32 (is_int = 1), t a power of
// two, l a multiple of 16, 16-byte aligned; idx: (n, l) int32 in [0, t);
// out: (n, l) of the table's type.  path (the index in GATHER_PATHS): 0
// stages 16 columns a block in shared memory (t * 16 * 4 bytes must fit a
// block), 1 holds whole columns in a block's or a cluster's shared memory as
// the plan says (cols_per_block .. interleaved; refused unless it is
// consistent, fits a block and covers every row), 2 reads the table through
// L2.  Returns the launch's error: a launch the card refuses is not tried
// another way.
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
  if (path == kPathColumns && !plan_ok(n, t, plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_int ? launch<int>(table, idx, out, n, t, l, rounds, path, plan, s)
             : launch<float>(table, idx, out, n, t, l, rounds, path, plan, s);
  return static_cast<int>(err);
}

// How many clusters of the columns path's float32 kernel the card runs at
// once under this plan (cudaOccupancyMaxActiveClusters; the GPCs of a part
// are not all the same size), or minus the error.  A plan of more clusters
// runs in waves.
extern "C" int vulcan_gather_max_clusters(int t, int l, int cols_per_block,
                                          int cluster_blocks, int row_slabs,
                                          int rows_per_slab) {
  const Plan plan = {cols_per_block, cluster_blocks, row_slabs, rows_per_slab, 0};
  if (t <= 0 || l <= 0 || !plan_ok(0, t, plan) || cluster_blocks < 2) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = columns_config<float, true>(t, l, plan, nullptr, &cfg, &attr);
  int clusters = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&clusters,
                                         gather_columns_kernel<float, true>, &cfg);
  }
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}
