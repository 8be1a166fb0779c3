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
// (7.5 us at HBM rate) and makes 8.4M lookups into an 8 MB table.
//
// Design, one per shape:
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
//   * L2 path (T4, taller tables): one column of 16384 rows is 64 KB, so at
//     most 3 columns fit a block, 43 blocks for 132 SMs.  The probe's question
//     is the card's gather rate from L2 (integrate and ICP gather from tables
//     far larger than shared memory), so the 8 MB table stays in L2 and every
//     lookup is an __ldg; each 4-byte lookup pulls a 32-byte sector.
// Both keep independent chains in every thread (4 on the smem path, 8 on
// the L2 path) so the dependent load -> index -> load sequence of one chain
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

template <typename V>
cudaError_t launch(const void* table, const int* idx, void* out, int n, int t,
                   int l, int rounds, bool use_smem, cudaStream_t s) {
  const V* tb = static_cast<const V*>(table);
  V* o = static_cast<V*>(out);
  if (!use_smem) {
    const size_t total = static_cast<size_t>(n) * l;
    const size_t per_block = static_cast<size_t>(kThreads) * kChains;
    const unsigned blocks =
        static_cast<unsigned>((total + per_block - 1) / per_block);
    gather_l2_kernel<V><<<blocks, kThreads, 0, s>>>(tb, idx, o, n, t, l,
                                                  rounds);
    return cudaGetLastError();
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
// out: (n, l) of the table's type.  use_smem = 1 stages the table in
// shared memory (t * 16 * 4 bytes must fit a block, or the launch is
// refused), 0 reads it through L2.  Returns cudaGetLastError().
extern "C" int vulcan_chained_gather(const void* table, const int* idx,
                                     void* out, int n, int t, int l,
                                     int rounds, int is_int, int use_smem,
                                     void* stream) {
  if (n < 0 || t <= 0 || (t & (t - 1)) != 0 || l <= 0 || l % kSmemCols != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 || rounds < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool smem = use_smem != 0;
  const cudaError_t err =
      is_int ? launch<int>(table, idx, out, n, t, l, rounds, smem, s)
             : launch<float>(table, idx, out, n, t, l, rounds, smem, s);
  return static_cast<int>(err);
}
