// Row kernels on the float32 embedding cache [R, D] for NVIDIA Hopper
// (sm_90a), built by cdlrm_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface, loaded with ctypes.
//
// gather_rows      out[i, :] = cache[slots[i], :]                 i < n
//   Replaces the Pallas kernel _gather_block_kernel
//   (cdlrm_tpu/ops/lookup.py::gather_rows, pallas_call at lookup.py:70).
// scatter_set_rows cache[slots[i], :] = rows[i, :]                i < *nvalid
//   Replaces the Pallas kernel _scatter_set_kernel
//   (cdlrm_tpu/ops/scatter.py::scatter_set_rows, pallas_call at scatter.py:257).
// scatter_add_rows cache[slots[i], :] += delta[i, :]              i < *nvalid
//   Replaces the Pallas kernel _scatter_add_kernel
//   (cdlrm_tpu/ops/scatter.py::scatter_add_rows, pallas_call at scatter.py:211).
// index_add_rows   out[slots[i], :] += alpha * src[i, :]         i < n
//   Duplicate slots allowed. The backward of gather_rows, which cdlrm_tpu
//   writes as an XLA .at[].add in the custom VJP (lookup.py:99-102), and with
//   alpha = -lr_embeds the plain-wire sparse SGD update (train/step.py:701).
//
// Bound: all four move whole rows and do at most one add per element, so
// device-memory bytes bound them. gather_rows and scatter_set_rows move
// 2 * rows * D * 4 bytes (one read and one write per row); scatter_add_rows
// 3 * rows * D * 4 (it also reads the cache row). At the serving shape
// (106,496 lookups, D = 128) the gather moves 109.1 MB, 32.6 us at the H100
// SXM's 3.35 TB/s; the row set of 100,000 rows moves 102.4 MB, 30.6 us. A
// plain device-to-device copy of the same bytes (Tensor.copy_) is the
// ceiling a copy reaches on the card; chip_smoke.py times it beside both.
// index_add_rows reads n * D * 4 bytes of source rows and reads and writes
// each distinct destination row once; its atomics resolve in L2, where rows
// that many lookups share serialise.
//
// Design of the two row copies, gather_rows and scatter_set_rows. A copy of
// random 512-byte rows is bound by how many bytes are in flight and by how
// little else a warp does, so:
// - the grid is persistent, kBlocksPerSm blocks of 8 warps on each SM, and
//   warp w owns the tiles w, w + warps, ... of kTileRows = 32 rows;
// - the 32 slots of a tile come with one coalesced 128-byte load, ahead of
//   the rows, and reach the lanes by shuffle: no lane waits for a slot of
//   its own before each row;
// - kUnroll = 8 rows are loaded, one float4 per lane and 32 columns, before
//   the first is stored: 8 independent 16-byte loads per lane in flight,
//   4 KB per warp, whatever the block scheduler does;
// - the side that is touched once bypasses the cache policy of the rest: the
//   gather's output rows are stored with __stcs and the set's staged rows are
//   loaded with __ldcs, so the cache's own rows keep L2; the gather reads the
//   cache through the read-only path.
// Widths divisible by 4 with 16-byte aligned operands take these kernels;
// anything else takes a plain strided float loop, one row per warp. The TPU
// kernels' pipelines of single-row DMAs through VMEM and their blocking rules
// (D % 128 == 0, 1024-row blocks, 64k-row SMEM chunks) are TPU constraints
// and have no counterpart here. Moving the rows with the bulk asynchronous
// copy engine (cp.async.bulk through rings of shared memory) instead of
// registers measured no faster on an H100, nor did 4 or 16 rows unrolled, so
// neither is here; PERF.md section 6 has their times.
//
// scatter_add_rows and index_add_rows keep the one-row-per-warp loop: at D =
// 128 the 32 lanes each move one 16-byte float4, so a row is one fully
// coalesced 512-byte access.
//
// scatter_add_rows needs no atomics: its valid prefix holds distinct rows, so
// each cache row has one writer and the result is the single rounded sum
// cache + delta, bit-exact against index_add_. index_add_rows has duplicate
// slots and adds with one float atomicAdd per element, lane c of the warp on
// column c, c + 32, ..., so each atomic instruction covers 128 consecutive
// bytes of one row. alpha * src is rounded to float32 before the add, as
// cdlrm_tpu's -lr_embeds * drows is. Duplicates are summed in the order the
// atomics land, which differs from run to run and from XLA's sequential
// order: the sums agree to rounding, not bit for bit.
//
// Contracts (checked by the Python wrappers, cdlrm_tpu_torch/ops/):
// - every slot lies in [0, R). An out-of-range slot is undefined behaviour
//   here, where XLA clamped it;
// - scatter_set_rows and scatter_add_rows: slots[:nvalid] are distinct rows
//   (the cache's valid prefix contract, cdlrm_tpu/ops/scatter.py:20-25).
//   nvalid is read on the device, so the caller never synchronises to count
//   the valid prefix; a row warp with i >= nvalid returns without touching
//   memory, so trash-row padding past the prefix is never written.
//
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so that a refused launch
// is seen at once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // threads per block
constexpr int kRowsPerBlock = kThreads / kWarp;  // one row per warp
constexpr int64_t kMaxBlocks = int64_t{1} << 20;
// the two row copies (gather_rows_unrolled_kernel, scatter_set_rows_unrolled_kernel)
constexpr int kTileRows = 32;    // rows per tile: one coalesced load of 32 slots
constexpr int kUnroll = 8;       // rows loaded before the first is stored
constexpr int kBlocksPerSm = 8;  // of the persistent grid
constexpr uint32_t kFullMask = 0xffffffffu;

__device__ __forceinline__ void add_row(float* __restrict__ dst,
                                        const float* __restrict__ src,
                                        int64_t d, int lane, bool vec4) {
  if (vec4) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int64_t c = lane; c < d / 4; c += kWarp) {
      float4 a = dst4[c];
      const float4 b = src4[c];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
      dst4[c] = a;
    }
  } else {
    for (int64_t c = lane; c < d; c += kWarp) dst[c] += src[c];
  }
}

// clamp the device-resident valid count into [0, u]
__device__ __forceinline__ int64_t valid_rows(const int64_t* nvalid,
                                              int64_t u) {
  const int64_t nv = *nvalid;
  return nv < 0 ? 0 : (nv > u ? u : nv);
}

// The row copies for widths and alignments that float4 cannot take: one row
// per warp, a strided float loop.
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ cache,
                   const int32_t* __restrict__ slots, float* __restrict__ out,
                   int64_t n, int64_t d) {
  const int lane = threadIdx.x % kWarp;
  const int64_t stride = int64_t{gridDim.x} * kRowsPerBlock;
  for (int64_t i = int64_t{blockIdx.x} * kRowsPerBlock + threadIdx.x / kWarp;
       i < n; i += stride) {
    const float* src = cache + int64_t{slots[i]} * d;  // one broadcast load per warp
    for (int64_t c = lane; c < d; c += kWarp) out[i * d + c] = src[c];
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_set_rows_kernel(float* __restrict__ cache,
                        const int32_t* __restrict__ slots,
                        const float* __restrict__ rows,
                        const int64_t* __restrict__ nvalid, int64_t u,
                        int64_t d) {
  const int64_t nv = valid_rows(nvalid, u);
  const int lane = threadIdx.x % kWarp;
  const int64_t stride = int64_t{gridDim.x} * kRowsPerBlock;
  for (int64_t i = int64_t{blockIdx.x} * kRowsPerBlock + threadIdx.x / kWarp;
       i < nv; i += stride) {
    float* dst = cache + int64_t{slots[i]} * d;
    for (int64_t c = lane; c < d; c += kWarp) dst[c] = rows[i * d + c];
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(float* __restrict__ cache,
                        const int32_t* __restrict__ slots,
                        const float* __restrict__ delta,
                        const int64_t* __restrict__ nvalid, int64_t u,
                        int64_t d) {
  const int64_t nv = valid_rows(nvalid, u);
  const int lane = threadIdx.x % kWarp;
  const int64_t stride = int64_t{gridDim.x} * kRowsPerBlock;
  for (int64_t i = int64_t{blockIdx.x} * kRowsPerBlock + threadIdx.x / kWarp;
       i < nv; i += stride) {
    const int64_t dst = int64_t{slots[i]} * d;
    add_row(cache + dst, delta + i * d, d, lane, kVec4);
  }
}

__global__ void __launch_bounds__(kThreads)
index_add_rows_kernel(float* __restrict__ out,
                      const int32_t* __restrict__ slots,
                      const float* __restrict__ src, int64_t n, int64_t d,
                      float alpha) {
  const int lane = threadIdx.x % kWarp;
  const int64_t stride = int64_t{gridDim.x} * kRowsPerBlock;
  for (int64_t i = int64_t{blockIdx.x} * kRowsPerBlock + threadIdx.x / kWarp;
       i < n; i += stride) {
    float* dst = out + int64_t{slots[i]} * d;
    const float* row = src + i * d;
    for (int64_t c = lane; c < d; c += kWarp) atomicAdd(dst + c, alpha * row[c]);
  }
}

// The two row copies through registers: warp w owns tiles w, w + warps, ...;
// its 32 slots come with one coalesced load and reach the lanes by shuffle;
// kUnroll rows are loaded (one float4 per lane and 32 columns) before the
// first is stored, so kUnroll independent loads per lane are in flight.
__global__ void __launch_bounds__(kThreads)
gather_rows_unrolled_kernel(const float4* __restrict__ cache,
                            const int32_t* __restrict__ slots, float4* __restrict__ out,
                            int64_t n, int64_t d4) {
  const int lane = threadIdx.x % kWarp;
  const int64_t total = int64_t{gridDim.x} * kRowsPerBlock;
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  for (int64_t t = int64_t{blockIdx.x} * kRowsPerBlock + threadIdx.x / kWarp; t < tiles;
       t += total) {
    const int64_t row0 = t * kTileRows;
    const int rows = n - row0 < kTileRows ? static_cast<int>(n - row0) : kTileRows;
    const int64_t mine = lane < rows ? int64_t{slots[row0 + lane]} : 0;
    for (int r0 = 0; r0 < rows; r0 += kUnroll) {
      int64_t src[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        src[j] = __shfl_sync(kFullMask, mine, (r0 + j) % kWarp) * d4;
      }
      for (int64_t c = lane; c < d4; c += kWarp) {
        float4 v[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          if (r0 + j < rows) v[j] = cache[src[j] + c];
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          if (r0 + j < rows) __stcs(out + (row0 + r0 + j) * d4 + c, v[j]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_set_rows_unrolled_kernel(float4* __restrict__ cache, const int32_t* __restrict__ slots,
                                 const float4* __restrict__ src_rows,
                                 const int64_t* __restrict__ nvalid, int64_t u, int64_t d4) {
  const int64_t nv = valid_rows(nvalid, u);
  const int lane = threadIdx.x % kWarp;
  const int64_t total = int64_t{gridDim.x} * kRowsPerBlock;
  const int64_t tiles = (nv + kTileRows - 1) / kTileRows;
  for (int64_t t = int64_t{blockIdx.x} * kRowsPerBlock + threadIdx.x / kWarp; t < tiles;
       t += total) {
    const int64_t row0 = t * kTileRows;
    const int rows = nv - row0 < kTileRows ? static_cast<int>(nv - row0) : kTileRows;
    const int64_t mine = lane < rows ? int64_t{slots[row0 + lane]} : 0;
    for (int r0 = 0; r0 < rows; r0 += kUnroll) {
      int64_t dst[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        dst[j] = __shfl_sync(kFullMask, mine, (r0 + j) % kWarp) * d4;
      }
      for (int64_t c = lane; c < d4; c += kWarp) {
        float4 v[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          if (r0 + j < rows) v[j] = __ldcs(src_rows + (row0 + r0 + j) * d4 + c);
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          if (r0 + j < rows) cache[dst[j] + c] = v[j];
        }
      }
    }
  }
}

unsigned int grid_for(int64_t rows) {
  int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool vec4_ok(int64_t d, const void* a, const void* b) {
  return d % 4 == 0 && (reinterpret_cast<uintptr_t>(a) % 16) == 0 &&
         (reinterpret_cast<uintptr_t>(b) % 16) == 0;
}

// the persistent grid of the unrolled kernels on the current device
unsigned int persistent_grid() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<unsigned int>(sms * kBlocksPerSm);
}

}  // namespace

extern "C" {

int cdlrm_gather_rows(const float* cache, const int32_t* slots, float* out,
                      int64_t n, int64_t d, cudaStream_t stream) {
  if (n > 0 && d > 0) {
    if (vec4_ok(d, cache, out)) {
      gather_rows_unrolled_kernel<<<persistent_grid(), kThreads, 0, stream>>>(
          reinterpret_cast<const float4*>(cache), slots,
          reinterpret_cast<float4*>(out), n, d / 4);
    } else {
      gather_rows_kernel<<<grid_for(n), kThreads, 0, stream>>>(cache, slots, out, n, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int cdlrm_scatter_set_rows(float* cache, const int32_t* slots,
                           const float* rows, const int64_t* nvalid, int64_t u,
                           int64_t d, cudaStream_t stream) {
  if (u > 0 && d > 0) {
    if (vec4_ok(d, cache, rows)) {
      scatter_set_rows_unrolled_kernel<<<persistent_grid(), kThreads, 0, stream>>>(
          reinterpret_cast<float4*>(cache), slots,
          reinterpret_cast<const float4*>(rows), nvalid, u, d / 4);
    } else {
      scatter_set_rows_kernel<<<grid_for(u), kThreads, 0, stream>>>(
          cache, slots, rows, nvalid, u, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int cdlrm_scatter_add_rows(float* cache, const int32_t* slots,
                           const float* delta, const int64_t* nvalid,
                           int64_t u, int64_t d, cudaStream_t stream) {
  if (u > 0 && d > 0) {
    if (vec4_ok(d, cache, delta)) {
      scatter_add_rows_kernel<true><<<grid_for(u), kThreads, 0, stream>>>(
          cache, slots, delta, nvalid, u, d);
    } else {
      scatter_add_rows_kernel<false><<<grid_for(u), kThreads, 0, stream>>>(
          cache, slots, delta, nvalid, u, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int cdlrm_index_add_rows(float* out, const int32_t* slots, const float* src,
                         int64_t n, int64_t d, float alpha,
                         cudaStream_t stream) {
  if (n > 0 && d > 0) {
    index_add_rows_kernel<<<grid_for(n), kThreads, 0, stream>>>(
        out, slots, src, n, d, alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cdlrm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
