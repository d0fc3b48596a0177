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
// (106,496 lookups, D = 128) the gather moves about 109 MB, about 33 us at
// the H100 SXM's 3.35 TB/s. index_add_rows reads 2 * n * D * 4 bytes and
// its atomics resolve in L2; rows that many lookups share serialise there.
//
// Design: one warp per row. At D = 128 the 32 lanes each move one 16-byte
// float4, so a row is one fully coalesced 512-byte load and store; other
// widths divisible by 4 loop in float4 steps, and any other width (or an
// operand that is not 16-byte aligned) takes a plain strided float loop. A
// grid-stride loop over rows covers any row count with a bounded grid. No
// shared memory: a row is read once and written once, so there is nothing to
// reuse, and the many warps in flight hide the latency of the random reads.
// The TPU kernels' pipelines of single-row DMAs through VMEM and their
// blocking rules (D % 128 == 0, 1024-row blocks, 64k-row SMEM chunks) are TPU
// constraints and have no counterpart here.
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

__device__ __forceinline__ void copy_row(float* __restrict__ dst,
                                         const float* __restrict__ src,
                                         int64_t d, int lane, bool vec4) {
  if (vec4) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int64_t c = lane; c < d / 4; c += kWarp) dst4[c] = src4[c];
  } else {
    for (int64_t c = lane; c < d; c += kWarp) dst[c] = src[c];
  }
}

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

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ cache,
                   const int32_t* __restrict__ slots, float* __restrict__ out,
                   int64_t n, int64_t d) {
  const int lane = threadIdx.x % kWarp;
  const int64_t stride = int64_t{gridDim.x} * kRowsPerBlock;
  for (int64_t i = int64_t{blockIdx.x} * kRowsPerBlock + threadIdx.x / kWarp;
       i < n; i += stride) {
    const int64_t src = int64_t{slots[i]} * d;  // one broadcast load per warp
    copy_row(out + i * d, cache + src, d, lane, kVec4);
  }
}

template <bool kVec4>
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
    const int64_t dst = int64_t{slots[i]} * d;
    copy_row(cache + dst, rows + i * d, d, lane, kVec4);
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

unsigned int grid_for(int64_t rows) {
  int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool vec4_ok(int64_t d, const void* a, const void* b) {
  return d % 4 == 0 && (reinterpret_cast<uintptr_t>(a) % 16) == 0 &&
         (reinterpret_cast<uintptr_t>(b) % 16) == 0;
}

}  // namespace

extern "C" {

int cdlrm_gather_rows(const float* cache, const int32_t* slots, float* out,
                      int64_t n, int64_t d, cudaStream_t stream) {
  if (n > 0 && d > 0) {
    if (vec4_ok(d, cache, out)) {
      gather_rows_kernel<true><<<grid_for(n), kThreads, 0, stream>>>(
          cache, slots, out, n, d);
    } else {
      gather_rows_kernel<false><<<grid_for(n), kThreads, 0, stream>>>(
          cache, slots, out, n, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int cdlrm_scatter_set_rows(float* cache, const int32_t* slots,
                           const float* rows, const int64_t* nvalid, int64_t u,
                           int64_t d, cudaStream_t stream) {
  if (u > 0 && d > 0) {
    if (vec4_ok(d, cache, rows)) {
      scatter_set_rows_kernel<true><<<grid_for(u), kThreads, 0, stream>>>(
          cache, slots, rows, nvalid, u, d);
    } else {
      scatter_set_rows_kernel<false><<<grid_for(u), kThreads, 0, stream>>>(
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
