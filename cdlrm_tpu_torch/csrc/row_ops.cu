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
//
// Bound: both move whole rows and compute nothing, so device-memory bytes
// bound them: 2 * rows * D * 4 bytes (one read and one write per row). At the
// serving shape (106,496 lookups, D = 128) the gather moves about 109 MB, about
// 33 us at the H100 SXM's 3.35 TB/s.
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
// Contracts (checked by the Python wrappers, cdlrm_tpu_torch/ops/):
// - every slot lies in [0, R). An out-of-range slot is undefined behaviour
//   here, where XLA clamped it;
// - scatter_set_rows: slots[:nvalid] are distinct rows (the cache's valid
//   prefix contract, cdlrm_tpu/ops/scatter.py:20-25). nvalid is read on the
//   device, so the caller never synchronises to count the valid prefix; a row
//   warp with i >= nvalid returns without touching memory, so trash-row
//   padding past the prefix is never written.
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
  int64_t nv = *nvalid;
  nv = nv < 0 ? 0 : (nv > u ? u : nv);
  const int lane = threadIdx.x % kWarp;
  const int64_t stride = int64_t{gridDim.x} * kRowsPerBlock;
  for (int64_t i = int64_t{blockIdx.x} * kRowsPerBlock + threadIdx.x / kWarp;
       i < nv; i += stride) {
    const int64_t dst = int64_t{slots[i]} * d;
    copy_row(cache + dst, rows + i * d, d, lane, kVec4);
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

const char* cdlrm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
