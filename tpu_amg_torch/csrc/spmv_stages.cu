// Stage ablations of the capped CSR SpMV (K1) for Hopper (sm_90a).
//
//   KW csr_spmv_stages  K1 with one or more of its stages taken out, on
//                       K1's own capped CSR, group size and lane order.
//                       Replaces the WELL prototype and ablation Pallas
//                       kernels of tools/: well2proto.py `make_v3_kernel`
//                       (W1), `dataonly_call` (W2), `make_v2_kernel` (W3),
//                       wellablate.py `make_kernel` (W4) and
//                       wellablate2.py `make_kernel` (W5).
//
// K1 spends its time in four stages: the index and value stream, the
// gather of x[c_j], the reduce across a row's lanes, and the write of y.
// The modes take stages out one at a time so that each mode's time, held
// against the bytes it must move, attributes K1's time to a stage:
//
//   full            y[r] = sum_j v_j x[c_j]            (K1 itself, bitwise)
//   nogather        y[r] = sum_j (v_j x[r] + zero c_j)  (indices read, x[r]
//                                                      contiguous)
//   nored           P[r, l] = sum_{j: (j - start) % G == l} v_j x[c_j]
//                                                     (no shuffle reduce)
//   nogather_nored  the two combined
//   streamonly      y[r] = sum_j (v_j + zero c_j)       (no x read at all)
//   dataonly        y[r] = sum_j v_j                    (no index read)
//
// `zero` is a runtime 0 so that the compiler keeps the index loads.
//
// Every mode is bound by bytes (values, indices, row pointers, x, y),
// never by operations.  The design keeps K1's launch shape exactly (one
// group of G lanes per row, lanes on consecutive entries, 256 threads a
// block) and changes only what a mode takes out, so that a difference in
// time is the stage's and not the layout's.  The TPU harnesses' window
// tables, passes and MXU merges have no counterpart: the CSR kernel has
// no such layout.
//
// The host side (tpu_amg_torch/ops/spmv_stages.py) allocates the output,
// passes PyTorch's current stream and checks the returned
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Mode : int {
  kFull = 0,
  kNoGather = 1,
  kNoRed = 2,
  kNoGatherNoRed = 3,
  kStreamOnly = 4,
  kDataOnly = 5,
};

template <typename T, int G, int M>
__global__ void stages_kernel(int64_t n_rows,
                              const int64_t* __restrict__ indptr,
                              const int32_t* __restrict__ indices,
                              const T* __restrict__ vals,
                              const T* __restrict__ x, T zero,
                              T* __restrict__ y) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = tid / G;
  const int lane = static_cast<int>(tid % G);
  const bool active = row < n_rows;
  const int64_t start = active ? indptr[row] : 0;
  const int64_t end = active ? indptr[row + 1] : 0;
  T acc = T(0);
  if constexpr (M == kFull || M == kNoRed) {
    // K1's loop, term for term
    for (int64_t j = start + lane; j < end; j += G) {
      acc += vals[j] * x[static_cast<int64_t>(indices[j])];
    }
  } else if constexpr (M == kNoGather || M == kNoGatherNoRed) {
    const T xr = active ? x[row] : T(0);
    for (int64_t j = start + lane; j < end; j += G) {
      acc += vals[j] * xr + zero * static_cast<T>(indices[j]);
    }
  } else if constexpr (M == kStreamOnly) {
    for (int64_t j = start + lane; j < end; j += G) {
      acc += vals[j] + zero * static_cast<T>(indices[j]);
    }
  } else {
    for (int64_t j = start + lane; j < end; j += G) {
      acc += vals[j];
    }
  }
  if constexpr (M == kNoRed || M == kNoGatherNoRed) {
    if (active) y[row * G + lane] = acc;
  } else {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off, G);
    }
    if (active && lane == 0) y[row] = acc;
  }
}

template <typename T, int G>
int launch_mode(int mode, int64_t n_rows, const int64_t* ip, const int32_t* ix,
                const T* v, const T* x, T zero, T* y, cudaStream_t s) {
  const int64_t threads = n_rows * G;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
#define STAGES_CASE(m)                                                       \
  case m:                                                                    \
    stages_kernel<T, G, m><<<blocks, kThreads, 0, s>>>(n_rows, ip, ix, v, x, \
                                                       zero, y);            \
    break;
  switch (mode) {
    STAGES_CASE(kFull)
    STAGES_CASE(kNoGather)
    STAGES_CASE(kNoRed)
    STAGES_CASE(kNoGatherNoRed)
    STAGES_CASE(kStreamOnly)
    STAGES_CASE(kDataOnly)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef STAGES_CASE
  return 0;
}

template <typename T>
int csr_spmv_stages(int64_t n_rows, int group, int mode, const void* indptr,
                    const void* indices, const void* vals, const void* x,
                    T zero, void* y, void* stream) {
  if (n_rows > 0) {
    auto ip = static_cast<const int64_t*>(indptr);
    auto ix = static_cast<const int32_t*>(indices);
    auto v = static_cast<const T*>(vals);
    auto xx = static_cast<const T*>(x);
    auto yy = static_cast<T*>(y);
    auto s = static_cast<cudaStream_t>(stream);
    int code = 0;
    switch (group) {
      case 2: code = launch_mode<T, 2>(mode, n_rows, ip, ix, v, xx, zero, yy, s); break;
      case 4: code = launch_mode<T, 4>(mode, n_rows, ip, ix, v, xx, zero, yy, s); break;
      case 8: code = launch_mode<T, 8>(mode, n_rows, ip, ix, v, xx, zero, yy, s); break;
      case 16: code = launch_mode<T, 16>(mode, n_rows, ip, ix, v, xx, zero, yy, s); break;
      case 32: code = launch_mode<T, 32>(mode, n_rows, ip, ix, v, xx, zero, yy, s); break;
      default: code = static_cast<int>(cudaErrorInvalidValue);
    }
    if (code != 0) return code;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stages_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int csr_spmv_stages_f64(int64_t n_rows, int group, int mode, const void* indptr,
                        const void* indices, const void* vals, const void* x,
                        double zero, void* y, void* stream) {
  return csr_spmv_stages<double>(n_rows, group, mode, indptr, indices, vals, x,
                                 zero, y, stream);
}

int csr_spmv_stages_f32(int64_t n_rows, int group, int mode, const void* indptr,
                        const void* indices, const void* vals, const void* x,
                        float zero, void* y, void* stream) {
  return csr_spmv_stages<float>(n_rows, group, mode, indptr, indices, vals, x,
                                zero, y, stream);
}

}  // extern "C"
