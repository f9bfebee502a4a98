// Streaming-read bandwidth probe for Hopper (sm_90a).
//
//   S1/S2 stream_sum  out[t] = carry + sum_i sum_chunks float(block_{i,t}[chunk])
//                     Replaces both Pallas bodies of tools/streambench.py:
//                     `run_case.kernel` (blocks of (rows, 128) stacked per
//                     tile) and `run_wide.kernel` (blocks of (sub, width)
//                     side by side in one wide array).
//
// The two TPU bodies differ only in how Mosaic tiles a contiguous stream
// into sublanes and lanes; Hopper has no such split, so one kernel takes
// a (tiles, rows, width) view of each input with a unit last stride and
// two strides in elements: `tile_stride` between tiles and `row_stride`
// between rows.  The stacked layout is the contiguous view
// (rows * width, width); the wide layout is the transposed view
// (width, tiles * width) of a (rows, tiles * width) array.  Each tile's
// block is cut into (8, 128) chunks, and every chunk is added into the
// tile's (8, 128) float32 sum.
//
// Bound by bytes only: one add per element read.  Each thread owns one
// 16-byte slot of the (8, 128) chunk (4 float32 or 16 int8 values) and
// reads it with 128-bit loads from chunk after chunk on a grid-stride
// loop, 4 chunks' loads issued before their adds; a block of 256
// threads covers 1 (float32) or 4 (int8) chunks per load.  The slots of
// a block are reduced in shared memory and added into the output with
// atomics, so several blocks can share a tile.  The caller fills the output with the carry first.
// int8 inputs are summed in int32 and float32 inputs in float32, so sums
// of integer-valued inputs are exact whatever the order.
//
// The host side (tpu_amg_torch/ops/stream.py) checks shapes, strides and
// 16-byte alignment, passes PyTorch's current stream and checks the
// returned cudaGetLastError().

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxInputs = 8;
constexpr int kChunk = 8 * 128;
constexpr int kUnroll = 4;  // chunks whose loads a thread keeps in flight

struct Inputs {
  const void* ptr[kMaxInputs];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_sum_kernel(Inputs in, int n_in, int rows, int width,
                  int64_t row_stride, int64_t tile_stride,
                  float* __restrict__ out) {
  // int8 sums are taken in int32 (exact, and without a conversion per
  // byte), float32 sums in float32; both become float32 at the end
  using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int,
                                        float>::type;
  constexpr int kVec = 16 / sizeof(T);          // values per 16-byte slot
  constexpr int kSlots = kChunk / kVec;         // slots per (8, 128) chunk
  constexpr int kGroups = kThreads / kSlots;    // chunks in flight per block
  constexpr int kSlotsPerRow = 128 / kVec;
  const int slot = threadIdx.x % kSlots;
  const int group = threadIdx.x / kSlots;
  const int r = slot / kSlotsPerRow;
  const int l = (slot % kSlotsPerRow) * kVec;
  const int64_t t = blockIdx.y;
  const unsigned col_chunks = width / 128;
  const unsigned n_chunks = (rows / 8) * col_chunks;

  Acc acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = Acc(0);
  const unsigned stride = gridDim.x * kGroups;
  for (unsigned q = blockIdx.x * kGroups + group; q < n_chunks;
       q += kUnroll * stride) {
    // kUnroll chunks' offsets, then their loads, then the adds: the
    // loads of one step are independent and in flight together
    int64_t off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned qu = q + u * stride;
      const unsigned rr = qu / col_chunks;
      const unsigned kk = qu - rr * col_chunks;
      off[u] = qu < n_chunks
                   ? t * tile_stride + (rr * 8 + r) * row_stride + kk * 128 + l
                   : -1;
    }
    for (int i = 0; i < n_in; ++i) {
      const T* base = static_cast<const T*>(in.ptr[i]);
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = off[u] >= 0 ? __ldg(reinterpret_cast<const uint4*>(base + off[u]))
                           : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* e = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] += static_cast<Acc>(e[j]);
      }
    }
  }
  if constexpr (kGroups > 1) {
    __shared__ Acc red[kThreads][kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) red[threadIdx.x][j] = acc[j];
    __syncthreads();
    if (group == 0) {
      for (int g = 1; g < kGroups; ++g) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] += red[g * kSlots + slot][j];
      }
    }
  }
  if (group == 0) {
    float* o = out + t * kChunk + r * 128 + l;
#pragma unroll
    for (int j = 0; j < kVec; ++j) atomicAdd(&o[j], static_cast<float>(acc[j]));
  }
}

template <typename T>
int stream_sum(int n_in, const void* const* inputs, int64_t tiles, int64_t rows,
               int64_t width, int64_t row_stride, int64_t tile_stride,
               int splits, void* out, void* stream) {
  // shapes and chunk indices within a tile are 32-bit
  constexpr int64_t kMax32 = int64_t{1} << 31;
  if (n_in < 1 || n_in > kMaxInputs || splits < 1 || tiles > 65535 ||
      rows >= kMax32 || width >= kMax32 || (rows / 8) * (width / 128) >= kMax32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles > 0) {
    Inputs in{};
    for (int i = 0; i < n_in; ++i) in.ptr[i] = inputs[i];
    const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(tiles));
    stream_sum_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        in, n_in, static_cast<int>(rows), static_cast<int>(width), row_stride,
        tile_stride, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int stream_sum_f32(int n_in, const void* const* inputs, int64_t tiles,
                   int64_t rows, int64_t width, int64_t row_stride,
                   int64_t tile_stride, int splits, void* out, void* stream) {
  return stream_sum<float>(n_in, inputs, tiles, rows, width, row_stride,
                           tile_stride, splits, out, stream);
}

int stream_sum_i8(int n_in, const void* const* inputs, int64_t tiles,
                  int64_t rows, int64_t width, int64_t row_stride,
                  int64_t tile_stride, int splits, void* out, void* stream) {
  return stream_sum<int8_t>(n_in, inputs, tiles, rows, width, row_stride,
                            tile_stride, splits, out, stream);
}

}  // extern "C"
