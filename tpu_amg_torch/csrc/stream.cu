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
// Bound by bytes only: one add per element read, so what counts is that
// every SM keeps its loads in flight without a break.  The TPU's
// sequential grid carried a tile's sum from step to step; here one block
// of 512 threads runs on each SM.  Each thread owns one 16-byte slot of
// the tile's (8, 128) sum (4 float32 or 16 int8 values), reads 8
// (input, chunk) items a step with 16-byte loads, and issues the next
// step's loads before it adds this step's, so 16 loads (256 bytes) a
// thread, 128 KB an SM, stay in flight from step to step and from tile to
// tile.
//   - As many tiles as SMs or more: the blocks are persistent, block b
//     taking tiles b, b + grid, ...; a finished tile's sum is written with
//     plain stores while the next tile's loads are in flight.
//   - Fewer tiles than SMs: a tile is shared by P = 2, 4 or 8 blocks, each
//     owning 8 / P of the rows of the (8, 128) sum: it reads those rows of
//     every chunk (runs of at least 512 bytes) and writes them.  No block
//     needs another's sums.
// So no atomics, no scratch and no second launch: one launch a call, each
// output written once, and the same bits on every call.  int8 inputs are
// summed in int32 and float32 inputs in float32, so sums of
// integer-valued inputs are exact whatever the order.  (Tried and
// dropped, PERF.md: a ring of TMA bulk copies into shared memory, no
// faster than these loads at 1 GiB; splitting a tile's chunks over
// blocks whose partials the last one sums, after an int ticket, or
// through distributed shared memory in a thread-block cluster, both
// slower than sharing out its rows.)
//
// The host side (tpu_amg_torch/ops/stream.py) checks shapes, strides and
// 16-byte alignment, makes the launch plan, passes PyTorch's current
// stream and checks the returned cudaGetLastError().

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxInputs = 8;
constexpr int kChunk = 8 * 128;
constexpr int kUnroll = 8;  // 16-byte loads a thread issues a step

struct Inputs {
  const void* ptr[kMaxInputs];
};

struct Shape {
  int n_in, rows, width;
  int64_t row_stride, tile_stride, tiles;
};

// int8 sums are taken in int32 (exact, and without a conversion per
// byte), float32 sums in float32; both become float32 at the end
template <typename T>
using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int,
                                      float>::type;

// n / d for n < 2^31 by a multiply and a shift (d fixed for the kernel).
struct Divider {
  unsigned d, m, shift;
  __device__ explicit Divider(unsigned divisor) : d(divisor) {
    shift = 0;
    while ((1u << shift) < d) ++shift;
    m = static_cast<unsigned>(
        ((uint64_t{1} << 32) * ((uint64_t{1} << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> shift;
  }
};

// A tile's items: item f (chunk-major, f < n) is input f % n_in of
// chunk f / n_in.
template <typename T>
struct Items {
  const T* const* base;  // the inputs (shared memory)
  int64_t slot;          // this thread's slot in a tile's first chunk
  int64_t row_stride, tile_stride;
  unsigned n;
  Divider n_in, cols;  // inputs; chunks in a row group
};

// Issue the loads of items f, f + G, ..., f + (kUnroll - 1) G of tile t;
// past the end: zeros, not read.
template <typename T, int G>
__device__ __forceinline__ void load_items(const Items<T>& it, int64_t t,
                                           unsigned f, uint4 (&v)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned fu = f + u * G;
    v[u] = make_uint4(0, 0, 0, 0);
    if (fu < it.n) {
      const unsigned q = it.n_in.div(fu);
      const unsigned i = fu - q * it.n_in.d;
      const unsigned rr = it.cols.div(q);
      const unsigned kk = q - rr * it.cols.d;
      v[u] = __ldg(reinterpret_cast<const uint4*>(
          it.base[i] + t * it.tile_stride + it.slot +
          static_cast<int64_t>(rr) * 8 * it.row_stride + kk * 128));
    }
  }
}

template <typename T, typename A, int V>
__device__ __forceinline__ void add_items(const uint4 (&v)[kUnroll],
                                          A (&acc)[V]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const T* e = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += static_cast<A>(e[j]);
  }
}

// Grid (P, blocks of tiles): block (p, b) owns rows [p 8 / P, (p + 1) 8 / P)
// of the (8, 128) sums of tiles b, b + gridDim.y, ...
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
stream_sum_kernel(Inputs in, Shape sh, const float* __restrict__ carry,
                  float* __restrict__ out) {
  using A = Acc<T>;
  constexpr int kVec = 16 / sizeof(T);            // values per 16-byte slot
  constexpr int kSlotsPerRow = 128 / kVec;
  constexpr int kSlots = kChunk / kVec / P;       // slots of a block's rows
  constexpr int kGroups = kThreads / kSlots;      // chunks a step of loads
  constexpr unsigned kStep = kUnroll * kGroups;   // items a step
  __shared__ const T* base[kMaxInputs];
  __shared__ A red[kThreads][kVec];  // the groups' sums of each slot
#pragma unroll
  for (int i = 0; i < kMaxInputs; ++i) {
    if (threadIdx.x == i) base[i] = static_cast<const T*>(in.ptr[i]);
  }
  __syncthreads();
  const int slot = threadIdx.x % kSlots;
  const int group = threadIdx.x / kSlots;
  const int r = blockIdx.x * (8 / P) + slot / kSlotsPerRow;
  const int l = (slot % kSlotsPerRow) * kVec;
  const unsigned col_chunks = sh.width / 128;
  const unsigned n_chunks = (sh.rows / 8) * col_chunks;
  const Items<T> it{base, r * sh.row_stride + l, sh.row_stride,
                    sh.tile_stride, n_chunks * sh.n_in, Divider(sh.n_in),
                    Divider(col_chunks)};
  // steps a tile (an empty tile takes one step of no loads)
  const unsigned steps = it.n > 0 ? (it.n + kStep - 1) / kStep : 1;

  A acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = A(0);

  // the tile whose last step was just added: its sums, group by group in
  // order, to out
  auto flush = [&](int64_t t) {
    if constexpr (kGroups > 1) {
      __syncthreads();  // the last tile's sums are read
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
      const int o = r * 128 + l;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        out[t * kChunk + o + j] = carry[o + j] + static_cast<float>(acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = A(0);
  };

  // two cursors over (tile, step): the loads run one step ahead of the
  // adds, from tile to tile
  int64_t lt = blockIdx.y, at = blockIdx.y;
  unsigned ls = 0, as = 0;
  auto advance = [&](int64_t& t, unsigned& s) {
    if (++s == steps) {
      s = 0;
      t += gridDim.y;
    }
  };
  uint4 a[kUnroll], b[kUnroll];
  load_items<T, kGroups>(it, lt, ls * kStep + group, a);
  advance(lt, ls);
  while (true) {
    const bool more_b = lt < sh.tiles;  // the same for every thread
    if (more_b) {
      load_items<T, kGroups>(it, lt, ls * kStep + group, b);
      advance(lt, ls);
    }
    add_items<T, A, kVec>(a, acc);
    if (as + 1 == steps) flush(at);
    advance(at, as);
    if (!more_b) break;
    const bool more_a = lt < sh.tiles;
    if (more_a) {
      load_items<T, kGroups>(it, lt, ls * kStep + group, a);
      advance(lt, ls);
    }
    add_items<T, A, kVec>(b, acc);
    if (as + 1 == steps) flush(at);
    advance(at, as);
    if (!more_a) break;
  }
}

template <typename T>
int stream_sum(int n_in, const void* const* inputs, int64_t tiles,
               int64_t rows, int64_t width, int64_t row_stride,
               int64_t tile_stride, int parts, int blocks, const void* carry,
               void* out, void* stream) {
  // shapes and (input, chunk) items within a tile are 32-bit
  constexpr int64_t kMax32 = int64_t{1} << 31;
  if (n_in < 1 || n_in > kMaxInputs || blocks < 1 || blocks > 65535 ||
      blocks > tiles || (parts > 1 && blocks != tiles) || rows >= kMax32 ||
      width >= kMax32 || (rows / 8) * (width / 128) * n_in >= kMax32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Inputs in{};
  for (int i = 0; i < n_in; ++i) in.ptr[i] = inputs[i];
  const Shape sh{n_in, static_cast<int>(rows), static_cast<int>(width),
                 row_stride, tile_stride, tiles};
  const dim3 grid(static_cast<unsigned>(parts), static_cast<unsigned>(blocks));
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(carry);
  auto o = static_cast<float*>(out);
  switch (parts) {
    case 1: stream_sum_kernel<T, 1><<<grid, kThreads, 0, st>>>(in, sh, c, o); break;
    case 2: stream_sum_kernel<T, 2><<<grid, kThreads, 0, st>>>(in, sh, c, o); break;
    case 4: stream_sum_kernel<T, 4><<<grid, kThreads, 0, st>>>(in, sh, c, o); break;
    case 8: stream_sum_kernel<T, 8><<<grid, kThreads, 0, st>>>(in, sh, c, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
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
                   int64_t tile_stride, int parts, int blocks,
                   const void* carry, void* out, void* stream) {
  return stream_sum<float>(n_in, inputs, tiles, rows, width, row_stride,
                           tile_stride, parts, blocks, carry, out, stream);
}

int stream_sum_i8(int n_in, const void* const* inputs, int64_t tiles,
                  int64_t rows, int64_t width, int64_t row_stride,
                  int64_t tile_stride, int parts, int blocks,
                  const void* carry, void* out, void* stream) {
  return stream_sum<int8_t>(n_in, inputs, tiles, rows, width, row_stride,
                            tile_stride, parts, blocks, carry, out, stream);
}

}  // extern "C"
