// On-chip primitive throughput probe for Hopper (sm_90a).
//
//   KG primitive_probe  out[t] = sum_{k < inner} body_op(x[t], idx[t, k mod 8], k),
//                       summed from x * 0 in x's type, in k order.
//                       Replaces the Pallas probe of the JAX package's
//                       tools/microbench_primitives.py (`make_kernel`, G1),
//                       which measured the VPU primitives a WELL x-window
//                       kernel is built from.
//
// A tile is (8, 128) float32 with int32 indices, or (16, 128) bfloat16 with
// int16 indices; idx holds 8 index arrays per tile, cycled by k.  The ops
// are the harness's bodies (microbench_primitives.py:96-143):
//
//   add          x + float((i + k) & 63)
//   fma          x * c_k + x, c_k = float(1.0 + 1e-7 k)
//   select       ((i + k) & 7) == 3 ? x : x + x
//   roll_lane    x rolled by k % 127 + 1 along the 128 lanes (jnp.roll)
//   roll_sub     x rolled by k % 7 + 1 along the 8 rows (jnp.roll)
//   lane_gather  x[s, (i + k) & 127]
//   sub_gather   x[(i + k) & 7, l]
//   pair_gather  r = x[(i + k) & 7, l], then r[s, (i + k) & 127]
//   bf16_lane    bfloat16 x[s, (i + k) & 127] over (16, 128)
//   bf16_sub     bfloat16 x[(i + k) & 15, l] over (16, 128)
//   gather_fma   pair_gather times x
//
// What bounds it is the SM's issue rate: 128 thread instructions a clock
// (4 schedulers, a warp instruction each) and 32 lanes' shared-memory
// loads a clock (one 128-byte wavefront).  The design keeps
// everything else out of the loop: one block per tile, 4 elements per
// thread, the tile's x (and, where an op reads another lane's index, its
// idx) staged once in shared memory; lane and row ops are shared-memory
// reads across a row of 128 or down the tile's rows; the 8 index arrays
// and x stay in registers, indexed only by constants.  `inner` is a
// template parameter (the harness's LO = 16 and HI = 272), the k loop runs
// in blocks of 16 unrolled steps (fma's in full, so that its c_k folds),
// and a runtime step and volatile shared-memory reads keep the compiler
// from merging the body of one k with another's (below): the HI loop
// issues 17x the LO loop's body, which the SASS (cuobjdump --dump-sass)
// confirms.  The time per op is the
// difference of the two calls over (HI - LO) tile-ops, as in the harness.
//
// The host side (tpu_amg_torch/ops/primitives.py) checks shapes and types,
// allocates the output, passes PyTorch's current stream and checks the
// returned cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Op : int {
  kAdd = 0,
  kFma,
  kSelect,
  kRollLane,
  kRollSub,
  kLaneGather,
  kSubGather,
  kPairGather,
  kBf16Lane,
  kBf16Sub,
  kGatherFma,
};

constexpr int kPerThread = 4;
constexpr int kNidx = 8;

// a tile element in shared memory: float32 as it is, bfloat16 as its bits
// (volatile loads need a plain type)
template <typename T>
struct Smem {
  using type = float;
  __device__ static float put(float v) { return v; }
  __device__ static float get(float v) { return v; }
};
template <>
struct Smem<__nv_bfloat16> {
  using type = unsigned short;
  __device__ static unsigned short put(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
  __device__ static __nv_bfloat16 get(unsigned short v) { return __ushort_as_bfloat16(v); }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// acc + v in the tile's type: float32, or bfloat16 rounded after each add
__device__ __forceinline__ float add(float acc, float v) { return acc + v; }
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 acc, __nv_bfloat16 v) {
  return __float2bfloat16_rn(__bfloat162float(acc) + __bfloat162float(v));
}

template <int OP>
constexpr bool kReadsOtherIdx = OP == kPairGather || OP == kGatherFma;

constexpr int kBlockK = 16;  // steps of k unrolled in a block (LO = 16)

// fma's constant c_k is folded only in a fully unrolled loop; every other
// op runs the HI loop as 17 blocks of 16 unrolled steps, because unrolled
// in full their 1,088 shared-memory addresses are computed ahead and
// spill to local memory, and the probe would time the spills
template <int OP>
constexpr bool kFullUnroll = OP == kFma;

// one step k of the body for element q, with index array m_idx = k mod 8
// (iq its entry of q); kx = k * kstep, where kstep is 1
// at run time and unknown to the compiler, so that (i + kx) has no period
// in k to fold (for a known k, (i + k) & 7 repeats every 8 steps, and a
// compiler merges the repeats); lane_sh and sub_sh are k % 127 + 1 and
// k % 7 + 1, the roll shifts.  Shared memory is read through volatile
// pointers: every load of the body is issued and none is merged with an
// equal one of another step.
template <typename T, typename I, int S, int OP>
__device__ __forceinline__ T body(int k, int kx, int lane_sh, int sub_sh,
                                  int q, T xq, int iq, int m_idx,
                                  const volatile typename Smem<T>::type* xs,
                                  const volatile I* is) {
  constexpr int N = S * 128;
  const int e = threadIdx.x + q * (N / kPerThread);
  const int s = e / 128;
  const int l = e % 128;
  const int i = iq + kx;
  if constexpr (OP == kAdd) {
    return xq + static_cast<float>(i & 63);
  } else if constexpr (OP == kFma) {
    const float c = static_cast<float>(1.0 + 1e-7 * k);
    return xq * c + xq;
  } else if constexpr (OP == kSelect) {
    return (i & 7) == 3 ? xq : xq + xq;
  } else if constexpr (OP == kRollLane) {
    return Smem<T>::get(xs[s * 128 + ((l - lane_sh) & 127)]);
  } else if constexpr (OP == kRollSub) {
    return Smem<T>::get(xs[((s - sub_sh) & 7) * 128 + l]);
  } else if constexpr (OP == kLaneGather || OP == kBf16Lane) {
    return Smem<T>::get(xs[s * 128 + (i & 127)]);
  } else if constexpr (OP == kSubGather) {
    return Smem<T>::get(xs[(i & 7) * 128 + l]);
  } else if constexpr (OP == kBf16Sub) {
    return Smem<T>::get(xs[(i & 15) * 128 + l]);
  } else {  // kPairGather, kGatherFma
    const int m = i & 127;
    const int row = (static_cast<int>(is[m_idx * N + s * 128 + m]) + kx) & 7;
    const T v = Smem<T>::get(xs[row * 128 + m]);
    if constexpr (OP == kGatherFma) return v * xq;
    return v;
  }
}

template <typename T, typename I, int S, int OP, int INNER>
__global__ void __launch_bounds__(S * 128 / kPerThread)
probe_kernel(const T* __restrict__ x, const I* __restrict__ idx,
             T* __restrict__ out, int kstep) {
  using St = typename Smem<T>::type;
  constexpr int N = S * 128;
  constexpr int NT = N / kPerThread;
  static_assert(INNER % kBlockK == 0, "inner is a multiple of 16");
  __shared__ St xs_[N];
  __shared__ I is_[kReadsOtherIdx<OP> ? kNidx * N : 1];
  const volatile St* xs = xs_;
  const volatile I* is = is_;
  const int64_t t = blockIdx.x;
  const T* xt = x + t * N;
  const I* it = idx + t * kNidx * N;

  T xv[kPerThread];
  int iv[kNidx][kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int e = threadIdx.x + q * NT;
    xv[q] = xt[e];
    xs_[e] = Smem<T>::put(xv[q]);
#pragma unroll
    for (int m = 0; m < kNidx; ++m) {
      const I v = it[m * N + e];
      iv[m][q] = v;
      if constexpr (kReadsOtherIdx<OP>) is_[m * N + e] = v;
    }
  }
  __syncthreads();

  T acc[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) acc[q] = T(to_f(xv[q]) * 0.0f);

  if constexpr (kFullUnroll<OP>) {
#pragma unroll
    for (int k = 0; k < INNER; ++k) {
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        acc[q] = add(acc[q], body<T, I, S, OP>(k, k * kstep, 0, 0, q, xv[q],
                                               iv[k % kNidx][q], k % kNidx,
                                               xs, is));
      }
    }
  } else {
    int lane_k = 0;  // k % 127
    int sub_k = 0;   // k % 7
#pragma unroll 1
    for (int k0 = 0; k0 < INNER; k0 += kBlockK) {
#pragma unroll
      for (int kk = 0; kk < kBlockK; ++kk) {
        const int k = k0 + kk;
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          acc[q] = add(acc[q], body<T, I, S, OP>(k, k * kstep, lane_k + 1,
                                                 sub_k + 1, q, xv[q],
                                                 iv[kk % kNidx][q],
                                                 kk % kNidx, xs, is));
        }
        if constexpr (OP == kRollLane) lane_k = lane_k == 126 ? 0 : lane_k + 1;
        if constexpr (OP == kRollSub) sub_k = sub_k == 6 ? 0 : sub_k + 1;
      }
    }
  }
  T* ot = out + t * N;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) ot[threadIdx.x + q * NT] = acc[q];
}

template <int OP, int INNER>
void launch(int64_t tiles, const void* x, const void* idx, void* out,
            cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(tiles);
  if constexpr (OP == kBf16Lane || OP == kBf16Sub) {
    probe_kernel<__nv_bfloat16, int16_t, 16, OP, INNER>
        <<<grid, 16 * 128 / kPerThread, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const int16_t*>(idx), static_cast<__nv_bfloat16*>(out),
            1);
  } else {
    probe_kernel<float, int32_t, 8, OP, INNER>
        <<<grid, 8 * 128 / kPerThread, 0, stream>>>(
            static_cast<const float*>(x), static_cast<const int32_t*>(idx),
            static_cast<float*>(out), 1);
  }
}

template <int OP>
int launch_inner(int inner, int64_t tiles, const void* x, const void* idx,
                 void* out, cudaStream_t stream) {
  switch (inner) {
    case 16: launch<OP, 16>(tiles, x, idx, out, stream); return 0;
    case 272: launch<OP, 272>(tiles, x, idx, out, stream); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* primitives_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// op: the index of the Op enum; inner: 16 or 272
int primitive_probe(int op, int inner, int64_t tiles, const void* x,
                    const void* idx, void* out, void* stream) {
  if (tiles < 1 || tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int code;
  switch (op) {
    case kAdd: code = launch_inner<kAdd>(inner, tiles, x, idx, out, s); break;
    case kFma: code = launch_inner<kFma>(inner, tiles, x, idx, out, s); break;
    case kSelect: code = launch_inner<kSelect>(inner, tiles, x, idx, out, s); break;
    case kRollLane: code = launch_inner<kRollLane>(inner, tiles, x, idx, out, s); break;
    case kRollSub: code = launch_inner<kRollSub>(inner, tiles, x, idx, out, s); break;
    case kLaneGather: code = launch_inner<kLaneGather>(inner, tiles, x, idx, out, s); break;
    case kSubGather: code = launch_inner<kSubGather>(inner, tiles, x, idx, out, s); break;
    case kPairGather: code = launch_inner<kPairGather>(inner, tiles, x, idx, out, s); break;
    case kBf16Lane: code = launch_inner<kBf16Lane>(inner, tiles, x, idx, out, s); break;
    case kBf16Sub: code = launch_inner<kBf16Sub>(inner, tiles, x, idx, out, s); break;
    case kGatherFma: code = launch_inner<kGatherFma>(inner, tiles, x, idx, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
