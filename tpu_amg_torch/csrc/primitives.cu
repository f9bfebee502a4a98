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
// What bounds it is the SM's issue rate, 128 thread instructions a clock
// (4 schedulers, a warp instruction each), and its shared-memory pipe, one
// warp's access a clock (a wavefront: one word from each of the 32 banks;
// a warp shuffle takes one too).  A warp's lanes that read distinct words
// of one bank take a wavefront each, so a gather with data-random columns
// costs more than one: on the harness's inputs a warp's 32 random columns
// m of one row fall, on average, 2.78 deep in the fullest bank (a host
// count of the first design's addresses on the probe's inputs), and the
// first design, which read both of the pair's gathers from tables in shared
// memory, ran close to the floor that sets (PERF.md).  The design keeps everything but the body out of the loop (one
// block per tile, 4 elements per thread, the 8 index arrays and x in
// registers, indexed only by constants; 1 element a thread where the
// replica leaves one block an SM) and takes the data-random gathers off
// the banks' conflicts:
//
//   * the index gather of pair_gather and gather_fma, idx[k mod 8, s, m], is
//     a warp shuffle: a warp's 32 lanes share the tile row s, and row s of
//     each index array is held packed, a byte an entry (only its low 3 bits
//     are read), 4 entries a lane; entry m is byte m & 3 of lane m >> 2
//     (SHFL.IDX, then PRMT), where every lane's source is served at once;
//   * the x gather of lane_gather, pair_gather and gather_fma reads a
//     replica of the tile in shared memory, 32 copies interleaved so that
//     lane c reads copy c at word (row * 128 + m) * 32 + c: every lane in
//     its own bank, one wavefront (the 128 KB leave one block an SM, of
//     1,024 threads: an element each, so that 32 warps hide the gathers'
//     latency).
//
// Every element-step still issues its gathers (a shuffle and a load for the
// pair), nothing is precomputed across steps.  With one wavefront a gather,
// the pair's ~11 instructions an element-step (index and address
// arithmetic, the shuffle, the byte extract, the load, the FMA) bound it at
// the issue rate, above the bound's 3.  The other ops read the tile as it
// is, where their lanes already fall in distinct banks (the bfloat16 ones
// 2 deep: two lanes of a word read different rows).
//
// `inner` is a template parameter (the harness's LO = 16 and HI = 272), the
// k loop runs in blocks of 16 unrolled steps (fma's in full, so that its c_k
// folds), and a runtime step and volatile shared-memory reads keep the
// compiler from merging the body of one k with another's (below): the HI
// loop issues 17x the LO loop's body, which the SASS (cuobjdump
// --dump-sass) confirms.  The time per op is the difference of the two
// calls over (HI - LO) tile-ops, as in the harness.
//
// The host side (tpu_amg_torch/ops/primitives.py) checks shapes, types and
// alignment, allocates the output, passes PyTorch's current stream and
// checks the returned cudaGetLastError().

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
constexpr int kCopies = 32;  // the replica's copies of the tile: one a lane

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

// the pair: its index gather is a shuffle of packed registers
template <int OP>
constexpr bool kPair = OP == kPairGather || OP == kGatherFma;
// x gathered at a data-random column, from the replica
template <int OP>
constexpr bool kReplica = OP == kLaneGather || kPair<OP>;

// tile elements a thread: 4, but 1 where the replica's 128 KB leave one
// block an SM, so that the block's 32 warps hide the gathers' latency
template <int OP>
constexpr int kPer = kReplica<OP> ? 1 : kPerThread;

template <int OP>
constexpr int replica_bytes() {
  return kReplica<OP> ? kCopies * 8 * 128 * static_cast<int>(sizeof(float)) : 0;
}

constexpr int kBlockK = 16;  // steps of k unrolled in a block (LO = 16)

// fma's constant c_k is folded only in a fully unrolled loop; every other
// op runs the HI loop as 17 blocks of 16 unrolled steps, because unrolled
// in full their 1,088 shared-memory addresses are computed ahead and
// spill to local memory, and the probe would time the spills
template <int OP>
constexpr bool kFullUnroll = OP == kFma;

// byte (c & 3) of a in the low byte (the upper three are a's and b's next)
__device__ __forceinline__ unsigned byte_at(unsigned a, unsigned c) {
  unsigned r;
  asm("prmt.b32.f4e %0, %1, %1, %2;" : "=r"(r) : "r"(a), "r"(c));
  return r;
}

// x[row, i & 127] from the replica, lane c's copy: byte offset
// ((row * 128 + m) * 32 + c) * 4, with row_hi = row << 14 (its higher bits
// are dropped) and lane4 = c * 4
__device__ __forceinline__ float replica_at(const volatile unsigned char* xr,
                                            unsigned row_hi, unsigned i,
                                            unsigned lane4) {
  const unsigned off = (row_hi & 0x1c000u) | ((i & 127u) << 7) | lane4;
  return *reinterpret_cast<const volatile float*>(xr + off);
}

// what an element-step reads besides its own registers
template <typename T>
struct Gathers {
  const volatile typename Smem<T>::type* xs;  // the tile
  const volatile unsigned char* xr;           // the replica
  unsigned lane4;                             // lane * 4
};

// one step k of the body for element q, with index array k mod 8 (iq its
// entry of q, pq the packed row s of that array: entries 4c..4c+3 of lane
// c); kx = k * kstep, where kstep is 1 at run time and unknown to
// the compiler, so that (i + kx) has no period in k to fold (for a known
// k, (i + k) & 7 repeats every 8 steps, and a compiler merges the
// repeats); lane_sh and sub_sh are k % 127 + 1 and k % 7 + 1, the roll
// shifts.  Shared memory is read through volatile pointers and the shuffle
// source differs from step to step: every gather of the body is issued and
// none is merged with an equal one of another step.
template <typename T, int S, int OP>
__device__ __forceinline__ T body(int k, int kx, int lane_sh, int sub_sh,
                                  int q, T xq, int iq, unsigned pq,
                                  const Gathers<T>& g) {
  constexpr int N = S * 128;
  const int e = threadIdx.x + q * (N / kPer<OP>);
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
    return Smem<T>::get(g.xs[s * 128 + ((l - lane_sh) & 127)]);
  } else if constexpr (OP == kRollSub) {
    return Smem<T>::get(g.xs[((s - sub_sh) & 7) * 128 + l]);
  } else if constexpr (OP == kLaneGather) {
    return replica_at(g.xr, static_cast<unsigned>(s) << 14,
                      static_cast<unsigned>(i), g.lane4);
  } else if constexpr (OP == kBf16Lane) {
    return Smem<T>::get(g.xs[s * 128 + (i & 127)]);
  } else if constexpr (OP == kSubGather) {
    return Smem<T>::get(g.xs[(i & 7) * 128 + l]);
  } else if constexpr (OP == kBf16Sub) {
    return Smem<T>::get(g.xs[(i & 15) * 128 + l]);
  } else {  // kPairGather, kGatherFma
    // the row's index entry idx[s, i & 127] (its low 3 bits are read)
    const unsigned p = __shfl_sync(0xffffffffu, pq, static_cast<unsigned>(i) >> 2);
    const int r = static_cast<int>(byte_at(p, static_cast<unsigned>(i)));
    const T v = replica_at(g.xr, static_cast<unsigned>(r + kx) << 14,
                           static_cast<unsigned>(i), g.lane4);
    if constexpr (OP == kGatherFma) return v * xq;
    return v;
  }
}

template <typename T, typename I, int S, int OP, int INNER>
__global__ void __launch_bounds__(S * 128 / kPer<OP>)
probe_kernel(const T* __restrict__ x, const I* __restrict__ idx,
             T* __restrict__ out, int kstep) {
  using St = typename Smem<T>::type;
  constexpr int N = S * 128;
  constexpr int P = kPer<OP>;
  constexpr int NT = N / P;
  static_assert(INNER % kBlockK == 0, "inner is a multiple of 16");
  static_assert(!kPair<OP> || (S == 8 && sizeof(I) == 4),
                "the pair runs on (8, 128) float32 tiles with int32 indices");
  __shared__ St xs_[kReplica<OP> ? 1 : N];
  extern __shared__ __align__(16) unsigned char xr_[];  // the replica
  const Gathers<T> g{xs_, xr_, (threadIdx.x & 31u) * 4u};
  const int64_t t = blockIdx.x;
  const T* xt = x + t * N;
  const I* it = idx + t * kNidx * N;

  T xv[P];
  int iv[kNidx][P];
  unsigned pk[kNidx][P];  // packed rows (the pair)
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int e = threadIdx.x + q * NT;
    xv[q] = xt[e];
    if constexpr (kReplica<OP>) {
      // element e's 32 copies, 128 contiguous bytes, stored 16 at a time in
      // an order rotated by the lane: the 8 lanes of a quarter warp write
      // 8 distinct groups of 4 banks
      const float f = to_f(xv[q]);
      const float4 v4 = make_float4(f, f, f, f);
#pragma unroll
      for (int j = 0; j < kCopies / 4; ++j) {
        const int c4 = (j + static_cast<int>(threadIdx.x)) & (kCopies / 4 - 1);
        reinterpret_cast<float4*>(xr_ + e * kCopies * 4)[c4] = v4;
      }
    } else {
      xs_[e] = Smem<T>::put(xv[q]);
    }
#pragma unroll
    for (int m = 0; m < kNidx; ++m) {
      const I v = it[m * N + e];
      iv[m][q] = v;
      if constexpr (kPair<OP>) {
        // entries 4c..4c+3 of row s (the warp's row) of array m, a byte each
        const int4 w = reinterpret_cast<const int4*>(
            it + m * N + (e / 128) * 128)[threadIdx.x & 31];
        pk[m][q] = (w.x & 0xffu) | (w.y & 0xffu) << 8 | (w.z & 0xffu) << 16 |
                   static_cast<unsigned>(w.w) << 24;
      } else {
        pk[m][q] = 0;
      }
    }
  }
  __syncthreads();

  T acc[P];
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = T(to_f(xv[q]) * 0.0f);

  if constexpr (kFullUnroll<OP>) {
#pragma unroll
    for (int k = 0; k < INNER; ++k) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        acc[q] = add(acc[q], body<T, S, OP>(k, k * kstep, 0, 0, q, xv[q],
                                               iv[k % kNidx][q],
                                               pk[k % kNidx][q], g));
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
        for (int q = 0; q < P; ++q) {
          acc[q] = add(acc[q], body<T, S, OP>(k, k * kstep, lane_k + 1,
                                                 sub_k + 1, q, xv[q],
                                                 iv[kk % kNidx][q],
                                                 pk[kk % kNidx][q], g));
        }
        if constexpr (OP == kRollLane) lane_k = lane_k == 126 ? 0 : lane_k + 1;
        if constexpr (OP == kRollSub) sub_k = sub_k == 6 ? 0 : sub_k + 1;
      }
    }
  }
  T* ot = out + t * N;
#pragma unroll
  for (int q = 0; q < P; ++q) ot[threadIdx.x + q * NT] = acc[q];
}

template <typename T, typename I, int S, int OP, int INNER>
int launch_tile(int64_t tiles, const void* x, const void* idx, void* out,
                cudaStream_t stream) {
  auto kernel = probe_kernel<T, I, S, OP, INNER>;
  constexpr int smem = replica_bytes<OP>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(tiles), S * 128 / kPer<OP>, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const I*>(idx), static_cast<T*>(out), 1);
  return 0;
}

template <int OP, int INNER>
int launch(int64_t tiles, const void* x, const void* idx, void* out,
           cudaStream_t stream) {
  if constexpr (OP == kBf16Lane || OP == kBf16Sub) {
    return launch_tile<__nv_bfloat16, int16_t, 16, OP, INNER>(tiles, x, idx, out, stream);
  } else {
    return launch_tile<float, int32_t, 8, OP, INNER>(tiles, x, idx, out, stream);
  }
}

template <int OP>
int launch_inner(int inner, int64_t tiles, const void* x, const void* idx,
                 void* out, cudaStream_t stream) {
  switch (inner) {
    case 16: return launch<OP, 16>(tiles, x, idx, out, stream);
    case 272: return launch<OP, 272>(tiles, x, idx, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// op's design constants, which the host's checks read (ops/primitives.py:
// per_thread, SHUFFLED, REPLICATED, FULL_UNROLL, BLOCK_K): tile elements a
// thread, whether the index gather is a shuffle, whether x is read from the
// replica, whether the k loop is unrolled in full, steps of k a loop block
template <int OP>
int design_of(int* d) {
  d[0] = kPer<OP>;
  d[1] = kPair<OP>;
  d[2] = kReplica<OP>;
  d[3] = kFullUnroll<OP>;
  d[4] = kBlockK;
  return 0;
}

}  // namespace

extern "C" {

const char* primitives_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// op: the index of the Op enum; design: 5 ints (design_of)
int primitive_design(int op, int* design) {
  switch (op) {
    case kAdd: return design_of<kAdd>(design);
    case kFma: return design_of<kFma>(design);
    case kSelect: return design_of<kSelect>(design);
    case kRollLane: return design_of<kRollLane>(design);
    case kRollSub: return design_of<kRollSub>(design);
    case kLaneGather: return design_of<kLaneGather>(design);
    case kSubGather: return design_of<kSubGather>(design);
    case kPairGather: return design_of<kPairGather>(design);
    case kBf16Lane: return design_of<kBf16Lane>(design);
    case kBf16Sub: return design_of<kBf16Sub>(design);
    case kGatherFma: return design_of<kGatherFma>(design);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
