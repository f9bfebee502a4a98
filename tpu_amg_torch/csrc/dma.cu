// Copy-engine probe for Hopper (sm_90a): device memory -> shared memory.
//
//   KD dma_probe  out = carry + sum over touched chunks c of src_0[c R : c R + 8, :]
//                 while every byte of every source is copied into shared
//                 memory.  Replaces the manual-DMA Pallas probes of the
//                 JAX package's tools/: dmabench.py `run_case.kernel` (D1:
//                 a ring of `depth` VMEM buffers fed by async copies) and
//                 dmabench2.py `k_whole` (D2: the whole array in VMEM),
//                 `k_multi` (D3: K sources in flight together) and
//                 `k_same` (D4: K copies in flight from one source).
//
// What it measures is the copy, so it is bound by bytes: every source
// byte crosses from device memory (or L2) into shared memory once; the
// touch adds a few KB per chunk.  The TPU's single core with megabytes
// of VMEM becomes one persistent block per SM with a ring of `depth`
// slots of `unit` bytes (depth x unit <= 227 KB); the bytes in flight
// per SM, depth x unit, are the probe's knob, as the TPU's chunk and
// depth were.  The engine is a template parameter:
//
//   bulk  one thread issues a 1-D TMA bulk copy per slot,
//         cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes,
//         completing on the slot's mbarrier; no registers or instructions
//         of the other threads are spent on the copy;
//   lsu   every thread issues 16-byte cp.async.cg copies for its share of
//         the slot, one commit group per slot, cp.async.wait_group to
//         consume the oldest.
//
// The sources are cut into units that never cross a source; unit u is
// unit u / n_src of source u % n_src, so consecutive ring slots hold
// different sources (D3) and a block's units are a contiguous range of
// that order.  A touched chunk's first 8 rows (4 KB) always lie inside
// one unit (units, chunks and sources are multiples of 4 KB); each of
// the 256 threads adds one float4 of it.  The blocks' (8, 128) partials
// go into the output, which the caller fills with the carry, by atomic
// adds: exact for integer-valued inputs, whatever the order.
//
// The host side (tpu_amg_torch/ops/dma.py) checks sizes and alignment,
// sets the dynamic shared memory, passes PyTorch's current stream and
// checks the returned cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSources = 8;
constexpr int kHeadBytes = 8 * 128 * 4;  // the touched rows of a chunk

struct Sources {
  const unsigned char* ptr[kMaxSources];
};

// Unit and chunk positions are counted in 4 KB atoms, in 32 bits: the
// loop does two 32-bit divisions a unit (64-bit ones would cost more than
// a small unit's copy)
struct Plan {
  int n_src;
  int64_t src_bytes;
  int units_per_src;
  int unit;         // bytes
  int unit_atoms;   // unit / 4 KB
  int chunk_atoms;  // chunk / 4 KB
  int touch_every;  // 0: touch nothing
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// unit u -> (source, index of the unit in its source, bytes)
__device__ __forceinline__ void unit_of(const Plan& p, int u, int* src,
                                        int* q, int* len) {
  *q = u / p.n_src;
  *src = u - *q * p.n_src;
  const int64_t left = p.src_bytes - static_cast<int64_t>(*q) * p.unit;
  *len = static_cast<int>(left < p.unit ? left : p.unit);
}

// add the touched chunk heads that lie in unit u, staged at buf
__device__ __forceinline__ void touch(const Plan& p, int u,
                                      const unsigned char* buf, float4& acc) {
  int src, q, len;
  unit_of(p, u, &src, &q, &len);
  if (src != 0 || p.touch_every == 0) return;
  const int a0 = q * p.unit_atoms;  // the unit's first atom
  const int a1 = a0 + len / kHeadBytes;
  for (int c = (a0 + p.chunk_atoms - 1) / p.chunk_atoms;
       c * p.chunk_atoms < a1; ++c) {
    if (c % p.touch_every) continue;
    const float4 v = reinterpret_cast<const float4*>(
        buf + static_cast<int64_t>(c * p.chunk_atoms - a0) * kHeadBytes)[threadIdx.x];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
}

__device__ __forceinline__ void block_range(const Plan& p, int* first, int* n) {
  const int64_t total = static_cast<int64_t>(p.n_src) * p.units_per_src;
  const int64_t b = blockIdx.x, nb = gridDim.x;
  *first = static_cast<int>(b * total / nb);
  *n = static_cast<int>((b + 1) * total / nb - *first);
}

__device__ __forceinline__ void add_out(float* out, const float4& acc) {
  float* o = out + 4 * threadIdx.x;
  atomicAdd(o + 0, acc.x);
  atomicAdd(o + 1, acc.y);
  atomicAdd(o + 2, acc.z);
  atomicAdd(o + 3, acc.w);
}

// ---- bulk (TMA) engine

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_issue(const Sources& s, const Plan& p,
                                           int u, unsigned char* dst,
                                           uint64_t* bar) {
  int src, q, len;
  unit_of(p, u, &src, &q, &len);
  const int64_t off = static_cast<int64_t>(q) * p.unit;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(len)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(s.ptr[src] + off), "r"(len), "r"(smem_addr(bar))
      : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dma_bulk_kernel(Sources s, Plan p, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[D];
  int first, n;
  block_range(p, &first, &n);
  if (threadIdx.x == 0) {
    for (int i = 0; i < D; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < D && i < n; ++i) {
      bulk_issue(s, p, first + i, ring + i * p.unit, &bars[i]);
    }
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n; ++i) {
    const int slot = i % D;
    mbar_wait(&bars[slot], static_cast<uint32_t>((i / D) & 1));
    touch(p, first + i, ring + slot * p.unit, acc);
    __syncthreads();  // every thread is done with the slot
    if (threadIdx.x == 0 && i + D < n) {
      bulk_issue(s, p, first + i + D, ring + slot * p.unit, &bars[slot]);
    }
  }
  add_out(out, acc);
}

// ---- lsu (cp.async) engine

__device__ __forceinline__ void lsu_issue(const Sources& s, const Plan& p,
                                          int u, unsigned char* dst) {
  int src, q, len;
  unit_of(p, u, &src, &q, &len);
  const unsigned char* g = s.ptr[src] + static_cast<int64_t>(q) * p.unit;
  for (int b = threadIdx.x * 16; b < len; b += kThreads * 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst + b)),
                 "l"(g + b)
                 : "memory");
  }
}

__device__ __forceinline__ void lsu_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dma_lsu_kernel(Sources s, Plan p, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ring[];
  int first, n;
  block_range(p, &first, &n);
  // one commit group per slot, empty ones included, so that group i is
  // complete once at most D - 1 groups are pending
  for (int i = 0; i < D; ++i) {
    if (i < n) lsu_issue(s, p, first + i, ring + i * p.unit);
    lsu_commit();
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n; ++i) {
    const int slot = i % D;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(D - 1) : "memory");
    __syncthreads();  // every thread's copies of the slot have landed
    touch(p, first + i, ring + slot * p.unit, acc);
    __syncthreads();  // every thread is done with the slot
    if (i + D < n) lsu_issue(s, p, first + i + D, ring + slot * p.unit);
    lsu_commit();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  add_out(out, acc);
}

template <typename Kernel>
int launch(Kernel kernel, int blocks, int smem, const Sources& s,
           const Plan& p, float* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(s, p, out);
  return 0;
}

template <int D>
int launch_depth(int engine, int blocks, int smem, const Sources& s,
                 const Plan& p, float* out, cudaStream_t stream) {
  return engine == 0 ? launch(dma_bulk_kernel<D>, blocks, smem, s, p, out, stream)
                     : launch(dma_lsu_kernel<D>, blocks, smem, s, p, out, stream);
}

}  // namespace

extern "C" {

const char* dma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// engine 0 = bulk (TMA), 1 = lsu (cp.async); depth in {1, 2, 4, 8, 16}
int dma_probe(int engine, int depth, int n_src, const void* const* sources,
              int64_t src_bytes, int unit, int64_t chunk_bytes,
              int64_t touch_every, int blocks, void* out, void* stream) {
  if (n_src < 1 || n_src > kMaxSources || unit <= 0 || unit % kHeadBytes ||
      src_bytes <= 0 || src_bytes % kHeadBytes || chunk_bytes <= 0 ||
      chunk_bytes % kHeadBytes || touch_every < 0 || blocks < 1 ||
      (engine != 0 && engine != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Sources s{};
  for (int i = 0; i < n_src; ++i) {
    s.ptr[i] = static_cast<const unsigned char*>(sources[i]);
  }
  const int64_t units_per_src = (src_bytes + unit - 1) / unit;
  if (units_per_src * n_src >= (int64_t{1} << 31) ||
      chunk_bytes / kHeadBytes >= (int64_t{1} << 31) ||
      touch_every >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p{n_src, src_bytes, static_cast<int>(units_per_src), unit,
         unit / kHeadBytes, static_cast<int>(chunk_bytes / kHeadBytes),
         static_cast<int>(touch_every)};
  const int smem = depth * unit;
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  int code;
  switch (depth) {
    case 1: code = launch_depth<1>(engine, blocks, smem, s, p, o, st); break;
    case 2: code = launch_depth<2>(engine, blocks, smem, s, p, o, st); break;
    case 4: code = launch_depth<4>(engine, blocks, smem, s, p, o, st); break;
    case 8: code = launch_depth<8>(engine, blocks, smem, s, p, o, st); break;
    case 16: code = launch_depth<16>(engine, blocks, smem, s, p, o, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
