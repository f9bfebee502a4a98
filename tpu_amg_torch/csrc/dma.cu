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
// the 256 threads adds one float4 of it.
//
// A call whose bytes sit in the 50 MB L2 (8-32 MB) takes a few us, so the
// call's fixed costs count as much as its copy rate.  Two are kept small:
//
//   combine  the kernel writes carry + the blocks' (8, 128) partials
//            itself, with no launch before it to fill the output, in
//            two rounds of tickets (one integer atomic a block a round):
//            every block stores its partial and takes its group's ticket
//            (12 blocks a group); the group's last block sums the
//            group's partials, stores that and takes the groups' ticket;
//            the last of those sums the carry and the groups' sums and
//            writes the output.  Each round's loads are issued together
//            (12 rows a thread), so a round costs one trip to L2, where
//            one block summing 132 partials would take several.  The
//            sums run in block order and the tickets go back to 0.  (The
//            first design had the caller fill the output with the carry
//            and every block add its partial there with 1,024 float
//            atomics on the same 1,024 addresses: the clone and the
//            contended atomics cost more than the two rounds.)
//
// D2's share (64 KB a block at depth 1) is one bulk copy: cut into four of
// 16 KB on the same barrier it ran no faster.
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
constexpr int kGroup = 12;  // blocks whose partials one of them sums first
constexpr int kMaxGroups = 64;

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

// where the blocks' partials meet
struct Combine {
  const float* carry;  // (8, 128)
  float* partials;     // (blocks + groups, 8, 128)
  unsigned* tickets;   // 1 + groups, 0 between calls
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

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// sum + rows 0..n-1 (n <= kGroup) of p, (8, 128) each: this thread's
// float4 of every row, loaded together, added in row order
__device__ __forceinline__ float4 sum_rows(const float* p, int n, float4 sum) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    v[j] = j < n ? __ldcg(reinterpret_cast<const float4*>(p) + j * kThreads +
                          threadIdx.x)
                 : zero;
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) add4(sum, v[j]);
  return sum;
}

// true in the last of n blocks to call it with this ticket, which it
// sets back to 0: the barrier, then one thread's atomic add with release
// and acquire semantics (no full fence), so that every store a block made
// before the call is visible to the block that comes last
__device__ __forceinline__ bool last_of(unsigned* ticket, unsigned n) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(ticket)
                 : "memory");
    last = old == n - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  return last;
}

// out = carry + the partials (module comment)
__device__ __forceinline__ void finish(const Combine& c, const float4& acc,
                                       float* out) {
  constexpr int kRow = 8 * 128;
  const int nb = static_cast<int>(gridDim.x);
  const int g = static_cast<int>(blockIdx.x) / kGroup;
  const int groups = (nb + kGroup - 1) / kGroup;
  const int in_group = min(kGroup, nb - g * kGroup);
  float4* rows = reinterpret_cast<float4*>(c.partials);
  rows[blockIdx.x * kThreads + threadIdx.x] = acc;
  // the group's last block sums its partials into row nb + g
  if (!last_of(c.tickets + 1 + g, in_group)) return;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  rows[(nb + g) * kThreads + threadIdx.x] =
      sum_rows(c.partials + g * kGroup * kRow, in_group, zero);
  // the last of the groups' last blocks sums the carry and the groups'
  // sums
  if (!last_of(c.tickets, groups)) return;
  float4 sum = reinterpret_cast<const float4*>(c.carry)[threadIdx.x];
  for (int g0 = 0; g0 < groups; g0 += kGroup) {
    sum = sum_rows(c.partials + (nb + g0) * kRow, min(kGroup, groups - g0), sum);
  }
  reinterpret_cast<float4*>(out)[threadIdx.x] = sum;
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
dma_bulk_kernel(Sources s, Plan p, Combine c, float* __restrict__ out) {
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
  finish(c, acc, out);
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
dma_lsu_kernel(Sources s, Plan p, Combine c, float* __restrict__ out) {
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
  finish(c, acc, out);
}

template <typename Kernel>
int launch(Kernel kernel, int blocks, int smem, const Sources& s,
           const Plan& p, const Combine& c, float* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(s, p, c, out);
  return 0;
}

template <int D>
int launch_depth(int engine, int blocks, int smem, const Sources& s,
                 const Plan& p, const Combine& c, float* out,
                 cudaStream_t stream) {
  return engine == 0
             ? launch(dma_bulk_kernel<D>, blocks, smem, s, p, c, out, stream)
             : launch(dma_lsu_kernel<D>, blocks, smem, s, p, c, out, stream);
}

}  // namespace

extern "C" {

const char* dma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the ticket groups' size and most number, which the host's allocation of
// the partials and tickets reads (ops/dma.py: GROUP, MAX_GROUPS)
int dma_group() { return kGroup; }
int dma_max_groups() { return kMaxGroups; }

// engine 0 = bulk (TMA), 1 = lsu (cp.async); depth in {1, 2, 4, 8, 16};
// carry (8, 128), partials (blocks + groups, 8, 128) and 1 + groups tickets
// at 0, groups = ceil(blocks / 12) <= 64
int dma_probe(int engine, int depth, int n_src, const void* const* sources,
              int64_t src_bytes, int unit, int64_t chunk_bytes,
              int64_t touch_every, int blocks, const void* carry,
              void* partials, void* tickets, void* out, void* stream) {
  if (n_src < 1 || n_src > kMaxSources || unit <= 0 || unit % kHeadBytes ||
      src_bytes <= 0 || src_bytes % kHeadBytes || chunk_bytes <= 0 ||
      chunk_bytes % kHeadBytes || touch_every < 0 || blocks < 1 ||
      (engine != 0 && engine != 1) || carry == nullptr ||
      partials == nullptr || tickets == nullptr ||
      blocks > kGroup * kMaxGroups) {
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
  Combine c{static_cast<const float*>(carry), static_cast<float*>(partials),
            static_cast<unsigned*>(tickets)};
  const int smem = depth * unit;
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  int code;
  switch (depth) {
    case 1: code = launch_depth<1>(engine, blocks, smem, s, p, c, o, st); break;
    case 2: code = launch_depth<2>(engine, blocks, smem, s, p, c, o, st); break;
    case 4: code = launch_depth<4>(engine, blocks, smem, s, p, c, o, st); break;
    case 8: code = launch_depth<8>(engine, blocks, smem, s, p, c, o, st); break;
    case 16: code = launch_depth<16>(engine, blocks, smem, s, p, c, o, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
