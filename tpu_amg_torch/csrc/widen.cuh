// A stored value of type V widened to the compute type T, exactly: the
// sparse kernels (K1, K2 in csr_rowblock.cuh and spmv.cu, K3 in dia.cu)
// stream their values in V and multiply and sum in T, V no wider than T.
// The pairs (V, T) the libraries instantiate: (f64, f64), (f32, f32),
// (f32, f64), (bf16, f32), (bf16, f64).  For V = T the widening is the
// identity, so a (T, T) kernel compiles to what it was before V existed.

#pragma once

#include <cuda_bf16.h>

template <typename T, typename V>
__device__ __forceinline__ T widen(V v) {
  return static_cast<T>(v);  // T from T, or double from float: exact
}

template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <>
__device__ __forceinline__ double widen<double, __nv_bfloat16>(__nv_bfloat16 v) {
  return static_cast<double>(__bfloat162float(v));
}
