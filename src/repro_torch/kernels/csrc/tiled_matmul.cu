// Tiled matmul with a stationarity order, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/tiled_matmul.py::
// tiled_matmul (bodies _out_stationary_kernel and _accumulate_kernel).
// out (M,N) = x (M,K) @ y (K,N); x, y and out share one dtype: float32,
// bfloat16 or int8.  Blocks (bm, bn, bk) divide (M, N, K).
//
// Numerics carried over from the TPU kernel (grid order itself carries
// none here, since blocks run in parallel):
//   order "out": float32 accumulation over all of K, one cast at the end.
//   order "a"/"b": per output tile, K-blocks in ascending order; each
//     block's float32 partial is cast to the output dtype and added in
//     that dtype (int8 wraps modulo 256, bfloat16 rounds to nearest even).
//   float -> int8 casts saturate (NaN -> 0, clamp to [-128, 127], truncate),
//   as XLA's convert does.  float32 products use IEEE fmaf, never TF32.
//
// What bounds it on the H100: this first version multiplies on the CUDA
// cores out of shared memory (no tensor cores, no TMA), so it is bound by
// shared-memory reads and FMA issue, far below the 989 TFLOP/s bf16 /
// 1979 TOP/s int8 tensor-core peaks and the 3.35 TB/s memory bound.
// What the design does about it: each block stages its x and y tiles in
// shared memory once per K-block and keeps a float32 accumulator tile
// there, so every device-memory byte of a tile is read once per block;
// threads own fixed output elements, so consecutive threads read
// consecutive columns (coalesced loads, conflict-free shared reads).
// The order gene decides the work split:
//   "out": one block per (bm, bn) output tile, looping over K;
//   "a":   one block per row-block i; x(i,kk) stays in shared memory while
//          the block sweeps every column-block j, read-modify-writing
//          out(i,j) in device memory;
//   "b":   one block per column-block j, symmetric (y(kk,j) stationary).
// "a" and "b" run fewer, longer blocks: exactly the loss of parallelism
// the mapper's order axis should see measured.
//
// Every launch requests smem_bytes(bm, bn, bk, sizeof(T)) =
// 4*bm*bn + (bm*bk + bk*bn)*sizeof(T) bytes of dynamic shared memory
// (kernels/tiled_matmul.py keeps the same formula).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// from(): the float32 -> T cast; add(): T + T computed in T.
template <typename T>
struct Arith;

template <>
struct Arith<float> {
  __device__ static float from(float v) { return v; }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};

template <>
struct Arith<__nv_bfloat16> {
  __device__ static __nv_bfloat16 from(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
};

template <>
struct Arith<int8_t> {
  __device__ static int8_t from(float v) {
    if (v != v) return 0;
    v = fminf(fmaxf(v, -128.0f), 127.0f);
    return static_cast<int8_t>(__float2int_rz(v));
  }
  __device__ static int8_t add(int8_t a, int8_t b) {
    int s = static_cast<int>(a) + static_cast<int>(b);
    return static_cast<int8_t>(((s + 128) & 255) - 128);
  }
};

// Copy a rows x cols tile starting at (row0, col0) of a row-major matrix
// with leading dimension ld into shared memory (row-major, packed).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int ld, int row0, int col0,
                                          int rows, int cols) {
  const int count = rows * cols;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / cols;
    const int c = e - r * cols;
    dst[e] = src[static_cast<size_t>(row0 + r) * ld + col0 + c];
  }
}

// acc (bm x bn, float32) = [acc +] xs (bm x bk) @ ys (bk x bn).  Thread t
// owns elements t, t + blockDim.x, ...; no two threads touch one element.
template <typename T>
__device__ __forceinline__ void tile_product(float* acc, const T* xs,
                                             const T* ys, int bm, int bn,
                                             int bk, bool accumulate) {
  const int count = bm * bn;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / bn;
    const int c = e - r * bn;
    const T* xr = xs + r * bk;
    const T* yc = ys + c;
    float s = 0.0f;
    for (int q = 0; q < bk; ++q) {
      s = fmaf(to_f32(xr[q]), to_f32(yc[q * bn]), s);
    }
    acc[e] = accumulate ? __fadd_rn(acc[e], s) : s;
  }
}

// out(i,j) = out(i,j) + T(acc), the first K-block adding to zero.
template <typename T>
__device__ __forceinline__ void add_partial(T* __restrict__ out,
                                            const float* acc, int n, int i,
                                            int j, int bm, int bn,
                                            bool first) {
  const int count = bm * bn;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / bn;
    const int c = e - r * bn;
    T* o = out + static_cast<size_t>(i * bm + r) * n + j * bn + c;
    const T prev = first ? Arith<T>::from(0.0f) : *o;
    *o = Arith<T>::add(prev, Arith<T>::from(acc[e]));
  }
}

// ORDER: 0 = "out", 1 = "a", 2 = "b".
template <typename T, int ORDER>
__global__ void __launch_bounds__(kThreads)
    tiled_matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
                        T* __restrict__ out, int m, int n, int k, int bm,
                        int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  T* xs = reinterpret_cast<T*>(acc + bm * bn);
  T* ys = xs + bm * bk;
  const int gm = m / bm;
  const int gn = n / bn;
  const int gk = k / bk;

  if (ORDER == 0) {
    const int i = blockIdx.x / gn;
    const int j = blockIdx.x - i * gn;
    for (int kk = 0; kk < gk; ++kk) {
      load_tile(xs, x, k, i * bm, kk * bk, bm, bk);
      load_tile(ys, y, n, kk * bk, j * bn, bk, bn);
      __syncthreads();
      tile_product(acc, xs, ys, bm, bn, bk, kk > 0);
      __syncthreads();
    }
    const int count = bm * bn;
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      const int r = e / bn;
      const int c = e - r * bn;
      out[static_cast<size_t>(i * bm + r) * n + j * bn + c] =
          Arith<T>::from(acc[e]);
    }
  } else if (ORDER == 1) {
    const int i = blockIdx.x;
    for (int kk = 0; kk < gk; ++kk) {
      load_tile(xs, x, k, i * bm, kk * bk, bm, bk);
      for (int j = 0; j < gn; ++j) {
        load_tile(ys, y, n, kk * bk, j * bn, bk, bn);
        __syncthreads();
        tile_product(acc, xs, ys, bm, bn, bk, false);
        add_partial(out, acc, n, i, j, bm, bn, kk == 0);
        __syncthreads();
      }
    }
  } else {
    const int j = blockIdx.x;
    for (int kk = 0; kk < gk; ++kk) {
      load_tile(ys, y, n, kk * bk, j * bn, bk, bn);
      for (int i = 0; i < gm; ++i) {
        load_tile(xs, x, k, i * bm, kk * bk, bm, bk);
        __syncthreads();
        tile_product(acc, xs, ys, bm, bn, bk, false);
        add_partial(out, acc, n, i, j, bm, bn, kk == 0);
        __syncthreads();
      }
    }
  }
}

template <typename T, int ORDER>
cudaError_t launch(const void* x, const void* y, void* out, int m, int n,
                   int k, int bm, int bn, int bk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(bm) * bn +
                      sizeof(T) * (static_cast<size_t>(bm) * bk +
                                   static_cast<size_t>(bk) * bn);
  auto kernel = tiled_matmul_kernel<T, ORDER>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks =
      ORDER == 0 ? (m / bm) * (n / bn) : (ORDER == 1 ? m / bm : n / bn);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(out), m, n, k, bm, bn, bk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_order(int order, const void* x, const void* y, void* out,
                         int m, int n, int k, int bm, int bn, int bk,
                         cudaStream_t stream) {
  switch (order) {
    case 0:
      return launch<T, 0>(x, y, out, m, n, k, bm, bn, bk, stream);
    case 1:
      return launch<T, 1>(x, y, out, m, n, k, bm, bn, bk, stream);
    case 2:
      return launch<T, 2>(x, y, out, m, n, k, bm, bn, bk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8; order: 0 = "out", 1 = "a",
// 2 = "b".  Returns the cudaError_t of the launch (0 on success).
extern "C" int tiled_matmul_launch(int dtype, int order, const void* x,
                                   const void* y, void* out, int m, int n,
                                   int k, int bm, int bn, int bk,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_order<float>(order, x, y, out, m, n, k, bm, bn, bk, s);
    case 1:
      return launch_order<__nv_bfloat16>(order, x, y, out, m, n, k, bm, bn,
                                         bk, s);
    case 2:
      return launch_order<int8_t>(order, x, y, out, m, n, k, bm, bn, bk, s);
    default:
      return cudaErrorInvalidValue;
  }
}
