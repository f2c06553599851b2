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
// float32 (the dtype of the autotune pass) runs the register-tiled kernel
// f32_kernel below; bfloat16 and int8 run the first kernel, tiled_matmul_
// kernel, unchanged.
//
// What bounds the float32 kernel on the H100: there are no float32 tensor
// cores (TF32 would break the float32 tolerance), so its ceiling is the
// 67 TFLOP/s of FFMA on the CUDA cores.  Before that come the shared-memory
// reads that feed the FMAs and, for thin tiles, the L2 traffic the mapping
// itself forces (M*N*K*4*(1/bm + 1/bn) bytes).  What the design does:
//   - each thread owns a TM x TN micro-tile of the output (TM, TN in
//     {1, 2, 4, 8}) in registers; per 4 steps of k it reads TM float4 of x
//     and 4 y rows of TN values (TN/4 float4 each when TN >= 4) from shared
//     memory for 4*TM*TN FMAs (at 8x8 one read per 16 FMAs).  A 16-byte
//     copy cannot transpose, so x stays row-major and is read 4 k at a
//     time along its rows; thread (uy, ux)
//     owns rows uy + s*bm/TM and columns in 4-wide slabs bn*4/TN apart, so
//     the threads of one read phase touch neighbouring rows and columns
//     (x rows padded to an odd number of reads where room allows);
//   - the operand tiles arrive by cp.async, 16 bytes a copy where rows and
//     offsets are 16-byte aligned, else 4; each thread walks its copies
//     with no per-element division;
//   - where the accumulator stays in registers, the 4*bm*bn bytes it no
//     longer needs hold a second operand buffer when one fits, and the copy
//     of step s+1 is in flight while step s is multiplied;
//   - the host (kernels/tiled_matmul.py, launch_plan) picks TM, TN, the
//     thread count (32 to 256, whole warps), the accumulator's place, the
//     buffers, copy widths and offsets; the kernel only dispatches to the
//     16 (TM, TN) x 3 order instantiations.
// The first kernel (bfloat16, int8) multiplies one output element per
// thread at a time out of shared memory: bound by shared-memory reads and
// the FMA instruction rate, far below the 989 TFLOP/s bf16 / 1979 TOP/s
// int8 tensor-core peaks.  Tensor cores for those dtypes are later work.
// The order gene decides the work split, for both kernels:
//   "out": one block per (bm, bn) output tile, looping over K;
//   "a":   one block per row-block i; x(i,kk) stays in shared memory while
//          the block sweeps every column-block j, read-modify-writing
//          out(i,j) in device memory;
//   "b":   one block per column-block j, symmetric (y(kk,j) stationary).
// "a" and "b" run fewer, longer blocks: exactly the loss of parallelism
// the mapper's order axis should see measured.
//
// A launch requests at most smem_bytes(bm, bn, bk, sizeof(T)) =
// 4*bm*bn + (bm*bk + bk*bn)*sizeof(T) bytes of dynamic shared memory
// (kernels/tiled_matmul.py keeps the same formula; the bridge's legality
// tests it).  The first kernel requests all of it; the float32 kernel what
// its plan lays out, never more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

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

// ---------------------------------------------------------------------------
// float32: register micro-tiles fed by cp.async (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kMaxF32Threads = 256;

// The host's launch plan (kernels/tiled_matmul.py, launch_plan); offsets in
// bytes of dynamic shared memory.
struct F32Plan {
  int acc_smem;   // accumulator tile in shared memory at offset 0
  int buffers;    // 1 or 2 operand buffers
  int x_vec;      // x rows read 4 floats at a time
  int x_ld;       // floats from one staged x row to the next
  int x_copy16;   // 16-byte copies of the x tile, else 4-byte
  int y_copy16;   // 16-byte copies of the y tile, else 4-byte
  int ys_at[2];
  int xs_at[2];
};

template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread's copies of a tile with per_row chunks a row: chunk
// threadIdx.x + t * blockDim.x.  The two divisions happen once; each step
// then adds (dr, dc) and wraps the column at most once (dc < per_row).
struct Walk {
  int r, c, dr, dc, per_row;
};

__device__ __forceinline__ Walk make_walk(int per_row) {
  return {static_cast<int>(threadIdx.x) / per_row,
          static_cast<int>(threadIdx.x) % per_row,
          static_cast<int>(blockDim.x) / per_row,
          static_cast<int>(blockDim.x) % per_row, per_row};
}

// Stage rows of a row-major matrix (leading dimension ld) at dst, dst_ld
// floats apart, V floats a copy.
template <int V>
__device__ __forceinline__ void copy_walk(float* dst, int dst_ld,
                                          const float* __restrict__ src,
                                          int ld, int rows, Walk w) {
  for (int r = w.r, c = w.c; r < rows;) {
    cp_async<V>(dst + r * dst_ld + c * V,
                src + static_cast<size_t>(r) * ld + c * V);
    c += w.dc;
    r += w.dr;
    if (c >= w.per_row) {
      c -= w.per_row;
      ++r;
    }
  }
}

__device__ __forceinline__ void copy_tile(float* dst, int dst_ld,
                                          const float* __restrict__ src,
                                          int ld, int rows, Walk w,
                                          bool v16) {
  if (v16) {
    copy_walk<4>(dst, dst_ld, src, ld, rows, w);
  } else {
    copy_walk<1>(dst, dst_ld, src, ld, rows, w);
  }
}

// The TN values of one micro-tile row: 4-wide slabs `slab` floats apart
// when TN >= 4, else TN neighbours.  p is 16-byte (TN >= 4) or 8-byte
// (TN == 2) aligned, in shared or device memory.
template <int TN>
__device__ __forceinline__ void load_row(float (&v)[TN], const float* p,
                                         int slab) {
  if constexpr (TN >= 4) {
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const float4 q = *reinterpret_cast<const float4*>(p + g * slab);
      v[4 * g] = q.x;
      v[4 * g + 1] = q.y;
      v[4 * g + 2] = q.z;
      v[4 * g + 3] = q.w;
    }
  } else if constexpr (TN == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

template <int TN>
__device__ __forceinline__ void store_row(float* p, const float (&v)[TN],
                                          int slab) {
  if constexpr (TN >= 4) {
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      *reinterpret_cast<float4*>(p + g * slab) =
          make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
    }
  } else if constexpr (TN == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// acc += x rows (xr + s*x_step, s < TM) @ y columns (yc, slabs) over one
// K-block, k ascending, one fmaf per product.
template <int TM, int TN>
__device__ __forceinline__ void micro_product(float (&acc)[TM][TN],
                                              const float* xr, int x_step,
                                              const float* yc, int bn,
                                              int slab, int bk, bool x_vec) {
  if (x_vec) {
    for (int q = 0; q < bk; q += 4) {
      float a[TM][4];
#pragma unroll
      for (int s = 0; s < TM; ++s) {
        const float4 v =
            *reinterpret_cast<const float4*>(xr + s * x_step + q);
        a[s][0] = v.x;
        a[s][1] = v.y;
        a[s][2] = v.z;
        a[s][3] = v.w;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float b[TN];
        load_row<TN>(b, yc + (q + t) * bn, slab);
#pragma unroll
        for (int s = 0; s < TM; ++s) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[s][j] = fmaf(a[s][t], b[j], acc[s][j]);
          }
        }
      }
    }
  } else {
    for (int q = 0; q < bk; ++q) {
      float b[TN];
      load_row<TN>(b, yc + q * bn, slab);
#pragma unroll
      for (int s = 0; s < TM; ++s) {
        const float a = xr[s * x_step + q];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[s][j] = fmaf(a, b[j], acc[s][j]);
      }
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int s = 0; s < TM; ++s) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[s][j] = 0.0f;
  }
}

// ORDER: 0 = "out", 1 = "a", 2 = "b".  Steps run the K-blocks ("out") or
// the sweep's (kk, j) / (kk, i) pairs in order ("a" / "b").
// The explicit minimum of one block per SM matters: with the thread bound
// alone, ptxas spilled registers in the TN = 1, orders "a"/"b"
// instantiations at 48-80 registers.
template <int TM, int TN, int ORDER>
__global__ void __launch_bounds__(kMaxF32Threads, 1)
    f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ out, int m, int n, int k, int bm, int bn,
               int bk, F32Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem);
  const int gm = m / bm;
  const int gn = n / bn;
  const int gk = k / bk;
  const int steps = ORDER == 0 ? gk : gk * (ORDER == 1 ? gn : gm);
  // micro-tiles down and across; thread (uy, ux) owns rows uy + s*rows
  const int rows = bm / TM;
  const int cols = bn / TN;
  const int units = rows * cols;
  const int slab = TN >= 4 ? bn * 4 / TN : 0;
  const Walk wx = make_walk(p.x_copy16 ? bk / 4 : bk);
  const Walk wy = make_walk(p.y_copy16 ? bn / 4 : bn);

  auto coords = [&](int s, int& kk, int& i, int& j) {
    if (ORDER == 0) {
      kk = s;
      i = blockIdx.x / gn;
      j = blockIdx.x - i * gn;
    } else if (ORDER == 1) {
      kk = s / gn;
      j = s - kk * gn;
      i = blockIdx.x;
    } else {
      kk = s / gm;
      i = s - kk * gm;
      j = blockIdx.x;
    }
  };
  // (a select, not p.xs_at[b]: indexing the parameter at run time would
  // copy the plan to local memory)
  auto x_tile = [&](int b) {
    return reinterpret_cast<float*>(smem + (b ? p.xs_at[1] : p.xs_at[0]));
  };
  auto y_tile = [&](int b) {
    return reinterpret_cast<float*>(smem + (b ? p.ys_at[1] : p.ys_at[0]));
  };
  // Stage the copies of step s.  "a" keeps x(i,kk) over its sweep of j,
  // "b" keeps y(kk,j) over i: each buffer takes the stationary tile the
  // first time the sweep of a K-block uses that buffer.
  auto stage = [&](int s) {
    int kk, i, j;
    coords(s, kk, i, j);
    const int b = p.buffers == 2 ? (s & 1) : 0;
    if (ORDER != 1 || j < p.buffers) {
      copy_tile(x_tile(b), p.x_ld,
                x + static_cast<size_t>(i) * bm * k + kk * bk, k, bm, wx,
                p.x_copy16);
    }
    if (ORDER != 2 || i < p.buffers) {
      copy_tile(y_tile(b), bn, y + static_cast<size_t>(kk) * bk * n + j * bn,
                n, bk, wy, p.y_copy16);
    }
    cp_async_commit();
  };

  float acc[TM][TN];
  zero(acc);
  stage(0);
  for (int s = 0; s < steps; ++s) {
    if (p.buffers == 2 && s + 1 < steps) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int kk, i, j;
    coords(s, kk, i, j);
    const int b = p.buffers == 2 ? (s & 1) : 0;
    const float* xs = x_tile(b);
    const float* ys = y_tile(b);
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int uy = u / cols;
      const int col0 = (u - uy * cols) * (TN >= 4 ? 4 : TN);
      if (ORDER != 0 || (p.acc_smem && kk == 0)) {
        zero(acc);
      } else if (p.acc_smem) {
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          load_row<TN>(acc[r], acc_s + (uy + r * rows) * bn + col0, slab);
        }
      }
      micro_product<TM, TN>(acc, xs + uy * p.x_ld, rows * p.x_ld, ys + col0,
                            bn, slab, bk, p.x_vec);
      if (ORDER != 0) {
        // out(i,j) = out(i,j) + partial, the first K-block adding to zero
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          float* o = out + static_cast<size_t>(i * bm + uy + r * rows) * n +
                     j * bn + col0;
          float prev[TN];
          if (kk == 0) {
#pragma unroll
            for (int c = 0; c < TN; ++c) prev[c] = 0.0f;
          } else {
            load_row<TN>(prev, o, slab);
          }
#pragma unroll
          for (int c = 0; c < TN; ++c) prev[c] = __fadd_rn(prev[c], acc[r][c]);
          store_row<TN>(o, prev, slab);
        }
      } else if (p.acc_smem) {
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          store_row<TN>(acc_s + (uy + r * rows) * bn + col0, acc[r], slab);
        }
      }
    }
    __syncthreads();
    if (p.buffers == 1 && s + 1 < steps) stage(s + 1);
  }
  if (ORDER == 0) {
    const int i = blockIdx.x / gn;
    const int j = blockIdx.x - i * gn;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int uy = u / cols;
      const int col0 = (u - uy * cols) * (TN >= 4 ? 4 : TN);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        if (p.acc_smem) {
          load_row<TN>(acc[r], acc_s + (uy + r * rows) * bn + col0, slab);
        }
        store_row<TN>(out + static_cast<size_t>(i * bm + uy + r * rows) * n +
                          j * bn + col0,
                      acc[r], slab);
      }
    }
  }
}

struct F32Launch {
  int order, m, n, k, bm, bn, bk, tm, tn, threads, smem;
  const float* x;
  const float* y;
  float* out;
  F32Plan plan;
  cudaStream_t stream;
};

template <int TM, int TN, int ORDER>
cudaError_t launch_f32(const F32Launch& a) {
  auto kernel = f32_kernel<TM, TN, ORDER>;
  if (a.smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = ORDER == 0 ? (a.m / a.bm) * (a.n / a.bn)
                                : (ORDER == 1 ? a.m / a.bm : a.n / a.bn);
  kernel<<<blocks, a.threads, a.smem, a.stream>>>(
      a.x, a.y, a.out, a.m, a.n, a.k, a.bm, a.bn, a.bk, a.plan);
  return cudaGetLastError();
}

template <int TM, int TN>
cudaError_t f32_by_order(const F32Launch& a) {
  switch (a.order) {
    case 0:
      return launch_f32<TM, TN, 0>(a);
    case 1:
      return launch_f32<TM, TN, 1>(a);
    case 2:
      return launch_f32<TM, TN, 2>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int TM>
cudaError_t f32_by_tn(const F32Launch& a) {
  switch (a.tn) {
    case 1:
      return f32_by_order<TM, 1>(a);
    case 2:
      return f32_by_order<TM, 2>(a);
    case 4:
      return f32_by_order<TM, 4>(a);
    case 8:
      return f32_by_order<TM, 8>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t f32_by_tm(const F32Launch& a) {
  switch (a.tm) {
    case 1:
      return f32_by_tn<1>(a);
    case 2:
      return f32_by_tn<2>(a);
    case 4:
      return f32_by_tn<4>(a);
    case 8:
      return f32_by_tn<8>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The first kernel.  dtype: 1 = bfloat16, 2 = int8 (float32 goes to
// tiled_matmul_f32_launch); order: 0 = "out", 1 = "a", 2 = "b".  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int tiled_matmul_launch(int dtype, int order, const void* x,
                                   const void* y, void* out, int m, int n,
                                   int k, int bm, int bn, int bk,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_order<__nv_bfloat16>(order, x, y, out, m, n, k, bm, bn,
                                         bk, s);
    case 2:
      return launch_order<int8_t>(order, x, y, out, m, n, k, bm, bn, bk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The float32 kernel with the plan of launch_plan (kernels/tiled_matmul.py):
// micro-tile tm x tn, threads, the accumulator's place, operand buffers,
// x reads and row stride, copy widths, byte offsets of the y and x tiles in
// each buffer, and the bytes of shared memory to request.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int tiled_matmul_f32_launch(
    int order, const void* x, const void* y, void* out, int m, int n, int k,
    int bm, int bn, int bk, int tm, int tn, int threads, int acc_smem,
    int buffers, int x_vec, int x_ld, int x_copy16, int y_copy16, int ys0,
    int xs0, int ys1, int xs1, int smem, void* stream) {
  if (threads < 32 || threads > kMaxF32Threads || bm % tm || bn % tn) {
    return cudaErrorInvalidValue;
  }
  const F32Launch a{order, m, n, k, bm, bn, bk, tm, tn, threads, smem,
                    static_cast<const float*>(x),
                    static_cast<const float*>(y), static_cast<float*>(out),
                    F32Plan{acc_smem, buffers, x_vec, x_ld, x_copy16,
                            y_copy16, {ys0, ys1}, {xs0, xs1}},
                    static_cast<cudaStream_t>(stream)};
  return f32_by_tm(a);
}
