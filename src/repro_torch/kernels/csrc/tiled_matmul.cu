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
//   bfloat16 products are exact in float32, so the tensor cores' float32
//   accumulation differs from the reference only in the order of the sums.
//   int8 accumulates in int32, which is exact.  The reference states
//   float32 partials and sums, which could round once a running sum passes
//   2^24 (|partial| <= bk * 2^14 rules that out only for bk <= 1024; the
//   bridge's legal blocks reach bk = 3072 at ffn_down).  Probed where the
//   sums do pass it (M = N = 8, K = 3072 at bk = 3072 and 1536, four
//   seeds; tests/test_torch_kernels.py::test_int8_running_sums_past_2_to_24),
//   the reference gave the exact integer result in every order, so no
//   difference from the reference is known.  The plain version sums int8 in float64, exactly, for the same
//   reason (int8 holds kernel == plain exactly).
//
// float32 (the dtype of the autotune pass) runs the register-tiled kernel
// f32_kernel; bfloat16 and int8 (the bridge's 16- and 8-bit widths) run
// the tensor-core kernel mma_kernel.
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
// What bounds the bfloat16/int8 kernel: at the bridge's shapes (K <= 3072,
// M*N <= 1.6M) the 989 TFLOP/s bf16 and 1979 TOP/s int8 tensor-core peaks
// put every product under 2 us, below the bytes bound; the mapping's own
// blocks then decide.  Thin tiles ((64,2,16) "a": 12,288 dependent steps a
// block) are bound by the latency of each step, large ones by the shared-
// memory reads that feed the fragments.  What the design does:
//   - each warp owns FM x FN fragments of 16 x 8 outputs (layouts 1x1, 2x2,
//     2x4, 4x4, 4x8) and multiplies them with mma.sync (m16n8k16 bf16 ->
//     f32, m16n8k32 s8 -> s32), one k-fragment at a time; up to 8 warps
//     (255 registers a thread) cover the tile, in passes when it has more
//     fragments than that;
//   - whole fragments come from shared memory by ldmatrix (x4 for x at both
//     widths, x2.trans for bfloat16 y); a fragment that reaches past the
//     tile in rows, columns or k is read element by element under a
//     predicate and is zero in registers past the tile, so shared memory is
//     never read past a tile and garbage bits (NaN, Inf) never meet a zero;
//     int8 y (4 consecutive k of one column a register) is gathered with
//     byte reads, since ldmatrix.trans transposes 16-bit elements only;
//   - the moving tiles (x and y for "out", y for "a", x for "b") go through
//     a ring of up to 4 stages staged 1..3 steps ahead: cp.async copies of
//     16, 8 or 4 bytes where rows and addresses allow, else ordinary loads
//     into registers a step ahead (rows under 4 bytes: int8 y at bn = 2,
//     bfloat16 y at bn = 1, int8 x at bk = 2, 6 or 9);
//   - rows are padded where the formula leaves room so that fragment reads
//     fall on distinct banks;
//   - orders "a"/"b" read every previous output value of a step one step
//     ahead and write after the product, two neighbouring outputs an
//     access; warps of one fragment (the thin tiles, whose steps are bound
//     by latency) run four steps of a sweep an iteration, on up to four
//     copies of the warp grid, through a ring of 8 to 16 stages;
//   - the accumulator stays in registers where one pass covers the tile,
//     and its 4*bm*bn bytes then hold more stages; otherwise ("out" with
//     more than 8 warps' fragments) it lives there, at offset 0;
//   - the host (launch_plan / mma_plan) picks the layout, warps, passes,
//     stages, row strides, copy widths and offsets; the kernel dispatches
//     to 26 instantiations: 2 dtypes x (5 layouts for "out" + 3 for each
//     of "a" and "b" + the four-step one-fragment kernel of "a" and "b").
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
// tests it).  Each kernel requests what its plan lays out, never more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDefaultSmem = 48 * 1024;

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

// ---------------------------------------------------------------------------
// bfloat16 and int8: tensor-core fragments (mma.sync) fed by a ring of
// operand stages (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kMaxMmaThreads = 256;
// Four steps an iteration (one-fragment warps): up to four copies of the
// warp grid, 16 warps, at 128 registers a thread.
constexpr int kMaxGroupThreads = 512;
// Elements of a tile staged through registers that each thread holds a
// step ahead; the rest of such a tile is copied when it is stored.
constexpr int kHeld = 2;

// The host's launch plan (kernels/tiled_matmul.py, launch_plan); offsets in
// bytes of dynamic shared memory.
struct MmaPlan {
  int warps_m, warps_n;    // warp grid of one pass over the tile
  int passes_m, passes_n;  // passes over the tile's fragments
  int acc_smem;            // accumulator tile in shared memory at offset 0
  int stages;              // ring stages of the moving tiles: 1..4, 8..16
  int x_ld, y_ld;          // elements from one staged row to the next
  int x_copy, y_copy;      // bytes a cp.async copies; 0 = through registers
  int x_word;              // staged x rows 4-byte aligned
  int xs_at, ys_at;        // x and y tiles in stage 0, or the stationary one
  int stage_bytes;         // bytes from one ring stage to the next
  int group;               // steps an iteration (1, or 4: see mma_kernel)
};

// One warp's m16n8 product over one k-fragment: d += a @ b.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kK = 16;
  __device__ static void run(float (&d)[4], const uint32_t (&a)[4],
                             const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
  // the float32 -> bfloat16 cast, round to nearest even
  __device__ static __nv_bfloat16 cast(float v) {
    return Arith<__nv_bfloat16>::from(v);
  }
};

template <>
struct Mma<int8_t> {
  using Acc = int;
  static constexpr int kK = 32;
  __device__ static void run(int (&d)[4], const uint32_t (&a)[4],
                             const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
  // the saturating cast (clamp to [-128, 127])
  __device__ static int8_t cast(int v) {
    return static_cast<int8_t>(min(max(v, -128), 127));
  }
};

template <typename T>
__device__ __forceinline__ uint32_t bits_at(const unsigned char* p) {
  if constexpr (sizeof(T) == 2) {
    return *reinterpret_cast<const uint16_t*>(p);
  } else {
    return *p;
  }
}

// The 4 bytes of consecutive k (k, k+1, ...) of one staged x row, zero from
// bk on; one 4-byte read when the row is word aligned and all are in range.
template <typename T>
__device__ __forceinline__ uint32_t row_group(const unsigned char* row,
                                              int k, int bk, bool word) {
  constexpr int G = 4 / sizeof(T);
  if (word && k + G <= bk) {
    return *reinterpret_cast<const uint32_t*>(row + k * sizeof(T));
  }
  uint32_t v = 0;
#pragma unroll
  for (int e = 0; e < G; ++e) {
    if (k + e < bk) v |= bits_at<T>(row + (k + e) * sizeof(T)) << (8 * sizeof(T) * e);
  }
  return v;
}

// The 4 bytes of consecutive k of column c of the staged y tile (row-major,
// y_ld elements a row), zero from bk on.
template <typename T>
__device__ __forceinline__ uint32_t col_group(const unsigned char* ys,
                                              int y_ld, int k, int c,
                                              int bk) {
  constexpr int G = 4 / sizeof(T);
  uint32_t v = 0;
#pragma unroll
  for (int e = 0; e < G; ++e) {
    if (k + e < bk) {
      v |= bits_at<T>(ys + (static_cast<size_t>(k + e) * y_ld + c) * sizeof(T))
           << (8 * sizeof(T) * e);
    }
  }
  return v;
}

// A warp's four 8 x 8 matrices of 16-bit elements (8 rows of 16 bytes
// each) from shared memory at shared-space address s, lanes 8q..8q+7
// naming the rows of matrix q; .trans delivers each matrix transposed.
// The memory clobber keeps a read of a tile that does not move (orders
// "a"/"b") inside the step loop, after the barrier that restages it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], unsigned s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  unsigned s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The 4 bytes of G consecutive k of one staged y column, all inside the
// tile: p points at the first, rows y_ld elements apart.
template <typename T>
__device__ __forceinline__ uint32_t col_bits(const unsigned char* p,
                                             int y_ld) {
  if constexpr (sizeof(T) == 2) {
    return bits_at<T>(p) | (bits_at<T>(p + 2 * y_ld) << 16);
  } else {
    return __byte_perm(__byte_perm(p[0], p[y_ld], 0x0040),
                       __byte_perm(p[2 * y_ld], p[3 * y_ld], 0x0040),
                       0x5410);
  }
}

template <int W>
__device__ __forceinline__ void cp_async_bytes(unsigned char* dst,
                                               const unsigned char* src) {
  const unsigned s = shared_addr(dst);
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(W)
                 : "memory");
  }
}

// Stage rows (device rows ld bytes apart) at dst, dst_ld bytes apart, W
// bytes a copy, walking this thread's copies with w (make_walk of the
// copies a row, computed once a launch).
template <int W>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_ld,
                                          const unsigned char* src,
                                          size_t ld, int rows, Walk w) {
  for (int r = w.r, c = w.c; r < rows;) {
    cp_async_bytes<W>(dst + r * dst_ld + c * W, src + r * ld + c * W);
    c += w.dc;
    r += w.dr;
    if (c >= w.per_row) {
      c -= w.per_row;
      ++r;
    }
  }
}

__device__ __forceinline__ void copy_async(unsigned char* dst, int dst_ld,
                                           const unsigned char* src,
                                           size_t ld, int rows, Walk w,
                                           int width) {
  if (width == 16) {
    copy_rows<16>(dst, dst_ld, src, ld, rows, w);
  } else if (width == 8) {
    copy_rows<8>(dst, dst_ld, src, ld, rows, w);
  } else {
    copy_rows<4>(dst, dst_ld, src, ld, rows, w);
  }
}

__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  if (pending >= 2) {
    cp_async_wait<2>();
  } else if (pending == 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

// A tile staged through registers (rows narrower than a 4-byte copy):
// this thread's elements walk the tile as w (make_walk of its columns)
// says, the first kHeld of them held in v a step ahead.
template <typename T>
__device__ __forceinline__ void held_load(T (&v)[kHeld],
                                          const T* __restrict__ src,
                                          size_t ld, int rows, Walk w) {
  int r = w.r, c = w.c;
#pragma unroll
  for (int q = 0; q < kHeld; ++q) {
    if (r < rows) v[q] = src[r * ld + c];
    c += w.dc;
    r += w.dr;
    if (c >= w.per_row) {
      c -= w.per_row;
      ++r;
    }
  }
}

// Store the held elements, then copy the rest of the tile.
template <typename T>
__device__ __forceinline__ void held_store(unsigned char* dst, int dst_ld,
                                           const T (&v)[kHeld],
                                           const T* __restrict__ src,
                                           size_t ld, int rows, Walk w) {
  T* d = reinterpret_cast<T*>(dst);
  int r = w.r, c = w.c;
#pragma unroll
  for (int q = 0; q < kHeld; ++q) {
    if (r < rows) d[r * dst_ld + c] = v[q];
    c += w.dc;
    r += w.dr;
    if (c >= w.per_row) {
      c -= w.per_row;
      ++r;
    }
  }
  while (r < rows) {
    d[r * dst_ld + c] = src[r * ld + c];
    c += w.dc;
    r += w.dr;
    if (c >= w.per_row) {
      c -= w.per_row;
      ++r;
    }
  }
}

// Copy a whole tile element by element (a stationary tile staged through
// registers, once a sweep).
template <typename T>
__device__ __forceinline__ void copy_elems(unsigned char* dst, int dst_ld,
                                           const T* __restrict__ src,
                                           size_t ld, int rows, Walk w) {
  T* d = reinterpret_cast<T*>(dst);
  for (int r = w.r, c = w.c; r < rows;) {
    d[r * dst_ld + c] = src[r * ld + c];
    c += w.dc;
    r += w.dr;
    if (c >= w.per_row) {
      c -= w.per_row;
      ++r;
    }
  }
}

// Two neighbouring outputs (c, c + 1) of a row: one 4-byte (bfloat16) or
// 2-byte (int8) access at an even element.
template <typename T>
__device__ __forceinline__ void load_pair(const T* p, T& lo, T& hi) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    lo = v.x;
    hi = v.y;
  } else {
    const char2 v = *reinterpret_cast<const char2*>(p);
    lo = v.x;
    hi = v.y;
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, T lo, T hi) {
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162 v;
    v.x = lo;
    v.y = hi;
    *reinterpret_cast<__nv_bfloat162*>(p) = v;
  } else {
    *reinterpret_cast<char2*>(p) = make_char2(lo, hi);
  }
}

// ORDER: 0 = "out", 1 = "a", 2 = "b".  Each warp owns FM x FN fragments of
// 16 x 8 outputs in each pass.  Steps run the K-blocks ("out") or the
// sweep's (kk, j) / (kk, i) pairs in order ("a" / "b"), as in f32_kernel;
// U > 1 runs U steps of a sweep an iteration (one fragment a warp).
template <typename T, int ORDER, int FM, int FN, int U>
__global__ void __launch_bounds__(U > 1 ? kMaxGroupThreads : kMaxMmaThreads,
                                  1)
    mma_kernel(const T* __restrict__ x, const T* __restrict__ y,
               T* __restrict__ out, int m, int n, int k, int bm, int bn,
               int bk, MmaPlan p) {
  using Acc = typename Mma<T>::Acc;
  constexpr int S = sizeof(T);
  constexpr int KF = Mma<T>::kK;
  constexpr int G = 4 / S;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* acc_s = reinterpret_cast<Acc*>(smem);
  const int gm = m / bm;
  const int gn = n / bn;
  const int gk = k / bk;
  const int steps = ORDER == 0 ? gk : gk * (ORDER == 1 ? gn : gm);
  const int ns = p.stages;
  const int frags_m = (bm + 15) / 16;
  const int frags_n = (bn + 7) / 8;
  const bool one_pass = p.passes_m * p.passes_n == 1;
  // outputs (c, c + 1) go as one access when bn (so n, so every row
  // start) is even
  const bool pairs = bn % 2 == 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // U > 1: the block runs blockDim.x / (32 * warps) groups of the warp
  // grid, group gi taking steps gi, gi + groups, ... of each iteration
  const int grid_warps = p.warps_m * p.warps_n;
  const int groups = U > 1 ? static_cast<int>(blockDim.x) / (32 * grid_warps)
                           : 1;
  const int gi = warp / grid_warps;
  const int wm = warp % grid_warps % p.warps_m;
  const int wn = warp % grid_warps / p.warps_m;
  const T zero_t = Arith<T>::from(0.0f);
  // staged rows and tiles 16-byte aligned: whole fragments by ldmatrix
  // (bfloat16 y) and x
  const bool x_mat = (p.x_ld * S) % 16 == 0 && p.xs_at % 16 == 0 &&
                     (ORDER == 1 || p.stage_bytes % 16 == 0);
  const bool y_mat = S == 1 || ((p.y_ld * S) % 16 == 0 &&
                                p.ys_at % 16 == 0 &&
                                (ORDER == 2 || p.stage_bytes % 16 == 0));
  // each thread's copies of a tile row by row: cp.async chunks, or
  // elements where the tile goes through registers
  const Walk wx = make_walk(p.x_copy ? bk * S / p.x_copy : bk);
  const Walk wy = make_walk(p.y_copy ? bn * S / p.y_copy : bn);

  // A step's place: K-block kk, row block i, column block j, advanced
  // without a division.
  struct Pos {
    int kk, i, j;
  };
  auto advance = [&](Pos& q) {
    if (ORDER == 0) {
      ++q.kk;
    } else if (ORDER == 1) {
      if (++q.j == gn) {
        q.j = 0;
        ++q.kk;
      }
    } else if (++q.i == gm) {
      q.i = 0;
      ++q.kk;
    }
  };
  const int blk = static_cast<int>(blockIdx.x);
  const Pos first = ORDER == 0   ? Pos{0, blk / gn, blk % gn}
                    : ORDER == 1 ? Pos{0, blk, 0}
                                 : Pos{0, 0, blk};
  auto x_tile = [&](int slot) {
    return smem + p.xs_at + (ORDER == 1 ? 0 : slot * p.stage_bytes);
  };
  auto y_tile = [&](int slot) {
    return smem + p.ys_at + (ORDER == 2 ? 0 : slot * p.stage_bytes);
  };
  auto x_src = [&](const Pos& q) {
    return x + static_cast<size_t>(q.i) * bm * k + q.kk * bk;
  };
  auto y_src = [&](const Pos& q) {
    return y + static_cast<size_t>(q.kk) * bk * n + q.j * bn;
  };
  auto copy_x = [&](unsigned char* dst, const T* src) {
    copy_async(dst, p.x_ld * S, reinterpret_cast<const unsigned char*>(src),
               static_cast<size_t>(k) * S, bm, wx, p.x_copy);
  };
  auto copy_y = [&](unsigned char* dst, const T* src) {
    copy_async(dst, p.y_ld * S, reinterpret_cast<const unsigned char*>(src),
               static_cast<size_t>(n) * S, bk, wy, p.y_copy);
  };

  // The moving tiles of a step: x in orders "out"/"b", y in "out"/"a";
  // tiles staged through registers are held per step of an iteration (v).
  T hx[U][kHeld], hy[U][kHeld];
  auto issue_async = [&](const Pos& q, int slot, bool valid,
                         bool commit = true) {
    if (valid) {
      if (ORDER != 1 && p.x_copy) copy_x(x_tile(slot), x_src(q));
      if (ORDER != 2 && p.y_copy) copy_y(y_tile(slot), y_src(q));
    }
    if (commit) cp_async_commit();
  };
  auto issue_held = [&](const Pos& q, bool valid, int v = 0) {
    if (!valid) return;
    if (ORDER != 1 && !p.x_copy) held_load(hx[v], x_src(q), k, bm, wx);
    if (ORDER != 2 && !p.y_copy) held_load(hy[v], y_src(q), n, bk, wy);
  };
  auto store_held = [&](const Pos& q, int slot, bool valid, int v = 0) {
    if (!valid) return;
    if (ORDER != 1 && !p.x_copy) {
      held_store(x_tile(slot), p.x_ld, hx[v], x_src(q), k, bm, wx);
    }
    if (ORDER != 2 && !p.y_copy) {
      held_store(y_tile(slot), p.y_ld, hy[v], y_src(q), n, bk, wy);
    }
  };
  // The stationary tile of a sweep ("a": x(i,kk), "b": y(kk,j)), staged
  // when the sweep of a K-block starts; every thread is past the last step.
  auto load_stationary = [&](const Pos& q) {
    if (ORDER == 1) {
      if (p.x_copy) {
        copy_x(smem + p.xs_at, x_src(q));
      } else {
        copy_elems(smem + p.xs_at, p.x_ld, x_src(q), k, bm, wx);
      }
    } else {
      if (p.y_copy) {
        copy_y(smem + p.ys_at, y_src(q));
      } else {
        copy_elems(smem + p.ys_at, p.y_ld, y_src(q), n, bk, wy);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };

  // This thread's outputs of fragment (fm0 + a, fn0 + b): rows fm*16 + g
  // (h = 0) and + 8 (h = 1), columns fn*8 + 2t and + 1, held as
  // v[a][b][2h], v[a][b][2h + 1] (the mma accumulator layout).
  auto row_ptr = [&](const Pos& q, int r, int c) {
    return out + static_cast<size_t>(q.i * bm + r) * n + q.j * bn + c;
  };
  auto for_outputs = [&](int fm0, int fn0, auto&& fn) {
#pragma unroll
    for (int a = 0; a < FM; ++a)
#pragma unroll
      for (int b = 0; b < FN; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (fm0 + a) * 16 + g + 8 * h;
          const int c = (fn0 + b) * 8 + 2 * t;
          if (fm0 + a < frags_m && fn0 + b < frags_n && r < bm && c < bn) {
            fn(a, b, h, r, c);
          }
        }
  };
  Acc acc[FM][FN][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int a = 0; a < FM; ++a)
#pragma unroll
      for (int b = 0; b < FN; ++b)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][b][q] = Acc(0);
  };
  // Write T(acc) to out, after adding it to `before` in orders "a"/"b".
  auto write_out = [&](const Pos& q, int fm0, int fn0, auto&& before) {
    for_outputs(fm0, fn0, [&](int a, int b, int h, int r, int c) {
      T lo = Mma<T>::cast(acc[a][b][2 * h]);
      T hi = Mma<T>::cast(acc[a][b][2 * h + 1]);
      if constexpr (ORDER != 0) {
        lo = Arith<T>::add(before[a][b][2 * h], lo);
        hi = Arith<T>::add(before[a][b][2 * h + 1], hi);
      }
      T* o = row_ptr(q, r, c);
      if (pairs) {
        store_pair(o, lo, hi);
      } else {
        o[0] = lo;
        if (c + 1 < bn) o[1] = hi;
      }
    });
  };
  // The previous output values of orders "a"/"b" (zero for the first
  // K-block), all read before any is written.
  T before[ORDER != 0 ? FM : 1][ORDER != 0 ? FN : 1][4];
  auto read_before = [&](auto& before, const Pos& q, int fm0, int fn0) {
    if constexpr (ORDER != 0) {
#pragma unroll
      for (int a = 0; a < FM; ++a)
#pragma unroll
        for (int b = 0; b < FN; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) before[a][b][e] = zero_t;
      if (q.kk == 0) return;
      for_outputs(fm0, fn0, [&](int a, int b, int h, int r, int c) {
        const T* o = row_ptr(q, r, c);
        if (pairs) {
          load_pair(o, before[a][b][2 * h], before[a][b][2 * h + 1]);
        } else {
          before[a][b][2 * h] = o[0];
          if (c + 1 < bn) before[a][b][2 * h + 1] = o[1];
        }
      });
    }
  };
  // acc += x rows of fragments fm0.. @ y columns of fragments fn0.. over
  // the K-block, one k-fragment at a time.  Fragments inside the tile are
  // read by ldmatrix from addresses computed once (x: rows inside, k whole
  // or half a fragment; bfloat16 y: columns inside, k whole); int8 y by
  // bytes; the rest element by element, zero in registers past the tile.
  auto product = [&](const unsigned char* xs, const unsigned char* ys,
                     int fm0, int fn0) {
    const bool x_fast = x_mat && (fm0 + FM) * 16 <= bm;
    const bool y_fast = y_mat && (fn0 + FN) * 8 <= bn;
    unsigned xa[FM];
#pragma unroll
    for (int a = 0; a < FM; ++a) {
      xa[a] = shared_addr(xs) +
              (((fm0 + a) * 16 + (lane & 15)) * p.x_ld * S + (lane >> 4) * 16);
    }
    // bfloat16: ldmatrix.trans rows k0 + (lane & 15); int8: bytes of rows
    // k0 + 4t + e, column g
    const unsigned char* yb =
        ys + ((S == 2 ? (lane & 15) : 4 * t) * p.y_ld + fn0 * 8 +
              (S == 2 ? 0 : g)) * S;
    const int y_half = (KF / 2) * p.y_ld;
    // int8 y: 4 consecutive k of column g, bytes p.y_ld apart
    auto y_bytes = [&](const unsigned char* c) {
      return __byte_perm(__byte_perm(c[0], c[p.y_ld], 0x0040),
                         __byte_perm(c[2 * p.y_ld], c[3 * p.y_ld], 0x0040),
                         0x5410);
    };
    if (x_fast && y_fast && bk % KF == 0) {
      // the whole tile: a tight loop with no predicate
      for (int k0 = 0; k0 < bk; k0 += KF, yb += KF * p.y_ld * S) {
        uint32_t af[FM][4];
#pragma unroll
        for (int a = 0; a < FM; ++a) ldmatrix_x4(af[a], xa[a] + k0 * S);
#pragma unroll
        for (int b = 0; b < FN; ++b) {
          uint32_t bf[2];
          if constexpr (S == 2) {
            ldmatrix_x2_trans(bf, shared_addr(yb) + b * 16);
          } else {
            bf[0] = y_bytes(yb + b * 8);
            bf[1] = y_bytes(yb + b * 8 + y_half);
          }
#pragma unroll
          for (int a = 0; a < FM; ++a) Mma<T>::run(acc[a][b], af[a], bf);
        }
      }
      return;
    }
    for (int k0 = 0; k0 < bk; k0 += KF, yb += KF * p.y_ld * S) {
      const int rem = bk - k0;
      uint32_t af[FM][4];
#pragma unroll
      for (int a = 0; a < FM; ++a) {
        if (x_fast && rem >= KF) {
          ldmatrix_x4(af[a], xa[a] + k0 * S);
          continue;
        }
        if (x_fast && rem * S == 16) {
          // half a k-fragment: rows 0-7 and 8-15 of its first 16 bytes
          uint32_t h[2];
          ldmatrix_x2(h, xa[a] - (lane >> 4) * 16 + k0 * S);
          af[a][0] = h[0];
          af[a][1] = h[1];
          af[a][2] = af[a][3] = 0u;
          continue;
        }
        const int r0 = (fm0 + a) * 16 + g;
        const int r1 = r0 + 8;
        const unsigned char* row0 = xs + r0 * p.x_ld * S;
        const unsigned char* row1 = xs + r1 * p.x_ld * S;
        const int ka = k0 + G * t;
        const int kb = ka + KF / 2;
        af[a][0] = r0 < bm ? row_group<T>(row0, ka, bk, p.x_word) : 0u;
        af[a][1] = r1 < bm ? row_group<T>(row1, ka, bk, p.x_word) : 0u;
        af[a][2] = r0 < bm ? row_group<T>(row0, kb, bk, p.x_word) : 0u;
        af[a][3] = r1 < bm ? row_group<T>(row1, kb, bk, p.x_word) : 0u;
      }
      // one fragment column of y at a time keeps few registers live
#pragma unroll
      for (int b = 0; b < FN; ++b) {
        if (fn0 + b >= frags_n) continue;
        uint32_t bf[2];
        if (y_fast && rem >= KF) {
          if constexpr (S == 2) {
            ldmatrix_x2_trans(bf, shared_addr(yb) + b * 16);
          } else {
            bf[0] = y_bytes(yb + b * 8);
            bf[1] = y_bytes(yb + b * 8 + y_half);
          }
        } else {
          const int c = (fn0 + b) * 8 + g;
          const int ka = k0 + G * t;
          // a half k-fragment inside the tile needs only the column's
          // predicate; one wholly past it is zero
          const unsigned char* col = ys + (ka * p.y_ld + c) * S;
          const int kh = (KF / 2) * p.y_ld * S;
          if (c >= bn) {
            bf[0] = bf[1] = 0u;
          } else {
            bf[0] = rem >= KF / 2 ? col_bits<T>(col, p.y_ld)
                                  : col_group<T>(ys, p.y_ld, ka, c, bk);
            bf[1] = rem >= KF       ? col_bits<T>(col + kh, p.y_ld)
                    : rem <= KF / 2 ? 0u
                                    : col_group<T>(ys, p.y_ld, ka + KF / 2,
                                                   c, bk);
          }
        }
#pragma unroll
        for (int a = 0; a < FM; ++a) {
          if (fm0 + a < frags_m) Mma<T>::run(acc[a][b], af[a], bf);
        }
      }
    }
  };

  auto next_slot = [&](int sl) { return sl + 1 == ns ? 0 : sl + 1; };
  if constexpr (U > 1) {
    // U consecutive steps of a sweep an iteration, for warps of one
    // fragment in orders "a"/"b" with one pass (the plan gives a ring of
    // ns = 2U..4U stages, ns a multiple of U, and sweeps a multiple of U).
    // The U steps touch different tiles, so their chains of reads,
    // products and writes are independent: they overlap within a warp and
    // spread over the warp groups, and one barrier serves U steps.  Iteration s stages steps s + ns - U .. s + ns - 1;
    // with three or more iterations in the ring, tiles staged through
    // registers are stored one iteration after they are loaded.
    const bool glate = ns >= 3 * U;
    T bef[U][FM][FN][4];
    Pos ahead = first;
    int ahead_slot = 0;
    Pos held = first;    // the register-staged iteration not yet stored
    int held_slot = 0;
    auto store_group = [&](Pos q, int qs, int from) {
#pragma unroll
      for (int v = 0; v < U; ++v) {
        store_held(q, qs, from + v < steps, v);
        advance(q);
        qs = next_slot(qs);
      }
    };
    for (int q = 0; q < ns - U; q += U) {
      held = ahead;
      held_slot = ahead_slot;
#pragma unroll
      for (int v = 0; v < U; ++v) {
        issue_async(ahead, ahead_slot, q + v < steps, false);
        issue_held(ahead, q + v < steps, v);
        advance(ahead);
        ahead_slot = next_slot(ahead_slot);
      }
      cp_async_commit();
      if (!glate || q + U < ns - U) store_group(held, held_slot, q);
    }
    Pos cur = first;
    int slot = 0;
    {
      Pos q = cur;
#pragma unroll
      for (int v = 0; v < U; ++v) {
        if (v % groups == gi) read_before(bef[v], q, wm, wn);
        advance(q);
      }
    }
    for (int s = 0; s < steps; s += U) {
      cp_async_wait_upto(ns / U - 2);
      __syncthreads();
      if ((ORDER == 1 ? cur.j : cur.i) == 0) load_stationary(cur);
      if (glate) store_group(held, held_slot, s + ns - 2 * U);
      held = ahead;
      held_slot = ahead_slot;
#pragma unroll
      for (int v = 0; v < U; ++v) {
        const bool valid = s + ns - U + v < steps;
        issue_async(ahead, ahead_slot, valid, false);
        issue_held(ahead, valid, v);
        advance(ahead);
        ahead_slot = next_slot(ahead_slot);
      }
      cp_async_commit();
#pragma unroll
      for (int v = 0; v < U; ++v) {
        if (v % groups == gi) {
          zero_acc();
          product(x_tile(slot), y_tile(slot), wm, wn);
          write_out(cur, wm, wn, bef[v]);
        }
        advance(cur);
        slot = next_slot(slot);
      }
      if (!glate) store_group(held, held_slot, s + ns - U);
      if (s + U < steps) {
        Pos r = cur;
#pragma unroll
        for (int v = 0; v < U; ++v) {
          if (v % groups == gi) read_before(bef[v], r, wm, wn);
          advance(r);
        }
      }
    }
    return;
  }

  // The ring: step s reads slot s % ns; the tiles of step s + ns - 1 are
  // issued at step s (cp.async), those staged through registers loaded at
  // step s and, with three or more stages, stored one step later, so that
  // no step waits for its own loads.
  const bool late = ns >= 3;
  const int lead = ns > 1 ? ns - 1 : 1;
  Pos ahead = first;   // step q of the prologue, then s + lead
  int ahead_slot = 0;
  Pos held = first;    // the register-staged step not yet stored
  int held_slot = 0;
  for (int q = 0; q < lead; ++q) {
    issue_async(ahead, ahead_slot, q < steps);
    issue_held(ahead, q < steps);
    if (!late || q + 1 < lead) {
      store_held(ahead, ahead_slot, q < steps);
    } else {
      held = ahead;
      held_slot = ahead_slot;
    }
    advance(ahead);
    ahead_slot = next_slot(ahead_slot);
  }
  Pos cur = first;
  int slot = 0;
  zero_acc();
  if (ORDER != 0 && one_pass) read_before(before, cur, wm * FM, wn * FN);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_upto(ns - 2);
    __syncthreads();
    if (ORDER == 1 && cur.j == 0) load_stationary(cur);
    if (ORDER == 2 && cur.i == 0) load_stationary(cur);
    const bool ahead_valid = s + lead < steps;
    if (late) {
      store_held(held, held_slot, s + lead - 1 < steps);
      held = ahead;
      held_slot = ahead_slot;
    }
    issue_held(ahead, ahead_valid);
    if (ns > 1) issue_async(ahead, ahead_slot, ahead_valid);
    const unsigned char* xs = x_tile(slot);
    const unsigned char* ys = y_tile(slot);
    for (int pm = 0; pm < p.passes_m; ++pm) {
      for (int pn = 0; pn < p.passes_n; ++pn) {
        const int fm0 = (pm * p.warps_m + wm) * FM;
        const int fn0 = (pn * p.warps_n + wn) * FN;
        if (ORDER == 0) {
          if (!one_pass) {
            // the accumulator tile in shared memory: this thread's
            // elements, zero for the first K-block
            for_outputs(fm0, fn0, [&](int a, int b, int h, int r, int c) {
              acc[a][b][2 * h] = cur.kk > 0 ? acc_s[r * bn + c] : Acc(0);
              acc[a][b][2 * h + 1] = cur.kk > 0 && c + 1 < bn
                                         ? acc_s[r * bn + c + 1]
                                         : Acc(0);
            });
          }
          product(xs, ys, fm0, fn0);
          if (!one_pass) {
            if (cur.kk == gk - 1) {
              write_out(cur, fm0, fn0, acc);
            } else {
              for_outputs(fm0, fn0, [&](int a, int b, int h, int r, int c) {
                acc_s[r * bn + c] = acc[a][b][2 * h];
                if (c + 1 < bn) acc_s[r * bn + c + 1] = acc[a][b][2 * h + 1];
              });
            }
          }
        } else {
          // out(i,j) = out(i,j) + T(partial), the first K-block adding to
          // zero; with one pass the previous values were read a step ahead
          if (!one_pass) read_before(before, cur, fm0, fn0);
          zero_acc();
          product(xs, ys, fm0, fn0);
          write_out(cur, fm0, fn0, before);
        }
      }
    }
    if (ns == 2) {
      store_held(ahead, ahead_slot, ahead_valid);
    } else if (ns == 1) {
      __syncthreads();
      issue_async(ahead, 0, ahead_valid);
      store_held(ahead, 0, ahead_valid);
    }
    advance(ahead);
    ahead_slot = next_slot(ahead_slot);
    advance(cur);
    slot = next_slot(slot);
    // the next step's previous values, read while this step's writes
    // drain (a tile written this step is read back by this same thread)
    if (ORDER != 0 && one_pass && s + 1 < steps) {
      read_before(before, cur, wm * FM, wn * FN);
    }
  }
  if (ORDER == 0 && one_pass) write_out(cur, wm * FM, wn * FN, acc);
}

struct MmaLaunch {
  int order, m, n, k, bm, bn, bk, fm, fn, smem;
  const void* x;
  const void* y;
  void* out;
  MmaPlan plan;
  cudaStream_t stream;
};

template <typename T, int ORDER, int FM, int FN, int U = 1>
cudaError_t launch_mma(const MmaLaunch& a) {
  auto kernel = mma_kernel<T, ORDER, FM, FN, U>;
  if (a.smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = ORDER == 0 ? (a.m / a.bm) * (a.n / a.bn)
                                : (ORDER == 1 ? a.m / a.bm : a.n / a.bn);
  // four steps an iteration: as many copies of the warp grid as fit, each
  // taking its share of the steps
  const int grid = 32 * a.plan.warps_m * a.plan.warps_n;
  const int threads =
      U > 1 ? grid * min(U, kMaxGroupThreads / grid) : grid;
  kernel<<<blocks, threads, a.smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.y),
      static_cast<T*>(a.out), a.m, a.n, a.k, a.bm, a.bn, a.bk, a.plan);
  return cudaGetLastError();
}

// The warp layouts (fragments a warp owns, down x across) the plan picks
// from: MMA_LAYOUTS (order "out") and MMA_LAYOUTS_AB in
// kernels/tiled_matmul.py.
template <typename T, int ORDER>
cudaError_t mma_by_layout(const MmaLaunch& a) {
  if (a.fm == 1 && a.fn == 1) {
    if constexpr (ORDER != 0) {
      if (a.plan.group == 4) return launch_mma<T, ORDER, 1, 1, 4>(a);
    }
    return launch_mma<T, ORDER, 1, 1>(a);
  }
  if (a.fm == 2 && a.fn == 2) return launch_mma<T, ORDER, 2, 2>(a);
  if (a.fm == 2 && a.fn == 4) return launch_mma<T, ORDER, 2, 4>(a);
  if constexpr (ORDER == 0) {
    if (a.fm == 4 && a.fn == 4) return launch_mma<T, ORDER, 4, 4>(a);
    if (a.fm == 4 && a.fn == 8) return launch_mma<T, ORDER, 4, 8>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t mma_by_order(const MmaLaunch& a) {
  switch (a.order) {
    case 0:
      return mma_by_layout<T, 0>(a);
    case 1:
      return mma_by_layout<T, 1>(a);
    case 2:
      return mma_by_layout<T, 2>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

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

// The bfloat16 / int8 tensor-core kernel with the plan of launch_plan
// (kernels/tiled_matmul.py).  dtype: 1 = bfloat16, 2 = int8; order: 0 =
// "out", 1 = "a", 2 = "b"; fm x fn fragments a warp, the warp grid and
// passes, the accumulator's place, ring stages, staged row strides, copy
// widths, byte offsets, steps an iteration, and the bytes of shared memory
// to request.  Returns the cudaError_t of the launch (0 on success).
extern "C" int tiled_matmul_mma_launch(
    int dtype, int order, const void* x, const void* y, void* out, int m,
    int n, int k, int bm, int bn, int bk, int fm, int fn, int warps_m,
    int warps_n, int passes_m, int passes_n, int acc_smem, int stages,
    int x_ld, int y_ld, int x_copy, int y_copy, int x_word, int xs_at,
    int ys_at, int stage_bytes, int group, int smem, void* stream) {
  if (warps_m < 1 || warps_n < 1 || 32 * warps_m * warps_n > kMaxMmaThreads ||
      stages < 1 || stages > 16 || passes_m < 1 || passes_n < 1) {
    return cudaErrorInvalidValue;
  }
  // four steps an iteration: one fragment a warp, one pass, orders "a"/"b",
  // a ring of whole iterations, sweeps of whole iterations
  const int sweep = order == 1 ? n / bn : m / bm;
  if (group != 1 &&
      (group != 4 || fm != 1 || fn != 1 || order == 0 ||
       passes_m * passes_n != 1 || stages % 4 || stages < 8 ||
       sweep % 4)) {
    return cudaErrorInvalidValue;
  }
  if (group == 1 && stages > 4) return cudaErrorInvalidValue;
  const MmaLaunch a{order, m, n, k, bm, bn, bk, fm, fn, smem, x, y, out,
                    MmaPlan{warps_m, warps_n, passes_m, passes_n, acc_smem,
                            stages, x_ld, y_ld, x_copy, y_copy, x_word,
                            xs_at, ys_at, stage_bytes, group},
                    static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1:
      return mma_by_order<__nv_bfloat16>(a);
    case 2:
      return mma_by_order<int8_t>(a);
    default:
      return cudaErrorInvalidValue;
  }
}
