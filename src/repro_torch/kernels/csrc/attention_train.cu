// Causal attention for the model path on the tensor cores, for Hopper
// (sm_90a): a bfloat16 flash forward that also writes each row's
// log-sum-exp, and its backward, FlashAttention-2's deterministic form.
//
// Replaces no TPU kernel.  The reference's model layers run attention as
// jnp (src/repro/models/attention.py::_flash_attention_jnp, the twin of its
// Pallas kernel), and XLA fuses that loop on the TPU; the port's plain
// twin of it (repro_torch/models/attention.py) runs on the card as float32
// SIMT products and a separate pass over a float32 logit tensor for every
// mask, max, exp and rescale, which autograd then keeps and walks back.
// This file is the same mathematics as one autograd op
// (kernels/attention_train.py): bfloat16 products with float32 sums, as
// the reference asks (preferred_element_type).
//
// Shapes.  q (B, Sq, H, d), k and v (B, Skv, KV, d), read in place through
// their strides (the model's split_heads layout; d is contiguous, every
// other stride a multiple of 8 values, every base on 16 bytes); query head
// h reads KV head h / (H / KV).  Query i sits at position q_offset + i and
// sees keys 0 .. q_offset + i (causal; Skv >= q_offset + Sq).  o and dq
// (B, Sq, H, d), dk and dv (B, Skv, KV, d) are contiguous; lse and delta
// (B, H, Sq) float32.  d is 64, 80, 96 or 128, one instantiation each.
//
// What bounds it on the H100: at the model's shapes (stablelm-3b, 4 x 4096
// tokens, 32 heads of 80) the causal forward is 2 * 2 * B*H*S^2*d / 2 =
// 3.4e11 FLOP a layer against ~0.3 GB of operands: it is bound by the
// tensor cores (989 TFLOP/s dense bfloat16), 0.35 ms a layer at that peak.
// mma.sync reaches about two thirds of it on Hopper (wgmma the rest, a
// later step); in front of it come the exponentials (one MUFU op a logit,
// 16 a clock an SM against 1024 products) and the shared-memory reads
// that feed the products.
//
// Design (FlashAttention-2 on mma.sync m16n8k16, bfloat16 in, float32 out):
//   * forward (attention_fwd_kernel): a CTA of 4 warps owns 128 query
//     rows of one (batch, head), 32 rows (two m16 fragments) a warp, and
//     walks the KV tiles of 64 keys up to its diagonal (tiles wholly above
//     it are skipped, by the CTA and by each warp).  K and V tiles are
//     double-buffered by 16-byte cp.async; operands reach the warps by
//     ldmatrix from rows padded by 16 bytes (conflict-free at every
//     width).  Shared-memory reads bound a warp that owns 16 rows (one
//     ldmatrix.x4 per two products: 187 TFLOP/s at stablelm's shape on
//     the H100); at 32 rows every K and V ldmatrix feeds four (218
//     TFLOP/s).  q's fragments are reloaded from shared memory each tile,
//     which keeps the accumulators of 32 rows within 255 registers.
//     The logits' float32 accumulator fragments become P's bfloat16 A
//     fragments in registers (no trip through shared memory), and the
//     softmax runs in base 2: logits times scale * log2(e), ex2.approx.
//     The row's base-2 log-sum-exp is written beside the output.
//   * backward: a preprocessing pass (attention_dot_kernel) writes delta =
//     rowsum(dO * O) in float32.  attention_dkdv_kernel is KV-tile
//     stationary: a CTA owns 64 keys of one (batch, KV head), 16 a warp,
//     walks every query head of the group and every query tile at or below
//     the diagonal, recomputes P^T from the saved log-sum-exp, and keeps
//     dK and dV in registers.  attention_dq_kernel is query-tile
//     stationary and keeps dQ in registers.  No atomics and no scratch to
//     zero: the two kernels are deterministic, run to run.  Both keep 16
//     rows a warp: two accumulators of d columns and two 16 x 64 logit
//     tiles already take 168-237 registers.
//   * precision: every product's operands are bfloat16 values the float32
//     twin also holds (q, k, v, P, dO), with float32 sums; the logits'
//     gradient dS, float32 in the twin, enters dQ and dK as a bfloat16
//     hi + lo pair (hi = bf16(dS), lo = bf16(dS - hi): 16 significant bits,
//     two products each).  The float32 logits are scaled, not q.
//   * masks: -inf logits (every row sees key 0, so a row's running max is
//     finite from its first tile); rows past Sq and keys past Skv are
//     staged as zeros and masked, and never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // query rows of a dq CTA
constexpr int kBlockN = 64;           // keys of a KV tile
constexpr int kPad = 8;               // bfloat16 values padding each staged row
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Element strides of a (B, S, heads, d) operand; d's is 1.
struct Strides {
  long long b, s, h;
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  bf16* out;      // forward: o; backward: dq
  bf16* dk;
  bf16* dv;
  float* lse;     // base-2 log-sum-exp of the scaled logits
  float* delta;   // rowsum(dO * O)
  Strides lq, lk, lv, ldo;
  int sq, skv, heads, group, q_offset;
  float scale;       // the logits' scale
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp's four 8 x 8 matrices of 16-bit values, lanes 8q..8q+7 naming the
// rows of matrix q; .trans delivers each transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a @ b on one warp: m16n8k16, bfloat16 in, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two float32 values as one register of bfloat16 (round to nearest even),
// the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The bfloat16 hi + lo pair of (x0, x1): hi rounds x, lo rounds x - hi.
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo,
                                           float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// Stage R rows of D values (row r at src + r * stride) into shared rows of
// D + kPad values; rows from `valid` on are zeros.
template <int D, int R>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long stride, int valid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int c = threadIdx.x; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c - r * kChunks) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + kPad) + col,
               src + (ok ? r : 0) * stride + col, ok ? 16 : 0);
  }
}

// R float32 values of a (B, H, Sq) row vector from src; past `valid`, 0.
template <int R>
__device__ __forceinline__ void stage_floats(float* dst, const float* src,
                                             int valid) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const bool ok = r < valid;
    cp_async4(dst + r, src + (ok ? r : 0), ok ? 4 : 0);
  }
}

// The A fragment (16 x 16) of 16 staged rows at s, columns k0..k0+15.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, s + (lane & 15) * (D + kPad) + k0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (b[0..1] for n0, b[2..3] for n0 + 8) where
// the staged rows at s are n, their columns k0..k0+15 k.
template <int D>
__device__ __forceinline__ void load_b_n(uint32_t (&b)[4], const bf16* s,
                                         int n0, int k0) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  ldmatrix_x4(b, s + (n0 + (m >> 1) * 8 + r) * (D + kPad) + k0 + (m & 1) * 8);
}

// The same where the staged rows are k (k0..k0+15), their columns n.
template <int D>
__device__ __forceinline__ void load_b_k(uint32_t (&b)[4], const bf16* s,
                                         int k0, int n0) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(b, s + (k0 + (m & 1) * 8 + r) * (D + kPad) + n0 +
                           (m >> 1) * 8);
}

// c (16 x N) += A (16 x D) @ the transpose of N staged rows at s; A's
// fragment of columns 16kk.. comes from a(kk, frag).
template <int D, int N, typename A>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4], A a,
                                        const bf16* s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    a(kk, af);
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      uint32_t b[4];
      load_b_n<D>(b, s, 16 * j, 16 * kk);
      mma_bf16(c[2 * j], af, b[0], b[1]);
      mma_bf16(c[2 * j + 1], af, b[2], b[3]);
    }
  }
}

// c (16 x D) += sum over the P parts of P (16 x K) @ K staged rows at s;
// P's fragments of columns 16kk.. come from p(kk, frags).
template <int D, int K, int P, typename F>
__device__ __forceinline__ void mma_pb(float (&c)[D / 8][4], F p,
                                       const bf16* s) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t pf[P][4];
    p(kk, pf);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t b[4];
      load_b_k<D>(b, s, 16 * kk, 16 * j);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        mma_bf16(c[2 * j], pf[i], b[0], b[1]);
        mma_bf16(c[2 * j + 1], pf[i], b[2], b[3]);
      }
    }
  }
}

// The A fragment of columns 16kk.. of a 16 x K float32 accumulator.
template <int K>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[K / 8][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Its hi (a[0]) + lo (a[1]) pair.
template <int K>
__device__ __forceinline__ void acc_to_a_split(uint32_t (&a)[2][4],
                                               const float (&c)[K / 8][4],
                                               int kk) {
  split_bf16(a[0][0], a[1][0], c[2 * kk][0], c[2 * kk][1]);
  split_bf16(a[0][1], a[1][1], c[2 * kk][2], c[2 * kk][3]);
  split_bf16(a[0][2], a[1][2], c[2 * kk + 1][0], c[2 * kk + 1][1]);
  split_bf16(a[0][3], a[1][3], c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store a warp's 16 x D float32 accumulator times `mul` as bfloat16 rows
// row0.. of a contiguous (.., d) array (row r at base + r * rstride),
// rows from `valid` on dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long rstride,
                                           const float (&c)[D / 8][4],
                                           int row0, int valid, float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= valid) continue;
    bf16* o = base + r * rstride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack_bf16(c[j][2 * half] * mul, c[j][2 * half + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------- forward

// A forward CTA's query rows: 4 warps of two m16 fragments (32 rows) each,
// so every K and V fragment a warp loads feeds two products.
constexpr int kFwdRows = 2 * 16 * kWarps;

template <int D>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStride = D + kPad;
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_kv = s_q + kFwdRows * kStride;  // [2 buffers][K, V][kBlockN rows]
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kFwdRows;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kp = a.k + b * a.lk.b + hk * a.lk.h;
  const bf16* vp = a.v + b * a.lv.b + hk * a.lv.h;
  const int last = min(m0 + kFwdRows, a.sq) - 1;
  const int tiles = min(cdiv(a.skv, kBlockN), (a.q_offset + last) / kBlockN + 1);

  auto stage_kv = [&](int j) {
    bf16* dst = s_kv + (j & 1) * 2 * kBlockN * kStride;
    const int n0 = j * kBlockN;
    stage_rows<D, kBlockN>(dst, kp + n0 * a.lk.s, a.lk.s, a.skv - n0);
    stage_rows<D, kBlockN>(dst + kBlockN * kStride, vp + n0 * a.lv.s, a.lv.s,
                           a.skv - n0);
  };
  stage_rows<D, kFwdRows>(s_q, a.q + b * a.lq.b + m0 * a.lq.s + h * a.lq.h,
                          a.lq.s, a.sq - m0);
  stage_kv(0);
  cp_async_commit();

  // fragment r of this warp holds rows w0 + 16 r ..; a thread rows g, g + 8
  const int w0 = 32 * warp;
  const bf16* s_qw = s_q + w0 * kStride;
  const int pos0 = a.q_offset + m0 + w0 + g;  // row g's position
  float acc[2][D / 8][4], m[2][2], l[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) acc[r][i][0] = acc[r][i][1] = acc[r][i][2] = acc[r][i][3] = 0.f;
    m[r][0] = m[r][1] = -INFINITY;
    l[r][0] = l[r][1] = 0.f;
  }

  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) stage_kv(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int n0 = j * kBlockN;
    // a tile wholly above this warp's last row changes none of its rows
    if (n0 <= pos0 + 31 - g) {
      const bf16* s_k = s_kv + (j & 1) * 2 * kBlockN * kStride;
      const bf16* s_v = s_k + kBlockN * kStride;
      float s[2][kBlockN / 8][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int i = 0; i < kBlockN / 8; ++i) s[r][i][0] = s[r][i][1] = s[r][i][2] = s[r][i][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[2][4];
        load_a<D>(qa[0], s_qw, 16 * kk);
        load_a<D>(qa[1], s_qw + 16 * kStride, 16 * kk);
#pragma unroll
        for (int i = 0; i < kBlockN / 16; ++i) {
          uint32_t kb[4];
          load_b_n<D>(kb, s_k, 16 * i, 16 * kk);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mma_bf16(s[r][2 * i], qa[r], kb[0], kb[1]);
            mma_bf16(s[r][2 * i + 1], qa[r], kb[2], kb[3]);
          }
        }
      }
      const bool edge = n0 + kBlockN - 1 > pos0 - g || n0 + kBlockN > a.skv;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int i = 0; i < kBlockN / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[r][i][e] * a.scale_log2;
            if (edge) {
              const int key = n0 + 8 * i + 2 * t + (e & 1);
              if (key > pos0 + 16 * r + 8 * (e >> 1) || key >= a.skv) x = -INFINITY;
            }
            s[r][i][e] = x;
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float mx = m[r][half];
#pragma unroll
          for (int i = 0; i < kBlockN / 8; ++i)
            mx = fmaxf(mx, fmaxf(s[r][i][2 * half], s[r][i][2 * half + 1]));
          mx = quad_max(mx);
          const float corr = fast_exp2(m[r][half] - mx);
          m[r][half] = mx;
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < kBlockN / 8; ++i) {
#pragma unroll
            for (int e = 2 * half; e < 2 * half + 2; ++e) {
              s[r][i][e] = fast_exp2(s[r][i][e] - mx);
              sum += s[r][i][e];
            }
          }
          l[r][half] = l[r][half] * corr + sum;
#pragma unroll
          for (int i = 0; i < D / 8; ++i) {
            acc[r][i][2 * half] *= corr;
            acc[r][i][2 * half + 1] *= corr;
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        uint32_t pa[2][4];
        acc_to_a<kBlockN>(pa[0], s[0], kk);
        acc_to_a<kBlockN>(pa[1], s[1], kk);
#pragma unroll
        for (int i = 0; i < D / 16; ++i) {
          uint32_t vb[4];
          load_b_k<D>(vb, s_v, 16 * kk, 16 * i);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mma_bf16(acc[r][2 * i], pa[r], vb[0], vb[1]);
            mma_bf16(acc[r][2 * i + 1], pa[r], vb[2], vb[3]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is restaged next
  }

  bf16* ob = a.out + (static_cast<long long>(b) * a.sq * a.heads + h) * D;
  const long long rstride = static_cast<long long>(a.heads) * D;
  float* lse = a.lse + (static_cast<long long>(b) * a.heads + h) * a.sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float sum = quad_sum(l[r][half]);
      const float inv = 1.f / sum;
      const int row = m0 + w0 + 16 * r + 8 * half + g;
      if (row >= a.sq) continue;
      bf16* o = ob + row * rstride + 2 * t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(o + 8 * i) =
            pack_bf16(acc[r][i][2 * half] * inv, acc[r][i][2 * half + 1] * inv);
      }
      if (t == 0) lse[row] = m[r][half] + log2f(sum);
    }
  }
}

// ---------------------------------------------------------------- backward

// delta[b, h, i] = sum over d of dO * O, one thread a row.
template <int D>
__global__ void __launch_bounds__(kThreads) attention_dot_kernel(const Args a) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(a.sq) * a.heads) return;
  const int b = blockIdx.y;
  const int h = static_cast<int>(idx % a.heads);
  const int i = static_cast<int>(idx / a.heads);
  const bf16* o = a.o + ((static_cast<long long>(b) * a.sq + i) * a.heads + h) * D;
  const bf16* g = a.dout + b * a.ldo.b + i * a.ldo.s + h * a.ldo.h;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 x = *reinterpret_cast<const uint4*>(o + 8 * c);
    const uint4 y = *reinterpret_cast<const uint4*>(g + 8 * c);
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sum += __low2float(xs[e]) * __low2float(ys[e]);
      sum += __high2float(xs[e]) * __high2float(ys[e]);
    }
  }
  a.delta[(static_cast<long long>(b) * a.heads + h) * a.sq + i] = sum;
}

// dQ of 64 query rows of one (batch, head): walks the KV tiles up to the
// diagonal, recomputing P from the log-sum-exp.
template <int D>
__global__ void __launch_bounds__(kThreads) attention_dq_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStride = D + kPad;
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_do = s_q + kBlockM * kStride;
  bf16* s_kv = s_do + kBlockM * kStride;  // [2 buffers][K, V][kBlockN rows]
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kp = a.k + b * a.lk.b + hk * a.lk.h;
  const bf16* vp = a.v + b * a.lv.b + hk * a.lv.h;
  const int last = min(m0 + kBlockM, a.sq) - 1;
  const int tiles = min(cdiv(a.skv, kBlockN), (a.q_offset + last) / kBlockN + 1);

  auto stage_kv = [&](int j) {
    bf16* dst = s_kv + (j & 1) * 2 * kBlockN * kStride;
    const int n0 = j * kBlockN;
    stage_rows<D, kBlockN>(dst, kp + n0 * a.lk.s, a.lk.s, a.skv - n0);
    stage_rows<D, kBlockN>(dst + kBlockN * kStride, vp + n0 * a.lv.s, a.lv.s,
                           a.skv - n0);
  };
  stage_rows<D, kBlockM>(s_q, a.q + b * a.lq.b + m0 * a.lq.s + h * a.lq.h,
                         a.lq.s, a.sq - m0);
  stage_rows<D, kBlockM>(s_do,
                         a.dout + b * a.ldo.b + m0 * a.ldo.s + h * a.ldo.h,
                         a.ldo.s, a.sq - m0);
  stage_kv(0);
  cp_async_commit();

  const long long vec = (static_cast<long long>(b) * a.heads + h) * a.sq;
  const int row0 = m0 + 16 * warp + g;
  float lse[2], dlt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
    lse[half] = r < a.sq ? a.lse[vec + r] : 0.f;
    dlt[half] = r < a.sq ? a.delta[vec + r] : 0.f;
  }
  const int pos0 = a.q_offset + row0;
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  const bf16* s_qw = s_q + 16 * warp * kStride;
  const bf16* s_dow = s_do + 16 * warp * kStride;

  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) stage_kv(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* s_k = s_kv + (j & 1) * 2 * kBlockN * kStride;
    const bf16* s_v = s_k + kBlockN * kStride;

    float p[kBlockN / 8][4], dp[kBlockN / 8][4];
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[i][e] = dp[i][e] = 0.f;
    }
    mma_abt<D, kBlockN>(
        p, [&](int kk, uint32_t (&f)[4]) { load_a<D>(f, s_qw, 16 * kk); }, s_k);
    mma_abt<D, kBlockN>(
        dp, [&](int kk, uint32_t (&f)[4]) { load_a<D>(f, s_dow, 16 * kk); },
        s_v);
    const int n0 = j * kBlockN;
    const bool edge = n0 + kBlockN - 1 > a.q_offset + m0 || n0 + kBlockN > a.skv;
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fast_exp2(p[i][e] * a.scale_log2 - lse[e >> 1]);
        if (edge) {
          const int key = n0 + 8 * i + 2 * t + (e & 1);
          if (key > pos0 + 8 * (e >> 1) || key >= a.skv) x = 0.f;
        }
        p[i][e] = x * (dp[i][e] - dlt[e >> 1]);  // dS
      }
    }
    mma_pb<D, kBlockN, 2>(
        dq,
        [&](int kk, uint32_t (&f)[2][4]) { acc_to_a_split<kBlockN>(f, p, kk); },
        s_k);
    __syncthreads();
  }
  store_rows<D>(a.out + (static_cast<long long>(b) * a.sq * a.heads + h) * D,
                static_cast<long long>(a.heads) * D, dq, m0 + 16 * warp, a.sq,
                a.scale);
}

// The query rows of a dK/dV step: 64 at d <= 96, 32 at d = 128 (registers:
// dK and dV of 16 keys at d columns, and P^T and dP^T of 16 x BM).
template <int D>
struct DkdvRows {
  static constexpr int value = D > 96 ? 32 : 64;
};

// dK and dV of 64 keys of one (batch, KV head): walks every query head of
// the group and every query tile at or below the diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads) attention_dkdv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStride = D + kPad;
  constexpr int BM = DkdvRows<D>::value;
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + kBlockN * kStride;
  bf16* s_qdo = s_v + kBlockN * kStride;  // [2 buffers][q, dO][BM rows]
  float* s_vec = reinterpret_cast<float*>(s_qdo + 4 * BM * kStride);  // [2][lse, delta][BM]
  const int n0 = blockIdx.x * kBlockN;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int first = max(0, n0 - a.q_offset) / BM;
  const int per_head = max(0, cdiv(a.sq, BM) - first);
  const int steps = per_head * a.group;

  stage_rows<D, kBlockN>(s_k, a.k + b * a.lk.b + n0 * a.lk.s + hk * a.lk.h,
                         a.lk.s, a.skv - n0);
  stage_rows<D, kBlockN>(s_v, a.v + b * a.lv.b + n0 * a.lv.s + hk * a.lv.h,
                         a.lv.s, a.skv - n0);
  auto stage_q = [&](int it) {
    const int h = hk * a.group + it / per_head;
    const int i0 = (first + it % per_head) * BM;
    bf16* dst = s_qdo + (it & 1) * 2 * BM * kStride;
    stage_rows<D, BM>(dst, a.q + b * a.lq.b + i0 * a.lq.s + h * a.lq.h,
                      a.lq.s, a.sq - i0);
    stage_rows<D, BM>(dst + BM * kStride,
                      a.dout + b * a.ldo.b + i0 * a.ldo.s + h * a.ldo.h,
                      a.ldo.s, a.sq - i0);
    const long long vec = (static_cast<long long>(b) * a.heads + h) * a.sq + i0;
    float* fv = s_vec + (it & 1) * 2 * BM;
    stage_floats<BM>(fv, a.lse + vec, a.sq - i0);
    stage_floats<BM>(fv + BM, a.delta + vec, a.sq - i0);
  };
  if (steps > 0) stage_q(0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  }
  const bf16* s_kw = s_k + 16 * warp * kStride;
  const bf16* s_vw = s_v + 16 * warp * kStride;
  const int key0 = n0 + 16 * warp + g;  // row g's key

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) stage_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int i0 = (first + it % per_head) * BM;
    const bf16* s_qt = s_qdo + (it & 1) * 2 * BM * kStride;
    const bf16* s_dot = s_qt + BM * kStride;
    const float* f_lse = s_vec + (it & 1) * 2 * BM;
    const float* f_dlt = f_lse + BM;

    float p[BM / 8][4], dp[BM / 8][4];  // P^T and dP^T: keys x queries
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[i][e] = dp[i][e] = 0.f;
    }
    mma_abt<D, BM>(
        p, [&](int kk, uint32_t (&f)[4]) { load_a<D>(f, s_kw, 16 * kk); }, s_qt);
    const bool edge = n0 + kBlockN - 1 > a.q_offset + i0 || i0 + BM > a.sq ||
                      n0 + kBlockN > a.skv;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * i + 2 * t + (e & 1);
        float x = fast_exp2(p[i][e] * a.scale_log2 - f_lse[qi]);
        if (edge) {
          const int key = key0 + 8 * (e >> 1);
          if (key > a.q_offset + i0 + qi || i0 + qi >= a.sq || key >= a.skv)
            x = 0.f;
        }
        p[i][e] = x;
      }
    }
    mma_pb<D, BM, 1>(
        dv, [&](int kk, uint32_t (&f)[1][4]) { acc_to_a<BM>(f[0], p, kk); },
        s_dot);
    mma_abt<D, BM>(
        dp, [&](int kk, uint32_t (&f)[4]) { load_a<D>(f, s_vw, 16 * kk); },
        s_dot);
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[i][e] *= dp[i][e] - f_dlt[8 * i + 2 * t + (e & 1)];  // dS^T
    }
    mma_pb<D, BM, 2>(
        dk,
        [&](int kk, uint32_t (&f)[2][4]) { acc_to_a_split<BM>(f, p, kk); },
        s_qt);
    __syncthreads();
  }
  cp_async_wait<0>();

  const long long rstride = static_cast<long long>(gridDim.y) * D;  // KV * d
  const long long base =
      (static_cast<long long>(b) * a.skv * gridDim.y + hk) * D;
  store_rows<D>(a.dk + base, rstride, dk, n0 + 16 * warp, a.skv, a.scale);
  store_rows<D>(a.dv + base, rstride, dv, n0 + 16 * warp, a.skv, 1.f);
}

template <typename K>
cudaError_t launch(K kernel, const Args& args, dim3 grid, int smem,
                   cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

int tile_bytes(int rows, int d) { return rows * (d + kPad) * 2; }

template <int D>
cudaError_t forward(const Args& a, int batch, cudaStream_t s) {
  const dim3 grid((a.sq + kFwdRows - 1) / kFwdRows, a.heads, batch);
  return launch(attention_fwd_kernel<D>, a, grid,
                tile_bytes(kFwdRows + 4 * kBlockN, D), s);
}

template <int D>
cudaError_t backward(const Args& a, int batch, int kv_heads,
                     cudaStream_t s) {
  const long long rows = static_cast<long long>(a.sq) * a.heads;
  cudaError_t err = launch(
      attention_dot_kernel<D>, a,
      dim3(static_cast<unsigned>((rows + kThreads - 1) / kThreads), batch), 0,
      s);
  if (err != cudaSuccess) return err;
  err = launch(attention_dq_kernel<D>, a,
               dim3((a.sq + kBlockM - 1) / kBlockM, a.heads, batch),
               tile_bytes(2 * kBlockM + 4 * kBlockN, D), s);
  if (err != cudaSuccess) return err;
  constexpr int BM = DkdvRows<D>::value;
  return launch(attention_dkdv_kernel<D>, a,
                dim3((a.skv + kBlockN - 1) / kBlockN, kv_heads, batch),
                tile_bytes(2 * kBlockN + 4 * BM, D) + 4 * BM * 4, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool strides_ok(const Strides& st) {
  return st.b % 8 == 0 && st.s % 8 == 0 && st.h % 8 == 0;
}

// The checks both entries share; fills the shape fields of `a`.
bool check(Args& a, const void* q, const void* k, const void* v, int batch,
           int sq, int skv, int heads, int kv_heads, int d, int q_offset,
           float scale) {
  if (batch < 1 || batch > 65535 || sq < 1 || skv < 1 || heads < 1 ||
      heads > 65535 || kv_heads < 1 || heads % kv_heads || q_offset < 0 ||
      static_cast<long long>(q_offset) + sq > skv ||
      (d != 64 && d != 80 && d != 96 && d != 128)) {
    return false;
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !strides_ok(a.lq) ||
      !strides_ok(a.lk) || !strides_ok(a.lv)) {
    return false;
  }
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.sq = sq;
  a.skv = skv;
  a.heads = heads;
  a.group = heads / kv_heads;
  a.q_offset = q_offset;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  return true;
}

}  // namespace

// q (B, Sq, H, d), k and v (B, Skv, KV, d) bfloat16 at the given element
// strides (batch, position, head; d contiguous) -> o (B, Sq, H, d)
// contiguous and lse (B, H, Sq) float32.  Returns the cudaError_t of the
// launch (0 on success), or cudaErrorInvalidValue for a shape, width,
// stride or alignment the kernel does not take.
extern "C" int attention_train_forward(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int sq, int skv, int heads, int kv_heads, int d, int q_offset,
    float scale, long long qb, long long qs, long long qh, long long kb,
    long long ks, long long kh, long long vb, long long vs, long long vh,
    void* stream) {
  Args a{};
  a.lq = {qb, qs, qh};
  a.lk = {kb, ks, kh};
  a.lv = {vb, vs, vh};
  if (!check(a, q, k, v, batch, sq, skv, heads, kv_heads, d, q_offset,
             scale) ||
      !aligned16(o)) {
    return cudaErrorInvalidValue;
  }
  a.out = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return forward<64>(a, batch, s);
    case 80: return forward<80>(a, batch, s);
    case 96: return forward<96>(a, batch, s);
    default: return forward<128>(a, batch, s);
  }
}

// The gradients of attention_train_forward's o: dout at the given strides,
// o and lse as the forward wrote them; delta (B, H, Sq) float32 is
// scratch; dq (B, Sq, H, d), dk and dv (B, Skv, KV, d) contiguous.
extern "C" int attention_train_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int sq, int skv, int heads, int kv_heads, int d,
    int q_offset, float scale, long long qb, long long qs, long long qh,
    long long kb, long long ks, long long kh, long long vb, long long vs,
    long long vh, long long ob, long long os, long long oh, void* stream) {
  Args a{};
  a.lq = {qb, qs, qh};
  a.lk = {kb, ks, kh};
  a.lv = {vb, vs, vh};
  a.ldo = {ob, os, oh};
  if (!check(a, q, k, v, batch, sq, skv, heads, kv_heads, d, q_offset,
             scale) ||
      !aligned16(o) || !aligned16(dout) || !strides_ok(a.ldo) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv)) {
    return cudaErrorInvalidValue;
  }
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<float*>(delta);
  a.out = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return backward<64>(a, batch, kv_heads, s);
    case 80: return backward<80>(a, batch, kv_heads, s);
    case 96: return backward<96>(a, batch, kv_heads, s);
    default: return backward<128>(a, batch, kv_heads, s);
  }
}
