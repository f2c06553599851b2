// Flash attention (online softmax over KV blocks), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel).  q (H,Sq,d), k and v (H,Skv,d)
// share one dtype, float32 or bfloat16; out (H,Sq,d) has q's dtype.
// Blocks bq | Sq and bkv | Skv may be any divisors (odd, 1, or the whole
// sequence), and d any width: the kernel bridge lowers the mapper's tile
// genes onto the blocks.
//
// Numerics carried over from the TPU kernel:
//   q is scaled in float32 before the dot (q * scale, scale = d**-0.5 by
//   default; the tensor-core body below scales the float32 logits); logits, the running max m, the running sum l and the
//   accumulator are float32; masked logits are the finite -1e30 (with -inf,
//   exp(m_prev - m_new) would be NaN on a row whose maximum is still the
//   mask value); causal masking compares absolute positions q_pos >= kv_pos
//   with no offset when Sq != Skv; KV blocks strictly above the q-block's
//   diagonal (ki*bkv > qi*bq + bq - 1) are skipped; the softmax state is
//   updated once per KV block; out = acc / max(l, 1e-30), cast to bfloat16
//   with round-to-nearest-even, as JAX's astype does.  expf and IEEE
//   division: no fast-math.  Sums run in another order than the reference
//   (a lane's share of d, then the lanes of a row), which the float32
//   tolerance covers.
//
// Order.  The TPU grid walks (head, q-block, kv-block) in order with m, l
// and acc in VMEM scratch across the KV steps.  Here a CTA owns all or a
// share of one (head, q-block) and walks that q-block's KV blocks in
// order itself; each thread keeps its rows' m, l and accumulator slice in
// registers for the whole walk.
//
// What bounds it on the H100: at BERT-base (12 heads, seq 512, d 64) the
// causal work is 2*2*H*S^2*d/2 = 0.40 GFLOP against 3 MB of operands, so
// it is bound by operations: 6.0 us at 67 TFLOP/s float32 on the CUDA
// cores (chip_smoke.attention_bound_ms).  The mapping does more than that:
// it computes whole blocks up to each q-block's diagonal, e.g. at
// (bq, bkv) = (16, 128) 80 KV blocks of 128 keys a head, 0.50 GFLOP or
// 7.5 us at the same peak (the design target, not the yardstick).  Before
// the FMA rate come the shared-memory reads that feed the FMAs, the
// per-block softmax (an exponential per logit), and at thin KV blocks the
// barriers and copies of each block.
// What the design does about it (kernels/flash_attention.py,
// attention_plan, picks every number below; this file checks the plan and
// refuses a bad one with cudaErrorInvalidValue):
//   * registers: a thread owns TR query rows ("row slots") of its CTA and
//     keeps their m, l and VEC accumulator columns in registers for the
//     whole KV walk; the q-block's rows are scaled once into shared memory
//     (float32, in the bytes the accumulator no longer takes);
//   * micro-tiles: the `lanes` lanes of a row group compute a block's
//     logits as a TR x TK register tile: `key_lanes` lanes split the keys
//     (TK a lane) and lanes/key_lanes lanes split d, their partial dots
//     summed by shuffles.  Each shared-memory read of q feeds TK keys and
//     each read of K feeds TR rows.  p goes to shared memory a slice of
//     key_lanes keys at a time (two slices a warp, one __syncwarp each),
//     and P.V runs as a TR-row x VEC-column tile a lane: `col_lanes` lanes
//     split d, and lanes/col_lanes of them split the slice's keys, their
//     partial accumulators summed by shuffles once, at the end.  At
//     blocks of 32 keys or more a row has 32 key lanes with whole dot
//     products (no two lanes of a warp read one K row: a 16-byte read
//     whose lanes repeat each other's addresses was timed slower); thinner
//     blocks put a warp's lanes over rows x keys, 16 a row (32 at
//     d >= 128), the lanes a block's keys leave splitting d;
//   * the kernel is a template on (dtype, VEC, TR, TK), the shapes the
//     plan returns, so the inner loops carry no guard: a block's last keys
//     past bkv (odd blocks) read a valid K/V row and are masked to -inf,
//     and a slab past d is read from a valid column and never stored;
//   * filling the card: a q-block of more than 16 rows (32 where a K/V
//     block takes more than 64 KB) is split over up to 8 plain CTAs
//     (grid x), each owning a share of its rows and staging the K/V blocks
//     on its own (they share nothing; K and V of all heads sit in L2); the
//     causal skipping stays at the whole q-block's diagonal.  The grid
//     walks the q-blocks from the last, so the heaviest causal q-blocks
//     start first.  A d wider than one pass of column lanes runs in column
//     passes (more CTAs), each recomputing the logits; a block of more keys
//     than the logit registers hold is walked twice (its maximum first,
//     then p and P.V);
//   * staging: K and V arrive by cp.async (16 bytes a copy for float32,
//     8 for bfloat16 where the plan proves alignment, else 4 or plain
//     loads) into rows whose 16-byte slabs are XOR-swizzled, so the lanes
//     of a row group read distinct banks without padding; copies walk the
//     tile with no division per element.  A run of `run` consecutive KV
//     blocks is staged per barrier (thin blocks: up to 128 keys).  Where
//     two runs fit the plan double-buffers them (the next run copies while
//     this one is computed); else K and V refill separately: the next K
//     while this block's softmax and P.V run, the next V while the next
//     QK^T runs.  A CTA of one or two rows at blocks of 128 keys or more
//     stages nothing: it reads K and V straight from device memory (each
//     value about once), so its request is q and p alone and many such
//     CTAs share an SM (staging 128 KB for one row left an SM one CTA).
//
// Every launch requests at most smem_bytes(bq, bkv, d, sizeof(T)) =
//   4*(bq*d + 2*bq + 4*bkv) + 2*bkv*(d*sizeof(T) + 4)
// bytes of dynamic shared memory, the mapping's formula (4 is the formula's
// own warp term, kept from the first version of this kernel): the plan
// lays out q (4*rows*d), the p slices and `run` K/V blocks (once or twice)
// inside it (q and p alone where it stages nothing).
//
// bfloat16 on the tensor cores (attention_mma_kernel<DK, DN, MINB>).  At
// BERT-base the causal work is the same 0.40 GFLOP, 0.41 us at the 989
// TFLOP/s bf16 peak, against 3.1 MB of operands (q, k, v and out, 12 x
// 512 x 64 at 2 bytes each), 0.94 us at 3.35 TB/s: the bytes bound it
// (chip_smoke.attention_bound_ms, 0.0009 ms).  The mapping's block work at
// (16, 128) is 0.0005 ms at the bf16 peak, and each CTA restages its K/V
// blocks from L2 (~3 us at BERT-base), so the time goes to latency:
// staging, barriers and the softmax between the two products.
// attention_plan runs this body for 16-bit operands at KV blocks of 3 keys
// or more and d <= 256, at any bq, wherever its layout fits the formula
// (kernels/flash_attention.py, mma_plan); blocks of one or two keys, where
// it was measured slower (each 16-key fragment holds one or two live keys),
// stay on the CUDA-core body above, which converts bfloat16 on load.
//   * both products on mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//     A warp owns 16 query rows; their A fragments come from shared memory
//     by ldmatrix once and stay in registers for the whole walk (DK steps
//     of 16 columns).  For QK^T, K's rows are the B operand's columns
//     (ldmatrix, not transposed); for P.V, V is read by ldmatrix.trans.
//     The scale is applied in float32 to the logits in the C fragments
//     (the reference scales q in float32 before its dot: the two differ
//     only in float32 rounding);
//   * p never touches shared memory: a row's maximum and sum come from
//     shuffles over the 4 lanes of a quad that hold it in the C fragment;
//     l sums the float32 p, as the reference does; p is packed to bfloat16
//     in registers (two 8-key C tiles are one 16-key A fragment) and goes
//     straight into the P.V mma.  That rounding of p to bfloat16 is the one
//     rounding the reference does not make (a relative 2^-9 a term; the
//     output stays within one bf16 ulp of the plain version, which
//     chip_smoke.py and the card tests hold at a tight (1e-2, 1e-2)
//     beside the bf16 tolerance);
//     the accumulator stays in float32 C fragments for the whole walk;
//   * filling the card at thin q-blocks: bq = 16 is one warp's rows, so a
//     CTA also takes up to 4 key warps that split each KV block's keys
//     (each in chunks of at most 64 keys, its logits in registers; a
//     block of more keys than a warp's chunk is walked twice, its maximum
//     first).  The warps exchange their rows' maxima once a block through
//     shared memory (two slots, by block parity), so every row still sees
//     its KV blocks in order with one softmax update each, and all warps
//     hold the same m; each keeps its own l and accumulator, summed once
//     at the end through the K/V bytes.  Keys were split, not rows or
//     columns: rows are already one fragment, and splitting d would
//     recompute the logits in every warp;
//   * staging: q, K and V by 16-byte cp.async into rows of 16-byte slabs
//     XOR-swizzled so the 8 rows an ldmatrix phase reads fall on distinct
//     banks; operands off 16 bytes (or a d not a multiple of 8) by plain
//     loads.  Two K/V buffers (runs of thin blocks, up to 128 keys) where
//     they fit the formula and leave room for a second CTA an SM; else one,
//     the next K copied while this block's P.V runs (the key warps' maximum
//     exchange is the barrier that frees K), the next V after it;
//   * ragged shapes: d is zero-padded to 16 columns in shared memory, so
//     the fragments' padding is zero; keys past bkv read a valid row
//     (clamped) and get p = 0 (-inf logits); rows past the CTA's compute
//     on its last row and are never stored; a d wider than 64 columns of
//     accumulator at DK = 16 (256, gemma-2b's head width) runs in column
//     passes (more CTAs), each recomputing the logits;
//   * launch bounds: up to 64 columns (~125 registers) two CTAs of 256
//     threads fit an SM (MINB = 2; the tuned (16, 128) CTA of 128 threads
//     leaves four an SM); 128 and 256 columns take one (MINB = 1).
// Not here: wgmma and TMA (a warpgroup tile is 64 rows; the tuned bq is
// 16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSplit = 8;
constexpr int kFormulaWarps = 4;
constexpr int kSmemLimit = 232448;
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kMaskValue = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
enum Stage { kSplit = 0, kDouble = 1, kDirect = 2 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int sq, skv, d, bq, bkv, causal;
  float scale;
  int slabs;       // d / VEC
  int lanes;       // lanes a row (LR)
  int key_lanes;   // lanes that split a block's keys (KQ)
  int col_lanes;   // lanes that split d in P.V (LRC)
  int rows;        // rows a CTA: bq / split
  int split, col_passes, chunks, run, stage;
  int p_at, kv_at;  // byte offsets of the p slices and of the K/V buffers
};

// VEC values at p (shared or device memory) as float32.
__device__ __forceinline__ void ld(float (&o)[4], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
__device__ __forceinline__ void ld(float (&o)[4], const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  o[0] = lo.x;
  o[1] = lo.y;
  o[2] = hi.x;
  o[3] = hi.y;
}
__device__ __forceinline__ void ld(float (&o)[1], const float* p) {
  o[0] = *p;
}
__device__ __forceinline__ void ld(float (&o)[1], const __nv_bfloat16* p) {
  o[0] = __bfloat162float(*p);
}

// VEC float32 values to p in T (bfloat16: round to nearest even).
__device__ __forceinline__ void st(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const unsigned*>(&lo);
  x.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}
__device__ __forceinline__ void st(float* p, const float (&v)[1]) {
  *p = v[0];
}
__device__ __forceinline__ void st(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES)
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

// The XOR swizzle of a row's slabs: slab c of row r lives at c ^ sw(r),
// sw(r) = (r >> shift) & mask, so that the rows read by one phase of a
// warp (8 lanes of 16-byte reads, 16 of 8-byte reads) fall on distinct
// banks.  mask + 1 divides the slab count, so the swizzle stays inside the
// row.  line: slabs of one 128-byte line.
struct Swizzle {
  int shift, mask;
};

__device__ __forceinline__ Swizzle make_swizzle(int slabs, int vec,
                                                int line) {
  if (vec == 1) return {0, 0};
  const int low = slabs & -slabs;
  int shift = 0;
  if (slabs < line && slabs == low) {
    while ((slabs << shift) < line) ++shift;
  }
  return {shift, min(low, line) - 1};
}

__device__ __forceinline__ int swz(Swizzle s, int r) {
  return (r >> s.shift) & s.mask;
}

// f(r, c) for this thread's (row, slab) pairs of `rows` rows of `slabs`
// slabs: pair threadIdx.x + t * blockDim.x, walked with no division per
// pair.
template <typename F>
__device__ __forceinline__ void for_each_slab(int rows, int slabs, F f) {
  int r = static_cast<int>(threadIdx.x) / slabs;
  int c = static_cast<int>(threadIdx.x) - r * slabs;
  const int dr = static_cast<int>(blockDim.x) / slabs;
  const int dc = static_cast<int>(blockDim.x) - dr * slabs;
  while (r < rows) {
    f(r, c);
    c += dc;
    r += dr;
    if (c >= slabs) {
      c -= slabs;
      ++r;
    }
  }
}

// Stage `rows` consecutive rows of `slabs` slabs (VEC values of T each)
// into dst, swizzled.
template <typename T, int VEC>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int rows, int slabs, Swizzle sw) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  for_each_slab(rows, slabs, [&](int r, int c) {
    T* o = dst + (r * slabs + (c ^ swz(sw, r))) * VEC;
    const T* i = src + (static_cast<size_t>(r) * slabs + c) * VEC;
    if constexpr (kBytes >= 4) {
      cp_async<kBytes>(o, i);
    } else {
      *o = *i;
    }
  });
}

// One CTA an SM is all the launch bounds promise: the register budget of
// a thread may then reach 255 (at (TR, TK) = (4, 8) the tile takes ~226),
// which timed no slower than the default bound at any BERT-base config.
template <typename T, int VEC, int TR, int TK>
__global__ void __launch_bounds__(kMaxThreads, 1)
    attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.slabs;
  const int LR = a.lanes;
  const int KQ = a.key_lanes;
  const int LRC = a.col_lanes;
  const int DQ = LR / KQ;    // lanes that split d in QK^T
  const int LRK = LR / LRC;  // lanes that split a slice's keys in P.V
  const int U = KQ / LRK;    // slice keys a lane multiplies into P.V
  const int RG = 32 / LR;    // row groups a warp
  const int WR = RG * TR;    // row slots a warp
  const int row_len = S * VEC;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int rg = lane / LR;
  const int lr = lane - rg * LR;
  const int kq = lr / DQ;
  const int dq = lr - kq * DQ;
  const int kg = lr / LRC;
  const int cg = lr - kg * LRC;

  // grid x: (q-block, from the last; share of its rows; column pass)
  const int per_q = a.split * a.col_passes;
  const int bx = static_cast<int>(blockIdx.x);
  const int qi = a.sq / a.bq - 1 - bx / per_q;
  const int part = (bx % per_q) / a.col_passes;
  const int pass = bx % a.col_passes;
  const int head = static_cast<int>(blockIdx.y);
  const int R = a.rows;
  const int row0 = qi * a.bq + part * R;

  float* qs = reinterpret_cast<float*>(smem);
  float* ps = reinterpret_cast<float*>(smem + a.p_at) + warp * 2 * WR * KQ;
  T* kbuf = reinterpret_cast<T*>(smem + a.kv_at);
  const int buf_elems = a.run * a.bkv * row_len;
  T* vbuf = kbuf + (a.stage == kDouble ? 2 : 1) * buf_elems;
  const Swizzle q_sw = make_swizzle(S, VEC, 128 / (4 * VEC));
  const bool direct = a.stage == kDirect;
  const Swizzle kv_sw =
      direct ? Swizzle{0, 0}
             : make_swizzle(S, VEC, 128 / (VEC * static_cast<int>(sizeof(T))));

  const size_t head_q = static_cast<size_t>(head) * a.sq * row_len;
  const size_t head_kv = static_cast<size_t>(head) * a.skv * row_len;
  const T* kg_head = static_cast<const T*>(a.k) + head_kv;
  const T* vg_head = static_cast<const T*>(a.v) + head_kv;

  // the q-block's KV blocks: all, or up to its diagonal
  const int n_kv = a.skv / a.bkv;
  const int n_blk =
      a.causal ? min(n_kv, (qi * a.bq + a.bq - 1) / a.bkv + 1) : n_kv;
  const int n_run = (n_blk + a.run - 1) / a.run;

  auto stage = [&](int r, int buf, bool with_k, bool with_v) {
    const int rows = min(a.run, n_blk - r * a.run) * a.bkv;
    const size_t at = static_cast<size_t>(r) * a.run * a.bkv * row_len;
    if (with_k) {
      stage_rows<T, VEC>(kbuf + buf * buf_elems, kg_head + at, rows, S,
                         kv_sw);
    }
    if (with_v) {
      stage_rows<T, VEC>(vbuf + buf * buf_elems, vg_head + at, rows, S,
                         kv_sw);
    }
    cp_async_commit();
  };

  if (a.stage == kDouble) {
    stage(0, 0, true, true);
  } else if (!direct) {
    stage(0, 0, true, false);
    stage(0, 0, false, true);
  }
  {  // q, scaled once into shared memory as float32
    const T* qg = static_cast<const T*>(a.q) + head_q +
                  static_cast<size_t>(row0) * row_len;
    for_each_slab(R, S, [&](int r, int c) {
      float x[VEC];
      ld(x, qg + (static_cast<size_t>(r) * S + c) * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] *= a.scale;
      st(qs + (r * S + (c ^ swz(q_sw, r))) * VEC, x);
    });
  }

  // this thread's row slots: slot = warp * WR + i * RG + rg; slots past
  // the CTA's rows compute on its last row and store nothing
  int q_off[TR], q_swz[TR], q_pos[TR];
  bool live[TR];
  float m[TR], l[TR], acc[TR][VEC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int slot = warp * WR + i * RG + rg;
    const int r = min(slot, R - 1);
    live[i] = slot < R;
    q_off[i] = r * row_len;
    q_swz[i] = swz(q_sw, r);
    q_pos[i] = row0 + r;
    m[i] = kMaskValue;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.0f;
  }
  // this lane's slab of P.V (a slab past d reads the last one, unstored)
  const int slab = pass * LRC + cg;
  const int slab_c = min(slab, S - 1);

  // Logits of keys c0 + t*KQ + kq (t < TK) of the block whose rows start
  // at krow0 in kb; kv0 is the block's first key position.
  auto logits = [&](float (&s)[TR][TK], const T* kb, int krow0, int c0,
                    int kv0) {
    int k_off[TK], k_swz[TK];
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      const int kr = krow0 + min(c0 + t * KQ + kq, a.bkv - 1);
      k_off[t] = kr * row_len;
      k_swz[t] = swz(kv_sw, kr);
#pragma unroll
      for (int i = 0; i < TR; ++i) s[i][t] = 0.0f;
    }
    for (int c = dq; c < S; c += DQ) {
      float qv[TR][VEC];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        ld(qv[i], qs + q_off[i] + (c ^ q_swz[i]) * VEC);
      }
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        float kv[VEC];
        ld(kv, kb + k_off[t] + (c ^ k_swz[t]) * VEC);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            s[i][t] = fmaf(qv[i][e], kv[e], s[i][t]);
          }
        }
      }
    }
    for (int off = 1; off < DQ; off <<= 1) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int t = 0; t < TK; ++t) {
          s[i][t] += __shfl_xor_sync(kFullMask, s[i][t], off);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      const int key = c0 + t * KQ + kq;
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        if (key >= a.bkv) {
          s[i][t] = -INFINITY;  // past the block: no weight, no maximum
        } else if (a.causal && q_pos[i] < kv0 + key) {
          s[i][t] = kMaskValue;
        }
      }
    }
  };

  // The block's maximum over the row's lanes, then m, l and acc rescaled.
  // Where the maximum did not move the factor is expf(0) = 1 exactly, and
  // multiplying by it changes nothing, so that is skipped.
  auto rescale = [&](float (&mb)[TR]) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      for (int off = DQ; off < LR; off <<= 1) {
        mb[i] = fmaxf(mb[i], __shfl_xor_sync(kFullMask, mb[i], off));
      }
      const float m_new = fmaxf(m[i], mb[i]);
      if (m_new != m[i]) {
        const float corr = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] *= corr;
      }
    }
  };

  // p = exp(s - m) in place; l sums each key once (the lanes that split
  // d hold the same logit)
  auto exponentiate = [&](float (&s)[TR][TK]) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        const float p = expf(s[i][t] - m[i]);
        s[i][t] = p;
        if (dq == 0) l[i] += p;
      }
    }
  };

  int p_buf = 0;
  // acc += p . V over keys c0 + ... of the block whose rows start at krow0
  auto pv = [&](const float (&s)[TR][TK], const T* vb, int krow0, int c0) {
    if (LR == 1) {  // one lane a row: its own keys and all its columns
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        const int kr = krow0 + min(c0 + t, a.bkv - 1);
        float vv[VEC];
        ld(vv, vb + kr * row_len + (slab_c ^ swz(kv_sw, kr)) * VEC);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            acc[i][e] = fmaf(s[i][t], vv[e], acc[i][e]);
          }
        }
      }
      return;
    }
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      float* pb = ps + p_buf * WR * KQ;
      p_buf ^= 1;
      if (dq == 0) {
#pragma unroll
        for (int i = 0; i < TR; ++i) pb[(i * RG + rg) * KQ + kq] = s[i][t];
      }
      __syncwarp();
      const int u0 = kg * U;
      const int key0 = c0 + t * KQ + u0;
      if ((U & 3) == 0) {
        for (int u = 0; u < U; u += 4) {
          float p4[TR][4];
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            ld(p4[i], pb + (i * RG + rg) * KQ + u0 + u);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kr = krow0 + min(key0 + u + j, a.bkv - 1);
            float vv[VEC];
            ld(vv, vb + kr * row_len + (slab_c ^ swz(kv_sw, kr)) * VEC);
#pragma unroll
            for (int i = 0; i < TR; ++i) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                acc[i][e] = fmaf(p4[i][j], vv[e], acc[i][e]);
              }
            }
          }
        }
      } else {
        for (int u = 0; u < U; ++u) {
          const int kr = krow0 + min(key0 + u, a.bkv - 1);
          float vv[VEC];
          ld(vv, vb + kr * row_len + (slab_c ^ swz(kv_sw, kr)) * VEC);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float p = pb[(i * RG + rg) * KQ + u0 + u];
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              acc[i][e] = fmaf(p, vv[e], acc[i][e]);
            }
          }
        }
      }
    }
  };

  const int keys_a_chunk = KQ * TK;
  if (direct) __syncthreads();  // q is in shared memory
  for (int r = 0; r < n_run; ++r) {
    const int buf = a.stage == kDouble ? (r & 1) : 0;
    const int nb = min(a.run, n_blk - r * a.run);
    if (a.stage == kDouble) {
      if (r + 1 < n_run) {
        stage(r + 1, buf ^ 1, true, true);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else if (!direct) {
      cp_async_wait<1>();  // K of this run (its V may still be in flight)
    }
    if (!direct) __syncthreads();
    const size_t run_at = static_cast<size_t>(r) * a.run * a.bkv * row_len;
    const T* kb = direct ? kg_head + run_at : kbuf + buf * buf_elems;
    const T* vb = direct ? vg_head + run_at : vbuf + buf * buf_elems;
    bool k_next = false;
    // kSplit: the K buffer is free once the run's last logits are in
    // registers; V must have landed before the run's first P.V
    auto release_k = [&](int b) {
      if (a.stage == kSplit && b == nb - 1) {
        __syncthreads();
        if (r + 1 < n_run) {
          stage(r + 1, 0, true, false);
          k_next = true;
        }
      }
    };
    auto acquire_v = [&](int b) {
      if (a.stage == kSplit && b == 0) {
        if (k_next) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
      }
    };
    // A block of one chunk: its logits, the softmax update, then P.V.  A
    // block of more chunks is walked twice: every chunk's logits for the
    // block's maximum, then each chunk's again for p and P.V.
    const int steps = a.chunks == 1 ? 1 : 2 * a.chunks;
    for (int b = 0; b < nb; ++b) {
      const int krow0 = b * a.bkv;
      const int kv0 = (r * a.run + b) * a.bkv;
      float mb[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) mb[i] = -INFINITY;
      for (int step = 0; step < steps; ++step) {
        const bool single = steps == 1;
        const int ch = single ? 0 : step % a.chunks;
        float s[TR][TK];
        logits(s, kb, krow0, ch * keys_a_chunk, kv0);
        if (step == steps - 1) release_k(b);
        if (single || step < a.chunks) {
#pragma unroll
          for (int i = 0; i < TR; ++i) {
#pragma unroll
            for (int t = 0; t < TK; ++t) mb[i] = fmaxf(mb[i], s[i][t]);
          }
          if (single || step == a.chunks - 1) rescale(mb);
        }
        if (single || step >= a.chunks) {
          exponentiate(s);
          if (single || step == a.chunks) acquire_v(b);
          pv(s, vb, krow0, ch * keys_a_chunk);
        }
      }
    }
    if (!direct) __syncthreads();  // every warp is done with the buffers
    if (a.stage == kSplit && r + 1 < n_run) stage(r + 1, 0, false, true);
  }

  // l over the row's lanes; acc over the lanes that split the keys
  T* og = static_cast<T*>(a.out) + head_q;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    for (int off = 1; off < LR; off <<= 1) {
      l[i] += __shfl_xor_sync(kFullMask, l[i], off);
    }
    for (int off = LRC; off < LR; off <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc[i][e] += __shfl_xor_sync(kFullMask, acc[i][e], off);
      }
    }
    if (live[i] && kg == 0 && slab < S) {
      const float denom = fmaxf(l[i], 1e-30f);
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = acc[i][e] / denom;
      st(og + static_cast<size_t>(q_pos[i]) * row_len + slab * VEC, o);
    }
  }
}

// Launch either body with `smem` bytes of dynamic shared memory (opted in
// above the default 48 KB).
template <typename A>
cudaError_t launch(void (*kernel)(A), const A& args, dim3 grid, int threads,
                   int smem, cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kChunkKeys = 64;  // keys a warp's logits hold at a time

// The tensor-core body's arguments; offsets in bytes of dynamic shared
// memory.
struct MmaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int sq, skv, d, bq, bkv, causal;
  float scale;
  int slabs;      // 16-byte slabs of a staged row: the padded d / 8
  int dk;         // 16-column steps of QK^T: the padded d / 16
  int rows;       // rows a CTA: bq / split
  int key_warps;  // warps that split a KV block's keys
  int keys;       // keys a warp a chunk (a multiple of 16)
  int chunks;     // chunks a warp a block
  int split, col_passes, run, stage;
  int vec8;       // K, V and q staged by 16-byte cp.async (else plain loads)
  int slots_at, kv_at;
};

// One warp's m16n8k16 product: d += a @ b, bfloat16 in, float32 sums
// (as tiled_matmul.cu's Mma<__nv_bfloat16>).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's four 8 x 8 matrices of 16-bit elements (8 rows of 16 bytes
// each) from shared memory at shared-space address s, lanes 8q..8q+7
// naming the rows of matrix q; .trans delivers each matrix transposed (as
// tiled_matmul.cu's ldmatrix_x4).  The memory clobber keeps the reads
// after the barrier that restages their buffer.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  unsigned s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// Two float32 values as one register of bfloat16 (round to nearest even),
// the first in the low half: the lower k of an A fragment pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Stage `rows` rows of d bfloat16 values (rows d apart at src) as rows of
// `slabs` swizzled 16-byte slabs, zero past d: by 16-byte cp.async where
// vec8 (d % 8 == 0 and every operand on 16 bytes), else by plain loads.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           int rows, int slabs, int d,
                                           Swizzle sw, bool vec8) {
  for_each_slab(rows, slabs, [&](int r, int c) {
    __nv_bfloat16* o = dst + (r * slabs + (c ^ swz(sw, r))) * 8;
    const int c0 = c * 8;
    const __nv_bfloat16* i = src + static_cast<size_t>(r) * d + c0;
    if (vec8 && c0 < d) {
      cp_async<16>(o, i);
      return;
    }
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    uint16_t* xs = reinterpret_cast<uint16_t*>(&x);
    const uint16_t* is = reinterpret_cast<const uint16_t*>(i);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (c0 + e < d) xs[e] = is[e];
    }
    *reinterpret_cast<uint4*>(o) = x;
  });
}

// DK: 16-column steps of QK^T whose q fragments a warp holds; DN: 8-column
// output tiles of one column pass (its accumulator); MINB: CTAs an SM the
// register budget must allow.
template <int DK, int DN, int MINB>
__global__ void __launch_bounds__(kMaxThreads, MINB)
    attention_mma_kernel(const MmaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NT = kChunkKeys / 8;  // 8-key logit tiles of a chunk
  const int S = a.slabs;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int KW = a.key_warps;
  const int kw = warp % KW;     // this warp's share of a block's keys
  const int rw = warp / KW;     // this warp's 16 rows of the CTA
  const int g = lane >> 2;      // fragment row (and row + 8)
  const int t = lane & 3;       // fragment column pair
  const int quad = lane >> 3;   // ldmatrix: the matrix this lane addresses
  const int r8 = lane & 7;      //   and its row in it

  // grid x: (q-block, from the last; share of its rows; column pass)
  const int per_q = a.split * a.col_passes;
  const int bx = static_cast<int>(blockIdx.x);
  const int qi = a.sq / a.bq - 1 - bx / per_q;
  const int part = (bx % per_q) / a.col_passes;
  const int pass = bx % a.col_passes;
  const int head = static_cast<int>(blockIdx.y);
  const int R = a.rows;
  // rows of the warps' fragments: the CTA's rows rounded up to 16
  const int Rp = static_cast<int>(blockDim.x) / 32 / KW * 16;
  const int row0 = qi * a.bq + part * R;
  const int rbase = rw * 16;

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* slots = reinterpret_cast<float*>(smem + a.slots_at);
  __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(smem + a.kv_at);
  const int row_len = S * 8;
  const int buf_elems = a.run * a.bkv * row_len;
  __nv_bfloat16* vbuf = kbuf + (a.stage == kDouble ? 2 : 1) * buf_elems;
  const Swizzle sw = make_swizzle(S, 8, 8);
  const bool vec8 = a.vec8 != 0;

  const size_t head_q = static_cast<size_t>(head) * a.sq * a.d;
  const size_t head_kv = static_cast<size_t>(head) * a.skv * a.d;
  const __nv_bfloat16* kg_head =
      static_cast<const __nv_bfloat16*>(a.k) + head_kv;
  const __nv_bfloat16* vg_head =
      static_cast<const __nv_bfloat16*>(a.v) + head_kv;

  const int n_kv = a.skv / a.bkv;
  const int n_blk =
      a.causal ? min(n_kv, (qi * a.bq + a.bq - 1) / a.bkv + 1) : n_kv;
  const int n_run = (n_blk + a.run - 1) / a.run;

  auto stage = [&](int r, int buf, bool with_k, bool with_v) {
    const int rows = min(a.run, n_blk - r * a.run) * a.bkv;
    const size_t at = static_cast<size_t>(r) * a.run * a.bkv * a.d;
    if (with_k) {
      stage_bf16(kbuf + buf * buf_elems, kg_head + at, rows, S, a.d, sw,
                 vec8);
    }
    if (with_v) {
      stage_bf16(vbuf + buf * buf_elems, vg_head + at, rows, S, a.d, sw,
                 vec8);
    }
    cp_async_commit();
  };

  // q first (its own group), then K and V of the first run
  stage_bf16(qs,
             static_cast<const __nv_bfloat16*>(a.q) + head_q +
                 static_cast<size_t>(row0) * a.d,
             R, S, a.d, sw, vec8);
  cp_async_commit();
  if (a.stage == kDouble) {
    stage(0, 0, true, true);
  } else {
    stage(0, 0, true, false);
    stage(0, 0, false, true);
  }

  // this lane's rows (g, g + 8 of the warp's 16); rows past the CTA's are
  // computed on its last row and never stored
  int q_pos[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rbase + g + 8 * i;
    live[i] = r < R;
    q_pos[i] = row0 + min(r, R - 1);
  }
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.0f, 0.0f};
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  uint32_t qf[DK][4];
  const int dn = min(DN, S - pass * DN);  // output tiles of this pass
  const int key0 = kw * a.keys * a.chunks;  // this warp's first key

  // Logits of chunk ch of this warp's keys of the block whose rows start
  // at krow0 in kb (kv0: its first key position): scaled in float32, keys
  // past the block -inf, causally masked ones the mask value.
  auto logits = [&](float (&s)[NT][4], const __nv_bfloat16* kb, int krow0,
                    int ch, int kv0) {
    const unsigned kb_s = static_cast<unsigned>(__cvta_generic_to_shared(kb));
    const int c0 = key0 + ch * a.keys;
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      if (16 * jp >= a.keys) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[2 * jp][e] = 0.0f;
        s[2 * jp + 1][e] = 0.0f;
      }
      const int kr = krow0 + min(c0 + 16 * jp + (quad >> 1) * 8 + r8,
                                 a.bkv - 1);
      const unsigned row_s = kb_s + kr * row_len * 2;
      const int ksw = swz(sw, kr);
#pragma unroll
      for (int ks = 0; ks < DK; ++ks) {
        if (ks >= a.dk) break;
        uint32_t b[4];
        ldmatrix_x4(b, row_s + (((2 * ks + (quad & 1)) ^ ksw) << 4));
        mma_bf16(s[2 * jp], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[ks], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (8 * j >= a.keys) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * a.scale;
        if (key >= a.bkv) {
          x = -INFINITY;  // past the block: no weight, no maximum
        } else if (a.causal && q_pos[e >> 1] < kv0 + key) {
          x = kMaskValue;
        }
        s[j][e] = x;
      }
    }
  };

  auto chunk_max = [&](const float (&s)[NT][4], float (&mb)[2]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (8 * j >= a.keys) break;
      mb[0] = fmaxf(mb[0], fmaxf(s[j][0], s[j][1]));
      mb[1] = fmaxf(mb[1], fmaxf(s[j][2], s[j][3]));
    }
  };

  // p = exp(s - m) (l sums the float32 p), then acc += p . V over the
  // chunk's keys, p packed to bfloat16 in registers: two 8-key C tiles are
  // one 16-key A fragment.
  auto pv = [&](float (&s)[NT][4], const __nv_bfloat16* vb, int krow0,
                int ch) {
    const unsigned vb_s = static_cast<unsigned>(__cvta_generic_to_shared(vb));
    const int c0 = key0 + ch * a.keys;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (8 * j >= a.keys) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (16 * kk >= a.keys) break;
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int vr = krow0 + min(c0 + 16 * kk + (quad & 1) * 8 + r8,
                                 a.bkv - 1);
      const unsigned row_s = vb_s + vr * row_len * 2;
      const int vsw = swz(sw, vr);
#pragma unroll
      for (int np = 0; np < DN / 2; ++np) {
        if (2 * np >= dn) break;
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, row_s + (((pass * DN + 2 * np + (quad >> 1)) ^ vsw) << 4));
        mma_bf16(acc[2 * np], pa, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
  };

  // The block's maximum over the key warps (two slots, by block parity:
  // a warp can be one block ahead of another at most), then m, l and acc
  // rescaled.  Where the maximum did not move the factor is expf(0) = 1
  // exactly, and multiplying by it changes nothing, so that is skipped.
  auto rescale = [&](float (&mb)[2], int blk) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mb[i] = fmaxf(mb[i], __shfl_xor_sync(kFullMask, mb[i], 1));
      mb[i] = fmaxf(mb[i], __shfl_xor_sync(kFullMask, mb[i], 2));
    }
    if (KW > 1) {
      float* sl = slots + (blk & 1) * KW * Rp;
      if (t == 0) {
        sl[kw * Rp + rbase + g] = mb[0];
        sl[kw * Rp + rbase + g + 8] = mb[1];
      }
      __syncthreads();
      for (int w = 0; w < KW; ++w) {
        mb[0] = fmaxf(mb[0], sl[w * Rp + rbase + g]);
        mb[1] = fmaxf(mb[1], sl[w * Rp + rbase + g + 8]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], mb[i]);
      if (m_new != m[i]) {
        const float corr = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr;
#pragma unroll
        for (int n = 0; n < DN; ++n) {
          acc[n][2 * i] *= corr;
          acc[n][2 * i + 1] *= corr;
        }
      }
    }
  };

  for (int r = 0; r < n_run; ++r) {
    const int buf = a.stage == kDouble ? (r & 1) : 0;
    const int nb = min(a.run, n_blk - r * a.run);
    if (a.stage == kDouble) {
      if (r + 1 < n_run) {
        stage(r + 1, buf ^ 1, true, true);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      cp_async_wait<1>();  // K of this run (its V may still be in flight)
    }
    __syncthreads();
    if (r == 0) {  // the warp's q fragments, held for the whole walk
      const int qr = min(rbase + (quad & 1) * 8 + r8, R - 1);
      const unsigned q_s = static_cast<unsigned>(__cvta_generic_to_shared(qs)) +
                           qr * row_len * 2;
#pragma unroll
      for (int ks = 0; ks < DK; ++ks) {
        if (ks >= a.dk) break;
        ldmatrix_x4(qf[ks],
                    q_s + (((2 * ks + (quad >> 1)) ^ swz(sw, qr)) << 4));
      }
    }
    const __nv_bfloat16* kb = kbuf + buf * buf_elems;
    const __nv_bfloat16* vb = vbuf + buf * buf_elems;
    bool k_next = false;
    for (int b = 0; b < nb; ++b) {
      const int krow0 = b * a.bkv;
      const int blk = r * a.run + b;
      const int kv0 = blk * a.bkv;
      float s[NT][4];
      float mb[2] = {-INFINITY, -INFINITY};
      for (int ch = 0; ch < a.chunks; ++ch) {
        logits(s, kb, krow0, ch, kv0);
        chunk_max(s, mb);
      }
      rescale(mb, blk);
      // kSplit: K is free once every warp's logits of the run's last block
      // are in registers (a block of one chunk; else it is read again)
      if (a.stage == kSplit && a.chunks == 1 && b == nb - 1 &&
          r + 1 < n_run) {
        if (KW == 1) __syncthreads();
        stage(r + 1, 0, true, false);
        k_next = true;
      }
      if (a.stage == kSplit && b == 0) {  // V of this run has landed
        if (k_next) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
      }
      if (a.chunks == 1) {
        pv(s, vb, krow0, 0);
      } else {
        for (int ch = 0; ch < a.chunks; ++ch) {
          logits(s, kb, krow0, ch, kv0);
          pv(s, vb, krow0, ch);
        }
      }
    }
    __syncthreads();  // every warp is done with the buffers
    if (a.stage == kSplit && r + 1 < n_run) {
      if (!k_next) stage(r + 1, 0, true, false);
      stage(r + 1, 0, false, true);
    }
  }

  // l over the quad's lanes; one key warp stores its rows, several sum
  // their accumulators through shared memory (the K/V bytes, now free)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFullMask, l[i], 1);
    l[i] += __shfl_xor_sync(kFullMask, l[i], 2);
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) + head_q;
  const int col0 = pass * DN * 8;
  if (KW == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
      const float denom = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = og + static_cast<size_t>(q_pos[i]) * a.d;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        if (n >= dn) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col0 + 8 * n + 2 * t + e;
          if (c < a.d) orow[c] = __float2bfloat16_rn(acc[n][2 * i + e] / denom);
        }
      }
    }
    return;
  }
  constexpr int kStride = DN * 8 + 4;  // floats from one summed row to the next
  float* red = reinterpret_cast<float*>(smem + a.kv_at);
  float* lred = red + KW * Rp * kStride;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kw * Rp + rbase + g + 8 * i;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      if (n >= dn) break;
      red[row * kStride + 8 * n + 2 * t] = acc[n][2 * i];
      red[row * kStride + 8 * n + 2 * t + 1] = acc[n][2 * i + 1];
    }
    if (t == 0) lred[row] = l[i];
  }
  __syncthreads();
  const int cols = min(dn * 8, a.d - col0);
  for (int idx = static_cast<int>(threadIdx.x); idx < R * cols;
       idx += static_cast<int>(blockDim.x)) {
    const int row = idx / cols;
    const int c = idx - row * cols;
    float sum = 0.0f;
    float lsum = 0.0f;
    for (int w = 0; w < KW; ++w) {
      sum += red[(w * Rp + row) * kStride + c];
      lsum += lred[w * Rp + row];
    }
    og[static_cast<size_t>(row0 + row) * a.d + col0 + c] =
        __float2bfloat16_rn(sum / fmaxf(lsum, 1e-30f));
  }
}

// The padded widths kernels/flash_attention.py's MMA_SHAPES lists, each
// with its (DK, DN): q fragments of the whole width, an accumulator of one
// column pass.  Up to 64 columns the register budget is 128 a thread, so
// two CTAs of 256 threads fit an SM; wider ones take one.
int mma_width(int dpad) {
  for (int w : {16, 32, 64, 128, 256}) {
    if (dpad <= w) return w;
  }
  return 0;
}

int mma_cols(int width) { return width == 256 ? 64 : width; }

cudaError_t by_width(int width, const MmaArgs& args, dim3 grid, int threads,
                     int smem, cudaStream_t stream) {
  switch (width) {
    case 16:
      return launch(attention_mma_kernel<1, 2, 2>, args, grid, threads, smem,
                    stream);
    case 32:
      return launch(attention_mma_kernel<2, 4, 2>, args, grid, threads, smem,
                    stream);
    case 64:
      return launch(attention_mma_kernel<4, 8, 2>, args, grid, threads, smem,
                    stream);
    case 128:
      return launch(attention_mma_kernel<8, 16, 1>, args, grid, threads, smem,
                    stream);
    case 256:
      return launch(attention_mma_kernel<16, 8, 1>, args, grid, threads, smem,
                    stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int VEC, int TR, int TK>
cudaError_t launch_kernel(const Args& args, dim3 grid, int threads, int smem,
                          cudaStream_t stream) {
  return launch(attention_kernel<T, VEC, TR, TK>, args, grid, threads, smem,
                stream);
}

// The (VEC, TR, TK) shapes attention_plan returns: 16-byte slabs with 4, 2
// or 1 rows a thread (TR * TK <= 32 logits), single values (d not a
// multiple of 4, or operands off 16-byte alignment) with one row.
template <typename T, int VEC, int TR>
cudaError_t by_keys(int keys, const Args& args, dim3 grid, int threads,
                    int smem, cudaStream_t stream) {
  switch (keys) {
    case 1: return launch_kernel<T, VEC, TR, 1>(args, grid, threads, smem,
                                                stream);
    case 2: return launch_kernel<T, VEC, TR, 2>(args, grid, threads, smem,
                                                stream);
    case 4: return launch_kernel<T, VEC, TR, 4>(args, grid, threads, smem,
                                                stream);
    case 8: return launch_kernel<T, VEC, TR, 8>(args, grid, threads, smem,
                                                stream);
    default:
      if constexpr (TR <= 2) {
        if (keys == 16) {
          return launch_kernel<T, VEC, TR, 16>(args, grid, threads, smem,
                                               stream);
        }
      }
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_shape(int vec, int rows, int keys, const Args& args,
                     dim3 grid, int threads, int smem, cudaStream_t stream) {
  if (vec == 1) {
    return rows == 1
               ? by_keys<T, 1, 1>(keys, args, grid, threads, smem, stream)
               : cudaErrorInvalidValue;
  }
  switch (rows) {
    case 1: return by_keys<T, 4, 1>(keys, args, grid, threads, smem, stream);
    case 2: return by_keys<T, 4, 2>(keys, args, grid, threads, smem, stream);
    case 4: return by_keys<T, 4, 4>(keys, args, grid, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

long long round16(long long v) { return (v + 15) / 16 * 16; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

long long formula_bytes(int bq, int bkv, int d, long long item) {
  return 4ll * (static_cast<long long>(bq) * d + 2ll * bq +
                static_cast<long long>(kFormulaWarps) * bkv) +
         2ll * bkv * (d * item + 4);
}

// The tensor-core body's launch: the plan's fields checked against the
// layout kernels/flash_attention.py::mma_layout computes.
cudaError_t launch_tensor_body(const void* q, const void* k, const void* v,
                               void* out, int heads, int sq, int skv, int d,
                               int bq, int bkv, int causal, float scale,
                               int threads, int warp_rows, int rows,
                               int lanes, int key_lanes, int col_lanes,
                               int keys, int vec, int split, int col_passes,
                               int chunks, int run, int stage, int smem,
                               int key_warps, cudaStream_t stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  const int dpad = (d + 15) / 16 * 16;
  const int width = mma_width(dpad);
  if (width == 0 || warp_rows != 16 || rows != 2 || lanes != 4 ||
      key_lanes != 4 || col_lanes != 4) {
    return bad;
  }
  if (vec == 8) {
    if (d % 8 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
        !aligned16(out)) {
      return bad;
    }
  } else if (vec != 1) {
    return bad;
  }
  if (split < 1 || split > kMaxSplit || bq % split) return bad;
  const int cta_rows = bq / split;
  const long long row_warps = cdiv(cta_rows, 16);
  if (key_warps < 1 || threads != 32 * row_warps * key_warps ||
      threads > kMaxThreads) {
    return bad;
  }
  // every key of a block in one warp's chunks, no warp without keys
  const long long warp_keys = static_cast<long long>(keys) * chunks;
  if (keys < 16 || keys > kChunkKeys || keys % 16 || chunks < 1 ||
      key_warps * warp_keys < bkv || (key_warps - 1) * warp_keys >= bkv) {
    return bad;
  }
  const int cols = mma_cols(width);
  if (col_passes != cdiv(dpad, cols) ||
      (stage != kSplit && stage != kDouble) || run < 1 ||
      (stage == kSplit && run != 1)) {
    return bad;
  }
  const long long rows_pad = row_warps * 16;
  const long long q_bytes = round16(2ll * cta_rows * dpad);
  const long long slot_bytes =
      key_warps == 1 ? 0 : round16(8ll * key_warps * rows_pad);
  const long long kv_bytes =
      2ll * (stage == kDouble ? 2 : 1) * run * bkv * dpad * 2;
  const long long red_bytes =
      key_warps == 1 ? 0 : 4ll * key_warps * rows_pad * (cols + 4 + 1);
  const long long kv_at = q_bytes + slot_bytes;
  if (smem != kv_at + (kv_bytes > red_bytes ? kv_bytes : red_bytes) ||
      smem > formula_bytes(bq, bkv, d, 2) || smem > kSmemLimit) {
    return bad;
  }
  const long long grid_x =
      static_cast<long long>(sq / bq) * split * col_passes;
  if (grid_x >= (1ll << 31)) return bad;
  MmaArgs args{q,          k,          v,          out,
               sq,         skv,        d,          bq,
               bkv,        causal,     scale,      dpad / 8,
               dpad / 16,  cta_rows,   key_warps,  keys,
               chunks,     split,      col_passes, run,
               stage,      vec == 8,   static_cast<int>(q_bytes),
               static_cast<int>(kv_at)};
  const dim3 grid(static_cast<unsigned>(grid_x), heads);
  return by_width(width, args, grid, threads, smem, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The plan (threads .. key_warps) comes
// from kernels/flash_attention.py::attention_plan; body 0 runs the CUDA
// cores (attention_kernel), body 1 the tensor cores (attention_mma_kernel,
// bfloat16 only).  Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    int heads, int sq, int skv, int d, int bq, int bkv, int causal,
    float scale, int threads, int warp_rows, int rows, int lanes,
    int key_lanes, int col_lanes, int keys, int vec, int split,
    int col_passes, int chunks, int run, int stage, int smem, int body,
    int key_warps, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return bad;
  const long long item = dtype == 0 ? 4 : 2;
  if (heads < 1 || heads > 65535 || sq < 1 || skv < 1 || d < 1 || bq < 1 ||
      bkv < 1 || sq % bq || skv % bkv) {
    return bad;
  }
  if (body == 1) {
    if (dtype != 1) return bad;
    return launch_tensor_body(q, k, v, out, heads, sq, skv, d, bq, bkv,
                              causal, scale, threads, warp_rows, rows, lanes,
                              key_lanes, col_lanes, keys, vec, split,
                              col_passes, chunks, run, stage, smem, key_warps,
                              static_cast<cudaStream_t>(stream));
  }
  if (body != 0 || key_warps != 1) return bad;
  // the launch's shape
  if (vec == 4) {
    if (d % 4 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
        !aligned16(out)) {
      return bad;
    }
  } else if (vec != 1) {
    return bad;
  }
  const int slabs = d / vec;
  if (!pow2(lanes) || lanes > 32 || !pow2(key_lanes) || lanes % key_lanes ||
      key_lanes > bkv || slabs % (lanes / key_lanes) || !pow2(col_lanes) ||
      lanes % col_lanes || key_lanes % (lanes / col_lanes)) {
    return bad;
  }
  if (split < 1 || split > kMaxSplit || bq % split) return bad;
  const int cta_rows = bq / split;
  if (warp_rows != (32 / lanes) * rows ||
      threads != 32 * cdiv(cta_rows, warp_rows) || threads > kMaxThreads) {
    return bad;
  }
  if (col_passes != cdiv(slabs, col_lanes) ||
      chunks != cdiv(bkv, static_cast<long long>(key_lanes) * keys) ||
      run < 1 || (stage != kSplit && stage != kDouble && stage != kDirect)) {
    return bad;
  }
  // the layout: q, the p slices (none at one lane a row), then K and V
  const long long q_bytes = round16(4ll * cta_rows * d);
  const long long p_bytes =
      lanes == 1 ? 0 : round16(8ll * (threads / 32) * warp_rows * key_lanes);
  const long long kv_bytes =
      stage == kDirect
          ? 0
          : 2ll * (stage == kDouble ? 2 : 1) * run * bkv * d * item;
  const long long formula = formula_bytes(bq, bkv, d, item);
  if (smem != q_bytes + p_bytes + kv_bytes || smem > formula ||
      smem > kSmemLimit) {
    return bad;
  }
  const long long grid_x =
      static_cast<long long>(sq / bq) * split * col_passes;
  if (grid_x >= (1ll << 31)) return bad;

  Args args{q,     k,         v,          out,   sq,
            skv,   d,         bq,         bkv,   causal,
            scale, slabs,     lanes,      key_lanes,
            col_lanes,        cta_rows,   split, col_passes,
            chunks, run,      stage,      static_cast<int>(q_bytes),
            static_cast<int>(q_bytes + p_bytes)};
  const dim3 grid(static_cast<unsigned>(grid_x), heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? by_shape<float>(vec, rows, keys, args, grid, threads, smem, s)
             : by_shape<__nv_bfloat16>(vec, rows, keys, args, grid, threads,
                                       smem, s);
}
