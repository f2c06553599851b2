// Flash attention (online softmax over KV blocks), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel).  q (H,Sq,d), k and v (H,Skv,d)
// share one dtype, float32 or bfloat16; out (H,Sq,d) has q's dtype.
// Blocks bq | Sq and bkv | Skv may be any divisors (odd, 1, or the whole
// sequence): the kernel bridge lowers the mapper's tile genes onto them.
//
// Numerics carried over from the TPU kernel:
//   q is scaled in float32 before the dot (q * scale, scale = d**-0.5 by
//   default); logits, the running max m, the running sum l and the
//   accumulator are float32; masked logits are the finite -1e30 (with -inf,
//   exp(m_prev - m_new) would be NaN on a row whose maximum is still the
//   mask value); causal masking compares absolute positions q_pos >= kv_pos
//   with no offset when Sq != Skv; KV blocks strictly above the diagonal
//   (ki*bkv > qi*bq + bq - 1) are skipped; out = acc / max(l, 1e-30), cast
//   to bfloat16 with round-to-nearest-even (__float2bfloat16), as JAX's
//   astype does.  expf and IEEE division: no fast-math.
//
// Order.  The TPU grid walks (head, q-block, kv-block) in order with m, l
// and acc in VMEM scratch across the KV steps.  Here one CUDA block owns
// one (head, q-block) and loops over the KV blocks itself; m, l and acc
// live in shared memory for the whole loop.
//
// What bounds it on the H100: at BERT-base (12 heads, seq 512, d 64) the
// causal work is 2*2*H*S^2*d/2 = 0.4 GFLOP against 3 MB of operands, so a
// tensor-core kernel would be bound by operations (0.4 us at 989 TFLOP/s
// bf16; 6 us at 67 TFLOP/s float32 on the CUDA cores).  This first version
// multiplies on the CUDA cores out of shared memory (no wgmma, no TMA), so
// it is bound by shared-memory reads and FMA issue.
// What the design does about it:
//   * layout: 4 warps; warp w owns query rows w, w+4, ... of the q-block,
//     one row at a time.  For a row, lane j computes the logits of keys
//     j, j+32, ... (the q row is a broadcast read, each K row is read by
//     one lane), the warp reduces max and sum with shuffles, and lane c
//     then owns accumulator columns c, c+32, ...  Rows are not held in
//     registers, so bq = 512 and d = 128 need no more registers than
//     bq = d = 16; the row state (m, l, acc) stays in shared memory;
//   * each K and V block is staged in shared memory once per q-block, at
//     the operand width (bf16 halves the bytes); a q row is read by the
//     whole warp at one address (a broadcast, from L1 after its first
//     KV block), so the q-block needs no shared memory and bq = d = 128
//     fits at float32;
//   * K and V rows are padded by one 32-bit word, so lanes reading
//     consecutive K rows hit different banks (row stride d*size + 4 bytes).
//
// Every launch requests smem_bytes(bq, bkv, d, sizeof(T)) =
//   4*(bq*d + 2*bq + 4*bkv) + 2*bkv*(d*sizeof(T) + 4)
// bytes of dynamic shared memory (kernels/flash_attention.py keeps the
// same formula; above 48 KB it is requested with cudaFuncSetAttribute).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kMaskValue = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, o);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int sq, int skv, int d, int bq, int bkv,
                           int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);         // bq x d
  float* m_run = acc + bq * d;                         // bq
  float* l_run = m_run + bq;                           // bq
  float* p_all = l_run + bq;                           // kWarps x bkv
  const int ld = d + 4 / static_cast<int>(sizeof(T));  // padded K/V row
  T* ks = reinterpret_cast<T*>(p_all + kWarps * bkv);  // bkv x ld
  T* vs = ks + bkv * ld;                               // bkv x ld

  const int qi = blockIdx.x;
  const int head = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = p_all + warp * bkv;
  const size_t q0 = (static_cast<size_t>(head) * sq +
                     static_cast<size_t>(qi) * bq) * d;
  const size_t kv0 = static_cast<size_t>(head) * skv * d;

  for (int e = threadIdx.x; e < bq * d; e += kThreads) acc[e] = 0.0f;
  for (int r = threadIdx.x; r < bq; r += kThreads) {
    m_run[r] = kMaskValue;
    l_run[r] = 0.0f;
  }

  const int n_kv = skv / bkv;
  const int last_q = qi * bq + bq - 1;
  for (int ki = 0; ki < n_kv; ++ki) {
    // blocks strictly above the diagonal, and all after them, are skipped
    if (causal && ki * bkv > last_q) break;
    __syncthreads();  // the previous K/V block is no longer read
    for (int e = threadIdx.x; e < bkv * d; e += kThreads) {
      const int j = e / d;
      const int c = e - j * d;
      const size_t g = kv0 + static_cast<size_t>(ki * bkv + j) * d + c;
      ks[j * ld + c] = k[g];
      vs[j * ld + c] = v[g];
    }
    __syncthreads();

    for (int r = warp; r < bq; r += kWarps) {
      const int q_pos = qi * bq + r;
      const T* qr = q + q0 + static_cast<size_t>(r) * d;
      // logits of this row against the block's keys, lane j: keys j, j+32..
      float m_blk = kMaskValue;
      for (int j = lane; j < bkv; j += 32) {
        const T* kr = ks + j * ld;
        float s = 0.0f;
        for (int c = 0; c < d; ++c) {
          s = fmaf(to_f32(qr[c]) * scale, to_f32(kr[c]), s);
        }
        if (causal && q_pos < ki * bkv + j) s = kMaskValue;
        p[j] = s;
        m_blk = fmaxf(m_blk, s);
      }
      m_blk = warp_max(m_blk);
      const float m_prev = m_run[r];
      const float m_new = fmaxf(m_prev, m_blk);
      float l_blk = 0.0f;
      for (int j = lane; j < bkv; j += 32) {
        const float e = expf(p[j] - m_new);
        p[j] = e;
        l_blk += e;
      }
      l_blk = warp_sum(l_blk);
      const float corr = expf(m_prev - m_new);
      __syncwarp();  // every lane's p[j] is visible to the whole warp
      for (int c = lane; c < d; c += 32) {
        float pv = 0.0f;
        for (int j = 0; j < bkv; ++j) {
          pv = fmaf(p[j], to_f32(vs[j * ld + c]), pv);
        }
        acc[r * d + c] = acc[r * d + c] * corr + pv;
      }
      __syncwarp();  // p is rewritten by the warp's next row
      if (lane == 0) {
        m_run[r] = m_new;
        l_run[r] = l_run[r] * corr + l_blk;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < bq * d; e += kThreads) {
    const int r = e / d;
    store(out + q0 + e, acc[e] / fmaxf(l_run[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int heads, int sq, int skv, int d, int bq, int bkv,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(bq) * d + 2 * bq +
                       static_cast<size_t>(kWarps) * bkv) +
      2 * static_cast<size_t>(bkv) * (sizeof(T) * d + 4);
  auto kernel = flash_attention_kernel<T>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(sq / bq, heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, d, bq, bkv,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v,
                                      void* out, int heads, int sq, int skv,
                                      int d, int bq, int bkv, int causal,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, out, heads, sq, skv, d, bq, bkv, causal,
                           scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, out, heads, sq, skv, d, bq, bkv,
                                   causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
