// Chunked selective scan (the Mamba-1 recurrence), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py::
// mamba_scan (body _scan_kernel):
//
//     h_t = exp(dt_t (x) A) * h_{t-1} + (dt_t * x_t) (x) B_t
//     y_t = <h_t, C_t> + D * x_t
//
// x, dt, y (B,L,D); b, c (B,L,N); A = a_log_neg (D,N); D = d_skip (D,).
// float32 only, with the state h (D,N) in float32.  chunk | L and
// d_block | D may be any divisors (d_block may be all of D).  expf and no
// fast-math: the oracle holds the result at 2e-4 over thousands of steps.
//
// Order.  The TPU grid runs (batch, d-block) in parallel and the chunks in
// order, carrying h in VMEM scratch.  Here one CUDA block owns one
// (batch, d-block) and loops over the chunks itself; h stays in registers
// for the whole sequence.
//
// What bounds it on the H100: at falcon-mamba-7b (B 1, L 4096, D 8192,
// N 16) it must move x, dt and y (3 x 128 MB) and b, c, A, D (~1 MB): about
// 0.12 ms at 3.35 TB/s, above the ~4.3 GFLOP of float32 work at 67 TFLOP/s
// (~0.07 ms).  So it is bound by bytes, and by the sequential dependence of
// h_t on h_{t-1} (one FMA chain of L steps per state element).
// What the design does about it:
//   * lanes over the state: a channel's N states sit in `lanes` adjacent
//     threads (lanes = N rounded up to a power of two, at most 32; up to 4
//     states a thread), and <h, C> is a __shfl_xor tree over those lanes.
//     At N = 16 that is 16x the threads of one thread per channel, which
//     at B = 1 is what fills the 132 SMs;
//   * a block runs `group` = min(d_block, 1024 / lanes) channels at once
//     (at most 1024 threads) and loops over the rest of its d-block in
//     passes, so a d-block of all 8192 channels is legal, only slow;
//   * per chunk, x and dt of the pass's channels and b, c of the chunk are
//     staged in shared memory with coalesced loads (consecutive threads,
//     consecutive channels), y is staged there too and written back
//     coalesced at the end of the chunk; exp(dt*A) needs no h, so it
//     overlaps the FMA chain.
//
// Every launch requests smem_bytes(chunk, d_block, N, 4) =
//   4*(3*chunk*group + 2*chunk*N)
// bytes of dynamic shared memory (kernels/mamba_scan.py keeps the same
// formula; above 48 KB it is requested with cudaFuncSetAttribute).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPerLane = 4;
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kMaxThreads)
    mamba_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ b,
                      const float* __restrict__ c,
                      const float* __restrict__ a_log_neg,
                      const float* __restrict__ d_skip,
                      float* __restrict__ y, int seq, int dim, int n_state,
                      int chunk, int d_block, int lanes, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // chunk x group
  float* dts = xs + chunk * group;             // chunk x group
  float* ys = dts + chunk * group;             // chunk x group
  float* bs = ys + chunk * group;              // chunk x N
  float* cs = bs + chunk * n_state;            // chunk x N

  const int batch = blockIdx.y;
  const int d0 = blockIdx.x * d_block;
  const int g = threadIdx.x / lanes;       // channel slot in the pass
  const int lane = threadIdx.x - g * lanes;  // state lane of the channel
  const int slot = g < group ? g : group - 1;  // threads past the group idle
  const size_t row0 = static_cast<size_t>(batch) * seq;

  for (int c0 = 0; c0 < d_block; c0 += group) {
    const int width = min(group, d_block - c0);
    const bool active = g < width;
    const int ch = d0 + c0 + slot;
    float a[kMaxPerLane];
    float h[kMaxPerLane];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int n = lane + i * lanes;
      a[i] = (active && n < n_state)
                 ? a_log_neg[static_cast<size_t>(ch) * n_state + n]
                 : 0.0f;
      h[i] = 0.0f;
    }
    const float dsk = active ? d_skip[ch] : 0.0f;

    for (int t0 = 0; t0 < seq; t0 += chunk) {
      __syncthreads();  // the previous chunk's staging is consumed
      for (int e = threadIdx.x; e < chunk * width; e += blockDim.x) {
        const int tt = e / width;
        const int cc = e - tt * width;
        const size_t gi = (row0 + t0 + tt) * dim + d0 + c0 + cc;
        xs[tt * group + cc] = x[gi];
        dts[tt * group + cc] = dt[gi];
      }
      for (int e = threadIdx.x; e < chunk * n_state; e += blockDim.x) {
        const size_t gi = (row0 + t0) * n_state + e;
        bs[e] = b[gi];
        cs[e] = c[gi];
      }
      __syncthreads();
      for (int tt = 0; tt < chunk; ++tt) {
        const float xt = xs[tt * group + slot];
        const float dtt = dts[tt * group + slot];
        const float u = dtt * xt;
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) {
          const int n = lane + i * lanes;
          if (n < n_state) {
            const float decay = expf(dtt * a[i]);
            h[i] = decay * h[i] + u * bs[tt * n_state + n];
            part += h[i] * cs[tt * n_state + n];
          }
        }
        for (int o = lanes / 2; o > 0; o >>= 1) {
          part += __shfl_xor_sync(kFullMask, part, o);
        }
        if (lane == 0 && active) ys[tt * group + g] = part + dsk * xt;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < chunk * width; e += blockDim.x) {
        const int tt = e / width;
        const int cc = e - tt * width;
        y[(row0 + t0 + tt) * dim + d0 + c0 + cc] = ys[tt * group + cc];
      }
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  `lanes` (a power
// of two, <= 32, with N <= 4 * lanes) and `group` come from the wrapper,
// which computes them as smem_bytes does.
extern "C" int mamba_scan_launch(const void* x, const void* dt,
                                 const void* b, const void* c,
                                 const void* a_log_neg, const void* d_skip,
                                 void* y, int batch, int seq, int dim,
                                 int n_state, int chunk, int d_block,
                                 int lanes, int group, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      n_state > kMaxPerLane * lanes || group < 1 ||
      group * lanes > kMaxThreads) {
    return cudaErrorInvalidValue;
  }
  const size_t smem =
      sizeof(float) * (3 * static_cast<size_t>(chunk) * group +
                       2 * static_cast<size_t>(chunk) * n_state);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // whole warps, so every shuffle sees all 32 lanes; threads past
  // group * lanes idle
  const int threads = (group * lanes + 31) / 32 * 32;
  const dim3 grid(dim / d_block, batch);
  mamba_scan_kernel<<<grid, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(a_log_neg),
      static_cast<const float*>(d_skip), static_cast<float*>(y), seq, dim,
      n_state, chunk, d_block, lanes, group);
  return cudaGetLastError();
}
