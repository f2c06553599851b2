// The Mamba-1 selective scan of the model path, forward and backward, for
// Hopper (sm_90a): one autograd op (kernels/selective_scan_train.py).
//
//     delta_t = softplus(delta_raw_t + delta_bias)
//     h_t     = exp(delta_t (x) A) * h_{t-1} + (delta_t u_t) (x) B_t
//     y_t     = (<h_t, C_t> + D u_t) * silu(z_t)
//
// u, delta_raw, z, y (batch, L, D) bfloat16; B, C (batch, L, N) bfloat16
// or float32; A (D, N), D and delta_bias (D,) float32; the state h float32.
// Every (batch, L, ...) operand is read in place through its strides (z and
// B, C are views of the model's in_proj and x_proj outputs).  N is 16
// (falcon-mamba-7b) or 8 (its smoke size), one instantiation each.
//
// Replaces no TPU kernel.  The JAX package's model layers run this scan as
// jnp (src/repro/models/ssm.py: lax.associative_scan over chunks), which
// XLA fuses on the TPU; its Pallas kernel (kernels/mamba_scan.py, ported as
// csrc/mamba_scan.cu) is the DSE bridge's, forward only, float32, Delta
// already activated and no gate.  The port's twin of the jnp scan
// (repro_torch/models/ssm.py) builds the scan's a and b as (batch, L, D, N)
// float32 tensors (8.6 GB each at falcon-mamba-7b training, 4 x 4096
// tokens) and keeps every chunk's log-step transients for autograd: a
// layer's backward alone would need over 100 GB.  Here no (batch, L, D, N)
// tensor exists: the state lives in registers.
//
// What bounds it on the H100 (falcon-mamba-7b, 4 x 4096 tokens, D 8192,
// N 16): bytes and exponentials, not the tensor cores.  A forward reads
// u, delta, z and writes y, 1.07 GB of bfloat16 (0.32 ms at 3.35 TB/s);
// a backward reads u, delta, z, dy and writes du, ddelta, dz, 1.88 GB
// (0.56 ms).  The forward takes B*L*D*N = 2.15e9 exponentials, 0.58 ms at
// the SFU's 16 ex2 a clock an SM (132 SMs, 1.755 GHz); the backward twice
// that (the states are recomputed, and each step's decay again in reverse).
// The decays run on the SFU's ex2.approx directly.
//
// Design (correct and simple first):
//   * a CTA owns 64 channels of one sequence, 4 threads a channel, each
//     thread N/4 of the channel's states in registers (mamba_scan.cu's
//     plan at states 4, lanes 4); <h, C> is N/4 FMAs and two shuffles.
//   * the sequence runs in chunks of kChunk = 16 positions.  A chunk's u,
//     Delta (softplus applied while staging), B and C are staged in shared
//     memory by coalesced loads, then the chunk's steps run in order; y is
//     staged and stored coalesced.  Positions past L are staged as Delta =
//     u = 0 (a step that keeps the state) and never stored: L may be ragged
//     against the chunk, and D against the 64 channels.
//   * the forward writes the state at each chunk's end, (batch, D,
//     ceil(L / 16), N) float32, when a backward will follow.
//   * the backward walks the chunks in reverse, one CTA per (64 channels,
//     sequence) as the forward.  In each chunk it recomputes the 16 states
//     from the saved state before it (the same arithmetic as the forward,
//     so the same values), keeping them in registers (16 x N/4 a thread),
//     then runs the adjoint recurrence lambda_t = q_t C_t + a_{t+1}
//     lambda_{t+1} (q_t = dy_t silu(z_t)) backwards through them.  du,
//     ddelta (through the softplus) and dz are staged and stored
//     coalesced.  dB and dC, sums over the D channels, are summed over a
//     warp's 8 channels by a reduce-scatter butterfly of shuffles (7 a
//     step for a thread's 8 values) and over the CTA's 8 warps in shared
//     memory, in fixed order, into one partial a CTA; dA, dD and
//     ddelta_bias, sums over batch and positions, are summed over the
//     positions in registers into one partial a sequence.
//     selective_scan_reduce_kernel then sums the partials in fixed order.
//     No atomics: two backwards on the same operands give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                    // threads a channel
constexpr int kChannels = 64;                // channels a CTA
constexpr int kThreads = kLanes * kChannels;  // 256
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                   // positions a chunk
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDefaultSmem = 48 * 1024;

using bf16 = __nv_bfloat16;

// Element strides of a (batch, L, last) operand.
struct Strides {
  long long b, l, e;
};

struct Args {
  const bf16* u;
  const bf16* delta;
  const bf16* z;
  const void* B;
  const void* C;
  const float* A;
  const float* Dskip;
  const float* bias;
  const bf16* dy;
  bf16* y;
  float* hsave;       // (batch, D, nchunks, N): the state at each chunk's end
  bf16* du;
  bf16* ddelta;
  bf16* dz;
  float* part_bc;     // (D blocks, 2, batch, L, N): dB and dC a CTA
  float* part_a;      // (batch, D, N)
  float* part_d;      // (batch, D)
  float* part_bias;   // (batch, D)
  float* dbc;         // (2, batch, L, N)
  float* dA;          // (D, N)
  float* dD;          // (D,)
  float* dbias;       // (D,)
  Strides su, sdelta, sz, sB, sC, sdy;
  int batch, L, D, nchunks, bc_f32;
};

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float load_bc(const void* p, bool f32,
                                         long long i) {
  return f32 ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// torch.nn.functional.softplus (beta 1, threshold 20) and its derivative
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

__device__ __forceinline__ float softplus_grad(float x) {
  if (x > 20.f) return 1.f;
  const float e = expf(x);
  return e / (e + 1.f);
}

// 2^x by the SFU's ex2.approx (relative error under 2^-22; results below
// 2^-126 flush to 0, a decay that has forgotten the state anyway)
__device__ __forceinline__ float exp2_approx(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
#endif
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// A chunk's u, Delta (and, for the backward, softplus' derivative) of the
// CTA's channels, and its B and C, into shared memory; zeros past L and D.
template <int N>
__device__ __forceinline__ void stage(const Args& a, int b, int d0, int t0,
                                      float (*s_u)[kChannels],
                                      float (*s_dt)[kChannels],
                                      float (*s_sp)[kChannels],
                                      float (*s_B)[N], float (*s_C)[N]) {
  for (int e = threadIdx.x; e < kChunk * kChannels; e += kThreads) {
    const int j = e / kChannels, c = e % kChannels;
    const int t = t0 + j, d = d0 + c;
    float u = 0.f, dt = 0.f, sp = 0.f;
    if (t < a.L && d < a.D) {
      u = to_f(a.u[b * a.su.b + t * a.su.l + d * a.su.e]);
      const float x =
          to_f(a.delta[b * a.sdelta.b + t * a.sdelta.l + d * a.sdelta.e]) +
          a.bias[d];
      dt = softplus(x);
      if (s_sp != nullptr) sp = softplus_grad(x);
    }
    s_u[j][c] = u;
    s_dt[j][c] = dt;
    if (s_sp != nullptr) s_sp[j][c] = sp;
  }
  const bool f32 = a.bc_f32 != 0;
  for (int e = threadIdx.x; e < kChunk * N; e += kThreads) {
    const int j = e / N, n = e % N;
    const int t = t0 + j;
    float bv = 0.f, cv = 0.f;
    if (t < a.L) {
      bv = load_bc(a.B, f32, b * a.sB.b + t * a.sB.l + n * a.sB.e);
      cv = load_bc(a.C, f32, b * a.sC.b + t * a.sC.l + n * a.sC.e);
    }
    s_B[j][n] = bv;
    s_C[j][n] = cv;
  }
}

// One step of the recurrence for a thread's S states: the forward and the
// backward's recompute run exactly this, so they agree to the bit.
template <int S>
__device__ __forceinline__ float step(float (&h)[S], const float (&A2)[S],
                                      float dt, float du, const float* Bt,
                                      const float* Ct) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    h[k] = fmaf(exp2_approx(dt * A2[k]), h[k], du * Bt[k]);
    acc = fmaf(h[k], Ct[k], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// dB and dC of a thread's S states summed over the warp's 8 channels by a
// reduce-scatter butterfly: at each of lane bits 4, 3, 2 a thread keeps
// half of its values and adds the other half of its partner's (2S - 1
// shuffles in all for 2S values, against 6S for a full reduction of
// each).  Returns the sum a thread ends with, and in `idx` its index among
// the 2S values (dB's S, then dC's); at S = 2 lanes 4 apart end with the
// same sum (bit 2 has no half left to split).
template <int S>
__device__ __forceinline__ float channel_sum(const float (&dB)[S],
                                             const float (&dC)[S], int& idx) {
  float v[2 * S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    v[k] = dB[k];
    v[S + k] = dC[k];
  }
  const int lane = threadIdx.x % 32;
  idx = 0;
  int cur = 2 * S;
#pragma unroll
  for (int off = 16; off >= kLanes; off /= 2) {
    if (cur > 1) {
      const int half = cur / 2;
      const bool hi = (lane & off) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = hi ? v[i] : v[i + half];
        const float keep = hi ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      if (hi) idx += half;
      cur = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
  return v[0];
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_fwd_kernel(Args a) {
  constexpr int S = N / kLanes;
  __shared__ float s_u[kChunk][kChannels];
  __shared__ float s_dt[kChunk][kChannels];
  __shared__ float s_y[kChunk][kChannels];
  __shared__ __align__(16) float s_B[kChunk][N];
  __shared__ __align__(16) float s_C[kChunk][N];

  const int b = blockIdx.y, d0 = blockIdx.x * kChannels;
  const int ch = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int d = d0 + ch, n0 = lane * S;
  float A2[S], h[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    A2[k] = d < a.D ? a.A[static_cast<long long>(d) * N + n0 + k] * kLog2e
                    : 0.f;
    h[k] = 0.f;
  }

  for (int c = 0; c < a.nchunks; ++c) {
    const int t0 = c * kChunk;
    __syncthreads();  // the last chunk's shared memory has been read
    stage<N>(a, b, d0, t0, s_u, s_dt, nullptr, s_B, s_C);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float dt = s_dt[j][ch];
      const float acc = step<S>(h, A2, dt, dt * s_u[j][ch], &s_B[j][n0],
                                &s_C[j][n0]);
      if (lane == 0) s_y[j][ch] = acc;
    }
    if (a.hsave != nullptr && d < a.D) {
      float* dst =
          a.hsave + ((static_cast<long long>(b) * a.D + d) * a.nchunks + c) *
                        N + n0;
#pragma unroll
      for (int k = 0; k < S; ++k) dst[k] = h[k];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kChunk * kChannels; e += kThreads) {
      const int j = e / kChannels, cc = e % kChannels;
      const int t = t0 + j, dd = d0 + cc;
      if (t < a.L && dd < a.D) {
        const float zv = to_f(a.z[b * a.sz.b + t * a.sz.l + dd * a.sz.e]);
        const float y = (s_y[j][cc] + a.Dskip[dd] * s_u[j][cc]) * zv *
                        sigmoid(zv);
        a.y[(static_cast<long long>(b) * a.L + t) * a.D + dd] =
            __float2bfloat16(y);
      }
    }
  }
}

// The backward's shared memory, carved from the dynamic buffer.
template <int N>
struct BwdSmem {
  float u[kChunk][kChannels];
  float dt[kChunk][kChannels];
  float sp[kChunk][kChannels];   // softplus' derivative
  float q[kChunk][kChannels];    // dy * silu(z)
  float g[kChunk][kChannels];    // dy * silu'(z), then dz
  float du[kChunk][kChannels];
  float ddt[kChunk][kChannels];
  float B[kChunk][N];
  float C[kChunk][N];
  float dB[kWarps][kChunk][N];
  float dC[kWarps][kChunk][N];
};

template <int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_bwd_kernel(Args a) {
  constexpr int S = N / kLanes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<N>& sm = *reinterpret_cast<BwdSmem<N>*>(smem_raw);

  const int b = blockIdx.y, d0 = blockIdx.x * kChannels;
  const int ch = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / 32;
  const int d = d0 + ch, n0 = lane * S;
  const bool live = d < a.D;
  float A[S], A2[S], carry[S], dA[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    A[k] = live ? a.A[static_cast<long long>(d) * N + n0 + k] : 0.f;
    A2[k] = A[k] * kLog2e;
    carry[k] = 0.f;  // a_{t+1} lambda_{t+1}, none after the last position
    dA[k] = 0.f;
  }
  const float Dd = live ? a.Dskip[d] : 0.f;
  float dD = 0.f, dbias = 0.f;

  for (int c = a.nchunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    __syncthreads();
    stage<N>(a, b, d0, t0, sm.u, sm.dt, sm.sp, sm.B, sm.C);
    for (int e = threadIdx.x; e < kChunk * kChannels; e += kThreads) {
      const int j = e / kChannels, cc = e % kChannels;
      const int t = t0 + j, dd = d0 + cc;
      float q = 0.f, g = 0.f;
      if (t < a.L && dd < a.D) {
        const float zv = to_f(a.z[b * a.sz.b + t * a.sz.l + dd * a.sz.e]);
        const float dy =
            to_f(a.dy[b * a.sdy.b + t * a.sdy.l + dd * a.sdy.e]);
        const float sg = sigmoid(zv);
        q = dy * zv * sg;
        g = dy * sg * (1.f + zv * (1.f - sg));
      }
      sm.q[j][cc] = q;
      sm.g[j][cc] = g;
    }
    __syncthreads();

    // the chunk's states from the state before it, as the forward ran them
    float h0[S], hist[kChunk][S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      h0[k] = (c > 0 && live)
                  ? a.hsave[((static_cast<long long>(b) * a.D + d) *
                                 a.nchunks + c - 1) * N + n0 + k]
                  : 0.f;
    }
    {
      float h[S];
#pragma unroll
      for (int k = 0; k < S; ++k) h[k] = h0[k];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float dt = sm.dt[j][ch];
        const float acc = step<S>(h, A2, dt, dt * sm.u[j][ch], &sm.B[j][n0],
                                  &sm.C[j][n0]);
#pragma unroll
        for (int k = 0; k < S; ++k) hist[j][k] = h[k];
        if (lane == 0) sm.g[j][ch] *= acc + Dd * sm.u[j][ch];  // dz
      }
    }

    // the adjoint recurrence, backwards through the chunk
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const float dt = sm.dt[j][ch], u = sm.u[j][ch], q = sm.q[j][ch];
      float ddt = 0.f, du = 0.f, dB[S], dC[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const float Bk = sm.B[j][n0 + k], Ck = sm.C[j][n0 + k];
        const float lam = fmaf(q, Ck, carry[k]);
        const float hprev = j > 0 ? hist[j - 1][k] : h0[k];
        const float decay = exp2_approx(dt * A2[k]);
        const float x = lam * hprev * decay;  // d loss / d log(decay)
        dA[k] = fmaf(x, dt, dA[k]);
        ddt = fmaf(x, A[k], fmaf(lam * u, Bk, ddt));
        du = fmaf(lam * dt, Bk, du);
        dB[k] = lam * dt * u;
        dC[k] = q * hist[j][k];
        carry[k] = decay * lam;
      }
      ddt += __shfl_xor_sync(0xffffffffu, ddt, 1);
      ddt += __shfl_xor_sync(0xffffffffu, ddt, 2);
      du += __shfl_xor_sync(0xffffffffu, du, 1);
      du += __shfl_xor_sync(0xffffffffu, du, 2);
      if (lane == 0) {
        const float draw = ddt * sm.sp[j][ch];
        sm.ddt[j][ch] = draw;
        sm.du[j][ch] = fmaf(q, Dd, du);
        dD = fmaf(q, u, dD);
        dbias += draw;
      }
      // over the warp's 8 channels (lanes 4 apart hold the same states)
      int idx;
      const float sum = channel_sum<S>(dB, dC, idx);
      if (2 * S >= 8 || threadIdx.x % 8 < kLanes) {
        float(*dst)[kChunk][N] = idx < S ? sm.dB : sm.dC;
        dst[warp][j][n0 + idx % S] = sum;
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kChunk * kChannels; e += kThreads) {
      const int j = e / kChannels, cc = e % kChannels;
      const int t = t0 + j, dd = d0 + cc;
      if (t < a.L && dd < a.D) {
        const long long o = (static_cast<long long>(b) * a.L + t) * a.D + dd;
        a.du[o] = __float2bfloat16(sm.du[j][cc]);
        a.ddelta[o] = __float2bfloat16(sm.ddt[j][cc]);
        a.dz[o] = __float2bfloat16(sm.g[j][cc]);
      }
    }
    // the CTA's dB and dC: its 8 warps in order
    const long long plane = static_cast<long long>(a.batch) * a.L * N;
    for (int e = threadIdx.x; e < kChunk * N; e += kThreads) {
      const int j = e / N, n = e % N;
      const int t = t0 + j;
      if (t >= a.L) continue;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb += sm.dB[w][j][n];
        sc += sm.dC[w][j][n];
      }
      float* p = a.part_bc + 2 * plane * blockIdx.x +
                 (static_cast<long long>(b) * a.L + t) * N + n;
      p[0] = sb;
      p[plane] = sc;
    }
  }

  if (live) {
    const long long bd = static_cast<long long>(b) * a.D + d;
#pragma unroll
    for (int k = 0; k < S; ++k) a.part_a[bd * N + n0 + k] = dA[k];
    if (lane == 0) {
      a.part_d[bd] = dD;
      a.part_bias[bd] = dbias;
    }
  }
}

// dB and dC summed over the CTAs' partials, dA, dD and ddelta_bias over
// the sequences', each in a fixed order.
template <int N>
__global__ void selective_scan_reduce_kernel(Args a, int blocks) {
  const long long plane = static_cast<long long>(a.batch) * a.L * N;
  const long long n_bc = 2 * plane, n_a = static_cast<long long>(a.D) * N;
  const long long total = n_bc + n_a + 2ll * a.D;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    if (i < n_bc) {
      for (int k = 0; k < blocks; ++k) s += a.part_bc[k * n_bc + i];
      a.dbc[i] = s;
    } else if (i < n_bc + n_a) {
      const long long r = i - n_bc;
      for (int k = 0; k < a.batch; ++k) s += a.part_a[k * n_a + r];
      a.dA[r] = s;
    } else {
      const long long r = i - n_bc - n_a;
      const bool is_d = r < a.D;
      const float* src = is_d ? a.part_d : a.part_bias;
      const long long col = is_d ? r : r - a.D;
      for (int k = 0; k < a.batch; ++k) s += src[k * a.D + col];
      (is_d ? a.dD : a.dbias)[col] = s;
    }
  }
}

size_t bwd_smem(int n) {
  return n == 16 ? sizeof(BwdSmem<16>) : sizeof(BwdSmem<8>);
}

template <int N>
cudaError_t forward(const Args& a, cudaStream_t s) {
  const dim3 grid((a.D + kChannels - 1) / kChannels, a.batch);
  selective_scan_fwd_kernel<N><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t backward(const Args& a, cudaStream_t s) {
  const int blocks = (a.D + kChannels - 1) / kChannels;
  const int smem = static_cast<int>(sizeof(BwdSmem<N>));
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        selective_scan_bwd_kernel<N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  selective_scan_bwd_kernel<N><<<dim3(blocks, a.batch), kThreads, smem, s>>>(
      a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  selective_scan_reduce_kernel<N><<<1024, 256, 0, s>>>(a, blocks);
  return cudaGetLastError();
}

// The shape checks both entries share; fills the shape and stride fields.
bool check(Args& a, int batch, int L, int D, int N, int bc_f32,
           const long long* st) {
  if (batch < 1 || batch > 65535 || L < 1 || D < 1 || (N != 8 && N != 16)) {
    return false;
  }
  a.batch = batch;
  a.L = L;
  a.D = D;
  a.nchunks = (L + kChunk - 1) / kChunk;
  a.bc_f32 = bc_f32;
  a.su = {st[0], st[1], st[2]};
  a.sdelta = {st[3], st[4], st[5]};
  a.sz = {st[6], st[7], st[8]};
  a.sB = {st[9], st[10], st[11]};
  a.sC = {st[12], st[13], st[14]};
  a.sdy = {st[15], st[16], st[17]};
  return true;
}

}  // namespace

// The number of partial sums of dB and dC the backward writes, (blocks, 2,
// batch, L, N) float32: one a CTA of 64 channels.
extern "C" int selective_scan_blocks(int D) {
  return (D + kChannels - 1) / kChannels;
}

// Bytes of dynamic shared memory the backward asks for at N states.
extern "C" int selective_scan_bwd_smem(int n) {
  return static_cast<int>(bwd_smem(n));
}

// y (batch, L, D) bfloat16 contiguous, and, when hsave is not null, the
// state at each chunk's end, (batch, D, ceil(L / 16), N) float32.
// strides: 18 element strides (batch, position, last) of u, delta, z, B,
// C and (unused here) dy.  Returns the launch's cudaError_t (0 on
// success), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int selective_scan_forward(
    const void* u, const void* delta, const void* z, const void* B,
    const void* C, const void* A, const void* Dskip, const void* bias,
    void* y, void* hsave, int batch, int L, int D, int N, int bc_f32,
    const long long* strides, void* stream) {
  Args a{};
  if (!check(a, batch, L, D, N, bc_f32, strides)) {
    return cudaErrorInvalidValue;
  }
  a.u = static_cast<const bf16*>(u);
  a.delta = static_cast<const bf16*>(delta);
  a.z = static_cast<const bf16*>(z);
  a.B = B;
  a.C = C;
  a.A = static_cast<const float*>(A);
  a.Dskip = static_cast<const float*>(Dskip);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<bf16*>(y);
  a.hsave = static_cast<float*>(hsave);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return N == 16 ? forward<16>(a, s) : forward<8>(a, s);
}

// The gradients of selective_scan_forward's y from dy: du, ddelta, dz
// (batch, L, D) bfloat16 contiguous; dbc (2, batch, L, N) float32 (dB,
// dC); dA (D, N), dD and dbias (D,) float32.  hsave as the forward wrote
// it; part_bc (selective_scan_blocks(D), 2, batch, L, N), part_a (batch,
// D, N), part_d and part_bias (batch, D) float32 are scratch.
extern "C" int selective_scan_backward(
    const void* u, const void* delta, const void* z, const void* B,
    const void* C, const void* A, const void* Dskip, const void* bias,
    const void* hsave, const void* dy, void* du, void* ddelta, void* dz,
    void* part_bc, void* part_a, void* part_d, void* part_bias, void* dbc,
    void* dA, void* dD, void* dbias, int batch, int L, int D, int N,
    int bc_f32, const long long* strides, void* stream) {
  Args a{};
  if (!check(a, batch, L, D, N, bc_f32, strides) || hsave == nullptr) {
    return cudaErrorInvalidValue;
  }
  a.u = static_cast<const bf16*>(u);
  a.delta = static_cast<const bf16*>(delta);
  a.z = static_cast<const bf16*>(z);
  a.B = B;
  a.C = C;
  a.A = static_cast<const float*>(A);
  a.Dskip = static_cast<const float*>(Dskip);
  a.bias = static_cast<const float*>(bias);
  a.hsave = const_cast<float*>(static_cast<const float*>(hsave));
  a.dy = static_cast<const bf16*>(dy);
  a.du = static_cast<bf16*>(du);
  a.ddelta = static_cast<bf16*>(ddelta);
  a.dz = static_cast<bf16*>(dz);
  a.part_bc = static_cast<float*>(part_bc);
  a.part_a = static_cast<float*>(part_a);
  a.part_d = static_cast<float*>(part_d);
  a.part_bias = static_cast<float*>(part_bias);
  a.dbc = static_cast<float*>(dbc);
  a.dA = static_cast<float*>(dA);
  a.dD = static_cast<float*>(dD);
  a.dbias = static_cast<float*>(dbias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return N == 16 ? backward<16>(a, s) : backward<8>(a, s);
}
