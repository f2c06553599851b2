// Chunked selective scan (the Mamba-1 recurrence), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py::
// mamba_scan (body _scan_kernel):
//
//     h_t = exp(dt_t (x) A) * h_{t-1} + (dt_t * x_t) (x) B_t
//     y_t = <h_t, C_t> + D * x_t
//
// x, dt, y (B,L,D); b, c (B,L,N); A = a_log_neg (D,N); D = d_skip (D,).
// float32 only, with the state h in float32; N <= 128.  chunk | L and
// d_block | D may be any divisors (d_block may be all of D).  No
// fast-math: the decay is exp2f(dt * a2) with a2 = A * log2(e) rounded
// once per state, and the oracle holds the result at 2e-4 over thousands
// of steps.
//
// Order.  The TPU grid runs (batch, d-block) in parallel and the chunks in
// order, carrying h in VMEM scratch.  Here one grid unit owns one
// (batch, d-block) and runs its chunks in order; h stays in registers for
// the whole sequence.  A unit is one CTA, or up to 8 CTAs that split the
// d-block when it is wider than one CTA may stage (below).
//
// What bounds it on the H100, at falcon-mamba-7b (B 1, L 4096, D 8192,
// N 16):
//   * bytes: x, dt and y (3 x 128 MB) and b, c, A, D (~1 MB), about
//     0.12 ms at 3.35 TB/s.  This is the bound chip_smoke.py reports;
//   * exponentials: B*L*D*N = 537 M, one a state update.  At the SFU's 16
//     ex2 a clock an SM that is 0.128-0.145 ms on 132 SMs (1.98-1.75 GHz),
//     about the byte bound.  A design target, not the card's floor: an
//     exponential can also run on the FMA pipes;
//   * instruction issue: a state update needs the exponent product, the
//     ex2 and its range handling, u*b, the h FMA and the <h, C> FMA.  Work
//     per channel (x, dt, u, the shuffle tree, the store of y) has to be
//     shared by several states, or it costs as much as the update;
//   * not the dependence: h_t = fma(decay_t, h_{t-1}, u_t b_t) is one FFMA
//     chain a state, ~4 cycles a step, 16 K cycles over L = 4096.
// What the design does about it:
//   * a thread owns `states` (S in 1, 2, 4, 8, 16) of one channel's N
//     states, a channel spreads over `lanes` = N/S threads (N rounded up
//     to a power of two), and <h, C> is S in-register FMAs plus log2(lanes)
//     shuffles.  The kernel is a template on (S, lanes, N == S * lanes), so
//     the state loop has no runtime guard where N is a power of two, and b
//     and c of S >= 4 states arrive as float4 reads of shared memory;
//   * the step loop walks pointers (no index arithmetic a step), stores y
//     under a predicate (no branch between steps) and is unrolled by 4
//     with a remainder, so the exponentials and loads of neighbouring
//     steps overlap the FFMA chain (chip_smoke.py counts the loop's SASS
//     instructions at S = 4);
//   * a d-block of more channels than one CTA may stage (channel_group,
//     64 at N = 16) is split over up to 8 CTAs (grid x = (D/d_block) *
//     split); each takes d_block / split channels in passes and stages its
//     own b and c.  Channels are independent, so the CTAs share nothing and
//     launch as plain CTAs: a thread-block cluster of the same CTAs was
//     timed on an H100 at every wide falcon-mamba-7b block and was never
//     faster (PERF.md);
//   * the next chunk is staged while the current one runs: in registers
//     where a thread's share is one vector an operand (small tiles, where
//     the formula leaves no room for a second buffer); else by cp.async
//     into each half of the one buffer while the other half runs (two
//     barriers a chunk); a chunk of one step too wide for registers is
//     copied, then run.  Copies walk the tile without a division per
//     element; 16-byte copies only where the plan proves alignment;
//   * y is stored straight from the lane that finishes the channel's sum
//     (consecutive channels, consecutive addresses), so y takes no shared
//     memory.
//
// Every launch requests at most smem_bytes(chunk, d_block, N, 4) =
//   4*(3*chunk*group + 2*chunk*N),  group = channel_group(d_block, N)
// bytes of dynamic shared memory (kernels/mamba_scan.py keeps the formula
// and the launch plan, scan_plan; this file checks the plan and refuses a
// bad one with cudaErrorInvalidValue).  The buffer holds the chunk's b and
// c, then x and dt of the channels of one pass: 4*chunk*(2*N + 2*channels)
// bytes, within the formula because channels <= group.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxState = 128;
constexpr int kMaxSplit = 8;
constexpr int kSmemLimit = 232448;
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
enum Stage { kSync = 0, kRegisters = 1, kHalves = 2 };

struct Args {
  const float* x;
  const float* dt;
  const float* b;
  const float* c;
  const float* a;
  const float* dsk;
  float* y;
  int seq, dim, n, chunk, d_block, channels, split, passes, stage;
  int vec_x, vec_bc;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A thread's vectors of a tile with per_row vectors a row: vector
// threadIdx.x + k * blockDim.x.  The two divisions happen once a pass;
// each step then adds (dr, dc) and wraps the column at most once.
struct Walk {
  int r, c, dr, dc, per_row;
};

__device__ __forceinline__ Walk make_walk(int per_row) {
  return {static_cast<int>(threadIdx.x) / per_row,
          static_cast<int>(threadIdx.x) % per_row,
          static_cast<int>(blockDim.x) / per_row,
          static_cast<int>(blockDim.x) % per_row, per_row};
}

__device__ __forceinline__ void advance(const Walk& w, int& r, int& c) {
  c += w.dc;
  r += w.dr;
  if (c >= w.per_row) {
    c -= w.per_row;
    ++r;
  }
}

// x and dt rows of one chunk (rows of ld_g floats in device memory) into
// rows of ld_s floats, V floats a copy; b and c (contiguous) likewise.
template <int V>
__device__ __forceinline__ void copy_walk(float* xs, float* dts,
                                          const float* xg, const float* dtg,
                                          int ld_s, int ld_g, int rows,
                                          Walk w) {
  for (int r = w.r, c = w.c; r < rows; advance(w, r, c)) {
    const size_t gi = static_cast<size_t>(r) * ld_g + c * V;
    const int si = r * ld_s + c * V;
    cp_async<V>(xs + si, xg + gi);
    cp_async<V>(dts + si, dtg + gi);
  }
}

template <int V>
__device__ __forceinline__ void copy_flat(float* bs, float* cs,
                                          const float* bg, const float* cg,
                                          int vectors) {
  for (int e = threadIdx.x; e < vectors; e += blockDim.x) {
    cp_async<V>(bs + e * V, bg + e * V);
    cp_async<V>(cs + e * V, cg + e * V);
  }
}

__device__ __forceinline__ float4 load(const float* p, int v) {
  if (v == 4) return *reinterpret_cast<const float4*>(p);
  return make_float4(*p, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void store(float* p, float4 q, int v) {
  if (v == 4) {
    *reinterpret_cast<float4*>(p) = q;
  } else {
    *p = q.x;
  }
}

// The S values of a thread's states in one row of b or c (p 16-byte
// aligned for S >= 4, 8-byte for S == 2, when exact); past N they are 0.
template <int S, bool kExact>
__device__ __forceinline__ void load_states(float (&v)[S], const float* p,
                                            int valid) {
  if constexpr (kExact && S >= 4) {
#pragma unroll
    for (int i = 0; i < S; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else if constexpr (kExact && S == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i) v[i] = (kExact || i < valid) ? p[i] : 0.0f;
  }
}

// Rows [0, rows) of a staged chunk.  xs/dts: the channel's x and dt in
// the first row (rows `channels` floats apart); bs/cs: the thread's first
// state in the first b and c rows; yp: y at the first row's step.
template <int S, int P, bool kExact>
__device__ __forceinline__ void run_rows(float (&h)[S], const float (&a2)[S],
                                         const float* xs, const float* dts,
                                         const float* bs, const float* cs,
                                         int channels, int n, int valid,
                                         int rows, float dsk, bool writer,
                                         float* yp, int dim) {
  const int ld = kExact ? S * P : n;  // a compile-time stride when exact
#pragma unroll 4
  for (int tt = 0; tt < rows; ++tt) {
    const float xt = *xs;
    const float dtt = *dts;
    const float u = dtt * xt;
    float bv[S];
    float cv[S];
    load_states<S, kExact>(bv, bs, valid);
    load_states<S, kExact>(cv, cs, valid);
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (kExact || i < valid) {
        h[i] = fmaf(exp2f(dtt * a2[i]), h[i], u * bv[i]);
        part = fmaf(h[i], cv[i], part);
      }
    }
#pragma unroll
    for (int o = P / 2; o > 0; o >>= 1) {
      part += __shfl_xor_sync(kFullMask, part, o);
    }
    if (writer) *yp = fmaf(dsk, xt, part);
    xs += channels;
    dts += channels;
    bs += ld;
    cs += ld;
    yp += dim;
  }
}

// The compiler is told to expect one CTA an SM: then it keeps the unrolled
// steps' values apart in registers, where with the thread bound alone it
// packed them into fewer and the steps ran one after another (slower on an
// H100 at falcon-mamba-7b).
template <int S, int P, bool kExact>
__global__ void __launch_bounds__(kMaxThreads, 1) scan_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int unit = blockIdx.x / p.split;  // the d-block
  const int rank = blockIdx.x - unit * p.split;
  const int share = p.d_block / p.split;  // this CTA's channels
  const int cta0 = unit * p.d_block + rank * share;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * p.seq;
  const int g = tid / P;  // channel slot in the pass
  const int lane = tid % P;
  const int first = lane * S;  // the thread's first state
  const int valid = p.n - first;
  const int chunk = p.chunk, n = p.n, dim = p.dim, channels = p.channels;
  const int vx = p.vec_x, vb = p.vec_bc;
  // the staged chunk: b, c (chunk x n each), then x, dt (chunk x channels)
  float* const bs = smem;
  float* const cs = bs + chunk * n;
  float* const xs = cs + chunk * n;
  float* const dts = xs + chunk * channels;
  const int half = p.stage == kHalves ? chunk / 2 : chunk;

  for (int pass = 0; pass < p.passes; ++pass) {
    const int c0 = cta0 + pass * channels;
    const int width = min(channels, share - pass * channels);
    const bool active = g < width;
    const int slot = active ? g : width - 1;  // idle threads shadow a channel
    const int ch = c0 + slot;
    float a2[S];
    float h[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      a2[i] = (kExact || i < valid)
                  ? p.a[static_cast<size_t>(ch) * n + first + i] * kLog2e
                  : 0.0f;
      h[i] = 0.0f;
    }
    const float dsk = p.dsk[ch];
    const bool writer = lane == 0 && active;
    const Walk w = make_walk(width / vx);

    // rows [r0, r1) of the chunk at step t0 into the buffer, by cp.async
    auto copy_rows = [&](int t0, int r0, int r1) {
      const size_t xo = (row0 + t0 + r0) * dim + c0;
      const size_t bo = (row0 + t0 + r0) * n;
      const int xr = r0 * channels, br = r0 * n;
      if (vx == 4) {
        copy_walk<4>(xs + xr, dts + xr, p.x + xo, p.dt + xo, channels, dim,
                     r1 - r0, w);
      } else {
        copy_walk<1>(xs + xr, dts + xr, p.x + xo, p.dt + xo, channels, dim,
                     r1 - r0, w);
      }
      if (vb == 4) {
        copy_flat<4>(bs + br, cs + br, p.b + bo, p.c + bo, (r1 - r0) * n / 4);
      } else {
        copy_flat<1>(bs + br, cs + br, p.b + bo, p.c + bo, (r1 - r0) * n);
      }
      cp_async_commit();
    };
    auto run = [&](int t0, int r0, int r1) {
      run_rows<S, P, kExact>(
          h, a2, xs + r0 * channels + slot, dts + r0 * channels + slot,
          bs + r0 * n + first, cs + r0 * n + first, channels, n, valid,
          r1 - r0, dsk, writer, p.y + (row0 + t0 + r0) * dim + ch, dim);
    };

    // register staging: the thread's one vector of x/dt (device and shared
    // offsets from the walk, once a pass; -1 past the tile) and of b/c
    const int gx = w.r < chunk ? w.r * dim + w.c * vx : 0;
    const int sx = w.r < chunk ? w.r * channels + w.c * vx : -1;
    const bool has_bc = tid < chunk * n / vb;
    float4 rx, rd, rb, rc;
    auto load_ahead = [&](int t0) {
      const size_t xo = (row0 + t0) * dim + c0;
      const size_t bo = (row0 + t0) * n;
      if (sx >= 0) {
        rx = load(p.x + xo + gx, vx);
        rd = load(p.dt + xo + gx, vx);
      }
      if (has_bc) {
        rb = load(p.b + bo + tid * vb, vb);
        rc = load(p.c + bo + tid * vb, vb);
      }
    };
    auto store_ahead = [&]() {
      if (sx >= 0) {
        store(xs + sx, rx, vx);
        store(dts + sx, rd, vx);
      }
      if (has_bc) {
        store(bs + tid * vb, rb, vb);
        store(cs + tid * vb, rc, vb);
      }
    };

    copy_rows(0, 0, chunk);
    cp_async_wait_all();
    __syncthreads();
    for (int t0 = 0; t0 < p.seq; t0 += chunk) {
      const bool next = t0 + chunk < p.seq;
      if (p.stage == kHalves) {
        // the rows of each half are refilled with the next chunk's while
        // the other half runs
        run(t0, 0, half);
        cp_async_wait_all();  // this chunk's second half has landed
        __syncthreads();      // for every thread; the first half is consumed
        if (next) copy_rows(t0 + chunk, 0, half);
        run(t0, half, chunk);
        cp_async_wait_all();  // the next chunk's first half has landed
        __syncthreads();      // for every thread; the second is consumed
        if (next) copy_rows(t0 + chunk, half, chunk);
        continue;
      }
      if (next && p.stage == kRegisters) load_ahead(t0 + chunk);
      run(t0, 0, chunk);
      __syncthreads();  // the chunk is consumed
      if (!next) continue;
      if (p.stage == kRegisters) {
        store_ahead();
      } else {
        copy_rows(t0 + chunk, 0, chunk);
        cp_async_wait_all();
      }
      __syncthreads();
    }
  }
}

template <int S, int P, bool kExact>
cudaError_t launch_kernel(const Args& args, dim3 grid, int threads, int smem,
                          cudaStream_t stream) {
  auto kernel = scan_kernel<S, P, kExact>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int S, int P>
cudaError_t by_exact(bool exact, const Args& args, dim3 grid, int threads,
                     int smem, cudaStream_t stream) {
  return exact ? launch_kernel<S, P, true>(args, grid, threads, smem, stream)
               : launch_kernel<S, P, false>(args, grid, threads, smem, stream);
}

// The (states, lanes) pairs scan_plan returns: up to 4 states a thread at
// any lanes; 8 states at 8 or 16 lanes (N 33..128); 16 states at 8 lanes
// (N 65..128).
template <int S>
cudaError_t by_lanes(int lanes, bool exact, const Args& args, dim3 grid,
                     int threads, int smem, cudaStream_t stream) {
  if constexpr (S <= 4) {
    switch (lanes) {
      case 1: return by_exact<S, 1>(exact, args, grid, threads, smem, stream);
      case 2: return by_exact<S, 2>(exact, args, grid, threads, smem, stream);
      case 4: return by_exact<S, 4>(exact, args, grid, threads, smem, stream);
      case 8: return by_exact<S, 8>(exact, args, grid, threads, smem, stream);
      case 16: return by_exact<S, 16>(exact, args, grid, threads, smem, stream);
      case 32: return by_exact<S, 32>(exact, args, grid, threads, smem, stream);
      default: return cudaErrorInvalidValue;
    }
  } else if constexpr (S == 8) {
    switch (lanes) {
      case 8: return by_exact<8, 8>(exact, args, grid, threads, smem, stream);
      case 16: return by_exact<8, 16>(exact, args, grid, threads, smem, stream);
      default: return cudaErrorInvalidValue;
    }
  } else {
    return lanes == 8
               ? by_exact<16, 8>(exact, args, grid, threads, smem, stream)
               : cudaErrorInvalidValue;
  }
}

int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for a plan the kernel does not take.  The plan
// (states .. smem) comes from kernels/mamba_scan.py::scan_plan; smem_cap
// is smem_bytes(chunk, d_block, n, 4), the mapping's formula.
extern "C" int mamba_scan_launch(
    const void* x, const void* dt, const void* b, const void* c,
    const void* a_log_neg, const void* d_skip, void* y, int batch, int seq,
    int dim, int n_state, int chunk, int d_block, int states, int lanes,
    int channels, int threads, int split, int passes, int stage, int vec_x,
    int vec_bc, int smem, int smem_cap, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (batch < 1 || batch > 65535 || seq < 1 || dim < 1 || n_state < 1 ||
      n_state > kMaxState || chunk < 1 || d_block < 1 || seq % chunk ||
      dim % d_block ||
      static_cast<long long>(chunk) * dim >= (1ll << 31)) {
    return bad;
  }
  if ((states != 1 && states != 2 && states != 4 && states != 8 &&
       states != 16) ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      states * lanes != pow2_ceil(n_state)) {
    return bad;
  }
  if (split < 1 || split > kMaxSplit || d_block % split) return bad;
  const int share = d_block / split;
  if (channels < 1 || channels > share || passes != cdiv(share, channels) ||
      threads != cdiv(static_cast<long long>(channels) * lanes, 32) * 32 ||
      threads > kMaxThreads) {
    return bad;
  }
  if (vec_x == 4) {
    if (channels % 4 || share % 4 || d_block % 4 || (2 * chunk * n_state) % 4 ||
        !aligned16(x) || !aligned16(dt)) {
      return bad;
    }
  } else if (vec_x != 1) {
    return bad;
  }
  if (vec_bc == 4) {
    if (n_state % 4 || !aligned16(b) || !aligned16(c)) return bad;
  } else if (vec_bc != 1) {
    return bad;
  }
  if (stage == kRegisters) {
    // one vector a thread an operand
    if (static_cast<long long>(chunk) * channels / vec_x > threads ||
        static_cast<long long>(chunk) * n_state / vec_bc > threads) {
      return bad;
    }
  } else if (stage == kHalves) {
    if (chunk < 2) return bad;
  } else if (stage != kSync) {
    return bad;
  }
  const long long want = 4ll * chunk * (2 * n_state + 2 * channels);
  if (smem != want || smem > smem_cap || smem > kSmemLimit) return bad;

  Args args{static_cast<const float*>(x),  static_cast<const float*>(dt),
            static_cast<const float*>(b),  static_cast<const float*>(c),
            static_cast<const float*>(a_log_neg),
            static_cast<const float*>(d_skip), static_cast<float*>(y),
            seq, dim, n_state, chunk, d_block, channels, split, passes,
            stage, vec_x, vec_bc};
  const dim3 grid((dim / d_block) * split, batch);
  const bool exact = states * lanes == n_state;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (states) {
    case 1: return by_lanes<1>(lanes, exact, args, grid, threads, smem, st);
    case 2: return by_lanes<2>(lanes, exact, args, grid, threads, smem, st);
    case 4: return by_lanes<4>(lanes, exact, args, grid, threads, smem, st);
    case 8: return by_lanes<8>(lanes, exact, args, grid, threads, smem, st);
    default: return by_lanes<16>(lanes, exact, args, grid, threads, smem, st);
  }
}
