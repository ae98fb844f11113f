// Mamba's selective scan on the H100 (sm_90a), forward and backward.
//
// Replaces the time recurrence of the JAX package's `mamba_apply`
// (src/repro/models/mamba.py:96-107: the `step` run by `chunked_scan`,
// src/repro/models/scan_utils.py:165, a `jax.lax.scan` with a
// `jax.checkpoint` every 256 steps) and XLA's autodiff of it.  It is not
// a Pallas kernel; PyTorch has no compiled scan, and an eager step loop
// issues about 8 ops a step.  `ref.selective_scan_ref` and
// `ref.selective_scan_bwd_ref` are the plain versions and the
// specification.
//
//   h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t,   y_t = sum_n c_t,n h_t,n
//
// x (B, S, D) float32 or bf16; dt (B, S, D), b and c (B, S, N), a (D, N)
// and y (B, S, D) float32; N (d_state) is a template, 16 (jamba) or 4.
//
// Bound.  Per (step, channel) the forward reads x and dt and writes y
// and takes N exps: at jamba's B 1, S 4,096, D 16,384, N 16 that is 0.67
// GB (0.20 ms at 3.35 TB/s) and 1.07 G exps (0.26 ms at the SFU's 16 a
// clock an SM).  Each channel is a chain of S dependent steps, and a
// thread a channel gives only B x D / 32 = 512 warps, about 4 an SM:
// the kernel is bound by latency before either.
//
// Forward: a thread a (batch row, channel) with its N states and its row
// of a in registers; a block of 128 channels of one row.  A tile of 16
// steps at a time: b_t and c_t, which all channels of the row share,
// are staged through shared memory, x_t and dt_t loaded into registers
// (coalesced across channels) before the tile's steps run.  The state at
// the start of every 256-step chunk is written out for the backward
// (B, ceil(S / 256), D, N).
//
// Backward: the same mapping, the chunks in reverse.  A chunk's states
// are recomputed from its stored state: first the state at the start of
// each 8-step sub-chunk, kept in a global scratch (thread-private rows,
// B x 32 x D x N floats); then, a sub-chunk at a time in reverse, its 9
// states into shared memory (each thread its own column) and the
// reverse recurrence over them with g (the gradient of h) carried in
// registers.  dx and d(dt) are written per element; da accumulates in
// registers over the row's steps.  db and dc are sums over all D
// channels: a warp sums its 32 channels' 2N values with a transposing
// butterfly (2N - 1 shuffles for 2N = 32; lane l ends holding one
// value's sum), the block adds its 4 warps in order and writes one
// partial per (block, row, step); a second kernel adds the blocks'
// partials, and the rows' da, in order.  No atomics: two backwards are
// bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 256;      // steps between the forward's stored states
constexpr int THREADS = 128;    // channels of a block (ref.SCAN_CHANNEL_BLOCK)
constexpr int WARPS = THREADS / 32;
constexpr int FWD_TILE = 16;    // steps the forward stages at once
constexpr int SUB = 8;          // steps of a backward sub-chunk
constexpr int NSUB = CHUNK / SUB;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <int N, typename XT>
__global__ void __launch_bounds__(THREADS)
    scan_fwd_kernel(const XT* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a_in, float* __restrict__ y,
                    float* __restrict__ hs, int S, int D) {
  __shared__ float sb[FWD_TILE][N];
  __shared__ float sc[FWD_TILE][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < D;
  const int nc = (S + CHUNK - 1) / CHUNK;
  const size_t row = (size_t)b * S;   // the row's first step
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? a_in[(size_t)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += FWD_TILE) {
    if (t0 % CHUNK == 0 && live) {
      float* dst = hs + (((size_t)b * nc + t0 / CHUNK) * D + d) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) dst[n] = h[n];
    }
    const int len = min(FWD_TILE, S - t0);
    __syncthreads();   // the previous tile's b and c are consumed
    for (int i = threadIdx.x; i < FWD_TILE * N; i += THREADS) {
      const int k = i / N;
      const size_t at = (row + t0 + k) * N + i % N;
      (&sb[0][0])[i] = k < len ? bm[at] : 0.f;
      (&sc[0][0])[i] = k < len ? cm[at] : 0.f;
    }
    float xv[FWD_TILE], dv[FWD_TILE];
#pragma unroll
    for (int k = 0; k < FWD_TILE; ++k) {
      const bool in = live && k < len;
      const size_t at = (row + t0 + k) * D + d;
      xv[k] = in ? to_f32(x[at]) : 0.f;
      dv[k] = in ? dt[at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FWD_TILE; ++k) {
      if (k < len) {
        const float dtx = dv[k] * xv[k];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(dv[k] * a[n]) * h[n] + dtx * sb[k][n];
          acc += h[n] * sc[k][n];
        }
        if (live) y[(row + t0 + k) * D + d] = acc;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
// A warp's sum of each of V values (a power of two up to 32) over its 32
// lanes.  Each halving level sends the half of the values a lane gives
// up to its partner and adds the half it keeps; after log2(V) levels
// lane l holds one value's partial in v[0], and plain butterfly levels
// finish the sum.  On exit v[0] of lane l is the sum of value
// l >> (5 - log2 V).
template <int C, int O>
struct Halve {
  template <int V>
  static __device__ __forceinline__ void run(float (&v)[V], int lane) {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float send = upper ? v[i] : v[i + C / 2];
      const float keep = upper ? v[i + C / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, O);
    }
    Halve<C / 2, O / 2>::run(v, lane);
  }
};

template <int O>
struct Halve<1, O> {
  template <int V>
  static __device__ __forceinline__ void run(float (&v)[V], int) {
#pragma unroll
    for (int o = O; o >= 1; o >>= 1) v[0] += __shfl_xor_sync(FULL, v[0], o);
  }
};

template <int V>
struct Log2 {
  static constexpr int value = 1 + Log2<V / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

// The staging buffers of one sub-chunk: b and c of the row, x, dt and dy
// of the block's channels (a column each).
template <int N>
struct Stage {
  float b[SUB][N];
  float c[SUB][N];
  float x[SUB][THREADS];
  float dt[SUB][THREADS];
  float dy[SUB][THREADS];
  float wsum[WARPS][SUB][2 * N];
};

template <int N, typename XT>
__device__ __forceinline__ void stage(Stage<N>& st, const XT* x,
                                      const float* dt, const float* dy,
                                      const float* bm, const float* cm,
                                      size_t row, int s0, int len, int d,
                                      bool live, int D) {
  __syncthreads();   // the previous sub-chunk's staged values are consumed
  for (int i = threadIdx.x; i < SUB * N; i += THREADS) {
    const int k = i / N;
    const size_t at = (row + s0 + k) * N + i % N;
    (&st.b[0][0])[i] = k < len ? bm[at] : 0.f;
    (&st.c[0][0])[i] = k < len ? cm[at] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < SUB; ++k) {
    const bool in = live && k < len;
    const size_t at = (row + s0 + k) * D + d;
    st.x[k][threadIdx.x] = in ? to_f32(x[at]) : 0.f;
    st.dt[k][threadIdx.x] = in ? dt[at] : 0.f;
    if (dy != nullptr) st.dy[k][threadIdx.x] = in ? dy[at] : 0.f;
  }
  __syncthreads();
}

template <int N, typename XT>
__global__ void __launch_bounds__(THREADS)
    scan_bwd_kernel(const XT* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a_in,
                    const float* __restrict__ hs, const float* __restrict__ dy,
                    XT* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ part_bc, float* __restrict__ part_a,
                    float* sub_h, int S, int D) {
  constexpr int V = 2 * N;
  constexpr int SHIFT = 5 - Log2<V>::value;
  __shared__ Stage<N> st;
  // hist[j][n][tid]: the sub-chunk's states, j = 0 the one before it
  extern __shared__ float hist[];
  const int b = blockIdx.y, B = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = blockIdx.x * THREADS + tid;
  const bool live = d < D;
  const int nc = (S + CHUNK - 1) / CHUNK;
  const size_t row = (size_t)b * S;
  float a[N], carry[N], da_acc[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? a_in[(size_t)d * N + n] : 0.f;
    carry[n] = 0.f;    // exp(dt_{t+1} a) g_{t+1}
    da_acc[n] = 0.f;
  }
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int c0 = ci * CHUNK;
    const int nsub = (min(CHUNK, S - c0) + SUB - 1) / SUB;
    // 1. the chunk's states again, keeping the one before every sub-chunk
    const float* h0 = hs + (((size_t)b * nc + ci) * D + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = live ? h0[n] : 0.f;
    for (int k = 0; k < nsub; ++k) {
      const int s0 = c0 + k * SUB, len = min(SUB, S - s0);
      if (live) {
        float* dst = sub_h + (((size_t)b * NSUB + k) * D + d) * N;
#pragma unroll
        for (int n = 0; n < N; ++n) dst[n] = h[n];
      }
      if (k + 1 == nsub) break;   // the last sub-chunk's states come in 2.
      stage<N, XT>(st, x, dt, nullptr, bm, cm, row, s0, len, d, live, D);
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const float dtv = st.dt[j][tid];
        const float dtx = dtv * st.x[j][tid];
#pragma unroll
        for (int n = 0; n < N; ++n)
          h[n] = expf(dtv * a[n]) * h[n] + dtx * st.b[j][n];
      }
    }
    // 2. the sub-chunks in reverse: their states, then the reverse steps
    for (int k = nsub - 1; k >= 0; --k) {
      const int s0 = c0 + k * SUB, len = min(SUB, S - s0);
      stage<N, XT>(st, x, dt, dy, bm, cm, row, s0, len, d, live, D);
      const float* src = sub_h + (((size_t)b * NSUB + k) * D + d) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = live ? src[n] : 0.f;
        hist[n * THREADS + tid] = h[n];
      }
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        if (j < len) {
          const float dtv = st.dt[j][tid];
          const float dtx = dtv * st.x[j][tid];
#pragma unroll
          for (int n = 0; n < N; ++n) {
            h[n] = expf(dtv * a[n]) * h[n] + dtx * st.b[j][n];
            hist[((j + 1) * N + n) * THREADS + tid] = h[n];
          }
        }
      }
      for (int j = len - 1; j >= 0; --j) {
        const float dtv = st.dt[j][tid], xv = st.x[j][tid];
        const float dyv = st.dy[j][tid];
        const float dtx = dtv * xv;
        float v[V];           // db's then dc's terms of this channel
        float sgb = 0.f, sdt = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float hn = hist[((j + 1) * N + n) * THREADS + tid];
          const float hp = hist[(j * N + n) * THREADS + tid];
          const float e = expf(dtv * a[n]);
          const float g = dyv * st.c[j][n] + carry[n];
          v[N + n] = dyv * hn;
          v[n] = g * dtx;
          sgb += g * st.b[j][n];
          const float t1 = g * hp * e;
          sdt += t1 * a[n];
          da_acc[n] += t1 * dtv;
          carry[n] = e * g;
        }
        if (live) {
          const size_t at = (row + s0 + j) * D + d;
          put(dx + at, dtv * sgb);
          ddt[at] = sdt + xv * sgb;
        }
        Halve<V, 16>::run(v, lane);
        if ((lane & ((1 << SHIFT) - 1)) == 0) st.wsum[warp][j][lane >> SHIFT] = v[0];
      }
      __syncthreads();
      // the block's partial of every step of the sub-chunk, warps in order
      for (int i = tid; i < len * V; i += THREADS) {
        const int j = i / V, u = i % V;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += st.wsum[w][j][u];
        part_bc[(((size_t)blockIdx.x * B + b) * S + s0 + j) * V + u] = s;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) part_a[((size_t)b * D + d) * N + n] = da_acc[n];
  }
}

// db, dc: the blocks' partials added in block order; da: the rows' in
// row order.
__global__ void scan_bwd_reduce_kernel(const float* __restrict__ part_bc,
                                       const float* __restrict__ part_a,
                                       float* __restrict__ db,
                                       float* __restrict__ dc,
                                       float* __restrict__ da, int blocks,
                                       int B, int S, int D, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_bc = (size_t)B * S * 2 * N;
  if (i < n_bc) {
    float s = 0.f;
    for (int k = 0; k < blocks; ++k) s += part_bc[(size_t)k * n_bc + i];
    const size_t bt = i / (2 * N);
    const int u = (int)(i % (2 * N));
    if (u < N) db[bt * N + u] = s;
    else dc[bt * N + u - N] = s;
  } else if (i < n_bc + (size_t)D * N) {
    const size_t j = i - n_bc;
    float s = 0.f;
    for (int r = 0; r < B; ++r) s += part_a[(size_t)r * D * N + j];
    da[j] = s;
  }
}

size_t hist_bytes(int n_state) {
  return (size_t)(SUB + 1) * n_state * THREADS * sizeof(float);
}

template <int N, typename XT>
cudaError_t fwd(const void* x, const void* dt, const void* bm, const void* cm,
                const void* a, void* y, void* hs, int B, int S, int D,
                cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  scan_fwd_kernel<N, XT><<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<float*>(y),
      static_cast<float*>(hs), S, D);
  return cudaGetLastError();
}

template <int N, typename XT>
cudaError_t bwd(const void* x, const void* dt, const void* bm, const void* cm,
                const void* a, const void* hs, const void* dy, void* dx,
                void* ddt, void* db, void* dc, void* da, void* part_bc,
                void* part_a, void* sub_h, int B, int S, int D,
                cudaStream_t stream) {
  const int blocks = (D + THREADS - 1) / THREADS;
  const size_t smem = hist_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<N, XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  scan_bwd_kernel<N, XT><<<dim3(blocks, B), THREADS, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(hs),
      static_cast<const float*>(dy), static_cast<XT*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(part_bc),
      static_cast<float*>(part_a), static_cast<float*>(sub_h), S, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t total = (size_t)B * S * 2 * N + (size_t)D * N;
  const int threads = 256;
  scan_bwd_reduce_kernel<<<(unsigned)((total + threads - 1) / threads),
                           threads, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
      static_cast<float*>(db), static_cast<float*>(dc),
      static_cast<float*>(da), blocks, B, S, D, N);
  return cudaGetLastError();
}

// Runs `fn` with `device` current and hands the caller's device back.
template <typename F>
int on_device(int device, F fn) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  err = fn();
  if (prev != device) {
    const cudaError_t restored = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restored;
  }
  return (int)err;
}

bool shapes_ok(int n_state, int B, int S, int D) {
  return (n_state == 4 || n_state == 16) && B > 0 && S > 0 && D > 0 &&
         B <= 65535;
}

}  // namespace

extern "C" {

// The tiling the kernels index their buffers by, for the caller to size
// them: `chunks` states a row in hs, `blocks` channel blocks in part_bc
// and `subs` sub-chunk states a row in sub_h.
void selective_scan_geometry(int S, int D, int* chunks, int* blocks,
                             int* subs) {
  *chunks = (S + CHUNK - 1) / CHUNK;
  *blocks = (D + THREADS - 1) / THREADS;
  *subs = NSUB;
}

// Both launch on `stream`, allocate nothing and do not synchronise.
// Every tensor is contiguous; x (and dx) is float32, or bf16 with
// `x_bf16`; everything else float32.  n_state is 4 or 16.  With
// (chunks, blocks, subs) from selective_scan_geometry(S, D): forward: y
// (B, S, D), hs (B, chunks, D, N).  Backward: dx, d(dt) (B, S, D), db,
// dc (B, S, N), da (D, N), and the scratch part_bc (blocks, B, S, 2N),
// part_a (B, D, N) and sub_h (B, subs, D, N).  Return
// cudaGetLastError() after the launches.
int selective_scan_fwd_launch(int device, int n_state, int x_bf16,
                              const void* x, const void* dt, const void* bm,
                              const void* cm, const void* a, void* y,
                              void* hs, int B, int S, int D, void* stream) {
  if (!shapes_ok(n_state, B, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (n_state == 16)
      return x_bf16 ? fwd<16, __nv_bfloat16>(x, dt, bm, cm, a, y, hs, B, S, D, s)
                    : fwd<16, float>(x, dt, bm, cm, a, y, hs, B, S, D, s);
    return x_bf16 ? fwd<4, __nv_bfloat16>(x, dt, bm, cm, a, y, hs, B, S, D, s)
                  : fwd<4, float>(x, dt, bm, cm, a, y, hs, B, S, D, s);
  });
}

int selective_scan_bwd_launch(int device, int n_state, int x_bf16,
                              const void* x, const void* dt, const void* bm,
                              const void* cm, const void* a, const void* hs,
                              const void* dy, void* dx, void* ddt, void* db,
                              void* dc, void* da, void* part_bc, void* part_a,
                              void* sub_h, int B, int S, int D, void* stream) {
  if (!shapes_ok(n_state, B, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (n_state == 16)
      return x_bf16
                 ? bwd<16, __nv_bfloat16>(x, dt, bm, cm, a, hs, dy, dx, ddt, db,
                                          dc, da, part_bc, part_a, sub_h, B, S,
                                          D, s)
                 : bwd<16, float>(x, dt, bm, cm, a, hs, dy, dx, ddt, db, dc, da,
                                  part_bc, part_a, sub_h, B, S, D, s);
    return x_bf16
               ? bwd<4, __nv_bfloat16>(x, dt, bm, cm, a, hs, dy, dx, ddt, db,
                                       dc, da, part_bc, part_a, sub_h, B, S, D,
                                       s)
               : bwd<4, float>(x, dt, bm, cm, a, hs, dy, dx, ddt, db, dc, da,
                               part_bc, part_a, sub_h, B, S, D, s);
  });
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
