// Flash attention, forward and backward, for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `flash_attention_pallas` in src/repro/kernels/flash_attention.py: GQA
// self-attention (query head h reads kv head h / G) over q (B, S, H, D)
// and k/v (B, S, KH, D), causal and/or sliding-window masked, with an
// online softmax in float32 (running max m, sum l, accumulator acc), the
// probabilities rounded to the value dtype before the PV product, and 0
// for a row with no attendable key.  The Pallas kernel is forward only;
// the JAX package differentiates the jnp form of the same function
// (`blockwise_attention`) with XLA autodiff.  Here the backward is two
// kernels of its own, from the saved output O and log-sum-exp
// LSE = m + log(l) (B, H, S):
//   dK/dV: one block per (b, kv head, k tile); it loops over the G query
//          heads of its kv head and over the q tiles that reach its keys,
//          so dK and dV are summed over the group with no atomics;
//   dQ:    one block per (b, h, q tile), looping over its k tiles.
// Each backward block computes delta = rowsum(dO * O) for the rows it
// reads.  Nothing is accumulated across blocks: the result is
// deterministic.
//
// Design.  The TPU grid (B, H, S/bq, S/bk) walks KV blocks in order and
// carries m / l / acc in VMEM; here a block owns one 64-row q tile and
// loops over the 64-key tiles that the mask leaves (the Pallas grid
// visits every KV block and masks it, which gives the same result from
// more work).  Tiles are staged in shared memory as float32 with a row
// stride of D | 1 words, so the 16 threads that share a tile row read
// distinct banks.  256 threads form a 16 x 16 grid: a thread holds a
// 4 x 4 block of the 64 x 64 score tile (rows ty + 16 i, keys tx + 16 j)
// and a 4 x 8 block of the 64 x D accumulator (columns tx + 16 j); the
// row max and row sum are shuffle reductions across the 16 lanes of a
// half warp that hold one row.
//
// Bound.  At the training shape (S 4096, D 128) attention does about
// 4 * S / 2 * D operations for each of its 2 * S * D * 2 bytes a head:
// far above the card's ratio of operations to bytes, so it is bound by
// operations.  This version runs its products on the CUDA cores in
// float32 (tensor cores, `mma.sync` then `wgmma`, and TMA tile loads
// are later work), and its tile loads are synchronous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int TILE = 64;            // rows of a q tile, keys of a k tile
constexpr int DMAX = 128;           // largest head_dim
constexpr int RPT = TILE / 16;      // tile rows held by a thread
constexpr int CPT = TILE / 16;      // tile keys held by a thread
constexpr int DPT = DMAX / 16;      // head_dim columns held by a thread
constexpr int PLD = TILE + 1;       // row stride of a score tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to T and back: the cast of p before the PV product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// reductions over the 16 lanes of a half warp (one tile row)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool attendable(int qp, int kp, int S, int causal,
                                           int window) {
  if (qp >= S || kp >= S) return false;
  if (causal && kp > qp) return false;
  if (window > 0 && kp <= qp - window) return false;
  return true;
}

// Keys [lo, hi) that a q tile starting at q0 can attend.
__device__ __forceinline__ void key_range(int q0, int S, int causal,
                                          int window, int& lo, int& hi) {
  lo = window > 0 ? max(0, q0 - window + 1) : 0;
  hi = causal ? min(S, q0 + TILE) : S;
  lo = lo / TILE * TILE;
}
// Queries [lo, hi) that can attend a key of the k tile starting at k0.
__device__ __forceinline__ void query_range(int k0, int S, int causal,
                                            int window, int& lo, int& hi) {
  lo = causal ? k0 : 0;
  hi = window > 0 ? min(S, k0 + TILE - 1 + window) : S;
  lo = lo / TILE * TILE;
}

// Rows [r0, r0 + TILE) of one head of x, whose rows are `row_stride`
// elements apart from `base`, into dst (TILE x ld floats); 0 past S.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* x,
                                          long long base,
                                          long long row_stride, int r0,
                                          int S, int D, int ld) {
  for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int row = r0 + r;
    dst[r * ld + d] =
        row < S ? to_f32(x[base + (long long)row * row_stride + d]) : 0.f;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d]  (both TILE x ld)
__device__ __forceinline__ void tile_dot(float (&s)[RPT][CPT],
                                         const float* a, const float* b,
                                         int D, int ld, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[RPT], bv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) av[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < CPT; ++j) bv[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] += av[i] * bv[j];
  }
}

// acc[i][jj] += sum_r w[r][rows_i] * x[r][tx + 16 jj], the weights read
// as w[r * PLD + row0 + 16 i] (w^T x) when `transposed`, else as
// w[(row0 + 16 i) * PLD + r] (w x); x is TILE x ld.
template <bool transposed>
__device__ __forceinline__ void tile_accumulate(float (&acc)[RPT][DPT],
                                                const float* w,
                                                const float* x, int D,
                                                int ld, int row0, int tx) {
  for (int r = 0; r < TILE; ++r) {
    float wv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      wv[i] = transposed ? w[r * PLD + row0 + 16 * i]
                         : w[(row0 + 16 * i) * PLD + r];
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) {
        const float xv = x[r * ld + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][jj] += wv[i] * xv;
      }
    }
  }
}

// lse and delta = rowsum(dO * O) of rows [q0, q0 + TILE) of head h:
// warp w handles rows 8 w .. 8 w + 7, lanes over D.
template <typename T>
__device__ __forceinline__ void load_row_stats(
    float* lse_s, float* delta_s, const float* lse, const T* o, const T* dout,
    long long base, long long row_stride, long long lse_base, int q0, int S,
    int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = 0; rr < TILE / (THREADS / 32); ++rr) {
    const int r = warp * (TILE / (THREADS / 32)) + rr;
    const int row = q0 + r;
    float part = 0.f;
    if (row < S) {
      const long long off = base + (long long)row * row_stride;
      for (int d = lane; d < D; d += 32)
        part += to_f32(dout[off + d]) * to_f32(o[off + d]);
    }
    part = warp_sum(part);
    if (lane == 0) {
      delta_s[r] = part;
      lse_s[r] = row < S ? lse[lse_base + row] : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, h, b)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int KH, int D,
                     int causal, int window, float scale) {
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ld = D | 1;
  const long long q_ss = (long long)H * D, k_ss = (long long)KH * D;
  const long long q_base = (long long)b * S * q_ss + (long long)h * D;
  const long long k_base = (long long)b * S * k_ss + (long long)kvh * D;

  extern __shared__ float smem[];
  float* q_s = smem;                 // TILE x ld
  float* k_s = q_s + TILE * ld;      // TILE x ld
  float* v_s = k_s + TILE * ld;      // TILE x ld
  float* p_s = v_s + TILE * ld;      // TILE x PLD

  load_tile(q_s, q, q_base, q_ss, q0, S, D, ld);
  float acc[RPT][DPT], m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = 0.f;
  }

  int lo, hi;
  key_range(q0, S, causal, window, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += TILE) {
    __syncthreads();  // the last tile's readers are done
    load_tile(k_s, k, k_base, k_ss, k0, S, D, ld);
    load_tile(v_s, v, k_base, k_ss, k0, S, D, ld);
    __syncthreads();

    float s[RPT][CPT];
    tile_dot(s, q_s, k_s, D, ld, ty, tx);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const bool ok = attendable(qp, k0 + tx + 16 * j, S, causal, window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m[i] > NEG_INF / 2 ? expf(m[i] - m_new) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const bool ok = attendable(qp, k0 + tx + 16 * j, S, causal, window);
        const float p = ok ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(ty + 16 * i) * PLD + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();
    tile_accumulate<false>(acc, p_s, v_s, D, ld, ty, tx);  // acc += P V
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const long long off = q_base + (long long)row * q_ss;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) o[off + d] = from_f32<T>(acc[i][jj] / lc);
    }
    if (tx == 0) lse[((long long)b * H + h) * S + row] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: one block per (k tile, kv head, b)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const float* __restrict__ lse, const T* __restrict__ dout,
    T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KH, int D,
    int causal, int window, float scale) {
  const int k0 = blockIdx.x * TILE, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ld = D | 1;
  const long long q_ss = (long long)H * D, k_ss = (long long)KH * D;
  const long long k_base = (long long)b * S * k_ss + (long long)kvh * D;

  extern __shared__ float smem[];
  float* k_s = smem;                 // TILE x ld
  float* v_s = k_s + TILE * ld;      // TILE x ld
  float* q_s = v_s + TILE * ld;      // TILE x ld
  float* do_s = q_s + TILE * ld;     // TILE x ld
  float* p_s = do_s + TILE * ld;     // TILE x PLD
  float* ds_s = p_s + TILE * PLD;    // TILE x PLD
  float* lse_s = ds_s + TILE * PLD;  // TILE
  float* delta_s = lse_s + TILE;     // TILE

  load_tile(k_s, k, k_base, k_ss, k0, S, D, ld);
  load_tile(v_s, v, k_base, k_ss, k0, S, D, ld);
  // rows (keys) ty + 16 i, columns tx + 16 jj
  float dk_acc[RPT][DPT], dv_acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

  int lo, hi;
  query_range(k0, S, causal, window, lo, hi);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long q_base = (long long)b * S * q_ss + (long long)h * D;
    for (int q0 = lo; q0 < hi; q0 += TILE) {
      __syncthreads();  // the last tile's readers are done
      load_tile(q_s, q, q_base, q_ss, q0, S, D, ld);
      load_tile(do_s, dout, q_base, q_ss, q0, S, D, ld);
      load_row_stats(lse_s, delta_s, lse, o, dout, q_base, q_ss,
                     ((long long)b * H + h) * S, q0, S, D);
      __syncthreads();

      float s[RPT][CPT], dp[RPT][CPT];
      tile_dot(s, q_s, k_s, D, ld, ty, tx);    // S = Q K^T
      tile_dot(dp, do_s, v_s, D, ld, ty, tx);  // dP = dO V^T
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = tx + 16 * j;
          const bool ok = attendable(q0 + r, k0 + c, S, causal, window);
          const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          p_s[r * PLD + c] = round_to<T>(p);
          ds_s[r * PLD + c] = p * (dp[i][j] - delta_s[r]);
        }
      }
      __syncthreads();
      tile_accumulate<true>(dv_acc, p_s, do_s, D, ld, ty, tx);  // P^T dO
      tile_accumulate<true>(dk_acc, ds_s, q_s, D, ld, ty, tx);  // dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
    const long long off = k_base + (long long)row * k_ss;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) {
        dk[off + d] = from_f32<T>(dk_acc[i][jj] * scale);
        dv[off + d] = from_f32<T>(dv_acc[i][jj]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dQ: one block per (q tile, h, b)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const float* __restrict__ lse, const T* __restrict__ dout,
    T* __restrict__ dq, int S, int H, int KH, int D, int causal, int window,
    float scale) {
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ld = D | 1;
  const long long q_ss = (long long)H * D, k_ss = (long long)KH * D;
  const long long q_base = (long long)b * S * q_ss + (long long)h * D;
  const long long k_base = (long long)b * S * k_ss + (long long)kvh * D;

  extern __shared__ float smem[];
  float* q_s = smem;                 // TILE x ld
  float* do_s = q_s + TILE * ld;     // TILE x ld
  float* k_s = do_s + TILE * ld;     // TILE x ld
  float* v_s = k_s + TILE * ld;      // TILE x ld
  float* ds_s = v_s + TILE * ld;     // TILE x PLD
  float* lse_s = ds_s + TILE * PLD;  // TILE
  float* delta_s = lse_s + TILE;     // TILE

  load_tile(q_s, q, q_base, q_ss, q0, S, D, ld);
  load_tile(do_s, dout, q_base, q_ss, q0, S, D, ld);
  load_row_stats(lse_s, delta_s, lse, o, dout, q_base, q_ss,
                 ((long long)b * H + h) * S, q0, S, D);
  float dq_acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) dq_acc[i][jj] = 0.f;

  int lo, hi;
  key_range(q0, S, causal, window, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += TILE) {
    __syncthreads();  // the last tile's readers are done
    load_tile(k_s, k, k_base, k_ss, k0, S, D, ld);
    load_tile(v_s, v, k_base, k_ss, k0, S, D, ld);
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
    tile_dot(s, q_s, k_s, D, ld, ty, tx);
    tile_dot(dp, do_s, v_s, D, ld, ty, tx);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        const bool ok = attendable(q0 + r, k0 + c, S, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ds_s[r * PLD + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    tile_accumulate<false>(dq_acc, ds_s, k_s, D, ld, ty, tx);  // dS K
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const long long off = q_base + (long long)row * q_ss;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) dq[off + d] = from_f32<T>(dq_acc[i][jj] * scale);
    }
  }
}

// Dynamic shared memory of each kernel, in bytes.
size_t fwd_smem(int D) {
  return sizeof(float) * (3 * TILE * (D | 1) + TILE * PLD);
}
size_t dkdv_smem(int D) {
  return sizeof(float) * (4 * TILE * (D | 1) + 2 * TILE * PLD + 2 * TILE);
}
size_t dq_smem(int D) {
  return sizeof(float) * (4 * TILE * (D | 1) + TILE * PLD + 2 * TILE);
}

// Above 48 KB a kernel must opt in; past the card's limit this fails and
// the error goes back to the wrapper.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int S, int H, int KH, int D,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TILE - 1) / TILE, H, B);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, KH, D, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* lse, const void* dout,
                       void* dq, void* dk, void* dv, int B, int S, int H,
                       int KH, int D, int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem_kv = dkdv_smem(D), smem_q = dq_smem(D);
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T>, smem_kv);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_kernel<T>, smem_q);
  if (err != cudaSuccess) return err;
  const int tiles = (S + TILE - 1) / TILE;
  flash_bwd_dkdv_kernel<T><<<dim3(tiles, KH, B), THREADS, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, KH, D, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T><<<dim3(tiles, H, B), THREADS, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<T*>(dq), S, H, KH, D, causal, window, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int KH, int D) {
  return B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || D > DMAX;
}

// Runs `body` with `device` current and hands the caller's device back.
template <typename F>
int on_device(int device, F body) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  err = body();
  if (prev != device) {
    const cudaError_t restored = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restored;
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Both launch on `stream`, allocate nothing and do not synchronise.
// Every tensor is contiguous: q, o, dout, dq (B, S, H, D); k, v, dk, dv
// (B, S, KH, D); lse (B, H, S) float32.  dtype: 0 = float32, 1 =
// bfloat16.  causal: 0 or 1; window: 0 = none.  Return cudaGetLastError()
// (or the error that stopped the launch).
int flash_attention_fwd_launch(int device, const void* q, const void* k,
                               const void* v, void* o, void* lse, int B,
                               int S, int H, int KH, int D, int causal,
                               int window, float scale, int dtype,
                               void* stream) {
  if (bad_shape(B, S, H, KH, D) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return dtype == 0 ? launch_fwd<float>(q, k, v, o, lse, B, S, H, KH, D,
                                          causal, window, scale, s)
                      : launch_fwd<__nv_bfloat16>(q, k, v, o, lse, B, S, H,
                                                  KH, D, causal, window,
                                                  scale, s);
  });
}

int flash_attention_bwd_launch(int device, const void* q, const void* k,
                               const void* v, const void* o, const void* lse,
                               const void* dout, void* dq, void* dk,
                               void* dv, int B, int S, int H, int KH, int D,
                               int causal, int window, float scale,
                               int dtype, void* stream) {
  if (bad_shape(B, S, H, KH, D) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return dtype == 0
               ? launch_bwd<float>(q, k, v, o, lse, dout, dq, dk, dv, B, S,
                                   H, KH, D, causal, window, scale, s)
               : launch_bwd<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv,
                                           B, S, H, KH, D, causal, window,
                                           scale, s);
  });
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
