// Flash attention in bf16 at head_dim 192 and 256, forward and backward,
// for Hopper (sm_90a), hand-written CUDA C++: the "d192" and "d256"
// routes of kernels/flash_attention.py, one template on D instantiated at
// both.
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `flash_attention_pallas` (src/repro/kernels/flash_attention.py:28-69)
// for bf16 with head_dim 256 (gemma3-1b) and 192 (deepseek-v2's MLA:
// 128 + 64 query / key columns, v padded from 128): GQA self-attention
// (query head h reads kv head h / G) over q (B, S, H, D) and k/v (B, S,
// KH, D),
// causal and/or sliding-window masked, online softmax in float32, p
// rounded to bf16 after the tile's running max before the PV product, 0
// for a row with no attendable key, and LSE = m + log(l) (B, H, S)
// float32 out.  Its backward replaces XLA's autodiff of
// `blockwise_attention` (src/repro/models/attention.py) in the JAX
// package.  Head dims 64 and 128 go to flash_attention_sm90.cu, float32
// to flash_attention.cu.
//
// Bound.  At gemma3's training shape (B 2, S 4096, 4 / 1 heads, causal,
// 22 of 26 layers with a 512-key window) and deepseek-v2's (B 1, S 4096,
// 128 / 128 heads of 192, causal) attention does 4 D operations per
// attended (query, key) pair and head forward for 4 D bytes of q and o a
// row: far above the H100's 295 operations a byte, so it is bound by the
// tensor cores' 989 TFLOP/s (bf16).
//
// Design.  This route is the simple one: every product is an
// `mma.sync.m16n8k16` (bf16 in, float32 accumulate) from shared memory,
// tiles double-buffered by cp.async.  At D 256 a warp's 16 x 256 float32
// accumulator is 128 registers a thread (96 at D 192), so a warp owns 16
// rows and all of D, and nothing else lives in registers for long: the
// Q, K and V fragments are loaded from shared memory at each product.
// Row strides are D + 8 bf16 (132 words at D 256, 100 at D 192: 4 mod
// 32 both), so every fragment load of a warp hits distinct banks, and
// rows stay 16-byte aligned for cp.async (528 and 400 bytes).  The accumulator of S = Q K^T (16 x 16 as two
// m16n8 tiles) is the A fragment of the next product as it stands (P,
// rounded to bf16), so P and dS never pass through shared memory on
// their way into a product.
//   fwd:   one block of 4 warps per (64-row q tile, h, b), the q tiles
//          with the most keys first; 32-key K / V tiles.  A warp skips
//          the tiles its rows cannot reach, and the block starts at the
//          window's first tile (what makes a 512-key local layer cheap
//          at S 4096); the mask is evaluated per element only on tiles
//          the diagonal, the window's edge or S cuts.
//   delta: delta = rowsum(dO * O) into (B, H, S) float32 scratch.
//   dK/dV: one block of 8 warps (4 pairs, 16 keys a pair) per (kv head,
//          b, 64-key tile), looping over the G query heads and the
//          16-query tiles that reach its keys (from the diagonal to the
//          window's end).  In a pair one warp forms S^T = K Q^T, P^T and
//          dV += P^T dO, the other dP^T = V dO^T, dS^T = P^T (dP^T -
//          delta) and dK += dS^T Q, P^T passing through shared memory:
//          D / 2 accumulators a thread each, one block an SM.  The pair
//          splits the work by product, not by D: each warp holds all D
//          columns of its own sum.
//   dQ:    one block of 8 warps per (64-row q tile, h, b), streaming
//          16-key K / V tiles from the window's first; one warp of a
//          pair forms S and P, the other dP, they swap them, and each
//          adds dS K to half of dQ's columns.
// Nothing is accumulated across blocks (no atomics): deterministic.  The
// backward runs 7 tile products where the bound counts 5 (dQ recomputes
// S and dP); wgmma, TMA and the single-pass backward are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// The head dims of the template: a shared tile's row stride (in bf16),
// m16n8 tiles across D and k16 steps across D
template <int D>
struct Dims {
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  static constexpr int LD = D + 8;
  static constexpr int NT = D / 8;
  static constexpr int KT = D / 16;
};
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int FWD_THREADS = 128;   // 4 warps, 16 query rows each
constexpr int FWD_ROWS = 64;       // query rows a forward block owns
constexpr int FWD_STEP = 32;       // keys of a K / V tile
constexpr int BWD_THREADS = 256;   // 4 pairs of warps, 16 rows a pair
constexpr int BWD_ROWS = 64;       // keys (dK/dV) or queries (dQ) a block
constexpr int BWD_STEP = 16;       // rows of the tile streamed per step

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ bool attendable(int qp, int kp, int S, int causal,
                                           int window) {
  if (qp >= S || kp >= S) return false;
  if (causal && kp > qp) return false;
  if (window > 0 && kp <= qp - window) return false;
  return true;
}

// c += a b on one 16 x 8 x 16 tile: bf16 operands, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pair_at(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// two bf16 values as one operand register, the first in the low half
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack(__float2bfloat16(lo), __float2bfloat16(hi));
}

// Fragments from shared tiles of row stride LD; g = lane / 4, t = lane % 4.
// A (16 x 16) = x[r0 .. r0 + 16)[c0 .. c0 + 16), row-major
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* x,
                                       int r0, int c0, int g, int t) {
  const bf16* p = x + (r0 + g) * LD + c0 + 2 * t;
  a[0] = pair_at(p);
  a[1] = pair_at(p + 8 * LD);
  a[2] = pair_at(p + 8);
  a[3] = pair_at(p + 8 * LD + 8);
}
// B (16 x 8) = x[n0 .. n0 + 8)[c0 .. c0 + 16)^T: x's rows are B's columns
template <int LD>
__device__ __forceinline__ void load_b_t(uint32_t (&b)[2], const bf16* x,
                                         int n0, int c0, int g, int t) {
  const bf16* p = x + (n0 + g) * LD + c0 + 2 * t;
  b[0] = pair_at(p);
  b[1] = pair_at(p + 8);
}
// B (16 x 8) = x[r0 .. r0 + 16)[n0 .. n0 + 8): x's rows are B's k rows
template <int LD>
__device__ __forceinline__ void load_b_n(uint32_t (&b)[2], const bf16* x,
                                         int r0, int n0, int g, int t) {
  const bf16* p = x + (r0 + 2 * t) * LD + n0 + g;
  b[0] = pack(p[0], p[LD]);
  b[1] = pack(p[8 * LD], p[9 * LD]);
}
// The accumulators of a 16 x 16 product (two m16n8 tiles: columns 0-7 in
// c0, 8-15 in c1) as the A fragment of the next, rounded to bf16
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4],
                                           const float (&c0)[4],
                                           const float (&c1)[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

// c (16 x 16) = x[r0 .. r0 + 16) y[0 .. 16)^T over D: x, y row-major tiles
template <int D>
__device__ __forceinline__ void product_t(float (&c)[2][4], const bf16* x,
                                          const bf16* y, int r0, int g,
                                          int t) {
  constexpr int LD = Dims<D>::LD;
#pragma unroll
  for (int kk = 0; kk < Dims<D>::KT; ++kk) {
    uint32_t a[4];
    load_a<LD>(a, x, r0, 16 * kk, g, t);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t b[2];
      load_b_t<LD>(b, y, 8 * j, 16 * kk, g, t);
      mma(c[j], a, b);
    }
  }
}
// acc (16 x 8 NA) += w x[0 .. 16)[8 n0 .. 8 (n0 + NA)), w (16 x 16) the
// accumulators of a product_t
template <int NA, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[NA][4],
                                           const float (&w)[2][4],
                                           const bf16* x, int n0, int g,
                                           int t) {
  uint32_t a[4];
  a_from_acc(a, w[0], w[1]);
#pragma unroll
  for (int n = 0; n < NA; ++n) {
    uint32_t b[2];
    load_b_n<LD>(b, x, 0, 8 * (n0 + n), g, t);
    mma(acc[n], a, b);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async that writes zeros when `in` is false (rows past S)
__device__ __forceinline__ void cp_async16(void* smem, const void* g,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(g), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* g,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(g), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Rows [r0, r0 + R) of one head of x (rows `rs` elements apart from
// `base`) into dst (R x LD), 16 bytes a copy; zeros past S
template <int R, int T, int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* x,
                                           long long base, long long rs,
                                           int r0, int S) {
  constexpr int LD = Dims<D>::LD;
  constexpr int PER_ROW = D / 8;  // 16-byte pieces of a row
#pragma unroll 4
  for (int c = threadIdx.x; c < R * PER_ROW; c += T) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * 8;
    const bool in = r0 + r < S;
    cp_async16(dst + r * LD + col,
               x + base + (long long)(in ? r0 + r : 0) * rs + col, in);
  }
}
// n values of a (B, H, S) row statistic from position r0; 0 past S
__device__ __forceinline__ void stage_stats(float* dst, const float* x,
                                            long long base, int r0, int S,
                                            int n, int first_thread) {
  const int i = threadIdx.x - first_thread;
  if (i >= 0 && i < n) {
    const bool in = r0 + i < S;
    cp_async4(dst + i, x + base + (in ? r0 + i : 0), in);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 2) fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int S, int H, int KH, int causal, int window,
    float scale) {
  constexpr int LD = Dims<D>::LD, NT = Dims<D>::NT, KT = Dims<D>::KT;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FWD_ROWS;  // last tile first
  const int kvh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = warp * 16;  // the warp's first query row in the tile
  const int w0 = q0 + qr;    // and its position
  // scores and the running max m in log2 units: P = exp2f(s - m)
  const float scale2 = scale * LOG2E;
  const long long q_ss = (long long)H * D, k_ss = (long long)KH * D;
  const long long q_base = (long long)b * S * q_ss + (long long)h * D;
  const long long k_base = (long long)b * S * k_ss + (long long)kvh * D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // FWD_ROWS x LD: Q, then O
  bf16* st = q_s + FWD_ROWS * LD;                 // 2 stages of K, V
  constexpr int STAGE = 2 * FWD_STEP * LD;

  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(S, q0 + FWD_ROWS) : S;
  lo = lo / FWD_STEP * FWD_STEP;
  const int steps = max(0, (hi - lo + FWD_STEP - 1) / FWD_STEP);
  auto stage = [&](int i, int buf) {
    const int kt0 = lo + i * FWD_STEP;
    bf16* k_s = st + buf * STAGE;
    stage_rows<FWD_STEP, FWD_THREADS, D>(k_s, k, k_base, k_ss, kt0, S);
    stage_rows<FWD_STEP, FWD_THREADS, D>(k_s + FWD_STEP * LD, v, k_base,
                                         k_ss, kt0, S);
  };

  stage_rows<FWD_ROWS, FWD_THREADS, D>(q_s, q, q_base, q_ss, q0, S);
  cp_async_commit();
  if (steps > 0) stage(0, 0);
  cp_async_commit();

  // keys [w_lo, w_hi) can reach one of the warp's rows
  const int w_lo = window > 0 ? w0 - window + 1 : 0;
  const int w_hi = causal ? min(S, w0 + 16) : S;
  float acc[NT][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) stage(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // step i's K and V (and Q) have landed
    __syncthreads();
    const int kt0 = lo + i * FWD_STEP;
    if (kt0 < w_hi && kt0 + FWD_STEP > w_lo) {
      const bf16* k_s = st + buf * STAGE;
      const bf16* v_s = k_s + FWD_STEP * LD;
      // S: rows g, g + 8 of the warp; keys 8 j + 2 t, + 1 of the tile
      float c[FWD_STEP / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4];
        load_a<LD>(a, q_s, qr, 16 * kk, g, t);
#pragma unroll
        for (int j = 0; j < FWD_STEP / 8; ++j) {
          uint32_t bb[2];
          load_b_t<LD>(bb, k_s, 8 * j, 16 * kk, g, t);
          mma(c[j], a, bb);
        }
      }
#pragma unroll
      for (int j = 0; j < FWD_STEP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] *= scale2;
      // the mask cuts this tile: the diagonal, the window's edge or S
      if ((causal && kt0 + FWD_STEP - 1 > w0) ||
          (window > 0 && kt0 <= w0 + 15 - window) || kt0 + FWD_STEP > S) {
#pragma unroll
        for (int j = 0; j < FWD_STEP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!attendable(w0 + g + (e >> 1) * 8,
                            kt0 + 8 * j + 2 * t + (e & 1), S, causal, window))
              c[j][e] = NEG_INF;
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < FWD_STEP / 8; ++j)
          mx = fmaxf(mx, fmaxf(c[j][2 * r], c[j][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        alpha[r] = m[r] > NEG_INF / 2 ? exp2f(m[r] - m_new) : 0.f;
        m[r] = m_new;
        l[r] *= alpha[r];  // this lane's part of the row sum
      }
#pragma unroll
      for (int j = 0; j < FWD_STEP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = c[j][e];
          c[j][e] = s > NEG_INF / 2 ? exp2f(s - m[e >> 1]) : 0.f;  // P
          l[e >> 1] += c[j][e];
        }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      // O += P V, 16 keys a product, P rounded to bf16
#pragma unroll
      for (int kk = 0; kk < FWD_STEP / 16; ++kk) {
        uint32_t a[4];
        a_from_acc(a, c[2 * kk], c[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bb[2];
          load_b_n<LD>(bb, v_s + 16 * kk * LD, 0, 8 * n, g, t);
          mma(acc[n], a, bb);
        }
      }
    }
    __syncthreads();  // buffer `buf` is free again
  }
  if (steps == 0) {  // Q must have landed before its rows are reused
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }

  // O = acc / max(l, 1e-30) into the warp's own rows of q_s, then out in
  // 16-byte rows
  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lc[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  bf16* o_s = q_s + qr * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(o_s + (g + 8 * r) * LD + 8 * n + 2 * t) =
          pack_f32(acc[n][2 * r] / lc[r], acc[n][2 * r + 1] / lc[r]);
  if (t == 0) {  // lse = m + log(l), m back in natural units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + g + 8 * r;
      const float mn = m[r] > NEG_INF / 2 ? m[r] * LN2 : NEG_INF;
      if (row < S) lse[((long long)b * H + h) * S + row] = mn + logf(lc[r]);
    }
  }
  __syncwarp();
  constexpr int PER_ROW = D / 8;
  for (int i = lane; i < 16 * PER_ROW; i += 32) {
    const int r = i / PER_ROW, col = (i % PER_ROW) * 8;
    if (w0 + r >= S) break;
    *reinterpret_cast<int4*>(o + q_base + (long long)(w0 + r) * q_ss + col) =
        *reinterpret_cast<const int4*>(o_s + r * LD + col);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) into (B, H, S): one warp per (b, s, h) row, a
// lane's 8 values one 16-byte load of each (lanes past D / 8 add 0)
template <int D>
__global__ void __launch_bounds__(256) delta_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    float* __restrict__ delta, int S, int H, long long rows) {
  static_assert(D <= 256, "a warp covers at most 256 columns");
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float part = 0.f;
  if (lane < D / 8) {
    const int4 ov = *reinterpret_cast<const int4*>(o + r * D + lane * 8);
    const int4 dv = *reinterpret_cast<const int4*>(dout + r * D + lane * 8);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(op[i]);
      const float2 c = __bfloat1622float2(dp[i]);
      part += a.x * c.x + a.y * c.y;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) {
    const long long bb = r / ((long long)S * H);
    const int rem = (int)(r - bb * S * H), s = rem / H, h = rem - s * H;
    delta[(bb * H + h) * S + s] = part;
  }
}

// dK and dV: one block per (kv head, b, 64-key tile), the k tiles with
// the most queries first (tile 0 under the causal mask).
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1) dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, const bf16* __restrict__ dout,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int KH,
    int causal, int window, float scale) {
  constexpr int LD = Dims<D>::LD, NT = Dims<D>::NT;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BWD_ROWS;
  const int G = H / KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp & 3, role = warp >> 2;  // role 0: dV, 1: dK
  const int kr = pair * 16;  // the pair's first key row in the tile
  const long long q_ss = (long long)H * D, k_ss = (long long)KH * D;
  const long long k_base = (long long)b * S * k_ss + (long long)kvh * D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);        // BWD_ROWS x LD
  bf16* v_s = k_s + BWD_ROWS * LD;                      // BWD_ROWS x LD
  float* x_s = reinterpret_cast<float*>(v_s + BWD_ROWS * LD);  // 4 x 32 x 8
  unsigned char* st = reinterpret_cast<unsigned char*>(x_s + 4 * 32 * 8);
  // a stage: q (STEP x LD), dO (STEP x LD) bf16; lse, delta (STEP) float
  constexpr int STAGE_BYTES = 2 * BWD_STEP * LD * 2 + 2 * BWD_STEP * 4;

  int lo = causal ? k0 : 0;
  const int hi = window > 0 ? min(S, k0 + BWD_ROWS - 1 + window) : S;
  lo = lo / BWD_STEP * BWD_STEP;
  const int per_head = max(0, (hi - lo + BWD_STEP - 1) / BWD_STEP);
  const int steps = G * per_head;

  auto tiles = [&](int buf, bf16*& q_t, bf16*& do_t, float*& l_t) {
    unsigned char* base = st + buf * STAGE_BYTES;
    q_t = reinterpret_cast<bf16*>(base);
    do_t = q_t + BWD_STEP * LD;
    l_t = reinterpret_cast<float*>(do_t + BWD_STEP * LD);
  };
  auto stage = [&](int i, int buf) {
    const int h = kvh * G + i / per_head;
    const int q0 = lo + (i % per_head) * BWD_STEP;
    const long long q_base = (long long)b * S * q_ss + (long long)h * D;
    const long long s_base = ((long long)b * H + h) * S;
    bf16 *q_t, *do_t;
    float* l_t;
    tiles(buf, q_t, do_t, l_t);
    stage_rows<BWD_STEP, BWD_THREADS, D>(q_t, q, q_base, q_ss, q0, S);
    stage_rows<BWD_STEP, BWD_THREADS, D>(do_t, dout, q_base, q_ss, q0, S);
    stage_stats(l_t, lse, s_base, q0, S, BWD_STEP, 0);
    stage_stats(l_t + BWD_STEP, delta, s_base, q0, S, BWD_STEP, 32);
  };

  float acc[NT][4];  // dV (role 0) or dK (role 1): 16 keys x D
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (steps > 0) {
    stage_rows<BWD_ROWS, BWD_THREADS, D>(k_s, k, k_base, k_ss, k0, S);
    stage_rows<BWD_ROWS, BWD_THREADS, D>(v_s, v, k_base, k_ss, k0, S);
    stage(0, 0);
  }
  cp_async_commit();
  float* x = x_s + (pair * 32 + lane) * 8;
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) stage(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // step i's tiles (and K, V) have landed
    __syncthreads();

    bf16 *q_t, *do_t;
    float* l_t;
    tiles(buf, q_t, do_t, l_t);
    const int q0 = lo + (i % per_head) * BWD_STEP;

    // S^T (role 0) or dP^T (role 1): 16 keys x 16 queries
    float c[2][4] = {};
    if (role == 0)
      product_t<D>(c, k_s, q_t, kr, g, t);
    else
      product_t<D>(c, v_s, do_t, kr, g, t);
    if (role == 0) {  // P^T = exp(S^T scale - lse), 0 off the mask
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kr + g + (e >> 1) * 8;
          const int qi = 8 * j + 2 * t + (e & 1);
          const bool ok = attendable(q0 + qi, key, S, causal, window);
          c[j][e] = ok ? expf(c[j][e] * scale - l_t[qi]) : 0.f;
          x[4 * j + e] = c[j][e];
        }
    }
    __syncthreads();  // P^T is in x_s
    if (role == 1) {  // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          c[j][e] = x[4 * j + e] * (c[j][e] - l_t[BWD_STEP + qi]);
        }
    }
    // dV += P^T dO (role 0), dK += dS^T Q (role 1): k = the 16 queries
    accumulate<NT, LD>(acc, c, role == 0 ? do_t : q_t, 0, g, t);
    __syncthreads();  // buffer `buf` and x_s are free again
  }

  bf16* out = role == 0 ? dv : dk;
  const float f = role == 0 ? 1.f : scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + kr + g + 8 * r;
    if (row >= S) continue;
    bf16* dst = out + k_base + (long long)row * k_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_f32(acc[n][2 * r] * f, acc[n][2 * r + 1] * f);
  }
}

// dQ: one block per (h, b, 64-row q tile), the q tiles with the most
// keys first.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1) dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, const bf16* __restrict__ dout,
    bf16* __restrict__ dq, int S, int H, int KH, int causal, int window,
    float scale) {
  constexpr int LD = Dims<D>::LD;
  constexpr int HALF = Dims<D>::NT / 2;  // n tiles of dQ a warp accumulates
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BWD_ROWS;  // last tile first
  const int kvh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp & 3, role = warp >> 2;  // role 0: S and P, 1: dP
  const int qr = pair * 16;  // the pair's first query row in the tile
  const long long q_ss = (long long)H * D, k_ss = (long long)KH * D;
  const long long q_base = (long long)b * S * q_ss + (long long)h * D;
  const long long k_base = (long long)b * S * k_ss + (long long)kvh * D;
  const long long s_base = ((long long)b * H + h) * S;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);     // BWD_ROWS x LD
  bf16* do_s = q_s + BWD_ROWS * LD;                  // BWD_ROWS x LD
  bf16* st = do_s + BWD_ROWS * LD;                   // 2 stages of K, V
  constexpr int STAGE = 2 * BWD_STEP * LD;
  float* l_s = reinterpret_cast<float*>(st + 2 * STAGE);  // lse, delta
  float* x_s = l_s + 2 * BWD_ROWS;  // P, dP of each pair: 2 x 4 x 32 x 8

  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(S, q0 + BWD_ROWS) : S;
  lo = lo / BWD_STEP * BWD_STEP;
  const int steps = max(0, (hi - lo + BWD_STEP - 1) / BWD_STEP);
  auto stage = [&](int i, int buf) {
    const int kt0 = lo + i * BWD_STEP;
    bf16* k_t = st + buf * STAGE;
    stage_rows<BWD_STEP, BWD_THREADS, D>(k_t, k, k_base, k_ss, kt0, S);
    stage_rows<BWD_STEP, BWD_THREADS, D>(k_t + BWD_STEP * LD, v, k_base,
                                         k_ss, kt0, S);
  };

  float acc[HALF][4];  // dQ, columns [D / 2 role, D / 2 (role + 1))
#pragma unroll
  for (int n = 0; n < HALF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (steps > 0) {
    stage_rows<BWD_ROWS, BWD_THREADS, D>(q_s, q, q_base, q_ss, q0, S);
    stage_rows<BWD_ROWS, BWD_THREADS, D>(do_s, dout, q_base, q_ss, q0, S);
    stage_stats(l_s, lse, s_base, q0, S, BWD_ROWS, 0);
    stage_stats(l_s + BWD_ROWS, delta, s_base, q0, S, BWD_ROWS, BWD_ROWS);
    stage(0, 0);
  }
  cp_async_commit();
  float* mine = x_s + ((role * 4 + pair) * 32 + lane) * 8;
  const float* theirs = x_s + (((1 - role) * 4 + pair) * 32 + lane) * 8;
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) stage(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // step i's tiles (and Q, dO, stats) have landed
    __syncthreads();

    const bf16* k_t = st + buf * STAGE;
    const bf16* v_t = k_t + BWD_STEP * LD;
    const int kt0 = lo + i * BWD_STEP;

    // S (role 0) or dP (role 1), 16 queries x 16 keys
    float c[2][4] = {};
    if (role == 0)
      product_t<D>(c, q_s, k_t, qr, g, t);
    else
      product_t<D>(c, do_s, v_t, qr, g, t);
    if (role == 0) {  // P = exp(S scale - lse), 0 off the mask
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = qr + g + (e >> 1) * 8;
          const int key = kt0 + 8 * j + 2 * t + (e & 1);
          const bool ok = attendable(q0 + r, key, S, causal, window);
          c[j][e] = ok ? expf(c[j][e] * scale - l_s[r]) : 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[4 * j + e] = c[j][e];
    __syncthreads();  // P and dP are in x_s
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // dS = P (dP - delta)
        const int r = qr + g + (e >> 1) * 8;
        const float p = role == 0 ? c[j][e] : theirs[4 * j + e];
        const float dp = role == 0 ? theirs[4 * j + e] : c[j][e];
        c[j][e] = p * (dp - l_s[BWD_ROWS + r]);
      }
    // dQ += dS K on this warp's half of the columns: k = the 16 keys
    accumulate<HALF, LD>(acc, c, k_t, HALF * role, g, t);
    __syncthreads();  // buffer `buf` and x_s are free again
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + g + 8 * r;
    if (row >= S) continue;
    bf16* dst = dq + q_base + (long long)row * q_ss + 8 * HALF * role + 2 * t;
#pragma unroll
    for (int n = 0; n < HALF; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_f32(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// Dynamic shared memory of each kernel, in bytes.
template <int D>
struct Smem {
  static constexpr int LD = Dims<D>::LD;
  static constexpr size_t FWD = 2 * (FWD_ROWS * LD + 2 * 2 * FWD_STEP * LD);
  static constexpr size_t DKDV = 2 * 2 * BWD_ROWS * LD + 4 * 4 * 32 * 8 +
                                 2 * (2 * BWD_STEP * LD * 2 +
                                      2 * BWD_STEP * 4);
  static constexpr size_t DQ =
      2 * (2 * BWD_ROWS * LD + 2 * 2 * BWD_STEP * LD) +
      4 * (2 * BWD_ROWS + 2 * 4 * 32 * 8);
};

// Above 48 KB a kernel must opt in; past the card's limit this fails and
// the error goes back to the wrapper.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

bool bad_shape(int B, int S, int H, int KH, int head_dim) {
  return B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 ||
         (head_dim != 192 && head_dim != 256);
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

template <int D>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                       float* lse, int B, int S, int H, int KH, int causal,
                       int window, float scale, cudaStream_t s) {
  cudaError_t err = allow_smem(fwd_kernel<D>, Smem<D>::FWD);
  if (err != cudaSuccess) return err;
  const int tiles = (S + FWD_ROWS - 1) / FWD_ROWS;
  fwd_kernel<D><<<dim3(H, B, tiles), FWD_THREADS, Smem<D>::FWD, s>>>(
      q, k, v, o, lse, S, H, KH, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* o, const float* lse, const bf16* dout,
                       bf16* dq, bf16* dk, bf16* dv, float* delta, int B,
                       int S, int H, int KH, int causal, int window,
                       float scale, cudaStream_t s) {
  cudaError_t err = allow_smem(dkdv_kernel<D>, Smem<D>::DKDV);
  if (err == cudaSuccess) err = allow_smem(dq_kernel<D>, Smem<D>::DQ);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * S * H;
  delta_kernel<D><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(o, dout, delta,
                                                              S, H, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (S + BWD_ROWS - 1) / BWD_ROWS;
  dkdv_kernel<D><<<dim3(KH, B, tiles), BWD_THREADS, Smem<D>::DKDV, s>>>(
      q, k, v, lse, delta, dout, dk, dv, S, H, KH, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<dim3(H, B, tiles), BWD_THREADS, Smem<D>::DQ, s>>>(
      q, k, v, lse, delta, dout, dq, S, H, KH, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launch on `stream`, allocate nothing and do not synchronise.
// head_dim is 192 or 256.  Every tensor is contiguous and 16-byte
// aligned: bf16 q, o, dout, dq (B, S, H, head_dim) and k, v, dk, dv (B,
// S, KH, head_dim); float32 lse and the scratch delta (B, H, S).  causal:
// 0 or 1; window: 0 = none.  Return cudaGetLastError() (or the error
// that stopped the launch).
int flash_attention_d256_fwd_launch(int device, const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int S, int H, int KH, int head_dim,
                                    int causal, int window, float scale,
                                    void* stream) {
  if (bad_shape(B, S, H, KH, head_dim)) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  bf16* out = static_cast<bf16*>(o);
  float* l = static_cast<float*>(lse);
  return on_device(device, [&]() {
    return head_dim == 192
               ? launch_fwd<192>(c(q), c(k), c(v), out, l, B, S, H, KH,
                                 causal, window, scale, s)
               : launch_fwd<256>(c(q), c(k), c(v), out, l, B, S, H, KH,
                                 causal, window, scale, s);
  });
}

int flash_attention_d256_bwd_launch(int device, const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* lse, const void* dout,
                                    void* dq, void* dk, void* dv, void* delta,
                                    int B, int S, int H, int KH, int head_dim,
                                    int causal, int window, float scale,
                                    void* stream) {
  if (bad_shape(B, S, H, KH, head_dim)) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      !aligned16(dout) || !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto m = [](void* p) { return static_cast<bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  return on_device(device, [&]() {
    return head_dim == 192
               ? launch_bwd<192>(c(q), c(k), c(v), c(o), l, c(dout), m(dq),
                                 m(dk), m(dv), dl, B, S, H, KH, causal,
                                 window, scale, s)
               : launch_bwd<256>(c(q), c(k), c(v), c(o), l, c(dout), m(dq),
                                 m(dk), m(dv), dl, B, S, H, KH, causal,
                                 window, scale, s);
  });
}

const char* flash_attention_d256_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
