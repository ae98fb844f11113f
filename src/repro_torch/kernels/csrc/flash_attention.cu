// Flash attention, forward and backward, for Hopper (sm_90a), hand-written
// CUDA C++: the float32 route ("simt" in kernels/flash_attention.py).
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `flash_attention_pallas` in src/repro/kernels/flash_attention.py: GQA
// self-attention (query head h reads kv head h / G) over q (B, S, H, D)
// and k/v (B, S, KH, D), causal and/or sliding-window masked, with an
// online softmax in float32 (running max m, sum l, accumulator acc), and
// 0 for a row with no attendable key.  The Pallas kernel is forward only;
// the JAX package differentiates the jnp form of the same function
// (`blockwise_attention`) with XLA autodiff.  Here the backward is three
// kernels of its own, from the saved output O and log-sum-exp
// LSE = m + log(l) (B, H, S):
//   delta: delta = rowsum(dO * O) once per row into (B, H, S) scratch;
//   dK/dV: one block per (kv head, b, k tile); it loops over the G query
//          heads of its kv head and over the q tiles that reach its keys,
//          so dK and dV are summed over the group with no atomics;
//   dQ:    one block per (h, b, q tile), looping over its k tiles and
//          recomputing S and dP (seven products where the bound counts
//          five).
// Nothing is accumulated across blocks: the result is deterministic.
//
// Products.  Every product, forward and backward, runs on the tensor
// cores as mma.sync.m16n8k8 with TF32 operands, in 3xTF32: each float32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi) (both
// truncated), and lo*hi + hi*lo + hi*hi are summed in float32 (CUTLASS's
// OpMultiplyAddFastF32), which keeps float32 accuracy (plain TF32 keeps
// about three decimal digits) at three times the TF32 work.  In the long
// sums (O, dK, dV, dQ) each short product (8 deep; 16 in the forward's
// O) goes into a fresh accumulator that a float32 add then folds into
// the running sum: the tensor cores truncate as they accumulate, and
// over the thousands of steps of a dK sum that drift broke the 2e-5
// checks; S and dP, only D deep, accumulate in place.  Tiles sit in
// shared memory with a row stride of 4 mod 32 words, so every fragment
// load hits 32 distinct banks, and the tile a block streams is
// double-buffered by cp.async.
//
// Forward design.  The TPU grid (B, H, S/bq, S/bk) walks KV blocks in
// order and carries m / l / acc in VMEM; here a block of 4 warps owns one
// 64-row q tile of one (h, b), a warp 16 rows and all of O's columns (64
// accumulators a thread at D 128), and loops over 16-key K / V tiles.
// About 68 KB a block at D 128 (Q and two stages of K and V) lets three
// blocks share an SM; O += P V folds 16 keys at a time, which keeps a
// thread within the 168 registers three blocks leave it.
// A warp skips the tiles its mask leaves empty, and evaluates the mask
// per element only on the tiles the causal diagonal, the window's edge or
// the end of the sequence cut.  The softmax runs on the accumulator
// fragments (a row's 16 scores sit in the 4 lanes of a quad), and P leaves
// the accumulator as the A operand of O += P V, its k order permuted
// (0 2 4 6 1 3 5 7) and V's rows loaded to match, so P never goes through
// shared memory.  The q tiles with the most keys are launched first.
//
// Backward design.  A block is 8 warps in 4 pairs, a pair owning 16 rows
// of the block's 64 (keys in dK/dV, queries in dQ).  In dK/dV one warp of
// a pair forms P^T and dV, the other dP^T and dK, P^T passing between
// them through shared memory; in dQ one forms P, the other dP, and each
// adds dS K to half of dQ's columns.  So a warp keeps at most 16 x D
// accumulators in registers (64 a thread at D 128), and 16 warps share an
// SM.  The operand a block streams (16-row Q / dO tiles with their LSE and
// delta for dK/dV, 16-row K / V tiles for dQ) is double-buffered, and
// about 110 KB a block lets two blocks share an SM.  The dK/dV kernel
// forms S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T come out of
// the accumulators already as the A operands of dV += P^T dO and dK +=
// dS^T Q; the dQ kernel does the same for dQ += dS K.  Under the causal
// mask the k tiles with the most queries (dK/dV) and the q tiles with the
// most keys (dQ) are launched first, so the long chains start in the
// first wave.
//
// Bound.  At the training shape (S 4096, D 128) attention does about
// 4 * S / 2 * D operations for each of its 2 * S * D * 2 bytes a head:
// far above the card's ratio of operations to bytes, so it is bound by
// operations: for float32-accurate products, the TF32 peak over three.
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int DMAX = 128;         // largest head_dim
constexpr int FWD_THREADS = 128;  // 4 warps, 16 query rows each
constexpr int FWD_ROWS = 64;      // query rows a forward block owns
constexpr int FWD_STEP = 16;      // keys of the K / V tile streamed per step
constexpr int BWD_THREADS = 256;  // 4 pairs of warps, 16 rows a pair
constexpr int BWD_ROWS = 64;      // keys (dK/dV) or queries (dQ) a block owns
constexpr int BWD_STEP = 16;      // rows of the tile streamed per step

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// reductions over the 4 lanes of a quad (one row of an accumulator tile)
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

// ---------------------------------------------------------------------------
// 3xTF32 products on the tensor cores, shared by the forward and backward
// ---------------------------------------------------------------------------
// x = hi + lo (+ what TF32 cannot hold), as TF32 register operands: the
// tensor cores read a TF32 operand from the top 19 bits of its register
// and ignore the low 13, so x's own bits are hi truncated to TF32, and
// lo = x - (those top bits) is exact and again truncated by the tensor
// cores (CUTLASS's round_toward_zero for both halves): one logical
// operation and one float add; two cvt.rna instructions a value made the
// backward about 1.3x slower on the H100
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// c += a b on one 16 x 8 x 8 tile, TF32 operands, float32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A float32 fragment split into TF32 halves: N registers of a warp's
// m16n8k8 operand (A: N = 4, B: N = 2).
template <int N>
struct Frag {
  unsigned hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float x) {
    split_tf32(x, hi[i], lo[i]);
  }
};

// c += a b in 3xTF32 (CUTLASS's OpMultiplyAddFastF32): the small cross
// terms first, then hi * hi; lo * lo is below float32's last bit
__device__ __forceinline__ void mma3(float (&c)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// acc += a b in 3xTF32 through a fresh accumulator, for the long sums
// (O, dK, dV, dQ over up to 32,768 terms): the tensor cores truncate when
// they add into an accumulator, which drifts over a long sum (2e-4 of a
// dK element's scale seen on the H100), while a float32 add rounds to
// nearest
__device__ __forceinline__ void mma3_add(float (&acc)[4], const Frag<4>& a,
                                         const Frag<2>& b) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(c, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

// Fragments from shared tiles of row stride ld (ld = 4 mod 32, so the 32
// lanes of every load hit 32 banks).  g = lane / 4, t = lane % 4.
// A (16 x 8) = x[r0 .. r0 + 16)[c0 .. c0 + 8), row-major
__device__ __forceinline__ void load_a(Frag<4>& a, const float* x, int ld,
                                       int r0, int c0, int g, int t) {
  const float* p = x + (r0 + g) * ld + c0 + t;
  a.set(0, p[0]);
  a.set(1, p[8 * ld]);
  a.set(2, p[4]);
  a.set(3, p[8 * ld + 4]);
}
// B (8 x 8) = x[n0 .. n0 + 8)[c0 .. c0 + 8)^T: x's rows are B's columns
__device__ __forceinline__ void load_b_t(Frag<2>& b, const float* x, int ld,
                                         int n0, int c0, int g, int t) {
  const float* p = x + (n0 + g) * ld + c0 + t;
  b.set(0, p[0]);
  b.set(1, p[4]);
}
// B (8 x 8) = x[r0 .. r0 + 8)[n0 .. n0 + 8) with its k rows in the order
// 0 2 4 6 1 3 5 7: the order of an A fragment taken from an accumulator
// (a_from_acc), so accumulator columns 2t, 2t + 1 meet rows 2t, 2t + 1
__device__ __forceinline__ void load_b_perm(Frag<2>& b, const float* x,
                                            int ld, int r0, int n0, int g,
                                            int t) {
  const float* p = x + (r0 + 2 * t) * ld + n0 + g;
  b.set(0, p[0]);
  b.set(1, p[ld]);
}
// The accumulator of a 16 x 8 tile (rows g, g + 8; columns 2t, 2t + 1) as
// the A fragment of the next product, its k columns in load_b_perm's order
__device__ __forceinline__ void a_from_acc(Frag<4>& a, const float (&c)[4]) {
  a.set(0, c[0]);
  a.set(1, c[2]);
  a.set(2, c[1]);
  a.set(3, c[3]);
}

// c (16 x 16) = a[r0 .. r0 + 16) b[0 .. 16)^T over the 8 NT columns of
// two tiles of row stride 8 NT + 4: two n tiles of 8.  A sum only 8 NT
// deep, kept in the tensor cores' accumulators, two a tile (even and odd
// k steps) so that consecutive products do not wait on each other
template <int NT>
__device__ __forceinline__ void tile_product_t(float (&c)[2][4],
                                               const float* a,
                                               const float* b, int r0, int g,
                                               int t) {
  constexpr int LD = 8 * NT + 4;
  float c2[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    Frag<4> fa;
    load_a(fa, a, LD, r0, 8 * kk, g, t);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      Frag<2> fb;
      load_b_t(fb, b, LD, 8 * j, 8 * kk, g, t);
      mma3((kk & 1) ? c2[j] : c[j], fa, fb);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += c2[j][e];
}
// acc (16 x 8 NA) += w x[:, 8 n0 .. 8 (n0 + NA)), w (16 x 16) the
// accumulator of a tile_product_t and x (16 x 8 NT) a tile of row stride
// 8 NT + 4
template <int NT, int NA>
__device__ __forceinline__ void tile_accumulate_acc(float (&acc)[NA][4],
                                                    const float (&w)[2][4],
                                                    const float* x, int n0,
                                                    int g, int t) {
  constexpr int LD = 8 * NT + 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    Frag<4> fa;
    a_from_acc(fa, w[j]);
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      Frag<2> fb;
      load_b_perm(fb, x, LD, 8 * j, 8 * (n0 + n), g, t);
      mma3_add(acc[n], fa, fb);
    }
  }
}

// cp.async that writes zeros when `in` is false (rows past S)
__device__ __forceinline__ void cp_async16_zfill(float* smem, const float* g,
                                                 bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(g), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4_zfill(float* smem, const float* g,
                                                bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(g), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Rows [r0, r0 + R) of one head of x (rows `rs` floats apart from `base`)
// into dst (R x ld) by cp.async, 16 bytes a copy when `vec4`, else 4;
// zeros past S.  Columns D .. ld are left alone.  The block's T threads
// take T / R a row, so the copies need no division (dividing each copy's
// index by the row length cost the forward 15% of its time)
template <int R, int T>
__device__ __forceinline__ void stage_rows(float* dst, const float* x,
                                           long long base, long long rs,
                                           int r0, int S, int D, int ld,
                                           bool vec4) {
  static_assert(T % R == 0, "a whole number of threads a row");
  constexpr int TPR = T / R;
  const int r = threadIdx.x / TPR, first = threadIdx.x % TPR;
  const bool in = r0 + r < S;
  const float* src = x + base + (long long)(in ? r0 + r : 0) * rs;
  float* row = dst + r * ld;
  if (vec4) {
    for (int c = 4 * first; c < D; c += 4 * TPR)
      cp_async16_zfill(row + c, src + c, in);
  } else {
    for (int c = first; c < D; c += TPR) cp_async4_zfill(row + c, src + c, in);
  }
}
// n values of a (B, H, S) row statistic from position r0 into dst; 0 past S
__device__ __forceinline__ void stage_stats(float* dst, const float* x,
                                            long long base, int r0, int S,
                                            int n, int first_thread) {
  const int i = threadIdx.x - first_thread;
  if (i >= 0 && i < n) {
    const bool in = r0 + i < S;
    cp_async4_zfill(dst + i, x + base + (in ? r0 + i : 0), in);
  }
}
// zero columns D .. 8 NT of `rows` rows: the padding of head_dim to the
// MMA's k of 8, which no copy writes
__device__ __forceinline__ void zero_pad(float* dst, int rows, int D,
                                         int dp, int ld) {
  const int w = dp - D;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x)
    dst[(i / w) * ld + D + i % w] = 0.f;
}

// ---------------------------------------------------------------------------
// forward: one block per (64-row q tile, h, b), the q tiles with the most
// keys launched first.  The block stages its Q tile, then streams 16-key
// tiles of K and V, double-buffered by cp.async.  Per tile each warp forms
// S = Q K^T for its 16 rows, the online softmax on the accumulators, and
// O += P V with P taken from them as A fragments.
// ---------------------------------------------------------------------------
template <int NT>  // head_dim padded to 8 NT
__global__ void __launch_bounds__(FWD_THREADS, 3) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int S, int H, int KH, int D, int causal,
    int window, float scale, int vec4) {
  constexpr int LD = 8 * NT + 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FWD_ROWS;  // last tile first
  const int kvh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = warp * 16;  // the warp's first query row in the tile
  const int w0 = q0 + qr;    // and its position
  // scores and the running max m in log2 units: P = exp2f(s - m), the
  // accurate exp2f (not an intrinsic), which costs less than expf
  const float scale2 = scale * LOG2E;
  const long long q_ss = (long long)H * D, k_ss = (long long)KH * D;
  const long long q_base = (long long)b * S * q_ss + (long long)h * D;
  const long long k_base = (long long)b * S * k_ss + (long long)kvh * D;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                // FWD_ROWS x LD: Q, later O
  float* st = q_s + FWD_ROWS * LD;  // 2 stages of K, V (STEP x LD)
  constexpr int STAGE = 2 * FWD_STEP * LD;

  if (D < 8 * NT) {
    zero_pad(q_s, FWD_ROWS, D, 8 * NT, LD);
    zero_pad(st, 4 * FWD_STEP, D, 8 * NT, LD);
  }

  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(S, q0 + FWD_ROWS) : S;
  lo = lo / FWD_STEP * FWD_STEP;
  const int steps = max(0, (hi - lo + FWD_STEP - 1) / FWD_STEP);
  auto stage = [&](int i, int buf) {
    const int kt0 = lo + i * FWD_STEP;
    float* k_s = st + buf * STAGE;
    stage_rows<FWD_STEP, FWD_THREADS>(k_s, k, k_base, k_ss, kt0, S, D, LD,
                                      vec4);
    stage_rows<FWD_STEP, FWD_THREADS>(k_s + FWD_STEP * LD, v, k_base, k_ss,
                                      kt0, S, D, LD, vec4);
  };

  stage_rows<FWD_ROWS, FWD_THREADS>(q_s, q, q_base, q_ss, q0, S, D, LD, vec4);
  cp_async_commit();
  if (steps > 0) stage(0, 0);
  cp_async_commit();
  cp_async_wait_one();  // Q has landed
  __syncthreads();

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
    cp_async_wait_one();  // step i's K and V have landed
    __syncthreads();
    const int kt0 = lo + i * FWD_STEP;
    if (kt0 < w_hi && kt0 + FWD_STEP > w_lo) {
      const float* k_s = st + buf * STAGE;
      const float* v_s = k_s + FWD_STEP * LD;
      float c[2][4] = {};  // S: rows g, g + 8; keys 8 j + 2 t, + 1
      tile_product_t<NT>(c, q_s, k_s, qr, g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] *= scale2;
      // the mask cuts this tile: the diagonal, the window's edge or S
      if ((causal && kt0 + FWD_STEP - 1 > w0) ||
          (window > 0 && kt0 <= w0 + 15 - window) || kt0 + FWD_STEP > S) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!attendable(w0 + g + (e >> 1) * 8, kt0 + 8 * j + 2 * t +
                            (e & 1), S, causal, window))
              c[j][e] = NEG_INF;
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mx = quad_max(fmaxf(fmaxf(c[0][2 * r], c[0][2 * r + 1]),
                                        fmaxf(c[1][2 * r], c[1][2 * r + 1])));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = m[r] > NEG_INF / 2 ? exp2f(m[r] - m_new) : 0.f;
        m[r] = m_new;
        l[r] *= alpha[r];  // this lane's part of the row sum
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
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
      // O += P V, each 16-key product folded into acc in float32
      Frag<4> fa[2];
      a_from_acc(fa[0], c[0]);
      a_from_acc(fa[1], c[1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          Frag<2> fb;
          load_b_perm(fb, v_s, LD, 8 * j, 8 * n, g, t);
          mma3(pv, fa[j], fb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += pv[e];
      }
    }
    __syncthreads();  // buffer `buf` is free again
  }

  // O = acc / max(l, 1e-30) into the warp's own rows of q_s, then out in
  // rows, 16 bytes a store when vec4
  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lc[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  float* o_s = q_s + qr * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_s[(g + (e >> 1) * 8) * LD + 8 * n + 2 * t + (e & 1)] =
          acc[n][e] / lc[e >> 1];
  if (t == 0) {  // lse = m + log(l), m back in natural units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + g + 8 * r;
      const float mn = m[r] > NEG_INF / 2 ? m[r] * LN2 : NEG_INF;
      if (row < S) lse[((long long)b * H + h) * S + row] = mn + logf(lc[r]);
    }
  }
  __syncwarp();
  const int w = vec4 ? 4 : 1, per_row = D / w;
  for (int i = lane; i < 16 * per_row; i += 32) {
    const int r = i / per_row, col = (i - r * per_row) * w;
    if (w0 + r >= S) break;
    float* dst = o + q_base + (long long)(w0 + r) * q_ss + col;
    const float* src = o_s + r * LD + col;
    if (vec4)
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    else
      *dst = *src;
  }
}

// ---------------------------------------------------------------------------
// backward: a delta pre-pass, then the dK/dV and dQ kernels
// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) into (B, H, S): one warp per (b, s, h) row
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(
    const float* __restrict__ o, const float* __restrict__ dout,
    float* __restrict__ delta, int S, int H, int D, long long rows) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* po = o + r * D;
  const float* pd = dout + r * D;
  float part = 0.f;
  for (int d = lane; d < D; d += 32) part += pd[d] * po[d];
  part = warp_sum(part);
  if (lane == 0) {
    const long long b = r / ((long long)S * H);
    const int rem = (int)(r - b * S * H), s = rem / H, h = rem - s * H;
    delta[(b * H + h) * S + s] = part;
  }
}

// dK and dV: one block per (kv head, b, k tile), the k tiles with the most
// queries launched first.  The block's 8 warps form 4 pairs, a pair owning
// 16 keys; the block streams 16-query tiles of Q and dO (with their LSE and
// delta) of each of the G heads, double-buffered by cp.async.  Per tile
// the pair's first warp forms S^T = K Q^T, P^T = exp(S^T scale - LSE) and
// dV += P^T dO; its second forms dP^T = V dO^T, takes P^T from the first
// through shared memory, and forms dS^T = P^T (dP^T - delta) and
// dK += dS^T Q.  P^T and dS^T come out of the accumulators already as the
// A operands of the second products.
template <int NT>  // head_dim padded to 8 NT
__global__ void __launch_bounds__(BWD_THREADS, 2) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KH,
    int D, int causal, int window, float scale, int vec4) {
  constexpr int LD = 8 * NT + 4;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BWD_ROWS;  // tile 0 has the longest chain
  const int G = H / KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp & 3, role = warp >> 2;  // role 0: dV, 1: dK
  const int kr = pair * 16;  // the pair's first key row in the tile
  const long long q_ss = (long long)H * D, k_ss = (long long)KH * D;
  const long long k_base = (long long)b * S * k_ss + (long long)kvh * D;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                   // BWD_ROWS x LD
  float* v_s = k_s + BWD_ROWS * LD;    // BWD_ROWS x LD
  float* x_s = v_s + BWD_ROWS * LD;    // P^T of each pair: 4 x 32 x 8
  float* st = x_s + 4 * 32 * 8;        // 2 stages of:
  constexpr int STAGE = 2 * BWD_STEP * LD + 2 * BWD_STEP;
  // q (STEP x LD), dO (STEP x LD), lse (STEP), delta (STEP)

  if (D < 8 * NT) {
    zero_pad(k_s, 2 * BWD_ROWS, D, 8 * NT, LD);
    for (int s = 0; s < 2; ++s) zero_pad(st + s * STAGE, 2 * BWD_STEP, D,
                                         8 * NT, LD);
  }

  int lo = causal ? k0 : 0;
  const int hi = window > 0 ? min(S, k0 + BWD_ROWS - 1 + window) : S;
  lo = lo / BWD_STEP * BWD_STEP;
  const int per_head = max(0, (hi - lo + BWD_STEP - 1) / BWD_STEP);
  const int steps = G * per_head;

  auto stage = [&](int i, int buf) {
    const int h = kvh * G + i / per_head;
    const int q0 = lo + (i % per_head) * BWD_STEP;
    const long long q_base = (long long)b * S * q_ss + (long long)h * D;
    const long long s_base = ((long long)b * H + h) * S;
    float* q_s = st + buf * STAGE;
    float* do_s = q_s + BWD_STEP * LD;
    float* l_s = do_s + BWD_STEP * LD;
    stage_rows<BWD_STEP, BWD_THREADS>(q_s, q, q_base, q_ss, q0, S, D, LD,
                                      vec4);
    stage_rows<BWD_STEP, BWD_THREADS>(do_s, dout, q_base, q_ss, q0, S, D, LD,
                                      vec4);
    stage_stats(l_s, lse, s_base, q0, S, BWD_STEP, 0);
    stage_stats(l_s + BWD_STEP, delta, s_base, q0, S, BWD_STEP, 32);
  };

  float acc[NT][4];  // dV (role 0) or dK (role 1): 16 keys x 8 NT
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (steps > 0) {
    stage_rows<BWD_ROWS, BWD_THREADS>(k_s, k, k_base, k_ss, k0, S, D, LD, vec4);
    stage_rows<BWD_ROWS, BWD_THREADS>(v_s, v, k_base, k_ss, k0, S, D, LD, vec4);
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

    const float* q_s = st + buf * STAGE;
    const float* do_s = q_s + BWD_STEP * LD;
    const float* l_s = do_s + BWD_STEP * LD;
    const int q0 = lo + (i % per_head) * BWD_STEP;

    // S^T (role 0) or dP^T (role 1), 16 keys x 16 queries
    float c[2][4] = {};
    if (role == 0)
      tile_product_t<NT>(c, k_s, q_s, kr, g, t);
    else
      tile_product_t<NT>(c, v_s, do_s, kr, g, t);
    if (role == 0) {  // P^T = exp(S^T scale - lse), 0 off the mask
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kr + g + (e >> 1) * 8;
          const int qi = 8 * j + 2 * t + (e & 1);
          const bool ok = attendable(q0 + qi, key, S, causal, window);
          c[j][e] = ok ? expf(c[j][e] * scale - l_s[qi]) : 0.f;
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
          c[j][e] = x[4 * j + e] * (c[j][e] - l_s[BWD_STEP + qi]);
        }
    }
    // dV += P^T dO (role 0), dK += dS^T Q (role 1): k = the 16 queries
    tile_accumulate_acc<NT, NT>(acc, c, role == 0 ? do_s : q_s, 0, g, t);
    __syncthreads();  // buffer `buf` and x_s are free again
  }

  float* out = role == 0 ? dv : dk;
  const float f = role == 0 ? 1.f : scale;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = k0 + kr + g + (e >> 1) * 8;
    if (row >= S) continue;
    const long long off = k_base + (long long)row * k_ss;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = 8 * n + 2 * t + (e & 1);
      if (d < D) out[off + d] = acc[n][e] * f;
    }
  }
}

// dQ: one block per (h, b, q tile), the q tiles with the most keys
// launched first.  The block's 8 warps form 4 pairs, a pair owning 16
// queries; the block streams 16-key tiles of K and V, double-buffered by
// cp.async.  Per tile the pair's first warp recomputes S = Q K^T and P,
// its second dP = dO V^T; they swap them through shared memory, both form
// dS = P (dP - delta), and each adds dS K to its half of dQ's columns, dS
// taken from the accumulator as an A fragment.
template <int NT>
__global__ void __launch_bounds__(BWD_THREADS, 2) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ dout,
    float* __restrict__ dq, int S, int H, int KH, int D, int causal,
    int window, float scale, int vec4) {
  constexpr int LD = 8 * NT + 4;
  constexpr int HALF = NT / 2;  // n tiles of dQ a warp accumulates
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

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // BWD_ROWS x LD
  float* do_s = q_s + BWD_ROWS * LD;    // BWD_ROWS x LD
  float* l_s = do_s + BWD_ROWS * LD;    // lse (BWD_ROWS), delta (BWD_ROWS)
  float* x_s = l_s + 2 * BWD_ROWS;      // P, dP of each pair: 2 x 4 x 32 x 8
  float* st = x_s + 2 * 4 * 32 * 8;     // 2 stages of K, V (STEP x LD)
  constexpr int STAGE = 2 * BWD_STEP * LD;

  if (D < 8 * NT) {
    zero_pad(q_s, 2 * BWD_ROWS, D, 8 * NT, LD);
    zero_pad(st, 4 * BWD_STEP, D, 8 * NT, LD);
  }

  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(S, q0 + BWD_ROWS) : S;
  lo = lo / BWD_STEP * BWD_STEP;
  const int steps = max(0, (hi - lo + BWD_STEP - 1) / BWD_STEP);
  auto stage = [&](int i, int buf) {
    const int kt0 = lo + i * BWD_STEP;
    float* k_s = st + buf * STAGE;
    stage_rows<BWD_STEP, BWD_THREADS>(k_s, k, k_base, k_ss, kt0, S, D, LD,
                                      vec4);
    stage_rows<BWD_STEP, BWD_THREADS>(k_s + BWD_STEP * LD, v, k_base, k_ss,
                                      kt0, S, D, LD, vec4);
  };

  float acc[HALF][4];  // dQ, columns [8 HALF role, 8 HALF (role + 1))
#pragma unroll
  for (int n = 0; n < HALF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (steps > 0) {
    stage_rows<BWD_ROWS, BWD_THREADS>(q_s, q, q_base, q_ss, q0, S, D, LD, vec4);
    stage_rows<BWD_ROWS, BWD_THREADS>(do_s, dout, q_base, q_ss, q0, S, D, LD,
                                      vec4);
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

    const float* k_s = st + buf * STAGE;
    const float* v_s = k_s + BWD_STEP * LD;
    const int kt0 = lo + i * BWD_STEP;

    // S (role 0) or dP (role 1), 16 queries x 16 keys
    float c[2][4] = {};
    if (role == 0)
      tile_product_t<NT>(c, q_s, k_s, qr, g, t);
    else
      tile_product_t<NT>(c, do_s, v_s, qr, g, t);
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
    tile_accumulate_acc<NT, HALF>(acc, c, k_s, HALF * role, g, t);
    __syncthreads();  // buffer `buf` and x_s are free again
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = q0 + qr + g + (e >> 1) * 8;
    if (row >= S) continue;
    const long long off = q_base + (long long)row * q_ss;
#pragma unroll
    for (int n = 0; n < HALF; ++n) {
      const int d = 8 * (HALF * role + n) + 2 * t + (e & 1);
      if (d < D) dq[off + d] = acc[n][e] * scale;
    }
  }
}

// Dynamic shared memory of each kernel, in bytes.
template <int NT>
size_t fwd_smem() {
  const int ld = 8 * NT + 4;
  return sizeof(float) * (FWD_ROWS * ld + 2 * 2 * FWD_STEP * ld);
}
template <int NT>
size_t dkdv_smem() {
  const int ld = 8 * NT + 4;
  return sizeof(float) * (2 * BWD_ROWS * ld + 4 * 32 * 8 +
                          2 * (2 * BWD_STEP * ld + 2 * BWD_STEP));
}
template <int NT>
size_t dq_smem() {
  const int ld = 8 * NT + 4;
  return sizeof(float) * (2 * BWD_ROWS * ld + 2 * BWD_ROWS + 2 * 4 * 32 * 8 +
                          2 * 2 * BWD_STEP * ld);
}

// Above 48 KB a kernel must opt in; past the card's limit this fails and
// the error goes back to the wrapper.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// 16-byte copies need head_dim and every row start 16-byte aligned
bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <int NT>
cudaError_t launch_fwd_tiles(const float* q, const float* k, const float* v,
                             float* o, float* lse, int B, int S, int H,
                             int KH, int D, int causal, int window,
                             float scale, int vec4, cudaStream_t stream) {
  const size_t smem = fwd_smem<NT>();
  cudaError_t err = allow_smem(flash_fwd_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + FWD_ROWS - 1) / FWD_ROWS;
  flash_fwd_kernel<NT><<<dim3(H, B, tiles), FWD_THREADS, smem, stream>>>(
      q, k, v, o, lse, S, H, KH, D, causal, window, scale, vec4);
  return cudaGetLastError();
}

cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, float* lse, int B, int S, int H, int KH,
                       int D, int causal, int window, float scale,
                       cudaStream_t stream) {
  const int vec4 = D % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(o);
  if (D <= 32)
    return launch_fwd_tiles<4>(q, k, v, o, lse, B, S, H, KH, D, causal,
                               window, scale, vec4, stream);
  if (D <= 64)
    return launch_fwd_tiles<8>(q, k, v, o, lse, B, S, H, KH, D, causal,
                               window, scale, vec4, stream);
  return launch_fwd_tiles<16>(q, k, v, o, lse, B, S, H, KH, D, causal,
                              window, scale, vec4, stream);
}

template <int NT>
cudaError_t launch_bwd_tiles(const float* q, const float* k, const float* v,
                             const float* lse, const float* delta,
                             const float* dout, float* dq, float* dk,
                             float* dv, int B, int S, int H, int KH, int D,
                             int causal, int window, float scale, int vec4,
                             cudaStream_t stream) {
  const size_t smem_kv = dkdv_smem<NT>(), smem_q = dq_smem<NT>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<NT>, smem_kv);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_kernel<NT>, smem_q);
  if (err != cudaSuccess) return err;
  const int tiles = (S + BWD_ROWS - 1) / BWD_ROWS;
  flash_bwd_dkdv_kernel<NT><<<dim3(KH, B, tiles), BWD_THREADS, smem_kv,
                              stream>>>(q, k, v, lse, delta, dout, dk, dv, S,
                                        H, KH, D, causal, window, scale,
                                        vec4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<NT><<<dim3(H, B, tiles), BWD_THREADS, smem_q,
                            stream>>>(q, k, v, lse, delta, dout, dq, S, H, KH,
                                      D, causal, window, scale, vec4);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                       const float* o, const float* lse, const float* dout,
                       float* dq, float* dk, float* dv, float* delta, int B,
                       int S, int H, int KH, int D, int causal, int window,
                       float scale, cudaStream_t stream) {
  const long long rows = (long long)B * S * H;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      o, dout, delta, S, H, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int vec4 = D % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(dout);
  if (D <= 32)
    return launch_bwd_tiles<4>(q, k, v, lse, delta, dout, dq, dk, dv, B, S,
                               H, KH, D, causal, window, scale, vec4, stream);
  if (D <= 64)
    return launch_bwd_tiles<8>(q, k, v, lse, delta, dout, dq, dk, dv, B, S,
                               H, KH, D, causal, window, scale, vec4, stream);
  return launch_bwd_tiles<16>(q, k, v, lse, delta, dout, dq, dk, dv, B, S, H,
                              KH, D, causal, window, scale, vec4, stream);
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
// Every tensor is contiguous float32: q, o, dout, dq (B, S, H, D); k, v,
// dk, dv (B, S, KH, D); lse (B, H, S).  dtype must be 0 (float32; the
// bf16 route is flash_attention_sm90.cu).  causal: 0 or 1; window: 0 =
// none.  Return cudaGetLastError() (or the error that stopped the
// launch).
int flash_attention_fwd_launch(int device, const void* q, const void* k,
                               const void* v, void* o, void* lse, int B,
                               int S, int H, int KH, int D, int causal,
                               int window, float scale, int dtype,
                               void* stream) {
  if (bad_shape(B, S, H, KH, D) || dtype != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return on_device(device, [&]() {
    return launch_fwd(f(q), f(k), f(v), static_cast<float*>(o),
                      static_cast<float*>(lse), B, S, H, KH, D, causal,
                      window, scale, s);
  });
}

int flash_attention_bwd_launch(int device, const void* q, const void* k,
                               const void* v, const void* o, const void* lse,
                               const void* dout, void* dq, void* dk,
                               void* dv, void* delta, int B, int S, int H,
                               int KH, int D, int causal, int window,
                               float scale, int dtype, void* stream) {
  if (bad_shape(B, S, H, KH, D) || dtype != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return on_device(device, [&]() {
    return launch_bwd(f(q), f(k), f(v), f(o), f(lse), f(dout),
                      static_cast<float*>(dq), static_cast<float*>(dk),
                      static_cast<float*>(dv), static_cast<float*>(delta), B,
                      S, H, KH, D, causal, window, scale, s);
  });
}

// The design of the forward's and backward's products, for the record.
const char* flash_attention_fwd_design() {
  return "3xTF32 mma.sync m16n8k8 (hi*hi + hi*lo + lo*hi, truncated "
         "halves); O summed in float32 one 16-key step at a time";
}

const char* flash_attention_bwd_design() {
  return "3xTF32 mma.sync m16n8k8 (hi*hi + hi*lo + lo*hi, truncated "
         "halves); dK, dV, dQ summed in float32 one k step at a time";
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
