// Flash attention in bf16 at head_dim 192 and 256, forward and backward,
// for Hopper (sm_90a): TMA tile loads through mbarrier rings, wgmma
// products on the tensor cores, warp-specialised blocks.  Hand-written
// CUDA C++ with PTX inline: the "d192" and "d256" routes of
// kernels/flash_attention.py, one template on D instantiated at both.
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `flash_attention_pallas` (src/repro/kernels/flash_attention.py:28-69)
// for bf16 with head_dim 256 (gemma3-1b) and 192 (deepseek-v2's MLA:
// 128 + 64 query / key columns, v padded from 128): GQA self-attention
// (query head h reads kv head h / G) over q (B, S, H, D) and k/v (B, S,
// KH, D), causal and/or sliding-window masked, online softmax in float32,
// p rounded to bf16 after the tile's running max before the PV product, 0
// for a row with no attendable key, and LSE = m + log(l) (B, H, S)
// float32 out.  Its backward replaces XLA's autodiff of
// `blockwise_attention` (src/repro/models/attention.py) in the JAX
// package.  Head dims 64 and 128 go to flash_attention_sm90.cu, float32
// to flash_attention.cu; both Hopper files share sm90_common.cuh (TMA,
// mbarrier, wgmma descriptors and products, setmaxnreg, masks, the delta
// pre-pass, tensor maps).
//
// Bound.  At gemma3's training shape (B 2, S 4096, 4 / 1 heads, causal,
// 22 of 26 layers with a 512-key window) and deepseek-v2's (B 1, S 4096,
// 128 / 128 heads of 192, causal) attention does 4 D operations per
// attended (query, key) pair and head forward (10 D backward) for 4 D
// bytes of q and o a row: far above the H100's 295 operations a byte, so
// it is bound by the tensor cores' 989 TFLOP/s (bf16).
//
// Design.  A row of D bf16 is D / 64 panels of 128 bytes (3 or 4), each
// loaded by TMA with the 128-byte swizzle and zeros past S.  A block is
// one producer warpgroup (registers dropped to 24) and two consumer
// warpgroups (240 registers) that keep their float32 accumulators in
// registers for the whole loop; every tile is 64 rows, staged in 2-deep
// full / empty mbarrier rings.  A 64 x D float32 accumulator is D / 2
// registers a thread (128 at D 256), so a warpgroup holds one of them:
// products of N = D run as wgmma of 128 columns (two panels) and, at D
// 192, one of 64.  S-type products (K = D) are 12 or 16 wgmma k steps
// from shared memory; products with P or dS take them from registers
// (the float32 fragment of one product is the bf16 A fragment of the
// next) and read the other operand MN-major through the transpose bit.
//   fwd:   one block per (128-row q tile, h, b), the q tiles with the
//          most keys first; each consumer owns 64 query rows and O; 64-key
//          K / V stages from the window's first tile; a consumer skips a
//          tile none of its rows reaches; the mask is evaluated only on
//          diagonal, window-edge and ragged tiles.  Shared memory 768 D
//          bytes: 192 KB at D 256, 144 KB at 192.
//   delta: delta = rowsum(dO * O) and LSE * log2(e), (B, H, S padded).
//   dK/dV: one block per (64-key tile, kv head, split, b), the tiles with
//          the most queries first.  The two consumers split the work by
//          product: one forms S^T = K Q^T and P^T and adds P^T dO to dV,
//          the other forms dP^T = V dO^T, dS^T = P^T (dP^T - delta) with
//          P^T handed over through a 16 KB float32 tile, and adds dS^T Q
//          to dK.  Q / dO / stats stages of 64 query rows of one head.
//          Where the longest block's steps are more than twice an SM's
//          share of all of them (gemma3's causal global layer: 128 blocks
//          on 132 SMs, the first walking 256 steps), the wrapper splits
//          each block's (head, query tile) steps into `splits` contiguous
//          chunks (kernels/flash_attention.py:d256_bwd_plan), each writing
//          float32 partial dK / dV, and a reduction pass sums them in
//          split order and casts to bf16.  210 KB at D 256.
//   dQ:    the tiles with the most keys first, 64-key K / V stages.  At D
//          192 one block per (128-row q tile, h, b): each consumer owns 64
//          rows and forms S, P, dP, dS and all of dQ (96 + 32 + 32 + 16
//          registers), as the sm90 kernel; 192 KB.  At D 256, where that
//          leaves no room (128 registers of dQ, and 256 KB of Q, dO and
//          K / V stages), one block per (64-row q tile, h, b): one consumer
//          forms S and P, the other dP; dP goes to the first through a
//          float32 tile, dS comes back as its bf16 fragment, and each adds
//          dS K to two of dQ's four panels.  217 KB.
// Hand-overs between the consumers go through mbarriers, whose waits trap
// after about 10 s, so a lost arrival fails the launch instead of hanging
// the card.  Nothing is accumulated across blocks by atomics and every sum
// has a fixed order: deterministic.  The backward runs 7 tile products
// where the bound counts 5 (dQ recomputes S and dP); the single-pass form
// needs dQ atomics and is later work.
#include "sm90_common.cuh"

namespace {

constexpr int TILE = 64;   // rows of every tile: queries or keys
// q rows of a dQ block: 128 where a consumer can hold S, dP and all of dQ
// for 64 rows and the block's tiles fit (D 192), else 64 (D 256)
template <int D> constexpr int DQ_ROWS = D == 192 ? 2 * TILE : TILE;

// N accumulators of `a` from element `off`, as an array of their own
template <int N, int M>
__device__ __forceinline__ auto part(float (&a)[M], int off) -> float (&)[N] {
  return *reinterpret_cast<float(*)[N]>(a + off);
}

// s (64 x 64) = rows [r0, r0 + 64) of `a` (K-major, `rows` rows) times the
// 64 rows of `b` (K-major) transposed, over D: D / 16 wgmma k steps
template <int D>
__device__ __forceinline__ void mma_scores(float (&s)[32], const bf16* a,
                                           int rows, int r0, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, desc_k(a, rows, r0, kk), desc_k(b, TILE, 0, kk), kk > 0);
}

// acc (64 x 64 NP) += a (registers: a 64 x 64 bf16 fragment) times panels
// [p0, p0 + NP) of a 64-row tile read MN-major: 128 columns a wgmma, and
// 64 for an odd NP
template <int NP>
__device__ __forceinline__ void mma_panels(float (&acc)[32 * NP],
                                           const uint32_t (&a)[16],
                                           const bf16* tile, int p0) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < NP / 2; ++c)
      wgmma_rs(part<64>(acc, 64 * c), &a[4 * kk],
               desc_mn(tile + (p0 + 2 * c) * TILE * PANEL, TILE, kk));
    if constexpr (NP % 2 == 1)
      wgmma_rs(part<32>(acc, 64 * (NP / 2)), &a[4 * kk],
               desc_mn(tile + (p0 + NP - 1) * TILE * PANEL, TILE, kk));
  }
}

// Rows r_lo, r_lo + 8 of a 64 x D float32 fragment as float32 into rows
// of a (B, S, heads, D) tensor at `base` (a partial dK or dV)
template <int D>
__device__ __forceinline__ void store_rows_f32(float* out,
                                               const float (&acc)[D / 2],
                                               long long base,
                                               long long row_ss, int r_lo,
                                               int S, int lane) {
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int row = r_lo + 8 * frag_half(j);
    if (row < S)
      *reinterpret_cast<float2*>(out + base + row * row_ss +
                                 frag_col(j, lane)) =
          make_float2(acc[j], acc[j + 1]);
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* bars, int n,
                                              const int* counts) {
  for (int i = 0; i < n; ++i) mbar_init(&bars[i], counts[i]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// forward: one block per (128-row q tile, h, b)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
               float* __restrict__ lse, int S, int H, int KH, int causal,
               int window, float scale) {
  constexpr int BQ = 2 * TILE, QT = BQ * D, KT = TILE * D;
  bf16* q_s = smem_base();
  bf16* kv_s = q_s + QT;  // stage st: K at kv_s + 2 st KT, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + 2 * STAGES * KT);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // last tile first
  const int kvh = h / (H / KH);
  int lo;
  const int n = key_tiles(q0, BQ, TILE, S, causal, window, lo);

  if (threadIdx.x == 0) {
    const int counts[7] = {1, 1, 1, 1, 1, 256, 256};
    init_barriers(q_full, 7, counts);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, QT * 2);
      tma_tile<D>(q_s, &tq, q_full, h, q0, b, BQ);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES, k0 = lo + it * TILE;
        if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        bf16* ks = kv_s + 2 * st * KT;
        mbar_expect_tx(&k_full[st], KT * 2);
        tma_tile<D>(ks, &tk, &k_full[st], kvh, k0, b, TILE);
        mbar_expect_tx(&v_full[st], KT * 2);
        tma_tile<D>(ks + KT, &tv, &v_full[st], kvh, k0, b, TILE);
      }
    }
  } else {  // consumers: rows qw0 .. qw0 + 63
    regs_inc<240>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    const int qw0 = q0 + TILE * cw;
    const int r_lo = qw0 + 16 * (t / 32) + lane / 4;  // and r_lo + 8
    // keys [w_lo, w_hi) reach one of this warpgroup's rows
    const int w_lo = window > 0 ? qw0 - window + 1 : 0;
    const int w_hi = causal ? min(S, qw0 + TILE) : S;
    const float sl2 = scale * LOG2E;
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int it = 0; it < n; ++it) {
      const int st = it % STAGES, k0 = lo + it * TILE;
      const uint32_t par = (it / STAGES) & 1;
      const bf16* ks = kv_s + 2 * st * KT;
      const bf16* vs = ks + KT;
      mbar_wait(&k_full[st], par);
      if (k0 >= w_hi || k0 + TILE <= w_lo) {  // no row of ours reaches it
        mbar_wait(&v_full[st], par);
        mbar_arrive(&empty[st]);
        continue;
      }

      float s[32];
      wgmma_fence();
      mma_scores<D>(s, q_s, BQ, TILE * cw, ks);
      wgmma_commit();
      wgmma_wait(s);

      const bool mask = needs_mask(qw0, TILE, k0, TILE, S, causal, window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = s[j] * sl2;
        if (mask && !attendable(r_lo + 8 * frag_half(j),
                                k0 + frag_col(j, lane), S, causal, window))
          x = -INFINITY;
        s[j] = x;
        mx[frag_half(j)] = fmaxf(mx[frag_half(j)], x);
      }
      float mu[2], alpha[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float m_new = fmaxf(m[hf], quad_max(mx[hf]));
        mu[hf] = m_new == -INFINITY ? 0.f : m_new;
        alpha[hf] = exp2f(m[hf] - mu[hf]);
        m[hf] = m_new;
        l[hf] *= alpha[hf];
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p = exp2f(s[j] - mu[frag_half(j)]);
        l[frag_half(j)] += p;
        s[j] = p;
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[frag_half(j)];
      uint32_t pa[16];
      to_a_frag(s, pa);

      mbar_wait(&v_full[st], par);
      wgmma_fence();
      mma_panels<D / 64>(acc, pa, vs, 0);
      wgmma_commit();
      wgmma_wait(acc);
      mbar_arrive(&empty[st]);
    }

    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float lc = fmaxf(quad_sum(l[hf]), 1e-30f);
      inv[hf] = 1.f / lc;
      const int row = r_lo + 8 * hf;
      if (row < S && lane % 4 == 0)
        lse[((long long)b * H + h) * S + row] =
            (m[hf] == -INFINITY ? NEG_INF : m[hf] / LOG2E) + logf(lc);
    }
    store_rows<D>(o, acc, ((long long)b * S * H + h) * D, (long long)H * D,
                  r_lo, S, lane, inv);
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV: one block per (64-key tile, kv head, split, b)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ delta,
                const float* __restrict__ lse2, bf16* __restrict__ dk,
                bf16* __restrict__ dv, float* __restrict__ part, int S,
                int Spad, int H, int KH, int splits, int causal, int window,
                float scale) {
  constexpr int T = TILE * D;
  bf16* k_s = smem_base();
  bf16* v_s = k_s + T;
  bf16* qd_s = v_s + T;  // stage st: Q at qd_s + 2 st T, dO after it
  float* p_x = reinterpret_cast<float*>(qd_s + 2 * STAGES * T);  // P^T
  float* stats = p_x + 32 * 128;  // stage st: lse2 of its rows, then delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + 2 * STAGES * TILE);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* x_full = empty + STAGES;  // P^T written
  uint64_t* x_empty = x_full + 1;     // P^T read

  const int kvh = blockIdx.x / splits, c = blockIdx.x % splits;
  const int b = blockIdx.y, k0 = blockIdx.z * TILE;
  const int G = H / KH;
  int lo;
  const int nq = query_tiles(k0, TILE, TILE, S, causal, window, lo);
  // this split's chunk [it0, it1) of the G x nq (head, q tile) steps
  const int n = G * nq, per = (n + splits - 1) / splits;
  const int it0 = min(n, c * per), it1 = min(n, it0 + per);

  if (threadIdx.x == 0) {
    const int counts[7] = {1, 1, 1, 256, 256, 128, 128};
    init_barriers(kv_full, 7, counts);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0 && it1 > it0) {
      mbar_expect_tx(kv_full, 2 * T * 2);
      tma_tile<D>(k_s, &tk, kv_full, kvh, k0, b, TILE);
      tma_tile<D>(v_s, &tv, kv_full, kvh, k0, b, TILE);
      for (int it = it0; it < it1; ++it) {
        const int i = it - it0, st = i % STAGES, h = kvh * G + it / nq;
        const int q0 = lo + (it % nq) * TILE;
        if (i >= STAGES) mbar_wait(&empty[st], (i / STAGES - 1) & 1);
        bf16* qs = qd_s + 2 * st * T;
        float* sts = stats + 2 * st * TILE;
        const long long srow = ((long long)b * H + h) * Spad + q0;
        mbar_expect_tx(&full[st], 2 * T * 2 + 2 * TILE * 4);
        tma_tile<D>(qs, &tq, &full[st], h, q0, b, TILE);
        tma_tile<D>(qs + T, &tdo, &full[st], h, q0, b, TILE);
        bulk_load(sts, lse2 + srow, TILE * 4, &full[st]);
        bulk_load(sts + TILE, delta + srow, TILE * 4, &full[st]);
      }
    }
  } else {  // consumers: keys k0 .. k0 + 63; cw 0 holds dV, cw 1 dK
    regs_inc<240>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    const int r_lo = k0 + 16 * (t / 32) + lane / 4;  // and r_lo + 8
    const float sl2 = scale * LOG2E;
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

    if (it1 > it0) mbar_wait(kv_full, 0);
    for (int it = it0; it < it1; ++it) {
      const int i = it - it0, st = i % STAGES;
      const int q0 = lo + (it % nq) * TILE;
      const bf16* qs = qd_s + 2 * st * T;
      const bf16* dos = qs + T;
      const float* l2s = stats + 2 * st * TILE;
      const float* dls = l2s + TILE;

      float x[32];  // cw 0: S^T = K Q^T, then P^T; cw 1: dP^T = V dO^T
      mbar_wait(&full[st], (i / STAGES) & 1);
      wgmma_fence();
      mma_scores<D>(x, cw == 0 ? k_s : v_s, TILE, 0, cw == 0 ? qs : dos);
      wgmma_commit();
      wgmma_wait(x);

      if (cw == 0) {
        const bool mask = needs_mask(q0, TILE, k0, TILE, S, causal, window);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = frag_col(j, lane);
          float p = exp2f(x[j] * sl2 - l2s[col]);
          if (mask && !attendable(q0 + col, r_lo + 8 * frag_half(j), S,
                                  causal, window))
            p = 0.f;
          x[j] = p;
        }
        if (i > 0) mbar_wait(x_empty, (i - 1) & 1);
#pragma unroll
        for (int j = 0; j < 32; ++j) p_x[j * 128 + t] = x[j];
        mbar_arrive(x_full);
      } else {  // dS^T = P^T (dP^T - delta)
        mbar_wait(x_full, i & 1);
#pragma unroll
        for (int j = 0; j < 32; ++j)
          x[j] = p_x[j * 128 + t] * (x[j] - dls[frag_col(j, lane)]);
        mbar_arrive(x_empty);
      }
      uint32_t a[16];
      to_a_frag(x, a);
      wgmma_fence();  // dV += P^T dO (cw 0), dK += dS^T Q (cw 1)
      mma_panels<D / 64>(acc, a, cw == 0 ? dos : qs, 0);
      wgmma_commit();
      wgmma_wait(acc);
      mbar_arrive(&empty[st]);
    }

    const long long row_ss = (long long)KH * D;
    if (splits == 1) {
      const long long base = ((long long)b * S * KH + kvh) * D;
      const float f = cw == 0 ? 1.f : scale, mul[2] = {f, f};
      store_rows<D>(cw == 0 ? dv : dk, acc, base, row_ss, r_lo, S, lane,
                    mul);
    } else {  // partials (2, splits, B, S, KH, D): dK first, then dV
      const long long base =
          ((((long long)(1 - cw) * splits + c) * gridDim.y + b) * S * KH +
           kvh) * D;
      store_rows_f32<D>(part, acc, base, row_ss, r_lo, S, lane);
    }
  }
}

// dK = scale x (the sum of the dK partials over the splits, in split
// order), dV = the sum of the dV partials, cast to bf16; four elements a
// thread, `n4` = B S KH D / 4
__global__ void dkdv_reduce_kernel(const float4* __restrict__ part,
                                   bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, long long n4,
                                   int splits, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 sk = part[i], sv = part[(long long)splits * n4 + i];
  for (int c = 1; c < splits; ++c) {
    const float4 xk = part[c * n4 + i];
    const float4 xv = part[(splits + c) * n4 + i];
    sk.x += xk.x; sk.y += xk.y; sk.z += xk.z; sk.w += xk.w;
    sv.x += xv.x; sv.y += xv.y; sv.z += xv.z; sv.w += xv.w;
  }
  *reinterpret_cast<uint2*>(dk + 4 * i) =
      make_uint2(pack_bf16(sk.x * scale, sk.y * scale),
                 pack_bf16(sk.z * scale, sk.w * scale));
  *reinterpret_cast<uint2*>(dv + 4 * i) =
      make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
}

// ---------------------------------------------------------------------------
// backward, dQ: one block per (128-row q tile, h, b) at D 192, per
// (64-row q tile, h, b) at D 256
// ---------------------------------------------------------------------------
// Consumer ROLE 0 forms S and P, takes dP, forms dS and hands it over;
// ROLE 1 forms dP and takes dS.  Each adds dS K to dQ's panels
// [p0, p0 + NP): ROLE 0 the first D / 128, ROLE 1 the rest.
template <int D, int ROLE>
__device__ __forceinline__ void dq_consumer(
    const bf16* q_s, const bf16* do_s, const bf16* kv_s, float* dp_x,
    uint32_t* ds_x, uint64_t* q_full, uint64_t* full, uint64_t* empty,
    uint64_t* bars, const float* __restrict__ delta,
    const float* __restrict__ lse2, bf16* __restrict__ dq, int n, int lo,
    int q0, int h, int b, int S, int Spad, int H, int causal, int window,
    float scale) {
  constexpr int T = TILE * D;
  constexpr int P0 = ROLE == 0 ? 0 : D / 128;
  constexpr int NP = ROLE == 0 ? D / 128 : D / 64 - D / 128;
  uint64_t* dp_full = bars;      // dP written
  uint64_t* dp_empty = bars + 1; // dP read
  uint64_t* ds_full = bars + 2;  // dS written
  uint64_t* ds_empty = bars + 3; // dS read
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r_lo = q0 + 16 * (t / 32) + lane / 4;  // and r_lo + 8
  const float sl2 = scale * LOG2E;
  float l2r[2] = {0.f, 0.f}, dlr[2] = {0.f, 0.f};
  if (ROLE == 0) {
    const long long srow = ((long long)b * H + h) * Spad;
    l2r[0] = lse2[srow + r_lo];
    l2r[1] = lse2[srow + r_lo + 8];
    dlr[0] = delta[srow + r_lo];
    dlr[1] = delta[srow + r_lo + 8];
  }
  float acc[32 * NP];
#pragma unroll
  for (int j = 0; j < 32 * NP; ++j) acc[j] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES, k0 = lo + it * TILE;
    const bf16* ks = kv_s + 2 * st * T;
    const bf16* vs = ks + T;

    float x[32];  // ROLE 0: S = Q K^T, then P, then dS; ROLE 1: dP = dO V^T
    mbar_wait(&full[st], (it / STAGES) & 1);
    wgmma_fence();
    mma_scores<D>(x, ROLE == 0 ? q_s : do_s, TILE, 0, ROLE == 0 ? ks : vs);
    wgmma_commit();
    wgmma_wait(x);

    uint32_t a[16];
    if (ROLE == 0) {
      const bool mask = needs_mask(q0, TILE, k0, TILE, S, causal, window);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int hf = frag_half(j);
        float p = exp2f(x[j] * sl2 - l2r[hf]);
        if (mask && !attendable(r_lo + 8 * hf, k0 + frag_col(j, lane), S,
                                causal, window))
          p = 0.f;
        x[j] = p;
      }
      mbar_wait(dp_full, it & 1);
#pragma unroll
      for (int j = 0; j < 32; ++j)  // dS = P (dP - delta)
        x[j] *= dp_x[j * 128 + t] - dlr[frag_half(j)];
      mbar_arrive(dp_empty);
      to_a_frag(x, a);
      if (it > 0) mbar_wait(ds_empty, (it - 1) & 1);
#pragma unroll
      for (int i = 0; i < 16; ++i) ds_x[i * 128 + t] = a[i];
      mbar_arrive(ds_full);
    } else {
      if (it > 0) mbar_wait(dp_empty, (it - 1) & 1);
#pragma unroll
      for (int j = 0; j < 32; ++j) dp_x[j * 128 + t] = x[j];
      mbar_arrive(dp_full);
      mbar_wait(ds_full, it & 1);
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = ds_x[i * 128 + t];
      mbar_arrive(ds_empty);
    }
    wgmma_fence();  // dQ[:, panels] += dS K[:, panels]
    mma_panels<NP>(acc, a, ks, P0);
    wgmma_commit();
    wgmma_wait(acc);
    mbar_arrive(&empty[st]);
  }

  const float sc[2] = {scale, scale};
  store_rows<64 * NP>(dq, acc, ((long long)b * S * H + h) * D + 64 * P0,
                      (long long)H * D, r_lo, S, lane, sc);
}

// dQ where a 64 x D float32 accumulator leaves room for S and dP (D 192:
// 96 registers): consumer cw owns rows [q0 + 64 cw, + 64) of a 128-row q
// tile, forms S, P, dP, dS and all of dQ for them, and skips a key tile
// none of its rows reaches
template <int D>
__device__ __forceinline__ void dq_own_rows(
    const bf16* q_s, const bf16* do_s, const bf16* kv_s, uint64_t* q_full,
    uint64_t* full, uint64_t* empty, const float* __restrict__ delta,
    const float* __restrict__ lse2, bf16* __restrict__ dq, int n, int lo,
    int q0, int cw, int h, int b, int S, int Spad, int H, int causal,
    int window, float scale) {
  constexpr int T = TILE * D, BQ = 2 * TILE;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int qw0 = q0 + TILE * cw;
  const int r_lo = qw0 + 16 * (t / 32) + lane / 4;  // and r_lo + 8
  const int w_lo = window > 0 ? qw0 - window + 1 : 0;
  const int w_hi = causal ? min(S, qw0 + TILE) : S;
  const float sl2 = scale * LOG2E;
  const long long srow = ((long long)b * H + h) * Spad;
  const float l2r[2] = {lse2[srow + r_lo], lse2[srow + r_lo + 8]};
  const float dlr[2] = {delta[srow + r_lo], delta[srow + r_lo + 8]};
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES, k0 = lo + it * TILE;
    const bf16* ks = kv_s + 2 * st * T;
    const bf16* vs = ks + T;
    mbar_wait(&full[st], (it / STAGES) & 1);
    if (k0 >= w_hi || k0 + TILE <= w_lo) {  // no row of ours reaches it
      mbar_arrive(&empty[st]);
      continue;
    }
    float s[32], dp[32];
    wgmma_fence();
    mma_scores<D>(s, q_s, BQ, TILE * cw, ks);   // S = Q K^T
    mma_scores<D>(dp, do_s, BQ, TILE * cw, vs); // dP = dO V^T
    wgmma_commit();
    wgmma_wait(s);
    wgmma_wait(dp);
    const bool mask = needs_mask(qw0, TILE, k0, TILE, S, causal, window);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hf = frag_half(j);
      float p = exp2f(s[j] * sl2 - l2r[hf]);
      if (mask && !attendable(r_lo + 8 * hf, k0 + frag_col(j, lane), S,
                              causal, window))
        p = 0.f;
      dp[j] = p * (dp[j] - dlr[hf]);  // dS
    }
    uint32_t a[16];
    to_a_frag(dp, a);
    wgmma_fence();  // dQ += dS K
    mma_panels<D / 64>(acc, a, ks, 0);
    wgmma_commit();
    wgmma_wait(acc);
    mbar_arrive(&empty[st]);
  }
  const float sc[2] = {scale, scale};
  store_rows<D>(dq, acc, ((long long)b * S * H + h) * D, (long long)H * D,
                r_lo, S, lane, sc);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const float* __restrict__ delta,
              const float* __restrict__ lse2, bf16* __restrict__ dq, int S,
              int Spad, int H, int KH, int causal, int window, float scale) {
  constexpr int T = TILE * D, BQ = DQ_ROWS<D>;
  bf16* q_s = smem_base();
  bf16* do_s = q_s + BQ * D;
  bf16* kv_s = do_s + BQ * D;  // stage st: K at kv_s + 2 st T, V after it
  float* dp_x = reinterpret_cast<float*>(kv_s + 2 * STAGES * T);
  uint32_t* ds_x = reinterpret_cast<uint32_t*>(dp_x + 32 * 128);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(  // hand-over at 64 rows
      BQ == TILE ? static_cast<void*>(ds_x + 16 * 128)
                 : static_cast<void*>(dp_x));
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* bars = empty + STAGES;  // the four hand-over barriers

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // last tile first
  const int kvh = h / (H / KH);
  int lo;
  const int n = key_tiles(q0, BQ, TILE, S, causal, window, lo);

  if (threadIdx.x == 0) {
    const int counts[9] = {1, 1, 1, 256, 256, 128, 128, 128, 128};
    init_barriers(q_full, 9, counts);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * BQ * D * 2);
      tma_tile<D>(q_s, &tq, q_full, h, q0, b, BQ);
      tma_tile<D>(do_s, &tdo, q_full, h, q0, b, BQ);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES, k0 = lo + it * TILE;
        if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        bf16* ks = kv_s + 2 * st * T;
        mbar_expect_tx(&full[st], 2 * T * 2);
        tma_tile<D>(ks, &tk, &full[st], kvh, k0, b, TILE);
        tma_tile<D>(ks + T, &tv, &full[st], kvh, k0, b, TILE);
      }
    }
  } else {
    regs_inc<240>();
    if constexpr (BQ != TILE)
      dq_own_rows<D>(q_s, do_s, kv_s, q_full, full, empty, delta, lse2, dq, n,
                 lo, q0, wg - 1, h, b, S, Spad, H, causal, window, scale);
    else if (wg == 1)
      dq_consumer<D, 0>(q_s, do_s, kv_s, dp_x, ds_x, q_full, full, empty,
                        bars, delta, lse2, dq, n, lo, q0, h, b, S, Spad, H,
                        causal, window, scale);
    else
      dq_consumer<D, 1>(q_s, do_s, kv_s, dp_x, ds_x, q_full, full, empty,
                        bars, delta, lse2, dq, n, lo, q0, h, b, S, Spad, H,
                        causal, window, scale);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// Dynamic shared memory of each kernel in bytes: the bf16 tiles, the
// hand-over tiles, the stats, up to 16 barriers and 1,024 bytes to align
// the start.
constexpr size_t EXTRA = 1024 + 16 * 8;
template <int D> constexpr size_t fwd_smem() {
  return (size_t)(2 * TILE * D + 2 * STAGES * TILE * D) * 2 + EXTRA;
}
template <int D> constexpr size_t dkdv_smem() {
  return (size_t)(2 * TILE * D + 2 * STAGES * TILE * D) * 2 + 32 * 128 * 4 +
         2 * STAGES * TILE * 4 + EXTRA;
}
template <int D> constexpr size_t dq_smem() {
  return (size_t)(2 * DQ_ROWS<D> * D + 2 * STAGES * TILE * D) * 2 +
         (DQ_ROWS<D> == TILE ? (32 + 16) * 128 * 4 : 0) + EXTRA;
}
static_assert(fwd_smem<256>() <= 232448 && dkdv_smem<256>() <= 232448 &&
                  dq_smem<256>() <= 232448 && dq_smem<192>() <= 232448,
              "a block's shared memory is at most 227 KB");

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int S, int H, int KH, int causal,
                       int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, S, H, D, 2 * TILE);
  if (err == cudaSuccess) err = make_map(&tk, k, B, S, KH, D, TILE);
  if (err == cudaSuccess) err = make_map(&tv, v, B, S, KH, D, TILE);
  if (err == cudaSuccess) err = allow_smem(fwd_kernel<D>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  fwd_kernel<D><<<dim3(H, B, (S + 2 * TILE - 1) / (2 * TILE)), THREADS,
                  fwd_smem<D>(), stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), S, H, KH,
      causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* lse, const void* dout,
                       void* dq, void* dk, void* dv, void* stats, void* part,
                       int B, int S, int H, int KH, int causal, int window,
                       float scale, int splits, cudaStream_t stream) {
  const int Spad = padded(S);
  const long long rows = (long long)B * H * Spad;
  float* delta = static_cast<float*>(stats);
  float* lse2 = delta + rows;
  CUtensorMap tq, tdo, tk, tv, tq_dq, tdo_dq;
  cudaError_t err = make_map(&tq, q, B, S, H, D, TILE);
  if (err == cudaSuccess) err = make_map(&tdo, dout, B, S, H, D, TILE);
  if (err == cudaSuccess) err = make_map(&tk, k, B, S, KH, D, TILE);
  if (err == cudaSuccess) err = make_map(&tv, v, B, S, KH, D, TILE);
  if (err == cudaSuccess) err = make_map(&tq_dq, q, B, S, H, D, DQ_ROWS<D>);
  if (err == cudaSuccess)
    err = make_map(&tdo_dq, dout, B, S, H, D, DQ_ROWS<D>);
  if (err == cudaSuccess) err = allow_smem(dkdv_kernel<D>, dkdv_smem<D>());
  if (err == cudaSuccess) err = allow_smem(dq_kernel<D>, dq_smem<D>());
  if (err != cudaSuccess) return err;

  const int tiles = (S + TILE - 1) / TILE;
  delta_kernel<D><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), delta, lse2, S, Spad, H, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3(KH * splits, B, tiles), THREADS, dkdv_smem<D>(),
                   stream>>>(tq, tdo, tk, tv, delta, lse2,
                             static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                             static_cast<float*>(part), S, Spad, H, KH,
                             splits, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (splits > 1) {
    const long long n4 = (long long)B * S * KH * D / 4;
    dkdv_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        static_cast<const float4*>(part), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), n4, splits, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  dq_kernel<D><<<dim3(H, B, (S + DQ_ROWS<D> - 1) / DQ_ROWS<D>), THREADS,
                 dq_smem<D>(), stream>>>(
      tq_dq, tdo_dq, tk, tv, delta, lse2, static_cast<bf16*>(dq), S, Spad, H,
      KH, causal, window, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

bool bad_shape(int B, int S, int H, int KH, int head_dim) {
  return B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 ||
         (head_dim != 192 && head_dim != 256);
}

}  // namespace

extern "C" {

// Both launch on `stream`, allocate nothing and do not synchronise.
// head_dim is 192 or 256.  Every tensor is contiguous and 16-byte
// aligned: bf16 q, o, dout, dq (B, S, H, head_dim) and k, v, dk, dv (B,
// S, KH, head_dim); float32 lse (B, H, S).  `stats` is float32 scratch of
// 2 x B x H x (S rounded up to 128) elements; with `splits` > 1 the dK/dV
// kernel splits each key tile's work `splits` ways into `partials`,
// float32 scratch of 2 x splits x B x S x KH x head_dim elements (else
// unused).  causal: 0 or 1; window: 0 = none.  Return cudaGetLastError()
// (or the error that stopped the launch).
int flash_attention_d256_fwd_launch(int device, const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int S, int H, int KH, int head_dim,
                                    int causal, int window, float scale,
                                    void* stream) {
  if (bad_shape(B, S, H, KH, head_dim)) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return head_dim == 192
               ? launch_fwd<192>(q, k, v, o, lse, B, S, H, KH, causal,
                                 window, scale, s)
               : launch_fwd<256>(q, k, v, o, lse, B, S, H, KH, causal,
                                 window, scale, s);
  });
}

int flash_attention_d256_bwd_launch(int device, const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* lse, const void* dout,
                                    void* dq, void* dk, void* dv, void* stats,
                                    void* partials, int B, int S, int H,
                                    int KH, int head_dim, int causal,
                                    int window, float scale, int splits,
                                    void* stream) {
  if (bad_shape(B, S, H, KH, head_dim) || splits < 1 ||
      (splits > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      !aligned16(dout) || !aligned16(dq) || !aligned16(dk) ||
      !aligned16(dv) || !aligned16(stats) || !aligned16(partials))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return head_dim == 192
               ? launch_bwd<192>(q, k, v, o, lse, dout, dq, dk, dv, stats,
                                 partials, B, S, H, KH, causal, window,
                                 scale, splits, s)
               : launch_bwd<256>(q, k, v, o, lse, dout, dq, dk, dv, stats,
                                 partials, B, S, H, KH, causal, window,
                                 scale, splits, s);
  });
}

const char* flash_attention_d256_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
