// Flash attention in bf16, forward and backward, for Hopper (sm_90a):
// TMA tile loads through mbarrier rings, wgmma products on the tensor
// cores, warp-specialised blocks.  Hand-written CUDA C++ with PTX inline.
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `flash_attention_pallas` (src/repro/kernels/flash_attention.py:28-69)
// for bf16 with head_dim 64 or 128: GQA self-attention (query head h
// reads kv head h / G) over q (B, S, H, D) and k/v (B, S, KH, D), causal
// and/or sliding-window masked, online softmax in float32, p rounded to
// bf16 after the tile's running max before the PV product, 0 for a row
// with no attendable key, and LSE = m + log(l) (B, H, S) float32 out.
// Its backward replaces XLA's autodiff of `blockwise_attention`
// (src/repro/models/attention.py) in the JAX package.  float32 and other
// head sizes go to flash_attention.cu (CUDA cores, float32 products).
//
// Bound.  At the training shape (B 2, S 4096, 16 / 8 heads, D 128,
// causal) attention does about S / 2 * 4 D operations a query row for
// 4 D bytes of q and o: some 2,000 operations a byte, far above the
// H100's 295, so it is bound by the tensor cores' 989 TFLOP/s (bf16).
// What the design does about it:
//   * every product is a `wgmma` (bf16 in, f32 accumulate): S = Q K^T
//     and dP = dO V^T read both operands from shared memory (K-major);
//     P V, P^T dO, dS^T Q and dS K take P / dS from registers (the f32
//     accumulator fragment of one product is the bf16 A fragment of the
//     next) and B from shared memory as MN-major through the
//     instruction's transpose bit, so nothing is transposed;
//   * tiles arrive by TMA (one thread issues, 128-byte swizzle, zero
//     fill past S) into 2-stage rings guarded by full / empty mbarriers,
//     so loads overlap the products;
//   * a block is one producer warpgroup (registers dropped to 24 with
//     setmaxnreg) and two consumer warpgroups of 64 rows (240 registers)
//     that keep their accumulators in registers for the whole loop;
//   * only diagonal, window-edge and ragged tiles are masked.
// A 128-wide bf16 row is 256 bytes and the 128-byte swizzle takes at
// most 128, so a tile is loaded as 64-column panels (rows x 128 bytes
// each); the descriptors step 32 bytes along K inside a panel (K-major,
// 8-row groups 1,024 bytes apart) and one panel along N (MN-major).
//
// Kernels (all deterministic: no atomics, fixed summation order):
//   fwd:   one block per (128-row q tile, h, b), q tiles in reverse so
//          the long causal rows start first; 128-key K / V stages.
//   delta: delta = rowsum(dO * O) and LSE * log2(e), once, (B, H, Spad).
//   dK/dV: one block per (128-key tile, kv head, b); loops over the G
//          query heads and the 64-row q tiles that reach its keys.
//   dQ:    one block per (128-row q tile, h, b); 64-key K / V stages.
// The backward runs 7 tile products where the bound counts 5 (dQ
// recomputes S and dP); the single-pass form is later work.
#include "sm90_common.cuh"

namespace {

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
  constexpr int BQ = 128, BK = 128, TILE = BQ * D;
  bf16* q_s = smem_base();
  bf16* kv_s = q_s + TILE;  // stage st: K at kv_s + 2 st TILE, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + 2 * STAGES * TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int nqt = (S + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  int lo;
  const int n = key_tiles(q0, BQ, BK, S, causal, window, lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&empty[i], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, TILE * 2);
      tma_tile<D>(q_s, &tq, q_full, h, q0, b, BQ);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES, k0 = lo + it * BK;
        if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        bf16* ks = kv_s + 2 * st * TILE;
        mbar_expect_tx(&k_full[st], TILE * 2);
        tma_tile<D>(ks, &tk, &k_full[st], kvh, k0, b, BK);
        mbar_expect_tx(&v_full[st], TILE * 2);
        tma_tile<D>(ks + TILE, &tv, &v_full[st], kvh, k0, b, BK);
      }
    }
  } else {  // consumers: rows qw0 .. qw0 + 63
    regs_inc<240>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    const int qw0 = q0 + 64 * cw;
    const int r_lo = qw0 + 16 * (t / 32) + lane / 4;  // and r_lo + 8
    const float sl2 = scale * LOG2E;
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int it = 0; it < n; ++it) {
      const int st = it % STAGES, k0 = lo + it * BK;
      const uint32_t par = (it / STAGES) & 1;
      const bf16* ks = kv_s + 2 * st * TILE;
      const bf16* vs = ks + TILE;

      float s[BK / 2];
      mbar_wait(&k_full[st], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc_k(q_s, BQ, 64 * cw, kk), desc_k(ks, BK, 0, kk),
                 kk > 0);
      wgmma_commit();
      wgmma_wait(s);

      const bool mask = needs_mask(qw0, 64, k0, BK, S, causal, window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
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
      for (int j = 0; j < BK / 2; ++j) {
        const float p = exp2f(s[j] - mu[frag_half(j)]);
        l[frag_half(j)] += p;
        s[j] = p;
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[frag_half(j)];
      uint32_t pa[BK / 4];
      to_a_frag(s, pa);

      mbar_wait(&v_full[st], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, &pa[4 * kk], desc_mn(vs, BK, kk));
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
// backward, dK and dV: one block per (128-key tile, kv head, b)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ delta,
                const float* __restrict__ lse2, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int S, int Spad, int H, int KH,
                int causal, int window, float scale) {
  constexpr int BK = 128, BQ = 64, KT = BK * D, QT = BQ * D;
  bf16* k_s = smem_base();
  bf16* v_s = k_s + KT;
  bf16* qd_s = v_s + KT;  // stage st: Q at qd_s + 2 st QT, dO after it
  float* stats = reinterpret_cast<float*>(qd_s + 2 * STAGES * QT);
  // stats + 2 st BQ: lse2 of stage st's rows, then their delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + 2 * STAGES * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  int lo;
  const int nq = query_tiles(k0, BK, BQ, S, causal, window, lo);
  const int n = G * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * KT * 2);
      tma_tile<D>(k_s, &tk, kv_full, kvh, k0, b, BK);
      tma_tile<D>(v_s, &tv, kv_full, kvh, k0, b, BK);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES, h = kvh * G + it / nq;
        const int q0 = lo + (it % nq) * BQ;
        if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        bf16* qs = qd_s + 2 * st * QT;
        float* sts = stats + 2 * st * BQ;
        const long long srow = ((long long)b * H + h) * Spad + q0;
        mbar_expect_tx(&full[st], 2 * QT * 2 + 2 * BQ * 4);
        tma_tile<D>(qs, &tq, &full[st], h, q0, b, BQ);
        tma_tile<D>(qs + QT, &tdo, &full[st], h, q0, b, BQ);
        bulk_load(sts, lse2 + srow, BQ * 4, &full[st]);
        bulk_load(sts + BQ, delta + srow, BQ * 4, &full[st]);
      }
    }
  } else {  // consumers: keys kw0 .. kw0 + 63
    regs_inc<240>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    const int kw0 = k0 + 64 * cw;
    const int r_lo = kw0 + 16 * (t / 32) + lane / 4;  // and r_lo + 8
    const float sl2 = scale * LOG2E;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n; ++it) {
      const int st = it % STAGES, q0 = lo + (it % nq) * BQ;
      const bf16* qs = qd_s + 2 * st * QT;
      const bf16* dos = qs + QT;
      const float* l2s = stats + 2 * st * BQ;
      const float* dls = l2s + BQ;

      float s[BQ / 2], dp[BQ / 2];
      mbar_wait(&full[st], (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T
        wgmma_ss(s, desc_k(k_s, BK, 64 * cw, kk), desc_k(qs, BQ, 0, kk),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
        wgmma_ss(dp, desc_k(v_s, BK, 64 * cw, kk), desc_k(dos, BQ, 0, kk),
                 kk > 0);
      wgmma_commit();
      wgmma_wait(s);
      wgmma_wait(dp);

      const bool mask = needs_mask(q0, BQ, kw0, 64, S, causal, window);
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int c = frag_col(j, lane);
        float p = exp2f(s[j] * sl2 - l2s[c]);
        if (mask && !attendable(q0 + c, r_lo + 8 * frag_half(j), S, causal,
                                window))
          p = 0.f;
        s[j] = p;
        dp[j] = p * (dp[j] - dls[c]);  // dS^T
      }
      uint32_t pa[BQ / 4], da[BQ / 4];
      to_a_frag(s, pa);
      to_a_frag(dp, da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)  // dV += P^T dO
        wgmma_rs(dv_acc, &pa[4 * kk], desc_mn(dos, BQ, kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)  // dK += dS^T Q
        wgmma_rs(dk_acc, &da[4 * kk], desc_mn(qs, BQ, kk));
      wgmma_commit();
      wgmma_wait(dv_acc);
      wgmma_wait(dk_acc);
      mbar_arrive(&empty[st]);
    }

    const long long base = ((long long)b * S * KH + kvh) * D;
    const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
    store_rows<D>(dk, dk_acc, base, (long long)KH * D, r_lo, S, lane, sc);
    store_rows<D>(dv, dv_acc, base, (long long)KH * D, r_lo, S, lane, one);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ: one block per (128-row q tile, h, b)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const float* __restrict__ delta,
              const float* __restrict__ lse2, bf16* __restrict__ dq, int S,
              int Spad, int H, int KH, int causal, int window, float scale) {
  constexpr int BQ = 128, BK = 64, QT = BQ * D, KT = BK * D;
  bf16* q_s = smem_base();
  bf16* do_s = q_s + QT;
  bf16* kv_s = do_s + QT;  // stage st: K at kv_s + 2 st KT, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + 2 * STAGES * KT);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int nqt = (S + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  int lo;
  const int n = key_tiles(q0, BQ, BK, S, causal, window, lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * QT * 2);
      tma_tile<D>(q_s, &tq, q_full, h, q0, b, BQ);
      tma_tile<D>(do_s, &tdo, q_full, h, q0, b, BQ);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES, k0 = lo + it * BK;
        if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        bf16* ks = kv_s + 2 * st * KT;
        mbar_expect_tx(&full[st], 2 * KT * 2);
        tma_tile<D>(ks, &tk, &full[st], kvh, k0, b, BK);
        tma_tile<D>(ks + KT, &tv, &full[st], kvh, k0, b, BK);
      }
    }
  } else {  // consumers: rows qw0 .. qw0 + 63
    regs_inc<240>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    const int qw0 = q0 + 64 * cw;
    const int r_lo = qw0 + 16 * (t / 32) + lane / 4;  // and r_lo + 8
    const float sl2 = scale * LOG2E;
    const long long srow = ((long long)b * H + h) * Spad;
    const float l2r[2] = {lse2[srow + r_lo], lse2[srow + r_lo + 8]};
    const float dlr[2] = {delta[srow + r_lo], delta[srow + r_lo + 8]};
    float dq_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dq_acc[j] = 0.f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n; ++it) {
      const int st = it % STAGES, k0 = lo + it * BK;
      const bf16* ks = kv_s + 2 * st * KT;
      const bf16* vs = ks + KT;

      float s[BK / 2], dp[BK / 2];
      mbar_wait(&full[st], (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T
        wgmma_ss(s, desc_k(q_s, BQ, 64 * cw, kk), desc_k(ks, BK, 0, kk),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // dP = dO V^T
        wgmma_ss(dp, desc_k(do_s, BQ, 64 * cw, kk), desc_k(vs, BK, 0, kk),
                 kk > 0);
      wgmma_commit();
      wgmma_wait(s);
      wgmma_wait(dp);

      const bool mask = needs_mask(qw0, 64, k0, BK, S, causal, window);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int hf = frag_half(j);
        float p = exp2f(s[j] * sl2 - l2r[hf]);
        if (mask && !attendable(r_lo + 8 * hf, k0 + frag_col(j, lane), S,
                                causal, window))
          p = 0.f;
        dp[j] = p * (dp[j] - dlr[hf]);  // dS
      }
      uint32_t da[BK / 4];
      to_a_frag(dp, da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // dQ += dS K
        wgmma_rs(dq_acc, &da[4 * kk], desc_mn(ks, BK, kk));
      wgmma_commit();
      wgmma_wait(dq_acc);
      mbar_arrive(&empty[st]);
    }

    const float sc[2] = {scale, scale};
    store_rows<D>(dq, dq_acc, ((long long)b * S * H + h) * D,
                  (long long)H * D, r_lo, S, lane, sc);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// Dynamic shared memory of each kernel in bytes: the bf16 tiles, the
// stats, the barriers and 1,024 bytes to align the start.
constexpr size_t SLACK = 1024 + 64;
template <int D> constexpr size_t fwd_smem() {
  return (size_t)(128 * D + 2 * STAGES * 128 * D) * 2 + SLACK;
}
template <int D> constexpr size_t dkdv_smem() {
  return (size_t)(2 * 128 * D + 2 * STAGES * 64 * D) * 2 +
         2 * STAGES * 64 * 4 + SLACK;
}
template <int D> constexpr size_t dq_smem() {
  return (size_t)(2 * 128 * D + 2 * STAGES * 64 * D) * 2 + SLACK;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int S, int H, int KH, int causal,
                       int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, S, H, D, 128);
  if (err == cudaSuccess) err = make_map(&tk, k, B, S, KH, D, 128);
  if (err == cudaSuccess) err = make_map(&tv, v, B, S, KH, D, 128);
  if (err == cudaSuccess) err = allow_smem(fwd_kernel<D>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  fwd_kernel<D><<<dim3((S + 127) / 128, H, B), THREADS, fwd_smem<D>(),
                  stream>>>(tq, tk, tv, static_cast<bf16*>(o),
                            static_cast<float*>(lse), S, H, KH, causal,
                            window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* lse, const void* dout,
                       void* dq, void* dk, void* dv, void* stats, int B,
                       int S, int H, int KH, int causal, int window,
                       float scale, cudaStream_t stream) {
  const int Spad = padded(S);
  const long long rows = (long long)B * H * Spad;
  float* delta = static_cast<float*>(stats);
  float* lse2 = delta + rows;
  CUtensorMap tq64, tdo64, tq128, tdo128, tk64, tv64, tk128, tv128;
  cudaError_t err = make_map(&tq64, q, B, S, H, D, 64);
  if (err == cudaSuccess) err = make_map(&tdo64, dout, B, S, H, D, 64);
  if (err == cudaSuccess) err = make_map(&tq128, q, B, S, H, D, 128);
  if (err == cudaSuccess) err = make_map(&tdo128, dout, B, S, H, D, 128);
  if (err == cudaSuccess) err = make_map(&tk64, k, B, S, KH, D, 64);
  if (err == cudaSuccess) err = make_map(&tv64, v, B, S, KH, D, 64);
  if (err == cudaSuccess) err = make_map(&tk128, k, B, S, KH, D, 128);
  if (err == cudaSuccess) err = make_map(&tv128, v, B, S, KH, D, 128);
  if (err == cudaSuccess) err = allow_smem(dkdv_kernel<D>, dkdv_smem<D>());
  if (err == cudaSuccess) err = allow_smem(dq_kernel<D>, dq_smem<D>());
  if (err != cudaSuccess) return err;

  delta_kernel<D><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), delta, lse2, S, Spad, H, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3((S + 127) / 128, KH, B), THREADS, dkdv_smem<D>(),
                   stream>>>(tq64, tdo64, tk128, tv128, delta, lse2,
                             static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                             S, Spad, H, KH, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<D><<<dim3((S + 127) / 128, H, B), THREADS, dq_smem<D>(),
                 stream>>>(tq128, tdo128, tk64, tv64, delta, lse2,
                           static_cast<bf16*>(dq), S, Spad, H, KH, causal,
                           window, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int KH, int D) {
  return B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || (D != 64 && D != 128);
}

}  // namespace

extern "C" {

// Both launch on `stream`, allocate nothing and do not synchronise.
// Every tensor is contiguous bf16: q, o, dout, dq (B, S, H, D); k, v, dk,
// dv (B, S, KH, D); lse (B, H, S) float32; D is 64 or 128.  `stats` is
// float32 scratch of 2 x B x H x (S rounded up to 128) elements.  causal:
// 0 or 1; window: 0 = none.  Return cudaGetLastError() (or the error
// that stopped the launch).
int flash_attention_sm90_fwd_launch(int device, const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int S, int H, int KH, int D, int causal,
                                    int window, float scale, void* stream) {
  if (bad_shape(B, S, H, KH, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return D == 64 ? launch_fwd<64>(q, k, v, o, lse, B, S, H, KH, causal,
                                    window, scale, s)
                   : launch_fwd<128>(q, k, v, o, lse, B, S, H, KH, causal,
                                     window, scale, s);
  });
}

int flash_attention_sm90_bwd_launch(int device, const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* lse, const void* dout,
                                    void* dq, void* dk, void* dv, void* stats,
                                    int B, int S, int H, int KH, int D,
                                    int causal, int window, float scale,
                                    void* stream) {
  if (bad_shape(B, S, H, KH, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return D == 64
               ? launch_bwd<64>(q, k, v, o, lse, dout, dq, dk, dv, stats, B,
                                S, H, KH, causal, window, scale, s)
               : launch_bwd<128>(q, k, v, o, lse, dout, dq, dk, dv, stats, B,
                                 S, H, KH, causal, window, scale, s);
  });
}

const char* flash_attention_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
