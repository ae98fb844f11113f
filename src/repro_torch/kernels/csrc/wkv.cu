// RWKV6's WKV recurrence on the H100 (sm_90a), forward and backward, the
// sequence's 256-step chunks side by side.
//
// Replaces the time recurrence of the JAX package's `rwkv_apply`
// (src/repro/models/rwkv.py:105-111: the `step` run by `chunked_scan`,
// src/repro/models/scan_utils.py:18, a `jax.lax.scan` with a
// `jax.checkpoint` every 256 steps) and XLA's autodiff of it.  It is not
// a Pallas kernel; PyTorch has no compiled scan, and an eager step loop
// issues about 6 ops a step.  `ref.wkv_ref` and `ref.wkv_bwd_ref` are
// the plain versions and the specification; `ref.wkv_chunk_ref`,
// `wkv_bwd_chunk_ref`, `wkv_stages_ref` and `wkv_bwd_stages_ref` are the
// stages below in plain form.
//
//   a_t = k_t v_t^T,  o_t[j] = sum_i r_t[i] (S_t[i,j] + u[i] a_t[i,j]),
//   S_{t+1} = diag(w_t) S_t + a_t,   S_0 = 0,
//
// per batch row and head.  r, k, v, w and o are (B, S, H HS) float32, u
// (H, HS); HS (the head size) is a template, 64 (rwkv6-3b) or 16.
//
// Bound.  The least work a step and state element is 5 flops in the
// forward (r S, 2; w S + k v, 3) and 14 in the backward (the state
// recomputed, 3; w G + r do, 3; dr, dk, dv, dw, 2 each); the u terms are
// rank one a row and step, O(HS) a step (an FMA counts 2).  At
// rwkv6-3b's training call (B 2, S 4,096, 40 heads of 64) the forward
// must move r, k, v, w in and o and the chunk states out, 0.44 GB, 0.13
// ms at 3.35 TB/s (bound by bytes); the backward does 18.8 GFLOP, 0.28 ms
// at 67 TFLOP/s of float32 (bound by operations).
//
// The chunks side by side.  Over chunk c (steps t0 .. t1 - 1) of a (row,
// head), with P_t = prod_{t0 <= tau < t} w_tau and W_c = P_{t1},
//
//   S_{c+1}     = diag(W_c) S_c + dS_c,
//                 dS_c = sum_t diag(prod_{t < tau < t1} w_tau) k_t v_t^T,
//   G_start(c)  = diag(W_c) G_end(c) + dG_c,   dG_c = sum_t diag(P_t) r_t do_t^T,
//
// G the gradient of the state (G_t = diag(w_t) G_{t+1} + r_t do_t^T).
// Every factor is a product of w <= 1: nothing is divided by w, and a
// product that underflows to 0 is the right one.  So the state at a
// chunk's start, which is all that ties a chunk to the ones before it,
// comes from a short chain:
//
//   forward   F1 (chunks side by side) dS_c and W_c, the steps in reverse
//                with the product of the w after each kept as it goes:
//                one FMA an element and step (wkv_chunk_kernel<HS, false>);
//             F2 (chunks in order, an element a thread) S_c, written to
//                the `states` output, coalesced (wkv_chain_kernel<false>);
//             F3 (chunks side by side) each chunk walked from S_c, o out
//                (wkv_fwd_kernel<HS>);
//   backward  B1 dG_c and W_c, the same kernel with (r, do) and the steps
//                in order (wkv_chunk_kernel<HS, true>);
//             B2 G_end(c) in reverse (wkv_chain_kernel<true>);
//             B3 each chunk from its stored S_c and G_end(c)
//                (wkv_bwd_kernel<HS>), then the du partials folded in
//                order (wkv_du_kernel).
//
// At the training call that is 2 x 40 x 16 = 1,280 (row, head, chunk)
// tiles of work in each stage instead of 80.
//
// F1, F3 (and B1): a block owns a (row, head, chunk)'s whole HS x HS
// state, HS^2 / 32 threads (128 at HS 64), a thread a tile of 8 rows x 4
// columns in registers, the 8 rows spread so the lanes sharing a column
// (HS / 8 of them) read neighbouring shared words.  A thread reads its
// rows' (r, k, w) and its columns' v once a step for 32 elements.  The
// u term is rank one: o_t += (sum_i r_i u_i k_i) v_t, one dot a step
// for the block, summed before the tile's walk.  F3's o sums over the
// rows of a column: each lane's 8 rows in registers, then over the
// column's lanes a 2-step group at a time by a transposing butterfly
// (each level sends the half of the values a lane gives up and adds the
// half it keeps), so a lane ends with one (step, column) of o.  Inputs come a tile of 16 steps at a time into a
// double-buffered shared-memory ring by cp.async, the next tile's
// copies in flight while this one is walked; no staging registers.
//
// B3: the 4 column blocks of 16 columns of a (row, head, chunk) form a
// thread-block cluster of 4 blocks of 128 threads, a thread a tile of 2
// rows x 4 columns.  Each chunk is walked from its stored state with
// three levels of recomputation, since no state is recovered by dividing
// by w: a first pass keeps the state at every 16-step piece's start in a
// per-block global scratch; then the pieces in reverse, each walked once
// to keep the state every 4 steps in registers, and each 4-step
// sub-chunk walked again into registers, then run in reverse with G (in
// registers, from G_end(c)).  The sums over columns (dr, dk, dw) fold
// over a warp's 4 column lanes by a transposing butterfly, 2 steps at a
// time; the warp then stores them (`st.async`, distributed shared
// memory) into the block of the cluster that owns its 16 rows, where
// each store counts on that block's mbarrier.  Once a 16-step piece's
// bytes are in, the owner adds the 4 blocks' sums in the fixed order
// block 0, 1, 2, 3 and writes them once, straight to the output; no
// fence is needed (a release cluster barrier would cost one at the scope
// of the card).  A relaxed cluster barrier marks the sums read, waited
// on only before the next piece's first store.  dv
// sums over rows: the warp's 8 row lanes by a butterfly, then its 4
// warps in order through shared memory.
// The u terms are rank one a row and step (dr += u k (v.do), dk += u r
// (v.do), dv += (sum_i k u r) do) and are added where the sums are
// written.  du (over batch rows and time) leaves as one partial a (batch
// row, chunk, row of the head), added in order by a small kernel.  No
// atomics: two backwards are bit-identical.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CHUNK = 256;        // steps between the stored states
constexpr int TILE = 16;          // steps a staged tile; a backward piece
constexpr int SUB = 4;            // steps of a backward sub-chunk
constexpr int BCOLS = 16;         // state columns a backward block holds
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// staging: cp.async into a shared-memory ring
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// TILE steps of WIDTH floats (a step D floats apart in src) into dst
// [TILE][WIDTH], zeros from step n on (the source address of a zero copy
// is step 0's, never read).
template <int WIDTH, int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* src, int D,
                                      int n) {
  constexpr int V = WIDTH / 4;
  for (int idx = threadIdx.x; idx < TILE * V; idx += THREADS) {
    const int l = idx / V, c = idx % V;
    cp16(dst + l * WIDTH + 4 * c, src + (size_t)(l < n ? l : 0) * D + 4 * c,
         l < n);
  }
}

// ---------------------------------------------------------------------------
// transposing butterflies
// ---------------------------------------------------------------------------
// Over the lanes that differ in bits M, M / 2, .. of `bits` (lanes M
// apart first): of CNT values a lane keeps the upper half where its bit
// is set, else the lower, adds its partner's copy of that half and leaves
// the sums at 0 .. CNT / 2 - 1, until one value or bit 1 is left.  A
// lane ends with values b * n .. b * n + n - 1, n what is left and b its
// bits M, M / 2, .. read as a number.  The sum order is fixed.
template <int CNT, int M>
__device__ __forceinline__ void fold_lanes(float* x, int bits,
                                           unsigned mask) {
  if constexpr (M >= 1 && CNT >= 2) {
    const bool hi = bits & M;
#pragma unroll
    for (int q = 0; q < CNT / 2; ++q) {
      const float send = hi ? x[q] : x[q + CNT / 2];
      const float keep = hi ? x[q + CNT / 2] : x[q];
      x[q] = keep + __shfl_xor_sync(mask, send, M);
    }
    fold_lanes<CNT / 2, M / 2>(x, bits, mask);
  }
}

// ---------------------------------------------------------------------------
// F1, F3 and B1: a block a (row, head, chunk), a thread 8 rows x 4 columns
// ---------------------------------------------------------------------------
template <int HS>
struct Fwd {
  static_assert(HS % 8 == 0 && HS * HS % 32 == 0, "head size");
  static constexpr int RL = HS / 8;            // lanes sharing a column
  static constexpr int THREADS = HS * HS / 32;
  static constexpr unsigned MASK = THREADS >= 32 ? FULL
                                                 : (1u << THREADS) - 1;
  static constexpr int PER = 8 / RL;  // o values a lane ends a group with
};

// Row e of the thread's 8 (q = e / 4): neighbouring lanes of a column
// read neighbouring float4s.
template <int HS>
__device__ __forceinline__ int fwd_row(int rl, int e) {
  return (e / 4) * 4 * Fwd<HS>::RL + rl * 4 + e % 4;
}

template <int HS>
__device__ __forceinline__ void fwd_rows(const float* p, int rl,
                                         float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p + rl * 4);
  const float4 b = *reinterpret_cast<const float4*>(p + 4 * Fwd<HS>::RL +
                                                    rl * 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void cols4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
}

template <int HS>
struct ChunkTile {
  float x[2][3][TILE][HS];  // a, b, w
};

template <int HS>
struct FwdSmem {
  float x[2][4][TILE][HS];  // r, k, w, v
  float kru[TILE];          // sum_i r_i u_i k_i over the head, a step
  float us[HS];
};

// F1 (a = k, b = v; the steps in reverse) and B1 (GRAD: a = r, b = do;
// the steps in order): X = sum_t diag(p_t) a_t b_t^T, p_t the product of
// the chunk's w over the steps walked before t (after t in F1, before t
// in B1), one FMA an element and step, and the product of all its w.
// Chunk `blockIdx.x + GRAD` of a whole number of chunks; F1 runs chunks
// 0 .. C - 2, B1 chunks 1 .. C - 1, each writing its X and product at
// index blockIdx.x of delta (B, C - 1, H, HS, HS) and decay (B, C - 1,
// H, HS).
template <int HS, bool GRAD>
__global__ void __launch_bounds__(Fwd<HS>::THREADS, 4)
wkv_chunk_kernel(const float* __restrict__ a, const float* __restrict__ bb,
                 const float* __restrict__ w, float* __restrict__ delta,
                 float* __restrict__ decay, int H, int S) {
  using F = Fwd<HS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkTile<HS>& sm = *reinterpret_cast<ChunkTile<HS>*>(smem_raw);
  constexpr int NT = CHUNK / TILE;
  const int idx = blockIdx.x, chunk = idx + (GRAD ? 1 : 0);
  const int h = blockIdx.y, b = blockIdx.z;
  const int C = S / CHUNK, D = H * HS;
  const int tid = threadIdx.x, rl = tid % F::RL, cl = tid / F::RL;
  const size_t base = ((size_t)b * S + (size_t)chunk * CHUNK) * D +
                      (size_t)h * HS;
  auto issue = [&](int j, int buf) {
    const size_t at = base + (size_t)(GRAD ? j : NT - 1 - j) * TILE * D;
    stage<HS, F::THREADS>(&sm.x[buf][0][0][0], a + at, D, TILE);
    stage<HS, F::THREADS>(&sm.x[buf][1][0][0], bb + at, D, TILE);
    stage<HS, F::THREADS>(&sm.x[buf][2][0][0], w + at, D, TILE);
    cp_commit();
  };

  float x[8][4], prod[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    prod[e] = 1.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) x[e][c] = 0.f;
  }
  issue(0, 0);
  for (int j = 0; j < NT; ++j) {
    if (j + 1 < NT) {
      issue(j + 1, (j + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = j & 1;
#pragma unroll 4
    for (int ll = 0; ll < TILE; ++ll) {
      const int l = GRAD ? ll : TILE - 1 - ll;
      float av[8], wv[8], bv[4];
      fwd_rows<HS>(sm.x[buf][0][l], rl, av);
      fwd_rows<HS>(sm.x[buf][2][l], rl, wv);
      cols4(&sm.x[buf][1][l][cl * 4], bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ap = av[e] * prod[e];
#pragma unroll
        for (int c = 0; c < 4; ++c) x[e][c] = fmaf(ap, bv[c], x[e][c]);
        prod[e] *= wv[e];
      }
    }
    __syncthreads();  // the buffer is free for tile j + 2
  }
  const size_t m = ((size_t)b * (C - 1) + idx) * H + h;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int i = fwd_row<HS>(rl, e);
    *reinterpret_cast<float4*>(delta + (m * HS + i) * HS + cl * 4) =
        make_float4(x[e][0], x[e][1], x[e][2], x[e][3]);
    if (cl == 0) decay[m * HS + i] = prod[e];
  }
}

// F2 (in order) and B2 (in reverse): an element (b, h, i, j) a thread,
// out (B, C, H, HS, HS).  Forward: out[0] = 0, out[c + 1] = decay[c]
// out[c] + delta[c]; reverse: out[C - 1] = 0, out[c] = decay[c] out[c + 1]
// + delta[c] (B1's index c is chunk c + 1).
template <bool REVERSE>
__global__ void wkv_chain_kernel(const float* __restrict__ delta,
                                 const float* __restrict__ decay,
                                 float* __restrict__ out, int C, int H,
                                 int hs, size_t total) {
  const size_t mat = (size_t)hs * hs;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const size_t e = idx % mat, bh = idx / mat;
    const size_t b = bh / H, h = bh % H, i = e / hs;
    auto at = [&](int c) { return ((b * C + c) * H + h) * mat + e; };
    auto dat = [&](int c) { return ((b * (C - 1) + c) * H + h) * mat + e; };
    auto wat = [&](int c) { return ((b * (C - 1) + c) * H + h) * hs + i; };
    float acc = 0.f;
    if (!REVERSE) {
      out[at(0)] = 0.f;
      for (int c = 0; c < C - 1; ++c) {
        acc = fmaf(decay[wat(c)], acc, delta[dat(c)]);
        out[at(c + 1)] = acc;
      }
    } else {
      out[at(C - 1)] = 0.f;
      for (int c = C - 2; c >= 0; --c) {
        acc = fmaf(decay[wat(c)], acc, delta[dat(c)]);
        out[at(c)] = acc;
      }
    }
  }
}

// F3: chunk blockIdx.x walked from its state S_c, o out.
template <int HS>
__global__ void __launch_bounds__(Fwd<HS>::THREADS, 4)
wkv_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u,
               const float* __restrict__ states, float* __restrict__ o,
               int H, int S) {
  using F = Fwd<HS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem<HS>& sm = *reinterpret_cast<FwdSmem<HS>*>(smem_raw);
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = (S + CHUNK - 1) / CHUNK, D = H * HS;
  const int t0 = chunk * CHUNK, nc = min(CHUNK, S - t0);
  const int nt = (nc + TILE - 1) / TILE;
  const int tid = threadIdx.x, rl = tid % F::RL, cl = tid / F::RL;
  const size_t base = ((size_t)b * S + t0) * D + (size_t)h * HS;
  auto issue = [&](int j, int buf) {
    const size_t at = base + (size_t)j * TILE * D;
    const int n = min(TILE, nc - j * TILE);
    stage<HS, F::THREADS>(&sm.x[buf][0][0][0], r + at, D, n);
    stage<HS, F::THREADS>(&sm.x[buf][1][0][0], k + at, D, n);
    stage<HS, F::THREADS>(&sm.x[buf][2][0][0], w + at, D, n);
    stage<HS, F::THREADS>(&sm.x[buf][3][0][0], v + at, D, n);
    cp_commit();
  };
  issue(0, 0);

  float st[8][4];
  {
    const float* src = states + (((size_t)b * C + chunk) * H + h) * HS * HS;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      cols4(src + (size_t)fwd_row<HS>(rl, e) * HS + cl * 4, st[e]);
  }
  for (int x = tid; x < HS; x += F::THREADS) sm.us[x] = u[h * HS + x];
  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) {
      issue(j + 1, (j + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = j & 1, n = min(TILE, nc - j * TILE);
    // the rank-one u term's dot at the tile's steps, 8 lanes a step
    for (int x = tid; x < TILE * 8; x += F::THREADS) {
      const int l = x / 8, sl = x % 8;
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < HS / 8; ++e) {
        const int i = sl + 8 * e;
        a = fmaf(sm.x[buf][1][l][i] * sm.us[i], sm.x[buf][0][l][i], a);
      }
#pragma unroll
      for (int m = 1; m < 8; m *= 2) a += __shfl_xor_sync(F::MASK, a, m);
      if (sl == 0) sm.kru[l] = a;
    }
    __syncthreads();
    for (int g = 0; g < n; g += 2) {
      float acc[8];  // (step s, column c) at s * 4 + c, over the lane's rows
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] = 0.f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int l = g + s;  // a zero step past n leaves a zero state
        float rv[8], kv[8], wv[8], vv[4];
        fwd_rows<HS>(sm.x[buf][0][l], rl, rv);
        fwd_rows<HS>(sm.x[buf][1][l], rl, kv);
        fwd_rows<HS>(sm.x[buf][2][l], rl, wv);
        cols4(&sm.x[buf][3][l][cl * 4], vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[s * 4 + c] = fmaf(rv[e], st[e][c], acc[s * 4 + c]);
            st[e][c] = fmaf(wv[e], st[e][c], kv[e] * vv[c]);
          }
        }
      }
      // over the column's RL lanes: lane rl ends with values rl * PER ..
      // rl * PER + PER - 1
      fold_lanes<8, F::RL / 2>(acc, rl, F::MASK);
#pragma unroll
      for (int q = 0; q < F::PER; ++q) {  // and the u term, once a column
        const int vi = rl * F::PER + q, s = vi / 4, c = vi % 4;
        const float os = fmaf(sm.kru[g + s], sm.x[buf][3][g + s][cl * 4 + c],
                              acc[q]);
        if (g + s < n)
          o[base + (size_t)(j * TILE + g + s) * D + cl * 4 + c] = os;
      }
    }
    __syncthreads();  // the buffer is free for tile j + 2
  }
}

// ---------------------------------------------------------------------------
// B3: a cluster of column blocks a (row, head, chunk)
// ---------------------------------------------------------------------------
template <int HS>
struct Bwd {
  static_assert(HS % BCOLS == 0, "head size");
  static constexpr int NCB = HS / BCOLS;    // column blocks: the cluster
  static constexpr int WARPS = HS / 16;     // a warp: 16 rows x 16 columns
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int PAIRS = BCOLS * TILE / THREADS;  // folds a thread
  // bytes the blocks of a cluster store into a block's pin and vin a piece
  static constexpr uint32_t PIECE_BYTES = 4u * NCB * TILE * (3 * BCOLS + 1);
};

template <int HS>
struct BwdSmem {
  float r[2][TILE][HS], k[2][TILE][HS], w[2][TILE][HS];
  float v[2][TILE][BCOLS], d[2][TILE][BCOLS];  // the block's columns
  // dr, dk, dw of the block's 16 rows at a piece's steps, summed over the
  // columns of each block of the cluster (stored there by that block)
  float pin[Bwd<HS>::NCB][3][TILE][BCOLS];
  float dvp[Bwd<HS>::WARPS][TILE][BCOLS];   // dv summed over a warp
  float vin[2][Bwd<HS>::NCB][TILE];  // v . do over each block's columns
  float kru[TILE];     // sum_i k u r over the head
  float us[HS];
  float dus[TILE][BCOLS];
  uint64_t bar;        // completes when a piece's pin and vin are in
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address in block `rank` of the cluster of this block's shared
// address `a`.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// Stores v at cluster address `addr` and counts its 4 bytes on the
// mbarrier at cluster address `bar` of the same block: no fence, the
// barrier's phase completes once every byte it expects has landed.
__device__ __forceinline__ void store_remote(uint32_t addr, float v,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" :: "r"(addr), "f"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The owner's one arrival of a phase, with the bytes the phase expects.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spins until phase `parity` of the barrier has completed, with the
// stores it counted visible.  A wait of about 10 s (2^34 cycles) traps,
// so a lost store fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// The halves of a cluster barrier.  The arrive is relaxed: it orders no
// write (a release arrive costs a fence at the scope of the whole card),
// and only says that this thread's reads of a buffer are done, their
// values in registers, before the buffer is written again; the data
// itself travels by store_remote and the owner's mbarrier.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// rows i0, i0 + 1 of a matrix with row stride `stride`, 4 columns
__device__ __forceinline__ void load2x4(const float* p, int stride,
                                        float (&x)[2][4]) {
  cols4(p, x[0]);
  cols4(p + stride, x[1]);
}

__device__ __forceinline__ void copy2x4(const float (&a)[2][4],
                                        float (&x)[2][4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[q][c] = a[q][c];
}

// x <- diag(w_l) x + k_l v_l^T on the thread's 2 x 4 elements
template <int HS>
__device__ __forceinline__ void bwd_walk(const BwdSmem<HS>& sm, int buf,
                                         int l, int i0, int jc,
                                         float (&x)[2][4]) {
  const float2 k2 = *reinterpret_cast<const float2*>(&sm.k[buf][l][i0]);
  const float2 w2 = *reinterpret_cast<const float2*>(&sm.w[buf][l][i0]);
  float vv[4];
  cols4(&sm.v[buf][l][jc], vv);
  const float kq[2] = {k2.x, k2.y}, wq[2] = {w2.x, w2.y};
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[q][c] = fmaf(wq[q], x[q][c], kq[q] * vv[c]);
}

// One reverse step at tile step l: st the state before it, g the
// gradient of the state after it (then before it).  rkw gets (dr, dk, dw)
// of rows q = 0, 1 over the thread's columns at [qty * 2 + q], dvv dv of
// its columns over its rows, the u terms left out.
template <int HS>
__device__ __forceinline__ void bwd_step(const BwdSmem<HS>& sm, int buf,
                                         int l, int i0, int jc,
                                         const float (&st)[2][4],
                                         float (&g)[2][4], float* rkw,
                                         float* dvv) {
  const float2 r2 = *reinterpret_cast<const float2*>(&sm.r[buf][l][i0]);
  const float2 k2 = *reinterpret_cast<const float2*>(&sm.k[buf][l][i0]);
  const float2 w2 = *reinterpret_cast<const float2*>(&sm.w[buf][l][i0]);
  float vv[4], dd[4];
  cols4(&sm.v[buf][l][jc], vv);
  cols4(&sm.d[buf][l][jc], dd);
  const float rq[2] = {r2.x, r2.y}, kq[2] = {k2.x, k2.y};
  const float wq[2] = {w2.x, w2.y};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float dr = 0.f, dk = 0.f, dw = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dr = fmaf(st[q][c], dd[c], dr);
      dk = fmaf(g[q][c], vv[c], dk);
      dw = fmaf(st[q][c], g[q][c], dw);
    }
    rkw[q] = dr;
    rkw[2 + q] = dk;
    rkw[4 + q] = dw;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) dvv[c] = fmaf(kq[0], g[0][c], kq[1] * g[1][c]);
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) g[q][c] = fmaf(wq[q], g[q][c], rq[q] * dd[c]);
}

template <int HS>
__global__ void __launch_bounds__(Bwd<HS>::THREADS, 4)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u,
               const float* __restrict__ states,
               const float* __restrict__ g_end,
               const float* __restrict__ dout, float* __restrict__ dv,
               float* __restrict__ drkw, float* __restrict__ part_u,
               float* __restrict__ ckpt, int B, int H, int S, int ckpts) {
  using Bw = Bwd<HS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<HS>& sm = *reinterpret_cast<BwdSmem<HS>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();  // the column block
  const int chunk = blockIdx.x / Bw::NCB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wi = tid / 32, lane = tid % 32;
  const int cl = lane & 3, rl = lane >> 2;
  const int i0 = wi * 16 + rl * 2;  // the thread's rows i0, i0 + 1 ...
  const int jc = cl * 4;            // ... and columns jc .. jc + 3
  const int D = H * HS, C = (S + CHUNK - 1) / CHUNK;
  const int t0 = chunk * CHUNK, nc = min(CHUNK, S - t0);
  const int np = (nc + TILE - 1) / TILE;  // pieces
  const size_t plane = (size_t)B * S * D;
  const size_t base = ((size_t)b * S + t0) * D + (size_t)h * HS;
  const size_t cbase = base + rank * BCOLS;
  // (i, jc) of the chunk's stored state and G_end at mat + i * HS
  const size_t mat = (((size_t)b * C + chunk) * H + h) * HS * HS +
                     rank * BCOLS + jc + (size_t)i0 * HS;
  // the state at piece p's start (p >= 1) at ck + (p - 1) * HS * BCOLS
  float* ck = ckpt + (((size_t)(b * C + chunk) * H + h) * Bw::NCB + rank) *
                         ckpts * HS * BCOLS + (size_t)i0 * BCOLS + jc;
  for (int x = tid; x < HS; x += Bw::THREADS) sm.us[x] = u[h * HS + x];
  // the block that sums the warp's 16 rows over the head's columns
  // the pin of the block that sums the warp's 16 rows over the head's
  // columns, and that block's mbarrier
  const uint32_t owner_pin = cluster_addr(smem_addr(&sm.pin[rank][0][0][0]),
                                          wi);
  const uint32_t owner_bar = cluster_addr(smem_addr(&sm.bar), wi);
  if (tid == 0) {
    mbar_init(&sm.bar);
    mbar_expect(&sm.bar, Bw::PIECE_BYTES);  // the first piece's
  }
  uint32_t phase = 0;
  // no block stores to another before it has started and set its barrier
  cluster_arrive_relaxed();

  auto issue = [&](int stg, int buf) {
    const bool rev = stg >= np - 1;
    const int p = rev ? 2 * np - 2 - stg : stg;
    const int n = min(TILE, nc - p * TILE);
    const size_t at = (size_t)p * TILE * D;
    stage<HS, Bw::THREADS>(&sm.k[buf][0][0], k + base + at, D, n);
    stage<HS, Bw::THREADS>(&sm.w[buf][0][0], w + base + at, D, n);
    stage<BCOLS, Bw::THREADS>(&sm.v[buf][0][0], v + cbase + at, D, n);
    if (rev) {
      stage<HS, Bw::THREADS>(&sm.r[buf][0][0], r + base + at, D, n);
      stage<BCOLS, Bw::THREADS>(&sm.d[buf][0][0], dout + cbase + at, D, n);
    }
    cp_commit();
  };

  float s1[2][4], g[2][4];
  load2x4(states + mat, HS, s1);
  load2x4(g_end + mat, HS, g);
  float du_acc[Bw::PAIRS];
#pragma unroll
  for (int q = 0; q < Bw::PAIRS; ++q) du_acc[q] = 0.f;

  // stages 0 .. np - 2: the first pass over pieces 0 .. np - 2 (k, w, v),
  // keeping the state at pieces 1 .. np - 1's start; then the pieces in
  // reverse, np - 1 .. 0 (every input)
  const int nst = 2 * np - 1;
  issue(0, 0);
  for (int stg = 0; stg < nst; ++stg) {
    if (stg + 1 < nst) {
      issue(stg + 1, (stg + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = stg & 1;
    if (stg < np - 1) {
#pragma unroll 4
      for (int l = 0; l < TILE; ++l) bwd_walk(sm, buf, l, i0, jc, s1);
      float* dst = ck + (size_t)stg * HS * BCOLS;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        *reinterpret_cast<float4*>(dst + q * BCOLS) =
            make_float4(s1[q][0], s1[q][1], s1[q][2], s1[q][3]);
      __syncthreads();
      continue;
    }
    const int p = 2 * np - 2 - stg;
    const float* s0 = p == 0 ? states + mat : ck + (size_t)(p - 1) * HS * BCOLS;
    const int s0_stride = p == 0 ? HS : BCOLS;
    float x[2][4];  // the piece's start state, walked to its checkpoints
    load2x4(s0, s0_stride, x);

    // the state every SUB steps of the piece
    float cks[TILE / SUB - 1][2][4];
#pragma unroll
    for (int l = 0; l < TILE - SUB; ++l) {
      bwd_walk(sm, buf, l, i0, jc, x);
      if (l % SUB == SUB - 1) copy2x4(x, cks[l / SUB]);
    }
    // every block has read the last piece's sums (or, before the first
    // piece, has started): their buffers may be written again
    cluster_wait();

    // the piece's rank-one sums a step: kru over the head's rows, v . do
    // over the block's columns (8 lanes a step, folded by a butterfly),
    // the latter stored in every block of the cluster
    for (int idx = tid; idx < TILE * 8; idx += Bw::THREADS) {
      const int l = idx / 8, sl = idx % 8;
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int e = 0; e < HS / 8; ++e) {
        const int i = sl + 8 * e;
        a = fmaf(sm.k[buf][l][i] * sm.us[i], sm.r[buf][l][i], a);
      }
#pragma unroll
      for (int e = 0; e < BCOLS / 8; ++e) {
        const int j = sl + 8 * e;
        c = fmaf(sm.v[buf][l][j], sm.d[buf][l][j], c);
      }
#pragma unroll
      for (int m = 1; m < 8; m *= 2) {
        a += __shfl_xor_sync(FULL, a, m);
        c += __shfl_xor_sync(FULL, c, m);
      }
      if (sl == 0) {
        sm.kru[l] = a;
        const uint32_t at = smem_addr(&sm.vin[p & 1][rank][l]);
#pragma unroll
        for (int cb = 0; cb < Bw::NCB; ++cb)
          store_remote(cluster_addr(at, cb), c,
                       cluster_addr(smem_addr(&sm.bar), cb));
      }
    }

    // the sub-chunks in reverse; the partials go to the blocks that own
    // their rows
#pragma unroll
    for (int sb = TILE / SUB - 1; sb >= 0; --sb) {
      float st[SUB][2][4];  // the sub-chunk's states
      if (sb == 0)
        load2x4(s0, s0_stride, st[0]);
      else
        copy2x4(cks[sb > 0 ? sb - 1 : 0], st[0]);
#pragma unroll
      for (int l = 1; l < SUB; ++l) {
        copy2x4(st[l - 1], st[l]);
        bwd_walk(sm, buf, sb * SUB + l - 1, i0, jc, st[l]);
      }
#pragma unroll
      for (int gp = 1; gp >= 0; --gp) {
        // (step s, quantity, row q) at (s * 3 + qty) * 2 + q; (s, col c)
        // at s * 4 + c
        float a[12], dvv[8];
#pragma unroll
        for (int s = 1; s >= 0; --s)
          bwd_step(sm, buf, sb * SUB + gp * 2 + s, i0, jc, st[gp * 2 + s],
                   g, a + s * 6, dvv + s * 4);
        // over the warp's 4 column lanes (lane bits 0-1): lane cl ends
        // with values cl * 3 .. cl * 3 + 2
        fold_lanes<12, 2>(a, lane, FULL);
        // over its 8 row lanes (lane bits 2-4): lane rl ends with value rl
        fold_lanes<8, 16>(dvv, lane, FULL);
        const int l0 = sb * SUB + gp * 2;  // the group's first step
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int vi = cl * 3 + q;
          const int at = ((vi / 2) % 3 * TILE + l0 + vi / 6) * BCOLS + rl * 2 +
                         vi % 2;
          store_remote(owner_pin + 4 * at, a[q], owner_bar);
        }
        sm.dvp[wi][l0 + (rl >> 2)][jc + (rl & 3)] = dvv[0];
      }
    }
    __syncthreads();           // the block's kru and dvp are in
    mbar_wait(&sm.bar, phase);  // and every block's pin and vin
    phase ^= 1;
    if (tid == 0 && p > 0) mbar_expect(&sm.bar, Bw::PIECE_BYTES);  // the next

    // the piece's sums of the block's 16 rows (dr, dk, dw, du) and its 16
    // columns (dv), a (row or column, step) pair a thread, written out
#pragma unroll
    for (int q = 0; q < Bw::PAIRS; ++q) {
      const int pair = tid + q * Bw::THREADS;
      const int rr = pair % BCOLS, l = pair / BCOLS;
      const int i = rank * BCOLS + rr;
      float vdo = 0.f, dr = 0.f, dk = 0.f, dw = 0.f;
#pragma unroll
      for (int cb = 0; cb < Bw::NCB; ++cb) {
        vdo += sm.vin[p & 1][cb][l];
        dr += sm.pin[cb][0][l][rr];
        dk += sm.pin[cb][1][l][rr];
        dw += sm.pin[cb][2][l][rr];
      }
      const float ri = sm.r[buf][l][i], ki = sm.k[buf][l][i];
      const float ui = sm.us[i];
      dr = fmaf(ui * ki, vdo, dr);
      dk = fmaf(ui * ri, vdo, dk);
      du_acc[q] = fmaf(ri * ki, vdo, du_acc[q]);
      float dvs = 0.f;
#pragma unroll
      for (int wj = 0; wj < Bw::WARPS; ++wj) dvs += sm.dvp[wj][l][rr];
      dvs = fmaf(sm.kru[l], sm.d[buf][l][rr], dvs);
      const int t = p * TILE + l;
      if (t < nc) {
        const size_t e = base + (size_t)t * D;
        drkw[e + i] = dr;
        drkw[plane + e + i] = dk;
        drkw[2 * plane + e + i] = dw;
        dv[e + rank * BCOLS + rr] = dvs;
      }
    }
    cluster_arrive_relaxed();  // this thread has read the piece's sums
    __syncthreads();  // the buffer is free for stage stg + 2
  }
  // du: each of the block's rows summed over its step slots in order
#pragma unroll
  for (int q = 0; q < Bw::PAIRS; ++q) {
    const int pair = tid + q * Bw::THREADS;
    sm.dus[pair / BCOLS][pair % BCOLS] = du_acc[q];
  }
  __syncthreads();
  if (tid < BCOLS) {
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < TILE; ++l) s += sm.dus[l][tid];
    part_u[((size_t)b * C + chunk) * D + h * HS + rank * BCOLS + tid] = s;
  }
  cluster_wait();  // pairs the last relaxed arrive
}

// du[d] = sum over batch rows, then chunks, in order, of part_u (B, C, D).
__global__ void wkv_du_kernel(const float* __restrict__ part_u,
                              float* __restrict__ du, int B, int C, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < C; ++c) s += part_u[((size_t)b * C + c) * D + d];
  du[d] = s;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// F1 + F2 (reverse: B1 + B2): out (B, C, H, HS, HS) from a, b, w; delta
// and decay the scratch of C - 1 chunks.
template <int HS>
cudaError_t chain(bool reverse, const float* a, const float* b,
                  const float* w, float* delta, float* decay, float* out,
                  int B, int S, int H, cudaStream_t stream) {
  const int C = (S + CHUNK - 1) / CHUNK;
  cudaError_t err;
  if (C > 1) {
    constexpr int smem = sizeof(ChunkTile<HS>);
    auto kernel = reverse ? wkv_chunk_kernel<HS, true>
                          : wkv_chunk_kernel<HS, false>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<dim3(C - 1, H, B), Fwd<HS>::THREADS, smem, stream>>>(
        a, b, w, delta, decay, H, S);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t total = (size_t)B * H * HS * HS;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (reverse)
    wkv_chain_kernel<true><<<blocks, 256, 0, stream>>>(delta, decay, out, C,
                                                       H, HS, total);
  else
    wkv_chain_kernel<false><<<blocks, 256, 0, stream>>>(delta, decay, out, C,
                                                        H, HS, total);
  return cudaGetLastError();
}

template <int HS>
cudaError_t fwd(const float* r, const float* k, const float* v,
                const float* w, const float* u, const float* states,
                float* o, int B, int S, int H, cudaStream_t stream) {
  constexpr int smem = sizeof(FwdSmem<HS>);
  cudaError_t err = set_smem(wkv_fwd_kernel<HS>, smem);
  if (err != cudaSuccess) return err;
  const int C = (S + CHUNK - 1) / CHUNK;
  wkv_fwd_kernel<HS><<<dim3(C, H, B), Fwd<HS>::THREADS, smem, stream>>>(
      r, k, v, w, u, states, o, H, S);
  return cudaGetLastError();
}

template <int HS>
cudaLaunchConfig_t bwd_config(int C, int B, int H, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Bwd<HS>::NCB * C, H, B);
  cfg.blockDim = dim3(Bwd<HS>::THREADS);
  cfg.dynamicSmemBytes = sizeof(BwdSmem<HS>);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Bwd<HS>::NCB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int HS>
cudaError_t bwd(const float* r, const float* k, const float* v,
                const float* w, const float* u, const float* states,
                const float* g_end, const float* dout, float* dv,
                float* drkw, float* du, float* part_u, float* ckpt, int B,
                int S, int H, int ckpts, cudaStream_t stream) {
  cudaError_t err = set_smem(wkv_bwd_kernel<HS>, sizeof(BwdSmem<HS>));
  if (err != cudaSuccess) return err;
  const int C = (S + CHUNK - 1) / CHUNK;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = bwd_config<HS>(C, B, H, stream, attr);
  err = cudaLaunchKernelEx(&cfg, wkv_bwd_kernel<HS>, r, k, v, w, u, states,
                           g_end, dout, dv, drkw, part_u, ckpt, B, H, S,
                           ckpts);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int D = H * HS;
  wkv_du_kernel<<<(D + 127) / 128, 128, 0, stream>>>(part_u, du, B, C, D);
  return cudaGetLastError();
}

// threads, resident blocks an SM, registers and local (spill) bytes a
// thread of `kernel` at `threads` and `smem` bytes, into out[0..3]
template <typename K>
cudaError_t kernel_info(K kernel, int threads, int smem, int* out) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  out[0] = threads;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

template <int HS>
cudaError_t occupancy(int* out) {
  cudaError_t err = kernel_info(wkv_chunk_kernel<HS, false>,
                                Fwd<HS>::THREADS, sizeof(ChunkTile<HS>),
                                out);
  if (err != cudaSuccess) return err;
  err = kernel_info(wkv_chunk_kernel<HS, true>, Fwd<HS>::THREADS,
                    sizeof(ChunkTile<HS>), out + 4);
  if (err != cudaSuccess) return err;
  err = kernel_info(wkv_fwd_kernel<HS>, Fwd<HS>::THREADS,
                    sizeof(FwdSmem<HS>), out + 8);
  if (err != cudaSuccess) return err;
  err = kernel_info(wkv_bwd_kernel<HS>, Bwd<HS>::THREADS,
                    sizeof(BwdSmem<HS>), out + 12);
  if (err != cudaSuccess) return err;
  // clusters of B3 the whole card holds at once
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = bwd_config<HS>(1, 1, 1, 0, attr);
  return cudaOccupancyMaxActiveClusters(out + 16, wkv_bwd_kernel<HS>, &cfg);
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

bool shapes_ok(int B, int S, int H) {
  return B > 0 && S > 0 && H > 0 && B <= 65535 && H <= 65535 &&
         (S <= CHUNK || S % CHUNK == 0);
}

const float* f(const void* p) { return static_cast<const float*>(p); }
float* f(void* p) { return static_cast<float*>(p); }

}  // namespace

extern "C" {

// The tiling the kernels index their buffers by, for the caller to size
// them: `chunks` stored states a (row, head), `col_blocks` column blocks a
// head (the backward's cluster) and `ckpts` states a chunk the backward
// keeps in its scratch (one at every 16-step piece's start but the
// first).  Zeros for a head size with no instantiation.
void wkv_geometry(int S, int hs, int* chunks, int* col_blocks, int* ckpts) {
  *chunks = (S + CHUNK - 1) / CHUNK;
  *col_blocks = hs == 64 ? Bwd<64>::NCB : hs == 16 ? Bwd<16>::NCB : 0;
  *ckpts = (min(S, CHUNK) + TILE - 1) / TILE - 1;
}

// All launch on `stream`, allocate nothing and do not synchronise.  Every
// tensor is contiguous float32, r, k, v, w and dout 16-byte aligned; hs is
// 16 or 64; D = H hs; with (C, ncb, ckpts) from wkv_geometry(S, hs).
//
// wkv_chain_launch: F1 + F2 (reverse 0: a = k, b = v; out the chunk
// states) or B1 + B2 (reverse 1: a = r, b = dout; out G_end), out (B, C,
// H, hs, hs); the scratch delta (B, C - 1, H, hs, hs) and decay (B, C -
// 1, H, hs).  wkv_fwd_launch: F3, o (B, S, D) from the chunk states.
// wkv_bwd_launch: B3 and the du fold, from the chunk states and G_end:
// dv (B, S, D), drkw (3, B, S, D) (dr, dk, dw), du (H, hs), and the
// scratch part_u (B, C, D) and ckpt (B, C, H, ncb, ckpts, hs, 16).
// Return cudaGetLastError() after the launches.
int wkv_chain_launch(int device, int hs, int reverse, const void* a,
                     const void* b, const void* w, void* delta, void* decay,
                     void* out, int B, int S, int H, void* stream) {
  if (!shapes_ok(B, S, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (hs == 64)
      return chain<64>(reverse, f(a), f(b), f(w), f(delta), f(decay),
                       f(out), B, S, H, st);
    if (hs == 16)
      return chain<16>(reverse, f(a), f(b), f(w), f(delta), f(decay),
                       f(out), B, S, H, st);
    return cudaErrorInvalidValue;
  });
}

int wkv_fwd_launch(int device, int hs, const void* r, const void* k,
                   const void* v, const void* w, const void* u,
                   const void* states, void* o, int B, int S, int H,
                   void* stream) {
  if (!shapes_ok(B, S, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (hs == 64)
      return fwd<64>(f(r), f(k), f(v), f(w), f(u), f(states), f(o), B, S, H,
                     st);
    if (hs == 16)
      return fwd<16>(f(r), f(k), f(v), f(w), f(u), f(states), f(o), B, S, H,
                     st);
    return cudaErrorInvalidValue;
  });
}

int wkv_bwd_launch(int device, int hs, const void* r, const void* k,
                   const void* v, const void* w, const void* u,
                   const void* states, const void* g_end, const void* dout,
                   void* dv, void* drkw, void* du, void* part_u, void* ckpt,
                   int B, int S, int H, int ckpts, void* stream) {
  if (!shapes_ok(B, S, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (hs == 64)
      return bwd<64>(f(r), f(k), f(v), f(w), f(u), f(states), f(g_end),
                     f(dout), f(dv), f(drkw), f(du), f(part_u), f(ckpt), B,
                     S, H, ckpts, st);
    if (hs == 16)
      return bwd<16>(f(r), f(k), f(v), f(w), f(u), f(states), f(g_end),
                     f(dout), f(dv), f(drkw), f(du), f(part_u), f(ckpt), B,
                     S, H, ckpts, st);
    return cudaErrorInvalidValue;
  });
}

// What the card makes of the kernels at head size hs: for F1, B1, F3
// and B3 in turn, threads a block, resident blocks an SM, registers and
// local (spill) bytes a thread (out[0..15]); B3's clusters resident on
// the whole card (out[16]).
int wkv_occupancy(int device, int hs, int* out) {
  return on_device(device, [&]() {
    if (hs == 64) return occupancy<64>(out);
    if (hs == 16) return occupancy<16>(out);
    return cudaErrorInvalidValue;
  });
}

const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
