// RWKV6's WKV recurrence on the H100 (sm_90a), forward and backward.
//
// Replaces the time recurrence of the JAX package's `rwkv_apply`
// (src/repro/models/rwkv.py:105-111: the `step` run by `chunked_scan`,
// src/repro/models/scan_utils.py:18, a `jax.lax.scan` with a
// `jax.checkpoint` every 256 steps) and XLA's autodiff of it.  It is not
// a Pallas kernel; PyTorch has no compiled scan, and an eager step loop
// issues about 6 ops a step.  `ref.wkv_ref` and `ref.wkv_bwd_ref` are
// the plain versions and the specification.
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
// does 6.7 GFLOP, 0.10 ms at the card's 67 TFLOP/s of float32, and must
// move r, k, v, w in and o and the chunk states out, 0.44 GB, 0.13 ms at
// 3.35 TB/s: bound by bytes.  The backward does 18.8 GFLOP (0.28 ms) and
// moves 0.78 GB (0.23 ms): bound by operations.  This kernel spends 7
// and 18 flops an element and step (the u terms per element).  Each
// state element is a chain of S dependent steps; the columns j of a
// head's state are independent in the forward.
//
// Forward: a block holds COLS = 16 columns of one (row, head)'s state, a
// column's HS rows spread over 8 lanes (HS / 8 rows a lane, strided so
// the lanes of a column read neighbouring shared words), 128 threads;
// rwkv6-3b's 40 heads of 64 make 320 blocks at B 2, one wave at 3 blocks
// an SM.  (r, k, w) of every row, as one float4, and v of the block's
// columns are staged a tile of 32 steps at a time through shared memory,
// every load of a tile issued before its first store.  A lane sums its
// rows of o for a group of 8 steps at once, and a transposing butterfly
// over the column's 8 lanes folds them: each level sends the half of
// the steps a lane gives up to its partner and adds the half it keeps,
// so lane q ends with step q's sum, 7 shuffles for 8 steps and none on a
// step's path.  o goes out a tile at a time.  The state at the start of
// every 256-step chunk is written out for the backward, (B, chunks, H,
// HS, HS).  What bounds it on the card: the shared-memory pipe, since
// the 16 columns' lanes all read every row's (r, k, w) (8 LDS.128 a
// warp and step, PERF.md).
//
// Backward: a block holds the same 16 columns, a thread a row (HS
// threads), the chunks in reverse.  Each chunk is walked twice from its
// stored state, 8-step sub-chunks at a time: a checkpoint pass keeps
// the state before every sub-chunk in a per-block global scratch (the
// chunk's last sub-chunk needs none), then the reverse pass takes the
// sub-chunks in reverse, recomputes each one's states into shared
// memory and runs the reverse recurrence of G (the gradient of the state
// after a step) over them, carried in registers.  No state is recovered
// by dividing by w.  A sub-chunk's inputs are staged through shared
// memory, loaded one sub-chunk ahead into registers.  dr, dk and dw are
// sums over the block's columns, in a thread's registers; dv (a sum over
// rows) goes through shared memory a sub-chunk at a time and is added
// over the rows in a fixed order (four chains, row q on chain q % 4); du
// accumulates over the row's steps.  dr, dk, dw go out as one partial a
// column block, du as one a (batch row, column block), and a second
// kernel adds them in order.  No atomics: two backwards are
// bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 256;     // steps between the forward's stored states
constexpr int COLS = 16;       // state columns a block holds
constexpr int FWD_LANES = 8;   // lanes sharing a column in the forward
constexpr int FWD_TILE = 32;   // steps the forward stages at once
constexpr int GROUP = FWD_LANES;  // steps a forward fold covers
// forward blocks an SM the registers must allow: 320 blocks (rwkv6-3b at
// B 2) in one wave on 132 SMs
constexpr int FWD_BLOCKS_PER_SM = 3;
constexpr int SUB = 8;         // steps of a backward sub-chunk
constexpr int NSUB = CHUNK / SUB;

template <int HS>
struct Shape {
  static_assert(HS % COLS == 0 && HS % FWD_LANES == 0, "head size");
  static constexpr int NCB = HS / COLS;               // column blocks a head
  static constexpr int ROWS = HS / FWD_LANES;         // forward rows a lane
  static constexpr int FWD_THREADS = COLS * FWD_LANES;
  static constexpr int BWD_THREADS = HS;
  // backward scratch a block: the state before every SUB-th step of a
  // chunk, (NSUB, COLS, HS) with a thread's row innermost
  static constexpr int SCRATCH = NSUB * COLS * HS;
};

template <int HS>
struct FwdSmem {
  float4 rkw[FWD_TILE][HS];  // (r, k, w, -) of every row
  float v[FWD_TILE][COLS];
  float o[FWD_TILE][COLS];
};

// Stage steps t0 .. t0 + n - 1 of the forward's inputs in shared memory,
// zeros past n: (r, k, w) of every row and v of the block's columns.
// Every load is issued before the first store.
template <int HS>
__device__ __forceinline__ void stage_fwd(
    FwdSmem<HS>& sm, const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ w, const float* __restrict__ v, size_t base,
    size_t col, int D, int t0, int n) {
  constexpr int T = Shape<HS>::FWD_THREADS;
  constexpr int RKW = FWD_TILE * HS / T, V = FWD_TILE * COLS / T;
  float4 x[RKW];
  float y[V];
#pragma unroll
  for (int q = 0; q < RKW; ++q) {
    const int idx = threadIdx.x + q * T, l = idx / HS;
    const size_t at = base + (size_t)(t0 + l) * D + idx % HS;
    x[q] = l < n ? make_float4(r[at], k[at], w[at], 0.f)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int idx = threadIdx.x + q * T, l = idx / COLS;
    y[q] = l < n ? v[col + (size_t)(t0 + l) * D + idx % COLS] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < RKW; ++q) {
    const int idx = threadIdx.x + q * T;
    sm.rkw[idx / HS][idx % HS] = x[q];
  }
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int idx = threadIdx.x + q * T;
    sm.v[idx / COLS][idx % COLS] = y[q];
  }
}

template <int HS>
__global__ void __launch_bounds__(Shape<HS>::FWD_THREADS, FWD_BLOCKS_PER_SM)
wkv_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, float* __restrict__ o,
               float* __restrict__ states, int H, int S) {
  using Sh = Shape<HS>;
  __shared__ FwdSmem<HS> sm;
  const int cb = blockIdx.x % Sh::NCB, h = blockIdx.x / Sh::NCB;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % FWD_LANES, jl = tid / FWD_LANES;
  const int j = cb * COLS + jl;
  const int D = H * HS;
  const int chunks = (S + CHUNK - 1) / CHUNK;
  const size_t base = (size_t)b * S * D + (size_t)h * HS;
  const size_t col = base + cb * COLS;

  float uu[Sh::ROWS], st[Sh::ROWS];
#pragma unroll
  for (int q = 0; q < Sh::ROWS; ++q) {
    uu[q] = u[h * HS + q * FWD_LANES + lane];
    st[q] = 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += FWD_TILE) {
    const int n = min(FWD_TILE, S - t0);
    __syncthreads();  // the last tile's o is out
    stage_fwd(sm, r, k, w, v, base, col, D, t0, n);
    __syncthreads();
    for (int g0 = 0; g0 < n; g0 += GROUP) {
      if ((t0 + g0) % CHUNK == 0) {
        float* dst = states +
                     (((size_t)b * chunks + (t0 + g0) / CHUNK) * H + h) * HS *
                         HS + j;
#pragma unroll
        for (int q = 0; q < Sh::ROWS; ++q)
          dst[(size_t)(q * FWD_LANES + lane) * HS] = st[q];
      }
      // the lane's rows of o at each of the group's steps (the staged
      // zeros past n leave the state 0 after the sequence's end)
      float acc[GROUP];
#pragma unroll
      for (int l = 0; l < GROUP; ++l) {
        const float vj = sm.v[g0 + l][jl];
        float a2[2] = {0.f, 0.f};  // two chains of the sum over rows
#pragma unroll
        for (int q = 0; q < Sh::ROWS; ++q) {
          const float4 x = sm.rkw[g0 + l][q * FWD_LANES + lane];
          const float a = x.y * vj;
          a2[q & 1] = fmaf(x.x, fmaf(uu[q], a, st[q]), a2[q & 1]);
          st[q] = fmaf(x.z, st[q], a);
        }
        acc[l] = a2[0] + a2[1];
      }
      // transposing butterfly over the column's lanes: each level sends
      // the half of the steps a lane gives up to its partner and adds
      // the half it keeps, so lane q ends with step q's sum over rows
#pragma unroll
      for (int m = GROUP / 2; m >= 1; m /= 2) {
        const bool hi = lane & m;
#pragma unroll
        for (int q = 0; q < m; ++q) {
          const float send = hi ? acc[q] : acc[q + m];
          const float keep = hi ? acc[q + m] : acc[q];
          acc[q] = keep + __shfl_xor_sync(0xffffffffu, send, m);
        }
      }
      if (g0 + lane < n) sm.o[g0 + lane][jl] = acc[0];
    }
    __syncthreads();
    for (int idx = tid; idx < n * COLS; idx += Sh::FWD_THREADS) {
      const int l = idx / COLS, c = idx % COLS;
      o[col + (size_t)(t0 + l) * D + c] = sm.o[l][c];
    }
  }
}

template <int HS>
struct BwdSmem {
  float4 rkw[SUB][HS];          // a sub-chunk's (r, k, w, -) of every row
  float4 v[SUB][COLS / 4];      // ... its v and do of the block's columns
  float4 dout[SUB][COLS / 4];
  float st[SUB][COLS][HS];      // ... its states, a thread's row innermost
  float dv[SUB][COLS][HS + 1];  // ... its dv terms, padded rows
};

// One sub-chunk of the backward's inputs in a thread's registers: its
// row's (r, k, w) at each step, and a share of v and do of the block's
// columns as float4s (the wrapper hands 16-byte aligned tensors; HS and
// COLS are multiples of 4), all loads issued at once.
template <int HS>
struct BwdStage {
  static constexpr int VD = SUB * COLS / 4;  // float4s of v (or do)
  static constexpr int VDQ = (VD + HS - 1) / HS;  // ... a thread's
  float4 rkw[SUB];
  float4 v[VDQ], dout[VDQ];

  __device__ __forceinline__ void fetch(
      const float* __restrict__ r, const float* __restrict__ k,
      const float* __restrict__ w, const float* __restrict__ vv,
      const float* __restrict__ dd, size_t base, size_t col, int D, int ts,
      int n) {
    const int i = threadIdx.x;
#pragma unroll
    for (int l = 0; l < SUB; ++l) {
      const size_t at = base + (size_t)(ts + l) * D + i;
      rkw[l] = l < n ? make_float4(r[at], k[at], w[at], 0.f)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < VDQ; ++q) {
      const int idx = i + q * HS;
      const int l = idx / (COLS / 4), c = idx % (COLS / 4);
      v[q] = dout[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < VD && l < n) {
        const size_t at = col + (size_t)(ts + l) * D;
        v[q] = reinterpret_cast<const float4*>(vv + at)[c];
        dout[q] = reinterpret_cast<const float4*>(dd + at)[c];
      }
    }
  }

  __device__ __forceinline__ void commit(BwdSmem<HS>& sm) const {
    const int i = threadIdx.x;
#pragma unroll
    for (int l = 0; l < SUB; ++l) sm.rkw[l][i] = rkw[l];
#pragma unroll
    for (int q = 0; q < VDQ; ++q) {
      const int idx = i + q * HS;
      if (idx < VD) {
        sm.v[idx / (COLS / 4)][idx % (COLS / 4)] = v[q];
        sm.dout[idx / (COLS / 4)][idx % (COLS / 4)] = dout[q];
      }
    }
  }
};

// The block's COLS columns of one step from shared memory.
__device__ __forceinline__ void load_cols(const float4 (&p)[COLS / 4],
                                          float (&out)[COLS]) {
#pragma unroll
  for (int q = 0; q < COLS / 4; ++q) {
    const float4 x = p[q];
    out[4 * q] = x.x;
    out[4 * q + 1] = x.y;
    out[4 * q + 2] = x.z;
    out[4 * q + 3] = x.w;
  }
}

// The stages of a chunk of `nsub` sub-chunks, in order: the checkpoint
// pass over sub-chunks 0 .. nsub - 2 (the last one's end state is never
// needed), then the reverse pass over nsub - 1 .. 0.  Stage `s` of the
// chunk: its sub-chunk, and whether it is of the reverse pass.
__device__ __forceinline__ int stage_sub(int s, int nsub, bool* reverse) {
  *reverse = s >= nsub - 1;
  return *reverse ? 2 * nsub - 2 - s : s;
}

template <int HS>
__global__ void __launch_bounds__(Shape<HS>::BWD_THREADS)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ states,
               const float* __restrict__ dout, float* __restrict__ dv,
               float* __restrict__ part_rkw, float* __restrict__ part_u,
               float* __restrict__ scratch, int B, int H, int S) {
  using Sh = Shape<HS>;
  extern __shared__ float4 smem_raw[];
  BwdSmem<HS>& sm = *reinterpret_cast<BwdSmem<HS>*>(smem_raw);
  const int cb = blockIdx.x % Sh::NCB, h = blockIdx.x / Sh::NCB;
  const int b = blockIdx.y;
  const int i = threadIdx.x;
  const int D = H * HS;
  const int chunks = (S + CHUNK - 1) / CHUNK;
  const size_t plane = (size_t)B * S * D;   // one (B, S, D) array
  const size_t base = (size_t)b * S * D + (size_t)h * HS;
  const size_t col = base + cb * COLS;
  float* ck = scratch + ((size_t)(b * H + h) * Sh::NCB + cb) * Sh::SCRATCH;
  const float ui = u[h * HS + i];
  auto subs = [&](int chunk) {
    return (min(S, (chunk + 1) * CHUNK) - chunk * CHUNK + SUB - 1) / SUB;
  };
  auto stage_steps = [&](int chunk, int sc, int* n) {
    const int ts = chunk * CHUNK + sc * SUB;
    *n = min(SUB, S - ts);
    return ts;
  };

  float g[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) g[c] = 0.f;
  float du = 0.f;
  BwdStage<HS> next;
  {
    bool rev;
    int n;
    const int ts = stage_steps(
        chunks - 1, stage_sub(0, subs(chunks - 1), &rev), &n);
    next.fetch(r, k, w, v, dout, base, col, D, ts, n);
  }

  for (int chunk = chunks - 1; chunk >= 0; --chunk) {
    const int nsub = subs(chunk);
    float s[COLS];
    const float4* src = reinterpret_cast<const float4*>(
        states + (((size_t)b * chunks + chunk) * H + h) * HS * HS +
        (size_t)i * HS + cb * COLS);
#pragma unroll
    for (int q = 0; q < COLS / 4; ++q) {
      const float4 x = src[q];
      s[4 * q] = x.x;
      s[4 * q + 1] = x.y;
      s[4 * q + 2] = x.z;
      s[4 * q + 3] = x.w;
    }
    for (int stg = 0; stg < 2 * nsub - 1; ++stg) {
      bool reverse;
      const int sc = stage_sub(stg, nsub, &reverse);
      int n;
      const int ts = stage_steps(chunk, sc, &n);
      __syncthreads();  // the last stage's inputs and dv terms are used
      next.commit(sm);
      __syncthreads();
      {  // the next stage's loads, in flight while this one runs
        int nc = chunk, ns = stg + 1;
        if (ns == 2 * nsub - 1) nc = chunk - 1, ns = 0;
        if (nc >= 0) {
          bool rev;
          int nn;
          const int nts = stage_steps(nc, stage_sub(ns, subs(nc), &rev), &nn);
          next.fetch(r, k, w, v, dout, base, col, D, nts, nn);
        }
      }
      if (!reverse) {  // keep the state before the sub-chunk, run it
        float* dst = ck + sc * COLS * HS + i;
#pragma unroll
        for (int c = 0; c < COLS; ++c) dst[c * HS] = s[c];
#pragma unroll
        for (int l = 0; l < SUB; ++l) {
          if (l >= n) break;
          const float4 x = sm.rkw[l][i];
          float vv[COLS];
          load_cols(sm.v[l], vv);
#pragma unroll
          for (int c = 0; c < COLS; ++c) s[c] = fmaf(x.z, s[c], x.y * vv[c]);
        }
        continue;
      }
      if (sc != nsub - 1) {  // the last sub-chunk starts where pass 0 ended
        const float* cks = ck + sc * COLS * HS + i;
#pragma unroll
        for (int c = 0; c < COLS; ++c) s[c] = cks[c * HS];
      }
#pragma unroll
      for (int l = 0; l < SUB; ++l) {
        if (l >= n) break;
        const float4 x = sm.rkw[l][i];
        float vv[COLS];
        load_cols(sm.v[l], vv);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          sm.st[l][c][i] = s[c];
          s[c] = fmaf(x.z, s[c], x.y * vv[c]);
        }
      }
#pragma unroll
      for (int l = SUB - 1; l >= 0; --l) {
        if (l >= n) continue;
        const float4 x = sm.rkw[l][i];
        const float ri = x.x, ki = x.y, wi = x.z;
        const float ur = ui * ri;
        float vv[COLS], dd[COLS];
        load_cols(sm.v[l], vv);
        load_cols(sm.dout[l], dd);
        float dr = 0.f, dk = 0.f, dw = 0.f, vdo = 0.f;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const float sj = sm.st[l][c][i];
          const float a = ki * vv[c];
          const float da = fmaf(ur, dd[c], g[c]);  // d loss / d a_t[i, j]
          dk = fmaf(vv[c], da, dk);
          dr = fmaf(fmaf(ui, a, sj), dd[c], dr);
          dw = fmaf(sj, g[c], dw);
          sm.dv[l][c][i] = ki * da;
          g[c] = fmaf(wi, g[c], ri * dd[c]);
          vdo = fmaf(vv[c], dd[c], vdo);
        }
        du = fmaf(ri * ki, vdo, du);
        const size_t e = base + (size_t)(ts + l) * D + i;
        part_rkw[(size_t)(0 * Sh::NCB + cb) * plane + e] = dr;
        part_rkw[(size_t)(1 * Sh::NCB + cb) * plane + e] = dk;
        part_rkw[(size_t)(2 * Sh::NCB + cb) * plane + e] = dw;
      }
      __syncthreads();
      // dv of the sub-chunk: its terms added over the rows in order
      for (int idx = i; idx < n * COLS; idx += HS) {
        const int l = idx / COLS, c = idx % COLS;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, row q on q % 4
#pragma unroll
        for (int q = 0; q < HS; ++q) sum[q % 4] += sm.dv[l][c][q];
        dv[col + (size_t)(ts + l) * D + c] = (sum[0] + sum[1]) +
                                             (sum[2] + sum[3]);
      }
    }
  }
  part_u[((size_t)b * Sh::NCB + cb) * D + h * HS + i] = du;
}

// drkw[q] = sum over the column blocks, in order, of part_rkw[q]; du =
// sum over the batch rows, each row's column blocks in order, of part_u.
__global__ void wkv_bwd_reduce_kernel(const float* __restrict__ part_rkw,
                                      const float* __restrict__ part_u,
                                      float* __restrict__ drkw,
                                      float* __restrict__ du, int ncb, int B,
                                      size_t plane, int D) {
  const size_t total = 3 * plane + D;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    if (idx < 3 * plane) {
      const size_t q = idx / plane, e = idx % plane;
      for (int c = 0; c < ncb; ++c) sum += part_rkw[(q * ncb + c) * plane + e];
      drkw[idx] = sum;
    } else {
      const size_t d = idx - 3 * plane;
      for (int bb = 0; bb < B; ++bb)
        for (int c = 0; c < ncb; ++c)
          sum += part_u[((size_t)bb * ncb + c) * D + d];
      du[d] = sum;
    }
  }
}

template <int HS>
cudaError_t fwd(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* o, void* states, int B, int S, int H,
                cudaStream_t stream) {
  using Sh = Shape<HS>;
  wkv_fwd_kernel<HS><<<dim3(H * Sh::NCB, B), Sh::FWD_THREADS, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(o),
      static_cast<float*>(states), H, S);
  return cudaGetLastError();
}

template <int HS>
cudaError_t bwd(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* states, const void* dout, void* dv,
                void* drkw, void* du, void* part_rkw, void* part_u,
                void* scratch, int B, int S, int H, cudaStream_t stream) {
  using Sh = Shape<HS>;
  constexpr int smem = sizeof(BwdSmem<HS>);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wkv_bwd_kernel<HS><<<dim3(H * Sh::NCB, B), Sh::BWD_THREADS, smem,
                       stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(states),
      static_cast<const float*>(dout), static_cast<float*>(dv),
      static_cast<float*>(part_rkw), static_cast<float*>(part_u),
      static_cast<float*>(scratch), B, H, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t plane = (size_t)B * S * H * HS;
  const size_t total = 3 * plane + (size_t)H * HS;
  const int threads = 256;
  const size_t blocks = (total + threads - 1) / threads;
  wkv_bwd_reduce_kernel<<<(unsigned)(blocks < 65536 * 16 ? blocks
                                                          : 65536 * 16),
                          threads, 0, stream>>>(
      static_cast<const float*>(part_rkw), static_cast<const float*>(part_u),
      static_cast<float*>(drkw), static_cast<float*>(du), Sh::NCB, B, plane,
      H * HS);
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

bool shapes_ok(int B, int S, int H) {
  return B > 0 && S > 0 && H > 0 && B <= 65535 &&
         (S <= CHUNK || S % CHUNK == 0);
}

}  // namespace

extern "C" {

// The tiling the kernels index their buffers by, for the caller to size
// them: `chunks` stored states a (row, head), `col_blocks` column blocks
// a head (the partials' leading extent) and `scratch` floats a backward
// block.  Zeros for a head size with no instantiation.
void wkv_geometry(int S, int hs, int* chunks, int* col_blocks,
                  int* scratch) {
  *chunks = (S + CHUNK - 1) / CHUNK;
  *col_blocks = hs == 64 ? Shape<64>::NCB : hs == 16 ? Shape<16>::NCB : 0;
  *scratch = hs == 64 ? Shape<64>::SCRATCH
                      : hs == 16 ? Shape<16>::SCRATCH : 0;
}

// Both launch on `stream`, allocate nothing and do not synchronise.
// Every tensor is contiguous float32; hs is 16 or 64; D = H hs.  With
// (chunks, ncb, scratch) from wkv_geometry(S, hs): forward: o (B, S, D),
// states (B, chunks, H, hs, hs).  Backward: dv (B, S, D), drkw (3, B, S,
// D) (dr, dk, dw), du (H, hs), and the scratch part_rkw (3, ncb, B, S,
// D), part_u (B, ncb, D) and work (B H ncb, scratch); v and dout 16-byte
// aligned.  Return cudaGetLastError() after the launches.
int wkv_fwd_launch(int device, int hs, const void* r, const void* k,
                   const void* v, const void* w, const void* u, void* o,
                   void* states, int B, int S, int H, void* stream) {
  if (!shapes_ok(B, S, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (hs == 64) return fwd<64>(r, k, v, w, u, o, states, B, S, H, st);
    if (hs == 16) return fwd<16>(r, k, v, w, u, o, states, B, S, H, st);
    return cudaErrorInvalidValue;
  });
}

int wkv_bwd_launch(int device, int hs, const void* r, const void* k,
                   const void* v, const void* w, const void* u,
                   const void* states, const void* dout, void* dv, void* drkw,
                   void* du, void* part_rkw, void* part_u, void* work, int B,
                   int S, int H, void* stream) {
  if (!shapes_ok(B, S, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (hs == 64)
      return bwd<64>(r, k, v, w, u, states, dout, dv, drkw, du, part_rkw,
                     part_u, work, B, S, H, st);
    if (hs == 16)
      return bwd<16>(r, k, v, w, u, states, dout, dv, drkw, du, part_rkw,
                     part_u, work, B, S, H, st);
    return cudaErrorInvalidValue;
  });
}

const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
