// Mamba's selective scan on the H100 (sm_90a), forward and backward.
//
// Replaces the time recurrence of the JAX package's `mamba_apply`
// (src/repro/models/mamba.py:96-107: the `step` run by `chunked_scan`,
// src/repro/models/scan_utils.py:18, a `jax.lax.scan` with a
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
// clock an SM).  The backward must move 1.1 GB (0.33 ms).  Each (row,
// channel, state) is a chain of S dependent steps, independent of the
// other states but for the sums over n (y, dx, d(dt)) and over channels
// (db, dc): B D N = 262,144 chains at jamba's shape.
//
// Mapping: the states across lanes.  A channel's N states are spread
// over L = N / P lanes of one warp, P = 4 states a lane (N 16: 4 lanes
// a channel, 8 channels a warp), so B 1, D 16,384 is 2,048 warps, 15.5
// an SM, each lane with 4 independent chains.  The exps of a step do not
// depend on h, so a lane's 4 chains and the unrolled steps of a tile
// keep the SFU fed.  exp(dt a) is ex2.approx of dt (a log2 e).  A sum
// over a channel's lanes, a step at a time, would cost log2 L shuffles a
// value; instead L steps' values are summed at once by a transposing
// butterfly (`Fold`): each level sends the half of the values a lane
// gives up to its partner and adds the half it keeps, so after log2 L
// levels lane q holds step q's sum, for L - 1 shuffles over L steps.
//
// Forward: blocks of 128 threads (32 channels of one row at N 16; 108
// registers, 4 blocks and 16 warps an SM).  A tile of 16 steps at a time
// is staged through shared memory: b_t and c_t (shared by the row's
// channels), and (dt_t, dt_t x_t) per channel (shared by its lanes),
// loaded coalesced across channels into registers one tile ahead.  Lane
// q of a channel writes y of step q of each group of L steps: L rows of
// 8 channels, whole 32-byte sectors.  The state at the start of every
// 256-step chunk is written out for the backward, (B, ceil(S / 256), D,
// N).  A lane a state (16 lanes a channel at N 16) was the other
// mapping; a probe on the card chose 4 states a lane (PERF.md has both
// times).
//
// Backward: blocks of 128 channels of one row (512 threads at N 16, 128
// registers, one block an SM), the chunks in reverse.  Each chunk is
// walked twice from its stored state, 8-step sub-chunks at a time: pass
// 0 runs it forward and keeps the state before every sub-chunk in a
// thread-private global scratch, sub_h (B, 32, D, N): 33.5 MB at jamba's
// B 1, mostly L2-resident; pass 1 takes the sub-chunks in reverse,
// recomputes each one's 9 states into registers from its stored state,
// and runs the reverse recurrence of g (the gradient of h) over them,
// carried in registers.  The exps are taken again in the reverse steps
// rather than kept: registers, not the SFU, bound this kernel.  dx and
// d(dt) sum over n with the same transposing butterfly (two values a
// step); da accumulates in registers over the row's steps.  db and dc
// are sums over all D channels: a warp folds its 8 channels' 2N values
// (each lane ends holding one value's sum), the block adds its 16 warps
// in order through shared memory and writes one partial per (block,
// row, step), (blocks, B, S, 2N) floats: 67 MB at jamba's shape; a second
// kernel adds the blocks' partials, and the rows' da, in order.  No
// atomics: two backwards are bit-identical.  Each warp stages its own
// channels (a __syncwarp, no block barrier), a sub-chunk's inputs and
// start state loaded into registers one sub-chunk ahead; the block meets
// at a barrier once every 4 sub-chunks, for the sums of db and dc (160
// KB of shared memory at N 16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 256;       // steps between the forward's stored states
constexpr int FWD_THREADS = 128;
constexpr int FWD_TILE = 16;     // steps the forward stages at once
constexpr int BWD_CHANNELS = 128;  // channels of a backward block
constexpr int SUB = 8;           // steps of a backward sub-chunk
constexpr int NSUB = CHUNK / SUB;
constexpr int GROUP = 4;         // sub-chunks between the backward's barriers
constexpr int P = 4;             // states a lane, forward and backward
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 2^v on the SFU (ex2.approx.ftz: one instruction; a result below
// 2^-126 is flushed to 0).
__device__ __forceinline__ float exp2_fast(float v) {
#ifdef __CUDA_ARCH__
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
#else
  return exp2f(v);
#endif
}

template <int V>
struct Log2 {
  static constexpr int value = 1 + Log2<V / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

// A lane's P = 4 states: 4 consecutive floats, 16-byte aligned.
__device__ __forceinline__ void load_p(const float* src, float (&out)[P]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}

__device__ __forceinline__ void store_p(float* dst, const float (&in)[P]) {
  *reinterpret_cast<float4*>(dst) = make_float4(in[0], in[1], in[2], in[3]);
}

// Sums the first C values of v over the lanes that differ in lane bits
// O, O/2, ... (LEVELS of them), transposing: while a lane holds more than
// one value, each level sends the half it gives up to its partner (lane
// ^ O) and adds the half it keeps, the lane with bit O set keeping the
// upper half; once one value is left, plain butterfly levels finish the
// sum.  On exit v[0 .. C >> levels) holds the sums of the values whose
// index's top bits are the lane's bits O, O/2, ... in that order.
template <int C, int O, int LEVELS>
struct Fold {
  template <int V>
  static __device__ __forceinline__ void run(float (&v)[V], int lane) {
    if constexpr (LEVELS > 0) {
      if constexpr (C > 1) {
        const bool upper = (lane & O) != 0;
#pragma unroll
        for (int i = 0; i < C / 2; ++i) {
          const float send = upper ? v[i] : v[i + C / 2];
          const float keep = upper ? v[i + C / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(FULL, send, O);
        }
        Fold<C / 2, O / 2, LEVELS - 1>::run(v, lane);
      } else {
        v[0] += __shfl_xor_sync(FULL, v[0], O);
        Fold<1, O / 2, LEVELS - 1>::run(v, lane);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <int N>
struct FwdShape {
  static constexpr int L = N / P;              // lanes a channel
  static constexpr int C = FWD_THREADS / L;    // channels a block
  static constexpr int VPT = FWD_TILE * C / FWD_THREADS;  // (step, channel)
  static constexpr int BPT =                    // b (and c) values
      (FWD_TILE * N + FWD_THREADS - 1) / FWD_THREADS;
};

template <int N, typename XT>
__global__ void __launch_bounds__(FWD_THREADS)
    scan_fwd_kernel(const XT* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a_in, float* __restrict__ y,
                    float* __restrict__ hs, int S, int D) {
  using Sh = FwdShape<N>;
  constexpr int L = Sh::L, C = Sh::C;
  __shared__ __align__(16) float sb[FWD_TILE][N];
  __shared__ __align__(16) float sc[FWD_TILE][N];
  __shared__ __align__(16) float2 sv[FWD_TILE][C];   // (dt, dt x)
  const int tid = threadIdx.x, lane = tid & 31;
  const int q = tid % L, cl = tid / L;   // lane in the channel, channel
  const int d0 = blockIdx.x * C, d = d0 + cl;
  const bool live = d < D;
  const int b = blockIdx.y;
  const int nc = (S + CHUNK - 1) / CHUNK;
  const size_t row = (size_t)b * S;      // the row's first step
  float a2[P], h[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a2[p] = live ? a_in[(size_t)d * N + q * P + p] * LOG2E : 0.f;
    h[p] = 0.f;
  }
  float ldt[Sh::VPT], lx[Sh::VPT], lb[Sh::BPT], lc[Sh::BPT];
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < Sh::VPT; ++i) {
      const int idx = tid + i * FWD_THREADS, k = idx / C;
      const int dd = d0 + idx % C, t = t0 + k;
      const bool in = dd < D && t < S;
      const size_t at = (row + t) * D + dd;
      ldt[i] = in ? dt[at] : 0.f;
      lx[i] = in ? to_f32(x[at]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < Sh::BPT; ++i) {
      const int idx = tid + i * FWD_THREADS;
      const bool in = idx < FWD_TILE * N && t0 + idx / N < S;
      const size_t at = (row + t0) * N + idx;
      lb[i] = in ? bm[at] : 0.f;
      lc[i] = in ? cm[at] : 0.f;
    }
  };
  load(0);
  for (int t0 = 0; t0 < S; t0 += FWD_TILE) {
    if (t0 % CHUNK == 0 && live)
      store_p(hs + (((size_t)b * nc + t0 / CHUNK) * D + d) * N + q * P, h);
    __syncthreads();   // the previous tile is consumed
#pragma unroll
    for (int i = 0; i < Sh::VPT; ++i) {
      const int idx = tid + i * FWD_THREADS;
      sv[idx / C][idx % C] = make_float2(ldt[i], ldt[i] * lx[i]);
    }
#pragma unroll
    for (int i = 0; i < Sh::BPT; ++i) {
      const int idx = tid + i * FWD_THREADS;
      if (idx < FWD_TILE * N) {
        (&sb[0][0])[idx] = lb[i];
        (&sc[0][0])[idx] = lc[i];
      }
    }
    __syncthreads();
    if (t0 + FWD_TILE < S) load(t0 + FWD_TILE);   // in flight during the tile
#pragma unroll
    for (int g0 = 0; g0 < FWD_TILE; g0 += L) {
      float v[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float2 u = sv[g0 + j][cl];
        float bb[P], cc[P];
        load_p(&sb[g0 + j][q * P], bb);
        load_p(&sc[g0 + j][q * P], cc);
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          h[p] = fmaf(exp2_fast(u.x * a2[p]), h[p], u.y * bb[p]);
          acc = fmaf(h[p], cc[p], acc);
        }
        v[j] = acc;
      }
      Fold<L, L / 2, Log2<L>::value>::run(v, lane);
      const int t = t0 + g0 + q;   // lane q holds step q of the group
      if (live && t < S) y[(row + t) * D + d] = v[0];
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
template <int N>
struct BwdShape {
  static constexpr int L = N / P;
  static constexpr int THREADS = BWD_CHANNELS * L;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int CPW = 32 / L;          // channels a warp
  static constexpr int VPT = SUB / L;         // (step, channel) a lane
  static constexpr int BC4 = 2 * SUB * N / 4;  // float4s of b and c
  static constexpr int BPT = (BC4 + 31) / 32;  // ... a lane
  // db / dc: a warp's channels fold 2P values a lane; the transposing
  // levels, then plain ones over the rest of the channel bits
  static constexpr int FOLD = Log2<2 * P>::value;
  static constexpr int REST = 5 - Log2<L>::value - FOLD;
};

// A warp's staging buffers for one sub-chunk: (dt, x, dy, dt x) of each
// of its channels, b and c of the row.
template <int N>
struct WarpStage {
  float4 v[SUB][BwdShape<N>::CPW];
  float bc[2][SUB][N];   // b, then c
};

// The backward's shared memory (dynamic: 160 KB at N 16): each warp's
// staging, and each warp's db / dc sums of a group of GROUP sub-chunks,
// two groups deep so that one barrier a group orders their writes and
// reads.
template <int N>
struct BwdSmem {
  WarpStage<N> warp[BwdShape<N>::WARPS];
  float wsum[2][BwdShape<N>::WARPS][GROUP * SUB][2 * N];
};

// A backward event: pass 0 runs sub-chunk k of chunk ci forward and keeps
// the state after it; pass 1 runs its reverse steps.  Chunks in reverse;
// within one, pass 0 over k = 0 .. nsub - 2, then pass 1 over k = nsub -
// 1 .. 0.
struct Event {
  int ci, k, pass;
};

__device__ __forceinline__ int subs_of(int ci, int S) {
  return (min(CHUNK, S - ci * CHUNK) + SUB - 1) / SUB;
}

__device__ __forceinline__ Event first_event(int nc, int S) {
  return Event{nc - 1, 0, subs_of(nc - 1, S) == 1 ? 1 : 0};
}

__device__ __forceinline__ bool next_event(Event& e, int S) {
  if (e.pass == 0) {
    if (e.k + 2 < subs_of(e.ci, S)) {
      ++e.k;
    } else {
      e.pass = 1;
      e.k = subs_of(e.ci, S) - 1;
    }
    return true;
  }
  if (e.k > 0) {
    --e.k;
    return true;
  }
  if (e.ci == 0) return false;
  --e.ci;
  e.k = 0;
  e.pass = subs_of(e.ci, S) == 1 ? 1 : 0;
  return true;
}

template <int N, typename XT>
__global__ void __launch_bounds__(BwdShape<N>::THREADS, 1)
    scan_bwd_kernel(const XT* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a_in,
                    const float* __restrict__ hs, const float* __restrict__ dy,
                    XT* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ part_bc, float* __restrict__ part_a,
                    float* __restrict__ sub_h, int S, int D) {
  using Sh = BwdShape<N>;
  constexpr int L = Sh::L, CPW = Sh::CPW, V = 2 * N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<N>& sm = *reinterpret_cast<BwdSmem<N>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane % L, cw = lane / L;   // lane in the channel, channel
  WarpStage<N>& ws = sm.warp[warp];
  const int d0 = blockIdx.x * BWD_CHANNELS + warp * CPW;  // the warp's first
  const int d = d0 + cw;
  const bool live = d < D;
  const int b = blockIdx.y, B = gridDim.y;
  const int nc = (S + CHUNK - 1) / CHUNK;
  const size_t row = (size_t)b * S;
  // where this lane's states sit in rows of (D, N) of hs and sub_h
  const size_t col = (size_t)d * N + q * P;
  // the lane's db / dc value after the channel fold, and whether it
  // writes it (lanes that differ only in channel bits below the fold
  // hold the same sum)
  const int held = lane >> (5 - Sh::FOLD);
  const int u_held = held < P ? q * P + held : N + q * P + held - P;
  const bool writer =
      ((lane >> Log2<L>::value) & ((1 << Sh::REST) - 1)) == 0;
  float a2[P], carry[P], da_acc[P], h[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a2[p] = live ? a_in[col + p] * LOG2E : 0.f;
    carry[p] = 0.f;    // exp(dt_{t+1} a) g_{t+1}
    da_acc[p] = 0.f;
    h[p] = 0.f;
  }
  // the next event's inputs and start state, loaded while this one runs
  float ldt[Sh::VPT], lx[Sh::VPT], ldy[Sh::VPT], lh[P];
  float4 lbc[Sh::BPT];
#pragma unroll
  for (int p = 0; p < P; ++p) lh[p] = 0.f;   // a dead channel's stays 0
  auto load = [&](const Event& e) {
    const int s0 = e.ci * CHUNK + e.k * SUB;
#pragma unroll
    for (int i = 0; i < Sh::VPT; ++i) {
      const int idx = lane + i * 32, j = idx / CPW;
      const int dd = d0 + idx % CPW, t = s0 + j;
      const bool in = dd < D && t < S;
      const size_t at = (row + t) * D + dd;
      ldt[i] = in ? dt[at] : 0.f;
      lx[i] = in ? to_f32(x[at]) : 0.f;
      ldy[i] = in && e.pass == 1 ? dy[at] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < Sh::BPT; ++i) {
      const int idx = lane + i * 32, half = idx / (Sh::BC4 / 2);
      const int r = 4 * (idx % (Sh::BC4 / 2));
      const bool in = idx < Sh::BC4 && s0 + r / N < S &&
                      (half == 0 || e.pass == 1);
      const float* src = (half == 0 ? bm : cm) + (row + s0) * N + r;
      lbc[i] = in ? *reinterpret_cast<const float4*>(src)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // the start state of a pass-1 event, but where pass 0 is making it
    // (the chunk's last sub-chunk: pass 0 ends holding it in h)
    const int ns = subs_of(e.ci, S);
    if (e.pass == 1 && (e.k + 1 < ns || ns == 1) && live)
      load_p(e.k == 0 ? hs + ((size_t)b * nc + e.ci) * D * N + col
                         : sub_h + ((size_t)b * NSUB + e.k) * D * N + col,
                lh);
  };
  Event ev = first_event(nc, S);
  load(ev);
  bool more = true;
  int buf = 0;
  while (more) {
    __syncwarp();   // the warp's previous staging is consumed
#pragma unroll
    for (int i = 0; i < Sh::VPT; ++i) {
      const int idx = lane + i * 32;
      ws.v[idx / CPW][idx % CPW] =
          make_float4(ldt[i], lx[i], ldy[i], ldt[i] * lx[i]);
    }
#pragma unroll
    for (int i = 0; i < Sh::BPT; ++i)
      if (lane + i * 32 < Sh::BC4)
        reinterpret_cast<float4*>(&ws.bc[0][0][0])[lane + i * 32] = lbc[i];
    __syncwarp();
    const Event cur = ev;
    float h_start[P];
#pragma unroll
    for (int p = 0; p < P; ++p) h_start[p] = lh[p];
    more = next_event(ev, S);
    if (more) load(ev);
    const int s0 = cur.ci * CHUNK + cur.k * SUB, len = min(SUB, S - s0);
    const float* h_chunk = hs + ((size_t)b * nc + cur.ci) * D * N + col;
    float* h_sub = sub_h + (size_t)b * NSUB * D * N + col;   // + k D N

    if (cur.pass == 0) {
      // forward over the sub-chunk; keep the state after it
      if (cur.k == 0 && live) load_p(h_chunk, h);
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const float4 u = ws.v[j][cw];
        float bb[P];
        load_p(&ws.bc[0][j][q * P], bb);
#pragma unroll
        for (int p = 0; p < P; ++p)
          h[p] = fmaf(exp2_fast(u.x * a2[p]), h[p], u.w * bb[p]);
      }
      if (live) store_p(h_sub + (size_t)(cur.k + 1) * D * N, h);
      continue;
    }

    // pass 1: the sub-chunk's states into registers, then its reverse
    // steps (the exps taken again there: registers, not the SFU, are
    // what this kernel runs short of)
    float hh[SUB + 1][P];
    const bool from_pass0 = cur.k > 0 && cur.k + 1 == subs_of(cur.ci, S);
#pragma unroll
    for (int p = 0; p < P; ++p) hh[0][p] = from_pass0 ? h[p] : h_start[p];
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const float4 u = ws.v[j][cw];
      float bb[P];
      load_p(&ws.bc[0][j][q * P], bb);
#pragma unroll
      for (int p = 0; p < P; ++p)
        hh[j + 1][p] = fmaf(exp2_fast(u.x * a2[p]), hh[j][p], u.w * bb[p]);
    }
#pragma unroll
    for (int g0 = SUB - L; g0 >= 0; g0 -= L) {
      float v[2 * L];   // per step of the group: sum_n g b, sum_n t1 a
#pragma unroll
      for (int jj = L - 1; jj >= 0; --jj) {
        const int j = g0 + jj;
        const float4 u = ws.v[j][cw];   // dt, x, dy, dt x
        float bb[P], cc[P], w[2 * P];   // w: db's then dc's terms
        load_p(&ws.bc[0][j][q * P], bb);
        load_p(&ws.bc[1][j][q * P], cc);
        float sgb = 0.f, sdt = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float e = exp2_fast(u.x * a2[p]);
          const float g = fmaf(u.z, cc[p], carry[p]);
          w[p] = g * u.w;
          w[P + p] = u.z * hh[j + 1][p];
          sgb = fmaf(g, bb[p], sgb);
          carry[p] = e * g;
          const float t1 = carry[p] * hh[j][p];   // g h_{t-1} exp(dt a)
          sdt = fmaf(t1, a2[p], sdt);
          da_acc[p] = fmaf(t1, u.x, da_acc[p]);
        }
        v[2 * jj] = sgb;
        v[2 * jj + 1] = sdt;
        Fold<2 * P, 16, 5 - Log2<L>::value>::run(w, lane);
        if (writer)
          sm.wsum[buf][warp][cur.k % GROUP * SUB + j][u_held] = w[0];
      }
      Fold<2 * L, L / 2, Log2<L>::value>::run(v, lane);
      const int j = g0 + q;   // lane q holds step q of the group
      if (live && j < len) {
        const float4 u = ws.v[j][cw];
        const size_t at = (row + s0 + j) * D + d;
        put(dx + at, u.x * v[0]);
        // sum_n t1 a: the terms carry a log2 e, taken out once here
        ddt[at] = v[1] * LN2 + u.y * v[0];
      }
    }
    if (cur.k % GROUP != 0) continue;
    // the group of sub-chunks k .. k + GROUP - 1 is done
    __syncthreads();   // every warp's sums of the group are in
    // the block's partial of every step of the group, warps in order
    for (int i = tid; i < min(GROUP * SUB, S - s0) * V; i += Sh::THREADS) {
      const int j = i / V, u = i % V;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < Sh::WARPS; ++w) s += sm.wsum[buf][w][j][u];
      part_bc[(((size_t)blockIdx.x * B + b) * S + s0 + j) * V + u] = s;
    }
    buf ^= 1;
  }
  if (live) {
    float out[P];
#pragma unroll
    for (int p = 0; p < P; ++p) out[p] = da_acc[p];
    store_p(part_a + (size_t)b * D * N + col, out);
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

template <int N, typename XT>
cudaError_t fwd(const void* x, const void* dt, const void* bm, const void* cm,
                const void* a, void* y, void* hs, int B, int S, int D,
                cudaStream_t stream) {
  constexpr int C = FwdShape<N>::C;
  const dim3 grid((D + C - 1) / C, B);
  scan_fwd_kernel<N, XT><<<grid, FWD_THREADS, 0, stream>>>(
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
  const int blocks = (D + BWD_CHANNELS - 1) / BWD_CHANNELS;
  constexpr int smem = sizeof(BwdSmem<N>);
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<N, XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  scan_bwd_kernel<N, XT><<<dim3(blocks, B), BwdShape<N>::THREADS, smem,
                           stream>>>(
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

// The template arguments of one instantiation, as a value for a generic
// lambda.
template <int N_, typename XT_>
struct Inst {
  static constexpr int N = N_;
  using XT = XT_;
};

// Calls fn(Inst<N, XT>{}) for the instantiation the arguments name: N 4
// or 16, x float32 or bf16.
template <typename F>
cudaError_t dispatch(int n_state, int x_bf16, F fn) {
  using bf16 = __nv_bfloat16;
  if (n_state == 16)
    return x_bf16 ? fn(Inst<16, bf16>{}) : fn(Inst<16, float>{});
  if (n_state == 4)
    return x_bf16 ? fn(Inst<4, bf16>{}) : fn(Inst<4, float>{});
  return cudaErrorInvalidValue;
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

bool shapes_ok(int B, int S, int D) {
  return B > 0 && S > 0 && D > 0 && B <= 65535;
}

// out: resident blocks an SM, registers a thread, local (spill) bytes a
// thread.
template <typename K>
cudaError_t kernel_info(K kernel, int threads, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The tiling the kernels index their buffers by, for the caller to size
// them: `chunks` states a row in hs, `blocks` channel blocks in part_bc
// and `subs` sub-chunk states a row in sub_h.
void selective_scan_geometry(int S, int D, int* chunks, int* blocks,
                             int* subs) {
  *chunks = (S + CHUNK - 1) / CHUNK;
  *blocks = (D + BWD_CHANNELS - 1) / BWD_CHANNELS;
  *subs = NSUB;
}

// What the card makes of the kernels at d_state n_state: out[8] = the
// forward's threads a block, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread
// and local (spill) bytes a thread, then the backward's four.
int selective_scan_occupancy(int device, int n_state, int x_bf16, int* out) {
  return on_device(device, [&]() {
    return dispatch(n_state, x_bf16, [&](auto inst) {
      using I = decltype(inst);
      out[0] = FWD_THREADS;
      cudaError_t err = kernel_info(scan_fwd_kernel<I::N, typename I::XT>,
                                    FWD_THREADS, 0, out + 1);
      if (err != cudaSuccess) return err;
      out[4] = BwdShape<I::N>::THREADS;
      return kernel_info(scan_bwd_kernel<I::N, typename I::XT>, out[4],
                         (int)sizeof(BwdSmem<I::N>), out + 5);
    });
  });
}

// Both launch on `stream`, allocate nothing and do not synchronise.
// Every tensor is contiguous; x (and dx) is float32, or bf16 with
// `x_bf16`; everything else float32.  n_state is 4 or 16.  With
// (chunks, blocks, subs) from
// selective_scan_geometry(S, D): forward: y (B, S, D), hs (B, chunks,
// D, N).  Backward: dx, d(dt) (B, S, D), db, dc (B, S, N), da (D, N),
// and the scratch part_bc (blocks, B, S, 2N), part_a (B, D, N) and
// sub_h (B, subs, D, N).  Return cudaGetLastError() after the launches.
int selective_scan_fwd_launch(int device, int n_state, int x_bf16,
                              const void* x, const void* dt, const void* bm,
                              const void* cm, const void* a, void* y,
                              void* hs, int B, int S, int D, void* stream) {
  if (!shapes_ok(B, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return dispatch(n_state, x_bf16, [&](auto inst) {
      using I = decltype(inst);
      return fwd<I::N, typename I::XT>(x, dt, bm, cm, a, y, hs, B, S, D, s);
    });
  });
}

int selective_scan_bwd_launch(int device, int n_state, int x_bf16,
                              const void* x, const void* dt, const void* bm,
                              const void* cm, const void* a, const void* hs,
                              const void* dy, void* dx, void* ddt, void* db,
                              void* dc, void* da, void* part_bc, void* part_a,
                              void* sub_h, int B, int S, int D, void* stream) {
  if (!shapes_ok(B, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return dispatch(n_state, x_bf16, [&](auto inst) {
      using I = decltype(inst);
      return bwd<I::N, typename I::XT>(x, dt, bm, cm, a, hs, dy, dx, ddt, db,
                                       dc, da, part_bc, part_a, sub_h, B, S, D,
                                       s);
    });
  });
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
