// The translation simulator's timing epilogue for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the JAX simulator's `epilogue` (src/repro/sim/simulator.py:558,
// inside `_build_model`), which the JAX runner fuses into its jitted chunk;
// the plain version and specification is `sim_epilogue_ref` in
// src/repro_torch/kernels/ref.py.
//
// What it computes.  For each (lane l, mechanism m) it re-derives, from a
// chunk's packed hit bits (the LRU scan's (T, L, M) output, read in that
// orientation), the gates the scan used and each step's timing: the
// per-line hierarchy latency (l1, or l1/l2/l3, then memory plus the queue
// delay and the multi-stack penalty), the walk's per-level latency (a PWC
// hit, memory for a bypassing mechanism, else the hierarchy), a serial or
// parallel (ECH) walk, the cache-as-TLB probe, the L2-TLB latency and the
// huge-page stall, and the step's cycles.  Over the chunk it sums nine
// counters, the cycles and the memory accesses, and adds them into the
// engine's state: counters and clock (B, M, C), mem_accs (B, M).
//
// Float rules.  Each step's terms are float32, in the plain version's
// order of operations; the one product (the multi-stack penalty) is
// __fmul_rn, so it is never contracted into a multiply-add and rounds on
// its own, as the plain version's does.  The chunk's partial sums are
// float64, rounded once to float32 and then added to the state in
// float32.  Counters of events are integers and come out exact.  Every
// sum runs in a fixed order (a thread's steps, then the block's warps,
// then the step tiles, each in order), so two launches from the same
// state give bit-identical states.
//
// Bound.  A streaming reduction over T: the packed bits (4 B a (t, l, m)),
// work (4 B), is4k and valid (1 B each a (t, l)) read once, a few hundred
// bytes of per-lane parameters and the state read and written once: about
// 2.4 MB for a 1,024-step chunk of the ndp_machine(8) bucket, 0.7 us at
// 3.35 TB/s.  The work is about 140 instructions a (step, column) (about
// 230 banked), 450 K of them in that chunk, some 3 us of issue over the
// card's 528 warp schedulers, and the fold is a chain of global round
// trips: the kernel is bound by issue and latency, not by bytes.
//
// Design.  A column is one (lane l, mechanism m); the columns of one
// (simulation b, mechanism m) group, its C lanes, are neighbours, in the
// state's own (B, M, C) order.  The grid is column tiles x step tiles.
// A block holds 32 columns, one a lane: up to 32 / C whole groups a tile
// where C <= 32, else a 32-lane piece of one group; and 16 warps, each
// walking `steps` consecutive steps of the block's step tile.  A warp's
// loads of packed (and of the walk lines) then fall in a few sectors of
// one step, and those of work, is4k, valid, vpn and off are a few
// broadcast words.  A thread issues the loads of 2 steps at once, then
// their arithmetic; the host picks `steps` (a multiple of 2) so that the
// grid fits the card's resident warps in one wave: geometry() below.
//
// Fold, in a fixed order and without float atomics.  A block sums its
// warps' partials a column in warp order through shared memory and
// writes them (float64) to its step tile's row of a scratch.  The last
// block of a column tile to finish (an integer ticket) folds the rows:
// its warps take contiguous ranges of step tiles in order, then the
// warps' sums fold in warp order, and the result is rounded once and
// added into the state; it then sums each whole group's memory accesses
// over its lanes in lane order into mem_accs.  Where C > 32 a group's
// pieces meet through a second ticket, the last to arrive summing them in
// order.  The block that takes a last ticket resets it, so the ticket
// array stays zero between launches; launches that share it must not
// overlap (the wrapper keeps one a stream).
//
// Banked memory (the BANKED instantiation).  A memory access at one of
// the five sites costs the closed-row latency, less the precharge and
// activate an open-row hit skips (the scan's five row-buffer bits, after
// every other bit), plus its own bank's queue delay: bank = line /
// lines_per_row % banks, the lines being the four PTE lines the scan
// read (pte, (T, L, M) x 4) and the data line vpn * 64 + off.  The queue
// delays of the block's 32 columns sit in shared memory; a column's
// accesses are counted per bank there, integers, by shared-memory atomics
// (exact in any order), folded over the tiles and the lanes like the
// rest, and added into mem_accs (B, M, banks).
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;            // columns a block: one a lane
constexpr int WARPS = 16;            // step slices a block: one a warp
constexpr int THREADS = LANES * WARPS;
constexpr int GROUP = 2;             // steps a thread loads at once
constexpr int MAX_STEP_TILES = 65535;  // gridDim.y
constexpr int MAX_DEVICES = 64;
constexpr int MAX_PTE = 4;
constexpr int MAX_HIER = 3;
constexpr int MAX_CORES = 256;
constexpr int MAX_BANKS = 64;
// flag word bits (ref.FLAG_*)
constexpr int FLAG_IDEAL = 1, FLAG_HUGE = 2, FLAG_BYPASS = 4,
              FLAG_SEGMENT = 8, FLAG_CACHE_TLB = 16, FLAG_COLOCATE = 1 << 9,
              FLAG_PARALLEL = 1 << 10;
constexpr int FLAG_N_PTE_SHIFT = 12;
// per-lane parameter columns (ref.EPILOGUE_PARAMS)
enum {
  P_MEM_LAT, P_L1_LAT, P_L2_LAT, P_L3_LAT, P_L2TLB_LAT, P_PWC_LAT, P_PROMO,
  P_ECH_REHASH, P_CTLB_LAT, P_STACK_PEN, P_ROW_SAVE, N_PARAMS
};
// outputs (ref.COUNTERS, then the clock and the memory accesses)
enum {
  O_TRANS, O_WALKS, O_WALK_CYC, O_L1TLB_MISS, O_PTE_ACC, O_PTE_L1_HIT,
  O_PTE_MEM, O_DATA_L1_MISS, O_DATA_MEM, O_CLOCK, O_MEM, N_OUT
};
// a column's slots in the block sums and the scratch: the float sums
// (float64), then the counts (int), each slot's output in SLOT_OUT; a
// bounded memory adds the column's memory accesses as one more count, a
// banked one its accesses a bank
constexpr int N_COL = O_CLOCK + 1;
constexpr int N_FLOAT = 3, N_INT = N_COL - N_FLOAT;
__constant__ int SLOT_OUT[N_COL] = {
    O_TRANS,  O_WALK_CYC,   O_CLOCK,        O_WALKS,    O_L1TLB_MISS,
    O_PTE_ACC, O_PTE_L1_HIT, O_PTE_MEM, O_DATA_L1_MISS, O_DATA_MEM};

__device__ __forceinline__ void prefetch_l2(const void* ptr) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(ptr));
}

struct Params {
  const int* packed;            // (T, L, M)
  const float* work;            // (T, L)
  const unsigned char* is4k;    // (T, L)
  const unsigned char* valid;   // (T, L)
  const float* q;               // (B, M); banked (B, M, banks)
  const int* flags;             // (L, M)
  const float* params;          // (L, N_PARAMS)
  const int4* pte;              // (T, L, M) x 4, banked only
  const int* vpn;               // (T, L), banked only
  const int* off;               // (T, L), banked only
  float* out[N_OUT];            // (B, M, C) each; O_MEM (B, M[, banks])
  double* part_f;               // (step tiles, N_FLOAT, col tiles, 32)
  int* part_i;                  // (step tiles, N_INT + nb, col tiles, 32)
  int* pieces;                  // C > 32: (B * M, nb, P)
  unsigned* tickets;            // column tiles, then B * M where C > 32
  int T, B, C, M, L, n_hier;
  int G, P, col_tiles;          // groups a tile (C <= 32), tiles a group
  bool ctlb;
  int banks, nb;                // nb: banks, or 1 for a bounded memory
  int steps;                    // steps a thread, a multiple of GROUP
  unsigned long long row_magic, bank_magic;  // / lines_per_row, / banks
  int row_shift, bank_shift;
  unsigned long long c_magic, m_magic;  // / C, / M
  int c_shift, m_shift;
};

// magic and shift that divide a key 0 <= key < 2^31 by d with a multiply:
// magic = floor(2^shift / d) + 1, shift = 31 + ceil(log2 d) (the error is
// below 2^31 / 2^shift <= 1 / d, so the quotient is exact)
void divisor(int d, unsigned long long& magic, int& shift) {
  int log2 = 0;
  while ((1LL << log2) < d) ++log2;
  shift = 31 + log2;
  magic = (1ULL << shift) / (unsigned long long)d + 1;
}

__device__ __forceinline__ int quotient(int key, unsigned long long magic,
                                        int shift) {
  return (int)(((unsigned long long)(unsigned)key * magic) >> shift);
}

// The column that lane j of column tile ct holds: its group g = b * M + m
// and core c; false where the lane holds none.
__device__ __forceinline__ bool column_of(const Params& p, int ct, int j,
                                          int& g, int& c) {
  if (p.P == 1) {               // C <= 32: G whole groups a tile
    const int k = quotient(j, p.c_magic, p.c_shift);
    g = ct * p.G + k;
    c = j - k * p.C;
    return k < p.G && g < p.B * p.M;
  }
  g = ct / p.P;                 // C > 32: a 32-lane piece of one group
  c = (ct - g * p.P) * LANES + j;
  return c < p.C;
}

// The per-column constants: the mechanism's flags and the lane's
// latencies.  A line that first hits at hierarchy level h costs hit[h] =
// l1 (+ l2 (+ l3)), summed in that order as the plain version sums them;
// one that misses them all costs top = hit[n_hier - 1] plus its memory
// cost.
struct Column {
  bool ideal, huge, bypass, segment, cache_tlb, parallel;
  int n_pte;
  float hit[MAX_HIER];
  float top;                    // hit[n_hier - 1]: the last level's
  float mem_cost0;              // bounded: every site's memory cost
  float miss0;                  // bounded: a line that reaches memory
  float mem_lat, row_save, pen, pwc_lat, ech_rehash, ctlb_lat, l2tlb_lat,
      promo, l1_lat;
};

template <bool BANKED>
__device__ __forceinline__ Column column(const Params& p, int l, int col,
                                         int g) {
  const int flags = p.flags[col];
  const float* dp = p.params + (size_t)l * N_PARAMS;
  Column k;
  k.ideal = flags & FLAG_IDEAL;
  k.huge = flags & FLAG_HUGE;
  k.bypass = flags & FLAG_BYPASS;
  k.segment = flags & FLAG_SEGMENT;
  k.cache_tlb = flags & FLAG_CACHE_TLB;
  k.parallel = flags & FLAG_PARALLEL;
  k.n_pte = (flags >> FLAG_N_PTE_SHIFT) & 7;
  k.hit[0] = dp[P_L1_LAT];
  k.hit[1] = k.hit[0] + dp[P_L2_LAT];
  k.hit[2] = k.hit[1] + dp[P_L3_LAT];
  k.pen = __fmul_rn(dp[P_STACK_PEN], (flags & FLAG_COLOCATE) ? 0.1f : 1.0f);
  k.mem_cost0 = BANKED ? 0.0f : (dp[P_MEM_LAT] + p.q[g]) + k.pen;
  k.top = p.n_hier == MAX_HIER ? k.hit[2] : k.hit[0];
  k.miss0 = k.top + k.mem_cost0;
  k.mem_lat = dp[P_MEM_LAT];
  k.row_save = dp[P_ROW_SAVE];
  k.pwc_lat = dp[P_PWC_LAT];
  k.ech_rehash = dp[P_ECH_REHASH];
  k.ctlb_lat = dp[P_CTLB_LAT];
  k.l2tlb_lat = dp[P_L2TLB_LAT];
  k.promo = dp[P_PROMO];
  k.l1_lat = dp[P_L1_LAT];
  return k;
}

// One step's inputs of one column.
struct StepIn {
  int bits;
  float work;
  bool valid, is4k;
  int lines[5];                 // banked: pte0..3, data
};

// A thread's input pointers at its next step, and their strides a step.
struct Cursor {
  const int* packed;
  const float* work;
  const unsigned char* valid;
  const unsigned char* is4k;
  const int4* pte;
  const int* vpn;
  const int* off;
  int lanes, cols;              // L and L * M
};

template <bool BANKED>
__device__ __forceinline__ Cursor cursor(const Params& p, int t, int l,
                                         int col) {
  const size_t tl = (size_t)t * p.L + l;
  const size_t tc = (size_t)t * p.L * p.M + col;
  Cursor at;
  at.packed = p.packed + tc;
  at.work = p.work + tl;
  at.valid = p.valid + tl;
  at.is4k = p.is4k + tl;
  at.pte = BANKED ? p.pte + tc : nullptr;
  at.vpn = BANKED ? p.vpn + tl : nullptr;
  at.off = BANKED ? p.off + tl : nullptr;
  at.lanes = p.L;
  at.cols = p.L * p.M;
  return at;
}

// compile-time values passed as arguments
template <int V>
struct Int {
  static constexpr int value = V;
};
template <bool V>
struct Bool {
  static constexpr bool value = V;
};

// A thread's partial sums of one column: the float sums (float64) and
// the counts (int), in slot order (SLOT_OUT), then (bounded memory) the
// column's memory accesses, which the step pass sets at its end.
struct Acc {
  double trans = 0.0, walk_cyc = 0.0, cyc = 0.0;
  int walks = 0, l1tlb_miss = 0, pte_acc = 0, pte_l1_hit = 0, pte_mem = 0,
      data_l1_miss = 0, data_mem = 0, mem = 0;

  // into a warp's rows of the block's sums
  __device__ __forceinline__ void to_shared(double (*f)[LANES],
                                            int (*n)[LANES], int lane,
                                            bool with_mem) const {
    f[0][lane] = trans;
    f[1][lane] = walk_cyc;
    f[2][lane] = cyc;
    n[0][lane] = walks;
    n[1][lane] = l1tlb_miss;
    n[2][lane] = pte_acc;
    n[3][lane] = pte_l1_hit;
    n[4][lane] = pte_mem;
    n[5][lane] = data_l1_miss;
    n[6][lane] = data_mem;
    if (with_mem) n[N_INT][lane] = mem;
  }

  // one step tile's row of a column (slots `row` apart), all loads
  // issued before the adds
  __device__ __forceinline__ void add_row(const double* f, const int* n,
                                          size_t row, bool with_mem) {
    const double x0 = __ldcg(f), x1 = __ldcg(f + row),
                 x2 = __ldcg(f + 2 * row);
    int k[N_INT + 1];
#pragma unroll
    for (int i = 0; i < N_INT; ++i) k[i] = __ldcg(n + i * row);
    k[N_INT] = with_mem ? __ldcg(n + N_INT * row) : 0;
    trans += x0;
    walk_cyc += x1;
    cyc += x2;
    walks += k[0];
    l1tlb_miss += k[1];
    pte_acc += k[2];
    pte_l1_hit += k[3];
    pte_mem += k[4];
    data_l1_miss += k[5];
    data_mem += k[6];
    mem += k[N_INT];
  }
};

// The inputs of the next GROUP steps, all loads issued before any is
// used; the cursor moves past them.  Steps from the `n`-th on lie past
// the thread's end: no bits and not valid, so they add exactly nothing.
template <bool BANKED>
__device__ __forceinline__ void load_group(Cursor& at, int n,
                                           StepIn (&in)[GROUP]) {
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    StepIn& s = in[j];
    const bool real = j < n;
    s.bits = real ? __ldg(at.packed + (size_t)j * at.cols) : 0;
    s.work = real ? __ldg(at.work + (size_t)j * at.lanes) : 0.0f;
    s.valid = real && __ldg(at.valid + (size_t)j * at.lanes) != 0;
    s.is4k = real && __ldg(at.is4k + (size_t)j * at.lanes) != 0;
    if (BANKED) {
      const int4 pl =
          real ? __ldg(at.pte + (size_t)j * at.cols) : make_int4(0, 0, 0, 0);
      s.lines[0] = pl.x;
      s.lines[1] = pl.y;
      s.lines[2] = pl.z;
      s.lines[3] = pl.w;
      s.lines[4] = real ? __ldg(at.vpn + (size_t)j * at.lanes) * 64 +
                              __ldg(at.off + (size_t)j * at.lanes)
                        : 0;
    }
  }
  at.packed += (size_t)GROUP * at.cols;
  at.work += (size_t)GROUP * at.lanes;
  at.valid += (size_t)GROUP * at.lanes;
  at.is4k += (size_t)GROUP * at.lanes;
  if (BANKED) {
    at.pte += (size_t)GROUP * at.cols;
    at.vpn += (size_t)GROUP * at.lanes;
    at.off += (size_t)GROUP * at.lanes;
  }
}

// One step of one column into `a`, for NH hierarchy levels and a
// cache-as-TLB table or none (CTLB); banked: q_row is the column's queue
// delay a bank and n_row its access count a bank, in shared memory.  The
// hit bits are read as masks: bit i of a site mask is site i (pte0..3,
// data).
template <bool BANKED, int NH, bool CTLB>
__device__ __forceinline__ void step(const Params& p, const Column& k,
                                     const StepIn& s, const float* q_row,
                                     int* n_row, Acc& a) {
  const unsigned bits = (unsigned)s.bits;
  constexpr int ctlb_bit = 6 + 5 * NH;
  // the sites that hit at each hierarchy level, and those that missed all
  const unsigned h0 = (bits >> 6) & 31u;
  const unsigned h1 = NH == MAX_HIER ? (bits >> 11) & 31u : 0u;
  const unsigned h2 = NH == MAX_HIER ? (bits >> 16) & 31u : 0u;
  const unsigned went_mem = ~(h0 | h1 | h2) & 31u;

  // each site's memory cost: banked, its bank's queue delay and the
  // row-buffer discount
  float mem_cost[5];
  int bank[5];
  if (BANKED) {
    const unsigned row_hit = bits >> (ctlb_bit + (CTLB ? 1 : 0));
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int row = quotient(s.lines[i], p.row_magic, p.row_shift);
      bank[i] = row - quotient(row, p.bank_magic, p.bank_shift) * p.banks;
      const float save = (row_hit >> i) & 1u ? k.row_save : 0.0f;
      mem_cost[i] = ((k.mem_lat - save) + q_row[bank[i]]) + k.pen;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 5; ++i) mem_cost[i] = k.mem_cost0;
  }

  // each site's latency: the hierarchy down to its first hit, else memory
  float lat[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    float v = BANKED ? k.top + mem_cost[i] : k.miss0;
    if (NH == MAX_HIER) {
      v = (h2 >> i) & 1u ? k.hit[2] : v;
      v = (h1 >> i) & 1u ? k.hit[1] : v;
    }
    lat[i] = (h0 >> i) & 1u ? k.hit[0] : v;
  }

  const bool h_l1tlb = bits & 1u, h_l2tlb = bits & 2u;
  const bool en0 = s.valid && !k.ideal && !(k.segment && !s.is4k);
  bool walk = en0 && !h_l1tlb && !h_l2tlb;
  bool ctlb_probe = false;
  if (CTLB) {
    ctlb_probe = walk && k.cache_tlb;
    walk = walk && !((bits >> ctlb_bit) & 1u);
  }
  const int eff_n = (k.huge && s.is4k) ? MAX_PTE : k.n_pte;

  // the walk's levels (mask bit lvl): enabled, missing the PWC, in memory
  const unsigned pwc = (bits >> 2) & 15u;
  const unsigned en =
      walk ? (eff_n >= MAX_PTE ? 15u : (1u << eff_n) - 1u) : 0u;
  const unsigned need_mem = en & ~pwc;
  const unsigned pte_mem = need_mem & (k.bypass ? 15u : went_mem);
  a.pte_acc += __popc(need_mem);
  a.pte_l1_hit += __popc(h0 & 15u);
  a.pte_mem += __popc(pte_mem);
  float lat_max = 0.0f, lat_sum = 0.0f;
#pragma unroll
  for (int lvl = 0; lvl < MAX_PTE; ++lvl) {
    float v = k.bypass ? mem_cost[lvl] : lat[lvl];
    v = (pwc >> lvl) & 1u ? k.pwc_lat : v;
    const float pte_lat = (en >> lvl) & 1u ? v : 0.0f;
    lat_max = lvl == 0 ? pte_lat : fmaxf(lat_max, pte_lat);
    lat_sum = lvl == 0 ? pte_lat : lat_sum + pte_lat;
    if (BANKED && ((pte_mem >> lvl) & 1u)) atomicAdd(&n_row[bank[lvl]], 1);
  }
  const float walk_cyc =
      k.parallel ? (lat_max + 2.0f) + k.ech_rehash : lat_sum;

  float trans = walk ? walk_cyc : 0.0f;
  if (CTLB) trans = trans + (ctlb_probe ? k.ctlb_lat : 0.0f);
  trans = (en0 && !h_l1tlb) ? k.l2tlb_lat + trans : 0.0f;
  trans = trans + ((k.huge && s.valid) ? k.promo : 0.0f);

  const float dlat = s.valid ? lat[MAX_PTE] : 0.0f;
  const float step_cyc =
      s.valid ? ((s.work + 1.0f) + trans) + (dlat - k.l1_lat) : 0.0f;

  a.trans += (double)trans;
  a.walks += walk;
  a.walk_cyc += (double)(walk ? walk_cyc : 0.0f);
  a.l1tlb_miss += en0 && !h_l1tlb;
  a.data_l1_miss += s.valid && !(h0 & 16u);
  const bool data_mem = s.valid && (went_mem & 16u);
  a.data_mem += data_mem;
  if (BANKED && data_mem) atomicAdd(&n_row[bank[MAX_PTE]], 1);
  a.cyc += (double)step_cyc;
}

// Steps t_begin .. t_end - 1 of one column into `acc`, GROUP at a time;
// `in` holds the first group's inputs, `at` points past them.
template <bool BANKED, int NH, bool CTLB>
__device__ __forceinline__ void walk_steps(const Params& p, const Column& k,
                                           Cursor& at, StepIn (&in)[GROUP],
                                           int t_begin, int t_end,
                                           const float* q_row, int* n_row,
                                           Acc& acc) {
  for (int t0 = t_begin;;) {
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      step<BANKED, NH, CTLB>(p, k, in[j], q_row, n_row, acc);
    t0 += GROUP;
    if (t0 >= t_end) break;
    load_group<BANKED>(at, t_end - t0, in);
  }
}

template <bool BANKED>
__global__ void __launch_bounds__(THREADS, BANKED ? 1 : 2)
    sim_epilogue_kernel(const Params p) {
  constexpr int NI = BANKED ? N_INT : N_INT + 1;  // bounded: + accesses
  constexpr int NS = N_FLOAT + NI;                // slots a column
  // the block's partials: a warp's row a slot, one column a lane
  __shared__ double red_f[WARPS][N_FLOAT][LANES];
  __shared__ int red_i[WARPS][NI][LANES];
  // banked: each column's queue delay and access count a bank (rows
  // padded so that lanes of other columns fall on other shared banks)
  __shared__ float q_bank[BANKED ? LANES : 1][BANKED ? MAX_BANKS + 1 : 1];
  __shared__ int n_bank[BANKED ? LANES : 1][BANKED ? MAX_BANKS + 1 : 1];
  __shared__ int col_mem[LANES];  // bounded: a column's memory accesses
  __shared__ unsigned ticket;
  const int lane = threadIdx.x % LANES;
  const int warp = threadIdx.x / LANES;
  const int ct = blockIdx.x, st = blockIdx.y;
  int g, c;
  const bool active = column_of(p, ct, lane, g, c);
  const int b = quotient(g, p.m_magic, p.m_shift), m = g - b * p.M;
  const int l = b * p.C + c;
  const int col = l * p.M + m;  // the packed bits' column
  const int o = g * p.C + c;    // the state's (B, M, C) index
  const int n_mem = p.P == 1 ? p.G * p.nb : 0;  // the tile's mem_accs
  const int mem0 = ct * p.G * p.nb;
  const int mem_end = min(mem0 + n_mem, p.B * p.M * p.nb);

  // the state the fold adds into, brought to L2 while the steps run
  if (active && warp < N_COL) prefetch_l2(p.out[SLOT_OUT[warp]] + o);
  if (threadIdx.x < mem_end - mem0) prefetch_l2(p.out[O_MEM] + mem0 +
                                                threadIdx.x);

  // the step pass: the first steps' loads and the column's constants are
  // in flight while a banked block stages its queue delays
  Acc acc;
  const int t_begin = (st * WARPS + warp) * p.steps;
  const int t_end = min(t_begin + p.steps, p.T);
  const bool walks = active && t_begin < t_end;
  Cursor at_step;
  StepIn in[GROUP];
  Column k;
  if (walks) {
    at_step = cursor<BANKED>(p, t_begin, l, col);
    load_group<BANKED>(at_step, t_end - t_begin, in);
    k = column<BANKED>(p, l, col, g);
  }
  if (BANKED) {                 // warp w stages lanes w, w + WARPS
    for (int j = warp; j < LANES; j += WARPS) {
      int gj, cj;
      const bool has = column_of(p, ct, j, gj, cj);
      for (int bk = lane; bk < p.banks; bk += LANES) {
        q_bank[j][bk] = has ? p.q[(size_t)gj * p.banks + bk] : 0.0f;
        n_bank[j][bk] = 0;
      }
    }
    __syncthreads();
  }

  if (walks) {
    const float* q_row = BANKED ? q_bank[lane] : nullptr;
    int* n_row = BANKED ? n_bank[lane] : nullptr;
    auto walk = [&](auto nh, auto ctlb) {
      walk_steps<BANKED, decltype(nh)::value, decltype(ctlb)::value>(
          p, k, at_step, in, t_begin, t_end, q_row, n_row, acc);
    };
    if (p.n_hier == 1)
      p.ctlb ? walk(Int<1>(), Bool<true>()) : walk(Int<1>(), Bool<false>());
    else
      p.ctlb ? walk(Int<MAX_HIER>(), Bool<true>())
             : walk(Int<MAX_HIER>(), Bool<false>());
  }
  acc.mem = acc.pte_mem + acc.data_mem;
  acc.to_shared(red_f[warp], red_i[warp], lane, !BANKED);
  __syncthreads();

  // the block's sums, warps in order, into its step tile's row
  const size_t row = (size_t)p.col_tiles * LANES;  // a slot's stride
  const size_t at = (size_t)ct * LANES + lane;     // this column's place
  const int n_int = N_INT + p.nb;                  // int slots a tile
  for (int v = warp; v < NS; v += WARPS) {
    if (v < N_FLOAT) {
      double sum = 0.0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += red_f[w][v][lane];
      p.part_f[((size_t)st * N_FLOAT + v) * row + at] = sum;
    } else {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += red_i[w][v - N_FLOAT][lane];
      p.part_i[((size_t)st * n_int + v - N_FLOAT) * row + at] = sum;
    }
  }
  if (BANKED) {
    for (int i = threadIdx.x; i < LANES * p.banks; i += THREADS) {
      const int bk = i / LANES, j = i - bk * LANES;
      p.part_i[((size_t)st * n_int + N_INT + bk) * row + (size_t)ct * LANES +
               j] = n_bank[j][bk];
    }
  }

  // the last block of this column tile folds its tiles (one thread
  // releases the block's rows and takes the ticket)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    ticket = atomicAdd(p.tickets + ct, 1u);
    __threadfence();
  }
  __syncthreads();
  if (ticket != gridDim.y - 1) return;
  if (threadIdx.x == 0) p.tickets[ct] = 0;  // for the next launch

  // the state it adds into (warp w: slot w), read beside the rows
  const float before =
      active && warp < N_COL ? p.out[SLOT_OUT[warp]][o] : 0.0f;
  const float mem_before = mem0 + (int)threadIdx.x < mem_end
                               ? p.out[O_MEM][mem0 + threadIdx.x] : 0.0f;

  // warp w folds step tiles [s_lo, s_hi) of every slot, in order
  const int n_st = gridDim.y;
  const int s_lo = warp * n_st / WARPS, s_hi = (warp + 1) * n_st / WARPS;
  Acc part;
  for (int s = s_lo; s < s_hi; ++s)
    part.add_row(p.part_f + (size_t)s * N_FLOAT * row + at,
                 p.part_i + (size_t)s * n_int * row + at, row, !BANKED);
  if (BANKED) {
    for (int j = warp; j < LANES; j += WARPS)
      for (int bk = lane; bk < p.banks; bk += LANES) n_bank[j][bk] = 0;
    __syncthreads();
    // per-bank counts: integers, exact in any order
    for (int s = s_lo; s < s_hi; ++s) {
      const int* src = p.part_i + ((size_t)s * n_int + N_INT) * row + at;
#pragma unroll 8
      for (int bk = 0; bk < p.banks; ++bk)
        atomicAdd(&n_bank[lane][bk], __ldcg(src + (size_t)bk * row));
    }
  }
  part.to_shared(red_f[warp], red_i[warp], lane, !BANKED);
  __syncthreads();
  static_assert(WARPS >= N_COL + 1, "a warp a slot in the last sums");
  const int v = warp;
  if (v < N_FLOAT) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += red_f[w][v][lane];
    if (active) p.out[SLOT_OUT[v]][o] = before + (float)total;
  } else if (v < NS) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += red_i[w][v - N_FLOAT][lane];
    if (v < N_COL) {
      if (active) p.out[SLOT_OUT[v]][o] = before + (float)total;
    } else {
      col_mem[lane] = active ? total : 0;
    }
  }
  __syncthreads();
  auto lane_mem = [&](int j, int bk) {
    return BANKED ? n_bank[j][bk] : col_mem[j];
  };

  if (p.P == 1) {
    // each whole group's accesses over its lanes, in lane order
    for (int i = mem0 + threadIdx.x; i < mem_end; i += THREADS) {
      const int gi = (i - mem0) / p.nb, bk = (i - mem0) - gi * p.nb;
      int total = 0;
      for (int cc = 0; cc < p.C; ++cc) total += lane_mem(gi * p.C + cc, bk);
      const float prev =
          i == mem0 + (int)threadIdx.x ? mem_before : p.out[O_MEM][i];
      p.out[O_MEM][i] = prev + (float)total;
    }
    return;
  }
  // C > 32: this tile's piece of its group; the last piece to arrive
  // sums the pieces in order
  const int gg = ct / p.P, piece = ct - gg * p.P;
  for (int bk = threadIdx.x; bk < p.nb; bk += THREADS) {
    int total = 0;
    for (int j = 0; j < LANES && piece * LANES + j < p.C; ++j)
      total += lane_mem(j, bk);
    p.pieces[((size_t)gg * p.nb + bk) * p.P + piece] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    ticket = atomicAdd(p.tickets + p.col_tiles + gg, 1u);
    __threadfence();
  }
  __syncthreads();
  if (ticket != (unsigned)p.P - 1) return;
  if (threadIdx.x == 0) p.tickets[p.col_tiles + gg] = 0;
  for (int bk = threadIdx.x; bk < p.nb; bk += THREADS) {
    const int* src = p.pieces + ((size_t)gg * p.nb + bk) * p.P;
    int total = 0;
    for (int i = 0; i < p.P; ++i) total += __ldcg(src + i);
    p.out[O_MEM][(size_t)gg * p.nb + bk] += (float)total;
  }
}

// The grid and the scratch of a launch.
struct Geometry {
  int G, P, col_tiles, step_tiles, steps, tickets;
  long long part_f_bytes, part_i_bytes, pieces_bytes;
};

// resident_warps: what the card holds at once of the instantiation
Geometry geometry(int T, int B, int C, int M, int banks,
                  long long resident_warps) {
  Geometry g;
  const int groups = B * M;
  g.G = C <= LANES ? LANES / C : 1;
  g.P = C <= LANES ? 1 : (C + LANES - 1) / LANES;
  g.col_tiles = C <= LANES ? (groups + g.G - 1) / g.G : groups * g.P;
  // steps a thread: enough that the grid fits in one wave
  long long steps = ((long long)g.col_tiles * T + resident_warps - 1) /
                    resident_warps;
  steps = (steps + GROUP - 1) / GROUP * GROUP;
  g.steps = (int)(steps > GROUP ? steps : GROUP);
  const long long tile = (long long)WARPS * g.steps;
  g.step_tiles = (int)((T + tile - 1) / tile);
  const long long row = (long long)g.col_tiles * LANES;
  g.part_f_bytes = (long long)g.step_tiles * N_FLOAT * row * 8;
  g.part_i_bytes =
      (long long)g.step_tiles * (N_INT + (banks ? banks : 1)) * row * 4;
  g.pieces_bytes = g.P > 1 ? (long long)groups * (banks ? banks : 1) *
                                 g.P * 4 : 0;
  g.tickets = g.col_tiles + (g.P > 1 ? groups : 0);
  return g;
}

// every int index (a column's, a (simulation, mechanism, bank)'s) fits
bool shapes_ok(int T, int B, int C, int M, int banks) {
  return T >= 0 && B > 0 && C > 0 && C <= MAX_CORES && M > 0 &&
         banks >= 0 && banks <= MAX_BANKS &&
         (long long)B * C * M * MAX_BANKS < (1LL << 31);
}

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

// The warps the current card (`device`) holds at once of an
// instantiation, asked once a device.
cudaError_t resident_warps(int device, bool banked, long long* out) {
  static long long cache[2][MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  long long& w = cache[banked][device];
  if (w == 0) {
    int sms = 0, blocks = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = banked ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, sim_epilogue_kernel<true>, THREADS, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, sim_epilogue_kernel<false>, THREADS, 0);
    if (err != cudaSuccess) return err;
    w = (long long)sms * (blocks > 0 ? blocks : 1) * WARPS;
  }
  *out = w;
  return cudaSuccess;
}

// out: resident blocks an SM, registers a thread, local (spill) bytes a
// thread
template <typename K>
cudaError_t kernel_info(K kernel, int* out) {
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The grid and scratch of a launch on `device` (B simulations of C cores,
// M mechanisms, T steps; banks 0 for a bounded memory): out = column
// tiles, step tiles, steps a thread, scratch bytes, ticket words.
int sim_epilogue_geometry(int device, int T, int B, int C, int M, int banks,
                          long long* out) {
  if (!shapes_ok(T, B, C, M, banks)) return (int)cudaErrorInvalidValue;
  return on_device(device, [&]() {
    long long warps = 0;
    const cudaError_t err = resident_warps(device, banks != 0, &warps);
    if (err != cudaSuccess) return err;
    const Geometry g = geometry(T, B, C, M, banks, warps);
    out[0] = g.col_tiles;
    out[1] = g.step_tiles;
    out[2] = g.steps;
    out[3] = g.part_f_bytes + g.part_i_bytes + g.pieces_bytes;
    out[4] = g.tickets;
    return cudaSuccess;
  });
}

// What the card makes of the two instantiations (bounded, banked): for
// each, threads a block, resident blocks an SM, registers a thread and
// local (spill) bytes a thread.
int sim_epilogue_occupancy(int device, int* out) {
  return on_device(device, [&]() {
    out[0] = out[4] = THREADS;
    cudaError_t err = kernel_info(sim_epilogue_kernel<false>, out + 1);
    if (err != cudaSuccess) return err;
    return kernel_info(sim_epilogue_kernel<true>, out + 5);
  });
}

// Launches on `stream`, allocates nothing, does not synchronise.  Every
// tensor is contiguous (is4k and valid: bytes); `out` holds the nine
// counters (ref.COUNTERS order) and the clock, each (B, M, C) float32,
// then mem_accs (B, M) float32, all added to in place.  C is at most 256;
// n_hier is 1 or 3.  `banks` is 0 for a bounded memory, and `pte`, `vpn`
// and `off` null; for a banked one 1 <= banks <= 64, q and mem_accs are
// (B, M, banks), `pte` is the (T, L, M, 4) int32 walk lines (16-byte
// aligned), `vpn` and `off` (T, L) int32, rows `lines_per_row` >= 1
// lines.  `scratch` (8-byte aligned) and `tickets` are at least as large
// as sim_epilogue_geometry says; the tickets are zero, and are zero again
// when the launch ends.  Returns cudaGetLastError().
int sim_epilogue_launch(int device, const void* packed, const void* work,
                        const void* is4k, const void* valid, const void* q,
                        const void* flags, const void* params,
                        const void* pte, const void* vpn, const void* off,
                        void* const* out, void* scratch,
                        long long scratch_bytes, void* tickets,
                        int n_tickets, int T, int B, int C, int M,
                        int n_hier, int ctlb, int banks, int lines_per_row,
                        void* stream) {
  if (!shapes_ok(T, B, C, M, banks)) return (int)cudaErrorInvalidValue;
  if (n_hier != 1 && n_hier != MAX_HIER) return (int)cudaErrorInvalidValue;
  const bool banked = banks != 0;
  if (banked && (lines_per_row < 1 || pte == nullptr || vpn == nullptr ||
                 off == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!banked && (pte != nullptr || vpn != nullptr || off != nullptr))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < N_OUT; ++k)
    if (out[k] == nullptr) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  Params p;
  p.packed = static_cast<const int*>(packed);
  p.work = static_cast<const float*>(work);
  p.is4k = static_cast<const unsigned char*>(is4k);
  p.valid = static_cast<const unsigned char*>(valid);
  p.q = static_cast<const float*>(q);
  p.flags = static_cast<const int*>(flags);
  p.params = static_cast<const float*>(params);
  p.pte = static_cast<const int4*>(pte);
  p.vpn = static_cast<const int*>(vpn);
  p.off = static_cast<const int*>(off);
  for (int k = 0; k < N_OUT; ++k) p.out[k] = static_cast<float*>(out[k]);
  p.T = T;
  p.B = B;
  p.C = C;
  p.M = M;
  p.L = B * C;
  p.n_hier = n_hier;
  p.ctlb = ctlb != 0;
  p.banks = banks;
  p.nb = banked ? banks : 1;
  divisor(banked ? lines_per_row : 1, p.row_magic, p.row_shift);
  divisor(banked ? banks : 1, p.bank_magic, p.bank_shift);
  divisor(C, p.c_magic, p.c_shift);
  divisor(M, p.m_magic, p.m_shift);
  return on_device(device, [&]() {
    long long warps = 0;
    cudaError_t err = resident_warps(device, banked, &warps);
    if (err != cudaSuccess) return err;
    const Geometry g = geometry(T, B, C, M, banks, warps);
    if (g.step_tiles > MAX_STEP_TILES || scratch == nullptr ||
        tickets == nullptr || (size_t)scratch % 8 != 0 ||
        scratch_bytes < g.part_f_bytes + g.part_i_bytes + g.pieces_bytes ||
        n_tickets < g.tickets)
      return cudaErrorInvalidValue;
    char* base = static_cast<char*>(scratch);
    p.part_f = reinterpret_cast<double*>(base);
    p.part_i = reinterpret_cast<int*>(base + g.part_f_bytes);
    p.pieces =
        reinterpret_cast<int*>(base + g.part_f_bytes + g.part_i_bytes);
    p.tickets = static_cast<unsigned*>(tickets);
    p.G = g.G;
    p.P = g.P;
    p.col_tiles = g.col_tiles;
    p.steps = g.steps;
    const dim3 grid((unsigned)g.col_tiles, (unsigned)g.step_tiles);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (banked)
      sim_epilogue_kernel<true><<<grid, THREADS, 0, s>>>(p);
    else
      sim_epilogue_kernel<false><<<grid, THREADS, 0, s>>>(p);
    return cudaGetLastError();
  });
}

const char* sim_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
