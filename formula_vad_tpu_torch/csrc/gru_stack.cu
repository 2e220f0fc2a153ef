// NSNet2 GRU-stack recurrence for Hopper (sm_90a), float32.
//
// Replaces four TPU kernels that compute one function in float32: both GRU
// layers (H = 400, ONNX z|r|n gate order, linear_before_reset = 1) stepped
// T times from h = 0 over the precomputed layer-1 input projection; out =
// the layer-2 hidden sequence [N, T, H]. A call may instead continue a
// carried state (h1_0, h2_0 [N, H] float32, the low-latency mode's GRU
// state): step 0 then reads h[t-1] from them, where it reads nothing from
// h = 0, and the final h1 and h2 stay in the scratch (or out) for the host
// to hand back. Per step and row:
//   gh1 = h1 Wh1 + bh1;  h1 = gates(gi1[t], gh1, h1)
//   gi2 = h1 Wi2 + bi2;  gh2 = h2 Wh2 + bh2;  h2 = gates(gi2, gh2, h2)
// - formula_vad_tpu/models/nsnet2_pallas.py::gru_stack_pallas (body
//   _kernel), kernel 1: gi1 [N, T, 3H], the biases as the ONNX GRU has them;
// - the float32 forms of benchmarks/gru_kernel_exp.py::gru_stack_kernel,
//   gru_stack_kernel_p and gru_stack_kernel_f (kernels 4-6): gi as three
//   per-gate arrays [N, T, H] (bi1 + bh1 folded into z and r, bi1 into n),
//   the biases as the triple bh1 = [0, 0, bh1_n], bi2 = [bi2_z + bh2_z,
//   bi2_r + bh2_r, bi2_n], bh2 = [0, 0, bh2_n] (adding 0.0 is exact, so the
//   gate sums below are theirs term for term), h2 out in float32 or, for
//   kernel 6, bf16. Their bf16 forms are csrc/gru_gates_p.cu.
// The gi of gate g at (row, step) is gi_g + (row * T + step) * gi_stride:
// kernel 1 passes gi1, gi1 + H, gi1 + 2H with stride 3H, the per-gate forms
// their three arrays with stride H.
//
// What bounds it on the H100: the T steps are serial, and each step is
// three [N, 400] x [400, 1200] products whose operands are the whole 5.8 MB
// of recurrent weights. At the batched scoring shape (1,680 rows, 54 steps)
// that is 261 GFLOP of float32 FMA on the CUDA cores (3.9 ms at the card's
// 67 TFLOP/s); the weights and h fit in the 50 MB L2.
//
// Design: one persistent cooperative launch for all T steps. A tile is a
// group of rows (row_tile <= ROW_TILE_MAX, chosen by the host's launch plan,
// models/nsnet2_cuda.py::launch_plan) times a group of UNIT_TILE hidden
// units with all three gates of each unit, so the gate math of a (row,
// unit) pair stays in the thread that holds its z, r and n sums. Rows and
// units are split so that the tiles of one wave fill the SMs (130 tiles at
// 1,680 rows on 132 SMs). Each CTA walks its tiles with a grid stride.
// Per step: phase 1 computes h1[t] for every tile, a grid barrier, then
// phase 2 computes h2[t]. No barrier is needed after phase 2: phase 1 of
// step t+1 reads only h1[t] (complete at the barrier of step t) and writes
// the other half of the h1 ping-pong buffer, which nobody reads after that
// barrier; phase 2 of step t+1 reads h2[t] after the barrier of step t+1.
// So there are T grid barriers per call.
// Each phase is a register-blocked SGEMM: K is staged through shared memory
// in chunks of KC (h rows of the tile and the tile's 120 weight columns,
// which the host packs contiguous per unit group), a STAGES-deep cp.async
// pipeline; each thread holds RM (or RM - 1) rows x UM units x (3 or 4)
// sums and does 12 FMAs per row for the 3 float4 of weights it reads per k.
// A step reads each tile's 576 KB of weights once from L2 (75 MB at 1,680
// rows, where one block per 16 rows read 605 MB).
// h1 and h2 are written inside the kernel, so they are read only through
// L2 (cp.async.cg, ld.global.cg): the SM's L1 may hold stale lines.
// With float32 out, h2[t-1] is read back from out. With bf16 out, h2 stays
// float32 in a ping-pong scratch like h1's (phase 2 of step t reads h2[t-1]
// and writes the other half; the barrier of step t+1 separates those reads
// from the next write) and is rounded once on its way to out.
//
// Per-class levels (kernel 1's mixes with 'highest' under a stage override,
// float32 out only): the recurrence's products fall in two classes, gru_h
// (h1 Wh1, h2 Wh2) and gru_i (h1 Wi2), each at a level LI, LH of its own,
// template parameters, so the highest/highest instantiation is the code
// above. HIGHEST: float32 weights, one FMA a multiply-add. DEFAULT: the
// weights rounded to bf16 on the host (held in float32), h rounded to
// bf16 where it is read from shared memory, one FMA: a product of two bf16
// values is exact in float32, so this is ops/precision.py's 'default'.
// HIGH (bf16_3x): each packed weight word holds bf16(w) in its high half
// and bf16(w - bf16(w)) in its low half (the host splits the float32
// values), h is split the same way where it is read, and each
// multiply-add is three FMAs: hi*lo and lo*hi into a second set of
// accumulators, hi*hi into the first; the two are summed at the end of
// the phase, small + large, as _bf16_3x sums its three products. The
// plain version is models/nsnet2_cuda.py::gru_stack_reference at the same
// levels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "grid_barrier.cuh"

namespace {

constexpr int H = 400;
constexpr int UNIT_TILE = 40;                // hidden units per tile: 120 gate columns
constexpr int UNIT_GROUPS = H / UNIT_TILE;   // 10
constexpr int UM = 4;                        // units per thread: one float4
constexpr int TU = UNIT_TILE / UM;           // 10 threads across the units
constexpr int RM = 6;                        // rows per thread
constexpr int TR = 24;                       // threads across the rows
constexpr int THREADS = TU * TR;             // 240
constexpr int ROW_TILE_MAX = TR * RM;        // 144
constexpr int KC = 80;                       // k per staged chunk
constexpr int CHUNKS = H / KC;               // 5 per product
// h row pitch in shared memory: thread ty reads rows ty + TR*i, 84 floats
// (20 banks mod 32) after thread ty-1's, so the four ty of a warp read
// four disjoint groups of four banks.
constexpr int HP = KC + 4;
constexpr int WCOLS = 3 * UNIT_TILE;         // 120
constexpr int STAGES = 2;                    // chunk c+1 loads while chunk c is multiplied
constexpr int STAGE_FLOATS = ROW_TILE_MAX * HP + KC * WCOLS;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * sizeof(float);  // 173,568
static_assert(THREADS % (KC / 4) == 0 && (KC * WCOLS / 4) % THREADS == 0 && KC % 8 == 0, "staging layout");

using bf16 = __nv_bfloat16;

// A product class's level (template parameters LI, LH).
constexpr int HIGHEST = 0, HIGH = 1, DEFAULT = 2;

template <typename OUT>
struct Params {
  const float* gi_z;  // [n_rows, n_steps, gi_stride] each; the gate's H columns first
  const float* gi_r;
  const float* gi_n;
  const float* wh1;  // [UNIT_GROUPS, H, 3 * UNIT_TILE] each: packed by unit group
  const float* wi2;
  const float* wh2;
  const float* bh1;  // [3H] each
  const float* bi2;
  const float* bh2;
  OUT* out;          // [n_rows, n_steps, H]: h2 of every step
  float* h1;         // [2, n_rows, H]: h1 of steps t-1 and t
  float* h2;         // bf16 out only: [2, n_rows, H], h2 of steps t-1 and t
  unsigned int* barrier;  // zero at launch
  const float* h1_0;  // [n_rows, H] each: the carried state h[-1], or null for h = 0
  const float* h2_0;
  int gi_stride, n_rows, n_steps, row_tile, unit_groups, tiles;
};

// A product's operands for one tile: rows of h (row stride in floats) and
// the packed weight matrix, whose 120 columns of the tile's unit group are
// read.
struct Operand {
  const float* h;
  size_t stride;
  const float* w;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float get(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}
__device__ __forceinline__ void set(float4& v, int q, float x) {
  if (q == 0) v.x = x; else if (q == 1) v.y = x; else if (q == 2) v.z = x; else v.w = x;
}

// Copy chunk `c` of `op` (k in [c*KC, c*KC + KC)) into one pipeline stage:
// rows_here rows of h, and the KC x 120 weight block of unit group ug, which
// the packed layout keeps contiguous.
__device__ __forceinline__ void stage_chunk(float* st, const Operand& op, int c, int row0, int rows_here, int ug) {
  const int k0 = c * KC;
  float* hs = st;
  float* ws = st + ROW_TILE_MAX * HP;
  const int q = threadIdx.x % (KC / 4);
  for (int r = threadIdx.x / (KC / 4); r < rows_here; r += THREADS / (KC / 4))
    cp_async16(hs + r * HP + q * 4, op.h + (size_t)(row0 + r) * op.stride + k0 + q * 4);
  const float* w = op.w + ((size_t)ug * H + k0) * WCOLS;
#pragma unroll
  for (int p = threadIdx.x; p < KC * WCOLS / 4; p += THREADS) cp_async16(ws + p * 4, w + p * 4);
}

// acc_g[i][u] += sum_k hs[ty + TR*i][k] * ws[k][g][tx*UM + u] over one
// chunk, for the first NR of the thread's RM rows. The h and weight
// fragments of step k+1 load from shared memory while step k's FMAs run
// (two register sets each). ROUND_H: h rounded to bf16 as it is read (a
// DEFAULT product; its weights are rounded on the host).
template <int NR, bool ROUND_H = false>
__device__ __forceinline__ void mac_chunk(const float* st, int ty, int tx, float (&az)[RM][UM],
                                          float (&ar)[RM][UM], float (&an)[RM][UM]) {
  const float* hs = st + ty * HP;
  const float* ws = st + ROW_TILE_MAX * HP + tx * UM;
  float4 hv[2][NR], w[2][3];
#pragma unroll
  for (int i = 0; i < NR; ++i) hv[0][i] = *reinterpret_cast<const float4*>(hs + i * TR * HP);
#pragma unroll
  for (int g = 0; g < 3; ++g) w[0][g] = *reinterpret_cast<const float4*>(ws + g * UNIT_TILE);
#pragma unroll 1
  for (int k0 = 0; k0 < KC; k0 += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // h fragment j >> 2 (float4 along k), weight fragment j & 1
      const int k = k0 + j;
      if (k + 1 < KC) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
          w[(j + 1) & 1][g] = *reinterpret_cast<const float4*>(ws + (k + 1) * WCOLS + g * UNIT_TILE);
      }
      if ((j & 3) == 0 && k + 4 < KC) {
#pragma unroll
        for (int i = 0; i < NR; ++i)
          hv[((j >> 2) + 1) & 1][i] = *reinterpret_cast<const float4*>(hs + i * TR * HP + k + 4);
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float h = ROUND_H ? bf16r(get(hv[(j >> 2) & 1][i], j & 3)) : get(hv[(j >> 2) & 1][i], j & 3);
#pragma unroll
        for (int u = 0; u < UM; ++u) {
          az[i][u] = fmaf(h, get(w[j & 1][0], u), az[i][u]);
          ar[i][u] = fmaf(h, get(w[j & 1][1], u), ar[i][u]);
          an[i][u] = fmaf(h, get(w[j & 1][2], u), an[i][u]);
        }
      }
    }
  }
}

// mac_chunk's sums for a HIGH product: each weight word holds bf16 hi and
// lo halves (high 16 bits, low 16 bits), h is split where it is read, and
// a multiply-add is hi*lo and lo*hi into s_g, hi*hi into acc_g.
template <int NR>
__device__ __forceinline__ void mac_chunk_3x(const float* st, int ty, int tx, float (&az)[RM][UM],
                                             float (&ar)[RM][UM], float (&an)[RM][UM], float (&sz)[RM][UM],
                                             float (&sr)[RM][UM], float (&sn)[RM][UM]) {
  const float* hs = st + ty * HP;
  const uint4* ws = reinterpret_cast<const uint4*>(st + ROW_TILE_MAX * HP + tx * UM);
#pragma unroll 1
  for (int k0 = 0; k0 < KC; k0 += 4) {
    float4 hv[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) hv[i] = *reinterpret_cast<const float4*>(hs + i * TR * HP + k0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float wh[3][UM], wl[3][UM];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const uint4 w = ws[((k0 + j) * WCOLS + g * UNIT_TILE) / 4];
        const unsigned words[UM] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int u = 0; u < UM; ++u) {
          wh[g][u] = __uint_as_float(words[u] & 0xffff0000u);
          wl[g][u] = __uint_as_float(words[u] << 16);
        }
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float h = get(hv[i], j);
        const float hh = bf16r(h), hl = bf16r(h - hh);
#pragma unroll
        for (int u = 0; u < UM; ++u) {
          sz[i][u] = fmaf(hl, wh[0][u], fmaf(hh, wl[0][u], sz[i][u]));
          sr[i][u] = fmaf(hl, wh[1][u], fmaf(hh, wl[1][u], sr[i][u]));
          sn[i][u] = fmaf(hl, wh[2][u], fmaf(hh, wl[2][u], sn[i][u]));
          az[i][u] = fmaf(hh, wh[0][u], az[i][u]);
          ar[i][u] = fmaf(hh, wh[1][u], ar[i][u]);
          an[i][u] = fmaf(hh, wh[2][u], an[i][u]);
        }
      }
    }
  }
}

// One chunk's sums at a product class's level.
template <int NR, int LEVEL>
__device__ __forceinline__ void mac_level(const float* st, int ty, int tx, float (&az)[RM][UM], float (&ar)[RM][UM],
                                          float (&an)[RM][UM], float (&sz)[RM][UM], float (&sr)[RM][UM],
                                          float (&sn)[RM][UM]) {
  if constexpr (LEVEL == HIGHEST)
    mac_chunk<NR, false>(st, ty, tx, az, ar, an);
  else if constexpr (LEVEL == DEFAULT)
    mac_chunk<NR, true>(st, ty, tx, az, ar, an);
  else
    mac_chunk_3x<NR>(st, ty, tx, az, ar, an, sz, sr, sn);
}

// One phase of one tile: LAYER2 = false computes h1[t], true computes h2[t].
template <bool LAYER2, typename OUT, int LI, int LH>
__device__ void tile_phase(const Params<OUT>& p, float* smem, int t, int tile) {
  constexpr bool H2_IN_OUT = std::is_same<OUT, float>::value;  // else in the h2 scratch
  const int tx = threadIdx.x % TU, ty = threadIdx.x / TU;
  const int rg = tile / p.unit_groups, ug = tile % p.unit_groups;
  const int row0 = rg * p.row_tile;
  const int rows_here = min(p.row_tile, p.n_rows - row0);
  // Thread ty holds rows ty + TR*i. A warp whose first ty has all RM rows
  // inside the tile computes RM rows, any other RM - 1: at 130 rows, warps
  // 0-3 do 6 and warps 4-7 do 5, so each SM sub-partition (warps w and
  // w + 4) carries 11 rows' work.
  const bool active = ty < rows_here;
  const bool full = (threadIdx.x & ~31) / TU + TR * (RM - 1) < rows_here;
  const size_t rows_h = (size_t)p.n_rows * H;
  // h[t-1] exists from t = 1, and at t = 0 too where a state is carried in.
  const bool from_state = t == 0 && p.h1_0 != nullptr;
  const bool has_prev = t > 0 || from_state;
  const float* h1_prev = from_state ? p.h1_0 : p.h1 + (size_t)((t + 1) & 1) * rows_h;
  float* h1_cur = p.h1 + (size_t)(t & 1) * rows_h;
  const size_t out_stride = (size_t)p.n_steps * H;
  const float* h2_prev;  // row 0 of h2[t-1] (layer 2, has_prev)
  size_t h2_stride;
  if (from_state) {
    h2_prev = p.h2_0;
    h2_stride = H;
  } else if constexpr (H2_IN_OUT) {
    h2_prev = p.out + (size_t)(t - 1) * H;
    h2_stride = out_stride;
  } else {
    h2_prev = p.h2 + (size_t)((t + 1) & 1) * rows_h;
    h2_stride = H;
  }

  // Layer 1: h1[t-1] Wh1 (nothing at t = 0 from h = 0). Layer 2: h1[t]
  // Wi2, then h2[t-1] Wh2 (where it exists); the n sums of the two stay
  // apart.
  const Operand a = LAYER2 ? Operand{h1_cur, (size_t)H, p.wi2} : Operand{h1_prev, (size_t)H, p.wh1};
  const Operand b = {h2_prev, h2_stride, p.wh2};  // layer 2 only
  const int total = LAYER2 ? (has_prev ? 2 * CHUNKS : CHUNKS) : (has_prev ? CHUNKS : 0);
  const int swap_at = LAYER2 ? CHUNKS : -1;
  // Chunk c of the phase: its operands picked field by field, so that the
  // choice stays in registers.
  auto operand = [&](int c) {
    const bool first = c < CHUNKS;
    return Operand{first ? a.h : b.h, first ? a.stride : b.stride, first ? a.w : b.w};
  };

  float az[RM][UM], ar[RM][UM], an[RM][UM], in[RM][UM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int u = 0; u < UM; ++u) az[i][u] = ar[i][u] = an[i][u] = in[i][u] = 0.0f;
  // A HIGH class's hi*lo + lo*hi sums (never touched otherwise).
  constexpr bool SPLIT = LI == HIGH || LH == HIGH;
  float sz[RM][UM], sr[RM][UM], sn[RM][UM];
  if constexpr (SPLIT) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int u = 0; u < UM; ++u) sz[i][u] = sr[i][u] = sn[i][u] = 0.0f;
  }
  // Layer 2 sums the n gate of h1 Wi2 in `an`, moves it to `in` and then
  // sums that of h2 Wh2 in `an`: one accumulator set serves both products.
  // A HIGH gru_i class's small sums of n join it there.
  auto swap_n = [&]() {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        if constexpr (LI == HIGH) {
          in[i][u] = sn[i][u] + an[i][u];
        } else {
          in[i][u] = an[i][u];
        }
        an[i][u] = 0.0f;
        if constexpr (SPLIT) sn[i][u] = 0.0f;
      }
  };

  __syncthreads();  // the previous phase's reads of the stages are done
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) stage_chunk(smem + s * STAGE_FLOATS, operand(s), s % CHUNKS, row0, rows_here, ug);
    cp_async_commit();
  }
  for (int c = 0; c < total; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = c + STAGES - 1;
    if (next < total) stage_chunk(smem + (next % STAGES) * STAGE_FLOATS, operand(next), next % CHUNKS, row0, rows_here, ug);
    cp_async_commit();
    if (c == swap_at) swap_n();
    if (active) {
      const float* st = smem + (c % STAGES) * STAGE_FLOATS;
      if constexpr (LI == HIGHEST && LH == HIGHEST) {
        if (full)
          mac_chunk<RM>(st, ty, tx, az, ar, an);
        else
          mac_chunk<RM - 1>(st, ty, tx, az, ar, an);
      } else if (LAYER2 && c < CHUNKS) {  // h1 Wi2: class gru_i
        if (full)
          mac_level<RM, LI>(st, ty, tx, az, ar, an, sz, sr, sn);
        else
          mac_level<RM - 1, LI>(st, ty, tx, az, ar, an, sz, sr, sn);
      } else {  // h1 Wh1, h2 Wh2: class gru_h
        if (full)
          mac_level<RM, LH>(st, ty, tx, az, ar, an, sz, sr, sn);
        else
          mac_level<RM - 1, LH>(st, ty, tx, az, ar, an, sz, sr, sn);
      }
    }
  }
  if (total == swap_at) swap_n();
  cp_async_wait<0>();
  if (!active) return;
  if constexpr (SPLIT) {  // small + large, as _bf16_3x sums them
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        az[i][u] = sz[i][u] + az[i][u];
        ar[i][u] = sr[i][u] + ar[i][u];
        an[i][u] = sn[i][u] + an[i][u];
      }
  }

  // Gate math: all global loads of the thread's rows first, so that their
  // latencies overlap, then the gates and the stores.
  const int u0 = ug * UNIT_TILE + tx * UM;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 hold[RM], gz[RM], gr[RM], gn[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const size_t row = row0 + ty + TR * i;
    const bool valid = ty + TR * i < rows_here;
    const float* prev = LAYER2 ? h2_prev + row * h2_stride : h1_prev + row * H;
    hold[i] = valid && has_prev ? __ldcg(reinterpret_cast<const float4*>(prev + u0)) : zero;
    if (!LAYER2) {
      const size_t g = (row * p.n_steps + t) * p.gi_stride + u0;
      gz[i] = valid ? __ldcs(reinterpret_cast<const float4*>(p.gi_z + g)) : zero;
      gr[i] = valid ? __ldcs(reinterpret_cast<const float4*>(p.gi_r + g)) : zero;
      gn[i] = valid ? __ldcs(reinterpret_cast<const float4*>(p.gi_n + g)) : zero;
    }
  }
  // Biases by the global gate column g*H + unit. Layer 1: bh1 (gi holds
  // bi1, or the per-gate forms' folding). Layer 2: bi2 (c*) and bh2 (b*),
  // which stay apart in the n gate.
  const float* b1 = LAYER2 ? p.bh2 : p.bh1;
  const float4 bz = __ldg(reinterpret_cast<const float4*>(b1 + u0));
  const float4 br = __ldg(reinterpret_cast<const float4*>(b1 + H + u0));
  const float4 bn = __ldg(reinterpret_cast<const float4*>(b1 + 2 * H + u0));
  const float4 cz = LAYER2 ? __ldg(reinterpret_cast<const float4*>(p.bi2 + u0)) : zero;
  const float4 cr = LAYER2 ? __ldg(reinterpret_cast<const float4*>(p.bi2 + H + u0)) : zero;
  const float4 cn = LAYER2 ? __ldg(reinterpret_cast<const float4*>(p.bi2 + 2 * H + u0)) : zero;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (ty + TR * i >= rows_here) break;
    const size_t row = row0 + ty + TR * i;
    float4 hnew;
#pragma unroll
    for (int u = 0; u < UM; ++u) {
      float z, rr, n;
      if (!LAYER2) {
        z = sigmoid(get(gz[i], u) + (az[i][u] + get(bz, u)));
        rr = sigmoid(get(gr[i], u) + (ar[i][u] + get(br, u)));
        n = tanhf(get(gn[i], u) + rr * (an[i][u] + get(bn, u)));
      } else {
        z = sigmoid(az[i][u] + (get(cz, u) + get(bz, u)));
        rr = sigmoid(ar[i][u] + (get(cr, u) + get(br, u)));
        n = tanhf((in[i][u] + get(cn, u)) + rr * (an[i][u] + get(bn, u)));
      }
      set(hnew, u, (1.0f - z) * n + z * get(hold[i], u));
    }
    if constexpr (!LAYER2) {
      *reinterpret_cast<float4*>(h1_cur + row * H + u0) = hnew;
    } else if constexpr (H2_IN_OUT) {
      *reinterpret_cast<float4*>(p.out + row * out_stride + (size_t)t * H + u0) = hnew;
    } else {
      *reinterpret_cast<float4*>(p.h2 + (size_t)(t & 1) * rows_h + row * H + u0) = hnew;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(hnew.x, hnew.y), hi = __floats2bfloat162_rn(hnew.z, hnew.w);
      *reinterpret_cast<uint2*>(p.out + row * out_stride + (size_t)t * H + u0) =
          make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
    }
  }
}

template <typename OUT, int LI = HIGHEST, int LH = HIGHEST>
__global__ void __launch_bounds__(THREADS, 1) gru_stack_kernel(Params<OUT> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  unsigned int target = 0;
  for (int t = 0; t < p.n_steps; ++t) {
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) tile_phase<false, OUT, LI, LH>(p, smem, t, tile);
    target += gridDim.x;
    grid_barrier(p.barrier, target);
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) tile_phase<true, OUT, LI, LH>(p, smem, t, tile);
  }
}

template <typename OUT, int LI = HIGHEST, int LH = HIGHEST>
cudaError_t blocks_per_sm(int* blocks) {
  const cudaError_t err = cudaFuncSetAttribute(gru_stack_kernel<OUT, LI, LH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gru_stack_kernel<OUT, LI, LH>, THREADS, SMEM_BYTES);
}

// Refuses a plan that does not cover the rows exactly, or a grid the
// device cannot hold at once (the grid barrier would deadlock), before any
// launch; then launches cooperatively.
template <typename OUT, int LI = HIGHEST, int LH = HIGHEST>
cudaError_t launch(Params<OUT> p, int row_groups, int grid, cudaStream_t stream) {
  if (p.n_rows < 1 || p.n_steps < 1 || p.row_tile < 1 || p.row_tile > ROW_TILE_MAX || p.unit_groups != UNIT_GROUPS ||
      row_groups < 1 || (long long)row_groups * p.row_tile < p.n_rows ||
      (long long)(row_groups - 1) * p.row_tile >= p.n_rows)
    return cudaErrorInvalidValue;
  const long long tiles = (long long)row_groups * p.unit_groups;
  if (grid < 1 || grid > tiles) return cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  int dev = 0, coop = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm<OUT, LI, LH>(&blocks);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (grid > blocks * sms) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)gru_stack_kernel<OUT, LI, LH>, dim3(grid), dim3(THREADS), args,
                                    SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fvad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// How many CTAs of the kernel one SM of the current device holds at once,
// with the shared memory the launch uses; the host's launch plan needs it.
int fvad_gru_stack_blocks_per_sm(int* blocks) { return (int)blocks_per_sm<float>(blocks); }

// gi_z, gi_r, gi_n: the three gates' columns of row 0, step 0, each step
// gi_stride floats after the last (kernel 1: gi1, gi1 + H, gi1 + 2H, stride
// 3H; the per-gate forms: three [n_rows, n_steps, H] arrays, stride H); wh1,
// wi2, wh2 packed by unit group [UNIT_GROUPS, H, 3 * UNIT_TILE]
// (models/nsnet2_cuda.py::pack; at a class's level, pack_at: wh1 and wh2
// at level_h, wi2 at level_i); bh1, bi2, bh2 [3H]; out [n_rows, n_steps,
// H], bf16 when out_bf16, else float32; h1 scratch [2, n_rows, H]; h2
// scratch [2, n_rows, H] when out_bf16, else unused; barrier: one zeroed
// unsigned int; h1_0, h2_0 [n_rows, H] the carried state, or both null for
// h = 0. level_i, level_h: the product classes' levels (0 highest, 1
// high, 2 default); with float32 out one of them must be 0, with a bf16 out
// both. The final h1 ends in h1 scratch slot (n_steps - 1) & 1, the final
// h2 in out's last step or, with a bf16 out, in h2 scratch slot
// (n_steps - 1) & 1. All float32 but a bf16 out and the weight words of a
// HIGH class, contiguous and 16-byte aligned, on the current device. The
// plan (row_tile, row_groups, unit_groups, grid) comes from the host. A
// plan that does not cover the rows exactly, or a grid the device cannot
// hold at once (the grid barrier would deadlock), is refused before any
// launch. Launches cooperatively on `stream`; returns the launch's
// cudaError_t.
int fvad_gru_stack(const float* gi_z, const float* gi_r, const float* gi_n, const float* wh1, const float* bh1,
                   const float* wi2, const float* bi2, const float* wh2, const float* bh2, void* out, float* h1,
                   float* h2, unsigned int* barrier, const float* h1_0, const float* h2_0, int gi_stride,
                   int out_bf16, int level_i, int level_h, int n_rows, int n_steps, int row_tile, int row_groups,
                   int unit_groups, int grid, void* stream) {
  if (gi_stride < H || gi_stride % 4 || (h1_0 == nullptr) != (h2_0 == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16) {
    if (!h2 || level_i != HIGHEST || level_h != HIGHEST) return (int)cudaErrorInvalidValue;
    return (int)launch(Params<bf16>{gi_z, gi_r, gi_n, wh1, wi2, wh2, bh1, bi2, bh2, static_cast<bf16*>(out), h1, h2,
                                    barrier, h1_0, h2_0, gi_stride, n_rows, n_steps, row_tile, unit_groups, 0},
                       row_groups, grid, st);
  }
  const Params<float> p{gi_z, gi_r, gi_n, wh1, wi2, wh2, bh1, bi2, bh2, static_cast<float*>(out), h1,
                        nullptr, barrier, h1_0, h2_0, gi_stride, n_rows, n_steps, row_tile, unit_groups, 0};
  if (level_i == HIGHEST && level_h == HIGHEST) return (int)launch(p, row_groups, grid, st);
  if (level_h == HIGHEST && level_i == HIGH) return (int)launch<float, HIGH, HIGHEST>(p, row_groups, grid, st);
  if (level_h == HIGHEST && level_i == DEFAULT) return (int)launch<float, DEFAULT, HIGHEST>(p, row_groups, grid, st);
  if (level_i == HIGHEST && level_h == HIGH) return (int)launch<float, HIGHEST, HIGH>(p, row_groups, grid, st);
  if (level_i == HIGHEST && level_h == DEFAULT) return (int)launch<float, HIGHEST, DEFAULT>(p, row_groups, grid, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
