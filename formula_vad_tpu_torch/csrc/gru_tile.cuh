// The float32 tile of the NSNet2 GRU-stack recurrence, shared by kernel 1
// (csrc/gru_stack.cu) and kernel B (csrc/gru_mixed.cu): the tile geometry,
// the staging of a K chunk through shared memory, the register-blocked
// FMA sums of a chunk (mac_chunk) and the gate math of a tile (finish).
// gru_stack.cu's header note explains the design.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int H = 400;
constexpr int UNIT_TILE = 40;                // hidden units per tile: 120 gate columns
constexpr int UNIT_GROUPS = H / UNIT_TILE;   // 10
constexpr int UM = 4;                        // units per thread: one float4
constexpr int TU = UNIT_TILE / UM;           // 10 threads across the units
constexpr int RM = 6;                        // rows per thread
constexpr int TR = 24;                       // threads across the rows
constexpr int FMA_THREADS = TU * TR;         // 240: the threads of the FMA layout
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
static_assert(FMA_THREADS % (KC / 4) == 0 && (KC * WCOLS / 4) % FMA_THREADS == 0 && KC % 8 == 0, "staging layout");

using bf16 = __nv_bfloat16;

template <typename OUT>
struct Params {
  const float* gi_z;  // [n_rows, n_steps, gi_stride] each; the gate's H columns first
  const float* gi_r;
  const float* gi_n;
  const float* wh1;  // packed by unit group (csrc/gru_stack.cu, csrc/gru_mixed.cu)
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
// the packed weight matrix, whose columns of the tile's unit group are read.
struct Operand {
  const float* h;
  size_t stride;
  const float* w;
};

// Where one phase of one tile reads and writes.
struct Tile {
  int row0, rows_here, ug;
  bool has_prev;           // h[t-1] exists: from t = 1, and at t = 0 where a state is carried in
  const float* h1_prev;    // row 0 of h1[t-1] (row stride H)
  float* h1_cur;           // row 0 of h1[t]
  const float* h2_prev;    // row 0 of h2[t-1] (layer 2, has_prev), row stride h2_stride
  size_t h2_stride, out_stride, rows_h;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float get(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}
__device__ __forceinline__ void set(float4& v, int q, float x) {
  if (q == 0) v.x = x; else if (q == 1) v.y = x; else if (q == 2) v.z = x; else v.w = x;
}

template <bool LAYER2, typename OUT>
__device__ __forceinline__ Tile tile_at(const Params<OUT>& p, int t, int tile) {
  constexpr bool H2_IN_OUT = std::is_same<OUT, float>::value;  // else in the h2 scratch
  Tile c;
  const int rg = tile / p.unit_groups;
  c.ug = tile % p.unit_groups;
  c.row0 = rg * p.row_tile;
  c.rows_here = min(p.row_tile, p.n_rows - c.row0);
  c.rows_h = (size_t)p.n_rows * H;
  const bool from_state = t == 0 && p.h1_0 != nullptr;
  c.has_prev = t > 0 || from_state;
  c.h1_prev = from_state ? p.h1_0 : p.h1 + (size_t)((t + 1) & 1) * c.rows_h;
  c.h1_cur = p.h1 + (size_t)(t & 1) * c.rows_h;
  c.out_stride = (size_t)p.n_steps * H;
  if (from_state) {
    c.h2_prev = p.h2_0;
    c.h2_stride = H;
  } else if constexpr (H2_IN_OUT) {
    c.h2_prev = p.out + (size_t)(t - 1) * H;
    c.h2_stride = c.out_stride;
  } else {
    c.h2_prev = p.h2 + (size_t)((t + 1) & 1) * c.rows_h;
    c.h2_stride = H;
  }
  return c;
}

// Chunk c's h rows (k in [c*KC, c*KC + KC)) of rows_here rows into a stage,
// by the first (THREADS / 20) * 20 threads of a block of THREADS.
template <int THREADS>
__device__ __forceinline__ void stage_rows(float* st, const Operand& op, int c, int row0, int rows_here) {
  constexpr int PER = THREADS / (KC / 4);  // rows a pass
  if (threadIdx.x >= PER * (KC / 4)) return;
  const int k0 = c * KC;
  const int q = threadIdx.x % (KC / 4);
  for (int r = threadIdx.x / (KC / 4); r < rows_here; r += PER)
    cp_async16(st + r * HP + q * 4, op.h + (size_t)(row0 + r) * op.stride + k0 + q * 4);
}

// N_U4 16-byte words from src into a stage's weight block.
template <int THREADS, int N_U4>
__device__ __forceinline__ void stage_words(float* st, const float* src) {
  float* ws = st + ROW_TILE_MAX * HP;
#pragma unroll
  for (int p = threadIdx.x; p < N_U4; p += THREADS) cp_async16(ws + p * 4, src + p * 4);
}

// acc_g[i][u] += sum_k hs[ty + TR*i][k] * ws[k][g][tx*UM + u] over one
// chunk of float32 weights, for the first NR of the thread's RM rows. The
// h and weight fragments of step k+1 load from shared memory while step
// k's FMAs run (two register sets each).
template <int NR>
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
        const float h = get(hv[(j >> 2) & 1][i], j & 3);
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

// The gate math of thread (ty, tx)'s rows and units from its sums: layer
// 1 az, ar, an (h1[t-1] Wh1), layer 2 az, ar (both products), in (n of h1
// Wi2) and an (n of h2 Wh2). All global loads of the thread's rows first,
// so that their latencies overlap, then the gates and the stores. SPLIT
// (kernel B): the new h also goes to `split` (row pitch SPLIT * H) in bf16,
// hi = bf16(h) in the first H columns and, at SPLIT = 2, lo = bf16(h - hi)
// in the next H.
template <bool LAYER2, typename OUT, int SPLIT = 0>
__device__ __forceinline__ void finish(const Params<OUT>& p, const Tile& c, int t, int ty, int tx,
                                       const float (&az)[RM][UM], const float (&ar)[RM][UM],
                                       const float (&an)[RM][UM], const float (&in)[RM][UM],
                                       bf16* split = nullptr) {
  constexpr bool H2_IN_OUT = std::is_same<OUT, float>::value;
  const int u0 = c.ug * UNIT_TILE + tx * UM;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 hold[RM], gz[RM], gr[RM], gn[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const size_t row = c.row0 + ty + TR * i;
    const bool valid = ty + TR * i < c.rows_here;
    const float* prev = LAYER2 ? c.h2_prev + row * c.h2_stride : c.h1_prev + row * H;
    hold[i] = valid && c.has_prev ? __ldcg(reinterpret_cast<const float4*>(prev + u0)) : zero;
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
    if (ty + TR * i >= c.rows_here) break;
    const size_t row = c.row0 + ty + TR * i;
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
    if constexpr (SPLIT > 0) {
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(hnew.x, hnew.y), h23 = __floats2bfloat162_rn(hnew.z, hnew.w);
      bf16* at = split + row * (SPLIT * H) + u0;
      *reinterpret_cast<uint2*>(at) =
          make_uint2(*reinterpret_cast<const unsigned*>(&h01), *reinterpret_cast<const unsigned*>(&h23));
      if constexpr (SPLIT == 2) {
        const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);  // exact
        const __nv_bfloat162 l01 = __floats2bfloat162_rn(hnew.x - f01.x, hnew.y - f01.y);
        const __nv_bfloat162 l23 = __floats2bfloat162_rn(hnew.z - f23.x, hnew.w - f23.y);
        *reinterpret_cast<uint2*>(at + H) =
            make_uint2(*reinterpret_cast<const unsigned*>(&l01), *reinterpret_cast<const unsigned*>(&l23));
      }
    }
    if constexpr (!LAYER2) {
      *reinterpret_cast<float4*>(c.h1_cur + row * H + u0) = hnew;
    } else if constexpr (H2_IN_OUT) {
      *reinterpret_cast<float4*>(p.out + row * c.out_stride + (size_t)t * H + u0) = hnew;
    } else {
      *reinterpret_cast<float4*>(p.h2 + (size_t)(t & 1) * c.rows_h + row * H + u0) = hnew;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(hnew.x, hnew.y), hi = __floats2bfloat162_rn(hnew.z, hnew.w);
      *reinterpret_cast<uint2*>(p.out + row * c.out_stride + (size_t)t * H + u0) =
          make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
    }
  }
}

}  // namespace
