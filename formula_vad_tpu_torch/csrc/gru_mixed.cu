// Kernel B for Hopper (sm_90a): the NSNet2 GRU-stack recurrence with its
// two product classes at different levels, one of them 'highest'.
//
// Stands in for formula_vad_tpu/models/nsnet2_pallas.py::gru_stack_pallas
// (kernel 1's TPU kernel, :88) under a stage override that sets one class
// at 'highest' and the other at 'high' or 'default' (the stage audit's
// gru_i and gru_h rows, precision.set_stage_overrides). Kernel 1's function
// (csrc/gru_stack.cu, whose note has the steps and the state), with the
// classes gru_h (h1 Wh1, h2 Wh2) and gru_i (h1 Wi2) each at a level, a
// template parameter each (LI, LH): 'highest' a float32 product; 'default'
// bf16(h) x bf16(w) summed in float32; 'high' bf16_3x, hi = bf16(x) and lo
// = bf16(x - hi) of both operands, the small products hi x lo and lo x hi
// summed apart from the large hi x hi and added small + large once, as
// ops/precision.py's _bf16_3x. The plain version is models/nsnet2_cuda.py::
// gru_stack_reference at the same levels. Float32 out only.
//
// What bounds it on the H100: at the scoring shape (1,680 rows x 54 steps)
// each product class is 87.1 GFLOP a product a call. The float32 class (one
// product for gru_i, two for gru_h) runs on the CUDA cores at 67 TFLOP/s;
// the bf16 class is its passes (3 at 'high', 1 at 'default') on the tensor
// cores at 989. So the float32 class bounds it: 1.3 or 2.6 ms.
//
// Design. Kernel 1's tile plan and staging (csrc/gru_tile.cuh): tiles of
// up to 144 rows x 40 hidden units with their three gates, one persistent
// cooperative launch, a grid barrier between the two phases of a step, a
// two-stage cp.async ring of K chunks of 80. The block is 8 whole warps
// (256 threads): kernel 1's FMA layout (24 x 10 threads, 6 rows x 4 units
// each) in the first 240, and all 8 warps on mma.sync for the bf16 class.
// - The float32 class is kernel 1's mac_chunk, the same FMA order over K,
//   on float32 h rows and weights staged as kernel 1 stages them.
// - The bf16 class runs mma.sync.m16n8k16 with bf16 operands and float32
//   accumulators. Its weights are packed on the host once in B-fragment
//   order (models/nsnet2_cuda.py::pack_at: a 'high' class's hi and lo words
//   side by side, a 'default' class's rounded weights only), so a chunk of
//   them is one contiguous 38,400 or 19,200 bytes. h is split once, where
//   it is made: the gate math that writes h1[t] (and h2[t] where gru_h is
//   the bf16 class) also writes its bf16 hi (and lo) to ping-pong split
//   rows in global memory (s1, s2), and a bf16 chunk stages those rows, so
//   each A fragment is one ldmatrix. Warp w takes n8 tiles 2w and 2w + 1
//   of the tile's 15 (z, r, n x 5) over all its m16 tiles (up to 9): 72
//   accumulators, or 144 at 'high', where the large and small sums keep
//   fragments of their own. K runs in order, chunk by chunk.
// - Each phase runs the bf16 class's product first (layer 1: h1 Wh1 when
//   gru_h is the bf16 class; layer 2: h1 Wi2 or h2 Wh2, whichever it is),
//   then the float32 class's. After the bf16 product's last chunk its sums
//   (small + large) go through shared memory, once, into the FMA layout's
//   registers. Layer 2 sums h1's half first, as kernel 1 does: where that
//   half is the bf16 class's, the float32 product of h2 Wh2 goes on from
//   its z and r sums; where it is the float32 class's, that product starts
//   from zero and the bf16 z and r sums of h2 Wh2 wait in a buffer of
//   their own beside the ring, added once the product is done. The n sums
//   of the two halves stay apart, as in kernel 1. No MMA fragment stays
//   live across the float32 product, and no instantiation spills
//   (fvad_gru_mixed_attributes).
// - Kernel 1's gate math (gru_tile.cuh::finish). A carried state's split
//   rows are written before the first step (one grid barrier more), where
//   the bf16 class reads h[t-1].
// The host's plan is kernel 1's launch_plan with this kernel's own
// occupancy (fvad_gru_mixed_blocks_per_sm).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_barrier.cuh"
#include "gru_tile.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;          // 256
constexpr int NT = WCOLS / 8;                // 15 n8 tiles: z, r, n x 5; warp w takes 2w and 2w + 1
constexpr int MT = ROW_TILE_MAX / 16;        // 9 m16 tiles at most
constexpr int KSTEPS = KC / 16;              // 5 K steps of 16 a chunk
constexpr int APITCH = 2 * KC * 2 + 16;      // bytes of a staged bf16 h row: hi, lo, pad (ldmatrix without conflicts)
constexpr int HOP = WCOLS + 4;               // the handed-off sums' row pitch
constexpr int ZP = 2 * UNIT_TILE + 4;        // row pitch of the z and r sums kept past the float32 product
// The ring and, after it, that buffer.
constexpr int MIXED_SMEM_BYTES = SMEM_BYTES + ROW_TILE_MAX * ZP * sizeof(float);  // 221,952
static_assert(THREADS >= FMA_THREADS && NT <= 2 * WARPS && ROW_TILE_MAX % 16 == 0 && KC % 16 == 0, "mma tiles");
static_assert(ROW_TILE_MAX * APITCH <= ROW_TILE_MAX * HP * 4, "staged bf16 h fits the h rows of a stage");
static_assert(ROW_TILE_MAX * HOP <= STAGE_FLOATS, "the handed-off sums fit a stage");
static_assert(UNIT_TILE % 8 == 0 && MIXED_SMEM_BYTES <= 227 * 1024, "n8 tiles within a gate; a block's shared memory");

// A product class's level (template parameters LI, LH).
constexpr int HIGHEST = 0, HIGH = 1, DEFAULT = 2;

// bf16 parts a class splits h and its weights into: hi (and lo at 'high').
template <int L>
constexpr int PARTS = L == HIGH ? 2 : 1;

struct MixedParams {
  Params<float> p;
  // [2 (ping-pong)][n_rows][PARTS * H] each: bf16 hi (| lo) of h1 and h2
  // of steps t-1 and t, as the bf16 class reads them (h2: gru_h only).
  bf16* s1;
  bf16* s2;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of an m16 x k16 block of bf16 rows: this lane's row
// address (row lane % 16, k 8 (lane / 16) of the block).
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s)
               : "memory");
}

// Chunk c of a bf16 product's h (rows of `split`, pitch PARTS * H) into a
// stage: row r's hi k in [c*KC, c*KC + KC) at byte r * APITCH, its lo at
// + 2 * KC.
template <int L>
__device__ __forceinline__ void stage_split(float* st, const bf16* split, int c, int row0, int rows_here) {
  constexpr int PIECES = 2 * KC / 16;  // 16-byte pieces of a part's row
  char* dst = reinterpret_cast<char*>(st);
  for (int i = threadIdx.x; i < rows_here * PARTS<L> * PIECES; i += THREADS) {
    const int r = i / (PARTS<L> * PIECES), part = i % (PARTS<L> * PIECES) / PIECES, piece = i % PIECES;
    cp_async16(dst + r * APITCH + part * 2 * KC + piece * 16,
               split + (size_t)(row0 + r) * (PARTS<L> * H) + part * H + c * KC + piece * 8);
  }
}

// One chunk's MMAs of this warp at level L: its n8 tiles 2w and 2w + 1
// (warp 7: 14 only) of the m_tiles m16 tiles; acc holds hi x hi (or the
// one 'default' pass), sm at 'high' hi x lo, then lo x hi. K steps in
// order; a K step's B fragments load once, each m16 tile's A fragments
// (hi, lo) once, and the two n8 tiles' MMAs alternate, so that neither
// small sum's two MMAs issue back to back. A tile of all MT m16 tiles (ALL)
// runs without the per-tile test, which leaves the compiler free to
// schedule the loads of the K step together.
template <int L, bool ALL = false>
__device__ __forceinline__ void mma_chunk(const float* st, int m_tiles, float (&acc)[MT][2][4],
                                          float (&sm)[MT][2][4]) {
  if constexpr (!ALL) {
    if (m_tiles == MT) {
      mma_chunk<L, true>(st, MT, acc, sm);
      return;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool two = 2 * warp + 1 < NT;
  const char* hs = reinterpret_cast<const char*>(st) + (lane & 15) * APITCH + (lane >> 4) * 16;
  const uint32_t* ws =
      reinterpret_cast<const uint32_t*>(st + ROW_TILE_MAX * HP) + (2 * warp * 32 + lane) * 2 * PARTS<L>;
#pragma unroll 1
  for (int s = 0; s < KSTEPS; ++s) {
    // B fragments of the two n8 tiles: b0, b1 of hi, then of lo.
    uint32_t b[2][4];
    const uint32_t* bs = ws + s * NT * 32 * 2 * PARTS<L>;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n == 0 || two) {
        if constexpr (L == HIGH) {
          const uint4 w = *reinterpret_cast<const uint4*>(bs + n * 32 * 4);
          b[n][0] = w.x, b[n][1] = w.y, b[n][2] = w.z, b[n][3] = w.w;
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(bs + n * 32 * 2);
          b[n][0] = w.x, b[n][1] = w.y;
        }
      }
    }
    const char* a0 = hs + s * 32;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (ALL || m < m_tiles) {
        uint32_t ah[4], al[4];
        ldsm_x4(ah, a0 + m * 16 * APITCH);
        if constexpr (L == HIGH) ldsm_x4(al, a0 + m * 16 * APITCH + 2 * KC);
        mma_bf16(acc[m][0], ah, b[0][0], b[0][1]);
        if (two) mma_bf16(acc[m][1], ah, b[1][0], b[1][1]);
        if constexpr (L == HIGH) {
          mma_bf16(sm[m][0], ah, b[0][2], b[0][3]);
          if (two) mma_bf16(sm[m][1], ah, b[1][2], b[1][3]);
          mma_bf16(sm[m][0], al, b[0][0], b[0][1]);
          if (two) mma_bf16(sm[m][1], al, b[1][0], b[1][1]);
        }
      }
    }
  }
}

// This warp's sums (small + large at 'high') into the stage at `ho`: [144
// rows][HOP], columns gate * 40 + unit as the FMA layout reads them. With
// KEEP, the z and r columns go to `zr` ([144 rows][ZP]) instead.
template <int L, bool KEEP>
__device__ __forceinline__ void hand_off(float* ho, float* zr, int m_tiles, const float (&acc)[MT][2][4],
                                         const float (&sm)[MT][2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= m_tiles) break;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (2 * warp + n >= NT) continue;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = L == HIGH ? sm[m][n][q] + acc[m][n][q] : acc[m][n][q];
      const int row = m * 16 + (lane >> 2), col = (2 * warp + n) * 8 + 2 * (lane & 3);
      const bool kept = KEEP && col < 2 * UNIT_TILE;
      const int pitch = kept ? ZP : HOP;
      float* r = (kept ? zr : ho) + row * pitch + col;
      *reinterpret_cast<float2*>(r) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(r + 8 * pitch) = make_float2(v[2], v[3]);
    }
  }
}

// Thread (ty, tx)'s sums of its RM rows and UM units from the handed-off
// tile, pitch P, gate g at column g * 40: with N_ONLY the n sums, else the
// z, r and n sums.
template <int P, bool N_ONLY>
__device__ __forceinline__ void take(const float* ho, int ty, int tx, float (&z)[RM][UM], float (&r)[RM][UM],
                                     float (&n)[RM][UM]) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float* row = ho + (ty + TR * i) * P + tx * UM;
    const float4 vn = *reinterpret_cast<const float4*>(row + 2 * UNIT_TILE);
#pragma unroll
    for (int u = 0; u < UM; ++u) n[i][u] = get(vn, u);
    if constexpr (!N_ONLY) {
      const float4 vz = *reinterpret_cast<const float4*>(row);
      const float4 vr = *reinterpret_cast<const float4*>(row + UNIT_TILE);
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        z[i][u] = get(vz, u);
        r[i][u] = get(vr, u);
      }
    }
  }
}

// The kept z and r sums ([144 rows][ZP]) added onto thread (ty, tx)'s.
__device__ __forceinline__ void add_kept(const float* zr, int ty, int tx, float (&z)[RM][UM], float (&r)[RM][UM]) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float* row = zr + (ty + TR * i) * ZP + tx * UM;
    const float4 vz = *reinterpret_cast<const float4*>(row);
    const float4 vr = *reinterpret_cast<const float4*>(row + UNIT_TILE);
#pragma unroll
    for (int u = 0; u < UM; ++u) {
      z[i][u] += get(vz, u);
      r[i][u] += get(vr, u);
    }
  }
}

// One phase of one tile: LAYER2 = false computes h1[t], true computes h2[t].
template <bool LAYER2, int LI, int LH>
__device__ void tile_phase(const MixedParams& mp, float* smem, int t, int tile) {
  static_assert((LI == HIGHEST) != (LH == HIGHEST), "one class at 'highest', the other not");
  constexpr int LM = LI == HIGHEST ? LH : LI;  // the bf16 class's level
  constexpr bool MMA_I = LI != HIGHEST;        // the bf16 class is gru_i (h1 Wi2)
  constexpr bool KEEP = LAYER2 && !MMA_I;      // h2 Wh2's bf16 z and r sums wait for h1 Wi2's float32 ones
  constexpr int W_U4 = KSTEPS * NT * 32 * 2 * PARTS<LM> / 4;  // a bf16 chunk's weights in uint4
  const Params<float>& p = mp.p;
  const int tx = threadIdx.x % TU, ty = threadIdx.x / TU;
  const Tile c = tile_at<LAYER2>(p, t, tile);
  // The FMA layout's threads and rows, as in kernel 1.
  const bool active = threadIdx.x < FMA_THREADS && ty < c.rows_here;
  const bool full = (threadIdx.x & ~31) / TU + TR * (RM - 1) < c.rows_here;
  const size_t slot = (size_t)p.n_rows * PARTS<LM> * H;  // one ping-pong half of s1 or s2

  // Layer 1: h1[t-1] Wh1 (gru_h). Layer 2: h1[t] Wi2 (gru_i) and h2[t-1]
  // Wh2 (gru_h). The products on h[t-1] only where it exists. The bf16
  // class reads h's split rows, the float32 class its float32 rows.
  const bf16* mm_h = MMA_I ? mp.s1 + (t & 1) * slot : (LAYER2 ? mp.s2 : mp.s1) + ((t + 1) & 1) * slot;
  const float* mm_w = MMA_I ? p.wi2 : LAYER2 ? p.wh2 : p.wh1;
  const Operand wh = LAYER2 ? Operand{c.h2_prev, c.h2_stride, p.wh2} : Operand{c.h1_prev, (size_t)H, p.wh1};
  const Operand ff = MMA_I ? wh : Operand{c.h1_cur, (size_t)H, p.wi2};
  const bool mm_here = MMA_I ? LAYER2 : c.has_prev;
  const bool ff_here = MMA_I ? c.has_prev : LAYER2;
  const int mm_chunks = mm_here ? CHUNKS : 0;
  const int total = mm_chunks + (ff_here ? CHUNKS : 0);
  // Chunk k of the phase: the bf16 product's chunks, then the float32 one's.
  auto stage = [&](int k) {
    float* st = smem + (k % STAGES) * STAGE_FLOATS;
    if (k < mm_chunks) {
      stage_split<LM>(st, mm_h, k, c.row0, c.rows_here);
      stage_words<THREADS, W_U4>(st, mm_w + ((size_t)c.ug * CHUNKS + k) * W_U4 * 4);
    } else {
      stage_rows<THREADS>(st, ff, k - mm_chunks, c.row0, c.rows_here);
      stage_words<THREADS, KC * WCOLS / 4>(st, ff.w + ((size_t)c.ug * H + (k - mm_chunks) * KC) * WCOLS);
    }
  };

  __syncthreads();  // the previous phase's reads of the stages are done
  if (total > 0) stage(0);
  cp_async_commit();
  int k = 0;
  float* ho = smem;  // the stage of the bf16 product's last chunk
  float* zr = smem + STAGES * STAGE_FLOATS;  // the kept z and r sums
  if (mm_chunks > 0) {
    const int m_tiles = (c.rows_here + 15) / 16;
    float acc[MT][2][4], sm[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] = sm[m][n][q] = 0.0f;
    for (; k < mm_chunks; ++k) {
      cp_async_wait<0>();
      __syncthreads();
      if (k + 1 < total) stage(k + 1);
      cp_async_commit();
      mma_chunk<LM>(smem + (k % STAGES) * STAGE_FLOATS, m_tiles, acc, sm);
    }
    ho = smem + ((k - 1) % STAGES) * STAGE_FLOATS;
    __syncthreads();  // every warp is done with the last chunk's stage
    hand_off<LM, KEEP>(ho, zr, m_tiles, acc, sm);
    __syncthreads();
  }
  float az[RM][UM], ar[RM][UM], an[RM][UM], in[RM][UM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int u = 0; u < UM; ++u) az[i][u] = ar[i][u] = an[i][u] = in[i][u] = 0.0f;
  // The bf16 product's sums: layer 2 with gru_i in bf16 keeps its n (h1
  // Wi2) in `in`, any other in `an`. The float32 product of layer 2 with
  // gru_h in bf16 is h1 Wi2: its n goes to `in`, and the bf16 z and r sums
  // come after it (KEEP). (The next chunk is staged into `ho` only after
  // the __syncthreads of the next iteration, which every thread reaches
  // after its take.)
  if (mm_chunks > 0 && active) {
    if (LAYER2 && MMA_I)
      take<HOP, false>(ho, ty, tx, az, ar, in);
    else
      take<HOP, KEEP>(ho, ty, tx, az, ar, an);
  }
  for (; k < total; ++k) {
    cp_async_wait<0>();
    __syncthreads();
    if (k + 1 < total) stage(k + 1);
    cp_async_commit();
    if (active) {
      const float* st = smem + (k % STAGES) * STAGE_FLOATS;
      if (LAYER2 && !MMA_I) {
        if (full)
          mac_chunk<RM>(st, ty, tx, az, ar, in);
        else
          mac_chunk<RM - 1>(st, ty, tx, az, ar, in);
      } else {
        if (full)
          mac_chunk<RM>(st, ty, tx, az, ar, an);
        else
          mac_chunk<RM - 1>(st, ty, tx, az, ar, an);
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  if (KEEP && mm_chunks > 0) add_kept(zr, ty, tx, az, ar);
  // The new h1 always, and the new h2 where gru_h is the bf16 class, also
  // go to their split rows for the bf16 class's next reads.
  if constexpr (!LAYER2)
    finish<false, float, PARTS<LM>>(p, c, t, ty, tx, az, ar, an, in, mp.s1 + (t & 1) * slot);
  else if constexpr (!MMA_I)
    finish<true, float, PARTS<LM>>(p, c, t, ty, tx, az, ar, an, in, mp.s2 + (t & 1) * slot);
  else
    finish<true>(p, c, t, ty, tx, az, ar, an, in);
}

// A carried state's split rows, for the bf16 class's reads of h[-1]
// (gru_h only: gru_i reads h1[t], which step t writes): h1_0 and h2_0 into
// ping-pong half 1 of s1 and s2.
template <int LM>
__device__ void split_state(const MixedParams& mp) {
  const Params<float>& p = mp.p;
  const size_t slot = (size_t)p.n_rows * PARTS<LM> * H;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < (size_t)p.n_rows * H; i += (size_t)gridDim.x * THREADS) {
    const size_t at = slot + i / H * (PARTS<LM> * H) + i % H;
    const float h[2] = {p.h1_0[i], p.h2_0[i]};
    bf16* s[2] = {mp.s1 + at, mp.s2 + at};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16 hi = __float2bfloat16_rn(h[j]);
      s[j][0] = hi;
      if constexpr (LM == HIGH) s[j][H] = __float2bfloat16_rn(h[j] - __bfloat162float(hi));
    }
  }
}

template <int LI, int LH>
__global__ void __launch_bounds__(THREADS, 1) gru_mixed_kernel(MixedParams mp) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  unsigned int target = 0;
  if constexpr (LI == HIGHEST) {
    if (mp.p.h1_0 != nullptr) {
      split_state<LH>(mp);
      target += gridDim.x;
      grid_barrier(mp.p.barrier, target);
    }
  }
  for (int t = 0; t < mp.p.n_steps; ++t) {
    for (int tile = blockIdx.x; tile < mp.p.tiles; tile += gridDim.x) tile_phase<false, LI, LH>(mp, smem, t, tile);
    target += gridDim.x;
    grid_barrier(mp.p.barrier, target);
    for (int tile = blockIdx.x; tile < mp.p.tiles; tile += gridDim.x) tile_phase<true, LI, LH>(mp, smem, t, tile);
  }
}

using Kernel = void (*)(MixedParams);

// The instantiation for (level_i, level_h), or null for another pair.
Kernel kernel_of(int level_i, int level_h) {
  if (level_i == HIGH && level_h == HIGHEST) return gru_mixed_kernel<HIGH, HIGHEST>;
  if (level_i == DEFAULT && level_h == HIGHEST) return gru_mixed_kernel<DEFAULT, HIGHEST>;
  if (level_i == HIGHEST && level_h == HIGH) return gru_mixed_kernel<HIGHEST, HIGH>;
  if (level_i == HIGHEST && level_h == DEFAULT) return gru_mixed_kernel<HIGHEST, DEFAULT>;
  return nullptr;
}

cudaError_t blocks_per_sm(Kernel kernel, int* blocks) {
  const cudaError_t err =
      cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MIXED_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, MIXED_SMEM_BYTES);
}

}  // namespace

extern "C" {

const char* fvad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The shared memory a CTA of any instantiation takes, in bytes.
int fvad_gru_mixed_smem_bytes() { return MIXED_SMEM_BYTES; }

// How many CTAs of the (level_i, level_h) instantiation one SM of the
// current device holds at once, with the shared memory the launch uses;
// the host's launch plan needs it.
int fvad_gru_mixed_blocks_per_sm(int level_i, int level_h, int* blocks) {
  const Kernel kernel = kernel_of(level_i, level_h);
  return kernel ? (int)blocks_per_sm(kernel, blocks) : (int)cudaErrorInvalidValue;
}

// The (level_i, level_h) instantiation's registers a thread and local
// memory (spill) bytes a thread, as the compiler built it.
int fvad_gru_mixed_attributes(int level_i, int level_h, int* num_regs, int* local_bytes) {
  const Kernel kernel = kernel_of(level_i, level_h);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)kernel);
  if (err != cudaSuccess) return (int)err;
  *num_regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// gi1 [n_rows, n_steps, 3H]; wh1, wi2, wh2 packed at their class's level
// (models/nsnet2_cuda.py::pack_at: wh1 and wh2 at level_h, wi2 at
// level_i; float32 [UNIT_GROUPS, H, 3 * UNIT_TILE] at 'highest', else
// B-fragment words [UNIT_GROUPS, H / 16, 15, 32, 4 or 2]); bh1, bi2, bh2
// [3H]; out [n_rows, n_steps, H] float32; h1 scratch [2, n_rows, H];
// split: bf16 scratch [2 (h1, h2)][2][n_rows][parts * H], parts 2 where
// the bf16 class is 'high', else 1; barrier: one zeroed unsigned int;
// h1_0, h2_0 [n_rows, H] the carried
// state, or both null for h = 0. level_i, level_h: 0 highest, 1 high, 2
// default, exactly one of them 0. The final h1 ends in h1 scratch slot
// (n_steps - 1) & 1, the final h2 in out's last step. Contiguous, 16-byte
// aligned, on the current device. The plan (row_tile, row_groups,
// unit_groups, grid) comes from the host. A plan that does not cover the
// rows exactly, or a grid the device cannot hold at once (the grid barrier
// would deadlock), is refused before any launch. Launches cooperatively on
// `stream`; returns the launch's cudaError_t.
int fvad_gru_mixed(const float* gi1, const float* wh1, const float* bh1, const float* wi2, const float* bi2,
                   const float* wh2, const float* bh2, float* out, float* h1, void* split, unsigned int* barrier,
                   const float* h1_0, const float* h2_0, int level_i, int level_h, int n_rows, int n_steps,
                   int row_tile, int row_groups, int unit_groups, int grid, void* stream) {
  const Kernel kernel = kernel_of(level_i, level_h);
  if (!kernel || (h1_0 == nullptr) != (h2_0 == nullptr) || n_rows < 1 || n_steps < 1 || row_tile < 1 ||
      row_tile > ROW_TILE_MAX || unit_groups != UNIT_GROUPS || row_groups < 1 ||
      (long long)row_groups * row_tile < n_rows || (long long)(row_groups - 1) * row_tile >= n_rows)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)row_groups * unit_groups;
  if (grid < 1 || grid > tiles) return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm(kernel, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (grid > blocks * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  const size_t layer = (size_t)2 * n_rows * ((level_i == HIGH || level_h == HIGH) ? 2 : 1) * H;
  MixedParams mp{{gi1, gi1 + H, gi1 + 2 * H, wh1, wi2, wh2, bh1, bi2, bh2, out, h1, nullptr, barrier, h1_0, h2_0,
                  3 * H, n_rows, n_steps, row_tile, unit_groups, (int)tiles},
                 static_cast<bf16*>(split), static_cast<bf16*>(split) + layer};
  void* args[] = {&mp};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args, MIXED_SMEM_BYTES,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
