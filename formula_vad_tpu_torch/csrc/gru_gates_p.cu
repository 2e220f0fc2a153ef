// The bf16 forms of the per-gate NSNet2 GRU-stack kernels 4, 5 and 6 for
// Hopper (sm_90a): one body, three instantiations. Below it, kernel A:
// kernel 5's function with three bf16 passes (bf16_3x) for a class of
// products, on a body of its own (gru_3x_kernel).
//
// Kernel A in brief (its section below has the details). A CTA owns 8
// hidden units (their hi and lo weights, 115,200 bytes, resident in shared
// memory) and a row group's 16-row tiles; every step each CTA needs the
// bf16 hi (and, for a three-pass class, lo) A fragments of all 400 units of
// h for every one of its tiles. Those cross between CTAs through exchange
// buffers in L2. The 50 CTAs of a row group form clusters of 5, and each
// K step of each tile's fragments is fetched from L2 once per cluster, by
// one member's bulk copy multicast into the shared memory of all 5, where
// 9 MMA warps read it from a ring of 6 stages of 18 KB that two copy warps
// fill: with the weights, 225,936 of the 232,448 bytes a block may have.
// At 1,680 rows x 54 steps and three passes a class the plan counts 4.30
// GB of L2 reads a call where one read per CTA took 21.50 GB (the
// section's table; counts from the plan, not measurements).
// Each row's products run in the order they ran when every CTA read h from
// L2 (hi x hi, then hi x lo and lo x hi, K steps in order, the h1 half of
// K = 800 first), so the outputs are bit for bit those of that design.
//
// Replaces the bf16 forms of three TPU kernels of
// benchmarks/gru_kernel_exp.py, which compute one function with the
// rounding points in different places:
//   kernel 4  gru_stack_kernel   (body _kernel)    gi cast to bf16, h2 out
//             in float32;
//   kernel 5  gru_stack_kernel_p (body _kernel_p)  gi float32, h2 out in
//             float32 (the bf16 tier's recurrence);
//   kernel 6  gru_stack_kernel_f (body _kernel_f)  gi cast to bf16, h2 out
//             in float32 or bf16 (out_dtype); its `tile` changes no bit and
//             the host's plan ignores it.
// Both GRU layers (H = 400, ONNX z|r|n, linear_before_reset = 1) step T
// times from h = 0, or from a carried state (h1_0, h2_0 [N, H] float32, the
// low-latency mode's GRU state, which the call continues and whose final
// value it writes to h1_T and, for kernel 6, h2_T; kernels 4 and 5 leave
// the final float32 h2 in out's last step), over per-gate layer-1 input
// projections gi_z, gi_r, gi_n
// [N, T, H] (bi1 + bh1 folded into z and r, bi1 only into n), with the
// packed weights wp1 = wh1 [H, 3H] and wp2 [2H, 4H] (h1 rows
// wi2 z | r | n_i | 0, h2 rows wh2 z | r | 0 | n_h: kernels 4 and 6's nine
// slabs w9, rounded to bf16 from the same float32 values). With
// b8 = [bh1_n, bi2_z + bh2_z, bi2_r + bh2_r, bi2_n, bh2_n], per step and
// row:
//   g1 = h1 wp1;  z1 = s(gi_z + g1z)  r1 = s(gi_r + g1r)
//   n1 = tanh(gi_n + r1 (g1n + bh1_n));       h1 = (1 - z1) n1 + z1 h1
//   g2 = [h1 | h2] wp2;  z2 = s(g2z + b2z)  r2 = s(g2r + b2r)
//   n2 = tanh((g2ni + bi2_n) + r2 (g2nh + bh2_n));  h2 = (1 - z2) n2 + z2 h2
// h1, h2 and the gate math are float32; h is rounded to bf16 only where it
// enters a product, and the products sum in float32 (z2 and r2 sum both
// halves of K = 800 in one accumulator, the h1 half first). A bf16 gi is
// converted to float32 exactly and added where kernel 5 adds its float32
// gi. The plain versions are models/nsnet2_gates_cuda.py::
// gru_gates_reference, gru_gates_p_reference and gru_gates_f_reference.
// The three instantiations differ in
//   the gi element type   float (kernel 5), __nv_bfloat16 (kernels 4, 6);
//   the out element type  float (kernels 4, 5), float or bf16 (kernel 6);
//   where f32 h2[t-1] lives: read back from out, which the same thread
//   wrote (kernels 4, 5: out is float32), or thread-private shared-memory
//   slots beside h1's (kernel 6: a bf16 out read back would round h2 every
//   step, which is another function).
//
// What bounds it on the H100: 261.3 GFLOP of serial-step bf16 products at
// the scoring shape (1,680 rows x 54 steps), 0.264 ms at 989 TFLOP/s. The
// design it replaces (gates_mma, 16 rows a block for all steps) re-read
// all 2.88 MB of bf16 weights from L2 in every block on every step:
// 105 x 2.88 MB x 54 = 16.3 GB of L2 reads a call.
//
// Design: one persistent cooperative launch. A CTA owns one group of
// U = 16 hidden units (25 groups) for the whole call and a contiguous
// range of 16-row MMA tiles (row groups: as many as fit beside the 25 unit
// groups in one wave, 5 on 132 SMs: 125 CTAs; a CTA holds at most
// MAX_TILES tiles beside its weights, so the host splits a call of more
// rows, 2,240 on 132 SMs, into launches of one wave each). Its weights, 3,600 bf16 per
// unit without wp2's zero blocks, 115,200 bytes, are loaded into shared
// memory once per call in mma.sync B-fragment order (each lane's 48 bytes
// of a K step contiguous: three conflict-free 16-byte loads). What crosses
// between CTAs is bf16(h1) and bf16(h2) only, ~5.4 GB of L2 reads a call
// at 1,680 rows (25 unit groups x 1,680 rows x 1,200 x 2 bytes a step).
//
// The exchange buffers x1 and x2 ([2 ping-pong][tiles][25 K steps][32
// lanes] uint4) hold bf16 h in mma.sync.m16n8k16 A-fragment order: the
// accumulators of the two n8 tiles of a unit group are, lane for lane, the
// A fragment of the K step that the group's 16 units form, so each thread
// stores its 8 new h values as one uint4 and each reader loads one uint4 a
// K step, 512 contiguous bytes a warp. They are written inside the kernel,
// so they are read only through L2 (ld.global.cg), as gru_stack.cu's h.
//
// A warp walks the CTA's tiles with stride 8. A K step is one A load and
// six MMAs (z, r and n, two n8 tiles each). A phase reads its A fragments
// 25 K steps at a time into a register ring: the block after the current
// one (the next tile, layer 2's h2 half, or step t+1's first layer-1 tile)
// loads into each slot as it is consumed. Per step: phase 1 computes h1[t]
// (K = 400), then one barrier, then phase 2 computes h2[t] (K = 800: h1[t]
// then h2[t-1]). A CTA reads only the h of its own rows, which the 25 CTAs
// of its row group write, so the barrier is grid_barrier.cuh's on a
// counter of the row group's own (128 bytes apart), 25 arrivals a step;
// a second counter beside it lets the last CTA out zero both.
// One barrier a step is enough: phase 1 of step t+1 reads only h1[t]
// (complete at the barrier of step t) and writes the other x1 half, which
// nobody reads after that barrier; phase 2 of step t+1 reads h2[t] after
// the barrier of step t+1.
// The CTA's float32 h1 stays in shared memory (thread-private slots), and
// so does kernel 6's float32 h2. gi of step t+1 goes to shared memory by
// cp.async during phase 2 of step t, each thread copying the 12 pairs of
// units it will read (float2 or bf16x2, zero-filled past n_rows). A
// tile's shared bytes (TILE_BYTES): its gi, 3,072 in float32 or 1,536 in
// bf16, its h1, 1,024, and kernel 6's h2, 1,024. A row's sums depend on its
// own inputs only, in a fixed order, so its bits do not depend on N or on
// the plan.
// A carried state is seeded before the first step: each CTA writes its
// units' float32 h1 (and kernel 6's h2) into its shared slots and their
// bf16 fragments into the x1 and x2 halves that step 0 reads, then one
// row-group barrier more makes every unit group's fragments visible. That
// is an instantiation of its own (CARRIED), so a call without a state runs
// the stateless code as it was.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "grid_barrier.cuh"

namespace {

constexpr int H = 400;
constexpr int U = 16;                   // hidden units per CTA: one K step of h
constexpr int UNIT_GROUPS = H / U;      // 25
constexpr int KS = H / 16;              // 25 K steps over one h
constexpr int KB = 3 * KS;              // weight K blocks: wp1, wp2's h1 rows, wp2's h2 rows
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MMA_ROWS = 16;
constexpr int W_U4 = KB * 32 * 3;       // uint4s of one unit group's weights
constexpr int W_BYTES = W_U4 * 16;      // 115,200
constexpr int GI_SLOTS = 12;            // gi pairs per lane and tile: 3 gates x 2 n8 tiles x 2 row halves
constexpr int H_SLOTS = 8;              // float of h1 (and of kernel 6's h2) per lane and tile
constexpr int MAX_TILES = 28;           // 16-row tiles a CTA holds beside its weights
constexpr int SMEM_LIMIT = 232448;      // an H100 block's shared memory
constexpr int BARRIER_STRIDE = 32;      // unsigned ints from one row group's counter to the next

using bf16 = __nv_bfloat16;

// The two units of a gi slot: float2 for float32 gi, bf16x2 for bf16.
template <typename GI>
using Pair = std::conditional_t<std::is_same_v<GI, float>, float2, __nv_bfloat162>;

template <typename GI, bool H2_SHARED>
constexpr int tile_bytes() {
  return (GI_SLOTS * (int)sizeof(Pair<GI>) + H_SLOTS * 4 * (H2_SHARED ? 2 : 1)) * 32;
}
static_assert(tile_bytes<float, false>() == 4096 && tile_bytes<bf16, false>() == 2560 &&
              tile_bytes<bf16, true>() == 3584, "tile bytes");
static_assert(W_BYTES + MAX_TILES * tile_bytes<float, false>() <= SMEM_LIMIT, "shared memory plan");

template <typename GI, typename OUT>
struct Params {
  const GI* gz;     // [n_rows, n_steps, H] each
  const GI* gr;
  const GI* gn;
  const uint4* w;   // [UNIT_GROUPS][KB][32 lanes][3]: 6 n8 tiles x 2 words a lane
  const float* b8;  // [8, H]
  OUT* out;         // [n_rows, n_steps, H]
  uint4* x1;        // [2][tiles][KS][32]: bf16(h1) in A-fragment order
  uint4* x2;        // the same for bf16(h2)
  unsigned int* barrier;  // [row groups][BARRIER_STRIDE]: zero at launch, left zero at exit
  const float* h1_0;  // [n_rows, H] each: the carried state h[-1], or null for h = 0
  const float* h2_0;
  float* h1_T;        // [n_rows, H]: the final h1 (with a state)
  float* h2_T;        // [n_rows, H]: kernel 6's final h2 (with a state)
  int n_rows, n_steps, tiles, tiles_per_group;
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float get(const float2& v, int e) { return e ? v.y : v.x; }
__device__ __forceinline__ float2 to_float2(const float2& v) { return v; }
__device__ __forceinline__ float2 to_float2(const __nv_bfloat162& v) { return __bfloat1622float2(v); }  // exact

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
// BYTES (8 or 4) from src, or zeros where !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src, bool valid) {
  static_assert(BYTES == 8 || BYTES == 4, "cp.async.ca size");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// One block of 25 K steps: acc[0..3] (z, r) and acc[N0], acc[N0 + 1] (the
// n gate's two n8 tiles) += ring x the weights at w (this lane's slot of
// the block's first K step). Slot j of the ring is refilled from `next`
// (this lane's uint4 of the following block, or null) once it is used.
template <int N0>
__device__ __forceinline__ void mma_block(uint4 (&ring)[KS], const uint4* next, const uint4* w, float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const uint4 a = ring[j];
    const uint4* wj = w + j * 32 * 3;
    const uint4 b0 = wj[0], b1 = wj[1], b2 = wj[2];
    mma_bf16(acc[0], a, b0.x, b0.y);
    mma_bf16(acc[1], a, b0.z, b0.w);
    mma_bf16(acc[2], a, b1.x, b1.y);
    mma_bf16(acc[3], a, b1.z, b1.w);
    mma_bf16(acc[N0], a, b2.x, b2.y);
    mma_bf16(acc[N0 + 1], a, b2.z, b2.w);
    if (next) ring[j] = __ldcg(next + j * 32);
  }
}

__device__ __forceinline__ void load_block(uint4 (&ring)[KS], const uint4* src) {
#pragma unroll
  for (int j = 0; j < KS; ++j) ring[j] = __ldcg(src + j * 32);
}

// Step t's gi of one tile -> the tile's slots, slot (gate * 4 + s * 2 +
// half) holding the lane's two units 8 s + 2 (lane % 4) (+1) of row g + 8
// half; rows past n_rows are zero-filled.
template <typename GI, typename OUT>
__device__ __forceinline__ void prefetch_gi(const Params<GI, OUT>& p, Pair<GI>* slots, int tile, int t, int col,
                                            int g) {
  const GI* gi[3] = {p.gz, p.gr, p.gn};
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = tile * MMA_ROWS + g + 8 * half;
        const bool valid = row < p.n_rows;
        const GI* src = gi[gate] + (valid ? ((size_t)row * p.n_steps + t) * H + col + 8 * s : 0);
        cp_async_ca<sizeof(Pair<GI>)>(slots + (gate * 4 + s * 2 + half) * 32, src, valid);
      }
}

// The eight (row, unit) pairs of a lane's slots and fragments in a tile:
// slot s * 4 + q holds row g + 8 (q >> 1), unit col + 8 s + (q & 1).
__device__ __forceinline__ size_t slot_index(int tile, int g, int col, int s, int q) {
  return (size_t)(tile * MMA_ROWS + g + 8 * (q >> 1)) * H + col + 8 * s + (q & 1);
}

__device__ __forceinline__ uint4 fragment(const float (&v)[2][4]) {
  return make_uint4(pack_bf16(v[0][0], v[0][1]), pack_bf16(v[0][2], v[0][3]), pack_bf16(v[1][0], v[1][1]),
                    pack_bf16(v[1][2], v[1][3]));
}

// The carried state of this warp's tiles: float32 h1 (and kernel 6's h2)
// into the shared slots, bf16 h1 and h2 into the x1 and x2 halves that step
// 0 reads (half 1), in this CTA's unit group's A-fragment slot. Rows past
// n_rows are zero.
template <typename GI, typename OUT, bool H2_SHARED>
__device__ void seed_state(const Params<GI, OUT>& p, float* h1s, float* h2s, int tile0, int n_tiles, int own,
                           int col, int g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t half_u4 = (size_t)p.tiles * KS * 32;
  for (int i = warp; i < n_tiles; i += WARPS) {
    const int tile = tile0 + i;
    float v1[2][4], v2[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool valid = tile * MMA_ROWS + g + 8 * (q >> 1) < p.n_rows;
        const size_t at = slot_index(tile, g, col, s, q);
        v1[s][q] = valid ? p.h1_0[at] : 0.0f;
        v2[s][q] = valid ? p.h2_0[at] : 0.0f;
        h1s[i * H_SLOTS * 32 + (s * 4 + q) * 32 + lane] = v1[s][q];
        if (H2_SHARED) h2s[i * H_SLOTS * 32 + (s * 4 + q) * 32 + lane] = v2[s][q];
      }
    p.x1[half_u4 + (size_t)tile * KS * 32 + own] = fragment(v1);
    p.x2[half_u4 + (size_t)tile * KS * 32 + own] = fragment(v2);
  }
}

template <typename GI, typename OUT, bool H2_SHARED, bool CARRIED>
__global__ void __launch_bounds__(THREADS, 1) gru_gates_p_kernel(Params<GI, OUT> p) {
  static_assert(H2_SHARED || std::is_same_v<OUT, float>, "h2 is read back from out only where out is float32");
  extern __shared__ uint4 smem[];
  uint4* ws = smem;                                                   // [KB][32][3]
  Pair<GI>* gis = reinterpret_cast<Pair<GI>*>(smem + W_U4);           // [tiles_per_group][GI_SLOTS][32]
  float* h1s = reinterpret_cast<float*>(gis + p.tiles_per_group * GI_SLOTS * 32);  // [..][H_SLOTS][32]
  float* h2s = h1s + p.tiles_per_group * H_SLOTS * 32;                // kernel 6: [..][H_SLOTS][32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int ug = blockIdx.x % UNIT_GROUPS, rg = blockIdx.x / UNIT_GROUPS;
  const int tile0 = rg * p.tiles_per_group;
  const int n_tiles = min(p.tiles_per_group, p.tiles - tile0);  // >= 1: the launcher checks the plan
  const int col = ug * U + (lane & 3) * 2;  // the lane's first unit; +8 in the second n8 tile

  const size_t own = (size_t)ug * 32 + lane;  // this thread's uint4 of a tile's fragments
  const uint4* wsrc = p.w + (size_t)ug * W_U4;
  for (int i = threadIdx.x; i < W_U4; i += THREADS) cp_async16(ws + i, wsrc + i);
  if constexpr (CARRIED) {  // step 0 continues a carried state
    seed_state<GI, OUT, H2_SHARED>(p, h1s, h2s, tile0, n_tiles, own, col, g);
  } else {
    for (int i = threadIdx.x; i < n_tiles * H_SLOTS * 32; i += THREADS) {
      h1s[i] = 0.0f;
      if (H2_SHARED) h2s[i] = 0.0f;
    }
  }
  for (int i = warp; i < n_tiles; i += WARPS) prefetch_gi(p, gis + i * GI_SLOTS * 32 + lane, tile0 + i, 0, col, g);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const uint4* w1 = ws + lane * 3;                   // wp1
  const uint4* w2a = ws + (KS * 32 + lane) * 3;      // wp2, h1 rows
  const uint4* w2b = ws + (2 * KS * 32 + lane) * 3;  // wp2, h2 rows
  const size_t half_u4 = (size_t)p.tiles * KS * 32;  // one ping-pong half
  const size_t frag_u4 = (size_t)KS * 32;            // one tile's K steps
  // Bias of row b8[k] at this lane's units of n8 tile s.
  auto bias = [&](int k, int s) { return __ldg(reinterpret_cast<const float2*>(p.b8 + k * H + col + 8 * s)); };

  uint4 ring[KS];
  unsigned int target = 0;
  if constexpr (CARRIED) {
    // Every unit group's fragments of h[-1] are written; step 0's first
    // layer-1 tile reads its h1[-1].
    target += UNIT_GROUPS;
    grid_barrier(p.barrier + rg * BARRIER_STRIDE, target);
    if (warp < n_tiles) load_block(ring, p.x1 + half_u4 + lane + (tile0 + warp) * frag_u4);
  }
  for (int t = 0; t < p.n_steps; ++t) {
    const bool has_prev = t > 0 || CARRIED;  // h[t-1] is not h = 0
    const uint4* x1_prev = p.x1 + ((t + 1) & 1) * half_u4 + lane;
    uint4* x1_cur = p.x1 + (t & 1) * half_u4;
    const uint4* x2_prev = p.x2 + ((t + 1) & 1) * half_u4 + lane;
    uint4* x2_cur = p.x2 + (t & 1) * half_u4;

    // ---- phase 1: h1[t]. The ring holds tile `warp`'s h1[t-1] (has_prev).
    for (int i = warp; i < n_tiles; i += WARPS) {
      const int tile = tile0 + i;
      float acc[8][4] = {};
      if (has_prev) mma_block<4>(ring, i + WARPS < n_tiles ? x1_prev + (tile + WARPS) * frag_u4 : nullptr, w1, acc);
      if (i == warp) cp_async_wait_all();  // this thread's gi copies of step t
      const Pair<GI>* gs = gis + i * GI_SLOTS * 32 + lane;
      float* hs = h1s + i * H_SLOTS * 32 + lane;
      float hn[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float2 bn = bias(0, s);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 xz = to_float2(gs[(s * 2 + half) * 32]), xr = to_float2(gs[(4 + s * 2 + half) * 32]);
          const float2 xn = to_float2(gs[(8 + s * 2 + half) * 32]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = half * 2 + e;
            const float z = sigmoid(get(xz, e) + acc[s][q]);
            const float r = sigmoid(get(xr, e) + acc[2 + s][q]);
            const float n = tanhf(get(xn, e) + r * (acc[4 + s][q] + get(bn, e)));
            const float h = (1.0f - z) * n + z * hs[(s * 4 + q) * 32];
            hs[(s * 4 + q) * 32] = h;
            hn[s][q] = h;
          }
        }
      }
      x1_cur[tile * frag_u4 + own] = fragment(hn);
    }
    target += UNIT_GROUPS;
    grid_barrier(p.barrier + rg * BARRIER_STRIDE, target);

    // ---- phase 2: h2[t]. Each tile's gi of step t+1 lands meanwhile.
    const uint4* x1_now = x1_cur + lane;
    if (warp < n_tiles) load_block(ring, x1_now + (tile0 + warp) * frag_u4);
    for (int i = warp; i < n_tiles; i += WARPS) {
      const int tile = tile0 + i;
      if (t + 1 < p.n_steps) prefetch_gi(p, gis + i * GI_SLOTS * 32 + lane, tile, t + 1, col, g);
      cp_async_commit();
      // The block after this tile's: the next tile's h1[t], or step t+1's
      // first layer-1 tile, which reads h1[t] too.
      const uint4* after = i + WARPS < n_tiles ? x1_now + (tile + WARPS) * frag_u4
                           : t + 1 < p.n_steps ? x1_now + (tile0 + warp) * frag_u4
                                               : nullptr;
      // f32 h2[t-1]: kernel 6's shared slots (zero or seeded at t = 0),
      // else out, or at t = 0 the carried state.
      float* h2 = h2s + i * H_SLOTS * 32 + lane;
      float2 hold[2][2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = tile * MMA_ROWS + g + 8 * half;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if constexpr (H2_SHARED)
            hold[s][half] = make_float2(h2[(s * 4 + half * 2) * 32], h2[(s * 4 + half * 2 + 1) * 32]);
          else if (!CARRIED || t > 0)
            hold[s][half] = t > 0 && row < p.n_rows
                                ? __ldcg(reinterpret_cast<const float2*>(p.out + ((size_t)row * p.n_steps + t - 1) * H +
                                                                         col + 8 * s))
                                : make_float2(0.0f, 0.0f);
          else
            hold[s][half] = row < p.n_rows ? *reinterpret_cast<const float2*>(p.h2_0 + (size_t)row * H + col + 8 * s)
                                           : make_float2(0.0f, 0.0f);
        }
      }
      float acc[8][4] = {};
      mma_block<4>(ring, has_prev ? x2_prev + tile * frag_u4 : after, w2a, acc);
      if (has_prev) mma_block<6>(ring, after, w2b, acc);
      float hn[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float2 bz = bias(1, s), br = bias(2, s), bi = bias(3, s), bh = bias(4, s);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = q & 1;
          const float z = sigmoid(acc[s][q] + get(bz, e));
          const float r = sigmoid(acc[2 + s][q] + get(br, e));
          const float n = tanhf((acc[4 + s][q] + get(bi, e)) + r * (acc[6 + s][q] + get(bh, e)));
          hn[s][q] = (1.0f - z) * n + z * get(hold[s][q >> 1], e);
          if (H2_SHARED) h2[(s * 4 + q) * 32] = hn[s][q];
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = tile * MMA_ROWS + g + 8 * half;
        if (row < p.n_rows)
#pragma unroll
          for (int s = 0; s < 2; ++s)
            store_pair(p.out + ((size_t)row * p.n_steps + t) * H + col + 8 * s, hn[s][half * 2], hn[s][half * 2 + 1]);
      }
      x2_cur[tile * frag_u4 + own] = fragment(hn);
    }
  }
  // The final state, from the thread's own slots: h1, and kernel 6's h2.
  if constexpr (CARRIED) {
    for (int i = warp; i < n_tiles; i += WARPS)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int tile = tile0 + i;
          if (tile * MMA_ROWS + g + 8 * (q >> 1) >= p.n_rows) continue;
          const size_t at = slot_index(tile, g, col, s, q);
          p.h1_T[at] = h1s[i * H_SLOTS * 32 + (s * 4 + q) * 32 + lane];
          if (H2_SHARED) p.h2_T[at] = h2s[i * H_SLOTS * 32 + (s * 4 + q) * 32 + lane];
        }
  }
  // Leave the row group's counters at 0 for the next launch on the stream:
  // each CTA's thread 0 is past its last wait when it checks out, so the
  // last of the 25 to check out resets both.
  if (threadIdx.x == 0) {
    unsigned int* counters = p.barrier + rg * BARRIER_STRIDE;
    if (atomicAdd(counters + 1, 1u) == UNIT_GROUPS - 1) {
      atomicExch(counters, 0u);
      atomicExch(counters + 1, 0u);
    }
  }
}

// Dynamic shared memory of a CTA of kernel `kind` holding tiles_per_group
// tiles; -1 for an unknown kind.
int smem_bytes(int kind, int tiles_per_group) {
  const int tile = kind == 4 ? tile_bytes<bf16, false>()
                   : kind == 5 ? tile_bytes<float, false>()
                   : kind == 6 ? tile_bytes<bf16, true>()
                               : -1;
  return tile < 0 ? -1 : W_BYTES + tiles_per_group * tile;
}

struct Launch {
  const void *gz, *gr, *gn, *w;
  const float* b8;
  void *out, *x1, *x2;
  unsigned int* barrier;
  const float *h1_0, *h2_0;
  float *h1_T, *h2_T;
  int n_rows, n_steps, tiles, row_groups, tiles_per_group;
  cudaStream_t stream;
};

// Refuses, before the launch, a refused shared-memory size or a grid the
// device cannot hold at once (a barrier would deadlock).
template <typename GI, typename OUT, bool H2_SHARED>
cudaError_t launch(const Launch& a) {
  void (*kernel)(Params<GI, OUT>) = a.h1_0 ? gru_gates_p_kernel<GI, OUT, H2_SHARED, true>
                                           : gru_gates_p_kernel<GI, OUT, H2_SHARED, false>;
  const int smem = W_BYTES + a.tiles_per_group * tile_bytes<GI, H2_SHARED>();
  const int grid = UNIT_GROUPS * a.row_groups;
  int dev = 0, coop = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (blocks < 1 || grid > blocks * sms) return cudaErrorCooperativeLaunchTooLarge;
  Params<GI, OUT> p{static_cast<const GI*>(a.gz), static_cast<const GI*>(a.gr), static_cast<const GI*>(a.gn),
                    static_cast<const uint4*>(a.w), a.b8, static_cast<OUT*>(a.out), static_cast<uint4*>(a.x1),
                    static_cast<uint4*>(a.x2), a.barrier, a.h1_0, a.h2_0, a.h1_T, a.h2_T, a.n_rows, a.n_steps,
                    a.tiles, a.tiles_per_group};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args, smem, a.stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel A: the bf16_3x form of kernels 1 and 5 (the 'high' tier's
// recurrence, and its mixes with 'default'), kernel 5's function with a
// pass count for each product class: gru_h (h1 Wh1 and wp2's h2 rows) and
// gru_i (wp2's h1 rows, h1 Wi2). One pass is a bf16 product, kernel 5's;
// three are bf16_3x, as ops/precision.py::_bf16_3x defines it for one
// product and the TPU runs Precision.HIGH: each operand split into hi =
// bf16(x) and lo = bf16(x - hi), hi*lo and lo*hi summed in float32 in one
// set of accumulators, hi*hi in another, the two added (small + large) at
// the end of the phase; lo*lo is dropped. z2 and r2 sum both halves of
// K = 800, so a half's pass count applies to its half. PI = PH = 1 is
// kernel 5's instantiation above, unchanged; this body takes the mixes
// with at least one three-pass class.
//
// Plan. Both halves of a 16-unit group's weights would take 230,400 of a
// block's 232,448 bytes, so a CTA here owns U3 = 8 hidden units (one n8
// tile, 50 unit groups): their hi and lo weights are the same 115,200
// bytes a CTA as kernel 5's, in mma.sync B-fragment order (each lane's 48
// bytes of a K step: z, r, n hi, then z, r, n lo). A row group needs all
// 50 unit groups, so a wave holds sm_count / 50 row groups (2 on 132 SMs:
// 100 CTAs; a third would take 150, so 32 SMs stay idle). Nothing a CTA
// keeps in shared memory grows with its rows (gi is read from global
// memory at a tile's start, the float32 h1 lives in the h1 operand), so
// one launch takes any row count: 1,680 rows are 2 row groups of 54 and
// 51 tiles.
//
// What bounds it: at 1,680 rows x 54 steps the products are 774 GFLOP of
// bf16 at (3, 3) passes, 0.78 ms at 989 TFLOP/s. Every step each CTA needs
// h's hi (and lo) fragments for all its tiles and all 400 units: 75 K
// steps x 512 bytes x 2 halves a tile. Read by every CTA from L2 that was
// 21.50 GB a call at 1,680 rows, and the first design's time followed
// those bytes (~5.4 TB/s). Here the 50 CTAs of a row group form clusters
// of CLUSTER3 = 5 consecutive unit groups, and each K step of a tile's
// fragments leaves L2 once per cluster:
//
//   exchange L2 reads a call, 1,680 x 54, counted from the plan
//                                          (3, 3)    (1, 3)    (3, 1)
//   one read a CTA (the first design)      21.50 GB  17.88     14.38
//   one read a cluster of 5 (this one)      4.30 GB   3.58      2.88
//
// Multicast divides the L2 reads, not what a CTA takes in: each still
// receives every fragment it reads into its shared memory, ~4.07 MB a step
// at 1,680 rows and (3, 3), as many bytes as it loaded from L2 before.
//
// The exchange buffers xh and xl ([2 ping-pong][50 K steps][pairs of
// tiles][2 tiles][32 lanes] uint4: bf16 hi and lo of h in mma.sync
// A-fragment order) hold h1 in K steps 0-24 and h2 in 25-49, so phase 2 of
// step t reads h1[t] | h2[t-1] from one half: h1 of step s lives in
// ping-pong half s & 1, h2 of step s in half (s + 1) & 1. For one K step
// the tiles of a row group lie side by side. The two CTAs of a K step each
// write their half (8 bytes) of a lane's 16-byte fragment, with plain
// stores, as before.
//
// Work. Nine MMA warps take the CTA's tiles in items, a pair of tiles
// where the CTA holds more than 9 (a warp then loads each weight fragment
// once for two tiles' MMAs), else one, and walk them in rounds of 9 items,
// all warps on the same K step of their round's items (a row group's 27
// pairs at 1,680 rows fill 3 rounds, where 8 warps took 4). A stage of the
// ring is one such K step: the round's tiles' hi fragments (up to 9 KB),
// then their lo (at 9 KB). Two copy warps fill the SLOTS3 = 6 slots, each
// walking the stages in order. The reporter waits for the slot's empty
// barrier (the 9 MMA warps read its last stage; a warp without an item in
// a short round waits for the stage and arrives all the same, so that no
// warp runs a phase ahead of the ring), reports that to the slot's
// cluster-empty barrier in the member of rank slot % 5, and arms the
// slot's full barrier with the stage's bytes. The issuer, in that member,
// waits for all 5 members' reports and issues cp.async.bulk ...
// .multicast::cluster of the hi (and lo) bytes into the same slot of all 5
// members, completing on each one's full barrier. (One warp in both roles
// made the 5 members' copy warps move in lockstep, a remote round trip a
// stage.) The MMA warps only wait for full barriers and arrive on their
// own CTA's empty ones, after fence.proxy.async.shared::cta orders their
// reads of a slot before a bulk copy rewrites it. The copy warps take a
// stage only when its h is complete: those of phase 2 of step t and phase
// 1 of step t+1 after the row group's barrier of step t, and
// fence.proxy.async on both sides of that barrier orders the stores of h
// with the copies that read it. Shared memory a CTA:
//
//   weights, hi and lo of 8 units x 1,200 K rows x 3 gates   115,200
//   ring: 6 stages x (9 KB hi + 9 KB lo)                     110,592
//   mbarriers: 6 slots x (full, empty, cluster-empty) x 8         144
//   total (a block may have 232,448)                         225,936
//
// Per step: phase 1 computes h1[t] (K = 400, class gru_h), then the row
// group's barrier (grid_barrier.cuh on the row group's counter, 50
// arrivals; a second counter lets the last CTA out zero both), then phase
// 2 computes h2[t] (K = 800: h1[t] at gru_i, h2[t-1] at gru_h). Why one
// barrier a step is enough is kernel 5's argument, above. The grid is one
// cooperative launch with the cluster attribute; the launcher refuses a
// grid whose clusters cannot all be resident at once
// (cudaOccupancyMaxActiveClusters), as a barrier over CTAs that are not
// would deadlock. A carried state is seeded before the first step (each
// CTA writes its units' fragments of h1[-1] and h2[-1], then one barrier
// more), an instantiation of its own (CARRIED); the float32 h1[-1] is
// read from h1_0 at step 0.
//
// The bits. Each accumulator of a row takes the MMAs it took when every
// CTA read its A fragments from L2 (hi x hi into acc; hi x lo, then lo x
// hi, into sm; K steps in order; the h1 half before the h2 half), on the
// same fragments, and the gate math is the same code: only where the A
// fragments come from changed, so the outputs are bit for bit the same.
// ---------------------------------------------------------------------------

constexpr int U3 = 8;                  // hidden units per CTA: one n8 tile
constexpr int UNIT_GROUPS3 = H / U3;   // 50
constexpr int KS2 = 2 * KS;            // K steps of an exchange row: h1, then h2
constexpr int CLUSTER3 = 5;            // CTAs of a row group that share each fetch of h
constexpr unsigned short MASK3 = (1u << CLUSTER3) - 1;
constexpr int MMA3 = 9;                 // MMA warps: 27 pairs of tiles in 3 rounds (1,680 rows)
constexpr int THREADS3 = MMA3 * 32 + 64;  // and the reporting and the issuing copy warp
constexpr int SLOTS3 = 6;               // stages in the ring
constexpr int STAGE3_U4 = 1152;         // a stage: hi of up to 9 pairs of tiles (9 KB), then lo
constexpr int LO3_U4 = 576;
constexpr int SMEM3 = W_BYTES + SLOTS3 * (STAGE3_U4 * 16 + 3 * 8);
static_assert(SMEM3 == 225936 && SMEM3 <= SMEM_LIMIT, "kernel A's shared memory plan");
static_assert(UNIT_GROUPS3 % CLUSTER3 == 0, "kernel A's clusters");

struct Params3 {
  const float* gz;  // [n_rows, n_steps, H] each
  const float* gr;
  const float* gn;
  const uint4* w;   // [UNIT_GROUPS3][KB][32 lanes][3]: z, r, n hi then z, r, n lo, 2 words each
  const float* b8;  // [8, H]
  float* out;       // [n_rows, n_steps, H]
  uint4* xh;        // [2][KS2][pairs][2][32]: bf16 hi of h1 | h2 in A-fragment order
  uint4* xl;        // the lo halves
  float* h1;        // [n_rows, H]: float32 h1, the final h1 at exit
  unsigned int* barrier;  // [row groups][BARRIER_STRIDE]: zero at launch, left zero at exit
  const float* h1_0;      // [n_rows, H] each: the carried state h[-1], or null for h = 0
  const float* h2_0;
  int n_rows, n_steps, tiles, tiles_per_group;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// The local arrival of a full barrier, armed with the bytes its stage brings.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// An arrival on the barrier at the same offset in the cluster member of rank `rank`.
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}
// `bytes` from global src into the same offset `dst` of every member in
// MASK3, each completing on its barrier at offset `bar`.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], "
      "%4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(MASK3)
      : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Orders this thread's generic-proxy accesses of global memory with the
// async proxy's (the bulk copies read the exchange the stores wrote).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async;\n" ::: "memory"); }
// The same for this thread's accesses of its CTA's shared memory (its reads
// of a ring slot, before a bulk copy writes the slot again).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// uint4 offset of (ping-pong half, K step, tile) in xh or xl.
__device__ __forceinline__ size_t xoff(int half, int k, int pairs, int tile) {
  return ((((size_t)half * KS2 + k) * pairs + (tile >> 1)) * 2 + (tile & 1)) * 32;
}

// A CTA's tiles as the MMA warps walk them: items (pairs of tiles above
// MMA3 tiles, else single tiles) in rounds of MMA3, item MMA3 r + w warp w's.
struct Items3 {
  int tile0, n_tiles, n_items, pairs;
  bool paired;
  __device__ __forceinline__ int rounds() const { return (n_items + MMA3 - 1) / MMA3; }
  __device__ __forceinline__ int size(int r) const { return min(MMA3, n_items - r * MMA3); }
  __device__ __forceinline__ int first(int i) const { return tile0 + (paired ? 2 * i : i); }
  __device__ __forceinline__ bool two(int i) const { return paired && 2 * i + 1 < n_tiles; }
  // The pairs a stage of round r holds, from pair base(r) on.
  __device__ __forceinline__ int base(int r) const { return (tile0 >> 1) + (paired ? r * MMA3 : 0); }
  __device__ __forceinline__ int count(int r) const {
    return paired ? size(r) : ((tile0 + n_tiles - 1) >> 1) - (tile0 >> 1) + 1;
  }
};

// An MMA warp's place in the ring: the next stage's slot and its full
// barrier's parity.
struct Reader3 {
  const uint4* ring;  // this lane's uint4 in slot 0 (generic)
  uint32_t bars;      // full[0]; empty[s] is SLOTS3 barriers past full[s]
  int slot;
  uint32_t parity;

  __device__ __forceinline__ void advance() {
    if (++slot == SLOTS3) {
      slot = 0;
      parity ^= 1;
    }
  }
  // Waits for the next stage; -> this lane's uint4 of the stage's hi at `at`.
  __device__ __forceinline__ const uint4* acquire(int at) const {
    mbar_wait(bars + slot * 8, parity);
    return ring + slot * STAGE3_U4 + at;
  }
  // After the warp has read the stage: its arrival on the empty barrier.
  __device__ __forceinline__ void release() {
    fence_proxy_async_shared();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(bars + (SLOTS3 + slot) * 8);
    advance();
  }
  // A warp without an item in a round still waits for and releases each of
  // its stages: a barrier's parity tells only its current phase from the
  // last, so no warp may run a phase ahead of the ring.
  __device__ __forceinline__ void skip(int n) {
    for (int k = 0; k < n; ++k) {
      acquire(0);
      release();
    }
  }
};

// Lane 0 of a copy warp, which walks the stages in order in one of two
// roles. The reporter waits for this CTA's MMA warps to read a slot's last
// stage, reports that to the slot's cluster-empty barrier in the member of
// rank slot % CLUSTER3, and arms the slot's full barrier with the next
// stage's bytes. The issuer, in the member that fills the slot, waits for
// every member's report and issues the bulk copies. Apart, neither waits
// on the other: the reporters run ahead on their own MMA warps' progress.
struct Writer3 {
  uint32_t slots, bars;  // shared addresses: slot 0, full[0]
  uint32_t rank;
  bool reporter;
  int slot, use;

  // One stage: `bytes` of hi from hi (and as much lo from lo, unless null).
  __device__ __forceinline__ void stage(const uint4* hi, const uint4* lo, uint32_t bytes) {
    const uint32_t full = bars + slot * 8, empty = full + SLOTS3 * 8, cluster_empty = empty + SLOTS3 * 8;
    const uint32_t issuer = slot % CLUSTER3;
    if (reporter) {
      if (use > 0) {
        mbar_wait(empty, (use - 1) & 1);
        mbar_arrive_at(cluster_empty, issuer);
      }
      mbar_expect_tx(full, lo ? 2 * bytes : bytes);
    } else if (issuer == rank) {
      if (use > 0) mbar_wait(cluster_empty, (use - 1) & 1);
      const uint32_t dst = slots + slot * STAGE3_U4 * 16;
      bulk_multicast(dst, hi, bytes, full);
      if (lo) bulk_multicast(dst + LO3_U4 * 16, lo, bytes, full);
    }
    if (++slot == SLOTS3) {
      slot = 0;
      ++use;
    }
  }
};

// A copy warp's stages of one phase: round by round, K steps 0 .. k1 of
// ping-pong half `half`, the K steps below KS at P_LOW passes and the rest
// at P_HIGH.
template <int P_LOW, int P_HIGH>
__device__ __forceinline__ void write_phase(Writer3& writer, const uint4* xh, const uint4* xl, const Items3& items,
                                            int half, int k1) {
  for (int r = 0; r < items.rounds(); ++r) {
    const uint32_t bytes = items.count(r) * 1024;
    for (int k = 0; k < k1; ++k) {
      const size_t at = xoff(half, k, items.pairs, 2 * items.base(r));
      writer.stage(xh + at, (k < KS ? P_LOW : P_HIGH) == 3 ? xl + at : nullptr, bytes);
    }
  }
}

// One block of 25 K steps of a class at P passes, for an item's one or two
// tiles from the ring (`at`: the item's offset in a stage): acc[tt][0],
// acc[tt][1] (z, r) and acc[tt][NG] (the n gate) += hi x hi; with P = 3,
// sm[tt][..] += hi x lo, then lo x hi, each accumulator's MMAs in the order
// of the first design, which read the A fragments from L2. w: this lane's
// slot of the block's first K step's weights.
template <int P, int NG>
__device__ __forceinline__ void ring_block(Reader3& reader, int at, const uint4* w, bool two, float (&acc)[2][4][4],
                                           float (&sm)[2][4][4]) {
#pragma unroll 1
  for (int j = 0; j < KS; ++j) {
    const uint4* a = reader.acquire(at);
    uint4 ah[2], al[2];
    ah[0] = a[0];
    ah[1] = two ? a[32] : ah[0];
    if constexpr (P == 3) {
      al[0] = a[LO3_U4];
      al[1] = two ? a[LO3_U4 + 32] : al[0];
    }
    const uint4* wj = w + j * 32 * 3;
    const uint4 b0 = wj[0], b1 = wj[1];
    const uint4 b2 = P == 3 ? wj[2] : b1;
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      if (tt == 1 && !two) break;
      mma_bf16(acc[tt][0], ah[tt], b0.x, b0.y);
      mma_bf16(acc[tt][1], ah[tt], b0.z, b0.w);
      mma_bf16(acc[tt][NG], ah[tt], b1.x, b1.y);
      if constexpr (P == 3) {
        mma_bf16(sm[tt][0], ah[tt], b1.z, b1.w);
        mma_bf16(sm[tt][0], al[tt], b0.x, b0.y);
        mma_bf16(sm[tt][1], ah[tt], b2.x, b2.y);
        mma_bf16(sm[tt][1], al[tt], b0.z, b0.w);
        mma_bf16(sm[tt][NG], ah[tt], b2.z, b2.w);
        mma_bf16(sm[tt][NG], al[tt], b1.x, b1.y);
      }
    }
    // Released after the MMAs, which wait for the loads, so the fence in
    // release() has nothing left to wait for.
    reader.release();
  }
}

// This CTA's half of a lane's fragment uint4 of one tile and K step: the
// four h values v (rows g, g, g + 8, g + 8 of units col, col + 1) as bf16
// hi and lo.
__device__ __forceinline__ void store_half3(uint4* xh, uint4* xl, size_t at, int half, const float (&v)[4]) {
  float l[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) l[q] = v[q] - __bfloat162float(__float2bfloat16_rn(v[q]));
  reinterpret_cast<uint2*>(xh + at)[half] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  reinterpret_cast<uint2*>(xl + at)[half] = make_uint2(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]));
}

__device__ __forceinline__ float2 load_pair(const float* p, bool valid) {
  return valid ? *reinterpret_cast<const float2*>(p) : make_float2(0.0f, 0.0f);
}

template <int PI, int PH, bool CARRIED>
__global__ void __launch_bounds__(THREADS3, 1) gru_3x_kernel(Params3 p) {
  extern __shared__ uint4 smem[];
  uint4* ws = smem;                                // [KB][32][3]
  uint4* ring = smem + W_U4;                       // [SLOTS3][STAGE3_U4]
  const uint32_t bars = smem_u32(ring + SLOTS3 * STAGE3_U4);  // full, empty, cluster-empty: SLOTS3 each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int ug = blockIdx.x % UNIT_GROUPS3, rg = blockIdx.x / UNIT_GROUPS3;
  Items3 items;
  items.tile0 = rg * p.tiles_per_group;
  items.n_tiles = min(p.tiles_per_group, p.tiles - items.tile0);  // >= 1: the launcher checks the plan
  items.paired = items.n_tiles > MMA3;  // then tile0 is even: the launcher checks the plan
  items.n_items = items.paired ? (items.n_tiles + 1) / 2 : items.n_tiles;
  items.pairs = (p.tiles + 1) / 2;
  const int col = ug * U3 + (lane & 3) * 2;  // the lane's two units
  const int kx = ug >> 1, half = ug & 1;     // the K step of h this CTA's units form, and its half of a lane's uint4

  const uint4* wsrc = p.w + (size_t)ug * W_U4;
  for (int i = threadIdx.x; i < W_U4; i += THREADS3) cp_async16(ws + i, wsrc + i);
  cp_async_commit();
  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS3; ++s) {
      mbar_init(bars + s * 8, 1);
      mbar_init(bars + (SLOTS3 + s) * 8, MMA3);
      mbar_init(bars + (2 * SLOTS3 + s) * 8, CLUSTER3);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (CARRIED && warp < MMA3) {  // h[-1]: step 0's fragments, h1 in ping-pong half 1 and h2 in half 0
    for (int tile = items.tile0 + warp; tile < items.tile0 + items.n_tiles; tile += MMA3) {
      float v1[4], v2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = tile * MMA_ROWS + g + 8 * (q >> 1);
        const bool valid = row < p.n_rows;
        v1[q] = valid ? p.h1_0[(size_t)row * H + col + (q & 1)] : 0.0f;
        v2[q] = valid ? p.h2_0[(size_t)row * H + col + (q & 1)] : 0.0f;
      }
      store_half3(p.xh, p.xl, xoff(1, kx, items.pairs, tile) + lane, half, v1);
      store_half3(p.xh, p.xl, xoff(0, KS + kx, items.pairs, tile) + lane, half, v2);
    }
    fence_proxy_async();
  }
  cp_async_wait_all();
  cluster_sync();  // every member's weights and barriers are ready

  Reader3 reader{ring + lane, bars, 0, 0u};
  Writer3 writer{smem_u32(ring), bars, cluster_rank(), warp == MMA3, 0, 0};
  const bool copier = warp >= MMA3 && lane == 0;
  const uint4* w1 = ws + lane * 3;                   // wp1
  const uint4* w2a = ws + (KS * 32 + lane) * 3;      // wp2, h1 rows
  const uint4* w2b = ws + (2 * KS * 32 + lane) * 3;  // wp2, h2 rows
  auto bias = [&](int k) { return __ldg(reinterpret_cast<const float2*>(p.b8 + k * H + col)); };
  // Item i's offset in a stage of its round r.
  auto item_at = [&](int i, int r) {
    const int first = items.first(i);
    return ((first >> 1) - items.base(r)) * 64 + (first & 1) * 32;
  };

  unsigned int target = 0;
  if constexpr (CARRIED) {  // every unit group's fragments of h[-1] are written
    target += UNIT_GROUPS3;
    grid_barrier(p.barrier + rg * BARRIER_STRIDE, target);
  }
  for (int t = 0; t < p.n_steps; ++t) {
    const bool has_prev = t > 0 || CARRIED;  // h[t-1] is not h = 0

    // ---- phase 1: h1[t] = gates(gi[t], h1[t-1] wp1), class gru_h.
    if (copier) {
      if (has_prev) {
        fence_proxy_async();
        write_phase<PH, PH>(writer, p.xh, p.xl, items, (t + 1) & 1, KS);
      }
    } else if (warp < MMA3) {
      for (int r = 0; r < items.rounds(); ++r) {
        const int i = r * MMA3 + warp;
        if (i >= items.n_items) {  // no item this round
          if (has_prev) reader.skip(KS);
          continue;
        }
        const int first = items.first(i);
        const bool two = items.two(i);
        float2 gi[2][3][2], hp[2][2];  // [tile][gate][row half], [tile][row half]: the lane's units col, col + 1
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = (first + tt) * MMA_ROWS + g + 8 * hf;
            const bool valid = (tt == 0 || two) && row < p.n_rows;
            const size_t at = ((size_t)row * p.n_steps + t) * H + col;
            gi[tt][0][hf] = valid ? __ldg(reinterpret_cast<const float2*>(p.gz + at)) : make_float2(0.0f, 0.0f);
            gi[tt][1][hf] = valid ? __ldg(reinterpret_cast<const float2*>(p.gr + at)) : make_float2(0.0f, 0.0f);
            gi[tt][2][hf] = valid ? __ldg(reinterpret_cast<const float2*>(p.gn + at)) : make_float2(0.0f, 0.0f);
            hp[tt][hf] = t > 0 ? load_pair(p.h1 + (size_t)row * H + col, valid)
                               : load_pair(CARRIED ? p.h1_0 + (size_t)row * H + col : nullptr, CARRIED && valid);
          }
        float acc[2][4][4] = {}, sm[2][4][4] = {};
        if (has_prev) ring_block<PH, 2>(reader, item_at(i, r), w1, two, acc, sm);
        const float2 bn = bias(0);
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          if (tt == 1 && !two) break;
          float hn[4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = hf * 2 + e;
              const float z = sigmoid(get(gi[tt][0][hf], e) + (sm[tt][0][q] + acc[tt][0][q]));
              const float r1 = sigmoid(get(gi[tt][1][hf], e) + (sm[tt][1][q] + acc[tt][1][q]));
              const float n = tanhf(get(gi[tt][2][hf], e) + r1 * ((sm[tt][2][q] + acc[tt][2][q]) + get(bn, e)));
              hn[q] = (1.0f - z) * n + z * get(hp[tt][hf], e);
            }
          const int tile = first + tt;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = tile * MMA_ROWS + g + 8 * hf;
            if (row < p.n_rows) store_pair(p.h1 + (size_t)row * H + col, hn[hf * 2], hn[hf * 2 + 1]);
          }
          store_half3(p.xh, p.xl, xoff(t & 1, kx, items.pairs, tile) + lane, half, hn);
        }
      }
      fence_proxy_async();
    }
    target += UNIT_GROUPS3;
    grid_barrier(p.barrier + rg * BARRIER_STRIDE, target);

    // ---- phase 2: h2[t] = gates([h1[t] | h2[t-1]] wp2): the h1 half class
    // gru_i, the h2 half gru_h. The copy warps go on into phase 1 of step
    // t+1, whose h1[t] is complete too.
    if (copier) {
      fence_proxy_async();
      write_phase<PI, PH>(writer, p.xh, p.xl, items, t & 1, has_prev ? KS2 : KS);
    } else if (warp < MMA3) {
      for (int r = 0; r < items.rounds(); ++r) {
        const int i = r * MMA3 + warp;
        if (i >= items.n_items) {
          reader.skip(has_prev ? KS2 : KS);
          continue;
        }
        const int first = items.first(i);
        const bool two = items.two(i);
        // f32 h2[t-1]: out (this thread wrote it), or at t = 0 the carried state.
        float2 hold[2][2];
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = (first + tt) * MMA_ROWS + g + 8 * hf;
            const bool valid = (tt == 0 || two) && row < p.n_rows;
            if (!CARRIED || t > 0)
              hold[tt][hf] = t > 0 && valid ? __ldcg(reinterpret_cast<const float2*>(
                                                  p.out + ((size_t)row * p.n_steps + t - 1) * H + col))
                                            : make_float2(0.0f, 0.0f);
            else
              hold[tt][hf] = load_pair(p.h2_0 + (size_t)row * H + col, valid);
          }
        float acc[2][4][4] = {}, sm[2][4][4] = {};
        const int at = item_at(i, r);
        ring_block<PI, 2>(reader, at, w2a, two, acc, sm);
        if (has_prev) ring_block<PH, 3>(reader, at, w2b, two, acc, sm);
        const float2 bz = bias(1), br = bias(2), bi = bias(3), bh = bias(4);
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          if (tt == 1 && !two) break;
          float hn[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = q & 1;
            const float z = sigmoid((sm[tt][0][q] + acc[tt][0][q]) + get(bz, e));
            const float r2 = sigmoid((sm[tt][1][q] + acc[tt][1][q]) + get(br, e));
            const float n = tanhf(((sm[tt][2][q] + acc[tt][2][q]) + get(bi, e)) +
                                  r2 * ((sm[tt][3][q] + acc[tt][3][q]) + get(bh, e)));
            hn[q] = (1.0f - z) * n + z * get(hold[tt][q >> 1], e);
          }
          const int tile = first + tt;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = tile * MMA_ROWS + g + 8 * hf;
            if (row < p.n_rows)
              store_pair(p.out + ((size_t)row * p.n_steps + t) * H + col, hn[hf * 2], hn[hf * 2 + 1]);
          }
          store_half3(p.xh, p.xl, xoff((t + 1) & 1, KS + kx, items.pairs, tile) + lane, half, hn);
        }
      }
    }
  }
  // No member leaves while another may still signal its barriers.
  cluster_sync();
  // The last of the row group's CTAs to check out leaves its counters at 0.
  if (threadIdx.x == 0) {
    unsigned int* counters = p.barrier + rg * BARRIER_STRIDE;
    if (atomicAdd(counters + 1, 1u) == UNIT_GROUPS3 - 1) {
      atomicExch(counters, 0u);
      atomicExch(counters + 1, 0u);
    }
  }
}

template <int PI, int PH>
cudaError_t launch3(Params3 p, int row_groups, cudaStream_t stream) {
  void (*kernel)(Params3) = p.h1_0 ? gru_3x_kernel<PI, PH, true> : gru_3x_kernel<PI, PH, false>;
  const int grid = UNIT_GROUPS3 * row_groups;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = CLUSTER3;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(THREADS3);
  config.dynamicSmemBytes = SMEM3;
  config.stream = stream;
  config.attrs = attrs;
  config.numAttrs = 1;  // the occupancy query takes the cluster shape only
  int dev = 0, coop = 0, clusters = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM3);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &config);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (clusters * CLUSTER3 < grid) return cudaErrorCooperativeLaunchTooLarge;
  config.numAttrs = 2;
  void* args[] = {&p};
  err = cudaLaunchKernelExC(&config, (const void*)kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}


}  // namespace

extern "C" {

const char* fvad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Dynamic shared memory of a launch of kernel `kind` (4, 5 or 6) whose CTAs
// hold tiles_per_group 16-row tiles (the host's launch plan sizes it with
// the same sum); -1 for another kind.
int fvad_gru_gates_p_smem_bytes(int kind, int tiles_per_group) { return smem_bytes(kind, tiles_per_group); }

// The bf16 form of kernel `kind` (4, 5 or 6: the TPU kernel replaced). The
// flags say the operands' types: w_bf16 must be 1 (float32 weights run on
// csrc/gru_stack.cu), gi_bf16 1 for kernels 4 and 6 and 0 for kernel 5,
// out_bf16 0 except for kernel 6. gz, gr, gn [n_rows, n_steps, H] (bf16 or
// float32); w the per-unit-group packing [25][75][32][12] of wp1 and wp2's
// non-zero blocks (models/nsnet2_gates_cuda.py::pack_unit_groups); b8
// [8, H] float32; out [n_rows, n_steps, H] (bf16 or float32); x1, x2 each
// [2][tiles][25][32] uint4 of scratch; barrier: row_groups x 32 unsigned
// ints, zero at launch (two counters a row group, 128 bytes apart; the
// kernel leaves them zero, so launches in order on one stream can share
// them); h1_0, h2_0 [n_rows, H] float32 the carried state, or null for
// h = 0, and with a state h1_T [n_rows, H] for the final h1 and, for kernel
// 6, h2_T for the final float32 h2 (kernels 4 and 5 leave it in out's last
// step). All contiguous on the current device, 16-byte aligned. The plan
// (tiles = ceil(n_rows / 16), row_groups x tiles_per_group covering them,
// grid 25 x row_groups) comes from the host. Operand types a kind does not
// take, a plan that does not cover the tiles exactly, a CTA of more than
// MAX_TILES tiles, a refused shared-memory size, or a grid the device
// cannot hold at once (a barrier would deadlock) are refused before any
// launch. Launches cooperatively on `stream`; returns the cudaError_t.
int fvad_gru_gates_p(int kind, int w_bf16, int gi_bf16, int out_bf16, const void* gz, const void* gr, const void* gn,
                     const void* w, const float* b8, void* out, void* x1, void* x2, unsigned int* barrier,
                     const float* h1_0, const float* h2_0, float* h1_T, float* h2_T, int n_rows, int n_steps, int tiles,
                     int row_groups, int tiles_per_group, void* stream) {
  const bool types = w_bf16 && ((kind == 5 && !gi_bf16 && !out_bf16) || (kind == 4 && gi_bf16 && !out_bf16) ||
                                (kind == 6 && gi_bf16));
  const bool carried = h1_0 != nullptr;
  const bool state = (h2_0 != nullptr) == carried && (h1_T != nullptr) == carried &&
                     (h2_T != nullptr) == (carried && kind == 6);
  if (!types || !state || n_rows < 1 || n_steps < 1 || tiles != (n_rows + MMA_ROWS - 1) / MMA_ROWS || tiles_per_group < 1 ||
      tiles_per_group > MAX_TILES || row_groups < 1 || (long long)row_groups * tiles_per_group < tiles ||
      (long long)(row_groups - 1) * tiles_per_group >= tiles)
    return (int)cudaErrorInvalidValue;
  const Launch a{gz, gr, gn, w, b8, out, x1, x2, barrier, h1_0, h2_0, h1_T, h2_T, n_rows, n_steps, tiles,
                 row_groups, tiles_per_group, (cudaStream_t)stream};
  cudaError_t err;
  if (kind == 5)
    err = launch<float, float, false>(a);
  else if (kind == 4)
    err = launch<bf16, float, false>(a);
  else
    err = out_bf16 ? launch<bf16, bf16, true>(a) : launch<bf16, float, true>(a);
  return (int)err;
}

// Kernel A's plan constants: the dynamic shared memory of a CTA (the same
// at any row count) and the CTAs of a cluster.
int fvad_gru_gates_3x_smem_bytes(void) { return SMEM3; }
int fvad_gru_gates_3x_cluster(void) { return CLUSTER3; }

// Kernel A: kernel 5's function with passes_i bf16 passes for the gru_i
// products (wp2's h1 rows) and passes_h for the gru_h ones (wp1, wp2's h2
// rows), each 1 or 3, not both 1 (that is kernel 5: fvad_gru_gates_p). gz,
// gr, gn [n_rows, n_steps, H] float32; w the per-unit-group packing
// [50][75][32][12] of the hi and lo halves (models/nsnet2_gates_cuda.py::
// pack_unit_groups_3x); b8 [8, H] float32; out [n_rows, n_steps, H]
// float32; xh, xl each [2][ceil(tiles / 2)][50][2][32] uint4 of scratch;
// h1 [n_rows, H] float32, the running h1 (scratch, or the final h1 at
// exit); barrier: row_groups x 32 unsigned ints, zero at launch and left
// zero; h1_0, h2_0 [n_rows, H] float32 the carried state or null (the
// final h2 is out's last step). All contiguous on the current device,
// 16-byte aligned. The plan (tiles = ceil(n_rows / 16), row_groups x
// tiles_per_group covering them, tiles_per_group even where it is above 9,
// grid 50 x row_groups in clusters of 5) comes from the host. Pass counts
// other than the three mixes, a plan that does not cover the tiles
// exactly, a refused shared-memory size or cluster launch, or a grid whose
// clusters the device cannot hold at once are refused before any launch.
// Launches cooperatively, in clusters, on `stream`; returns the
// cudaError_t.
int fvad_gru_gates_3x(int passes_i, int passes_h, const float* gz, const float* gr, const float* gn, const void* w,
                      const float* b8, float* out, void* xh, void* xl, float* h1, unsigned int* barrier,
                      const float* h1_0, const float* h2_0, int n_rows, int n_steps, int tiles, int row_groups,
                      int tiles_per_group, void* stream) {
  if ((h2_0 != nullptr) != (h1_0 != nullptr) || h1 == nullptr || n_rows < 1 || n_steps < 1 ||
      tiles != (n_rows + MMA_ROWS - 1) / MMA_ROWS || tiles_per_group < 1 ||
      (tiles_per_group > MMA3 && tiles_per_group % 2) || row_groups < 1 ||
      (long long)row_groups * tiles_per_group < tiles || (long long)(row_groups - 1) * tiles_per_group >= tiles)
    return (int)cudaErrorInvalidValue;
  const Params3 p{gz, gr, gn, static_cast<const uint4*>(w), b8, out, static_cast<uint4*>(xh), static_cast<uint4*>(xl),
                  h1, barrier, h1_0, h2_0, n_rows, n_steps, tiles, tiles_per_group};
  const cudaStream_t st = (cudaStream_t)stream;
  if (passes_i == 3 && passes_h == 3) return (int)launch3<3, 3>(p, row_groups, st);
  if (passes_i == 1 && passes_h == 3) return (int)launch3<1, 3>(p, row_groups, st);
  if (passes_i == 3 && passes_h == 1) return (int)launch3<3, 1>(p, row_groups, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
