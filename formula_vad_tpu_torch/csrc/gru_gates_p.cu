// The bf16 forms of the per-gate NSNet2 GRU-stack kernels 4, 5 and 6 for
// Hopper (sm_90a): one body, three instantiations. Below it, kernel A:
// kernel 5's function with three bf16 passes (bf16_3x) for a class of
// products, on a body of its own (gru_3x_kernel).
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
// Memory plan. Both halves of a 16-unit group's weights would take
// 230,400 of a block's 232,448 bytes, so a CTA here owns U3 = 8 hidden
// units (one n8 tile, 50 unit groups): their hi and lo weights are the
// same 115,200 bytes a CTA as kernel 5's, in mma.sync B-fragment order
// (each lane's 48 bytes of a K step: z, r, n hi, then z, r, n lo). A wave
// holds sm_count / 50 row groups (2 on 132 SMs: 100 CTAs) of at most
// MAX_TILES3 16-row tiles (TILE3_BYTES each: gi 1,536 and h1 512), so a
// call of 1,680 rows is one launch (2 x 53 tiles) and the host splits more
// than 1,824 rows into launches of one wave each. h crosses between CTAs
// split: hi and lo in exchange buffers of their own (x1h, x1l, x2h, x2l,
// A-fragment order as kernel 5's); the two CTAs of a K step each write
// their half (8 bytes) of a lane's 16-byte fragment. A three-pass class
// reads both, a one-pass class hi only. Everything else (the row group's
// barrier, gi prefetched a step ahead, float32 h1 in shared slots, h2
// read back from the float32 out, the carried state) is kernel 5's.
// ---------------------------------------------------------------------------

constexpr int U3 = 8;                  // hidden units per CTA: one n8 tile
constexpr int UNIT_GROUPS3 = H / U3;   // 50
constexpr int GI3_SLOTS = 6;           // gi pairs per lane and tile: 3 gates x 2 row halves
constexpr int H3_SLOTS = 4;            // float h1 per lane and tile
constexpr int TILE3_BYTES = (GI3_SLOTS * 8 + H3_SLOTS * 4) * 32;  // 2,048
constexpr int MAX_TILES3 = 57;         // 16-row tiles a CTA holds beside its weights
static_assert(W_BYTES + MAX_TILES3 * TILE3_BYTES <= SMEM_LIMIT, "kernel A's shared memory plan");

struct Params3 {
  const float* gz;  // [n_rows, n_steps, H] each
  const float* gr;
  const float* gn;
  const uint4* w;   // [UNIT_GROUPS3][KB][32 lanes][3]: z, r, n hi then z, r, n lo, 2 words each
  const float* b8;  // [8, H]
  float* out;       // [n_rows, n_steps, H]
  uint4* x1h;       // [2][tiles][KS][32]: bf16 hi of h1 in A-fragment order
  uint4* x1l;       // the lo halves
  uint4* x2h;       // the same for h2
  uint4* x2l;
  unsigned int* barrier;  // [row groups][BARRIER_STRIDE]: zero at launch, left zero at exit
  const float* h1_0;      // [n_rows, H] each: the carried state h[-1], or null for h = 0
  const float* h2_0;
  float* h1_T;            // [n_rows, H]: the final h1 (with a state)
  int n_rows, n_steps, tiles, tiles_per_group;
};

// One block of 25 K steps of a class at P passes: acc[0], acc[1] (z, r)
// and acc[NG] (the n gate) += hi x hi; with P = 3, sm[..] += hi x lo +
// lo x hi. hi, lo: this lane's uint4 of the block's first K step; w: its
// slot of the block's weights. A fragments load five K steps ahead.
template <int P, int NG>
__device__ __forceinline__ void mma_block3(const uint4* hi, const uint4* lo, const uint4* w, float (&acc)[4][4],
                                           float (&sm)[4][4]) {
  constexpr int G = 5;
  uint4 ah[2][G], al[2][G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    ah[0][j] = __ldcg(hi + j * 32);
    if constexpr (P == 3) al[0][j] = __ldcg(lo + j * 32);
  }
#pragma unroll
  for (int grp = 0; grp < KS / G; ++grp) {
    const int cur = grp & 1;
    if (grp + 1 < KS / G) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        ah[cur ^ 1][j] = __ldcg(hi + ((grp + 1) * G + j) * 32);
        if constexpr (P == 3) al[cur ^ 1][j] = __ldcg(lo + ((grp + 1) * G + j) * 32);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const uint4* wj = w + (grp * G + j) * 32 * 3;
      const uint4 b0 = wj[0], b1 = wj[1];
      const uint4 a = ah[cur][j];
      mma_bf16(acc[0], a, b0.x, b0.y);
      mma_bf16(acc[1], a, b0.z, b0.w);
      mma_bf16(acc[NG], a, b1.x, b1.y);
      if constexpr (P == 3) {
        const uint4 b2 = wj[2];
        const uint4 l = al[cur][j];
        mma_bf16(sm[0], a, b1.z, b1.w);
        mma_bf16(sm[0], l, b0.x, b0.y);
        mma_bf16(sm[1], a, b2.x, b2.y);
        mma_bf16(sm[1], l, b0.z, b0.w);
        mma_bf16(sm[NG], a, b2.z, b2.w);
        mma_bf16(sm[NG], l, b1.x, b1.y);
      }
    }
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

// Step t's gi of one tile -> its slots, slot gate * 2 + half holding the
// lane's units col, col + 1 of row g + 8 half; rows past n_rows zero.
__device__ __forceinline__ void prefetch_gi3(const Params3& p, float2* slots, int tile, int t, int col, int g) {
  const float* gi[3] = {p.gz, p.gr, p.gn};
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = tile * MMA_ROWS + g + 8 * half;
      const bool valid = row < p.n_rows;
      const float* src = gi[gate] + (valid ? ((size_t)row * p.n_steps + t) * H + col : 0);
      cp_async_ca<8>(slots + (gate * 2 + half) * 32, src, valid);
    }
}

template <int PI, int PH, bool CARRIED>
__global__ void __launch_bounds__(THREADS, 1) gru_3x_kernel(Params3 p) {
  extern __shared__ uint4 smem[];
  uint4* ws = smem;                                                          // [KB][32][3]
  float2* gis = reinterpret_cast<float2*>(smem + W_U4);                      // [tiles_per_group][GI3_SLOTS][32]
  float* h1s = reinterpret_cast<float*>(gis + p.tiles_per_group * GI3_SLOTS * 32);  // [..][H3_SLOTS][32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int ug = blockIdx.x % UNIT_GROUPS3, rg = blockIdx.x / UNIT_GROUPS3;
  const int tile0 = rg * p.tiles_per_group;
  const int n_tiles = min(p.tiles_per_group, p.tiles - tile0);  // >= 1: the launcher checks the plan
  const int col = ug * U3 + (lane & 3) * 2;  // the lane's two units
  const size_t own = (size_t)(ug >> 1) * 32 + lane;  // the lane's fragment uint4 of a tile's K step ug / 2
  const int half = ug & 1;                           // ... of which this CTA writes words (x, y) or (z, w)
  const size_t half_u4 = (size_t)p.tiles * KS * 32;  // one ping-pong half
  const size_t frag_u4 = (size_t)KS * 32;            // one tile's K steps

  const uint4* wsrc = p.w + (size_t)ug * W_U4;
  for (int i = threadIdx.x; i < W_U4; i += THREADS) cp_async16(ws + i, wsrc + i);
  for (int i = warp; i < n_tiles; i += WARPS) {
    float* hs = h1s + i * H3_SLOTS * 32 + lane;
    if constexpr (CARRIED) {  // h[-1]: the shared slots, and step 0's fragments (ping-pong half 1)
      const int tile = tile0 + i;
      float v1[4], v2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = tile * MMA_ROWS + g + 8 * (q >> 1);
        const bool valid = row < p.n_rows;
        v1[q] = valid ? p.h1_0[(size_t)row * H + col + (q & 1)] : 0.0f;
        v2[q] = valid ? p.h2_0[(size_t)row * H + col + (q & 1)] : 0.0f;
        hs[q * 32] = v1[q];
      }
      store_half3(p.x1h + half_u4, p.x1l + half_u4, tile * frag_u4 + own, half, v1);
      store_half3(p.x2h + half_u4, p.x2l + half_u4, tile * frag_u4 + own, half, v2);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) hs[q * 32] = 0.0f;
    }
    prefetch_gi3(p, gis + i * GI3_SLOTS * 32 + lane, tile0 + i, 0, col, g);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const uint4* w1 = ws + lane * 3;                   // wp1
  const uint4* w2a = ws + (KS * 32 + lane) * 3;      // wp2, h1 rows
  const uint4* w2b = ws + (2 * KS * 32 + lane) * 3;  // wp2, h2 rows
  auto bias = [&](int k) { return __ldg(reinterpret_cast<const float2*>(p.b8 + k * H + col)); };

  unsigned int target = 0;
  if constexpr (CARRIED) {  // every unit group's fragments of h[-1] are written
    target += UNIT_GROUPS3;
    grid_barrier(p.barrier + rg * BARRIER_STRIDE, target);
  }
  for (int t = 0; t < p.n_steps; ++t) {
    const bool has_prev = t > 0 || CARRIED;  // h[t-1] is not h = 0
    const size_t prev = ((t + 1) & 1) * half_u4 + lane, cur = (t & 1) * half_u4;

    // ---- phase 1: h1[t] = gates(gi[t], h1[t-1] wp1), class gru_h.
    for (int i = warp; i < n_tiles; i += WARPS) {
      const int tile = tile0 + i;
      float acc[4][4] = {}, sm[4][4] = {};
      if (has_prev) mma_block3<PH, 2>(p.x1h + prev + tile * frag_u4, p.x1l + prev + tile * frag_u4, w1, acc, sm);
      if (i == warp) cp_async_wait_all();  // this thread's gi copies of step t
      const float2* gs = gis + i * GI3_SLOTS * 32 + lane;
      float* hs = h1s + i * H3_SLOTS * 32 + lane;
      const float2 bn = bias(0);
      float hn[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 xz = gs[hf * 32], xr = gs[(2 + hf) * 32], xn = gs[(4 + hf) * 32];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = hf * 2 + e;
          const float z = sigmoid(get(xz, e) + (sm[0][q] + acc[0][q]));
          const float r = sigmoid(get(xr, e) + (sm[1][q] + acc[1][q]));
          const float n = tanhf(get(xn, e) + r * ((sm[2][q] + acc[2][q]) + get(bn, e)));
          const float h = (1.0f - z) * n + z * hs[q * 32];
          hs[q * 32] = h;
          hn[q] = h;
        }
      }
      store_half3(p.x1h + cur, p.x1l + cur, tile * frag_u4 + own, half, hn);
    }
    target += UNIT_GROUPS3;
    grid_barrier(p.barrier + rg * BARRIER_STRIDE, target);

    // ---- phase 2: h2[t] = gates([h1[t] | h2[t-1]] wp2): the h1 half class
    // gru_i, the h2 half gru_h. Each tile's gi of step t+1 lands meanwhile.
    for (int i = warp; i < n_tiles; i += WARPS) {
      const int tile = tile0 + i;
      if (t + 1 < p.n_steps) prefetch_gi3(p, gis + i * GI3_SLOTS * 32 + lane, tile, t + 1, col, g);
      cp_async_commit();
      // f32 h2[t-1]: out (this thread wrote it), or at t = 0 the carried state.
      float2 hold[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = tile * MMA_ROWS + g + 8 * hf;
        if (!CARRIED || t > 0)
          hold[hf] = t > 0 && row < p.n_rows
                         ? __ldcg(reinterpret_cast<const float2*>(p.out + ((size_t)row * p.n_steps + t - 1) * H + col))
                         : make_float2(0.0f, 0.0f);
        else
          hold[hf] = row < p.n_rows ? *reinterpret_cast<const float2*>(p.h2_0 + (size_t)row * H + col)
                                    : make_float2(0.0f, 0.0f);
      }
      float acc[4][4] = {}, sm[4][4] = {};
      mma_block3<PI, 2>(p.x1h + cur + lane + tile * frag_u4, p.x1l + cur + lane + tile * frag_u4, w2a, acc, sm);
      if (has_prev) mma_block3<PH, 3>(p.x2h + prev + tile * frag_u4, p.x2l + prev + tile * frag_u4, w2b, acc, sm);
      const float2 bz = bias(1), br = bias(2), bi = bias(3), bh = bias(4);
      float hn[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = q & 1;
        const float z = sigmoid((sm[0][q] + acc[0][q]) + get(bz, e));
        const float r = sigmoid((sm[1][q] + acc[1][q]) + get(br, e));
        const float n = tanhf(((sm[2][q] + acc[2][q]) + get(bi, e)) + r * ((sm[3][q] + acc[3][q]) + get(bh, e)));
        hn[q] = (1.0f - z) * n + z * get(hold[q >> 1], e);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = tile * MMA_ROWS + g + 8 * hf;
        if (row < p.n_rows) store_pair(p.out + ((size_t)row * p.n_steps + t) * H + col, hn[hf * 2], hn[hf * 2 + 1]);
      }
      store_half3(p.x2h + cur, p.x2l + cur, tile * frag_u4 + own, half, hn);
    }
  }
  if constexpr (CARRIED) {  // the final h1 from the thread's slots; h2 is out's last step
    for (int i = warp; i < n_tiles; i += WARPS)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = (tile0 + i) * MMA_ROWS + g + 8 * (q >> 1);
        if (row < p.n_rows) p.h1_T[(size_t)row * H + col + (q & 1)] = h1s[i * H3_SLOTS * 32 + q * 32 + lane];
      }
  }
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
  const int smem = W_BYTES + p.tiles_per_group * TILE3_BYTES;
  const int grid = UNIT_GROUPS3 * row_groups;
  int dev = 0, coop = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (blocks < 1 || grid > blocks * sms) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args, smem, stream);
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

// Dynamic shared memory of a kernel-A launch whose CTAs hold tiles_per_group tiles.
int fvad_gru_gates_3x_smem_bytes(int tiles_per_group) { return W_BYTES + tiles_per_group * TILE3_BYTES; }

// Kernel A: kernel 5's function with passes_i bf16 passes for the gru_i
// products (wp2's h1 rows) and passes_h for the gru_h ones (wp1, wp2's h2
// rows), each 1 or 3, not both 1 (that is kernel 5: fvad_gru_gates_p). gz,
// gr, gn [n_rows, n_steps, H] float32; w the per-unit-group packing
// [50][75][32][12] of the hi and lo halves (models/nsnet2_gates_cuda.py::
// pack_unit_groups with 8 units); b8 [8, H] float32; out [n_rows, n_steps,
// H] float32; x1h, x1l, x2h, x2l each [2][tiles][25][32] uint4 of scratch;
// barrier: row_groups x 32 unsigned ints, zero at launch and left zero;
// h1_0, h2_0 [n_rows, H] float32 the carried state or null, and with a
// state h1_T [n_rows, H] for the final h1 (the final h2 is out's last
// step). All contiguous on the current device, 16-byte aligned. The plan
// (tiles = ceil(n_rows / 16), row_groups x tiles_per_group covering them,
// grid 50 x row_groups) comes from the host. Pass counts other than the
// three mixes, a plan that does not cover the tiles exactly, a CTA of more
// than MAX_TILES3 tiles, a refused shared-memory size, or a grid the
// device cannot hold at once are refused before any launch. Launches
// cooperatively on `stream`; returns the cudaError_t.
int fvad_gru_gates_3x(int passes_i, int passes_h, const float* gz, const float* gr, const float* gn, const void* w,
                      const float* b8, float* out, void* x1h, void* x1l, void* x2h, void* x2l, unsigned int* barrier,
                      const float* h1_0, const float* h2_0, float* h1_T, int n_rows, int n_steps, int tiles,
                      int row_groups, int tiles_per_group, void* stream) {
  const bool carried = h1_0 != nullptr;
  if ((h2_0 != nullptr) != carried || (h1_T != nullptr) != carried || n_rows < 1 || n_steps < 1 ||
      tiles != (n_rows + MMA_ROWS - 1) / MMA_ROWS || tiles_per_group < 1 || tiles_per_group > MAX_TILES3 ||
      row_groups < 1 || (long long)row_groups * tiles_per_group < tiles ||
      (long long)(row_groups - 1) * tiles_per_group >= tiles)
    return (int)cudaErrorInvalidValue;
  const Params3 p{gz, gr, gn, static_cast<const uint4*>(w), b8, out, static_cast<uint4*>(x1h),
                  static_cast<uint4*>(x1l), static_cast<uint4*>(x2h), static_cast<uint4*>(x2l), barrier, h1_0,
                  h2_0, h1_T, n_rows, n_steps, tiles, tiles_per_group};
  const cudaStream_t st = (cudaStream_t)stream;
  if (passes_i == 3 && passes_h == 3) return (int)launch3<3, 3>(p, row_groups, st);
  if (passes_i == 1 && passes_h == 3) return (int)launch3<1, 3>(p, row_groups, st);
  if (passes_i == 3 && passes_h == 1) return (int)launch3<3, 1>(p, row_groups, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
