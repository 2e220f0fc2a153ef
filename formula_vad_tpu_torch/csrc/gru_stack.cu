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
// The plain version is models/nsnet2_cuda.py::gru_stack_reference. The
// tile's geometry, staging, FMA sums and gate math live in
// csrc/gru_tile.cuh, which kernel B (csrc/gru_mixed.cu: kernel 1's
// function with one product class on the tensor cores) shares.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grid_barrier.cuh"
#include "gru_tile.cuh"

namespace {

constexpr int THREADS = FMA_THREADS;  // 240

// Copy chunk `c` of `op` (k in [c*KC, c*KC + KC)) into one pipeline stage:
// rows_here rows of h, and the KC x 120 weight block of unit group ug, which
// the packed layout keeps contiguous.
__device__ __forceinline__ void stage_chunk(float* st, const Operand& op, int c, int row0, int rows_here, int ug) {
  stage_rows<THREADS>(st, op, c, row0, rows_here);
  stage_words<THREADS, KC * WCOLS / 4>(st, op.w + ((size_t)ug * H + c * KC) * WCOLS);
}

// One phase of one tile: LAYER2 = false computes h1[t], true computes h2[t].
template <bool LAYER2, typename OUT>
__device__ void tile_phase(const Params<OUT>& p, float* smem, int t, int tile) {
  const int tx = threadIdx.x % TU, ty = threadIdx.x / TU;
  const Tile c = tile_at<LAYER2>(p, t, tile);
  // Thread ty holds rows ty + TR*i. A warp whose first ty has all RM rows
  // inside the tile computes RM rows, any other RM - 1: at 130 rows, warps
  // 0-3 do 6 and warps 4-7 do 5, so each SM sub-partition (warps w and
  // w + 4) carries 11 rows' work.
  const bool active = ty < c.rows_here;
  const bool full = (threadIdx.x & ~31) / TU + TR * (RM - 1) < c.rows_here;

  // Layer 1: h1[t-1] Wh1 (nothing at t = 0 from h = 0). Layer 2: h1[t]
  // Wi2, then h2[t-1] Wh2 (where it exists); the n sums of the two stay
  // apart.
  const Operand a = LAYER2 ? Operand{c.h1_cur, (size_t)H, p.wi2} : Operand{c.h1_prev, (size_t)H, p.wh1};
  const Operand b = {c.h2_prev, c.h2_stride, p.wh2};  // layer 2 only
  const int total = LAYER2 ? (c.has_prev ? 2 * CHUNKS : CHUNKS) : (c.has_prev ? CHUNKS : 0);
  const int swap_at = LAYER2 ? CHUNKS : -1;
  // Chunk c of the phase: its operands picked field by field, so that the
  // choice stays in registers.
  auto operand = [&](int k) {
    const bool first = k < CHUNKS;
    return Operand{first ? a.h : b.h, first ? a.stride : b.stride, first ? a.w : b.w};
  };

  float az[RM][UM], ar[RM][UM], an[RM][UM], in[RM][UM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int u = 0; u < UM; ++u) az[i][u] = ar[i][u] = an[i][u] = in[i][u] = 0.0f;
  // Layer 2 sums the n gate of h1 Wi2 in `an`, moves it to `in` and then
  // sums that of h2 Wh2 in `an`: one accumulator set serves both products.
  auto swap_n = [&]() {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        in[i][u] = an[i][u];
        an[i][u] = 0.0f;
      }
  };

  __syncthreads();  // the previous phase's reads of the stages are done
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) stage_chunk(smem + s * STAGE_FLOATS, operand(s), s % CHUNKS, c.row0, c.rows_here, c.ug);
    cp_async_commit();
  }
  for (int k = 0; k < total; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = k + STAGES - 1;
    if (next < total)
      stage_chunk(smem + (next % STAGES) * STAGE_FLOATS, operand(next), next % CHUNKS, c.row0, c.rows_here, c.ug);
    cp_async_commit();
    if (k == swap_at) swap_n();
    if (active) {
      const float* st = smem + (k % STAGES) * STAGE_FLOATS;
      if (full)
        mac_chunk<RM>(st, ty, tx, az, ar, an);
      else
        mac_chunk<RM - 1>(st, ty, tx, az, ar, an);
    }
  }
  if (total == swap_at) swap_n();
  cp_async_wait<0>();
  if (!active) return;
  finish<LAYER2>(p, c, t, ty, tx, az, ar, an, in);
}

template <typename OUT>
__global__ void __launch_bounds__(THREADS, 1) gru_stack_kernel(Params<OUT> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  unsigned int target = 0;
  for (int t = 0; t < p.n_steps; ++t) {
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) tile_phase<false, OUT>(p, smem, t, tile);
    target += gridDim.x;
    grid_barrier(p.barrier, target);
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) tile_phase<true, OUT>(p, smem, t, tile);
  }
}

template <typename OUT>
cudaError_t blocks_per_sm(int* blocks) {
  const cudaError_t err =
      cudaFuncSetAttribute(gru_stack_kernel<OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gru_stack_kernel<OUT>, THREADS, SMEM_BYTES);
}

// Refuses a plan that does not cover the rows exactly, or a grid the
// device cannot hold at once (the grid barrier would deadlock), before any
// launch; then launches cooperatively.
template <typename OUT>
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
  if (err == cudaSuccess) err = blocks_per_sm<OUT>(&blocks);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (grid > blocks * sms) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)gru_stack_kernel<OUT>, dim3(grid), dim3(THREADS), args, SMEM_BYTES,
                                    stream);
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
// (models/nsnet2_cuda.py::pack); bh1, bi2, bh2 [3H]; out [n_rows, n_steps,
// H], bf16 when out_bf16, else float32; h1 scratch [2, n_rows, H]; h2
// scratch [2, n_rows, H] when out_bf16, else unused; barrier: one zeroed
// unsigned int; h1_0, h2_0 [n_rows, H] the carried state, or both null for
// h = 0. The final h1 ends in h1 scratch slot (n_steps - 1) & 1, the final
// h2 in out's last step or, with a bf16 out, in h2 scratch slot
// (n_steps - 1) & 1. All float32 but a bf16 out, contiguous and 16-byte
// aligned, on the current device. The plan (row_tile, row_groups,
// unit_groups, grid) comes from the host. A plan that does not cover the
// rows exactly, or a grid the device cannot hold at once (the grid barrier
// would deadlock), is refused before any launch. Launches cooperatively on
// `stream`; returns the launch's cudaError_t.
int fvad_gru_stack(const float* gi_z, const float* gi_r, const float* gi_n, const float* wh1, const float* bh1,
                   const float* wi2, const float* bi2, const float* wh2, const float* bh2, void* out, float* h1,
                   float* h2, unsigned int* barrier, const float* h1_0, const float* h2_0, int gi_stride,
                   int out_bf16, int n_rows, int n_steps, int row_tile, int row_groups, int unit_groups, int grid,
                   void* stream) {
  if (gi_stride < H || gi_stride % 4 || (h1_0 == nullptr) != (h2_0 == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16) {
    if (!h2) return (int)cudaErrorInvalidValue;
    return (int)launch(Params<bf16>{gi_z, gi_r, gi_n, wh1, wi2, wh2, bh1, bi2, bh2, static_cast<bf16*>(out), h1, h2,
                                    barrier, h1_0, h2_0, gi_stride, n_rows, n_steps, row_tile, unit_groups, 0},
                       row_groups, grid, st);
  }
  return (int)launch(Params<float>{gi_z, gi_r, gi_n, wh1, wi2, wh2, bh1, bi2, bh2, static_cast<float*>(out), h1,
                                   nullptr, barrier, h1_0, h2_0, gi_stride, n_rows, n_steps, row_tile, unit_groups, 0},
                     row_groups, grid, st);
}

}  // extern "C"
