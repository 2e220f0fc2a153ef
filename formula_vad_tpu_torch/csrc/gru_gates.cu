// The per-gate NSNet2 GRU-stack recurrence for Hopper (sm_90a), with
// bfloat16 weight operands.
//
// Replaces the bf16 forms of two TPU kernels of
// benchmarks/gru_kernel_exp.py, which compute one function with the
// rounding points in different places:
//   kernel 4  gru_stack_kernel   (body _kernel)    gi rounded to the weight
//             dtype, per-gate weight slabs w9, h2 out in float32;
//   kernel 6  gru_stack_kernel_f (body _kernel_f)  as kernel 4, with the
//             next step's gi prefetched while this step computes, h2 out in
//             out_dtype, and `tile` rows per grid slice.
// The bf16 form of kernel 5 (gru_stack_kernel_p: float32 gi, packed
// weights wp1 and wp2) is csrc/gru_gates_p.cu.
// Both GRU layers (H = 400, ONNX z|r|n, linear_before_reset = 1) run T
// steps from h = 0 over per-gate layer-1 input projections gi_z, gi_r,
// gi_n [N, T, H] (bi1 + bh1 folded into z and r, bi1 only into n). With
// b8 = [bh1_n, bi2_z + bh2_z, bi2_r + bh2_r, bi2_n, bh2_n], per step and row:
//   z1 = s(gi_z + h1 Wh1z)   r1 = s(gi_r + h1 Wh1r)
//   n1 = tanh(gi_n + r1 (h1 Wh1n + bh1_n))        h1 = (1 - z1) n1 + z1 h1
//   z2 = s(h1 Wi2z + h2 Wh2z + b2z)   r2 = s(h1 Wi2r + h2 Wh2r + b2r)
//   n2 = tanh((h1 Wi2n + bi2_n) + r2 (h2 Wh2n + bh2_n))
//   h2 = (1 - z2) n2 + z2 h2
// h1, h2 and the gate math stay float32. Each h is rounded to bf16 before
// it enters a product, and the products accumulate in float32: the TPU
// bodies' astype(w.dtype) then preferred_element_type = f32. The order of
// the float32 sums is the card's own (within a product, and layer 2's z and
// r sum both products in one accumulator). The float32 forms of the
// kernels compute kernel 1's function and run on its body, csrc/gru_stack.cu.
//
// What bounds it on the H100: at the scoring shape (1,680 rows x 54 steps)
// a call is 261 GFLOP of serial-step products (3 x [rows, 400] x [400, 1200]
// per step) on the tensor cores (989 TFLOP/s: 0.26 ms), where the limit
// that shows first is re-reading the 2.9 MB of bf16 weights from L2 every
// step in every block.
//
// Design (gates_mma): the TPU's sequential time grid becomes a loop inside
// the block; one block owns ROWS = 16 rows for all T steps and their h
// never leaves the SM. Blocks are independent, so a row's result does not
// depend on which block or tile holds it: kernel 6's `tile` only reshapes
// the grid (blockIdx.y = tile, blockIdx.x = 16-row block in it) and changes
// no bit. mma.sync.m16n8k16 (bf16 in, f32 accumulate): the 16 rows are one
// MMA M tile; 10 warps each own 5 tiles of 8 hidden units and hold, for
// each, the z, r and n accumulators of the same (row, unit) positions, so
// the gate math runs on the accumulator registers and h1, h2 stay in
// registers across steps. Shared memory holds only bf16(h1), bf16(h2) as
// the A operand (pitch 408, so the fragment loads hit 32 distinct banks).
// The wrapper packs each weight once into fragment order ([N/8][K/16][32
// lanes] of 8 bytes), so a warp's B fragment is one coalesced 256-byte
// load.
// Kernel 6: gi for step t+1 goes global -> shared memory by cp.async
// (double-buffered, zero-filled past N) while step t's products run: the
// TPU's make_async_copy + semaphores. Output is stored straight from
// registers in out_dtype (the TPU's out staging exists for its DMA).
// wgmma, TMA multicast of the weights across a cluster and filling all 132
// SMs (1680 / 16 = 105 blocks) are for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 400;
constexpr int ROWS = 16;           // rows per block: one MMA M tile
constexpr int UT = H / 8;          // 50 tiles of 8 hidden units (MMA N = 8)
constexpr int KS = H / 16;         // 25 K steps of 16 (MMA K = 16)
constexpr int MMA_WARPS = 10;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int UPW = UT / MMA_WARPS;  // 5 unit tiles per warp
constexpr int HP = H + 8;          // bf16 pitch of the h operand rows
constexpr int FRAG = 32;           // uint2 fragments per (unit tile, K step)

using bf16 = __nv_bfloat16;

// The nine weight slabs of one step, each [H, H] in fragment order
// [UT][KS][FRAG] uint2: wh1 z r n (seen by h1, layer 1), wi2 z r n (seen
// by h1, layer 2), wh2 z r n (seen by h2, layer 2).
constexpr int SLAB = UT * KS * FRAG;  // uint2s of one slab
constexpr int UT_STRIDE = KS * FRAG;  // uint2s from one unit tile to the next

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Kernel 6: step t's gi (three gates x ROWS rows x H) -> buf [3][ROWS][H],
// 16 bytes per copy, rows past the block's zero-filled.
template <typename GI>
__device__ __forceinline__ void prefetch_gi(GI* buf, const GI* const (&gi)[3], int row0, int rows_here,
                                            int n_steps, int t, int tid, int n_threads) {
  constexpr int PER = 16 / sizeof(GI);  // elements per copy
  constexpr int CPR = H / PER;          // copies per row
  for (int c = tid; c < 3 * ROWS * CPR; c += n_threads) {
    const int gate = c / (ROWS * CPR), r = (c / CPR) % ROWS, q = c % CPR;
    const bool valid = r < rows_here;
    const GI* src = gi[gate] + (valid ? ((size_t)(row0 + r) * n_steps + t) * H + q * PER : 0);
    cp_async16(buf + (gate * ROWS + r) * H + q * PER, src, valid);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// acc_g[u] += hb (16 x H, bf16) x slab g's unit tile (ut0 + u), for the three
// slabs first..first+2 and the warp's UPW unit tiles.
__device__ __forceinline__ void mma_pass3(const bf16* __restrict__ hb, const uint2* __restrict__ w9, int first,
                                          int ut0, int lane, float (&a0)[UPW][4], float (&a1)[UPW][4],
                                          float (&a2)[UPW][4]) {
  const uint2* w0 = w9 + (size_t)first * SLAB + (size_t)ut0 * UT_STRIDE + lane;
  const uint2* w1 = w0 + SLAB;
  const uint2* w2 = w1 + SLAB;
  // A fragment (m16n8k16, row-major): rows g and g + 8, columns 2 (lane % 4)
  // (+1) and the same + 8 of the K step.
  const uint32_t* p0 = reinterpret_cast<const uint32_t*>(hb + (lane >> 2) * HP + (lane & 3) * 2);
  const uint32_t* p1 = p0 + 8 * HP / 2;
#pragma unroll 1
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t a[4] = {p0[ks * 8], p1[ks * 8], p0[ks * 8 + 4], p1[ks * 8 + 4]};
    const int o = ks * FRAG;
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const uint2 b0 = __ldg(w0 + u * UT_STRIDE + o);
      const uint2 b1 = __ldg(w1 + u * UT_STRIDE + o);
      const uint2 b2 = __ldg(w2 + u * UT_STRIDE + o);
      mma_bf16(a0[u], a, b0);
      mma_bf16(a1[u], a, b1);
      mma_bf16(a2[u], a, b2);
    }
  }
}

template <typename GI, typename OUT, bool PREFETCH>
__global__ void __launch_bounds__(MMA_THREADS, 1)
gates_mma(const GI* __restrict__ gz, const GI* __restrict__ gr, const GI* __restrict__ gn,
          const uint2* __restrict__ w9, const float* __restrict__ b8, OUT* __restrict__ out, int n_rows, int n_steps,
          int tile) {
  extern __shared__ float4 smem4[];
  bf16* hb1 = reinterpret_cast<bf16*>(smem4);  // [ROWS][HP] bf16(h1)
  bf16* hb2 = hb1 + ROWS * HP;                  // [ROWS][HP] bf16(h2)
  GI* gbuf = reinterpret_cast<GI*>(hb2 + ROWS * HP);  // kernel 6: [2][3][ROWS][H]
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int ut0 = (tid >> 5) * UPW;
  const int tile0 = blockIdx.y * tile;
  const int row0 = tile0 + blockIdx.x * ROWS;
  const int rows_here = min(ROWS, min(tile0 + tile, n_rows) - row0);
  if (rows_here <= 0) return;  // the same for the whole block
  const GI* const gi[3] = {gz, gr, gn};

  for (int i = tid; i < 2 * ROWS * HP; i += MMA_THREADS) hb1[i] = __float2bfloat16_rn(0.0f);
  // Accumulator q of a tile is row g (+8 for q >= 2), column c2 + (q & 1).
  float h1[UPW][4], h2[UPW][4];
#pragma unroll
  for (int u = 0; u < UPW; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q) h1[u][q] = h2[u][q] = 0.0f;
  if (PREFETCH) {
    prefetch_gi(gbuf, gi, row0, rows_here, n_steps, 0, tid, MMA_THREADS);
    cp_async_commit();
  }
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    if (PREFETCH) {
      if (t + 1 < n_steps)
        prefetch_gi(gbuf + ((t + 1) & 1) * 3 * ROWS * H, gi, row0, rows_here, n_steps, t + 1, tid, MMA_THREADS);
      cp_async_commit();  // possibly empty: keeps one group per step
    }
    // ---- layer 1
    {
      float az[UPW][4], ar[UPW][4], an[UPW][4];
#pragma unroll
      for (int u = 0; u < UPW; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) az[u][q] = ar[u][q] = an[u][q] = 0.0f;
      mma_pass3(hb1, w9, 0, ut0, lane, az, ar, an);
      if (PREFETCH) {
        cp_async_wait_prev();  // this thread's copies of step t have landed
        __syncthreads();       // and every other thread's
      }
      const GI* sb = gbuf + (t & 1) * 3 * ROWS * H;
#pragma unroll
      for (int u = 0; u < UPW; ++u) {
        const int col = (ut0 + u) * 8 + c2;
        const float2 bn = load2(b8 + col);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = g + half * 8;
          float2 xz = make_float2(0.f, 0.f), xr = xz, xn = xz;
          if (PREFETCH) {
            xz = load2(sb + r * H + col);
            xr = load2(sb + (ROWS + r) * H + col);
            xn = load2(sb + (2 * ROWS + r) * H + col);
          } else if (r < rows_here) {
            const size_t o = ((size_t)(row0 + r) * n_steps + t) * H + col;
            xz = load2(gz + o); xr = load2(gr + o); xn = load2(gn + o);
          }
          const float vz[2] = {xz.x, xz.y}, vr[2] = {xr.x, xr.y}, vn[2] = {xn.x, xn.y}, b[2] = {bn.x, bn.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = half * 2 + e;
            const float z = sigmoid(vz[e] + az[u][q]);
            const float rg = sigmoid(vr[e] + ar[u][q]);
            const float n = tanhf(vn[e] + rg * (an[u][q] + b[e]));
            h1[u][q] = (1.0f - z) * n + z * h1[u][q];
          }
        }
      }
    }
    __syncthreads();  // every warp has read the old bf16(h1) (and this step's gi)
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int col = (ut0 + u) * 8 + c2;
      store2(hb1 + g * HP + col, h1[u][0], h1[u][1]);
      store2(hb1 + (g + 8) * HP + col, h1[u][2], h1[u][3]);
    }
    __syncthreads();  // the new bf16(h1) is visible to every warp

    // ---- layer 2: z and r sum both products in one accumulator each
    {
      float az[UPW][4], ar[UPW][4], ai[UPW][4], ah[UPW][4];
#pragma unroll
      for (int u = 0; u < UPW; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) az[u][q] = ar[u][q] = ai[u][q] = ah[u][q] = 0.0f;
      mma_pass3(hb1, w9, 3, ut0, lane, az, ar, ai);
      mma_pass3(hb2, w9, 6, ut0, lane, az, ar, ah);
#pragma unroll
      for (int u = 0; u < UPW; ++u) {
        const int col = (ut0 + u) * 8 + c2;
        const float2 bz = load2(b8 + H + col), br = load2(b8 + 2 * H + col);
        const float2 bi = load2(b8 + 3 * H + col), bh = load2(b8 + 4 * H + col);
        const float vbz[2] = {bz.x, bz.y}, vbr[2] = {br.x, br.y}, vbi[2] = {bi.x, bi.y}, vbh[2] = {bh.x, bh.y};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = q & 1;
          const float z = sigmoid(az[u][q] + vbz[e]);
          const float rg = sigmoid(ar[u][q] + vbr[e]);
          const float n = tanhf((ai[u][q] + vbi[e]) + rg * (ah[u][q] + vbh[e]));
          h2[u][q] = (1.0f - z) * n + z * h2[u][q];
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = g + half * 8;
          if (r < rows_here)
            store2(out + ((size_t)(row0 + r) * n_steps + t) * H + col, h2[u][half * 2], h2[u][half * 2 + 1]);
        }
      }
    }
    __syncthreads();  // every warp has read the old bf16(h2)
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int col = (ut0 + u) * 8 + c2;
      store2(hb2 + g * HP + col, h2[u][0], h2[u][1]);
      store2(hb2 + (g + 8) * HP + col, h2[u][2], h2[u][3]);
    }
    // The next reads of bf16(h2) follow the next step's two barriers.
  }
}

// ---------------------------------------------------------------- launch

template <typename GI, typename OUT, bool PREFETCH>
cudaError_t launch(const void* gz, const void* gr, const void* gn, const void* w9, const float* b8, void* out,
                   int n_rows, int n_steps, int tile, cudaStream_t stream) {
  const size_t smem = 2 * ROWS * HP * sizeof(bf16) + (PREFETCH ? 2 * 3 * ROWS * H * sizeof(GI) : 0);
  void (*kernel)(const GI*, const GI*, const GI*, const uint2*, const float*, OUT*, int, int, int) =
      gates_mma<GI, OUT, PREFETCH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tile + ROWS - 1) / ROWS, (n_rows + tile - 1) / tile);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const GI*>(gz), static_cast<const GI*>(gr), static_cast<const GI*>(gn),
      static_cast<const uint2*>(w9), b8,
      static_cast<OUT*>(out), n_rows, n_steps, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fvad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// kind 4 or 6 (the TPU kernel replaced). gz, gr, gn [n_rows, n_steps, H]
// bf16; w9 the bf16 fragment packing of the nine slabs [9, H, H]; b8
// [8, H] float32; out [n_rows, n_steps, H] (bf16 when out_bf16, else
// float32); tile rows per grid slice (1 <= tile <= n_rows). Kind 4 writes
// float32 with tile = n_rows. All contiguous on the current device, gi and
// out 16-byte aligned. Float32 weights or gi (w_bf16 = 0, gi_bf16 = 0) are
// refused: those forms run on csrc/gru_stack.cu. Launches on `stream` and
// returns cudaGetLastError().
int fvad_gru_gates(int kind, int w_bf16, int gi_bf16, int out_bf16, const void* gz, const void* gr,
                   const void* gn, const void* w9, const float* b8, void* out, int n_rows, int n_steps, int tile,
                   void* stream) {
  const bool ok = w_bf16 && gi_bf16 && n_rows > 0 && n_steps > 0 && tile >= 1 && tile <= n_rows &&
                  ((kind == 4 && !out_bf16 && tile == n_rows) || kind == 6);
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (kind == 6) {
    return out_bf16 ? (int)launch<bf16, bf16, true>(gz, gr, gn, w9, b8, out, n_rows, n_steps, tile, st)
                    : (int)launch<bf16, float, true>(gz, gr, gn, w9, b8, out, n_rows, n_steps, tile, st);
  }
  return (int)launch<bf16, float, false>(gz, gr, gn, w9, b8, out, n_rows, n_steps, tile, st);
}

}  // extern "C"
