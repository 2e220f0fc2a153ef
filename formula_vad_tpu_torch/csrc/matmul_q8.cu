// Int8 matmul with the dequant fused into the epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel formula_vad_tpu/ops/matmul_q8.py::matmul_q8
// (bodies _kernel and _kernel_rs):
//   acc[i, j] = sum_k a[i, k] * b[k, j]           int8 x int8, exact in int32
//   out[i, j] = epilogue(acc[i, j])               float32, stored f32 or bf16
// The epilogue rounds every float operation on its own (__fmul_rn,
// __fadd_rn: no FMA contraction), in the order the caller names:
//   order 0 (col_row): (acc * scale[j]) * row_scale[i]   the TPU kernel's acc * s * r
//   order 1 (row_col): (acc * row_scale[i]) * scale[j]   nsnet2_q8's _dot8(..) * sx * s
// then + bias[j] when a bias is given. The row scale and the bias are
// optional. The int32 sums are exact in any tile shape and K order, so the
// kernel equals its plain PyTorch version bit for bit.
//
// What bounds it on the H100: device-memory bytes. At the int8 tier's
// shapes (K = 161..600, N = 161..1200) a product does 2 K N operations per
// row against K + 4 N bytes moved per row (int8 in, float32 out): 41-280
// operations per byte, below the ~590 at which 1,979 TOP/s of int8 tensor
// cores would outrun 3.35 TB/s. The float output is most of the bytes
// (8.06 of 9.23 MB for the 1,680-row product inside the GRU scan, 435.5 of
// 472.6 MB for gi1), so the design is about streaming the output and
// keeping loads off its critical path.
//
// Two bodies, chosen by the host before the launch from the shape and A's
// alignment alone (ops/matmul_q8.py::select_path):
//
// "wgmma" (K_pad <= 608: every product of the int8 tier). A persistent
// kernel: one CTA of 384 threads per SM walks a contiguous range of
// 128 x BN output tiles, numbered row block first. BN (128 or 144) and the
// grid come from the host's tile plan: at the 1,680 x 1,200 product that
// runs 162 times a forward inside the GRU scan, 128 x 144 tiles make 126
// CTAs, one wave on 132 SMs, where 128 x 128 would leave 8 of 140 tiles to
// a second. Warpgroup 0 loads; warpgroups 1 and 2 each compute 64 rows of
// the tile with wgmma.mma_async.m64nBNk32.s32.s8.s8, both operands
// K-major in shared memory.
//
// The whole K of both operands sits in shared memory, in 128-byte K blocks
// with one mbarrier each: thread 0 issues every block of a tile at once, so
// the first wgmmas start while later blocks land. B ([N, K_pad], rows
// 16-byte aligned) always goes by TMA, 128-byte swizzled, through a tensor
// map built once per weight and tile width; TMA's 128-byte rows need 8x
// fewer requests than 16-byte pieces, which measured slower. A ([R, K],
// any K, any base) goes by TMA where K and its base are multiples of 16
// bytes (K = 400), its map encoded in C (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint: the library links no libcuda) and cached by
// address, rows and K; else the 128 loader threads move it, by cp.async
// of 8 bytes where K and the base allow (K = 600), or as the aligned
// 16-byte words around each 16-byte piece, funnel-shifted in registers
// (K = 161, any base), into an unswizzled K-slice-major layout. So the
// wrapper takes any contiguous a8 and no quantizer has to write a pitched
// copy. Every path leaves A zero past K, so whatever the weight holds in
// its padding adds nothing. A block's barrier wants
// five arrivals (thread 0's, which carries the TMA bytes, and one per
// loader warp after its copies are tracked or its stores fenced).
//
// A stays resident while a CTA walks the column blocks of one row block; B
// (at most 0.73 MB in all, so L2 holds it) is loaded per tile. When a
// tile's wgmmas are done the computing warps free the operand buffers (one
// mbarrier), so the next tile's loads overlap this tile's epilogue. The
// epilogue reads the tile's scale and bias once from shared memory (copied
// in per tile by cp.async, double-buffered) and each row scale once,
// stages the scaled tile in shared memory (pitches that keep the fragment
// stores on distinct banks), and writes it with 16-byte stores along each
// row where a row is a whole number of 16 bytes (N = 400, 600, 1200 in f32
// and bf16), else one element a lane (N = 161).
//
// "mma_sync" (K_pad > 608): the first port's body, kept
// as it was: one CTA per 128 x 128 tile, mma.sync.m16n8k32, K in 32-byte
// steps through double-buffered shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

namespace simt {


constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;       // bytes of K per step: one m16n8k32 MMA deep
constexpr int PITCH = 48;    // shared-memory row pitch in bytes
constexpr int THREADS = 256;

template <int VEC> struct Vec;
template <> struct Vec<16> { using T = int4; };
template <> struct Vec<8> { using T = int2; };
template <> struct Vec<4> { using T = int; };
template <> struct Vec<1> { using T = signed char; };

__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
mma_sync_kernel(const signed char* __restrict__ a, const signed char* __restrict__ bt,
                 const float* __restrict__ scale, const float* __restrict__ row_scale,
                 const float* __restrict__ bias, void* __restrict__ out, int rows, int n,
                 int k, int k_pad, int order, int out_bf16) {
  using T = typename Vec<VEC>::T;
  constexpr int A_VECS = BM * BK / VEC / THREADS;  // A vectors each thread loads per step
  constexpr int A_ROW_VECS = BK / VEC;
  __shared__ __align__(16) signed char as[2][BM * PITCH];
  __shared__ __align__(16) signed char bs[2][BN * PITCH];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = (lane & 3) * 4;  // MMA group and its byte offset
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  T areg[A_VECS];
  int4 breg;
  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int idx = tid + v * THREADS;
      const int r = m0 + idx / A_ROW_VECS, c = k0 + (idx % A_ROW_VECS) * VEC;
      areg[v] = (r < rows && c < k) ? *reinterpret_cast<const T*>(a + (size_t)r * k + c) : T{};
    }
    const int col = n0 + (tid >> 1);
    breg = col < n ? *reinterpret_cast<const int4*>(bt + (size_t)col * k_pad + k0 + (tid & 1) * 16)
                   : make_int4(0, 0, 0, 0);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int idx = tid + v * THREADS;
      *reinterpret_cast<T*>(&as[buf][(idx / A_ROW_VECS) * PITCH + (idx % A_ROW_VECS) * VEC]) = areg[v];
    }
    *reinterpret_cast<int4*>(&bs[buf][(tid >> 1) * PITCH + (tid & 1) * 16]) = breg;
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

  const int steps = k_pad / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load((s + 1) * BK);  // in flight during the MMAs below
    int bf[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const signed char* p = &bs[buf][(wn + ni * 8 + g) * PITCH + t4];
      bf[ni][0] = *reinterpret_cast<const int*>(p);
      bf[ni][1] = *reinterpret_cast<const int*>(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const signed char* p = &as[buf][(wm + mi * 16 + g) * PITCH + t4];
      const int af[4] = {
          *reinterpret_cast<const int*>(p), *reinterpret_cast<const int*>(p + 8 * PITCH),
          *reinterpret_cast<const int*>(p + 16), *reinterpret_cast<const int*>(p + 8 * PITCH + 16)};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af, bf[ni]);
    }
    // The other buffer was last read in step s - 1, before the barrier
    // that ended it, so it can be refilled now; one barrier per step.
    if (s + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: accumulator q of tile (mi, ni) is row g (+8 for q >= 2),
  // column 2 * (lane & 3) + (q & 1) of that 16 x 8 tile.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + mi * 16 + g + half * 8;
      if (r >= rows) continue;
      const float rs = row_scale ? row_scale[r] : 1.0f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = n0 + wn + ni * 8 + (lane & 3) * 2 + q;
          if (c >= n) continue;
          float v = __int2float_rn(acc[mi][ni][half * 2 + q]);
          if (order == 0) {
            v = __fmul_rn(v, scale[c]);
            if (row_scale) v = __fmul_rn(v, rs);
          } else {
            if (row_scale) v = __fmul_rn(v, rs);
            v = __fmul_rn(v, scale[c]);
          }
          if (bias) v = __fadd_rn(v, bias[c]);
          const size_t o = (size_t)r * n + c;
          if (out_bf16) {
            reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
          } else {
            reinterpret_cast<float*>(out)[o] = v;
          }
        }
      }
    }
  }
}

template <int VEC>
cudaError_t launch_mma_sync(const signed char* a, const signed char* bt, const float* scale,
                   const float* row_scale, const float* bias, void* out, int rows, int n,
                   int k, int k_pad, int order, int out_bf16, cudaStream_t stream) {
  const dim3 grid((rows + BM - 1) / BM, (n + BN - 1) / BN);
  mma_sync_kernel<VEC><<<grid, THREADS, 0, stream>>>(a, bt, scale, row_scale, bias, out, rows, n,
                                                      k, k_pad, order, out_bf16);
  return cudaGetLastError();
}

}  // namespace simt

namespace wg {

constexpr int BM = 128;        // tile rows: two computing warpgroups of 64
constexpr int THREADS = 384;   // warpgroup 0 loads, 1 and 2 compute
constexpr int K_PAD_MAX = 608;
constexpr int MAX_BLOCKS = (K_PAD_MAX + 127) / 128;  // 128-byte K blocks: one barrier, four wgmmas
constexpr int SMEM_LIMIT = 232448;                   // dynamic shared memory a CTA may use

// Staging pitches of the epilogue tile (bytes): float32 rows shift 8 banks,
// bf16 rows 4 (mod 32), so the fragment stores hit distinct banks.
__host__ __device__ constexpr int pitch_f32(int bn) { return 4 * bn + 32; }
__host__ __device__ constexpr int pitch_bf16(int bn) { return 2 * bn + 16; }

// Each computing warpgroup stages 64 rows; its last row needs no pad.
__host__ __device__ constexpr int stage_stride(int bn) { return 64 * pitch_f32(bn) - 32; }

__host__ __device__ constexpr int k_blocks(int k_pad) { return (k_pad + 127) / 128; }

// A: [k_blocks][BM][128 bytes] swizzled where TMA loads it, else [k_pad / 16][BM][16 bytes].
__host__ __device__ constexpr int a_bytes(int k_pad, bool a_tma) {
  return BM * (a_tma ? 128 * k_blocks(k_pad) : k_pad);
}

// A, B [k_blocks][bn][128 bytes], the two warpgroups' staging tiles, scale
// and bias [2][2][bn] float, the block barriers and the operands' "free"
// barrier, after up to 1 KB that rounds the base up to the 128-byte
// swizzle's 1 KB.
__host__ __device__ constexpr int smem_bytes(int bn, int k_pad, bool a_tma) {
  return 1024 + a_bytes(k_pad, a_tma) + bn * 128 * k_blocks(k_pad) + 2 * stage_stride(bn) + 16 * bn +
         8 * (MAX_BLOCKS + 1);
}

struct Params {
  const signed char* a;
  const signed char* bt;
  const float* scale;
  const float* row_scale;
  const float* bias;
  void* out;
  int rows, n, k, k_pad, order, out_bf16, out_vec, col_blocks, tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// An arrival that also expects `bytes` more from TMA copies.
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Holds the barrier's phase open until every cp.async this thread issued
// before it has landed (the pending count is raised now, lowered then).
__device__ __forceinline__ void mbar_track_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
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

// Zero-fills the destination where `valid` is false (no bytes are read).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// A [rows, 128-byte] box of a 2-D int8 tensor map at (byte x, row y),
// 128-byte swizzled; TMA fills what lies outside the tensor with zeros and
// reports the box's bytes to `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// Makes this thread's generic-proxy view of shared memory visible to the
// async proxy that wgmma reads its operands through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// wgmma operand descriptors, both K-major.
// TMA-loaded operands sit in 128-byte K blocks, [rows][128 bytes] each,
// 128-byte swizzled: 8-row groups 1,024 bytes apart (SBO); a 32-byte K
// step inside a block moves the start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// A loaded by threads sits K-slice-major, unswizzled: the 16-byte K slice j
// of row r at j * rows * 16 + r * 16. As 8-row x 16-byte core matrices, the
// two of a 32-byte K chunk are rows * 16 bytes apart (LBO) and 8-row groups
// 128 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_slices(uint32_t addr, uint32_t rows) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((rows * 16) >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n144(int (&d)[72], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "l"(da), "l"(db), "r"(accumulate));
}


template <int BN> struct Mma;
template <> struct Mma<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t da, uint64_t db, int acc) { wgmma_n128(d, da, db, acc); }
};
template <> struct Mma<144> {
  static __device__ __forceinline__ void run(int (&d)[72], uint64_t da, uint64_t db, int acc) { wgmma_n144(d, da, db, acc); }
};

// The 16 bytes at byte offset s (0..15) of the 32 bytes lo:hi.
__device__ __forceinline__ int4 bytes_at(int4 lo, int4 hi, int s) {
  const uint32_t w[8] = {(uint32_t)lo.x, (uint32_t)lo.y, (uint32_t)lo.z, (uint32_t)lo.w,
                         (uint32_t)hi.x, (uint32_t)hi.y, (uint32_t)hi.z, (uint32_t)hi.w};
  const int q = s >> 2;
  const uint32_t sh = (s & 3) * 8;
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) v[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  return make_int4((int)__funnelshift_r(v[0], v[1], sh), (int)__funnelshift_r(v[1], v[2], sh),
                   (int)__funnelshift_r(v[2], v[3], sh), (int)__funnelshift_r(v[3], v[4], sh));
}

// The first n (0..16) bytes of v, the rest zero: a piece that runs past K
// would otherwise carry the next row's bytes into the product.
__device__ __forceinline__ int4 first_bytes(int4 v, int n) {
  const auto word = [n](int x, int i) {
    const int m = n - 4 * i;
    return m >= 4 ? x : m <= 0 ? 0 : (int)((uint32_t)x & ((1u << (8 * m)) - 1));
  };
  return make_int4(word(v.x, 0), word(v.y, 1), word(v.z, 2), word(v.w, 3));
}

// Warpgroup 0: the operands of each tile of this CTA, and the tile's scale
// and bias. Thread 0 issues the TMA copies (B always, A where its rows are
// 16-byte aligned) and arrives on each block barrier with their bytes; all
// 128 threads copy the scale and bias and, where TMA cannot, A (cp.async of
// 8 bytes, or aligned 16-byte words funnel-shifted through registers), and
// each warp then arrives once: five arrivals a block.
template <int BN, int A_VEC>
__device__ __forceinline__ void produce(const Params& p, const CUtensorMap* a_map, const CUtensorMap* b_map,
                                       int first, int last, unsigned char* a_s, uint32_t b_u32, uint32_t sb_u32,
                                       uint32_t full0, uint32_t empty) {
  constexpr bool TMA_A = A_VEC == 16;
  const int t = threadIdx.x, lane = t & 31;
  const int chunks = p.k_pad / 32, blocks = k_blocks(p.k_pad);
  const uint32_t a_u32 = smem_u32(a_s);
  // The last aligned 16-byte word that holds a byte of A: the register path
  // reads whole words and never one past it.
  const uintptr_t a_last = (reinterpret_cast<uintptr_t>(p.a) + (size_t)p.rows * p.k - 1) & ~(uintptr_t)15;
  int prev_mb = -1, prev_nb = -1;
  for (int tile = first, it = 0; tile < last; ++tile, ++it) {
    const int mb = tile / p.col_blocks, nb = tile % p.col_blocks;
    const int m0 = mb * BM, n0 = nb * BN;
    if (it > 0) mbar_wait(empty, (it - 1) & 1);  // the consumers' wgmmas of the last tile are done
    const bool load_a = mb != prev_mb, load_b = nb != prev_nb;
    prev_mb = mb;
    prev_nb = nb;
    if (t == 0) {
      const uint32_t bytes = (load_b ? BN * 128 : 0) + (TMA_A && load_a ? BM * 128 : 0);
      for (int b = 0; b < blocks; ++b) {
        const uint32_t bar = full0 + 8 * b;
        mbar_arrive_expect(bar, bytes);
        if (load_b) tma_load(b_u32 + b * BN * 128, b_map, 128 * b, n0, bar);
        if (TMA_A && load_a) tma_load(a_u32 + b * BM * 128, a_map, 128 * b, m0, bar);
      }
    }
    // The tile's scale and bias, zero past N (and for a missing bias),
    // double-buffered by tile; block 0's phase waits for them.
    const uint32_t sbt = sb_u32 + (it & 1) * 8 * BN;
    for (int i = t; i < BN; i += 128) {
      const int c = n0 + i;
      cp_async4(sbt + 4 * i, p.scale + (c < p.n ? c : 0), c < p.n);
      cp_async4(sbt + 4 * (BN + i), (c < p.n && p.bias) ? p.bias + c : p.scale, c < p.n && p.bias);
    }
    mbar_track_copies(full0);
    if (A_VEC == 1 && load_a) {
      // A block a round: all of its loads in flight, then the stores, then
      // one arrival per warp.
      constexpr int PER = 4 * 2 * BM / 128;  // 16-byte pieces a thread moves per block
      for (int b = 0; b < blocks; ++b) {
        int4 lo[PER], hi[PER];
        int sh[PER], nv[PER];  // A's byte offset in its aligned word; the piece's bytes before K
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int q = t + u * 128;
          const int c = 4 * b + q / (2 * BM), rem = q % (2 * BM);
          const int row = m0 + rem % BM, kk = 16 * (2 * c + rem / BM);
          lo[u] = hi[u] = make_int4(0, 0, 0, 0);
          sh[u] = nv[u] = 0;
          if (c < chunks && row < p.rows && kk < p.k) {
            const uintptr_t at = reinterpret_cast<uintptr_t>(p.a + (size_t)row * p.k + kk);
            const uintptr_t w0 = at & ~(uintptr_t)15;
            sh[u] = (int)(at & 15);
            nv[u] = min(16, p.k - kk);
            lo[u] = __ldg(reinterpret_cast<const int4*>(w0));
            if (sh[u] && w0 + 16 <= a_last) hi[u] = __ldg(reinterpret_cast<const int4*>(w0 + 16));
          }
        }
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int q = t + u * 128;
          const int c = 4 * b + q / (2 * BM), rem = q % (2 * BM);
          if (c < chunks) {
            *reinterpret_cast<int4*>(a_s + (2 * c + rem / BM) * BM * 16 + (rem % BM) * 16) =
                first_bytes(bytes_at(lo[u], hi[u], sh[u]), nv[u]);
          }
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full0 + 8 * b);
      }
    } else {
      if (A_VEC == 8 && load_a) {
        for (int b = 0; b < blocks; ++b) {
          for (int c = 4 * b; c < chunks && c < 4 * b + 4; ++c) {
            for (int idx = t; idx < 4 * BM; idx += 128) {  // two slices of BM rows, two halves each
              const int jj = idx / (2 * BM), rem = idx % (2 * BM);
              const int row = m0 + (rem >> 1), kk = (2 * c + jj) * 16 + 8 * (rem & 1);
              const bool ok = row < p.rows && kk < p.k;
              cp_async8(a_u32 + (2 * c + jj) * BM * 16 + rem * 8, p.a + (ok ? (size_t)row * p.k + kk : 0), ok);
            }
          }
          mbar_track_copies(full0 + 8 * b);
        }
      }
      __syncwarp();
      if (lane == 0) {
        for (int b = 0; b < blocks; ++b) mbar_arrive(full0 + 8 * b);
      }
    }
  }
  cp_async_wait_all();
}

__device__ __forceinline__ float epilogue(int acc, float s, float rs, float b, int order, bool has_rs, bool has_bias) {
  float v = __int2float_rn(acc);
  if (order == 0) {
    v = __fmul_rn(v, s);
    if (has_rs) v = __fmul_rn(v, rs);
  } else {
    if (has_rs) v = __fmul_rn(v, rs);
    v = __fmul_rn(v, s);
  }
  return has_bias ? __fadd_rn(v, b) : v;
}

// The staged [64, BN] tile of one warpgroup to the output: 16-byte stores
// along each row where the rows are 16-byte aligned, else one element a lane.
template <int BN, typename T>
__device__ __forceinline__ void store_tile(const Params& p, const unsigned char* st, int pitch, int r0, int n0) {
  const int t = threadIdx.x & 127, lane = threadIdx.x & 31, warp = t >> 5;
  T* out = reinterpret_cast<T*>(p.out);
  if (p.out_vec) {
    constexpr int PER = 16 / sizeof(T), PIECES = BN / PER;
    for (int idx = t; idx < 64 * PIECES; idx += 128) {
      const int rl = idx / PIECES, pc = idx % PIECES;
      const int r = r0 + rl, col = n0 + pc * PER;
      if (r < p.rows && col < p.n) {
        *reinterpret_cast<int4*>(out + (size_t)r * p.n + col) = *reinterpret_cast<const int4*>(st + rl * pitch + pc * 16);
      }
    }
  } else {
    for (int rl = warp; rl < 64 && r0 + rl < p.rows; rl += 4) {
      const T* src = reinterpret_cast<const T*>(st + rl * pitch);
      for (int c = lane; c < BN && n0 + c < p.n; c += 32) out[(size_t)(r0 + rl) * p.n + n0 + c] = src[c];
    }
  }
}

// Warpgroups 1 and 2: rows 64 (wg - 1) .. + 63 of each tile.
template <int BN, bool TMA_A>
__device__ __forceinline__ void consume(const Params& p, int first, int last, uint32_t a_u32, uint32_t b_u32,
                                       unsigned char* stage, const float* sb, uint32_t full0, uint32_t empty) {
  const int w = threadIdx.x / 128 - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int chunks = p.k_pad / 32, blocks = k_blocks(p.k_pad);
  const bool has_rs = p.row_scale != nullptr, has_bias = p.bias != nullptr;
  unsigned char* st = stage + w * stage_stride(BN);
  const int pitch = p.out_bf16 ? pitch_bf16(BN) : pitch_f32(BN);
  const uint32_t a_w = a_u32 + w * 64 * (TMA_A ? 128 : 16);  // this warpgroup's 64 rows of A
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int tile = first, it = 0; tile < last; ++tile, ++it) {
    const int m0 = (tile / p.col_blocks) * BM, n0 = (tile % p.col_blocks) * BN;
    // Row scales first: their loads fly while the operands land.
    const int rl = warp * 16 + g;
    const int r0 = m0 + w * 64 + rl;
    const float rs0 = (has_rs && r0 < p.rows) ? p.row_scale[r0] : 1.0f;
    const float rs1 = (has_rs && r0 + 8 < p.rows) ? p.row_scale[r0 + 8] : 1.0f;
    wgmma_fence();
    for (int b = 0; b < blocks; ++b) {
      mbar_wait(full0 + 8 * b, it & 1);
      fence_proxy_async();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const int c = 4 * b + kc;
        if (c < chunks) {
          const uint64_t da = TMA_A ? desc_sw128(a_w + b * BM * 128 + kc * 32) : desc_slices(a_w + 2 * c * BM * 16, BM);
          Mma<BN>::run(acc, da, desc_sw128(b_u32 + b * BN * 128 + kc * 32), c > 0);
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);  // the operands may be overwritten now

    // Accumulator 4 j + e: row g (+8 for e >= 2), column 8 j + 2 q + (e & 1).
    const float* sbt = sb + (it & 1) * 2 * BN;
    named_sync(1 + w, 128);  // this warpgroup's stores of the last tile have read the staging tile
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * q;
      const float2 s = *reinterpret_cast<const float2*>(sbt + col);
      const float2 b = *reinterpret_cast<const float2*>(sbt + BN + col);
      const float v00 = epilogue(acc[4 * j], s.x, rs0, b.x, p.order, has_rs, has_bias);
      const float v01 = epilogue(acc[4 * j + 1], s.y, rs0, b.y, p.order, has_rs, has_bias);
      const float v10 = epilogue(acc[4 * j + 2], s.x, rs1, b.x, p.order, has_rs, has_bias);
      const float v11 = epilogue(acc[4 * j + 3], s.y, rs1, b.y, p.order, has_rs, has_bias);
      if (p.out_bf16) {
        *reinterpret_cast<__nv_bfloat162*>(st + rl * pitch + col * 2) = __floats2bfloat162_rn(v00, v01);
        *reinterpret_cast<__nv_bfloat162*>(st + (rl + 8) * pitch + col * 2) = __floats2bfloat162_rn(v10, v11);
      } else {
        *reinterpret_cast<float2*>(st + rl * pitch + col * 4) = make_float2(v00, v01);
        *reinterpret_cast<float2*>(st + (rl + 8) * pitch + col * 4) = make_float2(v10, v11);
      }
    }
    named_sync(1 + w, 128);
    if (p.out_bf16) {
      store_tile<BN, __nv_bfloat16>(p, st, pitch, m0 + w * 64, n0);
    } else {
      store_tile<BN, float>(p, st, pitch, m0 + w * 64, n0);
    }
  }
}

template <int BN, int A_VEC>
__global__ void __launch_bounds__(THREADS, 1)
    wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* const a_s = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  unsigned char* const b_s = a_s + a_bytes(p.k_pad, A_VEC == 16);
  unsigned char* const stage = b_s + BN * 128 * k_blocks(p.k_pad);
  float* const sb = reinterpret_cast<float*>(stage + 2 * stage_stride(BN));
  uint64_t* const bars = reinterpret_cast<uint64_t*>(sb + 4 * BN);
  const uint32_t full0 = smem_u32(bars), empty = smem_u32(bars + MAX_BLOCKS);
  if (threadIdx.x == 0) {
    // Fetch the tensor maps while the barriers are set up.
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&b_map)) : "memory");
    if (A_VEC == 16) asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&a_map)) : "memory");
    // Each block: thread 0's arrival with the TMA bytes, one per loader warp.
    for (int b = 0; b < k_blocks(p.k_pad); ++b) mbar_init(full0 + 8 * b, 5);
    mbar_init(empty, 8);  // one per computing warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int first = (int)((long long)blockIdx.x * p.tiles / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * p.tiles / gridDim.x);
  if (threadIdx.x < 128) {
    produce<BN, A_VEC>(p, &a_map, &b_map, first, last, a_s, smem_u32(b_s), smem_u32(sb), full0, empty);
  } else {
    consume<BN, A_VEC == 16>(p, first, last, smem_u32(a_s), smem_u32(b_s), stage, sb, full0, empty);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API call, through the runtime's entry
// point lookup (the library links no libcuda); looked up once.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return (EncodeTiled) nullptr;
    }
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The map of an int8 [rows, cols] tensor with rows `pitch` bytes apart,
// read in [box_rows, 128-byte] boxes, 128-byte swizzled.
cudaError_t encode(CUtensorMap* map, const void* base, int rows, int cols, int pitch, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A's map, from a small cache: a map is a function of the address, the
// rows and K alone, so an entry stays right however the memory behind it is
// reused, and the loop of a GRU scan, whose activations come back at the
// same few addresses, encodes none after its first steps.
cudaError_t a_map(CUtensorMap* map, const void* a, int rows, int k) {
  struct Entry {
    const void* a;
    int rows, k;
    CUtensorMap map;
  };
  static std::mutex lock;
  static Entry cache[16];
  static int next = 0;
  std::lock_guard<std::mutex> guard(lock);
  for (const Entry& e : cache) {
    if (e.a == a && e.rows == rows && e.k == k) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cudaError_t err = encode(map, a, rows, k, k, BM);
  if (err == cudaSuccess) {
    cache[next] = Entry{a, rows, k, *map};
    next = (next + 1) % 16;
  }
  return err;
}

template <int BN, int A_VEC>
cudaError_t launch(const Params& p, const CUtensorMap& a_map, const CUtensorMap& b_map, int grid, cudaStream_t stream) {
  // The shared-memory limit is raised once per device.
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(wgmma_kernel<BN, A_VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  wgmma_kernel<BN, A_VEC><<<grid, THREADS, smem_bytes(BN, p.k_pad, A_VEC == 16), stream>>>(p, a_map, b_map);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bn(const Params& p, const CUtensorMap& a_map, const CUtensorMap& b_map, int grid, int a_vec,
                      cudaStream_t stream) {
  switch (a_vec) {
    case 16: return launch<BN, 16>(p, a_map, b_map, grid, stream);
    case 8: return launch<BN, 8>(p, a_map, b_map, grid, stream);
    default: return launch<BN, 1>(p, a_map, b_map, grid, stream);
  }
}

}  // namespace wg

}  // namespace

extern "C" {

const char* fvad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }


// Bytes of dynamic shared memory the wgmma body takes (ops/matmul_q8.py's
// smem_bytes plans with the same sum).
int fvad_matmul_q8_smem_bytes(int bn, int k_pad, int a_tma) { return wg::smem_bytes(bn, k_pad, a_tma != 0); }

// The TMA map of a packed weight bt [n, k_pad] for tiles of bn columns,
// written to map (128 bytes), which the caller keeps with the weight.
int fvad_matmul_q8_weight_map(const signed char* bt, int n, int k_pad, int bn, void* map) {
  if (n <= 0 || k_pad <= 0 || k_pad % 32 || (bn != 128 && bn != 144) || reinterpret_cast<uintptr_t>(bt) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)wg::encode(static_cast<CUtensorMap*>(map), bt, n, k_pad, k_pad, bn);
}

// a [rows, k] int8 row-major; bt [n, k_pad] int8 (k_pad a multiple of 32,
// k_pad >= k; what lies past k is never used: A is zero there); scale [n] f32; row_scale [rows] f32 or null;
// bias [n] f32 or null; out [rows, n] float32 (out_bf16 = 0) or bfloat16.
// order 0: (acc * scale) * row_scale, order 1: (acc * row_scale) * scale.
// All contiguous on the current device.
//
// The host's plan: path 0 runs the mma_sync body, path 1 the wgmma body
// with 128 x bn tiles on `grid` CTAs and bt_map, bt's map from
// fvad_matmul_q8_weight_map for this bn; a_vec is the width of A's loads
// (16, 8, 4 or 1 bytes: it must divide k and a's address; the wgmma body
// takes 16, which goes by TMA, 8 or 1), out_vec = 1 asks for 16-byte
// output stores (n * element size and out's address multiples of 16). A
// plan the body cannot run is refused before any launch. Launches on
// `stream` and returns cudaGetLastError().
int fvad_matmul_q8(const signed char* a, const signed char* bt, const float* scale,
                   const float* row_scale, const float* bias, void* out, int rows, int n,
                   int k, int k_pad, int order, int out_bf16, int path, int bn, int grid,
                   int a_vec, int out_vec, const void* bt_map, void* stream) {
  if (rows <= 0 || n <= 0 || k <= 0 || k_pad < k || k_pad % 32 || (order != 0 && order != 1) ||
      (a_vec != 16 && a_vec != 8 && a_vec != 4 && a_vec != 1) || k % a_vec ||
      reinterpret_cast<uintptr_t>(a) % a_vec) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (path == 0) {
    switch (a_vec) {
      case 16: return (int)simt::launch_mma_sync<16>(a, bt, scale, row_scale, bias, out, rows, n, k, k_pad, order, out_bf16, s);
      case 8: return (int)simt::launch_mma_sync<8>(a, bt, scale, row_scale, bias, out, rows, n, k, k_pad, order, out_bf16, s);
      case 4: return (int)simt::launch_mma_sync<4>(a, bt, scale, row_scale, bias, out, rows, n, k, k_pad, order, out_bf16, s);
      default: return (int)simt::launch_mma_sync<1>(a, bt, scale, row_scale, bias, out, rows, n, k, k_pad, order, out_bf16, s);
    }
  }
  const int esize = out_bf16 ? 2 : 4;
  const long long col_blocks = bn > 0 ? (n + bn - 1) / bn : 0;
  const long long tiles = (long long)((rows + wg::BM - 1) / wg::BM) * col_blocks;
  if (path != 1 || (bn != 128 && bn != 144) || k_pad > wg::K_PAD_MAX || wg::smem_bytes(bn, k_pad, a_vec == 16) > wg::SMEM_LIMIT ||
      a_vec == 4 || grid < 1 || grid > tiles || tiles > 0x7fffffff || bt_map == nullptr ||
      (out_vec && ((n * esize) % 16 || reinterpret_cast<uintptr_t>(out) % 16))) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap a_map{}, b_map;
  memcpy(&b_map, bt_map, sizeof(CUtensorMap));
  if (a_vec == 16) {
    const cudaError_t err = wg::a_map(&a_map, a, rows, k);
    if (err != cudaSuccess) return (int)err;
  }
  const wg::Params p{a, bt, scale, row_scale, bias, out, rows, n, k, k_pad, order, out_bf16, out_vec,
                     (int)col_blocks, (int)tiles};
  return (int)(bn == 128 ? wg::launch_bn<128>(p, a_map, b_map, grid, a_vec, s)
                         : wg::launch_bn<144>(p, a_map, b_map, grid, a_vec, s));
}

}  // extern "C"
