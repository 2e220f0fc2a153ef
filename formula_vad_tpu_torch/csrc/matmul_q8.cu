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
// optional. So the kernel equals its plain PyTorch version bit for bit.
//
// What bounds it on the H100: device-memory bytes. At the int8 tier's
// shapes (K = 161..600, N = 161..1200) a product does 2 K N operations per
// row against K + 4 N bytes moved per row (int8 in, float32 out): 41-280
// operations per byte, below the ~590 at which 1,979 TOP/s of int8 tensor
// cores would outrun 3.35 TB/s. The float output is most of the bytes.
//
// Design: the int32 accumulator never reaches device memory (on the TPU it
// stays in VMEM): it lives in registers, and each output is written once,
// already scaled. One block computes a 128 x 128 output tile with 8 warps
// as 2 (rows) x 4 (columns); each warp owns 64 x 32, i.e. 4 x 4
// mma.sync.m16n8k32 tiles and 64 int32 accumulators per thread. K runs in
// 32-byte steps through double-buffered shared memory (row pitch 48 bytes,
// so the fragment loads hit 32 distinct banks); the next step's global loads
// are issued before this step's MMAs. A is [R, K] row-major with any K: its
// loads are VEC bytes wide (16, 8, 4 or 1: the widest that divides K and
// A's alignment) and masked past K and R. B arrives packed once by the
// wrapper as [N, K_pad], K-contiguous, zero past K (K_pad a multiple of 32),
// so its loads are always 16 bytes wide, masked past N. wgmma, TMA and a
// persistent schedule are for a later speed-up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
matmul_q8_kernel(const signed char* __restrict__ a, const signed char* __restrict__ bt,
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
cudaError_t launch(const signed char* a, const signed char* bt, const float* scale,
                   const float* row_scale, const float* bias, void* out, int rows, int n,
                   int k, int k_pad, int order, int out_bf16, cudaStream_t stream) {
  const dim3 grid((rows + BM - 1) / BM, (n + BN - 1) / BN);
  matmul_q8_kernel<VEC><<<grid, THREADS, 0, stream>>>(a, bt, scale, row_scale, bias, out, rows, n,
                                                      k, k_pad, order, out_bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fvad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// a [rows, k] int8 row-major; bt [n, k_pad] int8, zero past k (k_pad a
// multiple of 32, k_pad >= k); scale [n] f32; row_scale [rows] f32 or null;
// bias [n] f32 or null; out [rows, n] float32 (out_bf16 = 0) or bfloat16.
// order 0: (acc * scale) * row_scale, order 1: (acc * row_scale) * scale.
// All contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError().
int fvad_matmul_q8(const signed char* a, const signed char* bt, const float* scale,
                   const float* row_scale, const float* bias, void* out, int rows, int n,
                   int k, int k_pad, int order, int out_bf16, void* stream) {
  if (rows <= 0 || n <= 0 || k <= 0 || k_pad < k || k_pad % BK || (order != 0 && order != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t p = reinterpret_cast<uintptr_t>(a);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (k % 16 == 0 && p % 16 == 0) {
    err = launch<16>(a, bt, scale, row_scale, bias, out, rows, n, k, k_pad, order, out_bf16, s);
  } else if (k % 8 == 0 && p % 8 == 0) {
    err = launch<8>(a, bt, scale, row_scale, bias, out, rows, n, k, k_pad, order, out_bf16, s);
  } else if (k % 4 == 0 && p % 4 == 0) {
    err = launch<4>(a, bt, scale, row_scale, bias, out, rows, n, k, k_pad, order, out_bf16, s);
  } else {
    err = launch<1>(a, bt, scale, row_scale, bias, out, rows, n, k, k_pad, order, out_bf16, s);
  }
  return (int)err;
}

}  // extern "C"
