// Dense float32 GEMM on the CUDA cores, for sm_90a: a scouting kernel.
//
//     C[m, n] = sum_k A[m, k] * B[k, n]
//
// With SEG, K is cut into segments of `hop` rows; each segment sums into a
// fresh register partial that is added to the running total at the
// segment's end (the total of the finished segments lives in shared
// memory: registers hold only one partial).
//
// Replaces the reference package's TPU scouting kernels
// tools/exp_pallas_gemm.py::pallas_gemm and
// tools/exp_framed_kernel.py::make_gemm (plain, and seg_k=True): a dense
// f32-HIGHEST GEMM at M tiles of 512 and 176 rows, which measured the f32
// GEMM ceiling of the chip at the conv stage's Toeplitz shape (M = 175104,
// K = 704, N = 512).  No package code calls it; the tools
// tools/torch_exp_pallas_gemm.py and tools/torch_exp_framed_kernel.py time
// it beside torch.matmul and the chain's framed formulation.
//
// What bounds it: operations (the conv shape is 1.26e11 flop against
// 0.86 GB, ~150 flop per byte).  No TF32: the chain's class needs full
// float32 products.
//
// Design: a block computes an MT x 64 tile of C (MT = 512 or 176, the
// reference's M tiles), 256 threads of MT/16 x 4 outputs each; A's
// 16-column slab is staged transposed and B's 16-row slab as is, both with
// element-wise cp.async in two stages, so C needs no alignment.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TN = 4;
constexpr int NT = 256;  // 16 x 16 threads

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int MT, bool SEG>
struct Smem {
  static constexpr int APAD = MT + 4;
  static constexpr int A = BK * APAD;  // one stage of A, transposed
  static constexpr int B = BK * BN;    // one stage of B
  static constexpr size_t bytes =
      sizeof(float) * (2 * (A + B) + (SEG ? size_t(MT) * BN : 0));
};

template <int MT, bool SEG>
__global__ void __launch_bounds__(NT)
dense_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ Cm, int M, int K, int N, int hop,
                  int n_col) {
  constexpr int TM = MT / 16;
  static_assert(MT % 16 == 0, "16 thread rows");
  using S = Smem<MT, SEG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [2][BK][APAD]
  float* Bs = As + 2 * S::A;                       // [2][BK][BN]
  float* tot = Bs + 2 * S::B;                      // [MT][BN], SEG only

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long m0 = static_cast<long long>(blockIdx.x / n_col) * MT;
  const int n0 = (blockIdx.x % n_col) * BN;

  auto load = [&](int st, int k0) {
    float* as = As + st * S::A;
    for (int e = tid; e < MT * BK; e += NT) {
      const int kk = e % BK, i = e / BK;
      const long long m = m0 + i;
      const int k = k0 + kk;
      const bool ok = m < M && k < K;
      cp_async4(as + kk * S::APAD + i, ok ? A + m * K + k : A, ok);
    }
    float* bs = Bs + st * S::B;
    for (int e = tid; e < BK * BN; e += NT) {
      const int jj = e % BN, kk = e / BN;
      const int k = k0 + kk, n = n0 + jj;
      const bool ok = k < K && n < N;
      cp_async4(bs + kk * BN + jj,
                ok ? B + static_cast<long long>(k) * N + n : B, ok);
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  if constexpr (SEG) {
    for (int e = tid; e < MT * BN; e += NT) tot[e] = 0.f;
  }
  // add the finished segment's partial to its total (each thread its own
  // elements, so no barrier)
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float& t = tot[(ty * TM + i) * BN + tx * TN + j];
        t = t + acc[i][j];
        acc[i][j] = 0.f;
      }
  };

  const int n_slabs = (K + BK - 1) / BK;
  load(0, 0);
  for (int s = 0; s < n_slabs; ++s) {
    const int st = s & 1;
    if (s + 1 < n_slabs) {
      load(st ^ 1, (s + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = As + st * S::A;
    const float* bs = Bs + st * S::B;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk * S::APAD + ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = bs[kk * BN + tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if constexpr (SEG) {
      const int k1 = (s + 1) * BK;
      if (k1 % hop == 0 && k1 < K) flush();
    }
    __syncthreads();
  }
  if constexpr (SEG) flush();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      Cm[m * N + n] =
          SEG ? tot[(ty * TM + i) * BN + tx * TN + j] : acc[i][j];
    }
  }
}

template <int MT, bool SEG>
int launch(const float* A, const float* B, float* C, int M, int K, int N,
           int hop, cudaStream_t s) {
  const int n_col = (N + BN - 1) / BN;
  const long long blocks = static_cast<long long>((M + MT - 1) / MT) * n_col;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto* kern = dense_gemm_kernel<MT, SEG>;
  constexpr size_t smem = Smem<MT, SEG>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(blocks), NT, smem, s>>>(A, B, C, M, K, N, hop,
                                                        n_col);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns the launch's cudaError_t.
// A: [M, K], B: [K, N], C: [M, N], all row-major and contiguous; mt: the M
// tile, 512 or 176; hop: 0 for one K loop, else the segment length (a
// multiple of 16).
extern "C" int r8b_dense_gemm_f32(const float* A, const float* B, float* C,
                                  int M, int K, int N, int mt, int hop,
                                  void* stream) {
  if (M < 0 || K < 1 || N < 1 || hop < 0 || hop % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mt == 512)
    return hop ? launch<512, true>(A, B, C, M, K, N, hop, s)
               : launch<512, false>(A, B, C, M, K, N, 0, s);
  if (mt == 176)
    return hop ? launch<176, true>(A, B, C, M, K, N, hop, s)
               : launch<176, false>(A, B, C, M, K, N, 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
