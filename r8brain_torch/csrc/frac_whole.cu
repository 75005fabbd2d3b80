// Framed matmul of the fused 44.1k->96k chain (and of every whole-stepping
// interpolator), for sm_90a:
//
//     y[c, m*O + j] = sum_{d<D} xp[c, m*I + d] * skT[d, j]
//                   (+ sum_{d<D} xp[c, m*I + d] * skT_lo[d, j])
//
// Replaces the reference package's TPU kernel
// r8brain_tpu/ops/pallas_frac.py::frac_whole_pallas (its pallas_call and
// kernel body: the main HIGHEST dot and the optional residual dot).
//
// What bounds it: operations.  The flagship (C=1024, n_win=150, D=1027,
// O=640) is 2.0e11 flop against 0.57 GB of compulsory traffic, ~350 flop per
// byte, far above the fp32 CUDA-core ridge of the H100 (~20 flop/byte).
// The accuracy class (-141 dB against the f64 oracle) rules out TF32 tensor
// cores (10-bit mantissa), so this first kernel is an FMA kernel on the
// CUDA cores; tensor cores with an exact split form are later work.
//
// Design:
//   * Rows r = c*n_win + m of an implicit im2col matrix A[r, d] =
//     xp[c, m*I + d] against B = skT [D, O].  Each block computes a BM x BN
//     tile of y (which is exactly the [R, O] row-major layout of y, so the
//     output needs no reshape); one 1-D grid walks (row tile, col tile)
//     with the column tile fastest, so the blocks of one row tile run
//     together and share the window rows in L2.
//   * The windows overlap (I < D) and start at unaligned offsets (I=294):
//     each block stages its BK-column slab of A from the rows' own start
//     offsets (64-bit, kept in shared memory), with coalesced element-wise
//     cp.async copies, transposed into shared memory so that each thread
//     reads its TM rows as one vector.  Two stages: the next slab's copies
//     are in flight while this slab's FMAs run.  The ragged edges in
//     C*n_win, D and O are zero-filled, so C needs no alignment.
//   * Accuracy: each output sums BK terms (one slab, BK = KC = 32 in f32)
//     into a register partial, then folds it into a (hi, lo) pair with
//     two_sum.  A single running f32 sum over 1027 terms reaches only about
//     -132 dB on this operator; the chunked fold holds about -144 dB.  The
//     residual dot (skT_lo, ~2^-24 of the main term) is a plain running sum
//     added at the end as hi + (lo + residual).  Built without
//     --use_fast_math so the fold is not reassociated.
//   The plain PyTorch model of this exact chunking and fold is
//   r8brain_torch/ops/pallas_frac.py::frac_whole_ref.

#include <cuda_runtime.h>
#include <climits>

namespace {

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// Asynchronous copy of one element global -> shared (cp.async, sm_80+);
// writes zero instead when `pred` is false (the source is then not read).
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem,
                                              bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? static_cast<int>(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int BM, int BN, int BK, bool HAS_LO>
struct Smem {
  static constexpr int APAD = BM + 4;  // keeps each row of As 16-byte aligned
  static constexpr int A = BK * APAD;  // elements of one A stage
  static constexpr int B = BK * BN;    // elements of one B stage
  static constexpr size_t bytes =
      BM * sizeof(long long) + 2 * (A + B * (HAS_LO ? 2 : 1)) * sizeof(T);
};

template <typename T, int BM, int BN, int BK, int TM, int TN, bool HAS_LO>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
frac_whole_kernel(const T* __restrict__ xp, long long ldx,
                  const T* __restrict__ skT, const T* __restrict__ skT_lo,
                  T* __restrict__ y, long long R, int n_win, int I, int D,
                  int O, int n_col_tiles) {
  using S = Smem<T, BM, BN, BK, HAS_LO>;
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int APAD = S::APAD;
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0, "tile/threads");
  static_assert(NT % BK == 0 && NT % BN == 0, "load mapping");
  static_assert((BM * sizeof(long long)) % 16 == 0, "stage alignment");
  // two stages of each slab: the next slab's copies run under this one's
  // FMAs
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_base = reinterpret_cast<long long*>(smem_raw);
  T* As = reinterpret_cast<T*>(smem_raw + BM * sizeof(long long));  // [2][BK][APAD]
  T* Bs = As + 2 * S::A;                                             // [2][BK][BN]
  T* Bl = Bs + 2 * S::B;  // [2][BK][BN], HAS_LO only

  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const int col_t = static_cast<int>(tile % n_col_tiles);
  const long long r0 = (tile / n_col_tiles) * BM;
  const int j0 = col_t * BN;

  for (int i = tid; i < BM; i += NT) {
    const long long r = r0 + i;
    if (r < R) {
      const long long c = r / n_win;
      const long long m = r - c * n_win;
      row_base[i] = c * ldx + m * static_cast<long long>(I);
    } else {
      row_base[i] = -1;
    }
  }
  __syncthreads();

  // Start the copies of slab [d0, d0 + BK) into stage `st`: A transposed to
  // As[kk][row] (lanes along d, coalesced), B as Bs[kk][j] (lanes along j);
  // out-of-range elements are written as zeros.
  auto load_slab = [&](int st, int d0) {
    T* as = As + st * S::A;
#pragma unroll
    for (int it = 0; it < BM * BK / NT; ++it) {
      const int e = it * NT + tid;
      const int kk = e % BK;
      const int i = e / BK;
      const int d = d0 + kk;
      const long long base = row_base[i];
      const bool ok = base >= 0 && d < D;
      cp_async_elem(as + kk * APAD + i, ok ? xp + base + d : xp, ok);
    }
    T* bs = Bs + st * S::B;
#pragma unroll
    for (int it = 0; it < BK * BN / NT; ++it) {
      const int e = it * NT + tid;
      const int jj = e % BN;
      const int kk = e / BN;
      const int d = d0 + kk;
      const int j = j0 + jj;
      const bool ok = d < D && j < O;
      const long long off = ok ? static_cast<long long>(d) * O + j : 0;
      cp_async_elem(bs + kk * BN + jj, skT + off, ok);
      if constexpr (HAS_LO)
        cp_async_elem(Bl + st * S::B + kk * BN + jj, skT_lo + off, ok);
    }
    cp_async_commit();
  };

  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  T acc[TM][TN], hi[TM][TN], lo[TM][TN], rr[HAS_LO ? TM : 1][HAS_LO ? TN : 1];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = T(0);
      hi[i][j] = T(0);
      lo[i][j] = T(0);
      if constexpr (HAS_LO) rr[i][j] = T(0);
    }
  }

  const int n_slabs = (D + BK - 1) / BK;
  load_slab(0, 0);
  for (int t = 0; t < n_slabs; ++t) {
    const int st = t & 1;
    if (t + 1 < n_slabs) {
      load_slab(st ^ 1, (t + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // stage bases are 16-byte aligned, so each thread's TM (TN) values load
    // as vectors
    const T* as = static_cast<const T*>(
        __builtin_assume_aligned(As + st * S::A, 16));
    const T* bs = static_cast<const T*>(
        __builtin_assume_aligned(Bs + st * S::B, 16));
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk * APAD + ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = bs[kk * BN + tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_t(a[i], b[j], acc[i][j]);
      }
      if constexpr (HAS_LO) {
        const T* bl = static_cast<const T*>(
            __builtin_assume_aligned(Bl + st * S::B, 16));
        T c[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) c[j] = bl[kk * BN + tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) rr[i][j] = fma_t(a[i], c[j], rr[i][j]);
        }
      }
    }
    // every warp is done with stage st before the next iteration refills it
    __syncthreads();

    // fold this slab's partial sums: two_sum(hi, acc) -> (hi, lo += err)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const T s = hi[i][j] + acc[i][j];
        const T bp = s - hi[i][j];
        const T err = (hi[i][j] - (s - bp)) + (acc[i][j] - bp);
        hi[i][j] = s;
        lo[i][j] += err;
        acc[i][j] = T(0);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = r0 + ty * TM + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = j0 + tx * TN + j;
      if (col >= O) continue;
      T v;
      if constexpr (HAS_LO) {
        v = hi[i][j] + (lo[i][j] + rr[i][j]);
      } else {
        v = hi[i][j] + lo[i][j];
      }
      y[r * O + col] = v;
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN, bool HAS_LO>
cudaError_t launch_one(unsigned blocks, cudaStream_t s, const T* xp,
                       long long ldx, const T* skT, const T* skT_lo, T* y,
                       long long R, int n_win, int I, int D, int O,
                       int n_col) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr size_t smem = Smem<T, BM, BN, BK, HAS_LO>::bytes;
  auto* kern = frac_whole_kernel<T, BM, BN, BK, TM, TN, HAS_LO>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<blocks, NT, smem, s>>>(xp, ldx, skT, skT_lo, y, R, n_win, I, D, O,
                                n_col);
  return cudaGetLastError();
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const T* xp, long long ldx, const T* skT, const T* skT_lo, T* y,
           int C, int n_win, int I, int D, int O, void* stream) {
  if (C < 0 || n_win < 1 || I < 1 || D < 1 || O < 1 || ldx < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long R = static_cast<long long>(C) * n_win;
  if (R == 0) return 0;
  const int n_col = (O + BN - 1) / BN;
  const long long blocks = ((R + BM - 1) / BM) * n_col;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaError_t e =
      skT_lo != nullptr
          ? launch_one<T, BM, BN, BK, TM, TN, true>(nb, s, xp, ldx, skT, skT_lo,
                                                    y, R, n_win, I, D, O, n_col)
          : launch_one<T, BM, BN, BK, TM, TN, false>(nb, s, xp, ldx, skT,
                                                     skT_lo, y, R, n_win, I, D,
                                                     O, n_col);
  return static_cast<int>(e);
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns the launch's cudaError_t.
// xp: [C, >= (n_win-1)*I + D] with row stride ldx elements; skT, skT_lo:
// [D, O] row-major (skT_lo may be null); y: [C, n_win*O] row-major.
extern "C" int r8b_frac_whole_f32(const float* xp, long long ldx,
                                  const float* skT, const float* skT_lo,
                                  float* y, int C, int n_win, int I, int D,
                                  int O, void* stream) {
  // BK = 32 is the KC of the plain model (frac_whole_ref)
  return launch<float, 128, 64, 32, 8, 4>(xp, ldx, skT, skT_lo, y, C, n_win,
                                          I, D, O, stream);
}

extern "C" int r8b_frac_whole_f64(const double* xp, long long ldx,
                                  const double* skT, const double* skT_lo,
                                  double* y, int C, int n_win, int I, int D,
                                  int O, void* stream) {
  return launch<double, 64, 64, 16, 4, 4>(xp, ldx, skT, skT_lo, y, C, n_win,
                                          I, D, O, stream);
}
