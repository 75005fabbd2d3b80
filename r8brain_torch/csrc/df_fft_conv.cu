// Overlap-save FFT convolution of float32 frames with a fixed kernel
// spectrum, in FP64, for sm_90a:
//
//     frame f of row c:  x_f[t] = u[c, f*hop + t],  t < n   (zero past L)
//     w[c, f*hop + t]  = (x_f (*) k)[head + t],     t < hop = n - head
//
// with (*) the circular convolution of length n, computed as
// IFFT(FFT(x_f) * G) where G = FFT(k)/n arrives from the host (the 1/n of
// the inverse folded in).  In polyphase mode G = FFT(k_even)/n +
// i*FFT(k_odd)/n and the output is interleaved,
//
//     w[c, 2*(f*hop + t) + p] = (x_f (*) k_p)[head + t],   p = 0, 1,
//
// the up = 2 convolution of the zero-stuffed signal without the stuffing.
//
// Replaces all five df32-FFT TPU kernels of the reference package:
// ops/pallas_dfft5.py (df_ols_convolve_pallas5, _framed, _framed_poly:
// the bodies of _make_kernel5), ops/pallas_dfft4.py
// (df_ols_convolve_pallas4) and ops/pallas_dfft.py
// (df_ols_convolve_pallas).  They compute this one function, the f64
// convolution rounded to float32, in two-float arithmetic because the TPU
// has no fast float64; their differences are Mosaic layout work-arounds
// (lane rolls, the 128-lane four-step, frame starts on sublane tiles).
// Hopper has native FP64, so the butterflies, the spectrum product and the
// twiddles (host float64 tables, no device sin/cos) are plain doubles, and
// the only rounding to float32 is the output store (round to nearest).
//
// What bounds it: operations, at FP64 vector rate.  A length-n complex
// transform is about 5 n log2(n) flop; the flagship conv stage (n = 4096,
// one forward and one inverse transform per frame, ~15 frames per channel,
// 1024 channels) is ~7.5 GFLOP against ~0.2 GB of compulsory traffic, ~40
// flop per byte, above the FP64 ridge (~10 flop per byte).
//
// Design (a first, simple kernel; a faster one is later work):
//   * Packing: two real frames per complex transform (frame 2g in the real
//     part, 2g + 1 in the imaginary part, in row-major frame order across
//     rows), since (a + ib) (*) k = a (*) k + i b (*) k for a real k.  In
//     polyphase mode one real frame per transform, and the two inverse
//     transforms share one: IFFT(X * (H_e + i H_o)) = x(*)k_e + i x(*)k_o.
//   * n <= 8192: one CTA holds the whole transform in dynamic shared
//     memory (16 B a point, padded one point in 16 against bank
//     conflicts: 139 KB at n = 8192).  It reads its frames straight from
//     u (64-bit row offsets, any row stride), runs a radix-2 DIF forward
//     transform (natural order in, bit-reversed out), multiplies by G at
//     the bit-reversed index, runs a radix-2 DIT inverse (bit-reversed
//     in, natural out), and writes only the hop valid samples.  Each pass
//     does up to three radix-2 stages in registers on 8 points a thread,
//     with one __syncthreads between passes (four passes each way at
//     n = 4096).  At most 256 threads a CTA keep the registers of three
//     CTAs an SM, which at n = 4096 is also what shared memory holds.
//   * n >= 16384: the four-step split n = n1*n2 (n1, n2 <= 256), through a
//     float64 scratch that the wrapper allocates, in three launches of the
//     same shared-memory body: column transforms of length n2 and the
//     twiddle W_n^(t1*k2); row transforms of length n1, the product by G
//     and the inverse row transforms; the conjugate twiddle and inverse
//     column transforms, which write the output.
// The plain PyTorch version (r8brain_torch/ops/pallas_dfft.py::
// df_fft_conv_ref) is the same function through torch.fft in complex128.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int SMEM_MAX_LOGN = 13;  // one CTA holds transforms up to 8192
constexpr int MAX_RB = 3;          // radix-2 stages per pass: 8 points
constexpr int MAX_THREADS = 256;   // ~80 registers a thread: 3 CTAs an SM

__device__ __forceinline__ int pad_idx(int i) { return i + (i >> 4); }

__host__ __device__ constexpr int smem_points(int m) { return m + (m >> 4); }

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ double2 conj(double2 a) {
  return make_double2(a.x, -a.y);
}

__device__ __forceinline__ int brev(int p, int logm) {
  return static_cast<int>(__brev(static_cast<unsigned>(p)) >> (32 - logm));
}

// One pass of RB consecutive radix-2 stages over a length-2^logm sequence
// in shared memory.  Each thread takes groups of R = 2^RB points at
// stride hmin = 2^log_hmin.  Forward (DIF): stage halves hmin*2^(RB-1)
// down to hmin, twiddle on the difference.  Inverse (DIT, conjugate
// twiddles): halves hmin up to hmin*2^(RB-1), twiddle before the
// butterfly.  tw[e] = exp(-2*pi*i*e / 2^logn) is the host table; the
// twiddle of position j in a stage of half h is tw[j * 2^logn / (2h)].
template <int RB, bool INV>
__device__ void radix_pass(double2* s, int logm, int log_hmin,
                           const double2* __restrict__ tw, int logn) {
  constexpr int R = 1 << RB;
  const int hmin = 1 << log_hmin;
  const int groups = 1 << (logm - RB);
  for (int gi = threadIdx.x; gi < groups; gi += blockDim.x) {
    const int j = gi & (hmin - 1);
    const int base = ((gi >> log_hmin) << (log_hmin + RB)) + j;
    double2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = s[pad_idx(base + (k << log_hmin))];
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int sk = INV ? (1 << q) : (1 << (RB - 1 - q));
      const int log_h = INV ? log_hmin + q : log_hmin + RB - 1 - q;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (k & sk) continue;
        const int jpos = ((k & (sk - 1)) << log_hmin) + j;
        const double2 w = tw[jpos << (logn - log_h - 1)];
        if (INV) {
          const double2 t = cmul(v[k + sk], conj(w));
          v[k + sk] = csub(v[k], t);
          v[k] = cadd(v[k], t);
        } else {
          const double2 a = v[k], b = v[k + sk];
          v[k] = cadd(a, b);
          v[k + sk] = cmul(csub(a, b), w);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) s[pad_idx(base + (k << log_hmin))] = v[k];
  }
}

template <bool INV>
__device__ void pass_rb(int rb, double2* s, int logm, int log_hmin,
                        const double2* __restrict__ tw, int logn) {
  switch (rb) {
    case 3: radix_pass<3, INV>(s, logm, log_hmin, tw, logn); break;
    case 2: radix_pass<2, INV>(s, logm, log_hmin, tw, logn); break;
    default: radix_pass<1, INV>(s, logm, log_hmin, tw, logn); break;
  }
}

// Length-2^logm transform of s (shared memory, written and synced by the
// caller): forward DIF, natural order in, bit-reversed out; or inverse
// DIT, unscaled, bit-reversed in, natural out.  Ends synced.
template <bool INV>
__device__ void block_fft(double2* s, int logm, const double2* __restrict__ tw,
                          int logn) {
  if (!INV) {
    for (int log_top = logm - 1; log_top >= 0;) {
      const int rb = log_top + 1 < MAX_RB ? log_top + 1 : MAX_RB;
      pass_rb<false>(rb, s, logm, log_top - rb + 1, tw, logn);
      __syncthreads();
      log_top -= rb;
    }
  } else {
    for (int log_bot = 0; log_bot < logm;) {
      const int rb = logm - log_bot < MAX_RB ? logm - log_bot : MAX_RB;
      pass_rb<true>(rb, s, logm, log_bot, tw, logn);
      __syncthreads();
      log_bot += rb;
    }
  }
}

// The (at most two) frames of transform g: rows ca, cb and frame
// indices fa, fb within their rows (cb < 0: no second frame, in poly mode
// or for the last of an odd count).
struct Frames {
  long long ca, fa, cb, fb;
};

__device__ Frames frames_of(long long g, long long F_total, int n_frames,
                            bool poly) {
  Frames fr;
  const long long a = poly ? g : 2 * g;
  fr.ca = a / n_frames;
  fr.fa = a - fr.ca * n_frames;
  fr.cb = fr.fb = -1;
  if (!poly && a + 1 < F_total) {
    fr.cb = (a + 1) / n_frames;
    fr.fb = a + 1 - fr.cb * n_frames;
  }
  return fr;
}

// Point t of the packed frame pair: frame a real, frame b imaginary.
__device__ __forceinline__ double2 load_point(const Frames& fr,
                                              const float* __restrict__ u,
                                              long long ldu, long long L,
                                              int hop, int t) {
  const long long ia = fr.fa * hop + t;
  const double a = ia < L ? static_cast<double>(u[fr.ca * ldu + ia]) : 0.0;
  double b = 0.0;
  if (fr.cb >= 0) {
    const long long ib = fr.fb * hop + t;
    if (ib < L) b = static_cast<double>(u[fr.cb * ldu + ib]);
  }
  return make_double2(a, b);
}

// Output sample o (< hop) of the transform's frames, rounded to nearest;
// rows of out are n_frames*hop long (twice that, interleaved, when poly).
__device__ __forceinline__ void store_point(const Frames& fr,
                                            float* __restrict__ out,
                                            int n_frames, int hop, int o,
                                            double2 z, bool poly) {
  const long long row = static_cast<long long>(n_frames) * hop;
  if (poly) {
    reinterpret_cast<float2*>(out + 2 * (fr.ca * row + fr.fa * hop))[o] =
        make_float2(__double2float_rn(z.x), __double2float_rn(z.y));
  } else {
    out[fr.ca * row + fr.fa * hop + o] = __double2float_rn(z.x);
    if (fr.cb >= 0)
      out[fr.cb * row + fr.fb * hop + o] = __double2float_rn(z.y);
  }
}

// n <= 8192: one CTA per transform, the whole pipeline in shared memory.
template <bool POLY>
__global__ void __launch_bounds__(MAX_THREADS)
    conv_smem_kernel(const float* __restrict__ u, long long ldu, long long L,
        const double2* __restrict__ G, const double2* __restrict__ tw,
        float* __restrict__ out, long long F_total, int n_frames, int logn,
        int head, long long g0) {
  extern __shared__ double2 s[];
  const int n = 1 << logn, hop = n - head;
  const Frames fr = frames_of(g0 + blockIdx.x, F_total, n_frames, POLY);
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    s[pad_idx(t)] = load_point(fr, u, ldu, L, hop, t);
  __syncthreads();
  block_fft<false>(s, logn, tw, logn);
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    s[pad_idx(p)] = cmul(s[pad_idx(p)], G[brev(p, logn)]);
  __syncthreads();
  block_fft<true>(s, logn, tw, logn);
  for (int t = threadIdx.x; t < hop; t += blockDim.x)
    store_point(fr, out, n_frames, hop, t, s[pad_idx(head + t)], POLY);
}

// Four-step, n = n1*n2, t = t1 + n1*t2, k = k2 + n2*k1.  Scratch S of
// transform g (local to the launch's range) holds n points at
// S[p2*n1 + t1], p2 the bit-reversed position of k2.
//
// Pass A, CTA (t1, g): y[k2] = sum_t2 x[t1 + n1*t2] W_n2^(t2*k2), times
// W_n^(t1*k2).
template <bool POLY>
__global__ void __launch_bounds__(MAX_THREADS)
    four_step_a(const float* __restrict__ u, long long ldu, long long L,
        const double2* __restrict__ tw, double2* __restrict__ S,
        long long F_total, int n_frames, int logn, int log_n1, int head,
        long long g0) {
  extern __shared__ double2 s[];
  const int n = 1 << logn, hop = n - head, log_n2 = logn - log_n1;
  const int n2 = 1 << log_n2, t1 = blockIdx.x;
  const Frames fr = frames_of(g0 + blockIdx.y, F_total, n_frames, POLY);
  for (int t2 = threadIdx.x; t2 < n2; t2 += blockDim.x)
    s[pad_idx(t2)] = load_point(fr, u, ldu, L, hop, t1 + (t2 << log_n1));
  __syncthreads();
  block_fft<false>(s, log_n2, tw, logn);
  double2* Sg = S + (static_cast<long long>(blockIdx.y) << logn);
  for (int p2 = threadIdx.x; p2 < n2; p2 += blockDim.x)
    Sg[(p2 << log_n1) + t1] =
        cmul(s[pad_idx(p2)], tw[t1 * brev(p2, log_n2)]);
}

// Pass B, CTA (p2, g): the length-n1 transform over t1 of row p2, the
// product by G[k2 + n2*k1], the inverse transform back to t1.
__global__ void __launch_bounds__(MAX_THREADS)
    four_step_b(const double2* __restrict__ G, const double2* __restrict__ tw,
        double2* __restrict__ S, int logn, int log_n1) {
  extern __shared__ double2 s[];
  const int log_n2 = logn - log_n1, n1 = 1 << log_n1, p2 = blockIdx.x;
  const int k2 = brev(p2, log_n2);
  double2* row = S + (static_cast<long long>(blockIdx.y) << logn) +
                 (static_cast<long long>(p2) << log_n1);
  for (int t1 = threadIdx.x; t1 < n1; t1 += blockDim.x)
    s[pad_idx(t1)] = row[t1];
  __syncthreads();
  block_fft<false>(s, log_n1, tw, logn);
  for (int p1 = threadIdx.x; p1 < n1; p1 += blockDim.x)
    s[pad_idx(p1)] =
        cmul(s[pad_idx(p1)], G[k2 + (brev(p1, log_n1) << log_n2)]);
  __syncthreads();
  block_fft<true>(s, log_n1, tw, logn);
  for (int t1 = threadIdx.x; t1 < n1; t1 += blockDim.x)
    row[t1] = s[pad_idx(t1)];
}

// Pass C, CTA (t1, g): times conj W_n^(t1*k2), the inverse length-n2
// transform over k2 (its input already in bit-reversed order), and the
// valid samples t = t1 + n1*t2 in [head, n) to the output.
template <bool POLY>
__global__ void __launch_bounds__(MAX_THREADS)
    four_step_c(const double2* __restrict__ tw, const double2* __restrict__ S,
        float* __restrict__ out, long long F_total, int n_frames, int logn,
        int log_n1, int head, long long g0) {
  extern __shared__ double2 s[];
  const int n = 1 << logn, hop = n - head, log_n2 = logn - log_n1;
  const int n2 = 1 << log_n2, t1 = blockIdx.x;
  const Frames fr = frames_of(g0 + blockIdx.y, F_total, n_frames, POLY);
  const double2* Sg = S + (static_cast<long long>(blockIdx.y) << logn);
  for (int p2 = threadIdx.x; p2 < n2; p2 += blockDim.x)
    s[pad_idx(p2)] = cmul(Sg[(p2 << log_n1) + t1],
                          conj(tw[t1 * brev(p2, log_n2)]));
  __syncthreads();
  block_fft<true>(s, log_n2, tw, logn);
  for (int t2 = threadIdx.x; t2 < n2; t2 += blockDim.x) {
    const int t = t1 + (t2 << log_n1);
    if (t >= head)
      store_point(fr, out, n_frames, hop, t - head, s[pad_idx(t2)], POLY);
  }
}

int threads_for(int m) {
  const int t = m >> 4;
  return t < 32 ? 32 : (t > MAX_THREADS ? MAX_THREADS : t);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <bool POLY>
cudaError_t launch(const float* u, long long ldu, long long L,
                   const double2* G, const double2* tw, float* out,
                   long long F_total, int n_frames, int logn, int head,
                   long long g0, long long count, double2* S,
                   cudaStream_t st) {
  cudaError_t e;
  if (logn <= SMEM_MAX_LOGN) {
    const int n = 1 << logn;
    const size_t smem = smem_points(n) * sizeof(double2);
    if ((e = allow_smem(conv_smem_kernel<POLY>, smem)) != cudaSuccess)
      return e;
    conv_smem_kernel<POLY><<<static_cast<unsigned>(count), threads_for(n),
                             smem, st>>>(u, ldu, L, G, tw, out, F_total,
                                         n_frames, logn, head, g0);
    return cudaGetLastError();
  }
  const int log_n1 = logn / 2, log_n2 = logn - log_n1;
  const int n1 = 1 << log_n1, n2 = 1 << log_n2;
  const dim3 grid_a(n1, static_cast<unsigned>(count));
  const dim3 grid_b(n2, static_cast<unsigned>(count));
  four_step_a<POLY><<<grid_a, threads_for(n2),
                      smem_points(n2) * sizeof(double2), st>>>(
      u, ldu, L, tw, S, F_total, n_frames, logn, log_n1, head, g0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  four_step_b<<<grid_b, threads_for(n1), smem_points(n1) * sizeof(double2),
                st>>>(G, tw, S, logn, log_n1);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  four_step_c<POLY><<<grid_a, threads_for(n2),
                      smem_points(n2) * sizeof(double2), st>>>(
      tw, S, out, F_total, n_frames, logn, log_n1, head, g0);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns the launch's cudaError_t.
// u: [C, >= 0] float32, unit stride along time, row stride ldu, L samples
// a row (reads past L are zeros); G, tw: n complex128 (the spectrum in
// natural order; tw[e] = exp(-2*pi*i*e/n)); out: [C, n_frames*hop] float32
// (x2 interleaved when poly), contiguous.  Transforms g0 .. g0+count-1 of
// the n_tr = C*n_frames (poly) or ceil(C*n_frames/2) run; for n > 8192,
// scratch holds count*n complex128 and count <= 65535.
extern "C" int r8b_df_fft_conv(const float* u, long long ldu, long long L,
                               const void* G, const void* tw, float* out,
                               int C, int n_frames, int n, int head, int poly,
                               long long g0, long long count, void* scratch,
                               void* stream) {
  int logn = 0;
  while ((1 << logn) < n && logn < 30) ++logn;
  if (n != (1 << logn) || logn < 7 || logn > 16 || head < 0 || head >= n ||
      C < 1 || n_frames < 1 || ldu < 0 || L < 0 || g0 < 0 || count < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long F_total = static_cast<long long>(C) * n_frames;
  const long long n_tr = poly ? F_total : (F_total + 1) / 2;
  if (g0 + count > n_tr) return static_cast<int>(cudaErrorInvalidValue);
  if (logn > SMEM_MAX_LOGN && (scratch == nullptr || count > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  if (count > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* Gd = static_cast<const double2*>(G);
  const auto* twd = static_cast<const double2*>(tw);
  auto* S = static_cast<double2*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      poly ? launch<true>(u, ldu, L, Gd, twd, out, F_total, n_frames, logn,
                          head, g0, count, S, st)
           : launch<false>(u, ldu, L, Gd, twd, out, F_total, n_frames, logn,
                           head, g0, count, S, st);
  return static_cast<int>(e);
}
