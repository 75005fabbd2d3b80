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
// What bounds it: the FP64 vector units and the traffic inside the SM.
// The function needs ~5 n log2(n) flop a complex transform, two
// transforms a frame pair (one a frame in polyphase mode): at n = 4096,
// polyphase, 1024 channels, ~8 GFLOP against ~0.56 GB of compulsory
// traffic, ~14 flop per byte, near the ridge of the FP64 vector rate
// (~34 TFLOP/s, 3.35 TB/s).  So the points stay in registers and shared
// memory carries only the exchange between passes.
//
// Design, n <= 8192 (every size the main paths use):
//   * Packing: two real frames per complex transform (frame 2g in the real
//     part, 2g + 1 in the imaginary part, in row-major frame order across
//     rows), since (a + ib) (*) k = a (*) k + i b (*) k for a real k.  In
//     polyphase mode one real frame per transform, and the two inverse
//     transforms share one: IFFT(X * (H_e + i H_o)) = x(*)k_e + i x(*)k_o.
//   * n/16 threads a transform, 16 points each in registers.  Passes:
//     one of radix R0 = 2^(log2 n mod 4) (16 when that is 0), then radix
//     16: n = 4096 is 16.16.16, 8192 is 2.16.16.16, 2048 is 8.16.16.  The
//     forward transform is decimation in frequency (natural order in,
//     digit-reversed out); a radix-16 butterfly is two radix-4 stages in
//     registers, and the twiddles W_L^(jk) of its 15 outputs are powers of
//     one base twiddle tw[j*n/L] (one load a thread and pass; two to five
//     products deep).
//   * The last forward pass (sub-problems of 16 contiguous points, no
//     twiddles), the spectrum product and the first inverse pass run on
//     the same registers: the host stores G in the order the forward
//     transform leaves the points in (DfFFTPlan.Gk, [16][n/16], read
//     coalesced), so there is no bit reversal and no sweep of its own.
//   * The inverse is decimation in time with conjugate twiddles applied
//     before each butterfly, the forward's passes in reverse order; its
//     last pass leaves point t + m*n/16 in register m, stored straight to
//     the output (coalesced) where t >= head.
//   * Between passes the points go through shared memory: one write, one
//     barrier, one read (2(P-1) exchanges for P passes: 4 at n = 4096, 6
//     at 8192), a point every 16 padded (16 bytes a point) so that no
//     pattern conflicts, addressed as one base a thread plus constants.
//   * Persistent CTAs (as many as fit on the card) walk the transforms; a
//     thread copies its own points of the next transform into a staging
//     buffer in shared memory with cp.async while it computes this one,
//     so no CTA waits on device memory (one CTA an SM at n = 8192, whose
//     load latency a CTA a transform left bare).  A CTA holds n/16
//     threads (at least 128: several transforms a CTA below n = 2048).
//     The launch bounds let a thread take up to 255 registers (one CTA of
//     256 threads an SM at n = 4096, no spills: 5 % faster than two CTAs
//     held to 128 registers and spilling); at n = 8192 the 512 threads
//     get 128 each, and registers, not the 203 KB of shared memory, bound
//     the occupancy.
//   * Sizes 16384..65536: the four-step split n = n1*n2 (n1, n2 <= 256),
//     through a float64 scratch that the wrapper allocates, in three
//     launches of one shared-memory radix-2 body (radix-8 passes):
//     column transforms of length n2 and the twiddle W_n^(t1*k2); row
//     transforms of length n1, the product by G and the inverse row
//     transforms; the conjugate twiddle and inverse column transforms,
//     which write the output.  No timed path reaches these sizes.
// The plain PyTorch version (r8brain_torch/ops/pallas_dfft.py::
// df_fft_conv_ref) is the same function through torch.fft in complex128.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int REG_MAX_LOGN = 13;   // register-resident passes up to 8192
constexpr int MAX_RB = 3;          // four-step: radix-2 stages a pass
constexpr int MAX_THREADS = 256;   // four-step: threads a CTA

// Ablation, for tools/torch_fft_ablation.py only: a build with
// -DR8B_ABLATE=mask changes or drops parts of the n <= 8192 kernel's work
// (its output is then wrong, except under bit 1) so that the rest can be
// timed.  Bits: 1 each twiddle loaded from the table instead of powers of
// one, 2 no spectrum product, 4 loads and stores only (no passes, no
// product), 8 no exchanges through shared memory, 16 no inter-pass
// twiddles, 32 at most 128 registers a thread (launch bounds asking for
// 512 threads an SM, so two CTAs of 256 at n = 4096; the output is right).
#ifndef R8B_ABLATE
#define R8B_ABLATE 0
#endif
constexpr bool kTwTable = R8B_ABLATE & 1;
constexpr bool kNoProduct = R8B_ABLATE & 2;
constexpr bool kIoOnly = R8B_ABLATE & 4;
constexpr bool kNoExchange = R8B_ABLATE & 8;
constexpr bool kNoTwiddle = R8B_ABLATE & 16;
constexpr bool kRegCap = R8B_ABLATE & 32;

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

// ---------------------------------------------------------------------------
// n <= 8192: register-resident radix-16 passes, one kernel a call

// multiply by W16^E = exp(-2*pi*i*E/16), or by its conjugate (INV); E a
// constant, so the multiples of 4 cost nothing and the odd multiples of 2
// two products
template <int E, bool INV>
__device__ __forceinline__ double2 rot16(double2 a) {
  constexpr int e = ((INV ? -E : E) % 16 + 16) % 16;
  constexpr double R = 0.70710678118654752440;  // cos(pi/4)
  constexpr double C = 0.92387953251128675613;  // cos(pi/8)
  constexpr double S = 0.38268343236508977173;  // sin(pi/8)
  // cos(2*pi*e/16), sin(2*pi*e/16)
  constexpr double cs[16] = {1, C, R, S, 0, -S, -R, -C,
                             -1, -C, -R, -S, 0, S, R, C};
  constexpr double sn[16] = {0, S, R, C, 1, C, R, S,
                             0, -S, -R, -C, -1, -C, -R, -S};
  if constexpr (e == 0) {
    return a;
  } else if constexpr (e == 4) {
    return make_double2(a.y, -a.x);
  } else if constexpr (e == 8) {
    return make_double2(-a.x, -a.y);
  } else if constexpr (e == 12) {
    return make_double2(-a.y, a.x);
  } else if constexpr (e == 2) {
    return make_double2(R * (a.x + a.y), R * (a.y - a.x));
  } else if constexpr (e == 6) {
    return make_double2(R * (a.y - a.x), -R * (a.x + a.y));
  } else if constexpr (e == 10) {
    return make_double2(-R * (a.x + a.y), R * (a.x - a.y));
  } else if constexpr (e == 14) {
    return make_double2(R * (a.x - a.y), R * (a.x + a.y));
  } else {
    return cmul(a, make_double2(cs[e], -sn[e]));
  }
}

// In-place DFTs of R points in registers, natural order in and out:
// forward X_k = sum_m x_m W_R^(mk), inverse (INV) with W_R^(-mk), unscaled
template <bool INV>
__device__ __forceinline__ void dft4(double2& a0, double2& a1, double2& a2,
                                     double2& a3) {
  const double2 s02 = cadd(a0, a2), d02 = csub(a0, a2);
  const double2 s13 = cadd(a1, a3), d13 = csub(a1, a3);
  // -i * d13 forward, +i * d13 inverse
  const double2 jd = INV ? make_double2(-d13.y, d13.x)
                         : make_double2(d13.y, -d13.x);
  a0 = cadd(s02, s13);
  a2 = csub(s02, s13);
  a1 = cadd(d02, jd);
  a3 = csub(d02, jd);
}

template <int R, bool INV>
struct Dft;
template <bool INV>
struct Dft<2, INV> {
  __device__ __forceinline__ static void run(double2 (&t)[2]) {
    const double2 a = t[0];
    t[0] = cadd(a, t[1]);
    t[1] = csub(a, t[1]);
  }
};
template <bool INV>
struct Dft<4, INV> {
  __device__ __forceinline__ static void run(double2 (&t)[4]) {
    dft4<INV>(t[0], t[1], t[2], t[3]);
  }
};
// 8 = 4 x 2: m = m1 + 2*m2, k = k2 + 4*k1
template <bool INV>
struct Dft<8, INV> {
  __device__ __forceinline__ static void run(double2 (&t)[8]) {
    dft4<INV>(t[0], t[2], t[4], t[6]);
    dft4<INV>(t[1], t[3], t[5], t[7]);
    t[3] = rot16<2, INV>(t[3]);
    t[5] = rot16<4, INV>(t[5]);
    t[7] = rot16<6, INV>(t[7]);
    double2 y[8];
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      y[k2] = cadd(t[2 * k2], t[2 * k2 + 1]);
      y[k2 + 4] = csub(t[2 * k2], t[2 * k2 + 1]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = y[k];
  }
};
// 16 = 4 x 4: m = m1 + 4*m2, k = k2 + 4*k1
template <bool INV>
struct Dft<16, INV> {
  __device__ __forceinline__ static void run(double2 (&t)[16]) {
#pragma unroll
    for (int m1 = 0; m1 < 4; ++m1)
      dft4<INV>(t[m1], t[m1 + 4], t[m1 + 8], t[m1 + 12]);
    t[5] = rot16<1, INV>(t[5]);
    t[9] = rot16<2, INV>(t[9]);
    t[13] = rot16<3, INV>(t[13]);
    t[6] = rot16<2, INV>(t[6]);
    t[10] = rot16<4, INV>(t[10]);
    t[14] = rot16<6, INV>(t[14]);
    t[7] = rot16<3, INV>(t[7]);
    t[11] = rot16<6, INV>(t[11]);
    t[15] = rot16<9, INV>(t[15]);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2)
      dft4<INV>(t[4 * k2], t[4 * k2 + 1], t[4 * k2 + 2], t[4 * k2 + 3]);
    double2 y[16];
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2)
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1) y[k2 + 4 * k1] = t[4 * k2 + k1];
#pragma unroll
    for (int k = 0; k < 16; ++k) t[k] = y[k];
  }
};

// Geometry of the register-resident transform of length N = 2^LOGN
template <int LOGN>
struct Geo {
  static constexpr int N = 1 << LOGN;
  static constexpr int NT = N / 16;  // threads a transform, 16 points each
  static constexpr int LOG_R0 = LOGN % 4 ? LOGN % 4 : 4;
  static constexpr int R0 = 1 << LOG_R0;          // radix of pass 0
  static constexpr int Q = (LOGN - LOG_R0) / 4;  // radix-16 passes after it
  static constexpr int TPC = NT >= 128 ? 1 : 128 / NT;  // transforms a CTA
  static constexpr int THREADS = NT * TPC;
  static constexpr int PTS = smem_points(N);  // a transform's buffer
  // log2 of the sub-problem length of radix-16 pass i (1..Q)
  __host__ __device__ static constexpr int log_L(int i) {
    return LOGN - LOG_R0 - 4 * (i - 1);
  }
};

// Position of point m of thread tau in pass I: pass 0 holds t + m*N/16;
// radix-16 pass I, sub-problems of L = 2^log_L(I) points at stride s =
// L/16, holds block tau/s, offset j = tau % s: (tau/s)*L + j + m*s
template <int LOGN, int I>
__device__ __forceinline__ int pos(int tau, int m) {
  if constexpr (I == 0) {
    return tau + (m << (LOGN - 4));
  } else {
    constexpr int lL = Geo<LOGN>::log_L(I), ls = lL - 4;
    return ((tau >> ls) << lL) + (tau & ((1 << ls) - 1)) + (m << ls);
  }
}

// pad_idx(pos<LOGN, I>(tau, m)) as a base that depends on tau alone plus
// a constant offset for each m (strides are 1 or multiples of 16, except
// n = 128's pass 0), so the exchanges address with immediate offsets
template <int LOGN, int I>
__device__ __forceinline__ int ppos(int tau, int m) {
  constexpr int st =
      I == 0 ? 1 << (LOGN - 4) : 1 << (Geo<LOGN>::log_L(I) - 4);
  const int b = pos<LOGN, I>(tau, 0);
  if constexpr (st % 16 == 0) {
    return pad_idx(b) + m * (st + st / 16);
  } else if constexpr (st == 1) {
    return pad_idx(b) + m;  // b = 16*tau: the 16 points share a pad
  } else {
    return pad_idx(b + m * st);
  }
}

// t[k] *= W^k for k = 1..15 (the conjugates under INV), W = tw[j << sh]
// = W_N^(j*2^sh): powers of one base twiddle, w^k = w^(k-4) * w^4, at
// most five products deep; or, under the table ablation, tw[(j*k) << sh]
// each (j*k*2^sh < N)
template <bool INV>
__device__ __forceinline__ void twiddle(double2 (&t)[16], int j, int sh,
                                        const double2* __restrict__ tw) {
  if constexpr (kNoTwiddle) return;
  auto apply = [&](int k, double2 w) {
    t[k] = cmul(t[k], INV ? conj(w) : w);
  };
  if constexpr (kTwTable) {
#pragma unroll
    for (int k = 1; k < 16; ++k) apply(k, __ldg(tw + ((j * k) << sh)));
  } else {
    const double2 w1 = __ldg(tw + (j << sh));
    const double2 w2 = cmul(w1, w1);
    double2 wr[4] = {w1, w2, cmul(w2, w1), cmul(w2, w2)};  // the last four
    const double2 w4 = wr[3];
#pragma unroll
    for (int k = 1; k < 16; ++k) {
      if (k > 4) wr[(k - 1) & 3] = cmul(wr[(k - 1) & 3], w4);
      apply(k, wr[(k - 1) & 3]);
    }
  }
}

// multiply by W16^e for a value of e that unrolling makes constant
__device__ __forceinline__ double2 rot16_at(double2 a, int e) {
  switch (e & 15) {
    case 1: return rot16<1, false>(a);
    case 2: return rot16<2, false>(a);
    case 3: return rot16<3, false>(a);
    case 4: return rot16<4, false>(a);
    case 5: return rot16<5, false>(a);
    case 6: return rot16<6, false>(a);
    case 7: return rot16<7, false>(a);
    case 8: return rot16<8, false>(a);
    case 9: return rot16<9, false>(a);
    case 10: return rot16<10, false>(a);
    case 11: return rot16<11, false>(a);
    case 12: return rot16<12, false>(a);
    case 13: return rot16<13, false>(a);
    case 14: return rot16<14, false>(a);
    case 15: return rot16<15, false>(a);
    default: return a;
  }
}

// Pass 0, radix R0 over the whole transform (stride N/R0): groups q <
// 16/R0 of the points m*N/16 + tau, elements q + (16/R0)*k, offset j = tau
// + q*N/16, twiddles W_N^(jk) on the outputs (forward, DIF) or the
// inputs (inverse, DIT).  Below radix 16, W_N^(jk) = W_N^(tau*k) *
// W16^(qk): the powers of one loaded twiddle, turned by constants.
template <int LOGN, bool INV>
__device__ __forceinline__ void pass0(double2 (&v)[16], int tau,
                                      const double2* __restrict__ tw) {
  constexpr int R = Geo<LOGN>::R0, GR = 16 / R;
  if constexpr (R == 16) {
    if (INV) twiddle<true>(v, tau, 0, tw);
    Dft<16, INV>::run(v);
    if (!INV) twiddle<false>(v, tau, 0, tw);
  } else {
    double2 p[R];  // p[k] = W_N^(tau*k), k >= 1
    if constexpr (!kNoTwiddle) {
      p[1] = __ldg(tw + tau);
#pragma unroll
      for (int k = 2; k < R; ++k)
        p[k] = kTwTable ? __ldg(tw + tau * k) : cmul(p[k - 1], p[1]);
    }
#pragma unroll
    for (int q = 0; q < GR; ++q) {
      double2 t[R];
#pragma unroll
      for (int k = 0; k < R; ++k) t[k] = v[q + GR * k];
      if constexpr (INV && !kNoTwiddle) {
#pragma unroll
        for (int k = 1; k < R; ++k)
          t[k] = cmul(t[k], conj(rot16_at(p[k], q * k)));
      }
      Dft<R, INV>::run(t);
      if constexpr (!INV && !kNoTwiddle) {
#pragma unroll
        for (int k = 1; k < R; ++k) t[k] = cmul(t[k], rot16_at(p[k], q * k));
      }
#pragma unroll
      for (int k = 0; k < R; ++k) v[q + GR * k] = t[k];
    }
  }
}

// Radix-16 pass I (1..Q): twiddles W_L^(jk) = W_N^(jk*N/L); none in the
// last pass (L = 16, j = 0)
template <int LOGN, int I, bool INV>
__device__ __forceinline__ void pass16(double2 (&v)[16], int tau,
                                       const double2* __restrict__ tw) {
  constexpr int lL = Geo<LOGN>::log_L(I), ls = lL - 4;
  const int j = tau & ((1 << ls) - 1);
  if constexpr (INV && ls > 0) twiddle<true>(v, j, LOGN - lL, tw);
  Dft<16, INV>::run(v);
  if constexpr (!INV && ls > 0) twiddle<false>(v, j, LOGN - lL, tw);
}

// The points from pass FROM's positions to pass TO's through the
// transform's buffer s; `first`: nothing read s before (no barrier)
template <int LOGN, int FROM, int TO>
__device__ __forceinline__ void exchange(double2 (&v)[16], double2* s,
                                         int tau, bool first) {
  if constexpr (kNoExchange) return;
  if (!first) __syncthreads();
#pragma unroll
  for (int m = 0; m < 16; ++m) s[ppos<LOGN, FROM>(tau, m)] = v[m];
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 16; ++m) v[m] = s[ppos<LOGN, TO>(tau, m)];
}

// forward radix-16 passes I..Q (pass I - 1 done); `first` as exchange's
template <int LOGN, int I>
__device__ __forceinline__ void forward_from(double2 (&v)[16], double2* s,
                                             int tau,
                                             const double2* __restrict__ tw,
                                             bool first) {
  if constexpr (I <= Geo<LOGN>::Q) {
    exchange<LOGN, I - 1, I>(v, s, tau, first);
    pass16<LOGN, I, false>(v, tau, tw);
    forward_from<LOGN, I + 1>(v, s, tau, tw, false);
  }
}

// inverse passes I..0 (inverse pass I + 1 done)
template <int LOGN, int I>
__device__ __forceinline__ void inverse_from(double2 (&v)[16], double2* s,
                                             int tau,
                                             const double2* __restrict__ tw) {
  exchange<LOGN, I + 1, I>(v, s, tau, false);
  if constexpr (I == 0) {
    pass0<LOGN, true>(v, tau, tw);
  } else {
    pass16<LOGN, I, true>(v, tau, tw);
    inverse_from<LOGN, I - 1>(v, s, tau, tw);
  }
}

// cp.async of one float, zero-filled (the source not read) unless ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// Copies of this thread's points (tau + m*N/16 of each frame) of
// transform g into its slot's staging buffer st ([frames][N] floats),
// zero past L and for a transform past the range (live false)
template <int LOGN, bool POLY>
__device__ __forceinline__ void prefetch(float* st,
                                         const float* __restrict__ u,
                                         long long ldu, long long L,
                                         long long F_total, int n_frames,
                                         int hop, long long g, bool live,
                                         int tau) {
  constexpr int N = 1 << LOGN;
  const Frames fr = frames_of(g, F_total, n_frames, POLY);
  const float* pa = u + fr.ca * ldu + fr.fa * hop;
  const long long la = live ? L - fr.fa * hop : 0;
  const float* pb = u + fr.cb * ldu + fr.fb * hop;
  const long long lb = live && fr.cb >= 0 ? L - fr.fb * hop : 0;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int t = pos<LOGN, 0>(tau, m);
    cp_async4(st + t, t < la ? pa + t : u, t < la);
    if constexpr (!POLY) cp_async4(st + N + t, t < lb ? pb + t : u, t < lb);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Transforms g0 .. g_end-1 in groups of TPC (one a slot of the CTA);
// persistent CTAs walk the groups, the input of the next group copied
// into shared memory (cp.async) under the passes of this one.  Gk: the
// spectrum in the forward transform's output order, Gk[m*N/16 + tau] for
// the point that thread tau holds in register m after the last forward
// pass (position 16*tau + m).  One CTA an SM is enough for the launch
// bounds: up to 255 registers a thread below n = 8192 (no spills), 128 at
// 8192 (512 threads).
template <int LOGN, bool POLY>
__global__ void __launch_bounds__(Geo<LOGN>::THREADS,
                                  kRegCap ? 512 / Geo<LOGN>::THREADS : 1)
    conv_reg_kernel(const float* __restrict__ u, long long ldu, long long L,
        const double2* __restrict__ Gk, const double2* __restrict__ tw,
        float* __restrict__ out, long long F_total, int n_frames, int head,
        long long g0, long long g_end) {
  using GE = Geo<LOGN>;
  constexpr int SF = (POLY ? 1 : 2) * GE::N;  // staged floats a transform
  extern __shared__ double2 smem[];
  const int slot = threadIdx.x / GE::NT, tau = threadIdx.x % GE::NT;
  double2* s = smem + slot * GE::PTS;
  float* st = reinterpret_cast<float*>(smem + GE::TPC * GE::PTS) + slot * SF;
  const int hop = GE::N - head;
  const long long n_groups = (g_end - g0 + GE::TPC - 1) / GE::TPC;
  // a group's last transforms may lie past the range: they run on zeros
  // (every thread takes part in the barriers) and store nothing
  auto g_of = [&](long long grp) { return g0 + grp * GE::TPC + slot; };
  long long grp = blockIdx.x;
  prefetch<LOGN, POLY>(st, u, ldu, L, F_total, n_frames, hop, g_of(grp),
                       g_of(grp) < g_end, tau);
  for (; grp < n_groups; grp += gridDim.x) {
    const long long g = g_of(grp);
    // this thread's own copies (no other thread reads them)
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    double2 v[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int t = pos<LOGN, 0>(tau, m);
      v[m] = make_double2(st[t], POLY ? 0.0 : st[GE::N + t]);
    }
    if constexpr (!kIoOnly) pass0<LOGN, false>(v, tau, tw);
    // pass 0 has used every staged point: refill the buffer
    const long long next = grp + gridDim.x;
    if (next < n_groups)
      prefetch<LOGN, POLY>(st, u, ldu, L, F_total, n_frames, hop,
                           g_of(next), g_of(next) < g_end, tau);
    if constexpr (!kIoOnly) {
      forward_from<LOGN, 1>(v, s, tau, tw, grp == blockIdx.x);
      if constexpr (!kNoProduct) {
#pragma unroll
        for (int m = 0; m < 16; ++m)
          v[m] = cmul(v[m], __ldg(Gk + m * GE::NT + tau));
      }
      pass16<LOGN, GE::Q, true>(v, tau, tw);
      inverse_from<LOGN, GE::Q - 1>(v, s, tau, tw);
    }
    if (g >= g_end) continue;
    const Frames fr = frames_of(g, F_total, n_frames, POLY);
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int t = pos<LOGN, 0>(tau, m);
      if (t >= head) store_point(fr, out, n_frames, hop, t - head, v[m], POLY);
    }
  }
}

// ---------------------------------------------------------------------------
// n >= 16384: the four-step split over a shared-memory radix-2 body

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

template <int LOGN, bool POLY>
cudaError_t launch_reg(const float* u, long long ldu, long long L,
                       const double2* Gk, const double2* tw, float* out,
                       long long F_total, int n_frames, int head,
                       long long g0, long long count, cudaStream_t st) {
  using GE = Geo<LOGN>;
  // the exchange buffers and the staged input of each slot
  const size_t smem = static_cast<size_t>(GE::TPC) *
                      (GE::PTS * sizeof(double2) +
                       (POLY ? 1 : 2) * GE::N * sizeof(float));
  auto* kern = conv_reg_kernel<LOGN, POLY>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  // persistent: as many CTAs as fit on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, GE::THREADS, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long groups = (count + GE::TPC - 1) / GE::TPC;
  const long long most = static_cast<long long>(sms) * per_sm;
  const long long blocks = groups < most ? groups : most;
  kern<<<static_cast<unsigned>(blocks), GE::THREADS, smem, st>>>(
      u, ldu, L, Gk, tw, out, F_total, n_frames, head, g0, g0 + count);
  return cudaGetLastError();
}

template <bool POLY>
cudaError_t launch(const float* u, long long ldu, long long L,
                   const double2* G, const double2* tw, float* out,
                   long long F_total, int n_frames, int logn, int head,
                   long long g0, long long count, double2* S,
                   cudaStream_t st) {
  using Fn = cudaError_t (*)(const float*, long long, long long,
                             const double2*, const double2*, float*,
                             long long, int, int, long long, long long,
                             cudaStream_t);
  constexpr Fn reg[] = {launch_reg<7, POLY>,  launch_reg<8, POLY>,
                        launch_reg<9, POLY>,  launch_reg<10, POLY>,
                        launch_reg<11, POLY>, launch_reg<12, POLY>,
                        launch_reg<13, POLY>};
  if (logn <= REG_MAX_LOGN)
    return reg[logn - 7](u, ldu, L, G, tw, out, F_total, n_frames, head, g0,
                         count, st);
  cudaError_t e;
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
// a row (reads past L are zeros); tw: n complex128, tw[e] =
// exp(-2*pi*i*e/n); G: n complex128, for n <= 8192 the spectrum in the
// forward transform's output order as DfFFTPlan.Gk lays it out, above in
// natural order; out: [C, n_frames*hop] float32 (x2 interleaved when
// poly), contiguous.  Transforms g0 .. g0+count-1 of the n_tr =
// C*n_frames (poly) or ceil(C*n_frames/2) run; for n > 8192, scratch
// holds count*n complex128 and count <= 65535.
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
  if (logn > REG_MAX_LOGN && (scratch == nullptr || count > 65535))
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
