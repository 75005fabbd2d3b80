// Centrosymmetry-folded banded-Toeplitz conv stage (ConvExec engine
// "toeplitz_sym"), for sm_90a.  For every phase j of the stage, frame b of
// channel c and column t' < B/2 (B = 256):
//
//     a[l] = xp[c, b*hop + l],  r[l] = xp[c, b*hop + L_f_j - 1 - l],
//     z = a + r,  w = a - r                         (l < Hp_j = ceil(L_f_j/2))
//     oe = sum_l z[l] * Te_j[l, t'],  oo = sum_l w[l] * To_j[l, t']
//     y[c, (b*B + t')*up + j]         = oe + oo
//     y[c, (b*B + B-1-t')*up + j]     = oe - oo
//
// Under precision "high" each of oe, oo also gets the exact two_sum error
// of its fold add dotted with the same operator, and the dot of z (w) with
// the row-truncated f64 -> f32 operator residual Te_lo (To_lo) over its
// rows [r0, r0 + n).
//
// Replaces the reference package's TPU kernel
// r8brain_tpu/ops/pallas_symconv.py::sym_conv_stage_pallas.  That kernel
// needed a reversed copy of the stage input per phase (Mosaic has no lane
// reverse) and a separate XLA pass to flip and interleave its [e+o | e-o]
// output blocks.  Here the reversed window is read by index from the same
// staged span, and the mirrored half is written straight to its final
// interleaved place: the fold halves the FMAs of the unfolded operator
// and adds no pass.
//
// What bounds it: operations.  44.1k -> 96k at 1024 channels is 8.7e10
// flop against ~0.55 GB, ~160 flop per byte, far above the fp32 CUDA-core
// ridge (~20 flop/byte).  TF32 cannot hold the -141 dB class, so this is
// an FMA kernel on the CUDA cores.
//
// Design:
//   * One block = one channel x BM = 32 consecutive frames, all phases.
//     It stages the span xp[c, b0*hop : (b0+nf-1)*hop + max L_f] once into
//     shared memory with cp.async; every phase's forward and reversed
//     windows are read from it (the phases share one frame origin).
//   * Per phase, the operators stream through shared memory in BK = 16-row
//     slabs (two stages, 16-byte cp.async; Hp reaches 899 rows, 920 KB for
//     Te and To together at 96k -> 44.1k, so they cannot stay resident).
//     Each slab's folded rows z, w (and the fold errors under "high") are
//     built once into shared memory from the span, then each thread runs
//     TM x TN = 4 x 4 outputs of each of oe and oo.
//   * Accuracy: float32 partials of FOLD = 32 terms are folded into (hi,
//     lo) with two_sum, as in frac_whole (a single running f32 sum over
//     ~900 terms loses ~12 dB).  The "high" terms (~2^-24 of the main
//     ones) run in one plain f32 sum.  The two halves combine with one
//     more two_sum, so each output rounds once:
//         (s, e) = two_sum(hi_e, +-hi_o)
//         y = s + (e + ((lo_e +- lo_o) [+ (rr_e +- rr_o)]))
//     float64 accumulates without folds.  Built without --use_fast_math.
//   The plain PyTorch model of this chunking and fold order is
//   r8brain_torch/ops/pallas_symconv.py::sym_conv_ref.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int MAXP = 8;   // phases a stage may have
constexpr int BM = 32;    // frames (of one channel) a block
constexpr int BH = 128;   // columns of each half, B/2
constexpr int BK = 16;    // operator rows a slab
constexpr int TM = 4;     // frames a thread
constexpr int TN = 4;     // columns a thread, of each of oe and oo
constexpr int NT = (BM / TM) * (BH / TN);  // 256 threads
constexpr int FOLD = 32;  // terms a float32 partial sums before its fold
constexpr int ZP = BM + 4;  // row pitch of the folded slab (16-byte rows)
static_assert(FOLD % BK == 0, "folds fall on slab ends");
static_assert(BH / TN == 32, "one warp spans the columns of TM frames");
static_assert(TM == 4 && TN == 4, "vector loads of four");

struct Phases {
  int Lf[MAXP];
  int r0[MAXP][2];  // first residual row of Te_lo, To_lo
  int n[MAXP][2];   // residual rows of Te_lo, To_lo
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  }
}
// 16 bytes global -> shared; zeros instead when `pred` is false
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, bool HIGH>
__host__ __device__ constexpr size_t fixed_smem_elems() {
  // operator slabs [2 stages][2 ops][BK][BH] (twice under HIGH, the
  // residual rows) + folded slabs [BK][ZP] (z, w; + z_err, w_err)
  return size_t(2) * 2 * BK * BH * (HIGH ? 2 : 1) +
         size_t(BK) * ZP * (HIGH ? 4 : 2);
}

// four consecutive elements (16-byte aligned) as vector loads
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  const T bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

template <typename T, bool HIGH>
__global__ void __launch_bounds__(NT)
sym_conv_kernel(const T* __restrict__ xp, long long ldx,
                const T* __restrict__ ops, const T* __restrict__ lo,
                T* __restrict__ y, int nb, int hop, int up, int Hp_max,
                int R_lo, int Lf_max, int n_tiles, Phases ph) {
  constexpr bool kFold = sizeof(T) == 4;
  constexpr int VEC = 16 / sizeof(T);  // elements of one 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* opsS = reinterpret_cast<T*>(smem_raw);  // [2][2][BK][BH]
  T* loS = opsS + 2 * 2 * BK * BH;           // [2][2][BK][BH], HIGH only
  T* zS = opsS + 2 * 2 * BK * BH * (HIGH ? 2 : 1);  // [BK][ZP]
  T* wS = zS + BK * ZP;
  T* zeS = wS + BK * ZP;  // HIGH only
  T* weS = zeS + BK * ZP;
  T* span = opsS + fixed_smem_elems<T, HIGH>();

  const int tid = threadIdx.x;
  const int ty = tid / (BH / TN);  // the warp: frames ty*TM ...
  const int tx = tid % (BH / TN);  // columns tx*TN ...
  const long long c = blockIdx.x / n_tiles;
  const int b0 = static_cast<int>(blockIdx.x % n_tiles) * BM;
  const int nf = min(BM, nb - b0);
  const long long out_row = static_cast<long long>(nb) * 2 * BH * up;

  // the block's span, once: every phase reads its windows from it
  {
    const T* src = xp + c * ldx + static_cast<long long>(b0) * hop;
    const int len = (nf - 1) * hop + Lf_max;
    for (int e = tid; e < len; e += NT) cp_async_elem(span + e, src + e);
    cp_async_commit();
  }

  for (int j = 0; j < up; ++j) {
    const int Lf = ph.Lf[j];
    const int Hp = (Lf + 1) / 2;
    const T* te = ops + static_cast<size_t>(2 * j) * Hp_max * BH;
    const T* to = te + static_cast<size_t>(Hp_max) * BH;
    const T* tel = HIGH ? lo + static_cast<size_t>(2 * j) * R_lo * BH : lo;
    const T* tol = HIGH ? tel + static_cast<size_t>(R_lo) * BH : lo;
    const int r0e = ph.r0[j][0], ne = ph.n[j][0];
    const int r0o = ph.r0[j][1], no = ph.n[j][1];

    // slab [k0, k0 + BK) of Te, To (and of the residual rows) into stage st
    auto load_ops = [&](int st, int k0) {
      for (int q = tid; q < BK * BH / VEC; q += NT) {
        const int kk = q / (BH / VEC);
        const int cc = (q % (BH / VEC)) * VEC;
        const int l = k0 + kk;
        const bool ok = l < Hp;
        const size_t off = ok ? static_cast<size_t>(l) * BH + cc : 0;
        T* dst = opsS + static_cast<size_t>(st * 2 * BK + kk) * BH + cc;
        cp_async16(dst, te + off, ok);
        cp_async16(dst + BK * BH, to + off, ok);
        if constexpr (HIGH) {
          const bool oe_ = l >= r0e && l < r0e + ne;
          const bool oo_ = l >= r0o && l < r0o + no;
          T* dl = loS + static_cast<size_t>(st * 2 * BK + kk) * BH + cc;
          cp_async16(dl, tel + (oe_ ? static_cast<size_t>(l - r0e) * BH + cc
                                    : 0), oe_);
          cp_async16(dl + BK * BH,
                     tol + (oo_ ? static_cast<size_t>(l - r0o) * BH + cc : 0),
                     oo_);
        }
      }
      cp_async_commit();
    };

    T acc_e[TM][TN], acc_o[TM][TN], hi_e[TM][TN], hi_o[TM][TN];
    T lo_e[TM][TN], lo_o[TM][TN], rr_e[HIGH ? TM : 1][HIGH ? TN : 1],
        rr_o[HIGH ? TM : 1][HIGH ? TN : 1];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int k = 0; k < TN; ++k) {
        acc_e[i][k] = acc_o[i][k] = T(0);
        hi_e[i][k] = hi_o[i][k] = lo_e[i][k] = lo_o[i][k] = T(0);
        if constexpr (HIGH) rr_e[i][k] = rr_o[i][k] = T(0);
      }
    }
    auto fold = [&]() {
      if constexpr (kFold) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int k = 0; k < TN; ++k) {
            T s, e;
            two_sum(hi_e[i][k], acc_e[i][k], s, e);
            hi_e[i][k] = s;
            lo_e[i][k] += e;
            two_sum(hi_o[i][k], acc_o[i][k], s, e);
            hi_o[i][k] = s;
            lo_o[i][k] += e;
            acc_e[i][k] = acc_o[i][k] = T(0);
          }
        }
      }
    };

    const int n_slabs = (Hp + BK - 1) / BK;
    load_ops(0, 0);
    for (int s = 0; s < n_slabs; ++s) {
      const int st = s & 1;
      const int k0 = s * BK;
      if (s + 1 < n_slabs) {
        load_ops(st ^ 1, k0 + BK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      // the folded slab: row l of frame i, from the forward and the
      // reversed window of the span (kk fastest: consecutive addresses)
      for (int q = tid; q < BK * BM; q += NT) {
        const int kk = q % BK;
        const int i = q / BK;
        const int l = k0 + kk;
        T zv = T(0), wv = T(0), ze = T(0), we = T(0);
        if (l < Hp && i < nf) {
          const T a = span[i * hop + l];
          const T r = span[i * hop + Lf - 1 - l];
          zv = a + r;
          wv = a - r;
          if constexpr (HIGH) {
            const T bz = zv - a;
            ze = (a - (zv - bz)) + (r - bz);
            const T bv = wv - a;
            we = (a - (wv - bv)) - (r + bv);
          }
        }
        zS[kk * ZP + i] = zv;
        wS[kk * ZP + i] = wv;
        if constexpr (HIGH) {
          zeS[kk * ZP + i] = ze;
          weS[kk * ZP + i] = we;
        }
      }
      __syncthreads();

      const T* oe_s = opsS + static_cast<size_t>(st * 2 * BK) * BH;
      const T* oo_s = oe_s + BK * BH;
      const T* le_s = loS + static_cast<size_t>(st * 2 * BK) * BH;
      const T* lo_s = le_s + BK * BH;
      // does this slab meet a residual row block? (uniform in the block)
      const bool lo_slab = HIGH && ((k0 < r0e + ne && k0 + BK > r0e) ||
                                    (k0 < r0o + no && k0 + BK > r0o));
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        T z[TM], w[TM], a_e[TN], a_o[TN];
        ld4(zS + kk * ZP + ty * TM, z);
        ld4(wS + kk * ZP + ty * TM, w);
        ld4(oe_s + kk * BH + tx * TN, a_e);
        ld4(oo_s + kk * BH + tx * TN, a_o);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int k = 0; k < TN; ++k) {
            acc_e[i][k] = fma_t(z[i], a_e[k], acc_e[i][k]);
            acc_o[i][k] = fma_t(w[i], a_o[k], acc_o[i][k]);
          }
        }
        if constexpr (HIGH) {
          T ze[TM], we[TM];
          ld4(zeS + kk * ZP + ty * TM, ze);
          ld4(weS + kk * ZP + ty * TM, we);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int k = 0; k < TN; ++k) {
              rr_e[i][k] = fma_t(ze[i], a_e[k], rr_e[i][k]);
              rr_o[i][k] = fma_t(we[i], a_o[k], rr_o[i][k]);
            }
          }
          if (lo_slab) {
            T b_e[TN], b_o[TN];
            ld4(le_s + kk * BH + tx * TN, b_e);
            ld4(lo_s + kk * BH + tx * TN, b_o);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
#pragma unroll
              for (int k = 0; k < TN; ++k) {
                rr_e[i][k] = fma_t(z[i], b_e[k], rr_e[i][k]);
                rr_o[i][k] = fma_t(w[i], b_o[k], rr_o[i][k]);
              }
            }
          }
        }
      }
      if ((k0 + BK) % FOLD == 0) fold();
      // every warp is done with this stage before it is refilled
      __syncthreads();
    }
    fold();

    // write both halves straight to their interleaved places
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int fi = ty * TM + i;
      if (fi >= nf) continue;
      T* yb = y + c * out_row +
              static_cast<long long>(b0 + fi) * 2 * BH * up + j;
#pragma unroll
      for (int k = 0; k < TN; ++k) {
        const int t = tx * TN + k;
        T he = hi_e[i][k], ho = hi_o[i][k];
        if constexpr (!kFold) {
          he = acc_e[i][k];
          ho = acc_o[i][k];
        }
        T tp = lo_e[i][k] + lo_o[i][k];
        T tm = lo_e[i][k] - lo_o[i][k];
        if constexpr (HIGH) {
          tp = tp + (rr_e[i][k] + rr_o[i][k]);
          tm = tm + (rr_e[i][k] - rr_o[i][k]);
        }
        T s, e;
        two_sum(he, ho, s, e);
        yb[static_cast<long long>(t) * up] = s + (e + tp);
        two_sum(he, -ho, s, e);
        yb[static_cast<long long>(2 * BH - 1 - t) * up] = s + (e + tm);
      }
    }
  }
}

template <typename T, bool HIGH>
cudaError_t launch_one(const T* xp, long long ldx, const T* ops, const T* lo,
                       T* y, int C, int nb, int hop, int up, int Hp_max,
                       int R_lo, int Lf_max, const Phases& ph,
                       cudaStream_t s) {
  const int n_tiles = (nb + BM - 1) / BM;
  const long long blocks = static_cast<long long>(C) * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t span = static_cast<size_t>(BM - 1) * hop + Lf_max;
  const size_t smem = (fixed_smem_elems<T, HIGH>() + span) * sizeof(T);
  auto* kern = sym_conv_kernel<T, HIGH>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), NT, smem, s>>>(
      xp, ldx, ops, lo, y, nb, hop, up, Hp_max, R_lo, Lf_max, n_tiles, ph);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* xp, long long ldx, const T* ops, const T* lo, T* y,
           int C, int nb, int hop, int up, int Hp_max, int R_lo,
           const int* Lf, const int* lo_rows, void* stream) {
  if (C < 0 || nb < 1 || hop < 1 || up < 1 || up > MAXP || Hp_max < 1 ||
      ldx < 0 || (lo != nullptr && R_lo < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Phases ph{};
  int Lf_max = 0;
  for (int j = 0; j < up; ++j) {
    ph.Lf[j] = Lf[j];
    if (Lf[j] < 1 || (Lf[j] + 1) / 2 > Hp_max)
      return static_cast<int>(cudaErrorInvalidValue);
    Lf_max = Lf[j] > Lf_max ? Lf[j] : Lf_max;
    for (int k = 0; k < 2; ++k) {
      ph.r0[j][k] = lo_rows != nullptr ? lo_rows[4 * j + 2 * k] : 0;
      ph.n[j][k] = lo_rows != nullptr ? lo_rows[4 * j + 2 * k + 1] : 0;
      if (ph.r0[j][k] < 0 || ph.n[j][k] < 0 || ph.n[j][k] > R_lo)
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      lo != nullptr
          ? launch_one<T, true>(xp, ldx, ops, lo, y, C, nb, hop, up, Hp_max,
                                R_lo, Lf_max, ph, s)
          : launch_one<T, false>(xp, ldx, ops, lo, y, C, nb, hop, up, Hp_max,
                                 R_lo, Lf_max, ph, s);
  return static_cast<int>(e);
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns the launch's cudaError_t.
// xp: [C, >= (nb-1)*hop + max Lf] with row stride ldx elements; ops: [up, 2,
// Hp_max, 128] (Te_j, To_j; rows past Hp_j are not read); lo: null, or [up,
// 2, R_lo, 128] residual rows, with lo_rows [up][4] = (r0_e, n_e, r0_o,
// n_o); Lf: [up] frame lengths; y: [C, nb*256*up].  lo selects precision
// "high" (the residual dots and the fold-error compensation); float64 has
// no "high".
extern "C" int r8b_sym_conv_f32(const float* xp, long long ldx,
                                const float* ops, const float* lo, float* y,
                                int C, int nb, int hop, int up, int Hp_max,
                                int R_lo, const int* Lf, const int* lo_rows,
                                void* stream) {
  return launch<float>(xp, ldx, ops, lo, y, C, nb, hop, up, Hp_max, R_lo, Lf,
                       lo_rows, stream);
}

extern "C" int r8b_sym_conv_f64(const double* xp, long long ldx,
                                const double* ops, double* y, int C, int nb,
                                int hop, int up, int Hp_max, const int* Lf,
                                void* stream) {
  return launch<double>(xp, ldx, ops, nullptr, y, C, nb, hop, up, Hp_max, 0,
                        Lf, nullptr, stream);
}
