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
// the row-truncated f64 -> f32 operator residual Te_lo (To_lo).
//
// Replaces the reference package's TPU kernel
// r8brain_tpu/ops/pallas_symconv.py::sym_conv_stage_pallas.  That kernel
// needed a reversed copy of the stage input per phase (Mosaic has no lane
// reverse) and a separate XLA pass to flip and interleave its [e+o | e-o]
// output blocks.  Here the reversed window is read by index from the same
// staged span, and the mirrored half is written straight to its final
// interleaved place: the fold halves the products of the unfolded
// operator and adds no pass.
//
// float32: a three-slice bfloat16 split on the tensor cores (wgmma), the
// arithmetic of frac_whole.cu with the lead slices on fixed grids (its
// plain model is r8brain_torch/ops/pallas_symconv.py::sym_conv_ref).
//
// What bounds it: operations.  44.1k -> 96k at 1024 channels is 7.6e10
// flop of the function over the folded operators' nonzeros against ~0.55
// GB.  TF32 cannot hold the -141 dB class; float32 FMA on the CUDA cores is
// bound at 1.13 ms (67 TFLOP/s).  The split form runs 6 bf16 products a
// term (8 under "high": the fold errors and the residual rows) at 989
// TFLOP/s: 0.46 ms (0.56 under "high").
//
// Arithmetic:
//   * z, w formed in float32 (and under "high" their two_sum errors), each
//     split into three bf16 slices z = z0 + z1 + z2 + O(2^(E-27)): z0 is z
//     rounded to nearest on one grid for each frame and k16 step, 2^(E-8)
//     with 2^E above the step's largest |z| (a quad's max, E from its
//     exponent field; one too large is harmless), by adding and
//     subtracting 1.5 * 2^(E+15); z - z0 is exact and splits into z1, z2
//     by the floating rule.  The operators come split the same way, once,
//     by the executor (sym_parts: s0 on a grid for each column and k16
//     step, s1, s2, and under "high" bf16 of the residual rows at their
//     offsets).  Every slice product is exact in float32.
//   * Kept pairs: p+q <= 2; under "high" also bf16(z_err)*s0 and z0*s3.
//   * The big pair z0*s0 sums into a partial of FOLD = 32 terms: each of
//     its two k16 steps starts fresh (wgmma scale-d = 0, one accumulator
//     each).  z0 = k 2^(E-8) and s0 = m 2^(F-8) with |k|, |m| <= 256, so
//     a step's 16 products lie on the grid 2^(E+F-16) and sum to under
//     2^20 of its units: the sum is exact in float32 and the tensor cores,
//     which truncate an inexact sum toward zero, have nothing to truncate
//     (a truncated sum is a loss of gain, correlated with the signal, that
//     adds up coherently along a chain of stages).  The steps' sums are
//     added in float32 and the partial is folded into (hi, lo) with
//     two_sum on the CUDA cores.  The other products accumulate straight
//     into lo.  The halves combine as
//         (s, e) = two_sum(hi_e, +-hi_o),  y = s + (e + (lo_e +- lo_o)),
//     so each output rounds once.  Plain __f*_rn arithmetic (no
//     --use_fast_math): nothing is contracted or reassociated.
//
// Design:
//   * A block is two warpgroups; each owns one tile of 64 consecutive
//     frames of one channel (the rows of its m64 MMAs) and computes, for
//     every phase and every 32-column tile of the half, both z*Te and w*To
//     (m64n32k16), so the mirrored outputs y[t'] and y[B-1-t'] come from
//     one thread's registers: no exchange between warpgroups.  Eight
//     fragments of 16 floats a thread (two step partials, hi and lo of
//     each operator).  Tried on the H100 and slower: two warpgroups on the
//     same frames, one operator each over 64-column tiles, handing (hi,
//     lo) over through shared memory (9-11 % slower at the fast shapes,
//     level under "high": twice the operator traffic a frame, a 2-stage
//     ring); an operator's slices
//     stacked along N, z0 x [s0|s1|s2] as one n96 wgmma (one accumulator
//     of 48-64 floats an operator: 255 registers, spills, serialized
//     wgmmas).  128 columns a warpgroup would need two operators'
//     48-64 KB stages per k-tile, which with the windows does not fit.
//   * The span a tile's windows cover, xp[c, b0*hop : b0*hop + 63*hop +
//     max L_f], is staged once into shared memory with cp.async and serves
//     every phase, column tile, forward and reversed window.  Frames sit
//     hop = 256*down floats apart, a multiple of 32 banks, so the span is
//     skewed: SK floats of padding after every 256 samples (SK*down = 8
//     mod 32 where down allows), which puts the 8 rows of a fragment read
//     on different banks.  A k16 step never straddles a 256-sample
//     boundary, so the skew is one add a step; the reversed window's float
//     pairs are read as one 8-byte load and swapped where L_f is even, as
//     two 4-byte loads where it is odd.
//   * The operators are packed on the host, once (sym_parts): per (phase,
//     column tile, 64-row k-tile) one contiguous block [Te: P slices | To:
//     P slices], each a K-major [32, 64] bf16 tile, 128-byte swizzled.
//     One TMA bulk copy moves a block into an mbarrier ring shared by both
//     warpgroups (3 stages, 2 under "high"); wgmma reads B from it through
//     128B swizzle descriptors.  The warpgroup that frees a slot second
//     refills it, so neither waits for the other.
//   * A fold is: read and fold the windows, split z and w (and their
//     errors) for all its k16 steps, fence, its MMAs, commit, wait,
//     two_sum.  All of a fold's input registers are written before its
//     MMAs start (ptxas serializes wgmmas whose register inputs change in
//     flight).  The parts add up (tools/torch_sym_ablation.py): one
//     warpgroup's CUDA-core work does not hide under the other's MMAs.
//   * One phase a pass, written with stride up: all phases at once would
//     multiply the accumulators (up to 8 phases).
//
// float64: an FMA kernel on the CUDA cores (the port's f64 path), one
// block per channel x 32 frames, the operators streamed in 16-row slabs.

#include <climits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAXP = 8;   // phases a stage may have
constexpr int BH = 128;   // columns of each half, B/2

struct Phases {
  int Lf[MAXP];
};

// ---------------------------------------------------------------------------
// float32: the split form on the tensor cores

namespace split {

constexpr int TK = 64;           // operator rows a k-tile
constexpr int TN = 32;           // columns a tile, of each operator
constexpr int N_TILES = BH / TN;
constexpr int NF = 64;           // frames a warpgroup (the MMAs' rows)
constexpr int NR = TN / 2;       // accumulator floats a thread a fragment
constexpr int NT = 256;          // two warpgroups
constexpr int SLICE = TN * TK;   // bf16 elements of one slice's tile
// terms of a big-pair partial (ops/pallas_frac.py KC): two k16 steps, each
// summed fresh (and exactly) on the tensor cores and added in float32
// before the fold
constexpr int FOLD = 32;
static_assert(TK % FOLD == 0 && FOLD % 16 == 0, "folds tile the k-tile");

// Ablation, for tools/torch_sym_ablation.py only: a build with
// -DR8B_ABLATE=mask drops parts of the work (its output is then wrong) so
// that the rest can be timed.  Bits: 1 the two_sum fold (one add
// instead), 2 the split and its grids (z1 = z2 = z0 = bf16(z)), 4 the
// small-pair (and "high") MMAs, 8 the span staging, 16 the output stores,
// 32 the reversed window (z = w = a).
#ifndef R8B_ABLATE
#define R8B_ABLATE 0
#endif
constexpr bool kNoFold = R8B_ABLATE & 1;
constexpr bool kNoSplit = R8B_ABLATE & 2;
constexpr bool kNoSmall = R8B_ABLATE & 4;
constexpr bool kNoStage = R8B_ABLATE & 8;
constexpr bool kNoStore = R8B_ABLATE & 16;
constexpr bool kNoSym = R8B_ABLATE & 32;

// span index of sample p of a tile (SK floats of skew after every 256)
__device__ __forceinline__ int skewed(int p, int sk) {
  return p + sk * (p >> 8);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

template <int P>
__global__ void __launch_bounds__(NT, 1)
sym_split_kernel(const float* __restrict__ xp, long long ldx,
                 const bf16* __restrict__ parts, int Kt, float* __restrict__ y,
                 long long n_tiles_all, int nb, int hop, int up, int n_tiles,
                 int nf_max, int span_f, int sk, int vec, int ST, int Lf_max,
                 Phases ph) {
  constexpr int KS = FOLD / 16;          // k16 steps a fold
  constexpr int UNIT = 2 * P * SLICE;    // bf16 elements a ring stage
  constexpr unsigned UNIT_BYTES = UNIT * 2;

  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Bs = reinterpret_cast<bf16*>(base);  // [ST][UNIT]
  float* spans = reinterpret_cast<float*>(base + size_t(ST) * UNIT_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(spans + 2 * span_f);
  int* freed = reinterpret_cast<int*>(full + ST);  // warpgroups done, a slot

  const int tid = threadIdx.x;
  const int wg = tid >> 7, tw = tid & 127;
  const int wq = tw >> 5, lane = tw & 31, g = lane >> 2, tq = lane & 3;

  // this warpgroup's tile: channel c, frames b0 .. b0 + nf - 1
  const long long tile = 2LL * blockIdx.x + wg;
  long long c = 0;
  int b0 = 0, nf = 0;
  if (tile < n_tiles_all) {
    c = tile / n_tiles;
    b0 = static_cast<int>(tile % n_tiles) * nf_max;
    nf = min(nf_max, nb - b0);
  }
  float* span = spans + wg * span_f;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the operator blocks, one bulk copy a (phase, column tile, k-tile), in
  // the consumers' order: the first ST by thread 0 now, each later one by
  // the warpgroup that frees its slot second, so that neither warpgroup
  // waits for the other
  auto kt_of = [&](int j) { return ((ph.Lf[j] + 1) / 2 + TK - 1) / TK; };
  auto load_unit = [&](int v, int slot) {
    int j = 0;
    while (v >= N_TILES * kt_of(j)) v -= N_TILES * kt_of(j++);
    const int kt = kt_of(j);
    mbar_expect_tx(full + slot, UNIT_BYTES);
    bulk_g2s(Bs + slot * UNIT,
             parts + ((static_cast<long long>(j) * N_TILES + v / kt) * Kt +
                      v % kt) * UNIT,
             UNIT_BYTES, full + slot);
  };
  int n_units = 0;
  for (int j = 0; j < up; ++j) n_units += N_TILES * kt_of(j);
  if (tid == 0) {
    for (int u = 0; u < ST && u < n_units; ++u) load_unit(u, u);
  }

  // the span, once, skewed; zero past its end
  if (nf > 0 && !kNoStage) {
    const float* src = xp + c * ldx + static_cast<long long>(b0) * hop;
    const int len = (nf - 1) * hop + Lf_max;
    if (vec) {
      for (int e = tw; e < (len + 3) / 4; e += 128) {
        const int p = 4 * e;
        cp_async16(span + skewed(p, sk), src + p, 4 * min(4, len - p));
      }
    } else {
      for (int p = tw; p < len; p += 128)
        cp_async_elem(span + skewed(p, sk), src + p, true);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  named_bar_sync(1 + wg, 128);

  // this thread's two fragment rows (rows past the tile read frame 0:
  // finite, never written)
  const int row0 = wq * 16 + g, row1 = row0 + 8;
  const int rstride = hop + sk * (hop >> 8);
  const float* s0p = span + (row0 < nf ? row0 : 0) * rstride;
  const float* s1p = span + (row1 < nf ? row1 : 0) * rstride;
  const long long out_row = static_cast<long long>(nb) * 2 * BH * up;

  // Accumulators of each operator: the big pair's partial of the fold in
  // flight (tensor cores), its folded sum hi (CUDA cores), and lo, into
  // which the tensor cores add the small pairs and the fold its errors
  float acc_e[KS][NR], acc_o[KS][NR], hi_e[NR], hi_o[NR], lo_e[NR],
      lo_o[NR];
  int u = 0;  // ring stage counter
  for (int j = 0; j < up; ++j) {
    const int Lf = ph.Lf[j];
    const int Hp = (Lf + 1) / 2;
    const int ktj = kt_of(j);
    for (int n = 0; n < N_TILES; ++n) {
      zero(hi_e);
      zero(hi_o);
      zero(lo_e);
      zero(lo_o);
      for (int t = 0; t < ktj; ++t) {
        const int slot = u % ST;
        mbar_wait(full + slot, (u / ST) & 1);
        const unsigned b_s = smem_u32(Bs + slot * UNIT);
#pragma unroll
        for (int f = 0; f < TK / FOLD; ++f) {
          const int lf = t * TK + f * FOLD;
          if (lf >= Hp) break;  // all padding: adds nothing
          // the fold's A fragments: z and w split into three bf16 sets
          // (and their errors), all written before its MMAs start
          uint32_t az[KS][3][4], aw[KS][3][4], ez[KS][4], ew[KS][4];
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const int l0 = lf + ks * 16 + 2 * tq;  // columns l0, l0+1 (+8)
            float2 a[4], r[4];
            if (lf + ks * 16 + 16 <= Hp) {
              const int sf = sk * ((lf + ks * 16) >> 8);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float* sp = (q & 1) ? s1p : s0p;
                const int l = l0 + 8 * (q >> 1);
                a[q] = *reinterpret_cast<const float2*>(sp + l + sf);
                if constexpr (kNoSym) {
                  r[q] = make_float2(0.0f, 0.0f);
                } else if ((Lf & 1) == 0) {
                  // (r[l+1], r[l]) at q-1, q = Lf-1-l: one 8-byte load
                  const int qq = Lf - 2 - l;
                  const float2 v =
                      *reinterpret_cast<const float2*>(sp + skewed(qq, sk));
                  r[q] = make_float2(v.y, v.x);
                } else {
                  const int qq = Lf - 1 - l;
                  r[q] = make_float2(sp[skewed(qq, sk)],
                                     sp[skewed(qq - 1, sk)]);
                }
              }
            } else {
              // the step that crosses Hp: rows past it are zero
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float* sp = (q & 1) ? s1p : s0p;
                const int l = l0 + 8 * (q >> 1);
                float v[2], w[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int lc = min(l + h, Hp - 1);
                  const float av = sp[skewed(lc, sk)];
                  const float rv = kNoSym ? 0.0f : sp[skewed(Lf - 1 - lc, sk)];
                  v[h] = l + h < Hp ? av : 0.0f;
                  w[h] = l + h < Hp ? rv : 0.0f;
                }
                a[q] = make_float2(v[0], v[1]);
                r[q] = make_float2(w[0], w[1]);
              }
            }
            float2 zv[4], wv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              zv[q] = make_float2(__fadd_rn(a[q].x, r[q].x),
                                  __fadd_rn(a[q].y, r[q].y));
              wv[q] = make_float2(__fsub_rn(a[q].x, r[q].x),
                                  __fsub_rn(a[q].y, r[q].y));
            }
            // each fragment row's grids (q even: row g, q odd: row g + 8),
            // from the whole quad: every lane runs these shuffles
            float mz[2], mw[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mz[h] = grid_magic<kNoSplit>(absmax4(zv[h], zv[h + 2]));
              mw[h] = grid_magic<kNoSplit>(absmax4(wv[h], wv[h + 2]));
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              split_grid<kNoSplit>(zv[q], mz[q & 1], az[ks][0][q],
                                   az[ks][1][q], az[ks][2][q]);
              split_grid<kNoSplit>(wv[q], mw[q & 1], aw[ks][0][q],
                                   aw[ks][1][q], aw[ks][2][q]);
              if constexpr (P == 4) {
                float s, ex, ey, fx, fy;
                two_sum(a[q].x, r[q].x, s, ex);
                two_sum(a[q].y, r[q].y, s, ey);
                two_sum(a[q].x, -r[q].x, s, fx);
                two_sum(a[q].y, -r[q].y, s, fy);
                ez[ks][q] = bits(__float22bfloat162_rn(make_float2(ex, ey)));
                ew[ks][q] = bits(__float22bfloat162_rn(make_float2(fx, fy)));
              }
            }
          }
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            reg_fence(acc_e[ks]);
            reg_fence(acc_o[ks]);
          }
          reg_fence(lo_e);
          reg_fence(lo_o);
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const unsigned kb = b_s + (f * KS + ks) * 32;
            const uint64_t e0 = desc_sw128(kb);
            const uint64_t o0 = desc_sw128(kb + P * SLICE * 2);
            Mma<TN>::run(acc_e[ks], az[ks][0], e0, 0);  // fresh each step
            Mma<TN>::run(acc_o[ks], aw[ks][0], o0, 0);
            if constexpr (!kNoSmall) {
              const uint64_t e1 = desc_sw128(kb + SLICE * 2);
              const uint64_t e2 = desc_sw128(kb + 2 * SLICE * 2);
              const uint64_t o1 = desc_sw128(kb + (P + 1) * SLICE * 2);
              const uint64_t o2 = desc_sw128(kb + (P + 2) * SLICE * 2);
              Mma<TN>::run(lo_e, az[ks][0], e1, 1);
              Mma<TN>::run(lo_o, aw[ks][0], o1, 1);
              Mma<TN>::run(lo_e, az[ks][1], e0, 1);
              Mma<TN>::run(lo_o, aw[ks][1], o0, 1);
              Mma<TN>::run(lo_e, az[ks][0], e2, 1);
              Mma<TN>::run(lo_o, aw[ks][0], o2, 1);
              Mma<TN>::run(lo_e, az[ks][1], e1, 1);
              Mma<TN>::run(lo_o, aw[ks][1], o1, 1);
              Mma<TN>::run(lo_e, az[ks][2], e0, 1);
              Mma<TN>::run(lo_o, aw[ks][2], o0, 1);
              if constexpr (P == 4) {
                Mma<TN>::run(lo_e, ez[ks], e0, 1);
                Mma<TN>::run(lo_o, ew[ks], o0, 1);
                Mma<TN>::run(lo_e, az[ks][0],
                             desc_sw128(kb + 3 * SLICE * 2), 1);
                Mma<TN>::run(lo_o, aw[ks][0],
                             desc_sw128(kb + (P + 3) * SLICE * 2), 1);
              }
            }
          }
          wg_commit();
          wg_wait0();
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            reg_fence(acc_e[ks]);
            reg_fence(acc_o[ks]);
          }
          reg_fence(lo_e);
          reg_fence(lo_o);
#pragma unroll
          for (int i = 0; i < NR; ++i) {
            // the fold's partial: its steps' sums added in float32
            float pe = acc_e[0][i], po = acc_o[0][i];
#pragma unroll
            for (int ks = 1; ks < KS; ++ks) {
              pe = __fadd_rn(pe, acc_e[ks][i]);
              po = __fadd_rn(po, acc_o[ks][i]);
            }
            if constexpr (kNoFold) {
              hi_e[i] = __fadd_rn(hi_e[i], pe);
              hi_o[i] = __fadd_rn(hi_o[i], po);
            } else {
              float s, e;
              two_sum(hi_e[i], pe, s, e);
              hi_e[i] = s;
              lo_e[i] = __fadd_rn(lo_e[i], e);
              two_sum(hi_o[i], po, s, e);
              hi_o[i] = s;
              lo_o[i] = __fadd_rn(lo_o[i], e);
            }
          }
        }
        // this warpgroup's wgmmas on the slot have completed; the second
        // warpgroup to get here refills it
        named_bar_sync(1 + wg, 128);
        if (tw == 0) {
          __threadfence_block();
          if (atomicAdd(freed + slot, 1) == 1) {
            freed[slot] = 0;
            __threadfence_block();
            if (u + ST < n_units) {
              asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
              load_unit(u + ST, slot);
            }
          }
        }
        ++u;
      }

      // both halves straight to their interleaved places: fragment jj
      // holds columns 8jj..8jj+7 of the tile, rows g and g+8 of the warp's
      // 16
#pragma unroll
      for (int jj = 0; jj < NR / 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          const int fr = (e >> 1) ? row1 : row0;
          const int tcol = n * TN + 8 * jj + 2 * tq + (e & 1);
          const float tp = __fadd_rn(lo_e[i], lo_o[i]);
          const float tm = __fsub_rn(lo_e[i], lo_o[i]);
          float s, er;
          two_sum(hi_e[i], hi_o[i], s, er);
          const float yp = __fadd_rn(s, __fadd_rn(er, tp));
          two_sum(hi_e[i], -hi_o[i], s, er);
          const float ym = __fadd_rn(s, __fadd_rn(er, tm));
          bool store = fr < nf;
          if constexpr (kNoStore)  // keep the values live, store nothing
            store = store && __float_as_uint(yp) == 0x7f800001u &&
                    __float_as_uint(ym) == 0x7f800001u;
          if (store) {
            float* yb = y + c * out_row +
                        static_cast<long long>(b0 + fr) * 2 * BH * up + j;
            yb[static_cast<long long>(tcol) * up] = yp;
            yb[static_cast<long long>(2 * BH - 1 - tcol) * up] = ym;
          }
        }
      }
    }
  }
}

// floats of a tile's skewed span of nf frames (its copies end on a
// 16-byte boundary)
inline int span_floats(int nf, int hop, int Lf_max, int sk) {
  const int len = (nf - 1) * hop + Lf_max + 3;
  return (len + sk * (len >> 8) + 3) / 4 * 4;
}

template <int P>
cudaError_t launch_split(cudaStream_t s, const float* xp, long long ldx,
                         const bf16* parts, int Kt, float* y, int C, int nb,
                         int hop, int up, int Lf_max, const Phases& ph) {
  // skew: SK * down = 8 (mod 32) puts a fragment's 8 rows on distinct
  // banks (down = hop / 256; a multiple of 4 keeps SK = 8, with conflicts)
  const int down = hop / 256;
  const int sk = (down & 3) == 2 ? 4 : 8;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  // the most frames a tile, then the deepest ring, that fit
  const size_t unit = size_t(2) * P * SLICE * 2;
  int nf_max = 0, ST = 0, span_f = 0;
  size_t smem = 0;
  for (int nf = NF; nf >= 1 && nf_max == 0; nf /= 2) {
    for (int st = 3; st >= 2; --st) {
      const int sf = span_floats(nf, hop, Lf_max, sk);
      const size_t b = st * unit + size_t(2) * sf * 4 + 2 * st * 8 + 1024;
      if (b <= static_cast<size_t>(max_smem)) {
        nf_max = nf;
        ST = st;
        span_f = sf;
        smem = b;
        break;
      }
    }
  }
  if (nf_max == 0) return cudaErrorInvalidValue;  // a frame too long
  const int n_tiles = (nb + nf_max - 1) / nf_max;
  const long long tiles = static_cast<long long>(C) * n_tiles;
  const long long blocks = (tiles + 1) / 2;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int vec = reinterpret_cast<uintptr_t>(xp) % 16 == 0 && ldx % 4 == 0;
  auto* kern = sym_split_kernel<P>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), NT, smem, s>>>(
      xp, ldx, parts, Kt, y, tiles, nb, hop, up, n_tiles, nf_max, span_f, sk,
      vec, ST, Lf_max, ph);
  return cudaGetLastError();
}

}  // namespace split

// ---------------------------------------------------------------------------
// float64: FMA on the CUDA cores

namespace f64 {

constexpr int BM = 32;    // frames (of one channel) a block
constexpr int BK = 16;    // operator rows a slab
constexpr int TM = 4;     // frames a thread
constexpr int TN = 4;     // columns a thread, of each of oe and oo
constexpr int NT = (BM / TM) * (BH / TN);  // 256 threads
constexpr int ZP = BM + 4;  // row pitch of the folded slab
static_assert(BH / TN == 32, "one warp spans the columns of TM frames");
static_assert(TM == 4 && TN == 4, "vector loads of four");

// operator slabs [2 stages][2 ops][BK][BH] + folded slabs [BK][ZP] (z, w)
constexpr size_t kFixed = size_t(2) * 2 * BK * BH + size_t(BK) * ZP * 2;

__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__global__ void __launch_bounds__(NT)
sym_conv_f64_kernel(const double* __restrict__ xp, long long ldx,
                    const double* __restrict__ ops, double* __restrict__ y,
                    int nb, int hop, int up, int Hp_max, int Lf_max,
                    int n_tiles, Phases ph) {
  constexpr int VEC = 2;  // doubles of one 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* opsS = reinterpret_cast<double*>(smem_raw);  // [2][2][BK][BH]
  double* zS = opsS + 2 * 2 * BK * BH;                 // [BK][ZP]
  double* wS = zS + BK * ZP;
  double* span = opsS + kFixed;

  const int tid = threadIdx.x;
  const int ty = tid / (BH / TN);  // the warp: frames ty*TM ...
  const int tx = tid % (BH / TN);  // columns tx*TN ...
  const long long c = blockIdx.x / n_tiles;
  const int b0 = static_cast<int>(blockIdx.x % n_tiles) * BM;
  const int nf = min(BM, nb - b0);
  const long long out_row = static_cast<long long>(nb) * 2 * BH * up;

  // the block's span, once: every phase reads its windows from it
  {
    const double* src = xp + c * ldx + static_cast<long long>(b0) * hop;
    const int len = (nf - 1) * hop + Lf_max;
    for (int e = tid; e < len; e += NT) cp_async_elem(span + e, src + e, true);
    cp_async_commit();
  }

  for (int j = 0; j < up; ++j) {
    const int Lf = ph.Lf[j];
    const int Hp = (Lf + 1) / 2;
    const double* te = ops + static_cast<size_t>(2 * j) * Hp_max * BH;
    const double* to = te + static_cast<size_t>(Hp_max) * BH;

    // slab [k0, k0 + BK) of Te, To into stage st
    auto load_ops = [&](int st, int k0) {
      for (int q = tid; q < BK * BH / VEC; q += NT) {
        const int kk = q / (BH / VEC);
        const int cc = (q % (BH / VEC)) * VEC;
        const int l = k0 + kk;
        const bool ok = l < Hp;
        const size_t off = ok ? static_cast<size_t>(l) * BH + cc : 0;
        double* dst = opsS + static_cast<size_t>(st * 2 * BK + kk) * BH + cc;
        cp_async16(dst, te + off, ok ? 16 : 0);
        cp_async16(dst + BK * BH, to + off, ok ? 16 : 0);
      }
      cp_async_commit();
    };

    double acc_e[TM][TN], acc_o[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int k = 0; k < TN; ++k) acc_e[i][k] = acc_o[i][k] = 0.0;
    }

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
        double zv = 0.0, wv = 0.0;
        if (l < Hp && i < nf) {
          const double a = span[i * hop + l];
          const double r = span[i * hop + Lf - 1 - l];
          zv = a + r;
          wv = a - r;
        }
        zS[kk * ZP + i] = zv;
        wS[kk * ZP + i] = wv;
      }
      __syncthreads();

      const double* oe_s = opsS + static_cast<size_t>(st * 2 * BK) * BH;
      const double* oo_s = oe_s + BK * BH;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        double z[TM], w[TM], a_e[TN], a_o[TN];
        ld4(zS + kk * ZP + ty * TM, z);
        ld4(wS + kk * ZP + ty * TM, w);
        ld4(oe_s + kk * BH + tx * TN, a_e);
        ld4(oo_s + kk * BH + tx * TN, a_o);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int k = 0; k < TN; ++k) {
            acc_e[i][k] = fma(z[i], a_e[k], acc_e[i][k]);
            acc_o[i][k] = fma(w[i], a_o[k], acc_o[i][k]);
          }
        }
      }
      // every warp is done with this stage before it is refilled
      __syncthreads();
    }

    // write both halves straight to their interleaved places
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int fi = ty * TM + i;
      if (fi >= nf) continue;
      double* yb = y + c * out_row +
                   static_cast<long long>(b0 + fi) * 2 * BH * up + j;
#pragma unroll
      for (int k = 0; k < TN; ++k) {
        const int t = tx * TN + k;
        yb[static_cast<long long>(t) * up] = acc_e[i][k] + acc_o[i][k];
        yb[static_cast<long long>(2 * BH - 1 - t) * up] =
            acc_e[i][k] - acc_o[i][k];
      }
    }
  }
}

cudaError_t launch(const double* xp, long long ldx, const double* ops,
                   double* y, int C, int nb, int hop, int up, int Hp_max,
                   int Lf_max, const Phases& ph, cudaStream_t s) {
  const int n_tiles = (nb + BM - 1) / BM;
  const long long blocks = static_cast<long long>(C) * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t span = static_cast<size_t>(BM - 1) * hop + Lf_max;
  const size_t smem = (kFixed + span) * sizeof(double);
  const cudaError_t e = cudaFuncSetAttribute(
      sym_conv_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  sym_conv_f64_kernel<<<static_cast<unsigned>(blocks), NT, smem, s>>>(
      xp, ldx, ops, y, nb, hop, up, Hp_max, Lf_max, n_tiles, ph);
  return cudaGetLastError();
}

}  // namespace f64

// the phases' frame lengths, checked; returns the longest, or 0
int read_phases(const int* Lf, int up, int rows, Phases& ph) {
  int Lf_max = 0;
  for (int j = 0; j < up; ++j) {
    if (Lf[j] < 1 || (Lf[j] + 1) / 2 > rows) return 0;
    ph.Lf[j] = Lf[j];
    Lf_max = Lf[j] > Lf_max ? Lf[j] : Lf_max;
  }
  return Lf_max;
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns the launch's cudaError_t.
// xp: [C, >= (nb-1)*hop + max Lf] float32 with row stride ldx elements;
// parts: the packed bf16 operators [up, 4, Kt, 2, n_parts, 32, 64]
// (ops/pallas_symconv.py::sym_parts; n_parts 3, or 4 under precision
// "high" with the residual slice); y: [C, nb*256*up]; hop: a multiple of
// 256; Lf: [up] frame lengths.
extern "C" int r8b_sym_conv_f32(const float* xp, long long ldx,
                                const void* parts, int n_parts, int Kt,
                                float* y, int C, int nb, int hop, int up,
                                const int* Lf, void* stream) {
  Phases ph{};
  if (C < 0 || nb < 1 || hop < 256 || hop % 256 || up < 1 || up > MAXP ||
      ldx < 0 || Kt < 1 || (n_parts != 3 && n_parts != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Lf_max = read_phases(Lf, up, Kt * split::TK, ph);
  if (Lf_max == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* pb = static_cast<const bf16*>(parts);
  const cudaError_t e =
      n_parts == 3
          ? split::launch_split<3>(s, xp, ldx, pb, Kt, y, C, nb, hop, up,
                                   Lf_max, ph)
          : split::launch_split<4>(s, xp, ldx, pb, Kt, y, C, nb, hop, up,
                                   Lf_max, ph);
  return static_cast<int>(e);
}

// xp: [C, >= (nb-1)*hop + max Lf] float64 with row stride ldx; ops: [up, 2,
// Hp_max, 128] (Te_j, To_j; rows past Hp_j are not read); y: [C,
// nb*256*up].
extern "C" int r8b_sym_conv_f64(const double* xp, long long ldx,
                                const double* ops, double* y, int C, int nb,
                                int hop, int up, int Hp_max, const int* Lf,
                                void* stream) {
  Phases ph{};
  if (C < 0 || nb < 1 || hop < 1 || up < 1 || up > MAXP || Hp_max < 1 ||
      ldx < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Lf_max = read_phases(Lf, up, Hp_max, ph);
  if (Lf_max == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  return static_cast<int>(f64::launch(xp, ldx, ops, y, C, nb, hop, up, Hp_max,
                                      Lf_max, ph,
                                      static_cast<cudaStream_t>(stream)));
}
