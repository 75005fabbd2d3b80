// Split-operand (Ozaki) framed matmul on the tensor cores, for sm_90a:
//
//     y[c, b*Kcols + k] = sum_{l < L_f} xp[c, b*hop + l] * T[l, k]
//
// computed error-free on a per-channel power-of-two grid.  Replaces all
// four TPU kernels of the reference package's r8brain_tpu/ops/
// pallas_ozaki.py (ozaki_matmul_pallas, _ozaki_matmul_pallas_var,
// ozaki_dense_pallas, ozaki_dense_pallas_pair: the bodies _make_kernel and
// _make_dense_kernel), which compute this one function at different
// argument sets.  Template flags: HAS_LO consumes the previous seam's
// bfloat16 residual x_lo (one more pass against slice 0); EMIT_PAIR writes
// the two_sum-normalized (hi float32, lo bfloat16) pair.
//
// What bounds it: operations.  At the 44.1k->96k conv stage (C=1024,
// n_blocks=174, L_f=964, Kcols=512) the 10 slice products are 1.75e12
// flop against 0.73 GB of compulsory traffic (~2400 flop per byte), far
// above the bf16 tensor-core ridge (~295 flop per byte); so the products
// go to the tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32).
//
// Exactness.  Each x value is split on the grid of its channel's power of
// two sx into 4 slices of <= 8 significant bits (|integer| <= 256), each
// exact in bf16; the operator comes pre-split per column.  A slice-pair
// product is an integer < 2^16 on a common grid per (row, column), and a
// sum of <= K0 = 256 of them stays <= 2^24, so its float32 accumulation is
// exact as long as the accumulator keeps 24 bits (chip_smoke.py pins this
// for mma.sync on the card with mma_dot).  Every (p, q) pair therefore
// gets one fresh accumulator per K0-deep chunk; after each chunk the 10
// exact chunk results are folded in the reference's order (chunk, then p,
// then q): d = p+q = 0 by two_sum into (hi, lo), d >= 1 added into rest.
// The arithmetic outside the products uses __f*_rn intrinsics, so nothing
// is contracted or reassociated (the build has no --use_fast_math).
//
// Design (a first, simple kernel; wgmma, TMA and deeper pipelining are
// later work):
//   * Rows r = c*n_blocks + b of an implicit im2col matrix A[r, l] =
//     xp[c, b*hop + l] (64-bit row starts, any alignment, any hop),
//     against T [L_f, Kcols].  A block computes a BM x BN tile of y, which
//     is exactly the [C, n_blocks*Kcols] row-major layout.
//   * Per BK-deep slab, the block loads its x window slab (float32) and
//     the 4 operator slices (bf16) into registers, splits x into 4 bf16
//     slices, and stores everything to shared memory; two stages, so the
//     next slab's global loads are in flight while this slab multiplies.
//     The ragged edges in rows, l and Kcols are zero-filled.
//   * 8 warps, each a 16 x 16 piece of the tile: per 16-deep step it
//     loads the 4 x-slice fragments and 4 operator-slice fragments with
//     ldmatrix and issues the 10 pair products (x 2 n8 fragments) into
//     their own accumulators, plus the x_lo product under HAS_LO.
//   * The output combine runs in registers: one float32 store (and one
//     bf16 store when EMIT_PAIR).
// The plain PyTorch model of this exact split, chunking and fold is
// r8brain_torch/ops/pallas_ozaki.py::ozaki_framed_ref.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int N_PARTS = 4;
constexpr int N_DIAG = 4;
constexpr int N_PAIRS = 10;  // (p, q) with p + q < N_DIAG
constexpr int K0 = 256;
constexpr int BM = 64, BN = 32, BK = 32;
constexpr int NT = 256;           // 8 warps: 4 along rows x 2 along columns
constexpr int LDA = BK + 8;       // bf16 row pitch of an x-slice tile
constexpr int LDB = BN + 8;       // bf16 row pitch of an operator tile
constexpr int S_X = N_PARTS * BM * LDA;
constexpr int S_T = N_PARTS * BK * LDB;
constexpr int S_L = BM * LDA;
static_assert(K0 % BK == 0 && BK % 16 == 0, "slabs tile the chunks");
static_assert((LDA * 2) % 16 == 0 && (LDB * 2) % 16 == 0, "ldmatrix rows");

template <bool HAS_LO>
struct Smem {
  static constexpr int stage = S_X + S_T + (HAS_LO ? S_L : 0);  // elements
  static constexpr size_t head = BM * (2 * sizeof(long long) + 2 * sizeof(float));
  static constexpr size_t bytes = head + 2 * stage * sizeof(bf16);
};

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool HAS_LO, bool EMIT_PAIR>
__global__ void __launch_bounds__(NT, 1)
ozaki_framed_kernel(const float* __restrict__ xp, long long ldx,
                    const float* __restrict__ sx, const bf16* __restrict__ T,
                    const bf16* __restrict__ xl, long long ldxl,
                    float* __restrict__ y, bf16* __restrict__ yl, long long R,
                    int n_blocks, int hop, int L_f, int Kcols,
                    int n_col_tiles) {
  using S = Smem<HAS_LO>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_base = reinterpret_cast<long long*>(smem_raw);  // [BM]
  long long* row_base_lo = row_base + BM;                          // [BM]
  float* row_inv = reinterpret_cast<float*>(row_base_lo + BM);     // [BM]
  float* row_sx = row_inv + BM;                                    // [BM]
  bf16* stages = reinterpret_cast<bf16*>(smem_raw + S::head);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // 16-row piece of the tile
  const int wn = warp >> 2;  // 16-column piece of the tile
  const long long tile = blockIdx.x;
  const int j0 = static_cast<int>(tile % n_col_tiles) * BN;
  const long long r0 = (tile / n_col_tiles) * BM;

  for (int i = tid; i < BM; i += NT) {
    const long long r = r0 + i;
    if (r < R) {
      const long long c = r / n_blocks;
      const long long b = r - c * n_blocks;
      row_base[i] = c * ldx + b * hop;
      row_base_lo[i] = c * ldxl + b * hop;
      const float s = sx[c];
      row_sx[i] = s;
      row_inv[i] = __fdiv_rn(1.0f, s);  // exact: s is a power of two
    } else {
      row_base[i] = -1;
      row_base_lo[i] = -1;
      row_sx[i] = 1.0f;
      row_inv[i] = 1.0f;
    }
  }
  __syncthreads();

  // register staging of one slab: each thread moves pairs of neighbouring
  // elements (coalesced along l for x, along k for T)
  constexpr int XP = BM * BK / 2 / NT;            // x (and x_lo) pairs
  constexpr int TP = N_PARTS * BK * BN / 2 / NT;  // operator pairs
  float xr[XP][2];
  bf16 lr[HAS_LO ? XP : 1][2];
  bf16 tr[TP][2];
  const bf16 zero = __float2bfloat16_rn(0.0f);

  auto load_regs = [&](int d0) {
#pragma unroll
    for (int it = 0; it < XP; ++it) {
      const int e2 = it * NT + tid;
      const int i = e2 / (BK / 2);
      const int l = d0 + 2 * (e2 % (BK / 2));
      const long long base = row_base[i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = base >= 0 && l + h < L_f;
        xr[it][h] = ok ? xp[base + l + h] : 0.0f;
        if constexpr (HAS_LO)
          lr[it][h] = ok ? xl[row_base_lo[i] + l + h] : zero;
      }
    }
#pragma unroll
    for (int it = 0; it < TP; ++it) {
      const int e2 = it * NT + tid;
      const int q = e2 / (BK * BN / 2);
      const int rem = e2 % (BK * BN / 2);
      const int l = d0 + rem / (BN / 2);
      const int j = j0 + 2 * (rem % (BN / 2));
      const long long row = (static_cast<long long>(q) * L_f + l) * Kcols;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        tr[it][h] = (l < L_f && j + h < Kcols) ? T[row + j + h] : zero;
    }
  };

  // split the staged x into its 4 bf16 slices (the reference kernel's
  // arithmetic: multiply by 1/sx, then per slice round-half-even of
  // r * 256^(p+1), times 2^-8(p+1), residual r - q; every step exact)
  auto store_smem = [&](bf16* st) {
    bf16* xs = st;
    bf16* ts = st + S_X;
#pragma unroll
    for (int it = 0; it < XP; ++it) {
      const int e2 = it * NT + tid;
      const int i = e2 / (BK / 2);
      const int kk = 2 * (e2 % (BK / 2));
      const float inv = row_inv[i];
      float v0 = __fmul_rn(xr[it][0], inv);
      float v1 = __fmul_rn(xr[it][1], inv);
      float up = 256.0f, step = 0.00390625f;
#pragma unroll
      for (int p = 0; p < N_PARTS; ++p) {
        const float q0 = __fmul_rn(rintf(__fmul_rn(v0, up)), step);
        const float q1 = __fmul_rn(rintf(__fmul_rn(v1, up)), step);
        *reinterpret_cast<__nv_bfloat162*>(xs + (p * BM + i) * LDA + kk) =
            __floats2bfloat162_rn(q0, q1);
        v0 = __fsub_rn(v0, q0);
        v1 = __fsub_rn(v1, q1);
        up *= 256.0f;
        step *= 0.00390625f;
      }
      if constexpr (HAS_LO)
        *reinterpret_cast<__nv_bfloat162*>(st + S_X + S_T + i * LDA + kk) =
            __halves2bfloat162(lr[it][0], lr[it][1]);
    }
#pragma unroll
    for (int it = 0; it < TP; ++it) {
      const int e2 = it * NT + tid;
      const int q = e2 / (BK * BN / 2);
      const int rem = e2 % (BK * BN / 2);
      const int kk = rem / (BN / 2);
      const int jj = 2 * (rem % (BN / 2));
      *reinterpret_cast<__nv_bfloat162*>(ts + (q * BK + kk) * LDB + jj) =
          __halves2bfloat162(tr[it][0], tr[it][1]);
    }
  };

  float acc[N_PAIRS][2][4];
  float accl[2][4];
  float hi[2][4], lo[2][4], rest[2][4], cheap[2][4];
#pragma unroll
  for (int nf = 0; nf < 2; ++nf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int k = 0; k < N_PAIRS; ++k) acc[k][nf][e] = 0.0f;
      accl[nf][e] = hi[nf][e] = lo[nf][e] = rest[nf][e] = cheap[nf][e] = 0.0f;
    }
  }

  const int n_slabs = (L_f + BK - 1) / BK;
  load_regs(0);
  store_smem(stages);
  __syncthreads();
  for (int t = 0; t < n_slabs; ++t) {
    const bf16* st = stages + (t & 1) * S::stage;
    if (t + 1 < n_slabs) load_regs((t + 1) * BK);

#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[N_PARTS][4], b[N_PARTS][4];
#pragma unroll
      for (int p = 0; p < N_PARTS; ++p)
        ldmatrix_x4(a[p], st + (p * BM + wm * 16 + (lane & 15)) * LDA +
                              ks * 16 + (lane >> 4) * 8);
      // b[q]: {k 0-7, k 8-15} of n8 fragment 0, then of fragment 1
#pragma unroll
      for (int q = 0; q < N_PARTS; ++q)
        ldmatrix_x4_trans(
            b[q], st + S_X +
                      (q * BK + ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                          LDB +
                      wn * 16 + (lane >> 4) * 8);
      int k = 0;
#pragma unroll
      for (int p = 0; p < N_PARTS; ++p) {
#pragma unroll
        for (int q = 0; q < N_DIAG - p; ++q) {
#pragma unroll
          for (int nf = 0; nf < 2; ++nf)
            mma_16816(acc[k][nf], a[p], b[q][2 * nf], b[q][2 * nf + 1]);
          ++k;
        }
      }
      if constexpr (HAS_LO) {
        uint32_t al[4];
        ldmatrix_x4(al, st + S_X + S_T + (wm * 16 + (lane & 15)) * LDA +
                            ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nf = 0; nf < 2; ++nf)
          mma_16816(accl[nf], al, b[0][2 * nf], b[0][2 * nf + 1]);
      }
    }

    if (t + 1 < n_slabs)
      store_smem(stages + ((t + 1) & 1) * S::stage);

    // end of a K0-deep chunk (or of L_f): fold its exact pair results
    if (((t + 1) * BK) % K0 == 0 || t + 1 == n_slabs) {
      int k = 0;
#pragma unroll
      for (int p = 0; p < N_PARTS; ++p) {
#pragma unroll
        for (int q = 0; q < N_DIAG - p; ++q) {
#pragma unroll
          for (int nf = 0; nf < 2; ++nf) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float o = acc[k][nf][e];
              if (p + q == 0) {
                float s, err;
                two_sum(hi[nf][e], o, s, err);
                hi[nf][e] = s;
                lo[nf][e] = __fadd_rn(lo[nf][e], err);
              } else {
                rest[nf][e] = __fadd_rn(rest[nf][e], o);
              }
              acc[k][nf][e] = 0.0f;
            }
          }
          ++k;
        }
      }
      if constexpr (HAS_LO) {
#pragma unroll
        for (int nf = 0; nf < 2; ++nf) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            cheap[nf][e] = __fadd_rn(cheap[nf][e], accl[nf][e]);
            accl[nf][e] = 0.0f;
          }
        }
      }
    }
    __syncthreads();
  }

  // output combines of the reference kernel (pallas_ozaki.py:141-154)
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nf = 0; nf < 2; ++nf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = wm * 16 + g + (e >> 1) * 8;
      const long long r = r0 + i;
      const int j = j0 + wn * 16 + nf * 8 + tq * 2 + (e & 1);
      if (r >= R || j >= Kcols) continue;
      const float s = row_sx[i];
      const float small = __fadd_rn(lo[nf][e], rest[nf][e]);
      const long long o = r * Kcols + j;
      if constexpr (!EMIT_PAIR) {
        if constexpr (HAS_LO)
          y[o] = __fadd_rn(__fmul_rn(hi[nf][e], s),
                           __fadd_rn(__fmul_rn(small, s), cheap[nf][e]));
        else
          y[o] = __fmul_rn(__fadd_rn(hi[nf][e], small), s);
      } else {
        float sm = __fmul_rn(small, s);
        if constexpr (HAS_LO) sm = __fadd_rn(sm, cheap[nf][e]);
        float H, L;
        two_sum(__fmul_rn(hi[nf][e], s), sm, H, L);
        y[o] = H;
        yl[o] = __float2bfloat16_rn(L);
      }
    }
  }
}

template <bool HAS_LO, bool EMIT_PAIR>
cudaError_t launch_one(unsigned blocks, cudaStream_t s, const float* xp,
                       long long ldx, const float* sx, const bf16* T,
                       const bf16* xl, long long ldxl, float* y, bf16* yl,
                       long long R, int n_blocks, int hop, int L_f, int Kcols,
                       int n_col) {
  constexpr size_t smem = Smem<HAS_LO>::bytes;
  auto* kern = ozaki_framed_kernel<HAS_LO, EMIT_PAIR>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<blocks, NT, smem, s>>>(xp, ldx, sx, T, xl, ldxl, y, yl, R, n_blocks,
                                hop, L_f, Kcols, n_col);
  return cudaGetLastError();
}

// One warp per 16 x 8 output tile, fragments straight from global memory,
// one float32 accumulator over all of K in 16-deep mma steps.
__global__ void mma_dot_kernel(const bf16* __restrict__ a,
                               const bf16* __restrict__ b,
                               float* __restrict__ out, int M, int N, int K) {
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * 16, n0 = blockIdx.x * 8;
  const int g = lane >> 2, tq = lane & 3;
  auto A = [&](int m, int k) {
    return (m < M && k < K) ? a[static_cast<long long>(m) * K + k]
                            : __float2bfloat16_rn(0.0f);
  };
  auto B = [&](int k, int n) {
    return (k < K && n < N) ? b[static_cast<long long>(k) * N + n]
                            : __float2bfloat16_rn(0.0f);
  };
  auto pack = [](bf16 lo, bf16 hi) {
    __nv_bfloat162 v = __halves2bfloat162(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  };
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int kc = k0 + tq * 2;
    uint32_t af[4] = {pack(A(m0 + g, kc), A(m0 + g, kc + 1)),
                      pack(A(m0 + g + 8, kc), A(m0 + g + 8, kc + 1)),
                      pack(A(m0 + g, kc + 8), A(m0 + g, kc + 9)),
                      pack(A(m0 + g + 8, kc + 8), A(m0 + g + 8, kc + 9))};
    const uint32_t b0 = pack(B(kc, n0 + g), B(kc + 1, n0 + g));
    const uint32_t b1 = pack(B(kc + 8, n0 + g), B(kc + 9, n0 + g));
    mma_16816(d, af, b0, b1);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = m0 + g + (e >> 1) * 8, n = n0 + tq * 2 + (e & 1);
    if (m < M && n < N) out[static_cast<long long>(m) * N + n] = d[e];
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns the launch's cudaError_t.
// xp: [C, >= (n_blocks-1)*hop + L_f] float32, row stride ldx; sx: [C]
// float32 powers of two; T: [4, L_f, Kcols] bf16 row-major; xl (may be
// null): bf16, row stride ldxl; y: [C, n_blocks*Kcols] float32; yl (null
// unless the pair is wanted): [C, n_blocks*Kcols] bf16.
extern "C" int r8b_ozaki_framed(const float* xp, long long ldx,
                                const float* sx, const void* T, const void* xl,
                                long long ldxl, float* y, void* yl, int C,
                                int n_blocks, int hop, int L_f, int Kcols,
                                void* stream) {
  if (C < 0 || n_blocks < 1 || hop < 1 || L_f < 1 || Kcols < 1 || ldx < 0 ||
      ldxl < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long R = static_cast<long long>(C) * n_blocks;
  if (R == 0) return 0;
  const int n_col = (Kcols + BN - 1) / BN;
  const long long blocks = ((R + BM - 1) / BM) * n_col;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const bf16* Tb = static_cast<const bf16*>(T);
  const bf16* xlb = static_cast<const bf16*>(xl);
  bf16* ylb = static_cast<bf16*>(yl);
  cudaError_t e;
  if (xl != nullptr && yl != nullptr)
    e = launch_one<true, true>(nb, s, xp, ldx, sx, Tb, xlb, ldxl, y, ylb, R,
                               n_blocks, hop, L_f, Kcols, n_col);
  else if (xl != nullptr)
    e = launch_one<true, false>(nb, s, xp, ldx, sx, Tb, xlb, ldxl, y, ylb, R,
                                n_blocks, hop, L_f, Kcols, n_col);
  else if (yl != nullptr)
    e = launch_one<false, true>(nb, s, xp, ldx, sx, Tb, xlb, ldxl, y, ylb, R,
                                n_blocks, hop, L_f, Kcols, n_col);
  else
    e = launch_one<false, false>(nb, s, xp, ldx, sx, Tb, xlb, ldxl, y, ylb, R,
                                 n_blocks, hop, L_f, Kcols, n_col);
  return static_cast<int>(e);
}

// out [M, N] float32 = a [M, K] @ b [K, N] (bf16, row-major) through
// mma.sync with one float32 accumulator per output: the lemma probe.
extern "C" int r8b_ozaki_mma_dot(const void* a, const void* b, float* out,
                                 int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + 7) / 8, (M + 15) / 16);
  mma_dot_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
