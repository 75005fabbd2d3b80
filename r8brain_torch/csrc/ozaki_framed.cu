// Split-operand (Ozaki) framed matmul on Hopper's tensor cores (wgmma),
// for sm_90a:
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
// n_blocks=174, L_f=964, Kcols=512) the 10 slice products over the banded
// operator's nonzeros are 1.25e12 flop against 0.73 GB of compulsory
// traffic, far above the bf16 tensor-core ridge (~295 flop per byte).
//
// Exactness.  Each x value is split on the grid of its channel's power of
// two sx into 4 slices of <= 8 significant bits (|integer| <= 256), each
// exact in bf16; the operator comes pre-split per column.  A slice-pair
// product is an integer < 2^16 on a common grid per (row, column), and
// every partial sum of <= K0 = 256 of them is an integer <= 2^24, exact in
// float32 whatever the order or the rounding of the accumulator
// (chip_smoke.py pins this on the card for this kernel's wgmma chain and
// for mma.sync).  So each (p, q) chunk value o_pq is the same in any order
// of computation, and what fixes the output bits is only the fold: after
// each K0-deep chunk, in the reference's order (p, then q), d = p+q = 0 by
// two_sum into (hi, lo), d >= 1 added into rest.  The arithmetic outside
// the products uses __f*_rn intrinsics, so nothing is contracted or
// reassociated (the build has no --use_fast_math).
//
// Design:
//   * Rows r = c*n_blocks + b of an implicit im2col matrix A[r, l] =
//     xp[c, b*hop + l] (64-bit row starts, any alignment, any hop),
//     against T [L_f, Kcols].  A block is two warpgroups of 64 rows and
//     one 32-column tile: a 128 x 32 tile of y, which is exactly the [C,
//     n_blocks*Kcols] row-major layout.  The grid walks (row tile, column
//     tile) with the column tile fastest, so the blocks of a row tile
//     share its windows in L2.
//   * The operator is packed on the host, once, by its executor
//     (pallas_ozaki.pack_operator): per (column tile, 64-deep k-tile) one
//     contiguous 16 KB block [slice 0 | slice 1 | slice 2 | slice 3], each
//     slice a K-major [32, 64] bf16 tile, 128-byte swizzled.  Thread 0
//     moves a k-tile with one TMA bulk copy into an mbarrier ring.  The
//     four slices stacked are one K-major [128, 64] operand, so
//
//         A_0 x [s0|s1|s2|s3]   (m64n128k16: pairs (0,0)..(0,3))
//         A_1 x [s0|s1|s2]      (m64n96k16:  pairs (1,0)..(1,2))
//         A_2 x [s0|s1]         (m64n64k16:  pairs (2,0), (2,1))
//         A_3 x [s0]            (m64n32k16:  pair  (3,0))
//
//     read B through one descriptor: four wgmmas a k16 step make all 10
//     pairs, 320 columns of product for every split input fragment.  A
//     k-tile is read only where the column tile's operator has nonzeros:
//     the packing records each column tile's first and last nonzero
//     k-tile (the conv operator is banded), and the kernel skips the rest,
//     which leaves out exact zeros only.
//   * A from registers: each warpgroup stages its 64 rows of a k-tile in
//     float32 with cp.async (16-byte copies where xp, hop and the row
//     stride allow, else 8- or 4-byte), rows padded to 72 floats so that
//     the fragment reads are free of bank conflicts, behind a named
//     barrier; each thread splits its fragment into the four bf16 slice
//     fragments in registers (float adds of magic constants, see split4),
//     once for all 10 pairs.  Two k16 steps are split, then their eight
//     wgmmas issued and waited for: all of a batch's input registers are
//     written before its wgmmas start (ptxas keeps them asynchronous).
//   * The 10 chunk accumulators (160 floats a thread) live in registers;
//     hi, lo and rest (and cheap under HAS_LO) live in shared memory, a
//     float4 per thread and four elements, touched once a chunk by the
//     fold.
//   * Where the time goes (tools/torch_ozaki_ablation.py, PERF.md): at
//     the conv shape the wgmmas alone take about 55 % of the kernel's
//     time; staging the windows and splitting them add most of the rest,
//     and do not hide under the other warpgroup's wgmmas.
//   * x_lo (HAS_LO, off the resampler's main paths) is read straight
//     from global memory into its fragment, a bf16 at a time, and
//     multiplied against slice 0 (m64n32k16) into its own chunk
//     accumulator, which the fold adds into cheap.
//   * The output combine runs in registers: one float32 store (and one
//     bf16 store when EMIT_PAIR).
// The plain PyTorch model of this exact split, chunking and fold is
// r8brain_torch/ops/pallas_ozaki.py::ozaki_framed_ref.
//
// r8b_ozaki_wgmma_dot is the lemma probe of this kernel's own wgmma path
// (A from registers, the packed operator through a bulk copy, 16 k16
// steps chained into one accumulator); r8b_ozaki_mma_dot the one of
// mma.sync.

#include <climits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int N_PARTS = 4;
constexpr int K0 = 256;
constexpr int BM = 128;             // rows a block: two warpgroups of 64
constexpr int BN = 32;              // columns a tile, of each slice
constexpr int TK = 64;              // l a k-tile (one 128-byte bf16 row)
constexpr int KT_CHUNK = K0 / TK;   // k-tiles a chunk
constexpr int APITCH = TK + 8;      // floats a staged row: 8 mod 32 banks
constexpr int ST = 3;               // k-tiles in flight
constexpr int NT = 256;             // two warpgroups
constexpr int NR = BN / 2;          // accumulator floats a thread, a slice
constexpr int B_STAGE = N_PARTS * BN * TK * 2;  // bytes of a packed k-tile
constexpr int A_STAGE = BM * APITCH;            // floats of a staged k-tile
static_assert(K0 % TK == 0, "k-tiles tile the chunks");
static_assert((BN * TK * 2) % 1024 == 0, "swizzle atoms are 1 KB");

// Ablation, for tools/torch_ozaki_ablation.py only: a build with
// -DR8B_ABLATE=mask drops parts of the work (its output is then wrong) so
// that the rest can be timed.  Bits: 1 the fold (the 10 pair values added
// into hi, no two_sum, in no order), 2 the
// split (all four slices are bf16(x)), 4 the small pairs (only the
// A_0 x [s0|s1|s2|s3] wgmma), 8 the input staging, 16 the banded k-tile
// skip (every k-tile is read).
#ifndef R8B_ABLATE
#define R8B_ABLATE 0
#endif
constexpr bool kNoFold = R8B_ABLATE & 1;
constexpr bool kNoSplit = R8B_ABLATE & 2;
constexpr bool kNoSmall = R8B_ABLATE & 4;
constexpr bool kNoStage = R8B_ABLATE & 8;
constexpr bool kNoSkip = R8B_ABLATE & 16;

// k16 steps a thread splits before it issues their wgmmas and waits for
// them: two (one at a time was slower), one under HAS_LO, whose 255
// registers hold no second step's A fragments
template <bool HAS_LO>
constexpr int kSteps = HAS_LO ? 1 : 2;

// shared memory: the operator ring, the staged rows, the fold state
// (hi, lo, rest and under HAS_LO cheap: [state][NR][NT] floats), the
// full and empty barriers, the rows' starts, reciprocals and scales
template <bool HAS_LO>
struct Smem {
  static constexpr int n_state = HAS_LO ? 4 : 3;
  static constexpr size_t a_off = ST * B_STAGE;
  static constexpr size_t s_off = a_off + ST * A_STAGE * 4;
  static constexpr size_t bar_off = s_off + n_state * NR * NT * 4;
  static constexpr size_t row_off = bar_off + 2 * ST * 8;
  static constexpr size_t bytes = row_off + BM * (2 * 8 + 2 * 4) + 1024;
};

// The four slices of a float pair already divided by the channel's scale,
// as packed fragment registers a[p][k] (the lower column in the low half):
// the reference kernel's slices, round-half-even of r to the grid
// 2^-8(p+1) with residual r - q.  Adding M_p = 1.5 * 2^(15-8p) rounds r to
// that grid, half to even (|r| < 2^(14-8p)), and subtracting it is exact,
// so every step is exact and runs at the full rate of float adds (rintf
// is a conversion, a quarter of it).  A slice has <= 8 significant bits,
// so its bf16 is the top half of its float32: one byte permute a pair.
__device__ __forceinline__ void split4(float v0, float v1,
                                       uint32_t (&a)[N_PARTS][4], int k) {
  if constexpr (kNoSplit) {
    const uint32_t u = bits(__floats2bfloat162_rn(v0, v1));
#pragma unroll
    for (int p = 0; p < N_PARTS; ++p) a[p][k] = u;
    return;
  }
  constexpr float M[N_PARTS] = {49152.0f, 192.0f, 0.75f, 0.0029296875f};
#pragma unroll
  for (int p = 0; p < N_PARTS; ++p) {
    const float q0 = __fsub_rn(__fadd_rn(v0, M[p]), M[p]);
    const float q1 = __fsub_rn(__fadd_rn(v1, M[p]), M[p]);
    a[p][k] = __byte_perm(__float_as_uint(q0), __float_as_uint(q1), 0x7632);
    if (p + 1 < N_PARTS) {
      v0 = __fsub_rn(v0, q0);
      v1 = __fsub_rn(v1, q1);
    }
  }
}

template <bool HAS_LO, bool EMIT_PAIR>
__global__ void __launch_bounds__(NT, 1)
ozaki_framed_kernel(const float* __restrict__ xp, long long ldx,
                    const float* __restrict__ sx,
                    const bf16* __restrict__ tiles,
                    const int* __restrict__ bands,
                    const bf16* __restrict__ xl, long long ldxl,
                    float* __restrict__ y, bf16* __restrict__ yl, long long R,
                    int n_blocks, int hop, int L_f, int Kcols, int n_ct,
                    int n_kt, int vec) {
  using S = Smem<HAS_LO>;
  constexpr int KS = kSteps<HAS_LO>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment (offset kept on smem_raw so
  // that the compiler still sees shared-memory accesses)
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Bs = reinterpret_cast<bf16*>(base);                   // [ST][4][BN][TK]
  float* As = reinterpret_cast<float*>(base + S::a_off);      // [ST][BM][APITCH]
  // [n_state][NR / 4][NT] float4
  float4* state = reinterpret_cast<float4*>(base + S::s_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::bar_off);
  uint64_t* empty = full + ST;
  long long* row_base = reinterpret_cast<long long*>(base + S::row_off);
  long long* row_base_lo = row_base + BM;
  float* row_inv = reinterpret_cast<float*>(row_base_lo + BM);
  float* row_sx = row_inv + BM;
  // a 16-byte-aligned source for copies that read nothing
  const float* zsrc = reinterpret_cast<const float*>(tiles);

  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const int ct = static_cast<int>(tile % n_ct);
  const long long r0 = (tile / n_ct) * BM;
  // the column tile's nonzero k-tiles [kb, ke): the rest multiply zeros
  int kb = 0, ke = n_kt;
  if constexpr (!kNoSkip) {
    kb = bands[2 * ct];
    ke = bands[2 * ct + 1];
  }
  const int n_t = ke - kb;

  if (tid < BM) {
    const long long r = r0 + tid;
    if (r < R) {
      const long long c = r / n_blocks;
      const long long b = r - c * n_blocks;
      row_base[tid] = c * ldx + b * hop;
      row_base_lo[tid] = c * ldxl + b * hop;
      const float s = sx[c];
      row_sx[tid] = s;
      row_inv[tid] = __fdiv_rn(1.0f, s);  // exact: s is a power of two
    } else {
      row_base[tid] = -1;
      row_base_lo[tid] = -1;
      row_sx[tid] = 1.0f;
      row_inv[tid] = 1.0f;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#pragma unroll
  for (int i = 0; i < S::n_state * NR / 4; ++i)
    state[i * NT + tid] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  // thread 0 moves the operator: one bulk copy a k-tile into its slot, the
  // first ST now, each later one once both warpgroups freed the slot
  constexpr int B_ELEMS = B_STAGE / 2;
  const bf16* b_src =
      tiles + (static_cast<long long>(ct) * n_kt + kb) * B_ELEMS;
  auto load_b = [&](int u) {
    const int slot = u % ST;
    mbar_expect_tx(full + slot, B_STAGE);
    bulk_g2s(Bs + slot * B_ELEMS, b_src + static_cast<long long>(u) * B_ELEMS,
             B_STAGE, full + slot);
  };
  if (tid == 0) {
    for (int u = 0; u < ST && u < n_t; ++u) load_b(u);
  }

  const int wg = tid >> 7, tw = tid & 127;
  const int wq = tw >> 5, lane = tw & 31, g = lane >> 2, tq = lane & 3;
  const long long* rb = row_base + wg * 64;
  float* Aw = As + wg * 64 * APITCH;

  // this warpgroup's 64 rows of the u-th k-tile into its slot, zero past
  // L_f and R: warp wq stages rows 16wq..16wq+15, one row (two with
  // 16-byte copies) an instruction, 8-byte copies on rows whose start is
  // 8-byte aligned
  auto stage_a = [&](int u) {
    if constexpr (kNoStage) return;
    float* dst = Aw + (u % ST) * A_STAGE;
    const int d0 = (kb + u) * TK;
    if (vec) {
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int i = wq * 16 + it * 2 + (lane >> 4);
        const int d = d0 + 4 * (lane & 15);
        const long long b = rb[i];
        const int n = b < 0 ? 0 : max(0, min(4, L_f - d));
        cp_async16(dst + i * APITCH + 4 * (lane & 15),
                   n > 0 ? xp + b + d : zsrc, 4 * n);
      }
    } else {
      const int d = d0 + 2 * lane;
#pragma unroll 4
      for (int it = 0; it < 16; ++it) {
        const int i = wq * 16 + it;
        const long long b = rb[i];
        const int n = b < 0 ? 0 : max(0, min(2, L_f - d));
        float* to = dst + i * APITCH + 2 * lane;
        if (b >= 0 && (reinterpret_cast<uintptr_t>(xp + b + d0) & 7) == 0) {
          cp_async8(to, n > 0 ? xp + b + d : zsrc, 4 * n);
        } else {
          cp_async_elem(to, n > 0 ? xp + b + d : zsrc, n > 0);
          cp_async_elem(to + 1, n > 1 ? xp + b + d + 1 : zsrc, n > 1);
        }
      }
    }
  };

  // the chunk accumulators of the four passes (pairs (p, q) at column
  // block q of acc_p) and, under HAS_LO, of the x_lo pass
  float acc0[4 * NR], acc1[3 * NR], acc2[2 * NR], acc3[NR];
  float accl[HAS_LO ? NR : 1];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    acc0[i] = acc0[NR + i] = acc0[2 * NR + i] = acc0[3 * NR + i] = 0.0f;
    acc1[i] = acc1[NR + i] = acc1[2 * NR + i] = 0.0f;
    acc2[i] = acc2[NR + i] = acc3[i] = 0.0f;
    if constexpr (HAS_LO) accl[i] = 0.0f;
  }

  // the fold of a chunk's exact pair values, in the reference's order:
  // (0,0) by two_sum into (hi, lo); (0,1), (0,2), (0,3), (1,0), (1,1),
  // (1,2), (2,0), (2,1), (3,0) added into rest; x_lo's into cheap
  auto fold = [&]() {
    constexpr int Q = NR / 4;  // float4s of one state a thread
#pragma unroll
    for (int i4 = 0; i4 < Q; ++i4) {
      float4* st = state + i4 * NT + tid;
      float4 h4 = st[0], l4 = st[Q * NT], r4 = st[2 * Q * NT];
      float* hi = &h4.x;
      float* lo = &l4.x;
      float* rest = &r4.x;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * i4 + c;
        if constexpr (kNoFold) {  // plain adds, no two_sum, no order
          hi[c] += ((acc0[i] + acc0[NR + i]) + (acc0[2 * NR + i] +
                    acc0[3 * NR + i])) + ((acc1[i] + acc1[NR + i]) +
                    (acc1[2 * NR + i] + acc2[i])) + (acc2[NR + i] + acc3[i]);
        } else {
          float s, e;
          two_sum(hi[c], acc0[i], s, e);
          hi[c] = s;
          lo[c] = __fadd_rn(lo[c], e);
          float r = __fadd_rn(rest[c], acc0[NR + i]);
          r = __fadd_rn(r, acc0[2 * NR + i]);
          r = __fadd_rn(r, acc0[3 * NR + i]);
          r = __fadd_rn(r, acc1[i]);
          r = __fadd_rn(r, acc1[NR + i]);
          r = __fadd_rn(r, acc1[2 * NR + i]);
          r = __fadd_rn(r, acc2[i]);
          r = __fadd_rn(r, acc2[NR + i]);
          rest[c] = __fadd_rn(r, acc3[i]);
        }
      }
      st[0] = h4;
      st[Q * NT] = l4;
      st[2 * Q * NT] = r4;
      if constexpr (HAS_LO) {
        float4 c4 = st[3 * Q * NT];
        float* cheap = &c4.x;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          cheap[c] = __fadd_rn(cheap[c], accl[4 * i4 + c]);
        st[3 * Q * NT] = c4;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_t) stage_a(s);
    cp_async_commit();
  }

  const int row0 = wg * 64 + wq * 16 + g;  // this thread's rows: +0, +8
  const float inv0 = row_inv[row0], inv1 = row_inv[row0 + 8];
  const long long xb0 = row_base_lo[row0], xb1 = row_base_lo[row0 + 8];
  const bool ok0 = row_base[row0] >= 0, ok1 = row_base[row0 + 8] >= 0;
  const unsigned short* xlu = reinterpret_cast<const unsigned short*>(xl);
  // one bf16 of x_lo as fragment bits (zero past L_f and R), loaded
  // without a branch (a divergent load made ptxas serialize the wgmmas)
  auto xlo = [&](long long rowb, bool ok, int d) -> uint32_t {
    const bool in = ok && d < L_f;
    const uint32_t v = __ldg(xlu + (in ? rowb + d : 0));
    return in ? v : 0u;
  };

  int scale_d = 0;  // 0 on a chunk's first step: its accumulators start fresh
  for (int u = 0; u < n_t; ++u) {
    const int t = kb + u;
    // k-tile u staged by the whole warpgroup, which is also done reading
    // the slot that the next copies refill
    cp_async_wait<ST - 2>();
    named_bar_sync(1 + wg, 128);
    if (u + ST - 1 < n_t) stage_a(u + ST - 1);
    cp_async_commit();
    const int slot = u % ST;
    mbar_wait(full + slot, (u / ST) & 1);
    const float* a_s = Aw + slot * A_STAGE + (wq * 16 + g) * APITCH + 2 * tq;
    const unsigned b_s = smem_u32(Bs + slot * B_ELEMS);

    // step ks of the k-tile: its A fragments split into the four slices
    // (and x_lo's), then its wgmmas (sd: 0 on a chunk's first step)
    auto split_step = [&](int ks, uint32_t (&a)[N_PARTS][4],
                          uint32_t (&al)[4]) {
      const float* p0 = a_s + ks * 16;
      const float* p1 = p0 + 8 * APITCH;
      const float2 v0 = *reinterpret_cast<const float2*>(p0);
      const float2 v1 = *reinterpret_cast<const float2*>(p1);
      const float2 v2 = *reinterpret_cast<const float2*>(p0 + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(p1 + 8);
      split4(__fmul_rn(v0.x, inv0), __fmul_rn(v0.y, inv0), a, 0);
      split4(__fmul_rn(v1.x, inv1), __fmul_rn(v1.y, inv1), a, 1);
      split4(__fmul_rn(v2.x, inv0), __fmul_rn(v2.y, inv0), a, 2);
      split4(__fmul_rn(v3.x, inv1), __fmul_rn(v3.y, inv1), a, 3);
      if constexpr (HAS_LO) {
        const int d = t * TK + ks * 16 + 2 * tq;
        al[0] = xlo(xb0, ok0, d) | xlo(xb0, ok0, d + 1) << 16;
        al[1] = xlo(xb1, ok1, d) | xlo(xb1, ok1, d + 1) << 16;
        al[2] = xlo(xb0, ok0, d + 8) | xlo(xb0, ok0, d + 9) << 16;
        al[3] = xlo(xb1, ok1, d + 8) | xlo(xb1, ok1, d + 9) << 16;
      }
    };
    auto issue_step = [&](int ks, const uint32_t (&a)[N_PARTS][4],
                          const uint32_t (&al)[4], int sd) {
      const uint64_t desc = desc_sw128(b_s + ks * 32);
      Mma<4 * BN>::run(acc0, a[0], desc, sd);
      if constexpr (!kNoSmall) {
        Mma<3 * BN>::run(acc1, a[1], desc, sd);
        Mma<2 * BN>::run(acc2, a[2], desc, sd);
        Mma<BN>::run(acc3, a[3], desc, sd);
      }
      if constexpr (HAS_LO) Mma<BN>::run(accl, al, desc, sd);
    };
    auto fence_acc = [&]() {
      reg_fence(acc0);
      reg_fence(acc1);
      reg_fence(acc2);
      reg_fence(acc3);
      if constexpr (HAS_LO) reg_fence(accl);
    };
    // the k-tile's steps that reach into [0, L_f)
    const int n_s = min(TK / 16, (L_f - t * TK + 15) / 16);
    // KS steps split, then their wgmmas issued and waited for: all of a
    // batch's input registers are written before its wgmmas start (a
    // build that split the next step under this one's wgmmas, into a
    // second buffer, ran no faster)
#pragma unroll
    for (int k0 = 0; k0 < TK / 16; k0 += KS) {
      if (k0 >= n_s) break;
      uint32_t a[KS][N_PARTS][4], al[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) split_step(k0 + ks, a[ks], al[ks]);
      fence_acc();
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        issue_step(k0 + ks, a[ks], al[ks], ks > 0 ? 1 : scale_d);
      wg_commit();
      wg_wait0();
      fence_acc();
      scale_d = 1;
    }
    // end of a K0-deep chunk (or of the column tile's nonzero k-tiles)
    if ((t + 1) % KT_CHUNK == 0 || u + 1 == n_t) {
      fold();
      scale_d = 0;
    }
    // this warpgroup is done with the slot; thread 0 refills it with
    // k-tile u + ST once the other warpgroup is too
    mbar_arrive(empty + slot);
    if (tid == 0 && u + ST < n_t) {
      mbar_wait(empty + slot, (u / ST) & 1);
      load_b(u + ST);
    }
  }

  // output combines of the reference kernel (pallas_ozaki.py:141-154);
  // accumulator layout: n8 block j holds columns 8j..8j+7, rows g and g+8
  // (state i is float i % 4 of float4 i / 4)
  const float* stf = reinterpret_cast<const float*>(state);
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int j = i >> 2, e = i & 3;
    const int rloc = row0 + (e >> 1) * 8;
    const long long r = r0 + rloc;
    const int col = ct * BN + 8 * j + 2 * tq + (e & 1);
    if (r >= R || col >= Kcols) continue;
    constexpr int QS = NR * NT;  // floats of one state
    const float* st = stf + 4 * ((i >> 2) * NT + tid) + (i & 3);
    const float hi = st[0], s = row_sx[rloc];
    const float small = __fadd_rn(st[QS], st[2 * QS]);
    const long long o = r * Kcols + col;
    if constexpr (!EMIT_PAIR) {
      if constexpr (HAS_LO)
        y[o] = __fadd_rn(__fmul_rn(hi, s),
                         __fadd_rn(__fmul_rn(small, s), st[3 * QS]));
      else
        y[o] = __fmul_rn(__fadd_rn(hi, small), s);
    } else {
      float sm = __fmul_rn(small, s);
      if constexpr (HAS_LO) sm = __fadd_rn(sm, st[3 * QS]);
      float H, L;
      two_sum(__fmul_rn(hi, s), sm, H, L);
      y[o] = H;
      yl[o] = __float2bfloat16_rn(L);
    }
  }
}

template <bool HAS_LO, bool EMIT_PAIR>
cudaError_t launch_one(unsigned blocks, cudaStream_t s, const float* xp,
                       long long ldx, const float* sx, const bf16* tiles,
                       const int* bands, const bf16* xl, long long ldxl,
                       float* y, bf16* yl, long long R, int n_blocks, int hop,
                       int L_f, int Kcols, int n_ct, int n_kt, int vec) {
  constexpr size_t smem = Smem<HAS_LO>::bytes;
  auto* kern = ozaki_framed_kernel<HAS_LO, EMIT_PAIR>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<blocks, NT, smem, s>>>(xp, ldx, sx, tiles, bands, xl, ldxl, y, yl, R,
                                n_blocks, hop, L_f, Kcols, n_ct, n_kt, vec);
  return cudaGetLastError();
}

// The wgmma lemma probe: out[q, m, n] = sum_k a[m, k] * T_q[k, n] for the
// four slices of one packed column tile (n_kt k-tiles), a [64, 64*n_kt]
// bf16 row-major.  One warpgroup: the operator through bulk copies into
// shared memory, A from registers, the kernel's m64n128k16 over
// [s0|s1|s2|s3], every k16 step chained into one accumulator (the first
// fresh).
__global__ void __launch_bounds__(128, 1)
wgmma_dot_kernel(const bf16* __restrict__ a, const bf16* __restrict__ tiles,
                 float* __restrict__ out, int n_kt) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Bs = reinterpret_cast<bf16*>(base);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + n_kt * B_STAGE);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, n_kt * B_STAGE);
    for (int t = 0; t < n_kt; ++t)
      bulk_g2s(Bs + t * (B_STAGE / 2), tiles + t * (B_STAGE / 2), B_STAGE,
               bar);
  }
  mbar_wait(bar, 0);
  const int wq = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int K = n_kt * TK;
  const uint32_t* ar = reinterpret_cast<const uint32_t*>(a);
  const int rA = (wq * 16 + g) * (K / 2), rB = rA + 8 * (K / 2);
  float acc[4 * NR];
#pragma unroll
  for (int i = 0; i < 4 * NR; ++i) acc[i] = 0.0f;
  const unsigned b0 = smem_u32(Bs);
  for (int s = 0; s < K / 16; ++s) {
    const int c = (s * 16 + 2 * tq) / 2;
    const uint32_t af[4] = {ar[rA + c], ar[rB + c], ar[rA + c + 4],
                            ar[rB + c + 4]};
    reg_fence(acc);
    wg_fence();
    Mma<4 * BN>::run(acc, af,
                     desc_sw128(b0 + (s / 4) * B_STAGE + (s % 4) * 32),
                     s > 0);
    wg_commit();
    wg_wait0();
    reg_fence(acc);
  }
#pragma unroll
  for (int i = 0; i < 4 * NR; ++i) {
    const int q = i / NR, j = (i % NR) >> 2, e = i & 3;
    const int m = wq * 16 + g + (e >> 1) * 8, n = 8 * j + 2 * tq + (e & 1);
    out[(q * 64 + m) * BN + n] = acc[i];
  }
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
// float32 powers of two; tiles, bands: the operator as
// pallas_ozaki.pack_operator packs it, bf16 [n_ct, n_kt, 4, bn, 64] and
// int32 [n_ct, 2] (refused unless bn, n_kt and n_ct are this kernel's
// tiling of L_f x Kcols); xl (may be null): bf16, row stride ldxl; y: [C,
// n_blocks*Kcols] float32; yl (null unless the pair is wanted): [C,
// n_blocks*Kcols] bf16.
extern "C" int r8b_ozaki_framed(const float* xp, long long ldx,
                                const float* sx, const void* tiles,
                                const int* bands, int n_ct, int n_kt, int bn,
                                const void* xl, long long ldxl, float* y,
                                void* yl, int C, int n_blocks, int hop,
                                int L_f, int Kcols, void* stream) {
  if (C < 0 || n_blocks < 1 || hop < 1 || L_f < 1 || Kcols < 1 || ldx < 0 ||
      ldxl < 0 || bn != BN || n_kt != (L_f + TK - 1) / TK ||
      n_ct != (Kcols + BN - 1) / BN)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long R = static_cast<long long>(C) * n_blocks;
  if (R == 0) return 0;
  const long long blocks = ((R + BM - 1) / BM) * n_ct;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const bf16* tb = static_cast<const bf16*>(tiles);
  const bf16* xlb = static_cast<const bf16*>(xl);
  bf16* ylb = static_cast<bf16*>(yl);
  const int vec = reinterpret_cast<uintptr_t>(xp) % 16 == 0 && ldx % 4 == 0 &&
                  hop % 4 == 0;
#define R8B_OZ(LO_, PAIR_)                                                 \
  launch_one<LO_, PAIR_>(nb, s, xp, ldx, sx, tb, bands, xlb, ldxl, y, ylb, \
                         R, n_blocks, hop, L_f, Kcols, n_ct, n_kt, vec)
  cudaError_t e;
  if (xl != nullptr && yl != nullptr)
    e = R8B_OZ(true, true);
  else if (xl != nullptr)
    e = R8B_OZ(true, false);
  else if (yl != nullptr)
    e = R8B_OZ(false, true);
  else
    e = R8B_OZ(false, false);
#undef R8B_OZ
  return static_cast<int>(e);
}

// out [4, 64, 32] float32: out[q] = a [64, 64*n_kt] @ T_q through the
// kernel's wgmma path (tiles: one packed column tile of n_kt k-tiles,
// n_kt <= 4); the lemma probe.
extern "C" int r8b_ozaki_wgmma_dot(const void* a, const void* tiles,
                                   float* out, int n_kt, void* stream) {
  if (n_kt < 1 || n_kt > KT_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = n_kt * B_STAGE + 8 + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      wgmma_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_dot_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(tiles), out,
      n_kt);
  return static_cast<int>(cudaGetLastError());
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
