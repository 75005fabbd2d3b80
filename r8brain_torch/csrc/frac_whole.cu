// Framed matmul of the fused 44.1k->96k chain (and of every whole-stepping
// interpolator and matmul conv stage), for sm_90a:
//
//     y[c, m*O + j] = sum_{d<D} x[c, x0 + m*I + d] * skT[d, j]
//                   (+ sum_{d<D} x[c, x0 + m*I + d] * skT_lo[d, j])
//
// with x [C, n] read where it lies (any row stride) and zero outside
// columns [0, n): the window origin x0 is signed, and the windows may run
// past n, so no caller frames a padded copy of x.
//
// Replaces the reference package's TPU kernel
// r8brain_tpu/ops/pallas_frac.py::frac_whole_pallas (its pallas_call and
// kernel body: the main HIGHEST dot and the optional residual dot).
//
// float32: a three-slice bfloat16 split on the tensor cores (wgmma), its
// lead slices on fixed grids.
//
// What bounds it: operations.  The flagship (C=1024, n_win=150, D=1027,
// O=640) is 2.0e11 flop of the function against 0.57 GB of compulsory
// traffic.  The -141 dB class rules out TF32 (10-bit mantissa); a float32
// FMA kernel on the CUDA cores is bound at 3.0 ms (67 TFLOP/s).  The split
// form runs 6 bf16 products per term (7 with skT_lo) at 989 TFLOP/s: a
// 1.23 ms bound (1.43 with skT_lo).
//
// Arithmetic (the plain model is r8brain_torch/ops/pallas_frac.py::
// frac_whole_ref):
//   * The big pair x0*s0 sums into a partial of FOLD = 16 or 32 terms (one
//     or two k16 steps, one accumulator: wgmma scale-d = 0 on the fold's
//     first), each fold starting at a multiple of FOLD from d = 0, and is
//     folded into (hi, lo) with two_sum on the CUDA cores.
//   * Each window row's values over a fold are split into three bf16
//     slices x = x0 + x1 + x2 + O(2^(E-27)): x0 is x rounded to nearest on
//     one grid for the row and fold, 2^(E-8) with 2^E above the fold's
//     largest |x| of the row (the max over this lane's values of the fold,
//     then the quad's; E from its exponent field; one too large is
//     harmless), by adding and subtracting 1.5 * 2^(E+15) (grid_magic,
//     split_grid in hopper.cuh); x - x0 is exact and splits into x1, x2 by
//     the floating rule.  The grid belongs to the row, not the sample:
//     overlapping windows share samples, not grids (but at I = 1 on the
//     8-column tile a warp's 16 rows share one, see Design).  This trades
//     an exact input for exact fold sums: the floating split (split3)
//     holds every float32 x exactly, x0 + x1 + x2 here only to 2^(E-27)
//     (x1 and x2 hold the 16 bits below 2^(E-9), so a value far below its
//     row's largest loses its last bits), rounded to nearest, without a
//     sign of its own; the reference's f32-HIGHEST dot reads x exactly.
//     The operator comes
//     split the same way, once, by its executor (operator_parts: s0 on a
//     grid for each column and 32-row group of D, so a fold of 16 or 32
//     terms lies in one group; s1, s2, and under "high" bf16(skT_lo)).
//     Every slice product is exact in float32.  Inputs below 2^112 in
//     magnitude (the magic constant's range).
//   * x0 = k 2^(E-8) and s0 = m 2^(F-8) with |k|, |m| <= 256, so a fold's
//     products lie on the grid 2^(E+F-16) and sum to under 2^21 of its
//     units: the sum is exact in float32 and the tensor cores, which
//     truncate an inexact sum toward zero, have nothing to truncate (a
//     truncated sum is a loss of gain, correlated with the signal, that
//     adds up coherently along a chain of stages).
//   * Kept pairs: p+q <= 2 (and x0 * bf16(skT_lo)); the dropped ones are
//     below 2^-26 of a product.  The small pairs accumulate straight into
//     the lo fragment, so an output holds three fragments, not four.  Once
//     a k-tile lo moves into hi (Fast2Sum): lo then stays within an ulp
//     of hi, and the tensor cores truncate each small-pair sum they add
//     into it at that scale (a lo grown over all of D, up to 2^-9 of y,
//     put a bias on y of the toeplitz conv stage: beta -0.034 on an
//     H100).  y = hi + lo, rounded once.  The fold is plain __f*_rn
//     arithmetic (no --use_fast_math), so nothing is contracted or
//     reassociated.
//
// Design:
//   * Rows r = c*n_win + m of an implicit im2col matrix A[r, d] = x[c,
//     x0 + m*I + d] against the operator slices.  A block is two warpgroups,
//     each 64 rows x BN columns (BN = 128 where O is a multiple of 128 or
//     above 192, 64 otherwise, 8 for O <= 2: the direct stage's), so
//     a 128 x BN tile of y (exactly the [R, O] row-major layout of y); one
//     1-D grid walks (row tile, column tile) with the column tile fastest,
//     so the blocks of one row tile share the window rows in L2.  The
//     wide tile halves the input each block re-reads from L2 and the
//     splitting per output; three fragments of 64 floats fit a thread's
//     registers (8 warps an SM: no producer warp, whose ninth warp would
//     cap the registers at 168).
//   * The operator is packed on the host as one contiguous,
//     128-byte-swizzled block per (column tile, 64-deep k-tile)
//     (operator_parts), so thread 0 moves a whole stage with one TMA bulk
//     copy into an mbarrier ring (3 stages; 2 at BN = 128, whose stage of
//     four slices is 64 KB), refilling a slot once both warpgroups have
//     freed it, and wgmma reads B straight from it (K-major, 128B swizzle
//     descriptors).
//   * A from registers: the windows start at m*I, unaligned for I = 294,
//     147 and 1, so neither a TMA tile nor a swizzled A tile fits them.
//     Each warpgroup stages its own 64 rows of the k-tile in float32 with
//     cp.async, a warp a row, rows padded to 72 floats so that the
//     fragment reads are free of bank conflicts, behind a named barrier.
//     Each row keeps in shared memory its 64-bit start and the window's
//     columns [lo, hi) inside x (one 16-byte record, one load a copy): a
//     copy's byte count (cp.async's src-size) zero-fills past hi, past D
//     included, and a copy before lo reads nothing; where a k-tile leaves
//     x on one of a warp's rows, such a 0-byte copy names the operator's
//     address, not one outside x (a warp-wide test a k-tile, from the
//     k-tiles each row's span keeps inside x).  16-byte copies where
//     the caller asks for them (ops/pallas_frac.py::copy_width; refused
//     unless x, the origin, I and the row stride allow them), else 8-byte
//     on rows that start 8-byte aligned and whose copies do not straddle
//     x's first column, 4-byte on the others.  The caller puts the origin
//     on the widest alignment it can (ops/pallas_frac.py::lead_rows: up to
//     3 leading zero rows in the operator).  Each thread reads its fragment
//     as float pairs and splits them into the three bf16 fragment sets in
//     registers.
//   * The 8-column tile (O <= 2) multiplies the slices side by side: one
//     tile [s0 | s1 | s2 | bf16(skT_lo)], so a k16 step is 3 MMAs, not 6
//     or 7 (x1*s2 and the like ride along, below 2^-26 of a product);
//     the small-pair columns fold into their own lane's hi and lo and
//     sum across the quad at the end; only column block 0 of x0's
//     product (x0*s0) is the big pair, on the grids.  With I <= 64 it
//     stages stretches instead of rows: channel-aligned row tiles, and
//     per k-tile one contiguous stretch a warpgroup (63*I + 64 samples:
//     127 at I = 1, against 64 rows of 64), so two blocks fit an SM.
//     At I = 1 the rows are shifted copies of one another (row g+8 at
//     column c is row g at c+8), so a lane splits two float pairs a step,
//     not four, on one grid for the warp's 16 rows and the fold (the max
//     of the 15 + FOLD samples they read: a sample splits alike in every
//     row, and the fold's x0 still lie on one grid); at other I each row
//     splits its own four pairs on its own grid.
//   * A fold is: the rows' maxima over its A, split its A, fence, its 6
//     (7) MMAs a k16 step, commit, wait, two_sum.  All of a fold's input
//     registers are written before its MMAs start, so ptxas keeps them
//     asynchronous (a pipeline that split the next step under the MMAs
//     in flight was serialized by ptxas, C7513/C7518).  The fold of one
//     warpgroup runs on the CUDA cores while the other's MMAs run (making
//     them take turns through an mbarrier pair was slower on the H100).
//   * A block walks only its column tile's band: the folds that meet the
//     k16 steps of D where some slice of the operator is nonzero in the
//     tile's columns (operator_band, built once with the operator; past
//     D the operator is zero padding).  The operators are banded (a
//     column of the fused flagship or a toeplitz conv reads about 780 of
//     D's rows, the band sliding about one k-tile a column tile), so this
//     drops 19-33 % of their folds: split, MMAs, two_sum and TMA traffic.
//     The k-loop runs over the band's k-tiles, the rings count from its
//     first, and the folds outside it in its edge k-tiles are skipped.
//     y is the full walk's bit for bit (finite x): a skipped fold would
//     add exact zeros (x0 * 0, nothing for the tensor cores to truncate,
//     two_sum(hi, 0) = (hi, 0)); before the band hi = lo = 0; after it
//     each further k-tile's Fast2Sum keeps hi + lo exactly (it may move
//     an ulp between them), so y = hi + lo is unchanged.  The work then
//     approaches the bound over nonzero operator entries rather than the
//     dense one (flagship 0.859 against 1.225 ms).  The 8-column tile
//     (O <= 2: the direct stage, whose superkernel is dense) walks all of
//     D as before: reading a band there made ptxas schedule its fold loop
//     worse (+7.5 % on the direct stage, H100), and its epilogue sums lo
//     across the quad apart from hi, which a skipped Fast2Sum would move.
//
// float64: an FMA kernel on the CUDA cores (the port's f64 path), 64 x 64
// tiles, 16-term partials folded with two_sum.

#include <climits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32: the split form on the tensor cores

// The columns [lo, hi) of a window of D from column p of a row of n that
// lie inside the row (lo = hi where none do); the others read as zeros.
__device__ __forceinline__ int2 window_span(long long p, long long n, int D) {
  const long long lo = min(static_cast<long long>(D), max(0LL, -p));
  const long long hi = max(lo, min(static_cast<long long>(D), n - p));
  return make_int2(static_cast<int>(lo), static_cast<int>(hi));
}

namespace split {

constexpr int BM = 128;            // rows a block: two warpgroups of 64
constexpr int TK = 64;             // d a k-tile (one 128-byte bf16 row)
constexpr int APITCH = TK + 8;     // floats a staged row: 8 mod 32 banks
// k-tiles in flight: 3, or 2 for the 128-column tile (a stage of its four
// operator slices is 64 KB)
template <int BN>
constexpr int STAGES = BN == 128 ? 2 : 3;
constexpr int NT = 256;            // two warpgroups (8 warps: 255 registers)
constexpr int A_ROWS = BM * APITCH;  // floats of an A stage staged by row
constexpr int MAX_STRETCH_I = 64;    // the 8-column tile stages stretches

// Ablation, for tools/torch_frac_ablation.py only: a build with
// -DR8B_ABLATE=mask drops parts of the work (its output is then wrong) so
// that the rest can be timed.  Bits: 1 the two_sum fold (one add instead),
// 2 the split and its grids (x0 = x1 = x2 = bf16(x)), 4 the small-pair
// MMAs, 8 the input staging.
#ifndef R8B_ABLATE
#define R8B_ABLATE 0
#endif
constexpr bool kNoFold = R8B_ABLATE & 1;
constexpr bool kNoSplit = R8B_ABLATE & 2;
constexpr bool kNoSmall = R8B_ABLATE & 4;
constexpr bool kNoStage = R8B_ABLATE & 8;

// Whether the row staging guards the source address of its 0-byte copies.
template <bool B>
struct Guard {
  static constexpr bool on = B;
};

// A window row as the staging reads it: its first column's offset from x,
// the window's columns [lo, hi) that lie inside x (the rest read as zeros),
// and hi stored as ~hi (negative) where the row takes 4-byte copies in the
// 8-byte mode: its start is not 8-byte aligned, or x's first column falls
// inside one of its 8-byte copies.
struct __align__(16) Row {
  long long b;
  int lo, hi;
};
// one 16-byte shared-memory load
__device__ __forceinline__ Row load_row(const Row* r) {
  const int4 v = *reinterpret_cast<const int4*>(r);
  return Row{static_cast<long long>(
                 (static_cast<unsigned long long>(static_cast<unsigned>(v.y))
                  << 32) | static_cast<unsigned>(v.x)),
             v.z, v.w};
}

// Shared memory: STAGES operator stages (P swizzled tiles each), STAGES A
// stages of a_stage floats (by row, A_ROWS; or two stretches), the full
// and empty barriers, the rows, the staging warps' k-tiles inside x.
template <int BN, int P>
struct Smem {
  static constexpr int ST = STAGES<BN>;
  // the 8-column tile (O <= 2) holds one more tile: the slices side by side
  static constexpr int PT = BN == 8 ? P + 1 : P;
  static constexpr int B_STAGE = PT * BN * TK * 2;  // bytes
  static constexpr size_t a_off = ST * B_STAGE;
  static_assert((BN * TK * 2) % 1024 == 0, "swizzle atoms are 1 KB");
  static constexpr size_t bytes(int a_stage) {
    return a_off + ST * a_stage * 4 + 2 * ST * 8 + BM * sizeof(Row) +
           BM / 16 * sizeof(int2) +
           1024;  // + alignment
  }
};

// n_mt > 0 (8-column tile, I <= MAX_STRETCH_I): stretch mode.  Row tiles
// are channel-aligned (n_mt a channel) and each warpgroup stages, per
// k-tile, the one contiguous stretch its 64 windows cover (63*I + 64
// samples: 127 at I = 1, against 4096 by row); row i reads it at i*I.
template <int BN, int FOLD, int P>
__global__ void __launch_bounds__(NT, BN == 8 ? 2 : 1)
frac_split_kernel(const float* __restrict__ xp, long long ldx,
                  long long x0, long long n_x,
                  const bf16* __restrict__ parts,
                  const int* __restrict__ band, float* __restrict__ y,
                  long long R, int n_win, int I, int D, int O, int n_kt,
                  int n_col_tiles, int vec, int a_stage, int n_mt) {
  using S = Smem<BN, P>;
  constexpr int ST = S::ST;
  constexpr int NR = BN / 2;     // accumulator floats a thread, a fragment
  constexpr int KS = FOLD / 16;  // k16 steps a fold
  constexpr int FK = TK / FOLD;  // folds a k-tile
  constexpr int TILE = BN * TK;  // bf16 elements of one slice's tile
  static_assert(TK % FOLD == 0 && FOLD % 16 == 0, "folds tile the k-tile");

  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment (offset kept on smem_raw so
  // that the compiler still sees shared-memory accesses)
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Bs = reinterpret_cast<bf16*>(base);               // [ST][P][BN][TK]
  float* As = reinterpret_cast<float*>(base + S::a_off);  // [ST][a_stage]
  uint64_t* full = reinterpret_cast<uint64_t*>(As + ST * a_stage);
  uint64_t* empty = full + ST;
  Row* rows = reinterpret_cast<Row*>(empty + ST);  // 16-byte aligned
  // per staging warp (16 rows): the k-tiles [x, y) whose copies all lie
  // inside x, on every one of its rows
  int2* inside = reinterpret_cast<int2*>(rows + BM);
  // the source of a copy that reads nothing (16-byte aligned: TMA's)
  const float* zsrc = reinterpret_cast<const float*>(parts);

  const bool stretch = BN == 8 && n_mt > 0;
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const int col_t = static_cast<int>(tile % n_col_tiles);
  // the column tile's band: the folds [f_lo, f_hi) that meet its nonzero
  // k16 steps, in the k-tiles [t_lo, t_hi); the others add exact zeros.
  // The 8-column tile walks all of D (see Design).
  int f_lo = 0, f_hi = INT_MAX, t_lo = 0, t_hi = n_kt;
  if constexpr (BN != 8) {
    f_lo = band[2 * col_t] / KS;
    f_hi = max(f_lo, (band[2 * col_t + 1] + KS - 1) / KS);
    t_lo = f_lo / FK;
    t_hi = min(n_kt, (f_hi + FK - 1) / FK);
  }
  // the tile's first output row and the end of its rows
  long long r0, r_end = R, c0 = 0;
  int m0 = 0;
  if (stretch) {
    const long long rt = tile / n_col_tiles;
    c0 = rt / n_mt;
    m0 = static_cast<int>(rt % n_mt) * BM;
    r0 = c0 * n_win + m0;
    r_end = (c0 + 1) * n_win;
  } else {
    r0 = (tile / n_col_tiles) * BM;
  }
  if (tid < BM) {
    // row r's window: from x's column p of channel c (no columns past R;
    // those rows copy nothing, from x's first column)
    const long long r = r0 + tid;
    Row w{0, 0, 0};
    long long p = 0;
    if (r < r_end) {
      const long long c = r / n_win;
      p = x0 + (r - c * n_win) * static_cast<long long>(I);
      const int2 sp = window_span(p, n_x, D);
      const bool al = ((reinterpret_cast<uintptr_t>(xp) +
                        4 * static_cast<uintptr_t>(c * ldx + p)) & 7) == 0 &&
                      (sp.x & 1) == 0;
      w = Row{c * ldx + p, sp.x, al ? sp.y : ~sp.y};
    }
    rows[tid] = w;
    // k-tile t reads columns p + t*TK + [0, TK) of the row: inside x for
    // t in [ta, tb); over the staging warp's 16 rows (half a warp here)
    int ta = p >= 0 ? 0 : static_cast<int>(min(static_cast<long long>(n_kt),
                                               (TK - 1 - p) / TK));
    int tb = static_cast<int>(
        max(0LL, min(static_cast<long long>(n_kt), (n_x - p) / TK)));
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      ta = max(ta, __shfl_xor_sync(0xffffffffu, ta, o));
      tb = min(tb, __shfl_xor_sync(0xffffffffu, tb, o));
    }
    if ((tid & 15) == 0) inside[tid >> 4] = make_int2(ta, tb);
  }
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 moves the operator: one bulk copy a k-tile into its slot, the
  // band's first ST now, each later one once both warpgroups freed the
  // slot (slots and phases count from t_lo)
  constexpr int PT = S::PT;
  const bf16* b_src = parts + static_cast<long long>(col_t) * n_kt * PT * TILE;
  auto load_b = [&](int t) {
    const int slot = (t - t_lo) % ST;
    mbar_expect_tx(full + slot, S::B_STAGE);
    bulk_g2s(Bs + slot * PT * TILE,
             b_src + static_cast<long long>(t) * PT * TILE, S::B_STAGE,
             full + slot);
  };
  if (tid == 0) {
    for (int t = t_lo; t < t_lo + ST && t < t_hi; ++t) load_b(t);
  }

  const int wg = tid >> 7, tw = tid & 127;
  const int wq = tw >> 5, lane = tw & 31, g = lane >> 2, tq = lane & 3;
  const Row* rw = rows + wg * 64;
  const int sw = a_stage / 2;  // floats of one warpgroup's stretch
  float* Aw = As + wg * (stretch ? sw : 64 * APITCH);
  const int rs = stretch ? I : APITCH;  // row stride of the staged A

  // this warpgroup's 64 rows of k-tile t into its slot, zero past D and R
  // and outside x: warp wq stages rows 16wq..16wq+15, one row (two with
  // 16-byte copies) an instruction, 8-byte copies on rows marked so.  A
  // copy of w floats at column d of a window takes n = min(w, hi - d) of
  // them, 0 before lo (the rest zero-filled; where a row of the warp
  // leaves x in this k-tile, a copy of 0 bytes takes the operator's first
  // element as its source, so no copy names an address outside x): no copy
  // begins before x and ends in it, since the 16-byte mode puts x's first
  // column on its grid and the 8-byte mode copies such a row by the float.
  auto stage_a = [&](int t) {
    if constexpr (kNoStage) return;
    float* dst = Aw + ((t - t_lo) % ST) * a_stage;
    const int d0 = t * TK;
    if (stretch) {
      // positions p0 + e of channel c0's windows (x's column x0 + p0 + e):
      // zero past the windows' extent and outside x, e in [e_lo, e_hi)
      const long long p0 = static_cast<long long>(m0 + 64 * wg) * I + d0;
      const long long ext = static_cast<long long>(n_win - 1) * I + D;
      const long long a0 = x0 + p0;
      const long long n_sw = sw, lo = min(n_sw, max(0LL, -a0));
      const int e_lo = static_cast<int>(lo);
      const int e_hi = static_cast<int>(max(lo, min(n_sw, min(ext - p0,
                                                              n_x - a0))));
      const float* src = xp + c0 * ldx + a0;
      for (int e = tw; e < sw; e += 128) {
        const bool ok = static_cast<unsigned>(e - e_lo) <
                        static_cast<unsigned>(e_hi - e_lo);
        cp_async_elem(dst + e, ok ? src + e : zsrc, ok);
      }
    } else {
      // where the k-tile leaves x on a row of this warp, a copy of 0 bytes
      // takes zsrc as its source; elsewhere every copy's address lies in x
      const int2 in = inside[wg * 4 + wq];
      auto stage_rows = [&](auto guard) {
        auto src = [&](const Row& r, int d, int n) {
          return !decltype(guard)::on || n > 0 ? xp + r.b + d : zsrc;
        };
        if (vec) {
#pragma unroll
          for (int it = 0; it < 8; ++it) {
            const int i = wq * 16 + it * 2 + (lane >> 4);
            const int d = d0 + 4 * (lane & 15);
            const Row r = load_row(rw + i);
            const int n = d < r.lo ? 0 : max(0, min(4, r.hi - d));
            cp_async16(dst + i * APITCH + 4 * (lane & 15), src(r, d, n),
                       4 * n);
          }
        } else {
          const int d = d0 + 2 * lane;
#pragma unroll 4
          for (int it = 0; it < 16; ++it) {
            const int i = wq * 16 + it;
            const Row r = load_row(rw + i);
            float* to = dst + i * APITCH + 2 * lane;
            if (r.hi >= 0) {
              const int n = d < r.lo ? 0 : max(0, min(2, r.hi - d));
              cp_async8(to, src(r, d, n), 4 * n);
            } else {
              const int hi = ~r.hi;
              const bool ok0 = d >= r.lo && d < hi;
              const bool ok1 = d + 1 >= r.lo && d + 1 < hi;
              cp_async_elem(to, ok0 ? xp + r.b + d : zsrc, ok0);
              cp_async_elem(to + 1, ok1 ? xp + r.b + d + 1 : zsrc, ok1);
            }
          }
        }
      };
      if (t >= in.x && t < in.y) {
        stage_rows(Guard<false>{});
      } else {
        stage_rows(Guard<true>{});
      }
    }
  };

  // Accumulators: the big pair's partial of the fold in flight (tensor
  // cores), its folded sum hi (CUDA cores), and lo, into which the tensor
  // cores add the small pairs and the fold its errors (never both at once)
  float acc[NR], hi[NR], lo[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = hi[i] = lo[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (t_lo + s < t_hi) stage_a(t_lo + s);
    cp_async_commit();
  }

  for (int t = t_lo; t < t_hi; ++t) {
    // k-tile t staged by the whole warpgroup, which is also done reading
    // the slot that the next copies refill
    cp_async_wait<ST - 2>();
    named_bar_sync(1 + wg, 128);
    if (t + ST - 1 < t_hi) stage_a(t + ST - 1);
    cp_async_commit();
    const int u = t - t_lo;  // k-tiles walked before this one
    const int slot = u % ST;
    mbar_wait(full + slot, (u / ST) & 1);
    const float* a_s = Aw + slot * a_stage + (wq * 16 + g) * rs + 2 * tq;
    const unsigned b_s = smem_u32(Bs + slot * PT * TILE);

#pragma unroll
    for (int f = 0; f < FK; ++f) {
      // outside the band or all padding: adds nothing
      if (t * FK + f < f_lo) continue;
      if (t * FK + f >= f_hi || t * TK + f * FOLD >= D) break;
      // the fold's A fragments, split into three bf16 sets: all written
      // before its MMAs start (no register of an MMA in flight changes).
      // Pair q of step ks: row g (q even) or g + 8 (q odd), columns 2tq,
      // 2tq + 1 (q < 2) or those + 8.  In stretch mode a row reads on past
      // D into the next windows' samples, which the fold that crosses D
      // zeroes (the operator is zero there; the grid is the model's).
      const int d_f = t * TK + f * FOLD;
      const bool edge = stretch && d_f + FOLD > D;
      auto pair = [&](int ks, int q) {
        const float* p = a_s + (f * KS + ks) * 16 + (q & 1) * 8 * rs +
                         (q >> 1) * 8;
        float2 v = stretch ? make_float2(p[0], p[1])  // any float start
                           : *reinterpret_cast<const float2*>(p);
        if (edge) {
          const int d = d_f + ks * 16 + 2 * tq + (q >> 1) * 8;
          if (d >= D) v.x = 0.0f;
          if (d + 1 >= D) v.y = 0.0f;
        }
        return v;
      };
      uint32_t a[KS][3][4];
      if (stretch && I == 1) {
        // unit stride: row g+8 at column c is row g at c+8 (pair 2 is
        // pair 1), and pair 0 is the step before's pair 3, so a lane
        // reads and splits two pairs a step (and pair 0 once).  That needs
        // one grid for every row that reads a sample: the warp's 16 rows
        // share one over the fold, from the max of the 15 + FOLD samples
        // they read (each zeroed past D in its own row and column, the
        // quad's max and then across the quads).  Their x0 then lie on
        // one grid 2^(E-8), |k| <= 256, so a fold's sums stay exact.
        const float2 v0 = pair(0, 0);
        float2 v[KS][2];
        float mx = fmaxf(fabsf(v0.x), fabsf(v0.y));
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          v[ks][0] = pair(ks, 1);
          v[ks][1] = pair(ks, 3);
          mx = fmaxf(mx, absmax4(v[ks][0], v[ks][1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float M = grid_magic<kNoSplit>(mx);
        split_grid<kNoSplit>(v0, M, a[0][0][0], a[0][1][0], a[0][2][0]);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          split_grid<kNoSplit>(v[ks][0], M, a[ks][0][1], a[ks][1][1],
                               a[ks][2][1]);
          split_grid<kNoSplit>(v[ks][1], M, a[ks][0][3], a[ks][1][3],
                               a[ks][2][3]);
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            a[ks][p][2] = a[ks][p][1];
            if (ks > 0) a[ks][p][0] = a[ks > 0 ? ks - 1 : 0][p][3];
          }
        }
      } else {
        // each fragment row's grid over the whole fold (m[0]: row g,
        // m[1]: row g + 8), from the quad's max: every lane runs the
        // shuffles
        float m[2] = {0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            m[h] = fmaxf(m[h], absmax4(pair(ks, h), pair(ks, h + 2)));
        }
        const float M[2] = {grid_magic<kNoSplit>(m[0]),
                            grid_magic<kNoSplit>(m[1])};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split_grid<kNoSplit>(pair(ks, q), M[q & 1], a[ks][0][q],
                                 a[ks][1][q], a[ks][2][q]);
        }
      }
      reg_fence(acc);
      reg_fence(lo);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const unsigned kb = b_s + (f * KS + ks) * 32;
        if constexpr (BN == 8) {
          // [s0 | s1 | s2 | bf16(skT_lo)], two columns each: column block
          // 0 of x0's product is the big pair, the rest small pairs
          const uint64_t sc = desc_sw128(kb + P * BN * TK * 2);
          Mma<BN>::run(acc, a[ks][0], sc, ks);  // fresh on the fold's first
          if constexpr (!kNoSmall) {
            Mma<BN>::run(lo, a[ks][1], sc, 1);
            Mma<BN>::run(lo, a[ks][2], sc, 1);
          }
        } else {
          const uint64_t s0 = desc_sw128(kb);
          const uint64_t s1 = desc_sw128(kb + BN * TK * 2);
          const uint64_t s2 = desc_sw128(kb + 2 * BN * TK * 2);
          Mma<BN>::run(acc, a[ks][0], s0, ks);  // fresh on the fold's first
          if constexpr (!kNoSmall) {
            Mma<BN>::run(lo, a[ks][0], s1, 1);
            Mma<BN>::run(lo, a[ks][1], s0, 1);
            Mma<BN>::run(lo, a[ks][0], s2, 1);
            Mma<BN>::run(lo, a[ks][1], s1, 1);
            Mma<BN>::run(lo, a[ks][2], s0, 1);
            if constexpr (P == 4)
              Mma<BN>::run(lo, a[ks][0], desc_sw128(kb + 3 * BN * TK * 2), 1);
          }
        }
      }
      wg_commit();
      wg_wait0();
      reg_fence(acc);
      reg_fence(lo);
      // (the 8-column tile: lanes tq > 0 fold their slice's small pair
      // x0*s_tq the same way, into their own hi and lo)
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if constexpr (kNoFold) {
          hi[i] = __fadd_rn(hi[i], acc[i]);
        } else {
          float sum, e;
          two_sum(hi[i], acc[i], sum, e);
          hi[i] = sum;
          lo[i] = __fadd_rn(lo[i], e);
        }
      }
    }
    // once a k-tile, lo moves into hi (Fast2Sum: |hi| >= |lo| but where
    // the folds so far cancel): lo keeps within an ulp of hi, so the
    // tensor cores, which truncate each small-pair sum they add into lo,
    // truncate at that scale (a lo grown over all of D would put a bias
    // on y)
    if constexpr (!kNoFold) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float sum = __fadd_rn(hi[i], lo[i]);
        lo[i] = __fsub_rn(lo[i], __fsub_rn(sum, hi[i]));
        hi[i] = sum;
      }
    }
    // this warpgroup is done with the slot; thread 0 refills it with
    // tile t + ST once the other warpgroup is too
    mbar_arrive(empty + slot);
    if (tid == 0 && t + ST < t_hi) {
      mbar_wait(empty + slot, (u / ST) & 1);
      load_b(t + ST);
    }
  }

  // accumulator layout: fragment j holds columns 8j..8j+7; rows g and g+8
  // of the warp's 16
  const int row0 = wg * 64 + wq * 16 + g;
  if constexpr (BN == 8) {
    // a row's small-pair sums lie across the quad (column 2tq + j holds
    // slice tq's, as hi + lo): add them into the lo of the thread that
    // holds columns 0, 1
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      float v = tq == 0 ? lo[e] : __fadd_rn(hi[e], lo[e]);
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
      lo[e] = v;
    }
    if (tq != 0) return;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = r0 + row0 + (e >> 1) * 8;
      const int col = col_t * BN + 8 * j + 2 * tq + (e & 1);
      if (r < r_end && col < O)
        y[r * O + col] = __fadd_rn(hi[4 * j + e], lo[4 * j + e]);
    }
  }
}

template <int BN, int FOLD, int P>
cudaError_t launch_split(cudaStream_t s, const float* xp, long long ldx,
                         long long x0, long long n_x, const bf16* parts,
                         const int* band, float* y, int C, int n_win, int I,
                         int D, int O, int n_kt, int vec) {
  const long long R = static_cast<long long>(C) * n_win;
  const int n_col = (O + BN - 1) / BN;
  const bool stretch = BN == 8 && I <= MAX_STRETCH_I;
  const int n_mt = stretch ? (n_win + BM - 1) / BM : 0;
  const long long row_tiles =
      stretch ? static_cast<long long>(C) * n_mt : (R + BM - 1) / BM;
  const long long blocks = row_tiles * n_col;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  // one warpgroup's stretch, rounded to whole 16-byte rows
  const int a_stage = stretch ? 2 * ((63 * I + TK + 3) / 4 * 4) : A_ROWS;
  // 16-byte copies, as the caller asks (ops/pallas_frac.py::copy_width),
  // only where every row's window and x's first column of every channel
  // start 16-byte aligned
  if (vec && !(reinterpret_cast<uintptr_t>(xp) % 16 == 0 && ldx % 4 == 0 &&
               I % 4 == 0 && (x0 & 3) == 0))
    return cudaErrorInvalidValue;
  const size_t smem = Smem<BN, P>::bytes(a_stage);
  auto* kern = frac_split_kernel<BN, FOLD, P>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), NT, smem, s>>>(
      xp, ldx, x0, n_x, parts, band, y, R, n_win, I, D, O, n_kt, n_col, vec,
      a_stage, n_mt);
  return cudaGetLastError();
}

}  // namespace split

// ---------------------------------------------------------------------------
// float64: FMA on the CUDA cores

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int BM, int BN, int BK, bool HAS_LO>
struct Smem {
  static constexpr int APAD = BM + 4;  // keeps each row of As 16-byte aligned
  static constexpr int A = BK * APAD;  // elements of one A stage
  static constexpr int B = BK * BN;    // elements of one B stage
  static constexpr size_t rows = BM * (sizeof(long long) + sizeof(int2));
  static constexpr size_t bytes =
      rows + 2 * (A + B * (HAS_LO ? 2 : 1)) * sizeof(T);
};

template <typename T, int BM, int BN, int BK, int TM, int TN, int FOLD,
          bool HAS_LO>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
frac_whole_kernel(const T* __restrict__ xp, long long ldx, long long x0,
                  long long n_x, const T* __restrict__ skT,
                  const T* __restrict__ skT_lo,
                  T* __restrict__ y, long long R, int n_win, int I, int D,
                  int O, int n_col_tiles) {
  using S = Smem<T, BM, BN, BK, HAS_LO>;
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int APAD = S::APAD;
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0, "tile/threads");
  static_assert(NT % BK == 0 && NT % BN == 0, "load mapping");
  static_assert(S::rows % 16 == 0, "stage alignment");
  // two stages of each slab: the next slab's copies run under this one's
  // FMAs
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_base = reinterpret_cast<long long*>(smem_raw);
  int2* row_span = reinterpret_cast<int2*>(row_base + BM);
  T* As = reinterpret_cast<T*>(smem_raw + S::rows);  // [2][BK][APAD]
  T* Bs = As + 2 * S::A;                                             // [2][BK][BN]
  T* Bl = Bs + 2 * S::B;  // [2][BK][BN], HAS_LO only

  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const int col_t = static_cast<int>(tile % n_col_tiles);
  const long long r0 = (tile / n_col_tiles) * BM;
  const int j0 = col_t * BN;

  for (int i = tid; i < BM; i += NT) {
    const long long r = r0 + i;
    long long b = 0;
    int2 sp = make_int2(0, 0);
    if (r < R) {
      const long long c = r / n_win;
      const long long p = x0 + (r - c * n_win) * static_cast<long long>(I);
      b = c * ldx + p;
      sp = window_span(p, n_x, D);
    }
    row_base[i] = b;
    row_span[i] = sp;
  }
  __syncthreads();

  // Start the copies of slab [d0, d0 + BK) into stage `st`: A transposed to
  // As[kk][row] (lanes along d, coalesced), B as Bs[kk][j] (lanes along j);
  // out-of-range elements (past D or R, outside x) are written as zeros.
  auto load_slab = [&](int st, int d0) {
    T* as = As + st * S::A;
#pragma unroll
    for (int it = 0; it < BM * BK / NT; ++it) {
      const int e = it * NT + tid;
      const int kk = e % BK;
      const int i = e / BK;
      const int d = d0 + kk;
      const int2 sp = row_span[i];
      const bool ok = d >= sp.x && d < sp.y;
      cp_async_elem(as + kk * APAD + i, ok ? xp + row_base[i] + d : skT, ok);
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

  // fold the partials into (hi, lo): two_sum(hi, acc) -> (hi, lo += err)
  static_assert(BK % FOLD == 0, "fold within a slab");
  auto fold = [&]() {
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
  };

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
      if ((kk + 1) % FOLD == 0) fold();
    }
    // every warp is done with stage st before the next iteration refills it
    __syncthreads();
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

template <typename T, int BM, int BN, int BK, int TM, int TN, int FOLD,
          bool HAS_LO>
cudaError_t launch_one(unsigned blocks, cudaStream_t s, const T* xp,
                       long long ldx, long long x0, long long n_x,
                       const T* skT, const T* skT_lo, T* y, long long R,
                       int n_win, int I, int D, int O, int n_col) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr size_t smem = Smem<T, BM, BN, BK, HAS_LO>::bytes;
  auto* kern = frac_whole_kernel<T, BM, BN, BK, TM, TN, FOLD, HAS_LO>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<blocks, NT, smem, s>>>(xp, ldx, x0, n_x, skT, skT_lo, y, R, n_win,
                                I, D, O, n_col);
  return cudaGetLastError();
}

template <typename T, int BM, int BN, int BK, int TM, int TN, int FOLD>
int launch(const T* xp, long long ldx, long long x0, long long n_x,
           const T* skT, const T* skT_lo, T* y, int C, int n_win, int I,
           int D, int O, void* stream) {
  if (C < 0 || n_win < 1 || I < 1 || D < 1 || O < 1 || ldx < 0 || n_x < 0)
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
          ? launch_one<T, BM, BN, BK, TM, TN, FOLD, true>(
                nb, s, xp, ldx, x0, n_x, skT, skT_lo, y, R, n_win, I, D, O,
                n_col)
          : launch_one<T, BM, BN, BK, TM, TN, FOLD, false>(
                nb, s, xp, ldx, x0, n_x, skT, skT_lo, y, R, n_win, I, D, O,
                n_col);
  return static_cast<int>(e);
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns the launch's cudaError_t.
// xp: x [C, n_x] float32 with row stride ldx elements, read from the signed
// window origin x0 (window m of channel c: columns x0 + m*I + [0, D)),
// zero outside [0, n_x); parts:
// the packed bf16 operator slices [n_col_tiles, n_kt, n_parts, bn, 64]
// (ops/pallas_frac.py::operator_parts; n_parts 3, or 4 with bf16(skT_lo));
// band: int32 [n_col_tiles, 2], each column tile's first and one past its
// last nonzero k16 step of D (operator_band); y: [C, n_win*O] row-major.
// fold: the terms of one big-pair partial, 16 or 32.  vec: 1 to stage
// the windows with 16-byte copies (refused where x, x0, I or ldx do not
// allow them), 0 for 8-byte copies on the rows that allow them.
extern "C" int r8b_frac_whole_f32(const float* xp, long long ldx,
                                  long long x0, long long n_x,
                                  const void* parts, const int* band,
                                  int n_parts, int bn, int n_kt, float* y,
                                  int C, int n_win, int I, int D, int O,
                                  int fold, int vec, void* stream) {
  using split::TK;
  if (C < 0 || n_win < 1 || I < 1 || D < 1 || O < 1 || ldx < 0 || n_x < 0 ||
      n_kt * TK < D || n_kt > D / TK + 1 || band == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* pb = static_cast<const bf16*>(parts);
#define R8B_SPLIT(BN_, FOLD_, P_)                                    \
  if (bn == BN_ && fold == FOLD_ && n_parts == P_)                   \
    return static_cast<int>(split::launch_split<BN_, FOLD_, P_>(     \
        s, xp, ldx, x0, n_x, pb, band, y, C, n_win, I, D, O, n_kt, vec));
  R8B_SPLIT(128, 32, 3)
  R8B_SPLIT(128, 32, 4)
  R8B_SPLIT(128, 16, 3)
  R8B_SPLIT(128, 16, 4)
  R8B_SPLIT(64, 32, 3)
  R8B_SPLIT(64, 32, 4)
  R8B_SPLIT(64, 16, 3)
  R8B_SPLIT(64, 16, 4)
  R8B_SPLIT(8, 32, 3)
  R8B_SPLIT(8, 32, 4)
  R8B_SPLIT(8, 16, 3)
  R8B_SPLIT(8, 16, 4)
#undef R8B_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

// xp: x [C, n_x] float64 with row stride ldx, read from the signed window
// origin x0, zero outside [0, n_x); skT, skT_lo: [D, O] row-major (skT_lo
// may be null); y: [C, n_win*O] row-major.
extern "C" int r8b_frac_whole_f64(const double* xp, long long ldx,
                                  long long x0, long long n_x,
                                  const double* skT, const double* skT_lo,
                                  double* y, int C, int n_win, int I, int D,
                                  int O, void* stream) {
  return launch<double, 64, 64, 16, 4, 4, 16>(xp, ldx, x0, n_x, skT, skT_lo,
                                              y, C, n_win, I, D, O, stream);
}
