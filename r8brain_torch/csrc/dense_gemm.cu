// Dense float32 GEMM at the precision of the TPU's HIGHEST dot, on the
// tensor cores (wgmma), for sm_90a: a scouting kernel.
//
//     C[m, n] = sum_k A[m, k] * B[k, n]
//
// With SEG, K is cut into segments of `hop` rows; each segment sums into a
// fresh accumulator and the segments are added in float32.
//
// Replaces the reference package's TPU scouting kernels
// tools/exp_pallas_gemm.py::pallas_gemm and
// tools/exp_framed_kernel.py::make_gemm (plain, and seg_k=True): a dense
// f32 dot at Precision.HIGHEST, which measured the GEMM ceiling of the
// chip at the conv stage's Toeplitz shape (M = 175104, K = 704, N = 512).
// No package code calls it; chip_smoke.py and the tools
// tools/torch_exp_framed_kernel.py and tools/torch_gemm_ablation.py time
// it beside torch.matmul.
//
// Arithmetic: the TPU's HIGHEST dot is six bf16 passes.  A and B are each
// split exactly into three bf16 slices, x = x0 + x1 + x2 (each slice the
// nearest bf16 to what the ones before left; exact for float32 in bf16's
// normal range), every slice product is exact in float32, and the 6 pairs
// with p+q <= 2 are summed in float32 (the dropped ones are below 2^-26 of
// a product).  The tensor cores truncate their float32 sums, so one
// accumulator chained over all of K would lose ~2^-23 of its size a step
// (264 steps at K = 704): each `fold` k-values (64, or the segment) sum
// into a fresh accumulator (wgmma scale-d = 0), added into the total with
// round-to-nearest float32 adds on the CUDA cores.  mt, the reference's M
// tile, is accepted by the wrapper and changes nothing.
//
// What bounds it: operations.  The conv shape is 6 * 2MKN = 7.6e11 bf16
// flop (0.77 ms at 989 TFLOP/s) against 0.86 GB of compulsory traffic
// (0.26 ms); float32 FMA on the CUDA cores would be bound at 1.9 ms.
//
// Design:
//   * B, the small operand, is split and packed once per call by the
//     wrapper (ops/scout.py::pack_b: three bf16 slices, K-major, 128-byte
//     swizzled, one contiguous block per 128-column tile and 64-deep
//     k-tile), so one TMA bulk copy moves a k-tile of B (48 KB).
//   * A arrives by TMA tensor copies (a tensor map over [M, K] float32,
//     128-byte swizzle, two 32-column boxes a 64-deep k-tile; the copy
//     engine zero-fills rows past M and columns past K, so ragged shapes
//     need no masks; K must be a multiple of 4, else the wrapper pads A).
//   * A CTA is three warpgroups: a producer (one thread starts the copies;
//     setmaxnreg gives its registers to the others) and two consumers, each
//     64 rows x 128 columns of a 128 x 128 tile of C.  A is ringed in 3
//     stages (32 KB each), B in 2 (48 KB): 192 KB, one CTA an SM.  CTAs are
//     persistent (one an SM), walking tiles with the column tile fastest,
//     so the four column tiles of a row tile run at once and read A from
//     HBM once; the producer runs ahead into the next tile while the
//     consumers store the last one.
//   * A consumer reads its k-tile of A from shared memory as float pairs
//     (the swizzle keeps the reads free of bank conflicts), splits them
//     into three bf16 fragment sets in registers, and starts the 24
//     m64n128k16 MMAs of the k-tile (A from registers, B's slices from
//     shared memory), commits, waits, frees the slots and, at a fold's
//     end, adds the accumulator into the total.  The other consumer's MMAs
//     run while one splits and folds.
//   * Folds every 64 k-values (or every `hop` under SEG) keep the MMAs of
//     a whole k-tile in one batch; a SEG length that is no multiple of 64
//     takes a build that batches and folds by k16 step.

#include <cuda.h>

#include <climits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;        // rows a tile: two consumer warpgroups of 64
constexpr int BN = 128;        // columns a tile
constexpr int TK = 64;         // k a k-tile (one 128-byte bf16 row of B)
constexpr int BOX_K = 32;      // floats a TMA box row (128 bytes)
constexpr int A_ST = 3;        // stages of A
constexpr int B_ST = 2;        // stages of B
constexpr int NT = 384;        // producer + two consumer warpgroups
constexpr int A_STAGE = BM * TK * 4;      // bytes
constexpr int B_STAGE = 3 * BN * TK * 2;  // bytes: three slices
constexpr int SMEM = A_ST * A_STAGE + B_ST * B_STAGE + 2 * (A_ST + B_ST) * 8 +
                     1024;  // + alignment

// Ablation, for tools/torch_gemm_ablation.py only: a build with
// -DR8B_ABLATE=mask drops parts of the work (its output is then wrong) so
// that the rest can be timed.  Bits: 1 the split (x1 = x2 = x0), 2 the
// stores (the sums still computed), 4 the A fragment reads and the split
// (MMAs on fixed registers), 8 the small-pair MMAs (the big pair alone).
#ifndef R8B_ABLATE
#define R8B_ABLATE 0
#endif
constexpr bool kNoSplit = R8B_ABLATE & 1;
constexpr bool kNoStore = R8B_ABLATE & 2;
constexpr bool kNoFrag = R8B_ABLATE & 4;
constexpr bool kNoSmall = R8B_ABLATE & 8;

// the three bf16 slices of a float pair, as packed fragment registers (the
// lower column in the low half): x0 = bf16_rn(v), x1 = bf16_rn(v - x0), x2
// = bf16_rn(v - x0 - x1), each difference exact
__device__ __forceinline__ void split3(float2 v, uint32_t& a0, uint32_t& a1,
                                       uint32_t& a2) {
  const __nv_bfloat162 h0 = __float22bfloat162_rn(v);
  if constexpr (kNoSplit) {
    a0 = a1 = a2 = bits(h0);
    return;
  }
  const float2 f0 = __bfloat1622float2(h0);
  const float2 r = make_float2(__fsub_rn(v.x, f0.x), __fsub_rn(v.y, f0.y));
  const __nv_bfloat162 h1 = __float22bfloat162_rn(r);
  const float2 f1 = __bfloat1622float2(h1);
  const __nv_bfloat162 h2 = __float22bfloat162_rn(
      make_float2(__fsub_rn(r.x, f1.x), __fsub_rn(r.y, f1.y)));
  a0 = bits(h0);
  a1 = bits(h1);
  a2 = bits(h2);
}

// one TMA tensor copy of the box at (k, m) into shared memory, completing
// on `bar`'s transaction count
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int k, int m, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(m),
      "r"(smem_u32(bar))
      : "memory");
}

// KB: k16 steps a batch of MMAs (4: a whole k-tile; 1: folds may end at
// any step).  fold: k-values a fresh accumulator sums (a multiple of
// 16*KB).
template <int KB>
__global__ void __launch_bounds__(NT, 1)
dense_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                  const bf16* __restrict__ b_packed, float* __restrict__ C,
                  int M, int K, int N, int fold, int n_col, int n_tiles,
                  int vec) {
  constexpr int KS = 4;  // k16 steps a k-tile
  extern __shared__ unsigned char smem_raw[];
  // TMA's and wgmma's 128-byte swizzle atoms need 1024-byte alignment
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* As = base;                          // [A_ST][2][BM][32] f32
  unsigned char* Bs = base + A_ST * A_STAGE;         // [B_ST][3][BN][TK] bf16
  uint64_t* bar = reinterpret_cast<uint64_t*>(Bs + B_ST * B_STAGE);
  uint64_t* full_a = bar;
  uint64_t* empty_a = full_a + A_ST;
  uint64_t* full_b = empty_a + A_ST;
  uint64_t* empty_b = full_b + B_ST;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < A_ST; ++s) {
      mbar_init(full_a + s, 1);
      mbar_init(empty_a + s, 256);
    }
    for (int s = 0; s < B_ST; ++s) {
      mbar_init(full_b + s, 1);
      mbar_init(empty_b + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_kt = (K + TK - 1) / TK;
  const int wg = tid >> 7;
  if (wg == 0) {
    // producer: one thread keeps the rings full, for every k-tile of every
    // tile of this CTA; a slot is refilled once both consumers freed it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 0) return;
    long long it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile / n_col) * BM;
      const bf16* b_src = b_packed + static_cast<long long>(tile % n_col) *
                                         n_kt * (B_STAGE / 2);
      for (int t = 0; t < n_kt; ++t, ++it) {
        const int sa = static_cast<int>(it % A_ST);
        const int sb = static_cast<int>(it % B_ST);
        mbar_wait(empty_a + sa, static_cast<unsigned>((it / A_ST) & 1) ^ 1);
        mbar_expect_tx(full_a + sa, A_STAGE);
        unsigned char* a_dst = As + sa * A_STAGE;
        tma_load_2d(a_dst, &a_map, t * TK, m0, full_a + sa);
        tma_load_2d(a_dst + A_STAGE / 2, &a_map, t * TK + BOX_K, m0,
                    full_a + sa);
        mbar_wait(empty_b + sb, static_cast<unsigned>((it / B_ST) & 1) ^ 1);
        mbar_expect_tx(full_b + sb, B_STAGE);
        bulk_g2s(Bs + sb * B_STAGE,
                 b_src + static_cast<long long>(t) * (B_STAGE / 2), B_STAGE,
                 full_b + sb);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;  // consumer 0 or 1: rows 64*cw .. of the tile
  const int tw = tid & 127;
  const int wq = tw >> 5, lane = tw & 31, g = lane >> 2, tq = lane & 3;
  // this thread's rows in the tile (g and g + 8 of its warp's 16): their
  // byte offsets in a box (128 bytes a row) and the swizzle of the row
  const int r_lo = cw * 64 + wq * 16 + g;
  const int sw = r_lo & 7;  // r_lo + 8 has the same
  constexpr int NR = BN / 2;  // accumulator floats a thread

  float acc[NR], tot[NR];
  uint32_t a[KB][3][4];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.0f;
  if constexpr (kNoFrag) {
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[kb][p][q] = 0;
  }
  long long it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
#pragma unroll
    for (int i = 0; i < NR; ++i) tot[i] = 0.0f;
    bool fresh = true;
    for (int t = 0; t < n_kt; ++t, ++it) {
      const int sa = static_cast<int>(it % A_ST);
      const int sb = static_cast<int>(it % B_ST);
      mbar_wait(full_a + sa, static_cast<unsigned>((it / A_ST) & 1));
      mbar_wait(full_b + sb, static_cast<unsigned>((it / B_ST) & 1));
      const unsigned char* a_s = As + sa * A_STAGE + r_lo * 128;
      const unsigned b_s = smem_u32(Bs + sb * B_STAGE);
#pragma unroll
      for (int bt = 0; bt < KS / KB; ++bt) {
        // the batch's A fragments, split into three bf16 sets: all written
        // before its MMAs start (no register of an MMA in flight changes)
        if constexpr (!kNoFrag) {
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            const int c = (bt * KB + kb) * 16 + 2 * tq;  // column of pair 0
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              // pairs: (row g, c), (row g+8, c), (row g, c+8), (row g+8, c+8)
              const int cc = c + (q >> 1) * 8;
              const unsigned char* p = a_s + (q & 1) * 8 * 128 +
                                       (cc >> 5) * (A_STAGE / 2) +
                                       ((((cc & 31) >> 2) ^ sw) << 4) +
                                       (cc & 3) * 4;
              split3(*reinterpret_cast<const float2*>(p), a[kb][0][q],
                     a[kb][1][q], a[kb][2][q]);
            }
          }
        }
        reg_fence(acc);
        wg_fence();
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          const unsigned kk = b_s + ((bt * KB + kb) * 16) * 2;
          const uint64_t s0 = desc_sw128(kk);
          const uint64_t s1 = desc_sw128(kk + BN * TK * 2);
          const uint64_t s2 = desc_sw128(kk + 2 * BN * TK * 2);
          // a fold's first MMA starts the accumulator afresh
          Mma<BN>::run(acc, a[kb][0], s0, (fresh && kb == 0) ? 0 : 1);
          if constexpr (!kNoSmall) {
            Mma<BN>::run(acc, a[kb][0], s1, 1);
            Mma<BN>::run(acc, a[kb][1], s0, 1);
            Mma<BN>::run(acc, a[kb][0], s2, 1);
            Mma<BN>::run(acc, a[kb][1], s1, 1);
            Mma<BN>::run(acc, a[kb][2], s0, 1);
          }
        }
        wg_commit();
        wg_wait0();
        reg_fence(acc);
        fresh = false;
        const int k_end = t * TK + (bt + 1) * KB * 16;
        if (k_end % fold == 0 || k_end >= K) {
#pragma unroll
          for (int i = 0; i < NR; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
          fresh = true;
        }
      }
      // both slots read: free them for the producer
      mbar_arrive(empty_a + sa);
      mbar_arrive(empty_b + sb);
    }
    if constexpr (kNoStore) {
      // the sums stay live (ptxas drops MMAs whose results nothing reads):
      // one store that never happens (M >= 0 always)
      float x = 0.0f;
#pragma unroll
      for (int i = 0; i < NR; ++i) x += tot[i];
      if (M < 0) C[0] = x;
      continue;
    }
    // accumulator layout: fragment j holds columns 8j..8j+7; rows g and g+8
    const long long row = static_cast<long long>(tile / n_col) * BM + r_lo;
    const int col0 = (tile % n_col) * BN + 2 * tq;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row + 8 * h;
        if (r >= M) continue;
        float* dst = C + r * N + col;
        if (vec) {
          if (col < N)
            *reinterpret_cast<float2*>(dst) =
                make_float2(tot[4 * j + 2 * h], tot[4 * j + 2 * h + 1]);
        } else {
          if (col < N) dst[0] = tot[4 * j + 2 * h];
          if (col + 1 < N) dst[1] = tot[4 * j + 2 * h + 1];
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled looked up through the CUDA runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns the launch's cudaError_t.
// A: [M, K] float32, row-major, contiguous, 16-byte aligned, K a multiple
// of 4; b_packed: B [K, N] as ops/scout.py::pack_b lays it out
// ([ceil(N/128)][ceil(K/64)][3][128][64] bfloat16); C: [M, N] float32,
// contiguous; fold: k-values a fresh accumulator sums, a positive multiple
// of 16 (64 for one K loop, the segment length under SEG).
extern "C" int r8b_dense_gemm_f32(const float* A, const void* b_packed,
                                  float* C, int M, int K, int N, int fold,
                                  void* stream) {
  if (M < 0 || K < 1 || N < 1 || K % 4 != 0 || fold < 16 || fold % 16 != 0 ||
      reinterpret_cast<uintptr_t>(A) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 4};
  const cuuint32_t box[2] = {BOX_K, BM};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(A), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_col = (N + BN - 1) / BN;
  const long long n_tiles = static_cast<long long>((M + BM - 1) / BM) * n_col;
  if (n_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  const int vec = N % 2 == 0 && reinterpret_cast<uintptr_t>(C) % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const bf16*>(b_packed);
  auto* kern = fold % TK == 0 ? dense_gemm_kernel<4> : dense_gemm_kernel<1>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, NT, SMEM, s>>>(map, bp, C, M, K, N, fold, n_col,
                              static_cast<int>(n_tiles), vec);
  return static_cast<int>(cudaGetLastError());
}
