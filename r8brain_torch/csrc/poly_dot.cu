// The polynomial stage's fast contraction (FracPolyExec, engine "banded",
// precision "fast", no seam residual, no pair), for sm_90a:
//
//     y[c, n] = sum_{i < fl} x[c, starts[n] + i] * taps[n, i]
//
// with x read as 0 outside [0, N).  x: [C, N] float32, unit stride along
// time, any row stride; starts: [M] int32 in x's own coordinates; taps:
// [M, fl] float32 (output n's spline filter, its float64 values rounded
// once); y: [C, M] contiguous.
//
// Replaces no TPU kernel: the reference package's polynomial stage
// (r8brain_tpu/ops/stages.py, FracPolyExec) is XLA.  Its banded form (a
// padded copy of the input, drift chunks of batched float32 matmuls against
// operators of W rows of which fl are nonzero, adds, reshape copies and a
// concatenation) ran on the card as some 30 launches and 11x the
// multiply-adds.  This kernel computes the same dot in one launch; its
// plain version is r8brain_torch/ops/poly_dot.py::poly_dot_ref.
//
// What bounds it: bytes.  At 44.1k -> 96001 (C = 1024, N ~ 88.6k, M =
// 48256, fl = 24) x is read once (363 MB), y written once (198 MB), the
// taps 4.6 MB: 0.169 ms at 3.35 TB/s, against 1.18 G multiply-adds (0.035
// ms on the CUDA cores).  Read from shared memory once a multiply-add, x
// alone would take 4.7 GB of shared-memory reads, about 0.16 ms at the
// card's 128 bytes a clock an SM: as long as the bound.  The design:
//   * a block takes TILE = 64 outputs and walks up to GROUPS = 16 channel
//     groups of CB = 64.  It reads the tile's starts and taps once.  Each
//     group's box of x, [64 channels, xs samples from the tile's first
//     window rounded down to 16 bytes], arrives in shared memory by one TMA
//     tensor copy (zeros outside [0, N) and past C), the next group's in
//     flight while the block computes the current one (two buffers, one
//     mbarrier).  Where x is not 16-byte aligned, or a box would be wider
//     than 256 samples, cp.async element copies take its place.  (Element
//     copies, or one bulk copy a row, cost the block more instructions and
//     read x at 2.2 to 2.6 TB/s.)
//   * warp w owns outputs 8w ... 8w + 7 of the tile, lane l channels l and
//     l + 32 of the group.  A run of outputs whose windows start at offsets
//     rising within DA samples of a 16-byte-aligned origin shares a
//     register window of WA = fl + DA samples a channel, read with 16-byte
//     loads (rows lie 4 mod 32 words apart: each quarter-warp reads 8
//     distinct bank quads).  The runs are found once a tile, as an origin
//     and a mask of offsets; each output reads the window at its offset d,
//     a compile-time index in one of DA + 1 unrolled chains walked forward
//     (d is the same across the warp: no branch diverges; a jump table an
//     output cost as much again as the multiply-adds).  Each output is one
//     fmaf chain a channel in tap order i = 0 ... fl - 1 in float32, the
//     taps read once a pair of channels (a broadcast).  The register
//     windows are built for the planner's filter lengths, fl even from 8
//     to 28; any other fl takes the same chain with every sample read
//     from shared memory.
//   * the outputs pass through shared memory and leave as one TMA bulk copy
//     a channel row, draining while the block goes on (coalesced stores
//     where y's rows are not 16-byte aligned).
// HBM traffic is x once (a tile's overlap with the next comes from L2) and
// y once.

#include <climits>
#include <cstdint>
#include <cstring>

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;          // threads a block
constexpr int NW = NT / 32;      // warps a block
constexpr int RUN = 8;           // outputs a warp owns
constexpr int TILE = NW * RUN;   // outputs a block
constexpr int CB = 64;           // channels a group: two a lane
constexpr int GROUPS = 16;       // channel groups a block walks, at most
constexpr int YS = TILE + 4;     // the output tile's row stride: 16-byte rows
constexpr int PAD = 20;          // room for a register window past a span

// the register window of fl = FL: WA samples, offsets 0 ... DA (DA 16 to
// 18 up to fl = 24, 12 to 14 above, within 128 registers a thread)
template <int FL>
struct Win {
  static constexpr int WA = (FL + (FL > 24 ? 12 : 16) + 3) & ~3;
  static constexpr int DA = WA - FL;
  static_assert(DA <= PAD, "a window reads past the row");
};

__host__ __device__ inline int taps_stride(int fl) { return (fl + 3) & ~3; }
// an input row: the span from its 16-byte-aligned origin and PAD samples
// of slack (a window reads at most DA - 1 past the span), 4 mod 32 words
__host__ __device__ inline int xs_stride(int width) {
  return ((width + 3 + PAD + 27) / 32) * 32 + 4;
}

// Shared memory of a block, in floats: the taps [TILE, taps_stride], two
// input buffers [CB, xs_stride], the outputs [CB, YS], the starts [TILE].
__host__ __device__ inline size_t smem_floats(int fl, int width) {
  return static_cast<size_t>(TILE) * taps_stride(fl) +
         2 * static_cast<size_t>(CB) * xs_stride(width) +
         static_cast<size_t>(CB) * YS + TILE;
}

// One output's chains for the lane's two channels from the register
// window at offset D.
template <int FL, int D>
__device__ __forceinline__ void chain(const float (&w0)[Win<FL>::WA],
                                      const float (&w1)[Win<FL>::WA],
                                      const float* hk, float& a0,
                                      float& a1) {
  a0 = 0.0f;
  a1 = 0.0f;
  if constexpr (FL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < FL; i += 4) {
      const float4 h = *reinterpret_cast<const float4*>(hk + i);
      a0 = fmaf(w0[D + i], h.x, a0);
      a1 = fmaf(w1[D + i], h.x, a1);
      a0 = fmaf(w0[D + i + 1], h.y, a0);
      a1 = fmaf(w1[D + i + 1], h.y, a1);
      a0 = fmaf(w0[D + i + 2], h.z, a0);
      a1 = fmaf(w1[D + i + 2], h.z, a1);
      a0 = fmaf(w0[D + i + 3], h.w, a0);
      a1 = fmaf(w1[D + i + 3], h.w, a1);
    }
  } else {
#pragma unroll
    for (int i = 0; i < FL; i += 2) {
      const float2 h = *reinterpret_cast<const float2*>(hk + i);
      a0 = fmaf(w0[D + i], h.x, a0);
      a1 = fmaf(w1[D + i], h.x, a1);
      a0 = fmaf(w0[D + i + 1], h.y, a0);
      a1 = fmaf(w1[D + i + 1], h.y, a1);
    }
  }
}

// The outputs of a run from k on, one at each offset D set in `mask` (the
// offsets rise along the run): for each D in turn, its output's chains.
template <int FL, int D = 0>
__device__ __forceinline__ void run_chains(int& k, unsigned mask,
                                           const float (&w0)[Win<FL>::WA],
                                           const float (&w1)[Win<FL>::WA],
                                           const float* taps_s, float* y0,
                                           float* y1) {
  constexpr int flp = (FL + 3) & ~3;
  if (mask & (1u << D)) {
    float a0, a1;
    chain<FL, D>(w0, w1, taps_s + k * flp, a0, a1);
    y0[k] = a0;
    y1[k] = a1;
    ++k;
  }
  if constexpr (D < Win<FL>::DA)
    if (mask >> (D + 1))
      run_chains<FL, D + 1>(k, mask, w0, w1, taps_s, y0, y1);
}

// one TMA tensor copy of the box at (col, row) into shared memory,
// completing on `bar`'s transaction count
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// FL > 0: fl == FL, the register windows; FL == 0: any fl, every sample
// read from shared memory.  bulk: x_map is x's tensor map with a
// box of [CB rows, xs samples] (TMA), else cp.async elements.
template <int FL>
__global__ void __launch_bounds__(NT, 2)
    poly_dot_kernel(const __grid_constant__ CUtensorMap x_map,
                    const float* __restrict__ x, long long ldx, int N,
                    const int* __restrict__ starts,
                    const float* __restrict__ taps, int fl_arg,
                    float* __restrict__ y, int C, int M, int width,
                    int bulk, int bulk_y) {
  extern __shared__ __align__(128) float4 smem_raw[];
  __shared__ int red_lo[NW], red_hi[NW];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int2 runs_s[NW][RUN];  // a warp's runs: (origin - a, offsets)
  __shared__ int nrun_s[NW];
  const int fl = FL > 0 ? FL : fl_arg;
  const int flp = taps_stride(fl);
  const int xs = xs_stride(width);
  float* const taps_s = reinterpret_cast<float*>(smem_raw);
  float* const xbuf = taps_s + TILE * flp;
  float* const ys = xbuf + 2 * CB * xs;
  int* const st_s = reinterpret_cast<int*>(ys + CB * YS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * TILE;
  const int tn = min(TILE, M - n0);
  const int n_groups = (C + CB - 1) / CB;
  if (tid == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the tile's starts, their range and its taps (rows padded to flp)
  int lo = INT_MAX, hi = INT_MIN;
  for (int k = tid; k < tn; k += NT) {
    const int s = starts[n0 + k];
    st_s[k] = s;
    lo = min(lo, s);
    hi = max(hi, s);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    red_lo[warp] = lo;
    red_hi[warp] = hi;
  }
  for (int e = tid; e < tn * flp; e += NT) {
    const int k = e / flp, i = e - k * flp;
    taps_s[e] =
        i < fl ? taps[static_cast<long long>(n0 + k) * fl + i] : 0.0f;
  }
  __syncthreads();
  lo = red_lo[0];
  hi = red_hi[0];
  for (int w = 1; w < NW; ++w) {
    lo = min(lo, red_lo[w]);
    hi = max(hi, red_hi[w]);
  }
  // The tile reads x over [lo, lo + span).  Where the caller's width
  // bounds it (fits), a row holds x over [a, a + na): a = lo rounded down
  // to a multiple of 4, na the span from a rounded up to one (the TMA box,
  // xs samples from a, zeros outside [0, N)); a wider tile stages nothing
  // and reads x from global memory.
  const long long span = static_cast<long long>(hi) - lo + fl;
  const bool fits = span <= width;
  const long long a = static_cast<long long>(lo) - (((lo % 4) + 4) % 4);
  const int na = fits ? static_cast<int>((lo + span - a + 3) & ~3LL) : 0;

  auto stage = [&](int g, float* buf) {
    const int c0 = g * CB, cb = min(CB, C - c0);
    if (bulk) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(&bar, CB * xs * 4);
        tma_load_2d(buf, &x_map, static_cast<int>(a), c0, &bar);
      }
    } else {
      for (int r = warp; r < cb; r += NW) {
        const float* xr = x + static_cast<long long>(c0 + r) * ldx;
        float* sr = buf + r * xs;
        for (int j = lane; j < na; j += 32) {
          const long long p = a + j;
          const bool in = p >= 0 && p < N;
          cp_async_elem(sr + j, in ? xr + p : xr, in);
        }
      }
      cp_async_commit();
    }
  };

  // Each warp's runs, the same for every group: from output k, the
  // outputs whose windows start at offsets rising strictly within [0, DA]
  // of the 16-byte-aligned origin at or below k's
  const int k0 = warp * RUN, kend = min(k0 + RUN, tn);
  const int ai = static_cast<int>(a);
  if constexpr (FL > 0) {
    if (lane == 0 && fits) {
      int n = 0;
      for (int k = k0; k < kend;) {
        const int base = ai + ((st_s[k] - ai) & ~3);
        unsigned mask = 1u << (st_s[k] - base);
        int ke = k + 1;
        for (; ke < kend && st_s[ke] > st_s[ke - 1] &&
               st_s[ke] - base <= Win<FL>::DA;
             ++ke)
          mask |= 1u << (st_s[ke] - base);
        runs_s[warp][n++] = make_int2(base - ai, static_cast<int>(mask));
        k = ke;
      }
      nrun_s[warp] = n;
    }
    __syncwarp();
  }

  int g = blockIdx.y, b = 0;
  unsigned phase = 0;
  if (fits && g < n_groups) stage(g, xbuf);
  for (; g < n_groups; g += gridDim.y, b ^= 1) {
    if (fits) {
      if (bulk) {
        mbar_wait(&bar, phase);
        phase ^= 1;
      } else {
        cp_async_wait<0>();
      }
    }
    if (bulk_y && tid < CB)  // the last group's rows have left ys
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();
    const int gn = g + gridDim.y;
    if (fits && gn < n_groups) stage(gn, xbuf + (b ^ 1) * CB * xs);

    // the warp's outputs (rows of channels past C hold whatever shared
    // memory held: computed, never stored)
    const float* r0 = xbuf + b * CB * xs + lane * xs;
    const float* r1 = r0 + 32 * xs;
    float* y0 = ys + lane * YS;
    float* y1 = y0 + 32 * YS;
    if (!fits) {  // a width too small for this tile: the same fmaf chains
                  // on x read from global memory (right, slower)
      const int c0 = g * CB;
      // rows past C read row C - 1: computed, never stored
      const float* x0 =
          x + static_cast<long long>(min(c0 + lane, C - 1)) * ldx;
      const float* x1 =
          x + static_cast<long long>(min(c0 + lane + 32, C - 1)) * ldx;
      for (int k = k0; k < kend; ++k) {
        const float* hk = taps_s + k * flp;
        const long long s0 = st_s[k];
        float a0 = 0.0f, a1 = 0.0f;
        for (int i = 0; i < fl; ++i) {
          const long long p = s0 + i;
          const bool in = p >= 0 && p < N;
          const float h = hk[i];
          a0 = fmaf(in ? x0[p] : 0.0f, h, a0);
          a1 = fmaf(in ? x1[p] : 0.0f, h, a1);
        }
        y0[k] = a0;
        y1[k] = a1;
      }
    } else if constexpr (FL > 0) {
      constexpr int WA = Win<FL>::WA;
      const int n_runs = nrun_s[warp];
      int k = k0;
      for (int r = 0; r < n_runs; ++r) {
        const int2 run = runs_s[warp][r];
        float w0[WA], w1[WA];
#pragma unroll
        for (int j = 0; j < WA; j += 4) {
          const float4 u = *reinterpret_cast<const float4*>(r0 + run.x + j);
          const float4 v = *reinterpret_cast<const float4*>(r1 + run.x + j);
          w0[j] = u.x;
          w0[j + 1] = u.y;
          w0[j + 2] = u.z;
          w0[j + 3] = u.w;
          w1[j] = v.x;
          w1[j + 1] = v.y;
          w1[j + 2] = v.z;
          w1[j + 3] = v.w;
        }
        run_chains<FL>(k, static_cast<unsigned>(run.y), w0, w1, taps_s, y0,
                       y1);
      }
    } else {
      for (int k = k0; k < kend; ++k) {
        const float* hk = taps_s + k * flp;
        const int o = st_s[k] - ai;
        float a0 = 0.0f, a1 = 0.0f;
        for (int i = 0; i < fl; ++i) {
          const float h = hk[i];
          a0 = fmaf(r0[o + i], h, a0);
          a1 = fmaf(r1[o + i], h, a1);
        }
        y0[k] = a0;
        y1[k] = a1;
      }
    }
    __syncthreads();

    const int c0 = g * CB, cb = min(CB, C - c0);
    if (bulk_y) {
      if (tid < cb) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                y + static_cast<long long>(c0 + tid) * M + n0),
            "r"(smem_u32(ys + tid * YS)), "r"(tn * 4)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      continue;
    }
    for (int r = warp; r < cb; r += NW) {
      float* yr = y + static_cast<long long>(c0 + r) * M + n0;
      const float* sr = ys + r * YS;
      for (int kk = lane; kk < tn; kk += 32) yr[kk] = sr[kk];
    }
  }
  if (bulk_y && tid < CB)  // every row has left ys
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

constexpr int MAX_DEV = 64;

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

template <int FL>
cudaError_t launch(const float* x, long long ldx, int N, const int* starts,
                   const float* taps, int fl, float* y, int C, int M,
                   int width, cudaStream_t s) {
  // the dynamic shared memory this instantiation is allowed, by device
  static int allowed[MAX_DEV] = {0};
  const size_t smem = smem_floats(fl, width) * sizeof(float);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEV) return cudaErrorInvalidDevice;
  if (smem > static_cast<size_t>(allowed[dev])) {
    int max_smem = 0;
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    if (smem + 2 * NW * sizeof(int) + 16 > static_cast<size_t>(max_smem))
      return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(poly_dot_kernel<FL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    allowed[dev] = static_cast<int>(smem);
  }
  const long long n_tiles = (static_cast<long long>(M) + TILE - 1) / TILE;
  const long long n_groups = (static_cast<long long>(C) + CB - 1) / CB;
  const long long gy = (n_groups + GROUPS - 1) / GROUPS;
  if (n_tiles > INT_MAX || gy > 65535) return cudaErrorInvalidValue;
  // x's tensor map: rows of N samples ldx apart, a box of [CB, xs]
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  const int xs = xs_stride(width);
  const EncodeTiled encode = encode_tiled();
  int bulk = encode != nullptr && xs <= 256 &&
             reinterpret_cast<uintptr_t>(x) % 16 == 0 && ldx % 4 == 0;
  if (bulk) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(C)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldx) * 4};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(xs), CB};
    const cuuint32_t estr[2] = {1, 1};
    bulk = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                  const_cast<float*>(x), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(gy));
  const int bulk_y = reinterpret_cast<uintptr_t>(y) % 16 == 0 && M % 4 == 0;
  poly_dot_kernel<FL><<<grid, NT, smem, s>>>(map, x, ldx, N, starts, taps,
                                             fl, y, C, M, width, bulk,
                                             bulk_y);
  return cudaGetLastError();
}

}  // namespace

// x: [C, N >= 1] float32, row stride ldx; starts [M] int32; taps [M, fl]
// float32; y [C, M] float32.  width: an upper bound of (max - min) of
// starts over any tile of 64 consecutive outputs from output 0, plus fl,
// sizes the shared-memory rows (a tile past it reads x from global memory:
// the same sums, slower).  Returns a CUDA error code, 0 on success.
extern "C" int r8b_poly_dot_f32(const float* x, long long ldx, int N,
                                const int* starts, const float* taps, int fl,
                                float* y, int C, int M, int width,
                                void* stream) {
  if (C < 0 || M < 0 || N < 1 || ldx < 0 || fl < 1 || width < fl ||
      width > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0 || M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (fl) {
#define R8B_POLY_FL(F)                                              \
  case F:                                                           \
    e = launch<F>(x, ldx, N, starts, taps, fl, y, C, M, width, s); \
    break;
    R8B_POLY_FL(8) R8B_POLY_FL(10) R8B_POLY_FL(12) R8B_POLY_FL(14)
    R8B_POLY_FL(16) R8B_POLY_FL(18) R8B_POLY_FL(20) R8B_POLY_FL(22)
    R8B_POLY_FL(24) R8B_POLY_FL(26) R8B_POLY_FL(28)
#undef R8B_POLY_FL
    default:
      e = launch<0>(x, ldx, N, starts, taps, fl, y, C, M, width, s);
  }
  return static_cast<int>(e);
}
