// Grouped (per-expert) matrix product for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py::_gmm_kernel
// (launched by pl.pallas_call in gmm).  For each expert e:
//
//   out[e] = x[e] @ w[e],   x [E,C,d], w [E,d,f] -> out [E,C,f]
//
// with the products summed in fp32 over all of d and the result written in
// x's dtype.  It is the compute core of the MoE layer after dispatch: the
// three expert products x@w_gate, x@w_in and h@w_out of every MoE block.
// Inputs are contiguous; E is any count, C, d and f any multiples of 8 (so
// every 16-byte chunk of a row lies wholly inside or wholly outside the
// matrix).
//
// Design.  The Pallas grid (E, C/block_c, f/block_f), with a fori_loop over
// block_d inside each step, becomes CUDA blocks that each take whole
// (expert, C tile, f tile) tiles and loop over d themselves: blocks run in
// parallel and in no order, so nothing is carried from one to the next.
//  - bf16 runs on Hopper's warpgroup MMA (wgmma, bf16 operands read from
//    shared memory by descriptor, fp32 accumulators in registers), fed by
//    the Tensor Memory Accelerator.  One producer warp keeps a ring of
//    four stages in flight: each stage is one TMA box of x (64 deep,
//    K-major) and 64-wide boxes of w (MN-major: w's rows are read with
//    the transposed-B bit), all with the 128-byte swizzle, and a
//    full/empty mbarrier pair hands it between the producer and the
//    consumer warpgroups.  TMA zero-fills rows past C and depth past d;
//    the epilogue masks rows past C and columns past f.  A bf16 x bf16
//    product is exact in fp32, so only the order of the fp32 sum differs
//    from the plain version.  Two tilings, picked by C: for C > 64 (the
//    prefill, C 640) 128 x 256 tiles, two consumer warpgroups of
//    m64n256k16 (128 accumulator registers a thread), one block per
//    resident slot walking the tiles (persistent: the ring runs on across
//    a block's tiles, so the producer loads the next tile while the
//    consumers write this one); for C <= 64 (a decode step, C 8) 64 x 128
//    tiles, one consumer warpgroup of m64n128k16 and one block per tile,
//    where the weights' bytes bound the time and the deep ring keeps
//    enough of them in flight.  The producer is a single warp, so no
//    setmaxnreg: 94 and 160 registers a thread fit without it.  The
//    tensor maps are encoded on the host at each launch (through
//    cudaGetDriverEntryPointByVersion, so the build needs no -lcuda): two
//    encodings, a few µs of host time, on a decode step's 48 launches too,
//    where this tiling still beat a 16 x 128 mma.sync one on an H100.  The
//    shared-memory attribute and the persistent grid's size are set up
//    once per tiling and device (prepare), and gmm_load_kernels does that
//    for every tiling when the library is loaded.
//  - fp32 stays on the CUDA cores in full fp32 (never TF32, which keeps
//    about three decimal digits): cp.async double-buffered tiles, BM 64 x
//    BN 64 x BK 16, 256 threads with a 4 x 4 patch each.
//
// Bound.  At the olmoe-1b-7b prefill (4 x 1024 tokens, 64 experts top-8,
// capacity 640, d 2048, expert d_ff 1024, bf16) one x@w_gate does
// 2 * 64 * 640 * 2048 * 1024 = 1.718e11 FLOP, 0.174 ms at the 989 TFLOP/s
// bf16 tensor-core peak, and moves 168 + 268 + 84 MB, 0.155 ms at
// 3.35 TB/s: operations bound it.  At a decode step (C 8) the same product
// is 2.1e9 FLOP but must read all 64 experts' weights, 268 MB, 0.080 ms:
// bytes bound it.  The tile is still written from registers with 4-byte
// stores; staging it for a TMA store, and consumer warpgroups taking turns
// (one writing its tile while the other multiplies), are the next steps
// toward the operations bound.
#include <cuda.h>   // CUtensorMap and the types of cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstdio>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy a ROWS x COLS tile of a row-major [n_rows, n_cols] matrix, whose
// top-left corner is (r0, c0), into shared memory with row stride LD
// (elements), zero-filling what lies outside the matrix.
template <typename T, int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int n_rows, int n_cols, int r0,
                                          int c0) {
  constexpr int PER = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int CHUNKS = ROWS * COLS / PER;
  constexpr int PER_ROW = COLS / PER;
  for (int i = threadIdx.x; i < CHUNKS; i += NT) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * PER;
    const int gr = r0 + r, gc = c0 + c;
    const bool valid = gr < n_rows && gc < n_cols;
    const T* g = valid ? src + static_cast<long long>(gr) * n_cols + gc : src;
    cp_async16(dst + r * LD + c, g, valid);
  }
}

// ---------------------------------------------------------------------
// fp32: CUDA cores.  256 threads as 16 x 16; thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j of the 64 x 64 tile (i, j < 4), so a warp
// reads two rows of x's tile (broadcast) and 16 neighbouring words of w's.
// ---------------------------------------------------------------------
constexpr int FBM = 64, FBN = 64, FBK = 16, FNT = 256;
constexpr int FLDA = FBK + 4, FLDB = FBN + 4;   // rows stay 16-byte aligned

__global__ void __launch_bounds__(FNT)
    gmm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int C, int d, int f) {
  __shared__ __align__(16) float As[2][FBM * FLDA];
  __shared__ __align__(16) float Bs[2][FBK * FLDB];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const float* xe = x + static_cast<long long>(e) * C * d;
  const float* we = w + static_cast<long long>(e) * d * f;
  float* oe = out + static_cast<long long>(e) * C * f;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = (d + FBK - 1) / FBK;
  load_tile<float, FBM, FBK, FLDA, FNT>(As[0], xe, C, d, m0, 0);
  load_tile<float, FBK, FBN, FLDB, FNT>(Bs[0], we, d, f, 0, n0);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load_tile<float, FBM, FBK, FLDA, FNT>(As[s ^ 1], xe, C, d, m0,
                                            (kt + 1) * FBK);
      load_tile<float, FBK, FBN, FLDB, FNT>(Bs[s ^ 1], we, d, f,
                                            (kt + 1) * FBK, n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[s][(ty + 16 * i) * FLDA + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[s][k * FLDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < f) oe[static_cast<long long>(row) * f + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------
// bf16: wgmma fed by TMA.  A block computes 64 CONS x BN tiles of out[e]
// with CONS consumer warpgroups (64 rows each, m64nBNk16) and one
// producer warp that keeps a ring of STAGES x (x tile 64 CONS x 64, w tile
// 64 x BN) in flight; full/empty mbarriers hand each stage over.
// ---------------------------------------------------------------------
// CONS consumer warpgroups (64 rows of the tile each), a tile BN wide
// (128 or 256: BN / 64 boxes of w), STAGES ring stages 64 deep; PERSISTENT:
// one block per resident slot (SMs x blocks an SM holds), each walking its
// share of the tiles, else one block per tile
template <int CONS_, int STAGES_, int BN_, bool PERSISTENT_>
struct WgTiling {
  static constexpr int CONS = CONS_, STAGES = STAGES_;
  static constexpr bool PERSISTENT = PERSISTENT_;
  static constexpr int BM = 64 * CONS, BN = BN_, BK = 64;
  static constexpr int NT = 128 * CONS + 32;     // + the producer warp
  static constexpr int A_BYTES = BM * BK * 2;    // one box {64, BM}
  static constexpr int B_HALF = BK * 64 * 2;     // one box {64, 64}, 8 KB
  static constexpr int STAGE_BYTES = A_BYTES + (BN / 64) * B_HALF;
  // the ring, 1024-byte aligned for the 128-byte swizzle, then 2 x STAGES
  // barriers
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 16 * STAGES;
};

// The two bf16 tilings and the switch between them (gmm_fwd, gmm_tiling)
using DecodeTiling = WgTiling<1, 4, 128, false>;   // C <= SMALL_C_MAX
using PrefillTiling = WgTiling<2, 4, 256, true>;   // C > SMALL_C_MAX
constexpr int SMALL_C_MAX = 64;

template <typename Fn>
decltype(auto) with_bf16_tiling(int C, Fn&& fn) {
  if (C <= SMALL_C_MAX) return fn(DecodeTiling{});
  return fn(PrefillTiling{});
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 3-d tensor map into shared memory, completing on `bar`;
// what lies outside the tensor arrives as zeros
__device__ __forceinline__ void tma_load_3d(unsigned dst,
                                            const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo,
                                               unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// D[64 x 128] (fp32, this warpgroup's registers) += A · B: A K-major and
// B MN-major (w's rows, imm-trans-b 1), both read by descriptor
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 256] (fp32, this warpgroup's registers) += A · B, as above
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128)
    wgmma_m64n128k16(d, da, db);
  else
    wgmma_m64n256k16(d, da, db);
}

// Each block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... (one
// tile per block when the grid covers them all); a tile is (expert, C
// tile, f tile), the f tile fastest.  The ring and its phases run on
// across a block's tiles, so the producer loads the next tile while the
// consumers write this one.
template <typename Tl>
__global__ void __launch_bounds__(Tl::NT, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     __nv_bfloat16* __restrict__ out, int E, int C, int d,
                     int f) {
  constexpr int CONS = Tl::CONS, STAGES = Tl::STAGES;
  constexpr int BM = Tl::BM, BN = Tl::BN, BK = Tl::BK;
  constexpr int A_BYTES = Tl::A_BYTES, B_HALF = Tl::B_HALF;
  constexpr int STAGE_BYTES = Tl::STAGE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const unsigned ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const unsigned bars = ring + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int n_n = (f + BN - 1) / BN, n_m = (C + BM - 1) / BM;
  const int n_tiles = E * n_m * n_n;
  const int nk = (d + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);                  // the producer's expect_tx
      mbar_init(empty(s), 4 * CONS);          // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONS) {                     // producer
    if (lane == 0) {
      int it = 0;                             // stages filled so far
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int n0 = (tile % n_n) * BN, m0 = (tile / n_n % n_m) * BM;
        const int e = tile / (n_n * n_m);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES, use = it / STAGES;
          if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
          mbar_expect_tx(full(s), STAGE_BYTES);
          const unsigned a = ring + s * STAGE_BYTES, b = a + A_BYTES;
          tma_load_3d(a, &tx, full(s), kt * BK, m0, e);
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_load_3d(b + h * B_HALF, &tw, full(s), n0 + 64 * h, kt * BK,
                        e);
        }
      }
    }
    return;
  }

  // consumer warpgroup wgi: rows 64 wgi .. 64 wgi + 63 of each tile
  const int wgi = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  int it = 0;                                 // stages consumed so far
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = (tile % n_n) * BN, m0 = (tile / n_n % n_m) * BM;
    const int e = tile / (n_n * n_m);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      const unsigned a = ring + s * STAGE_BYTES + wgi * (A_BYTES / CONS);
      const unsigned b = ring + s * STAGE_BYTES + A_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        // x: K-major, 128-byte rows; a k16 step is 32 bytes along the
        // row, 8-row groups 1024 bytes apart.  w: MN-major, a k16 step is
        // 16 rows of 128 bytes; 8-row groups 1024 bytes apart, the 64-wide
        // boxes along n B_HALF apart.
        wgmma_tile<BN>(acc, sw128_desc(a + 32 * k, 16, 1024),
                       sw128_desc(b + 2048 * k, B_HALF, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(empty(s));
    }

    // accumulator: this lane holds rows 16 (warp % 4) + g and + 8,
    // columns 8 j + 2 t and + 1; f is a multiple of 8, so an n8 tile is
    // in or out whole
    __nv_bfloat16* oe = out + static_cast<long long>(e) * C * f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= f) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 64 * wgi + 16 * (warp % 4) + g + 8 * h;
        if (row < C)
          *reinterpret_cast<__nv_bfloat162*>(
              &oe[static_cast<long long>(row) * f + col]) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 [n2, n1, n0] tensor (n0 contiguous) as a 3-d map of boxes
// {box0, box1, 1}, 128-byte swizzle, zeros outside
bool encode_3d(CUtensorMap* map, EncodeTiled fn, const void* base,
               uint64_t n0, uint64_t n1, uint64_t n2, unsigned box0,
               unsigned box1) {
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * 2, n0 * n1 * 2};    // bytes
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int MAX_DEVICES = 64;

// Once per tiling and device: raise the kernel's dynamic shared memory
// above 48 KB (which also loads it, where modules load lazily) and count
// the blocks of it the card holds at once (PERSISTENT's grid).  Later
// launches read the count; they set no attribute and query nothing.
template <typename Tl>
cudaError_t prepare(int* slots) {
  static std::atomic<int> ready[MAX_DEVICES];   // slots + 1; 0: not yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int got = ready[dev].load(std::memory_order_acquire);
  if (got == 0) {
    auto kernel = gmm_wgmma_kernel<Tl>;
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, Tl::NT, Tl::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    got = sms * per_sm + 1;
    ready[dev].store(got, std::memory_order_release);
  }
  *slots = got - 1;
  return cudaSuccess;
}

template <typename Tl>
cudaError_t launch_wgmma(const void* x, const void* w, void* out, int E,
                         int C, int d, int f, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return cudaErrorMisalignedAddress;
  int slots = 0;
  cudaError_t err = prepare<Tl>(&slots);
  if (err != cudaSuccess) return err;
  CUtensorMap tx, tw;
  if (!encode_3d(&tx, fn, x, d, C, E, 64, Tl::BM) ||
      !encode_3d(&tw, fn, w, f, d, E, 64, Tl::BK))
    return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>(E) *
                          ((C + Tl::BM - 1) / Tl::BM) *
                          ((f + Tl::BN - 1) / Tl::BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const long long grid = Tl::PERSISTENT && slots < tiles ? slots : tiles;
  gmm_wgmma_kernel<Tl><<<static_cast<int>(grid), Tl::NT, Tl::SMEM_BYTES,
                         stream>>>(tx, tw, static_cast<__nv_bfloat16*>(out),
                                   E, C, d, f);
  return cudaGetLastError();
}

// What a tiling is, from the constants its launch uses
template <typename Tl>
const char* tiling_name() {
  static char name[160];
  static const int written = snprintf(
      name, sizeof name,
      "wgmma %d x %d x %d, %s, TMA ring of %d stages, %d B dynamic shared "
      "memory",
      Tl::BM, Tl::BN, Tl::BK,
      Tl::PERSISTENT ? "persistent blocks" : "a block per tile", Tl::STAGES,
      Tl::SMEM_BYTES);
  (void)written;
  return name;
}

}  // namespace

// dtype 0: fp32, 1: bf16.  Returns a cudaError_t (0 on success); the launch
// is checked, the run is not (the caller synchronises where it must know).
extern "C" int gmm_fwd(const void* x, const void* w, void* out, int dtype,
                       int E, int C, int d, int f, void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || C % 8 || d % 8 || f % 8 ||
      E > 65535 || (C + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(with_bf16_tiling(C, [&](auto tl) {
      return launch_wgmma<decltype(tl)>(x, w, out, E, C, d, f, st);
    }));
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((f + FBN - 1) / FBN, (C + FBM - 1) / FBM, E);
  gmm_fma_kernel<<<grid, FNT, 0, st>>>(static_cast<const float*>(x),
                                       static_cast<const float*>(w),
                                       static_cast<float*>(out), C, d, f);
  return static_cast<int>(cudaGetLastError());
}

// Load every kernel of the library onto the current device and set each
// bf16 tiling up (prepare), so that no launch of a served path pays for
// it.  Returns a cudaError_t (0 on success).
extern "C" int gmm_load_kernels() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gmm_fma_kernel);
  int slots = 0;
  if (err == cudaSuccess) err = prepare<DecodeTiling>(&slots);
  if (err == cudaSuccess) err = prepare<PrefillTiling>(&slots);
  return static_cast<int>(err);
}

// The tiling gmm_fwd runs for this dtype and C rows per expert
extern "C" const char* gmm_tiling(int dtype, int C) {
  if (dtype != 1) return "fp32 CUDA cores, 64 x 64 x 16";
  return with_bf16_tiling(C, [](auto tl) {
    return tiling_name<decltype(tl)>();
  });
}

extern "C" const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
