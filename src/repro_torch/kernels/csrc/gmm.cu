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
// block_d inside each step, becomes one CUDA block per (f tile, C tile,
// expert) that loops over d itself: blocks run in parallel and in no order,
// so nothing is carried from one to the next.  Each step of the loop stages
// a BM x BK tile of x and a BK x BN tile of w in shared memory with
// cp.async, two stages deep, so the next tile is in flight while the
// current one is multiplied; rows past C, columns past f and depth past d
// are zero-filled by the copy itself.
//  - bf16 runs on the tensor cores: mma.sync.aligned.m16n8k16 with bf16
//    operands (fed by ldmatrix, w's tile transposed on the way) and fp32
//    accumulators.  A bf16 x bf16 product is exact in fp32, so only the
//    order of the fp32 sum differs from the plain version.  Two tilings:
//    BM 128 x BN 128 x BK 32 with 8 warps of 64 x 32 for the prefill
//    (C 640), and BM 16 x BN 128 x BK 64 with 4 warps of 16 x 32 for the
//    decode step (C 8), where a 128-row tile would be 15/16 padding.
//  - fp32 stays on the CUDA cores in full fp32 (never TF32, which keeps
//    about three decimal digits): BM 64 x BN 64 x BK 16, 256 threads with a
//    4 x 4 patch each.
//
// Bound.  At the olmoe-1b-7b prefill (4 x 1024 tokens, 64 experts top-8,
// capacity 640, d 2048, expert d_ff 1024, bf16) one x@w_gate does
// 2 * 64 * 640 * 2048 * 1024 = 1.718e11 FLOP, 0.174 ms at the 989 TFLOP/s
// bf16 tensor-core peak, and moves 168 + 268 + 84 MB, 0.155 ms at
// 3.35 TB/s: operations bound it.  At a decode step (C 8) the same product
// is 2.1e9 FLOP but must read all 64 experts' weights, 268 MB, 0.080 ms:
// bytes bound it.  mma.sync reaches a part of the peak that wgmma, fed by
// TMA from a deeper ring, would raise; that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------
// bf16: tensor cores.  A block computes a BM x BN tile of out[e]; its warps
// are laid out (BM/WM) x (BN/WN), each owning a WM x WN patch as
// (WM/16) x (WN/8) m16n8 accumulator tiles.
// ---------------------------------------------------------------------
template <int BM, int BN, int BK, int WM, int WN>
struct MmaTiling {
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NT = 32 * (BM / WM) * WARPS_N;
  static constexpr int MI = WM / 16;
  static constexpr int NI = WN / 8;
  static constexpr int LDA = BK + 8;     // +16 bytes: rows on other banks
  static constexpr int LDB = BN + 8;
  static_assert(BK % 16 == 0 && WN % 16 == 0 && WM % 16 == 0, "tiling");
};

template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(MmaTiling<BM, BN, BK, WM, WN>::NT)
    gmm_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int C, int d, int f) {
  using Tl = MmaTiling<BM, BN, BK, WM, WN>;
  constexpr int NT = Tl::NT, MI = Tl::MI, NI = Tl::NI;
  constexpr int LDA = Tl::LDA, LDB = Tl::LDB;
  __shared__ __align__(16) __nv_bfloat16 As[2][BM * LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK * LDB];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16* xe = x + static_cast<long long>(e) * C * d;
  const __nv_bfloat16* we = w + static_cast<long long>(e) * d * f;
  __nv_bfloat16* oe = out + static_cast<long long>(e) * C * f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / Tl::WARPS_N) * WM;
  const int wn0 = (warp % Tl::WARPS_N) * WN;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int nk = (d + BK - 1) / BK;
  load_tile<__nv_bfloat16, BM, BK, LDA, NT>(As[0], xe, C, d, m0, 0);
  load_tile<__nv_bfloat16, BK, BN, LDB, NT>(Bs[0], we, d, f, 0, n0);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load_tile<__nv_bfloat16, BM, BK, LDA, NT>(As[s ^ 1], xe, C, d, m0,
                                                (kt + 1) * BK);
      load_tile<__nv_bfloat16, BK, BN, LDB, NT>(Bs[s ^ 1], we, d, f,
                                                (kt + 1) * BK, n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], &As[s][(wm0 + i * 16 + (lane & 15)) * LDA + kk +
                                 (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        // two n8 tiles: matrices (k 0-7, n 0-7), (k 8-15, n 0-7),
        // (k 0-7, n 8-15), (k 8-15, n 8-15), transposed into B fragments
        unsigned b[4];
        ldmatrix_x4_trans(b, &Bs[s][(kk + (lane & 7) + ((lane >> 3) & 1) * 8)
                                        * LDB +
                                    wn0 + j * 8 + (lane >> 4) * 8]);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16_16816(acc[i][j], a[i], b[0], b[1]);
          mma_bf16_16816(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();    // the stage just read is the next one written
  }

  // accumulator tile (16 x 8): this lane holds rows g and g + 8, columns
  // 2t and 2t + 1; f is a multiple of 8, so a tile is in or out whole
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = n0 + wn0 + j * 8 + 2 * t;
      if (col >= f) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + i * 16 + g + 8 * h;
        if (row < C)
          *reinterpret_cast<__nv_bfloat162*>(
              &oe[static_cast<long long>(row) * f + col]) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
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

template <int BM, int BN, int BK, int WM, int WN>
cudaError_t launch_mma(const void* x, const void* w, void* out, int E, int C,
                       int d, int f, cudaStream_t stream) {
  const dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  gmm_mma_kernel<BM, BN, BK, WM, WN>
      <<<grid, MmaTiling<BM, BN, BK, WM, WN>::NT, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(w),
          static_cast<__nv_bfloat16*>(out), C, d, f);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: fp32, 1: bf16.  Returns a cudaError_t (0 on success); the launch
// is checked, the run is not (the caller synchronises where it must know).
extern "C" int gmm_fwd(const void* x, const void* w, void* out, int dtype,
                       int E, int C, int d, int f, void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || C % 8 || d % 8 || f % 8 ||
      E > 65535 || (C + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(
        C <= 16 ? launch_mma<16, 128, 64, 16, 32>(x, w, out, E, C, d, f, st)
                : launch_mma<128, 128, 32, 64, 32>(x, w, out, E, C, d, f,
                                                   st));
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((f + FBN - 1) / FBN, (C + FBM - 1) / FBM, E);
  gmm_fma_kernel<<<grid, FNT, 0, st>>>(static_cast<const float*>(x),
                                       static_cast<const float*>(w),
                                       static_cast<float*>(out), C, d, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
