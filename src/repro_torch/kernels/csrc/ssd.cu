// SSD intra-chunk term (Mamba2) for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::_ssd_kernel (launched by
// pl.pallas_call in ssd_intra_chunk).  For each (batch, head, chunk) of Q
// rows, with head dim P, state dim N and dA = dt * A:
//
//   cum   = cumsum(dA)                                   [Q]
//   y     = ((C B^T) o L) (x dt),  L[i,j] = exp(cum_i - cum_j) for j <= i,
//                                  0 above the diagonal  [Q,P]
//   state = (B * exp(cum_{Q-1} - cum))^T (x dt)          [N,P]
//
// with head h reading B and C of group h / (H/G).  The exponent is taken
// only on and below the diagonal, so the upper triangle never forms
// inf * 0.  cum is summed in fp64, and the exponents cum_i - cum_j and
// cum_{Q-1} - cum_i are taken in fp64 before they are rounded to fp32;
// cum is written rounded once to fp32.  The plain version
// (kernels/ref.py::ssd_intra_chunk_ref) does the same, so the two do not
// depend on the order of the sum.  Mamba2's A in [-16, -1] takes cum to
// ~-1e3 within a 256-row chunk, where an fp32 ulp is 6e-5: differences of
// two fp32 cums would move the decay of every near-diagonal pair by up to
// ~1e-4 relative, and the chunked scan away from the sequential
// recurrence; fp64 keeps the exponents exact to fp32 rounding.  All else
// is fp32.
//
// Layout.  x [B,L,H,P], dt [B,L,H], B and C [B,L,G,N] are read through the
// element strides the caller passes (x, B, C with a contiguous last
// dimension), so the views the model cuts from its conv output need no
// copies or transposes; A is [H].  Outputs are contiguous fp32, as the
// Pallas kernel's: y [B,H,nc,Q,P], state [B,H,nc,N,P], cum [B,H,nc,Q].
// Any Q is taken (the last 64-row tile is masked), P <= 128, N <= 256.
//
// bf16: tensor cores (ssd_tc_kernel).  The unit of work is a (chunk,
// group, batch) and a job that loops over the group's H/G heads: a 64-row
// q tile of y, or a 128-row tile of the state (64 rows where N <= 64 or
// P > 64).
// Jobs go out a state tile first, then the q tiles heaviest first,
// alternating, each over all chunks before the next.
//   A y block first computes its q tile's C B^T rows over the causal k
// tiles, once, on mma.sync.m16n8k16 (bf16 C and B, exact products summed
// in fp32; C's fragments in registers, B's 64-row tiles through a
// two-stage cp.async ring), and keeps them in shared memory in fp32 (64 x
// 256 x 4 = 64 KB at Q 256).  Then, head by head, every warp forms its 16
// rows of M = (C B^T) o L_h o dt_h in fp32 registers, 16 columns at a
// time: below the diagonal L[i,j] dt_j = exp(cum_i - ref) * exp(ref -
// cum_j) dt_j, ref = cum at the end of the 16 columns, the second factor
// made once per head and column; on the diagonal block an exp per term on
// and below the diagonal; above it 0.  Each exponent is a difference of
// fp64 cums, scaled by log2(e) in fp64 and rounded once to fp32; where dA
// <= 0 (every SSD model: dt > 0, A < 0) both factors are <= 1.  y = M x
// runs on wgmma (m64nDPk16, M's pieces from registers, x from shared
// memory by descriptor), every warp issuing the four 16-column steps of a
// k tile.
//   A state block keeps its columns of the chunk's B in shared memory for
// all heads and takes state = W^T x, W = B exp(cum_end - cum) dt, its W^T
// fragments read from B by ldmatrix.trans and scaled in registers, on
// wgmma the same way.  So C B^T is computed once per group and B is read
// once per chunk.
//   x's 64-row tiles come by TMA (one 64 x 64 box per 64 columns, 128-byte
// swizzle, an mbarrier per slot) through a three-slot ring, two tiles
// ahead; a view TMA cannot take (not 16-byte aligned) is staged element by
// element into the same layout, zero past Q and P.
//   M and W are fp32; each is split into SSD_SPLIT_PIECES (3) bf16 pieces
// (hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), together all
// 24 significand bits) and each piece takes one product with the exact
// bf16 x, so every product is the fp32 product.  Two pieces (about 16
// bits) hold K2 to its own checks, but move the bf16 model's one-call
// prefill 0.105 from its token-by-token decode, over the 0.08 that
// chip_smoke.py allows (PERF.md, PR 16).
//   Per head, dt * A is scanned in fp64 across the block (dA rounded to
// fp32, as the plain version rounds it), double-buffered: head h + 1's
// scan and decay factors are made around the barriers of head h's first
// step.  P and N are padded to 64 or 128 and 64, 128 or 256 (the
// tiling).  Shared memory grows with Q (C B^T rows, the per-head buffers);
// a chunk too long for a block's 227 KB (Q > 640 at N 128, P 64) runs on
// the CUDA-core kernel below.
//
// fp32: CUDA cores (ssd_kernel).  One block of 256 threads per (chunk,
// head, batch), flash-style without the softmax: for each 64-row q tile it
// keeps that tile of C in shared memory and walks the causal 64-row k
// tiles, each thread computing a 4x4 patch of the C B^T tile; a second
// pass computes the state 64 rows of N at a time.  Every product in fp32
// FMAs, so the fp32 path matches its plain version to the order of the sum.
//
// Bound.  At the prefill shape of mamba2-130m serving (B 8, L 4096, H 24,
// P 64, G 1, N 128, Q 256, bf16 x, B, C; fp32 dt and outputs) the kernel
// must read its inputs and write y, state and cum once: 425 MB, 0.127 ms
// at 3.35 TB/s.  Its products (the causal half of C B^T once per group, of
// M x per head, and the state product) are 2.7e10 FLOP, 0.027 ms at the
// bf16 tensor-core peak; with three pieces, and the zero blocks above
// the diagonal, the tensor cores do about 8e10, 0.08 ms.  So the floor is
// the bytes.  The CUDA-core fp32 kernel (67 TFLOP/s at most, C B^T once per
// head) is bound by its 5.2e10 FLOP at 0.78 ms.
#include <cuda.h>   // CUtensorMap and the types of cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstdio>

#ifndef SSD_SPLIT_PIECES
#define SSD_SPLIT_PIECES 3
#endif

namespace {

constexpr int TR = 64;          // rows of a q, k or state tile
constexpr int NT = 256;         // threads: 16 row groups x 16 column lanes
constexpr int RPT = TR / 16;    // tile rows (and columns) per thread
constexpr int MAX_SMEM = 232448;  // a Hopper block's opt-in shared memory

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  float* y;
  float* state;
  float* cum;
  int H, hpg, nc, Q, P, N;
  long long x_sb, x_sl, x_sh;
  long long dt_sb, dt_sl, dt_sh;
  long long b_sb, b_sl, b_sg;
  long long c_sb, c_sl, c_sg;
  int x_aligned, bc_aligned;   // 16-byte base and strides: cp.async staging
  int x_tma;                   // x's tiles by TMA (its tensor map encoded)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ inline int n_tiles(int Q) { return (Q + TR - 1) / TR; }
__host__ __device__ inline int b_floats(int N) {
  return TR * (N + 1 > TR + 1 ? N + 1 : TR + 1);
}

// x * dt of rows k0 .. k0+TR into xs [TR][16*NV], zero past Q and P.
template <typename T, int NV>
__device__ void stage_xdt(float* xs, const T* xg, const float* dt_s,
                          const Params& p, int k0) {
  constexpr int ldx = 16 * NV;
  for (int i = threadIdx.x; i < TR * ldx; i += NT) {
    const int r = i / ldx, col = i - r * ldx, k = k0 + r;
    xs[i] = (k < p.Q && col < p.P) ? to_f(xg[k * p.x_sl + col]) * dt_s[k]
                                   : 0.f;
  }
}

// NV = column groups of 16 in a row of x (P <= 16 * NV).
template <typename T, int NV>
__global__ void __launch_bounds__(NT) ssd_kernel(Params p) {
  extern __shared__ float smem[];
  const int Q = p.Q, N = p.N, P = p.P, nt = n_tiles(Q);
  const int ldn = N + 1, ldx = 16 * NV, lds = TR + 1;
  double* cum_d = reinterpret_cast<double*>(smem);  // [nt*TR] dA, then cum
  float* dt_s = smem + 2 * nt * TR;    // [nt*TR]   dt
  float* cs = dt_s + nt * TR;          // [TR][N+1] C tile
  float* bs = cs + TR * ldn;           // [TR][N+1] B tile; [TR][TR+1] B*decay
  float* xs = bs + b_floats(N);        // [TR][16*NV] x*dt tile
  float* ss = xs + TR * ldx;           // [TR][TR+1] (C B^T o L) tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / p.hpg;
  const long long l0 = static_cast<long long>(c) * Q;
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh +
                l0 * p.x_sl;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh + l0 * p.dt_sl;
  const T* bg = static_cast<const T*>(p.b) + b * p.b_sb + g * p.b_sg +
                l0 * p.b_sl;
  const T* cg = static_cast<const T*>(p.c) + b * p.c_sb + g * p.c_sg +
                l0 * p.c_sl;
  const long long bhc = (static_cast<long long>(b) * p.H + h) * p.nc + c;
  float* yg = p.y + bhc * Q * P;
  float* sg = p.state + bhc * N * P;
  float* cumg = p.cum + bhc * Q;
  const float A = p.A[h];

  for (int i = tid; i < nt * TR; i += NT) {
    const float d = i < Q ? dtg[i * p.dt_sl] : 0.f;
    dt_s[i] = d;
    cum_d[i] = static_cast<double>(d * A);  // dA rounded to fp32, as plain
  }
  __syncthreads();
  if (tid < 32) {  // cum: lane k sums its run of rows in fp64, a warp scan
    const int per = (Q + 31) / 32;  // of the run totals gives its offset
    const int lo = min(tid * per, Q), hi = min(lo + per, Q);
    double run = 0.0;
    for (int i = lo; i < hi; ++i) run += cum_d[i];
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    double acc = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) acc = 0.0;
    for (int i = lo; i < hi; ++i) {
      acc += cum_d[i];
      cum_d[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < Q; i += NT) cumg[i] = static_cast<float>(cum_d[i]);

  // ---- y = (C B^T o L)(x dt), one q tile at a time ----------------------
  for (int qt = 0; qt < nt; ++qt) {
    const int q0 = qt * TR;
    for (int i = tid; i < TR * N; i += NT) {
      const int r = i / N, n = i - r * N, q = q0 + r;
      cs[r * ldn + n] = q < Q ? to_f(cg[q * p.c_sl + n]) : 0.f;
    }
    float acc[RPT][NV];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[i][v] = 0.f;

    for (int kt = 0; kt <= qt; ++kt) {
      const int k0 = kt * TR;
      for (int i = tid; i < TR * N; i += NT) {
        const int r = i / N, n = i - r * N, k = k0 + r;
        bs[r * ldn + n] = k < Q ? to_f(bg[k * p.b_sl + n]) : 0.f;
      }
      stage_xdt<T, NV>(xs, xg, dt_s, p, k0);
      __syncthreads();  // B, x*dt (and C, on the first k tile) staged

      float s[RPT][RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float a[RPT], bk[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = cs[(ty + 16 * i) * ldn + n];
#pragma unroll
        for (int j = 0; j < RPT; ++j) bk[j] = bs[(tx + 16 * j) * ldn + n];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < RPT; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int qi = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int kj = k0 + tx + 16 * j;
          ss[(ty + 16 * i) * lds + tx + 16 * j] =
              (kj <= qi && qi < Q)
                  ? s[i][j] * expf(static_cast<float>(cum_d[qi] - cum_d[kj]))
                  : 0.f;
        }
      }
      __syncthreads();  // the (C B^T o L) tile is visible

#pragma unroll 4
      for (int k = 0; k < TR; ++k) {
        float pk[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) pk[i] = ss[(ty + 16 * i) * lds + k];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float xv = xs[k * ldx + tx + 16 * v];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][v] = fmaf(pk[i], xv, acc[i][v]);
        }
      }
      __syncthreads();  // tiles consumed before the next are staged
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int q = q0 + ty + 16 * i;
      if (q >= Q) continue;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int col = tx + 16 * v;
        if (col < P) yg[q * P + col] = acc[i][v];
      }
    }
  }

  // ---- state = (B * exp(cum_end - cum))^T (x dt), 64 rows of N a pass --
  const double cum_end = cum_d[Q - 1];
  for (int n0 = 0; n0 < N; n0 += TR) {
    float acc[RPT][NV];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[i][v] = 0.f;
    for (int qt = 0; qt < nt; ++qt) {
      const int q0 = qt * TR;
      for (int i = tid; i < TR * TR; i += NT) {
        const int r = i / TR, col = i - r * TR, q = q0 + r, n = n0 + col;
        bs[r * lds + col] =
            (q < Q && n < N)
                ? to_f(bg[q * p.b_sl + n]) *
                      expf(static_cast<float>(cum_end - cum_d[q]))
                : 0.f;
      }
      stage_xdt<T, NV>(xs, xg, dt_s, p, q0);
      __syncthreads();
#pragma unroll 4
      for (int q = 0; q < TR; ++q) {
        float bn[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) bn[i] = bs[q * lds + ty + 16 * i];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float xv = xs[q * ldx + tx + 16 * v];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][v] = fmaf(bn[i], xv, acc[i][v]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = n0 + ty + 16 * i;
      if (n >= N) continue;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int col = tx + 16 * v;
        if (col < P) sg[n * P + col] = acc[i][v];
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Once per kernel and device: raise its dynamic shared memory to a
// Hopper block's most (which also loads it, where modules load lazily).
// Later launches set no attribute.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, std::atomic<bool> (&ready)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess) ready[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T, int NV>
cudaError_t prepare_fma() {
  static std::atomic<bool> ready[MAX_DEVICES];
  return prepare(ssd_kernel<T, NV>, ready);
}

template <typename T, int NV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const cudaError_t err = prepare_fma<T, NV>();
  if (err != cudaSuccess) return err;
  const int floats = 3 * n_tiles(p.Q) * TR + TR * (p.N + 1) +
                     b_floats(p.N) + TR * 16 * NV + TR * (TR + 1);
  const int bytes = floats * static_cast<int>(sizeof(float));
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid(p.nc, p.H, B);
  ssd_kernel<T, NV><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const Params& p, int B, cudaStream_t stream) {
  if (p.P <= 16) return launch<T, 1>(p, B, stream);
  if (p.P <= 32) return launch<T, 2>(p, B, stream);
  if (p.P <= 64) return launch<T, 4>(p, B, stream);
  if (p.P <= 128) return launch<T, 8>(p, B, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// bf16: tensor cores (C B^T on mma.sync.m16n8k16, y and the state on
// wgmma with A from registers; x by TMA, B and C by cp.async)
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int TNT = 128;        // threads: 4 warps of 16 rows
constexpr int PIECES = SSD_SPLIT_PIECES;  // bf16 pieces of M and of W
constexpr int XS = 3;           // slots of the x ring (XS - 1 in flight)
constexpr int MAX_PER = 6;      // rows of dt a thread holds: Q <= 768
static_assert(PIECES >= 1 && PIECES <= 3, "1 to 3 bf16 pieces");

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// `bytes` (0 to 16) from global to shared, the rest of 16 zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 unpack_bf16(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
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

// one box of a 4-d tensor map into shared memory, completing on `bar`;
// what lies outside the tensor arrives as zeros
__device__ __forceinline__ void tma_load_4d(unsigned dst,
                                            const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// An x slot: DP/64 boxes of 64 rows x 64 columns, each row 128 bytes whose
// 16-byte chunks are swizzled by the row (chunk j at j ^ (row & 7)): what
// TMA writes with the 128-byte swizzle, and what ldmatrix reads without
// bank conflicts.  The element (r, c) of a slot:
__device__ __forceinline__ int x_at(int r, int c) {
  return (c >> 6) * (TR * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}

// Rows r0 .. r0 + TR of a [n_rows, d] bf16 matrix (row stride ld_g
// elements) into an x slot element by element, zero past n_rows and d:
// views TMA cannot take (visible after the next barrier)
template <int DP>
__device__ __forceinline__ void stage_x_plain(bf16* __restrict__ slot,
                                              const bf16* __restrict__ src,
                                              long long ld_g, int r0,
                                              int n_rows, int d) {
  for (int i = threadIdx.x; i < TR * DP; i += TNT) {
    const int r = i / DP, c = i % DP;
    slot[x_at(r, c)] = r0 + r < n_rows && c < d ? src[(r0 + r) * ld_g + c]
                                                : __float2bfloat16(0.f);
  }
  // wgmma reads the slot through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The A fragment of a 16 x 16 fp32 tile (v: a0's two values, a1's, a2's,
// a3's) as NP bf16 fragments whose sum is v: piece 0 = bf16(v), piece 1 =
// bf16 of what is left, and so on.
template <int NP>
__device__ __forceinline__ void split(float (&v)[8], unsigned (&a)[NP][4]) {
#pragma unroll
  for (int pi = 0; pi < NP; ++pi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 hb = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      a[pi][e] = *reinterpret_cast<unsigned*>(&hb);
      if (pi + 1 < NP) {
        const float2 f = __bfloat1622float2(hb);
        v[2 * e] -= f.x;
        v[2 * e + 1] -= f.y;
      }
    }
}

// Registers the compiler must hold unchanged across this point
__device__ __forceinline__ void keep_registers(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}
__device__ __forceinline__ void keep_registers(unsigned& v) {
  asm volatile("" : "+r"(v)::"memory");
}
template <typename T, int N>
__device__ __forceinline__ void keep_registers(T (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) keep_registers(v[i]);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo,
                                               unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// D[64 x 64] (fp32, the warpgroup's registers, this warp's rows in mma.sync's
// accumulator layout) += A B: A [64 x 16] from registers (this warp's 16 rows
// in mma.sync's A layout), B [16 x 64] MN-major (imm-trans-b 1) by descriptor
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] (fp32, the warpgroup's registers, this warp's rows in mma.sync's
// accumulator layout) += A B: A [64 x 16] from registers (this warp's 16 rows
// in mma.sync's A layout), B [16 x 128] MN-major (imm-trans-b 1) by descriptor
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc[m] += (sum of the NP pieces of a[kk][m]) x (the x slot's rows 16 kk
// .. 16 kk + 15) for the KN 16-row steps from k0 of a tile and the MI
// 64-row tiles of the warpgroup, the smallest piece first, as one commit
// group: wgmma with A from registers and x's slot, MN-major with the
// 128-byte swizzle (a k16 step is 16 rows of 128 bytes, 8-row groups 1024
// bytes apart, the 64-column boxes TR * 128 bytes apart).  Every warp of
// the block issues them; the fragments and accumulators stay untouched
// until wgmma_wait.
template <int KN, int KS, int MI, int NP, int DP>
__device__ __forceinline__ void wgmma_issue(float (&acc)[MI][DP / 8][4],
                                            unsigned (&a)[KS][MI][NP][4],
                                            const bf16* xs, int k0) {
  const unsigned x0 = smem_u32(xs);
  keep_registers(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < KN; ++k) {
    const uint64_t db = sw128_desc(x0 + 2048 * (k0 + k), TR * 128, 1024);
#pragma unroll
    for (int m = 0; m < MI; ++m)
#pragma unroll
      for (int pi = NP - 1; pi >= 0; --pi) {
        if constexpr (DP == 64)
          wgmma_rs_n64(acc[m], a[k0 + k][m][pi], db);
        else
          wgmma_rs_n128(acc[m], a[k0 + k][m][pi], db);
      }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until every issued wgmma has completed: it read the fragments and wrote
// the accumulators asynchronously, so neither may be reused or moved by
// the compiler before this
template <int KS, int MI, int NP, int DP>
__device__ __forceinline__ void wgmma_wait(float (&acc)[MI][DP / 8][4],
                                           unsigned (&a)[KS][MI][NP][4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  keep_registers(a);
  keep_registers(acc);
}

// Rows r and r + 8 of a [n_rows, P] fp32 output from a warp's m16
// accumulator tile (this lane's columns 2 t4 and 2 t4 + 1 of each n8 tile),
// as pairs where P is even.
template <int DP>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&acc)[DP / 8][4],
                                           int r, int n_rows, int P, int t4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= n_rows) continue;
    float* o = out + static_cast<long long>(row) * P;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t4;
      if (col + 1 < P && P % 2 == 0) {
        *reinterpret_cast<float2*>(o + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        if (col < P) o[col] = acc[j][2 * h];
        if (col + 1 < P) o[col + 1] = acc[j][2 * h + 1];
      }
    }
  }
}

// Rows r0 .. r0+rows of a [n_rows, d] bf16 matrix (row stride ld_g
// elements) into shared memory as rows x COLS with row stride LD,
// zero-filled past n_rows and d: 16-byte cp.async where the view is
// aligned, else element by element (visible after the next barrier).
template <int COLS, int LD>
__device__ __forceinline__ void stage_rows(bf16* __restrict__ dst,
                                           const bf16* __restrict__ src,
                                           long long ld_g, int r0, int rows,
                                           int n_rows, int d, bool aligned) {
  if (aligned) {
    constexpr int PER_ROW = COLS / 8;
    for (int i = threadIdx.x; i < rows * PER_ROW; i += TNT) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
      const bool valid = r0 + r < n_rows && c < d;
      const int bytes = valid ? 2 * min(8, d - c) : 0;
      cp_async16(dst + r * LD + c, valid ? src + (r0 + r) * ld_g + c : src,
                 bytes);
    }
  } else {
    for (int i = threadIdx.x; i < rows * COLS; i += TNT) {
      const int r = i / COLS, c = i % COLS;
      dst[r * LD + c] = (r0 + r < n_rows && c < d)
                            ? src[(r0 + r) * ld_g + c]
                            : __float2bfloat16(0.f);
    }
  }
}

// The bf16 tiling: N padded to DN, P to DP (multiples of 64).  Shared
// memory (bytes), from a 1024-byte boundary: the ring (a y block's C and
// two B tiles [64][DN+8], then XS x slots [64][DP] swizzled; a state
// block's x slots); two buffers (heads h and h + 1) of cum [QP] fp64, dt
// [QP] and decay factors [QP] fp32, 4 fp64 of scan scratch each, and the
// x slots' mbarriers; then a y block's C B^T rows [64][QP+8] fp32, or a
// state block's B columns [QP][SROWS+8]; QP = Q padded to 64.
template <int DN_, int DP_>
struct TcTiling {
  static constexpr int DN = DN_, DP = DP_;
  static constexpr int LDN = DN + 8;      // +16 bytes: rows on other banks
  // a state block's rows of N: two 64-row wgmma tiles where N > 64 and P
  // <= 64 (at P 128 their accumulators and fragments would spill)
  static constexpr int SM16 = DN >= 128 && DP == 64 ? 2 : 1;
  static constexpr int SROWS = 64 * SM16;
  static constexpr int LDB = SROWS + 8;   // its B columns [QP][SROWS+8]
  static constexpr int BSLOT = TR * LDN, XSLOT = TR * DP;   // elements
  static constexpr int RING_BYTES =
      2 * (2 * BSLOT > XS * XSLOT ? 2 * BSLOT : XS * XSLOT);
  __host__ __device__ static int qp(int Q) { return n_tiles(Q) * TR; }
  __host__ __device__ static int head_bytes(int Q) { return 32 * qp(Q) + 96; }
  __host__ __device__ static int bytes(int Q) {
    const int y = 4 * TR * (qp(Q) + 8), state = 2 * qp(Q) * LDB;
    return 1024 + RING_BYTES + head_bytes(Q) + (y > state ? y : state);
  }
  // the chunk fits the tensor-core kernel: its shared memory, and each
  // thread's rows of dt in MAX_PER registers
  static bool fits(int Q) {
    return bytes(Q) <= MAX_SMEM && qp(Q) <= TNT * MAX_PER;
  }
};

// exp(x) of an fp64 exponent: x log2(e) taken in fp64 and rounded once to
// fp32 (the plain version rounds x once), then 2^ on the special-function
// unit (2 ulp)
__device__ __forceinline__ float exp_fp64(double x) {
  return exp2f(static_cast<float>(x * 1.4426950408889634));
}

// This thread's rows of one head's dt over the chunk (0 past Q), loaded
// into registers a head ahead of their use.
__device__ __forceinline__ void load_dt(float (&d)[MAX_PER],
                                        const float* __restrict__ dtg,
                                        long long dt_sl, int Q, int QP) {
  const int per = (QP + TNT - 1) / TNT, lo = threadIdx.x * per;
#pragma unroll
  for (int k = 0; k < MAX_PER; ++k) {
    const int i = lo + k;
    d[k] = k < per && i < Q ? dtg[i * dt_sl] : 0.f;
    if (k + 1 >= per) break;
  }
}

// One head's buffers: dt and cum = cumsum(dt * A) in fp64 over rows [0, Q)
// (0 past Q, to QP), the decay factors, and the scan's scratch.
struct HeadBuf {
  double* cum;
  float* dt;
  float* fac;
  double* scratch;
};

// The fp64 scan of dt * A in two halves around a barrier.  scan_a: each
// thread's run of rows (dA rounded to fp32, as the plain version rounds
// it) and its place in the warp's inclusive scan; the warp totals go to
// the scratch.  scan_b, after the barrier: each run's offset, and cum.
struct Scan {
  double da[MAX_PER];
  double excl;   // the sum of the runs before this thread's in its warp
};

__device__ __forceinline__ void scan_a(const float (&d)[MAX_PER], float A,
                                       int QP, const HeadBuf& hb, Scan& sc) {
  const int lane = threadIdx.x & 31;
  const int per = (QP + TNT - 1) / TNT, lo = threadIdx.x * per;
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < MAX_PER; ++k) {
    if (k >= per || lo + k >= QP) break;
    sc.da[k] = static_cast<double>(d[k] * A);
    hb.dt[lo + k] = d[k];
    run += sc.da[k];
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) hb.scratch[threadIdx.x >> 5] = incl;
  sc.excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) sc.excl = 0.0;
}

__device__ __forceinline__ void scan_b(const Scan& sc, int Q, int QP,
                                       const HeadBuf& hb) {
  const int per = (QP + TNT - 1) / TNT, lo = threadIdx.x * per;
  double acc = sc.excl;
  for (int w = 0; w < (threadIdx.x >> 5); ++w) acc += hb.scratch[w];
#pragma unroll
  for (int k = 0; k < MAX_PER; ++k) {
    const int i = lo + k;
    if (k >= per || i >= QP) break;
    acc += sc.da[k];
    hb.cum[i] = i < Q ? acc : 0.0;
  }
}

template <int DN, int DP>
__global__ void __launch_bounds__(TNT, 2)
    ssd_tc_kernel(const __grid_constant__ CUtensorMap x_map, Params p) {
  using Tl = TcTiling<DN, DP>;
  constexpr int LDN = Tl::LDN, LDB = Tl::LDB;
  constexpr int XSLOT = Tl::XSLOT, AHEAD = XS - 1;   // x tiles in flight
  extern __shared__ unsigned char smem_raw[];
  const int Q = p.Q, QP = Tl::qp(Q), N = p.N, P = p.P;
  const int n_qt = QP / TR, n_nt = (N + Tl::SROWS - 1) / Tl::SROWS;
  unsigned char* base =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* ring = reinterpret_cast<bf16*>(base);
  unsigned char* head = base + Tl::RING_BYTES;
  // head buffer k of 2: cum [2][QP] fp64, dt and factors [2][QP] fp32,
  // scratch [2][4] fp64; then the x slots' mbarriers
  auto head_buf = [&](int k) {
    double* cum = reinterpret_cast<double*>(head);
    float* dt = reinterpret_cast<float*>(cum + 2 * QP);
    double* scratch = reinterpret_cast<double*>(dt + 4 * QP);
    return HeadBuf{cum + k * QP, dt + k * QP, dt + (2 + k) * QP,
                   scratch + 4 * k};
  };
  const unsigned xbar = smem_u32(head) + 32 * QP + 64;   // XS, 8 B each
  unsigned char* area = head + Tl::head_bytes(Q);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;   // fragment row and column pair
  // (chunk, group), and the job of grid z, each job over all chunks before
  // the next: the state's n tiles and the q tiles (heaviest first)
  // alternate while both last, so that blocks heavy on the tensor cores
  // (state) and on forming M (y) share the SMs
  const int cgi = blockIdx.x, z = blockIdx.z, both = min(n_nt, n_qt);
  const bool is_state = z < 2 * both ? !(z & 1) : n_nt > n_qt;
  const int job = z < 2 * both ? z >> 1 : z - both;   // within its kind
  const int c = cgi % p.nc, g = cgi / p.nc, b = blockIdx.y;
  const long long l0 = static_cast<long long>(c) * Q;
  const bf16* bg = static_cast<const bf16*>(p.b) + b * p.b_sb + g * p.b_sg +
                   l0 * p.b_sl;
  const bf16* cg = static_cast<const bf16*>(p.c) + b * p.c_sb + g * p.c_sg +
                   l0 * p.c_sl;
  const bf16* xg0 = static_cast<const bf16*>(p.x) + b * p.x_sb + l0 * p.x_sl;
  const float* dtg0 = p.dt + b * p.dt_sb + l0 * p.dt_sl;
  const int h0 = g * p.hpg, hpg = p.hpg;
  const bool bc_al = p.bc_aligned, x_tma = p.x_tma;
  if (x_tma && threadIdx.x == 0) {
    for (int k = 0; k < XS; ++k) mbar_init(xbar + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // x tile s of a role's steps, rows r0 .. r0 + TR of head h, into slot
  // s % XS: one TMA per 64-column box, issued by thread 0, completing on
  // the slot's mbarrier; else element by element
  auto stage_x = [&](int s, int h, int r0) {
    bf16* slot = ring + (s % XS) * XSLOT;
    if (!x_tma) {
      stage_x_plain<DP>(slot, xg0 + h * p.x_sh, p.x_sl, r0, Q, P);
    } else if (threadIdx.x == 0) {
      const unsigned bar = xbar + 8 * (s % XS);
      mbar_expect_tx(bar, XSLOT * 2);
#pragma unroll
      for (int box = 0; box < DP / 64; ++box)
        tma_load_4d(smem_u32(slot + box * TR * 64), &x_map, bar, box * 64, h,
                    static_cast<int>(l0) + r0, b);
    }
  };
  // x of step s has landed (visible to all after the next barrier)
  auto wait_x = [&](int s) {
    if (x_tma) mbar_wait(xbar + 8 * (s % XS), (s / XS) & 1);
  };
  // Per head h, buffer h & 1 holds its dt, cum and decay factors.  Head
  // h + 1's are made under head h's products: scan_a before and scan_b
  // after the first barrier of head h's first step, the factors after its
  // second; its dt is in registers a head ahead.  The factors: a state
  // block's exp(cum_end - cum_q) dt_q; a y block's exp(ref - cum_j) dt_j,
  // ref = cum at the end of j's 16-column block (so that below the
  // diagonal L[i,j] dt_j = exp(cum_i - ref) * that, with both exponents
  // <= 0 where dA <= 0, every SSD model's case: dt > 0, A < 0).
  float dt_next[MAX_PER];
  Scan scan;
  auto factors = [&](const HeadBuf& hb) {
    const double cum_end = hb.cum[Q - 1];
    for (int i = threadIdx.x; i < QP; i += TNT) {
      const double ref = is_state ? cum_end : hb.cum[min(i | 15, Q - 1)];
      hb.fac[i] = i < Q ? exp_fp64(ref - hb.cum[i]) * hb.dt[i] : 0.f;
    }
  };
  load_dt(dt_next, dtg0 + h0 * p.dt_sh, p.dt_sl, Q, QP);
  scan_a(dt_next, p.A[h0], QP, head_buf(0), scan);
  if (hpg > 1) load_dt(dt_next, dtg0 + (h0 + 1) * p.dt_sh, p.dt_sl, Q, QP);
  __syncthreads();
  scan_b(scan, Q, QP, head_buf(0));
  __syncthreads();
  factors(head_buf(0));   // visible after the first step's first barrier
  // around the barriers of head hi's first step: head hi + 1's scan and
  // factors
  auto next_a = [&](int hi) {
    if (hi + 1 < hpg)
      scan_a(dt_next, p.A[h0 + hi + 1], QP, head_buf((hi + 1) & 1), scan);
  };
  auto next_b = [&](int hi) {
    if (hi + 1 < hpg) {
      scan_b(scan, Q, QP, head_buf((hi + 1) & 1));
      if (hi + 2 < hpg)
        load_dt(dt_next, dtg0 + (h0 + hi + 2) * p.dt_sh, p.dt_sl, Q, QP);
    }
  };
  auto next_fac = [&](int hi) {
    if (hi + 1 < hpg) factors(head_buf((hi + 1) & 1));
  };

  if (is_state) {
    // ---- state = W^T x, W = B exp(cum_end - cum) dt; SROWS columns of N
    constexpr int SM16 = Tl::SM16;                 // 64-row tiles of it
    const int n0 = job * Tl::SROWS;
    const int nw = n0 + 16 * warp;                 // rows nw + 64 m
    bf16* bs = reinterpret_cast<bf16*>(area);      // [QP][LDB] B columns
    const int steps = hpg * n_qt;                  // (head, q tile)
    int pf_h = h0, pf_t = 0;                       // the next step to stage
    auto stage_next = [&](int s) {
      if (s >= steps) return;
      stage_x(s, pf_h, pf_t * TR);
      if (++pf_t == n_qt) pf_t = 0, ++pf_h;
    };
    stage_rows<Tl::SROWS, LDB>(bs, bg + n0, p.b_sl, 0, QP, Q, N - n0, bc_al);
    cp_async_commit();
    for (int s = 0; s < AHEAD; ++s) stage_next(s);
    for (int hi = 0, s = 0; hi < hpg; ++hi) {
      const HeadBuf hb = head_buf(hi & 1);
      float acc[SM16][DP / 8][4] = {};
      for (int qt = 0; qt < n_qt; ++qt, ++s) {
        stage_next(s + AHEAD);
        if (s == 0) cp_async_wait<0>();   // B's columns landed
        wait_x(s);
        if (qt == 0) next_a(hi);
        __syncthreads();          // ... for every thread
        if (qt == 0) next_b(hi);
        const bf16* xs = ring + (s % XS) * XSLOT;
        // W's 16-row steps of the tile (0 past Q), every warp
        const int n16 = min(TR, Q - qt * TR + 15) / 16;
        unsigned a[TR / 16][SM16][PIECES][4];
#pragma unroll
        for (int kk = 0; kk < TR / 16; ++kk) {
          const int q16 = qt * TR + kk * 16;
          const float2 s0 = *reinterpret_cast<const float2*>(
              hb.fac + q16 + 2 * t4);
          const float2 s8 = *reinterpret_cast<const float2*>(
              hb.fac + q16 + 2 * t4 + 8);
#pragma unroll
          for (int m = 0; m < SM16; ++m) {
            if (kk >= n16) {
#pragma unroll
              for (int pi = 0; pi < PIECES; ++pi)
                a[kk][m][pi][0] = a[kk][m][pi][1] = a[kk][m][pi][2] =
                    a[kk][m][pi][3] = 0u;
              continue;
            }
            // Bᵀ's A fragment (rows n, k = q) by ldmatrix.trans of B
            unsigned bt[4];
            ldmatrix_x4_trans(bt, bs + (q16 + (lane & 7) +
                                        ((lane >> 4) << 3)) * LDB +
                                      16 * warp + 64 * m +
                                      ((lane >> 3) & 1) * 8);
            float v[8];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = unpack_bf16(bt[e]);
              const float2 sc = e < 2 ? s0 : s8;
              v[2 * e] = f.x * sc.x;
              v[2 * e + 1] = f.y * sc.y;
            }
            split(v, a[kk][m]);
          }
        }
        wgmma_issue<TR / 16, TR / 16, SM16, PIECES, DP>(acc, a, xs, 0);
        wgmma_wait<TR / 16, SM16, PIECES, DP>(acc, a);
        __syncthreads();          // the slot is consumed before it is refilled
        if (qt == 0) next_fac(hi);
      }
      const long long bhc =
          (static_cast<long long>(b) * p.H + h0 + hi) * p.nc + c;
#pragma unroll
      for (int m = 0; m < SM16; ++m)
        store_rows<DP>(p.state + bhc * N * P, acc[m], nw + 64 * m + g8, N, P,
                       t4);
    }
    return;
  }

  // ---- y = M x, M = (C Bᵀ) o L o dt, one 64-row q tile ------------------
  const int qt = n_qt - 1 - job;            // heaviest first
  const int q0 = qt * TR, n_kt = qt + 1;    // the causal k tiles
  const int ldc = QP + 8;
  float* cb = reinterpret_cast<float*>(area);              // [TR][QP+8]
  const int r0 = 16 * warp + g8;            // this lane's rows r0, r0 + 8

  // C Bᵀ for the q tile, k tile by k tile: C's fragments stay in registers
  stage_rows<DN, LDN>(ring, cg, p.c_sl, q0, TR, Q, N, bc_al);
  cp_async_commit();
  stage_rows<DN, LDN>(ring + Tl::BSLOT, bg, p.b_sl, 0, TR, Q, N, bc_al);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  unsigned cf[DN / 16][4];
#pragma unroll
  for (int kk = 0; kk < DN / 16; ++kk)
    ldmatrix_x4(cf[kk], ring + (16 * warp + (lane & 15)) * LDN +
                            (lane >> 4) * 8 + kk * 16);
  __syncthreads();   // slot 0 is free for B's second tile
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt)
      stage_rows<DN, LDN>(ring + (kt & 1) * Tl::BSLOT, bg, p.b_sl,
                          (kt + 1) * TR, TR, Q, N, bc_al);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* bts = ring + ((kt + 1) & 1) * Tl::BSLOT;
    float s[TR / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < DN / 16; ++kk)
#pragma unroll
      for (int n = 0; n < TR / 8; n += 2) {
        unsigned bk[4];
        ldmatrix_x4(bk, bts + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LDN
                            + kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[n], cf[kk], bk[0], bk[1]);
        mma16816(s[n + 1], cf[kk], bk[2], bk[3]);
      }
#pragma unroll
    for (int n = 0; n < TR / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(cb + (r0 + 8 * r) * ldc + kt * TR + n * 8 +
                                   2 * t4) =
            make_float2(s[n][2 * r], s[n][2 * r + 1]);
    __syncthreads();   // the B slot is consumed; C Bᵀ visible at the end
  }

  // head by head: M's rows from C Bᵀ, the head's cum and factors; y = M x
  const int steps = hpg * n_kt;             // (head, k tile)
  int pf_h = h0, pf_t = 0;                  // the next step to stage
  auto stage_next = [&](int s) {
    if (s >= steps) return;
    stage_x(s, pf_h, pf_t * TR);
    if (++pf_t == n_kt) pf_t = 0, ++pf_h;
  };
  // the ring's C and B tiles were written and read through the generic
  // proxy; TMA writes its x slots through the async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int s = 0; s < AHEAD; ++s) stage_next(s);
  const int i0 = q0 + r0, i1 = i0 + 8;      // this lane's rows of y
  const bool warp_live = q0 + 16 * warp < Q;
  // M's fragment of the 16 columns from j0, (row, column) of v[2e] and
  // v[2e+1]: a0 (i0; jc, jc+1), a1 (i1; jc, jc+1), a2 (i0; jc+8, jc+9),
  // a3 (i1; jc+8, jc+9) with jc = j0 + 2 t4
  auto cb_frag = [&](int jc, float (&v)[8]) {
    const float* cb0 = cb + r0 * ldc + jc;
    const float* cb1 = cb0 + 8 * ldc;
    const float2 c00 = *reinterpret_cast<const float2*>(cb0);
    const float2 c10 = *reinterpret_cast<const float2*>(cb1);
    const float2 c08 = *reinterpret_cast<const float2*>(cb0 + 8);
    const float2 c18 = *reinterpret_cast<const float2*>(cb1 + 8);
    v[0] = c00.x; v[1] = c00.y; v[2] = c10.x; v[3] = c10.y;
    v[4] = c08.x; v[5] = c08.y; v[6] = c18.x; v[7] = c18.y;
  };
  for (int hi = 0, s = 0; hi < hpg; ++hi) {
    const HeadBuf hb = head_buf(hi & 1);
    const long long bhc =
        (static_cast<long long>(b) * p.H + h0 + hi) * p.nc + c;
    const double ci0 = hb.cum[i0], ci1 = hb.cum[i1];
    // a 16-column block below the diagonal: L[i,j] dt_j = exp(cum_i - ref)
    // fac_j; none past Q, rows past Q 0
    auto below = [&](int j0, unsigned (&a)[1][PIECES][4]) {
      const double ref = hb.cum[j0 + 15];
      const float e[2] = {
          i0 < Q ? exp_fp64(ci0 - ref) : 0.f,
          i1 < Q ? exp_fp64(ci1 - ref) : 0.f};
      const int jc = j0 + 2 * t4;
      float v[8];
      cb_frag(jc, v);
      const float2 f0 = *reinterpret_cast<const float2*>(hb.fac + jc);
      const float2 f8 = *reinterpret_cast<const float2*>(hb.fac + jc + 8);
      const float f[4] = {f0.x, f0.y, f8.x, f8.y};
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] *= f[(k & 1) + ((k >> 2) << 1)] * e[(k >> 1) & 1];
      split(v, a[0]);
    };
    float acc[1][DP / 8][4] = {};
    for (int kt = 0; kt < n_kt; ++kt, ++s) {
      stage_next(s + AHEAD);
      wait_x(s);
      if (kt == 0) next_a(hi);
      __syncthreads();          // ... for every thread
      if (kt == 0) next_b(hi);
      const bf16* xs = ring + (s % XS) * XSLOT;
      // four 16-column blocks: below the diagonal (factored decays), on
      // it (exp per term on and below the diagonal), or above it (0)
      unsigned a[TR / 16][1][PIECES][4];
#pragma unroll
      for (int kk = 0; kk < TR / 16; ++kk) {
        const int j0 = kt * TR + kk * 16;
        if (warp_live && (kt < qt || kk < warp)) {
          below(j0, a[kk]);
        } else if (warp_live && kk == warp) {
          const int jc = j0 + 2 * t4;
          float v[8];
          cb_frag(jc, v);
          const double2 cj0 = *reinterpret_cast<const double2*>(hb.cum + jc);
          const double2 cj8 =
              *reinterpret_cast<const double2*>(hb.cum + jc + 8);
          const float2 d0 = *reinterpret_cast<const float2*>(hb.dt + jc);
          const float2 d8 = *reinterpret_cast<const float2*>(hb.dt + jc + 8);
          const double cj[4] = {cj0.x, cj0.y, cj8.x, cj8.y};
          const float dj[4] = {d0.x, d0.y, d8.x, d8.y};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int col = (k & 1) + ((k >> 2) << 1);   // into cj, dj
            const int i = (k >> 1) & 1 ? i1 : i0;
            const int j = jc + (k & 1) + ((k >> 2) << 3);
            const double ci = (k >> 1) & 1 ? ci1 : ci0;
            v[k] = j <= i && i < Q ? v[k] * exp_fp64(ci - cj[col]) * dj[col]
                                   : 0.f;
          }
          split(v, a[kk][0]);
        } else {
#pragma unroll
          for (int pi = 0; pi < PIECES; ++pi)
            a[kk][0][pi][0] = a[kk][0][pi][1] = a[kk][0][pi][2] =
                a[kk][0][pi][3] = 0u;
        }
      }
      wgmma_issue<TR / 16, TR / 16, 1, PIECES, DP>(acc, a, xs, 0);
      wgmma_wait<TR / 16, 1, PIECES, DP>(acc, a);
      __syncthreads();          // the slot is consumed before it is refilled
      if (kt == 0) next_fac(hi);
    }
    for (int i = q0 + threadIdx.x; i < min(q0 + TR, Q); i += TNT)
      p.cum[bhc * Q + i] = static_cast<float>(hb.cum[i]);
    store_rows<DP>(p.y + bhc * Q * P, acc[0], i0, Q, P, t4);
  }
}

template <typename Tl>
cudaError_t prepare_tc() {
  static std::atomic<bool> ready[MAX_DEVICES];
  return prepare(ssd_tc_kernel<Tl::DN, Tl::DP>, ready);
}

// The bf16 tiling that holds N and P, handed to fn (ssd_intra_chunk_fwd,
// ssd_path and ssd_load_kernels)
template <typename Fn>
decltype(auto) with_bf16_tiling(int P, int N, Fn&& fn) {
  if (P <= 64) {
    if (N <= 64) return fn(TcTiling<64, 64>{});
    if (N <= 128) return fn(TcTiling<128, 64>{});
    return fn(TcTiling<256, 64>{});
  }
  if (N <= 64) return fn(TcTiling<64, 128>{});
  if (N <= 128) return fn(TcTiling<128, 128>{});
  return fn(TcTiling<256, 128>{});
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

// x [B, L, H, P] (P contiguous, the other strides p's) as a 4-d map of
// boxes of 64 columns by 64 rows of L, 128-byte swizzle, zeros outside.
// False where TMA cannot take the view (not 16-byte aligned).
bool encode_x(CUtensorMap* map, const Params& p, int B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || !p.x_aligned) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.P),
                              static_cast<cuuint64_t>(p.H),
                              static_cast<cuuint64_t>(p.nc) * p.Q,
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(p.x_sh) * 2,
                                 static_cast<cuuint64_t>(p.x_sl) * 2,
                                 static_cast<cuuint64_t>(p.x_sb) * 2};
  const cuuint32_t box[4] = {64, 1, TR, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(p.x), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Tl>
cudaError_t launch_tc(const Params& p, int B, cudaStream_t stream) {
  const cudaError_t err = prepare_tc<Tl>();
  if (err != cudaSuccess) return err;
  CUtensorMap x_map{};
  Params q = p;
  q.x_tma = encode_x(&x_map, p, B);
  const int n_jobs = (p.N + Tl::SROWS - 1) / Tl::SROWS + n_tiles(p.Q);
  const dim3 grid(p.nc * (p.H / p.hpg), B, n_jobs);
  ssd_tc_kernel<Tl::DN, Tl::DP>
      <<<grid, TNT, Tl::bytes(p.Q), stream>>>(x_map, q);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, B and C): 0 = float32, 1 = bfloat16; dt and A are float32.
// Strides are in elements.  Returns the cudaError_t of the launch (0 on
// success); the kernel runs asynchronously on `stream`.
extern "C" int ssd_intra_chunk_fwd(
    const void* x, const void* dt, const void* A, const void* b,
    const void* c, void* y, void* state, void* cum, int dtype, int B, int nc,
    int Q, int H, int G, int P, int N, long long x_sb, long long x_sl,
    long long x_sh, long long dt_sb, long long dt_sl, long long dt_sh,
    long long b_sb, long long b_sl, long long b_sg, long long c_sb,
    long long c_sl, long long c_sg, void* stream) {
  if (B <= 0 || nc <= 0 || Q <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      P <= 0 || P > 128 || N <= 0 || N > 256 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto al = [](const void* ptr, long long s0, long long s1, long long s2) {
    return reinterpret_cast<unsigned long long>(ptr) % 16 == 0 &&
           s0 % 8 == 0 && s1 % 8 == 0 && s2 % 8 == 0;
  };
  const int x_al = al(x, x_sb, x_sl, x_sh);
  const int bc_al = al(b, b_sb, b_sl, b_sg) && al(c, c_sb, c_sl, c_sg);
  Params p{x,    static_cast<const float*>(dt), static_cast<const float*>(A),
           b,    c,    static_cast<float*>(y),  static_cast<float*>(state),
           static_cast<float*>(cum),            H,     H / G, nc,   Q,
           P,    N,    x_sb, x_sl, x_sh,        dt_sb, dt_sl, dt_sh,
           b_sb, b_sl, b_sg, c_sb, c_sl,        c_sg,  x_al,  bc_al, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_p<float>(p, B, st));
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_bf16_tiling(P, N, [&](auto tl) {
    using Tl = decltype(tl);
    return Tl::fits(Q) ? launch_tc<Tl>(p, B, st)
                       : launch_p<__nv_bfloat16>(p, B, st);
  }));
}

// Load every kernel of the library onto the current device and raise each
// one's shared memory (prepare), so that no launch of a served path pays
// for it.  Returns a cudaError_t (0 on success).
extern "C" int ssd_load_kernels() {
  cudaError_t err = prepare_fma<float, 1>();
  if (err == cudaSuccess) err = prepare_fma<float, 2>();
  if (err == cudaSuccess) err = prepare_fma<float, 4>();
  if (err == cudaSuccess) err = prepare_fma<float, 8>();
  if (err == cudaSuccess) err = prepare_fma<__nv_bfloat16, 1>();
  if (err == cudaSuccess) err = prepare_fma<__nv_bfloat16, 2>();
  if (err == cudaSuccess) err = prepare_fma<__nv_bfloat16, 4>();
  if (err == cudaSuccess) err = prepare_fma<__nv_bfloat16, 8>();
  for (const int P : {64, 128})
    for (const int N : {64, 128, 256})
      if (err == cudaSuccess)
        err = with_bf16_tiling(P, N, [](auto tl) {
          return prepare_tc<decltype(tl)>();
        });
  return static_cast<int>(err);
}

// What ssd_intra_chunk_fwd runs for this dtype, chunk and head and state
// dims
extern "C" const char* ssd_path(int dtype, int Q, int P, int N) {
  static char name[192];
  if (dtype != 1 || Q <= 0 || P <= 0 || N <= 0)
    return "fp32 CUDA cores, 64 x 64 tiles, C B^T per head";
  with_bf16_tiling(P, N, [&](auto tl) {
    using Tl = decltype(tl);
    if (!Tl::fits(Q))
      snprintf(name, sizeof name,
               "bf16 CUDA cores (Q %d: %d B of shared memory on the tensor "
               "cores), C B^T per head",
               Q, Tl::bytes(Q));
    else
      snprintf(name, sizeof name,
               "mma.sync, C B^T once per group, %d bf16 pieces, x by TMA "
               "where 16-byte aligned, N/P padded to %d/%d, %d B dynamic "
               "shared memory",
               PIECES, Tl::DN, Tl::DP, Tl::bytes(Q));
    return 0;
  });
  return name;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
