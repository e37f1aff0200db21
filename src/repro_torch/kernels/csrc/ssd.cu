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
// Design.  One block of 256 threads per (chunk, head, batch).  The Pallas
// kernel holds a whole chunk; at Q 256, P 64, N 128 that is 320 KB in
// fp32, more than a Hopper block's 227 KB, so this kernel tiles it,
// flash-style without the softmax.  The block first stages dt and cum
// (one warp scans cum in fp64 and keeps it in shared memory).  Then, for
// each 64-row q tile, it keeps that tile of C in shared memory and walks
// the causal 64-row k tiles: B and x*dt are staged, each thread computes
// a 4x4 patch of the C B^T tile with CUDA-core FMAs, multiplies in the
// decay (0 above the diagonal), the tile goes to shared memory, and y
// accumulates in registers (4 rows x P/16 columns a thread).  A second
// pass over the q tiles computes the state 64 rows of N at a time from B
// scaled by the decay to the chunk's end.  At N 128, P 64 the block holds
// 102 KB of shared memory, so two blocks fit on an SM.  ptxas (-Xptxas -v,
// nvcc 12.9, sm_90a): the instances for P <= 32, 64 and 128 use 80, 98-100
// and 128 registers and spill nothing; those for P <= 16 use 80 and spill
// 4 bytes.
//
// Bound.  At the prefill shape of mamba2-130m serving (B 8, L 4096, H 24,
// P 64, G 1, N 128, Q 256, bf16 x, B, C; fp32 dt and outputs) the kernel
// must read its inputs and write y, state and cum once: 425 MB, 0.127 ms
// at 3.35 TB/s; it does 5.2e10 FLOP (the causal half of C B^T and of
// (C B^T o L)(x dt), and the state product), 0.053 ms at the bf16
// tensor-core peak.  So the floor is the bytes.  This version runs every
// product on the CUDA cores in fp32 (67 TFLOP/s at most, 0.78 ms for this
// work) at one shared-memory load per two FMAs, and computes C B^T once
// per head where mamba2's 24 heads share one group; tensor-core tiles
// (bf16 products are exact in fp32) and one C B^T per group are the way
// down to the floor.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 64;          // rows of a q, k or state tile
constexpr int NT = 256;         // threads: 16 row groups x 16 column lanes
constexpr int RPT = TR / 16;    // tile rows (and columns) per thread

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

template <typename T, int NV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int floats = 3 * n_tiles(p.Q) * TR + TR * (p.N + 1) +
                     b_floats(p.N) + TR * 16 * NV + TR * (TR + 1);
  const int bytes = floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
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
  Params p{x,    static_cast<const float*>(dt), static_cast<const float*>(A),
           b,    c,    static_cast<float*>(y),  static_cast<float*>(state),
           static_cast<float*>(cum),            H,     H / G, nc,   Q,
           P,    N,    x_sb, x_sl, x_sh,        dt_sb, dt_sl, dt_sh,
           b_sb, b_sl, b_sg, c_sb, c_sl,        c_sg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0   ? launch_p<float>(p, B, st)
      : dtype == 1 ? launch_p<__nv_bfloat16>(p, B, st)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
