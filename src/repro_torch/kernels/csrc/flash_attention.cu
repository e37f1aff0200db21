// Flash attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by pl.pallas_call in flash_attention_bhsd).  It computes the same
// function: blockwise online-softmax attention with an fp32 running max,
// denominator and accumulator; GQA maps query head h to kv head h / (H/K)
// by index, never by repeating K/V; causal masking by absolute position
// with -1e30, KV tiles past the diagonal skipped; the denominator clamped
// at 1e-30; output in q's dtype.
//
// Layout.  q [B,S,H,hd], k [B,T,K,hd], v [B,T,K,hdv] and o [B,S,H,hdv] are
// read and written through the element strides the caller passes (the last
// dimension contiguous), so the model's layout needs no transposes.  Any S
// and T are taken: the ragged edge of the last tile is masked here, where
// the Pallas wrapper asserts S % block == 0.  hd and hdv may differ (MLA).
//
// Design.  One thread block of 256 threads per (q tile of 64 rows, head,
// batch).  The block keeps q (pre-scaled, fp32) in shared memory and walks
// the KV tiles of 64 rows: K^T is staged into shared memory, each thread
// computes a 4x4 patch of the 64x64 score tile with CUDA-core FMAs, the row
// max and sum are reduced across the 16 threads that share a row with warp
// shuffles, the probabilities go to shared memory, and V is staged into the
// buffer K^T used before, so a block at hd 128 holds 81 KB and two blocks
// fit on an SM.  Causal q tiles are issued heaviest first.
//
// Bound.  At the prefill shape of deepseek-7b serving (B 4, S 1024, H = K =
// 32, hd 128, causal, bf16) the kernel must move q, k, v and o once: 134 MB,
// 40 us at 3.35 TB/s; it does 3.4e10 FLOP, 35 us at the bf16 tensor-core
// peak of 989 TFLOP/s.  So the floor is the bytes, about 40 us.  This
// version runs its products on the CUDA cores (about 67 TFLOP/s fp32) and
// reads its operands from shared memory at one load per two FMAs, so it is
// bound by shared-memory traffic well above that floor; mma.sync / wgmma
// tiles fed by TMA are the way down to it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key/value rows per tile
constexpr int NT = 256;       // threads: 16 row groups x 16 column lanes
constexpr int RPT = BQ / 16;  // score rows per thread
constexpr int CPT = BK / 16;  // score columns per thread
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, G, hd, hdv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ inline int kv_floats(int hd, int nv) {
  const int kt = hd * (BK + 1), vt = BK * 16 * nv;
  return kt > vt ? kt : vt;
}

// NV = column groups of 16 in the output row (hdv <= 16 * NV).
template <typename T, int NV>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int hd = p.hd, hdv = p.hdv;
  const int q_ld = hd + 1, kt_ld = BK + 1, p_ld = BK + 1, v_ld = 16 * NV;
  float* qs = smem;                         // [BQ][hd+1]  q * scale
  float* kv = qs + BQ * q_ld;               // [hd][BK+1] K^T, then [BK][v_ld] V
  float* ps = kv + kv_floats(hd, NV);       // [BQ][BK+1]  probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.G;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * hd; i += NT) {
    const int r = i / hd, d = i - r * hd, s = q0 + r;
    qs[r * q_ld + d] = s < p.S ? to_f(qg[s * p.q_ss + d]) * p.scale : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][NV];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n) acc[i][n] = 0.f;
  }

  int n_kt = (p.T + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    for (int i = tid; i < BK * hd; i += NT) {
      const int c = i / hd, d = i - c * hd, t = k0 + c;
      kv[d * kt_ld + c] = t < p.T ? to_f(kg[t * p.k_ss + d]) : 0.f;
    }
    __syncthreads();  // K^T staged (and q, on the first tile)

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float a[RPT], bk[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = qs[(ty + 16 * i) * q_ld + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) bk[j] = kv[d * kt_ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= p.T)
          s[i][j] = -INFINITY;  // past the ragged edge: weight exactly 0
        else if (p.causal && kpos > qpos)
          s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pj = expf(s[i][j] - mx);
        ps[(ty + 16 * i) * p_ld + tx + 16 * j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int n = 0; n < NV; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();  // K^T no longer read; probabilities visible

    for (int i = tid; i < BK * v_ld; i += NT) {
      const int c = i / v_ld, d = i - c * v_ld, t = k0 + c;
      kv[i] = (t < p.T && d < hdv) ? to_f(vg[t * p.v_ss + d]) : 0.f;
    }
    __syncthreads();  // V staged

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pc[i] = ps[(ty + 16 * i) * p_ld + c];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const float vv = kv[c * v_ld + tx + 16 * n];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][n] = fmaf(pc[i], vv, acc[i][n]);
      }
    }
    __syncthreads();  // V and probabilities consumed before the next tile
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= p.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int col = tx + 16 * n;
      if (col < hdv) og[s * p.o_ss + col] = from_f<T>(acc[i][n] / den);
    }
  }
}

template <typename T, int NV>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
  const int floats = BQ * (p.hd + 1) + kv_floats(p.hd, NV) + BQ * (BK + 1);
  const int bytes = floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, NV><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hdv(const Params& p, int B, int H, cudaStream_t stream) {
  if (p.hdv <= 32) return launch<T, 2>(p, B, H, stream);
  if (p.hdv <= 64) return launch<T, 4>(p, B, H, stream);
  if (p.hdv <= 128) return launch<T, 8>(p, B, H, stream);
  if (p.hdv <= 256) return launch<T, 16>(p, B, H, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// cudaError_t of the launch (0 on success); the kernel runs asynchronously
// on `stream`.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int T, int H, int K, int hd, int hdv, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int causal,
    void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      hd <= 0 || hdv <= 0 || hd > 256 || hdv > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    S,    T,    H / K, hd,   hdv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,  v_ss, v_sh,
           o_sb, o_ss, o_sh, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_hdv<float>(p, B, H, st)
                              : dtype == 1
                                    ? launch_hdv<__nv_bfloat16>(p, B, H, st)
                                    : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
