// Flash attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by pl.pallas_call in flash_attention_bhsd).  It computes the same
// function: blockwise online-softmax attention with an fp32 running max,
// denominator and accumulator; GQA maps query head h to kv head h / (H/K)
// by index, never by repeating K/V; causal masking by absolute position
// with -1e30, KV tiles past the diagonal skipped (query row i at key
// position q_off + i: 0 in the TPU kernel, the last S of T or a rank's rows
// of a split sequence here); the denominator clamped
// at 1e-30; output in q's dtype.
//
// Layout.  q [B,S,H,hd], k [B,T,K,hd], v [B,T,K,hdv] and o [B,S,H,hdv] are
// read and written through the element strides the caller passes (the last
// dimension contiguous), so the model's layout needs no transposes.  Any S
// and T are taken: the ragged edge of the last tile is masked here, where
// the Pallas wrapper asserts S % block == 0.  hd and hdv may differ (MLA).
//
// bf16: tensor cores.  One block of 4 warps per (head, batch, q tile);
// each warp owns 16 MI query rows (MI = 2 where hd and hdv pad to 64 or
// 128, the served shapes, so every K and V fragment read from shared
// memory feeds two MMAs; MI = 1 at 32 and 256).  q, K and V stay bf16 in
// shared memory (rows padded by 16 bytes, so ldmatrix reads 8 rows on 8
// distinct bank groups); K and V tiles of 64 rows stream through a
// two-stage cp.async ring, zero-filled past T and past hd / hdv, so tile
// j + 1 is in flight while tile j is multiplied.  S = q·Kᵀ runs on
// mma.sync.m16n8k16 (bf16 operands by ldmatrix, fp32 accumulators); the
// softmax scale is applied to S in fp32 after the product; the online
// softmax runs on the accumulator registers (row max and sum across the 4
// lanes of a row by shuffles); P is rounded to bf16 in registers and is,
// in the m16n8k16 accumulator layout, already the A operand of P·V, whose
// V fragments come from ldmatrix.trans.  So S and P never touch shared
// memory.  Rounding P to bf16 is a rounding the reference (P·V in fp32)
// does not have: at most 2^-9 relative per weight; chip_smoke.py phases 2
// and 4 hold it to the unchanged tolerances.  hd and hdv are padded to one
// of five tilings (32/32, 64/64, 128/128, 256/128, 256/256); q stays in
// registers with MI = 1 up to a padded hd of 128 and is otherwise re-read
// from shared memory at each KV tile (at hdv 256 the 16 x 256 fp32
// accumulator alone takes 128 registers a thread).  Causal q tiles are
// issued heaviest first (the q tile is the grid's slowest dimension).
// Each kernel's shared-memory attribute is set once per device (prepare);
// flash_attention_load_kernels does that for every kernel, fp32 ones too,
// when the library is loaded, so no launch on a served path loads one.
// mma.sync and not wgmma: a 64-row wgmma tile per warpgroup with P from
// registers needs the producer/consumer structure of K3 and a second
// accumulator layout; mma.sync met this kernel's bar first and wgmma is
// the next step.
//
// fp32: CUDA cores, in full fp32 (TF32 would break the 2e-5 tolerance).
// One block of 256 threads per (q tile of 64 rows, head, batch) stages
// q, K^T and V in fp32 shared memory and computes a 4x4 patch of each
// 64x64 score tile per thread.
//
// Bound.  At the prefill shape of deepseek-7b serving (B 4, S 1024, H = K =
// 32, hd 128, causal, bf16) the kernel must move q, k, v and o once: 134 MB,
// 40 us at 3.35 TB/s; it does 3.4e10 FLOP over the causal pairs, 35 us at
// the bf16 tensor-core peak of 989 TFLOP/s.  So the floor is the bytes,
// about 40 us.  mma.sync reaches only part of the tensor cores' peak and
// each block re-reads its K/V tiles from L2; wgmma with TMA-fed tiles and
// a producer warp is the way further down.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdio>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key/value rows per tile
constexpr int NT = 256;       // threads: 16 row groups x 16 column lanes
constexpr int MAX_HD = 256;   // the widest hd and hdv taken
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
  int q_off;  // query row i sits at key position q_off + i (causal mask)
};

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__host__ __device__ constexpr int kv_floats(int hd, int nv) {
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
  if (p.causal) n_kt = min(n_kt, (p.q_off + q0 + BQ + BK - 1) / BK);

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
      const int qpos = p.q_off + q0 + ty + 16 * i;
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

constexpr int MAX_DEVICES = 64;

// Once per kernel and device: raise its dynamic shared memory above 48 KB
// to `bytes` (which also loads it, where modules load lazily).  Later
// launches set no attribute.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes,
                    std::atomic<bool> (&ready)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) ready[dev].store(true, std::memory_order_release);
  return err;
}

__host__ __device__ constexpr int fma_bytes(int hd, int nv) {
  return (BQ * (hd + 1) + kv_floats(hd, nv) + BQ * (BK + 1)) *
         static_cast<int>(sizeof(float));
}

// fp32: the attribute is set once to the most any hd takes
template <typename T, int NV>
cudaError_t prepare_fma() {
  static std::atomic<bool> ready[MAX_DEVICES];
  return prepare(flash_fwd_kernel<T, NV>, fma_bytes(MAX_HD, NV), ready);
}

template <typename T, int NV>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
  const cudaError_t err = prepare_fma<T, NV>();
  if (err != cudaSuccess) return err;
  const int bytes = fma_bytes(p.hd, NV);
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

// ---------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16, operands by ldmatrix, K/V tiles
// through a two-stage cp.async ring)
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int TK = 64;        // key/value rows per tile
constexpr int TNT = 128;      // threads: 4 warps
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; !valid zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
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

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Copy rows [r0, r0 + ROWS) of a [n_rows, d] matrix (row stride `ld_g`
// elements, d a multiple of 8) into shared memory as ROWS x D with row
// stride LD, zero-filling rows past n_rows and columns past d.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(bf16* __restrict__ dst,
                                          const bf16* __restrict__ src,
                                          long long ld_g, int r0, int n_rows,
                                          int d) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += TNT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const bool valid = r0 + r < n_rows && c < d;
    cp_async16(dst + r * LD + c, valid ? src + (r0 + r) * ld_g + c : src,
               valid);
  }
}

template <int DK_, int DV_, int MI_>
struct TcTiling {
  static constexpr int DK = DK_, DV = DV_, MI = MI_;
  static constexpr int BQ = 64 * MI;    // 4 warps of 16 MI query rows
  static constexpr int LDK = DK + 8;    // +16 bytes: rows on other banks
  static constexpr int LDV = DV + 8;
  static constexpr int Q_ELEMS = BQ * LDK;
  static constexpr int K_ELEMS = TK * LDK;
  static constexpr int V_ELEMS = TK * LDV;
  static constexpr int BYTES = 2 * (Q_ELEMS + 2 * K_ELEMS + 2 * V_ELEMS);
};

// DK, DV: hd and hdv padded to a multiple of 16 (the MMA's k and 2 n8).
// MI: m16 row tiles per warp.  With MI 2 each K and V fragment read from
// shared memory feeds two MMAs, which halves the shared-memory traffic per
// product; q is then re-read from shared memory at every KV tile, where
// with MI 1 (and DK <= 128) it stays in registers.
template <int DK, int DV, int MI>
__global__ void __launch_bounds__(TNT) flash_fwd_mma_kernel(Params p) {
  using Tl = TcTiling<DK, DV, MI>;
  constexpr int BQ = Tl::BQ, LDK = Tl::LDK, LDV = Tl::LDV;
  constexpr bool Q_IN_REGS = MI == 1 && DK <= 128;
  constexpr int KS = DK / 16;    // k16 steps of q·Kᵀ
  constexpr int NS = TK / 8;     // n8 tiles of a 16 x 64 score tile
  constexpr int NO = DV / 8;     // n8 tiles of a 16 x DV output tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LDK]
  bf16* ks = qs + Tl::Q_ELEMS;                    // [2][TK][LDK]
  bf16* vs = ks + 2 * Tl::K_ELEMS;                // [2][TK][LDV]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest first
  const int kh = h / p.G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = warp * 16 * MI;   // the warp's first row in the block

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  int n_kt = (p.T + TK - 1) / TK;
  if (p.causal) n_kt = min(n_kt, (p.q_off + q0 + BQ + TK - 1) / TK);

  load_rows<BQ, DK, LDK>(qs, qg, p.q_ss, q0, p.S, p.hd);
  load_rows<TK, DK, LDK>(ks, kg, p.k_ss, 0, p.T, p.hd);
  cp_async_commit();
  load_rows<TK, DV, LDV>(vs, vg, p.v_ss, 0, p.T, p.hdv);
  cp_async_commit();

  // row tile i of the warp; this lane's rows in it: g and g + 8 (r = 0, 1)
  float o[MI][NO][4], m[MI][2], l[MI][2];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = NEG_INF;
      l[i][r] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  }
  unsigned qf[Q_IN_REGS ? KS : 1][4];
  const bf16* q_lane = qs + (w0 + (lane & 15)) * LDK + (lane >> 4) * 8;

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    const bf16* kst = ks + st * Tl::K_ELEMS;
    const bf16* vst = vs + st * Tl::V_ELEMS;
    cp_async_wait<1>();   // K_j (and q) landed; V_j may still be in flight
    __syncthreads();      // ... for every thread, and K_{j-1} is consumed
    if (j + 1 < n_kt)
      load_rows<TK, DK, LDK>(ks + (st ^ 1) * Tl::K_ELEMS, kg, p.k_ss,
                             (j + 1) * TK, p.T, p.hd);
    cp_async_commit();
    if (Q_IN_REGS && j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[Q_IN_REGS ? kk : 0], q_lane + kk * 16);
    }

    // S = q·Kᵀ for this warp's 16 MI rows x 64 keys
    float s[MI][NS][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if (Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[i][e] = qf[Q_IN_REGS ? kk : 0][e];
        } else {
          ldmatrix_x4(a[i], q_lane + i * 16 * LDK + kk * 16);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        // matrices (keys 0-7, k 0-7), (keys 0-7, k 8-15), (keys 8-15,
        // k 0-7), (keys 8-15, k 8-15): B fragments of two n8 tiles
        unsigned bk[4];
        ldmatrix_x4(bk, kst + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LDK
                            + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma16816(s[i][n], a[i], bk[0], bk[1]);
          mma16816(s[i][n + 1], a[i], bk[2], bk[3]);
        }
      }
    }

    // scale in fp32, mask the ragged edge and the diagonal, online softmax
    const int k0 = j * TK;
    const bool edge =
        k0 + TK > p.T || (p.causal && k0 + TK - 1 > p.q_off + q0);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[i][n][e] * p.scale;
          if (edge) {
            const int kpos = k0 + n * 8 + 2 * t + (e & 1);
            const int qpos = p.q_off + q0 + w0 + i * 16 + g + (e >> 1) * 8;
            if (kpos >= p.T)
              x = -INFINITY;      // past the ragged edge: weight exactly 0
            else if (p.causal && kpos > qpos)
              x = NEG_INF;
          }
          s[i][n][e] = x;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[i][r];
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(s[i][n][2 * r], s[i][n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2f((m[i][r] - mx) * LOG2E);
        m[i][r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[i][n][e] = exp2f((s[i][n][e] - mx) * LOG2E);
            sum += s[i][n][e];
          }
        l[i][r] = l[i][r] * alpha + sum;   // this lane's columns only
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[i][n][2 * r] *= alpha;
          o[i][n][2 * r + 1] *= alpha;
        }
      }
    }

    cp_async_wait<1>();   // V_j landed; K_{j+1} may still be in flight
    __syncthreads();      // ... for every thread, and V_{j-1} is consumed
    if (j + 1 < n_kt)
      load_rows<TK, DV, LDV>(vs + (st ^ 1) * Tl::V_ELEMS, vg, p.v_ss,
                             (j + 1) * TK, p.T, p.hdv);
    cp_async_commit();

    // O += P·V: the S accumulators of n8 tiles 2kk and 2kk + 1 are, packed
    // to bf16, the A fragment of keys 16kk .. 16kk + 15
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      unsigned a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        a[i][0] = pack_bf16(s[i][2 * kk][0], s[i][2 * kk][1]);
        a[i][1] = pack_bf16(s[i][2 * kk][2], s[i][2 * kk][3]);
        a[i][2] = pack_bf16(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1]);
        a[i][3] = pack_bf16(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        // matrices (keys 0-7, cols 0-7), (keys 8-15, cols 0-7), (keys 0-7,
        // cols 8-15), (keys 8-15, cols 8-15), transposed into B fragments
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vst + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LDV +
                                  n * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma16816(o[i][n], a[i], bv[0], bv[1]);
          mma16816(o[i][n + 1], a[i], bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float den = l[i][r];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      den = fmaxf(den, 1e-30f);
      const int row = q0 + w0 + i * 16 + g + 8 * r;
      if (row >= p.S) continue;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < p.hdv)
          *reinterpret_cast<__nv_bfloat162*>(og + row * p.o_ss + col) =
              __floats2bfloat162_rn(o[i][n][2 * r] / den,
                                    o[i][n][2 * r + 1] / den);
      }
    }
}

template <typename Tl>
cudaError_t prepare_mma() {
  static std::atomic<bool> ready[MAX_DEVICES];
  return prepare(flash_fwd_mma_kernel<Tl::DK, Tl::DV, Tl::MI>, Tl::BYTES,
                 ready);
}

template <typename Tl>
cudaError_t launch_mma(const Params& p, int B, int H, cudaStream_t stream) {
  const cudaError_t err = prepare_mma<Tl>();
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (p.S + Tl::BQ - 1) / Tl::BQ);
  flash_fwd_mma_kernel<Tl::DK, Tl::DV, Tl::MI>
      <<<grid, TNT, Tl::BYTES, stream>>>(p);
  return cudaGetLastError();
}

// The smallest of the five tilings that holds hd and hdv, handed to fn
// (flash_attention_fwd, flash_attention_tiling and _load_kernels)
template <typename Fn>
decltype(auto) with_bf16_tiling(int hd, int hdv, Fn&& fn) {
  if (hd <= 32 && hdv <= 32) return fn(TcTiling<32, 32, 1>{});
  if (hd <= 64 && hdv <= 64) return fn(TcTiling<64, 64, 2>{});
  if (hd <= 128 && hdv <= 128) return fn(TcTiling<128, 128, 2>{});
  if (hdv <= 128) return fn(TcTiling<256, 128, 1>{});
  return fn(TcTiling<256, 256, 1>{});
}

// What a tiling is, from the constants its launch uses
template <typename Tl>
const char* tiling_name() {
  static char name[128];
  static const int written = snprintf(
      name, sizeof name,
      "mma.sync, q tile %d, hd/hdv padded to %d/%d, %d B dynamic shared "
      "memory",
      Tl::BQ, Tl::DK, Tl::DV, Tl::BYTES);
  (void)written;
  return name;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  q_off: the
// key position of query row 0 (a causal query block that is not the first
// rows of the keys: the last S of T, or a rank's rows of a split sequence);
// it moves the causal mask and the causal tile bound, nothing else, so 0
// gives the unshifted kernel bit for bit.  Returns the cudaError_t of the
// launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int T, int H, int K, int hd, int hdv, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int causal,
    int q_off, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      hd <= 0 || hdv <= 0 || hd > MAX_HD || hdv > MAX_HD || B > 65535 ||
      (S + 63) / 64 > 65535 || q_off < 0 || (causal && q_off + S > T))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    S,    T,    H / K, hd,   hdv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,  v_ss, v_sh,
           o_sb, o_ss, o_sh, scale, causal, q_off};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_hdv<float>(p, B, H, st));
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_bf16_tiling(hd, hdv, [&](auto tl) {
    return launch_mma<decltype(tl)>(p, B, H, st);
  }));
}

// Load every kernel of the library onto the current device and raise
// each one's shared memory (prepare), so that no launch of a served path
// pays for it.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_load_kernels() {
  cudaError_t err = prepare_fma<float, 2>();
  if (err == cudaSuccess) err = prepare_fma<float, 4>();
  if (err == cudaSuccess) err = prepare_fma<float, 8>();
  if (err == cudaSuccess) err = prepare_fma<float, 16>();
  for (const int hd : {32, 64, 128, 256})
    for (const int hdv : {32, 64, 128, 256})
      if (err == cudaSuccess)
        err = with_bf16_tiling(hd, hdv, [](auto tl) {
          return prepare_mma<decltype(tl)>();
        });
  return static_cast<int>(err);
}

// The tiling flash_attention_fwd runs for this dtype and these head dims
extern "C" const char* flash_attention_tiling(int dtype, int hd, int hdv) {
  if (dtype != 1) return "fp32 CUDA cores, 64 x 64 tiles";
  return with_bf16_tiling(hd, hdv, [](auto tl) {
    return tiling_name<decltype(tl)>();
  });
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
