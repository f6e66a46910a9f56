// IPA attention forward (K2) and backward (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernels of ab_opt_tpu/ops/ipa_pallas.py:
//   K2  _attention_fwd_call -> _fwd_kernel: per trajectory n and head h,
//       alpha = softmax(qa_h . ka_h^T + bias[n // reps, h]) (exact, f32),
//       out_h = alpha . vvp_h; exports alpha;
//   K3  _attention_bwd_call -> _bwd_kernel: the VJP of K2 from the saved
//       alpha: dal = dout . vvp^T + dalphas, dlog = alpha * (dal -
//       rowsum(dal * alpha)) (= dbias), dqa = dlog . ka, dka = dlog^T . qa,
//       dvvp = alpha^T . dout.
// Layout (the JAX package's): qa, ka, vvp, out, dout, dqa, dka, dvvp are
// (N, L, H * 64), each head a 64-wide slot; bias is (N / reps, H, L, L)
// (trajectory n reads its complex's block n / reps); alphas, dalphas and
// dbias are (N, H, L, L). All in the input type T (float or bf16); every
// product accumulates in f32 and the softmax runs in f32.
//
// What bounds it on this card. At the training shapes (N = 16, L = 128,
// H = 12, bf16) K2 moves ~25 MB and does ~0.8 GFLOP, K3 ~41 MB and ~1.6
// GFLOP: far below the ~295 FLOP/byte where the H100's bf16 tensor cores
// become the limit, so both are bounded by device-memory bytes (~7.5 us and
// ~12 us at 3.35 TB/s). This first version computes on the CUDA cores in
// f32 (register-tiled products from shared memory, the same code for both
// types); tensor-core tiles, fusing the two backward passes and keeping
// alpha out of device memory are later work.
//
// Design. The TPU grid walks one trajectory at a time and holds whole L x L
// blocks in VMEM; here blocks run in parallel, so every pass is a grid over
// (row tile, head, trajectory) and nothing carries between blocks.
//   fwd_kernel      per 32 query rows: logits for the whole row in shared
//                   memory (<= 32 x 512 f32), max-subtract softmax, alpha
//                   (rounded to T, as the TPU kernel rounds before its value
//                   dot) written out, then alpha . vvp over 64-key tiles.
//   bwd_rows_kernel per 32 query rows: dal, the row sums r_i = sum_j dal
//                   alpha (written to an f32 scratch), dlog -> dbias, dqa.
//   bwd_cols_kernel per 32 keys: loops over 32-row query tiles, recomputes
//                   dal and dlog = dal alpha - alpha r_i in f32 from the same
//                   inputs and the row sums, and accumulates dka and dvvp.
// The second pass re-reads alphas, dalphas, dout and qa (and recomputes
// dout . vvp^T) instead of reading dbias back, so dka is built from f32 dlog
// exactly as the TPU kernel builds it, not from dlog rounded to bf16. Two
// launches per backward call, no atomics.
//
// L is a runtime value (the wrapper takes multiples of 16 up to 512; ragged
// tiles are masked here), H and N are grid dimensions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int SLOT = 64;       // per-head width of qa / ka / vvp
constexpr int NT = 256;        // threads per block
constexpr int TQ = 32;         // query rows per block (fwd, bwd pass 1)
constexpr int TK = 64;         // keys per staged tile (fwd, bwd pass 1)
constexpr int CK = 32;         // keys per block (bwd pass 2)
constexpr int CQ = 32;         // query rows per staged tile (bwd pass 2)
constexpr int TLD = SLOT + 1;  // smem row pitch of staged 64-wide tiles
constexpr int GLD = CK + 1;    // smem row pitch of (CQ x CK) tiles

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rows x 64 slot of head h, rows r0.. of trajectory n, from an
// (N, L, H * 64) tensor into f32 shared memory (pitch TLD); rows past L are
// zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           int n, int h, int r0, int rows,
                                           int L, int HD) {
  for (int idx = threadIdx.x; idx < rows * SLOT; idx += NT) {
    const int r = idx / SLOT, d = idx % SLOT, j = r0 + r;
    float v = 0.0f;
    if (j < L) v = to_f(src[((size_t)n * L + j) * HD + (size_t)h * SLOT + d]);
    dst[r * TLD + d] = v;
  }
}

// acc[c] = A[i] . B[j0 + 8c] over the 64-wide slot, i = tid / 8,
// j0 = tid % 8: one 32 x 64 tile of A B^T (A: TQ rows, B: TK rows).
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         float acc[8]) {
  const int i = threadIdx.x >> 3, j0 = threadIdx.x & 7;
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < SLOT; ++d) {
    const float a = A[i * TLD + d];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] += a * B[(j0 + 8 * c) * TLD + d];
  }
}

// o[c] += sum_j P[i, jb + j] * V[j, d0 + 8c] over the keys of one staged
// tile, i = tid / 8, d0 = tid % 8 (P: row pitch pld; V: pitch TLD).
__device__ __forceinline__ void tile_pv(const float* P, int pld, int jb,
                                        int jn, const float* V, float o[8]) {
  const int i = threadIdx.x >> 3, d0 = threadIdx.x & 7;
  for (int j = 0; j < jn; ++j) {
    const float p = P[i * pld + jb + j];
#pragma unroll
    for (int c = 0; c < 8; ++c) o[c] += p * V[j * TLD + d0 + 8 * c];
  }
}

template <typename T>
__device__ __forceinline__ void store_slot(T* __restrict__ dst, const float o[8],
                                           int n, int h, int r0, int L, int HD) {
  const int i = r0 + (threadIdx.x >> 3), d0 = threadIdx.x & 7;
  if (i >= L) return;
  T* row = dst + ((size_t)n * L + i) * HD + (size_t)h * SLOT;
#pragma unroll
  for (int c = 0; c < 8; ++c) row[d0 + 8 * c] = from_f<T>(o[c]);
}

// ---------------------------------------------------------------- K2
template <typename T>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ qa, const T* __restrict__ ka,
           const T* __restrict__ vv, const T* __restrict__ bias,
           T* __restrict__ out, T* __restrict__ alphas, int L, int H,
           int reps) {
  extern __shared__ float sm[];
  const int SLD = L + 1;
  float* Qs = sm;                  // TQ x TLD
  float* KV = Qs + TQ * TLD;       // TK x TLD
  float* S = KV + TK * TLD;        // TQ x SLD: logits, then alpha
  const int n = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TQ;
  const int HD = H * SLOT, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  stage_rows(Qs, qa, n, h, i0, TQ, L, HD);
  for (int j0 = 0; j0 < L; j0 += TK) {
    __syncthreads();
    stage_rows(KV, ka, n, h, j0, TK, L, HD);
    __syncthreads();
    float acc[8];
    tile_abt(Qs, KV, acc);
    const int i = tid >> 3;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + (tid & 7) + 8 * c;
      if (j < L) S[i * SLD + j] = acc[c];
    }
  }
  __syncthreads();

  // Exact softmax over the whole row in f32; masked keys carry -1e5 in the
  // bias. One warp per row.
  const T* bbase = bias + ((size_t)(n / reps) * H + h) * L * L;
  for (int r = warp; r < TQ; r += NT / 32) {
    const int i = i0 + r;
    float* srow = S + r * SLD;
    if (i >= L) {
      for (int j = lane; j < L; j += 32) srow[j] = 0.0f;
      continue;
    }
    const T* brow = bbase + (size_t)i * L;
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const float v = srow[j] + to_f(brow[j]);
      srow[j] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float s = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      s += e;
    }
    const float inv = 1.0f / warp_sum(s);
    T* arow = alphas + (((size_t)n * H + h) * L + i) * L;
    for (int j = lane; j < L; j += 32) {
      const T a = from_f<T>(srow[j] * inv);
      arow[j] = a;
      srow[j] = to_f(a);
    }
  }

  float o[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j0 = 0; j0 < L; j0 += TK) {
    __syncthreads();
    stage_rows(KV, vv, n, h, j0, TK, L, HD);
    __syncthreads();
    tile_pv(S, SLD, j0, min(TK, L - j0), KV, o);
  }
  store_slot(out, o, n, h, i0, L, HD);
}

// ------------------------------------------------------- K3, pass 1
template <typename T>
__global__ void __launch_bounds__(NT)
bwd_rows_kernel(const T* __restrict__ ka, const T* __restrict__ vv,
                const T* __restrict__ alphas, const T* __restrict__ dout,
                const T* __restrict__ dalphas, T* __restrict__ dqa,
                T* __restrict__ dbias, float* __restrict__ rowsum, int L,
                int H) {
  extern __shared__ float sm[];
  const int SLD = L + 1;
  float* Ds = sm;                  // TQ x TLD: dout rows
  float* KV = Ds + TQ * TLD;       // TK x TLD
  float* S = KV + TK * TLD;        // TQ x SLD: dout . vvp^T, then dlog
  const int n = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * TQ;
  const int HD = H * SLOT, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  stage_rows(Ds, dout, n, h, i0, TQ, L, HD);
  for (int j0 = 0; j0 < L; j0 += TK) {
    __syncthreads();
    stage_rows(KV, vv, n, h, j0, TK, L, HD);
    __syncthreads();
    float acc[8];
    tile_abt(Ds, KV, acc);
    const int i = tid >> 3;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + (tid & 7) + 8 * c;
      if (j < L) S[i * SLD + j] = acc[c];
    }
  }
  __syncthreads();

  // dal = S + dalphas; tmp = dal * alpha; dlog = tmp - alpha * sum_j tmp.
  for (int r = warp; r < TQ; r += NT / 32) {
    const int i = i0 + r;
    float* srow = S + r * SLD;
    if (i >= L) {
      for (int j = lane; j < L; j += 32) srow[j] = 0.0f;
      continue;
    }
    const size_t rb = (((size_t)n * H + h) * L + i) * L;
    float s = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float tmp = (srow[j] + to_f(dalphas[rb + j])) * to_f(alphas[rb + j]);
      srow[j] = tmp;
      s += tmp;
    }
    s = warp_sum(s);
    for (int j = lane; j < L; j += 32) {
      const float g = srow[j] - to_f(alphas[rb + j]) * s;
      srow[j] = g;
      dbias[rb + j] = from_f<T>(g);
    }
    if (lane == 0) rowsum[((size_t)n * H + h) * L + i] = s;
  }

  float o[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j0 = 0; j0 < L; j0 += TK) {
    __syncthreads();
    stage_rows(KV, ka, n, h, j0, TK, L, HD);
    __syncthreads();
    tile_pv(S, SLD, j0, min(TK, L - j0), KV, o);
  }
  store_slot(dqa, o, n, h, i0, L, HD);
}

// ------------------------------------------------------- K3, pass 2
template <typename T>
__global__ void __launch_bounds__(NT)
bwd_cols_kernel(const T* __restrict__ qa, const T* __restrict__ vv,
                const T* __restrict__ alphas, const T* __restrict__ dout,
                const T* __restrict__ dalphas, const float* __restrict__ rowsum,
                T* __restrict__ dka, T* __restrict__ dvv, int L, int H) {
  extern __shared__ float sm[];
  float* Vs = sm;                  // CK x TLD: vvp rows of this key tile
  float* Qs = Vs + CK * TLD;       // CQ x TLD: qa rows
  float* Ds = Qs + CQ * TLD;       // CQ x TLD: dout rows
  float* A = Ds + CQ * TLD;        // CQ x GLD: alpha
  float* G = A + CQ * GLD;         // CQ x GLD: dalphas, then dlog
  const int n = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * CK;
  const int HD = H * SLOT, tid = threadIdx.x;
  const size_t hb = ((size_t)n * H + h) * L;

  stage_rows(Vs, vv, n, h, j0, CK, L, HD);
  float gk[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float gv[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int q0 = 0; q0 < L; q0 += CQ) {
    __syncthreads();
    stage_rows(Qs, qa, n, h, q0, CQ, L, HD);
    stage_rows(Ds, dout, n, h, q0, CQ, L, HD);
    for (int idx = tid; idx < CQ * CK; idx += NT) {
      const int i = idx / CK, j = idx % CK;
      float a = 0.0f, da = 0.0f;
      if (q0 + i < L && j0 + j < L) {
        const size_t e = (hb + q0 + i) * L + j0 + j;
        a = to_f(alphas[e]);
        da = to_f(dalphas[e]);
      }
      A[i * GLD + j] = a;
      G[i * GLD + j] = da;
    }
    __syncthreads();

    // dlog[i, j] for this (CQ x CK) tile: 4 entries per thread.
    {
      const int i = tid >> 3, jb = tid & 7;
      const float r = (q0 + i < L) ? rowsum[hb + q0 + i] : 0.0f;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int d = 0; d < SLOT; ++d) {
        const float x = Ds[i * TLD + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += x * Vs[(jb + 8 * c) * TLD + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jb + 8 * c;
        const float a = A[i * GLD + j];
        G[i * GLD + j] = (acc[c] + G[i * GLD + j]) * a - a * r;
      }
    }
    __syncthreads();

    // dka[j] += sum_i dlog[i, j] qa[i]; dvvp[j] += sum_i alpha[i, j] dout[i].
    {
      const int j = tid >> 3, d0 = tid & 7;
      for (int i = 0; i < CQ; ++i) {
        const float g = G[i * GLD + j], a = A[i * GLD + j];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          gk[c] += g * Qs[i * TLD + d0 + 8 * c];
          gv[c] += a * Ds[i * TLD + d0 + 8 * c];
        }
      }
    }
  }
  store_slot(dka, gk, n, h, j0, L, HD);
  store_slot(dvv, gv, n, h, j0, L, HD);
}

// ------------------------------------------------------------- host side

size_t rows_smem(int L) {
  return ((size_t)(TQ + TK) * TLD + (size_t)TQ * (L + 1)) * sizeof(float);
}

size_t cols_smem() {
  return ((size_t)(CK + 2 * CQ) * TLD + (size_t)2 * CQ * GLD) * sizeof(float);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* qa, const void* ka, const void* vv,
               const void* bias, void* out, void* alphas, int N, int L, int H,
               int reps, cudaStream_t stream) {
  const size_t smem = rows_smem(L);
  int err = set_smem(fwd_kernel<T>, smem);
  if (err) return err;
  fwd_kernel<T><<<dim3((L + TQ - 1) / TQ, H, N), NT, smem, stream>>>(
      static_cast<const T*>(qa), static_cast<const T*>(ka),
      static_cast<const T*>(vv), static_cast<const T*>(bias),
      static_cast<T*>(out), static_cast<T*>(alphas), L, H, reps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* qa, const void* ka, const void* vv,
               const void* alphas, const void* dout, const void* dalphas,
               void* dqa, void* dka, void* dvv, void* dbias, float* rowsum,
               int N, int L, int H, cudaStream_t stream) {
  const size_t smem1 = rows_smem(L), smem2 = cols_smem();
  int err = set_smem(bwd_rows_kernel<T>, smem1);
  if (err) return err;
  bwd_rows_kernel<T><<<dim3((L + TQ - 1) / TQ, H, N), NT, smem1, stream>>>(
      static_cast<const T*>(ka), static_cast<const T*>(vv),
      static_cast<const T*>(alphas), static_cast<const T*>(dout),
      static_cast<const T*>(dalphas), static_cast<T*>(dqa),
      static_cast<T*>(dbias), rowsum, L, H);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = set_smem(bwd_cols_kernel<T>, smem2);
  if (err) return err;
  bwd_cols_kernel<T><<<dim3((L + CK - 1) / CK, H, N), NT, smem2, stream>>>(
      static_cast<const T*>(qa), static_cast<const T*>(vv),
      static_cast<const T*>(alphas), static_cast<const T*>(dout),
      static_cast<const T*>(dalphas), rowsum, static_cast<T*>(dka),
      static_cast<T*>(dvv), L, H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry point launches on `stream`
// and returns the first non-zero cudaGetLastError() (0 when every launch was
// accepted); it does not synchronise.
extern "C" int ipa_attention_fwd(const void* qa, const void* ka,
                                 const void* vv, const void* bias, void* out,
                                 void* alphas, int N, int L, int H, int reps,
                                 int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(qa, ka, vv, bias, out, alphas, N, L, H, reps, s);
  if (dtype == 1)
    return launch_fwd<bf16>(qa, ka, vv, bias, out, alphas, N, L, H, reps, s);
  return (int)cudaErrorInvalidValue;
}

// rowsum: (N, H, L) float32 scratch written by the first pass.
extern "C" int ipa_attention_bwd(const void* qa, const void* ka,
                                 const void* vv, const void* alphas,
                                 const void* dout, const void* dalphas,
                                 void* dqa, void* dka, void* dvv, void* dbias,
                                 float* rowsum, int N, int L, int H, int dtype,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(qa, ka, vv, alphas, dout, dalphas, dqa, dka, dvv,
                             dbias, rowsum, N, L, H, s);
  if (dtype == 1)
    return launch_bwd<bf16>(qa, ka, vv, alphas, dout, dalphas, dqa, dka, dvv,
                            dbias, rowsum, N, L, H, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ipa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
