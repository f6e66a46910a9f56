// IPA attention forward (K2), backward (K3) and sampling forward with the
// pair aggregation (K4) for Hopper (sm_90a).
//
// Replaces the TPU kernels of ab_opt_tpu/ops/ipa_pallas.py:
//   K2  _attention_fwd_call -> _fwd_kernel: per trajectory n and head h,
//       alpha = softmax(qa_h . ka_h^T + bias[n // reps, h]) (exact, f32),
//       out_h = alpha . vvp_h; exports alpha;
//   K3  _attention_bwd_call -> _bwd_kernel: the VJP of K2 from the saved
//       alpha: dal = dout . vvp^T + dalphas, dlog = alpha * (dal -
//       rowsum(dal * alpha)) (= dbias), dqa = dlog . ka, dka = dlog^T . qa,
//       dvvp = alpha^T . dout;
//   K4  _attention_fwd_p2n_call -> _fwd_p2n_kernel: K2's out plus
//       p2n[n, i, h, :] = sum_j alpha[h, i, j] z[n // reps, i, j, :], with
//       alpha never leaving the block (no alphas output).
// Layout (the JAX package's): qa, ka, vvp, out, dout, dqa, dka, dvvp are
// (N, L, H * 64), each head a 64-wide slot; bias is (N / reps, H, L, L)
// (trajectory n reads its complex's block n / reps); alphas, dalphas and
// dbias are (N, H, L, L); z is (N / reps, L, L, Cz), p2n (N, L, H, Cz). All
// in the input type T (float or bf16); every product accumulates in f32 and
// the softmax runs in f32.
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
// K4, at the sampler's shapes (N = 256 trajectories of one complex, L =
// 128, H = 12, Cz = 64, bf16), moves ~254 MB (qa, ka, vvp, out and p2n at
// 50 MB each; z 2 MB and bias 0.4 MB, shared by the replicas) and does
// ~19.3 GFLOP (logits, alpha . vvp and alpha . z at 6.4 each): bounded by
// bytes (~76 us) too. What it saves is the (N, H, L, L) alphas, ~100 MB
// written and read again per layer at that fan-out. The p2n operand differs
// for every query row (row i reads its own (L, Cz) slab of z), so a block
// owns a query tile of one trajectory for all heads, keeps every head's
// alpha for the tile in shared memory, and reads each z row once per
// trajectory and tile instead of once per head; the 2 MB z of a complex
// stays in the 50 MB L2 across its replicas. In bf16 up to L = 256 its
// three products run on the tensor cores (wmma 16x16x16, f32 accumulators),
// elsewhere on K2's CUDA-core f32 tiles. Sharing z across replicas (K1's
// M = reps H), wgmma and TMA are later work.
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
//   fwd_p2n_mma_kernel  bf16, L <= 256: per 16 query rows of one
//                   trajectory, all heads; every head's alpha for the tile
//                   (16 H x L bf16, 53 KB at L = 128) stays in shared memory
//                   beside the head's whole K and V; one launch, no alphas
//                   in device memory.
//   fwd_p2n_kernel  float32, or bf16 past L = 256: the same per TQ query
//                   rows (TQ = 32, 16, 8 or 4, the most that fits; alpha in
//                   T, H x TQ x L), products on the CUDA cores.
//
// L is a runtime value (the wrapper takes multiples of 16 up to 512; ragged
// tiles are masked here), H and N are grid dimensions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <math.h>

typedef __nv_bfloat16 bf16;
using namespace nvcuda;

namespace {

constexpr int SLOT = 64;       // per-head width of qa / ka / vvp
constexpr int NT = 256;        // threads per block
constexpr int TQ = 32;         // query rows per block (fwd, bwd pass 1)
constexpr int TK = 64;         // keys per staged tile (fwd, bwd pass 1)
constexpr int CK = 32;         // keys per block (bwd pass 2)
constexpr int CQ = 32;         // query rows per staged tile (bwd pass 2)
constexpr int TLD = SLOT + 1;  // smem row pitch of staged 64-wide tiles
constexpr int GLD = CK + 1;    // smem row pitch of (CQ x CK) tiles
constexpr int P2N_ROWS = 4;    // query rows per pass of K4's p2n phase
constexpr int P2N_QUADS = 4;   // column quads a thread owns there: H Cz <= 1024
// Shared memory of one block, and of one SM (sm_90: 227 KB and 228 KB; the
// runtime reserves 1 KB a block).
constexpr size_t SMEM_BLOCK = 232448, SMEM_SM = 233472, SMEM_RESERVED = 1024;
// K4's bf16 tensor-core variant: 16 query rows a block (one wmma row tile),
// staged 64-wide rows at a bf16 pitch of KLD (rows 16 apart stay 32-byte
// aligned), L up to P2N_MMA_MAX_L.
constexpr int WQ = 16;
constexpr int KLD = SLOT + 8;
constexpr int P2N_MMA_MAX_L = 256;

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

// The register tiles below split a ROWS x 64 tile over the NT threads:
// thread tid owns row tid / CG and the ROWS / 4 columns tid % CG + CG c,
// CG = NT / ROWS (ROWS = 32: 8 columns a thread, 4: one).
template <int ROWS> struct Tile {
  static constexpr int CG = NT / ROWS, PT = SLOT / CG;
  static_assert(NT % ROWS == 0 && SLOT % CG == 0 && TK == SLOT, "tile");
};

// acc[c] = A[i] . B[j0 + CG c] over the 64-wide slot: one ROWS x 64 tile of
// A B^T (A: ROWS rows, B: TK rows).
template <int ROWS>
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         float acc[Tile<ROWS>::PT]) {
  constexpr int CG = Tile<ROWS>::CG, PT = Tile<ROWS>::PT;
  const int i = threadIdx.x / CG, j0 = threadIdx.x % CG;
#pragma unroll
  for (int c = 0; c < PT; ++c) acc[c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < SLOT; ++d) {
    const float a = A[i * TLD + d];
#pragma unroll
    for (int c = 0; c < PT; ++c) acc[c] += a * B[(j0 + CG * c) * TLD + d];
  }
}

// o[c] += sum_j P[i, jb + j] * V[j, d0 + CG c] over the keys of one staged
// tile, i = tid / CG, d0 = tid % CG (P: row pitch pld; V: pitch TLD).
template <int ROWS>
__device__ __forceinline__ void tile_pv(const float* P, int pld, int jb,
                                        int jn, const float* V,
                                        float o[Tile<ROWS>::PT]) {
  constexpr int CG = Tile<ROWS>::CG, PT = Tile<ROWS>::PT;
  const int i = threadIdx.x / CG, d0 = threadIdx.x % CG;
  for (int j = 0; j < jn; ++j) {
    const float p = P[i * pld + jb + j];
#pragma unroll
    for (int c = 0; c < PT; ++c) o[c] += p * V[j * TLD + d0 + CG * c];
  }
}

template <int ROWS, typename T>
__device__ __forceinline__ void store_slot(T* __restrict__ dst,
                                           const float o[Tile<ROWS>::PT],
                                           int n, int h, int r0, int L, int HD) {
  constexpr int CG = Tile<ROWS>::CG, PT = Tile<ROWS>::PT;
  const int i = r0 + threadIdx.x / CG, d0 = threadIdx.x % CG;
  if (i >= L) return;
  T* row = dst + ((size_t)n * L + i) * HD + (size_t)h * SLOT;
#pragma unroll
  for (int c = 0; c < PT; ++c) row[d0 + CG * c] = from_f<T>(o[c]);
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
    tile_abt<TQ>(Qs, KV, acc);
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
    tile_pv<TQ>(S, SLD, j0, min(TK, L - j0), KV, o);
  }
  store_slot<TQ>(out, o, n, h, i0, L, HD);
}

// ---------------------------------------------------------------- K4
// One block owns TQ query rows of trajectory n for every head (the TPU grid
// (N, L / TI)), so each row's (L, Cz) slab of z is read once per trajectory
// and tile, not once per head. Shared memory:
//   Qs  TQ x TLD     f32  the head's query rows
//   KV  TK x TLD     f32  a staged key or value tile; in the p2n phase, z
//                         rows of 4 queries (P2N_ROWS x ZJ keys x Cz)
//   S   TQ x (L + 1) f32  the head's logits, then its alpha
//   A   H x TQ x L   T    every head's alpha, rounded to T, for p2n
// Per head: logits, exact softmax, alpha rounded once to T (into S as f32
// and into A), out = alpha . vvp. Then p2n[i, h, :] = sum_j A[h, i, j]
// z[n / reps, i, j, :], 4 query rows at a time, 64 threads a row; thread
// owns the column quads q = tid % 64 + 64 k (k < P2N_QUADS) of the row's
// H * Cz / 4, quad q = (head q / (Cz / 4), columns 4 (q % (Cz / 4)) + 0..3).
template <typename T, int TQ>
__global__ void __launch_bounds__(NT)
fwd_p2n_kernel(const T* __restrict__ qa, const T* __restrict__ ka,
               const T* __restrict__ vv, const T* __restrict__ bias,
               const T* __restrict__ z, T* __restrict__ out,
               T* __restrict__ p2n, int L, int H, int Cz, int reps) {
  extern __shared__ float sm[];
  constexpr int CG = Tile<TQ>::CG, PT = Tile<TQ>::PT;
  static_assert(TQ % P2N_ROWS == 0 && NT == P2N_ROWS * 64, "p2n rows");
  const int SLD = L + 1;
  float* Qs = sm;
  float* KV = Qs + TQ * TLD;
  float* S = KV + TK * TLD;
  T* A = reinterpret_cast<T*>(S + TQ * SLD);
  const int n = blockIdx.y, c = n / reps, i0 = blockIdx.x * TQ;
  const int HD = H * SLOT, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int h = 0; h < H; ++h) {
    __syncthreads();                 // the previous head is done with Qs, S
    stage_rows(Qs, qa, n, h, i0, TQ, L, HD);
    for (int j0 = 0; j0 < L; j0 += TK) {
      __syncthreads();
      stage_rows(KV, ka, n, h, j0, TK, L, HD);
      __syncthreads();
      float acc[PT];
      tile_abt<TQ>(Qs, KV, acc);
      const int i = tid / CG;
#pragma unroll
      for (int q = 0; q < PT; ++q) {
        const int j = j0 + tid % CG + CG * q;
        if (j < L) S[i * SLD + j] = acc[q];
      }
    }
    __syncthreads();

    // Exact softmax in f32, one warp a row; masked keys carry -1e5 in the
    // bias. alpha is rounded to T once and that value feeds both products.
    const T* bbase = bias + ((size_t)c * H + h) * L * L;
    for (int r = warp; r < TQ; r += NT / 32) {
      const int i = i0 + r;
      float* srow = S + r * SLD;
      T* arow = A + ((size_t)h * TQ + r) * L;
      if (i >= L) {
        for (int j = lane; j < L; j += 32) {
          srow[j] = 0.0f;
          arow[j] = from_f<T>(0.0f);
        }
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
      for (int j = lane; j < L; j += 32) {
        const T a = from_f<T>(srow[j] * inv);
        arow[j] = a;
        srow[j] = to_f(a);
      }
    }

    float o[PT];
#pragma unroll
    for (int q = 0; q < PT; ++q) o[q] = 0.0f;
    for (int j0 = 0; j0 < L; j0 += TK) {
      __syncthreads();
      stage_rows(KV, vv, n, h, j0, TK, L, HD);
      __syncthreads();
      tile_pv<TQ>(S, SLD, j0, min(TK, L - j0), KV, o);
    }
    store_slot<TQ>(out, o, n, h, i0, L, HD);
  }

  const int CQ = Cz / 4, NQ = H * CQ;
  const int ZJ = TK * TLD / (P2N_ROWS * Cz);      // keys per staged chunk
  const int rr = tid >> 6, ql = tid & 63;
  const float* zr = KV + rr * ZJ * Cz;
  for (int r0 = 0; r0 < TQ; r0 += P2N_ROWS) {
    float acc[P2N_QUADS][4];
#pragma unroll
    for (int k = 0; k < P2N_QUADS; ++k)
      acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
    const T* arow = A + (size_t)(r0 + rr) * L;
    for (int j0 = 0; j0 < L; j0 += ZJ) {
      const int jn = min(ZJ, L - j0), chunk = jn * Cz;
      __syncthreads();
      for (int idx = tid; idx < P2N_ROWS * chunk; idx += NT) {
        const int r = idx / chunk, e = idx - r * chunk, i = i0 + r0 + r;
        float v = 0.0f;
        if (i < L) v = to_f(z[(((size_t)c * L + i) * L + j0) * Cz + e]);
        KV[r * ZJ * Cz + e] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < P2N_QUADS; ++k) {
        const int q = ql + 64 * k;
        if (q >= NQ) continue;
        const int hq = q / CQ, c4 = (q - hq * CQ) * 4;
        const T* ah = arow + (size_t)hq * TQ * L + j0;
        for (int j = 0; j < jn; ++j) {
          const float a = to_f(ah[j]);
          const float4 zv = *reinterpret_cast<const float4*>(zr + j * Cz + c4);
          acc[k][0] += a * zv.x;
          acc[k][1] += a * zv.y;
          acc[k][2] += a * zv.z;
          acc[k][3] += a * zv.w;
        }
      }
    }
    const int i = i0 + r0 + rr;
    if (i >= L) continue;
#pragma unroll
    for (int k = 0; k < P2N_QUADS; ++k) {
      const int q = ql + 64 * k;
      if (q >= NQ) continue;
      const int hq = q / CQ, c4 = (q - hq * CQ) * 4;
      T* dst = p2n + (((size_t)n * L + i) * H + hq) * Cz + c4;
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = from_f<T>(acc[k][e]);
    }
  }
}

// K4 for bf16 on the tensor cores (wmma 16x16x16, f32 accumulators): the
// same function, one block = 16 query rows of trajectory n, all heads, 8
// warps. Shared memory (bytes 32-aligned at every wmma pointer):
//   Ks, Vs  L x KLD     bf16  the head's keys and values; in the p2n phase
//                             the z rows of two queries
//   Qs      16 x KLD    bf16  the head's query rows
//   S       16 x SLD    f32   the head's logits, then alpha . vvp; in the
//                             p2n phase two queries' (16 x Cz) products
//   A       ((WQ - 1) H + 16) x ALD bf16: alpha[h] of query row r at row
//                             r H + h (ALD = L + 16), so the 16 x 16 tile at
//                             row r H covers every head of query r (rows
//                             past its H heads belong to the next query or
//                             the tail; their products are not stored), and
//                             head h's (16 x L) alpha is rows h + H r.
// Per head: logits (warp w: key tiles w, w + 8, ...), exact softmax in f32
// (2 rows a warp), alpha rounded to bf16 once into A, out = alpha . vvp
// (warps 0-3, one 16-column tile each). Then p2n, two query rows at a time
// (warps 0-3 the first, 4-7 the second, one Cz/16-column tile each).
__host__ __device__ inline int p2n_mma_sld(int L) { return (L > 128 ? L : 128) + 4; }
__host__ __device__ inline int p2n_mma_ald(int L) { return L + 16; }

__global__ void __launch_bounds__(NT)
fwd_p2n_mma_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
                   const bf16* __restrict__ vv, const bf16* __restrict__ bias,
                   const bf16* __restrict__ z, bf16* __restrict__ out,
                   bf16* __restrict__ p2n, int L, int H, int Cz, int reps) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int SLD = p2n_mma_sld(L), ALD = p2n_mma_ald(L);
  bf16* Ks = reinterpret_cast<bf16*>(smraw);
  bf16* Vs = Ks + L * KLD;
  bf16* Qs = Vs + L * KLD;
  float* S = reinterpret_cast<float*>(Qs + WQ * KLD);
  bf16* A = reinterpret_cast<bf16*>(S + WQ * SLD);
  const int n = blockIdx.y, c = n / reps, i0 = blockIdx.x * WQ;
  const int HD = H * SLOT, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  for (int h = 0; h < H; ++h) {
    __syncthreads();                 // the previous head is done with every buffer
    for (int idx = tid; idx < L * 8; idx += NT) {
      const int j = idx >> 3, cc = (idx & 7) * 8;
      const size_t g = ((size_t)n * L + j) * HD + (size_t)h * SLOT + cc;
      *reinterpret_cast<uint4*>(&Ks[j * KLD + cc]) = *reinterpret_cast<const uint4*>(&ka[g]);
      *reinterpret_cast<uint4*>(&Vs[j * KLD + cc]) = *reinterpret_cast<const uint4*>(&vv[g]);
    }
    for (int idx = tid; idx < WQ * 8; idx += NT) {
      const int r = idx >> 3, cc = (idx & 7) * 8, i = i0 + r;
      uint4 v = zero4;
      if (i < L)
        v = *reinterpret_cast<const uint4*>(&qa[((size_t)n * L + i) * HD + (size_t)h * SLOT + cc]);
      *reinterpret_cast<uint4*>(&Qs[r * KLD + cc]) = v;
    }
    __syncthreads();

    for (int jt = warp; jt < L / 16; jt += NT / 32) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < SLOT / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(qf, Qs + kk * 16, KLD);
        wmma::load_matrix_sync(kf, Ks + jt * 16 * KLD + kk * 16, KLD);
        wmma::mma_sync(acc, qf, kf, acc);
      }
      wmma::store_matrix_sync(S + jt * 16, acc, SLD, wmma::mem_row_major);
    }
    __syncthreads();

    const bf16* bbase = bias + ((size_t)c * H + h) * L * L;
    for (int r = warp; r < WQ; r += NT / 32) {
      const int i = i0 + r;
      float* srow = S + r * SLD;
      bf16* arow = A + ((size_t)r * H + h) * ALD;
      if (i >= L) {
        for (int j = lane; j < L; j += 32) arow[j] = __float2bfloat16(0.0f);
        continue;
      }
      const bf16* brow = bbase + (size_t)i * L;
      float mx = -INFINITY;
      for (int j = lane; j < L; j += 32) {
        const float v = srow[j] + __bfloat162float(brow[j]);
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
      for (int j = lane; j < L; j += 32) arow[j] = __float2bfloat16(srow[j] * inv);
    }
    __syncthreads();

    if (warp < SLOT / 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kt = 0; kt < L / 16; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, A + (size_t)h * ALD + kt * 16, H * ALD);
        wmma::load_matrix_sync(vf, Vs + kt * 16 * KLD + warp * 16, KLD);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(S + warp * 16, acc, SLD, wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < WQ * SLOT; idx += NT) {
      const int r = idx / SLOT, d = idx % SLOT, i = i0 + r;
      if (i < L)
        out[((size_t)n * L + i) * HD + (size_t)h * SLOT + d] =
            __float2bfloat16(S[r * SLD + d]);
    }
  }

  const int cz8 = Cz / 8;
  for (int r0 = 0; r0 < WQ; r0 += 2) {
    __syncthreads();
    for (int idx = tid; idx < 2 * L * cz8; idx += NT) {
      const int q = idx / (L * cz8), rest = idx - q * (L * cz8);
      const int j = rest / cz8, cc = (rest % cz8) * 8, i = i0 + r0 + q;
      uint4 v = zero4;
      if (i < L)
        v = *reinterpret_cast<const uint4*>(&z[(((size_t)c * L + i) * L + j) * Cz + cc]);
      *reinterpret_cast<uint4*>(&(q ? Vs : Ks)[j * KLD + cc]) = v;
    }
    __syncthreads();
    const int q = warp >> 2, jc = warp & 3;
    if (jc < Cz / 16) {
      const bf16* zb = q ? Vs : Ks;
      const bf16* ab = A + (size_t)(r0 + q) * H * ALD;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kt = 0; kt < L / 16; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> zf;
        wmma::load_matrix_sync(af, ab + kt * 16, ALD);
        wmma::load_matrix_sync(zf, zb + kt * 16 * KLD + jc * 16, KLD);
        wmma::mma_sync(acc, af, zf, acc);
      }
      wmma::store_matrix_sync(S + q * SLOT + jc * 16, acc, SLD, wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < 2 * H * Cz; idx += NT) {
      const int q = idx / (H * Cz), rest = idx - q * (H * Cz);
      const int hh = rest / Cz, d = rest % Cz, i = i0 + r0 + q;
      if (i < L)
        p2n[(((size_t)n * L + i) * H + hh) * Cz + d] =
            __float2bfloat16(S[hh * SLD + q * SLOT + d]);
    }
  }
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
    tile_abt<TQ>(Ds, KV, acc);
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
    tile_pv<TQ>(S, SLD, j0, min(TK, L - j0), KV, o);
  }
  store_slot<TQ>(dqa, o, n, h, i0, L, HD);
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
  store_slot<CK>(dka, gk, n, h, j0, L, HD);
  store_slot<CK>(dvv, gv, n, h, j0, L, HD);
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

size_t p2n_smem(int tq, int L, int H, size_t tsize) {
  return ((size_t)(tq + TK) * TLD + (size_t)tq * (L + 1)) * sizeof(float)
         + (size_t)H * tq * L * tsize;
}

// K4's query rows a block: the most (32, 16, 8 or 4) with which two blocks
// fit on an SM, else the most with which one does; 0 if none fits.
int p2n_tile(int L, int H, size_t tsize) {
  const int rows[] = {32, 16, 8, 4};
  for (int blocks = 2; blocks >= 1; --blocks)
    for (int tq : rows) {
      const size_t smem = p2n_smem(tq, L, H, tsize);
      if (smem <= SMEM_BLOCK && blocks * (smem + SMEM_RESERVED) <= SMEM_SM)
        return tq;
    }
  return 0;
}

template <typename T, int TQ>
int launch_fwd_p2n_rows(const T* qa, const T* ka, const T* vv, const T* bias,
                        const T* z, T* out, T* p2n, int N, int L, int H,
                        int Cz, int reps, cudaStream_t stream) {
  const size_t smem = p2n_smem(TQ, L, H, sizeof(T));
  int err = set_smem(fwd_p2n_kernel<T, TQ>, smem);
  if (err) return err;
  fwd_p2n_kernel<T, TQ><<<dim3((L + TQ - 1) / TQ, N), NT, smem, stream>>>(
      qa, ka, vv, bias, z, out, p2n, L, H, Cz, reps);
  return (int)cudaGetLastError();
}

size_t p2n_mma_smem(int L, int H) {
  return (size_t)(2 * L + WQ) * KLD * sizeof(bf16)
         + (size_t)WQ * p2n_mma_sld(L) * sizeof(float)
         + (size_t)((WQ - 1) * H + 16) * p2n_mma_ald(L) * sizeof(bf16);
}

// Whether K4 takes the bf16 tensor-core variant at these shapes.
bool p2n_mma(int L, int H, int Cz, int dtype) {
  return dtype == 1 && L <= P2N_MMA_MAX_L && H <= 16 && Cz % 16 == 0
         && Cz <= SLOT && p2n_mma_smem(L, H) <= SMEM_BLOCK;
}

template <typename T>
int launch_fwd_p2n(const void* qa, const void* ka, const void* vv,
                   const void* bias, const void* z, void* out, void* p2n,
                   int N, int L, int H, int Cz, int reps, cudaStream_t stream) {
  if (Cz % 4 != 0 || Cz > TK * TLD / P2N_ROWS || H * Cz > 1024)
    return (int)cudaErrorInvalidValue;
  if (p2n_mma(L, H, Cz, sizeof(T) == sizeof(bf16))) {
    const size_t smem = p2n_mma_smem(L, H);
    int err = set_smem(fwd_p2n_mma_kernel, smem);
    if (err) return err;
    fwd_p2n_mma_kernel<<<dim3((L + WQ - 1) / WQ, N), NT, smem, stream>>>(
        static_cast<const bf16*>(qa), static_cast<const bf16*>(ka),
        static_cast<const bf16*>(vv), static_cast<const bf16*>(bias),
        static_cast<const bf16*>(z), static_cast<bf16*>(out),
        static_cast<bf16*>(p2n), L, H, Cz, reps);
    return (int)cudaGetLastError();
  }
  const auto args = [&](auto launch) {
    return launch(static_cast<const T*>(qa), static_cast<const T*>(ka),
                  static_cast<const T*>(vv), static_cast<const T*>(bias),
                  static_cast<const T*>(z), static_cast<T*>(out),
                  static_cast<T*>(p2n), N, L, H, Cz, reps, stream);
  };
  switch (p2n_tile(L, H, sizeof(T))) {
    case 32: return args(launch_fwd_p2n_rows<T, 32>);
    case 16: return args(launch_fwd_p2n_rows<T, 16>);
    case 8: return args(launch_fwd_p2n_rows<T, 8>);
    case 4: return args(launch_fwd_p2n_rows<T, 4>);
  }
  return (int)cudaErrorInvalidConfiguration;
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

// K4: z (N / reps, L, L, Cz) per complex; out (N, L, H * 64) and p2n
// (N, L, H, Cz) in the input type; no alphas output.
extern "C" int ipa_attention_fwd_p2n(const void* qa, const void* ka,
                                     const void* vv, const void* bias,
                                     const void* z, void* out, void* p2n,
                                     int N, int L, int H, int Cz, int reps,
                                     int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_p2n<float>(qa, ka, vv, bias, z, out, p2n, N, L, H, Cz,
                                 reps, s);
  if (dtype == 1)
    return launch_fwd_p2n<bf16>(qa, ka, vv, bias, z, out, p2n, N, L, H, Cz,
                                reps, s);
  return (int)cudaErrorInvalidValue;
}

// The query rows a K4 block takes at (L, H, Cz, dtype), 0 if no tile fits;
// negative when the block runs on the tensor cores.
extern "C" int ipa_attention_fwd_p2n_tile(int L, int H, int Cz, int dtype) {
  if (p2n_mma(L, H, Cz, dtype)) return -WQ;
  return p2n_tile(L, H, dtype == 0 ? sizeof(float) : sizeof(bf16));
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
