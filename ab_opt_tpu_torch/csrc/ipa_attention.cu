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
// ~12 us at 3.35 TB/s). Two routes, named by the wrapper's attention_plan
// (ops/ipa_attention.py) and by ipa_attention_plan below:
//   tile        bf16, L up to 256 (the training path): K2 is K1's
//               replica-group attention tile with alpha in K2's layout (S1
//               v1's kernel; see "K2, tiles"), K3 one launch of a thread-
//               block cluster on mma.sync (see "K3, tiles");
//   cuda_cores  float32, and bf16 past L = 256: the f32 CUDA-core tiles
//               below (fwd_kernel; bwd_rows_kernel + bwd_cols_kernel).
//
// K4, at the sampler's shapes (N = 256 trajectories of one complex, L =
// 128, H = 12, Cz = 64, bf16), moves ~254 MB (qa, ka, vvp, out and p2n at
// 50 MB each; z 2 MB and bias 0.4 MB, shared by the replicas) and does
// ~19.3 GFLOP (logits, alpha . vvp and alpha . z at 6.4 each): bounded by
// bytes (~76 us) too. The p2n operand differs for every query row (row i
// reads its own (L, Cz) slab z[c, i]) and is shared by the reps * H
// (replica, head) alpha rows of that row: K1's M = reps H. In bf16 up to
// L = 256 (Cz = 64, H a multiple of 4) K4 runs on K1's replica-group
// attention tile (csrc/k1_tiles.cuh; see "K4, tiles" below); float32, bf16
// past L = 256 and bf16 with another Cz or H take K2's CUDA-core f32 tiles
// (fwd_p2n_kernel).
//
// Design of the CUDA-core route. The TPU grid walks one trajectory at a time
// and holds whole L x L blocks in VMEM; here blocks run in parallel, so
// every pass is a grid over (row tile, head, trajectory) and nothing carries
// between blocks.
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
//   fwd_p2n_kernel  float32, or bf16 past L = 256: K4 per TQ query rows of
//                   one trajectory, all heads (TQ = 32, 16, 8 or 4, the most
//                   that fits; alpha in T, H x TQ x L, in shared memory),
//                   products on the CUDA cores.
//
// L is a runtime value (the wrapper takes multiples of 16 up to 512; ragged
// tiles are masked here), H and N are grid dimensions.

#include <cooperative_groups.h>

#include "k1_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
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

// ------------------------------------------------------------ K4, tiles
// bf16, L a multiple of 16 up to 256, Cz = CZ: K1's replica-group attention
// tile (csrc/k1_tiles.cuh) with the replicas of a complex sharing z[c, i],
// as two launches:
//   k4_attn_kernel  k1_attn_tile (AttnLean up to L = 128, two blocks an SM;
//                   AttnLarge past it) with alpha in K1's (Nc, L, reps*H, L)
//                   layout into a workspace the wrapper keeps per shape; o
//                   is K1's attention launch's, bit for bit;
//   k4_p2n_kernel   p2n_stage / p2n_mma (K5's p2n) over M = reps*H alpha
//                   rows sharing each z[c, i]: a block per (128 alpha rows,
//                   4 query rows, complex), two stages where two blocks fit
//                   an SM; p2n is K1's p2n launch's, bit for bit.
// Alpha goes through device memory (100 MB each way at N = 256, L = 128):
// the bytes a block would have to stream instead, to keep it on the chip,
// cost more. The fused tile that kept a (64 query rows x 2 heads x 4
// replicas) block's alpha rows in shared memory read z[c, i] once per
// block, 1.13 GB from L2 a call, and took 0.5364 ms against this
// composition's 0.2640 on an H100 80GB HBM3 at 700 W (chip_smoke.py phase
// 7; PERF.md).

// The attention: block = (query tile, head h, replicas blockIdx.z * rt ..
// + rt - 1), as K1's attention launch.
template <class Plan>
__global__ void __launch_bounds__(Plan::QW * 32, 1)
k4_attn_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
               const bf16* __restrict__ vv, const bf16* __restrict__ bias,
               bf16* __restrict__ o, bf16* __restrict__ alpha, int L, int H, int reps,
               int rt) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int h = blockIdx.y, n0 = blockIdx.z * rt;
  k1_attn_tile<Plan, ALPHA_K1>(blockIdx.x * Plan::QT, h, n0, rt, qa, ka, vv,
                               bias + ((size_t)(n0 / reps) * H + h) * L * L, o, alpha, L, H,
                               reps, smraw);
}

// The p2n: block = (P2N_M alpha rows from blockIdx.x * P2N_M, query rows
// blockIdx.y * rows .., complex blockIdx.z), the rows through a ring of ns
// p2n_stage stages; p2n (N, L, H, CZ) is the feature rows at pitch H CZ.
__global__ void __launch_bounds__(P2N_NT, 1)
k4_p2n_kernel(const bf16* __restrict__ alpha, const bf16* __restrict__ z,
              bf16* __restrict__ p2n, int L, int H, int reps, int rows, int ns) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int m0 = blockIdx.x * P2N_M, i0 = blockIdx.y * rows, c = blockIdx.z;
  const int i1 = min(L, i0 + rows);
  const size_t sb = p2n_stage_bytes(L);
  auto Zs = [&](int st) { return reinterpret_cast<bf16*>(smraw + st * sb); };
  auto stage = [&](int i, int st) {
    p2n_stage(m0, i, c, alpha, z, Zs(st), Zs(st) + L * KLD, L, H, reps);
    cp_async_commit();
  };
  for (int k = 0; k < ns - 1; ++k) {
    if (i0 + k < i1) stage(i0 + k, k);
    else cp_async_commit();
  }
  for (int i = i0; i < i1; ++i) {
    const int st = (i - i0) % ns;
    if (i + ns - 1 < i1) stage(i + ns - 1, (st + ns - 1) % ns);
    else cp_async_commit();
    cp_async_wait_n(ns - 1);
    __syncthreads();
    p2n_mma(m0, i, c, Zs(st), Zs(st) + L * KLD, p2n, H * CZ, L, H, reps);
    __syncthreads();
  }
}

// ------------------------------------------------------------ K2, tiles
// bf16, L a multiple of 16 up to 256: K1's replica-group attention tile
// with alpha in K2's (N, H, L, L) layout, a block per (query tile, head, rt
// replicas of one complex), 64 query rows and four warps a block: up to
// L = 128 one stage (AttnLean64: 63,488 bytes at L = 128, three blocks an
// SM, 384 blocks at the training shape N = 16, H = 12), past it AttnLarge's
// two, as S1 runs it. At the training shape this tile took 0.0128 ms against
// 0.0132 for AttnLean's 128 rows (192 blocks, two an SM) on an H100 80GB
// HBM3 at 700 W (chip_smoke.py phase 4).
// A plan changes how many warps and stages a block has, never a warp's sums,
// so out and alphas are S1 v1's bit for bit.
using AttnLean64 = AttnPlan<128, 4, 1>;
constexpr int K2_ROWS = 64;                 // query rows a K2 tile block

template <class Plan>
__global__ void __launch_bounds__(Plan::QW * 32, 1)
k2_tile_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
               const bf16* __restrict__ vv, const bf16* __restrict__ bias,
               bf16* __restrict__ out, bf16* __restrict__ alphas, int L, int H, int reps,
               int rt) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int h = blockIdx.y, n0 = blockIdx.z * rt;
  k1_attn_tile<Plan, ALPHA_K2>(blockIdx.x * Plan::QT, h, n0, rt, qa, ka, vv,
                               bias + ((size_t)(n0 / reps) * H + h) * L * L, out, alphas, L,
                               H, reps, smraw);
}

// ------------------------------------------------------------ K3, tiles
// bf16, L a multiple of 16 up to 256: the whole backward in one launch. A
// thread-block cluster per (trajectory n, head h) of C = ceil(L / 64)
// blocks (grid (C, H, N)); block r owns query rows 64 r .. 64 r + 63 in
// phase 1 and key rows 64 r .. in phase 2; four warps of 16 rows each.
//   phase 1  dal = dout . vvp^T (mma.sync from the block's dout rows and
//            all of vvp), + dalphas, tmp = dal alpha, r_i = sum_j tmp by
//            quad shuffles, dlog = tmp - alpha r_i in f32 registers (the
//            TPU kernel's order); dbias = bf16(dlog) out; dqa = dlog . ka.
//            dlog enters the tensor cores as hi = bf16(dlog) plus lo =
//            bf16(dlog - hi), two mma.sync into one f32 sum: dlog's rows sum
//            to zero, so its products cancel, and dlog rounded to bf16 alone
//            misses the bf16 gate for dqa and dka (tests/test_torch_k3.py
//            pins this). hi, lo and alpha go into shared memory transposed
//            ([key j][query i], by stmatrix.trans), for phase 2.
//   phase 2  after cluster.sync(): dka = dlog^T . qa (hi and lo) and dvvp =
//            alpha^T . dout for the block's 64 key rows, the A fragments read
//            straight from every peer's transposed tiles through distributed
//            shared memory (32-bit loads: a row of a transposed tile is a
//            fragment row), qa and dout rows from the block's own copy.
//   A final cluster.sync() keeps each block's shared memory alive until no
//   peer reads it. No atomics: every output element has one writer and a
//   fixed order of sums, so two launches are bitwise equal.
// Shared memory (bf16, L rows of KLD each): R holds vvp, then qa (its copy
// starts once dal is taken and lands during the rest of phase 1); K ka, then
// each warp's 16-row staging tile for the 16-byte stores of dbias, dqa, dka
// and dvvp; D dout; Th, Tl, Ta (L key rows x 64 query columns) dlog hi, lo
// and alpha transposed. 110,592 bytes at L = 128 (two blocks an SM),
// 221,184 at L = 256.
constexpr int K3_ROWS = 64;                 // query / key rows a block
constexpr int K3_NT = K3_ROWS / 16 * 32;    // 128 threads, a warp per 16 rows

__host__ __device__ constexpr size_t k3_smem(int L) {
  return (size_t)6 * L * KLD * sizeof(bf16);
}
static_assert(k3_smem(256) <= SMEM_BLOCK, "K3's tile exceeds sm_90 at L=256");
static_assert(2 * (k3_smem(128) + SMEM_RESERVED) <= SMEM_SM, "two K3 tiles must share an SM");

__device__ __forceinline__ void stsm_x4_t(void* p, uint32_t r0, uint32_t r1, uint32_t r2,
                                          uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(smem_u32(p)), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// (a, b) -> hi = bf16x2(a, b), lo = bf16x2(a - hi, b - hi).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(hv);
  const __nv_bfloat162 lv = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&hv);
  lo = *reinterpret_cast<const uint32_t*>(&lv);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// A warp's 16 x 64 f32 accumulators (mma C fragments) rounded to bf16,
// through its staging tile Sw into 16 rows (pitch ld) at dst: 16-byte
// stores. A warp's 16 rows are all valid or it has none (L % 16 == 0).
__device__ __forceinline__ void store_frag_rows(float (&acc)[SLOT / 8][4], bf16* Sw,
                                                bf16* __restrict__ dst, size_t ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < SLOT / 8; ++j) {
    st_shared_u32(Sw + g * KLD + j * 8 + 2 * t, pack2(acc[j][0], acc[j][1]));
    st_shared_u32(Sw + (g + 8) * KLD + j * 8 + 2 * t, pack2(acc[j][2], acc[j][3]));
  }
  __syncwarp();
#pragma unroll
  for (int u = lane; u < 128; u += 32) {
    const int r = u >> 3, q = u & 7;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + q * 8) = ld_shared_v4(Sw + r * KLD + q * 8);
  }
}

template <int KMAX>
__global__ void __launch_bounds__(K3_NT, 1)
k3_tile_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
               const bf16* __restrict__ vv, const bf16* __restrict__ alphas,
               const bf16* __restrict__ dout, const bf16* __restrict__ dalphas,
               bf16* __restrict__ dqa, bf16* __restrict__ dka, bf16* __restrict__ dvv,
               bf16* __restrict__ dbias, int L, int H) {
  extern __shared__ __align__(128) unsigned char smraw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int h = blockIdx.y, n = blockIdx.z, HD = H * SLOT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  bf16* R = reinterpret_cast<bf16*>(smraw);
  bf16* K = R + L * KLD;
  bf16* D = K + L * KLD;
  bf16* Th = D + L * KLD;
  bf16* Tl = Th + L * KLD;
  bf16* Ta = Tl + L * KLD;
  bf16* Sw = K + warp * 16 * KLD;    // staging, once every warp is done with ka
  const size_t nb = (size_t)n * L, hb = ((size_t)n * H + h) * L;
  const int nt = L >> 3;
  const int i_first = rank * K3_ROWS + warp * 16;   // phase 1: query rows; phase 2: key rows
  const bool rows_ok = i_first < L;                  // L % 16 == 0: all 16 rows or none

  // All L rows of head h's 64-wide slot of an (N, L, H * 64) operand.
  auto stage_rows = [&](bf16* dst, const bf16* src) {
    for (int idx = tid; idx < L * 8; idx += K3_NT) {
      const int row = idx >> 3, cc = (idx & 7) * 8;
      cp_async16(dst + row * KLD + cc, src + (nb + row) * HD + h * SLOT + cc, true);
    }
    cp_async_commit();
  };
  stage_rows(R, vv);
  stage_rows(D, dout);
  stage_rows(K, ka);

  // alpha and dalphas of the warp's rows in C-fragment order (rows g, g + 8,
  // columns 8 jt + 2t, + 1). Up to L = 128 both are loaded while the copies
  // land; past it (twice the registers) alpha after dal and dalphas pair by
  // pair as it is used, or the kernel spills.
  constexpr bool kEarly = KMAX <= 128;
  const size_t e0 = (hb + i_first + g) * L + 2 * t, e1 = e0 + (size_t)8 * L;
  uint32_t ap[KMAX / 8][2], dp[KMAX / 8][2];
  auto ld_pairs = [&](const bf16* src, uint32_t (&dst)[KMAX / 8][2]) {
#pragma unroll
    for (int jt = 0; jt < KMAX / 8; ++jt) {
      if (jt < nt) {
        dst[jt][0] = __ldg(reinterpret_cast<const unsigned int*>(src + e0 + jt * 8));
        dst[jt][1] = __ldg(reinterpret_cast<const unsigned int*>(src + e1 + jt * 8));
      }
    }
  };
  if constexpr (kEarly) {
    if (rows_ok) {
      ld_pairs(alphas, ap);
      ld_pairs(dalphas, dp);
    }
  }
  cp_async_wait<1>();              // vvp and dout (ka may still land)
  __syncthreads();

  // dal = dout . vvp^T in C fragments: s[jt] holds rows g, g + 8 and the key
  // columns 8 jt + 2t, + 1 (as K1's logits).
  float s[KMAX / 8][4];
#pragma unroll
  for (int jt = 0; jt < KMAX / 8; ++jt) s[jt][0] = s[jt][1] = s[jt][2] = s[jt][3] = 0.0f;
  if (rows_ok) {
    uint32_t df[SLOT / 16][4];
#pragma unroll
    for (int kk = 0; kk < SLOT / 16; ++kk)
      ldsm_x4(df[kk], D + (i_first + (lane & 15)) * KLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jt = 0; jt < KMAX / 8; ++jt) {
      if (jt < nt) {
        const bf16* vr = R + (jt * 8 + (lane & 7)) * KLD + (lane >> 3) * 8;
        uint32_t v0[4], v1[4];
        ldsm_x4(v0, vr);
        ldsm_x4(v1, vr + 32);
        mma_bf16(s[jt], df[0], v0[0], v0[1]);
        mma_bf16(s[jt], df[1], v0[2], v0[3]);
        mma_bf16(s[jt], df[2], v1[0], v1[1]);
        mma_bf16(s[jt], df[3], v1[2], v1[3]);
      }
    }
  }
  __syncthreads();                 // every warp is done with vvp: R takes qa
  stage_rows(R, qa);

  if (rows_ok) {
    if constexpr (!kEarly) ld_pairs(alphas, ap);
    // + dalphas, tmp = dal alpha, row sums, dlog = tmp - alpha r (f32).
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int jt = 0; jt < KMAX / 8; ++jt) {
      if (jt < nt) {
        if constexpr (!kEarly) {
          dp[jt][0] = __ldg(reinterpret_cast<const unsigned int*>(dalphas + e0 + jt * 8));
          dp[jt][1] = __ldg(reinterpret_cast<const unsigned int*>(dalphas + e1 + jt * 8));
        }
        const float2 d0 = unpack2(dp[jt][0]), d1 = unpack2(dp[jt][1]);
        const float2 a0 = unpack2(ap[jt][0]), a1 = unpack2(ap[jt][1]);
        s[jt][0] = (s[jt][0] + d0.x) * a0.x;
        s[jt][1] = (s[jt][1] + d0.y) * a0.y;
        s[jt][2] = (s[jt][2] + d1.x) * a1.x;
        s[jt][3] = (s[jt][3] + d1.y) * a1.y;
        r0 += s[jt][0] + s[jt][1];
        r1 += s[jt][2] + s[jt][3];
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      r0 += __shfl_xor_sync(0xffffffffu, r0, o);
      r1 += __shfl_xor_sync(0xffffffffu, r1, o);
    }
#pragma unroll
    for (int jt = 0; jt < KMAX / 8; ++jt) {
      if (jt < nt) {
        const float2 a0 = unpack2(ap[jt][0]), a1 = unpack2(ap[jt][1]);
        s[jt][0] -= a0.x * r0;
        s[jt][1] -= a0.y * r0;
        s[jt][2] -= a1.x * r1;
        s[jt][3] -= a1.y * r1;
      }
    }

    // hi, lo and alpha transposed into Th, Tl, Ta: the 16 x 16 block (this
    // warp's rows, keys 16 kk ..) lands at rows 16 kk .., columns 16 warp ..
    const int tr = (lane & 7) + ((lane >> 4) & 1) * 8, tc = warp * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KMAX / 16; ++kk) {
      if (2 * kk < nt) {
        uint32_t hi[4], lo[4];
        split2(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split2(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split2(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split2(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
        const int off = (kk * 16 + tr) * KLD + tc;
        stsm_x4_t(Th + off, hi[0], hi[1], hi[2], hi[3]);
        stsm_x4_t(Tl + off, lo[0], lo[1], lo[2], lo[3]);
        stsm_x4_t(Ta + off, ap[2 * kk][0], ap[2 * kk][1], ap[2 * kk + 1][0], ap[2 * kk + 1][1]);
      }
    }
  }
  cp_async_wait<1>();              // ka (qa may still land)
  __syncthreads();

  float oc[SLOT / 8][4];
  if (rows_ok) {
    // dqa = dlog . ka: the split dlog registers are the A fragments.
#pragma unroll
    for (int j = 0; j < SLOT / 8; ++j) oc[j][0] = oc[j][1] = oc[j][2] = oc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KMAX / 16; ++kk) {
      if (2 * kk < nt) {
        uint32_t hi[4], lo[4];
        split2(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split2(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split2(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split2(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
        const bf16* kr = K + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KLD + (lane >> 4) * 8;
#pragma unroll
        for (int d = 0; d < SLOT / 16; ++d) {
          uint32_t kb[4];
          ldsm_x4_t(kb, kr + d * 16);
          mma_bf16(oc[2 * d], hi, kb[0], kb[1]);
          mma_bf16(oc[2 * d], lo, kb[0], kb[1]);
          mma_bf16(oc[2 * d + 1], hi, kb[2], kb[3]);
          mma_bf16(oc[2 * d + 1], lo, kb[2], kb[3]);
        }
      }
    }
  }
  __syncthreads();                 // every warp is done with ka: K stages the outputs
  if (rows_ok) {
    // dbias = bf16(dlog) (= hi), 64 key columns at a time through Sw.
    bf16* drow = dbias + (hb + i_first) * L;
#pragma unroll
    for (int cb = 0; cb < KMAX / 64; ++cb) {
      if (cb * 8 < nt) {
        __syncwarp();
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int jt = cb * 8 + jj;
          if (jt < nt) {
            st_shared_u32(Sw + g * KLD + jj * 8 + 2 * t, pack2(s[jt][0], s[jt][1]));
            st_shared_u32(Sw + (g + 8) * KLD + jj * 8 + 2 * t, pack2(s[jt][2], s[jt][3]));
          }
        }
        __syncwarp();
        const int units = min(8, nt - cb * 8);
#pragma unroll
        for (int u = lane; u < 128; u += 32) {
          const int r = u >> 3, q = u & 7;
          if (q < units)
            *reinterpret_cast<uint4*>(drow + (size_t)r * L + cb * 64 + q * 8) =
                ld_shared_v4(Sw + r * KLD + q * 8);
        }
      }
    }
    store_frag_rows(oc, Sw, dqa + (nb + i_first) * HD + h * SLOT, HD, lane);
  }
  cp_async_wait<0>();              // qa is in R
  cluster.sync();                  // every block's Th, Tl, Ta and R are written

  if (rows_ok) {
    // dka = dlog^T . qa, dvvp = alpha^T . dout for key rows i_first ..: K
    // runs over every block's query rows, rank by rank, 16 at a time.
    float gk[SLOT / 8][4], gv[SLOT / 8][4];
#pragma unroll
    for (int j = 0; j < SLOT / 8; ++j) {
      gk[j][0] = gk[j][1] = gk[j][2] = gk[j][3] = 0.0f;
      gv[j][0] = gv[j][1] = gv[j][2] = gv[j][3] = 0.0f;
    }
    const int fo = (i_first + g) * KLD + 2 * t;    // a fragment row in a peer's T
    for (int p = 0; p < C; ++p) {
      const bf16* ph = cluster.map_shared_rank(Th, p);
      const bf16* pl = cluster.map_shared_rank(Tl, p);
      const bf16* pa = cluster.map_shared_rank(Ta, p);
      const int np = min(K3_ROWS, L - p * K3_ROWS);
#pragma unroll
      for (int kk = 0; kk < K3_ROWS / 16; ++kk) {
        if (kk * 16 < np) {
          const int o = fo + kk * 16;
          auto frag = [&](const bf16* base, uint32_t (&a)[4]) {
            a[0] = *reinterpret_cast<const uint32_t*>(base + o);
            a[1] = *reinterpret_cast<const uint32_t*>(base + o + 8 * KLD);
            a[2] = *reinterpret_cast<const uint32_t*>(base + o + 8);
            a[3] = *reinterpret_cast<const uint32_t*>(base + o + 8 * KLD + 8);
          };
          uint32_t ah[4], al[4], aa[4];
          frag(ph, ah);
          frag(pl, al);
          frag(pa, aa);
          const int ro = (p * K3_ROWS + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KLD +
                         (lane >> 4) * 8;
#pragma unroll
          for (int d = 0; d < SLOT / 16; ++d) {
            uint32_t qb[4], db[4];
            ldsm_x4_t(qb, R + ro + d * 16);
            ldsm_x4_t(db, D + ro + d * 16);
            mma_bf16(gk[2 * d], ah, qb[0], qb[1]);
            mma_bf16(gk[2 * d], al, qb[0], qb[1]);
            mma_bf16(gk[2 * d + 1], ah, qb[2], qb[3]);
            mma_bf16(gk[2 * d + 1], al, qb[2], qb[3]);
            mma_bf16(gv[2 * d], aa, db[0], db[1]);
            mma_bf16(gv[2 * d + 1], aa, db[2], db[3]);
          }
        }
      }
    }
    const size_t ob = (nb + i_first) * HD + h * SLOT;
    store_frag_rows(gk, Sw, dka + ob, HD, lane);
    store_frag_rows(gv, Sw, dvv + ob, HD, lane);
  }
  cluster.sync();                  // no block leaves while a peer may read it
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

// ------------------------------------------------- K2 and K3: the plans
// One plan per kernel and shape, the launches' own: route 1 (tile) or 0
// (CUDA cores), then per launch its grid, threads, cluster size and shared
// memory. ipa_attention_plan hands it to the wrapper's check.
struct Shape {
  int gx, gy, gz, threads, cluster;
  size_t smem;
};
struct RoutePlan {
  int tile, n;
  Shape l[2];
};

bool tile_route(int dtype, int L) { return dtype == 1 && L <= 256; }

// The CUDA-core launches: 32 query rows a block (fwd_kernel, and
// bwd_rows_kernel: pass 0), 32 keys a block (bwd_cols_kernel: pass 1).
Shape cc_shape(int N, int L, int H, int pass) {
  if (pass == 0) return {(L + TQ - 1) / TQ, H, N, NT, 1, rows_smem(L)};
  return {(L + CK - 1) / CK, H, N, NT, 1, cols_smem()};
}

// Replicas a K2 tile block serves (they share its bias rows), as K1 and K4
// pick them: the largest of 4, 2 and 1 that divides reps.
int replica_group(int reps) { return reps % 4 == 0 ? 4 : reps % 2 == 0 ? 2 : 1; }

RoutePlan fwd_plan(int N, int L, int H, int reps, int dtype) {
  RoutePlan p{};
  p.n = 1;
  if (tile_route(dtype, L)) {
    p.tile = 1;
    p.l[0] = {(L + K2_ROWS - 1) / K2_ROWS, H, N / replica_group(reps), K2_ROWS / 16 * 32, 1,
              L > 128 ? AttnLarge::smem(L) : AttnLean64::smem(L)};
  } else {
    p.l[0] = cc_shape(N, L, H, 0);
  }
  return p;
}

RoutePlan bwd_plan(int N, int L, int H, int dtype) {
  RoutePlan p{};
  if (tile_route(dtype, L)) {
    const int c = (L + K3_ROWS - 1) / K3_ROWS;
    p.tile = 1;
    p.n = 1;
    p.l[0] = {c, H, N, K3_NT, c, k3_smem(L)};
  } else {
    p.n = 2;
    p.l[0] = cc_shape(N, L, H, 0);
    p.l[1] = cc_shape(N, L, H, 1);
  }
  return p;
}

template <typename T>
int launch_fwd(const void* qa, const void* ka, const void* vv,
               const void* bias, void* out, void* alphas, int N, int L, int H,
               int reps, cudaStream_t stream) {
  const Shape sh = cc_shape(N, L, H, 0);
  int err = set_smem(fwd_kernel<T>, sh.smem);
  if (err) return err;
  fwd_kernel<T><<<dim3(sh.gx, sh.gy, sh.gz), sh.threads, sh.smem, stream>>>(
      static_cast<const T*>(qa), static_cast<const T*>(ka),
      static_cast<const T*>(vv), static_cast<const T*>(bias),
      static_cast<T*>(out), static_cast<T*>(alphas), L, H, reps);
  return (int)cudaGetLastError();
}

size_t cc_p2n_smem(int tq, int L, int H, size_t tsize) {
  return ((size_t)(tq + TK) * TLD + (size_t)tq * (L + 1)) * sizeof(float)
         + (size_t)H * tq * L * tsize;
}

// K4's query rows a block on the CUDA cores: the most (32, 16, 8 or 4) with
// which two blocks fit on an SM, else the most with which one does; 0 if
// none fits.
int cc_p2n_rows(int L, int H, size_t tsize) {
  const int rows[] = {32, 16, 8, 4};
  for (int blocks = 2; blocks >= 1; --blocks)
    for (int tq : rows) {
      const size_t smem = cc_p2n_smem(tq, L, H, tsize);
      if (smem <= SMEM_BLOCK && blocks * (smem + SMEM_RESERVED) <= SMEM_SM)
        return tq;
    }
  return 0;
}

template <typename T, int TQ>
int launch_fwd_p2n_rows(const T* qa, const T* ka, const T* vv, const T* bias,
                        const T* z, T* out, T* p2n, int N, int L, int H,
                        int Cz, int reps, cudaStream_t stream) {
  const size_t smem = cc_p2n_smem(TQ, L, H, sizeof(T));
  int err = set_smem(fwd_p2n_kernel<T, TQ>, smem);
  if (err) return err;
  fwd_p2n_kernel<T, TQ><<<dim3((L + TQ - 1) / TQ, N), NT, smem, stream>>>(
      qa, ka, vv, bias, z, out, p2n, L, H, Cz, reps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd_p2n(const void* qa, const void* ka, const void* vv,
                   const void* bias, const void* z, void* out, void* p2n,
                   int N, int L, int H, int Cz, int reps, cudaStream_t stream) {
  if (Cz % 4 != 0 || Cz > TK * TLD / P2N_ROWS || H * Cz > 1024)
    return (int)cudaErrorInvalidValue;
  const auto args = [&](auto launch) {
    return launch(static_cast<const T*>(qa), static_cast<const T*>(ka),
                  static_cast<const T*>(vv), static_cast<const T*>(bias),
                  static_cast<const T*>(z), static_cast<T*>(out),
                  static_cast<T*>(p2n), N, L, H, Cz, reps, stream);
  };
  switch (cc_p2n_rows(L, H, sizeof(T))) {
    case 32: return args(launch_fwd_p2n_rows<T, 32>);
    case 16: return args(launch_fwd_p2n_rows<T, 16>);
    case 8: return args(launch_fwd_p2n_rows<T, 8>);
    case 4: return args(launch_fwd_p2n_rows<T, 4>);
  }
  return (int)cudaErrorInvalidConfiguration;
}

// K4's p2n stages: two where two blocks of them fit an SM, else one.
constexpr int k4_p2n_stages(int L) {
  return 2 * (2 * p2n_stage_bytes(L) + SMEM_RESERVED) <= SMEM_SM ? 2 : 1;
}

int launch_k4_p2n(const bf16* alpha, const bf16* z, bf16* p2n, int N, int L, int H, int reps,
                  int rows, int ns, cudaStream_t stream) {
  const size_t smem = ns * p2n_stage_bytes(L);
  int err = set_smem(k4_p2n_kernel, smem);
  if (err) return err;
  k4_p2n_kernel<<<dim3((reps * H + P2N_M - 1) / P2N_M, (L + rows - 1) / rows, N / reps), P2N_NT,
                  smem, stream>>>(alpha, z, p2n, L, H, reps, rows, ns);
  return (int)cudaGetLastError();
}

// The attention into K1's alpha layout in `alpha`, then p2n over P2N_M-row
// blocks of `rows` query rows each.
template <class Plan>
int launch_k4(const bf16* qa, const bf16* ka, const bf16* vv, const bf16* bias,
                       const bf16* z, bf16* out, bf16* p2n, bf16* alpha, int N, int L, int H,
                       int reps, int rt, int rows, cudaStream_t stream) {
  int err = set_smem(k4_attn_kernel<Plan>, Plan::smem(L));
  if (err) return err;
  k4_attn_kernel<Plan><<<dim3((L + Plan::QT - 1) / Plan::QT, H, N / rt), Plan::QW * 32,
                         Plan::smem(L), stream>>>(qa, ka, vv, bias, out, alpha, L, H, reps, rt);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_k4_p2n(alpha, z, p2n, N, L, H, reps, rows, k4_p2n_stages(L), stream);
}

template <class Plan>
int launch_k2_tile(const void* qa, const void* ka, const void* vv, const void* bias, void* out,
                   void* alphas, int N, int L, int H, int reps, const Shape& s,
                   cudaStream_t stream) {
  int err = set_smem(k2_tile_kernel<Plan>, s.smem);
  if (err) return err;
  k2_tile_kernel<Plan><<<dim3(s.gx, s.gy, s.gz), s.threads, s.smem, stream>>>(
      static_cast<const bf16*>(qa), static_cast<const bf16*>(ka),
      static_cast<const bf16*>(vv), static_cast<const bf16*>(bias), static_cast<bf16*>(out),
      static_cast<bf16*>(alphas), L, H, reps, N / s.gz);
  return (int)cudaGetLastError();
}

// One launch of a (C, 1, 1) cluster per (n, h), by cudaLaunchKernelEx.
template <int KMAX>
int launch_k3_tile(const void* qa, const void* ka, const void* vv, const void* alphas,
                   const void* dout, const void* dalphas, void* dqa, void* dka, void* dvv,
                   void* dbias, int L, int H, const Shape& s, cudaStream_t stream) {
  int err = set_smem(k3_tile_kernel<KMAX>, s.smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.gx, s.gy, s.gz);
  cfg.blockDim = dim3(s.threads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(
      &cfg, k3_tile_kernel<KMAX>, static_cast<const bf16*>(qa), static_cast<const bf16*>(ka),
      static_cast<const bf16*>(vv), static_cast<const bf16*>(alphas),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(dalphas),
      static_cast<bf16*>(dqa), static_cast<bf16*>(dka), static_cast<bf16*>(dvv),
      static_cast<bf16*>(dbias), L, H);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* qa, const void* ka, const void* vv,
               const void* alphas, const void* dout, const void* dalphas,
               void* dqa, void* dka, void* dvv, void* dbias, float* rowsum,
               int N, int L, int H, cudaStream_t stream) {
  const Shape s1 = cc_shape(N, L, H, 0), s2 = cc_shape(N, L, H, 1);
  int err = set_smem(bwd_rows_kernel<T>, s1.smem);
  if (err) return err;
  bwd_rows_kernel<T><<<dim3(s1.gx, s1.gy, s1.gz), s1.threads, s1.smem, stream>>>(
      static_cast<const T*>(ka), static_cast<const T*>(vv),
      static_cast<const T*>(alphas), static_cast<const T*>(dout),
      static_cast<const T*>(dalphas), static_cast<T*>(dqa),
      static_cast<T*>(dbias), rowsum, L, H);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = set_smem(bwd_cols_kernel<T>, s2.smem);
  if (err) return err;
  bwd_cols_kernel<T><<<dim3(s2.gx, s2.gy, s2.gz), s2.threads, s2.smem, stream>>>(
      static_cast<const T*>(qa), static_cast<const T*>(vv),
      static_cast<const T*>(alphas), static_cast<const T*>(dout),
      static_cast<const T*>(dalphas), rowsum, static_cast<T*>(dka),
      static_cast<T*>(dvv), L, H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry point launches on `stream`
// and returns the first non-zero cudaGetLastError() (0 when every launch was
// accepted); it does not synchronise. ipa_attention_fwd and
// ipa_attention_bwd are the CUDA-core route, in either type (the wrapper
// takes it for float32 and bf16 past L = 256; bf16 up to 256 runs the
// tiles, ipa_attention_fwd_tile and ipa_attention_bwd_tile).
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

// K4 on the CUDA cores (float32, or bf16 past L = 256): z (N / reps, L, L,
// Cz) per complex; out (N, L, H * 64) and p2n (N, L, H, Cz) in the input
// type; no alphas output.
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

// The query rows a CUDA-core K4 block takes at (L, H, dtype), 0 if no tile
// fits.
extern "C" int ipa_attention_fwd_p2n_tile(int L, int H, int dtype) {
  return cc_p2n_rows(L, H, dtype == 0 ? sizeof(float) : sizeof(bf16));
}

// K4 on K1's attention tile (bf16, L a multiple of 16 up to 256, Cz = 64,
// H a multiple of 4): alpha is an (N / reps, L, reps H, L) bf16 workspace;
// rt replicas an attention block, `rows` query rows a p2n block. On
// `stream`; returns the first non-zero cudaGetLastError().
extern "C" int ipa_attention_fwd_p2n_tiles(const bf16* qa, const bf16* ka, const bf16* vv,
                                           const bf16* bias, const bf16* z, bf16* out,
                                           bf16* p2n, bf16* alpha, int N, int L, int H,
                                           int reps, int rt, int rows, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (L % 16 != 0 || L < 16 || L > 256 || H < 4 || H % 4 != 0 || reps < 1 || N % reps != 0 ||
      rt < 1 || reps % rt != 0 || rows < 1 || !alpha)
    return (int)cudaErrorInvalidValue;
  if (L <= 128)
    return launch_k4<AttnLean>(qa, ka, vv, bias, z, out, p2n, alpha, N, L, H, reps, rt, rows, s);
  return launch_k4<AttnLarge>(qa, ka, vv, bias, z, out, p2n, alpha, N, L, H, reps, rt, rows, s);
}

// K4's tile plan at L, for the wrapper's check: [attention smem, p2n smem,
// attention query rows, p2n stages]. Returns 0, or an error for an L it
// does not take.
extern "C" int ipa_attention_fwd_p2n_tile_plan(int L, long long* out) {
  if (L % 16 != 0 || L < 16 || L > 256) return (int)cudaErrorInvalidValue;
  out[0] = (long long)(L <= 128 ? AttnLean::smem(L) : AttnLarge::smem(L));
  out[1] = (long long)(k4_p2n_stages(L) * p2n_stage_bytes(L));
  out[2] = L <= 128 ? AttnLean::QT : AttnLarge::QT;
  out[3] = k4_p2n_stages(L);
  return 0;
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

static bool tile_shapes_ok(int N, int L, int H, int reps) {
  return L % 16 == 0 && L >= 16 && L <= 256 && H >= 1 && H <= 65535 && reps >= 1 &&
         N % reps == 0 && N >= 1 && N <= 65535;
}

// K2 on K1's attention tile (bf16, L a multiple of 16 up to 256), 64 query
// rows a block. On `stream`; returns cudaGetLastError().
extern "C" int ipa_attention_fwd_tile(const void* qa, const void* ka, const void* vv,
                                      const void* bias, void* out, void* alphas, int N, int L,
                                      int H, int reps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!tile_shapes_ok(N, L, H, reps)) return (int)cudaErrorInvalidValue;
  const Shape sh = fwd_plan(N, L, H, reps, 1).l[0];
  if (L > 128)
    return launch_k2_tile<AttnLarge>(qa, ka, vv, bias, out, alphas, N, L, H, reps, sh, s);
  return launch_k2_tile<AttnLean64>(qa, ka, vv, bias, out, alphas, N, L, H, reps, sh, s);
}

// K3 in one launch (bf16, L a multiple of 16 up to 256); dbias per
// trajectory (N, H, L, L). On `stream`; returns the first non-zero error.
extern "C" int ipa_attention_bwd_tile(const void* qa, const void* ka, const void* vv,
                                      const void* alphas, const void* dout,
                                      const void* dalphas, void* dqa, void* dka, void* dvv,
                                      void* dbias, int N, int L, int H, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!tile_shapes_ok(N, L, H, 1)) return (int)cudaErrorInvalidValue;
  const Shape sh = bwd_plan(N, L, H, 1).l[0];
  if (L <= 128)
    return launch_k3_tile<128>(qa, ka, vv, alphas, dout, dalphas, dqa, dka, dvv, dbias, L, H,
                               sh, s);
  return launch_k3_tile<256>(qa, ka, vv, alphas, dout, dalphas, dqa, dka, dvv, dbias, L, H,
                             sh, s);
}

// K2's and K3's plans at (N, L, H, reps, dtype), for the wrapper's check: out[0..13] K2, out[14..27] K3, each [route (1 tile,
// 0 CUDA cores), launches, then per launch (grid x, y, z, threads, cluster,
// smem) x 2, zeros past the last launch].
extern "C" int ipa_attention_plan(int N, int L, int H, int reps, int dtype, long long* out) {
  if (L % 16 != 0 || L < 16 || L > 512 || reps < 1 || N % reps != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const RoutePlan plans[2] = {fwd_plan(N, L, H, reps, dtype), bwd_plan(N, L, H, dtype)};
  for (int k = 0; k < 2; ++k) {
    long long* o = out + 14 * k;
    o[0] = plans[k].tile;
    o[1] = plans[k].n;
    for (int i = 0; i < 2; ++i) {
      const Shape& sh = plans[k].l[i];
      const long long v[6] = {sh.gx, sh.gy, sh.gz, sh.threads, sh.cluster, (long long)sh.smem};
      for (int e = 0; e < 6; ++e) o[2 + 6 * i + e] = i < plans[k].n ? v[e] : 0;
    }
  }
  return 0;
}

extern "C" const char* ipa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
