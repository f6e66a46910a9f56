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
// bytes (~76 us) too. The p2n operand differs for every query row (row i
// reads its own (L, Cz) slab z[c, i]) and is shared by the reps * H
// (replica, head) alpha rows of that row: K1's M = reps H. In bf16 up to
// L = 256 (Cz = 64, H a multiple of 4) K4 runs on K1's replica-group
// attention tile (csrc/k1_tiles.cuh; see "K4, tiles" below); float32, and
// bf16 past L = 256, take K2's CUDA-core f32 tiles (fwd_p2n_kernel).
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
//   fwd_p2n_kernel  float32, or bf16 past L = 256: K4 per TQ query rows of
//                   one trajectory, all heads (TQ = 32, 16, 8 or 4, the most
//                   that fits; alpha in T, H x TQ x L, in shared memory),
//                   products on the CUDA cores.
//
// L is a runtime value (the wrapper takes multiples of 16 up to 512; ragged
// tiles are masked here), H and N are grid dimensions.

#include "k1_tiles.cuh"

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

extern "C" const char* ipa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
