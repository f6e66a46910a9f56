// The attention-variant harness (S1-S3) for Hopper (sm_90a): three ways to
// compute the IPA attention forward, each on the tensor cores in bf16.
//
// Replaces the TPU kernels of scripts/micro_kernel_variants.py:
//   S1  v1_call -> _v1_kernel: K2's function (ab_opt_tpu/ops/ipa_pallas.py
//       _attention_fwd_call); with store_alphas (v1) it exports the alphas,
//       without (v3) only out;
//   S2  v2_call -> _v2_kernel: K2's function with the heads as the batch
//       dimension of one product; exports the alphas;
//   S3  v4_call -> _v4_kernel: v3 plus p2n[n, i, h, :] = sum_j alpha[h, i, j]
//       z[n / reps, i, j, :] in the kernel: K4's function.
// Layout (the JAX package's): qa, ka, vvp, out are (N, L, H * 64), each head
// a 64-wide slot, qa pre-scaled; bias is (N / reps, H, L, L) (trajectory n
// reads its complex's block n / reps); alphas (N, H, L, L); z (N / reps, L,
// L, Cz), p2n (N, L, H, Cz). All bf16. Every product accumulates in f32 on
// the tensor cores (S1: mma.sync m16n8k16; S2, S3: wmma 16x16x16); the
// softmax is exact (max-subtract, f32) and alpha is rounded to bf16 once,
// and that value feeds every product and the alphas output.
//
// What bounds them on this card. At the script's shape (N = 256 replicas of
// one complex, L = 128, H = 12, Cz = 64) each variant does 12.9 GFLOP (v4:
// 19.3) and moves qa, ka, vvp and out at 50.3 MB each, the alphas at 100.7
// MB (v1, v2) and p2n at 50.3 MB (v4): ~302 MB for v1 and v2, ~202 MB for
// v3, ~254 MB for v4. At ~295 FLOP a byte before the bf16 tensor cores
// limit, all are bounded by device-memory bytes (0.060-0.090 ms at 3.35
// TB/s). S2 and S3 price where the intermediate alpha lives and how the
// heads share a block; S1 is K1's attention launch with alpha in K2's
// layout or nowhere, held against the library's attention.
//
// Design.
//   S1 (v1, v3) runs K1's replica-group attention tile (csrc/k1_tiles.cuh
//     k1_attn_tile, the tile of K1's attention launch): a block per (query
//     tile, head, rt replicas of one complex), the tile's bias rows staged
//     once for the group, a cp.async ring of K / V / Q stages, the logits,
//     the exact softmax and alpha . V in mma.sync registers, o out through
//     16-byte stores. v1 writes alpha in K2's (N, H, L, L) layout from the
//     same registers; v3 compiles the alpha stores away. L a multiple of 16
//     up to 256, as K1 takes it. Up to L = 128 the tile runs in AttnLean's
//     plan (one K / V / Q stage, two blocks an SM; K1's launch keeps
//     AttnSmall's three stages, one block an SM), past it in AttnLarge's.
//   S1's earlier design (phased_kernel below with an alpha store: 16 query
//   rows of one trajectory a block, every head's f32 logits in shared
//   memory, capped at L = 128) is gone; its times stay in PERF.md.
//   phased_kernel (S3, v4), 8 warps, a block owns 16 query rows of one
//   trajectory (grid (L / 16, N)):
//     phase 1  every head's 16 x L logits tile, f32, into shared memory
//              (K of two heads staged at a time; warp w takes key tiles w,
//              w + 8, ...);
//     phase 2  one softmax pass over all H * 16 rows by the whole block (a
//              warp a row), bias block n / reps added; alpha rounded to bf16
//              into A at row r H + h (one 16 x 16 tile holds every head of
//              query r, and head h's 16 x L alpha is rows h + H r);
//     phase 3  every head's alpha . V (V of two heads staged at a time, one
//              16 x 16 output tile a warp);
//     phase 4  p2n from A and z, two query rows at a time.
//     Shared memory holds the f32 logits of every head at once (98 KB at
//     L = 128, H = 12), beside the block's query rows, two heads' K or V
//     and the bf16 alphas: 219,520 bytes at L = 128, H = 12, so L = 128 is
//     the cap at 12 heads (L = 144 needs 242,688 of the 232,448 a block may
//     have). phased_smem() is the plan; the wrapper refuses above the cap.
//   head_batched_kernel (S2): one warp a head (min(H, 16) warps, a head
//     loop past 16), no block-wide barrier at all. Each warp runs its
//     head's logits, softmax, alpha store and alpha . V alone, reading its
//     Q, K and V fragments straight from global memory: twelve heads' K and
//     V (393 KB at L = 128) do not fit in shared memory, and a trajectory's
//     ka and vvp stay L2-resident across its 8 row tiles. Shared memory is
//     per warp: the head's f32 logits and its bf16 alpha (13 KB at L = 128);
//     cap L = 192 at 12 heads.
// S2 and S3 are first, simple versions: no cp.async, TMA, wgmma or
// clusters.

#include <stddef.h>

#include "k1_tiles.cuh"

namespace {

constexpr int TI = 16;            // query rows a block (one wmma row tile)
constexpr int NT = 256;           // threads of a phased block
constexpr int NW = NT / 32;
constexpr int HB_MAX_WARPS = 16;  // head-batched: warps a block at most
constexpr size_t SMEM_BLOCK = 232448;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> RowA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> RowB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> ColB;

// Pitches (elements). Every wmma pointer below is 32-byte aligned: rows of
// bf16 pitch q_ld, KLD and a_ld 16 apart, and f32 rows of pitch s_ld, are
// multiples of 32 bytes, and so is every region.
__host__ __device__ inline int q_ld(int H) { return H * SLOT + 8; }
__host__ __device__ inline int a_ld(int L) { return L + 16; }
__host__ __device__ inline int s_ld(int L) { return (L > SLOT ? L : SLOT) + 4; }
// f32 logits of every head (phase 1-2), reused as the output tiles' scratch
// (phase 3: 256 floats a warp) and the p2n products (2 queries x 16 x 64).
__host__ __device__ inline int phased_s_floats(int L, int H) {
  const int s = H * TI * s_ld(L);
  return s > 2048 ? s : 2048;
}
// A's rows: alpha[h] of query r at row r H + h; the p2n tile of query r reads
// 16 rows from r H.
__host__ __device__ inline int phased_a_rows(int H) {
  return (TI - 1) * H + (H > 16 ? H : 16);
}
__host__ __device__ inline size_t hb_warp_bytes(int L) {
  return (size_t)TI * s_ld(L) * sizeof(float) + (size_t)TI * a_ld(L) * sizeof(bf16);
}

size_t phased_smem(int L, int H) {
  return (size_t)TI * q_ld(H) * sizeof(bf16) + (size_t)2 * L * KLD * sizeof(bf16)
         + (size_t)phased_s_floats(L, H) * sizeof(float)
         + (size_t)phased_a_rows(H) * a_ld(L) * sizeof(bf16);
}

int hb_warps(int H) { return H < HB_MAX_WARPS ? H : HB_MAX_WARPS; }

size_t head_batched_smem(int L, int H) { return hb_warps(H) * hb_warp_bytes(L); }

// Exact softmax of one row by one warp: srow (f32 logits, L) plus the bias
// row; alpha rounded to bf16 once into arow and, if given, grow (global).
__device__ __forceinline__ void softmax_row(float* srow, const bf16* __restrict__ brow,
                                            bf16* arow, bf16* __restrict__ grow,
                                            int L, int lane) {
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
  for (int j = lane; j < L; j += 32) {
    const bf16 a = __float2bfloat16(srow[j] * inv);
    arow[j] = a;
    if (grow) grow[j] = a;
  }
}

// Head h's 64-wide slot of every row of trajectory n, (N, L, H * 64) ->
// smem (L x KLD), 16 bytes a thread.
__device__ __forceinline__ void stage_slot(bf16* dst, const bf16* __restrict__ src,
                                           int n, int h, int L, int HD) {
  for (int idx = threadIdx.x; idx < L * 8; idx += NT) {
    const int j = idx >> 3, cc = (idx & 7) * 8;
    *reinterpret_cast<uint4*>(&dst[j * KLD + cc]) = *reinterpret_cast<const uint4*>(
        &src[((size_t)n * L + j) * HD + (size_t)h * SLOT + cc]);
  }
}

// -------------------------------------------------------------------- S1
// Block = (query tile, head h, replicas blockIdx.z * rt .. + rt - 1), as
// K1's attention launch; alpha in K2's layout (v1) or none (v3).
template <class Plan, AlphaOut AO>
__global__ void __launch_bounds__(Plan::QW * 32, 1)
tile_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
            const bf16* __restrict__ vv, const bf16* __restrict__ bias,
            bf16* __restrict__ out, bf16* __restrict__ alphas, int L, int H,
            int reps, int rt) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int h = blockIdx.y, n0 = blockIdx.z * rt;
  k1_attn_tile<Plan, AO>(blockIdx.x * Plan::QT, h, n0, rt, qa, ka, vv,
                         bias + ((size_t)(n0 / reps) * H + h) * L * L, out, alphas, L, H,
                         reps, smraw);
}

// -------------------------------------------------------------------- S3
// Shared memory: Qs (16 x q_ld) the block's query rows, every head; KV
// (2 x L x KLD) two heads' K or V, or two queries' z rows; S (f32, see
// phased_s_floats); A (phased_a_rows x a_ld bf16).
__global__ void __launch_bounds__(NT)
phased_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
              const bf16* __restrict__ vv, const bf16* __restrict__ bias,
              const bf16* __restrict__ z, bf16* __restrict__ out,
              bf16* __restrict__ p2n, int L, int H, int Cz, int reps) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int QLD = q_ld(H), SLD = s_ld(L), ALD = a_ld(L), HD = H * SLOT;
  bf16* Qs = reinterpret_cast<bf16*>(smraw);
  bf16* KV = Qs + TI * QLD;
  float* S = reinterpret_cast<float*>(KV + 2 * L * KLD);
  bf16* A = reinterpret_cast<bf16*>(S + phased_s_floats(L, H));
  const int n = blockIdx.y, c = n / reps, i0 = blockIdx.x * TI;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int JT = L / 16;

  // Phase 1: every head's logits.
  for (int idx = tid; idx < TI * H * 8; idx += NT) {
    const int r = idx / (H * 8), cc = (idx - r * H * 8) * 8;
    *reinterpret_cast<uint4*>(&Qs[r * QLD + cc]) =
        *reinterpret_cast<const uint4*>(&qa[((size_t)n * L + i0 + r) * HD + cc]);
  }
  for (int h0 = 0; h0 < H; h0 += 2) {
    const int nh = min(2, H - h0);
    __syncthreads();                 // the previous pair is done with KV
    for (int k = 0; k < nh; ++k) stage_slot(KV + k * L * KLD, ka, n, h0 + k, L, HD);
    __syncthreads();
    for (int t = warp; t < nh * JT; t += NW) {
      const int k = t / JT, jt = t - k * JT, h = h0 + k;
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < SLOT / 16; ++kk) {
        RowA qf;
        ColB kf;
        wmma::load_matrix_sync(qf, Qs + h * SLOT + kk * 16, QLD);
        wmma::load_matrix_sync(kf, KV + (k * L + jt * 16) * KLD + kk * 16, KLD);
        wmma::mma_sync(acc, qf, kf, acc);
      }
      wmma::store_matrix_sync(S + (size_t)h * TI * SLD + jt * 16, acc, SLD,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  // Phase 2: one softmax pass over all H x 16 rows (row h * 16 + r of S).
  const bf16* bbase = bias + (size_t)c * H * L * L;
  for (int row = warp; row < H * TI; row += NW) {
    const int h = row / TI, r = row - h * TI, i = i0 + r;
    softmax_row(S + (size_t)row * SLD, bbase + ((size_t)h * L + i) * L,
                A + ((size_t)r * H + h) * ALD, nullptr, L, lane);
  }

  // Phase 3: every head's alpha . V; warp w's output tile goes through its
  // own 256 floats of S (the logits are consumed).
  float* scr = S + warp * 256;
  for (int h0 = 0; h0 < H; h0 += 2) {
    const int nh = min(2, H - h0);
    __syncthreads();                 // softmax done / the previous pair done with KV
    for (int k = 0; k < nh; ++k) stage_slot(KV + k * L * KLD, vv, n, h0 + k, L, HD);
    __syncthreads();
    for (int t = warp; t < nh * (SLOT / 16); t += NW) {
      const int k = t / (SLOT / 16), ct = t - k * (SLOT / 16), h = h0 + k;
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kt = 0; kt < JT; ++kt) {
        RowA pf;
        RowB vf;
        wmma::load_matrix_sync(pf, A + (size_t)h * ALD + kt * 16, H * ALD);
        wmma::load_matrix_sync(vf, KV + (k * L + kt * 16) * KLD + ct * 16, KLD);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, d = e & 15;
        out[((size_t)n * L + i0 + r) * HD + (size_t)h * SLOT + ct * 16 + d] =
            __float2bfloat16(scr[e]);
      }
      __syncwarp();
    }
  }

  // Phase 4: p2n, two query rows at a time: warps 0-3 the first, 4-7 the
  // second, one Cz / 16-column tile each; the 16 x 16 A tile at row r H
  // holds every head of query r (rows past its H heads are not stored).
  const int cz8 = Cz / 8;
  for (int r0 = 0; r0 < TI; r0 += 2) {
    __syncthreads();
    for (int idx = tid; idx < 2 * L * cz8; idx += NT) {
      const int q = idx / (L * cz8), rest = idx - q * (L * cz8);
      const int j = rest / cz8, cc = (rest - j * cz8) * 8, i = i0 + r0 + q;
      *reinterpret_cast<uint4*>(&KV[(q * L + j) * KLD + cc]) =
          *reinterpret_cast<const uint4*>(&z[(((size_t)c * L + i) * L + j) * Cz + cc]);
    }
    __syncthreads();
    const int q = warp >> 2, jc = warp & 3;
    if (jc < Cz / 16) {
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kt = 0; kt < JT; ++kt) {
        RowA af;
        RowB zf;
        wmma::load_matrix_sync(af, A + (size_t)(r0 + q) * H * ALD + kt * 16, ALD);
        wmma::load_matrix_sync(zf, KV + (q * L + kt * 16) * KLD + jc * 16, KLD);
        wmma::mma_sync(acc, af, zf, acc);
      }
      wmma::store_matrix_sync(S + q * TI * SLOT + jc * 16, acc, SLOT,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < 2 * H * Cz; idx += NT) {
      const int q2 = idx / (H * Cz), rest = idx - q2 * (H * Cz);
      const int hh = rest / Cz, d = rest - hh * Cz, i = i0 + r0 + q2;
      p2n[(((size_t)n * L + i) * H + hh) * Cz + d] =
          __float2bfloat16(S[q2 * TI * SLOT + hh * SLOT + d]);
    }
  }
}

// ------------------------------------------------------------------ S2
// One warp a head, no block barrier. Warp w's shared memory: S (16 x s_ld
// f32: the head's logits, then its four output tiles) and A (16 x a_ld
// bf16: its alpha). Q, K and V fragments come from global memory (L2).
__global__ void
head_batched_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
                    const bf16* __restrict__ vv, const bf16* __restrict__ bias,
                    bf16* __restrict__ out, bf16* __restrict__ alphas, int L,
                    int H, int reps) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int SLD = s_ld(L), ALD = a_ld(L), HD = H * SLOT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  unsigned char* mine = smraw + (size_t)warp * hb_warp_bytes(L);
  float* S = reinterpret_cast<float*>(mine);
  bf16* A = reinterpret_cast<bf16*>(mine + (size_t)TI * SLD * sizeof(float));
  const int n = blockIdx.y, c = n / reps, i0 = blockIdx.x * TI, JT = L / 16;

  for (int h = warp; h < H; h += nwarps) {
    const bf16* qb = qa + ((size_t)n * L + i0) * HD + (size_t)h * SLOT;
    const bf16* kb = ka + (size_t)n * L * HD + (size_t)h * SLOT;
    const bf16* vb = vv + (size_t)n * L * HD + (size_t)h * SLOT;
    for (int jt = 0; jt < JT; ++jt) {
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < SLOT / 16; ++kk) {
        RowA qf;
        ColB kf;
        wmma::load_matrix_sync(qf, qb + kk * 16, HD);
        wmma::load_matrix_sync(kf, kb + (size_t)jt * 16 * HD + kk * 16, HD);
        wmma::mma_sync(acc, qf, kf, acc);
      }
      wmma::store_matrix_sync(S + jt * 16, acc, SLD, wmma::mem_row_major);
    }
    __syncwarp();
    const bf16* bh = bias + (((size_t)c * H + h) * L + i0) * L;
    bf16* gh = alphas + (((size_t)n * H + h) * L + i0) * L;
    for (int r = 0; r < TI; ++r)
      softmax_row(S + r * SLD, bh + (size_t)r * L, A + r * ALD, gh + (size_t)r * L,
                  L, lane);
    __syncwarp();
    for (int ct = 0; ct < SLOT / 16; ++ct) {
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kt = 0; kt < JT; ++kt) {
        RowA pf;
        RowB vf;
        wmma::load_matrix_sync(pf, A + kt * 16, ALD);
        wmma::load_matrix_sync(vf, vb + (size_t)kt * 16 * HD + ct * 16, HD);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(S + ct * 16, acc, SLD, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < TI * SLOT; e += 32) {
      const int r = e >> 6, d = e & 63;
      out[((size_t)n * L + i0 + r) * HD + (size_t)h * SLOT + d] =
          __float2bfloat16(S[r * SLD + d]);
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------- host side

template <typename K>
int set_smem(K kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  return (int)cudaGetLastError();
}

template <class Plan, AlphaOut AO>
int launch_tile(const void* qa, const void* ka, const void* vv, const void* bias, void* out,
                void* alphas, int N, int L, int H, int reps, int rt, cudaStream_t stream) {
  int err = set_smem(tile_kernel<Plan, AO>, Plan::smem(L));
  if (err) return err;
  tile_kernel<Plan, AO><<<dim3((L + Plan::QT - 1) / Plan::QT, H, N / rt), Plan::QW * 32,
                          Plan::smem(L), stream>>>(
      static_cast<const bf16*>(qa), static_cast<const bf16*>(ka),
      static_cast<const bf16*>(vv), static_cast<const bf16*>(bias), static_cast<bf16*>(out),
      static_cast<bf16*>(alphas), L, H, reps, rt);
  return (int)cudaGetLastError();
}

template <AlphaOut AO>
int launch_s1(const void* qa, const void* ka, const void* vv, const void* bias, void* out,
              void* alphas, int N, int L, int H, int reps, int rt, cudaStream_t stream) {
  if (L <= 128)
    return launch_tile<AttnLean, AO>(qa, ka, vv, bias, out, alphas, N, L, H, reps, rt, stream);
  return launch_tile<AttnLarge, AO>(qa, ka, vv, bias, out, alphas, N, L, H, reps, rt, stream);
}

bool shapes_ok(int N, int L, int H, int reps) {
  return N > 0 && H > 0 && L >= TI && L % TI == 0 && reps > 0 && N % reps == 0
         && N <= 65535;
}

}  // namespace

// Shared memory a block of each kernel takes at (L, H), in bytes; the
// wrapper's cap for S2 and S3 is the largest L that fits in 232,448, S1's
// is K1's (L = 256).
extern "C" size_t attention_tile_smem(int L) {
  return L <= 128 ? AttnLean::smem(L) : AttnLarge::smem(L);
}
extern "C" size_t attention_phased_smem(int L, int H) { return phased_smem(L, H); }
extern "C" size_t attention_head_batched_smem(int L, int H) {
  return head_batched_smem(L, H);
}

// S1: out and, with alphas non-null (v1), alphas (N, H, L, L); without
// (v3) no alpha is stored. rt replicas a block (>= 1, dividing reps; the
// wrapper passes K1's choice). Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted); does not
// synchronise.
extern "C" int attention_tile(const void* qa, const void* ka, const void* vv,
                              const void* bias, void* out, void* alphas, int N, int L,
                              int H, int reps, int rt, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!shapes_ok(N, L, H, reps) || L > 256 || rt < 1 || reps % rt != 0)
    return (int)cudaErrorInvalidValue;
  if (alphas)
    return launch_s1<ALPHA_K2>(qa, ka, vv, bias, out, alphas, N, L, H, reps, rt, s);
  return launch_s1<ALPHA_NONE>(qa, ka, vv, bias, out, alphas, N, L, H, reps, rt, s);
}

// S3 (v4): out and p2n. As attention_tile, on `stream`.
extern "C" int attention_phased(const void* qa, const void* ka, const void* vv,
                                const void* bias, const void* z, void* out, void* p2n,
                                int N, int L, int H, int Cz, int reps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!shapes_ok(N, L, H, reps) || phased_smem(L, H) > SMEM_BLOCK || H > 16 ||
      Cz % 16 != 0 || Cz < 16 || Cz > SLOT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = phased_smem(L, H);
  int err = set_smem(phased_kernel, smem);
  if (err) return err;
  phased_kernel<<<dim3(L / TI, N), NT, smem, s>>>(
      static_cast<const bf16*>(qa), static_cast<const bf16*>(ka),
      static_cast<const bf16*>(vv), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(z), static_cast<bf16*>(out), static_cast<bf16*>(p2n), L, H,
      Cz, reps);
  return (int)cudaGetLastError();
}

// S2: out and alphas.
extern "C" int attention_head_batched(const void* qa, const void* ka,
                                      const void* vv, const void* bias,
                                      void* out, void* alphas, int N, int L,
                                      int H, int reps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = head_batched_smem(L, H);
  if (!shapes_ok(N, L, H, reps) || smem > SMEM_BLOCK)
    return (int)cudaErrorInvalidValue;
  int err = set_smem(head_batched_kernel, smem);
  if (err) return err;
  head_batched_kernel<<<dim3(L / TI, N), 32 * hb_warps(H), smem, s>>>(
      static_cast<const bf16*>(qa), static_cast<const bf16*>(ka),
      static_cast<const bf16*>(vv), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), static_cast<bf16*>(alphas), L, H, reps);
  return (int)cudaGetLastError();
}

extern "C" const char* attention_variants_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
