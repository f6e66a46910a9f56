// One IPA block (GABlock) forward for Hopper (sm_90a), bf16 tensor cores.
//
// Replaces the TPU kernel ab_opt_tpu/ops/gablock_pallas.py::_gablock_kernel
// (body _gablock_body): the whole block of the DiffAb sampling encoder —
// x projections, local->global point rotation, per-head |p|^2, the
// augmented 64-wide qa/ka/vvp operands, softmax(qa.ka^T + pair bias),
// alpha.vvp, the pair aggregation p2n = sum_j alpha z, global->local
// rotation with distance/direction features, out_transform, the row mask,
// LayerNorm, the 3-layer ReLU MLP and the second LayerNorm.
//
// What bounds it on this card. At N = 256 trajectories, L = 128 a layer is
// ~55 GFLOP with plain projections (the TPU kernel's folded fast-weight form
// is ~110 GFLOP, its operand matrices mostly zeros, so the folding is not
// carried over). z is 2 MB bf16 per complex and shared by all replicas of
// that complex; the per-complex pair bias is (H, L, L) bf16. Every GEMM here
// runs on the tensor cores (WMMA m16n16k16, bf16 in, f32 accumulate), so the
// layer is bounded by how well those tiles are fed, plus ~1 GB of
// intermediate traffic, not by HBM reads of z or of the weights. Measured on
// an H100 80GB HBM3 at 700 W: 1.43 ms per layer at N = 256 (~38 TFLOP/s, 4%
// of the bf16 dense peak), about half of it in attn_kernel, whose 97 KB of
// shared memory per 4-warp block leaves 2 blocks per SM.
//
// Design (simple and exact first; several launches from this one file):
//   1. gemm (A f32 -> bf16 on load): proj = x @ [Wq|Wk|Wv|Wqp|Wkp|Wvp]
//   2. assemble: rotate q/k/v points to the global frame (f32 R, t),
//      |p|^2 per head, write qa/ka/vvp in 64-wide per-head slots
//   3. attn: per (trajectory, head, 64 query rows): logits on the tensor
//      cores, + bias[n // reps], exact max-subtract softmax in f32,
//      alpha (bf16) -> alpha . vvp
//   4. p2n: per (complex, query row i): z[c, i] (L x Cz) is loaded once and
//      multiplied by the alpha rows of ALL replicas and heads of that complex
//      (M = reps * H), written straight into the feature matrix
//   5. feat: global->local rotation of the aggregated points, distance and
//      direction, node values -> the bf16 feature matrix
//   6. gemm + LayerNorm epilogue: out_transform, row mask, residual, LN1
//   7-9. gemm (+bias, ReLU) x2, gemm + LayerNorm epilogue: MLP and LN2
// Intermediates that go to device memory between launches: the projections,
// qa/ka/vvp, alpha (N, H, L, L as (Nc, L, reps*H, L)), the attention values,
// the feature matrix, x1 and the MLP hiddens. Fusing them away, wgmma, TMA
// and pipelined tiles are later work.
//
// Fixed head geometry (the DiffAb defaults): query/key width 32, value width
// 32, 8 query points, 8 value points, pair width 64, node width 128. The
// number of heads H (multiple of 4) and L (multiple of 16, at most 256) are
// runtime values. The Python wrapper (ops/gablock.py) checks all of this.
//
// S4, the fused-GABlock variant harness (scripts/micro_fused_variants.py,
// run_layer :165 over _gablock_kernel_v3 :48 and _gablock_kernel_abl :264),
// runs from this file too, through gablock_forward_variant(..., abl, rt);
// its wrappers are in ops/gablock_variants.py.
//   v3 (rt >= 1): step 3 is attn_rt_kernel, one block per (64 query rows,
//     head, rt replicas of one complex). The tile's bias rows are staged in
//     shared memory once and serve all rt replicas; each replica then runs
//     as in attn_kernel, alpha in the same layout for p2n. The script's
//     h-major (h*RT + r) alpha stack was a TPU lane layout, not kept.
//   abl (rt = 0): steps 2, 3 and 5 are templates on a mask of ABL_* bits
//     (if constexpr); skip_p2n and skip_mlp act on the host side (a launch
//     skipped, its columns zeroed), fake_feat swaps feat_kernel for a copy
//     kernel. Mask 0 is the code gablock_forward runs.
//   flag (script)   counterpart here
//   skip_p2n        p2n_kernel not launched; the p2n feature columns zero
//   fake_softmax    attn: alpha = bf16(0.01 (logits + bias)), no max/exp/sum
//   fake_alpha      attn: alpha = bf16(0.01 bias), no logits, no softmax
//   skip_rot        assemble without R, t; feat without R^T (. - t)
//   skip_mlp        the MLP GEMMs and LN2 not launched; out = x1
//   skip_sq         assemble: the |p|^2 slot takes the first H planar point
//                   columns (x of the operand's first H points)
//   fake_feat       feat_kernel not launched; fake_feat_kernel fills the
//                   H (VD + 7 NPV) non-p2n feature columns with
//                   [o | o[:, :H (VD + 7 NPV) - H SLOT]] over o's 64-wide
//                   slots (pad zero): a copy of the bytes feat_kernel moves
//   skip_values     attn: no alpha . V; o = the replica's own vvp rows
//   thin_ops        assemble: the point and |p|^2 slots of qa/ka and the
//                   point slots of vvp zero, the constant slots kept
//   skip_sect       none: the projection here is operand-major, so there is
//                   no section gather to drop (the baseline's mask)
//   skip_out, skip_wpts  none: the TPU body never reads them
//   floor           the seven flags skip_sq, skip_values, fake_feat,
//                   fake_alpha, skip_rot, skip_p2n, skip_mlp
// The entry takes the masks the harness uses: 0, each single bit, the floor.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int QK = 32;     // query/key channels per head
constexpr int VD = 32;     // value channels per head
constexpr int NP = 8;      // query/key points per head
constexpr int NPV = 8;     // value points per head
constexpr int CZ = 64;     // pair feature width
constexpr int FD = 128;    // node feature width
constexpr int SLOT = 64;   // per-head width of qa / ka / vvp
constexpr int KLD = SLOT + 8;  // smem leading dim of 64-wide bf16 tiles

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 tobf(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
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

// ------------------------------------------------------------------ GEMM
// C (M x ncols) = A (M x K) @ B (K x ncols), B row-major bf16. Block tile
// 64 x 128 x 32, 8 warps, each warp a 16 x 64 strip (4 accumulators).

constexpr int GBM = 64, GBN = 128, GBK = 32;
constexpr int GLDA = GBK + 8;
constexpr int GLDB = GBN + 8;
constexpr int GLDC = GBN + 4;

enum { EPI_BF16 = 0, EPI_LN = 1 };

struct Epi {
  const float* bias;       // (ncols), may be null for EPI_BF16
  int relu;                // EPI_BF16: apply ReLU after the bias
  bf16* out_bf16;          // EPI_BF16: output; EPI_LN: optional bf16 copy
  int ldo;                 // EPI_BF16 output leading dim
  const float* resid;      // EPI_LN: (M, FD) f32 residual
  const float* rowmask;    // EPI_LN: (M) row mask on (acc + bias), or null
  const float* ln;         // EPI_LN: gamma (FD) then beta (FD)
  float* out_f32;          // EPI_LN: (M, FD) f32 output
};

__device__ __forceinline__ void load_a_tile(bf16 (*As)[GLDA], const bf16* A,
                                            int lda, int M, int m0, int k0,
                                            int tid) {
  int r = tid >> 2, cc = (tid & 3) * 8;
  int gr = m0 + r;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (gr < M) v = *reinterpret_cast<const uint4*>(A + (size_t)gr * lda + k0 + cc);
  *reinterpret_cast<uint4*>(&As[r][cc]) = v;
}

__device__ __forceinline__ void load_a_tile(bf16 (*As)[GLDA], const float* A,
                                            int lda, int M, int m0, int k0,
                                            int tid) {
  int r = tid >> 2, cc = (tid & 3) * 8;
  int gr = m0 + r;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (gr < M) {
    const float4* p = reinterpret_cast<const float4*>(A + (size_t)gr * lda + k0 + cc);
    float4 a = p[0], b = p[1];
    v = make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
  }
  *reinterpret_cast<uint4*>(&As[r][cc]) = v;
}

template <typename TA, int EPI>
__global__ void __launch_bounds__(256)
gemm_kernel(const TA* __restrict__ A, int lda, const bf16* __restrict__ B,
            int ldb, int M, int K, Epi ep) {
  __shared__ __align__(128) bf16 As[GBM][GLDA];
  __shared__ __align__(128) bf16 Bs[GBK][GLDB];
  __shared__ __align__(128) float Cs[GBM][GLDC];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int wr = warp & 3, wc = warp >> 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += GBK) {
    load_a_tile(As, A, lda, M, m0, k0, tid);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int id = tid + 256 * s;
      int r = id >> 4, cc = (id & 15) * 8;
      *reinterpret_cast<uint4*>(&Bs[r][cc]) =
          *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * ldb + n0 + cc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &As[wr * 16][kk], GLDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &Bs[kk][wc * 64 + j * 16], GLDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(&Cs[wr * 16][wc * 64 + j * 16], acc[j], GLDC,
                            wmma::mem_row_major);
  __syncthreads();

  if (EPI == EPI_BF16) {
    for (int idx = tid; idx < GBM * GBN; idx += 256) {
      int r = idx / GBN, c = idx % GBN;
      int gr = m0 + r;
      if (gr >= M) continue;
      float v = Cs[r][c];
      if (ep.bias) v += ep.bias[n0 + c];
      if (ep.relu) v = fmaxf(v, 0.0f);
      ep.out_bf16[(size_t)gr * ep.ldo + n0 + c] = tobf(v);
    }
  } else {
    // One warp per row; the tile spans the whole FD = 128 wide row.
    for (int r = warp; r < GBM; r += 8) {
      int gr = m0 + r;
      if (gr >= M) continue;
      float mk = ep.rowmask ? ep.rowmask[gr] : 1.0f;
      float v[4], s = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int c = lane + 32 * q;
        v[q] = ep.resid[(size_t)gr * FD + c] + (Cs[r][c] + ep.bias[c]) * mk;
        s += v[q];
      }
      float mean = warp_sum(s) * (1.0f / FD);
      float s2 = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float d = v[q] - mean;
        s2 += d * d;
      }
      float rstd = rsqrtf(warp_sum(s2) * (1.0f / FD) + 1e-10f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int c = lane + 32 * q;
        float y = (v[q] - mean) * rstd * ep.ln[c] + ep.ln[FD + c];
        ep.out_f32[(size_t)gr * FD + c] = y;
        if (ep.out_bf16) ep.out_bf16[(size_t)gr * FD + c] = tobf(y);
      }
    }
  }
}

// ------------------------------------------------------------- ablations
// S4's phase-ablation bits (see the header); the bits each kernel reads.
enum : int {
  ABL_SKIP_P2N = 1 << 0,
  ABL_FAKE_SOFTMAX = 1 << 1,
  ABL_FAKE_ALPHA = 1 << 2,
  ABL_SKIP_ROT = 1 << 3,
  ABL_SKIP_MLP = 1 << 4,
  ABL_SKIP_SQ = 1 << 5,
  ABL_FAKE_FEAT = 1 << 6,
  ABL_SKIP_VALUES = 1 << 7,
  ABL_THIN_OPS = 1 << 8,
  ABL_FLOOR = ABL_SKIP_SQ | ABL_SKIP_VALUES | ABL_FAKE_FEAT | ABL_FAKE_ALPHA |
              ABL_SKIP_ROT | ABL_SKIP_P2N | ABL_SKIP_MLP,
  ABL_ASSEMBLE = ABL_SKIP_ROT | ABL_SKIP_SQ | ABL_THIN_OPS,
  ABL_ATTN = ABL_FAKE_SOFTMAX | ABL_FAKE_ALPHA | ABL_SKIP_VALUES,
  ABL_FEAT = ABL_SKIP_ROT,
};

// -------------------------------------------------------------- assemble
// One block per row (trajectory n, residue i). proj row layout:
// [q (H*QK) | k (H*QK) | v (H*VD) | qp | kp | vp], each point block planar
// ([x | y | z], head-major inside). Writes, per head h (64-wide slots):
//   qa = [q/sqrt(3*QK) | -2 c_h qp_g | c_h |qp_g|^2 | c_h | 0]
//   ka = [k            | kp_g        | 1            | |kp_g|^2 | 0]
//   vv = [v            | vp_g        | 0]
// so that qa . ka = the node + spatial logits, pre-scaled by 1/sqrt(3).
template <int ABL>
__global__ void __launch_bounds__(256)
assemble_kernel(const bf16* __restrict__ proj, int pw,
                const float* __restrict__ R9, const float* __restrict__ tr,
                const float* __restrict__ coef, int H, bf16* __restrict__ qa,
                bf16* __restrict__ ka, bf16* __restrict__ vv) {
  constexpr bool kThin = (ABL & ABL_THIN_OPS) != 0;
  extern __shared__ float smf[];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int HP = H * NP, HPV = H * NPV, npts = 2 * HP + HPV;
  float* g = smf;                 // (3, npts) global-frame points
  float* sq = smf + 3 * npts;     // (2, H) |qp|^2, |kp|^2 per head
  const bf16* pr = proj + (size_t)row * pw;
  float R[9], t[3];
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = R9[(size_t)row * 9 + e];
#pragma unroll
  for (int e = 0; e < 3; ++e) t[e] = tr[(size_t)row * 3 + e];

  const int pbase = H * (2 * QK + VD);
  if constexpr (!kThin) {
    for (int idx = tid; idx < npts; idx += blockDim.x) {
      int base, n, j;
      if (idx < HP) { base = pbase; n = HP; j = idx; }
      else if (idx < 2 * HP) { base = pbase + 3 * HP; n = HP; j = idx - HP; }
      else { base = pbase + 6 * HP; n = HPV; j = idx - 2 * HP; }
      float px = bf(pr[base + j]), py = bf(pr[base + n + j]), pz = bf(pr[base + 2 * n + j]);
      if constexpr ((ABL & ABL_SKIP_ROT) != 0) {
        g[idx] = px;
        g[npts + idx] = py;
        g[2 * npts + idx] = pz;
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          g[c * npts + idx] = R[3 * c] * px + R[3 * c + 1] * py + R[3 * c + 2] * pz + t[c];
      }
    }
    __syncthreads();
    if (tid < 2 * H) {
      int o = tid / H, h = tid % H;
      float s = 0.0f;
      if constexpr ((ABL & ABL_SKIP_SQ) != 0) {
        s = g[o * HP + h];        // x of the operand's h-th point
      } else {
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < NP; ++p) {
            float v = g[c * npts + o * HP + h * NP + p];
            s += v * v;
          }
      }
      sq[tid] = s;
    }
    __syncthreads();
  }

  const float s_node = 1.0f / sqrtf(3.0f * QK);
  const size_t ob = (size_t)row * H * SLOT;
  for (int idx = tid; idx < H * SLOT; idx += blockDim.x) {
    int h = idx / SLOT, d = idx % SLOT;
    float cf = coef[h];
    float a, b, v;
    if (d < QK) {
      a = bf(pr[h * QK + d]) * s_node;
      b = bf(pr[H * QK + h * QK + d]);
      v = bf(pr[2 * H * QK + h * VD + d]);
    } else if (d < QK + 3 * NP) {
      if constexpr (kThin) {
        a = 0.0f; b = 0.0f; v = 0.0f;
      } else {
        int e = d - QK, c = e / NP, p = e % NP;
        a = -2.0f * cf * g[c * npts + h * NP + p];
        b = g[c * npts + HP + h * NP + p];
        v = g[c * npts + 2 * HP + h * NPV + p];
      }
    } else if (d == QK + 3 * NP) {
      a = kThin ? 0.0f : cf * sq[h]; b = 1.0f; v = 0.0f;
    } else if (d == QK + 3 * NP + 1) {
      a = cf; b = kThin ? 0.0f : sq[H + h]; v = 0.0f;
    } else {
      a = 0.0f; b = 0.0f; v = 0.0f;
    }
    qa[ob + idx] = tobf(a);
    ka[ob + idx] = tobf(b);
    vv[ob + idx] = tobf(v);
  }
}

// ------------------------------------------------------------- attention
// One tile = (64 query rows from i0, head h, trajectory n), 4 warps x 16
// rows. Writes o (attention values, 64-wide slot per head) and alpha in the
// (Nc, L, reps*H, L) layout the p2n kernel reads row by row. brows points at
// the pair-bias row of query i0, the next rows bld elements apart (device
// memory in attn_kernel, shared memory in attn_rt_kernel).
constexpr int AQ = 64;

// Row stride (floats) of the attention block's logits buffer; it also holds
// the 64-wide alpha.vvp tile afterwards, so it is at least SLOT wide.
__host__ __device__ constexpr int attn_sld(int L) { return (L > SLOT ? L : SLOT) + 4; }

__host__ __device__ constexpr size_t attn_smem(int L) {
  return (size_t)2 * L * KLD * 2 + (size_t)AQ * KLD * 2 + (size_t)AQ * attn_sld(L) * 4 +
         (size_t)AQ * (L + 8) * 2;
}

// attn_rt_kernel also keeps the tile's (64, L) bias rows, (L + 8) apart.
__host__ __device__ constexpr size_t attn_rt_smem(int L) {
  return attn_smem(L) + (size_t)AQ * (L + 8) * 2;
}
// Both attention blocks fit a block's shared memory on sm_90 (232,448
// bytes) up to the largest L the wrapper takes (256), so L has no lower cap.
static_assert(attn_rt_smem(256) <= 232448, "attn_rt_kernel's plan exceeds sm_90");

template <int ABL>
__device__ __forceinline__ void attn_tile(
    const bf16* __restrict__ qa, const bf16* __restrict__ ka,
    const bf16* __restrict__ vv, const bf16* brows, int bld,
    bf16* __restrict__ o, bf16* __restrict__ alpha, int L, int H, int reps,
    int n, int h, int i0, unsigned char* smraw) {
  constexpr bool kFakeAlpha = (ABL & ABL_FAKE_ALPHA) != 0;
  const int SLD = attn_sld(L), PLD = L + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smraw);
  bf16* Vs = Ks + L * KLD;
  bf16* Qs = Vs + L * KLD;
  float* S = reinterpret_cast<float*>(Qs + AQ * KLD);
  bf16* Pm = reinterpret_cast<bf16*>(S + AQ * SLD);

  const int c = n / reps, rp = n % reps;
  const int HD = H * SLOT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int idx = tid; idx < L * 8; idx += blockDim.x) {
    int j = idx >> 3, cc = (idx & 7) * 8;
    size_t gsrc = ((size_t)n * L + j) * HD + h * SLOT + cc;
    *reinterpret_cast<uint4*>(&Ks[j * KLD + cc]) = *reinterpret_cast<const uint4*>(&ka[gsrc]);
    *reinterpret_cast<uint4*>(&Vs[j * KLD + cc]) = *reinterpret_cast<const uint4*>(&vv[gsrc]);
  }
  for (int idx = tid; idx < AQ * 8; idx += blockDim.x) {
    int r = idx >> 3, cc = (idx & 7) * 8, i = i0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (i < L) val = *reinterpret_cast<const uint4*>(&qa[((size_t)n * L + i) * HD + h * SLOT + cc]);
    *reinterpret_cast<uint4*>(&Qs[r * KLD + cc]) = val;
  }
  __syncthreads();

  const int wrow = warp * 16;
  if constexpr (!kFakeAlpha) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[SLOT / 16];
#pragma unroll
    for (int kk = 0; kk < SLOT / 16; ++kk)
      wmma::load_matrix_sync(qf[kk], Qs + wrow * KLD + kk * 16, KLD);
    for (int jt = 0; jt < L / 16; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < SLOT / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + jt * 16 * KLD + kk * 16, KLD);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(S + wrow * SLD + jt * 16, acc, SLD, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // Exact softmax over keys, f32; masked keys carry -1e5 in the bias.
  const size_t RH = (size_t)reps * H;
  for (int rr = 0; rr < 16; ++rr) {
    const int row = wrow + rr, i = i0 + row;
    float* srow = S + row * SLD;
    bf16* prow = Pm + row * PLD;
    if (i >= L) {
      for (int j = lane; j < L; j += 32) prow[j] = tobf(0.0f);
      continue;
    }
    const bf16* brow = brows + (size_t)row * bld;
    bf16* arow = alpha + (((size_t)c * L + i) * RH + (size_t)rp * H + h) * L;
    if constexpr ((ABL & (ABL_FAKE_ALPHA | ABL_FAKE_SOFTMAX)) != 0) {
      for (int j = lane; j < L; j += 32) {
        float v = bf(brow[j]);
        if constexpr (!kFakeAlpha) v += srow[j];
        bf16 a = tobf(0.01f * v);
        prow[j] = a;
        arow[j] = a;
      }
      continue;
    }
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      float v = srow[j] + bf(brow[j]);
      srow[j] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float s = 0.0f;
    for (int j = lane; j < L; j += 32) {
      float e = __expf(srow[j] - mx);
      srow[j] = e;
      s += e;
    }
    const float inv = 1.0f / warp_sum(s);
    for (int j = lane; j < L; j += 32) {
      bf16 a = tobf(srow[j] * inv);
      prow[j] = a;
      arow[j] = a;
    }
  }
  __syncwarp();

  if constexpr ((ABL & ABL_SKIP_VALUES) != 0) {
    for (int rr = 0; rr < 16; ++rr) {
      const int i = i0 + wrow + rr;
      if (i >= L) continue;
      bf16* dst = o + ((size_t)n * L + i) * HD + h * SLOT;
      for (int d = lane; d < SLOT; d += 32) dst[d] = Vs[i * KLD + d];
    }
    return;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[SLOT / 16];
#pragma unroll
  for (int j = 0; j < SLOT / 16; ++j) wmma::fill_fragment(oacc[j], 0.0f);
  for (int kt = 0; kt < L / 16; ++kt) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
    wmma::load_matrix_sync(pf, Pm + wrow * PLD + kt * 16, PLD);
#pragma unroll
    for (int j = 0; j < SLOT / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
      wmma::load_matrix_sync(vf, Vs + kt * 16 * KLD + j * 16, KLD);
      wmma::mma_sync(oacc[j], pf, vf, oacc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < SLOT / 16; ++j)
    wmma::store_matrix_sync(S + wrow * SLD + j * 16, oacc[j], SLD, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int i = i0 + wrow + rr;
    if (i >= L) continue;
    bf16* dst = o + ((size_t)n * L + i) * HD + h * SLOT;
    for (int d = lane; d < SLOT; d += 32) dst[d] = tobf(S[(wrow + rr) * SLD + d]);
  }
}

// Block = (64 query rows, head h, trajectory n); the bias rows come
// straight from device memory.
template <int ABL>
__global__ void __launch_bounds__(128)
attn_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
            const bf16* __restrict__ vv, const bf16* __restrict__ bias,
            bf16* __restrict__ o, bf16* __restrict__ alpha, int L, int H,
            int reps) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int n = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * AQ;
  const int c = n / reps;
  attn_tile<ABL>(qa, ka, vv, bias + (((size_t)c * H + h) * L + i0) * L, L, o,
                 alpha, L, H, reps, n, h, i0, smraw);
}

// S4's v3. Block = (64 query rows, head h, rt replicas of one complex from
// trajectory blockIdx.z * rt; rt divides reps): the tile's bias rows are
// staged once and serve every replica, which then runs as in attn_kernel.
__global__ void __launch_bounds__(128)
attn_rt_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
               const bf16* __restrict__ vv, const bf16* __restrict__ bias,
               bf16* __restrict__ o, bf16* __restrict__ alpha, int L, int H,
               int reps, int rt) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int BLD = L + 8;
  bf16* Bs = reinterpret_cast<bf16*>(smraw + attn_smem(L));
  const int n0 = blockIdx.z * rt, h = blockIdx.y, i0 = blockIdx.x * AQ;
  const bf16* bsrc = bias + ((size_t)(n0 / reps) * H + h) * L * L;
  const int chunks = L / 8;
  for (int idx = threadIdx.x; idx < AQ * chunks; idx += blockDim.x) {
    int r = idx / chunks, cc = (idx % chunks) * 8, i = i0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (i < L) val = *reinterpret_cast<const uint4*>(&bsrc[(size_t)i * L + cc]);
    *reinterpret_cast<uint4*>(&Bs[r * BLD + cc]) = val;
  }
  // attn_tile's barrier after its staging publishes Bs as well.
  for (int r = 0; r < rt; ++r) {
    if (r) __syncthreads();     // the previous replica's K, V are read
    attn_tile<0>(qa, ka, vv, Bs, BLD, o, alpha, L, H, reps, n0 + r, h, i0,
                 smraw);
  }
}

// ------------------------------------------------------------------- p2n
// Block = (64 of the reps*H alpha rows, query row i, complex c). z[c, i]
// (L x CZ) is staged once and shared by every replica and head of c.
constexpr int OLD = CZ + 4;

__global__ void __launch_bounds__(128)
p2n_kernel(const bf16* __restrict__ alpha, const bf16* __restrict__ z,
           bf16* __restrict__ feat, int ko, int L, int H, int reps) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int ALD = L + 8;
  bf16* Zs = reinterpret_cast<bf16*>(smraw);
  bf16* As = Zs + L * KLD;
  float* Os = reinterpret_cast<float*>(As + 64 * ALD);

  const int m0 = blockIdx.x * 64, i = blockIdx.y, c = blockIdx.z;
  const int RH = reps * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int idx = tid; idx < L * 8; idx += blockDim.x) {
    int j = idx >> 3, cc = (idx & 7) * 8;
    *reinterpret_cast<uint4*>(&Zs[j * KLD + cc]) =
        *reinterpret_cast<const uint4*>(&z[(((size_t)c * L + i) * L + j) * CZ + cc]);
  }
  const int chunks = L / 8;
  for (int idx = tid; idx < 64 * chunks; idx += blockDim.x) {
    int r = idx / chunks, cc = (idx % chunks) * 8, m = m0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m < RH)
      val = *reinterpret_cast<const uint4*>(&alpha[(((size_t)c * L + i) * RH + m) * L + cc]);
    *reinterpret_cast<uint4*>(&As[r * ALD + cc]) = val;
  }
  __syncthreads();

  const int wrow = warp * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CZ / 16];
#pragma unroll
  for (int j = 0; j < CZ / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int kt = 0; kt < L / 16; ++kt) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, As + wrow * ALD + kt * 16, ALD);
#pragma unroll
    for (int j = 0; j < CZ / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> zf;
      wmma::load_matrix_sync(zf, Zs + kt * 16 * KLD + j * 16, KLD);
      wmma::mma_sync(acc[j], af, zf, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < CZ / 16; ++j)
    wmma::store_matrix_sync(Os + wrow * OLD + j * 16, acc[j], OLD, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int m = m0 + wrow + rr;
    if (m >= RH) continue;
    const int n = c * reps + m / H, h = m % H;
    bf16* dst = feat + ((size_t)n * L + i) * ko + h * CZ;
    for (int d = lane; d < CZ; d += 32) dst[d] = tobf(Os[(wrow + rr) * OLD + d]);
  }
}

// ------------------------------------------------------------------ feat
// One block per row. Feature row layout (the module's planar out_transform
// rows): [p2n (H*CZ, written by p2n_kernel) | node (H*VD) | points local
// [x|y|z] (3*H*NPV) | distance (H*NPV) | direction [x|y|z] (3*H*NPV)].
template <int ABL>
__global__ void __launch_bounds__(128)
feat_kernel(const bf16* __restrict__ o, const float* __restrict__ R9,
            const float* __restrict__ tr, bf16* __restrict__ feat, int ko,
            int H) {
  const int row = blockIdx.x, tid = threadIdx.x;
  float R[9], t[3];
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = R9[(size_t)row * 9 + e];
#pragma unroll
  for (int e = 0; e < 3; ++e) t[e] = tr[(size_t)row * 3 + e];
  const bf16* orow = o + (size_t)row * H * SLOT;
  bf16* frow = feat + (size_t)row * ko;
  const int HPV = H * NPV;
  const int b0 = H * CZ, b1 = b0 + H * VD, b2 = b1 + 3 * HPV, b3 = b2 + HPV;
  for (int idx = tid; idx < H * VD; idx += blockDim.x)
    frow[b0 + idx] = orow[(idx / VD) * SLOT + idx % VD];
  for (int idx = tid; idx < HPV; idx += blockDim.x) {
    const int h = idx / NPV, p = idx % NPV;
    const bf16* pt = orow + h * SLOT + VD + p;
    float l[3];
    if constexpr ((ABL & ABL_SKIP_ROT) != 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) l[c] = bf(pt[c * NPV]);
    } else {
      float d0 = bf(pt[0]) - t[0], d1 = bf(pt[NPV]) - t[1], d2 = bf(pt[2 * NPV]) - t[2];
#pragma unroll
      for (int c = 0; c < 3; ++c) l[c] = R[c] * d0 + R[3 + c] * d1 + R[6 + c] * d2;
    }
    float ss = l[0] * l[0] + l[1] * l[1] + l[2] * l[2];
    float inv = 1.0f / (sqrtf(ss + 1e-8f) + 1e-4f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      frow[b1 + c * HPV + idx] = tobf(l[c]);
      frow[b3 + c * HPV + idx] = tobf(l[c] * inv);
    }
    frow[b2 + idx] = tobf(sqrtf(ss + 1e-12f));
  }
}

// S4's fake_feat: the rest = ko - H*CZ feature columns of each row take
// [o | o[:, :rest - H*SLOT]], 16 bytes a thread, read and written in order
// (ko, H*CZ and H*SLOT are multiples of 8 elements, as rest is).
__global__ void __launch_bounds__(256)
fake_feat_kernel(const bf16* __restrict__ o, bf16* __restrict__ feat,
                 size_t vecs, int ko, int H) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= vecs) return;
  const int ov = H * SLOT / 8, fv = (ko - H * CZ) / 8;
  const size_t row = idx / fv;
  const int v = (int)(idx % fv);
  const uint4* src = reinterpret_cast<const uint4*>(o + row * H * SLOT);
  uint4* dst = reinterpret_cast<uint4*>(feat + row * ko + H * CZ);
  dst[v] = src[v < ov ? v : v - ov];
}

// ------------------------------------------------------------- host side

size_t align_up(size_t b) { return (b + 255) & ~(size_t)255; }

struct Workspace {
  bf16 *proj, *qa, *ka, *vv, *alpha, *o, *feat, *x1b, *h1, *h2;
  float* x1;
};

size_t carve(unsigned char* base, int N, int L, int H, int pw, int ko,
             Workspace* w) {
  const size_t M = (size_t)N * L, HD = (size_t)H * SLOT;
  const size_t sizes[11] = {
      M * pw * 2, M * HD * 2, M * HD * 2, M * HD * 2, (size_t)N * H * L * L * 2,
      M * HD * 2, M * ko * 2, M * FD * 2, M * FD * 2, M * FD * 2, M * FD * 4};
  void** slots[11] = {(void**)&w->proj, (void**)&w->qa, (void**)&w->ka,
                      (void**)&w->vv, (void**)&w->alpha, (void**)&w->o,
                      (void**)&w->feat, (void**)&w->x1b, (void**)&w->h1,
                      (void**)&w->h2, (void**)&w->x1};
  size_t off = 0;
  for (int s = 0; s < 11; ++s) {
    if (base) *slots[s] = base + off;
    off += align_up(sizes[s]);
  }
  return off;
}

size_t p2n_smem(int L) {
  return (size_t)L * KLD * 2 + (size_t)64 * (L + 8) * 2 + (size_t)64 * OLD * 4;
}

// The arguments of one layer (gablock_forward's, in its order).
struct LayerArgs {
  const float *x, *R9, *t;
  const bf16 *z, *bias;
  const float* mask;
  const bf16* w_proj;
  int pw;
  const float* coef;
  const bf16* w_out;
  int ko;
  const float *b_out, *ln1;
  const bf16 *w_m1, *w_m2, *w_m3;
  const float *b_m, *ln2;
  float* out;
  void* workspace;
  int N, L, H, reps;
  cudaStream_t stream;
};

// One layer with the ablation mask ABL (0: the layer itself); rt >= 1 runs
// the attention as attn_rt_kernel over rt replicas (S4's v3).
template <int ABL>
int forward_impl(const LayerArgs& a, int rt) {
  cudaStream_t stream = a.stream;
  const int N = a.N, L = a.L, H = a.H, reps = a.reps, pw = a.pw, ko = a.ko;
  Workspace w;
  carve(reinterpret_cast<unsigned char*>(a.workspace), N, L, H, pw, ko, &w);
  const int M = N * L, Nc = N / reps;
  const int mt = (M + GBM - 1) / GBM;
  cudaError_t err;
#define GB_CHECK()                                  \
  do {                                              \
    err = cudaGetLastError();                       \
    if (err != cudaSuccess) return (int)err;        \
  } while (0)

  Epi ep = {};
  ep.out_bf16 = w.proj;
  ep.ldo = pw;
  gemm_kernel<float, EPI_BF16><<<dim3(pw / GBN, mt), 256, 0, stream>>>(
      a.x, FD, a.w_proj, pw, M, FD, ep);
  GB_CHECK();

  const int npts = 2 * H * NP + H * NPV;
  assemble_kernel<ABL & ABL_ASSEMBLE><<<M, 256, (3 * npts + 2 * H) * sizeof(float), stream>>>(
      w.proj, pw, a.R9, a.t, a.coef, H, w.qa, w.ka, w.vv);
  GB_CHECK();

  const dim3 attn_grid((L + AQ - 1) / AQ, H, rt > 0 ? N / rt : N);
  if (rt > 0) {
    const size_t bytes = attn_rt_smem(L);
    cudaFuncSetAttribute(attn_rt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    GB_CHECK();
    attn_rt_kernel<<<attn_grid, 128, bytes, stream>>>(
        w.qa, w.ka, w.vv, a.bias, w.o, w.alpha, L, H, reps, rt);
  } else {
    const size_t bytes = attn_smem(L);
    cudaFuncSetAttribute(attn_kernel<ABL & ABL_ATTN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    GB_CHECK();
    attn_kernel<ABL & ABL_ATTN><<<attn_grid, 128, bytes, stream>>>(
        w.qa, w.ka, w.vv, a.bias, w.o, w.alpha, L, H, reps);
  }
  GB_CHECK();

  if constexpr ((ABL & ABL_SKIP_P2N) != 0) {
    err = cudaMemset2DAsync(w.feat, (size_t)ko * 2, 0, (size_t)H * CZ * 2, M, stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    const size_t p2n_bytes = p2n_smem(L);
    cudaFuncSetAttribute(p2n_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)p2n_bytes);
    GB_CHECK();
    p2n_kernel<<<dim3((reps * H + 63) / 64, L, Nc), 128, p2n_bytes, stream>>>(
        w.alpha, a.z, w.feat, ko, L, H, reps);
    GB_CHECK();
  }

  if constexpr ((ABL & ABL_FAKE_FEAT) != 0) {
    const size_t vecs = (size_t)M * (ko - H * CZ) / 8;
    fake_feat_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, stream>>>(
        w.o, w.feat, vecs, ko, H);
    GB_CHECK();
  } else {
    feat_kernel<ABL & ABL_FEAT><<<M, 128, 0, stream>>>(w.o, a.R9, a.t, w.feat, ko, H);
    GB_CHECK();
  }

  constexpr bool kSkipMlp = (ABL & ABL_SKIP_MLP) != 0;
  ep = Epi{};
  ep.bias = a.b_out;
  ep.resid = a.x;
  ep.rowmask = a.mask;
  ep.ln = a.ln1;
  ep.out_f32 = kSkipMlp ? a.out : w.x1;
  ep.out_bf16 = kSkipMlp ? nullptr : w.x1b;
  gemm_kernel<bf16, EPI_LN><<<dim3(1, mt), 256, 0, stream>>>(w.feat, ko, a.w_out,
                                                             FD, M, ko, ep);
  GB_CHECK();
  if constexpr (kSkipMlp) return 0;

  ep = Epi{};
  ep.bias = a.b_m;
  ep.relu = 1;
  ep.out_bf16 = w.h1;
  ep.ldo = FD;
  gemm_kernel<bf16, EPI_BF16><<<dim3(1, mt), 256, 0, stream>>>(w.x1b, FD, a.w_m1,
                                                               FD, M, FD, ep);
  GB_CHECK();
  ep.bias = a.b_m + FD;
  ep.out_bf16 = w.h2;
  gemm_kernel<bf16, EPI_BF16><<<dim3(1, mt), 256, 0, stream>>>(w.h1, FD, a.w_m2,
                                                               FD, M, FD, ep);
  GB_CHECK();

  ep = Epi{};
  ep.bias = a.b_m + 2 * FD;
  ep.resid = w.x1;
  ep.ln = a.ln2;
  ep.out_f32 = a.out;
  gemm_kernel<bf16, EPI_LN><<<dim3(1, mt), 256, 0, stream>>>(w.h2, FD, a.w_m3, FD,
                                                             M, FD, ep);
  GB_CHECK();
#undef GB_CHECK
  return 0;
}

}  // namespace

extern "C" size_t gablock_workspace_bytes(int N, int L, int H, int pw, int ko) {
  Workspace w;
  return carve(nullptr, N, L, H, pw, ko, &w);
}

#define GB_LAYER_PARAMS                                                       \
  const float *x, const float *R9, const float *t, const bf16 *z,             \
      const bf16 *bias, const float *mask, const bf16 *w_proj, int pw,        \
      const float *coef, const bf16 *w_out, int ko, const float *b_out,       \
      const float *ln1, const bf16 *w_m1, const bf16 *w_m2, const bf16 *w_m3, \
      const float *b_m, const float *ln2, float *out, void *workspace, int N, \
      int L, int H, int reps, void *stream_ptr
#define GB_LAYER_ARGS                                                         \
  LayerArgs{x, R9, t, z, bias, mask, w_proj, pw, coef, w_out, ko, b_out, ln1, \
            w_m1, w_m2, w_m3, b_m, ln2, out, workspace, N, L, H, reps,        \
            reinterpret_cast<cudaStream_t>(stream_ptr)}

// Runs one GABlock layer on `stream`. Returns the first non-zero
// cudaGetLastError() after a launch (0 when every launch was accepted).
extern "C" int gablock_forward(GB_LAYER_PARAMS) {
  return forward_impl<0>(GB_LAYER_ARGS, 0);
}

// S4: one layer as gablock_forward, with the ablation mask `abl` (a mask the
// switch lists) or, with abl = 0 and rt >= 1 dividing reps, v3's attention
// over rt replicas. Anything else returns cudaErrorInvalidValue.
extern "C" int gablock_forward_variant(GB_LAYER_PARAMS, int abl, int rt) {
  const LayerArgs a = GB_LAYER_ARGS;
  if (rt < 0 || (rt > 0 && (abl != 0 || reps % rt != 0)))
    return (int)cudaErrorInvalidValue;
  switch (abl) {
#define GB_CASE(m) \
  case m:          \
    return forward_impl<m>(a, rt);
    GB_CASE(0)
    GB_CASE(ABL_SKIP_P2N)
    GB_CASE(ABL_FAKE_SOFTMAX)
    GB_CASE(ABL_FAKE_ALPHA)
    GB_CASE(ABL_SKIP_ROT)
    GB_CASE(ABL_SKIP_MLP)
    GB_CASE(ABL_SKIP_SQ)
    GB_CASE(ABL_FAKE_FEAT)
    GB_CASE(ABL_SKIP_VALUES)
    GB_CASE(ABL_THIN_OPS)
    GB_CASE(ABL_FLOOR)
#undef GB_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gablock_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
