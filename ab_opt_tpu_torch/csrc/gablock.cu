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
// ~53 GFLOP with plain projections (the TPU kernel's folded fast-weight form
// is ~110 GFLOP, its operand matrices mostly zeros, so the folding is not
// carried over). z is 2 MB bf16 per complex and shared by all replicas of
// that complex; the per-complex pair bias is (H, L, L) bf16. Every product
// runs on the tensor cores, so the layer is bounded by how well those tiles
// are fed and by ~1 GB of intermediate traffic between launches, not by HBM
// reads of z or of the weights. Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 3): 0.73 ms per layer at N = 256, L = 128, the
// layer's earlier design (S4's baseline below) 1.42 ms in the same run.
//
// K1's launches (gablock_forward, the layer's only entry), each a thin
// __global__ wrapper over a tile of k1_tiles.cuh (which K5's persistent
// chain, csrc/gablock_chain.cu, runs as work items):
//   1. k1_proj_kernel (proj_tile): proj = x @ [Wq|Wk|Wv|Wqp|Wkp|Wvp]. A
//      block keeps its 128 x 128 row-block of x resident in shared memory
//      (f32 -> bf16 once) and streams the weight's 128-column tiles past it
//      through a two-stage cp.async ring into wgmma m64n128k16 (two
//      warpgroups, two blocks an SM).
//   2. k1_assemble_kernel (assemble_row): rotate q/k/v points to the global
//      frame (f32 R, t), |p|^2 per head, write qa/ka/vvp in 64-wide
//      per-head slots
//   3. k1_attn_kernel (k1_attn_tile): one block per (query tile, head,
//      group of rt replicas of one complex; rt the largest of 4, 2, 1 that
//      divides reps). The tile's bias rows are staged in shared memory once
//      (16-byte cp.async) and serve all rt replicas; each replica's K, V and
//      Q tiles arrive by cp.async into a ring of two or three stages, the
//      next replicas loading while the current one computes. Logits come
//      from mma.sync m16n8k16 and stay in registers (a whole key row, L <=
//      256); + bias[n // reps], the exact max-subtract softmax in f32 with
//      quad shuffles, alpha packed to bf16 pairs that are both the A operand
//      of alpha . vvp and, through a 16-row staging tile, 16-byte stores of
//      alpha in the (Nc, L, reps*H, L) layout p2n reads; o leaves the same
//      way.
//   4. k1_p2n_kernel (p2n_tile): per (complex, query row i): z[c, i] (L x
//      Cz) is loaded once and multiplied by the alpha rows of ALL replicas
//      and heads of that complex (M = reps * H), written straight into the
//      feature matrix
//   5. k1_feat_kernel (feat_row): global->local rotation of the aggregated
//      points, distance and direction, node values -> the bf16 feature
//      matrix
//   6-9. k1_gemm_kernel (gemm_tile: 64 x 128 tiles a warpgroup, two
//      warpgroups a block sharing each B chunk where the blocks fill the
//      SMs; K streamed in 64-wide chunks through a three-stage cp.async ring
//      into wgmma): out_transform + row mask + residual + LN1, MLP1 and MLP2
//      (bias, ReLU), MLP3 + LN2. The LN epilogue holds a whole 128-wide row
//      in one tile and reduces it in registers.
// Both GEMM kernels take the weight transposed (N x K, K contiguous: the
// bundle's w_*_t), so A and B reach wgmma K-major with the 128-byte swizzle,
// written by cp.async at the swizzled address.
// Intermediates that go to device memory between launches: the projections,
// qa/ka/vvp, alpha (N, H, L, L as (Nc, L, reps*H, L)), the attention values,
// the feature matrix, x1 and the MLP hiddens. Launches 3, 4 and 6-9 also
// run alone (gablock_attention, gablock_p2n, gablock_gemm), for tests and
// for the checks of K4 and S1, which run the same tiles.

// Fixed head geometry (the DiffAb defaults): query/key width 32, value width
// 32, 8 query points, 8 value points, pair width 64, node width 128. The
// number of heads H (multiple of 4) and L (multiple of 16, at most 256) are
// runtime values. The Python wrapper (ops/gablock.py) checks all of this.
//
// S4, the fused-GABlock variant harness (scripts/micro_fused_variants.py,
// run_layer :165 over _gablock_kernel_v3 :48 and _gablock_kernel_abl :264),
// runs from this file too, through gablock_forward_variant(..., abl, rt);
// its wrappers are in ops/gablock_variants.py. It runs the layer's earlier
// design, forward_impl<ABL> (gemm_kernel, WMMA m16n16k16 with synchronous
// loads; attn_kernel, one block per (64 query rows, head, trajectory), the
// logits through a float32 shared-memory tile and 2-byte alpha stores), so
// its ablations price that design and its mask 0 is the "before" of K1.
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

#include "k1_tiles.cuh"

namespace {

// ------------------------------------------------------------------ GEMM
// C (M x ncols) = A (M x K) @ B (K x ncols), B row-major bf16. Block tile
// 64 x 128 x 32, 8 warps, each warp a 16 x 64 strip (4 accumulators).

constexpr int GBM = 64, GBN = 128, GBK = 32;
constexpr int GLDA = GBK + 8;
constexpr int GLDB = GBN + 8;
constexpr int GLDC = GBN + 4;

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

// ------------------------------------------------------- K1's launches
// Thin __global__ wrappers over the tiles of k1_tiles.cuh, one tile (or
// row) a block; the grids are K1's since PR 8.

// One row per block of 256 threads.
__global__ void __launch_bounds__(256)
k1_assemble_kernel(const bf16* __restrict__ proj, int pw, const float* __restrict__ R9,
                   const float* __restrict__ tr, const float* __restrict__ coef, int H,
                   bf16* __restrict__ qa, bf16* __restrict__ ka, bf16* __restrict__ vv) {
  extern __shared__ float smf[];
  const size_t row = blockIdx.x;
  assemble_row<256>(row, threadIdx.x, proj + row * pw, R9 + row * 9, tr + row * 3, coef, H, qa,
                    ka, vv, smf);
}

// Block = (query tile, head h, replicas blockIdx.z * rt .. + rt - 1).
template <class Plan>
__global__ void __launch_bounds__(Plan::QW * 32, 1)
k1_attn_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
               const bf16* __restrict__ vv, const bf16* __restrict__ bias,
               bf16* __restrict__ o, bf16* __restrict__ alpha, int L, int H,
               int reps, int rt) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int h = blockIdx.y, n0 = blockIdx.z * rt;
  k1_attn_tile<Plan>(blockIdx.x * Plan::QT, h, n0, rt, qa, ka, vv,
                     bias + ((size_t)(n0 / reps) * H + h) * L * L, o, alpha, L, H, reps,
                     smraw);
}

// Block = (64 of the reps*H alpha rows, query row i, complex c).
__global__ void __launch_bounds__(128)
k1_p2n_kernel(const bf16* __restrict__ alpha, const bf16* __restrict__ z,
              bf16* __restrict__ feat, int ko, int L, int H, int reps) {
  extern __shared__ __align__(128) unsigned char smraw[];
  p2n_tile<128>(blockIdx.x * 64, blockIdx.y, blockIdx.z, alpha, z, feat, ko, L, H, reps, smraw);
}

// One row per block of 128 threads.
__global__ void __launch_bounds__(128)
k1_feat_kernel(const bf16* __restrict__ o, const float* __restrict__ R9,
               const float* __restrict__ tr, bf16* __restrict__ feat, int ko, int H) {
  const size_t row = blockIdx.x;
  feat_row<128>(row, threadIdx.x, o + row * H * SLOT, R9 + row * 9, tr + row * 3, feat, ko, H);
}

// Block = 128 rows x the column tiles [t0, t1) of 128; grid (row blocks,
// column splits).
__global__ void __launch_bounds__(256, 2)
k1_proj_kernel(const float* __restrict__ X, const bf16* __restrict__ Bt, int M, int N,
               int tiles_per_block, Epi ep) {
  extern __shared__ unsigned char smraw[];
  const int t0 = blockIdx.y * tiles_per_block;
  proj_tile(blockIdx.x * 128, t0, min(t0 + tiles_per_block, N / WN), X, Bt, M, N, ep, smraw);
}

// Block = 64 WG rows, WG warpgroups.
template <int EPI, int WG>
__global__ void __launch_bounds__(128 * WG)
k1_gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ Bt, int M,
               int K, Epi ep) {
  extern __shared__ unsigned char smraw[];
  gemm_tile<EPI, WG>(blockIdx.x * 64 * WG, A, lda, Bt, M, K, ep, smraw);
}

// ------------------------------------------------------------- host side


// The arguments of one layer (gablock_forward's, in its order). The weight
// matrices w_proj, w_out and w_m1..3 are (K, N) for forward_impl and
// transposed, (N, K), for forward_k1.
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
    const size_t p2n_bytes = p2n_smem(L, 64);
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

// ------------------------------------------------------- K1's launches

// rt: the replicas an attention block serves (>= 1, dividing reps; the
// wrapper passes the largest of 4, 2, 1 that divides reps).
template <class Plan>
cudaError_t launch_attn(const bf16* qa, const bf16* ka, const bf16* vv, const bf16* bias,
                        bf16* o, bf16* alpha, int N, int L, int H, int reps, int rt,
                        cudaStream_t stream) {
  if (rt < 1 || reps % rt != 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      k1_attn_kernel<Plan>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Plan::smem(L));
  if (err != cudaSuccess) return err;
  k1_attn_kernel<Plan>
      <<<dim3((L + Plan::QT - 1) / Plan::QT, H, N / rt), Plan::QW * 32, Plan::smem(L), stream>>>(
          qa, ka, vv, bias, o, alpha, L, H, reps, rt);
  return cudaGetLastError();
}

cudaError_t launch_k1_attention(const bf16* qa, const bf16* ka, const bf16* vv,
                                const bf16* bias, bf16* o, bf16* alpha, int N, int L, int H,
                                int reps, int rt, cudaStream_t stream) {
  if (L <= 128)
    return launch_attn<AttnSmall>(qa, ka, vv, bias, o, alpha, N, L, H, reps, rt, stream);
  return launch_attn<AttnLarge>(qa, ka, vv, bias, o, alpha, N, L, H, reps, rt, stream);
}

// p2n into the feature rows (pitch ko): a block per (64 alpha rows, query
// row, complex).
cudaError_t launch_k1_p2n(const bf16* alpha, const bf16* z, bf16* feat, int ko, int Nc, int L,
                          int H, int reps, cudaStream_t stream) {
  const size_t bytes = p2n_smem(L, 64);
  const cudaError_t err = cudaFuncSetAttribute(
      k1_p2n_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  k1_p2n_kernel<<<dim3((reps * H + 63) / 64, L, Nc), 128, bytes, stream>>>(alpha, z, feat, ko,
                                                                          L, H, reps);
  return cudaGetLastError();
}

// The projection: 128-row blocks, the column tiles split so that the grid
// covers the SMs at small M (x is then converted once per split).
cudaError_t launch_k1_proj(const float* x, const bf16* bt, int M, int N, const Epi& ep,
                           cudaStream_t stream) {
  const int mb = (M + 127) / 128, tiles = N / WN, sms = num_sms();
  const int split = max(1, min(tiles, (sms + mb - 1) / mb));
  const int per = (tiles + split - 1) / split;
  const cudaError_t err = cudaFuncSetAttribute(
      k1_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PROJ_SMEM);
  if (err != cudaSuccess) return err;
  k1_proj_kernel<<<dim3(mb, (tiles + per - 1) / per), 256, PROJ_SMEM, stream>>>(x, bt, M, N,
                                                                               per, ep);
  return cudaGetLastError();
}

template <int EPI, int WG>
cudaError_t launch_gemm_wg(const bf16* A, int lda, const bf16* bt, int M, int K, const Epi& ep,
                           cudaStream_t stream) {
  const size_t bytes = gemm_smem(WG);
  const cudaError_t err = cudaFuncSetAttribute(
      k1_gemm_kernel<EPI, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  k1_gemm_kernel<EPI, WG><<<(M + 64 * WG - 1) / (64 * WG), 128 * WG, bytes, stream>>>(
      A, lda, bt, M, K, ep);
  return cudaGetLastError();
}

// Two warpgroups a block where the 128-row blocks cover the SMs, else one.
template <int EPI>
cudaError_t launch_k1_gemm(const bf16* A, int lda, const bf16* bt, int M, int K, const Epi& ep,
                           cudaStream_t stream) {
  if ((M + 127) / 128 >= num_sms()) return launch_gemm_wg<EPI, 2>(A, lda, bt, M, K, ep, stream);
  return launch_gemm_wg<EPI, 1>(A, lda, bt, M, K, ep, stream);
}

// K1: one layer through the launches in the header's list (the weights
// transposed, see LayerArgs); rt as launch_attn takes it.
int forward_k1(const LayerArgs& a, int rt) {
  cudaStream_t stream = a.stream;
  const int N = a.N, L = a.L, H = a.H, reps = a.reps, pw = a.pw, ko = a.ko;
  Workspace w;
  carve(reinterpret_cast<unsigned char*>(a.workspace), N, L, H, pw, ko, &w);
  const int M = N * L, Nc = N / reps;
  cudaError_t err;
#define K1_CHECK(call)                       \
  do {                                       \
    err = (call);                            \
    if (err != cudaSuccess) return (int)err; \
  } while (0)

  Epi ep = {};
  ep.out_bf16 = w.proj;
  ep.ldo = pw;
  K1_CHECK(launch_k1_proj(a.x, a.w_proj, M, pw, ep, stream));

  k1_assemble_kernel<<<M, 256, assemble_floats(H) * sizeof(float), stream>>>(
      w.proj, pw, a.R9, a.t, a.coef, H, w.qa, w.ka, w.vv);
  K1_CHECK(cudaGetLastError());

  K1_CHECK(
      launch_k1_attention(w.qa, w.ka, w.vv, a.bias, w.o, w.alpha, N, L, H, reps, rt, stream));

  K1_CHECK(launch_k1_p2n(w.alpha, a.z, w.feat, ko, Nc, L, H, reps, stream));
  k1_feat_kernel<<<M, 128, 0, stream>>>(w.o, a.R9, a.t, w.feat, ko, H);
  K1_CHECK(cudaGetLastError());

  ep = Epi{};
  ep.bias = a.b_out;
  ep.resid = a.x;
  ep.rowmask = a.mask;
  ep.ln = a.ln1;
  ep.out_f32 = w.x1;
  ep.out_bf16 = w.x1b;
  K1_CHECK(launch_k1_gemm<EPI_LN>(w.feat, ko, a.w_out, M, ko, ep, stream));

  ep = Epi{};
  ep.bias = a.b_m;
  ep.relu = 1;
  ep.out_bf16 = w.h1;
  ep.ldo = FD;
  K1_CHECK(launch_k1_gemm<EPI_BF16>(w.x1b, FD, a.w_m1, M, FD, ep, stream));
  ep.bias = a.b_m + FD;
  ep.out_bf16 = w.h2;
  K1_CHECK(launch_k1_gemm<EPI_BF16>(w.h1, FD, a.w_m2, M, FD, ep, stream));

  ep = Epi{};
  ep.bias = a.b_m + 2 * FD;
  ep.resid = w.x1;
  ep.ln = a.ln2;
  ep.out_f32 = a.out;
  K1_CHECK(launch_k1_gemm<EPI_LN>(w.h2, FD, a.w_m3, M, FD, ep, stream));
#undef K1_CHECK
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

// K1: runs one GABlock layer on `stream`, the weight matrices transposed
// (w_proj (pw, F), w_out (F, ko), w_m* (F, F) as (N, K)), the attention in
// blocks of rt replicas (rt >= 1 divides reps). Returns the first non-zero
// error after a launch (0 when every launch was accepted).
extern "C" int gablock_forward(GB_LAYER_PARAMS, int rt) {
  return forward_k1(GB_LAYER_ARGS, rt);
}

// K1's attention launch alone: o (N, L, H*64) and alpha (Nc, L, reps*H, L)
// from qa/ka/vv (N, L, H*64) and bias (Nc, H, L, L), all bf16; rt as
// gablock_forward takes it.
extern "C" int gablock_attention(const bf16* qa, const bf16* ka, const bf16* vv,
                                 const bf16* bias, bf16* o, bf16* alpha, int N, int L, int H,
                                 int reps, int rt, void* stream_ptr) {
  if (L % 16 != 0 || L < 16 || L > 256 || reps < 1 || N % reps != 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_k1_attention(qa, ka, vv, bias, o, alpha, N, L, H, reps, rt,
                                  reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K1's p2n launch alone: p2n (N, L, H, 64), the feature rows' p2n columns
// at the pitch H * 64, from alpha (Nc, L, reps*H, L) and z (Nc, L, L, 64).
extern "C" int gablock_p2n(const bf16* alpha, const bf16* z, bf16* p2n, int N, int L, int H,
                           int reps, void* stream_ptr) {
  if (L % 16 != 0 || L < 16 || L > 256 || reps < 1 || N % reps != 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_k1_p2n(alpha, z, p2n, H * CZ, N / reps, L, H, reps,
                            reinterpret_cast<cudaStream_t>(stream_ptr));
}

// K1's GEMM alone, out = epilogue(A . bt^T) with bt (N, K): a_f32 = 1 is the
// projection (A f32 (M, 128), N a multiple of 128, bf16 out (M, N), bias and
// relu optional); otherwise A bf16 (M, K), N = 128, and ln (gamma, beta)
// null for the bf16 epilogue (bias, relu) or set for the LayerNorm one
// (bias, resid, rowmask optional; out_f32 and optionally out_bf16).
extern "C" int gablock_gemm(const void* A, int a_f32, const bf16* bt, int M, int K, int N,
                            const float* bias, int relu, const float* resid,
                            const float* rowmask, const float* ln, float* out_f32,
                            bf16* out_bf16, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  Epi ep = {};
  ep.bias = bias;
  ep.relu = relu;
  ep.out_bf16 = out_bf16;
  ep.ldo = N;
  ep.resid = resid;
  ep.rowmask = rowmask;
  ep.ln = ln;
  ep.out_f32 = out_f32;
  if (M < 1 || K < 8 || K % 8 != 0) return (int)cudaErrorInvalidValue;
  if (a_f32) {
    if (K != FD || N % WN != 0 || ln || !out_bf16) return (int)cudaErrorInvalidValue;
    return (int)launch_k1_proj(static_cast<const float*>(A), bt, M, N, ep, stream);
  }
  if (N != FD) return (int)cudaErrorInvalidValue;
  const bf16* a = static_cast<const bf16*>(A);
  if (ln) {
    if (!bias || !resid || !out_f32) return (int)cudaErrorInvalidValue;
    return (int)launch_k1_gemm<EPI_LN>(a, K, bt, M, K, ep, stream);
  }
  if (!out_bf16) return (int)cudaErrorInvalidValue;
  return (int)launch_k1_gemm<EPI_BF16>(a, K, bt, M, K, ep, stream);
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
