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
// K1's launches (gablock_forward, the layer's only entry):
//   1. k1_proj_kernel: proj = x @ [Wq|Wk|Wv|Wqp|Wkp|Wvp]. A block keeps its
//      128 x 128 row-block of x resident in shared memory (f32 -> bf16 once)
//      and streams the weight's 128-column tiles past it through a
//      two-stage cp.async ring into wgmma m64n128k16 (two warpgroups, two
//      blocks an SM).
//   2. assemble_kernel: rotate q/k/v points to the global frame (f32 R, t),
//      |p|^2 per head, write qa/ka/vvp in 64-wide per-head slots
//   3. k1_attn_kernel: one block per (query tile, head, group of rt replicas
//      of one complex; rt the largest of 4, 2, 1 that divides reps). The
//      tile's bias rows are staged in shared memory once (16-byte cp.async)
//      and serve all rt replicas; each replica's K, V and Q tiles arrive by
//      cp.async into a ring of two or three stages, the next replicas
//      loading while the current one computes. Logits come from mma.sync
//      m16n8k16 and stay in registers (a whole key row, L <= 256);
//      + bias[n // reps], the exact
//      max-subtract softmax in f32 with quad shuffles, alpha packed to bf16
//      pairs that are both the A operand of alpha . vvp and, through a
//      16-row staging tile, 16-byte stores of alpha in the (Nc, L, reps*H,
//      L) layout p2n reads; o leaves the same way.
//   4. p2n_kernel: per (complex, query row i): z[c, i] (L x Cz) is loaded
//      once and multiplied by the alpha rows of ALL replicas and heads of
//      that complex (M = reps * H), written straight into the feature matrix
//   5. feat_kernel: global->local rotation of the aggregated points,
//      distance and direction, node values -> the bf16 feature matrix
//   6-9. k1_gemm_kernel (64 x 128 tiles a warpgroup, two warpgroups a
//      block sharing each B chunk where the blocks fill the SMs; K
//      streamed in 64-wide chunks through a three-stage cp.async ring into
//      wgmma): out_transform + row mask + residual + LN1, MLP1 and MLP2
//      (bias, ReLU), MLP3 + LN2. The LN epilogue holds a whole 128-wide row
//      in one tile and reduces it in registers.
// Both GEMM kernels take the weight transposed (N x K, K contiguous: the
// bundle's w_*_t), so A and B reach wgmma K-major with the 128-byte swizzle,
// written by cp.async at the swizzled address.
// Intermediates that go to device memory between launches: the projections,
// qa/ka/vvp, alpha (N, H, L, L as (Nc, L, reps*H, L)), the attention values,
// the feature matrix, x1 and the MLP hiddens.

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

// ------------------------------------------------------ Hopper primitives
// cp.async (16 bytes, zero-filled when !full), ldmatrix, mma.sync and wgmma
// in inline PTX; used by K1's launches (k1_proj_kernel, k1_attn_kernel,
// k1_gemm_kernel).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of this thread (st.shared, cp.async) become visible
// to wgmma's operand reads (the async proxy) after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate. Not
// volatile: registers in, registers out, so the compiler may schedule the
// surrounding ldmatrix loads ahead of it.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void st_shared_u32(void* p, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(smem_u32(p)), "r"(v) : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_u32(p))
               : "memory");
  return v;
}

// wgmma operands: K-major tiles of 64 bf16 (128 bytes) a row, rows in
// 1024-byte groups of 8 with the 128-byte swizzle (16-byte unit u of row r
// at unit u ^ (r & 7)); the tile base is 1024-aligned.
__device__ __forceinline__ int sw128(int r, int u) { return r * 128 + ((u ^ (r & 7)) << 4); }

__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint32_t a = smem_u32(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16) . B (16 x 128): both from shared memory
// through descriptors, both K-major.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
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

// ------------------------------------------------------- K1's attention
// Block = (query tile of QT = 16 * QW rows from i0, head h, replicas n0 ..
// n0 + rt - 1 of complex c; rt divides reps), QW warps of 16 query rows.
// Shared memory: the tile's bias rows Bs (QT x (L + 8)) once, then NS
// stages of [K (L x KLD) | V (L x KLD) | Q (QT x KLD)], one replica each:
// the next NS - 1 replicas load while one computes.
// A warp keeps a whole key row in registers: KMAX/8 mma tiles of 8 keys
// (KMAX >= L); each warp's 16 Q rows of the stage double as its staging
// tile for the 16-byte alpha and o stores once Q is in registers.
template <int KMAX_, int QW_, int NS_>
struct AttnPlan {
  static constexpr int KMAX = KMAX_, QW = QW_, NS = NS_, QT = 16 * QW_;
  __host__ __device__ static constexpr size_t stage_elems(int L) {
    return (size_t)(2 * L + QT) * KLD;
  }
  __host__ __device__ static constexpr size_t smem(int L) {
    return (size_t)QT * (L + 8) * 2 + NS * stage_elems(L) * 2;
  }
};
// L <= 128: 8 warps, 128 query rows, three stages (200,704 bytes at L=128:
// one block an SM). 128 < L <= 256: 4 warps, 64 query rows, two stages
// (199,680 bytes at L=256).
using AttnSmall = AttnPlan<128, 8, 3>;
using AttnLarge = AttnPlan<256, 4, 2>;
static_assert(AttnSmall::smem(128) <= 232448, "K1's attention plan exceeds sm_90 at L=128");
static_assert(AttnLarge::smem(256) <= 232448, "K1's attention plan exceeds sm_90 at L=256");

// One warp's 16 query rows of one replica: logits, softmax, alpha, o.
template <int KMAX>
__device__ __forceinline__ void k1_attn_warp(const bf16* Ks, const bf16* Vs, bf16* Qw,
                                             const bf16* Bw, int BLD, int L, int i_first,
                                             bf16* __restrict__ orow, size_t o_ld,
                                             bf16* __restrict__ arow, size_t a_ld,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int nt = L >> 3;

  uint32_t qf[SLOT / 16][4];
#pragma unroll
  for (int kk = 0; kk < SLOT / 16; ++kk)
    ldsm_x4(qf[kk], Qw + (lane & 15) * KLD + kk * 16 + (lane >> 4) * 8);

  // Logits (16 x L) in mma C fragments: s[jt] holds rows g, g + 8 and the
  // key columns 8 jt + 2t, + 1.
  float s[KMAX / 8][4];
#pragma unroll
  for (int jt = 0; jt < KMAX / 8; ++jt) {
    s[jt][0] = s[jt][1] = s[jt][2] = s[jt][3] = 0.0f;
    if (jt < nt) {
      const bf16* kr = Ks + (jt * 8 + (lane & 7)) * KLD + (lane >> 3) * 8;
      uint32_t k0[4], k1[4];     // channels 0-31, 32-63: b0, b1 of two k-steps each
      ldsm_x4(k0, kr);
      ldsm_x4(k1, kr + 32);
      mma_bf16(s[jt], qf[0], k0[0], k0[1]);
      mma_bf16(s[jt], qf[1], k0[2], k0[3]);
      mma_bf16(s[jt], qf[2], k1[0], k1[1]);
      mma_bf16(s[jt], qf[3], k1[2], k1[3]);
    }
  }

  // + bias, exact max-subtract softmax in f32 over the quad's registers
  // (masked keys carry -1e5 in the bias).
  const bf16* b0 = Bw + g * BLD + 2 * t;
  const bf16* b1 = b0 + 8 * BLD;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int jt = 0; jt < KMAX / 8; ++jt) {
    if (jt < nt) {
      const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b0 + jt * 8));
      const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + jt * 8));
      s[jt][0] += u.x;
      s[jt][1] += u.y;
      s[jt][2] += w.x;
      s[jt][3] += w.y;
      m0 = fmaxf(m0, fmaxf(s[jt][0], s[jt][1]));
      m1 = fmaxf(m1, fmaxf(s[jt][2], s[jt][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int jt = 0; jt < KMAX / 8; ++jt) {
    if (jt < nt) {
      s[jt][0] = __expf(s[jt][0] - m0);
      s[jt][1] = __expf(s[jt][1] - m0);
      s[jt][2] = __expf(s[jt][2] - m1);
      s[jt][3] = __expf(s[jt][3] - m1);
      l0 += s[jt][0] + s[jt][1];
      l1 += s[jt][2] + s[jt][3];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  uint32_t p[KMAX / 8][2];
#pragma unroll
  for (int jt = 0; jt < KMAX / 8; ++jt) {
    p[jt][0] = pack2(s[jt][0] * inv0, s[jt][1] * inv0);
    p[jt][1] = pack2(s[jt][2] * inv1, s[jt][3] * inv1);
  }

  // alpha out, 64 key columns at a time through the staging tile Qw.
#pragma unroll
  for (int cb = 0; cb < KMAX / 64; ++cb) {
    if (cb * 8 < nt) {
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (cb * 8 + jj < nt) {
          st_shared_u32(Qw + g * KLD + jj * 8 + 2 * t, p[cb * 8 + jj][0]);
          st_shared_u32(Qw + (g + 8) * KLD + jj * 8 + 2 * t, p[cb * 8 + jj][1]);
        }
      }
      __syncwarp();
      const int units = min(8, nt - cb * 8);
#pragma unroll
      for (int u = lane; u < 128; u += 32) {
        const int r = u >> 3, q = u & 7;
        if (q < units && i_first + r < L)
          *reinterpret_cast<uint4*>(arow + r * a_ld + cb * 64 + q * 8) =
              ld_shared_v4(Qw + r * KLD + q * 8);
      }
    }
  }

  // o = alpha . vvp: the packed alpha registers are the A fragments.
  float oc[SLOT / 8][4];
#pragma unroll
  for (int j = 0; j < SLOT / 8; ++j) oc[j][0] = oc[j][1] = oc[j][2] = oc[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KMAX / 16; ++kk) {
    if (2 * kk < nt) {
      const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1]};
      const bf16* vr = Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KLD + (lane >> 4) * 8;
#pragma unroll
      for (int d = 0; d < SLOT / 16; ++d) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vr + d * 16);
        mma_bf16(oc[2 * d], a, vb[0], vb[1]);
        mma_bf16(oc[2 * d + 1], a, vb[2], vb[3]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < SLOT / 8; ++j) {
    st_shared_u32(Qw + g * KLD + j * 8 + 2 * t, pack2(oc[j][0], oc[j][1]));
    st_shared_u32(Qw + (g + 8) * KLD + j * 8 + 2 * t, pack2(oc[j][2], oc[j][3]));
  }
  __syncwarp();
#pragma unroll
  for (int u = lane; u < 128; u += 32) {
    const int r = u >> 3, q = u & 7;
    if (i_first + r < L)
      *reinterpret_cast<uint4*>(orow + r * o_ld + q * 8) = ld_shared_v4(Qw + r * KLD + q * 8);
  }
}

template <class Plan>
__global__ void __launch_bounds__(Plan::QW * 32, 1)
k1_attn_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
               const bf16* __restrict__ vv, const bf16* __restrict__ bias,
               bf16* __restrict__ o, bf16* __restrict__ alpha, int L, int H,
               int reps, int rt) {
  constexpr int QT = Plan::QT, NTH = Plan::QW * 32, NS = Plan::NS;
  extern __shared__ __align__(128) unsigned char smraw[];
  const int BLD = L + 8;
  bf16* Bs = reinterpret_cast<bf16*>(smraw);
  bf16* stage0 = Bs + QT * BLD;
  const size_t stage_elems = Plan::stage_elems(L);
  const int i0 = blockIdx.x * QT, h = blockIdx.y, n0 = blockIdx.z * rt;
  const int c = n0 / reps;
  const int HD = H * SLOT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const bf16* bsrc = bias + ((size_t)c * H + h) * L * L;
  const int chunks = L >> 3;
  for (int idx = tid; idx < QT * chunks; idx += NTH) {
    const int r = idx / chunks, cc = (idx - r * chunks) * 8, i = i0 + r;
    cp_async16(&Bs[r * BLD + cc], bsrc + (size_t)(i < L ? i : 0) * L + cc, i < L);
  }
  auto load_stage = [&](int r, bf16* st) {
    const size_t nb = (size_t)(n0 + r) * L;
    bf16* Ks = st;
    for (int idx = tid; idx < (2 * L + QT) * 8; idx += NTH) {
      const int row = idx >> 3, cc = (idx & 7) * 8;
      const bf16* src;
      bool ok = true;
      if (row < L) {
        src = ka + (nb + row) * HD;
      } else if (row < 2 * L) {
        src = vv + (nb + row - L) * HD;
      } else {
        const int i = i0 + row - 2 * L;
        ok = i < L;
        src = qa + (nb + (ok ? i : 0)) * HD;
      }
      cp_async16(Ks + row * KLD + cc, src + h * SLOT + cc, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < rt) load_stage(s, stage0 + s * stage_elems);
    cp_async_commit();
  }
  const size_t RH = (size_t)reps * H;
  const int wrow = warp * 16, i_first = i0 + wrow;
  for (int r = 0; r < rt; ++r) {
    bf16* st = stage0 + (r % NS) * stage_elems;
    if (r + NS - 1 < rt) load_stage(r + NS - 1, stage0 + ((r + NS - 1) % NS) * stage_elems);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();
    if (i_first < L) {
      const int n = n0 + r, rp = n - c * reps;
      bf16* Ks = st;
      bf16* Vs = Ks + L * KLD;
      bf16* Qs = Vs + L * KLD;
      k1_attn_warp<Plan::KMAX>(Ks, Vs, Qs + wrow * KLD, Bs + wrow * BLD, BLD, L, i_first,
                         o + ((size_t)n * L + i_first) * HD + h * SLOT, (size_t)HD,
                         alpha + (((size_t)c * L + i_first) * RH + (size_t)rp * H + h) * L,
                         RH * L, lane);
    }
    __syncthreads();
  }
}

// --------------------------------------------------------- K1's GEMMs
// One tensor-core tile for the layer's five products: wgmma m64n128k16
// (bf16 in, f32 accumulate) per warpgroup on 64 rows x 128 columns, the
// operands K-major in 64-wide chunks (128 x 64 bf16 = 16 KB of B, 64 rows
// x 64 = 8 KB of A per warpgroup), filled by cp.async (A of the projection
// by st.shared after its f32 -> bf16 conversion). Two drivers:
//   k1_proj_kernel: A = x (f32, K = FD) resident, two warpgroups (128 rows),
//     the weight's column tiles streamed through a two-stage ring (97 KB:
//     two blocks an SM, the 256 row blocks of N=256, L=128 in one wave);
//   k1_gemm_kernel<EPI, WG>: N = FD, WG warpgroups (64 WG rows) sharing
//     each B chunk, K streamed through a three-stage ring; WG = 2 where the
//     128-row blocks fill the SMs (half the B traffic), else 1.
// The bf16 epilogue stages each warpgroup's tile (64 x 128 bf16, rows of
// 256 bytes, 16-byte units swizzled by row) for 16-byte stores, in ring
// memory that the tile's products have finished reading.
constexpr int WN = 128;                // output columns a tile
constexpr int WK = 64;                 // K a chunk
constexpr int WB_CHUNK = WN * WK * 2;  // bytes of one B chunk
constexpr int WA_CHUNK = 64 * WK * 2;  // bytes of one warpgroup's A chunk
constexpr int C_TILE = 64 * WN * 2;    // bytes of one warpgroup's bf16 staging tile
constexpr int G_STAGES = 3;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// rows x 64 of a row-major bf16 matrix (rows r0.., K from k0) into a
// swizzled chunk; rows >= nrows and K past K (a multiple of 8) are zero.
__device__ __forceinline__ void load_chunk(unsigned char* dst, const bf16* src, int ld,
                                           int r0, int nrows, int rows, int k0, int K,
                                           int tid, int nth) {
  for (int idx = tid; idx < rows * 8; idx += nth) {
    const int r = idx >> 3, u = idx & 7, gr = r0 + r, k = k0 + u * 8;
    const bool ok = gr < nrows && k < K;
    cp_async16(dst + sw128(r, u), ok ? src + (size_t)gr * ld + k : src, ok);
  }
}

// acc += (this warpgroup's 64 rows of an A chunk) . (a B chunk)^T, K = 64.
__device__ __forceinline__ void wg_mma_chunk(float (&acc)[64], const unsigned char* a,
                                             const unsigned char* b) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
  for (int k = 0; k < WK / 16; ++k) wgmma_m64n128k16(acc, da + 2 * k, db + 2 * k);
}

// Byte offset of (row r, column c) in a staging tile.
__device__ __forceinline__ int c_off(int r, int c) {
  return r * (WN * 2) + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// EPI_BF16: bf16(acc + bias, ReLU) of a warpgroup's 64 x 128 tile through
// its staging tile Cs to out rows m0w.. (16-byte stores). `bar`
// synchronises the warpgroup (named barrier id, 128 threads).
__device__ __forceinline__ void epi_bf16(float (&acc)[64], const Epi& ep, int n0, int m0w,
                                         int M, unsigned char* Cs, int wtid, int bar) {
  const int warp = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = j * 8 + 2 * t;
    float b0 = 0.0f, b1 = 0.0f;
    if (ep.bias) {
      b0 = ep.bias[n0 + col];
      b1 = ep.bias[n0 + col + 1];
    }
    float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0, acc[4 * j + 3] + b1};
    if (ep.relu) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = fmaxf(v[e], 0.0f);
    }
    st_shared_u32(Cs + c_off(warp * 16 + g, col), pack2(v[0], v[1]));
    st_shared_u32(Cs + c_off(warp * 16 + g + 8, col), pack2(v[2], v[3]));
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
  for (int u = wtid; u < 64 * (WN / 8); u += 128) {
    const int r = u / (WN / 8), q = u % (WN / 8), gr = m0w + r;
    if (gr < M)
      *reinterpret_cast<uint4*>(ep.out_bf16 + (size_t)gr * ep.ldo + n0 + q * 8) =
          ld_shared_v4(Cs + c_off(r, q * 8));
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
}

// EPI_LN: y = LN(resid + (acc + bias) * rowmask) over the whole FD = 128 row,
// reduced in registers across the quad that holds it.
__device__ __forceinline__ void epi_ln(float (&acc)[64], const Epi& ep, int m0w, int M,
                                       int wtid) {
  const int warp = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gr = m0w + warp * 16 + g + 8 * hr;
    const bool ok = gr < M;
    const size_t rb = (size_t)(ok ? gr : 0) * FD;
    const float mk = (ok && ep.rowmask) ? ep.rowmask[gr] : 1.0f;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float2 r = *reinterpret_cast<const float2*>(ep.resid + rb + col);
      float& v0 = acc[4 * j + 2 * hr];
      float& v1 = acc[4 * j + 2 * hr + 1];
      v0 = r.x + (v0 + ep.bias[col]) * mk;
      v1 = r.y + (v1 + ep.bias[col + 1]) * mk;
      s += v0 + v1;
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mean = s * (1.0f / FD);
    float s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const float d0 = acc[4 * j + 2 * hr] - mean, d1 = acc[4 * j + 2 * hr + 1] - mean;
      s2 += d0 * d0 + d1 * d1;
    }
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
    const float rstd = rsqrtf(s2 * (1.0f / FD) + 1e-10f);
    if (!ok) continue;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float y0 = (acc[4 * j + 2 * hr] - mean) * rstd * ep.ln[col] + ep.ln[FD + col];
      const float y1 = (acc[4 * j + 2 * hr + 1] - mean) * rstd * ep.ln[col + 1] + ep.ln[FD + col + 1];
      *reinterpret_cast<float2*>(ep.out_f32 + rb + col) = make_float2(y0, y1);
      if (ep.out_bf16)
        *reinterpret_cast<uint32_t*>(ep.out_bf16 + rb + col) = pack2(y0, y1);
    }
  }
}

constexpr size_t PROJ_SMEM = 1024 + 2 * 2 * WA_CHUNK + 2 * 2 * WB_CHUNK;
__host__ __device__ constexpr size_t gemm_smem(int wg) {
  return 1024 + (size_t)G_STAGES * (wg * WA_CHUNK + WB_CHUNK);
}
static_assert(2 * C_TILE <= 2 * WB_CHUNK, "the projection's staging must fit a B stage");
static_assert(2 * C_TILE <= G_STAGES * (2 * WA_CHUNK + WB_CHUNK), "staging must fit the ring");

// proj (M x N, bf16) = bf16(x) (M x FD) . Bt^T, Bt (N x FD); block = 128
// rows x the column tiles [t0, t1) of 128; grid (row blocks, column splits).
__global__ void __launch_bounds__(256, 2)
k1_proj_kernel(const float* __restrict__ X, const bf16* __restrict__ Bt, int M, int N,
               int tiles_per_block, Epi ep) {
  extern __shared__ unsigned char smraw[];
  unsigned char* sm = align1024(smraw);
  unsigned char* As = sm;                                  // [chunk][wg] 8 KB each
  unsigned char* Bst = As + 2 * 2 * WA_CHUNK;              // [stage][chunk] 16 KB
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int m0 = blockIdx.x * 128;
  const int t0 = blockIdx.y * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, N / WN);
  if (t0 >= t1) return;
  auto load_b = [&](int nt, int stage) {
#pragma unroll
    for (int kc = 0; kc < FD / WK; ++kc)
      load_chunk(Bst + (stage * 2 + kc) * WB_CHUNK, Bt, FD, nt * WN, N, WN, kc * WK, FD,
                 tid, 256);
  };
  load_b(t0, 0);
  cp_async_commit();
  // x's row-block, f32 -> bf16 once: unit c (8 values) of row r goes to
  // K chunk c / 8, warpgroup r / 64.
  for (int idx = tid; idx < 128 * (FD / 8); idx += 256) {
    const int r = idx / (FD / 8), c = idx % (FD / 8), gr = m0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < M) {
      const float4* p = reinterpret_cast<const float4*>(X + (size_t)gr * FD + c * 8);
      const float4 a = p[0], b = p[1];
      v = make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(As + ((c >> 3) * 2 + (r >> 6)) * WA_CHUNK + sw128(r & 63, c & 7)) = v;
  }
  for (int nt = t0; nt < t1; ++nt) {
    const int stage = (nt - t0) & 1;
    if (nt + 1 < t1) load_b(nt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    acc_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < FD / WK; ++kc)
      wg_mma_chunk(acc, As + (kc * 2 + wg) * WA_CHUNK, Bst + (stage * 2 + kc) * WB_CHUNK);
    wgmma_commit();
    wgmma_wait0();
    acc_fence(acc);
    __syncthreads();          // both warpgroups are done with this B stage
    epi_bf16(acc, ep, nt * WN, m0 + wg * 64, M, Bst + stage * 2 * WB_CHUNK + wg * C_TILE,
             wtid, 1 + wg);
    __syncthreads();          // staging read before the next prefetch refills it
  }
}

// out (M x FD) = epilogue(A (M x K, bf16) . Bt^T), Bt (FD x K); block = 64 WG
// rows, WG warpgroups.
template <int EPI, int WG>
__global__ void __launch_bounds__(128 * WG)
k1_gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ Bt, int M,
               int K, Epi ep) {
  extern __shared__ unsigned char smraw[];
  unsigned char* sm = align1024(smraw);
  constexpr int STAGE = WG * WA_CHUNK + WB_CHUNK, NTH = 128 * WG;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int m0 = blockIdx.x * 64 * WG;
  const int KC = (K + WK - 1) / WK;
  auto load = [&](int kc, int s) {
    load_chunk(sm + s * STAGE, A, lda, m0, M, 64 * WG, kc * WK, K, tid, NTH);
    load_chunk(sm + s * STAGE + WG * WA_CHUNK, Bt, K, 0, WN, WN, kc * WK, K, tid, NTH);
  };
#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < KC) load(s, s);
    cp_async_commit();
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int kc = 0; kc < KC; ++kc) {
    cp_async_wait<G_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    const int nk = kc + G_STAGES - 1;
    if (nk < KC) load(nk, nk % G_STAGES);
    cp_async_commit();
    const unsigned char* st = sm + (kc % G_STAGES) * STAGE;
    acc_fence(acc);
    wgmma_fence();
    wg_mma_chunk(acc, st + wg * WA_CHUNK, st + WG * WA_CHUNK);
    wgmma_commit();
    wgmma_wait0();
    acc_fence(acc);
  }
  if constexpr (EPI == EPI_BF16) {
    cp_async_wait<0>();
    __syncthreads();          // the ring is free: it becomes the staging tiles
    epi_bf16(acc, ep, 0, m0 + wg * 64, M, sm + wg * C_TILE, wtid, 1 + wg);
  } else {
    epi_ln(acc, ep, m0 + wg * 64, M, wtid);
  }
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

// SMs of the current device, asked once per device.
int num_sms() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (!cached[dev]) {
    int sms = 132;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms;
  }
  return cached[dev];
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

  const int npts = 2 * H * NP + H * NPV;
  assemble_kernel<0><<<M, 256, (3 * npts + 2 * H) * sizeof(float), stream>>>(
      w.proj, pw, a.R9, a.t, a.coef, H, w.qa, w.ka, w.vv);
  K1_CHECK(cudaGetLastError());

  K1_CHECK(
      launch_k1_attention(w.qa, w.ka, w.vv, a.bias, w.o, w.alpha, N, L, H, reps, rt, stream));

  const size_t p2n_bytes = p2n_smem(L);
  K1_CHECK(cudaFuncSetAttribute(p2n_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)p2n_bytes));
  p2n_kernel<<<dim3((reps * H + 63) / 64, L, Nc), 128, p2n_bytes, stream>>>(w.alpha, a.z, w.feat,
                                                                           ko, L, H, reps);
  K1_CHECK(cudaGetLastError());
  feat_kernel<0><<<M, 128, 0, stream>>>(w.o, a.R9, a.t, w.feat, ko, H);
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
