// K1's Hopper tiles (sm_90a, bf16 tensor cores) as __device__ functions,
// shared by K1's launches (csrc/gablock.cu: each kernel there is a thin
// __global__ wrapper over one of these) and K5's persistent chain
// (csrc/gablock_chain.cu, which runs them as work items). Each function
// takes its tile's indices and the block's shared-memory base and computes
// what the K1 launch of the same name computes for that tile, with the same
// rounding: so K5 and six K1 launches agree bitwise.
//
//   proj_tile         proj (128 rows, column tiles [t0, t1)) = bf16(x) . Bt^T
//                     through wgmma, x's row block resident (256 threads)
//   assemble_row<G>   one row of qa / ka / vvp from proj, R, t (G threads;
//                     the row in device memory or staged in shared memory)
//   k1_attn_tile<P,A,H>
//                     the replica-group attention: (query tile, head, rt
//                     replicas of one complex); mma.sync logits, softmax and
//                     alpha . V in registers (P::QW warps); alpha out in K1's
//                     layout, K2's, the block's shared memory or not at all
//                     (A: AlphaOut), a per-warp hook H after each replica
//   p2n_tile<NTH>     16 NTH / 32 alpha rows of one (query row, complex)
//                     times z[c, i] into the feature rows (NTH threads)
//   p2n_stage/p2n_mma the same product on 128 alpha rows staged by cp.async
//                     ahead, by mma.sync as the attention takes alpha . V,
//                     with p2n_tile's sums (256 threads; K5's p2n items and
//                     K4's p2n launch, csrc/ipa_attention.cu)
//   feat_row<G>       one row's node and local-frame point features (G; o's
//                     row in device memory or staged in shared memory)
//   gemm_tile<E, WG>  64 WG rows x 128 columns through wgmma with the bf16
//                     (bias, ReLU) or LayerNorm epilogue (128 WG threads; K5
//                     runs two one-warpgroup tiles side by side)
//
// assemble_row, k1_attn_tile and feat_row take a last template parameter,
// ABL (default 0), a mask of the ABL_* bits below: S4's phase ablations
// (csrc/gablock.cu) skip or fake the phase a bit names inside the tile.
// With ABL = 0 each tile is the code K1, K5, K4, K2, S1 and S3 run.
//
// Data another block of the same launch may have written (x after the first
// layer, proj, o, alpha, the feature rows, x1, the MLP hiddens) is read
// through L2 only: cp.async.cg or ld.global.cg, never through L1, which is
// not coherent across SMs (K5 stages proj's and o's rows by cp.async before
// assemble_row and feat_row read them; K1 reads them in place).
//
// Fixed head geometry (the DiffAb defaults): query/key width 32, value width
// 32, 8 query points, 8 value points, pair width 64, node width 128. H (a
// multiple of 4) and L (a multiple of 16, at most 256) are runtime values.
#pragma once

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
// in inline PTX.

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

// cp.async.wait_group with a count known only at run time (0 to 2).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n >= 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
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

// G threads that share one row's work: the block (G = blockDim.x) or one
// warp (G = 32).
template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G == 32) __syncwarp();
  else __syncthreads();
}

// ------------------------------------------------------------- ablations
// S4's phase-ablation bits (the flags of scripts/micro_fused_variants.py
// with a counterpart here; ops/gablock_variants.py::ABL_BITS mirrors the
// values). The tiles read the bits of ABL_ASSEMBLE, ABL_ATTN and ABL_FEAT;
// csrc/gablock.cu acts on the others at the launches.
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
// One row (trajectory n, residue i) of proj -> qa / ka / vvp. proj row
// layout: [q (H*QK) | k (H*QK) | v (H*VD) | qp | kp | vp], each point block
// planar ([x | y | z], head-major inside). Writes, per head h (64-wide
// slots):
//   qa = [q/sqrt(3*QK) | -2 c_h qp_g | c_h |qp_g|^2 | c_h | 0]
//   ka = [k            | kp_g        | 1            | |kp_g|^2 | 0]
//   vv = [v            | vp_g        | 0]
// so that qa . ka = the node + spatial logits, pre-scaled by 1/sqrt(3).
// pr: the row's proj values (H * 168 used) and Rr, tr its R (9, row-major)
// and t (3), in device memory (K1) or staged in shared memory (K5); smf:
// (3 npts + 2 H) floats of this group's own.
// ABL (S4): skip_rot takes the points as projected (no R, t); skip_sq puts
// in the |p|^2 slot the x of the operand's h-th planar point; thin_ops
// computes no point and writes zero point and |p|^2 slots (the constant
// slots kept).
__host__ __device__ constexpr int assemble_floats(int H) { return 3 * (2 * H * NP + H * NPV) + 2 * H; }

template <int G, int ABL = 0>
__device__ __forceinline__ void assemble_row(int row, int tid, const bf16* __restrict__ pr,
                                             const float* __restrict__ Rr,
                                             const float* __restrict__ tr,
                                             const float* __restrict__ coef, int H,
                                             bf16* __restrict__ qa, bf16* __restrict__ ka,
                                             bf16* __restrict__ vv, float* smf) {
  constexpr bool kThin = (ABL & ABL_THIN_OPS) != 0;
  const int HP = H * NP, HPV = H * NPV, npts = 2 * HP + HPV;
  float* g = smf;                 // (3, npts) global-frame points
  float* sq = smf + 3 * npts;     // (2, H) |qp|^2, |kp|^2 per head
  float R[9], t[3];
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = Rr[e];
#pragma unroll
  for (int e = 0; e < 3; ++e) t[e] = tr[e];

  const int pbase = H * (2 * QK + VD);
  if constexpr (!kThin) {
    for (int idx = tid; idx < npts; idx += G) {
      int base, n, j;
      if (idx < HP) { base = pbase; n = HP; j = idx; }
      else if (idx < 2 * HP) { base = pbase + 3 * HP; n = HP; j = idx - HP; }
      else { base = pbase + 6 * HP; n = HPV; j = idx - 2 * HP; }
      const float px = bf(pr[base + j]), py = bf(pr[base + n + j]), pz = bf(pr[base + 2 * n + j]);
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
    group_sync<G>();
    for (int k = tid; k < 2 * H; k += G) {
      const int o = k / H, h = k % H;
      float s = 0.0f;
      if constexpr ((ABL & ABL_SKIP_SQ) != 0) {
        s = g[o * HP + h];
      } else {
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < NP; ++p) {
            const float v = g[c * npts + o * HP + h * NP + p];
            s += v * v;
          }
      }
      sq[k] = s;
    }
    group_sync<G>();
  }

  const float s_node = 1.0f / sqrtf(3.0f * QK);
  const size_t ob = (size_t)row * H * SLOT;
  for (int idx = tid; idx < H * SLOT; idx += G) {
    const int h = idx / SLOT, d = idx % SLOT;
    const float cf = coef[h];
    float a, b, v;
    if (d < QK) {
      a = bf(pr[h * QK + d]) * s_node;
      b = bf(pr[H * QK + h * QK + d]);
      v = bf(pr[2 * H * QK + h * VD + d]);
    } else if (d < QK + 3 * NP) {
      if constexpr (kThin) {
        a = 0.0f; b = 0.0f; v = 0.0f;
      } else {
        const int e = d - QK, c = e / NP, p = e % NP;
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
  group_sync<G>();   // smf is free for the group's next row
}

// ------------------------------------------------------------------- p2n
// 16 NTH/32 of the reps*H alpha rows from m0, query row i, complex c:
// z[c, i] (L x CZ) is staged once and shared by every replica and head of
// c; the products are wmma m16n16k16 (bf16 in, f32 accumulate), one warp a
// 16-row strip; the results go straight into the feature rows.
constexpr int OLD = CZ + 4;

__host__ __device__ constexpr size_t p2n_smem(int L, int rows) {
  return (size_t)L * KLD * 2 + (size_t)rows * (L + 8) * 2 + (size_t)rows * OLD * 4;
}

template <int NTH>
__device__ __forceinline__ void p2n_tile(int m0, int i, int c, const bf16* __restrict__ alpha,
                                         const bf16* __restrict__ z, bf16* __restrict__ feat,
                                         int ko, int L, int H, int reps, unsigned char* smraw) {
  constexpr int MR = NTH / 2;     // 16 rows a warp
  const int ALD = L + 8;
  bf16* Zs = reinterpret_cast<bf16*>(smraw);
  bf16* As = Zs + L * KLD;
  float* Os = reinterpret_cast<float*>(As + MR * ALD);

  const int RH = reps * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int idx = tid; idx < L * 8; idx += NTH) {
    int j = idx >> 3, cc = (idx & 7) * 8;
    *reinterpret_cast<uint4*>(&Zs[j * KLD + cc]) =
        *reinterpret_cast<const uint4*>(&z[(((size_t)c * L + i) * L + j) * CZ + cc]);
  }
  const int chunks = L / 8;
  for (int idx = tid; idx < MR * chunks; idx += NTH) {
    int r = idx / chunks, cc = (idx % chunks) * 8, m = m0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m < RH)
      val = __ldcg(reinterpret_cast<const uint4*>(&alpha[(((size_t)c * L + i) * RH + m) * L + cc]));
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

// K5's p2n items and K4's p2n launch: 256 threads, 128 alpha rows a block;
// a block's query rows go through a ring of [z[c, i] | alpha rows] stages,
// as many as fit (at most three: two rows' copies in flight while one
// computes; L=128: three, L=256: one). The alpha rows' pitch is at least
// CZ + 8: each warp's 16 rows are also its staging tile for the 16 x CZ
// output.
constexpr int P2N_NT = 256;
constexpr int P2N_M = P2N_NT / 2;
__host__ __device__ constexpr int p2n_ald(int L) { return (L > CZ ? L : CZ) + 8; }
__host__ __device__ constexpr size_t p2n_stage_bytes(int L) {
  return ((size_t)L * KLD + (size_t)P2N_M * p2n_ald(L)) * 2;
}
__host__ __device__ constexpr int p2n_stages(int L) {
  return 3 * p2n_stage_bytes(L) <= 200704 ? 3 : 2 * p2n_stage_bytes(L) <= 230000 ? 2 : 1;
}

// z[c, i] (into Zs, pitch KLD) and the 128 alpha rows from m0 (into As,
// zero past reps*H) of query row i by cp.async, to be waited for by the
// caller. alpha is K1's (Nc, L, reps*H, L).
__device__ __forceinline__ void p2n_stage(int m0, int i, int c, const bf16* __restrict__ alpha,
                                          const bf16* __restrict__ z, bf16* Zs, bf16* As,
                                          int L, int H, int reps) {
  const int ALD = p2n_ald(L), RH = reps * H, chunks = L / 8;
  for (int idx = threadIdx.x; idx < L * 8; idx += P2N_NT) {
    const int j = idx >> 3, cc = (idx & 7) * 8;
    cp_async16(&Zs[j * KLD + cc], &z[(((size_t)c * L + i) * L + j) * CZ + cc], true);
  }
  for (int idx = threadIdx.x; idx < P2N_M * chunks; idx += P2N_NT) {
    const int r = idx / chunks, cc = (idx - r * chunks) * 8, m = m0 + r;
    cp_async16(&As[r * ALD + cc],
               m < RH ? &alpha[(((size_t)c * L + i) * RH + m) * L + cc] : alpha, m < RH);
  }
}

// p2n_tile's product on a staged row (Zs: z[c, i], As: 128 alpha rows, pitch
// p2n_ald(L)), as K1's attention computes alpha . V: warp w's 16 alpha rows
// by mma.sync m16n8k16 (the A fragments by ldmatrix, z's by
// ldmatrix.trans), K in 16-key steps in order as wmma takes them, so the
// sums are p2n_tile's; rounded to bf16 into the warp's own alpha rows (read
// by no one else) and stored 16 bytes at a time into the feature rows (row
// pitch ko; K4 passes its (N, L, H, CZ) output with ko = H CZ).
__device__ __forceinline__ void p2n_mma(int m0, int i, int c, const bf16* Zs, bf16* As,
                                        bf16* __restrict__ feat, int ko, int L, int H,
                                        int reps) {
  const int ALD = p2n_ald(L), RH = reps * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* Aw = As + warp * 16 * ALD;
  float oc[CZ / 8][4];
#pragma unroll
  for (int j = 0; j < CZ / 8; ++j) oc[j][0] = oc[j][1] = oc[j][2] = oc[j][3] = 0.0f;
  for (int kk = 0; kk < L / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, Aw + (lane & 15) * ALD + kk * 16 + (lane >> 4) * 8);
    const bf16* zr = Zs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KLD + (lane >> 4) * 8;
#pragma unroll
    for (int d = 0; d < CZ / 16; ++d) {
      uint32_t zb[4];
      ldsm_x4_t(zb, zr + d * 16);
      mma_bf16(oc[2 * d], a, zb[0], zb[1]);
      mma_bf16(oc[2 * d + 1], a, zb[2], zb[3]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < CZ / 8; ++j) {
    st_shared_u32(Aw + g * ALD + j * 8 + 2 * t, pack2(oc[j][0], oc[j][1]));
    st_shared_u32(Aw + (g + 8) * ALD + j * 8 + 2 * t, pack2(oc[j][2], oc[j][3]));
  }
  __syncwarp();
#pragma unroll
  for (int u = lane; u < 16 * CZ / 8; u += 32) {
    const int r = u / (CZ / 8), q = u % (CZ / 8), m = m0 + warp * 16 + r;
    if (m < RH) {
      const int n = c * reps + m / H, h = m % H;
      *reinterpret_cast<uint4*>(feat + ((size_t)n * L + i) * ko + h * CZ + q * 8) =
          ld_shared_v4(Aw + r * ALD + q * 8);
    }
  }
}

// ------------------------------------------------------------------ feat
// One row (G threads). Feature row layout (the module's planar
// out_transform rows): [p2n (H*CZ, written by p2n_tile) | node (H*VD) |
// points local [x|y|z] (3*H*NPV) | distance (H*NPV) | direction [x|y|z]
// (3*H*NPV)]. orow: the row's attention values (H*SLOT) and Rr, tr its R
// and t, in device memory (K1) or staged in shared memory (K5). ABL (S4):
// skip_rot takes the aggregated points as they are (no R^T (. - t)).
template <int G, int ABL = 0>
__device__ __forceinline__ void feat_row(int row, int tid, const bf16* __restrict__ orow,
                                         const float* __restrict__ Rr,
                                         const float* __restrict__ tr, bf16* __restrict__ feat,
                                         int ko, int H) {
  float R[9], t[3];
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = Rr[e];
#pragma unroll
  for (int e = 0; e < 3; ++e) t[e] = tr[e];
  bf16* frow = feat + (size_t)row * ko;
  const int HPV = H * NPV;
  const int b0 = H * CZ, b1 = b0 + H * VD, b2 = b1 + 3 * HPV, b3 = b2 + HPV;
  for (int u = tid; u < H * VD / 8; u += G) {   // node values, 16 bytes a copy
    const int h = u / (VD / 8), q = u % (VD / 8);
    *reinterpret_cast<uint4*>(frow + b0 + u * 8) =
        *reinterpret_cast<const uint4*>(orow + h * SLOT + q * 8);
  }
  for (int idx = tid; idx < HPV; idx += G) {
    const int h = idx / NPV, p = idx % NPV;
    const bf16* pt = orow + h * SLOT + VD + p;
    float l[3];
    if constexpr ((ABL & ABL_SKIP_ROT) != 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) l[c] = bf(pt[c * NPV]);
    } else {
      const float d0 = bf(pt[0]) - t[0], d1 = bf(pt[NPV]) - t[1], d2 = bf(pt[2 * NPV]) - t[2];
#pragma unroll
      for (int c = 0; c < 3; ++c) l[c] = R[c] * d0 + R[3 + c] * d1 + R[6 + c] * d2;
    }
    const float ss = l[0] * l[0] + l[1] * l[1] + l[2] * l[2];
    const float inv = 1.0f / (sqrtf(ss + 1e-8f) + 1e-4f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      frow[b1 + c * HPV + idx] = tobf(l[c]);
      frow[b3 + c * HPV + idx] = tobf(l[c] * inv);
    }
    frow[b2 + idx] = tobf(sqrtf(ss + 1e-12f));
  }
}

// ------------------------------------------------------------- attention
// Tile = (query tile of QT = 16 * QW rows from i0, head h, replicas n0 ..
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
// K1: L <= 128: 8 warps, 128 query rows, three stages (200,704 bytes at
// L=128: one block an SM). 128 < L <= 256: 4 warps, 64 query rows, two
// stages (199,680 bytes at L=256). K5's blocks have 8 warps, so past L=128
// it takes 128 query rows and one stage (159,744 bytes at L=256).
// S1 and K4 (csrc/attention_variants.cu, csrc/ipa_attention.cu) take
// AttnLean up to L=128: 8 warps and one stage (90,112 bytes at L=128), so
// two blocks share an SM and one's loads overlap the other's math; the same
// bits as AttnSmall, and S1's v3 at N=256 in 0.1243 ms against 0.1652 with
// AttnSmall on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 11).
using AttnSmall = AttnPlan<128, 8, 3>;
using AttnLean = AttnPlan<128, 8, 1>;
using AttnLarge = AttnPlan<256, 4, 2>;
using AttnWide = AttnPlan<256, 8, 1>;
static_assert(AttnSmall::smem(128) <= 232448, "K1's attention plan exceeds sm_90 at L=128");
static_assert(2 * (AttnLean::smem(128) + 1024) <= 233472, "two lean tiles must share an SM");
static_assert(AttnLarge::smem(256) <= 232448, "K1's attention plan exceeds sm_90 at L=256");
static_assert(AttnWide::smem(256) <= 232448, "K5's attention plan exceeds sm_90 at L=256");

// Where the tile's alpha goes: K1's (Nc, L, reps*H, L) layout (the rows
// p2n reads), K2's (N, H, L, L) layout (S1's v1), nowhere (S1's v3: the
// 16-byte alpha stores then compile away), or the block's shared memory
// (S3: `alpha` is then a shared-memory base, the tile's query row q at row
// q, rows L apart, each replica's rows in place of the last, for the hook
// to take). o is the same in all four.
enum AlphaOut { ALPHA_K1 = 0, ALPHA_K2 = 1, ALPHA_NONE = 2, ALPHA_SMEM = 3 };

// k1_attn_tile's hook, called by each warp as hook(r, wrow, lane) once its
// 16 rows (from wrow) of replica r are done; by default nothing.
struct NoHook {
  __device__ __forceinline__ void operator()(int, int, int) const {}
};

// One warp's 16 query rows of one replica: logits, softmax, alpha (to arow,
// rows a_ld apart, in device or shared memory; none without STORE_ALPHA),
// o. ABL (S4), the bits of ABL_ATTN:
//   fake_softmax  alpha = bf16(0.01 (logits + bias)) from the C fragments:
//                 no max, exp or sum;
//   fake_alpha    no Q . K (neither Q's fragments nor K's are read):
//                 alpha = bf16(0.01 bias), from the staged bias rows;
//   skip_values   no alpha . V: o = the replica's own vvp rows (row i of the
//                 V stage for query row i), by the same 16-byte stores.
template <int KMAX, bool STORE_ALPHA = true, int ABL = 0>
__device__ __forceinline__ void k1_attn_warp(const bf16* Ks, const bf16* Vs, bf16* Qw,
                                             const bf16* Bw, int BLD, int L, int i_first,
                                             bf16* __restrict__ orow, size_t o_ld,
                                             bf16* __restrict__ arow, size_t a_ld,
                                             int lane) {
  constexpr bool kFakeAlpha = (ABL & ABL_FAKE_ALPHA) != 0;
  constexpr bool kLinear = (ABL & (ABL_FAKE_ALPHA | ABL_FAKE_SOFTMAX)) != 0;
  constexpr bool kSkipValues = (ABL & ABL_SKIP_VALUES) != 0;
  const int g = lane >> 2, t = lane & 3;
  const int nt = L >> 3;

  uint32_t qf[SLOT / 16][4];
  if constexpr (!kFakeAlpha) {
#pragma unroll
    for (int kk = 0; kk < SLOT / 16; ++kk)
      ldsm_x4(qf[kk], Qw + (lane & 15) * KLD + kk * 16 + (lane >> 4) * 8);
  }

  // Logits (16 x L) in mma C fragments: s[jt] holds rows g, g + 8 and the
  // key columns 8 jt + 2t, + 1.
  float s[KMAX / 8][4];
#pragma unroll
  for (int jt = 0; jt < KMAX / 8; ++jt) {
    s[jt][0] = s[jt][1] = s[jt][2] = s[jt][3] = 0.0f;
    if (!kFakeAlpha && jt < nt) {
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
  uint32_t p[KMAX / 8][2];
  if constexpr (kLinear) {
#pragma unroll
    for (int jt = 0; jt < KMAX / 8; ++jt) {
      if (jt < nt) {
        const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b0 + jt * 8));
        const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + jt * 8));
        p[jt][0] = pack2(0.01f * (s[jt][0] + u.x), 0.01f * (s[jt][1] + u.y));
        p[jt][1] = pack2(0.01f * (s[jt][2] + w.x), 0.01f * (s[jt][3] + w.y));
      } else {
        p[jt][0] = p[jt][1] = 0u;
      }
    }
  } else {
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
#pragma unroll
    for (int jt = 0; jt < KMAX / 8; ++jt) {
      p[jt][0] = pack2(s[jt][0] * inv0, s[jt][1] * inv0);
      p[jt][1] = pack2(s[jt][2] * inv1, s[jt][3] * inv1);
    }
  }

  // alpha out, 64 key columns at a time through the staging tile Qw.
#pragma unroll
  for (int cb = 0; cb < KMAX / 64; ++cb) {
    if (STORE_ALPHA && cb * 8 < nt) {
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
  const bf16* ostage = Qw;
  if constexpr (kSkipValues) {
    ostage = Vs + i_first * KLD;
  } else {
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
  }
#pragma unroll
  for (int u = lane; u < 128; u += 32) {
    const int r = u >> 3, q = u & 7;
    if (i_first + r < L)
      *reinterpret_cast<uint4*>(orow + r * o_ld + q * 8) = ld_shared_v4(ostage + r * KLD + q * 8);
  }
}

// The tile (i0, h, n0 .. n0 + rt - 1) on Plan::QW * 32 threads; bias_ch is
// the (L, L) pair bias of (complex, head); alpha in the layout AO names;
// `hook` runs in each warp after each replica; ABL as k1_attn_warp takes it.
// Under fake_alpha a stage loads only V: K's rows are never read, and the
// Q rows' room serves only as the warps' staging tiles.
template <class Plan, AlphaOut AO = ALPHA_K1, class Hook = NoHook, int ABL = 0>
__device__ __forceinline__ void k1_attn_tile(int i0, int h, int n0, int rt,
                                             const bf16* __restrict__ qa,
                                             const bf16* __restrict__ ka,
                                             const bf16* __restrict__ vv,
                                             const bf16* __restrict__ bias_ch,
                                             bf16* __restrict__ o, bf16* __restrict__ alpha,
                                             int L, int H, int reps, unsigned char* smraw,
                                             Hook hook = Hook()) {
  constexpr int QT = Plan::QT, NTH = Plan::QW * 32, NS = Plan::NS;
  const int BLD = L + 8;
  bf16* Bs = reinterpret_cast<bf16*>(smraw);
  bf16* stage0 = Bs + QT * BLD;
  const size_t stage_elems = Plan::stage_elems(L);
  const int c = n0 / reps;
  const int HD = H * SLOT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int chunks = L >> 3;
  for (int idx = tid; idx < QT * chunks; idx += NTH) {
    const int r = idx / chunks, cc = (idx - r * chunks) * 8, i = i0 + r;
    cp_async16(&Bs[r * BLD + cc], bias_ch + (size_t)(i < L ? i : 0) * L + cc, i < L);
  }
  constexpr bool kFakeAlpha = (ABL & ABL_FAKE_ALPHA) != 0;
  auto load_stage = [&](int r, bf16* st) {
    const size_t nb = (size_t)(n0 + r) * L;
    bf16* Ks = st;
    const int first = kFakeAlpha ? L * 8 : 0, last = kFakeAlpha ? 2 * L * 8 : (2 * L + QT) * 8;
    for (int idx = first + tid; idx < last; idx += NTH) {
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
      bf16* arow = nullptr;
      size_t a_ld = 0;
      if constexpr (AO == ALPHA_K1) {
        arow = alpha + (((size_t)c * L + i_first) * RH + (size_t)rp * H + h) * L;
        a_ld = RH * L;
      } else if constexpr (AO == ALPHA_K2) {
        arow = alpha + (((size_t)n * H + h) * L + i_first) * L;
        a_ld = L;
      } else if constexpr (AO == ALPHA_SMEM) {
        arow = alpha + (size_t)wrow * L;
        a_ld = L;
      }
      k1_attn_warp<Plan::KMAX, AO != ALPHA_NONE, ABL>(
          Ks, Vs, Qs + wrow * KLD, Bs + wrow * BLD, BLD, L, i_first,
          o + ((size_t)n * L + i_first) * HD + h * SLOT, (size_t)HD, arow, a_ld, lane);
      hook(r, wrow, lane);
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
//   proj_tile: A = x (f32, K = FD) resident, two warpgroups (128 rows), the
//     weight's column tiles streamed through a two-stage ring (97 KB);
//   gemm_tile<EPI, WG>: N = FD, WG warpgroups (64 WG rows) sharing each B
//     chunk, K streamed through a three-stage ring.
// The bf16 epilogue stages each warpgroup's tile (64 x 128 bf16, rows of
// 256 bytes, 16-byte units swizzled by row) for 16-byte stores, in ring
// memory that the tile's products have finished reading.
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
      const float2 r = __ldcg(reinterpret_cast<const float2*>(ep.resid + rb + col));
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

// proj (M x N, bf16) = bf16(x) (M x FD) . Bt^T, Bt (N x FD): rows m0 ..
// m0 + 127, the column tiles [t0, t1) of 128; 256 threads.
__device__ __forceinline__ void proj_tile(int m0, int t0, int t1, const float* __restrict__ X,
                                          const bf16* __restrict__ Bt, int M, int N,
                                          const Epi& ep, unsigned char* smraw) {
  if (t0 >= t1) return;
  unsigned char* sm = align1024(smraw);
  unsigned char* As = sm;                                  // [chunk][wg] 8 KB each
  unsigned char* Bst = As + 2 * 2 * WA_CHUNK;              // [stage][chunk] 16 KB
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
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
      const float4 a = __ldcg(p), b = __ldcg(p + 1);
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

// Barrier `id` over `n` threads (bar.sync 0 over the whole block is
// __syncthreads).
template <int ID, int N>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}

// out (M x FD) = epilogue(A (M x K, bf16) . Bt^T), Bt (FD x K): rows m0 ..
// m0 + 64 WG - 1, on 128 WG threads (threadIdx.x % (128 WG) their index)
// that synchronise on barrier BAR and, in the bf16 epilogue, EPI_BAR + (its
// warpgroup). K1's blocks are exactly those threads (BAR 0 is then
// __syncthreads); K5 runs two one-warpgroup tiles in one block, each on its
// own barriers and ring, as K1 runs two blocks an SM.
template <int EPI, int WG, int BAR = 0, int EPI_BAR = 1>
__device__ __forceinline__ void gemm_tile(int m0, const bf16* __restrict__ A, int lda,
                                          const bf16* __restrict__ Bt, int M, int K,
                                          const Epi& ep, unsigned char* smraw) {
  unsigned char* sm = align1024(smraw);
  constexpr int STAGE = WG * WA_CHUNK + WB_CHUNK, NTH = 128 * WG;
  const int tid = threadIdx.x % NTH, wg = tid >> 7, wtid = tid & 127;
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
    bar_sync<BAR, NTH>();
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
    bar_sync<BAR, NTH>();          // the ring is free: it becomes the staging tiles
    epi_bf16(acc, ep, 0, m0 + wg * 64, M, sm + wg * C_TILE, wtid, EPI_BAR + wg);
  } else {
    epi_ln(acc, ep, m0 + wg * 64, M, wtid);
  }
}

// ------------------------------------------------------- the workspace
// Intermediates of one layer in device memory (K1 between its launches,
// K5 between its work items).
inline size_t align_up(size_t b) { return (b + 255) & ~(size_t)255; }

struct Workspace {
  bf16 *proj, *qa, *ka, *vv, *alpha, *o, *feat, *x1b, *h1, *h2;
  float* x1;
};

inline size_t carve(unsigned char* base, int N, int L, int H, int pw, int ko,
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

// SMs of the current device, asked once per device.
inline int num_sms() {
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

}  // namespace
