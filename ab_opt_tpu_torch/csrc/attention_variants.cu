// The attention-variant harness (S1-S3) for Hopper (sm_90a): three ways to
// compute the IPA attention forward, each on the tensor cores in bf16.
//
// Replaces the TPU kernels of scripts/micro_kernel_variants.py:
//   S1  v1_call -> _v1_kernel: K2's function (ab_opt_tpu/ops/ipa_pallas.py
//       _attention_fwd_call); with store_alphas (v1) it exports the alphas,
//       without (v3) only out;
//   S2  v2_call -> _v2_kernel: K2's function with the heads walked inside
//       one block; exports the alphas;
//   S3  v4_call -> _v4_kernel: v3 plus p2n[n, i, h, :] = sum_j alpha[h, i, j]
//       z[n / reps, i, j, :] in the kernel: K4's function.
// Layout (the JAX package's): qa, ka, vvp, out are (N, L, H * 64), each head
// a 64-wide slot, qa pre-scaled; bias is (N / reps, H, L, L) (trajectory n
// reads its complex's block n / reps); alphas (N, H, L, L); z (N / reps, L,
// L, Cz), p2n (N, L, H, Cz). All bf16. Every product accumulates in f32 on
// the tensor cores (S1, S3: mma.sync m16n8k16; S2: wgmma m64n64k16); the
// softmax is exact (max-subtract, f32) and alpha is rounded to bf16 once,
// and that value feeds every product and the alphas output.
//
// What bounds them on this card. At the script's shape (N = 256 replicas of
// one complex, L = 128, H = 12, Cz = 64) each variant does 12.9 GFLOP (v4:
// 19.3) and moves qa, ka, vvp and out at 50.3 MB each, the alphas at 100.7
// MB (v1, v2) and p2n at 50.3 MB (v4): ~302 MB for v1 and v2 (0.0903 ms at
// 3.35 TB/s), ~202 MB for v3 (0.0602), ~254 MB for v4 (0.0759). At ~295
// FLOP a byte before the bf16 tensor cores limit, all are bounded by
// device-memory bytes.
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
//     plan (one K / V / Q stage, two blocks an SM), past it in AttnLarge's.
//   S3 (v4, s3_kernel) is K4's function in one launch with alpha never in
//     device memory. K4 (csrc/ipa_attention.cu) writes alpha out of its
//     attention launch and reads it back in its p2n launch, 100 MB each way
//     at the script's shape, so that p2n can multiply reps * H alpha rows by
//     each z[n / reps, i] (L x Cz). A block that keeps its alpha has only
//     its own rt (replica, head) rows per query row: multiplied there, every
//     z[c, i] would come from L2 once per block (a fused K4 tile built so:
//     1.13 GB a call, 0.5364 ms against K4's 0.2640). So S3 shares z across a
//     thread-block cluster:
//     attention  K1's tile (k1_attn_tile<.., ALPHA_SMEM>; o bitwise K4's):
//                a block per (64 query rows, head, rt replicas of one
//                complex), four warps, one K / V / Q stage; each replica's
//                alpha rows go into the block's shared memory, and each
//                warp, through the tile's hook, pushes its 16 rows at once
//                to the blocks that own those query rows (16-byte stores to
//                distributed shared memory);
//     cluster    (1, cy, cz) blocks: the same query tile and complex, cy
//                heads by cz replica groups, at most 8; the query rows are
//                dealt round-robin to its blocks, so the owner of row i
//                holds all M = cy cz rt alpha rows of that row after one
//                cluster.sync();
//     p2n        the owner multiplies them by z[c, i], which reaches the
//                cluster once a row (cp.async into a ring of three), as
//                K4's p2n launch does (mma.sync m16n8k16, 16-key steps in
//                order, one (16 rows, 16 Cz columns) tile a warp): p2n
//                bitwise K4's.
//     At the script's shape: rt = 2, a cluster of 8 replica groups, M = 16
//     (one full m16 tile), 114,688 bytes a block (two an SM: one block's
//     p2n runs beside the other's attention); z comes from L2 393 MB a
//     call, each alpha row crosses the cluster once (100 MB), and a block
//     reads 4 KB of alpha and 16 KB of z from shared memory a query row.
//     Cz a multiple of 16 up to 64, H up to 16, L a multiple of 16 up to
//     256. s3_plan below is the plan; ops/attention_variants.py v4_plan
//     mirrors it.
//   S2 (v2, s2_kernel): a block owns 64 query rows of rt (1 or 2) replicas
//     of one complex and walks every head, warp-specialised:
//     producer   one warpgroup, which gives its registers to the
//                consumers (setmaxnreg: 40 a thread, the consumers 232, so
//                that a row of 256 f32 logits does not spill); one thread
//                keeps a ring of head items in flight by TMA
//                (cp.async.bulk.tensor, 128-byte swizzle, mbarrier
//                completion): per (head, replica) Q_h (64 rows) and the
//                whole K_h and V_h, per head its bias rows, once for the
//                group's replicas;
//     consumers  two warpgroups take the items in turn: logits Q . K^T by
//                wgmma m64n64k16 (both operands in shared memory, K-major),
//                the exact softmax on the accumulator fragments (row max
//                and sum across each quad), alpha rounded to bf16 once and
//                packed as the A fragments of alpha . V by wgmma with A in
//                registers and V read transposed (MN-major) through its
//                descriptor; alphas and o leave through the stage's Q tile
//                (128-byte swizzled staging) by 16-byte stores; the item's
//                stage goes back to the producer by mbarrier.
//     Keys past L (K and V rows past L are zero-filled by the TMA box) are
//     masked before the softmax. L a multiple of 16 up to 256, any H. Four
//     stages up to L = 128 (197,888 bytes), two past it (214,272 at L =
//     256). s2_plan below is the plan; v2_plan mirrors it.
// S1's, S2's and S3's first designs (16 query rows of one trajectory a
// block with every head's f32 logits in shared memory; one warp a head
// with K and V read from L2) are gone; their times stay in PERF.md.

#include <stddef.h>
#include <cuda.h>
#include <cooperative_groups.h>

#include "k1_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr size_t SMEM_BLOCK = 232448;

template <typename K>
int set_smem(K kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  return (int)cudaGetLastError();
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
// Shared memory of a block: G, the gathered alpha rows of the query rows it
// owns (query rows q = rank, rank + C, ... of the tile, the k-th at rows
// k M .. k M + M - 1 of s3_ald: row k M + m, m = p rt + r, is the cluster
// rank p's replica r; 16 - M more rows end G, so that every 16-row tile
// from k M lies in it), written by every block of the cluster; S, this
// block's alpha of one replica (QT rows of L), from which each warp pushes
// its rows to their owners; then a work region that the attention (bias
// rows and one K / V / Q stage) and, after the cluster barrier, the p2n
// phase (a ring of S3_Z_STAGES z[c, i] buffers and each warp's 16 x 16
// output staging) take in turn.
constexpr int S3_MAX_CLUSTER = 8;
constexpr int S3_MAX_RT = 2;
constexpr int S3_Z_STAGES = 3;
constexpr int S3_OLD = 24;                            // output staging pitch
// K1's tile with 64 query rows, four warps and one stage: two blocks share
// an SM at L = 128, so that one block's p2n phase runs beside the other's
// attention.
using S3Small = AttnPlan<128, 4, 1>;      // L <= 128
using S3Large = AttnPlan<256, 4, 1>;      // past it
static_assert(S3_MAX_CLUSTER * S3_MAX_RT <= 16, "M fits one m16 tile");

__host__ __device__ inline int s3_ald(int L) { return L + 8; }
__host__ __device__ inline int s3_zld(int Cz) { return Cz + 8; }
// G's rows: M for each of the ceil(qt / C) query rows a block owns, then
// 16 - M (the tail of the last 16-row tile; the rows past M of a tile are
// read, multiplied and dropped).
__host__ __device__ inline int s3_g_rows(int qt, int c, int m) {
  return (qt + c - 1) / c * m + 16 - m;
}

struct S3Plan {
  int qt, threads, rt, cy, cz, m;
  size_t smem;
};

// The plan at (L, H, Cz, reps): K1's tile with 64 query rows, four warps
// and one stage; rt the larger of 2, 1 dividing reps whose block fits; the
// cluster cz replica groups (the largest divisor of reps / rt up to 8) by
// cy heads (the largest divisor of H with cy cz <= 8). Returns false if no
// block fits.
bool s3_plan(int L, int H, int Cz, int reps, S3Plan* p) {
  static_assert(S3Small::QT == S3Large::QT && S3Small::QW == S3Large::QW, "one block shape");
  const int qt = S3Small::QT, threads = 32 * S3Small::QW;
  const size_t attn = L <= 128 ? S3Small::smem(L) : S3Large::smem(L);
  const size_t p2n = (size_t)S3_Z_STAGES * L * s3_zld(Cz) * 2 +
                     (size_t)(threads / 32) * 16 * S3_OLD * 2;
  for (int rt = S3_MAX_RT; rt >= 1; rt /= 2) {
    if (reps % rt != 0) continue;
    int cz = 1, cy = 1;
    for (int d = S3_MAX_CLUSTER; d >= 1; --d)
      if ((reps / rt) % d == 0) { cz = d; break; }
    for (int d = S3_MAX_CLUSTER / cz; d >= 1; --d)
      if (H % d == 0) { cy = d; break; }
    const size_t smem = (size_t)s3_g_rows(qt, cy * cz, cy * cz * rt) * s3_ald(L) * 2 +
                        (size_t)qt * L * 2 + (attn > p2n ? attn : p2n);
    if (smem <= SMEM_BLOCK) {
      *p = S3Plan{qt, threads, rt, cy, cz, cy * cz * rt, smem};
      return true;
    }
  }
  return false;
}

// Grid (ceil(L / QT), H, N / rt), cluster (1, cy, cz). Block rank p = dy +
// cy dz of the cluster holds head (y - y % cy) + dy and replica group
// (z - z % cz) + dz.
template <class Plan, int CZT>
__global__ void __launch_bounds__(Plan::QW * 32, 1)
s3_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
          const bf16* __restrict__ vv, const bf16* __restrict__ bias,
          const bf16* __restrict__ z, bf16* __restrict__ out, bf16* __restrict__ p2n,
          int L, int H, int reps, int rt, int cy, int cz) {
  constexpr int QT = Plan::QT, NTH = Plan::QW * 32, NW = Plan::QW;
  constexpr int ZLD = CZT + 8, CG = CZT / 16, NZ = S3_Z_STAGES;
  extern __shared__ __align__(128) unsigned char smraw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cy * cz, rank = (int)cluster.block_rank();
  const int ALD = s3_ald(L), M = C * rt, chunks = L / 8;
  const int i0 = blockIdx.x * QT, h = blockIdx.y, n0 = blockIdx.z * rt, c = n0 / reps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  bf16* G = reinterpret_cast<bf16*>(smraw);
  bf16* S = G + (size_t)s3_g_rows(QT, C, M) * ALD;
  unsigned char* work = reinterpret_cast<unsigned char*>(S + (size_t)QT * L);

  // Each warp pushes its 16 rows of replica r, as soon as they are in S,
  // into the owners' G (16-byte stores to distributed shared memory).
  auto push = [&](int r, int wrow, int ln) {
    __syncwarp();
    const int m = rank * rt + r;
    for (int u = ln; u < 16 * chunks; u += 32) {
      const int rr = u / chunks, cc = (u - rr * chunks) * 8, q = wrow + rr;
      if (i0 + q < L) {
        bf16* dst = cluster.map_shared_rank(G, q % C) + ((size_t)(q / C) * M + m) * ALD + cc;
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(S + (size_t)q * L + cc);
      }
    }
    __syncwarp();                  // S is read before the next replica rewrites it
  };
  cluster.sync();                  // every peer runs: its G may be written
  k1_attn_tile<Plan, ALPHA_SMEM>(i0, h, n0, rt, qa, ka, vv,
                                 bias + ((size_t)c * H + h) * L * L, out, S, L, H, reps,
                                 work, push);
  cluster.sync();                  // every block's rows are in their owners' G

  // p2n of this block's query rows i0 + rank + k C, k < nq, through a ring
  // of z[c, i] buffers; no peer reads this block's memory any more.
  bf16* Zbuf = reinterpret_cast<bf16*>(work);
  bf16* stg = Zbuf + (size_t)NZ * L * ZLD + warp * 16 * S3_OLD;
  const int HQ = h - h % cy, GQ = blockIdx.z - blockIdx.z % cz;
  int nq = 0;
  for (int q = rank; q < QT && i0 + q < L; q += C) ++nq;
  auto load_z = [&](int k) {
    bf16* Zs = Zbuf + (size_t)(k % NZ) * L * ZLD;
    const bf16* zr = z + ((size_t)c * L + i0 + rank + k * C) * L * CZT;
    for (int idx = tid; idx < L * (CZT / 8); idx += NTH) {
      const int j = idx / (CZT / 8), cc = (idx - j * (CZT / 8)) * 8;
      cp_async16(Zs + j * ZLD + cc, zr + (size_t)j * CZT + cc, true);
    }
  };
#pragma unroll
  for (int k = 0; k < NZ - 1; ++k) {
    if (k < nq) load_z(k);
    cp_async_commit();
  }
  for (int k = 0; k < nq; ++k) {
    if (k + NZ - 1 < nq) load_z(k + NZ - 1);
    cp_async_commit();
    cp_async_wait<NZ - 1>();
    __syncthreads();               // row k's z is in place
    const int i = i0 + rank + k * C;
    const bf16* Zs = Zbuf + (size_t)(k % NZ) * L * ZLD;
    for (int d = warp; d < CG; d += NW) {
      float oc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const bf16* ar = G + ((size_t)k * M + (lane & 15)) * ALD + (lane >> 4) * 8;
      const bf16* zr = Zs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ZLD + (lane >> 4) * 8 + d * 16;
      for (int kk = 0; kk < L / 16; ++kk) {
        uint32_t a[4], zb[4];
        ldsm_x4(a, ar + kk * 16);
        ldsm_x4_t(zb, zr + kk * 16 * ZLD);
        mma_bf16(oc[0], a, zb[0], zb[1]);
        mma_bf16(oc[1], a, zb[2], zb[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        st_shared_u32(stg + g * S3_OLD + j * 8 + 2 * t, pack2(oc[j][0], oc[j][1]));
        st_shared_u32(stg + (g + 8) * S3_OLD + j * 8 + 2 * t, pack2(oc[j][2], oc[j][3]));
      }
      __syncwarp();
      const int m = lane >> 1;
      if (m < M) {
        const int pr = m / rt, hp = HQ + pr % cy, n = (GQ + pr / cy) * rt + m % rt;
        *reinterpret_cast<uint4*>(p2n + (((size_t)n * L + i) * H + hp) * CZT + d * 16 +
                                  (lane & 1) * 8) =
            ld_shared_v4(stg + (lane >> 1) * S3_OLD + (lane & 1) * 8);
      }
      __syncwarp();
    }
    __syncthreads();               // z buffer k % NZ is free for row k + NZ
  }
}

template <class Plan, int CZT>
int launch_s3(const S3Plan& p, const void* qa, const void* ka, const void* vv,
              const void* bias, const void* z, void* out, void* p2n, int N, int L, int H,
              int reps, cudaStream_t stream) {
  auto kernel = s3_kernel<Plan, CZT>;
  int err = set_smem(kernel, p.smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((L + p.qt - 1) / p.qt, H, N / p.rt);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.cy;
  attr[0].val.clusterDim.z = p.cz;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(qa),
                                static_cast<const bf16*>(ka), static_cast<const bf16*>(vv),
                                static_cast<const bf16*>(bias), static_cast<const bf16*>(z),
                                static_cast<bf16*>(out), static_cast<bf16*>(p2n), L, H, reps,
                                p.rt, p.cy, p.cz);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <class Plan>
int launch_s3_cz(const S3Plan& p, int Cz, const void* qa, const void* ka, const void* vv,
                 const void* bias, const void* z, void* out, void* p2n, int N, int L, int H,
                 int reps, cudaStream_t s) {
  switch (Cz) {
    case 16: return launch_s3<Plan, 16>(p, qa, ka, vv, bias, z, out, p2n, N, L, H, reps, s);
    case 32: return launch_s3<Plan, 32>(p, qa, ka, vv, bias, z, out, p2n, N, L, H, reps, s);
    case 48: return launch_s3<Plan, 48>(p, qa, ka, vv, bias, z, out, p2n, N, L, H, reps, s);
    case 64: return launch_s3<Plan, 64>(p, qa, ka, vv, bias, z, out, p2n, N, L, H, reps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// -------------------------------------------------------------------- S2
// The two wgmma forms S2 takes, in inline PTX (its mbarriers and TMA are
// k1_tiles.cuh's).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) += A (64 x 16) . B (16 x 64), both from shared memory
// through descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers: the mma.sync A
// fragment of each warp's 16 rows) . B (16 x 64) from shared memory,
// MN-major (transposed: 16 rows of 64 contiguous columns).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Shared memory (1024-aligned): NS item stages [Q (64 x 64) | K (Lk x 64) |
// V (Lk x 64)], two bias stages (Lk / 64 boxes of 64 x 64), then the
// mbarriers; every tile 128-byte swizzled by the TMA (sw128). Lk = L
// rounded up to 64.
constexpr int S2_ROWS = 64;                   // query rows a block
constexpr int S2_THREADS = 384;               // two consumer warpgroups + the producer's
constexpr int S2_BOX = 64 * 64 * 2;           // one 64 x 64 bf16 box
constexpr int S2_BIAS_STAGES = 2;

__host__ __device__ inline int s2_lk(int L) { return (L + 63) / 64 * 64; }
__host__ __device__ inline size_t s2_stage(int L) { return S2_BOX + (size_t)2 * s2_lk(L) * 128; }
__host__ __device__ inline size_t s2_bias_stage(int L) { return (size_t)(s2_lk(L) / 64) * S2_BOX; }

struct S2Plan {
  int rt, ns;
  size_t smem;
};

// Four item stages where they fit, else two; rt = 2 replicas a block where
// reps is even (the pair shares each head's bias rows), else 1.
S2Plan s2_plan(int L, int reps) {
  const size_t fixed = 1024 + S2_BIAS_STAGES * s2_bias_stage(L) + 256;
  const int ns = fixed + 4 * s2_stage(L) <= SMEM_BLOCK ? 4 : 2;
  return S2Plan{reps % 2 == 0 ? 2 : 1, ns, fixed + ns * s2_stage(L)};
}

// Grid (ceil(L / 64), N / rt). Item t = h rt + r (head h, replica n =
// blockIdx.y rt + r) is warpgroup t % 2's, in stage t % ns; head h's bias
// rows in bias stage h % 2.
template <int KMAX>
__global__ void __launch_bounds__(S2_THREADS, 1)
s2_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
          bf16* __restrict__ out, bf16* __restrict__ alphas, int L, int H, int reps, int rt,
          int ns) {
  constexpr int NCH = KMAX / 64;
  extern __shared__ __align__(128) unsigned char smraw[];
  unsigned char* sm = align1024(smraw);
  const int Lk = s2_lk(L), nch = Lk / 64, T = H * rt;
  const size_t STG = s2_stage(L), BST = s2_bias_stage(L);
  unsigned char* bias_sm = sm + ns * STG;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bias_sm + S2_BIAS_STAGES * BST);
  uint64_t *full = bars, *empty = bars + 4, *bfull = bars + 8, *bempty = bars + 10;
  const int tid = threadIdx.x, i0 = blockIdx.x * S2_ROWS;
  const int c = blockIdx.y * rt / reps;

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    for (int b = 0; b < S2_BIAS_STAGES; ++b) {
      mbar_init(&bfull[b], 1);
      mbar_init(&bempty[b], 128 * rt);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // 168 registers a thread at launch (384 threads); the producer
  // warpgroup keeps 40, each consumer takes 232.
  if (tid >= 256) {                // the producer warpgroup; one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 256) return;
    for (int t = 0; t < T; ++t) {
      const int h = t / rt, r = t - h * rt, n = blockIdx.y * rt + r;
      if (r == 0) {
        const int b = h % S2_BIAS_STAGES;
        mbar_wait(&bempty[b], ((h / S2_BIAS_STAGES) & 1) ^ 1);
        mbar_expect_tx(&bfull[b], (uint32_t)BST);
        for (int cb = 0; cb < nch; ++cb)
          tma_load3(bias_sm + b * BST + cb * S2_BOX, &tb, &bfull[b], cb * 64, i0, c * H + h);
      }
      const int s = t % ns;
      unsigned char* st = sm + s * STG;
      mbar_wait(&empty[s], ((t / ns) & 1) ^ 1);
      mbar_expect_tx(&full[s], (uint32_t)STG);
      tma_load3(st, &tq, &full[s], h * 64, i0, n);
      tma_load3(st + S2_BOX, &tk, &full[s], h * 64, 0, n);
      tma_load3(st + S2_BOX + (size_t)Lk * 128, &tv, &full[s], h * 64, 0, n);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid >> 7, wtid = tid & 127, w = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, r0 = 16 * w + g, HD = H * SLOT;
  auto wg_sync = [&]() { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };
  for (int t = wg; t < T; t += 2) {
    const int h = t / rt, r = t - h * rt, n = blockIdx.y * rt + r;
    const int s = t % ns, b = h % S2_BIAS_STAGES;
    unsigned char* Qs = sm + s * STG;
    unsigned char* Ks = Qs + S2_BOX;
    unsigned char* Vs = Ks + (size_t)Lk * 128;
    const unsigned char* Bs = bias_sm + b * BST;
    mbar_wait(&full[s], (t / ns) & 1);
    mbar_wait(&bfull[b], (h / S2_BIAS_STAGES) & 1);

    // Logits: chunk ch holds keys 64 ch .. + 63 (n8 block j: keys 64 ch +
    // 8 j + 2 t4, + 1 of rows r0 and r0 + 8).
    float acc[NCH][32];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[ch][e] = 0.0f;
      reg_fence(acc[ch]);
    }
    wgmma_fence();
    const uint64_t dq = sw128_desc(Qs);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      if (ch < nch) {
        const uint64_t dk = sw128_desc(Ks + ch * S2_BOX);
#pragma unroll
        for (int k = 0; k < SLOT / 16; ++k) wgmma_ss_n64(acc[ch], dq + 2 * k, dk + 2 * k);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) reg_fence(acc[ch]);

    // + bias, exact max-subtract softmax in f32 over the quad's registers;
    // keys past L carry no weight.
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      if (ch < nch) {
        const unsigned char* bb = Bs + ch * S2_BOX;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (ch * 64 + j * 8 + 2 * t4 < L) {
            const float2 u = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(bb + sw128(r0, j) + 4 * t4));
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(bb + sw128(r0 + 8, j) + 4 * t4));
            acc[ch][4 * j] += u.x;
            acc[ch][4 * j + 1] += u.y;
            acc[ch][4 * j + 2] += x.x;
            acc[ch][4 * j + 3] += x.y;
            m0 = fmaxf(m0, fmaxf(acc[ch][4 * j], acc[ch][4 * j + 1]));
            m1 = fmaxf(m1, fmaxf(acc[ch][4 * j + 2], acc[ch][4 * j + 3]));
          } else {
            acc[ch][4 * j] = acc[ch][4 * j + 1] = -INFINITY;
            acc[ch][4 * j + 2] = acc[ch][4 * j + 3] = -INFINITY;
          }
        }
      }
    }
    mbar_arrive(&bempty[b]);       // this thread's bias reads are done
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      if (ch < nch) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[ch][4 * j] = __expf(acc[ch][4 * j] - m0);
          acc[ch][4 * j + 1] = __expf(acc[ch][4 * j + 1] - m0);
          acc[ch][4 * j + 2] = __expf(acc[ch][4 * j + 2] - m1);
          acc[ch][4 * j + 3] = __expf(acc[ch][4 * j + 3] - m1);
          l0 += acc[ch][4 * j] + acc[ch][4 * j + 1];
          l1 += acc[ch][4 * j + 2] + acc[ch][4 * j + 3];
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    uint32_t p[NCH][8][2];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[ch][j][0] = pack2(acc[ch][4 * j] * inv0, acc[ch][4 * j + 1] * inv0);
        p[ch][j][1] = pack2(acc[ch][4 * j + 2] * inv1, acc[ch][4 * j + 3] * inv1);
      }
    }

    // alphas out, 64 key columns at a time through the stage's Q tile (the
    // logits have read it).
    bf16* ga = alphas + (((size_t)n * H + h) * L + i0) * L;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      if (ch < nch) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          st_shared_u32(Qs + sw128(r0, j) + 4 * t4, p[ch][j][0]);
          st_shared_u32(Qs + sw128(r0 + 8, j) + 4 * t4, p[ch][j][1]);
        }
        wg_sync();
#pragma unroll
        for (int u = wtid; u < S2_ROWS * 8; u += 128) {
          const int row = u >> 3, q = u & 7, col = ch * 64 + q * 8;
          if (i0 + row < L && col < L)
            *reinterpret_cast<uint4*>(ga + (size_t)row * L + col) = ld_shared_v4(Qs + sw128(row, q));
        }
        wg_sync();
      }
    }

    // o = alpha . V: the packed alphas are the A fragments; V (keys x 64)
    // is B read transposed, 16 keys (2048 bytes) a step.
    float o[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.0f;
    reg_fence(o);
    wgmma_fence();
    const uint64_t dv = sw128_desc(Vs);
#pragma unroll
    for (int kk = 0; kk < KMAX / 16; ++kk) {
      if (kk < L / 16) {
        const int ch = kk >> 2, jj = (kk & 3) * 2;
        const uint32_t a[4] = {p[ch][jj][0], p[ch][jj][1], p[ch][jj + 1][0], p[ch][jj + 1][1]};
        wgmma_rs_n64_tb(o, a, dv + (uint64_t)(kk * (2048 >> 4)));
      }
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(o);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        asm volatile("" : "+r"(p[ch][j][0]), "+r"(p[ch][j][1])::"memory");

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      st_shared_u32(Qs + sw128(r0, j) + 4 * t4, pack2(o[4 * j], o[4 * j + 1]));
      st_shared_u32(Qs + sw128(r0 + 8, j) + 4 * t4, pack2(o[4 * j + 2], o[4 * j + 3]));
    }
    wg_sync();
#pragma unroll
    for (int u = wtid; u < S2_ROWS * 8; u += 128) {
      const int row = u >> 3, q = u & 7;
      if (i0 + row < L)
        *reinterpret_cast<uint4*>(out + ((size_t)n * L + i0 + row) * HD + h * SLOT + q * 8) =
            ld_shared_v4(Qs + sw128(row, q));
    }
    fence_proxy_async();           // the staging writes before the next TMA into Qs
    mbar_arrive(&empty[s]);
  }
}

// ------------------------------------------------------------- host side

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

// Every kernel here takes L a multiple of 16 up to 256.
bool shapes_ok(int N, int L, int H, int reps) {
  return N > 0 && H > 0 && L >= 16 && L % 16 == 0 && L <= 256 && reps > 0 && N % reps == 0 &&
         N <= 65535;
}

template <int KMAX>
int launch_s2(const CUtensorMap* maps, void* out, void* alphas, int N, int L, int H, int reps,
              const S2Plan& p, cudaStream_t stream) {
  int err = set_smem(s2_kernel<KMAX>, p.smem);
  if (err) return err;
  s2_kernel<KMAX><<<dim3((L + S2_ROWS - 1) / S2_ROWS, N / p.rt), S2_THREADS, p.smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(out), static_cast<bf16*>(alphas), L,
      H, reps, p.rt, p.ns);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory a block of S1 takes at L, in bytes (whatever H).
extern "C" size_t attention_tile_smem(int L) {
  return L <= 128 ? AttnLean::smem(L) : AttnLarge::smem(L);
}

// S3's plan for the wrapper's check: [query rows a block, threads, rt, cy,
// cz, M, shared memory]. Returns 0, or an error for a shape it does not
// take.
extern "C" int attention_v4_plan(int L, int H, int Cz, int reps, long long* out) {
  S3Plan p;
  if (!shapes_ok(reps, L, H, reps) || H > 16 || Cz < 16 || Cz > 64 || Cz % 16 != 0 ||
      !s3_plan(L, H, Cz, reps, &p))
    return (int)cudaErrorInvalidValue;
  const long long v[7] = {p.qt, p.threads, p.rt, p.cy, p.cz, p.m, (long long)p.smem};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
  return 0;
}

// S2's plan: [rt, item stages, shared memory].
extern "C" int attention_v2_plan(int L, int reps, long long* out) {
  if (!shapes_ok(reps, L, 1, reps)) return (int)cudaErrorInvalidValue;
  const S2Plan p = s2_plan(L, reps);
  out[0] = p.rt;
  out[1] = p.ns;
  out[2] = (long long)p.smem;
  return 0;
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
  if (!shapes_ok(N, L, H, reps) || rt < 1 || reps % rt != 0)
    return (int)cudaErrorInvalidValue;
  if (alphas)
    return launch_s1<ALPHA_K2>(qa, ka, vv, bias, out, alphas, N, L, H, reps, rt, s);
  return launch_s1<ALPHA_NONE>(qa, ka, vv, bias, out, alphas, N, L, H, reps, rt, s);
}

// S3 (v4): out and p2n, one launch. As attention_tile, on `stream`.
extern "C" int attention_v4(const void* qa, const void* ka, const void* vv, const void* bias,
                            const void* z, void* out, void* p2n, int N, int L, int H, int Cz,
                            int reps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  S3Plan p;
  if (!shapes_ok(N, L, H, reps) || H > 16 || Cz < 16 || Cz > 64 || Cz % 16 != 0 ||
      !s3_plan(L, H, Cz, reps, &p))
    return (int)cudaErrorInvalidValue;
  if (L <= 128)
    return launch_s3_cz<S3Small>(p, Cz, qa, ka, vv, bias, z, out, p2n, N, L, H, reps, s);
  return launch_s3_cz<S3Large>(p, Cz, qa, ka, vv, bias, z, out, p2n, N, L, H, reps, s);
}

// S2 (v2): out and alphas, one launch. The tensor maps are encoded here, on
// the host, each call. As attention_tile, on `stream`; a map the driver
// refuses returns cudaErrorInvalidValue.
extern "C" int attention_v2(const void* qa, const void* ka, const void* vv, const void* bias,
                            void* out, void* alphas, int N, int L, int H, int reps,
                            void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!shapes_ok(N, L, H, reps)) return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const uint64_t HD = (uint64_t)H * SLOT;
  CUtensorMap maps[4];
  if (!map3(fn, &maps[0], qa, HD, L, N, S2_ROWS) ||
      !map3(fn, &maps[1], ka, HD, L, N, s2_lk(L)) ||
      !map3(fn, &maps[2], vv, HD, L, N, s2_lk(L)) ||
      !map3(fn, &maps[3], bias, L, L, (uint64_t)(N / reps) * H, S2_ROWS))
    return (int)cudaErrorInvalidValue;
  const S2Plan p = s2_plan(L, reps);
  if (L <= 128) return launch_s2<128>(maps, out, alphas, N, L, H, reps, p, s);
  return launch_s2<256>(maps, out, alphas, N, L, H, reps, p, s);
}

extern "C" const char* attention_variants_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
