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
// layer's first design 1.42 ms in the same run.
//
// K1's launches (gablock_forward; S4's entry below runs the same ones),
// each a thin __global__ wrapper over a tile of k1_tiles.cuh (which K5's
// persistent chain, csrc/gablock_chain.cu, runs as work items):
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
//      and serve all rt replicas; each replica's K, V and Q tiles arrive in
//      a ring of two or three stages, the next replicas loading while the
//      current one computes. Logits come
//      from mma.sync m16n8k16 and stay in registers (a whole key row, L <=
//      256); + bias[n // reps], the exact max-subtract softmax in f32 with
//      quad shuffles, alpha packed to bf16 pairs that are both the A operand
//      of alpha . vvp and, through a 16-row staging tile, 16-byte stores of
//      alpha in the (Nc, L, reps*H, L) layout p2n reads; o leaves the same
//      way. Up to L=128 the plan is AttnSmall (8 warps, 128 query rows,
//      three cp.async stages); past it AttnRing (k1_attn_tile_tma): 8
//      warps and 128 query rows (two tiles a replica at L=256), two stages
//      of K, V and Q filled by TMA (one thread issues, an mbarrier a stage
//      counts the bytes) into 128-byte-swizzled rows of 64 bf16, the bias
//      rows in swizzled 64-column blocks; 230,464 bytes of shared memory at
//      L=256, one block and eight warps an SM, the next replica's loads in
//      flight while the current one computes. Bytes bound it: at N = 256,
//      L = 256, H = 12 qa, ka, vv, o, alpha and the bias are 807 MB, 241 us
//      at 3.35 TB/s, against 46 us of tensor-core work; AttnRing takes
//      414 us there, AttnLarge 1286 (H100 80GB HBM3, 700 W). At L=256 the
//      launch takes an instance whose key count is a constant (FULL). K2,
//      K4 and S1 keep AttnLarge (4 warps, 64 query rows, two cp.async
//      stages) past L=128: their alpha layouts and K4's hook run on
//      k1_attn_tile, and S3's alpha in shared memory has no room beside
//      AttnRing's stages.
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
// runs K1's own launches through gablock_forward_variant(..., abl, rt); its
// wrappers are in ops/gablock_variants.py. Both entries run forward_k1<ABL>:
// gablock_forward is forward_k1<0>, so v3 (mask 0, the caller's rt) and the
// abl baseline (mask 0, K1's rt) are K1 by construction, and each ablation
// prices a phase of K1's launches as they are.
//   v3: the attention's replica group rt (K1 takes the largest of 4, 2, 1
//     that divides reps); a group changes which block runs a replica, never
//     a warp's sums, so v3 equals K1 bit for bit at every rt.
//   abl: a mask of the ABL_* bits (k1_tiles.cuh). The bits of ABL_ASSEMBLE,
//     ABL_ATTN and ABL_FEAT select a variant of that tile (if constexpr);
//     the others act on the launches here. Mask 0 is K1.
//   flag (script)   counterpart here
//   skip_p2n        k1_p2n_kernel not launched; the p2n feature columns zero
//                   (cudaMemset2DAsync)
//   fake_softmax    attention tile: alpha = bf16(0.01 (logits + bias)), no
//                   max/exp/sum
//   fake_alpha      attention tile: alpha = bf16(0.01 bias); no Q . K, and a
//                   stage loads V only (K's and Q's rows dropped)
//   skip_rot        assemble_row without R, t; feat_row without R^T (. - t)
//   skip_mlp        the LN1 GEMM writes out; MLP1-3 and LN2 not launched
//   skip_sq         assemble_row: the |p|^2 slot takes the first H planar
//                   point columns (x of the operand's first H points)
//   fake_feat       k1_feat_kernel not launched; fake_feat_kernel fills the
//                   H (VD + 7 NPV) non-p2n feature columns with
//                   [o | o[:, :H (VD + 7 NPV) - H SLOT]] over o's 64-wide
//                   slots (pad zero): a copy of the bytes feat_row moves
//   skip_values     attention tile: no alpha . V; o = the replica's own vvp
//                   rows
//   thin_ops        assemble_row: the point and |p|^2 slots of qa/ka and the
//                   point slots of vvp zero, no point computed, the constant
//                   slots kept
//   skip_sect       none: the projection here is operand-major, so there is
//                   no section gather to drop (the baseline's mask)
//   skip_out, skip_wpts  none: the TPU body never reads them
//   floor           the seven flags skip_sq, skip_values, fake_feat,
//                   fake_alpha, skip_rot, skip_p2n, skip_mlp
// The entry takes the masks the harness uses: 0, each single bit, the
// floor. S4 once ran the layer's first design (WMMA GEMMs with synchronous
// loads, one attention block per trajectory with the logits in an f32
// shared-memory tile); its last times, abl 1.4075 and v3 1.3439 ms a layer
// at reps 256 on an H100 80GB HBM3 at 700 W, stand in PERF.md.

#include "k1_tiles.cuh"

namespace {

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
// row) a block. ABL: the bits of S4's mask the tile reads (0 for K1).

// One row per block of 256 threads.
template <int ABL>
__global__ void __launch_bounds__(256)
k1_assemble_kernel(const bf16* __restrict__ proj, int pw, const float* __restrict__ R9,
                   const float* __restrict__ tr, const float* __restrict__ coef, int H,
                   bf16* __restrict__ qa, bf16* __restrict__ ka, bf16* __restrict__ vv) {
  extern __shared__ float smf[];
  const size_t row = blockIdx.x;
  assemble_row<256, ABL>(row, threadIdx.x, proj + row * pw, R9 + row * 9, tr + row * 3, coef,
                         H, qa, ka, vv, smf);
}

// Block = (query tile, head h, replicas blockIdx.z * rt .. + rt - 1).
template <class Plan, int ABL>
__global__ void __launch_bounds__(Plan::QW * 32, 1)
k1_attn_kernel(const bf16* __restrict__ qa, const bf16* __restrict__ ka,
               const bf16* __restrict__ vv, const bf16* __restrict__ bias,
               bf16* __restrict__ o, bf16* __restrict__ alpha, int L, int H,
               int reps, int rt) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int h = blockIdx.y, n0 = blockIdx.z * rt;
  k1_attn_tile<Plan, ALPHA_K1, NoHook, ABL>(blockIdx.x * Plan::QT, h, n0, rt, qa, ka, vv,
                                            bias + ((size_t)(n0 / reps) * H + h) * L * L, o,
                                            alpha, L, H, reps, smraw);
}

// Block = (64 of the reps*H alpha rows, query row i, complex c).
__global__ void __launch_bounds__(128)
k1_p2n_kernel(const bf16* __restrict__ alpha, const bf16* __restrict__ z,
              bf16* __restrict__ feat, int ko, int L, int H, int reps) {
  extern __shared__ __align__(128) unsigned char smraw[];
  p2n_tile<128>(blockIdx.x * 64, blockIdx.y, blockIdx.z, alpha, z, feat, ko, L, H, reps, smraw);
}

// One row per block of 128 threads.
template <int ABL>
__global__ void __launch_bounds__(128)
k1_feat_kernel(const bf16* __restrict__ o, const float* __restrict__ R9,
               const float* __restrict__ tr, bf16* __restrict__ feat, int ko, int H) {
  const size_t row = blockIdx.x;
  feat_row<128, ABL>(row, threadIdx.x, o + row * H * SLOT, R9 + row * 9, tr + row * 3, feat,
                     ko, H);
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

// The same block on AttnRing (K1 past L=128): the operands through
// their tensor maps (k1_attn_tile_tma); FULL when L == Plan::KMAX.
template <class Plan, int ABL, bool FULL>
__global__ void __launch_bounds__(Plan::QW * 32, 1)
k1_attn_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
               bf16* __restrict__ o, bf16* __restrict__ alpha, int L, int H, int reps, int rt) {
  extern __shared__ __align__(128) unsigned char smraw[];
  k1_attn_tile_tma<Plan, ABL, FULL>(blockIdx.x * Plan::QT, blockIdx.y, blockIdx.z * rt, rt, &tq, &tk,
                              &tv, &tb, o, alpha, L, H, reps, smraw);
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

// The arguments of one layer (gablock_forward's, in its order); the weight
// matrices w_proj, w_out and w_m1..3 transposed, (N, K).
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

// ------------------------------------------------------- K1's launches

// The query tiles of one replica at L: each replica's L rows take tiles of
// their own, so the last holds L - (tiles - 1) * QT residues.
template <class Plan>
constexpr int attn_query_tiles(int L) { return (L + Plan::QT - 1) / Plan::QT; }

// rt: the replicas an attention block serves (>= 1, dividing reps; the
// wrapper passes the largest of 4, 2, 1 that divides reps, S4's v3 its own).
template <class Plan, int ABL>
cudaError_t launch_attn(const bf16* qa, const bf16* ka, const bf16* vv, const bf16* bias,
                        bf16* o, bf16* alpha, int N, int L, int H, int reps, int rt,
                        cudaStream_t stream) {
  if (rt < 1 || reps % rt != 0) return cudaErrorInvalidValue;
  // k1_attn_kernel is overloaded (AttnRing's takes tensor maps): the
  // pointer's type names this form.
  void (*kernel)(const bf16*, const bf16*, const bf16*, const bf16*, bf16*, bf16*, int, int,
                 int, int) = k1_attn_kernel<Plan, ABL>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Plan::smem(L));
  if (err != cudaSuccess) return err;
  k1_attn_kernel<Plan, ABL>
      <<<dim3(attn_query_tiles<Plan>(L), H, N / rt), Plan::QW * 32, Plan::smem(L), stream>>>(
          qa, ka, vv, bias, o, alpha, L, H, reps, rt);
  return cudaGetLastError();
}

// The same launch on AttnRing: qa, ka, vv and the bias as 3-D tensor
// maps, encoded here each call (a CUDA graph keeps the captured ones).
template <class Plan, int ABL>
cudaError_t launch_attn_tma(const bf16* qa, const bf16* ka, const bf16* vv, const bf16* bias,
                            bf16* o, bf16* alpha, int N, int L, int H, int reps, int rt,
                            cudaStream_t stream) {
  if (rt < 1 || reps % rt != 0) return cudaErrorInvalidValue;
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const uint64_t HD = (uint64_t)H * SLOT;
  CUtensorMap m[4];
  if (!map3(fn, &m[0], qa, HD, L, N, Plan::QT) || !map3(fn, &m[1], ka, HD, L, N, L) ||
      !map3(fn, &m[2], vv, HD, L, N, L) ||
      !map3(fn, &m[3], bias, L, L, (uint64_t)(N / reps) * H, Plan::QT))
    return cudaErrorInvalidValue;
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, bf16*, bf16*, int, int,
                 int, int) = k1_attn_kernel<Plan, ABL, false>;
  if (L == Plan::KMAX) kernel = k1_attn_kernel<Plan, ABL, true>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Plan::smem(L));
  if (err != cudaSuccess) return err;
  void* args[] = {&m[0], &m[1], &m[2], &m[3], &o, &alpha, &L, &H, &reps, &rt};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                          dim3(attn_query_tiles<Plan>(L), H, N / rt), dim3(Plan::QW * 32), args,
                          Plan::smem(L), stream);
}

// The attention plan K1 takes at L: AttnSmall up to 128 residues, else
// AttnRing (gablock_attention_plan reports it).
inline bool k1_attn_small(int L) { return L <= 128; }

template <int ABL = 0>
cudaError_t launch_k1_attention(const bf16* qa, const bf16* ka, const bf16* vv,
                                const bf16* bias, bf16* o, bf16* alpha, int N, int L, int H,
                                int reps, int rt, cudaStream_t stream) {
  if (k1_attn_small(L))
    return launch_attn<AttnSmall, ABL>(qa, ka, vv, bias, o, alpha, N, L, H, reps, rt, stream);
  return launch_attn_tma<AttnRing, ABL>(qa, ka, vv, bias, o, alpha, N, L, H, reps, rt, stream);
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
// transposed, see LayerArgs); rt as launch_attn takes it. ABL: S4's
// ablation mask (0: K1 itself), the tiles' bits passed to the launches that
// read them, the others acting here.
template <int ABL>
int forward_k1(const LayerArgs& a, int rt) {
  cudaStream_t stream = a.stream;
  const int N = a.N, L = a.L, H = a.H, reps = a.reps, pw = a.pw, ko = a.ko;
  Workspace w;
  carve(reinterpret_cast<unsigned char*>(a.workspace), N, L, H, pw, ko, &w);
  const int M = N * L;
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

  k1_assemble_kernel<ABL & ABL_ASSEMBLE><<<M, 256, assemble_floats(H) * sizeof(float), stream>>>(
      w.proj, pw, a.R9, a.t, a.coef, H, w.qa, w.ka, w.vv);
  K1_CHECK(cudaGetLastError());

  K1_CHECK(launch_k1_attention<ABL & ABL_ATTN>(w.qa, w.ka, w.vv, a.bias, w.o, w.alpha, N, L, H,
                                               reps, rt, stream));

  if constexpr ((ABL & ABL_SKIP_P2N) != 0)
    K1_CHECK(cudaMemset2DAsync(w.feat, (size_t)ko * 2, 0, (size_t)H * CZ * 2, M, stream));
  else
    K1_CHECK(launch_k1_p2n(w.alpha, a.z, w.feat, ko, N / reps, L, H, reps, stream));
  if constexpr ((ABL & ABL_FAKE_FEAT) != 0) {
    const size_t vecs = (size_t)M * (ko - H * CZ) / 8;
    fake_feat_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, stream>>>(w.o, w.feat, vecs, ko,
                                                                          H);
  } else {
    k1_feat_kernel<ABL & ABL_FEAT><<<M, 128, 0, stream>>>(w.o, a.R9, a.t, w.feat, ko, H);
  }
  K1_CHECK(cudaGetLastError());

  constexpr bool kSkipMlp = (ABL & ABL_SKIP_MLP) != 0;
  ep = Epi{};
  ep.bias = a.b_out;
  ep.resid = a.x;
  ep.rowmask = a.mask;
  ep.ln = a.ln1;
  ep.out_f32 = kSkipMlp ? a.out : w.x1;
  ep.out_bf16 = kSkipMlp ? nullptr : w.x1b;
  K1_CHECK(launch_k1_gemm<EPI_LN>(w.feat, ko, a.w_out, M, ko, ep, stream));
  if constexpr (kSkipMlp) return 0;

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
  return forward_k1<0>(GB_LAYER_ARGS, rt);
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

// K1's attention plan at L, as launch_k1_attention launches it for a block
// of rt replicas: returns the plan's query tile QT (the query rows a tile
// computes at once) and writes the tiles one head of the block computes,
// of which rt * L rows hold a residue.
extern "C" int gablock_attention_plan(int L, int rt, int* tiles) {
  if (k1_attn_small(L)) {
    *tiles = rt * attn_query_tiles<AttnSmall>(L);
    return AttnSmall::QT;
  }
  *tiles = rt * attn_query_tiles<AttnRing>(L);
  return AttnRing::QT;
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

// S4: one layer through K1's launches (forward_k1<abl>) with the ablation
// mask `abl` (a mask the switch lists; 0 is K1) and the attention in blocks
// of rt replicas (rt >= 1 dividing reps: v3's parameter; the abl wrapper
// passes K1's). Anything else returns cudaErrorInvalidValue.
extern "C" int gablock_forward_variant(GB_LAYER_PARAMS, int abl, int rt) {
  const LayerArgs a = GB_LAYER_ARGS;
  if (rt < 1 || reps % rt != 0) return (int)cudaErrorInvalidValue;
  switch (abl) {
#define GB_CASE(m) \
  case m:          \
    return forward_k1<m>(a, rt);
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
