// The whole GAEncoder (every GABlock layer of one sampling step) in one
// launch, for Hopper (sm_90a), bf16 tensor cores: K5.
//
// Replaces the TPU kernel ab_opt_tpu/ops/gablock_pallas.py:409
// _encoder_chain_kernel (called by :616 fused_encoder_chained): NL GABlock
// layers in sequence, with R, t, z and the row mask fixed across layers and
// x carried from layer to layer, never leaving the chip between layers.
// Each layer computes what csrc/gablock.cu (K1) computes, with the same
// rounding points: bf16 x, projections, qa/ka/vvp, alpha, attention values,
// p2n, feature matrix and MLP inputs; f32 R, t, softmax (exact, max
// subtracted) and LayerNorm.
//
// What bounds it on this card. At N = 256 trajectories, L = 128, H = 12 and
// six layers the encoder is ~320 GFLOP of tensor-core work (six times K1's
// 53.35 GFLOP), 0.32 ms at the 989 TFLOP/s bf16 dense peak, while the bytes
// it must move (x in and out, R, t, mask, z, six biases, six layers'
// weights: ~57 MB) take 0.017 ms at 3.35 TB/s: it is bound by operations.
// K1 is not: it spends its time on 54 launches a step and ~1 GB a layer of
// intermediates through device memory (the (N, H, L, L) alphas alone are
// ~100 MB). This design removes both: one launch, x and the alphas on
// chip, every product on the tensor cores (wmma m16n16k16, bf16 in, f32
// accumulate). What is left between it and its bound is L2 traffic and
// latency: every block re-reads each layer's weights per 16-row tile
// (w_out and the MLP, ~565 KB a tile), K and V per head and tile (~3 MB a
// layer) and z per tile (2 MB a layer), ~11 MB a layer a trajectory, which
// one block of 8 warps pulls at ~10 bytes a cycle; and the fill of one
// block a trajectory (32 of 132 SMs at fan-out 32). Measured on an H100
// 80GB HBM3 at 700 W: ~12.1 ms per encoder pass at N = 256 (six K1
// launches: ~8.4 ms) and ~5.7 ms at N = 32 (six K1 launches: ~1.6 ms);
// block 0's cycles (utils/profile_chain.py): tail 24%, projection 17%, p2n
// 14%, staging 13%, softmax 12%, alpha . V 9%. A tail over all L rows (the
// weights read once a layer), wgmma, TMA bulk copies, clusters that split a
// trajectory's tiles and weight multicast are later work.
//
// Design. One block of 256 threads owns one trajectory at a time; a
// persistent grid of at most (SMs x blocks per SM) blocks loops over the N
// trajectories. Per trajectory, x (L x 128 f32) lives in shared memory (or,
// where it does not fit, in the output rows, which then carry it). Per
// layer, inside the block:
//   1. projection: x -> bf16, then for each 64-wide slot (q, k or v of head
//      h: 32 features and 8 points x 3, gathered from w_proj's planar
//      columns while the slot is staged) one 16 x 64 tile a warp and row
//      tile; its epilogue rounds to bf16, rotates the points to the global
//      frame, takes |p|^2 and writes the assembled qa / ka / vvp rows to the
//      block's scratch slab (3 x L x H x 64 bf16, in L2), which the wrapper
//      allocates;
//   2. __syncthreads: every row's keys and values are in the slab;
//   3. per 16-row query tile, per head: K and V of the head staged in
//      shared memory, logits + bias[c, layer, h], exact softmax, alpha
//      rounded to bf16 into the tile's alpha buffer (all heads), alpha . V,
//      then the node values and the local-frame point features of that head
//      straight into the tile's feature rows; after the last head, p2n =
//      alpha . z[c, i] per query row, all heads of a row in one 16 x L tile
//      of the alpha buffer, into the feature rows too;
//   4. the row-local tail of the tile: out_transform + bias, row mask,
//      residual, LN1, the three-layer ReLU MLP, LN2, written over the
//      tile's own x rows (every other row's x was consumed by this layer's
//      projection before step 2);
//   5. __syncthreads before the next layer's projection.
// No grid-wide barrier is needed, and the (N, H, L, L) alphas never reach
// device memory. The layer loop is a runtime loop over the stacked weights.
//
// Every tile that a step reads from device memory (a weight slot, K, V and
// the bias rows of a head, two rows of z, 128-row chunks of w_out and the
// MLP weights) is staged with cp.async, all copies in flight at once; the
// query fragments of a head load straight from the slab meanwhile.
//
// Shared memory at L = 128, H = 12 (226 KB of the 227 KB a block may use,
// so one block an SM): x 64 KB; the tile's alphas 55 KB, ((15 H + 16) rows
// of L + 16: alpha[h] of query r at row r H + h, so a 16-row wmma tile at
// row r H holds every head of query r for p2n and head h's 16 x L alpha is
// rows h + H r for the value product; during the projection the same bytes
// hold x in bf16 and the staged weight slot, during the tail the staged
// weight chunk); K and V of a head 36 KB (then two query rows of z, then
// the tail's bf16 and f32 tiles); the tile's feature rows 57 KB; logits
// 8 KB; a head's bias rows 4 KB; R, t and mask 1 KB.
// Where x does not fit (L > 128, or large H) it moves to the output rows,
// and then the feature rows to the slab; a layout that still does not fit
// is refused.
//
// Fixed head geometry (the DiffAb defaults): query/key width 32, value
// width 32, 8 query points, 8 value points, pair width 64, node width 128.
// H (a multiple of 4) and L (a multiple of 16, at most 256) are runtime
// values. The Python wrapper (ops/gablock.py) checks all of this.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <math.h>
#include <algorithm>

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
constexpr int NT = 256;    // threads per block
constexpr int NW = NT / 32;
constexpr int TQ = 16;     // query rows per tile
constexpr int RPW = TQ / NW;   // softmax rows per warp
constexpr int KLD = SLOT + 8;  // pitch of 64-wide bf16 tiles
constexpr int XLD = FD + 8;    // pitch of 128-wide bf16 rows
constexpr int PLD = SLOT + 4;  // pitch of the projection's f32 staging
constexpr int TLD = FD + 4;    // pitch of the tail's f32 tile
constexpr int RTLD = 16;       // floats per row of the tile's R, t, mask
constexpr size_t SMEM_BLOCK = 232448;
constexpr int ERR_SMEM = 10001;      // the layout does not fit
constexpr int ERR_WORKSPACE = 10002; // the workspace is too small

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 tobf(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float rbf(float v) { return bf(tobf(v)); }

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte asynchronous copy global -> shared (cp.async, L2 only): a
// staging loop issues all its copies before any returns, and one wait
// covers them, so a tile costs one L2 round trip, not one per load.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ inline int sld(int L) { return (L > FD ? L : FD) + 4; }
__host__ __device__ inline int mtiles(int H) { return (H + 15) / 16; }
__host__ __device__ inline int alpha_rows(int H) { return (TQ - 1) * H + 16 * mtiles(H); }

// Byte offsets of the shared-memory regions; x and the feature rows live
// in shared memory only where the flags say so.
struct Layout {
  int x_smem, feat_smem;
  size_t a, kv, q, rt, s, x, feat, total;
};

struct Args {
  const float *x, *R9, *t, *mask;
  const bf16 *z, *bias, *w_proj, *w_out, *w_m1, *w_m2, *w_m3;
  const float *coef, *b_out, *ln1, *b_m, *ln2;
  float* out;
  unsigned char* slab;
  size_t slab_bytes;
  int pw, ko, N, L, H, reps, NL;
  Layout lay;
};

// Fragments of a B operand that lives in device memory (L2) load GB
// k-steps at a time, so their latencies overlap; the products alternate
// between two accumulators, so consecutive MMAs do not wait on each other.
constexpr int GB = 6;

__device__ __forceinline__ void add_acc(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>& a,
    const wmma::fragment<wmma::accumulator, 16, 16, 16, float>& b) {
#pragma unroll
  for (int e = 0; e < a.num_elements; ++e) a.x[e] += b.x[e];
}

// acc = sum over k < 16 nk of A[:, k] B[k, :] for one 16 x 16 output tile:
// A (16 x 16 nk, bf16, pitch lda) in shared memory or the slab; B's 16
// columns (16 nk x 16, bf16, pitch ldb) in device memory.
__device__ __forceinline__ void tile_product_l2(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>& acc, const bf16* A,
    int lda, const bf16* B, int ldb, int nk) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2;
  wmma::fill_fragment(acc, 0.0f);
  wmma::fill_fragment(acc2, 0.0f);
  int k = 0;
  for (; k + GB <= nk; k += GB) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[GB];
#pragma unroll
    for (int u = 0; u < GB; ++u)
      wmma::load_matrix_sync(bfr[u], B + (size_t)(k + u) * 16 * ldb, ldb);
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, A + (k + u) * 16, lda);
      if (u & 1) wmma::mma_sync(acc2, af, bfr[u], acc2);
      else wmma::mma_sync(acc, af, bfr[u], acc);
    }
  }
  for (; k < nk; ++k) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
    wmma::load_matrix_sync(bfr, B + (size_t)k * 16 * ldb, ldb);
    wmma::load_matrix_sync(af, A + k * 16, lda);
    wmma::mma_sync(acc, af, bfr, acc);
  }
  add_acc(acc, acc2);
}

// C (16 x 128, f32, pitch ldc) = A (16 x K, bf16, pitch lda) @ B (K x 128,
// bf16 row-major in device memory); warp w computes the 16 columns at 16 w.
__device__ __forceinline__ void row_tile_gemm(const bf16* A, int lda,
                                              const bf16* B, int K, float* C,
                                              int ldc, int warp) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  tile_product_l2(acc, A, lda, B + warp * 16, FD, K / 16);
  wmma::store_matrix_sync(C + warp * 16, acc, ldc, wmma::mem_row_major);
}

// LayerNorm over one 128-wide row held as 4 values a lane (column
// lane + 32 q); returns the normalised values in v.
__device__ __forceinline__ void layer_norm(float (&v)[4], const float* ln,
                                           int lane) {
  float s = v[0] + v[1] + v[2] + v[3];
  const float mean = warp_sum(s) * (1.0f / FD);
  float s2 = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float d = v[q] - mean;
    s2 += d * d;
  }
  const float rstd = rsqrtf(warp_sum(s2) * (1.0f / FD) + 1e-10f);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = lane + 32 * q;
    v[q] = (v[q] - mean) * rstd * ln[c] + ln[FD + c];
  }
}

// Column of w_proj where group g (8 columns) of the 64-wide slot of
// (kind, h) starts: groups 0-3 the 32 features, 4-6 the x, y, z planes of
// the 8 points; kind 0 q, 1 k, 2 v. w_proj's column order is [q | k | v |
// qp | kp | vp], each point block planar ([x | y | z], head-major inside).
__device__ __forceinline__ int slot_col(int kind, int h, int g, int H) {
  if (g < 4) return kind * H * QK + h * QK + g * 8;   // QK == VD
  const int c = g - 4, HP = H * NP;
  return H * (2 * QK + VD) + kind * 3 * HP + c * HP + h * NP;   // NP == NPV
}

// Phases of a layer, for a profiling build only (-DGABLOCK_CHAIN_PROFILE,
// utils/profile_chain.py): block 0's thread 0 adds the clock64 cycles since
// its last mark to the phase it has just finished; each mark follows a
// barrier, so a phase's cycles are the block's. Other builds compile the
// marks to nothing.
enum { PH_PROJECTION, PH_STAGE, PH_LOGITS, PH_SOFTMAX, PH_VALUES,
       PH_FEATURES, PH_P2N, PH_TAIL, NPHASE };
#ifdef GABLOCK_CHAIN_PROFILE
__device__ unsigned long long g_phase_cycles[NPHASE];
#define PHASE_START long long t_phase = clock64()
#define PHASE(i)                                             \
  do {                                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0) {               \
      const long long t_ = clock64();                        \
      g_phase_cycles[i] += t_ - t_phase;                     \
      t_phase = t_;                                          \
    }                                                        \
  } while (0)
#else
#define PHASE_START
#define PHASE(i) do {} while (0)
#endif

__global__ void __launch_bounds__(NT, 1) chain_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  PHASE_START;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = a.L, H = a.H, ko = a.ko, pw = a.pw;
  const int HD = H * SLOT, MT = mtiles(H), ALD = L + 16, SLD = sld(L);
  const int HPV = H * NPV;
  const int fb0 = H * CZ, fb1 = fb0 + H * VD, fb2 = fb1 + 3 * HPV,
            fb3 = fb2 + HPV;   // feature row: [p2n | node | local | dist | dir]
  const Layout lay = a.lay;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  bf16* A = reinterpret_cast<bf16*>(smem + lay.a);      // the tile's alphas
  bf16* Xb = A;                                          // projection: x in bf16
  bf16* Wst = A + (size_t)L * XLD;                       // projection: one slot
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.kv);    // a head's K, V;
  bf16* Vs = Ks + (size_t)L * KLD;                       // p2n: two z rows
  float* Pst = reinterpret_cast<float*>(smem + lay.kv) + warp * 16 * PLD;
  bf16* Hb1 = reinterpret_cast<bf16*>(smem + lay.kv);   // tail: bf16 rows
  bf16* Hb2 = Hb1 + TQ * XLD;
  float* T = reinterpret_cast<float*>(Hb2 + TQ * XLD);  // tail: GEMM output
  bf16* Bs = reinterpret_cast<bf16*>(smem + lay.q);    // a head's bias rows
  const int BLD = L + 8;
  float* RT = reinterpret_cast<float*>(smem + lay.rt);  // R (9), t (3), mask
  float* S = reinterpret_cast<float*>(smem + lay.s);    // logits; alpha . V; x1
  float* Wsg = S + warp * 256;                           // p2n: a warp's tile

  unsigned char* slab = a.slab + (size_t)blockIdx.x * a.slab_bytes;
  bf16* qa = reinterpret_cast<bf16*>(slab);
  bf16* ka = qa + (size_t)L * HD;
  bf16* vv = ka + (size_t)L * HD;
  bf16* feat = lay.feat_smem ? reinterpret_cast<bf16*>(smem + lay.feat)
                             : vv + (size_t)L * HD;
  const int FLD = lay.feat_smem ? ko + 8 : ko;
  const float s_node = 1.0f / sqrtf(3.0f * QK);

  for (int n = blockIdx.x; n < a.N; n += gridDim.x) {
    const int c = n / a.reps;
    const float* R9n = a.R9 + (size_t)n * L * 9;
    const float* tn = a.t + (size_t)n * L * 3;
    const float* maskn = a.mask + (size_t)n * L;
    float* X = lay.x_smem ? reinterpret_cast<float*>(smem + lay.x)
                          : a.out + (size_t)n * L * FD;
    __syncthreads();   // the previous trajectory is done with every buffer
    {
      const float4* src = reinterpret_cast<const float4*>(a.x + (size_t)n * L * FD);
      float4* dst = reinterpret_cast<float4*>(X);
      for (int idx = tid; idx < L * FD / 4; idx += NT) dst[idx] = src[idx];
    }

    for (int layer = 0; layer < a.NL; ++layer) {
      const bf16* Wp = a.w_proj + (size_t)layer * FD * pw;
      const float* coef = a.coef + (size_t)layer * H;
      __syncthreads();   // every row of x is written
      PHASE(layer == 0 ? PH_PROJECTION : PH_TAIL);

      // ---- 1. projection and assembly of qa / ka / vvp for all L rows
      for (int idx = tid; idx < L * FD / 2; idx += NT) {
        const int r = idx / (FD / 2), cc = (idx % (FD / 2)) * 2;
        const float2 v = *reinterpret_cast<const float2*>(&X[(size_t)r * FD + cc]);
        *reinterpret_cast<__nv_bfloat162*>(&Xb[(size_t)r * XLD + cc]) =
            __floats2bfloat162_rn(v.x, v.y);
      }
      for (int s = 0; s < 3 * H; ++s) {
        const int kind = s / H, h = s % H;
        __syncthreads();   // x in bf16 is written; the last slot is consumed
        for (int idx = tid; idx < FD * 8; idx += NT) {
          const int k = idx >> 3, g = idx & 7;
          if (g < 7)
            cp_async16(&Wst[k * KLD + g * 8], &Wp[(size_t)k * pw + slot_col(kind, h, g, H)]);
          else
            *reinterpret_cast<uint4*>(&Wst[k * KLD + g * 8]) = zero4;
        }
        cp_async_wait_all();
        __syncthreads();
        const float cf = coef[h];
        bf16* dst_base = kind == 0 ? qa : (kind == 1 ? ka : vv);
        for (int rt = warp; rt < L / 16; rt += NW) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
          for (int kk = 0; kk < FD / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
            wmma::load_matrix_sync(af, Xb + (size_t)rt * 16 * XLD + kk * 16, XLD);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
              wmma::load_matrix_sync(bfr, Wst + kk * 16 * KLD + j * 16, KLD);
              wmma::mma_sync(acc[j], af, bfr, acc[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::store_matrix_sync(Pst + j * 16, acc[j], PLD, wmma::mem_row_major);
          __syncwarp();
          // Assemble the slot of the 16 rows (the layout of K1's
          // assemble_kernel):
          //   qa = [q/sqrt(3 QK) | -2 c_h g | c_h |g|^2 | c_h | 0]
          //   ka = [k            | g       | 1         | |g|^2 | 0]
          //   vv = [v            | g       | 0]
          // with g the points rotated to the global frame (f32 R, t).
          // Lanes 0-15 write the 32 features of row `lane`, lanes 16-31 the
          // points and extras of row `lane - 16`.
          {
            const int rr = lane & 15, row = rt * 16 + rr;
            const float* pr = Pst + rr * PLD;
            uint32_t w[16];   // 32 bf16 values, packed in pairs
            if (lane < 16) {
              const float scale = kind == 0 ? s_node : 1.0f;
#pragma unroll
              for (int d = 0; d < 16; ++d)
                w[d] = pack2(rbf(pr[2 * d]) * scale, rbf(pr[2 * d + 1]) * scale);
            } else {
              const float* R = R9n + (size_t)row * 9;
              const float* tr = tn + (size_t)row * 3;
              float Rm[9], t3[3], v[32], sq = 0.0f;
#pragma unroll
              for (int e = 0; e < 9; ++e) Rm[e] = R[e];
#pragma unroll
              for (int e = 0; e < 3; ++e) t3[e] = tr[e];
              const float gs = kind == 0 ? -2.0f * cf : 1.0f;
#pragma unroll
              for (int p = 0; p < NP; ++p) {
                const float px = rbf(pr[32 + p]), py = rbf(pr[40 + p]),
                            pz = rbf(pr[48 + p]);
#pragma unroll
                for (int e = 0; e < 3; ++e) {
                  const float g = Rm[3 * e] * px + Rm[3 * e + 1] * py + Rm[3 * e + 2] * pz + t3[e];
                  sq += g * g;
                  v[e * NP + p] = gs * g;
                }
              }
              v[24] = kind == 0 ? cf * sq : (kind == 1 ? 1.0f : 0.0f);
              v[25] = kind == 0 ? cf : (kind == 1 ? sq : 0.0f);
#pragma unroll
              for (int d = 26; d < 32; ++d) v[d] = 0.0f;
#pragma unroll
              for (int d = 0; d < 16; ++d) w[d] = pack2(v[2 * d], v[2 * d + 1]);
            }
            uint4* dst = reinterpret_cast<uint4*>(
                dst_base + (size_t)row * HD + h * SLOT + (lane < 16 ? 0 : 32));
#pragma unroll
            for (int k = 0; k < 4; ++k)
              dst[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
          }
          __syncwarp();
        }
      }

      // ---- 3-4. per 16-row query tile: attention, p2n, the tail
      const bf16* bias_l = a.bias + ((size_t)c * a.NL + layer) * H * L * L;
      for (int i0 = 0; i0 < L; i0 += TQ) {
        __syncthreads();   // 2. the slab is complete / the last tile's tail is done
        PHASE(i0 == 0 ? PH_PROJECTION : PH_TAIL);
        if (tid < TQ * 13) {
          const int r = tid / 13, e = tid % 13, i = i0 + r;
          RT[r * RTLD + e] = e < 9 ? R9n[(size_t)i * 9 + e]
                                   : (e < 12 ? tn[(size_t)i * 3 + e - 9] : maskn[i]);
        }
        for (int h = 0; h < H; ++h) {
          const bf16* bh = bias_l + (size_t)h * L * L;
          __syncthreads();   // the last head is done with Ks, Vs, Bs and S
          PHASE(PH_FEATURES);
          for (int idx = tid; idx < L * 8; idx += NT) {
            const int j = idx >> 3, cc = (idx & 7) * 8;
            const size_t g = (size_t)j * HD + h * SLOT + cc;
            cp_async16(&Ks[j * KLD + cc], &ka[g]);
            cp_async16(&Vs[j * KLD + cc], &vv[g]);
          }
          for (int idx = tid; idx < TQ * (L / 8); idx += NT) {
            const int r = idx / (L / 8), cc = (idx % (L / 8)) * 8;
            cp_async16(&Bs[r * BLD + cc], &bh[(size_t)(i0 + r) * L + cc]);
          }
          // The query tile's fragments come straight from the slab while
          // the copies are in flight.
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[SLOT / 16];
#pragma unroll
          for (int kk = 0; kk < SLOT / 16; ++kk)
            wmma::load_matrix_sync(qf[kk], qa + (size_t)i0 * HD + h * SLOT + kk * 16, HD);
          cp_async_wait_all();
          __syncthreads();
          PHASE(PH_STAGE);

          for (int jt = warp; jt < L / 16; jt += NW) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
            wmma::fill_fragment(acc, 0.0f);
#pragma unroll
            for (int kk = 0; kk < SLOT / 16; ++kk) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
              wmma::load_matrix_sync(kf, Ks + jt * 16 * KLD + kk * 16, KLD);
              wmma::mma_sync(acc, qf[kk], kf, acc);
            }
            wmma::store_matrix_sync(S + jt * 16, acc, SLD, wmma::mem_row_major);
          }
          __syncthreads();
          PHASE(PH_LOGITS);

          // Exact softmax over keys in f32; masked keys carry -1e5 in the
          // bias. alpha is rounded to bf16 once and feeds both products.
          {   // warp w: rows w + NW q, q < RPW, interleaved
            float mx[RPW], sum[RPW];
#pragma unroll
            for (int q = 0; q < RPW; ++q) mx[q] = -INFINITY;
            for (int j = lane; j < L; j += 32) {
#pragma unroll
              for (int q = 0; q < RPW; ++q) {
                const int r = warp + NW * q;
                const float v = S[r * SLD + j] + bf(Bs[r * BLD + j]);
                S[r * SLD + j] = v;
                mx[q] = fmaxf(mx[q], v);
              }
            }
            for (int o = 16; o > 0; o >>= 1)
#pragma unroll
              for (int q = 0; q < RPW; ++q)
                mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], o));
#pragma unroll
            for (int q = 0; q < RPW; ++q) sum[q] = 0.0f;
            for (int j = lane; j < L; j += 32) {
#pragma unroll
              for (int q = 0; q < RPW; ++q) {
                const int r = warp + NW * q;
                const float e = __expf(S[r * SLD + j] - mx[q]);
                S[r * SLD + j] = e;
                sum[q] += e;
              }
            }
            for (int o = 16; o > 0; o >>= 1)
#pragma unroll
              for (int q = 0; q < RPW; ++q)
                sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], o);
#pragma unroll
            for (int q = 0; q < RPW; ++q) {
              const int r = warp + NW * q;
              const float inv = 1.0f / sum[q];
              bf16* arow = A + ((size_t)r * H + h) * ALD;
              for (int j = lane; j < L; j += 32) arow[j] = tobf(S[r * SLD + j] * inv);
            }
          }
          __syncthreads();
          PHASE(PH_SOFTMAX);

          {   // warp w: 16 value columns (w % 4), every other key tile (w / 4)
            const int jc = warp & 3, half = warp >> 2;
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
            wmma::fill_fragment(acc, 0.0f);
            for (int kt = half; kt < L / 16; kt += 2) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
              wmma::load_matrix_sync(pf, A + (size_t)h * ALD + kt * 16, H * ALD);
              wmma::load_matrix_sync(vf, Vs + kt * 16 * KLD + jc * 16, KLD);
              wmma::mma_sync(acc, pf, vf, acc);
            }
            wmma::store_matrix_sync(S + half * SLOT + jc * 16, acc, SLD, wmma::mem_row_major);
          }
          __syncthreads();
          PHASE(PH_VALUES);

          // The head's node values and local-frame point features (the
          // layout of K1's feat_kernel), from the bf16-rounded values; the
          // two key halves of alpha . V sum here.
          for (int idx = tid; idx < TQ * VD; idx += NT) {
            const int r = idx / VD, d = idx % VD;
            feat[(size_t)r * FLD + fb0 + h * VD + d] =
                tobf(S[r * SLD + d] + S[r * SLD + SLOT + d]);
          }
          if (tid < TQ * NPV) {
            const int r = tid / NPV, p = tid % NPV, k = h * NPV + p;
            const float* R = RT + r * RTLD;
            const float* o = S + r * SLD + VD + p;
            const float d0 = rbf(o[0] + o[SLOT]) - R[9];
            const float d1 = rbf(o[NPV] + o[SLOT + NPV]) - R[10];
            const float d2 = rbf(o[2 * NPV] + o[SLOT + 2 * NPV]) - R[11];
            float l[3];
#pragma unroll
            for (int e = 0; e < 3; ++e) l[e] = R[e] * d0 + R[3 + e] * d1 + R[6 + e] * d2;
            const float ss = l[0] * l[0] + l[1] * l[1] + l[2] * l[2];
            const float inv = 1.0f / (sqrtf(ss + 1e-8f) + 1e-4f);
            bf16* fr = feat + (size_t)r * FLD;
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              fr[fb1 + e * HPV + k] = tobf(l[e]);
              fr[fb3 + e * HPV + k] = tobf(l[e] * inv);
            }
            fr[fb2 + k] = tobf(sqrtf(ss + 1e-12f));
          }
        }

        // p2n: per query row i, (all heads' alphas, H x L) . z[c, i] (L x
        // CZ): a warp takes (row, 16 heads, 16 columns of z) at a time, z's
        // fragments straight from L2 (shared by every replica of c).
        __syncthreads();   // every head's alphas are in A; S is free
        PHASE(PH_FEATURES);
        for (int it = warp; it < TQ * MT * (CZ / 16); it += NW) {
          const int r = it / (MT * (CZ / 16)), rem = it % (MT * (CZ / 16));
          const int mt = rem / (CZ / 16), jc = rem % (CZ / 16);
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          tile_product_l2(acc, A + ((size_t)r * H + mt * 16) * ALD, ALD,
                          a.z + ((size_t)c * L + i0 + r) * L * CZ + jc * 16, CZ, L / 16);
          wmma::store_matrix_sync(Wsg, acc, 16, wmma::mem_row_major);
          __syncwarp();
          bf16* fr = feat + (size_t)r * FLD;
          for (int e = lane; e < 256; e += 32) {
            const int hh = mt * 16 + (e >> 4);   // rows past H: not stored
            if (hh < H) fr[hh * CZ + jc * 16 + (e & 15)] = tobf(Wsg[e]);
          }
          __syncwarp();
        }

        // The tail: out_transform, mask, residual, LN1, MLP, LN2.
        const float* b_out = a.b_out + (size_t)layer * FD;
        const float* ln1 = a.ln1 + (size_t)layer * 2 * FD;
        const float* ln2 = a.ln2 + (size_t)layer * 2 * FD;
        const float* b_m = a.b_m + (size_t)layer * 3 * FD;
        __syncthreads();   // the feature rows are complete
        PHASE(PH_P2N);
        row_tile_gemm(feat, FLD, a.w_out + (size_t)layer * ko * FD, ko, T, TLD, warp);
        __syncthreads();
        for (int r = warp; r < TQ; r += NW) {
          const float mk = RT[r * RTLD + 12];
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int cc = lane + 32 * q;
            v[q] = X[(size_t)(i0 + r) * FD + cc] + (T[r * TLD + cc] + b_out[cc]) * mk;
          }
          layer_norm(v, ln1, lane);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int cc = lane + 32 * q;
            S[r * SLD + cc] = v[q];
            Hb1[r * XLD + cc] = tobf(v[q]);
          }
        }
        const bf16* w_m[3] = {a.w_m1 + (size_t)layer * FD * FD,
                              a.w_m2 + (size_t)layer * FD * FD,
                              a.w_m3 + (size_t)layer * FD * FD};
        bf16* hin[3] = {Hb1, Hb2, Hb1};
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          __syncthreads();   // the GEMM input rows are written
          row_tile_gemm(hin[m], XLD, w_m[m], FD, T, TLD, warp);
          __syncthreads();
          if (m < 2) {
            bf16* hout = hin[m + 1];
            for (int idx = tid; idx < TQ * FD; idx += NT) {
              const int r = idx / FD, cc = idx % FD;
              hout[r * XLD + cc] = tobf(fmaxf(T[r * TLD + cc] + b_m[m * FD + cc], 0.0f));
            }
          }
        }
        for (int r = warp; r < TQ; r += NW) {
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int cc = lane + 32 * q;
            v[q] = S[r * SLD + cc] + T[r * TLD + cc] + b_m[2 * FD + cc];
          }
          layer_norm(v, ln2, lane);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            X[(size_t)(i0 + r) * FD + lane + 32 * q] = v[q];
        }
      }
    }

    __syncthreads();   // every tile's tail has written its x rows
    PHASE(PH_TAIL);
    if (lay.x_smem) {
      const float4* src = reinterpret_cast<const float4*>(X);
      float4* dst = reinterpret_cast<float4*>(a.out + (size_t)n * L * FD);
      for (int idx = tid; idx < L * FD / 4; idx += NT) dst[idx] = src[idx];
    }
  }
}

// ------------------------------------------------------------- host side

size_t up(size_t b, size_t to) { return (b + to - 1) / to * to; }

// Shared-memory layout at (L, H); returns 0, or ERR_SMEM where even x and
// the feature rows in device memory leave it above what a block may use.
int make_layout(int L, int H, Layout* lay) {
  const size_t ko = (size_t)H * (CZ + VD + 7 * NPV);
  const size_t a = up(std::max((size_t)alpha_rows(H) * (L + 16) * 2,
                               (size_t)L * XLD * 2 + (size_t)FD * KLD * 2), 128);
  const size_t kv = up(std::max(std::max((size_t)2 * L * KLD * 2,
                                         (size_t)NW * 16 * PLD * 4),
                                (size_t)2 * TQ * XLD * 2 + (size_t)TQ * TLD * 4), 128);
  const size_t q = up((size_t)TQ * (L + 8) * 2, 128);
  const size_t rt = up((size_t)TQ * RTLD * 4, 128);
  const size_t s = up(std::max((size_t)TQ * sld(L) * 4, (size_t)NW * 256 * 4), 128);
  const size_t xb = up((size_t)L * FD * 4, 128);
  const size_t fb = up((size_t)TQ * (ko + 8) * 2, 128);
  const size_t base = a + kv + q + rt + s;
  const int opts[3][2] = {{1, 1}, {0, 1}, {0, 0}};
  for (const auto& o : opts) {
    const size_t total = base + (o[0] ? xb : 0) + (o[1] ? fb : 0);
    if (total > SMEM_BLOCK) continue;
    lay->x_smem = o[0];
    lay->feat_smem = o[1];
    lay->a = 0;
    lay->kv = a;
    lay->q = lay->kv + kv;
    lay->rt = lay->q + q;
    lay->s = lay->rt + rt;
    lay->x = lay->s + s;
    lay->feat = lay->x + (o[0] ? xb : 0);
    lay->total = total;
    return 0;
  }
  return ERR_SMEM;
}

struct Plan {
  Layout lay;
  size_t slab_bytes;
  int grid;
};

// The launch at (N, L, H): layout, blocks (at most SMs x blocks per SM,
// at most N) and the scratch slab per block.
int make_plan(int N, int L, int H, Plan* p) {
  int err = make_layout(L, H, &p->lay);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->lay.total);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel, NT,
                                                         p->lay.total)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return ERR_SMEM;
  p->grid = std::min(N, per_sm * sms);
  const size_t ko = (size_t)H * (CZ + VD + 7 * NPV);
  p->slab_bytes = up((size_t)3 * L * H * SLOT * 2 + (p->lay.feat_smem ? 0 : (size_t)TQ * ko * 2),
                     256);
  return 0;
}

}  // namespace

extern "C" int gablock_chain_layout(int L, int H, int* x_smem, int* feat_smem,
                                    size_t* smem_bytes) {
  Layout lay;
  const int err = make_layout(L, H, &lay);
  if (err) return err;
  *x_smem = lay.x_smem;
  *feat_smem = lay.feat_smem;
  *smem_bytes = lay.total;
  return 0;
}

extern "C" int gablock_chain_workspace(int N, int L, int H, size_t* bytes) {
  Plan p;
  const int err = make_plan(N, L, H, &p);
  if (err) return err;
  *bytes = p.slab_bytes * (size_t)p.grid;
  return 0;
}

// Runs NL GABlock layers on `stream`. Weights are stacked with a leading
// layer axis, biases (Nc, NL, H, L, L). Returns 0, or the error of the
// planning step or of cudaGetLastError() after the launch.
extern "C" int gablock_chain_forward(
    const float* x, const float* R9, const float* t, const bf16* z,
    const bf16* bias, const float* mask, const bf16* w_proj, int pw,
    const float* coef, const bf16* w_out, int ko, const float* b_out,
    const float* ln1, const bf16* w_m1, const bf16* w_m2, const bf16* w_m3,
    const float* b_m, const float* ln2, float* out, void* workspace,
    size_t workspace_bytes, int N, int L, int H, int reps, int NL,
    void* stream_ptr) {
  Plan p;
  int err = make_plan(N, L, H, &p);
  if (err) return err;
  if (workspace_bytes < p.slab_bytes * (size_t)p.grid) return ERR_WORKSPACE;
  Args a;
  a.x = x; a.R9 = R9; a.t = t; a.mask = mask;
  a.z = z; a.bias = bias; a.w_proj = w_proj; a.w_out = w_out;
  a.w_m1 = w_m1; a.w_m2 = w_m2; a.w_m3 = w_m3;
  a.coef = coef; a.b_out = b_out; a.ln1 = ln1; a.b_m = b_m; a.ln2 = ln2;
  a.out = out;
  a.slab = static_cast<unsigned char*>(workspace);
  a.slab_bytes = p.slab_bytes;
  a.pw = pw; a.ko = ko; a.N = N; a.L = L; a.H = H; a.reps = reps; a.NL = NL;
  a.lay = p.lay;
  chain_kernel<<<p.grid, NT, p.lay.total, reinterpret_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}

#ifdef GABLOCK_CHAIN_PROFILE
// Copies the per-phase cycle sums out (NPHASE values) and, with reset,
// zeroes them. Returns a CUDA error code.
extern "C" int gablock_chain_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[NPHASE] = {};
    e = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)e;
}
#endif

extern "C" const char* gablock_chain_error_string(int err) {
  if (err == ERR_SMEM) return "the tile does not fit in shared memory";
  if (err == ERR_WORKSPACE) return "the workspace is smaller than the plan";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
