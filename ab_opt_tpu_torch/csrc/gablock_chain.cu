// The whole GAEncoder (every GABlock layer of one sampling step) in one
// launch, for Hopper (sm_90a), bf16 tensor cores: K5.
//
// Replaces the TPU kernel ab_opt_tpu/ops/gablock_pallas.py:409
// _encoder_chain_kernel (called by :616 fused_encoder_chained): NL GABlock
// layers in sequence, with R, t, z and the row mask fixed across layers and
// x carried from layer to layer. Each layer computes what K1
// (csrc/gablock.cu) computes, through K1's own tiles (csrc/k1_tiles.cuh),
// so K5's output equals six K1 launches bitwise.
//
// What bounds it on this card. At N = 256 trajectories, L = 128, H = 12 and
// six layers the encoder is ~320 GFLOP of tensor-core work (six times K1's
// 53.35 GFLOP), 0.32 ms at the 989 TFLOP/s bf16 dense peak; the bytes it
// must move (x in and out, R, t, mask, z, six biases and six layers'
// weights, ~57 MB) take 0.017 ms at 3.35 TB/s. Between K1's launches,
// though, ~1 GB a layer of intermediates goes through device memory (the
// (N, H, L, L) alphas alone are ~100 MB, far larger than the 50 MB L2), and
// a step on the K1 route makes 54 launches that the host must issue. This
// design keeps K1's tiles and K1's intermediates in device memory, and
// removes the 54 launches and the tail of each phase: it is one launch.
//
// Design: a persistent launch (one 256-thread block an SM) over a work list
// that the wrapper builds (ops/gablock.py::chain_plan) and passes in as
// int32 tables. Items are ordered by (layer, phase, replica group, tile):
//   proj      128 rows x a range of the projection's column tiles (wgmma,
//             x resident; x is the input at layer 0, the output rows after)
//   assemble  16 to 128 rows of qa / ka / vvp (more items where the rows
//             are few), one warp a row, the proj rows staged in shared
//             memory by cp.async, the next rows' copies in flight
//   attention (query tile of 128 rows, head, rt replicas of one complex):
//             K1's replica-group mma.sync tile, bias staged once
//   feat      16 to 128 rows of the feature matrix's node and point
//             columns, one warp a row, o's rows staged as proj's are
//   p2n       128 alpha rows (replicas x heads of one complex) x a few
//             query rows: z[c, i] staged once a row, the next rows' z and
//             alpha copies in flight while one computes; the product by
//             mma.sync as K1's alpha . V, with the same sums as K1's p2n
//   tail      128 rows: out_transform + LN1, MLP1, MLP2 and MLP3 + LN2
//             through the wgmma GEMM tile, each warpgroup on 64 rows with
//             its own ring and barriers, the rows' own hiddens read back
//             through L2
// A block takes the next item with atomicAdd on a ticket (claimed one item
// ahead, so the claim's latency hides behind the current item). An item
// waits only on items with smaller tickets, which running blocks hold, so
// the launch cannot deadlock, whether or not every block is resident. Each
// dependency is a counter in global memory that the items it counts
// increment once each; an item waits until each of its counters has seen
// every such increment of this launch:
//   attention(g)   assemble of every row of replica group g
//   p2n(c, i..)    attention of every replica and head it reads (the query
//                  tile of i, every group that its alpha rows cover)
//   feat(rows)     attention of its rows (every head)
//   tail(rows)     feat and p2n of its rows
//   proj(l, rows)  tail(l - 1) of its rows
//   assemble(l)    proj(l) of its rows
// Everything a tile overwrites was read by items that precede it through
// these chains (the K, V rows assemble(l) writes, for one, were read by
// attention(l - 1), which the rows' tail(l - 1) follows through p2n of
// every query row): tests/test_torch_chain_plan.py checks that no two items
// that touch the same data, one writing, go unordered. Producers publish with __threadfence() plus a
// release increment after the block's barrier; consumers spin on an acquire
// load, then read what other blocks wrote through L2 only (cp.async.cg,
// ld.global.cg). The counters and the ticket only ever grow: the wrapper
// passes the launch's epoch (1, 2, ...), and a counter is complete at epoch
// x its count of a launch, so no memset runs between launches.
//
// One block shape serves every tile: 256 threads, 1 block an SM (the
// attention's shared memory: 200,704 bytes at L=128). K1's attention
// (8 warps up to L=128), projection and its two-warpgroup GEMM have that
// shape already; the other launches of K1 run more, smaller blocks an SM:
//   k1_proj_kernel   2 blocks an SM          -> one (no overlap of two
//                                               tiles' loads and products)
//   AttnLarge (L>128) 4 warps, 2 stages      -> 8 warps, one stage
//   k1_gemm_kernel   2 blocks an SM          -> two one-warpgroup tiles
//                                               side by side in the block
//   p2n, feat        128 threads, many an SM -> 256 threads (p2n: 128 rows)
//   assemble         a block a row           -> a warp a row (the rows
//                                               staged: see above)
//
// Fixed head geometry (the DiffAb defaults): query/key width 32, value
// width 32, 8 query points, 8 value points, pair width 64, node width 128.
// H (a multiple of 4) and L (a multiple of 16, at most 256) are runtime
// values, as in K1. The Python wrapper checks all of this.

#include <algorithm>

#include "k1_tiles.cuh"

namespace {

constexpr int NT = 256;       // threads a block
constexpr int ROWS = 128;     // rows of a proj, assemble or tail item
constexpr int ITEM_COLS = 8;  // kind, layer, p0, p1, p2, signal, waits [lo, hi)
enum { K_PROJ = 0, K_ASSEMBLE, K_ATTN, K_FEAT, K_P2N, K_TAIL, NKIND };
constexpr int ERR_OCCUPANCY = 10001;   // the block does not fit an SM

struct ChainArgs {
  const float *x, *R9, *t, *mask;
  const bf16 *z, *bias;                             // bias (Nc, NL, H, L, L)
  const bf16 *w_proj, *w_out, *w_m1, *w_m2, *w_m3;  // transposed, stacked by layer
  const float *coef, *b_out, *ln1, *b_m, *ln2;
  float* out;
  Workspace w;
  const int* items;      // (n_items, ITEM_COLS)
  const int* waits;      // counter ids, items' [lo, hi) ranges
  const int* totals;     // per counter: the increments of one launch
  unsigned* counters;    // [0] the ticket, then the dependency counters
  int n_items;
  unsigned ticket_base, epoch;
  int pw, ko, N, L, H, reps, rt, NL, p2n_rows;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Between two tiles of one block: the first's copies are done, and the
// barrier orders its global writes before the second's reads (one block,
// so CTA scope suffices).
__device__ __forceinline__ void tile_step() {
  cp_async_wait<0>();
  __syncthreads();
}

// Rows [r0, r1) of a row-major bf16 matrix (ld elements a row, the first
// `units` 16-byte units of each read), with their R (9 floats) and t (3),
// through shared memory, CH rows (a multiple of 4) at a time in two
// buffers at buf: the next chunk's cp.async copies are in flight while warp
// w runs fn(row, staged row, R, t) on rows w, w + 8, ... of the current
// chunk. The per-row tiles then read shared memory, not device memory at a
// latency a row.
__host__ __device__ constexpr size_t staged_bytes(int CH, int units) {
  return (size_t)CH * (units * 16 + 12 * 4);
}

template <int CH, class Fn>
__device__ __forceinline__ void staged_rows(const bf16* src, int ld, int units,
                                            const float* R9, const float* tr, int r0, int r1,
                                            unsigned char* buf, Fn fn) {
  static_assert(CH % 4 == 0, "R and t of CH rows must be whole 16-byte units");
  const int tid = threadIdx.x, warp = tid >> 5;
  const int pitch = units * 8;
  auto rows_of = [&](int k) { return reinterpret_cast<bf16*>(buf + (k & 1) * staged_bytes(CH, units)); };
  auto R_of = [&](int k) { return reinterpret_cast<float*>(rows_of(k) + CH * pitch); };
  auto stage = [&](int k) {
    const int c0 = r0 + k * CH, n = min(CH, r1 - c0);
    bf16* dst = rows_of(k);
    for (int idx = tid; idx < n * units; idx += NT) {
      const int r = idx / units, u = idx - r * units;
      cp_async16(dst + r * pitch + u * 8, src + (size_t)(c0 + r) * ld + u * 8, true);
    }
    float* Rs = R_of(k);
    const int nR = n * 9 / 4, nt = n * 3 / 4;   // 16-byte units of R, of t
    for (int idx = tid; idx < nR + nt; idx += NT) {
      if (idx < nR) cp_async16(Rs + idx * 4, R9 + (size_t)c0 * 9 + idx * 4, true);
      else cp_async16(Rs + CH * 9 + (idx - nR) * 4, tr + (size_t)c0 * 3 + (idx - nR) * 4, true);
    }
  };
  const int nk = (r1 - r0 + CH - 1) / CH;
  stage(0);
  cp_async_commit();
  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk) stage(k + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int c0 = r0 + k * CH;
    const bf16* b = rows_of(k);
    const float* Rs = R_of(k);
    for (int r = warp; r < CH && c0 + r < r1; r += NT / 32)
      fn(c0 + r, b + r * pitch, Rs + r * 9, Rs + CH * 9 + r * 3);
    __syncthreads();   // the buffer is free for chunk k + 2
  }
}

// Rows a chunk of assemble (one a warp) and of feat (two a warp).
constexpr int ASM_CH = NT / 32, FEAT_CH = 2 * NT / 32;

// A p2n item's query rows go through the ring of k1_tiles.cuh's p2n_stage
// (K4's p2n launch runs the same), on K5's block.
static_assert(P2N_NT == NT, "p2n_stage and p2n_mma take K5's whole block");

__host__ __device__ constexpr int proj_units(int H) { return H * 168 * 2 / 16; }
__host__ __device__ constexpr int o_units(int H) { return H * SLOT * 2 / 16; }

// Nanoseconds (%globaltimer) by item kind, waiting on counters (index
// NKIND), each block's whole run (NKIND + 1), the tail's four GEMM tiles
// (from NKIND + 2) and p2n's waits for its copies (NKIND + 6), summed over
// all blocks, for a profiling build only (-DGABLOCK_CHAIN_PROFILE,
// utils/profile_chain.py). Other builds compile the marks to nothing.
#ifdef GABLOCK_CHAIN_PROFILE
constexpr int NPROFILE = NKIND + 7;
__device__ unsigned long long g_profile_ns[NPROFILE];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROFILE_MARK(v) const long long v = global_ns()
#define PROFILE_ADD(i, c) atomicAdd(&g_profile_ns[i], (unsigned long long)(c))
#define PROFILE_TAIL(k, v)                              \
  PROFILE_MARK(v);                                      \
  if (threadIdx.x == 0) PROFILE_ADD(NKIND + 2 + k, v - t_tail)
#define PROFILE_SPAN(i, v0, v1) \
  if (threadIdx.x == 0) PROFILE_ADD(i, v1 - v0)
#else
#define PROFILE_TAIL(k, v)
#define PROFILE_SPAN(i, v0, v1)
#define PROFILE_MARK(v)
#define PROFILE_ADD(i, c)
#endif

// One GEMM of the tail: each warpgroup takes 64 of the 128 rows as a tile
// of its own (its barriers, its half of the shared memory), so one's loads
// overlap the other's products, as two K1 blocks do on one SM.
template <int EPI>
__device__ __forceinline__ void tail_gemm(int m0, const bf16* A, int lda, const bf16* Bt,
                                          int M, int K, const Epi& ep, unsigned char* smraw) {
  if (threadIdx.x < 128)
    gemm_tile<EPI, 1, 3, 5>(m0, A, lda, Bt, M, K, ep, smraw);
  else
    gemm_tile<EPI, 1, 4, 6>(m0 + 64, A, lda, Bt, M, K, ep, smraw + gemm_smem(1));
}

// The tail of the 128 rows from m0: out_transform + LN1, MLP1, MLP2 and
// MLP3 + LN2.
__device__ __forceinline__ void run_tail(const ChainArgs& a, int l, int m0, const float* X,
                                         unsigned char* smraw) {
  const int M = a.N * a.L, ko = a.ko;
  const Workspace& w = a.w;
  PROFILE_MARK(t_tail);
  Epi ep = {};
  ep.bias = a.b_out + (size_t)l * FD;
  ep.resid = X;
  ep.rowmask = a.mask;
  ep.ln = a.ln1 + (size_t)l * 2 * FD;
  ep.out_f32 = w.x1;
  ep.out_bf16 = w.x1b;
  tail_gemm<EPI_LN>(m0, w.feat, ko, a.w_out + (size_t)l * FD * ko, M, ko, ep, smraw);
  tile_step();
  PROFILE_TAIL(0, t_out);
  ep = Epi{};
  ep.bias = a.b_m + (size_t)l * 3 * FD;
  ep.relu = 1;
  ep.out_bf16 = w.h1;
  ep.ldo = FD;
  tail_gemm<EPI_BF16>(m0, w.x1b, FD, a.w_m1 + (size_t)l * FD * FD, M, FD, ep, smraw);
  tile_step();
  PROFILE_TAIL(1, t_m1);
  ep.bias += FD;
  ep.out_bf16 = w.h2;
  tail_gemm<EPI_BF16>(m0, w.h1, FD, a.w_m2 + (size_t)l * FD * FD, M, FD, ep, smraw);
  tile_step();
  PROFILE_TAIL(2, t_m2);
  ep = Epi{};
  ep.bias = a.b_m + (size_t)l * 3 * FD + 2 * FD;
  ep.resid = w.x1;
  ep.ln = a.ln2 + (size_t)l * 2 * FD;
  ep.out_f32 = a.out;
  tail_gemm<EPI_LN>(m0, w.h2, FD, a.w_m3 + (size_t)l * FD * FD, M, FD, ep, smraw);
  PROFILE_TAIL(3, t_m3);
}

template <class Plan>
__device__ __forceinline__ void run_item(const ChainArgs& a, int kind, int l, int p0, int p1,
                                         int p2, unsigned char* smraw) {
  const int L = a.L, H = a.H, M = a.N * L, pw = a.pw, ko = a.ko;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Workspace& w = a.w;
  const float* X = l == 0 ? a.x : a.out;   // this layer's input rows
  switch (kind) {
    case K_PROJ: {   // rows 128 p0 .., column tiles [p1, p2)
      Epi ep = {};
      ep.out_bf16 = w.proj;
      ep.ldo = pw;
      proj_tile(p0 * ROWS, p1, p2, X, a.w_proj + (size_t)l * pw * FD, M, pw, ep, smraw);
      break;
    }
    case K_ASSEMBLE: {   // rows [p0, p1)
      float* smf = reinterpret_cast<float*>(smraw + 2 * staged_bytes(ASM_CH, proj_units(H))) +
                   (size_t)warp * assemble_floats(H);
      const float* coef = a.coef + (size_t)l * H;
      staged_rows<ASM_CH>(w.proj, pw, proj_units(H), a.R9, a.t, p0, p1, smraw,
                          [&](int r, const bf16* pr, const float* Rr, const float* tr) {
                            assemble_row<32>(r, lane, pr, Rr, tr, coef, H, w.qa, w.ka, w.vv,
                                             smf);
                          });
      break;
    }
    case K_ATTN: {   // query tile p0, head p1, replica group p2
      const int n0 = p2 * a.rt;
      k1_attn_tile<Plan>(p0 * Plan::QT, p1, n0, a.rt, w.qa, w.ka, w.vv,
                         a.bias + (((size_t)(n0 / a.reps) * a.NL + l) * H + p1) * L * L,
                         w.o, w.alpha, L, H, a.reps, smraw);
      break;
    }
    case K_FEAT: {   // rows [p0, p1)
      staged_rows<FEAT_CH>(w.o, H * SLOT, o_units(H), a.R9, a.t, p0, p1, smraw,
                           [&](int r, const bf16* orow, const float* Rr, const float* tr) {
                             feat_row<32>(r, lane, orow, Rr, tr, w.feat, ko, H);
                           });
      break;
    }
    case K_P2N: {   // query rows p0 .. p0 + p2n_rows - 1, alpha rows 128 p1 .., complex p2
      const int i1 = min(L, p0 + a.p2n_rows), m0 = p1 * P2N_M, ns = p2n_stages(L);
      const size_t sb = p2n_stage_bytes(L);
      auto Zs = [&](int st) { return reinterpret_cast<bf16*>(smraw + st * sb); };
      auto stage = [&](int i, int st) {
        p2n_stage(m0, i, p2, w.alpha, a.z, Zs(st), Zs(st) + L * KLD, L, H, a.reps);
        cp_async_commit();
      };
      for (int k = 0; k < ns - 1; ++k) {   // the ring's first rows
        if (p0 + k < i1) stage(p0 + k, k);
        else cp_async_commit();
      }
      for (int i = p0; i < i1; ++i) {
        const int st = (i - p0) % ns;
        if (i + ns - 1 < i1) stage(i + ns - 1, (st + ns - 1) % ns);
        else cp_async_commit();
        PROFILE_MARK(t_copy);
        cp_async_wait_n(ns - 1);   // all but the ns - 1 newest groups: row i is staged
        __syncthreads();
        PROFILE_MARK(t_staged);
        PROFILE_SPAN(NKIND + 6, t_copy, t_staged);
        p2n_mma(m0, i, p2, Zs(st), Zs(st) + L * KLD, w.feat, ko, L, H, a.reps);
        __syncthreads();   // stage st is free for row i + ns
      }
      break;
    }
    case K_TAIL:   // rows 128 p0 ..
      run_tail(a, l, p0 * ROWS, X, smraw);
      break;
    default:
      break;
  }
}

template <class Plan>
__global__ void __launch_bounds__(NT, 1) chain_kernel(const ChainArgs a) {
  static_assert(Plan::QW * 32 == NT, "the attention tile must take the whole block");
  extern __shared__ __align__(1024) unsigned char smraw[];
  __shared__ int s_next;
  const int tid = threadIdx.x;
  PROFILE_MARK(t_start);
  if (tid == 0) s_next = (int)(atomicAdd(a.counters, 1u) - a.ticket_base);
  __syncthreads();
  int cur = s_next;
  while (cur < a.n_items) {
    __syncthreads();   // every thread has read s_next
    PROFILE_MARK(t_claim);
    if (tid == 0) s_next = (int)(atomicAdd(a.counters, 1u) - a.ticket_base);
    const int* it = a.items + (size_t)cur * ITEM_COLS;
    const int kind = it[0];
    for (int k = it[6] + tid; k < it[7]; k += NT) {
      const int c = a.waits[k];
      const unsigned target = a.epoch * (unsigned)a.totals[c];
      // A wait of seconds means a counter that can never complete (a fault
      // of the plan): end the launch with an error instead of hanging.
      for (unsigned spins = 0; (int)(ld_acquire(a.counters + 1 + c) - target) < 0; ++spins) {
        if (spins > (1u << 26)) __trap();
        __nanosleep(64);
      }
    }
    __syncthreads();
    PROFILE_MARK(t_ready);
    run_item<Plan>(a, kind, it[1], it[2], it[3], it[4], smraw);
    cp_async_wait<0>();
    __threadfence();   // the item's writes, before its counter's release
    __syncthreads();
    if (tid == 0) {
      red_release(a.counters + 1 + it[5], 1u);
      PROFILE_MARK(t_done);
      PROFILE_ADD(kind, t_done - t_ready);
      PROFILE_ADD(NKIND, t_ready - t_claim);
    }
    cur = s_next;
  }
  if (tid == 0) {
    PROFILE_MARK(t_end);
    PROFILE_ADD(NKIND + 1, t_end - t_start);
  }
}

// ------------------------------------------------------------- host side

size_t chain_smem(int L, int H) {
  size_t s = std::max(PROJ_SMEM, 2 * gemm_smem(1));
  s = std::max(s, L <= 128 ? AttnSmall::smem(L) : AttnWide::smem(L));
  s = std::max(s, p2n_stages(L) * p2n_stage_bytes(L));
  s = std::max(s, 2 * staged_bytes(FEAT_CH, o_units(H)));
  return std::max(s, 2 * staged_bytes(ASM_CH, proj_units(H)) +
                         (size_t)(NT / 32) * assemble_floats(H) * sizeof(float));
}

// Blocks of the persistent grid (blocks an SM x SMs) and shared memory a
// block, or an error.
template <class Plan>
int launch_shape(int L, int H, int* grid, size_t* smem) {
  *smem = chain_smem(L, H);
  cudaError_t e = cudaFuncSetAttribute(chain_kernel<Plan>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel<Plan>, NT, *smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return ERR_OCCUPANCY;
  *grid = per_sm * num_sms();
  return 0;
}

template <class Plan>
int launch_chain(ChainArgs a, cudaStream_t stream) {
  int grid = 0;
  size_t smem = 0;
  const int err = launch_shape<Plan>(a.L, a.H, &grid, &smem);
  if (err) return err;
  // Every launch before this one claimed n_items + grid tickets (each block
  // ends on one claim past the list).
  a.ticket_base = (a.epoch - 1u) * (unsigned)(a.n_items + grid);
  chain_kernel<Plan><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the intermediates: K1's workspace at the same shape.
extern "C" size_t gablock_chain_workspace_bytes(int N, int L, int H, int pw, int ko) {
  Workspace w;
  return carve(nullptr, N, L, H, pw, ko, &w);
}

// The persistent grid, threads a block and shared memory a block at (L, H).
extern "C" int gablock_chain_launch_shape(int L, int H, int* grid, int* threads,
                                          size_t* smem) {
  if (L % 16 != 0 || L < 16 || L > 256 || H < 4 || H % 4 != 0)
    return (int)cudaErrorInvalidValue;
  *threads = NT;
  return L <= 128 ? launch_shape<AttnSmall>(L, H, grid, smem)
                  : launch_shape<AttnWide>(L, H, grid, smem);
}

// Runs NL GABlock layers on `stream`: one launch over the work list `items`
// (n_items x 8 int32), its `waits` and per-counter `totals`, built by the
// wrapper for (N, L, H, reps, rt, NL, p2n_rows). Weights are the bundles'
// transposed matrices stacked with a leading layer axis, biases (Nc, NL, H,
// L, L). `counters` (1 + counters, uint32) start at zero and are kept from
// launch to launch with `workspace`; `epoch` is 1 at the first launch on
// them and one more (mod 2^32) at each after. Returns 0, or the error of the planning
// step or of cudaGetLastError() after the launch.
extern "C" int gablock_chain_forward(
    const float* x, const float* R9, const float* t, const bf16* z, const bf16* bias,
    const float* mask, const bf16* w_proj, int pw, const float* coef, const bf16* w_out,
    int ko, const float* b_out, const float* ln1, const bf16* w_m1, const bf16* w_m2,
    const bf16* w_m3, const float* b_m, const float* ln2, float* out, void* workspace,
    unsigned* counters, const int* items, int n_items, const int* waits, const int* totals,
    unsigned epoch, int N, int L, int H, int reps, int rt, int NL, int p2n_rows,
    void* stream_ptr) {
  if (L % 16 != 0 || L < 16 || L > 256 || H < 4 || H % 4 != 0 || reps < 1 || N % reps != 0 ||
      rt < 1 || reps % rt != 0 || NL < 1 || n_items < 1 || p2n_rows < 1)
    return (int)cudaErrorInvalidValue;
  ChainArgs a;
  a.x = x; a.R9 = R9; a.t = t; a.mask = mask; a.z = z; a.bias = bias;
  a.w_proj = w_proj; a.w_out = w_out; a.w_m1 = w_m1; a.w_m2 = w_m2; a.w_m3 = w_m3;
  a.coef = coef; a.b_out = b_out; a.ln1 = ln1; a.b_m = b_m; a.ln2 = ln2;
  a.out = out;
  carve(static_cast<unsigned char*>(workspace), N, L, H, pw, ko, &a.w);
  a.items = items; a.waits = waits; a.totals = totals; a.counters = counters;
  a.n_items = n_items; a.epoch = epoch; a.ticket_base = 0;
  a.pw = pw; a.ko = ko; a.N = N; a.L = L; a.H = H; a.reps = reps; a.rt = rt; a.NL = NL;
  a.p2n_rows = p2n_rows;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  return L <= 128 ? launch_chain<AttnSmall>(a, stream) : launch_chain<AttnWide>(a, stream);
}

#ifdef GABLOCK_CHAIN_PROFILE
// Copies the nanosecond sums out (NKIND kinds, the waits, the blocks' runs,
// the tail's four GEMMs, each from the tail's start, p2n's copy waits) and,
// with reset, zeroes them. Returns a CUDA error code.
extern "C" int gablock_chain_profile_ns(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_profile_ns, sizeof(g_profile_ns));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[NPROFILE] = {};
    e = cudaMemcpyToSymbol(g_profile_ns, zero, sizeof(zero));
  }
  return (int)e;
}
#endif

extern "C" const char* gablock_chain_error_string(int err) {
  if (err == ERR_OCCUPANCY) return "the block does not fit an SM";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
