// ssd_scan: the Mamba2 SSD (state-space duality) chunked scan of one layer's prefill.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas (kernel
// ssd_scan_kernel, pallas_call at :105) and, in the port's model, the
// reference's XLA scan repro/models/ssm.py::_ssd_chunk_scan.  Inputs: x
// (B, L, nh, hd) raw, dt (B, L, nh) fp32 after softplus, B_in and C_in
// (B, L, s) in x's dtype, A (nh,) fp32 and negative.  Outputs: y (B, L, nh, hd)
// in x's dtype and the final state (B, nh, hd, s) in fp32.  x̄ = x * dt is
// formed in fp32 and, with round_xbar, rounded to x's dtype before use: the
// model rounds it (repro/models/ssm.py:148), the TPU kernel does not
// (ssd_scan.py:47); the two agree in fp32.
//
// Per chunk of Q steps, with l the within-chunk cumulative sum of dt * A:
//     y_t   = sum_{u <= t} (C_t . B_u) exp(l_t - l_u) x̄_u  +  exp(l_t) C_t . state
//     state = state exp(l_last) + sum_u B_u exp(l_last - l_u) x̄_u
// The t < u half of l_t - l_u is positive: it is never exponentiated (the
// product is set to 0 before any exp), so it cannot overflow.
//
// The chunk.  The kernel walks chunks of its own fixed Q = 64 and pads the
// last one with dt = 0 and x = B = C = 0.  That padding is exact: a padded
// step decays by exp(0) = 1 and adds 0 to the state, and its y is not
// written.  So a prime L costs ceil(L / 64) chunks, where the reference's
// rule (Q = min(chunk, L), halved until it divides L) falls to Q = 1; the
// plain version (kernels/ref.py::ssd_chunk_scan_ref) keeps that rule, and
// the two differ in summation order only.  Q stays 64 by design: it is one
// 64-row tile (four 16-row warp tiles), and chip_smoke.py's bf16 end-to-end
// gate measures the reference's own spread at this chunk (SSD_CHUNK).
//
// No carry between blocks.  On the TPU the chunk axis is a sequential grid
// axis and the (nh, hd, s) state lives in VMEM scratch across grid steps.
// Here the chunk loop runs inside the block.  Column d of the head dim is
// independent of every other, so the grid is (hd / DT, nh, B): each block
// owns DT columns of one head of one sequence.  DT (32 or 16) is the
// wrapper's plan (kernels/ssd_scan.py::ssd_plan, from the shapes and the SM
// count alone): the narrowest tile whose grid fits one block an SM, else the
// widest.
//
// What bounds it on the H100: at zamba2-1.2b's (B, L) = (1, 512) prefill
// (nh 64, hd 64, s 64) the function reads x, dt, B, C once and writes y and
// the state, ~9.7 MB: 2.9 us at 3.35 TB/s, against ~0.3 GFLOP of chunked
// products (0.3 us of bf16 tensor cores), so bytes set the card's bound.
// One launch cannot reach it (the empty-launch floor is ~5.5 us), and the
// chunk loop is sequential: what bounds the kernel is each SM's work on a
// chunk (about 3.4 us a chunk at that shape), most of it the tensor-core
// products and the conversions that feed them.  The bf16 design:
// * Tensor cores for the four chunk products (mma.sync m16n8k16, bf16 in,
//   fp32 accumulate; hopper.cuh), no scalar loop over shared memory.  Eight
//   warps: warps 0-3 ("intra") own the chunk's rows t in [16 w, 16 w + 16)
//   and compute C state^T and the intra-chunk product for them, and write
//   y; warps 4-7 ("state") own 16-row tiles of s and update the state, which
//   they keep in registers (fp32) for the whole scan and copy to shared
//   memory for the next chunk's C state^T.  mma.sync, not wgmma: the
//   operands of the scores and the state update are made in registers.
// * The decayed scores (C_t . B_u) exp(l_t - l_u) w_u, masked to u <= t,
//   depend on the head and not on its columns, so they are made once for
//   the head's column tiles: those blocks form a cluster (up to 4), the ten
//   16 x 16 score tiles of a chunk are dealt to the cluster's intra warps,
//   and each writes its tile's A fragments to its shared memory, from where
//   every block of the cluster reads them (distributed shared memory; one
//   cluster barrier a chunk, whose wait C state^T fills).  Recomputing C B^T
//   in every block cost 12% of the call at zamba2's shape and 24% at
//   mamba2's (chip_smoke.py --ssd-only, measured on that design).
// * Precision: no operand loses fp32 accuracy.  C, B and x are bf16 values
//   and enter the products as they are (x̄ too under round_xbar: bf16(x dt)
//   is formed in registers).  An operand that carries fp32 values is split
//   into hi = bf16(v) and lo = bf16(v - hi), and both are multiplied (~16
//   significant bits kept): the decayed scores, the carried state, and
//   B_u exp(l_last - l_u) w_u.  Without round_xbar the weight w_u = dt_u is
//   folded into those operands and x enters raw, so x̄'s fp32 value is never
//   rounded.  Plain bf16 rounding of them would put ~2^-9 relative error
//   into the state (tests/test_torch_ssd_plan.py); TF32 is not used.
// * The next chunk loads while this one computes: a two-stage ring of TMA
//   boxes (B and C 64 x 64 with a 128-byte swizzle, x 64 x DT), one thread
//   issuing three boxes a chunk (one box per 64 state columns of B and C),
//   completion counted on an mbarrier; rows past L and columns past s land
//   as zeros (per-thread copies, cp.async or a bulk copy a row, held the
//   copying warps for most of a chunk).  The state's copy is
//   double-buffered too (chunk c reads buffer c % 2 and writes the other),
//   so one block barrier a chunk orders everything.
// * The cumulative sum off thread 0: each warp scans the chunk's dt A with
//   shuffles (lane i holds steps 2i and 2i + 1), no block barrier.
// fp32 (the tests' type) keeps FMA products on the CUDA cores, no TF32
// (ssd_scan_fma_kernel): 256 threads, operands in fp32 shared memory, a
// barrier between phases, the scan on one warp in step order.  Both kernels
// take a fixed summation order and no atomics: a call returns the same bits
// run to run.
#include "hopper.cuh"

namespace {

using repro::hopper::cluster_addr;
using repro::hopper::cluster_arrive;
using repro::hopper::cluster_wait;
using repro::hopper::cp_async4;
using repro::hopper::cp_async_commit;
using repro::hopper::cp_async_wait;
using repro::hopper::fence_barrier_init;
using repro::hopper::ld_cluster_f4;
using repro::hopper::ldmatrix_x4;
using repro::hopper::ldmatrix_x4_trans;
using repro::hopper::mbar_arrive;
using repro::hopper::mbar_arrive_expect_tx;
using repro::hopper::mbar_init;
using repro::hopper::mbar_wait;
using repro::hopper::mma_16816;
using repro::hopper::pack_bf16;
using repro::hopper::smem_u32;
using repro::hopper::tma_load_3d;
using repro::hopper::tma_load_4d;
using bf16 = __nv_bfloat16;

constexpr int Q = 64;  // the kernel's chunk length

// ---------------------------------------------------------------------------
// bf16: tensor-core chunk products
// ---------------------------------------------------------------------------
constexpr int TILES = Q / 16;        // 16-row tiles of the chunk, one warp pair each
constexpr int THREADS = 64 * TILES;  // warps 0-3 the intra-chunk path, 4-7 the state path
constexpr int BOX = 64;              // state columns a TMA box of B or C (128 bytes, swizzled)
constexpr int BOX_BYTES = Q * BOX * 2;
constexpr int SCORE_TILES = TILES * (TILES + 1) / 2;  // 16 x 16 tiles (t, u <= t) of the decayed scores
constexpr int SCORE_BYTES = SCORE_TILES * 2 * 32 * 16;  // their A fragments, hi and lo, 16 bytes a lane

// Score tile k is (row tile i, column tile j), row by row: i (i + 1) / 2 + j.
__device__ __forceinline__ int score_row(int k) { return k < 1 ? 0 : k < 3 ? 1 : k < 6 ? 2 : 3; }

// Row pitch (elements) of the state's shared copy, DT columns wide: 16 bytes
// of padding, so that the 8 rows an ldmatrix reads fall in distinct banks.
__host__ __device__ constexpr int st_pitch(int dt) { return dt + 8; }
__host__ __device__ inline int boxes(int sp) { return (sp + BOX - 1) / BOX; }

// One ring stage, every tile on 1024 bytes: B and C [boxes][Q][64] (128-byte
// swizzle), x [Q][DT] (a DT * 2-byte swizzle), dt [Q] fp32 (in 1 KB).
__host__ __device__ inline size_t stage_bytes(int dt, int sp) {
    return 2 * (size_t)boxes(sp) * BOX_BYTES + (size_t)Q * dt * 2 + 1024;
}
// 1 KB to align the window; two ring stages; the state's copy, two buffers of
// hi and lo [sp][st_pitch]; each warp's [2][Q] fp32 of l and decay factors;
// the decayed scores' fragments, two buffers; a stage's mbarrier each.
// kernels/ssd_scan.py::mma_smem mirrors it.
__host__ __device__ inline size_t mma_smem(int dt, int sp) {
    return 1024 + 2 * stage_bytes(dt, sp) + 4 * 2 * (size_t)sp * st_pitch(dt) + (size_t)(THREADS / 32) * 2 * Q * 4 +
           2 * SCORE_BYTES + 2 * 8;
}

// Byte offset of (row, col) in a B or C tile as TMA wrote it: 64-column boxes
// of 128-byte rows, the 16-byte chunks of a row XORed with the row's low bits.
__device__ __forceinline__ uint32_t bc_off(int row, int col) {
    return (col >> 6) * BOX_BYTES + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}
// Byte offset of (row, col) in the x tile: DT * 2-byte rows, swizzled by that span.
template <int DT>
__device__ __forceinline__ uint32_t x_off(int row, int col) {
    return repro::hopper::swizzle<DT * 2>(row * DT * 2 + col * 2);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// hi = bf16(v), lo = bf16(v - hi) for a pair (the low half of each word holds a)
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
    hi = pack_bf16(__bfloat162float(ha), __bfloat162float(hb));
    lo = pack_bf16(a - __bfloat162float(ha), b - __bfloat162float(hb));
}

// Row and column (elements) of this lane's address for an ldmatrix.x4 that
// yields the fragments of two n8 tiles (rows) x one k16 step (columns) from
// an n-major tile, or (with .trans) the A fragment of one m16 x k16 tile from
// a k-major one: rows (lane & 7) + 8 (lane >> 4), column 8 ((lane >> 3) & 1).
__device__ __forceinline__ int pair_row(int lane) { return (lane & 7) + 8 * (lane >> 4); }
__device__ __forceinline__ int pair_col(int lane) { return 8 * ((lane >> 3) & 1); }

// The state's B fragments (k16 x n8, "col": k = state column, n = head column)
// of NT n8 tiles, k rows [16 ks, 16 ks + 16), from its copy [k][d]: ldmatrix.trans.
template <int NT>
__device__ __forceinline__ void load_state(uint32_t (&b)[NT][2], uint32_t base, int ks, int lane) {
    constexpr int pitch = st_pitch(8 * NT) * 2;
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, base + (16 * ks + (lane & 15)) * pitch + (16 * p + 8 * (lane >> 4)) * 2);
        b[2 * p][0] = r[0], b[2 * p][1] = r[1], b[2 * p + 1][0] = r[2], b[2 * p + 1][1] = r[3];
    }
}

// The x fragments (B operand: k = step u, n = column d) of u-step kk;
// x̄ = bf16(x dt) formed in registers under round_xbar.
template <int NT>
__device__ __forceinline__ void load_x(uint32_t (&xf)[NT][2], int kk, uint32_t xs_a, const float* dts,
                                       int round_xbar, int lane) {
    const int tig = lane & 3;
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, xs_a + x_off<8 * NT>(16 * kk + (lane & 15), 16 * p + 8 * (lane >> 4)));
        xf[2 * p][0] = r[0], xf[2 * p][1] = r[1], xf[2 * p + 1][0] = r[2], xf[2 * p + 1][1] = r[3];
    }
    if (round_xbar) {
        const float2 dlo = *reinterpret_cast<const float2*>(dts + 16 * kk + 2 * tig);
        const float2 dhi = *reinterpret_cast<const float2*>(dts + 16 * kk + 8 + 2 * tig);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const float2 v0 = unpack_bf16(xf[j][0]), v1 = unpack_bf16(xf[j][1]);
            xf[j][0] = pack_bf16(v0.x * dlo.x, v0.y * dlo.y);
            xf[j][1] = pack_bf16(v1.x * dhi.x, v1.y * dhi.y);
        }
    }
}

// The chunk's l on one warp, a shuffle scan: lane i gets steps 2i and 2i + 1
// (written to wl) and every lane l_last.
__device__ __forceinline__ float chunk_scan(const float* dts, float a, int lane, float* wl, float& l_even,
                                            float& l_odd) {
    const float2 d = *reinterpret_cast<const float2*>(dts + 2 * lane);
    const float v0 = d.x * a;
    float p = v0 + d.y * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, p, o);
        if (lane >= o) p += up;
    }
    const float before = __shfl_up_sync(0xffffffffu, p, 1);
    l_even = (lane == 0 ? 0.f : before) + v0;
    l_odd = p;
    *reinterpret_cast<float2*>(wl + 2 * lane) = make_float2(l_even, l_odd);
    return __shfl_sync(0xffffffffu, p, 31);
}

// Two blocks an SM where the shared memory allows it (s <= 64), so at most 128 registers a thread.
template <int DT, int SPMAX>
__global__ void __launch_bounds__(THREADS, SPMAX <= 64 ? 2 : 1)
ssd_scan_kernel(const __grid_constant__ CUtensorMap map_b, const __grid_constant__ CUtensorMap map_c,
                const __grid_constant__ CUtensorMap map_x, const bf16* __restrict__ x, const float* __restrict__ dt,
                const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const float* __restrict__ A,
                bf16* __restrict__ y, float* __restrict__ state_out, int L, int nh, int hd, int s, int sp,
                int round_xbar, int tma, int cl) {
    constexpr int NT = DT / 8;                            // n8 tiles over the block's columns
    constexpr int KT_MAX = SPMAX / 16;                    // k16 steps over the state
    constexpr int ST_MAX = (KT_MAX + TILES - 1) / TILES;  // 16-row state tiles a state warp
    constexpr int XP = st_pitch(DT);
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = repro::hopper::align1024(smem_raw);
    const int nb = boxes(sp);
    const size_t stage = stage_bytes(DT, sp);
    bf16* stbuf = reinterpret_cast<bf16*>(smem + 2 * stage);  // [parity][hi, lo][sp][XP]
    float* wl_all = reinterpret_cast<float*>(stbuf + 4 * (size_t)sp * XP);  // [warp][2][Q]
    uint8_t* scores = reinterpret_cast<uint8_t*>(wl_all + (THREADS / 32) * 2 * Q);  // [2][k][hi, lo][lane][16 B]
    uint64_t* full = reinterpret_cast<uint64_t*>(scores + 2 * SCORE_BYTES);  // [2] a stage's bytes
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
    const int w = warp % TILES;  // the chunk's rows [16 w, 16 w + 16) are this warp's (and its pair's)
    const bool intra = warp < TILES;
    float* wl = wl_all + warp * 2 * Q;  // l
    float* wx = wl + Q;  // state warps: exp(l_last - l_u) w_u
    const int d0 = blockIdx.x * DT, h = blockIdx.y, b = blockIdx.z, rank = blockIdx.x % cl;
    const float a = A[h];
    const int nkt = sp / 16, nc = (L + Q - 1) / Q;
    const size_t row0 = (size_t)b * L;
    const int ta = 16 * w + gid, tb = ta + 8;  // this lane's rows of the accumulators

    // The state warps load chunk c into stage `stg`.  With tma (s % 8 == 0, bases on 16 bytes)
    // one thread issues a TMA box per 64 state columns of B and of C and one of x, counted on
    // full[stg]; rows past L and columns past s land as zeros.  Else element by element into the
    // same swizzled layout.  dt by 4-byte copies.
    auto load_chunk = [&](int c, int stg) {
        uint8_t* Bs = smem + stg * stage;
        uint8_t* Cs = Bs + nb * BOX_BYTES;
        uint8_t* Xs = Cs + nb * BOX_BYTES;
        float* dts = reinterpret_cast<float*>(Xs + Q * DT * 2);
        const int t0 = c * Q, n = min(Q, L - t0), st = tid - 32 * TILES;
        if (st < Q) cp_async4(smem_u32(dts + st), st < n ? dt + (row0 + t0 + st) * nh + h : dt, st < n ? 4 : 0);
        if (tma) {
            if (st == Q) {
                mbar_arrive_expect_tx(&full[stg], 2 * nb * BOX_BYTES + Q * DT * 2);
                for (int j = 0; j < nb; ++j) {
                    tma_load_3d(Bs + j * BOX_BYTES, &map_b, &full[stg], BOX * j, t0, b);
                    tma_load_3d(Cs + j * BOX_BYTES, &map_c, &full[stg], BOX * j, t0, b);
                }
                tma_load_4d(Xs, &map_x, &full[stg], d0, h, t0, b);
            }
        } else {
            if (st == Q) mbar_arrive(&full[stg]);  // no bytes in flight: the phase completes on this arrival
            const bf16 zero = __float2bfloat16_rn(0.f);
            for (int i = st; i < Q * DT; i += 32 * TILES) {
                const int r = i / DT, d = i % DT;
                *reinterpret_cast<bf16*>(Xs + x_off<DT>(r, d)) =
                    r < n ? x[((row0 + t0 + r) * nh + h) * hd + d0 + d] : zero;
            }
            for (int i = st; i < Q * nb * BOX; i += 32 * TILES) {
                const int r = i / (nb * BOX), k = i % (nb * BOX);
                const bool ok = r < n && k < s;
                const size_t g = (row0 + t0 + r) * s + k;
                *reinterpret_cast<bf16*>(Bs + bc_off(r, k)) = ok ? Bm[g] : zero;
                *reinterpret_cast<bf16*>(Cs + bc_off(r, k)) = ok ? Cm[g] : zero;
            }
        }
    };

    // the state's buffer 0 is the zero state the first chunk reads
    for (int i = tid; i < sp * XP; i += THREADS) reinterpret_cast<uint32_t*>(stbuf)[i] = 0u;
    if (tid == 0) {
        mbar_init(&full[0], 1);
        mbar_init(&full[1], 1);
        fence_barrier_init();
    }
    __syncthreads();
    float sacc[ST_MAX][NT][4];  // a state warp's 16-row tiles of the state, [k][d] (mma rows k, columns d)
#pragma unroll
    for (int i = 0; i < ST_MAX; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) sacc[i][j][r] = 0.f;

    if (!intra) load_chunk(0, 0);
    cp_async_commit();
    for (int c = 0; c < nc; ++c) {
        const int t0 = c * Q, n = min(Q, L - t0);
        cp_async_wait<0>();
        mbar_wait(&full[c & 1], (c >> 1) & 1);
        __syncthreads();  // chunk c's stage visible; chunk c - 1 done with the other stage and state buffer
        if (!intra && c + 1 < nc) load_chunk(c + 1, (c + 1) & 1);
        cp_async_commit();

        const uint8_t* Bs = smem + (c & 1) * stage;
        const float* dts = reinterpret_cast<const float*>(Bs + 2 * nb * BOX_BYTES + Q * DT * 2);
        const uint32_t bs_a = smem_u32(Bs), cs_a = bs_a + nb * BOX_BYTES, xs_a = cs_a + nb * BOX_BYTES;
        float l_even, l_odd;

        if (intra) {
            chunk_scan(dts, a, lane, wl, l_even, l_odd);
            __syncwarp();
            // The decayed scores (C_t . B_u) exp(l_t - l_u) w_u depend on the head, not on its
            // columns: the cluster's blocks (the column tiles of one head) share them.  Tile k goes
            // to warp k % 4 of block (k / 4) % cl, which writes its A fragments (hi, lo) for all.
            uint8_t* sc = scores + (c & 1) * SCORE_BYTES;
            for (int k = 4 * rank + w; k < SCORE_TILES; k += 4 * cl) {
                const int i = score_row(k), j = k - i * (i + 1) / 2;
                float g[2][4] = {};
#pragma unroll
                for (int ks = 0; ks < KT_MAX; ++ks) {
                    if (ks < nkt) {
                        uint32_t ca[4], bb[4];
                        ldmatrix_x4(ca, cs_a + bc_off(16 * i + (lane & 15), 16 * ks + 8 * (lane >> 4)));
                        ldmatrix_x4(bb, bs_a + bc_off(16 * j + pair_row(lane), 16 * ks + pair_col(lane)));
                        mma_16816(g[0], ca, bb[0], bb[1]);
                        mma_16816(g[1], ca, bb[2], bb[3]);
                    }
                }
                const int ra = 16 * i + gid, rb = ra + 8;
                const float la = wl[ra], lb = wl[rb];
                uint32_t fh[4], fl[4];
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int u = 16 * j + 8 * half + 2 * tig;
                    const float2 lu = *reinterpret_cast<const float2*>(wl + u);
                    const float2 wu = round_xbar ? make_float2(1.f, 1.f) : *reinterpret_cast<const float2*>(dts + u);
                    // masked before the exp: l_t - l_u > 0 for u > t is never exponentiated
                    const float m0 = u <= ra ? g[half][0] * expf(la - lu.x) * wu.x : 0.f;
                    const float m1 = u + 1 <= ra ? g[half][1] * expf(la - lu.y) * wu.y : 0.f;
                    const float m2 = u <= rb ? g[half][2] * expf(lb - lu.x) * wu.x : 0.f;
                    const float m3 = u + 1 <= rb ? g[half][3] * expf(lb - lu.y) * wu.y : 0.f;
                    split_pack(m0, m1, fh[2 * half], fl[2 * half]);
                    split_pack(m2, m3, fh[2 * half + 1], fl[2 * half + 1]);
                }
                *reinterpret_cast<uint4*>(sc + ((2 * k) * 32 + lane) * 16) = make_uint4(fh[0], fh[1], fh[2], fh[3]);
                *reinterpret_cast<uint4*>(sc + ((2 * k + 1) * 32 + lane) * 16) = make_uint4(fl[0], fl[1], fl[2], fl[3]);
            }
            cluster_arrive();

            // C state^T for this warp's rows, on the state this chunk starts from (while the other
            // blocks of the cluster finish their score tiles)
            const uint32_t sh_a = smem_u32(stbuf + (size_t)(2 * (c & 1)) * sp * XP), sl_a = sh_a + sp * XP * 2;
            float ys[NT][4];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) ys[j][r] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KT_MAX; ++ks) {
                if (ks < nkt) {
                    uint32_t ca[4], shf[NT][2], slf[NT][2];
                    ldmatrix_x4(ca, cs_a + bc_off(16 * w + (lane & 15), 16 * ks + 8 * (lane >> 4)));
                    load_state<NT>(shf, sh_a, ks, lane);
                    load_state<NT>(slf, sl_a, ks, lane);
#pragma unroll
                    for (int j = 0; j < NT; ++j) {
                        mma_16816(ys[j], ca, shf[j][0], shf[j][1]);
                        mma_16816(ys[j], ca, slf[j][0], slf[j][1]);
                    }
                }
            }
            cluster_wait();  // every score tile of the chunk is in its block's shared memory

            // the intra-chunk product: this warp's rows against the u-tiles up to its own (every
            // tile's fragments requested before the first product)
            uint32_t ah[TILES][4], al[TILES][4];
#pragma unroll
            for (int kk = 0; kk < TILES; ++kk) {
                if (kk <= w) {
                    const int k = w * (w + 1) / 2 + kk;
                    const uint32_t at = cluster_addr(smem_u32(sc + ((2 * k) * 32 + lane) * 16), (k / 4) % cl);
                    const float4 hv = ld_cluster_f4(at), lv = ld_cluster_f4(at + 32 * 16);
                    ah[kk][0] = __float_as_uint(hv.x), ah[kk][1] = __float_as_uint(hv.y);
                    ah[kk][2] = __float_as_uint(hv.z), ah[kk][3] = __float_as_uint(hv.w);
                    al[kk][0] = __float_as_uint(lv.x), al[kk][1] = __float_as_uint(lv.y);
                    al[kk][2] = __float_as_uint(lv.z), al[kk][3] = __float_as_uint(lv.w);
                }
            }
            float yi[NT][4];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) yi[j][r] = 0.f;
#pragma unroll
            for (int kk = 0; kk < TILES; ++kk) {
                if (kk <= w) {
                    uint32_t xf[NT][2];
                    load_x<NT>(xf, kk, xs_a, dts, round_xbar, lane);
#pragma unroll
                    for (int j = 0; j < NT; ++j) {
                        mma_16816(yi[j], ah[kk], xf[j][0], xf[j][1]);
                        mma_16816(yi[j], al[kk], xf[j][0], xf[j][1]);
                    }
                }
            }

            // y = intra + exp(l_t) C_t . state
            const float ea = expf(wl[ta]), eb = expf(wl[tb]);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int d = d0 + 8 * j + 2 * tig;
                if (ta < n)
                    *reinterpret_cast<uint32_t*>(y + ((row0 + t0 + ta) * nh + h) * hd + d) =
                        pack_bf16(yi[j][0] + ys[j][0] * ea, yi[j][1] + ys[j][1] * ea);
                if (tb < n)
                    *reinterpret_cast<uint32_t*>(y + ((row0 + t0 + tb) * nh + h) * hd + d) =
                        pack_bf16(yi[j][2] + ys[j][2] * eb, yi[j][3] + ys[j][3] * eb);
            }
        } else {
            cluster_arrive();  // the state warps take no score tile
            bf16* nh_p = stbuf + (size_t)(2 * ((c + 1) & 1)) * sp * XP;
            bf16* nl_p = nh_p + sp * XP;

            const float l_last = chunk_scan(dts, a, lane, wl, l_even, l_odd);
            const float2 dd = *reinterpret_cast<const float2*>(dts + 2 * lane);
            *reinterpret_cast<float2*>(wx + 2 * lane) =
                make_float2((round_xbar ? 1.f : dd.x) * expf(l_last - l_even),
                            (round_xbar ? 1.f : dd.y) * expf(l_last - l_odd));
            __syncwarp();

            // state = state exp(l_last) + (B_u exp(l_last - l_u) w_u)^T x, this warp's 16-row tiles of s
            const float decay = expf(l_last);
#pragma unroll
            for (int i = 0; i < ST_MAX; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int r = 0; r < 4; ++r) sacc[i][j][r] *= decay;
#pragma unroll
            for (int kk = 0; kk < TILES; ++kk) {
                uint32_t xf[NT][2];
                load_x<NT>(xf, kk, xs_a, dts, round_xbar, lane);
                const float2 vlo = *reinterpret_cast<const float2*>(wx + 16 * kk + 2 * tig);
                const float2 vhi = *reinterpret_cast<const float2*>(wx + 16 * kk + 8 + 2 * tig);
#pragma unroll
                for (int i = 0; i < ST_MAX; ++i) {
                    const int q = w + TILES * i;
                    if (q < nkt) {
                        uint32_t ba[4], ah[4], al[4];
                        ldmatrix_x4_trans(ba, bs_a + bc_off(16 * kk + pair_row(lane), 16 * q + pair_col(lane)));
#pragma unroll
                        for (int r = 0; r < 4; ++r) {
                            const float2 v = unpack_bf16(ba[r]), wgt = r < 2 ? vlo : vhi;
                            split_pack(v.x * wgt.x, v.y * wgt.y, ah[r], al[r]);
                        }
#pragma unroll
                        for (int j = 0; j < NT; ++j) {
                            mma_16816(sacc[i][j], ah, xf[j][0], xf[j][1]);
                            mma_16816(sacc[i][j], al, xf[j][0], xf[j][1]);
                        }
                    }
                }
            }
            // the next chunk's copy of the state: rows k, columns d
#pragma unroll
            for (int i = 0; i < ST_MAX; ++i) {
                const int q = w + TILES * i;
                if (q < nkt) {
#pragma unroll
                    for (int j = 0; j < NT; ++j) {
                        const int k = 16 * q + gid, d = 8 * j + 2 * tig;
                        uint32_t hi, lo;
                        split_pack(sacc[i][j][0], sacc[i][j][1], hi, lo);
                        *reinterpret_cast<uint32_t*>(nh_p + k * XP + d) = hi;
                        *reinterpret_cast<uint32_t*>(nl_p + k * XP + d) = lo;
                        split_pack(sacc[i][j][2], sacc[i][j][3], hi, lo);
                        *reinterpret_cast<uint32_t*>(nh_p + (k + 8) * XP + d) = hi;
                        *reinterpret_cast<uint32_t*>(nl_p + (k + 8) * XP + d) = lo;
                    }
                }
            }
            cluster_wait();
        }
    }
    cp_async_wait<0>();
    cluster_arrive();
    cluster_wait();  // no block leaves while another reads its score tiles

    if (!intra) {
#pragma unroll
        for (int i = 0; i < ST_MAX; ++i) {
            const int q = w + TILES * i;
            if (q < nkt) {
#pragma unroll
                for (int j = 0; j < NT; ++j) {
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        const int k = 16 * q + gid + 8 * (r >> 1), d = d0 + 8 * j + 2 * tig + (r & 1);
                        if (k < s) state_out[(((size_t)b * nh + h) * hd + d) * s + k] = sacc[i][j][r];
                    }
                }
            }
        }
    }
}

template <int DT, int SPMAX>
int launch_mma(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A, void* y, void* state,
               int B, int L, int nh, int hd, int s, int sp, int round_xbar, int cl, void* stream) {
    auto kernel = ssd_scan_kernel<DT, SPMAX>;
    const size_t bytes = mma_smem(DT, sp);
    cudaError_t e = repro::allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    // TMA reads B, C (s x L x B, boxes of 64 x 64) and x (hd x nh x L x B, boxes of DT x 1 x 64 x 1)
    // in place when their rows and bases lie on 16 bytes; rows past L and columns past s load as zeros
    CUtensorMap map_b{}, map_c{}, map_x{};
    const int tma = s % 8 == 0 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
                                    reinterpret_cast<uintptr_t>(Cm)) & 15) == 0;
    if (tma) {
        const cuuint64_t bc_dims[3] = {(cuuint64_t)s, (cuuint64_t)L, (cuuint64_t)B};
        const cuuint64_t bc_strides[2] = {(cuuint64_t)s * 2, (cuuint64_t)L * s * 2};
        const cuuint32_t bc_box[3] = {BOX, Q, 1};
        if ((e = repro::hopper::encode_bf16_map(&map_b, Bm, 3, bc_dims, bc_strides, bc_box, 128)) != cudaSuccess) return e;
        if ((e = repro::hopper::encode_bf16_map(&map_c, Cm, 3, bc_dims, bc_strides, bc_box, 128)) != cudaSuccess) return e;
        const cuuint64_t x_dims[4] = {(cuuint64_t)hd, (cuuint64_t)nh, (cuuint64_t)L, (cuuint64_t)B};
        const cuuint64_t x_strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)nh * hd * 2, (cuuint64_t)L * nh * hd * 2};
        const cuuint32_t x_box[4] = {DT, 1, Q, 1};
        if ((e = repro::hopper::encode_bf16_map(&map_x, x, 4, x_dims, x_strides, x_box, DT * 2)) != cudaSuccess) return e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(hd / DT, nh, B);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, map_b, map_c, map_x, static_cast<const bf16*>(x),
                           static_cast<const float*>(dt), static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
                           static_cast<const float*>(A), static_cast<bf16*>(y), static_cast<float*>(state), L, nh, hd,
                           s, sp, round_xbar, tma, cl);
    return e != cudaSuccess ? e : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMA products
// ---------------------------------------------------------------------------
constexpr int FMA_THREADS = 256;  // 8 warps

inline size_t fma_smem(int dt, int s) {
    // Bs, Cs [Q][s+1]; Xs [Q][DT+1]; Ms [Q][Q+1]; St [DT][s+1]; lc, el, wi, dts [Q]
    return sizeof(float) * ((size_t)2 * Q * (s + 1) + (size_t)Q * (dt + 1) + (size_t)Q * (Q + 1) +
                            (size_t)dt * (s + 1) + 4 * Q);
}

template <int DT>
__global__ void __launch_bounds__(FMA_THREADS)
ssd_scan_fma_kernel(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ A, float* __restrict__ y,
                    float* __restrict__ state_out, int L, int nh, int hd, int s) {
    extern __shared__ float smem_f[];
    const int sp = s + 1;  // odd row pitch: a warp walking rows hits distinct banks
    float* Bs = smem_f;              // [Q][s+1]  B rows of the chunk
    float* Cs = Bs + Q * sp;         // [Q][s+1]  C rows of the chunk
    float* Xs = Cs + Q * sp;         // [Q][DT+1] x̄ of this block's columns
    float* Ms = Xs + Q * (DT + 1);   // [Q][Q+1]  (C_t . B_u) exp(l_t - l_u), 0 for u > t
    float* St = Ms + Q * (Q + 1);    // [DT][s+1] the carried state
    float* lc = St + DT * sp;        // [Q] within-chunk cumulative log-decay
    float* el = lc + Q;              // [Q] exp(l_t)
    float* wi = el + Q;              // [Q] exp(l_last - l_u)
    float* dts = wi + Q;             // [Q] dt

    const int d0 = blockIdx.x * DT, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const float a = A[h];
    for (int i = tid; i < DT * sp; i += FMA_THREADS) St[i] = 0.f;

    for (int t0 = 0; t0 < L; t0 += Q) {
        const int n = min(Q, L - t0);  // real steps of this chunk; the rest are padding
        if (tid < Q) dts[tid] = tid < n ? dt[((size_t)b * L + t0 + tid) * nh + h] : 0.f;
        for (int i = tid; i < Q * s; i += FMA_THREADS) {
            const int t = i / s, k = i % s;
            const size_t g = ((size_t)b * L + t0 + t) * s + k;
            Bs[t * sp + k] = t < n ? Bm[g] : 0.f;
            Cs[t * sp + k] = t < n ? Cm[g] : 0.f;
        }
        __syncthreads();  // dts visible; the previous chunk's state update done
        for (int i = tid; i < Q * DT; i += FMA_THREADS) {
            const int t = i / DT, d = i % DT;
            Xs[t * (DT + 1) + d] = t < n ? x[(((size_t)b * L + t0 + t) * nh + h) * hd + d0 + d] * dts[t] : 0.f;
        }
        if (tid < 32) {  // the cumulative sum in step order, lane i keeping steps i and i + 32
            float acc = 0.f, l0 = 0.f, l1 = 0.f;
            for (int t = 0; t < Q; ++t) {
                acc = __fadd_rn(acc, __fmul_rn(dts[t], a));
                if (t == tid) l0 = acc;
                if (t == tid + 32) l1 = acc;
            }
            lc[tid] = l0, lc[tid + 32] = l1;
        }
        __syncthreads();
        if (tid < Q) {
            el[tid] = expf(lc[tid]);
            wi[tid] = expf(lc[Q - 1] - lc[tid]);
        }
        for (int i = tid; i < Q * Q; i += FMA_THREADS) {
            const int t = i / Q, u = i % Q;
            float m = 0.f;
            if (u <= t) {  // masked before the exp
                float cb = 0.f;
                for (int k = 0; k < s; ++k) cb = fmaf(Cs[t * sp + k], Bs[u * sp + k], cb);
                m = cb * expf(lc[t] - lc[u]);
            }
            Ms[t * (Q + 1) + u] = m;
        }
        __syncthreads();
        for (int i = tid; i < n * DT; i += FMA_THREADS) {
            const int t = i / DT, d = i % DT;
            float yi = 0.f;
            for (int u = 0; u <= t; ++u) yi = fmaf(Ms[t * (Q + 1) + u], Xs[u * (DT + 1) + d], yi);
            float yc = 0.f;
            for (int k = 0; k < s; ++k) yc = fmaf(Cs[t * sp + k], St[d * sp + k], yc);
            y[(((size_t)b * L + t0 + t) * nh + h) * hd + d0 + d] = yi + yc * el[t];
        }
        __syncthreads();  // y read the state this chunk started from
        const float decay = el[Q - 1];
        for (int i = tid; i < DT * s; i += FMA_THREADS) {
            const int d = i / s, k = i % s;
            float acc = 0.f;
            for (int u = 0; u < Q; ++u) acc = fmaf(Bs[u * sp + k] * wi[u], Xs[u * (DT + 1) + d], acc);
            St[d * sp + k] = St[d * sp + k] * decay + acc;
        }
        __syncthreads();  // before the next chunk overwrites Bs, Xs
    }
    for (int i = tid; i < DT * s; i += FMA_THREADS) {
        const int d = i / s, k = i % s;
        state_out[(((size_t)b * nh + h) * hd + d0 + d) * s + k] = St[d * sp + k];
    }
}

template <int DT>
int launch_fma(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A, void* y, void* state,
               int B, int L, int nh, int hd, int s, void* stream) {
    auto kernel = ssd_scan_fma_kernel<DT>;
    const size_t bytes = fma_smem(DT, s);
    cudaError_t e = repro::allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid(hd / DT, nh, B);
    kernel<<<grid, FMA_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<const float*>(A), static_cast<float*>(y),
        static_cast<float*>(state), L, nh, hd, s);
    return cudaGetLastError();
}

}  // namespace

// The plan's columns a block, 16 or 32 (bf16: 32 only for s <= 128), divide
// hd; 1 <= s <= 256.  bf16: `cluster` blocks (at most 8) share a head's
// decayed scores and divide its column tiles; fp32 takes 1.  x̄ under
// round_xbar only in bf16 (in fp32 the two contracts are one).
REPRO_EXPORT int ssd_scan_bf16(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A, void* y,
                               void* state, int B, int L, int nh, int hd, int s, int round_xbar, int d_tile,
                               int cluster, void* stream) {
    if (L < 1 || s < 1 || s > 256 || d_tile < 1 || hd % d_tile || cluster < 1 || cluster > 8 ||
        (hd / d_tile) % cluster)
        return cudaErrorInvalidValue;
    const int sp = (s + 15) / 16 * 16;
#define SSD_LAUNCH(DT, SPMAX) \
    launch_mma<DT, SPMAX>(x, dt, Bm, Cm, A, y, state, B, L, nh, hd, s, sp, round_xbar, cluster, stream)
    if (sp <= 64) {
        switch (d_tile) {
            case 16: return SSD_LAUNCH(16, 64);
            case 32: return SSD_LAUNCH(32, 64);
        }
    } else if (sp <= 128) {
        switch (d_tile) {
            case 16: return SSD_LAUNCH(16, 128);
            case 32: return SSD_LAUNCH(32, 128);
        }
    } else if (d_tile == 16) {
        return SSD_LAUNCH(16, 256);
    }
#undef SSD_LAUNCH
    return cudaErrorInvalidValue;
}

REPRO_EXPORT int ssd_scan_f32(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A, void* y,
                              void* state, int B, int L, int nh, int hd, int s, int round_xbar, int d_tile,
                              int cluster, void* stream) {
    (void)round_xbar;  // rounding x̄ to fp32 is the identity
    if (L < 1 || s < 1 || s > 256 || d_tile < 1 || hd % d_tile || cluster != 1) return cudaErrorInvalidValue;
    switch (d_tile) {
        case 16: return launch_fma<16>(x, dt, Bm, Cm, A, y, state, B, L, nh, hd, s, stream);
        case 32: return launch_fma<32>(x, dt, Bm, Cm, A, y, state, B, L, nh, hd, s, stream);
        default: return cudaErrorInvalidValue;
    }
}
