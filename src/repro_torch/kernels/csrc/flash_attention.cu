// flash_attention: prefill attention (causal, sliding window, q_offset, GQA).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (kernel flash_attention_kernel, pallas_call at :95) and, in the port's
// model, the reference's XLA prefill loop models/attention.py::_flash_fwd_pass
// — whose numerics it follows, because the model's parity depends on them:
// q is scaled in fp32 and rounded back to q's dtype BEFORE the dot; scores
// accumulate in fp32; the online softmax is in fp32 (m and l; l sums the
// unrounded p); p = exp(s - m) is rounded to V's dtype before PV; the result
// is acc / max(l, 1e-30), rounded once.  The mask is _mask_for's: causal
// (q_pos >= k_pos), window (q_pos - k_pos < window), with q_pos offset by
// q_offset; key positions past Skv give p = 0.  GQA groups query heads onto
// their KV head (h / G) without repeating K/V.  Masked scores are the finite
// NEG_INF of common.cuh, so a row masked over a whole tile is zeroed by the
// next tile's correction factor and never turns NaN.  Key tiles that the
// causal or window mask empties for a whole block are skipped (exact: their
// contribution is exp(-1e30 - m) = 0, or is zeroed by the next correction).
// There are no atomics and no data-dependent order: two launches on the same
// inputs give the same bits.
//
// What bounds it on the H100: at the main path's prefills (B 4, S 256, causal;
// 32/8 heads at head_dim 64 or 128, or 32/32 heads at 64) the work is
// 1.1-2.2 GFLOP against 4-8 MB of q/k/v/out: 3-6 us at the card's bytes
// rate, 1-2 us at its bf16 tensor-core rate, so a few microseconds either
// way; what a kernel actually spends is latency (loads, the softmax's
// dependent steps) and the parallelism it exposes.
//
// The bf16 entry runs a Hopper kernel (sm_90a), one warpgroup a block:
// * A block owns 64 packed rows of one KV head: GP = gcd(G, 64) query heads
//   of the group times 64 / GP consecutive query positions (row = position
//   x GP + head), so each K/V tile is read once for those GP heads.  Q's
//   tile is one TMA box over (position, head, dim).  Launches (blocks of 128
//   threads): (4, 256) at 32/8 heads, hd 64 or 128: 16 position tiles x 8
//   KV heads x 4 = 512; at 32/32 heads (zamba2's G = 1): 4 x 32 x 4 = 512;
//   zamba2's (1, 512) prefill: 8 x 32 = 256.  The heaviest (causal: last)
//   position tiles start first.
// * K and V tiles of 64 positions arrive by TMA (swizzled 32/64/128 bytes by
//   head dim) into a two-stage ring with mbarriers: the next tile's copy is
//   in flight while the current tile's math runs; a stage is refilled as
//   soon as its products are done.
// * S = Q K^T is one wgmma chain (m64n64k16, both operands K-major in shared
//   memory; Q scaled in place first, then a proxy fence); S and the online
//   softmax state stay in registers.  P is rounded to bf16 in registers and
//   is the register A operand of O += P V (m64n{hd}k16, V MN-major through
//   the descriptor's transpose bit).  O (64 x hd fp32) lives in registers:
//   128 a thread at hd 256.
//
// The fp32 entry keeps the FMA kernel below (four threads a query row, K/V
// tiles widened into shared memory): tensor cores would take fp32 through
// TF32, which breaks the fp32 tolerance (1e-4) the reference is held to.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

// ---------------------------------------------------------------------------
// fp32: the FMA kernel
// ---------------------------------------------------------------------------
namespace fp32_fma {

constexpr int BQ = 32;        // query rows per block
constexpr int BKV = 64;       // key positions per tile
constexpr int THREADS = 128;  // 4 threads per query row
constexpr int CPT = BKV / 4;  // score columns per thread

template <int HD, int VD>
size_t smem_bytes() {
    return sizeof(float) * ((size_t)BQ * (HD + 1) + (size_t)BKV * (HD + 1) + (size_t)BKV * (VD + 1) +
                            (size_t)BQ * (BKV + 1));
}

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int Sq, int Skv, int H, int KV, int causal, int window,
                       int q_offset, float scale) {
    extern __shared__ float smem[];
    float* Qs = smem;                    // [BQ][HD+1]
    float* Ks = Qs + BQ * (HD + 1);      // [BKV][HD+1]
    float* Vs = Ks + BKV * (HD + 1);     // [BKV][VD+1]
    float* Ps = Vs + BKV * (VD + 1);     // [BQ][BKV+1]

    using repro::NEG_INF;
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int G = H / KV, kvh = h / G;
    const int tid = threadIdx.x, r = tid / 4, sub = tid % 4;
    const int qi = q0 + r;            // this thread's query row
    const int q_pos = q_offset + qi;  // its absolute position

    repro::load_rows_f32<T, true>(Qs, HD + 1, q + (((size_t)b * Sq + q0) * H + h) * HD, (size_t)H * HD, BQ, Sq - q0,
                                  HD, scale);

    // key range any row of this tile can see
    const int q_last = q_offset + min(q0 + BQ, Sq) - 1;
    int k_hi = causal ? min(Skv, q_last + 1) : Skv;
    int k_lo = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
    k_lo = (k_lo / BKV) * BKV;

    float m = NEG_INF, l = 0.f;
    float acc[VD / 4];
#pragma unroll
    for (int e = 0; e < VD / 4; ++e) acc[e] = 0.f;

    for (int k0 = k_lo; k0 < k_hi; k0 += BKV) {
        __syncthreads();  // previous tile consumed; Qs visible
        const size_t row0 = ((size_t)b * Skv + k0) * KV + kvh;
        repro::load_rows_f32<T>(Ks, HD + 1, k + row0 * HD, (size_t)KV * HD, BKV, Skv - k0, HD);
        repro::load_rows_f32<T>(Vs, VD + 1, v + row0 * VD, (size_t)KV * VD, BKV, Skv - k0, VD);
        __syncthreads();

        float s[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float qd = Qs[r * (HD + 1) + d];
#pragma unroll
            for (int j = 0; j < CPT; ++j) s[j] = fmaf(qd, Ks[(sub + 4 * j) * (HD + 1) + d], s[j]);
        }
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            int k_pos = k0 + sub + 4 * j;
            bool ok = k_pos < Skv;
            if (causal) ok = ok && q_pos >= k_pos;
            if (window > 0) ok = ok && q_pos - k_pos < window;
            s[j] = ok ? s[j] : NEG_INF;
            mx = fmaxf(mx, s[j]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m, mx);
        const float corr = expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            int c = sub + 4 * j;
            // as _flash_fwd_pass: p = exp(s - m), not re-masked (positions past
            // the sequence end, which the reference never sees, are zeroed)
            float p = (k0 + c < Skv) ? expf(s[j] - m_new) : 0.f;
            psum += p;
            Ps[r * (BKV + 1) + c] = repro::round_to<T>(p);
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        l = l * corr + psum;
        m = m_new;
        __syncwarp();  // a row's four threads share one warp

#pragma unroll
        for (int e = 0; e < VD / 4; ++e) acc[e] *= corr;
        for (int c = 0; c < BKV; ++c) {
            float p = Ps[r * (BKV + 1) + c];
#pragma unroll
            for (int e = 0; e < VD / 4; ++e) acc[e] = fmaf(p, Vs[c * (VD + 1) + sub + 4 * e], acc[e]);
        }
    }
    if (qi < Sq) {
        const float l_safe = fmaxf(l, 1e-30f);
        T* o = out + (((size_t)b * Sq + qi) * H + h) * VD;
#pragma unroll
        for (int e = 0; e < VD / 4; ++e) o[sub + 4 * e] = repro::from_f32<T>(acc[e] / l_safe);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv, int H, int KV,
           int causal, int window, int q_offset, float scale, void* stream) {
    auto kernel = flash_attention_kernel<T, HD, HD>;
    size_t bytes = smem_bytes<HD, HD>();
    cudaError_t e = repro::allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), Sq,
        Skv, H, KV, causal, window, q_offset, scale);
    return cudaGetLastError();
}

}  // namespace fp32_fma

// ---------------------------------------------------------------------------
// bf16: wgmma tiles fed by TMA
// ---------------------------------------------------------------------------
namespace bf16_wgmma {

using namespace repro::hopper;

constexpr int BQ = 64;   // packed rows a block (the wgmma M of one warpgroup)
constexpr int BKV = 64;  // key positions a tile
constexpr int THREADS = 128;

template <int HD>
struct Cfg {
    static constexpr int SW = HD * 2 >= 128 ? 128 : HD * 2;  // swizzle span = bytes of a tile row's chunk
    static constexpr int CH = SW / 2;                         // elements of a chunk
    static constexpr int NCH = HD / CH;                       // chunks across the head dim
    static constexpr int CHUNK = 64 * SW;                     // bytes of one chunk of a 64-row tile
    static constexpr int TILE = NCH * CHUNK;                  // bytes of a 64-row tile (64 x HD bf16)
    // K/V stages: two up to hd 64; one from hd 128, where a second would halve the blocks an
    // SM holds (shared memory) and the other resident blocks hide the load instead
    static constexpr int STAGES = HD >= 128 ? 1 : 2;
    // blocks an SM should hold: at hd 128, four (registers capped at 128 a thread) fill 132 SMs
    // with the main path's 512 blocks in one wave
    static constexpr int MIN_BLOCKS = HD == 128 ? 4 : 1;
    static constexpr int SMEM = TILE * (1 + 2 * STAGES) + 1024;  // Q, the K/V ring, alignment slack
};

// One key tile of the online softmax over this thread's two rows: mask (MASK:
// some position of the tile is out of range, causal- or window-masked for
// some row of the block), m, l, the correction of O, and p = exp(s - m) in
// place of s.  Element (i, t, e) of s is row i (row0 + 8 i), column 8 t + 2 quad + e.
template <bool MASK, int HD>
__device__ __forceinline__ void softmax_tile(float (&sc)[BKV / 2], float (&o)[HD / 2], float (&m)[2], float (&l)[2],
                                             const int (&q_pos)[2], int k0, int Skv, int causal, int window,
                                             int quad) {
    using repro::NEG_INF;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int t = 0; t < BKV / 8; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float& v = sc[4 * t + 2 * i + e];
                if (MASK) {
                    const int k_pos = k0 + 8 * t + 2 * quad + e;
                    bool ok = k_pos < Skv;
                    if (causal) ok = ok && q_pos[i] >= k_pos;
                    if (window > 0) ok = ok && q_pos[i] - k_pos < window;
                    v = ok ? v : NEG_INF;
                }
                mx = fmaxf(mx, v);
            }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int t = 0; t < BKV / 8; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                // as _flash_fwd_pass: p = exp(s - m), not re-masked (positions past
                // the sequence end, which the reference never sees, are zeroed)
                float& v = sc[4 * t + 2 * i + e];
                v = (!MASK || k0 + 8 * t + 2 * quad + e < Skv) ? expf(v - m_new) : 0.f;
                psum += v;
            }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        l[i] = l[i] * corr + psum;
        m[i] = m_new;
#pragma unroll
        for (int t = 0; t < HD / 8; ++t) {
            o[4 * t + 2 * i] *= corr;
            o[4 * t + 2 * i + 1] *= corr;
        }
    }
}

// K-major descriptor of k16 step kk of a 64-row tile (Q or K) of the head dim
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
    using Cf = Cfg<HD>;
    constexpr int PER = Cf::CH / 16;  // k16 steps in a chunk
    return make_desc(tile + (kk / PER) * Cf::CHUNK + (kk % PER) * 32, 16, 8 * Cf::SW, Cf::SW);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, Cfg<HD>::MIN_BLOCKS)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                   int H, int KV, int GP, int causal, int window, int q_offset, float scale) {
    using Cf = Cfg<HD>;
    using repro::NEG_INF;
    extern __shared__ uint8_t smem_raw[];
    constexpr int STAGES = Cf::STAGES;
    __shared__ __align__(8) uint64_t bar_q, bar_kv[STAGES];
    uint8_t* Qs = align1024(smem_raw);
    auto Ks = [&](int s) { return Qs + Cf::TILE * (1 + 2 * s); };
    auto Vs = [&](int s) { return Qs + Cf::TILE * (2 + 2 * s); };

    const int G = H / KV, groups = G / GP, qrows = BQ / GP;
    const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest (causal: last) position tiles first
    const int kvh = blockIdx.y / groups, h0 = kvh * G + (blockIdx.y % groups) * GP, b = blockIdx.z;
    const int q0 = qt * qrows;
    const int tid = threadIdx.x;

    // key range any row of this block can see, from whole tiles
    const int q_first = q_offset + q0, q_last = q_offset + min(q0 + qrows, Sq) - 1;
    const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
    int k_lo = window > 0 ? max(0, q_first - window + 1) : 0;
    k_lo = (k_lo / BKV) * BKV;
    const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BKV - 1) / BKV : 0;

    auto load_kv = [&](int j) {
        const int s = j % STAGES, k0 = k_lo + j * BKV;
        mbar_arrive_expect_tx(&bar_kv[s], 2 * Cf::TILE);
#pragma unroll
        for (int c = 0; c < Cf::NCH; ++c) {
            tma_load_4d(Ks(s) + c * Cf::CHUNK, &map_k, &bar_kv[s], c * Cf::CH, kvh, k0, b);
            tma_load_4d(Vs(s) + c * Cf::CHUNK, &map_v, &bar_kv[s], c * Cf::CH, kvh, k0, b);
        }
    };
    if (tid == 0) {
        mbar_init(&bar_q, 1);
        for (int s = 0; s < STAGES; ++s) mbar_init(&bar_kv[s], 1);
        fence_barrier_init();
        mbar_arrive_expect_tx(&bar_q, Cf::TILE);
#pragma unroll
        for (int c = 0; c < Cf::NCH; ++c) tma_load_4d(Qs + c * Cf::CHUNK, &map_q, &bar_q, c * Cf::CH, h0, q0, b);
        for (int j = 0; j < min(STAGES, n_tiles); ++j) load_kv(j);
    }
    __syncthreads();  // the barriers are initialized

    // q scaled in fp32 and rounded back to bf16, in place (elementwise: the swizzle does not matter)
    mbar_wait(&bar_q, 0);
    for (int i = tid; i < Cf::TILE / 16; i += THREADS) {
        uint4 v = reinterpret_cast<uint4*>(Qs)[i];
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            float2 f = __bfloat1622float2(e[u]);
            e[u] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
        reinterpret_cast<uint4*>(Qs)[i] = v;
    }
    fence_proxy_async();  // the generic writes above, before wgmma reads Q through the async proxy
    __syncthreads();

    const int lane = tid % 32, quad = lane % 4;
    const int row0 = (tid / 32) * 16 + lane / 4;  // this thread's rows: row0 and row0 + 8
    int q_pos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) q_pos[i] = q_offset + q0 + (row0 + 8 * i) / GP;

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    const uint32_t q_tile = smem_u32(Qs);

    for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES, k0 = k_lo + j * BKV;
        mbar_wait(&bar_kv[s], (j / STAGES) & 1);

        // S = (q * scale) K^T, fp32 in registers
        float sc[BKV / 2];
        const uint32_t k_tile = smem_u32(Ks(s));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
            WgmmaSS<BKV, 0, 0>::mma(sc, kmajor_desc<HD>(q_tile, kk), kmajor_desc<HD>(k_tile, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(sc);

        // the mask, where some position of the tile is out of range or masked for some row
        const bool mask = k0 + BKV > Skv || (causal && k0 + BKV - 1 > q_first) || (window > 0 && q_last - k0 >= window);
        if (mask)
            softmax_tile<true, HD>(sc, o, m, l, q_pos, k0, Skv, causal, window, quad);
        else
            softmax_tile<false, HD>(sc, o, m, l, q_pos, k0, Skv, causal, window, quad);

        // O += round_bf16(P) V: P's k16 chunk kc is S's column blocks 2kc and 2kc + 1
        const uint32_t v_tile = smem_u32(Vs(s));
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BKV / 16; ++kc) {
            const uint32_t a[4] = {pack_bf16(sc[8 * kc], sc[8 * kc + 1]), pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]),
                                   pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]),
                                   pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7])};
            WgmmaRS<HD, 1>::mma(o, a, make_desc(v_tile + kc * 16 * Cf::SW, Cf::CHUNK, 8 * Cf::SW, Cf::SW));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(o);

        if (j + STAGES < n_tiles) {  // stage s is consumed by the whole warpgroup: refill it
            __syncthreads();
            if (tid == 0) load_kv(j + STAGES);
        }
    }

    // out = acc / max(l, 1e-30), rounded once
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = row0 + 8 * i, qi = q0 + r / GP;
        if (qi >= Sq) continue;
        const float l_safe = fmaxf(l[i], 1e-30f);
        __nv_bfloat16* dst = out + (((size_t)b * Sq + qi) * H + h0 + r % GP) * HD + 2 * quad;
#pragma unroll
        for (int t = 0; t < HD / 8; ++t)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * t) =
                __floats2bfloat162_rn(o[4 * t + 2 * i] / l_safe, o[4 * t + 2 * i + 1] / l_safe);
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv, int H, int KV,
           int causal, int window, int q_offset, float scale, cudaStream_t stream) {
    using Cf = Cfg<HD>;
    const int G = H / KV;
    const int GP = (G & -G) > BQ ? BQ : (G & -G);  // the largest power of two dividing G, at most 64
    const int qrows = BQ / GP;
    CUtensorMap map_q, map_k, map_v;
    const cuuint64_t q_dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)Sq, (cuuint64_t)B};
    const cuuint64_t q_strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)H * HD * 2, (cuuint64_t)Sq * H * HD * 2};
    const cuuint32_t q_box[4] = {(cuuint32_t)Cf::CH, (cuuint32_t)GP, (cuuint32_t)qrows, 1};
    cudaError_t e = encode_bf16_map(&map_q, q, 4, q_dims, q_strides, q_box, Cf::SW);
    if (e != cudaSuccess) return e;
    const cuuint64_t kv_dims[4] = {(cuuint64_t)HD, (cuuint64_t)KV, (cuuint64_t)Skv, (cuuint64_t)B};
    const cuuint64_t kv_strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)KV * HD * 2, (cuuint64_t)Skv * KV * HD * 2};
    const cuuint32_t kv_box[4] = {(cuuint32_t)Cf::CH, 1, (cuuint32_t)BKV, 1};
    if ((e = encode_bf16_map(&map_k, k, 4, kv_dims, kv_strides, kv_box, Cf::SW)) != cudaSuccess) return e;
    if ((e = encode_bf16_map(&map_v, v, 4, kv_dims, kv_strides, kv_box, Cf::SW)) != cudaSuccess) return e;
    auto kernel = flash_wgmma_kernel<HD>;
    if ((e = repro::allow_smem(kernel, Cf::SMEM)) != cudaSuccess) return e;
    dim3 grid((Sq + qrows - 1) / qrows, KV * (G / GP), B);
    kernel<<<grid, THREADS, Cf::SMEM, stream>>>(map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), Sq, Skv, H,
                                                KV, GP, causal, window, q_offset, scale);
    return cudaGetLastError();
}

}  // namespace bf16_wgmma

namespace {

// f(std::integral_constant<int, hd>) for the head dims the kernels are built for
template <typename F>
int with_head_dim(int hd, F f) {
    switch (hd) {
        case 16: return f(std::integral_constant<int, 16>{});
        case 32: return f(std::integral_constant<int, 32>{});
        case 64: return f(std::integral_constant<int, 64>{});
        case 128: return f(std::integral_constant<int, 128>{});
        case 256: return f(std::integral_constant<int, 256>{});
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// head dims (hd == vd) 16, 32, 64, 128 or 256; window <= 0 means none
REPRO_EXPORT int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
                                      int H, int KV, int hd, int causal, int window, int q_offset, float scale,
                                      void* stream) {
    if (B <= 0 || Sq <= 0) return cudaSuccess;
    auto s = static_cast<cudaStream_t>(stream);
    if (Skv <= 0)  // no key: every row is the zero of acc / max(l, 1e-30)
        return cudaMemsetAsync(out, 0, (size_t)B * Sq * H * hd * sizeof(__nv_bfloat16), s);
    return with_head_dim(hd, [&](auto HD) {
        return bf16_wgmma::launch<decltype(HD)::value>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, q_offset,
                                                       scale, s);
    });
}

REPRO_EXPORT int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
                                     int H, int KV, int hd, int causal, int window, int q_offset, float scale,
                                     void* stream) {
    return with_head_dim(hd, [&](auto HD) {
        return fp32_fma::launch<float, decltype(HD)::value>(q, k, v, out, B, Sq, Skv, H, KV, causal, window,
                                                            q_offset, scale, stream);
    });
}
