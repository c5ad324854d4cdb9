// One-token GQA flash-decode, shared by the flat and the paged kernel.
//
// decode_attention.cu (flat cache, strict valid mask) and
// paged_decode_attention.cu (page pool through a block table, n_valid per
// slot) instantiate the same kernel; they differ only in the ROWS policy
// that says where cache position `pos` of batch row b lives and whether it
// is attended:
//
//   struct Rows {
//     long long row(int b, int kvh, int pos);  // index of that (position, KV head) row
//     bool live(int b, int pos);               // position attended?
//   };
//
// K row `row` starts at k + row * hd and V row at v + row * vd.
//
// Numerics (the reference's, repro/kernels/decode_attention.py): q is
// scaled in fp32 and rounded to the cache dtype; scores accumulate in fp32;
// the softmax is online in fp32; p is rounded to V's dtype before PV; p is
// re-masked after the exp, so a fully-masked row keeps l = 0 and flushes
// to zeros, never NaN.  Where the caller passes an lse buffer, the cluster's
// combine also writes each head's fp32 log-sum-exp of its scores over the
// valid positions (-inf where none is): what combining the partial
// attentions of a cache split over several ranks takes.  Without it the
// output and its bits are unchanged.
//
// What bounds it on the H100: the bytes of the live K/V rows, each read once
// (~1 FLOP a byte), a few microseconds at most at the main path's shapes.
// At 0.5-3 MB a call the time is latency: the launch, then the chain of
// dependent reads (mask or block table, then K/V), then the combine of the
// splits.  The design shortens that chain:
// * One launch a call, no workspace.  The positions are cut into 16-position
//   warp tiles, dealt round-robin to the warps of a cluster of C blocks
//   (C <= 8, the portable cluster) of W warps each: tile t goes to warp
//   t mod (C W), so a prefix mask spreads evenly.  Each warp keeps its own
//   online-softmax state (m, l, acc) of the block's heads; at the end the
//   block combines its warps in warp order in shared memory, and every block
//   of the cluster combines the cluster's block partials in rank order
//   through distributed shared memory (hopper.cuh: cluster_sync,
//   cluster_addr) and writes a slice of the output.  No atomics: two
//   launches give the same bits.  The plan (C, W, ring stages) is the
//   wrapper's (kernels/decode_attention.py::decode_plan), a function of the
//   shapes and the card's SM count alone: the fewest tiles a warp such
//   that every block of the call is resident at once (a second wave costs
//   more than a warp's second tile; at zamba2's 8 x 32 groups, G = 1, that
//   is 2 blocks a cluster, not 5).  So the grid (C, KV x head chunks x
//   feature chunks, B) is fixed by the shapes, and a captured CUDA graph
//   replays it whatever the mask or n_valid hold.
// * Pipelined tiles in their own dtype.  Each warp has a ring of
//   min(2, tiles it walks) stages in shared memory; 16-byte cp.async copies
//   bring the K and V rows of tile i + 1 (the paged policy resolves its page
//   ids first) while tile i is scored, under cp.async groups (every lane of
//   the warp copies and computes, so a group wait and a warp barrier guard
//   a stage).  The first stages go out before the block stages its q, so
//   q's read overlaps theirs.  No block barrier in the main loop.
// * Tensor-core products for bf16 (mma.sync m16n8k16, fp32 accumulate): the
//   warp's 16 positions are the M side and the block's heads, G padded to
//   8, the N side.  S^T = K q^T takes K through ldmatrix, hd in steps of 16
//   (a last half step reads zeroed pad columns); O^T = V^T P^T takes V
//   through ldmatrix.trans (V read position-major, no transpose in memory)
//   and the rounded P through a 256-byte warp buffer.  fp32 stays on CUDA
//   cores (TF32 would break the fp32 tolerance): two lanes a position split
//   each dot product, and lanes split V's features for PV.
// * Masked work skipped, exactly.  Before issuing a tile's copies the warp
//   asks Rows::live of its 16 positions (one ballot); a tile with none
//   live is neither copied nor computed.  Computing it would leave
//   (m, l, acc) as they were (m unchanged, corr = exp(0) = 1, p = 0), so
//   skipping changes no bit.
// G > 8 runs in chunks of 8 heads, and vd > 256 in chunks of 256 features,
// each chunk its own cluster (they reread K); no ported model needs either.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace repro {
namespace decode {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::cp_async_wait_all;
using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma_16816;
using hopper::smem_u32;

constexpr int TP = 16;            // positions a warp tile (the mma's M)
constexpr int HN = 8;             // heads a block (the mma's N): G in chunks of 8
constexpr int VMAX = 256;         // V features a block: vd in chunks of 256
constexpr int MAX_CLUSTER = 8;    // blocks a cluster (portable)
constexpr int MAX_WARPS = 4;      // warps a block
constexpr int MAX_STAGES = 2;     // ring stages a warp
constexpr int WARP_EXTRA = 640;   // per warp: 16 row indices (8 bytes) + a [HN][TP] fp32 P buffer
constexpr size_t SMEM_MAX = 232448;

// Row strides (elements) of the shared-memory tiles.  bf16: rounded up to
// the mma's 16-deep step and padded by 16 bytes, so ldmatrix's 8 rows fall
// in distinct banks; fp32: padded by 16 bytes.
inline __host__ __device__ int tile_stride(int n, int esz) { return esz == 2 ? (n + 15) / 16 * 16 + 8 : n + 4; }

// Dynamic shared memory of one block: the warps' rings (the fp32 partials of
// the combine reuse them), the block's scaled q, and each warp's extras.
// kernels/decode_attention.py::smem_bytes mirrors it.
inline size_t smem_bytes(int warps, int stages, int hd, int vd, int esz) {
    const int vw = vd < VMAX ? vd : VMAX;
    const size_t ring = (size_t)warps * stages * TP * esz * (tile_stride(hd, esz) + tile_stride(vw, esz));
    const size_t parts = (size_t)(warps + 1) * HN * (vw + 2) * sizeof(float);
    return (ring > parts ? ring : parts) + (size_t)HN * tile_stride(hd, esz) * esz + (size_t)warps * WARP_EXTRA;
}

__device__ __forceinline__ float warp_max(float x, int from) {
    for (int o = from; o < 32; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}
__device__ __forceinline__ float warp_sum(float x, int from, int to) {
    for (int o = from; o < to; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// ---------------------------------------------------------------------------
// A warp's online softmax over its tiles
// ---------------------------------------------------------------------------
// bf16 on tensor cores.  Fragment layouts (PTX ISA, mma m16n8k16): lane =
// 4 gid + tig; C holds rows gid and gid + 8, columns 2 tig + {0, 1}.  S^T's
// rows are positions and its columns heads; O^T's rows are features (MT
// m-tiles of 16) and its columns heads, so both keep head 2 tig + e in
// column e of the lane's fragment, and the rescale needs no shuffle.
template <int MT>
struct MmaWarp {
    float m[2], l[2], acc[MT][4];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int e = 0; e < 2; ++e) m[e] = NEG_INF, l[e] = 0.f;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }

    __device__ __forceinline__ void tile(const __nv_bfloat16* Ks, const __nv_bfloat16* Vs, const __nv_bfloat16* qs,
                                         float* pbuf, unsigned live, int KS, int VS, int hd, int vdc, int) {
        const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
        // S^T = K q^T: ldmatrix x4 matrices (pos 0-7 | 8-15) x (dim 0-7 | 8-15); q^T from the scaled
        // q tile, dims 2 tig + {0, 1} (+ 8) of head gid
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        const uint32_t k_addr = smem_u32(Ks + ((lane & 7) + ((lane >> 3) & 1) * 8) * KS + (lane >> 4) * 8);
        const __nv_bfloat16* qrow = qs + gid * KS + 2 * tig;
        for (int kk = 0; kk < (hd + 15) / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, k_addr + kk * 32);
            mma_16816(s, a, *reinterpret_cast<const uint32_t*>(qrow + 16 * kk),
                      *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8));
        }
        // online softmax of head 2 tig + e over positions gid, gid + 8: the 8 lanes of one tig share it
        const bool lv0 = (live >> gid) & 1u, lv1 = (live >> (gid + 8)) & 1u;
        uint16_t* pb = reinterpret_cast<uint16_t*>(pbuf);  // [HN heads][TP positions] bf16
        float corr[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const float s0 = lv0 ? s[e] : NEG_INF, s1 = lv1 ? s[2 + e] : NEG_INF;
            const float m_new = fmaxf(m[e], warp_max(fmaxf(s0, s1), 4));
            corr[e] = expf(m[e] - m_new);
            // re-masked after the exp: exp(s - m) is 1 on an all-masked row
            const float p0 = lv0 ? expf(s0 - m_new) : 0.f, p1 = lv1 ? expf(s1 - m_new) : 0.f;
            l[e] = l[e] * corr[e] + warp_sum(p0 + p1, 4, 32);
            m[e] = m_new;
            const __nv_bfloat16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
            pb[(2 * tig + e) * TP + gid] = *reinterpret_cast<const uint16_t*>(&h0);
            pb[(2 * tig + e) * TP + gid + 8] = *reinterpret_cast<const uint16_t*>(&h1);
        }
        __syncwarp();
        // O^T = O^T corr + V^T P^T: V^T through ldmatrix.trans, matrices (feat 0-7 | 8-15) x (pos 0-7 | 8-15);
        // P^T's fragment is positions 2 tig + {0, 1} (+ 8) of head gid
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pb + gid * TP + 2 * tig);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pb + gid * TP + 8 + 2 * tig);
        const uint32_t v_addr = smem_u32(Vs + ((lane & 7) + (lane >> 4) * 8) * VS + ((lane >> 3) & 1) * 8);
        const int mtiles = (vdc + 15) / 16;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            if (mt < mtiles) {
                acc[mt][0] *= corr[0];
                acc[mt][1] *= corr[1];
                acc[mt][2] *= corr[0];
                acc[mt][3] *= corr[1];
                uint32_t a[4];
                ldmatrix_x4_trans(a, v_addr + mt * 32);
                mma_16816(acc[mt], a, b0, b1);
            }
        }
    }

    // this warp's partial: part[HN][vw] (feature rows past vdc dropped), pm[HN], pl[HN]
    __device__ __forceinline__ void store(float* part, float* pm, float* pl, int vw, int vdc) const {
        const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            const int f = 16 * mt + gid;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                if (f < vdc) part[(2 * tig + e) * vw + f] = acc[mt][e];
                if (f + 8 < vdc) part[(2 * tig + e) * vw + f + 8] = acc[mt][2 + e];
            }
        }
        if (gid == 0) {
#pragma unroll
            for (int e = 0; e < 2; ++e) pm[2 * tig + e] = m[e], pl[2 * tig + e] = l[e];
        }
    }
};

// fp32 on CUDA cores: lanes p and p + 16 split position p's dot products
// (alternate 16-byte chunks, then one shuffle), each lane then holds head g's
// state for all positions; PV splits the features over the lanes, 4 each
// per 128 (vd <= 256: two float4 a head).
struct FmaWarp {
    float m[HN], l[HN];
    float4 acc[HN][2];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int g = 0; g < HN; ++g) {
            m[g] = NEG_INF, l[g] = 0.f;
            acc[g][0] = acc[g][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }

    __device__ __forceinline__ void tile(const float* Ks, const float* Vs, const float* qs, float* pbuf, unsigned live,
                                         int KS, int VS, int hd, int vdc, int gc) {
        const int lane = threadIdx.x % 32, p = lane & 15, h = lane >> 4;
        float s[HN];
#pragma unroll
        for (int g = 0; g < HN; ++g) s[g] = 0.f;
        const float* krow = Ks + p * KS;
        for (int c = 4 * h; c < hd; c += 8) {
            const float4 kv = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
            for (int g = 0; g < HN; ++g) {
                if (g < gc) {
                    const float4 qv = *reinterpret_cast<const float4*>(qs + g * KS + c);
                    s[g] = fmaf(qv.x, kv.x, s[g]);
                    s[g] = fmaf(qv.y, kv.y, s[g]);
                    s[g] = fmaf(qv.z, kv.z, s[g]);
                    s[g] = fmaf(qv.w, kv.w, s[g]);
                }
            }
        }
        const bool lv = (live >> p) & 1u;
        float corr[HN];
#pragma unroll
        for (int g = 0; g < HN; ++g) {
            corr[g] = 1.f;
            if (g < gc) {
                float x = s[g] + __shfl_xor_sync(0xffffffffu, s[g], 16);
                x = lv ? x : NEG_INF;
                float mx = x;
                for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
                const float m_new = fmaxf(m[g], mx);
                corr[g] = expf(m[g] - m_new);
                const float pv = lv ? expf(x - m_new) : 0.f;  // re-masked after the exp
                l[g] = l[g] * corr[g] + warp_sum(pv, 1, 16);
                m[g] = m_new;
                if (h == 0) pbuf[g * TP + p] = pv;
            }
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int f = 4 * (lane + 32 * i);
            if (f < vdc) {
#pragma unroll
                for (int g = 0; g < HN; ++g) {
                    if (g < gc) {
                        acc[g][i].x *= corr[g];
                        acc[g][i].y *= corr[g];
                        acc[g][i].z *= corr[g];
                        acc[g][i].w *= corr[g];
                    }
                }
                for (int pp = 0; pp < TP; ++pp) {
                    const float4 vv = *reinterpret_cast<const float4*>(Vs + pp * VS + f);
#pragma unroll
                    for (int g = 0; g < HN; ++g) {
                        if (g < gc) {
                            const float w = pbuf[g * TP + pp];
                            acc[g][i].x = fmaf(w, vv.x, acc[g][i].x);
                            acc[g][i].y = fmaf(w, vv.y, acc[g][i].y);
                            acc[g][i].z = fmaf(w, vv.z, acc[g][i].z);
                            acc[g][i].w = fmaf(w, vv.w, acc[g][i].w);
                        }
                    }
                }
            }
        }
    }

    __device__ __forceinline__ void store(float* part, float* pm, float* pl, int vw, int vdc) const {
        const int lane = threadIdx.x % 32;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int f = 4 * (lane + 32 * i);
            if (f < vdc) {
#pragma unroll
                for (int g = 0; g < HN; ++g) *reinterpret_cast<float4*>(part + g * vw + f) = acc[g][i];
            }
        }
        if (lane == 0) {
#pragma unroll
            for (int g = 0; g < HN; ++g) pm[g] = m[g], pl[g] = l[g];
        }
    }
};

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// ---------------------------------------------------------------------------
// The kernel: grid (C, KV x head chunks x feature chunks, B), clusters (C, 1, 1),
// blockDim W warps; `stages` ring stages a warp.  VT: the V features a
// block holds in registers (bf16: 64, 128 or 256 -> MT = VT / 16 m-tiles).
// ---------------------------------------------------------------------------
template <typename T, int VT, typename Rows>
__global__ void __launch_bounds__(MAX_WARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, Rows rows,
              T* __restrict__ out, float* __restrict__ lse, int S, int KV, int G, int hd, int vd, int stages,
              float scale) {
    constexpr bool BF16 = sizeof(T) == 2;
    constexpr int ESZ = sizeof(T), VEC = 16 / ESZ;
    using Warp = typename std::conditional<BF16, MmaWarp<VT / 16>, FmaWarp>::type;
    extern __shared__ __align__(16) uint8_t smem[];

    const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int C = gridDim.x, rank = blockIdx.x, b = blockIdx.z;
    const int HC = (G + HN - 1) / HN, VC = (vd + VMAX - 1) / VMAX;
    const int vc = blockIdx.y % VC, hc = (blockIdx.y / VC) % HC, kvh = blockIdx.y / (VC * HC);
    const int g0 = hc * HN, gc = min(HN, G - g0);
    const int vw = min(vd, VMAX), v0 = vc * VMAX, vdc = min(VMAX, vd - v0);
    const int KS = tile_stride(hd, ESZ), VS = tile_stride(vw, ESZ);
    const int stage_elems = TP * (KS + VS);

    const size_t ring_bytes = (size_t)W * stages * stage_elems * ESZ;
    const size_t parts_bytes = (size_t)(W + 1) * HN * (vw + 2) * sizeof(float);
    T* ring = reinterpret_cast<T*>(smem) + (size_t)warp * stages * stage_elems;
    T* qs = reinterpret_cast<T*>(smem + (ring_bytes > parts_bytes ? ring_bytes : parts_bytes));
    uint8_t* extra = reinterpret_cast<uint8_t*>(qs + HN * KS) + warp * WARP_EXTRA;
    long long* ridx = reinterpret_cast<long long*>(extra);
    float* pbuf = reinterpret_cast<float*>(extra + TP * sizeof(long long));

    // this warp's tiles: t = u, u + C W, ... < nt
    const int nt = (S + TP - 1) / TP, NW = C * W, u = rank * W + warp;
    const int my_nt = u < nt ? (nt - 1 - u) / NW + 1 : 0;
    const int kc = hd / VEC, vcn = vdc / VEC;

    // Resolve tile i's rows and liveness, copy its live K/V rows into stage i % stages (one cp.async
    // group, empty for a dead or absent tile); returns its 16-bit live mask.
    auto issue = [&](int i) -> unsigned {
        unsigned live = 0;
        if (i < my_nt) {
            const int pos0 = (u + i * NW) * TP, pos = pos0 + lane;
            const bool in = lane < TP && pos < S;
            const long long row = in ? rows.row(b, kvh, pos) : 0;  // (the page id read beside the liveness)
            live = __ballot_sync(0xffffffffu, in && rows.live(b, pos));
            if (live) {
                if (lane < TP) ridx[lane] = row;
                __syncwarp();
                T* Ks = ring + (size_t)(i % stages) * stage_elems;
                T* Vs = Ks + TP * KS;
                for (int j = lane; j < TP * kc; j += 32) {
                    const int r = j / kc, c = j % kc;
                    const bool ok = pos0 + r < S;  // rows past the cache read as zeros
                    cp_async16(smem_u32(Ks + r * KS + c * VEC), ok ? k + ridx[r] * hd + c * VEC : k, ok ? 16 : 0);
                }
                for (int j = lane; j < TP * vcn; j += 32) {
                    const int r = j / vcn, c = j % vcn;
                    const bool ok = pos0 + r < S;
                    cp_async16(smem_u32(Vs + r * VS + c * VEC), ok ? v + ridx[r] * vd + v0 + c * VEC : v,
                               ok ? 16 : 0);
                }
                __syncwarp();  // ridx read by every lane before the next tile's rows overwrite it
            }
        }
        cp_async_commit();
        return live;
    };

    // the ring's first tiles go out before anything else: their reads overlap q's below.  Stage s
    // keeps its tile's live mask in bits [16 s, 16 s + 16) of `lives`.
    unsigned lives = 0;
    for (int s = 0; s < stages; ++s) lives |= issue(s) << (16 * s);

    // the block's q heads, scaled in fp32 and rounded to T (16-byte loads); pad heads and columns zero
    const T* qb = q + ((size_t)b * KV * G + (size_t)kvh * G + g0) * hd;
    for (int i = threadIdx.x; i < gc * kc; i += blockDim.x) {
        const int n = i / kc, c = (i % kc) * VEC;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(qb + (size_t)n * hd + c));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) qs[n * KS + c + j] = from_f32<T>(to_f32<T>(e[j]) * scale);
    }
    for (int i = threadIdx.x; i < HN * KS; i += blockDim.x) {
        if (i / KS >= gc || i % KS >= hd) qs[i] = from_f32<T>(0.f);
    }
    // bf16: the K columns past hd up to the 16-deep mma step are read as zeros (cp.async never writes them)
    if (BF16 && hd % 16) {
        for (int r = lane; r < stages * TP; r += 32) {
            T* row = ring + (size_t)(r / TP) * stage_elems + (r % TP) * KS;
            for (int c = hd; c < KS - 8; ++c) row[c] = from_f32<T>(0.f);
        }
    }
    __syncthreads();

    Warp st;
    st.init();
    for (int i = 0; i < my_nt; ++i) {
        // tile i's group is done once at most stages - 1 later groups are pending
        if (stages == 2)
            cp_async_wait<1>();
        else
            cp_async_wait<0>();
        __syncwarp();
        const int sh = 16 * (i % stages);
        const unsigned live = (lives >> sh) & 0xffffu;
        if (live) {
            const T* Ks = ring + (size_t)(i % stages) * stage_elems;
            st.tile(Ks, Ks + TP * KS, qs, pbuf, live, KS, VS, hd, vdc, gc);
        }
        __syncwarp();  // the stage and the P buffer are free
        // the stage just freed takes tile i + stages, in flight while the next ones are scored
        lives = (lives & ~(0xffffu << sh)) | issue(i + stages) << sh;
    }
    cp_async_wait_all();
    __syncthreads();  // every warp is done with the rings: the partials take their place

    float* part = reinterpret_cast<float*>(smem);  // [W][HN][vw]
    float* pm = part + W * HN * vw;                // [W][HN]
    float* pl = pm + W * HN;                       // [W][HN]
    float* bpart = pl + W * HN;                    // [HN][vw]: the block's partial
    float* bm = bpart + HN * vw;                   // [HN]
    float* bl = bm + HN;                           // [HN]
    st.store(part + warp * HN * vw, pm + warp * HN, pl + warp * HN, vw, vdc);
    __syncthreads();

    // the block's warps, in warp order
    for (int i = threadIdx.x; i < gc * vdc; i += blockDim.x) {
        const int g = i / vdc, d = i % vdc;
        float mb = NEG_INF;
        for (int w = 0; w < W; ++w) mb = fmaxf(mb, pm[w * HN + g]);
        float lb = 0.f, ab = 0.f;
        for (int w = 0; w < W; ++w) {
            const float e = expf(pm[w * HN + g] - mb);
            lb = fmaf(pl[w * HN + g], e, lb);
            ab = fmaf(part[(w * HN + g) * vw + d], e, ab);
        }
        bpart[g * vw + d] = ab;
        if (d == 0) bm[g] = mb, bl[g] = lb;
    }
    hopper::cluster_sync();  // every block partial of the cluster is in place

    // the cluster's blocks, in rank order: this block writes its slice of the gc x vdc outputs,
    // out = sum_r acc_r exp(m_r - m) / max(sum_r l_r exp(m_r - m), 1e-30), m = max_r m_r
    const int n4 = gc * (vdc / 4), per = (n4 + C - 1) / C, lo = rank * per, hi = min(n4, lo + per);
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        const int g = i / (vdc / 4), d = (i % (vdc / 4)) * 4;
        const uint32_t m_addr = smem_u32(bm + g), l_addr = smem_u32(bl + g), a_addr = smem_u32(bpart + g * vw + d);
        float mr[MAX_CLUSTER];
        float M = NEG_INF;
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r) {
            if (r < C) {
                mr[r] = hopper::ld_cluster_f32(hopper::cluster_addr(m_addr, r));
                M = fmaxf(M, mr[r]);
            }
        }
        float L = 0.f;
        float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r) {
            if (r < C) {
                const float e = expf(mr[r] - M);
                L = fmaf(hopper::ld_cluster_f32(hopper::cluster_addr(l_addr, r)), e, L);
                const float4 a = hopper::ld_cluster_f4(hopper::cluster_addr(a_addr, r));
                A.x = fmaf(a.x, e, A.x);
                A.y = fmaf(a.y, e, A.y);
                A.z = fmaf(a.z, e, A.z);
                A.w = fmaf(a.w, e, A.w);
            }
        }
        const float den = fmaxf(L, 1e-30f);
        store4<T>(out + ((size_t)b * KV * G + (size_t)kvh * G + g0 + g) * vd + v0 + d,
                  make_float4(A.x / den, A.y / den, A.z / den, A.w / den));
        // the optional lse (fp32, (B, H)): log sum_j exp(s_j) over the valid positions, -inf where none is,
        // once a head (by the thread of its first feature chunk's first 4 features)
        if (lse != nullptr && vc == 0 && d == 0)
            lse[(size_t)b * KV * G + (size_t)kvh * G + g0 + g] = L > 0.f ? M + logf(L) : __int_as_float(0xff800000);
    }
    hopper::cluster_sync();  // no block leaves while another reads its shared memory
}

// One launch on `stream`: S logical positions under the wrapper's plan (clusters, warps, stages).
template <typename T, typename Rows>
int launch(const void* q, const void* k, const void* v, Rows rows, void* out, void* lse, int B, int S, int KV, int G,
           int hd, int vd, float scale, int clusters, int warps, int stages, void* stream) {
    if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || hd <= 0 || vd <= 0) return cudaErrorInvalidValue;
    if (clusters < 1 || clusters > MAX_CLUSTER || warps < 1 || warps > MAX_WARPS || stages < 1 ||
        stages > MAX_STAGES)
        return cudaErrorInvalidValue;
    if ((hd * sizeof(T)) % 16 || (vd * sizeof(T)) % 16) return cudaErrorInvalidValue;
    const size_t bytes = smem_bytes(warps, stages, hd, vd, sizeof(T));
    const long long ny = (long long)KV * ((G + HN - 1) / HN) * ((vd + VMAX - 1) / VMAX);
    if (bytes > SMEM_MAX || ny > 65535 || B > 65535) return cudaErrorInvalidValue;
    const int vw = vd < VMAX ? vd : VMAX;
    void (*kernel)(const T*, const T*, const T*, Rows, T*, float*, int, int, int, int, int, int, float);
    if constexpr (sizeof(T) == 4)
        kernel = decode_kernel<T, VMAX, Rows>;
    else
        kernel = vw <= 64 ? decode_kernel<T, 64, Rows> : vw <= 128 ? decode_kernel<T, 128, Rows>
                                                                   : decode_kernel<T, VMAX, Rows>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(clusters, (unsigned)ny, B);
    cfg.blockDim = dim3(32 * warps);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = clusters;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), rows, static_cast<T*>(out), static_cast<float*>(lse), S, KV,
                           G, hd, vd, stages, scale);
    return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace decode
}  // namespace repro
