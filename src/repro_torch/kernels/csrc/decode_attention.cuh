// One-token GQA flash-decode, shared by the flat and the paged kernel.
//
// decode_attention.cu (flat cache, strict valid mask) and
// paged_decode_attention.cu (page pool through a block table, n_valid
// per slot) instantiate the same two kernels; they differ only in the
// ROWS policy that says where cache position `pos` of batch row b lives
// and whether it is valid:
//
//   struct Rows {
//     size_t row(int b, int kvh, int pos);  // index of that (position, KV head) row
//     bool live(int b, int pos);            // position attended?
//     bool empty(int b, int s_begin);       // no position >= s_begin is live
//   };
//
// K row `row` starts at k + row * hd and V row at v + row * vd.
//
// Numerics (the reference's, repro/kernels/decode_attention.py): q is
// scaled in fp32 and rounded to the cache dtype; scores accumulate in fp32;
// the softmax is online in fp32; p is rounded to V's dtype before PV; p is
// re-masked after the exp, so a fully-masked row keeps l = 0 and flushes
// to zeros, never NaN.
//
// Design: a block computes all G = H/KV query heads that share one KV
// head, so each K/V tile is read once, not G times (the TPU kernel's GQA
// tiling).  The sequence is split (flash-decoding): one block per
// (KV head, batch row, split) runs the online softmax over its split in
// TS-position tiles and writes its unnormalized (m, l, acc); a second pass
// combines the splits, rescaling each by exp(m_i - m), and normalizes.
// Per tile, TS threads first resolve the tile's row indices into shared
// memory (the paged policy reads the block table there: the card's form of
// the TPU's scalar prefetch), then K/V come in through 16-byte loads issued
// in batches (common.cuh::load_rows_f32_at).  A split whose first position
// is already past every live position (Rows::empty) writes the empty
// partial (m = -1e30, l = 0, acc = 0) without reading K/V: bit for bit what
// computing the fully-masked split gives, so skipping changes no result
// while the grid stays a function of the shapes alone (CUDA-graph safe).
#pragma once

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int TS = 32;        // cache positions per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;

inline int n_splits(int S, int split) { return (S + split - 1) / split; }

// per (batch row, KV head, split): m[G], l[G], acc[G][vd]
inline size_t ws_floats(int B, int nsplit, int KV, int G, int vd) {
    return (size_t)B * KV * nsplit * G * (vd + 2);
}

inline size_t smem_bytes(int G, int hd, int vd) {
    return sizeof(long long) * TS +
           sizeof(float) * ((size_t)G * hd + (size_t)G * TS + (size_t)G * vd + 3 * (size_t)G + TS +
                            (size_t)TS * (hd + 1) + (size_t)TS * (vd + 1));
}

// Row r of the current tile: base + row_idx[r] * dim (row_idx in shared memory).
template <typename T>
struct TileRows {
    const T* __restrict__ base;
    const long long* idx;
    int dim;
    __device__ __forceinline__ const T* operator()(int r) const { return base + (size_t)idx[r] * dim; }
};

template <typename T, typename Rows>
__global__ void __launch_bounds__(THREADS)
partial_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, Rows rows,
               float* __restrict__ ws, int S, int split, int KV, int G, int hd, int vd, float scale) {
    extern __shared__ long long smem_raw[];
    long long* ridx = smem_raw;                            // [TS] row index of each tile position
    float* qs = reinterpret_cast<float*>(ridx + TS);       // [G][hd] scaled q, rounded to T
    float* sc = qs + G * hd;                               // [G][TS] scores, then rounded p
    float* acc = sc + G * TS;                              // [G][vd]
    float* m = acc + G * vd;                               // [G]
    float* l = m + G;                                      // [G]
    float* corr = l + G;                                   // [G]
    float* live = corr + G;                                // [TS]
    float* Ks = live + TS;                                 // [TS][hd+1]
    float* Vs = Ks + TS * (hd + 1);                        // [TS][vd+1]

    const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
    const int s_begin = sp * split, s_end = min(S, s_begin + split);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int H = KV * G;
    float* w = ws + (((size_t)b * KV + kvh) * gridDim.z + sp) * G * (vd + 2);

    if (rows.empty(b, s_begin)) {  // the empty partial, exactly
        for (int g = tid; g < G; g += THREADS) {
            w[g] = NEG_INF;
            w[G + g] = 0.f;
        }
        for (int i = tid; i < G * vd; i += THREADS) w[2 * G + i] = 0.f;
        return;
    }

    const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * hd;
    for (int i = tid; i < G * hd; i += THREADS) qs[i] = round_to<T>(to_f32<T>(qb[i]) * scale);
    for (int i = tid; i < G * vd; i += THREADS) acc[i] = 0.f;
    for (int g = tid; g < G; g += THREADS) {
        m[g] = NEG_INF;
        l[g] = 0.f;
    }

    for (int s0 = s_begin; s0 < s_end; s0 += TS) {
        __syncthreads();  // previous tile fully consumed; init visible
        for (int t = tid; t < TS; t += THREADS) {
            int pos = s0 + t;
            bool in = pos < s_end;
            ridx[t] = in ? (long long)rows.row(b, kvh, pos) : 0;
            live[t] = (in && rows.live(b, pos)) ? 1.f : 0.f;
        }
        __syncthreads();
        load_rows_f32_at<T>(Ks, hd + 1, TileRows<T>{k, ridx, hd}, TS, s_end - s0, hd);
        load_rows_f32_at<T>(Vs, vd + 1, TileRows<T>{v, ridx, vd}, TS, s_end - s0, vd);
        __syncthreads();

        // scores: one (head, position) pair per thread
        for (int i = tid; i < G * TS; i += THREADS) {
            int g = i / TS, t = i % TS;
            float dot = 0.f;
            for (int d = 0; d < hd; ++d) dot = fmaf(qs[g * hd + d], Ks[t * (hd + 1) + d], dot);
            sc[i] = live[t] != 0.f ? dot : NEG_INF;
        }
        __syncthreads();

        // online-softmax update: one warp per query head
        for (int g = warp; g < G; g += WARPS) {
            float mx = NEG_INF;
            for (int t = lane; t < TS; t += 32) mx = fmaxf(mx, sc[g * TS + t]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            float m_prev = m[g];
            float m_new = fmaxf(m_prev, mx);
            float sum = 0.f;
            for (int t = lane; t < TS; t += 32) {
                // re-masked after the exp: exp(s - m) is 1 on an all-masked row
                float p = live[t] != 0.f ? expf(sc[g * TS + t] - m_new) : 0.f;
                sum += p;
                sc[g * TS + t] = round_to<T>(p);
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
            if (lane == 0) {
                float c = expf(m_prev - m_new);
                corr[g] = c;
                l[g] = l[g] * c + sum;
                m[g] = m_new;
            }
        }
        __syncthreads();

        // acc = acc * corr + p @ V: one (head, feature) pair per thread
        for (int i = tid; i < G * vd; i += THREADS) {
            int g = i / vd, d = i % vd;
            float a = acc[i] * corr[g];
            for (int t = 0; t < TS; ++t) a = fmaf(sc[g * TS + t], Vs[t * (vd + 1) + d], a);
            acc[i] = a;
        }
    }
    __syncthreads();
    for (int g = tid; g < G; g += THREADS) {
        w[g] = m[g];
        w[G + g] = l[g];
    }
    for (int i = tid; i < G * vd; i += THREADS) w[2 * G + i] = acc[i];
}

// out = sum_i acc_i exp(m_i - m) / max(sum_i l_i exp(m_i - m), 1e-30), m = max_i m_i
template <typename T>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int KV, int G, int vd, int nsplit) {
    const int kvh = blockIdx.x, b = blockIdx.y;
    const int H = KV * G;
    const size_t stride = (size_t)G * (vd + 2);
    const float* w = ws + ((size_t)b * KV + kvh) * nsplit * stride;
    T* ob = out + ((size_t)b * H + (size_t)kvh * G) * vd;
    for (int i = threadIdx.x; i < G * vd; i += THREADS) {
        int g = i / vd;
        float m = NEG_INF;
        for (int s = 0; s < nsplit; ++s) m = fmaxf(m, w[s * stride + g]);
        float l = 0.f, a = 0.f;
        for (int s = 0; s < nsplit; ++s) {
            float c = expf(w[s * stride + g] - m);
            l = fmaf(w[s * stride + G + g], c, l);
            a = fmaf(w[s * stride + 2 * G + i], c, a);
        }
        ob[i] = from_f32<T>(a / fmaxf(l, 1e-30f));
    }
}

// Both passes on `stream`; S logical positions in splits of `split`.
template <typename T, typename Rows>
int launch(const void* q, const void* k, const void* v, Rows rows, void* ws, void* out, int B, int S, int split,
           int KV, int G, int hd, int vd, float scale, void* stream) {
    if (B <= 0 || S <= 0 || split <= 0) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    size_t bytes = smem_bytes(G, hd, vd);
    cudaError_t e = allow_smem(partial_kernel<T, Rows>, bytes);
    if (e != cudaSuccess) return e;
    const int nsplit = n_splits(S, split);
    partial_kernel<T, Rows><<<dim3(KV, B, nsplit), THREADS, bytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), rows,
        static_cast<float*>(ws), S, split, KV, G, hd, vd, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    combine_kernel<T><<<dim3(KV, B), THREADS, 0, s>>>(static_cast<const float*>(ws), static_cast<T*>(out), KV, G,
                                                      vd, nsplit);
    return cudaGetLastError();
}

}  // namespace decode
}  // namespace repro
