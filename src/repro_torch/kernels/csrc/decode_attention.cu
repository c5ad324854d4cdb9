// decode_attention: one-token GQA attention over a flat KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention_pallas
// (kernel decode_attention_kernel, pallas_call at :118), with its contract:
// q (B,1,H,hd), k_cache (B,S,KV,hd), v_cache (B,S,KV,vd), a strict (B,S)
// valid mask -> (B,1,H,vd) in q's dtype.  q is scaled in fp32 and rounded
// to the cache dtype; scores accumulate in fp32; the softmax is online in
// fp32; p is rounded to V's dtype before PV; p is re-masked after the exp,
// so a fully-masked row keeps l = 0 and flushes to zeros, never NaN.
//
// What bounds it on the H100: the bytes of the cache — every K and V
// element is read once, and the arithmetic is ~1 FLOP per byte.  At the
// main path's decode (B=4, S=288, KV=8, hd=64, bf16) that is 2.4 MB, under
// 1 us at 3.35 TB/s.  The design follows the TPU kernel's GQA tiling: a
// block computes all G = H/KV query heads that share one KV head, so each
// K/V tile is read from memory once, not G times.  Where the TPU walked S
// sequentially in one program, here S is split (flash-decoding): one block
// per (KV head, batch row, 64-position split) runs the online softmax over
// its split in 32-position tiles and writes its unnormalized (m, l, acc);
// a second pass combines the splits (rescaling each by exp(m_i - m)) and
// normalizes.  At the main path's shape that is 160 blocks instead of 32.
// K/V tiles come in through 16-byte loads issued in batches
// (common.cuh::load_rows_f32): with ~1 block per SM there are too few
// warps to hide load latency one element at a time.  The wrapper checks
// the 16-byte alignment and head dims (multiples of 16 bytes) this needs.
#include "common.cuh"

namespace {

constexpr int TS = 32;        // cache positions per tile
constexpr int SPLIT = 64;     // cache positions per block (a multiple of TS)
constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;

int n_splits(int S) { return (S + SPLIT - 1) / SPLIT; }

// per (batch row, KV head, split): m[G], l[G], acc[G][vd]
size_t ws_floats(int B, int S, int KV, int G, int vd) { return (size_t)B * KV * n_splits(S) * G * (vd + 2); }

size_t smem_bytes(int G, int hd, int vd) {
    return sizeof(float) * ((size_t)G * hd + (size_t)G * TS + (size_t)G * vd + 3 * (size_t)G + TS +
                            (size_t)TS * (hd + 1) + (size_t)TS * (vd + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const uint8_t* __restrict__ valid, float* __restrict__ ws, int S, int KV, int G, int hd,
                      int vd, float scale) {
    extern __shared__ float smem[];
    float* qs = smem;                // [G][hd] scaled q, rounded to T
    float* sc = qs + G * hd;         // [G][TS] scores, then rounded p
    float* acc = sc + G * TS;        // [G][vd]
    float* m = acc + G * vd;         // [G]
    float* l = m + G;                // [G]
    float* corr = l + G;             // [G]
    float* live = corr + G;          // [TS]
    float* Ks = live + TS;           // [TS][hd+1]
    float* Vs = Ks + TS * (hd + 1);  // [TS][vd+1]

    using repro::NEG_INF;
    const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
    const int s_begin = split * SPLIT, s_end = min(S, s_begin + SPLIT);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int H = KV * G;
    const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * hd;

    for (int i = tid; i < G * hd; i += THREADS)
        qs[i] = repro::round_to<T>(repro::to_f32<T>(qb[i]) * scale);
    for (int i = tid; i < G * vd; i += THREADS) acc[i] = 0.f;
    for (int g = tid; g < G; g += THREADS) {
        m[g] = NEG_INF;
        l[g] = 0.f;
    }

    for (int s0 = s_begin; s0 < s_end; s0 += TS) {
        __syncthreads();  // previous tile fully consumed; init visible
        const size_t row0 = ((size_t)b * S + s0) * KV + kvh;
        repro::load_rows_f32<T>(Ks, hd + 1, k + row0 * hd, (size_t)KV * hd, TS, s_end - s0, hd);
        repro::load_rows_f32<T>(Vs, vd + 1, v + row0 * vd, (size_t)KV * vd, TS, s_end - s0, vd);
        for (int t = tid; t < TS; t += THREADS) {
            int pos = s0 + t;
            live[t] = (pos < s_end && valid[(size_t)b * S + pos]) ? 1.f : 0.f;
        }
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
                sc[g * TS + t] = repro::round_to<T>(p);
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
    const int nsplit = gridDim.z;
    float* w = ws + (((size_t)b * KV + kvh) * nsplit + split) * G * (vd + 2);
    for (int g = tid; g < G; g += THREADS) {
        w[g] = m[g];
        w[G + g] = l[g];
    }
    for (int i = tid; i < G * vd; i += THREADS) w[2 * G + i] = acc[i];
}

// out = sum_i acc_i exp(m_i - m) / max(sum_i l_i exp(m_i - m), 1e-30), m = max_i m_i
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int KV, int G, int vd, int nsplit) {
    const int kvh = blockIdx.x, b = blockIdx.y;
    const int H = KV * G;
    const size_t stride = (size_t)G * (vd + 2);
    const float* w = ws + ((size_t)b * KV + kvh) * nsplit * stride;
    T* ob = out + ((size_t)b * H + (size_t)kvh * G) * vd;
    for (int i = threadIdx.x; i < G * vd; i += THREADS) {
        int g = i / vd;
        float m = repro::NEG_INF;
        for (int s = 0; s < nsplit; ++s) m = fmaxf(m, w[s * stride + g]);
        float l = 0.f, a = 0.f;
        for (int s = 0; s < nsplit; ++s) {
            float c = expf(w[s * stride + g] - m);
            l = fmaf(w[s * stride + G + g], c, l);
            a = fmaf(w[s * stride + 2 * G + i], c, a);
        }
        ob[i] = repro::from_f32<T>(a / fmaxf(l, 1e-30f));
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* ws, void* out, int B, int S, int KV,
           int G, int hd, int vd, float scale, void* stream) {
    if (B <= 0 || S <= 0) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    size_t bytes = smem_bytes(G, hd, vd);
    cudaError_t e = repro::allow_smem(decode_partial_kernel<T>, bytes);
    if (e != cudaSuccess) return e;
    const int nsplit = n_splits(S);
    decode_partial_kernel<T><<<dim3(KV, B, nsplit), THREADS, bytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(valid), static_cast<float*>(ws), S, KV, G, hd, vd, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    decode_combine_kernel<T><<<dim3(KV, B), THREADS, 0, s>>>(static_cast<const float*>(ws), static_cast<T*>(out),
                                                             KV, G, vd, nsplit);
    return cudaGetLastError();
}

}  // namespace

// fp32 workspace (per-split m, l, acc) one call needs
REPRO_EXPORT long long decode_attention_workspace_bytes(int B, int S, int KV, int G, int vd) {
    return (long long)(sizeof(float) * ws_floats(B, S, KV, G, vd));
}

REPRO_EXPORT int decode_attention_bf16(const void* q, const void* k, const void* v, const void* valid, void* ws,
                                       void* out, int B, int S, int KV, int G, int hd, int vd, float scale,
                                       void* stream) {
    return launch<__nv_bfloat16>(q, k, v, valid, ws, out, B, S, KV, G, hd, vd, scale, stream);
}

REPRO_EXPORT int decode_attention_f32(const void* q, const void* k, const void* v, const void* valid, void* ws,
                                      void* out, int B, int S, int KV, int G, int hd, int vd, float scale,
                                      void* stream) {
    return launch<float>(q, k, v, valid, ws, out, B, S, KV, G, hd, vd, scale, stream);
}
