// flash_attention: prefill attention (causal, sliding window, q_offset, GQA).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (kernel flash_attention_kernel, pallas_call at :95) and, in the port's
// model, the reference's XLA prefill loop models/attention.py::_flash_fwd_pass
// — whose numerics it follows, because the model's parity depends on them:
// q is scaled in fp32 and rounded back to q's dtype BEFORE the dot; scores
// accumulate in fp32; the online softmax is in fp32; p = exp(s - m) is
// rounded to V's dtype before PV; the result is acc / max(l, 1e-30).  The
// mask is _mask_for's: causal (q_pos >= k_pos), window (q_pos - k_pos <
// window), with q_pos offset by q_offset.  GQA groups query heads onto
// their KV head (h / G) without repeating K/V.
//
// What bounds it on the H100: at the main path's prefill (B=4, S=256, H=32,
// KV=8, hd=64, causal) the work is ~0.27 GFLOP of QK^T and as much of PV
// against 4 MB of q/k/v/out, so the card's bound is a few microseconds
// either way; this first kernel is bound by its own instruction issue
// instead (FMA units, scores and PV read from shared memory).  Design: one
// 128-thread block per (32-query tile, head, batch row), four threads per
// query row; K/V walk 64-position tiles through shared memory (16-byte
// loads issued in batches, common.cuh::load_rows_f32; the wrapper checks
// the 16-byte alignment this needs); tiles that
// the causal or window mask empties for the whole query tile are skipped,
// which is exact (their contribution is exp(-1e30 - m) = 0, or is zeroed by
// the next correction factor).  Tensor-core tiles (wgmma) are later work.
#include "common.cuh"

namespace {

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

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv, int H, int KV, int hd,
             int causal, int window, int q_offset, float scale, void* stream) {
    switch (hd) {
        case 16: return launch<T, 16>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, q_offset, scale, stream);
        case 32: return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, q_offset, scale, stream);
        case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, q_offset, scale, stream);
        case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, q_offset, scale, stream);
        case 256: return launch<T, 256>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, q_offset, scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// head dims (hd == vd) 16, 32, 64, 128 or 256; window <= 0 means none
REPRO_EXPORT int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
                                      int H, int KV, int hd, int causal, int window, int q_offset, float scale,
                                      void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, hd, causal, window, q_offset, scale, stream);
}

REPRO_EXPORT int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
                                     int H, int KV, int hd, int causal, int window, int q_offset, float scale,
                                     void* stream) {
    return dispatch<float>(q, k, v, out, B, Sq, Skv, H, KV, hd, causal, window, q_offset, scale, stream);
}
