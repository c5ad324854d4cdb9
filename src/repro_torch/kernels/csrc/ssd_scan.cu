// ssd_scan: the Mamba2 SSD (state-space duality) chunked scan of one layer's prefill.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas (kernel
// ssd_scan_kernel, pallas_call at :105) and, in the port's model, the
// reference's XLA scan repro/models/ssm.py::_ssd_chunk_scan.  Inputs: x
// (B, L, nh, hd) raw, dt (B, L, nh) fp32 after softplus, B_in and C_in
// (B, L, s) in x's dtype, A (nh,) fp32 and negative.  Outputs: y (B, L, nh, hd)
// in x's dtype and the final state (B, nh, hd, s) in fp32.  All arithmetic is
// fp32.  x̄ = x * dt is formed in fp32 and, with round_xbar, rounded to x's
// dtype before use: the model rounds it (repro/models/ssm.py:148), the TPU
// kernel does not (ssd_scan.py:47); the two agree in fp32.
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
// rule (Q = min(chunk, L), halved until it divides L) falls to Q = 1.  The
// plain version (kernels/ref.py::ssd_chunk_scan_ref) keeps the reference's
// rule; the two compute the same sums and differ only in summation order
// (chunk boundaries and the order of the within-chunk cumulative sum).
//
// No carry between blocks.  On the TPU the chunk axis is a sequential grid
// axis and the (nh, hd, s) state lives in VMEM scratch across grid steps.
// Here the chunk loop runs inside the block.  Column d of the head dim is
// independent of every other (y[..., d] and state[:, d, :] read column d of
// x̄ alone), so the grid is (hd / DT, nh, B): each block owns DT columns of
// one head of one sequence, and its fp32 state slice (DT x s, 16 KB at
// DT 32, s 128) stays in shared memory for the whole scan.  The wrapper
// picks DT = 16 where DT = 32 would leave SMs idle (mamba2-130m at B = 1
// has 24 heads: 48 blocks at DT 32, 96 at DT 16).
//
// C B^T has no head axis, and each block recomputes its chunk's Q x Q
// product (Q^2 s multiply-adds, as much as the intra-chunk product at
// DT = s).  Writing it once per (sequence, chunk) to a scratch would save
// that, at the price of a second launch and a pass over device memory; the
// recompute is kept because the first kernel is held to be simple and
// right, and its cost is inside the FMA work below.
//
// What bounds it on the H100: at zamba2-1.2b's (B, L) = (1, 512) prefill
// (nh 64, hd 64, s 64) the function reads x, dt, B, C once and writes y and
// the state: ~9.6 MB, ~2.9 us at 3.35 TB/s, against ~0.3 GFLOP of chunked
// products, so bytes set the card's bound.  This kernel is bound instead by
// its own instruction issue: fp32 FMAs on operands read from shared memory,
// ~5 M per block, no tensor cores.  wgmma tiles for the three chunk products
// are later work.
#include "common.cuh"

namespace {

constexpr int Q = 64;         // the kernel's chunk length
constexpr int THREADS = 256;  // 8 warps

template <int DT>
size_t smem_bytes(int s) {
    // Bs, Cs [Q][s+1]; Xs [Q][DT+1]; Ms [Q][Q+1]; St [DT][s+1]; lc, el, wi, dts [Q]
    return sizeof(float) * ((size_t)2 * Q * (s + 1) + (size_t)Q * (DT + 1) + (size_t)Q * (Q + 1) +
                            (size_t)DT * (s + 1) + 4 * Q);
}

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ A, T* __restrict__ y,
                float* __restrict__ state_out, int L, int nh, int hd, int s, int round_xbar) {
    extern __shared__ float smem[];
    const int sp = s + 1;  // odd row pitch: a warp walking rows hits distinct banks
    float* Bs = smem;                // [Q][s+1]  B rows of the chunk
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
    for (int i = tid; i < DT * sp; i += THREADS) St[i] = 0.f;

    for (int t0 = 0; t0 < L; t0 += Q) {
        const int n = min(Q, L - t0);  // real steps of this chunk; the rest are padding
        if (tid < Q) dts[tid] = tid < n ? dt[((size_t)b * L + t0 + tid) * nh + h] : 0.f;
        for (int i = tid; i < Q * s; i += THREADS) {
            const int t = i / s, k = i % s;
            const size_t g = ((size_t)b * L + t0 + t) * s + k;
            Bs[t * sp + k] = t < n ? repro::to_f32<T>(Bm[g]) : 0.f;
            Cs[t * sp + k] = t < n ? repro::to_f32<T>(Cm[g]) : 0.f;
        }
        __syncthreads();  // dts visible; the previous chunk's state update done
        for (int i = tid; i < Q * DT; i += THREADS) {
            const int t = i / DT, d = i % DT;
            float v = 0.f;
            if (t < n) {
                v = repro::to_f32<T>(x[(((size_t)b * L + t0 + t) * nh + h) * hd + d0 + d]) * dts[t];
                if (round_xbar) v = repro::round_to<T>(v);
            }
            Xs[t * (DT + 1) + d] = v;
        }
        if (tid == 0) {  // the cumulative sum in step order
            float acc = 0.f;
            for (int t = 0; t < Q; ++t) {
                acc += dts[t] * a;
                lc[t] = acc;
            }
        }
        __syncthreads();
        if (tid < Q) {
            el[tid] = expf(lc[tid]);
            wi[tid] = expf(lc[Q - 1] - lc[tid]);
        }
        for (int i = tid; i < Q * Q; i += THREADS) {
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
        for (int i = tid; i < n * DT; i += THREADS) {
            const int t = i / DT, d = i % DT;
            float yi = 0.f;
            for (int u = 0; u <= t; ++u) yi = fmaf(Ms[t * (Q + 1) + u], Xs[u * (DT + 1) + d], yi);
            float yc = 0.f;
            for (int k = 0; k < s; ++k) yc = fmaf(Cs[t * sp + k], St[d * sp + k], yc);
            y[(((size_t)b * L + t0 + t) * nh + h) * hd + d0 + d] = repro::from_f32<T>(yi + yc * el[t]);
        }
        __syncthreads();  // y read the state this chunk started from
        const float decay = el[Q - 1];
        for (int i = tid; i < DT * s; i += THREADS) {
            const int d = i / s, k = i % s;
            float acc = 0.f;
            for (int u = 0; u < Q; ++u) acc = fmaf(Bs[u * sp + k] * wi[u], Xs[u * (DT + 1) + d], acc);
            St[d * sp + k] = St[d * sp + k] * decay + acc;
        }
        __syncthreads();  // before the next chunk overwrites Bs, Xs
    }
    for (int i = tid; i < DT * s; i += THREADS) {
        const int d = i / s, k = i % s;
        state_out[(((size_t)b * nh + h) * hd + d0 + d) * s + k] = St[d * sp + k];
    }
}

template <typename T, int DT>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A, void* y, void* state,
           int B, int L, int nh, int hd, int s, int round_xbar, void* stream) {
    auto kernel = ssd_scan_kernel<T, DT>;
    const size_t bytes = smem_bytes<DT>(s);
    cudaError_t e = repro::allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid(hd / DT, nh, B);
    kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<const float*>(A), static_cast<T*>(y), static_cast<float*>(state), L,
        nh, hd, s, round_xbar);
    return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A, void* y, void* state,
             int B, int L, int nh, int hd, int s, int round_xbar, int d_tile, void* stream) {
    if (L < 1 || s < 1 || s > 256 || hd % d_tile) return cudaErrorInvalidValue;
    switch (d_tile) {
        case 16: return launch<T, 16>(x, dt, Bm, Cm, A, y, state, B, L, nh, hd, s, round_xbar, stream);
        case 32: return launch<T, 32>(x, dt, Bm, Cm, A, y, state, B, L, nh, hd, s, round_xbar, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// d_tile (16 or 32) divides hd; 1 <= s <= 256
REPRO_EXPORT int ssd_scan_bf16(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A, void* y,
                               void* state, int B, int L, int nh, int hd, int s, int round_xbar, int d_tile,
                               void* stream) {
    return dispatch<__nv_bfloat16>(x, dt, Bm, Cm, A, y, state, B, L, nh, hd, s, round_xbar, d_tile, stream);
}

REPRO_EXPORT int ssd_scan_f32(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A, void* y,
                              void* state, int B, int L, int nh, int hd, int s, int round_xbar, int d_tile,
                              void* stream) {
    return dispatch<float>(x, dt, Bm, Cm, A, y, state, B, L, nh, hd, s, round_xbar, d_tile, stream);
}
