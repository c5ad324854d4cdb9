// Tiled fp32 GEMM on the FMA units: C = op(A) @ B, full fp32 products (no
// TF32, whose ~3 decimal digits would break the 1e-4 fp32 tolerance).
//
// The fp32 entries of sketch_matmul.cu, lowrank_matmul.cu and
// lowrank_matmul_batched.cu run it; their bf16 entries run the wgmma GEMM
// (gemm_wgmma.cuh) and the skinny decode GEMM (lowrank_matmul.cu).
//
//   A : (M, K) row-major with row stride lda, or under TRANS_A the stored
//       (K, M) matrix whose transpose is used — W^T is read in place, never
//       materialized.
//   B : (K, N) row-major with row stride ldb.
//   C : (M, N) row-major with row stride ldc.
//
// One 128-thread block per 64x64 output tile (each thread 8x4 outputs); the
// K loop walks 32-deep slabs through shared memory.  The next slab's global
// loads are issued into registers before the current slab's products, so
// their latency overlaps the math.  Loads are 16-byte vectors when the
// operand's row stride and base allow it, and element loads otherwise;
// ragged edges are zero-filled, so any M, N, K is accepted.
//
// Batched: blockIdx.z indexes a stack of independent products (A, B and C
// each offset by its own stack stride sa / sb / sc, in elements), so one
// launch covers a whole (L, M, K) @ (L, K, N) stack; a plain GEMM is the
// stack of one (gridDim.z = 1, strides unused).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 128;

// Load 16 bytes (VEC elements) of row r starting at column c of a
// (rows x cols) row-major matrix with row stride ld; out-of-range elements
// read as zero.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ base, int ld, int rows, int cols,
                                            int r, int c, bool vec_ok) {
    constexpr int VEC = 16 / sizeof(T);
    uint4 out;
    if (vec_ok && r < rows && c + VEC <= cols) {
        out = __ldg(reinterpret_cast<const uint4*>(base + (size_t)r * ld + c));
    } else {
        __align__(16) T tmp[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i)
            tmp[i] = (r < rows && c + i < cols) ? base[(size_t)r * ld + c + i] : from_f32<T>(0.f);
        out = *reinterpret_cast<const uint4*>(tmp);
    }
    return out;
}

// ---------------------------------------------------------------------------
// fp32: FMA units, full fp32 products.
// ---------------------------------------------------------------------------
template <bool TRANS_A>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                int M, int N, int K, int lda, int ldb, int ldc, long long sa, long long sb, long long sc,
                bool a_vec, bool b_vec) {
    constexpr int VEC = 4;
    constexpr int A_ROWS = TRANS_A ? GEMM_BK : GEMM_BM;
    constexpr int A_COLS = TRANS_A ? GEMM_BM : GEMM_BK;
    constexpr int AS_LD = GEMM_BM + 4;  // As is always [k][m]
    constexpr int B_LD = GEMM_BN + 4;
    constexpr int A_CHUNKS = A_ROWS * A_COLS / VEC / GEMM_THREADS;  // 4
    constexpr int B_CHUNKS = GEMM_BK * GEMM_BN / VEC / GEMM_THREADS;  // 4
    __shared__ __align__(16) float As[GEMM_BK * AS_LD];
    __shared__ __align__(16) float Bs[GEMM_BK * B_LD];

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * GEMM_BM;
    const int n0 = blockIdx.x * GEMM_BN;
    A += blockIdx.z * sa;
    B += blockIdx.z * sb;
    C += blockIdx.z * sc;
    const int a_rows = TRANS_A ? K : M;
    const int a_cols = TRANS_A ? M : K;

    uint4 ra[A_CHUNKS], rb[B_CHUNKS];
    auto load_tiles = [&](int k0) {
#pragma unroll
        for (int i = 0; i < A_CHUNKS; ++i) {
            int idx = tid + i * GEMM_THREADS;
            int r = idx / (A_COLS / VEC), c = (idx % (A_COLS / VEC)) * VEC;
            int gr = TRANS_A ? k0 + r : m0 + r;
            int gc = TRANS_A ? m0 + c : k0 + c;
            ra[i] = load_chunk<float>(A, lda, a_rows, a_cols, gr, gc, a_vec);
        }
#pragma unroll
        for (int i = 0; i < B_CHUNKS; ++i) {
            int idx = tid + i * GEMM_THREADS;
            int r = idx / (GEMM_BN / VEC), c = (idx % (GEMM_BN / VEC)) * VEC;
            rb[i] = load_chunk<float>(B, ldb, K, N, k0 + r, n0 + c, b_vec);
        }
    };
    auto store_tiles = [&]() {
#pragma unroll
        for (int i = 0; i < A_CHUNKS; ++i) {
            int idx = tid + i * GEMM_THREADS;
            int r = idx / (A_COLS / VEC), c = (idx % (A_COLS / VEC)) * VEC;
            const float* v = reinterpret_cast<const float*>(&ra[i]);
            if (TRANS_A) {
                *reinterpret_cast<uint4*>(&As[r * AS_LD + c]) = ra[i];
            } else {
#pragma unroll
                for (int e = 0; e < VEC; ++e) As[(c + e) * AS_LD + r] = v[e];
            }
        }
#pragma unroll
        for (int i = 0; i < B_CHUNKS; ++i) {
            int idx = tid + i * GEMM_THREADS;
            int r = idx / (GEMM_BN / VEC), c = (idx % (GEMM_BN / VEC)) * VEC;
            *reinterpret_cast<uint4*>(&Bs[r * B_LD + c]) = rb[i];
        }
    };

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    const int nk = (K + GEMM_BK - 1) / GEMM_BK;
    load_tiles(0);
    for (int kt = 0; kt < nk; ++kt) {
        store_tiles();
        __syncthreads();
        if (kt + 1 < nk) load_tiles((kt + 1) * GEMM_BK);
#pragma unroll 4
        for (int kk = 0; kk < GEMM_BK; ++kk) {
            float a[8], b[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) a[i] = As[kk * AS_LD + ty + 8 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[kk * B_LD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int gm = m0 + ty + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            int gn = n0 + tx + 16 * j;
            if (gm < M && gn < N) C[(size_t)gm * ldc + gn] = acc[i][j];
        }
    }
}

// 16-byte vector loads need the base, the row stride and (for a stack) the
// stack stride all on 16-byte boundaries.
inline bool vec_ok(const void* p, int ld, int elem_bytes, long long stack_stride = 0) {
    return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && ((size_t)ld * elem_bytes) % 16 == 0 &&
           ((size_t)stack_stride * elem_bytes) % 16 == 0;
}

// C[z] = op(A[z]) @ B[z] for z < batch (the strides are ignored when batch == 1).
inline cudaError_t launch_gemm_f32(const void* A, const void* B, void* C, int M, int N, int K, int lda, int ldb,
                                   int ldc, bool trans_a, cudaStream_t stream, int batch = 1, long long sa = 0,
                                   long long sb = 0, long long sc = 0) {
    if (M <= 0 || N <= 0 || batch <= 0) return cudaSuccess;
    if (batch > 65535) return cudaErrorInvalidValue;
    dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM, batch);
    bool av = vec_ok(A, lda, 4, sa), bv = vec_ok(B, ldb, 4, sb);
    auto* a = static_cast<const float*>(A);
    auto* b = static_cast<const float*>(B);
    auto* c = static_cast<float*>(C);
    if (trans_a)
        gemm_f32_kernel<true><<<grid, GEMM_THREADS, 0, stream>>>(a, b, c, M, N, K, lda, ldb, ldc, sa, sb, sc, av, bv);
    else
        gemm_f32_kernel<false><<<grid, GEMM_THREADS, 0, stream>>>(a, b, c, M, N, K, lda, ldb, ldc, sa, sb, sc, av, bv);
    return cudaGetLastError();
}

}  // namespace repro
