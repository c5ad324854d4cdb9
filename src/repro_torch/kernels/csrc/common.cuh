// Shared helpers for the port's hand-written CUDA kernels.
//
// Every kernel library is built by nvcc into its own shared object with a
// plain C interface (loaded with ctypes).  Each C entry point launches on
// the stream it is given, allocates nothing, and returns cudaGetLastError()
// so that a refused launch surfaces in the Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr float NEG_INF = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// Round an fp32 value through T and back (the reference's `.astype(T)`).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32<T>(from_f32<T>(v)); }

// Copy a tile of `rows` rows x `cols` elements (row r at src + r * src_stride)
// into fp32 shared memory dst[r * dst_ld + c]; rows >= valid_rows read as 0.
// 16-byte vector loads, eight per thread issued before any of them is
// stored, so a thread waits out one load latency per eight chunks instead
// of one per element.  Needs cols and src_stride to be multiples of
// 16 / sizeof(T) and src 16-byte aligned (the Python wrappers check).  With
// SCALE, each value is scaled in fp32 and rounded back through T (the
// reference's `(q.astype(f32) * scale).astype(T)`).
template <typename T, bool SCALE = false>
__device__ __forceinline__ void load_rows_f32(float* dst, int dst_ld, const T* __restrict__ src, size_t src_stride,
                                              int rows, int valid_rows, int cols, float scale = 1.f) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int BATCH = 8;
    const int per_row = cols / VEC, total = rows * per_row;
    for (int base = threadIdx.x; base < total; base += BATCH * blockDim.x) {
        uint4 buf[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
            int i = base + j * blockDim.x;
            int r = i / per_row, c = (i % per_row) * VEC;
            buf[j] = (i < total && r < valid_rows) ? __ldg(reinterpret_cast<const uint4*>(src + r * src_stride + c))
                                                   : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
            int i = base + j * blockDim.x;
            if (i < total) {
                int r = i / per_row, c = (i % per_row) * VEC;
                const T* e = reinterpret_cast<const T*>(&buf[j]);
#pragma unroll
                for (int u = 0; u < VEC; ++u) {
                    float x = to_f32<T>(e[u]);
                    dst[r * dst_ld + c + u] = SCALE ? round_to<T>(x * scale) : x;
                }
            }
        }
    }
}

// Raise a kernel's dynamic shared-memory ceiling when it needs more than
// the 48 KB default.  Returns the CUDA error, if any.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace repro

REPRO_EXPORT const char* repro_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The library links its own (static) CUDA runtime, whose current device is
// its own: the wrappers set it to the tensors' device before each launch.
REPRO_EXPORT int repro_set_device(int device) { return cudaSetDevice(device); }
