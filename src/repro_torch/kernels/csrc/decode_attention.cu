// decode_attention: one-token GQA attention over a flat KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention_pallas
// (kernel decode_attention_kernel, pallas_call at :118), with its contract:
// q (B,1,H,hd), k_cache (B,S,KV,hd), v_cache (B,S,KV,vd), a strict (B,S)
// valid mask -> (B,1,H,vd) in q's dtype, and where `lse` is not null each
// head's fp32 log-sum-exp (B,H) beside it.  The kernel and its numerics are in
// decode_attention.cuh, shared with the paged kernel; this file gives it the
// flat layout.
//
// What bounds it on the H100: the bytes of the live K/V rows, each read
// once (~1 FLOP a byte).  At the static path's decode (B=4, S=288, KV=8,
// hd=64, bf16, 257 positions valid) that is 2.1 MB, under 1 us at 3.35 TB/s,
// so a call's time is its launch and its chain of dependent reads.  Where
// the TPU walked S sequentially in one program, here one launch spreads S
// over a cluster of blocks (kernels/decode_attention.py::decode_plan; at
// S=288: 5 blocks of 4 warps, one 16-position tile a warp) and combines
// the splits through distributed shared memory.  Each warp reads its tile's
// 16 mask bytes first (one byte a lane, one ballot) and skips the K/V
// copies and products of a tile with no valid position: a prefix mask of
// 257 of 288 reads 272 rows, a ragged one only the tiles it touches.  The
// wrapper checks the 16-byte alignment and head dims (multiples of 16
// bytes) the copies need.
#include "decode_attention.cuh"

namespace {

// Flat cache: position pos of row b is row (b * S + pos) * KV + kvh; the mask says what is valid.
struct FlatRows {
    const uint8_t* __restrict__ valid;
    int S, KV;
    __device__ __forceinline__ long long row(int b, int kvh, int pos) const {
        return ((long long)b * S + pos) * KV + kvh;
    }
    __device__ __forceinline__ bool live(int b, int pos) const { return valid[(size_t)b * S + pos] != 0; }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, void* lse, int B, int S, int KV,
           int G, int hd, int vd, float scale, int clusters, int warps, int stages, void* stream) {
    FlatRows rows{static_cast<const uint8_t*>(valid), S, KV};
    return repro::decode::launch<T>(q, k, v, rows, out, lse, B, S, KV, G, hd, vd, scale, clusters, warps, stages,
                                    stream);
}

}  // namespace

REPRO_EXPORT int decode_attention_bf16(const void* q, const void* k, const void* v, const void* valid, void* out,
                                       void* lse, int B, int S, int KV, int G, int hd, int vd, float scale,
                                       int clusters, int warps, int stages, void* stream) {
    return launch<__nv_bfloat16>(q, k, v, valid, out, lse, B, S, KV, G, hd, vd, scale, clusters, warps, stages,
                                 stream);
}

REPRO_EXPORT int decode_attention_f32(const void* q, const void* k, const void* v, const void* valid, void* out,
                                      void* lse, int B, int S, int KV, int G, int hd, int vd, float scale, int clusters,
                                      int warps, int stages, void* stream) {
    return launch<float>(q, k, v, valid, out, lse, B, S, KV, G, hd, vd, scale, clusters, warps, stages, stream);
}
