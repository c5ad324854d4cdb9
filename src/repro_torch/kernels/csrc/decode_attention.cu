// decode_attention: one-token GQA attention over a flat KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention_pallas
// (kernel decode_attention_kernel, pallas_call at :118), with its contract:
// q (B,1,H,hd), k_cache (B,S,KV,hd), v_cache (B,S,KV,vd), a strict (B,S)
// valid mask -> (B,1,H,vd) in q's dtype.  The kernels and their numerics
// are in decode_attention.cuh, shared with the paged kernel; this file
// gives them the flat layout.
//
// What bounds it on the H100: the bytes of the cache — every K and V
// element is read once, and the arithmetic is ~1 FLOP per byte.  At the
// main path's decode (B=4, S=288, KV=8, hd=64, bf16) that is 2.4 MB, under
// 1 us at 3.35 TB/s.  Where the TPU walked S sequentially in one program,
// here S is split in 64-position splits (flash-decoding): at the main
// path's shape 160 blocks instead of 32.  The wrapper checks the 16-byte
// alignment and head dims (multiples of 16 bytes) the vector loads need.
#include "decode_attention.cuh"

namespace {

constexpr int SPLIT = 64;  // cache positions per block (a multiple of decode::TS)

// Flat cache: position pos of row b is row (b * S + pos) * KV + kvh; the mask says what is valid.
struct FlatRows {
    const uint8_t* __restrict__ valid;
    int S, KV;
    __device__ __forceinline__ size_t row(int b, int kvh, int pos) const {
        return ((size_t)b * S + pos) * KV + kvh;
    }
    __device__ __forceinline__ bool live(int b, int pos) const { return valid[(size_t)b * S + pos] != 0; }
    __device__ __forceinline__ bool empty(int, int) const { return false; }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* ws, void* out, int B, int S, int KV,
           int G, int hd, int vd, float scale, void* stream) {
    FlatRows rows{static_cast<const uint8_t*>(valid), S, KV};
    return repro::decode::launch<T>(q, k, v, rows, ws, out, B, S, SPLIT, KV, G, hd, vd, scale, stream);
}

}  // namespace

// fp32 workspace (per-split m, l, acc) one call needs
REPRO_EXPORT long long decode_attention_workspace_bytes(int B, int S, int KV, int G, int vd) {
    return (long long)(sizeof(float) * repro::decode::ws_floats(B, repro::decode::n_splits(S, SPLIT), KV, G, vd));
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
