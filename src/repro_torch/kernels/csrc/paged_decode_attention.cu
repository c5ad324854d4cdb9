// paged_decode_attention: one-token GQA attention over a paged KV pool.
//
// Replaces the TPU kernel
// repro/kernels/decode_attention.py::paged_decode_attention_pallas
// (kernel _paged_decode_kernel, pallas_call at :211), with its contract:
// q (B,1,H,hd); pools (P,page,KV,hd|vd) whose last page is the trash page;
// block table (B,n_tbl) int32; n_valid (B,) int32 -> (B,1,H,vd) in q's
// dtype.  Logical position pos of slot b lives at
// pool[bt[b, pos / page], pos % page]; positions >= n_valid[b] are masked,
// and a slot with n_valid 0 gives zeros.  The kernels and their numerics
// are decode_attention.cuh's, shared with the flat kernel; this file gives
// them the paged layout.
//
// What bounds it on the H100: the bytes of the valid K/V rows, each read
// once (~1 FLOP per byte).  At the engine's main path (8 slots, 640
// logical positions, page 64, KV 8, hd 64, bf16) a full pool is 10.5 MB,
// about 3 us at 3.35 TB/s, and the live rows are usually far fewer.
// Where the TPU's grid walked the block table one page per sequential
// step (scalar prefetch steering the DMA), here a block takes one split of
// `split` positions: one page when pages are >= 64 positions, else the
// fewest whole pages that make >= 64 positions.  Each tile reads its page
// ids from the block table in global memory.  The grid is
// (KV, B, ceil(n_tbl * page / split)), a function of the shapes alone, so a
// captured CUDA graph replays it whatever n_valid holds; splits wholly at or
// past n_valid[b] return the empty partial without reading K/V.  At page 64
// the splits, tiles and arithmetic are the flat kernel's, so on the same
// logical cache the two return identical bits.
#include "decode_attention.cuh"

namespace {

constexpr int MIN_SPLIT = 64;  // positions per block, rounded up to whole pages

int split_len(int page) { return page * ((MIN_SPLIT + page - 1) / page); }

struct PagedRows {
    const int* __restrict__ bt;
    const int* __restrict__ n_valid;
    int n_tbl, page, KV;
    __device__ __forceinline__ size_t row(int b, int kvh, int pos) const {
        int j = pos / page;
        return ((size_t)bt[(size_t)b * n_tbl + j] * page + (pos - j * page)) * KV + kvh;
    }
    __device__ __forceinline__ bool live(int b, int pos) const { return pos < n_valid[b]; }
    __device__ __forceinline__ bool empty(int b, int s_begin) const { return s_begin >= n_valid[b]; }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bt, const void* n_valid, void* ws, void* out,
           int B, int n_tbl, int page, int KV, int G, int hd, int vd, float scale, void* stream) {
    if (page <= 0 || n_tbl <= 0) return cudaErrorInvalidValue;
    PagedRows rows{static_cast<const int*>(bt), static_cast<const int*>(n_valid), n_tbl, page, KV};
    return repro::decode::launch<T>(q, k, v, rows, ws, out, B, n_tbl * page, split_len(page), KV, G, hd, vd, scale,
                                    stream);
}

}  // namespace

// fp32 workspace (per-split m, l, acc) one call needs
REPRO_EXPORT long long paged_decode_attention_workspace_bytes(int B, int n_tbl, int page, int KV, int G, int vd) {
    int nsplit = repro::decode::n_splits(n_tbl * page, split_len(page));
    return (long long)(sizeof(float) * repro::decode::ws_floats(B, nsplit, KV, G, vd));
}

REPRO_EXPORT int paged_decode_attention_bf16(const void* q, const void* k, const void* v, const void* bt,
                                             const void* n_valid, void* ws, void* out, int B, int n_tbl, int page,
                                             int KV, int G, int hd, int vd, float scale, void* stream) {
    return launch<__nv_bfloat16>(q, k, v, bt, n_valid, ws, out, B, n_tbl, page, KV, G, hd, vd, scale, stream);
}

REPRO_EXPORT int paged_decode_attention_f32(const void* q, const void* k, const void* v, const void* bt,
                                            const void* n_valid, void* ws, void* out, int B, int n_tbl, int page,
                                            int KV, int G, int hd, int vd, float scale, void* stream) {
    return launch<float>(q, k, v, bt, n_valid, ws, out, B, n_tbl, page, KV, G, hd, vd, scale, stream);
}
