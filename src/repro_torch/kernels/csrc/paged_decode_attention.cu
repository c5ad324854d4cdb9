// paged_decode_attention: one-token GQA attention over a paged KV pool.
//
// Replaces the TPU kernel
// repro/kernels/decode_attention.py::paged_decode_attention_pallas
// (kernel _paged_decode_kernel, pallas_call at :211), with its contract:
// q (B,1,H,hd); pools (P,page,KV,hd|vd) whose last page is the trash page;
// block table (B,n_tbl) int32; n_valid (B,) int32 -> (B,1,H,vd) in q's
// dtype.  Logical position pos of slot b lives at
// pool[bt[b, pos / page], pos % page]; positions >= n_valid[b] are masked,
// and a slot with n_valid 0 gives zeros.  The kernel and its numerics are
// decode_attention.cuh's, shared with the flat kernel; this file gives it
// the paged layout.
//
// What bounds it on the H100: the bytes of the valid K/V rows, each read
// once (~1 FLOP a byte).  At the engine's main path (8 slots, 640 logical
// positions, page 64, KV 8, hd 64, bf16) a full pool is 10.5 MB, about 3 us
// at 3.35 TB/s, and the live rows are usually far fewer; a call's time is
// its launch and its chain of dependent reads.  Where the TPU's grid walked
// the block table one page per sequential step (scalar prefetch steering
// the DMA), here the logical positions are cut into 16-position warp tiles
// exactly as the flat kernel cuts its S = n_tbl * page (the plan is
// kernels/decode_attention.py::decode_plan of that S): before copying a
// tile, each of its first 16 lanes resolves one position's page id from the
// block table, and a tile at or past n_valid[b] is neither copied nor
// computed.  The grid is a function of the shapes alone, so a captured CUDA
// graph replays it whatever n_valid holds.  The tiles, their order and the
// arithmetic are the flat kernel's at every page size, so on the same
// logical cache the two return identical bits.
#include "decode_attention.cuh"

namespace {

struct PagedRows {
    const int* __restrict__ bt;
    const int* __restrict__ n_valid;
    int n_tbl, page, KV;
    __device__ __forceinline__ long long row(int b, int kvh, int pos) const {
        const int j = pos / page;
        return ((long long)bt[(size_t)b * n_tbl + j] * page + (pos - j * page)) * KV + kvh;
    }
    __device__ __forceinline__ bool live(int b, int pos) const { return pos < n_valid[b]; }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bt, const void* n_valid, void* out, int B,
           int n_tbl, int page, int KV, int G, int hd, int vd, float scale, int clusters, int warps, int stages,
           void* stream) {
    if (page <= 0 || n_tbl <= 0) return cudaErrorInvalidValue;
    PagedRows rows{static_cast<const int*>(bt), static_cast<const int*>(n_valid), n_tbl, page, KV};
    return repro::decode::launch<T>(q, k, v, rows, out, B, n_tbl * page, KV, G, hd, vd, scale, clusters, warps,
                                    stages, stream);
}

}  // namespace

REPRO_EXPORT int paged_decode_attention_bf16(const void* q, const void* k, const void* v, const void* bt,
                                             const void* n_valid, void* out, int B, int n_tbl, int page, int KV,
                                             int G, int hd, int vd, float scale, int clusters, int warps, int stages,
                                             void* stream) {
    return launch<__nv_bfloat16>(q, k, v, bt, n_valid, out, B, n_tbl, page, KV, G, hd, vd, scale, clusters, warps,
                                 stages, stream);
}

REPRO_EXPORT int paged_decode_attention_f32(const void* q, const void* k, const void* v, const void* bt,
                                            const void* n_valid, void* out, int B, int n_tbl, int page, int KV, int G,
                                            int hd, int vd, float scale, int clusters, int warps, int stages,
                                            void* stream) {
    return launch<float>(q, k, v, bt, n_valid, out, B, n_tbl, page, KV, G, hd, vd, scale, clusters, warps, stages,
                         stream);
}
