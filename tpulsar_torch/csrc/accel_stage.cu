// The hi stage's harmonic sums, z maxima and block maxima for Hopper
// (sm_90a), read straight from the correlation's power pieces.
//
// This kernel replaces no Pallas kernel.  In the JAX package the
// harmonic-stage sums, the z maxima and the block maxima of the hi
// stage (tpulsar/kernels/accel.py::_harmonic_stage_maxes and the
// reduction half of tpulsar/kernels/fourier.py::blockmax_topk) are
// XLA, and the port ran them as plain PyTorch: a zeroed plane, the
// pieces copied into it, then per stage a float32 copy of the
// accumulator, per harmonic a gather of z rows and a full-size add,
// then amax and argmax.  This kernel is the card's counterpart of the
// host consumer tpulsar_torch/native/accel_host.cpp: the same stage
// maxima and block maxima from the same pieces, bit for bit.
//
// Input: the overlap-save power pieces still split by z chunk, as
// kernels/accel.py::_corr_piece_list writes them, one buffer a chunk,
// chunk q of shape (nd, nsegs, zdim(q), two_step) in float32 or
// bfloat16, addressed through a device table of the chunks' pointers
// (every chunk holds zchunk z rows but the last, which holds the rest).
// Plane column c of DM row d and z row r is valid index v = c - width:
// slab v / two_step, offset v % two_step; the columns c < width are the
// zero pad.  No plane is assembled.
//
// Output, for every DM row and stage h of 1, 2, 4, ..., H: over the
// blocks of block_r columns of the stage's L = nr / h columns, each
// block's largest z maximum of the summed power, its column and that
// column's z index ((nd, nstages, nb1) each, nb1 the block count of
// stage 1; a block past the stage's own count holds -inf, 0, 0), and
// each stage's z index at column 0.  The top-k over the block maxima
// is torch's stable sort (kernels/fourier.py::topk_of_blocks).
//
// Arithmetic, as the torch consumer and the host consumer compute it:
//   * the summed power at (column c, z) is the float32 chain
//     ((p_1 + p_2) + p_3) + ..., one add a harmonic in ascending
//     order (a bfloat16 term widens to float32 first, exactly), where
//     p_hh is the plane at z row clip(center + hh*(z - center), 0,
//     nz-1) and column hh*c; stage h's sum is the chain after p_h;
//   * harmonic hh adds to the columns below L of the first stage that
//     uses it, so column c takes the harmonics 1 .. top(c), top(c) the
//     largest stage h with c < nr / h;
//   * z maximum with first-z-wins ties (strict >), block maximum with
//     first-column-wins ties.
// No atomics: every run gives the same bits.
//
// What bounds it on this card: bytes.  The pieces of one ds-1 row of
// the survey's default search (nz 51, 8 harmonics, 3,932,162 columns)
// are 803 MB in float32: read once, 0.24 ms at 3.35 TB/s.  The sums
// need each piece once for the fundamental and, for harmonic hh, the
// ~nz/hh + 2 distinct z rows it selects over hh / top of the width;
// since hh*4 <= 32 bytes for hh <= 8, a warp's read of harmonic hh
// touches every 32-byte sector of its span, so that is ~2.2 GB of
// sectors a row, ~0.65 ms.  The adds and compares (~20 a column and
// z) are far below the card's rate.
//
// What the design does about it: one thread a plane column walks z;
// its running sum, each stage's running (max, argmax) and the slab and
// offset of each harmonic's column live in registers, so nothing but
// the pieces is read and nothing but the block maxima is written.  Each
// block keeps the nz z rows' base pointers and slab strides in shared
// memory (more than 2048 rows opt in past the 48 KB a block has by
// default).  The fundamental's reads are coalesced; harmonic hh's lanes
// read hh elements apart from the sectors the warp touches, and the
// clamped rows, read again at every clamped z, come from L1 and L2.
// Half the columns take the fundamental alone and a quarter two
// harmonics, so a walk that read one z row at a time would keep one
// or two reads in flight a thread and wait on latency, not bandwidth:
// the walk is compiled for each top stage (as_walk<TOP>), and issues
// the reads of 8 / TOP z rows (at least one) before it sums any, so a
// thread keeps ~8 reads in flight whatever its harmonics; the pad's
// reads are issued too and discarded, so no read waits on a branch.
// A block folds its columns' maxima into block_r-column blocks with
// warp shuffles and shared memory.  The lowest columns take the most
// harmonics, and they are the lowest block indices, so the heaviest
// blocks are scheduled first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kAsThreads = 256;   // plane columns a block, one a thread
constexpr int kAsWarps = kAsThreads / 32;
constexpr int kAsMaxNz = 3072;    // z rows of the shared table (48 KB)
// dynamic shared memory above which a launch opts in past the 48 KB a
// block has by default (the static reduction arrays take the rest)
constexpr size_t kAsSmemNoOptIn = 32 * 1024;

// One element of the pieces as float32, through the read-only path; a
// bfloat16 is its 16 bits above 16 zero bits (the exact widening)
__device__ __forceinline__ float as_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float as_load(const __nv_bfloat16* p) {
    const unsigned short b =
        __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float((unsigned)b << 16);
}

__host__ __device__ constexpr int as_log2(int x) {
    return x <= 1 ? 0 : 1 + as_log2(x / 2);
}

struct AsArgs {
    const void* const* chunks;   // device table of nchunks pointers
    int nchunks, zchunk, nz, block_r;
    int64_t nsegs, two_step, width, nr, nb1;
    float* bmax;                 // (nd, nstages, nb1)
    int32_t* bcol;               // (nd, nstages, nb1)
    int32_t* bz;                 // (nd, nstages, nb1)
    int32_t* zarg0;              // (nd, nstages)
};

// The (value, column, z) that wins of two: the larger value, the lower
// column on a tie (first-column-wins).
__device__ __forceinline__ void as_pick(float& v, int32_t& c, int32_t& z,
                                        float ov, int32_t oc, int32_t oz) {
    if (ov > v || (ov == v && oc < c)) {
        v = ov;
        c = oc;
        z = oz;
    }
}

// The z walk of one column whose top stage is TOP: the summed power
// at every z, each stage's running (max, argmax) in best / arg.  The
// loads of U z rows (U * TOP of them, at least 8 where TOP <= 8) are
// issued before the sums use any, so that a column of few harmonics
// keeps as many reads in flight as one of many.
template <typename T, int TOP>
__device__ __forceinline__ void as_walk(const AsArgs& a,
                                        const T* const* rowbase,
                                        const int64_t* rowstride, int64_t c,
                                        float* best, int32_t* arg) {
    constexpr int U = TOP >= 8 ? 1 : 8 / TOP;
    // slab and offset of column hh*c of the plane; hh*c < nr for hh <=
    // TOP, and nr < 2^31, so 32 bits hold it.  A column of the width
    // pad reads the row's first element, every read is issued
    // unconditionally, and the pad's term is 0 (bit hh-1 of pad)
    int32_t hs[TOP], ho[TOP];
    uint32_t pad = 0;
    const uint32_t two_step = (uint32_t)a.two_step;
#pragma unroll
    for (int k = 0; k < TOP; ++k) {
        const int64_t v = (int64_t)(k + 1) * c - a.width;
        const uint32_t vv = v < 0 ? 0u : (uint32_t)v, s = vv / two_step;
        hs[k] = (int32_t)s;
        ho[k] = (int32_t)(vv - s * two_step);
        pad |= (v < 0 ? 1u : 0u) << k;
    }
    const int center = (a.nz - 1) / 2;
    for (int z0 = 0; z0 < a.nz; z0 += U) {
        float p[U][TOP];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            // past the last z row: read the last one again, unused
            const int z = z0 + u < a.nz ? z0 + u : a.nz - 1;
#pragma unroll
            for (int hh = 1; hh <= TOP; ++hh) {
                int r = center + hh * (z - center);
                r = r < 0 ? 0 : (r > a.nz - 1 ? a.nz - 1 : r);
                const float x = as_load(rowbase[r]
                                        + hs[hh - 1] * rowstride[r]
                                        + ho[hh - 1]);
                p[u][hh - 1] = (pad >> (hh - 1)) & 1u ? 0.0f : x;
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (z0 + u >= a.nz) break;
            float acc = p[u][0];
#pragma unroll
            for (int hh = 1; hh <= TOP; ++hh) {
                if (hh > 1) acc += p[u][hh - 1];
                if ((hh & (hh - 1)) == 0 && acc > best[as_log2(hh)]) {
                    best[as_log2(hh)] = acc;
                    arg[as_log2(hh)] = z0 + u;
                }
            }
        }
    }
}

// as_walk for the column's top stage, TOP .. H.
template <typename T, int TOP, int H>
__device__ __forceinline__ void as_walk_top(int top, const AsArgs& a,
                                            const T* const* rowbase,
                                            const int64_t* rowstride,
                                            int64_t c, float* best,
                                            int32_t* arg) {
    if (top == TOP) {
        as_walk<T, TOP>(a, rowbase, rowstride, c, best, arg);
    } else if constexpr (TOP < H) {
        as_walk_top<T, 2 * TOP, H>(top, a, rowbase, rowstride, c, best,
                                   arg);
    }
}

template <typename T, int H>
__global__ void __launch_bounds__(kAsThreads)
accel_stage_kernel(AsArgs a) {
    constexpr int NS = as_log2(H) + 1;
    extern __shared__ __align__(16) unsigned char as_smem[];
    const T** rowbase = reinterpret_cast<const T**>(as_smem);
    int64_t* rowstride = reinterpret_cast<int64_t*>(as_smem) + a.nz;
    __shared__ float red_v[kAsWarps][NS];
    __shared__ int32_t red_c[kAsWarps][NS];
    __shared__ int32_t red_z[kAsWarps][NS];

    const int64_t dm = blockIdx.y;
    for (int r = threadIdx.x; r < a.nz; r += kAsThreads) {
        const int q = r / a.zchunk, lz = r - q * a.zchunk;
        const int64_t zd = q == a.nchunks - 1
                               ? a.nz - (int64_t)q * a.zchunk : a.zchunk;
        rowbase[r] = static_cast<const T*>(a.chunks[q])
                     + (dm * a.nsegs * zd + lz) * a.two_step;
        rowstride[r] = zd * a.two_step;
    }
    __syncthreads();

    const int64_t c = (int64_t)blockIdx.x * kAsThreads + threadIdx.x;
    // top(c): the largest stage h with c < nr / h (0 past the plane)
    int top = 0;
#pragma unroll
    for (int h = 1; h <= H; h *= 2)
        if (c < (a.nr >> as_log2(h))) top = h;

    float best[NS];
    int32_t arg[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        best[s] = -CUDART_INF_F;
        arg[s] = 0;
    }
    if (top > 0)
        as_walk_top<T, 1, H>(top, a, rowbase, rowstride, c, best, arg);
    if (c == 0) {
#pragma unroll
        for (int s = 0; s < NS; ++s) a.zarg0[dm * NS + s] = arg[s];
    }

    // fold each stage's column maxima into block_r-column blocks: a
    // warp's 32 columns by shuffles, then block_r / 32 warps in order
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        float v = (1 << s) <= top ? best[s] : -CUDART_INF_F;
        int32_t col = (int32_t)c, zz = arg[s];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_down_sync(0xffffffffu, v, o);
            const int32_t oc = __shfl_down_sync(0xffffffffu, col, o);
            const int32_t oz = __shfl_down_sync(0xffffffffu, zz, o);
            as_pick(v, col, zz, ov, oc, oz);
        }
        if (lane == 0) {
            red_v[warp][s] = v;
            red_c[warp][s] = col;
            red_z[warp][s] = zz;
        }
    }
    __syncthreads();
    const int wpg = a.block_r / 32, groups = kAsThreads / a.block_r;
    for (int t = threadIdx.x; t < groups * NS; t += kAsThreads) {
        const int g = t / NS, s = t - g * NS, w0 = g * wpg;
        float v = red_v[w0][s];
        int32_t col = red_c[w0][s], zz = red_z[w0][s];
        for (int w = w0 + 1; w < w0 + wpg; ++w)
            if (red_v[w][s] > v) {
                v = red_v[w][s];
                col = red_c[w][s];
                zz = red_z[w][s];
            }
        const int64_t b = (int64_t)blockIdx.x * groups + g;
        if (b >= a.nb1) continue;
        const int64_t nb = ((a.nr >> s) + a.block_r - 1) / a.block_r;
        const int64_t o = (dm * NS + s) * a.nb1 + b;
        a.bmax[o] = b < nb ? v : -CUDART_INF_F;
        a.bcol[o] = b < nb ? col : 0;
        a.bz[o] = b < nb ? zz : 0;
    }
}

template <typename T, int H>
int as_launch(const AsArgs& a, int64_t nd, cudaStream_t stream) {
    const int64_t nblk = (a.nr + kAsThreads - 1) / kAsThreads;
    const size_t smem = (size_t)a.nz * (sizeof(void*) + sizeof(int64_t));
    if (smem > kAsSmemNoOptIn) {
        // the table and the static arrays pass 48 KB near kAsMaxNz
        const cudaError_t err = cudaFuncSetAttribute(
            accel_stage_kernel<T, H>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    accel_stage_kernel<T, H><<<dim3((unsigned)nblk, (unsigned)nd),
                               kAsThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T>
int as_dispatch(int top_stage, const AsArgs& a, int64_t nd,
                cudaStream_t stream) {
    switch (top_stage) {
        case 1: return as_launch<T, 1>(a, nd, stream);
        case 2: return as_launch<T, 2>(a, nd, stream);
        case 4: return as_launch<T, 4>(a, nd, stream);
        case 8: return as_launch<T, 8>(a, nd, stream);
        case 16: return as_launch<T, 16>(a, nd, stream);
        case 32: return as_launch<T, 32>(a, nd, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// The z rows the kernel takes at most (its shared table's height).
int accel_stage_max_nz(void) { return kAsMaxNz; }

// chunks: device table of nchunks pointers, chunk q (nd, nsegs,
// zdim(q), two_step) of bf16 ? __nv_bfloat16 : float, zdim(q) =
// zchunk but for the last chunk's remainder; stages 1, 2, ...,
// top_stage; bmax, bcol, bz: (nd, nstages, nb1) with nb1 =
// ceil(nr / block_r); zarg0: (nd, nstages).  Returns the launch's
// error code (cudaErrorInvalidValue for arguments it does not take).
int accel_stage_blocks(int bf16, const void* const* chunks, int nchunks,
                       int zchunk, int nz, int64_t nd, int64_t nsegs,
                       int64_t two_step, int64_t width, int64_t nr,
                       int top_stage, int block_r, float* bmax,
                       int32_t* bcol, int32_t* bz, int32_t* zarg0,
                       void* stream) {
    if (nd < 1 || nd > 65535 || nz < 1 || nz > kAsMaxNz || zchunk < 1
        || nchunks != (nz + zchunk - 1) / zchunk || nsegs < 1
        || two_step < 1 || width < 0 || nr < 1
        || nr > ((int64_t)1 << 31) - 2 * kAsThreads
        || block_r < 32 || block_r % 32 || kAsThreads % block_r)
        return (int)cudaErrorInvalidValue;
    const int64_t nb1 = (nr + block_r - 1) / block_r;
    const AsArgs a{chunks, nchunks, zchunk, nz, block_r, nsegs, two_step,
                   width, nr, nb1, bmax, bcol, bz, zarg0};
    return bf16 ? as_dispatch<__nv_bfloat16>(top_stage, a, nd,
                                             (cudaStream_t)stream)
                : as_dispatch<float>(top_stage, a, nd,
                                     (cudaStream_t)stream);
}

}  // extern "C"
