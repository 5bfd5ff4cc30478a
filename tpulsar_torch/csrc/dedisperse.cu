// Stage-1 and stage-2 incoherent dedispersion for Hopper (sm_90a).
//
// These two kernels replace the Pallas TPU kernels of the JAX package:
//
//   dd_form_subbands_*  <- tpulsar/kernels/pallas_dd.py:_kernel_sb
//                          (via _form_subbands_block)
//   dd_dedisperse       <- tpulsar/kernels/pallas_dd.py:_kernel_roll
//                          (via _dedisperse_chunk; the `slice` variant
//                          _kernel computes the same function)
//
// Both are plain C entry points (bound with ctypes by
// tpulsar_torch/kernels/cuda_dd.py).  Each launches on the stream it is
// given, allocates nothing, and returns the launch's error code so that
// a refused launch is reported to the caller.  dd_prepare() raises every
// kernel's dynamic shared-memory limit; the wrapper calls it once per
// device, not once per launch.
//
// Staging, in both kernels: a block stages the windows of input rows
// it sums into a ring of two shared-memory stages.  One thread starts a
// TMA bulk copy (cp.async.bulk) per window, all completing on the
// stage's mbarrier, so the next stage is in flight while the current
// one is summed and no other thread spends an instruction on the copy.
// A copy starts at the 16-byte boundary at or below the window's first
// sample (the sample's offset `delta` in the stage is kept or
// recomputed from its address) and may read a few samples of a
// neighbouring row, never outside the tensor, that are never summed.
// Only where a window reaches the row's last sample (the T-1 edge
// clamp) or an end of the tensor do all threads copy it element by
// element with the clamp instead.
//
// ---------------------------------------------------------------------
// Stage 1, subband formation:
//
//   out[b, j] = sum_{r<ds} sum_{c<cps} data[b*cps + c,
//                                          min(j*ds + r + sh[b, c], T-1)]
//
// What bounds it on this card: bytes.  Each input sample is read once
// (a full PALFA Mock beam is 3.77 GB of uint8) and the output is a
// quarter of that at downsample 1, against ~1 add per input byte.  The
// first kernel of this port loaded one byte a thread per load (32 B a
// warp), each behind its own 64-bit index arithmetic and clamp, and ran
// at ~37% of the bound.  What the design does about it: a block owns
// one subband and a run of kSbTilesPerBlock time tiles of L <= 2048
// input samples (L = J*ds, J a multiple of 4).  For each tile it stages
// the cps channel windows [j0*ds + sh_c, +L) as above, so the beam is
// read in 16-byte vectors and every sample once.  The channel sum runs
// on 32-bit words of four samples: the uint8 instantiation adds bytes
// 0,2 and bytes 1,3 of each word as two packed 16-bit lanes (flushed
// every 255 channels), so two shared loads, a funnel shift and four
// integer ops serve four samples.  The downsample stays fused: at ds 1
// the four sums are stored as a float4; otherwise they go to a shared
// float buffer and the ds samples of each output are added from there.
// The uint8 beam is read as it lies in device memory (the TPU kernel
// had to widen a padded bf16 copy, because Mosaic has no u8->f32
// cast); no padded or widened copy of the beam exists.
//
// Summation order: the channels of one input sample in c order, then
// the ds samples of one output in r order.  On uint8 input every
// partial sum is an integer far below 2^24, so the result is exact in
// any order; the float32 instantiation (a beam that is not quantized)
// keeps that order from 0.0f and so equals the plain version exactly.
//
// ---------------------------------------------------------------------
// Stage 2, shift-and-sum over subbands for a chunk of DM rows:
//
//   out[d, t] = sum_{s<nsub} subb[s, min(t + shift[d, s], T-1)]
//
// What bounds it on this card: the output is ndms x T floats and the
// input nsub x T floats, with ndms*nsub adds per output sample.  Read
// once, the bytes bound it (0.63 ms for a 38-row chunk of a full-rate
// Mock pass).  A design that adds from shared memory has a floor of its
// own: one 4-byte shared load per add, at 32 such words a clock an SM,
// about 126 ms for the 1.06e12 adds of a Mock beam.  The first kernel
// of this port held 32 rows' accumulators (168 registers a thread: one
// 8-warp block per SM), staged one subband per pair of barriers with
// the loads never overlapping the adds, and cut each chunk into
// launches of at most 32 rows that each re-read the whole input; it ran
// at ~5% of the bytes bound.
//
// What the design does about it:
//   - One launch per call.  The chunk's rows are cut into the fewest
//     groups of at most kDdGroupRows rows, of equal size (38 -> 2 x 19,
//     64 -> 4 x 16, 76 -> 4 x 19); the grid is (time tiles x row
//     groups), the groups of one tile adjacent so that the input they
//     share is still in L2 for the next.  The kernel is instantiated
//     for each group size R, so the row loop is unrolled with no
//     guards; a short last group sums rows of offset 0 it never stores.
//     R x 4 accumulators fit __launch_bounds__(256, 2): 16 warps an SM.
//   - Eight subbands per barrier.  Each stage holds eight subbands'
//     segments (tile + span floats, from the group's smallest shift for
//     that subband), staged as above while the other stage is summed:
//     one barrier per eight subbands instead of two per subband.
//   - The group's shift table (rows relative to their smallest shift
//     per subband, laid out [s][row] so one 16-byte load gives four
//     rows' offsets) and the smallest shifts sit in shared memory,
//     loaded once per block.
//   - Neighbouring threads read neighbouring samples for every row, so
//     the shared loads are conflict-free.
// What remains is that floor: the kernel's time sits close to it
// (PERF.md).  Keeping a row's samples in registers for the next row of
// equal offset (common on the Mock plan) was tried and lost more to
// the branch than it saved in loads.
// Summation order (the contract with the reference's scan,
// tpulsar/kernels/dedisperse.py:_dedisperse_subbands_scan): every
// accumulator starts at 0.0f and adds the subbands one at a time in s
// order; no partial sums are combined, and the s loop is never split
// across threads or blocks, so the result is bit-identical to it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

namespace {

constexpr int kMaxSmem = 232448;      // a block's shared-memory limit

constexpr int kSbThreads = 256;       // stage 1 threads per block
constexpr int kSbWords = 2;           // stage 1 words of 4 samples a thread
constexpr int kSbTile = kSbThreads * kSbWords * 4;  // input samples a tile
constexpr int kSbBudget = 100 * 1024; // stage 1 shared bytes aimed at
constexpr int kSbTilesPerBlock = 16;  // stage 1 tiles a block walks

constexpr int kDdThreads = 256;       // stage 2 threads per block
constexpr int kDdPerThread = 4;       // stage 2 time samples per thread
constexpr int kDdTile = kDdThreads * kDdPerThread;
constexpr int kDdGroupRows = 20;      // DM rows per block, at most
constexpr int kDdSubPerStage = 8;     // subbands per stage
constexpr int kDdStages = 2;

// ---------------------------------------------- staging (both kernels)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// generic-proxy accesses to shared memory before the TMA writes after
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// Offset, in elements, of `p` past the 16-byte boundary at or below it.
template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
    return (int)(((uintptr_t)p & 15) / sizeof(T));
}

// The window of `len` samples of `row` from sample `g0` (row[min(g0+i,
// T_len-1)]): staged so that stage[delta + i] holds sample i.  It is
// one TMA bulk copy of `bytes` (whole 16-byte vectors from `src`), or,
// where those would pass the row's last sample or leave [lo, hi), the
// tensor the row lies in, an element copy with the clamp (bytes 0).
template <typename T>
struct Window {
    const T* src;
    int delta;
    uint32_t bytes;
};

template <typename T>
__device__ __forceinline__ Window<T> window(const T* row, int64_t g0,
                                            int len, int64_t T_len,
                                            const T* lo, const T* hi) {
    Window<T> w;
    w.delta = misalign(row + g0);
    w.src = row + g0 - w.delta;
    const uint32_t bytes = ((w.delta + len) * (uint32_t)sizeof(T) + 15)
                           / 16 * 16;
    const bool vec = g0 + len <= T_len && w.src >= lo
        && reinterpret_cast<const char*>(w.src) + bytes
               <= reinterpret_cast<const char*>(hi);
    w.bytes = vec ? bytes : 0;
    return w;
}

// Element copy of a window whose bytes are 0, by all threads.
template <typename T>
__device__ __forceinline__ void copy_clamped(T* dst, const T* row,
                                             int64_t g0, int delta,
                                             int len, int64_t T_len) {
    for (int p = threadIdx.x; p < delta + len; p += blockDim.x) {
        int64_t g = g0 - delta + p;
        g = g < 0 ? 0 : (g > T_len - 1 ? T_len - 1 : g);
        dst[p] = row[g];
    }
}

// Fill one stage with n windows, window i being `len` samples of
// row(i) from g0(i) into dst(i).  Thread 0 starts the bulk copies on
// `bar` (one arrival carrying their byte count); the element copies,
// only ever needed near the ends of the rows or of the tensor, are
// made by all threads, and skipped without a look at the windows when
// `fast` (the caller's proof that every window is a bulk copy).  The
// delta of window i goes to deltas[i] when deltas is not null.  All
// threads call it with the same arguments; what it staged is complete
// after mbar_wait on `bar` and a __syncthreads().
template <typename T, typename Row, typename G0, typename Dst>
__device__ __forceinline__ void fill_stage(int n, Row row, G0 g0, Dst dst,
                                           int len, int64_t T_len,
                                           const T* lo, const T* hi,
                                           bool fast, uint64_t* bar,
                                           int* deltas) {
    if (threadIdx.x == 0) {
        fence_proxy_async();
        uint32_t bytes = 0;
        for (int i = 0; i < n; ++i)
            bytes += window<T>(row(i), g0(i), len, T_len, lo, hi).bytes;
        mbar_arrive_expect(bar, bytes);
        for (int i = 0; i < n; ++i) {
            const Window<T> w = window<T>(row(i), g0(i), len, T_len, lo,
                                          hi);
            if (w.bytes) bulk_copy(dst(i), w.src, w.bytes, bar);
            if (deltas) deltas[i] = w.delta;
        }
    }
    if (!fast) {
        for (int i = 0; i < n; ++i) {
            const Window<T> w = window<T>(row(i), g0(i), len, T_len, lo,
                                          hi);
            if (!w.bytes)
                copy_clamped<T>(dst(i), row(i), g0(i), w.delta, len, T_len);
        }
    }
}

// ------------------------------------------------------------ stage 1

// Stage-1 tile geometry: outputs per tile J (a multiple of 4), input
// samples per tile L = J*ds <= kSbTile, and the shared bytes of one
// channel's window (16-byte multiple, room for the misalignment and
// the word after the last).
struct SbGeom {
    int J, L, seg_bytes, smem;
};

// two mbarriers, shifts (cps,), each stage's window misalignments (2, cps)
__host__ __device__ constexpr int sb_head_bytes(int cps) {
    return 16 + (3 * cps * 4 + 15) / 16 * 16;
}

template <typename T>
SbGeom sb_geom(int cps, int ds) {
    const int eb = (int)sizeof(T);
    int lmax = (kSbBudget / (2 * cps) - 48) / eb;
    if (lmax > kSbTile) lmax = kSbTile;
    int J = (lmax / ds) / 4 * 4;
    if (J < 4) J = 4;
    SbGeom g;
    g.J = J;
    g.L = J * ds;
    g.seg_bytes = ((g.L * eb + 15) / 16) * 16 + 32;
    g.smem = sb_head_bytes(cps) + 2 * cps * g.seg_bytes
             + (ds > 1 ? g.L * 4 : 0);
    return g;
}

template <typename T>
__global__ void __launch_bounds__(kSbThreads)
form_subbands_kernel(const T* __restrict__ data, int nchan, int64_t T_len,
                     const int* __restrict__ shifts, int cps, int ds,
                     int64_t n_out, int J, int seg_bytes, int64_t ntiles,
                     float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_sb[];
    const int L = J * ds;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem_sb);
    int* sh = reinterpret_cast<int*>(smem_sb + 16);
    int* dl = sh + cps;       // (2, cps) misalignment of each window
    unsigned char* stages = smem_sb + sb_head_bytes(cps);
    float* fbuf = reinterpret_cast<float*>(stages + 2 * cps * seg_bytes);

    const int b = blockIdx.y;
    for (int c = threadIdx.x; c < cps; c += blockDim.x)
        sh[c] = shifts[b * cps + c];
    if (threadIdx.x == 0) {
        mbar_init(&bar[0]);
        mbar_init(&bar[1]);
        mbar_init_fence();
    }
    __syncthreads();
    int shmin = sh[0], shmax = sh[0];
    for (int c = 1; c < cps; ++c) {
        shmin = min(shmin, sh[c]);
        shmax = max(shmax, sh[c]);
    }

    const T* rows = data + (int64_t)b * cps * T_len;
    const T* lo = data;
    const T* hi = data + (int64_t)nchan * T_len;
    float* orow = out + (int64_t)b * n_out;
    const int64_t first = (int64_t)blockIdx.x * kSbTilesPerBlock;
    int64_t last = first + kSbTilesPerBlock;
    if (last > ntiles) last = ntiles;

    auto fill = [&](int64_t tile, int st) {
        unsigned char* base = stages + (int64_t)st * cps * seg_bytes;
        const int64_t t0 = tile * L;
        // 16 samples clear of both ends: every window is a bulk copy
        const bool fast = t0 + shmin >= 16 && t0 + shmax + L + 16 <= T_len;
        fill_stage<T>(
            cps, [&](int c) { return rows + (int64_t)c * T_len; },
            [&](int c) { return t0 + sh[c]; },
            [&](int c) { return reinterpret_cast<T*>(base + c * seg_bytes); },
            L, T_len, lo, hi, fast, &bar[st], dl + st * cps);
    };

    fill(first, 0);
    for (int64_t tile = first; tile < last; ++tile) {
        const int i = (int)(tile - first);
        const int st = i & 1;
        mbar_wait(&bar[st], (i >> 1) & 1);
        __syncthreads();          // stage st complete; stage st^1 and fbuf free
        if (tile + 1 < last) fill(tile + 1, st ^ 1);
        const unsigned char* base = stages + (int64_t)st * cps * seg_bytes;
        const int* dls = dl + st * cps;
        const int64_t j0 = tile * J;
        int64_t jn = n_out - j0;  // outputs of this tile that exist
        if (jn > J) jn = J;

        if constexpr (sizeof(T) == 1) {
            // words w = tid + 256*i of four consecutive samples: bytes
            // 0,2 and 1,3 of each word summed as 16-bit lanes, flushed
            // every 255 channels (255 * 255 < 2^16)
            uint32_t v[kSbWords][4] = {};
            // words of this thread inside the tile (all 4 unless L is cut
            // short by a large cps; reads past them would leave the window)
            const int nw = (L / 4 - (int)threadIdx.x + kSbThreads - 1)
                           / kSbThreads;
            for (int c0 = 0; c0 < cps; c0 += 255) {
                const int c1 = min(cps, c0 + 255);
                uint32_t a02[kSbWords] = {}, a13[kSbWords] = {};
                for (int c = c0; c < c1; ++c) {
                    const int delta = dls[c];
                    const uint32_t* seg = reinterpret_cast<const uint32_t*>(
                        base + c * seg_bytes) + (delta >> 2) + threadIdx.x;
                    const int shift = 8 * (delta & 3);
#pragma unroll
                    for (int k = 0; k < kSbWords; ++k) {
                        if (k >= nw) break;
                        const uint32_t x = __funnelshift_r(
                            seg[k * kSbThreads], seg[k * kSbThreads + 1],
                            shift);
                        a02[k] += x & 0x00FF00FFu;
                        a13[k] += (x >> 8) & 0x00FF00FFu;
                    }
                }
#pragma unroll
                for (int k = 0; k < kSbWords; ++k) {
                    v[k][0] += a02[k] & 0xFFFF; v[k][2] += a02[k] >> 16;
                    v[k][1] += a13[k] & 0xFFFF; v[k][3] += a13[k] >> 16;
                }
            }
#pragma unroll
            for (int k = 0; k < kSbWords; ++k) {
                if (k >= nw) break;
                const int w = threadIdx.x + k * kSbThreads;
                const float4 f = make_float4((float)v[k][0], (float)v[k][1],
                                             (float)v[k][2], (float)v[k][3]);
                if (ds == 1) {
                    const int64_t j = j0 + 4 * w;
                    float* dst = orow + j;
                    if (j + 3 < n_out && ((uintptr_t)dst & 15) == 0) {
                        *reinterpret_cast<float4*>(dst) = f;
                    } else {
                        if (j < n_out) dst[0] = f.x;
                        if (j + 1 < n_out) dst[1] = f.y;
                        if (j + 2 < n_out) dst[2] = f.z;
                        if (j + 3 < n_out) dst[3] = f.w;
                    }
                } else {
                    reinterpret_cast<float4*>(fbuf)[w] = f;
                }
            }
        } else {
            // one sample a thread at a time, channels in c order
            for (int i = threadIdx.x; i < L; i += blockDim.x) {
                float v = 0.0f;
                for (int c = 0; c < cps; ++c)
                    v += reinterpret_cast<const float*>(
                        base + c * seg_bytes)[dls[c] + i];
                if (ds == 1) {
                    if (i < jn) orow[j0 + i] = v;
                } else {
                    fbuf[i] = v;
                }
            }
        }
        if (ds > 1) {
            __syncthreads();      // fbuf complete
            for (int jj = threadIdx.x; jj < jn; jj += blockDim.x) {
                const float* f = fbuf + jj * ds;
                float acc = f[0];
                for (int r = 1; r < ds; ++r) acc += f[r];
                orow[j0 + jj] = acc;
            }
        }
    }
}

template <typename T>
int launch_form_subbands(const T* data, int nchan, int64_t T_len,
                         const int* shifts, int nsub, int ds,
                         float* out, cudaStream_t stream) {
    const int cps = nchan / nsub;
    const int64_t n_out = T_len / ds;
    if (n_out > 0) {
        const SbGeom g = sb_geom<T>(cps, ds);
        if (g.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
        const int64_t ntiles = (n_out + g.J - 1) / g.J;
        dim3 grid((unsigned)((ntiles + kSbTilesPerBlock - 1)
                             / kSbTilesPerBlock), (unsigned)nsub);
        form_subbands_kernel<T><<<grid, kSbThreads, g.smem, stream>>>(
            data, nchan, T_len, shifts, cps, ds, n_out, g.J, g.seg_bytes,
            ntiles, out);
    }
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------ stage 2

__host__ __device__ inline int dd_seg_floats(int span) {
    // tile + span samples, plus up to 3 of misalignment, in float4s
    return ((kDdTile + span + 3) + 3) / 4 * 4;
}

// ints of one group's table: [rel (nsub, kDdGroupRows) | lo (nsub,)],
// padded to 16 bytes
__host__ __device__ inline int64_t dd_table_ints(int nsub) {
    return ((int64_t)nsub * (kDdGroupRows + 1) + 3) / 4 * 4;
}

// R: the rows of a group (a compile-time count, so the row loop has no
// guards; the last group's missing rows have offsets 0 and are summed
// but not stored).
template <int R>
__global__ void __launch_bounds__(kDdThreads, 2)
dedisperse_kernel(const float* __restrict__ subb, int nsub, int64_t T_len,
                  const int* __restrict__ tables, int ndms, int ngroups,
                  int span, float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_dd[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem_dd);
    // rel: (nsub, kDdGroupRows) shifts minus the group's smallest shift
    // for that subband; lo: (nsub,) those smallest shifts
    int* rel = reinterpret_cast<int*>(smem_dd + 16);
    const int* lo = rel + nsub * kDdGroupRows;
    const int64_t tab_ints = dd_table_ints(nsub);
    float* segs = reinterpret_cast<float*>(rel + tab_ints);
    const int seg_len = dd_seg_floats(span);
    const int len = kDdTile + span;

    const int g = blockIdx.x % ngroups;
    const int64_t t0 = (int64_t)(blockIdx.x / ngroups) * kDdTile;
    const int row0 = g * R;
    {
        const int4* src = reinterpret_cast<const int4*>(tables
                                                       + g * tab_ints);
        int4* dst = reinterpret_cast<int4*>(rel);
        for (int i = threadIdx.x; i < tab_ints / 4; i += blockDim.x)
            dst[i] = src[i];
    }
    if (threadIdx.x == 0) {
        mbar_init(&bar[0]);
        mbar_init(&bar[1]);
        mbar_init_fence();
    }
    __syncthreads();
    int lomin = lo[0], lomax = lo[0];
    for (int s = 1; s < nsub; ++s) {
        lomin = min(lomin, lo[s]);
        lomax = max(lomax, lo[s]);
    }
    // 16 samples clear of both ends: every window is a bulk copy
    const bool fast = t0 + lomin >= 16 && t0 + lomax + len + 16 <= T_len;

    const float* hi = subb + (int64_t)nsub * T_len;
    const int nchunk = (nsub + kDdSubPerStage - 1) / kDdSubPerStage;
    auto fill = [&](int ch, int st) {
        float* base = segs + (int64_t)st * kDdSubPerStage * seg_len;
        const int s0 = ch * kDdSubPerStage;
        fill_stage<float>(
            min(kDdSubPerStage, nsub - s0),
            [&](int j) { return subb + (int64_t)(s0 + j) * T_len; },
            [&](int j) { return t0 + lo[s0 + j]; },
            [&](int j) { return base + j * seg_len; },
            len, T_len, subb, hi, fast, &bar[st], nullptr);
    };

    float acc[R][kDdPerThread];
#pragma unroll
    for (int d = 0; d < R; ++d)
#pragma unroll
        for (int k = 0; k < kDdPerThread; ++k) acc[d][k] = 0.0f;

    fill(0, 0);
    for (int ch = 0; ch < nchunk; ++ch) {
        const int st = ch & 1;
        mbar_wait(&bar[st], (ch >> 1) & 1);
        __syncthreads();          // stage st complete; stage st^1 free
        if (ch + 1 < nchunk) fill(ch + 1, st ^ 1);
        const float* base = segs + (int64_t)st * kDdSubPerStage * seg_len;
        const int nj = min(kDdSubPerStage, nsub - ch * kDdSubPerStage);
        for (int j = 0; j < nj; ++j) {
            const int s = ch * kDdSubPerStage + j;
            const float* seg = base + j * seg_len + threadIdx.x
                + misalign(subb + (int64_t)s * T_len + t0 + lo[s]);
            const int4* off4 = reinterpret_cast<const int4*>(
                rel + s * kDdGroupRows);
#pragma unroll
            for (int q = 0; q < (R + 3) / 4; ++q) {
                const int4 o = off4[q];
                const int os[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    if (4 * q + e < R) {
                        const float* p = seg + os[e];
#pragma unroll
                        for (int k = 0; k < kDdPerThread; ++k)
                            acc[4 * q + e][k] += p[k * kDdThreads];
                    }
                }
            }
        }
    }

    const int nrows = min(R, ndms - row0);
#pragma unroll
    for (int d = 0; d < R; ++d) {
        if (d < nrows) {
            float* orow = out + (int64_t)(row0 + d) * T_len;
#pragma unroll
            for (int k = 0; k < kDdPerThread; ++k) {
                const int64_t t = t0 + threadIdx.x + k * kDdThreads;
                if (t < T_len) orow[t] = acc[d][k];
            }
        }
    }
}

using DdKernel = void (*)(const float*, int, int64_t, const int*, int, int,
                          int, float*);

template <std::size_t... I>
std::array<DdKernel, sizeof...(I)> dd_kernel_table(
        std::index_sequence<I...>) {
    return {{&dedisperse_kernel<(int)I + 1>...}};
}

// dedisperse_kernel<R> for R = 1 .. kDdGroupRows, at index R - 1
const std::array<DdKernel, kDdGroupRows>& dd_kernels() {
    static const auto table =
        dd_kernel_table(std::make_index_sequence<kDdGroupRows>{});
    return table;
}

}  // namespace

extern "C" {

// Raise every kernel's dynamic shared-memory limit and ask for the
// largest shared-memory carveout, on the current device (once per
// device; a launch does not repeat it).
int dd_prepare(void) {
    for (int i = 0; i < kDdGroupRows + 2; ++i) {
        const void* k =
            i < kDdGroupRows ? reinterpret_cast<const void*>(dd_kernels()[i])
            : i == kDdGroupRows
                ? reinterpret_cast<const void*>(form_subbands_kernel<uint8_t>)
                : reinterpret_cast<const void*>(form_subbands_kernel<float>);
        cudaError_t err = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                k, cudaFuncAttributePreferredSharedMemoryCarveout,
                (int)cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

int dd_form_subbands_u8(const uint8_t* data, int nchan, int64_t T_len,
                        const int* shifts, int nsub, int ds, float* out,
                        void* stream) {
    return launch_form_subbands<uint8_t>(data, nchan, T_len, shifts, nsub,
                                         ds, out, (cudaStream_t)stream);
}

int dd_form_subbands_f32(const float* data, int nchan, int64_t T_len,
                         const int* shifts, int nsub, int ds, float* out,
                         void* stream) {
    return launch_form_subbands<float>(data, nchan, T_len, shifts, nsub,
                                       ds, out, (cudaStream_t)stream);
}

// Shared memory one stage-2 launch needs for a given nsub and span
// (cuda_dd.stage2_smem_bytes computes the same and is held to this).
int64_t dd_dedisperse_smem_bytes(int nsub, int span) {
    return 16 + dd_table_ints(nsub) * (int64_t)sizeof(int)
           + (int64_t)kDdStages * kDdSubPerStage * dd_seg_floats(span)
             * (int64_t)sizeof(float);
}

int dd_group_rows(void) { return kDdGroupRows; }

// Shared memory of one stage-1 block for cps channels a subband at
// downsample ds (uint8 input when u8 is not 0, else float32).
int64_t dd_form_subbands_smem_bytes(int cps, int ds, int u8) {
    return u8 ? sb_geom<uint8_t>(cps, ds).smem : sb_geom<float>(cps, ds).smem;
}

// Blocks of a kernel that fit one SM with `smem` bytes of dynamic shared
// memory: kernel 0 is stage 2 with `rows` rows a group, 1 stage 1 on
// uint8, 2 stage 1 on float32.  Negative on a CUDA error.
int dd_blocks_per_sm(int kernel, int rows, int64_t smem) {
    if (kernel == 0 && (rows < 1 || rows > kDdGroupRows)) return -1;
    const void* k =
        kernel == 0 ? reinterpret_cast<const void*>(dd_kernels()[rows - 1])
        : kernel == 1
            ? reinterpret_cast<const void*>(form_subbands_kernel<uint8_t>)
            : reinterpret_cast<const void*>(form_subbands_kernel<float>);
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, k, kernel == 0 ? kDdThreads : kSbThreads, (size_t)smem);
    return err == cudaSuccess ? n : -(int)err;
}

// tables: (ngroups, dd_table_ints(nsub)) int32, each group's
// [rel (nsub, kDdGroupRows) | lo (nsub,) | pad]; grows rows a group
// (the last may hold fewer); out: (ndms, T_len).
int dd_dedisperse(const float* subb, int nsub, int64_t T_len,
                  const int* tables, int ndms, int ngroups, int grows,
                  int span, float* out, void* stream) {
    if (ndms < 1 || grows < 1 || grows > kDdGroupRows
        || (int64_t)ngroups * grows < ndms
        || (int64_t)(ngroups - 1) * grows >= ndms)
        return (int)cudaErrorInvalidValue;
    const int64_t smem = dd_dedisperse_smem_bytes(nsub, span);
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    if (T_len > 0) {
        const int64_t ntiles = (T_len + kDdTile - 1) / kDdTile;
        void* args[] = {&subb, &nsub, &T_len, &tables, &ndms, &ngroups,
                        &span, &out};
        return (int)cudaLaunchKernel(
            reinterpret_cast<const void*>(dd_kernels()[grows - 1]),
            dim3((unsigned)(ntiles * ngroups)), dim3(kDdThreads), args,
            (size_t)smem, (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
