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
// given, allocates nothing, and returns cudaGetLastError() so that a
// refused launch is reported to the caller.
//
// ---------------------------------------------------------------------
// Stage 1, subband formation:
//
//   out[b, j] = sum_{r<ds} sum_{c<cps} data[b*cps + c,
//                                          min(j*ds + r + sh[b, c], T-1)]
//
// What bounds it on this card: bytes.  Each input sample is read once
// (a full PALFA Mock beam is 3.77 GB of uint8) and the output is a
// quarter of that at downsample 1, against ~1 add per input byte.
// What the design does about it: the uint8 beam is read as it lies in
// device memory and widened to float in registers (the TPU kernel had
// to widen a padded bf16 copy first, because Mosaic has no u8->f32
// cast, and slabbed the sweep to bound that copy); the edge clamp is
// an index min(), so no padded copy of the beam exists either; and the
// sum-downsample is fused into the epilogue, so the full-rate subband
// block is never written.  Consecutive threads read consecutive
// samples of one channel row, so every warp load is coalesced.
//
// Summation order: for each output, the channels of one input sample
// are summed in c order, then the ds samples are summed in r order.
// On uint8 input every partial sum is an integer far below 2^24, so
// the result is exact whatever the order.
//
// ---------------------------------------------------------------------
// Stage 2, shift-and-sum over subbands for up to 32 DM rows:
//
//   out[d, t] = sum_{s<nsub} subb[s, min(t + shift[d, s], T-1)]
//
// summed in s order, exactly as the reference's scan
// (tpulsar/kernels/dedisperse.py:_dedisperse_subbands_scan) does, so
// the result is bit-identical to it.
//
// What bounds it on this card: the output is ndms x T floats and the
// input nsub x T floats, with ndms*nsub adds per output sample.  Read
// once, the bytes bound it (0.6 ms for 32 rows of a full-rate Mock
// pass), but a naive kernel re-reads the input once per DM row.  What
// the design does about it: each block owns one time tile and all the
// launch's DM rows (at most 32, one register accumulator each per
// time sample it owns).  It walks the subbands in order; for each it
// stages the row segment the rows' shifts can reach into shared
// memory once, and every DM row reads its shifted window from there.
// Within one pass the rows' shifts for a given subband span only a
// few hundred samples at most, so the staged segment starts at that
// subband's smallest shift and is the tile plus the span long: the
// input is read from device memory about once per launch instead of
// once per DM row.  The shift table sits in shared memory too.
// Shared-memory reads are conflict-free: neighbouring threads read
// neighbouring samples for every row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSbThreads = 256;     // stage 1 threads per block
constexpr int kSbPerThread = 4;     // stage 1 outputs per thread

constexpr int kDdThreads = 256;     // stage 2 threads per block
constexpr int kDdPerThread = 4;     // stage 2 time samples per thread
constexpr int kDdTile = kDdThreads * kDdPerThread;
constexpr int kDdMaxRows = 32;      // DM rows per launch

template <typename T>
__global__ void form_subbands_kernel(const T* __restrict__ data,
                                     int nchan, int64_t T_len,
                                     const int* __restrict__ shifts,
                                     int cps, int ds, int64_t n_out,
                                     float* __restrict__ out) {
    extern __shared__ int sh_sb[];
    const int b = blockIdx.y;
    for (int c = threadIdx.x; c < cps; c += blockDim.x)
        sh_sb[c] = shifts[b * cps + c];
    __syncthreads();

    const int64_t base = (int64_t)blockIdx.x * (kSbThreads * kSbPerThread)
                         + threadIdx.x;
    const T* rows = data + (int64_t)b * cps * T_len;
    for (int k = 0; k < kSbPerThread; ++k) {
        const int64_t j = base + (int64_t)k * kSbThreads;
        if (j >= n_out) break;
        float acc = 0.0f;
        for (int r = 0; r < ds; ++r) {
            const int64_t t = j * ds + r;
            float v = 0.0f;
            for (int c = 0; c < cps; ++c) {
                int64_t idx = t + sh_sb[c];
                if (idx > T_len - 1) idx = T_len - 1;
                v += static_cast<float>(rows[(int64_t)c * T_len + idx]);
            }
            acc = (r == 0) ? v : acc + v;
        }
        out[(int64_t)b * n_out + j] = acc;
    }
}

__global__ void dedisperse_kernel(const float* __restrict__ subb, int nsub,
                                  int64_t T_len,
                                  const int* __restrict__ shifts,
                                  const int* __restrict__ smin, int nrows,
                                  int span, float* __restrict__ out) {
    extern __shared__ int smem[];
    int* sh = smem;                        // (nrows, nsub) shift table
    int* lo = sh + kDdMaxRows * nsub;      // (nsub,) smallest shift
    float* seg = reinterpret_cast<float*>(lo + nsub);  // tile + span

    for (int i = threadIdx.x; i < nrows * nsub; i += blockDim.x)
        sh[i] = shifts[i];
    for (int i = threadIdx.x; i < nsub; i += blockDim.x)
        lo[i] = smin[i];

    const int64_t t0 = (int64_t)blockIdx.x * kDdTile;
    const int seg_len = kDdTile + span;

    float acc[kDdMaxRows][kDdPerThread];
#pragma unroll
    for (int d = 0; d < kDdMaxRows; ++d)
#pragma unroll
        for (int k = 0; k < kDdPerThread; ++k) acc[d][k] = 0.0f;

    for (int s = 0; s < nsub; ++s) {
        __syncthreads();                   // shift table ready / seg free
        const int s_lo = lo[s];
        const float* row = subb + (int64_t)s * T_len;
        for (int i = threadIdx.x; i < seg_len; i += blockDim.x) {
            int64_t g = t0 + s_lo + i;
            if (g > T_len - 1) g = T_len - 1;
            seg[i] = row[g];
        }
        __syncthreads();
#pragma unroll
        for (int d = 0; d < kDdMaxRows; ++d) {
            if (d < nrows) {
                const int off = sh[d * nsub + s] - s_lo;
#pragma unroll
                for (int k = 0; k < kDdPerThread; ++k)
                    acc[d][k] += seg[threadIdx.x + k * kDdThreads + off];
            }
        }
    }

#pragma unroll
    for (int d = 0; d < kDdMaxRows; ++d) {
        if (d < nrows) {
#pragma unroll
            for (int k = 0; k < kDdPerThread; ++k) {
                const int64_t t = t0 + threadIdx.x + k * kDdThreads;
                if (t < T_len) out[(int64_t)d * T_len + t] = acc[d][k];
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
        const int64_t per_block = kSbThreads * kSbPerThread;
        dim3 grid((unsigned)((n_out + per_block - 1) / per_block),
                  (unsigned)nsub);
        form_subbands_kernel<T><<<grid, kSbThreads, cps * sizeof(int),
                                  stream>>>(data, nchan, T_len, shifts,
                                            cps, ds, n_out, out);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

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

// Shared memory one stage-2 launch needs for a given nsub and span.
int64_t dd_dedisperse_smem_bytes(int nsub, int span) {
    return (int64_t)(kDdMaxRows * nsub + nsub) * sizeof(int)
           + (int64_t)(kDdTile + span) * sizeof(float);
}

int dd_max_rows(void) { return kDdMaxRows; }

int dd_dedisperse(const float* subb, int nsub, int64_t T_len,
                  const int* shifts, const int* smin, int nrows, int span,
                  float* out, void* stream) {
    if (nrows < 1 || nrows > kDdMaxRows) return (int)cudaErrorInvalidValue;
    const int64_t smem = dd_dedisperse_smem_bytes(nsub, span);
    cudaError_t err = cudaFuncSetAttribute(
        dedisperse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (T_len > 0) {
        dim3 grid((unsigned)((T_len + kDdTile - 1) / kDdTile));
        dedisperse_kernel<<<grid, kDdThreads, (size_t)smem,
                            (cudaStream_t)stream>>>(
            subb, nsub, T_len, shifts, smin, nrows, span, out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
