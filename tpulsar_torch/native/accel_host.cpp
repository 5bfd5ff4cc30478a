// Host-side consumer of the acceleration-search correlation plane.
//
// On the CPU the hi-accel stage's non-FFT time goes to the harmonic-sum
// gathers, the per-stage reductions and the plane's assembly copies.
// This kernel computes, for one block of DM trials, every harmonic
// stage's summed-power column maxima and the block-max top-k
// extraction in one cache-tiled pass — BIT-IDENTICAL to the torch path
// in tpulsar_torch/kernels/accel.py (_harmonic_stage_maxes +
// fourier.blockmax_topk) and to the JAX package's XLA path:
//   * f32 accumulation in ascending-harmonic order (same left-to-right
//     float addition order),
//   * max/argmax over z with first-index-wins ties,
//   * block maxima (block_r columns) with first-column-wins ties,
//   * top-k over block maxima sorted descending, ties by ascending
//     block index (lax.top_k semantics), -inf padding for the ragged
//     tail block, zero padding when there are fewer blocks than k.
//
// The plane is read from the overlap-save pieces still SPLIT by
// z-chunk: one buffer per z-chunk of the correlation's z loop, each
// (nd, nsegs, zc_q, 2*step), addressed through a pointer table, with
// the width left-pad applied in INDEX SPACE: plane col c maps to valid
// index v = c - width, slab s = v / (2*step), offset j = v % (2*step);
// c < width is the zero pad.  No full plane is ever assembled.
//
// On the card the same math runs in the CUDA stage kernel,
// tpulsar_torch/csrc/accel_stage.cu (kernels/cuda_dd.py::
// accel_stage_blocks), from the same pieces and bit for bit: every
// batched hi stage on the card calls it, and only its top-k over the
// block maxima is torch's.  (Replaces the compute PRESTO's
// accelsearch C core does per DM on the host without copying it: the
// z-max/harmonic-stage/top-k structure here mirrors the package's own
// design, not PRESTO's.)
//
// Build: handled by tpulsar_torch.native.load() (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

struct StagePlan {
  int h;          // stage numharm
  int64_t L;      // column count nr // h
  int64_t nb;     // block count ceil(L / block_r)
};

// Row of the plane used by harmonic hh for output z index zi:
// clip(center + hh*(zi - center), 0, nz-1).
static inline int rowmap(int hh, int zi, int nz) {
  const int center = (nz - 1) / 2;
  long r = (long)center + (long)hh * (zi - center);
  if (r < 0) r = 0;
  if (r > nz - 1) r = nz - 1;
  return (int)r;
}

// Pieces still split by z-chunk: chunk q holds z rows
// [q*zchunk, q*zchunk + zdim(q)) as (nd, nsegs, zdim, two_step); the
// select_dm offset is recomputed per chunk because the last chunk's
// zdim is the ragged nz remainder.  Plane col c =
// slab((c - width) / two_step, zi)[(c - width) % two_step], zero for
// c < width (the torch path's left pad).
struct ZSegSrc {
  const float* const* chunks;
  int nchunks;
  int zchunk;
  int nz;
  int64_t nsegs;
  int64_t dm;
  int64_t two_step;
  int64_t width;

  void select_dm(int64_t d) { dm = d; }

  inline int zdim(int q) const {
    return q == nchunks - 1 ? nz - q * zchunk : zchunk;
  }

  inline const float* slab(int64_t s, int zi) const {
    const int q = zi / zchunk, lz = zi - q * zchunk;
    return chunks[q]
        + (((size_t)dm * nsegs + s) * zdim(q) + lz) * two_step;
  }

  void seed(int zi, int64_t c0, int64_t w, float* dst) const {
    int64_t j = 0;
    while (j < w && c0 + j < width) dst[j++] = 0.0f;   // zero pad
    int64_t v = c0 + j - width;
    while (j < w) {
      const int64_t s = v / two_step, off = v % two_step;
      const int64_t take = std::min(w - j, two_step - off);
      std::memcpy(dst + j, slab(s, zi) + off,
                  (size_t)take * sizeof(float));
      j += take;
      v += take;
    }
  }

  void accum(int zi, int64_t c0, int64_t cnt, int hh, float* dst) const {
    int64_t j = 0;
    // columns hh*(c0+j) < width read the zero pad: contribute 0
    while (j < cnt && (int64_t)hh * (c0 + j) < width) ++j;
    if (j >= cnt) return;
    int64_t v = (int64_t)hh * (c0 + j) - width;
    int64_t s = v / two_step, off = v % two_step;
    const float* sp = slab(s, zi);
    for (; j < cnt; ++j) {
      dst[j] += sp[off];
      off += hh;
      if (off >= two_step) {
        s += off / two_step;
        off %= two_step;
        sp = slab(s, zi);
      }
    }
  }
};

void stage_topk_core(const ZSegSrc& src_proto,
                     int64_t nd, int nz, int64_t nr,
                     const int* stages, int nstages, int block_r,
                     int topk, float* vals, int32_t* rbins,
                     int32_t* zidx) {
  const float NEG_INF = -std::numeric_limits<float>::infinity();
  std::vector<StagePlan> plan(nstages);
  int maxh = 1;
  for (int s = 0; s < nstages; ++s) {
    plan[s].h = stages[s];
    plan[s].L = nr / stages[s];
    plan[s].nb = (plan[s].L + block_r - 1) / block_r;
    if (stages[s] > maxh) maxh = stages[s];
  }
  // stage_of[hh] = index of the first stage >= hh (terms for harmonic
  // hh are needed up to that stage's column range).
  std::vector<int> stage_of(maxh + 1, nstages - 1);
  for (int hh = 1; hh <= maxh; ++hh)
    for (int s = 0; s < nstages; ++s)
      if (plan[s].h >= hh) { stage_of[hh] = s; break; }

  // Per-stage block maxima: value, column, and the column's arg-z.
  std::vector<std::vector<float>> bmax(nstages);
  std::vector<std::vector<int64_t>> bcol(nstages);
  std::vector<std::vector<int32_t>> bz(nstages);
  // z-argmax of column 0 per stage: the XLA extraction's zero-padded
  // top-k entries read take_along_axis at clipped bin 0, i.e. column
  // 0's zarg — NOT block 0's winning column.
  std::vector<int32_t> zarg_col0(nstages, 0);

  const int64_t TILE = 4096;  // columns per tile (multiple of any
                              // power-of-two block_r <= 4096)
  std::vector<float> acc((size_t)nz * TILE);
  std::vector<float> colmax(TILE);
  std::vector<int32_t> colarg(TILE);

  for (int64_t d = 0; d < nd; ++d) {
    ZSegSrc src = src_proto;
    src.select_dm(d);
    for (int s = 0; s < nstages; ++s) {
      bmax[s].assign((size_t)plan[s].nb, NEG_INF);
      bcol[s].assign((size_t)plan[s].nb, 0);
      bz[s].assign((size_t)plan[s].nb, 0);
    }
    const int64_t Lmax = plan[0].L;  // stage 1 spans every column
    for (int64_t c0 = 0; c0 < Lmax; c0 += TILE) {
      const int64_t c1 = std::min(c0 + TILE, Lmax);
      int prev_h = 0;
      for (int s = 0; s < nstages; ++s) {
        const int h = plan[s].h;
        const int64_t Ls = plan[s].L;
        if (c0 >= Ls) break;  // this and later stages end before c0
        if (h == 1) {
          // Stage 1's "sum" is the plane itself: seed acc from it
          // (later stages accumulate on top).
          for (int zi = 0; zi < nz; ++zi)
            src.seed(zi, c0, c1 - c0, acc.data() + (size_t)zi * TILE);
        }
        // Add terms prev_h+1 .. h (harmonic hh contributes to
        // columns < L of the first stage that uses it — which for
        // hh in (prev_h, h] is exactly this stage's Ls).
        for (int hh = std::max(2, prev_h + 1); hh <= h; ++hh) {
          const int64_t cend = std::min(c1, plan[stage_of[hh]].L);
          for (int zi = 0; zi < nz; ++zi)
            src.accum(rowmap(hh, zi, nz), c0, cend - c0, hh,
                      acc.data() + (size_t)zi * TILE);
        }
        // Column max over z (first-z-wins ties) computed ROW-wise —
        // a per-column walk down the (nz, TILE) accumulator strides
        // by the tile width and thrashes one cache set; the running
        // row-wise compare streams sequentially and vectorizes.
        const int64_t cend = std::min(c1, Ls);
        const int64_t w = cend - c0;
        std::memcpy(colmax.data(), acc.data(), (size_t)w * sizeof(float));
        std::fill(colarg.begin(), colarg.begin() + w, 0);
        for (int zi = 1; zi < nz; ++zi) {
          const float* a = acc.data() + (size_t)zi * TILE;
          for (int64_t j = 0; j < w; ++j)
            if (a[j] > colmax[j]) { colmax[j] = a[j]; colarg[j] = zi; }
        }
        // Fold into the stage's running block maxima
        // (first-column-wins ties).
        if (c0 == 0) zarg_col0[s] = colarg[0];
        for (int64_t c = c0; c < cend; ++c) {
          const float m = colmax[c - c0];
          const int64_t b = c / block_r;
          if (m > bmax[s][b]) {
            bmax[s][b] = m;
            bcol[s][b] = c;
            bz[s][b] = colarg[c - c0];
          }
        }
        prev_h = h;
      }
    }
    // Top-k over block maxima per stage: descending, stable by block
    // index (lax.top_k), then the same padding/clipping as the XLA
    // extraction (zero-pad short results; zidx of padded entries
    // reads zarg at column 0).
    for (int s = 0; s < nstages; ++s) {
      const int64_t nb = plan[s].nb;
      const int k = (int)std::min<int64_t>(topk, nb);
      std::vector<int64_t> order(nb);
      for (int64_t i = 0; i < nb; ++i) order[i] = i;
      std::partial_sort(order.begin(), order.begin() + k, order.end(),
                        [&](int64_t a, int64_t b) {
                          if (bmax[s][a] != bmax[s][b])
                            return bmax[s][a] > bmax[s][b];
                          return a < b;
                        });
      float* ov = vals + ((size_t)d * nstages + s) * topk;
      int32_t* ob = rbins + ((size_t)d * nstages + s) * topk;
      int32_t* oz = zidx + ((size_t)d * nstages + s) * topk;
      for (int i = 0; i < k; ++i) {
        const int64_t b = order[i];
        ov[i] = bmax[s][b];
        ob[i] = (int32_t)bcol[s][b];
        oz[i] = bz[s][b];
      }
      for (int i = k; i < topk; ++i) {
        ov[i] = 0.0f;
        ob[i] = 0;
        oz[i] = zarg_col0[s];
      }
    }
  }
}

}  // namespace

extern "C" {

// stages: ascending harmonic stages (e.g. 1,2,4,8,16).
// vals/rbins/zidx: (nd, nstages, topk) outputs, matching
// _accel_block_topk's (vals, rbin, zidx) stacking order.
// chunks: nchunks buffers, chunk q = (nd, nsegs, zdim(q), two_step)
// float32 — the overlap-save powers still SPLIT by z-chunk, exactly
// as the jitted z loop produces them (no concatenate anywhere).
// zchunk is the z height of every chunk but the last (which holds
// the ragged nz remainder).
void tpulsar_accel_stage_topk_zsegs(
    const float* const* chunks, int nchunks, int zchunk,
    int64_t nd, int64_t nsegs, int nz, int64_t two_step,
    int64_t width, int64_t nr,
    const int* stages, int nstages, int block_r, int topk,
    float* vals, int32_t* rbins, int32_t* zidx) {
  ZSegSrc proto;
  proto.chunks = chunks;
  proto.nchunks = nchunks;
  proto.zchunk = zchunk;
  proto.nz = nz;
  proto.nsegs = nsegs;
  proto.dm = 0;
  proto.two_step = two_step;
  proto.width = width;
  stage_topk_core(proto, nd, nz, nr, stages, nstages, block_r, topk,
                  vals, rbins, zidx);
}

}  // extern "C"
