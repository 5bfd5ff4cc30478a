// Native bit-unpacking for PSRFITS sample data.
//
// The reference reaches its native tier through PRESTO's C readers
// (psrfits.c, invoked via the python wrappers inventoried in
// SURVEY.md 2.3); tpulsar reads PSRFITS in Python but hands the
// packed-byte -> sample expansion (the host-side hot loop: every raw
// byte of every beam passes through it) to this small C++ kernel.
// Strategy: one 256-entry lookup table per packing, written out with
// contiguous stores -- about an order of magnitude faster than the
// two-strided-stores NumPy formulation for 4-bit data.
//
// Built as a plain shared library; bound with ctypes
// (tpulsar_torch/native/__init__.py).  No Python.h dependency.

#include <cmath>
#include <cstdint>
#include <cstddef>
#include <vector>

namespace {

struct Lut4 {
    int16_t t[256][2];
    Lut4() {
        for (int b = 0; b < 256; ++b) {
            t[b][0] = static_cast<int16_t>((b >> 4) & 0x0F);  // high nibble first
            t[b][1] = static_cast<int16_t>(b & 0x0F);
        }
    }
};

struct Lut2 {
    int16_t t[256][4];
    Lut2() {
        for (int b = 0; b < 256; ++b)
            for (int k = 0; k < 4; ++k)
                t[b][k] = static_cast<int16_t>((b >> (6 - 2 * k)) & 0x03);
    }
};

struct Lut1 {
    int16_t t[256][8];
    Lut1() {
        for (int b = 0; b < 256; ++b)
            for (int k = 0; k < 8; ++k)
                t[b][k] = static_cast<int16_t>((b >> (7 - k)) & 0x01);
    }
};

const Lut4 LUT4;
const Lut2 LUT2;
const Lut1 LUT1;

}  // namespace

extern "C" {

void tpulsar_unpack4(const uint8_t* in, int16_t* out, size_t nbytes) {
    for (size_t i = 0; i < nbytes; ++i) {
        out[2 * i]     = LUT4.t[in[i]][0];
        out[2 * i + 1] = LUT4.t[in[i]][1];
    }
}

void tpulsar_unpack2(const uint8_t* in, int16_t* out, size_t nbytes) {
    for (size_t i = 0; i < nbytes; ++i) {
        const int16_t* e = LUT2.t[in[i]];
        out[4 * i]     = e[0];
        out[4 * i + 1] = e[1];
        out[4 * i + 2] = e[2];
        out[4 * i + 3] = e[3];
    }
}

void tpulsar_unpack1(const uint8_t* in, int16_t* out, size_t nbytes) {
    for (size_t i = 0; i < nbytes; ++i) {
        const int16_t* e = LUT1.t[in[i]];
        for (int k = 0; k < 8; ++k) out[8 * i + k] = e[k];
    }
}

// Fused unpack4 + per-channel scale/offset calibration:
// out[s, c] = samples[s, c] * scales[c] + offsets[c], float32.
// in is row-major (nspec, nchan/2) packed bytes.
void tpulsar_unpack4_cal(const uint8_t* in, float* out, size_t nspec,
                         size_t nchan, const float* scales,
                         const float* offsets) {
    const size_t nb = nchan / 2;
    for (size_t s = 0; s < nspec; ++s) {
        const uint8_t* row = in + s * nb;
        float* orow = out + s * nchan;
        for (size_t i = 0; i < nb; ++i) {
            orow[2 * i] = LUT4.t[row[i]][0] * scales[2 * i]
                          + offsets[2 * i];
            orow[2 * i + 1] = LUT4.t[row[i]][1] * scales[2 * i + 1]
                              + offsets[2 * i + 1];
        }
    }
}

// Fused unpack4 + affine requantization to uint8:
// out[s, c] = clip(round(samples[s, c] * a[c] + b[c]), 0, 255).
// Callers fold calibration and the block quantization map into (a, b)
// per subint row; with only 16 possible sample values the whole map
// collapses into a per-channel 16-entry uint8 LUT, so the inner loop
// is two table reads and two stores per packed byte.
void tpulsar_unpack4_q8(const uint8_t* in, uint8_t* out, size_t nspec,
                        size_t nchan, const float* a, const float* b) {
    const size_t nb = nchan / 2;
    std::vector<uint8_t> lut(nchan * 16);
    for (size_t c = 0; c < nchan; ++c) {
        for (int x = 0; x < 16; ++x) {
            // rint (round-half-to-even in the default FP environment)
            // matches the NumPy fallback's np.rint: lround's
            // half-away-from-zero differed by 1 LSB at exact .5
            // boundaries, making quantized blocks environment-
            // dependent
            const long r = static_cast<long>(
                rintf(static_cast<float>(x) * a[c] + b[c]));
            lut[c * 16 + x] =
                r < 0 ? 0 : (r > 255 ? 255 : static_cast<uint8_t>(r));
        }
    }
    for (size_t s = 0; s < nspec; ++s) {
        const uint8_t* row = in + s * nb;
        uint8_t* orow = out + s * nchan;
        for (size_t i = 0; i < nb; ++i) {
            const uint8_t byte = row[i];
            orow[2 * i] = lut[(2 * i) * 16 + ((byte >> 4) & 0x0F)];
            orow[2 * i + 1] = lut[(2 * i + 1) * 16 + (byte & 0x0F)];
        }
    }
}

}  // extern "C"
