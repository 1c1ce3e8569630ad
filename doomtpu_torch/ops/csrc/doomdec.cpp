// Native asset decoder for doomtpu_torch: the port's own copy of the
// JAX package's native/doomdec.cpp, the same code.
//
// Decodes the Doom picture (patch) format — column-major posts with a
// 0xff terminator (see the format notes in
// doomtpu_torch/assets/pictures.py) — into dense row-major pixel +
// opacity planes.  Load-time hot path when a WAD carries hundreds of
// sprite/patch lumps.  A host library, built with the host C++ compiler
// (doomtpu_torch/ops/build.py::build_host_library).
//
// Exposed via a tiny C ABI consumed with ctypes
// (doomtpu_torch/ops/native.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// Returns 0 on success, nonzero on malformed input.
// raw: the full picture lump. pixels/mask: h*w row-major output planes.
int doomdec_picture(const uint8_t* raw, size_t raw_len, int w, int h,
                    uint8_t* pixels, uint8_t* mask) {
    if (raw_len < 8 + 4 * (size_t)w) return 1;
    std::memset(pixels, 0, (size_t)w * h);
    std::memset(mask, 0, (size_t)w * h);

    for (int x = 0; x < w; ++x) {
        uint32_t off;
        std::memcpy(&off, raw + 8 + 4 * (size_t)x, 4);
        while (true) {
            if (off >= raw_len) return 2;
            uint8_t y_offset = raw[off];
            if (y_offset == 0xff) break;
            if (off + 2 > raw_len) return 2;
            uint8_t length = raw[off + 1];
            if (off + 3 + (size_t)length > raw_len) return 3;
            for (int i = 0; i < length; ++i) {
                int y = y_offset + i;
                if (y >= 0 && y < h) {
                    pixels[(size_t)y * w + x] = raw[off + 3 + (size_t)i];
                    mask[(size_t)y * w + x] = 1;
                }
            }
            off += (uint32_t)length + 4;
        }
    }
    return 0;
}

}  // extern "C"
