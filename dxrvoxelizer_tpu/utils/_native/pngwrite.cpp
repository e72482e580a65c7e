// Native PNG encoder — the stb_image_write analog.
//
// The reference vendors stb_image_write for its F11 screenshot path
// (reference: Common/stb_image_write.h, DXRVoxelizer.cpp:531-551). This is
// an original implementation: 8-bit gray/RGB/RGBA, per-row none/sub/up
// filter selection by least absolute residual (the classic heuristic),
// zlib-compressed IDAT. Exposed through ctypes (utils/native.py); the
// pure-Python encoder in utils/image.py is the fallback.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
    v.push_back(uint8_t(x >> 24));
    v.push_back(uint8_t(x >> 16));
    v.push_back(uint8_t(x >> 8));
    v.push_back(uint8_t(x));
}

void put_chunk(std::vector<uint8_t>& png, const char tag[4],
               const uint8_t* data, size_t len) {
    put_be32(png, uint32_t(len));
    size_t tag_at = png.size();
    png.insert(png.end(), tag, tag + 4);
    png.insert(png.end(), data, data + len);
    uint32_t crc = crc32(0L, png.data() + tag_at, uInt(4 + len));
    put_be32(png, crc);
}

}  // namespace

extern "C" {

// Encode pixels [h][w][ch] (ch in {1,3,4}) into a malloc'd PNG buffer.
// Returns the byte length and stores the buffer in *out (caller frees via
// pngwrite_free); returns <= 0 on failure.
long long pngwrite_encode(const uint8_t* pixels, int w, int h, int ch,
                          uint8_t** out) {
    if (!pixels || !out || w <= 0 || h <= 0 ||
        (ch != 1 && ch != 3 && ch != 4)) {
        return -1;
    }
    const size_t stride = size_t(w) * ch;
    std::vector<uint8_t> raw;
    raw.reserve((stride + 1) * h);
    std::vector<uint8_t> line(stride);

    for (int y = 0; y < h; ++y) {
        const uint8_t* row = pixels + size_t(y) * stride;
        const uint8_t* up = y ? pixels + size_t(y - 1) * stride : nullptr;

        // filter heuristic: minimize sum of |residual| as signed bytes
        long long cost_none = 0, cost_sub = 0, cost_up = 0;
        for (size_t x = 0; x < stride; ++x) {
            int none = row[x];
            int sub = row[x] - (x >= size_t(ch) ? row[x - ch] : 0);
            int upv = row[x] - (up ? up[x] : 0);
            cost_none += abs(int(int8_t(none)));
            cost_sub += abs(int(int8_t(sub)));
            cost_up += abs(int(int8_t(upv)));
        }
        uint8_t filter = 0;
        if (cost_sub < cost_none && cost_sub <= cost_up) {
            filter = 1;
        } else if (cost_up < cost_none) {
            filter = 2;
        }
        raw.push_back(filter);
        for (size_t x = 0; x < stride; ++x) {
            if (filter == 1) {
                line[x] = uint8_t(row[x] - (x >= size_t(ch) ? row[x - ch] : 0));
            } else if (filter == 2) {
                line[x] = uint8_t(row[x] - (up ? up[x] : 0));
            } else {
                line[x] = row[x];
            }
        }
        raw.insert(raw.end(), line.begin(), line.end());
    }

    uLongf comp_cap = compressBound(uLong(raw.size()));
    std::vector<uint8_t> comp(comp_cap);
    if (compress2(comp.data(), &comp_cap, raw.data(), uLong(raw.size()), 6) !=
        Z_OK) {
        return -2;
    }

    std::vector<uint8_t> png;
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    png.insert(png.end(), sig, sig + 8);
    uint8_t ihdr[13];
    ihdr[0] = uint8_t(w >> 24); ihdr[1] = uint8_t(w >> 16);
    ihdr[2] = uint8_t(w >> 8); ihdr[3] = uint8_t(w);
    ihdr[4] = uint8_t(h >> 24); ihdr[5] = uint8_t(h >> 16);
    ihdr[6] = uint8_t(h >> 8); ihdr[7] = uint8_t(h);
    ihdr[8] = 8;  // bit depth
    ihdr[9] = (ch == 1) ? 0 : (ch == 3 ? 2 : 6);  // color type
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    put_chunk(png, "IHDR", ihdr, 13);
    put_chunk(png, "IDAT", comp.data(), comp_cap);
    put_chunk(png, "IEND", nullptr, 0);

    uint8_t* buf = static_cast<uint8_t*>(malloc(png.size()));
    if (!buf) return -3;
    memcpy(buf, png.data(), png.size());
    *out = buf;
    return (long long)png.size();
}

void pngwrite_free(uint8_t* p) { free(p); }

// Convenience: encode + write to a file. Returns 0 on success.
int pngwrite_file(const char* path, const uint8_t* pixels, int w, int h,
                  int ch) {
    uint8_t* buf = nullptr;
    long long len = pngwrite_encode(pixels, w, h, ch, &buf);
    if (len <= 0) return int(len ? len : -1);
    FILE* f = fopen(path, "wb");
    if (!f) {
        free(buf);
        return -4;
    }
    size_t written = fwrite(buf, 1, size_t(len), f);
    fclose(f);
    free(buf);
    return written == size_t(len) ? 0 : -5;
}

}  // extern "C"
