// mazecore: native host runtime helpers for the MAZE-IPP-TPU framework.
//
// The compute path is JAX/XLA on the TPU; this library accelerates the
// host-side data plane. First component: a zero-dependency BMP codec for
// the 8-bit grayscale crops the LOKI camera writes (the reference decodes
// them through PIL/imageio; here small-crop decode bypasses the general
// codec machinery entirely).
//
// Build: g++ -O3 -march=native -shared -fPIC mazecore.cpp -o _mazecore.so

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

inline uint16_t rd16(const uint8_t* p) {
    return static_cast<uint16_t>(p[0] | (p[1] << 8));
}
inline uint32_t rd32(const uint8_t* p) {
    return static_cast<uint32_t>(p[0] | (p[1] << 8) | (p[2] << 16) |
                                 (static_cast<uint32_t>(p[3]) << 24));
}
inline void wr16(uint8_t* p, uint16_t v) {
    p[0] = v & 0xff;
    p[1] = (v >> 8) & 0xff;
}
inline void wr32(uint8_t* p, uint32_t v) {
    p[0] = v & 0xff;
    p[1] = (v >> 8) & 0xff;
    p[2] = (v >> 16) & 0xff;
    p[3] = (v >> 24) & 0xff;
}

}  // namespace

extern "C" {

// Query BMP dimensions. Returns 0 on success; fills height/width/channels.
// Supports uncompressed 8-bit palette (treated as grayscale) and 24/32-bit.
int bmp_probe(const uint8_t* data, size_t n, int* height, int* width,
              int* channels) {
    if (n < 54 || data[0] != 'B' || data[1] != 'M') return -1;
    uint32_t dib = rd32(data + 14);
    if (dib < 40) return -2;
    int32_t w = static_cast<int32_t>(rd32(data + 18));
    int32_t h = static_cast<int32_t>(rd32(data + 22));
    uint16_t bpp = rd16(data + 28);
    uint32_t compression = rd32(data + 30);
    if (compression != 0) return -3;  // only BI_RGB
    if (w <= 0 || w > 1 << 20) return -4;
    int habs = h < 0 ? -h : h;
    if (habs <= 0 || habs > 1 << 20) return -4;
    // Total-pixel cap: a lying header would otherwise drive the caller
    // into a giant output allocation before decode even starts. 2^26
    // pixels (~8192^2) is far beyond any LOKI frame; bigger files fall
    // back to the general codec.
    if (static_cast<uint64_t>(w) * habs > (1u << 26)) return -4;
    if (bpp == 8) {
        *channels = 1;
    } else if (bpp == 24) {
        *channels = 3;
    } else if (bpp == 32) {
        *channels = 4;
    } else {
        return -5;
    }
    *height = habs;
    *width = w;
    return 0;
}

// Decode into caller-allocated out (height*width*channels). Grayscale BMPs
// (8-bit with a gray palette) decode to 1 channel; color ones to RGB(A).
int bmp_decode(const uint8_t* data, size_t n, uint8_t* out) {
    int H, W, C;
    int rc = bmp_probe(data, n, &H, &W, &C);
    if (rc != 0) return rc;

    uint32_t offset = rd32(data + 10);
    int32_t h_raw = static_cast<int32_t>(rd32(data + 22));
    bool bottom_up = h_raw > 0;
    uint16_t bpp = rd16(data + 28);
    size_t row_stride = (static_cast<size_t>(W) * bpp / 8 + 3) & ~size_t(3);
    if (offset + row_stride * H > n) return -6;

    // Palette for 8-bit (after the DIB header). Bounds-check in size_t
    // BEFORE forming the pointer: data + 14 + dib with an adversarial
    // 4-billion dib is out-of-bounds pointer arithmetic.
    const uint8_t* palette = nullptr;
    if (bpp == 8) {
        uint64_t dib = rd32(data + 14);
        if (14 + dib + 256 * 4 <= offset && offset <= n)
            palette = data + 14 + static_cast<size_t>(dib);
    }

    for (int y = 0; y < H; ++y) {
        const uint8_t* src = data + offset + row_stride * (bottom_up ? H - 1 - y : y);
        uint8_t* dst = out + static_cast<size_t>(y) * W * C;
        if (bpp == 8) {
            if (palette) {
                for (int x = 0; x < W; ++x) {
                    // BGRA palette entry; assume gray (LOKI) -> take B.
                    dst[x] = palette[src[x] * 4];
                }
            } else {
                std::memcpy(dst, src, W);
            }
        } else if (bpp == 24) {
            for (int x = 0; x < W; ++x) {  // BGR -> RGB
                dst[3 * x + 0] = src[3 * x + 2];
                dst[3 * x + 1] = src[3 * x + 1];
                dst[3 * x + 2] = src[3 * x + 0];
            }
        } else {  // 32: BGRA -> RGBA
            for (int x = 0; x < W; ++x) {
                dst[4 * x + 0] = src[4 * x + 2];
                dst[4 * x + 1] = src[4 * x + 1];
                dst[4 * x + 2] = src[4 * x + 0];
                dst[4 * x + 3] = src[4 * x + 3];
            }
        }
    }
    return 0;
}

// Required output buffer size for encoding an 8-bit grayscale BMP.
size_t bmp8_encoded_size(int height, int width) {
    size_t row_stride = (static_cast<size_t>(width) + 3) & ~size_t(3);
    return 54 + 256 * 4 + row_stride * height;
}

// Encode 8-bit grayscale image as a palette BMP. Returns bytes written.
size_t bmp8_encode(const uint8_t* img, int height, int width, uint8_t* out) {
    size_t row_stride = (static_cast<size_t>(width) + 3) & ~size_t(3);
    size_t data_offset = 54 + 256 * 4;
    size_t total = data_offset + row_stride * height;

    std::memset(out, 0, data_offset);
    out[0] = 'B';
    out[1] = 'M';
    wr32(out + 2, static_cast<uint32_t>(total));
    wr32(out + 10, static_cast<uint32_t>(data_offset));
    wr32(out + 14, 40);                 // DIB header size
    wr32(out + 18, static_cast<uint32_t>(width));
    wr32(out + 22, static_cast<uint32_t>(height));  // bottom-up
    wr16(out + 26, 1);                  // planes
    wr16(out + 28, 8);                  // bpp
    wr32(out + 34, static_cast<uint32_t>(row_stride * height));
    wr32(out + 46, 256);                // palette size

    uint8_t* pal = out + 54;
    for (int i = 0; i < 256; ++i) {
        pal[4 * i + 0] = pal[4 * i + 1] = pal[4 * i + 2] = static_cast<uint8_t>(i);
        pal[4 * i + 3] = 0;
    }

    for (int y = 0; y < height; ++y) {
        uint8_t* dst = out + data_offset + row_stride * (height - 1 - y);
        std::memcpy(dst, img + static_cast<size_t>(y) * width, width);
        std::memset(dst + width, 0, row_stride - width);
    }
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// PNG encoder (8-bit grayscale / RGB), zlib-backed.
//
// The vignette-export hot path writes one PNG per detected object; going
// through a dedicated single-pass encoder (filter "Up" + one deflate call)
// avoids the general-purpose codec machinery on the single-core hosts this
// pipeline runs on. Decoded by any PNG reader.

#include <cstdlib>
#include <zlib.h>
#ifdef HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

inline void wr32be(uint8_t* p, uint32_t v) {
    p[0] = (v >> 24) & 0xff;
    p[1] = (v >> 16) & 0xff;
    p[2] = (v >> 8) & 0xff;
    p[3] = v & 0xff;
}

inline uint8_t* put_chunk(uint8_t* out, const char* type, const uint8_t* data,
                          size_t len) {
    wr32be(out, static_cast<uint32_t>(len));
    std::memcpy(out + 4, type, 4);
    if (len) std::memcpy(out + 8, data, len);
    uint32_t crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, out + 4, static_cast<uInt>(4 + len));
    wr32be(out + 8 + len, crc);
    return out + 12 + len;
}

}  // namespace

extern "C" {

// Worst-case output size for png_encode. libdeflate's stored-block bound
// exceeds zlib's compressBound on small payloads, so take both.
size_t png_encoded_bound(int height, int width, int channels) {
    size_t raw = (static_cast<size_t>(width) * channels + 1) * height;
    size_t bound = compressBound(static_cast<uLong>(raw));
#ifdef HAVE_LIBDEFLATE
    size_t lb = libdeflate_zlib_compress_bound(nullptr, raw);
    if (lb > bound) bound = lb;
#endif
    return 8 + 25 + 12 + bound + 12 + 64;
}

// Encode 8-bit grayscale (channels=1) or RGB (channels=3) as PNG.
// Returns bytes written, or 0 on failure.
size_t png_encode(const uint8_t* img, int height, int width, int channels,
                  int level, uint8_t* out, size_t out_cap) {
    if (channels != 1 && channels != 3) return 0;
    size_t row = static_cast<size_t>(width) * channels;
    size_t raw_len = (row + 1) * height;

    // Filter type 2 ("Up") per scanline: cheap and effective on the smooth
    // grayscale vignettes this pipeline writes.
    uint8_t* raw = static_cast<uint8_t*>(std::malloc(raw_len));
    if (!raw) return 0;
    for (int y = 0; y < height; ++y) {
        uint8_t* dst = raw + static_cast<size_t>(y) * (row + 1);
        const uint8_t* src = img + static_cast<size_t>(y) * row;
        if (y == 0) {
            dst[0] = 0;  // None
            std::memcpy(dst + 1, src, row);
        } else {
            dst[0] = 2;  // Up
            const uint8_t* prev = src - row;
            for (size_t x = 0; x < row; ++x)
                dst[1 + x] = static_cast<uint8_t>(src[x] - prev[x]);
        }
    }

    uLongf comp_len = compressBound(static_cast<uLong>(raw_len));
#ifdef HAVE_LIBDEFLATE
    {
        size_t lb = libdeflate_zlib_compress_bound(nullptr, raw_len);
        if (lb > comp_len) comp_len = static_cast<uLongf>(lb);
    }
#endif
    uint8_t* comp = static_cast<uint8_t*>(std::malloc(comp_len));
    if (!comp) {
        std::free(raw);
        return 0;
    }
#ifdef HAVE_LIBDEFLATE
    // Same zlib stream format, ~2x the encode speed of libz — PNG encode
    // is on the per-object vignette hot path of 1-core hosts.
    {
        static thread_local libdeflate_compressor* comps[13] = {};
        int lvl = level < 1 ? 1 : (level > 12 ? 12 : level);
        if (!comps[lvl]) comps[lvl] = libdeflate_alloc_compressor(lvl);
        size_t n = comps[lvl] ? libdeflate_zlib_compress(
                                    comps[lvl], raw, raw_len, comp, comp_len)
                              : 0;
        std::free(raw);
        if (!n) {
            std::free(comp);
            return 0;
        }
        comp_len = static_cast<uLongf>(n);
    }
#else
    int rc = compress2(comp, &comp_len, raw, static_cast<uLong>(raw_len), level);
    std::free(raw);
    if (rc != Z_OK) {
        std::free(comp);
        return 0;
    }
#endif

    size_t need = 8 + 25 + (12 + comp_len) + 12;
    if (out_cap < need) {
        std::free(comp);
        return 0;
    }

    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    std::memcpy(out, sig, 8);
    uint8_t* p = out + 8;

    uint8_t ihdr[13];
    wr32be(ihdr, static_cast<uint32_t>(width));
    wr32be(ihdr + 4, static_cast<uint32_t>(height));
    ihdr[8] = 8;                        // bit depth
    ihdr[9] = channels == 1 ? 0 : 2;    // grayscale / truecolor
    ihdr[10] = ihdr[11] = ihdr[12] = 0; // deflate / adaptive / no interlace
    p = put_chunk(p, "IHDR", ihdr, 13);
    p = put_chunk(p, "IDAT", comp, comp_len);
    p = put_chunk(p, "IEND", nullptr, 0);
    std::free(comp);
    return static_cast<size_t>(p - out);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// PNG decoder (8-bit grayscale / RGB, non-interlaced).
//
// Both workloads decode PNGs on their hottest host loops: the LOKI input
// builder reads the camera's per-object vignettes, and the predict
// pipelines re-read the crops the loki export wrote. This single-purpose
// decoder (chunk walk -> one inflate -> unfilter) skips the general codec
// machinery; anything it does not support (16-bit, palette, interlaced)
// returns nonzero and the caller falls back to cv2.

namespace {

inline uint32_t rd32be(const uint8_t* p) {
    return (static_cast<uint32_t>(p[0]) << 24) |
           (static_cast<uint32_t>(p[1]) << 16) |
           (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

static const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

// Walk the chunk list; returns 0 and fills the geometry + the
// concatenated IDAT payload bounds on success.
int png_parse(const uint8_t* data, size_t len, int* height, int* width,
              int* channels) {
    if (len < 8 + 25 || std::memcmp(data, kPngSig, 8) != 0) return 1;
    const uint8_t* p = data + 8;
    const uint8_t* end = data + len;
    if (end - p < 25 || std::memcmp(p + 4, "IHDR", 4) != 0) return 1;
    uint32_t w = rd32be(p + 8), h = rd32be(p + 12);
    uint8_t bitdepth = p[16], colortype = p[17], comp = p[18], filt = p[19],
            interlace = p[20];
    if (bitdepth != 8 || comp != 0 || filt != 0 || interlace != 0) return 2;
    int ch;
    if (colortype == 0) ch = 1;
    else if (colortype == 2) ch = 3;
    else return 2;  // palette/alpha -> fall back
    if (!w || !h || w > (1u << 24) || h > (1u << 24)) return 1;
    // Total-pixel cap, same rationale as bmp_probe: the caller sizes its
    // output buffer from these fields before any inflate sanity check can
    // catch a lying IHDR.
    if (static_cast<uint64_t>(w) * h > (1u << 26)) return 1;
    // A tRNS chunk adds transparency cv2 would expand to an alpha
    // channel; this decoder doesn't, so reject to preserve the fallback
    // contract (chunk walk stops at the first IDAT — tRNS must precede).
    {
        const uint8_t* q = p;
        while (end - q >= 12) {
            uint32_t clen = rd32be(q);
            if (static_cast<size_t>(end - q) < 12 + static_cast<size_t>(clen))
                break;
            if (std::memcmp(q + 4, "tRNS", 4) == 0) return 2;
            if (std::memcmp(q + 4, "IDAT", 4) == 0 ||
                std::memcmp(q + 4, "IEND", 4) == 0)
                break;
            q += 12 + clen;
        }
    }
    *height = static_cast<int>(h);
    *width = static_cast<int>(w);
    *channels = ch;
    return 0;
}

}  // namespace

extern "C" {

// Query PNG dimensions. 0 = supported; nonzero = caller falls back.
int png_probe(const uint8_t* data, size_t len, int* height, int* width,
              int* channels) {
    return png_parse(data, len, height, width, channels);
}

// Decode into out (height*width*channels bytes). 0 on success.
int png_decode(const uint8_t* data, size_t len, uint8_t* out) {
    int h, w, ch;
    if (png_parse(data, len, &h, &w, &ch)) return 1;
    size_t row = static_cast<size_t>(w) * ch;
    size_t raw_len = (row + 1) * h;

    // Concatenate IDAT payloads (encoders may split the stream).
    uint8_t* zbuf = nullptr;
    size_t zlen = 0, zcap = 0;
    const uint8_t* p = data + 8;
    const uint8_t* end = data + len;
    while (end - p >= 12) {
        uint32_t clen = rd32be(p);
        if (static_cast<size_t>(end - p) < 12 + static_cast<size_t>(clen))
            break;
        if (std::memcmp(p + 4, "IDAT", 4) == 0) {
            if (zlen + clen > zcap) {
                zcap = (zlen + clen) * 2 + 1024;
                uint8_t* nb = static_cast<uint8_t*>(std::realloc(zbuf, zcap));
                if (!nb) { std::free(zbuf); return 1; }
                zbuf = nb;
            }
            std::memcpy(zbuf + zlen, p + 8, clen);
            zlen += clen;
        } else if (std::memcmp(p + 4, "IEND", 4) == 0) {
            break;
        }
        p += 12 + clen;
    }
    if (!zlen) { std::free(zbuf); return 1; }

    uint8_t* raw = static_cast<uint8_t*>(std::malloc(raw_len));
    if (!raw) { std::free(zbuf); return 1; }
    int ok = 0;
#ifdef HAVE_LIBDEFLATE
    {
        static thread_local libdeflate_decompressor* dec =
            libdeflate_alloc_decompressor();
        size_t got = 0;
        ok = dec && libdeflate_zlib_decompress(dec, zbuf, zlen, raw, raw_len,
                                               &got) == LIBDEFLATE_SUCCESS &&
             got == raw_len;
    }
#else
    {
        uLongf dlen = raw_len;
        ok = uncompress(raw, &dlen, zbuf, static_cast<uLong>(zlen)) == Z_OK &&
             dlen == raw_len;
    }
#endif
    std::free(zbuf);
    if (!ok) { std::free(raw); return 1; }

    // Unfilter scanline by scanline straight into the output.
    int bpp = ch;
    for (int y = 0; y < h; ++y) {
        const uint8_t* src = raw + static_cast<size_t>(y) * (row + 1);
        uint8_t f = src[0];
        ++src;
        uint8_t* dst = out + static_cast<size_t>(y) * row;
        const uint8_t* prev = y ? dst - row : nullptr;
        switch (f) {
            case 0:  // None
                std::memcpy(dst, src, row);
                break;
            case 1:  // Sub
                for (size_t x = 0; x < row; ++x)
                    dst[x] = static_cast<uint8_t>(
                        src[x] + (x >= static_cast<size_t>(bpp)
                                      ? dst[x - bpp] : 0));
                break;
            case 2:  // Up
                if (prev)
                    for (size_t x = 0; x < row; ++x)
                        dst[x] = static_cast<uint8_t>(src[x] + prev[x]);
                else
                    std::memcpy(dst, src, row);
                break;
            case 3:  // Average
                for (size_t x = 0; x < row; ++x) {
                    int a = x >= static_cast<size_t>(bpp) ? dst[x - bpp] : 0;
                    int b = prev ? prev[x] : 0;
                    dst[x] = static_cast<uint8_t>(src[x] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (size_t x = 0; x < row; ++x) {
                    int a = x >= static_cast<size_t>(bpp) ? dst[x - bpp] : 0;
                    int b = prev ? prev[x] : 0;
                    int c = (prev && x >= static_cast<size_t>(bpp))
                                ? prev[x - bpp] : 0;
                    dst[x] = static_cast<uint8_t>(src[x] + paeth(a, b, c));
                }
                break;
            default:
                std::free(raw);
                return 1;
        }
    }
    std::free(raw);
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// HDF5 chunk packing: byte-shuffle + one DEFLATE pass in native code.
//
// HDF5Writer's direct-chunk path (dataio/hdf5.py) byte-shuffles each
// whole-dataset chunk and zlib-compresses it. Doing the shuffle in numpy
// costs a strided .tobytes() transpose pass (~0.4 s per haul of raw
// prediction maps on a 1-core host); here both steps are one call with a
// cache-friendly blocked transpose.

extern "C" {

size_t chunk_pack_bound(size_t nbytes) {
    size_t bound = compressBound(static_cast<uLong>(nbytes));
#ifdef HAVE_LIBDEFLATE
    size_t lb = libdeflate_zlib_compress_bound(nullptr, nbytes);
    if (lb > bound) bound = lb;
#endif
    return bound;
}

// Shuffle (itemsize-strided byte transpose; itemsize<=0 disables) and
// zlib-compress. Returns compressed size, or 0 on failure.
size_t chunk_pack(const uint8_t* data, size_t nbytes, int itemsize,
                  int level, uint8_t* out, size_t out_cap) {
    const uint8_t* src = data;
    uint8_t* shuf = nullptr;
    if (itemsize > 1 && nbytes % itemsize == 0) {
        shuf = static_cast<uint8_t*>(std::malloc(nbytes));
        if (!shuf) return 0;
        size_t n = nbytes / itemsize;
        for (int b = 0; b < itemsize; ++b) {
            uint8_t* dst = shuf + static_cast<size_t>(b) * n;
            const uint8_t* s = data + b;
            for (size_t i = 0; i < n; ++i) dst[i] = s[i * itemsize];
        }
        src = shuf;
    }
    size_t written = 0;
#ifdef HAVE_LIBDEFLATE
    {
        static thread_local libdeflate_compressor* comps[13] = {};
        // Level 0 = DEFLATE stored blocks (still a valid zlib stream the
        // HDF5 gzip filter inflates) at ~memcpy speed — the writer's
        // adaptive path uses it for payloads DEFLATE can't shrink.
        int lvl = level < 0 ? 0 : (level > 12 ? 12 : level);
        if (!comps[lvl]) comps[lvl] = libdeflate_alloc_compressor(lvl);
        if (comps[lvl])
            written = libdeflate_zlib_compress(comps[lvl], src, nbytes, out,
                                               out_cap);
    }
#else
    {
        uLongf clen = static_cast<uLongf>(out_cap);
        if (compress2(out, &clen, src, static_cast<uLong>(nbytes), level) ==
            Z_OK)
            written = clen;
    }
#endif
    std::free(shuf);
    return written;
}

}  // extern "C"
