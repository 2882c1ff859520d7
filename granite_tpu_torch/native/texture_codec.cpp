// Texture codec of granite_tpu_torch: BCn (BC1/3/4/5/7 decode and encode,
// BC6H decode and encode), ETC2/EAC and ASTC LDR (all 14 2D footprints)
// decode, and the GTPX container header.  Texture streaming decodes a
// `.gtpx` sidecar with it on worker threads (assets/streaming.py).
//
// A copy of the texture half of granite_tpu/native/granite_native.cpp
// (the port imports nothing of the JAX package): its BCn section and its
// GTPX, ETC2/EAC, BC7, BC6H and ASTC sections, unchanged.  The MLT1
// meshlet codec and the radix sort, which serve only the offline tools,
// are left out.  tests/test_torch_texture_codec.py holds every decoder
// and encoder byte-equal to the original's.  Built with g++ at first use
// and bound with ctypes (granite_tpu_torch/native/texture.py).
//
// The original's notes follow.
//
// granite_native — host-side data-plane library.
//
// The reference implements these in C++ inside the engine:
//   * GPU-format texture transcode (vulkan/texture/texture_decoder.cpp
//     decodes BC/ETC2/ASTC blocks when hardware lacks the format; here the
//     TPU always lacks them, so decode runs on host at asset load),
//   * the MemoryMappedTexture (GTX) container (vulkan/texture/
//     memory_mapped_texture.cpp),
//   * meshlet encode/decode (vulkan/mesh/meshlet.cpp +
//     scene-export/meshlet_export.cpp),
//   * 64-bit radix sort for draw lists (util/radix_sorter.hpp).
//
// This is a fresh implementation against the public format specs (BCn per
// the Khronos Data Format spec), not a port of the reference's code.
// Exposed as extern "C" for ctypes.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// BCn block decompression (Khronos Data Format / S3TC spec).
// ---------------------------------------------------------------------------

static inline void decode_bc1_colors(uint16_t c0, uint16_t c1,
                                     uint8_t pal[4][4], bool allow_alpha) {
    auto expand = [](uint16_t c, uint8_t *rgb) {
        rgb[0] = (uint8_t)(((c >> 11) & 31) * 255 / 31);
        rgb[1] = (uint8_t)(((c >> 5) & 63) * 255 / 63);
        rgb[2] = (uint8_t)((c & 31) * 255 / 31);
    };
    expand(c0, pal[0]);
    expand(c1, pal[1]);
    pal[0][3] = pal[1][3] = 255;
    if (c0 > c1 || !allow_alpha) {
        for (int i = 0; i < 3; i++) {
            pal[2][i] = (uint8_t)((2 * pal[0][i] + pal[1][i]) / 3);
            pal[3][i] = (uint8_t)((pal[0][i] + 2 * pal[1][i]) / 3);
        }
        pal[2][3] = pal[3][3] = 255;
    } else {
        for (int i = 0; i < 3; i++) {
            pal[2][i] = (uint8_t)((pal[0][i] + pal[1][i]) / 2);
            pal[3][i] = 0;
        }
        pal[2][3] = 255;
        pal[3][3] = 0;
    }
}

// BC1: 8 bytes/block -> 4x4 RGBA8.
void decode_bc1(const uint8_t *src, uint8_t *dst, int width, int height) {
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            const uint8_t *b = src + (by * bw + bx) * 8;
            uint16_t c0 = (uint16_t)(b[0] | (b[1] << 8));
            uint16_t c1 = (uint16_t)(b[2] | (b[3] << 8));
            uint32_t bits;
            memcpy(&bits, b + 4, 4);
            uint8_t pal[4][4];
            decode_bc1_colors(c0, c1, pal, true);
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    int px = bx * 4 + x, py = by * 4 + y;
                    if (px >= width || py >= height) continue;
                    int idx = (bits >> (2 * (y * 4 + x))) & 3;
                    memcpy(dst + (py * width + px) * 4, pal[idx], 4);
                }
        }
}

// BC4 single-channel helper: 8 bytes -> 16 values.
static void decode_bc4_block(const uint8_t *b, uint8_t out[16]) {
    int a0 = b[0], a1 = b[1];
    uint64_t bits = 0;
    for (int i = 0; i < 6; i++)
        bits |= (uint64_t)b[2 + i] << (8 * i);
    int pal[8];
    pal[0] = a0;
    pal[1] = a1;
    if (a0 > a1)
        for (int i = 1; i < 7; i++) pal[1 + i] = ((7 - i) * a0 + i * a1) / 7;
    else {
        for (int i = 1; i < 5; i++) pal[1 + i] = ((5 - i) * a0 + i * a1) / 5;
        pal[6] = 0;
        pal[7] = 255;
    }
    for (int i = 0; i < 16; i++)
        out[i] = (uint8_t)pal[(bits >> (3 * i)) & 7];
}

// BC3: 16 bytes/block (BC4 alpha + BC1 color).
void decode_bc3(const uint8_t *src, uint8_t *dst, int width, int height) {
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            const uint8_t *b = src + (by * bw + bx) * 16;
            uint8_t alpha[16];
            decode_bc4_block(b, alpha);
            uint16_t c0 = (uint16_t)(b[8] | (b[9] << 8));
            uint16_t c1 = (uint16_t)(b[10] | (b[11] << 8));
            uint32_t bits;
            memcpy(&bits, b + 12, 4);
            uint8_t pal[4][4];
            decode_bc1_colors(c0, c1, pal, false);
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    int px = bx * 4 + x, py = by * 4 + y;
                    if (px >= width || py >= height) continue;
                    int idx = (bits >> (2 * (y * 4 + x))) & 3;
                    uint8_t *d = dst + (py * width + px) * 4;
                    memcpy(d, pal[idx], 3);
                    d[3] = alpha[y * 4 + x];
                }
        }
}

// BC4 (R) / BC5 (RG), expanded to RGBA8.
void decode_bc4(const uint8_t *src, uint8_t *dst, int width, int height) {
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            uint8_t r[16];
            decode_bc4_block(src + (by * bw + bx) * 8, r);
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    int px = bx * 4 + x, py = by * 4 + y;
                    if (px >= width || py >= height) continue;
                    uint8_t *d = dst + (py * width + px) * 4;
                    d[0] = r[y * 4 + x];
                    d[1] = d[2] = 0;
                    d[3] = 255;
                }
        }
}

void decode_bc5(const uint8_t *src, uint8_t *dst, int width, int height) {
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            uint8_t r[16], g[16];
            const uint8_t *b = src + (by * bw + bx) * 16;
            decode_bc4_block(b, r);
            decode_bc4_block(b + 8, g);
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    int px = bx * 4 + x, py = by * 4 + y;
                    if (px >= width || py >= height) continue;
                    uint8_t *d = dst + (py * width + px) * 4;
                    d[0] = r[y * 4 + x];
                    d[1] = g[y * 4 + x];
                    d[2] = 0;
                    d[3] = 255;
                }
        }
}

// ---------------------------------------------------------------------------
// BC1 encoder (min/max bounding-box fit) — the repacker's compressor
// (scene-export/texture_compression.cpp analogue, simplified fit).
// ---------------------------------------------------------------------------

static uint16_t pack565(const uint8_t *rgb) {
    return (uint16_t)(((rgb[0] * 31 / 255) << 11) |
                      ((rgb[1] * 63 / 255) << 5) |
                      (rgb[2] * 31 / 255));
}

void encode_bc1(const uint8_t *src, uint8_t *dst, int width, int height) {
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            uint8_t mn[3] = {255, 255, 255}, mx[3] = {0, 0, 0};
            uint8_t texels[16][4];
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    int px = std::min(bx * 4 + x, width - 1);
                    int py = std::min(by * 4 + y, height - 1);
                    const uint8_t *s = src + (py * width + px) * 4;
                    memcpy(texels[y * 4 + x], s, 4);
                    for (int c = 0; c < 3; c++) {
                        mn[c] = std::min(mn[c], s[c]);
                        mx[c] = std::max(mx[c], s[c]);
                    }
                }
            uint16_t c0 = pack565(mx), c1 = pack565(mn);
            if (c0 < c1) std::swap(c0, c1);
            uint8_t pal[4][4];
            decode_bc1_colors(c0, c1, pal, false);
            uint32_t bits = 0;
            for (int i = 0; i < 16; i++) {
                int best = 0;
                long bestd = 1L << 60;
                for (int p = 0; p < 4; p++) {
                    long d = 0;
                    for (int c = 0; c < 3; c++) {
                        long diff = (long)texels[i][c] - pal[p][c];
                        d += diff * diff;
                    }
                    if (d < bestd) { bestd = d; best = p; }
                }
                bits |= (uint32_t)best << (2 * i);
            }
            uint8_t *out = dst + (by * bw + bx) * 8;
            out[0] = (uint8_t)c0; out[1] = (uint8_t)(c0 >> 8);
            out[2] = (uint8_t)c1; out[3] = (uint8_t)(c1 >> 8);
            memcpy(out + 4, &bits, 4);
        }
}

// ---------------------------------------------------------------------------
// RGTC / BC3-5 encoders (scene-export/rgtc_compressor.cpp +
// texture_compression.cpp analogues): single-channel BC4 blocks via the
// 8-point interpolated alpha ramp; BC5 = two BC4 planes (XY normal
// maps); BC3 = BC1 color + BC4 alpha.
// ---------------------------------------------------------------------------

static void encode_bc4_block(const uint8_t vals[16], uint8_t out[8]) {
    uint8_t mn = 255, mx = 0;
    for (int i = 0; i < 16; i++) {
        mn = std::min(mn, vals[i]);
        mx = std::max(mx, vals[i]);
    }
    // 8-point mode (a0 > a1): endpoints + 6 interpolants.
    uint8_t a0 = mx, a1 = mn;
    uint8_t pal[8];
    pal[0] = a0; pal[1] = a1;
    if (a0 > a1)
        for (int i = 1; i < 7; i++)
            pal[1 + i] = (uint8_t)(((7 - i) * a0 + i * a1) / 7);
    else {                    // flat block: 6-point mode degenerates fine
        for (int i = 1; i < 5; i++)
            pal[1 + i] = (uint8_t)(((5 - i) * a0 + i * a1) / 5);
        pal[6] = 0; pal[7] = 255;
    }
    uint64_t bits = 0;
    for (int i = 0; i < 16; i++) {
        int best = 0; int bestd = 1 << 30;
        for (int p = 0; p < 8; p++) {
            int d = (int)vals[i] - pal[p];
            d *= d;
            if (d < bestd) { bestd = d; best = p; }
        }
        bits |= (uint64_t)best << (3 * i);
    }
    out[0] = a0; out[1] = a1;
    for (int b = 0; b < 6; b++)
        out[2 + b] = (uint8_t)(bits >> (8 * b));
}

static void gather_channel(const uint8_t *src, int width, int height,
                           int bx, int by, int stride, int chan,
                           uint8_t vals[16]) {
    for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
            int px = std::min(bx * 4 + x, width - 1);
            int py = std::min(by * 4 + y, height - 1);
            vals[y * 4 + x] = src[(py * width + px) * stride + chan];
        }
}

void encode_bc4(const uint8_t *src, uint8_t *dst, int width, int height) {
    // src: RGBA8; channel 0 (R) is compressed (rgtc_compressor.cpp R8).
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            uint8_t vals[16];
            gather_channel(src, width, height, bx, by, 4, 0, vals);
            encode_bc4_block(vals, dst + (by * bw + bx) * 8);
        }
}

void encode_bc5(const uint8_t *src, uint8_t *dst, int width, int height) {
    // RG from RGBA8 -> two BC4 planes (normal-map XY).
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            uint8_t vals[16];
            uint8_t *out = dst + (by * bw + bx) * 16;
            gather_channel(src, width, height, bx, by, 4, 0, vals);
            encode_bc4_block(vals, out);
            gather_channel(src, width, height, bx, by, 4, 1, vals);
            encode_bc4_block(vals, out + 8);
        }
}

void encode_bc3(const uint8_t *src, uint8_t *dst, int width, int height) {
    // BC3 block = BC4 alpha block + BC1 color block (no punch-through).
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    // color half reuses encode_bc1 into a scratch, alpha via BC4.
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            uint8_t *out = dst + (by * bw + bx) * 16;
            uint8_t vals[16];
            gather_channel(src, width, height, bx, by, 4, 3, vals);
            encode_bc4_block(vals, out);
            // BC1 color for this block
            uint8_t mn[3] = {255, 255, 255}, mx[3] = {0, 0, 0};
            uint8_t texels[16][4];
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    int px = std::min(bx * 4 + x, width - 1);
                    int py = std::min(by * 4 + y, height - 1);
                    const uint8_t *s = src + (py * width + px) * 4;
                    memcpy(texels[y * 4 + x], s, 4);
                    for (int c = 0; c < 3; c++) {
                        mn[c] = std::min(mn[c], s[c]);
                        mx[c] = std::max(mx[c], s[c]);
                    }
                }
            uint16_t c0 = pack565(mx), c1 = pack565(mn);
            if (c0 < c1) std::swap(c0, c1);
            uint8_t pal[4][4];
            decode_bc1_colors(c0, c1, pal, false);
            uint32_t bits = 0;
            for (int i = 0; i < 16; i++) {
                int best = 0;
                long bestd = 1L << 60;
                for (int p = 0; p < 4; p++) {
                    long d = 0;
                    for (int c = 0; c < 3; c++) {
                        long diff = (long)texels[i][c] - pal[p][c];
                        d += diff * diff;
                    }
                    if (d < bestd) { bestd = d; best = p; }
                }
                bits |= (uint32_t)best << (2 * i);
            }
            out[8] = (uint8_t)c0; out[9] = (uint8_t)(c0 >> 8);
            out[10] = (uint8_t)c1; out[11] = (uint8_t)(c1 >> 8);
            memcpy(out + 12, &bits, 4);
        }
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// GTX-style container ("GTPX") — mmap-friendly texture file
// (vulkan/texture/memory_mapped_texture.cpp analogue; fresh layout).
// Header: magic 'GTPX', version, format, width, height, levels, flags,
// then per-level {offset, size} table, then payload.
// ---------------------------------------------------------------------------

struct GtpxHeader {
    char magic[4];       // "GTPX"
    uint32_t version;    // 1
    uint32_t format;     // 0=RGBA8, 1=BC1, 3=BC3, 4=BC4, 5=BC5
    uint32_t width, height, levels, flags;
};

int gtpx_write_header(uint8_t *out, uint32_t format, uint32_t width,
                      uint32_t height, uint32_t levels, uint32_t flags) {
    GtpxHeader h;
    memcpy(h.magic, "GTPX", 4);
    h.version = 1;
    h.format = format;
    h.width = width;
    h.height = height;
    h.levels = levels;
    h.flags = flags;
    memcpy(out, &h, sizeof(h));
    return (int)sizeof(h);
}

int gtpx_read_header(const uint8_t *data, int size, uint32_t *format,
                     uint32_t *width, uint32_t *height, uint32_t *levels,
                     uint32_t *flags) {
    if (size < (int)sizeof(GtpxHeader)) return -1;
    GtpxHeader h;
    memcpy(&h, data, sizeof(h));
    if (memcmp(h.magic, "GTPX", 4) != 0 || h.version != 1) return -2;
    *format = h.format;
    *width = h.width;
    *height = h.height;
    *levels = h.levels;
    *flags = h.flags;
    return (int)sizeof(GtpxHeader);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// ETC2 / EAC / BC7 decoders (reference behavior:
// assets/shaders/decode/{etc2,eac,bc7}.comp; constant tables are Khronos /
// D3D spec facts).  Block-oriented scalar C, 4x4 RGBA8 out per block.
// ---------------------------------------------------------------------------

extern "C" {

static const int etc1_mod_table[8][2] = {
    {2, 8}, {5, 17}, {9, 29}, {13, 42},
    {18, 60}, {24, 80}, {33, 106}, {47, 183}};

static const int etc2_alpha_mod[16][4] = {
    {2, 5, 8, 14}, {2, 6, 9, 12}, {1, 4, 7, 12}, {1, 3, 5, 12},
    {2, 5, 7, 11}, {2, 6, 8, 10}, {3, 6, 7, 10}, {2, 4, 7, 10},
    {1, 5, 7, 9}, {1, 4, 7, 9}, {1, 3, 7, 9}, {1, 4, 6, 9},
    {2, 3, 6, 9}, {0, 1, 2, 9}, {3, 5, 7, 8}, {2, 4, 6, 8}};

static const int etc2_dist[8] = {3, 6, 11, 16, 23, 32, 41, 64};

static inline uint64_t load_be64(const uint8_t *p) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
    return v;
}

static inline int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

static inline int ext(uint64_t v, int bit, int count) {
    return (int)((v >> bit) & ((1ull << count) - 1));
}

static inline int sext3(int v) { return (v & 4) ? v - 8 : v; }

// Decode one ETC2 color block (8 bytes, big-endian) into rgb[16][3].
// punch_mask: when alpha_bits==1, bit set -> pixel is transparent.
static void decode_etc2_color_block(uint64_t blk, int alpha_bits,
                                    uint8_t rgb[16][3],
                                    uint16_t *punch_mask) {
    *punch_mask = 0;
    const int diff_bit = ext(blk, 33, 1);
    const int flip = ext(blk, 32, 1);
    const int punchthrough_block = (alpha_bits == 1) && !diff_bit;
    // linear_pixel = 4*x + y (ETC column-major pixel order)
    if (alpha_bits != 1 && !diff_bit) {
        // Individual (ETC1) mode: two 4-bit bases.
        int base[2][3];
        base[0][0] = ext(blk, 60, 4) * 0x11;
        base[1][0] = ext(blk, 56, 4) * 0x11;
        base[0][1] = ext(blk, 52, 4) * 0x11;
        base[1][1] = ext(blk, 48, 4) * 0x11;
        base[0][2] = ext(blk, 44, 4) * 0x11;
        base[1][2] = ext(blk, 40, 4) * 0x11;
        int table[2] = {ext(blk, 37, 3), ext(blk, 34, 3)};
        for (int px = 0; px < 16; px++) {
            int x = px >> 2, y = px & 3;
            int sb = flip ? (y >> 1) : (x >> 1);
            int msb = ext(blk, 16 + px, 1);
            int lsb = ext(blk, px, 1);
            int mag = etc1_mod_table[table[sb]][lsb];
            int mod = msb ? -mag : mag;
            for (int c = 0; c < 3; c++)
                rgb[px][c] = (uint8_t)clamp255(base[sb][c] + mod);
        }
        return;
    }
    int r = ext(blk, 59, 5), rd = sext3(ext(blk, 56, 3));
    int g = ext(blk, 51, 5), gd = sext3(ext(blk, 48, 3));
    int b = ext(blk, 43, 5), bd = sext3(ext(blk, 40, 3));
    int r1 = r + rd, g1 = g + gd, b1 = b + bd;
    if (r1 < 0 || r1 > 31) {
        // T mode
        int tr1 = (ext(blk, 59, 2) << 2) | ext(blk, 56, 2);
        int tg1 = ext(blk, 52, 4);
        int tb1 = ext(blk, 48, 4);
        int tr2 = ext(blk, 44, 4);
        int tg2 = ext(blk, 40, 4);
        int tb2 = ext(blk, 36, 4);
        int da = (ext(blk, 34, 2) << 1) | ext(blk, 32, 1);
        int dist = etc2_dist[da];
        int c1[3] = {tr1 * 0x11, tg1 * 0x11, tb1 * 0x11};
        int c2[3] = {tr2 * 0x11, tg2 * 0x11, tb2 * 0x11};
        for (int px = 0; px < 16; px++) {
            int msb = ext(blk, 16 + px, 1);
            int lsb = ext(blk, px, 1);
            int idx = (msb << 1) | lsb;
            int out[3];
            if (idx == 0) {
                out[0] = c1[0]; out[1] = c1[1]; out[2] = c1[2];
            } else {
                int mod = 2 - idx;     // 1, 0, -1 for idx 1, 2, 3
                for (int c = 0; c < 3; c++)
                    out[c] = c2[c] + mod * dist;
            }
            if (punchthrough_block && idx == 2) *punch_mask |= 1u << px;
            for (int c = 0; c < 3; c++)
                rgb[px][c] = (uint8_t)clamp255(out[c]);
        }
        return;
    }
    if (g1 < 0 || g1 > 31) {
        // H mode
        int hr1 = ext(blk, 59, 4);
        int hg1 = (ext(blk, 56, 3) << 1) | ext(blk, 52, 1);
        int hb1 = ext(blk, 51, 1) << 3 | ext(blk, 47, 3);
        int hr2 = ext(blk, 43, 4);
        int hg2 = ext(blk, 39, 4);
        int hb2 = ext(blk, 35, 4);
        int d = (ext(blk, 34, 1) << 2) | (ext(blk, 32, 1) << 1);
        int v1 = (hr1 << 16) | (hg1 << 8) | hb1;
        int v2 = (hr2 << 16) | (hg2 << 8) | hb2;
        d += (v1 >= v2);
        int dist = etc2_dist[d];
        int c1[3] = {hr1 * 0x11, hg1 * 0x11, hb1 * 0x11};
        int c2[3] = {hr2 * 0x11, hg2 * 0x11, hb2 * 0x11};
        for (int px = 0; px < 16; px++) {
            int msb = ext(blk, 16 + px, 1);
            int lsb = ext(blk, px, 1);
            const int *base = msb ? c2 : c1;
            int mod = 1 - 2 * lsb;
            if (punchthrough_block && msb && lsb)
                *punch_mask |= 1u << px;
            for (int c = 0; c < 3; c++)
                rgb[px][c] = (uint8_t)clamp255(base[c] + mod * dist);
        }
        return;
    }
    if (b1 < 0 || b1 > 31) {
        // Planar mode
        int ro = ext(blk, 57, 6);
        int go = (ext(blk, 56, 1) << 6) | ext(blk, 49, 6);
        int bo = (ext(blk, 48, 1) << 5) | (ext(blk, 43, 2) << 3)
                 | ext(blk, 39, 3);
        int rh = (ext(blk, 34, 5) << 1) | ext(blk, 32, 1);
        int gh = ext(blk, 25, 7);
        int bh = ext(blk, 19, 6);
        int rv = ext(blk, 13, 6);
        int gv = ext(blk, 6, 7);
        int bv = ext(blk, 0, 6);
        ro = (ro << 2) | (ro >> 4); rh = (rh << 2) | (rh >> 4);
        rv = (rv << 2) | (rv >> 4);
        go = (go << 1) | (go >> 6); gh = (gh << 1) | (gh >> 6);
        gv = (gv << 1) | (gv >> 6);
        bo = (bo << 2) | (bo >> 4); bh = (bh << 2) | (bh >> 4);
        bv = (bv << 2) | (bv >> 4);
        for (int px = 0; px < 16; px++) {
            int x = px >> 2, y = px & 3;
            int o[3] = {ro, go, bo}, hh[3] = {rh, gh, bh},
                vv[3] = {rv, gv, bv};
            for (int c = 0; c < 3; c++) {
                int val = o[c] + (((hh[c] - o[c]) * x
                                   + (vv[c] - o[c]) * y + 2) >> 2);
                rgb[px][c] = (uint8_t)clamp255(val);
            }
        }
        return;
    }
    // Differential (ETC1) mode.
    int base[2][3] = {{r * 0x11 >> 0, 0, 0}, {0, 0, 0}};
    base[0][0] = (r << 3) | (r >> 2);
    base[0][1] = (g << 3) | (g >> 2);
    base[0][2] = (b << 3) | (b >> 2);
    base[1][0] = (r1 << 3) | (r1 >> 2);
    base[1][1] = (g1 << 3) | (g1 >> 2);
    base[1][2] = (b1 << 3) | (b1 >> 2);
    int table[2] = {ext(blk, 37, 3), ext(blk, 34, 3)};
    for (int px = 0; px < 16; px++) {
        int x = px >> 2, y = px & 3;
        int sb = flip ? (y >> 1) : (x >> 1);
        int msb = ext(blk, 16 + px, 1);
        int lsb = ext(blk, px, 1);
        int mag = etc1_mod_table[table[sb]][lsb];
        int mod = msb ? -mag : mag;
        if (punchthrough_block && msb && lsb) *punch_mask |= 1u << px;
        if (punchthrough_block && msb && !lsb) mod = 0;
        if (punchthrough_block && !msb && !lsb) mod = 0;
        if (punchthrough_block && !msb && lsb) mod = mag;
        for (int c = 0; c < 3; c++)
            rgb[px][c] = (uint8_t)clamp255(base[sb][c] + mod);
    }
}

static inline int decode_eac_alpha_px(uint64_t blk, int px) {
    int base = ext(blk, 56, 8);
    int mult = ext(blk, 52, 4);
    int table = ext(blk, 48, 4);
    int sel = ext(blk, 45 - 3 * px, 3);
    int lsb2 = sel & 3;
    int msb = sel >> 2;
    int mod = etc2_alpha_mod[table][lsb2] ^ (msb - 1);  // negate-1 trick
    return clamp255(base + mod * mult);
}

void decode_etc2(const uint8_t *src, uint8_t *dst, int width, int height,
                 int alpha_bits) {
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    size_t bsize = (alpha_bits == 8) ? 16 : 8;
    for (int by = 0; by < bh; by++) {
        for (int bx = 0; bx < bw; bx++) {
            const uint8_t *b = src + (by * bw + bx) * bsize;
            uint64_t ablk = 0, cblk;
            if (alpha_bits == 8) {
                ablk = load_be64(b);
                cblk = load_be64(b + 8);
            } else {
                cblk = load_be64(b);
            }
            uint8_t rgb[16][3];
            uint16_t punch = 0;
            decode_etc2_color_block(cblk, alpha_bits, rgb, &punch);
            for (int px = 0; px < 16; px++) {
                int x = bx * 4 + (px >> 2);
                int y = by * 4 + (px & 3);
                if (x >= width || y >= height) continue;
                uint8_t *o = dst + (y * width + x) * 4;
                int transparent = (punch >> px) & 1;
                o[0] = transparent ? 0 : rgb[px][0];
                o[1] = transparent ? 0 : rgb[px][1];
                o[2] = transparent ? 0 : rgb[px][2];
                if (alpha_bits == 8)
                    o[3] = (uint8_t)decode_eac_alpha_px(ablk, px);
                else if (alpha_bits == 1)
                    o[3] = transparent ? 0 : 255;
                else
                    o[3] = 255;
            }
        }
    }
}

// EAC R11/RG11 -> 8-bit (11-bit codes >> 3), alpha=255.
void decode_eac(const uint8_t *src, uint8_t *dst, int width, int height,
                int channels) {
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    size_t bsize = channels * 8;
    for (int by = 0; by < bh; by++) {
        for (int bx = 0; bx < bw; bx++) {
            const uint8_t *b = src + (by * bw + bx) * bsize;
            for (int px = 0; px < 16; px++) {
                int x = bx * 4 + (px >> 2);
                int y = by * 4 + (px & 3);
                if (x >= width || y >= height) continue;
                uint8_t *o = dst + (y * width + x) * 4;
                for (int c = 0; c < 4; c++) o[c] = (c == 3) ? 255 : 0;
                for (int c = 0; c < channels; c++) {
                    uint64_t blk = load_be64(b + c * 8);
                    int base = ext(blk, 56, 8) * 8 + 4;
                    int mult = ext(blk, 52, 4) * 8;
                    if (mult == 0) mult = 1;
                    int table = ext(blk, 48, 4);
                    int sel = ext(blk, 45 - 3 * px, 3);
                    int mod = etc2_alpha_mod[table][sel & 3]
                              ^ ((sel >> 2) - 1);
                    int v11 = base + mod * mult;
                    if (v11 < 0) v11 = 0;
                    if (v11 > 2047) v11 = 2047;
                    o[c] = (uint8_t)(v11 >> 3);
                }
            }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BC7 decoder (D3D11 spec; partition/anchor/weight tables are spec
// constants, cf. assets/shaders/decode/bc7.comp).
// ---------------------------------------------------------------------------

extern "C" {

static const uint8_t bc7_w2[4] = {0, 21, 43, 64};
static const uint8_t bc7_w3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
static const uint8_t bc7_w4[16] = {0, 4, 9, 13, 17, 21, 26, 30,
                                   34, 38, 43, 47, 51, 55, 60, 64};

static const uint8_t bc7_part2[64][16] = {
#define R2(a,b,c,d,e,f,g,h,i,j,k,l,m,n,o,p) {a,b,c,d,e,f,g,h,i,j,k,l,m,n,o,p},
R2(0,0,1,1,0,0,1,1,0,0,1,1,0,0,1,1) R2(0,0,0,1,0,0,0,1,0,0,0,1,0,0,0,1)
R2(0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1) R2(0,0,0,1,0,0,1,1,0,0,1,1,0,1,1,1)
R2(0,0,0,0,0,0,0,1,0,0,0,1,0,0,1,1) R2(0,0,1,1,0,1,1,1,0,1,1,1,1,1,1,1)
R2(0,0,0,1,0,0,1,1,0,1,1,1,1,1,1,1) R2(0,0,0,0,0,0,0,1,0,0,1,1,0,1,1,1)
R2(0,0,0,0,0,0,0,0,0,0,0,1,0,0,1,1) R2(0,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1)
R2(0,0,0,0,0,0,0,1,0,1,1,1,1,1,1,1) R2(0,0,0,0,0,0,0,0,0,0,0,1,0,1,1,1)
R2(0,0,0,1,0,1,1,1,1,1,1,1,1,1,1,1) R2(0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1)
R2(0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1) R2(0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1)
R2(0,0,0,0,1,0,0,0,1,1,1,0,1,1,1,1) R2(0,1,1,1,0,0,0,1,0,0,0,0,0,0,0,0)
R2(0,0,0,0,0,0,0,0,1,0,0,0,1,1,1,0) R2(0,1,1,1,0,0,1,1,0,0,0,1,0,0,0,0)
R2(0,0,1,1,0,0,0,1,0,0,0,0,0,0,0,0) R2(0,0,0,0,1,0,0,0,1,1,0,0,1,1,1,0)
R2(0,0,0,0,0,0,0,0,1,0,0,0,1,1,0,0) R2(0,1,1,1,0,0,1,1,0,0,1,1,0,0,0,1)
R2(0,0,1,1,0,0,0,1,0,0,0,1,0,0,0,0) R2(0,0,0,0,1,0,0,0,1,0,0,0,1,1,0,0)
R2(0,1,1,0,0,1,1,0,0,1,1,0,0,1,1,0) R2(0,0,1,1,0,1,1,0,0,1,1,0,1,1,0,0)
R2(0,0,0,1,0,1,1,1,1,1,1,0,1,0,0,0) R2(0,0,0,0,1,1,1,1,1,1,1,1,0,0,0,0)
R2(0,1,1,1,0,0,0,1,1,0,0,0,1,1,1,0) R2(0,0,1,1,1,0,0,1,1,0,0,1,1,1,0,0)
R2(0,1,0,1,0,1,0,1,0,1,0,1,0,1,0,1) R2(0,0,0,0,1,1,1,1,0,0,0,0,1,1,1,1)
R2(0,1,0,1,1,0,1,0,0,1,0,1,1,0,1,0) R2(0,0,1,1,0,0,1,1,1,1,0,0,1,1,0,0)
R2(0,0,1,1,1,1,0,0,0,0,1,1,1,1,0,0) R2(0,1,0,1,0,1,0,1,1,0,1,0,1,0,1,0)
R2(0,1,1,0,1,0,0,1,0,1,1,0,1,0,0,1) R2(0,1,0,1,1,0,1,0,1,0,1,0,0,1,0,1)
R2(0,1,1,1,0,0,1,1,1,1,0,0,1,1,1,0) R2(0,0,0,1,0,0,1,1,1,1,0,0,1,0,0,0)
R2(0,0,1,1,0,0,1,0,0,1,0,0,1,1,0,0) R2(0,0,1,1,1,0,1,1,1,1,0,1,1,1,0,0)
R2(0,1,1,0,1,0,0,1,1,0,0,1,0,1,1,0) R2(0,0,1,1,1,1,0,0,1,1,0,0,0,0,1,1)
R2(0,1,1,0,0,1,1,0,1,0,0,1,1,0,0,1) R2(0,0,0,0,0,1,1,0,0,1,1,0,0,0,0,0)
R2(0,1,0,0,1,1,1,0,0,1,0,0,0,0,0,0) R2(0,0,1,0,0,1,1,1,0,0,1,0,0,0,0,0)
R2(0,0,0,0,0,0,1,0,0,1,1,1,0,0,1,0) R2(0,0,0,0,0,1,0,0,1,1,1,0,0,1,0,0)
R2(0,1,1,0,1,1,0,0,1,0,0,1,0,0,1,1) R2(0,0,1,1,0,1,1,0,1,1,0,0,1,0,0,1)
R2(0,1,1,0,0,0,1,1,1,0,0,1,1,1,0,0) R2(0,0,1,1,1,0,0,1,1,1,0,0,0,1,1,0)
R2(0,1,1,0,1,1,0,0,1,1,0,0,1,0,0,1) R2(0,1,1,0,0,0,1,1,0,0,1,1,1,0,0,1)
R2(0,1,1,1,1,1,1,0,1,0,0,0,0,0,0,1) R2(0,0,0,1,1,0,0,0,1,1,1,0,0,1,1,1)
R2(0,0,0,0,1,1,1,1,0,0,1,1,0,0,1,1) R2(0,0,1,1,0,0,1,1,1,1,1,1,0,0,0,0)
R2(0,0,1,0,0,0,1,0,1,1,1,0,1,1,1,0) R2(0,1,0,0,0,1,0,0,0,1,1,1,0,1,1,1)
#undef R2
};

static const uint8_t bc7_part3[64][16] = {
#define R3(a,b,c,d,e,f,g,h,i,j,k,l,m,n,o,p) {a,b,c,d,e,f,g,h,i,j,k,l,m,n,o,p},
R3(0,0,1,1,0,0,1,1,0,2,2,1,2,2,2,2) R3(0,0,0,1,0,0,1,1,2,2,1,1,2,2,2,1)
R3(0,0,0,0,2,0,0,1,2,2,1,1,2,2,1,1) R3(0,2,2,2,0,0,2,2,0,0,1,1,0,1,1,1)
R3(0,0,0,0,0,0,0,0,1,1,2,2,1,1,2,2) R3(0,0,1,1,0,0,1,1,0,0,2,2,0,0,2,2)
R3(0,0,2,2,0,0,2,2,1,1,1,1,1,1,1,1) R3(0,0,1,1,0,0,1,1,2,2,1,1,2,2,1,1)
R3(0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2) R3(0,0,0,0,1,1,1,1,1,1,1,1,2,2,2,2)
R3(0,0,0,0,1,1,1,1,2,2,2,2,2,2,2,2) R3(0,0,1,2,0,0,1,2,0,0,1,2,0,0,1,2)
R3(0,1,1,2,0,1,1,2,0,1,1,2,0,1,1,2) R3(0,1,2,2,0,1,2,2,0,1,2,2,0,1,2,2)
R3(0,0,1,1,0,1,1,2,1,1,2,2,1,2,2,2) R3(0,0,1,1,2,0,0,1,2,2,0,0,2,2,2,0)
R3(0,0,0,1,0,0,1,1,0,1,1,2,1,1,2,2) R3(0,1,1,1,0,0,1,1,2,0,0,1,2,2,0,0)
R3(0,0,0,0,1,1,2,2,1,1,2,2,1,1,2,2) R3(0,0,2,2,0,0,2,2,0,0,2,2,1,1,1,1)
R3(0,1,1,1,0,1,1,1,0,2,2,2,0,2,2,2) R3(0,0,0,1,0,0,0,1,2,2,2,1,2,2,2,1)
R3(0,0,0,0,0,0,1,1,0,1,2,2,0,1,2,2) R3(0,0,0,0,1,1,0,0,2,2,1,0,2,2,1,0)
R3(0,1,2,2,0,1,2,2,0,0,1,1,0,0,0,0) R3(0,0,1,2,0,0,1,2,1,1,2,2,2,2,2,2)
R3(0,1,1,0,1,2,2,1,1,2,2,1,0,1,1,0) R3(0,0,0,0,0,1,1,0,1,2,2,1,1,2,2,1)
R3(0,0,2,2,1,1,0,2,1,1,0,2,0,0,2,2) R3(0,1,1,0,0,1,1,0,2,0,0,2,2,2,2,2)
R3(0,0,1,1,0,1,2,2,0,1,2,2,0,0,1,1) R3(0,0,0,0,2,0,0,0,2,2,1,1,2,2,2,1)
R3(0,0,0,0,0,0,0,2,1,1,2,2,1,2,2,2) R3(0,2,2,2,0,0,2,2,0,0,1,2,0,0,1,1)
R3(0,0,1,1,0,0,1,2,0,0,2,2,0,2,2,2) R3(0,1,2,0,0,1,2,0,0,1,2,0,0,1,2,0)
R3(0,0,0,0,1,1,1,1,2,2,2,2,0,0,0,0) R3(0,1,2,0,1,2,0,1,2,0,1,2,0,1,2,0)
R3(0,1,2,0,2,0,1,2,1,2,0,1,0,1,2,0) R3(0,0,1,1,2,2,0,0,1,1,2,2,0,0,1,1)
R3(0,0,1,1,1,1,2,2,2,2,0,0,0,0,1,1) R3(0,1,0,1,0,1,0,1,2,2,2,2,2,2,2,2)
R3(0,0,0,0,0,0,0,0,2,1,2,1,2,1,2,1) R3(0,0,2,2,1,1,2,2,0,0,2,2,1,1,2,2)
R3(0,0,2,2,0,0,1,1,0,0,2,2,0,0,1,1) R3(0,2,2,0,1,2,2,1,0,2,2,0,1,2,2,1)
R3(0,1,0,1,2,2,2,2,2,2,2,2,0,1,0,1) R3(0,0,0,0,2,1,2,1,2,1,2,1,2,1,2,1)
R3(0,1,0,1,0,1,0,1,0,1,0,1,2,2,2,2) R3(0,2,2,2,0,1,1,1,0,2,2,2,0,1,1,1)
R3(0,0,0,2,1,1,1,2,0,0,0,2,1,1,1,2) R3(0,0,0,0,2,1,1,2,2,1,1,2,2,1,1,2)
R3(0,2,2,2,0,1,1,1,0,1,1,1,0,2,2,2) R3(0,0,0,2,1,1,1,2,1,1,1,2,0,0,0,2)
R3(0,1,1,0,0,1,1,0,0,1,1,0,2,2,2,2) R3(0,0,0,0,0,0,0,0,2,1,1,2,2,1,1,2)
R3(0,1,1,0,0,1,1,0,2,2,2,2,2,2,2,2) R3(0,0,2,2,0,0,1,1,0,0,1,1,0,0,2,2)
R3(0,0,2,2,1,1,2,2,1,1,2,2,0,0,2,2) R3(0,0,0,0,0,0,0,0,0,0,0,0,2,1,1,2)
R3(0,0,0,2,0,0,0,1,0,0,0,2,0,0,0,1) R3(0,2,2,2,1,2,2,2,0,2,2,2,1,2,2,2)
R3(0,1,0,1,2,2,2,2,2,2,2,2,2,2,2,2) R3(0,1,1,1,2,0,1,1,2,2,0,1,2,2,2,0)
#undef R3
};

static const uint8_t bc7_anchor2[64] = {
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15,2,8,2,2,8,8,15,2,8,2,2,8,8,2,2,
    15,15,6,8,2,8,15,15,2,8,2,2,2,15,15,6,
    6,2,6,8,15,15,2,2,15,15,15,15,15,2,2,15};

static const uint8_t bc7_anchor3a[64] = {
    3,3,15,15,8,3,15,15,8,8,6,6,6,5,3,3,
    3,3,8,15,3,3,6,10,5,8,8,6,8,5,15,15,
    8,15,3,5,6,10,8,15,15,3,15,5,15,15,15,15,
    3,15,5,5,5,8,5,10,5,10,8,13,15,12,3,3};

static const uint8_t bc7_anchor3b[64] = {
    15,8,8,3,15,15,3,8,15,15,15,15,15,15,15,8,
    15,8,15,3,15,8,15,8,3,15,6,10,15,15,10,8,
    15,3,15,10,10,8,9,10,6,15,8,15,3,6,6,8,
    15,3,15,15,15,15,15,15,15,15,15,15,3,15,15,8};

struct Bc7BitReader {
    const uint8_t *p;
    int bit;
};

static inline uint32_t bc7_read(Bc7BitReader *r, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
        v |= (uint32_t)((r->p[r->bit >> 3] >> (r->bit & 7)) & 1) << i;
        r->bit++;
    }
    return v;
}

// Per-mode metadata: subsets, partition bits, rotation bits, index-
// selection bit, color bits, alpha bits, endpoint p-bits, shared p-bits,
// index bits, secondary index bits (D3D11.3 spec 19.5.14).
struct Bc7Mode {
    int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
static const Bc7Mode bc7_modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0},   // mode 0
    {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},   // mode 1
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0},   // mode 2
    {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},   // mode 3
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3},   // mode 4
    {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},   // mode 5
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0},   // mode 6
    {2, 6, 0, 0, 5, 5, 1, 0, 2, 0},   // mode 7
};

static inline int bc7_expand(int v, int bits) {
    v <<= (8 - bits);
    return v | (v >> bits);
}

static void decode_bc7_block(const uint8_t *b, uint8_t out[16][4]) {
    Bc7BitReader r = {b, 0};
    int mode = 0;
    while (mode < 8 && bc7_read(&r, 1) == 0) mode++;
    if (mode == 8) {
        for (int i = 0; i < 16; i++) {
            out[i][0] = out[i][1] = out[i][2] = 0;
            out[i][3] = 0;
        }
        return;
    }
    const Bc7Mode m = bc7_modes[mode];
    int partition = m.pb ? (int)bc7_read(&r, m.pb) : 0;
    int rotation = m.rb ? (int)bc7_read(&r, m.rb) : 0;
    int idx_sel = m.isb ? (int)bc7_read(&r, m.isb) : 0;
    int nep = m.ns * 2;
    int ep[6][4];
    for (int c = 0; c < 3; c++)
        for (int e = 0; e < nep; e++)
            ep[e][c] = (int)bc7_read(&r, m.cb);
    if (m.ab)
        for (int e = 0; e < nep; e++)
            ep[e][3] = (int)bc7_read(&r, m.ab);
    int pbits[6] = {0, 0, 0, 0, 0, 0};
    int has_p = 0;
    if (m.epb) {
        has_p = 1;
        for (int e = 0; e < nep; e++) pbits[e] = (int)bc7_read(&r, 1);
    } else if (m.spb) {
        has_p = 1;
        for (int s = 0; s < m.ns; s++) {
            int p = (int)bc7_read(&r, 1);
            pbits[2 * s] = pbits[2 * s + 1] = p;
        }
    }
    for (int e = 0; e < nep; e++) {
        int cb = m.cb + has_p;
        for (int c = 0; c < 3; c++)
            ep[e][c] = bc7_expand((ep[e][c] << has_p) | pbits[e], cb);
        if (m.ab) {
            int abts = m.ab + has_p;
            ep[e][3] = bc7_expand((ep[e][3] << has_p) | pbits[e], abts);
        } else {
            ep[e][3] = 255;
        }
    }
    // Index bit counts with anchor compression.
    int idx1[16], idx2[16];
    for (int px = 0; px < 16; px++) {
        int subset = 0;
        if (m.ns == 2) subset = bc7_part2[partition][px];
        else if (m.ns == 3) subset = bc7_part3[partition][px];
        int anchor = (px == 0);
        if (m.ns == 2 && px == bc7_anchor2[partition]) anchor = 1;
        if (m.ns == 3 && (px == bc7_anchor3a[partition] ||
                          px == bc7_anchor3b[partition])) anchor = 1;
        // anchors only apply to their own subset's first pixel; the
        // tables guarantee that, so the simple check suffices.
        idx1[px] = anchor ? -(m.ib) : m.ib;   // sign marks anchor
        (void)subset;
    }
    for (int px = 0; px < 16; px++) {
        int bits = idx1[px] < 0 ? -idx1[px] - 1 : idx1[px];
        idx1[px] = (int)bc7_read(&r, bits);
    }
    if (m.ib2) {
        for (int px = 0; px < 16; px++) {
            int bits = (px == 0) ? m.ib2 - 1 : m.ib2;
            idx2[px] = (int)bc7_read(&r, bits);
        }
    }
    for (int px = 0; px < 16; px++) {
        int subset = 0;
        if (m.ns == 2) subset = bc7_part2[partition][px];
        else if (m.ns == 3) subset = bc7_part3[partition][px];
        const int *e0 = ep[2 * subset];
        const int *e1 = ep[2 * subset + 1];
        int wc, wa;
        if (m.ib2) {
            int i1 = idx1[px], i2 = idx2[px];
            int w1 = (m.ib == 2) ? bc7_w2[i1] :
                     (m.ib == 3) ? bc7_w3[i1] : bc7_w4[i1];
            int w2 = (m.ib2 == 2) ? bc7_w2[i2] :
                     (m.ib2 == 3) ? bc7_w3[i2] : bc7_w4[i2];
            if (idx_sel) { wc = w2; wa = w1; }
            else { wc = w1; wa = w2; }
        } else {
            int i1 = idx1[px];
            wc = (m.ib == 2) ? bc7_w2[i1] :
                 (m.ib == 3) ? bc7_w3[i1] : bc7_w4[i1];
            wa = wc;
        }
        int px_out[4];
        for (int c = 0; c < 3; c++)
            px_out[c] = (e0[c] * (64 - wc) + e1[c] * wc + 32) >> 6;
        px_out[3] = (e0[3] * (64 - wa) + e1[3] * wa + 32) >> 6;
        if (rotation) {
            int tmp = px_out[3];
            px_out[3] = px_out[rotation - 1];
            px_out[rotation - 1] = tmp;
        }
        for (int c = 0; c < 4; c++) out[px][c] = (uint8_t)px_out[c];
    }
}

void decode_bc7(const uint8_t *src, uint8_t *dst, int width, int height) {
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; by++) {
        for (int bx = 0; bx < bw; bx++) {
            uint8_t px[16][4];
            decode_bc7_block(src + (by * bw + bx) * 16, px);
            for (int i = 0; i < 16; i++) {
                int x = bx * 4 + (i & 3);
                int y = by * 4 + (i >> 2);
                if (x >= width || y >= height) continue;
                uint8_t *o = dst + (y * width + x) * 4;
                for (int c = 0; c < 4; c++) o[c] = px[i][c];
            }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BC6H (HDR RGB half-float) decoder — reference parity target:
// vulkan/texture/texture_decoder.cpp:30-120 + assets/shaders/decode (the
// reference decodes BC6H via its compute path); bit layouts follow the
// D3D11.3 functional spec 19.5 (the same public tables every decoder
// ships).  Field names: [rgb][wxyz] = subset0 e0/e1, subset1 e0/e1.
// ---------------------------------------------------------------------------

extern "C" {

struct B6Reader { const uint8_t *p; int bit; };

static inline uint32_t b6(B6Reader *r, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
        v |= (uint32_t)((r->p[r->bit >> 3] >> (r->bit & 7)) & 1) << i;
        r->bit++;
    }
    return v;
}

static inline int b6_sext(int v, int bits) {
    return (v & (1 << (bits - 1))) ? v - (1 << bits) : v;
}

// Unquantize to the 17-bit intermediate (D3D11.3 19.5.7).
static int b6_unq_unsigned(int v, int bits) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xFFFF;
    return ((v << 15) + 0x4000) >> (bits - 1);
}

static int b6_unq_signed(int v, int bits) {
    if (bits >= 16) return v;
    int s = 0;
    if (v < 0) { v = -v; s = 1; }
    int out;
    if (v == 0) out = 0;
    else if (v >= (1 << (bits - 1)) - 1) out = 0x7FFF;
    else out = ((v << 15) + 0x4000) >> (bits - 1);
    return s ? -out : out;
}

static float b6_half_to_float(uint16_t h) {
    uint32_t sign = (uint32_t)(h >> 15) << 31;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {
            exp = 127 - 15 + 1;
            while (!(man & 0x400)) { man <<= 1; exp--; }
            man &= 0x3FF;
            bits = sign | (exp << 23) | (man << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float f;
    memcpy(&f, &bits, 4);
    return f;
}

// Decode one 128-bit block to 16 RGB float pixels.
static void decode_bc6h_block(const uint8_t *blk, float out[16][3],
                              int is_signed) {
    B6Reader r = {blk, 0};
    int e[4][3] = {};     // [w/x/y/z][r/g/b]
    int epb = 0, db[3] = {0, 0, 0};
    int transformed = 1, two = 1, bad = 0;
    int mode = (int)b6(&r, 2);
    if (mode >= 2) mode |= (int)b6(&r, 3) << 2;

#define RD(f, c, n, sh) e[f][c] |= (int)b6(&r, n) << (sh)
    switch (mode) {
    case 0x00:  // 10.555
        epb = 10; db[0] = db[1] = db[2] = 5;
        RD(2,1,1,4); RD(2,2,1,4); RD(3,2,1,4);
        RD(0,0,10,0); RD(0,1,10,0); RD(0,2,10,0);
        RD(1,0,5,0); RD(3,1,1,4); RD(2,1,4,0);
        RD(1,1,5,0); RD(3,2,1,0); RD(3,1,4,0);
        RD(1,2,5,0); RD(3,2,1,1); RD(2,2,4,0);
        RD(2,0,5,0); RD(3,2,1,2);
        RD(3,0,5,0); RD(3,2,1,3);
        break;
    case 0x01:  // 7.666
        epb = 7; db[0] = db[1] = db[2] = 6;
        RD(2,1,1,5); RD(3,1,1,4); RD(3,1,1,5);
        RD(0,0,7,0); RD(3,2,1,0); RD(3,2,1,1); RD(2,2,1,4);
        RD(0,1,7,0); RD(2,2,1,5); RD(3,2,1,2); RD(2,1,1,4);
        RD(0,2,7,0); RD(3,2,1,3); RD(3,2,1,5); RD(3,2,1,4);
        RD(1,0,6,0); RD(2,1,4,0);
        RD(1,1,6,0); RD(3,1,4,0);
        RD(1,2,6,0); RD(2,2,4,0);
        RD(2,0,6,0); RD(3,0,6,0);
        break;
    case 0x02:  // 11.544
        epb = 11; db[0] = 5; db[1] = 4; db[2] = 4;
        RD(0,0,10,0); RD(0,1,10,0); RD(0,2,10,0);
        RD(1,0,5,0); RD(0,0,1,10); RD(2,1,4,0);
        RD(1,1,4,0); RD(0,1,1,10); RD(3,2,1,0); RD(3,1,4,0);
        RD(1,2,4,0); RD(0,2,1,10); RD(3,2,1,1); RD(2,2,4,0);
        RD(2,0,5,0); RD(3,2,1,2);
        RD(3,0,5,0); RD(3,2,1,3);
        break;
    case 0x06:  // 11.454
        epb = 11; db[0] = 4; db[1] = 5; db[2] = 4;
        RD(0,0,10,0); RD(0,1,10,0); RD(0,2,10,0);
        RD(1,0,4,0); RD(0,0,1,10); RD(3,1,1,4); RD(2,1,4,0);
        RD(1,1,5,0); RD(0,1,1,10); RD(3,1,4,0);
        RD(1,2,4,0); RD(0,2,1,10); RD(3,2,1,1); RD(2,2,4,0);
        RD(2,0,4,0); RD(3,2,1,0); RD(3,2,1,2);
        RD(3,0,4,0); RD(2,1,1,4); RD(3,2,1,3);
        break;
    case 0x0A:  // 11.445
        epb = 11; db[0] = 4; db[1] = 4; db[2] = 5;
        RD(0,0,10,0); RD(0,1,10,0); RD(0,2,10,0);
        RD(1,0,4,0); RD(0,0,1,10); RD(2,2,1,4); RD(2,1,4,0);
        RD(1,1,4,0); RD(0,1,1,10); RD(3,1,1,4); RD(3,1,4,0);
        RD(1,2,5,0); RD(0,2,1,10); RD(2,2,4,0);
        RD(2,0,4,0); RD(3,2,1,0); RD(3,2,1,2);
        RD(3,0,4,0); RD(3,2,1,1); RD(3,2,1,3);
        break;
    case 0x0E:  // 9.555
        epb = 9; db[0] = db[1] = db[2] = 5;
        RD(0,0,9,0); RD(2,2,1,4);
        RD(0,1,9,0); RD(2,1,1,4);
        RD(0,2,9,0); RD(3,2,1,4);
        RD(1,0,5,0); RD(3,1,1,4); RD(2,1,4,0);
        RD(1,1,5,0); RD(3,2,1,0); RD(3,1,4,0);
        RD(1,2,5,0); RD(3,2,1,1); RD(2,2,4,0);
        RD(2,0,5,0); RD(3,2,1,2);
        RD(3,0,5,0); RD(3,2,1,3);
        break;
    case 0x12:  // 8.655
        epb = 8; db[0] = 6; db[1] = 5; db[2] = 5;
        RD(0,0,8,0); RD(3,1,1,4); RD(2,2,1,4);
        RD(0,1,8,0); RD(3,2,1,2); RD(2,1,1,4);
        RD(0,2,8,0); RD(3,2,1,3); RD(3,2,1,4);
        RD(1,0,6,0); RD(2,1,4,0);
        RD(1,1,5,0); RD(3,2,1,0); RD(3,1,4,0);
        RD(1,2,5,0); RD(3,2,1,1); RD(2,2,4,0);
        RD(2,0,6,0); RD(3,0,6,0);
        break;
    case 0x16:  // 8.565
        epb = 8; db[0] = 5; db[1] = 6; db[2] = 5;
        RD(0,0,8,0); RD(3,2,1,0); RD(2,2,1,4);
        RD(0,1,8,0); RD(2,1,1,5); RD(2,1,1,4);
        RD(0,2,8,0); RD(3,1,1,5); RD(3,2,1,4);
        RD(1,0,5,0); RD(3,1,1,4); RD(2,1,4,0);
        RD(1,1,6,0); RD(3,1,4,0);
        RD(1,2,5,0); RD(3,2,1,1); RD(2,2,4,0);
        RD(2,0,5,0); RD(3,2,1,2);
        RD(3,0,5,0); RD(3,2,1,3);
        break;
    case 0x1A:  // 8.556
        epb = 8; db[0] = 5; db[1] = 5; db[2] = 6;
        RD(0,0,8,0); RD(3,2,1,1); RD(2,2,1,4);
        RD(0,1,8,0); RD(2,2,1,5); RD(2,1,1,4);
        RD(0,2,8,0); RD(3,2,1,5); RD(3,2,1,4);
        RD(1,0,5,0); RD(3,1,1,4); RD(2,1,4,0);
        RD(1,1,5,0); RD(3,2,1,0); RD(3,1,4,0);
        RD(1,2,6,0); RD(2,2,4,0);
        RD(2,0,5,0); RD(3,2,1,2);
        RD(3,0,5,0); RD(3,2,1,3);
        break;
    case 0x1E:  // 6.666, untransformed
        epb = 6; db[0] = db[1] = db[2] = 6; transformed = 0;
        RD(0,0,6,0); RD(3,1,1,4); RD(3,2,1,0); RD(3,2,1,1); RD(2,2,1,4);
        RD(0,1,6,0); RD(2,1,1,5); RD(2,2,1,5); RD(3,2,1,2); RD(2,1,1,4);
        RD(0,2,6,0); RD(3,1,1,5); RD(3,2,1,3); RD(3,2,1,5); RD(3,2,1,4);
        RD(1,0,6,0); RD(2,1,4,0);
        RD(1,1,6,0); RD(3,1,4,0);
        RD(1,2,6,0); RD(2,2,4,0);
        RD(2,0,6,0); RD(3,0,6,0);
        break;
    case 0x03:  // 10.10 one subset, untransformed
        epb = 10; db[0] = db[1] = db[2] = 10; transformed = 0; two = 0;
        RD(0,0,10,0); RD(0,1,10,0); RD(0,2,10,0);
        RD(1,0,10,0); RD(1,1,10,0); RD(1,2,10,0);
        break;
    case 0x07:  // 11.9 one subset
        epb = 11; db[0] = db[1] = db[2] = 9; two = 0;
        RD(0,0,10,0); RD(0,1,10,0); RD(0,2,10,0);
        RD(1,0,9,0); RD(0,0,1,10);
        RD(1,1,9,0); RD(0,1,1,10);
        RD(1,2,9,0); RD(0,2,1,10);
        break;
    case 0x0B:  // 12.8 one subset (extension bits MSB-first)
        epb = 12; db[0] = db[1] = db[2] = 8; two = 0;
        RD(0,0,10,0); RD(0,1,10,0); RD(0,2,10,0);
        RD(1,0,8,0); RD(0,0,1,11); RD(0,0,1,10);
        RD(1,1,8,0); RD(0,1,1,11); RD(0,1,1,10);
        RD(1,2,8,0); RD(0,2,1,11); RD(0,2,1,10);
        break;
    case 0x0F:  // 16.4 one subset (extension bits MSB-first)
        epb = 16; db[0] = db[1] = db[2] = 4; two = 0;
        RD(0,0,10,0); RD(0,1,10,0); RD(0,2,10,0);
        RD(1,0,4,0); RD(0,0,1,15); RD(0,0,1,14); RD(0,0,1,13);
        RD(0,0,1,12); RD(0,0,1,11); RD(0,0,1,10);
        RD(1,1,4,0); RD(0,1,1,15); RD(0,1,1,14); RD(0,1,1,13);
        RD(0,1,1,12); RD(0,1,1,11); RD(0,1,1,10);
        RD(1,2,4,0); RD(0,2,1,15); RD(0,2,1,14); RD(0,2,1,13);
        RD(0,2,1,12); RD(0,2,1,11); RD(0,2,1,10);
        break;
    default:
        bad = 1;   // reserved mode: all-zero block (spec behavior)
        break;
    }
#undef RD
    if (bad) {
        for (int i = 0; i < 16; i++)
            out[i][0] = out[i][1] = out[i][2] = 0.0f;
        return;
    }

    int partition = two ? (int)b6(&r, 5) : 0;
    int nep = two ? 4 : 2;
    int mask = (1 << epb) - 1;
    for (int c = 0; c < 3; c++) {
        if (is_signed || transformed) {
            // Base always sign-extends in signed mode; deltas are
            // two's complement at their field width.
            if (is_signed) e[0][c] = b6_sext(e[0][c], epb);
            for (int k = 1; k < nep; k++) {
                if (transformed) {
                    int d = b6_sext(e[k][c], db[c]);
                    int v = (e[0][c] + d) & mask;
                    e[k][c] = is_signed ? b6_sext(v, epb) : v;
                } else if (is_signed) {
                    e[k][c] = b6_sext(e[k][c], db[c] == epb ? epb : db[c]);
                }
            }
        }
    }
    int unq[4][3];
    for (int k = 0; k < nep; k++)
        for (int c = 0; c < 3; c++)
            unq[k][c] = is_signed ? b6_unq_signed(e[k][c], epb)
                                  : b6_unq_unsigned(e[k][c], epb);

    int idx[16];
    int ib = two ? 3 : 4;
    for (int px = 0; px < 16; px++) {
        int anchor = (px == 0) ||
                     (two && px == bc7_anchor2[partition]);
        idx[px] = (int)b6(&r, anchor ? ib - 1 : ib);
    }
    for (int px = 0; px < 16; px++) {
        int subset = two ? bc7_part2[partition][px] : 0;
        const int *e0 = unq[2 * subset];
        const int *e1 = unq[2 * subset + 1];
        int wgt = two ? bc7_w3[idx[px]] : bc7_w4[idx[px]];
        for (int c = 0; c < 3; c++) {
            int interp = (e0[c] * (64 - wgt) + e1[c] * wgt + 32) >> 6;
            uint16_t half;
            if (is_signed) {
                int s = interp < 0;
                int v = (s ? -interp : interp) * 31 >> 5;
                half = (uint16_t)((s ? 0x8000 : 0) | v);
            } else {
                half = (uint16_t)((interp * 31) >> 6);
            }
            out[px][c] = b6_half_to_float(half);
        }
    }
}

void decode_bc6h(const uint8_t *src, float *dst, int width, int height,
                 int is_signed) {
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; by++) {
        for (int bx = 0; bx < bw; bx++) {
            float px[16][3];
            decode_bc6h_block(src + (by * bw + bx) * 16, px, is_signed);
            for (int i = 0; i < 16; i++) {
                int x = bx * 4 + (i & 3);
                int y = by * 4 + (i >> 2);
                if (x >= width || y >= height) continue;
                float *o = dst + (y * width + x) * 3;
                o[0] = px[i][0];
                o[1] = px[i][1];
                o[2] = px[i][2];
            }
        }
    }
}

}  // extern "C"

// ===========================================================================
// ASTC LDR decoder (all 2D block sizes 4x4..12x12).
//
// Implements the Khronos ASTC specification's decode procedure (the same
// algorithm the reference executes on the GPU in
// assets/shaders/decode/astc.comp with LUTs from
// vulkan/texture/texture_decoder.cpp:690 init_trits_quints etc.).  All
// constant tables below (trit/quint packings, unquantization A/B/C/D
// multipliers, the partition hash) are normative spec constants.
// HDR endpoint modes (2,3,7,11,14,15) decode to the error color in this
// LDR-profile decoder, as the spec allows; output is UNORM8 RGBA
// (decode_unorm8 extension semantics, which the engine's u8 texture path
// uses).
// ===========================================================================

namespace astc {

struct QuantMode { uint8_t bits, trits, quints; };

static inline int qm_range(const QuantMode &m) {
    int r = 1 << m.bits;
    if (m.trits) r *= 3;
    if (m.quints) r *= 5;
    return r == 1 ? 0 : r;
}

static inline int qm_cost_bits(const QuantMode &m, int n) {
    // total ISE bits for n values
    return m.bits * n + (m.quints * 7 * n + 2) / 3 + (m.trits * 8 * n + 4) / 5;
}

// Weight quantization per block-mode index R (spec weight range table).
static const QuantMode weight_modes[16] = {
    {0, 0, 0}, {0, 0, 0},              // invalid
    {1, 0, 0}, {0, 1, 0}, {2, 0, 0}, {0, 0, 1}, {1, 1, 0}, {3, 0, 0},
    {0, 0, 0}, {0, 0, 0},              // invalid
    {1, 0, 1}, {2, 1, 0}, {4, 0, 0}, {2, 0, 1}, {3, 1, 0}, {5, 0, 0},
};

// Endpoint quantization candidates, largest range first (the decoder
// picks the largest whose ISE cost fits the remaining bits).
static const QuantMode color_modes[17] = {
    {8, 0, 0}, {6, 1, 0}, {5, 0, 1}, {7, 0, 0}, {5, 1, 0}, {4, 0, 1},
    {6, 0, 0}, {4, 1, 0}, {3, 0, 1}, {5, 0, 0}, {3, 1, 0}, {2, 0, 1},
    {4, 0, 0}, {2, 1, 0}, {1, 0, 1}, {3, 0, 0}, {1, 1, 0},
};

// --- spec trit/quint block decode (C.2.12) --------------------------------
static uint16_t trit_table[256];
static uint16_t quint_table[128];
static bool tables_ready = false;

static void build_integer_tables() {
    for (unsigned T = 0; T < 256; T++) {
        unsigned C;
        unsigned t0, t1, t2, t3, t4;
        if (((T >> 2) & 7) == 7) {
            C = (((T >> 5) & 7) << 2) | (T & 3);
            t4 = t3 = 2;
        } else {
            C = T & 0x1f;
            if (((T >> 5) & 3) == 3) { t4 = 2; t3 = (T >> 7) & 1; }
            else { t4 = (T >> 7) & 1; t3 = (T >> 5) & 3; }
        }
        if ((C & 3) == 3) {
            t2 = 2;
            t1 = (C >> 4) & 1;
            unsigned c3 = (C >> 3) & 1, c2 = (C >> 2) & 1;
            t0 = (c3 << 1) | (c2 & ~c3 & 1);
        } else if (((C >> 2) & 3) == 3) {
            t2 = 2; t1 = 2; t0 = C & 3;
        } else {
            t2 = (C >> 4) & 1;
            t1 = (C >> 2) & 3;
            unsigned c1 = (C >> 1) & 1, c0 = C & 1;
            t0 = (c1 << 1) | (c0 & ~c1 & 1);
        }
        trit_table[T] = (uint16_t)(t0 | (t1 << 3) | (t2 << 6) |
                                   (t3 << 9) | (t4 << 12));
    }
    for (unsigned Q = 0; Q < 128; Q++) {
        unsigned C;
        unsigned q0, q1, q2;
        if (((Q >> 1) & 3) == 3 && ((Q >> 5) & 3) == 0) {
            unsigned q0b = Q & 1, q4 = (Q >> 4) & 1, q3 = (Q >> 3) & 1;
            q2 = (q0b << 2) | (((q4 & ~q0b) & 1) << 1) | ((q3 & ~q0b) & 1);
            q1 = q0 = 4;
        } else {
            if (((Q >> 1) & 3) == 3) {
                q2 = 4;
                C = (((Q >> 3) & 3) << 3) | (((~(Q >> 5)) & 3) << 1) |
                    (Q & 1);
            } else {
                q2 = (Q >> 5) & 3;
                C = Q & 0x1f;
            }
            if ((C & 7) == 5) { q1 = 4; q0 = (C >> 3) & 3; }
            else { q1 = (C >> 3) & 3; q0 = C & 7; }
        }
        quint_table[Q] = (uint16_t)(q0 | (q1 << 3) | (q2 << 6));
    }
    tables_ready = true;
}

// --- 128-bit block bit access ---------------------------------------------
struct Block {
    uint8_t b[16];
    int get(int pos, int n) const {
        // little-endian bit numbering across the 16 bytes
        unsigned v = 0;
        for (int i = 0; i < n; i++) {
            int p = pos + i;
            if (p < 0 || p >= 128) continue;
            v |= (unsigned)((b[p >> 3] >> (p & 7)) & 1) << i;
        }
        return (int)v;
    }
    int get_rev(int pos_from_top, int n) const {
        // n bits ending at bit 127 - pos_from_top, reversed order
        // (weights are stored from the top of the block, bit-reversed)
        unsigned v = 0;
        for (int i = 0; i < n; i++) {
            int p = 127 - (pos_from_top + i);
            if (p < 0 || p >= 128) continue;
            v |= (unsigned)((b[p >> 3] >> (p & 7)) & 1) << i;
        }
        return (int)v;
    }
};

// ISE decode of value `index` from a bit-reversed-at-top stream is
// handled by pre-extracting the weight stream into a forward buffer;
// endpoints read forward from the block directly.
struct BitSource {
    const uint8_t *bits;     // packed LSB-first
    int base;                // start bit
    int limit;               // one past last valid bit (reads beyond = 0)
    int get(int pos, int n) const {
        unsigned v = 0;
        for (int i = 0; i < n; i++) {
            int p = base + pos + i;
            if (p >= limit) continue;
            v |= (unsigned)((bits[p >> 3] >> (p & 7)) & 1) << i;
        }
        return (int)v;
    }
};

static int ise_decode(const BitSource &src, int index, const QuantMode &q) {
    if (q.trits) {
        int block = index / 5;
        int off = index - block * 5;
        int sb = block * (5 * q.bits + 8);
        int T = src.get(sb + q.bits * 1 + 0, 2) |
                (src.get(sb + q.bits * 2 + 2, 2) << 2) |
                (src.get(sb + q.bits * 3 + 4, 1) << 4) |
                (src.get(sb + q.bits * 4 + 5, 2) << 5) |
                (src.get(sb + q.bits * 5 + 7, 1) << 7);
        int t = (trit_table[T] >> (3 * off)) & 7;
        if (!q.bits) return t;
        int m_off = off * q.bits + (off * 8 + 4) / 5;
        int m = src.get(sb + m_off, q.bits);
        return (t << q.bits) | m;
    }
    if (q.quints) {
        int block = index / 3;
        int off = index - block * 3;
        int sb = block * (3 * q.bits + 7);
        int Q = src.get(sb + q.bits * 1 + 0, 3) |
                (src.get(sb + q.bits * 2 + 3, 2) << 3) |
                (src.get(sb + q.bits * 3 + 5, 2) << 5);
        int qd = (quint_table[Q] >> (3 * off)) & 7;
        if (!q.bits) return qd;
        int m_off = off * q.bits + (off * 7 + 2) / 3;
        int m = src.get(sb + m_off, q.bits);
        return (qd << q.bits) | m;
    }
    return src.get(index * q.bits, q.bits);
}

// --- unquantization (spec C.2.13/C.2.17) ----------------------------------
static int unquant_weight(int v, const QuantMode &m) {
    int out;
    if (!m.trits && !m.quints) {
        switch (m.bits) {
        case 1: out = v * 63; break;
        case 2: out = v * 0x15; break;
        case 3: out = v * 9; break;
        case 4: out = (v << 2) | (v >> 2); break;
        case 5: out = (v << 1) | (v >> 4); break;
        default: out = 0; break;
        }
    } else if (m.bits == 0) {
        out = m.trits ? 32 * v : 16 * v;
    } else {
        int b = (v >> 1) & 1, c = (v >> 2) & 1;
        int A = 0x7f * (v & 1);
        int D = v >> m.bits;
        int B = 0, C;
        if (m.trits) {
            static const int Cs[3] = {50, 23, 11};
            C = Cs[m.bits - 1];
            if (m.bits == 2) B = 0x45 * b;
            else if (m.bits == 3) B = 0x21 * b + 0x42 * c;
        } else {
            static const int Cs[2] = {28, 13};
            C = Cs[m.bits - 1];
            if (m.bits == 2) B = 0x42 * b;
        }
        int unq = (D * C + B) ^ A;
        out = (A & 0x20) | (unq >> 2);
    }
    if (m.bits != 0 && out > 32) out++;     // expand [0,63] -> [0,64]
    return out;
}

static int unquant_endpoint(int v, const QuantMode &m) {
    if (!m.trits && !m.quints) {
        switch (m.bits) {
        case 1: return v * 0xff;
        case 2: return v * 0x55;
        case 3: return (v << 5) | (v << 2) | (v >> 1);
        case 4: return v * 0x11;
        case 5: return (v << 3) | (v >> 2);
        case 6: return (v << 2) | (v >> 4);
        case 7: return (v << 1) | (v >> 6);
        default: return v;
        }
    }
    int b = (v >> 1) & 1, c = (v >> 2) & 1, d = (v >> 3) & 1;
    int e = (v >> 4) & 1, f = (v >> 5) & 1;
    int A = (v & 1) * 0x1ff;
    int D = v >> m.bits;
    int B = 0, C;
    if (m.trits) {
        static const int Cs[6] = {204, 93, 44, 22, 11, 5};
        C = Cs[m.bits - 1];
        switch (m.bits) {
        case 2: B = b * 0x116; break;
        case 3: B = b * 0x85 + c * 0x10a; break;
        case 4: B = b * 0x41 + c * 0x82 + d * 0x104; break;
        case 5: B = b * 0x20 + c * 0x40 + d * 0x81 + e * 0x102; break;
        case 6: B = b * 0x10 + c * 0x20 + d * 0x40 + e * 0x80 + f * 0x101;
            break;
        }
    } else {
        static const int Cs[5] = {113, 54, 26, 13, 6};
        C = Cs[m.bits - 1];
        switch (m.bits) {
        case 2: B = b * 0x10c; break;
        case 3: B = b * 0x82 + c * 0x105; break;
        case 4: B = b * 0x40 + c * 0x81 + d * 0x102; break;
        case 5: B = b * 0x20 + c * 0x40 + d * 0x80 + e * 0x101; break;
        }
    }
    int unq = (D * C + B) ^ A;
    return (A & 0x80) | (unq >> 2);
}

// --- partition hash (spec C.2.21) -----------------------------------------
static uint32_t hash52(uint32_t p) {
    p ^= p >> 15; p -= p << 17; p += p << 7; p += p << 4;
    p ^= p >> 5;  p += p << 16; p ^= p >> 7; p ^= p >> 3;
    p ^= p << 6;  p ^= p >> 17;
    return p;
}

static int select_partition(int seed, int x, int y, int count,
                            bool small_block) {
    if (small_block) { x <<= 1; y <<= 1; }
    seed += (count - 1) * 1024;
    uint32_t rnum = hash52((uint32_t)seed);
    int s[8];
    for (int i = 0; i < 8; i++) {
        int v = (int)((rnum >> (4 * i)) & 0xF);
        s[i] = v * v;
    }
    int sh1, sh2;
    if (seed & 1) { sh1 = (seed & 2) ? 4 : 5; sh2 = (count == 3) ? 6 : 5; }
    else { sh1 = (count == 3) ? 6 : 5; sh2 = (seed & 2) ? 4 : 5; }
    for (int i = 0; i < 8; i++) s[i] >>= (i & 1) ? sh2 : sh1;
    int a = (s[0] * x + s[1] * y + (int)(rnum >> 14)) & 0x3f;
    int b2 = (s[2] * x + s[3] * y + (int)(rnum >> 10)) & 0x3f;
    int c2 = (s[4] * x + s[5] * y + (int)(rnum >> 6)) & 0x3f;
    int d2 = (s[6] * x + s[7] * y + (int)(rnum >> 2)) & 0x3f;
    if (count < 4) d2 = 0;
    if (count < 3) c2 = 0;
    if (a >= b2 && a >= c2 && a >= d2) return 0;
    if (b2 >= c2 && b2 >= d2) return 1;
    if (c2 >= d2) return 2;
    return 3;
}

}  // namespace astc

namespace astc {

struct BlockInfo {
    int grid_w, grid_h;
    int weight_mode;
    int num_parts;
    int seed;
    int cem;
    int config_bits;          // incl. extra CEM + CCS
    int primary_config_bits;  // endpoint stream start
    bool dual_plane;
    bool void_extent;
    bool error;
};

static BlockInfo decode_block_info(const Block &blk) {
    BlockInfo bi = {};
    uint32_t lo = (uint32_t)blk.get(0, 16);
    bi.void_extent = (lo & 0x1ff) == 0x1fc;
    if (bi.void_extent) return bi;

    bi.dual_plane = (lo >> 10) & 1;
    uint32_t hi2 = (lo >> 2) & 3;

    if ((lo & 3) != 0) {
        bi.weight_mode = (int)(((lo >> 4) & 1) | ((lo << 1) & 6) |
                               ((lo >> 6) & 8));
        int A = (int)((lo >> 5) & 3);
        int Bv = (int)((lo >> 7) & 3);
        if (hi2 < 2) {
            bi.grid_w = Bv + 4 + 4 * (int)hi2;
            bi.grid_h = A + 2;
        } else if (hi2 == 2) {
            bi.grid_w = A + 2;
            bi.grid_h = Bv + 8;
        } else {
            if (lo & 0x100) { bi.grid_w = ((lo >> 7) & 1) + 2; bi.grid_h = A + 2; }
            else { bi.grid_w = A + 2; bi.grid_h = ((lo >> 7) & 1) + 6; }
        }
    } else {
        int p3 = (int)((lo >> 9) & 1);
        int hi = (int)((lo >> 7) & 3);
        int lo2 = (int)((lo >> 5) & 3);
        if (hi == 0) { bi.grid_w = 12; bi.grid_h = lo2 + 2; }
        else if (hi == 1) { bi.grid_w = lo2 + 2; bi.grid_h = 12; }
        else if (hi == 2) {
            bi.dual_plane = false;
            p3 = 0;
            bi.grid_w = lo2 + 6;
            bi.grid_h = (int)((lo >> 9) & 3) + 6;
        } else {
            if (lo2 == 0) { bi.grid_w = 6; bi.grid_h = 10; }
            else if (lo2 == 1) { bi.grid_w = 10; bi.grid_h = 6; }
            else { bi.error = true; return bi; }
        }
        bi.weight_mode = (int)(((lo >> 4) & 1) | ((lo >> 1) & 2) |
                               ((lo >> 1) & 4)) + (p3 << 3);
    }

    bi.num_parts = blk.get(11, 2) + 1;
    if (bi.num_parts > 1) {
        bi.seed = blk.get(13, 10);
        bi.cem = blk.get(23, 6);
    } else {
        bi.cem = blk.get(13, 4);
    }

    int config;
    if (bi.num_parts > 1) {
        bool single = (bi.cem & 3) == 0;
        config = single ? 29 : (25 + 3 * bi.num_parts);
        bi.primary_config_bits = 29;
    } else {
        config = 17;
        bi.primary_config_bits = 17;
    }
    if (bi.dual_plane) config += 2;
    bi.config_bits = config;

    if (bi.dual_plane && bi.num_parts > 3) bi.error = true;
    return bi;
}

static inline void bit_transfer_signed(int &a, int &b) {
    b >>= 1;
    b |= a & 0x80;
    a >>= 1;
    a &= 0x3f;
    if (a & 0x20) a -= 0x40;         // sign-extend 6 bits
}

static inline void blue_contract(int r, int g, int b, int a, int out[4]) {
    out[0] = (r + b) >> 1;
    out[1] = (g + b) >> 1;
    out[2] = b;
    out[3] = a;
}

static inline int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// Returns false for HDR modes (LDR-profile error).
static bool decode_endpoints_ldr(int cem, const int *v, int ep0[4],
                                 int ep1[4]) {
    switch (cem) {
    case 0:
        ep0[0] = ep0[1] = ep0[2] = v[0]; ep0[3] = 0xff;
        ep1[0] = ep1[1] = ep1[2] = v[1]; ep1[3] = 0xff;
        return true;
    case 1: {
        int l0 = (v[0] >> 2) | (v[1] & 0xc0);
        int l1 = l0 + (v[1] & 0x3f);
        if (l1 > 0xff) l1 = 0xff;
        ep0[0] = ep0[1] = ep0[2] = l0; ep0[3] = 0xff;
        ep1[0] = ep1[1] = ep1[2] = l1; ep1[3] = 0xff;
        return true;
    }
    case 4:
        ep0[0] = ep0[1] = ep0[2] = v[0]; ep0[3] = v[2];
        ep1[0] = ep1[1] = ep1[2] = v[1]; ep1[3] = v[3];
        return true;
    case 5: {
        int v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3];
        bit_transfer_signed(v1, v0);
        bit_transfer_signed(v3, v2);
        ep0[0] = ep0[1] = ep0[2] = clamp255(v0); ep0[3] = clamp255(v2);
        int l1 = clamp255(v0 + v1);
        ep1[0] = ep1[1] = ep1[2] = l1; ep1[3] = clamp255(v2 + v3);
        return true;
    }
    case 6:
        for (int i = 0; i < 3; i++) ep0[i] = (v[i] * v[3]) >> 8;
        ep0[3] = 0xff;
        ep1[0] = v[0]; ep1[1] = v[1]; ep1[2] = v[2]; ep1[3] = 0xff;
        return true;
    case 8: {
        int s0 = v[0] + v[2] + v[4], s1 = v[1] + v[3] + v[5];
        if (s1 >= s0) {
            ep0[0] = v[0]; ep0[1] = v[2]; ep0[2] = v[4]; ep0[3] = 0xff;
            ep1[0] = v[1]; ep1[1] = v[3]; ep1[2] = v[5]; ep1[3] = 0xff;
        } else {
            blue_contract(v[1], v[3], v[5], 0xff, ep0);
            blue_contract(v[0], v[2], v[4], 0xff, ep1);
        }
        return true;
    }
    case 9: {
        int v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3], v4 = v[4],
            v5 = v[5];
        bit_transfer_signed(v1, v0);
        bit_transfer_signed(v3, v2);
        bit_transfer_signed(v5, v4);
        if (v1 + v3 + v5 >= 0) {
            ep0[0] = v0; ep0[1] = v2; ep0[2] = v4; ep0[3] = 0xff;
            ep1[0] = v0 + v1; ep1[1] = v2 + v3; ep1[2] = v4 + v5;
            ep1[3] = 0xff;
        } else {
            blue_contract(v0 + v1, v2 + v3, v4 + v5, 0xff, ep0);
            blue_contract(v0, v2, v4, 0xff, ep1);
        }
        for (int i = 0; i < 3; i++) {
            ep0[i] = clamp255(ep0[i]);
            ep1[i] = clamp255(ep1[i]);
        }
        return true;
    }
    case 10:
        for (int i = 0; i < 3; i++) ep0[i] = (v[i] * v[3]) >> 8;
        ep0[3] = v[4];
        ep1[0] = v[0]; ep1[1] = v[1]; ep1[2] = v[2]; ep1[3] = v[5];
        return true;
    case 12: {
        int s0 = v[0] + v[2] + v[4], s1 = v[1] + v[3] + v[5];
        if (s1 >= s0) {
            ep0[0] = v[0]; ep0[1] = v[2]; ep0[2] = v[4]; ep0[3] = v[6];
            ep1[0] = v[1]; ep1[1] = v[3]; ep1[2] = v[5]; ep1[3] = v[7];
        } else {
            blue_contract(v[1], v[3], v[5], v[7], ep0);
            blue_contract(v[0], v[2], v[4], v[6], ep1);
        }
        return true;
    }
    case 13: {
        int v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3], v4 = v[4],
            v5 = v[5], v6 = v[6], v7 = v[7];
        bit_transfer_signed(v1, v0);
        bit_transfer_signed(v3, v2);
        bit_transfer_signed(v5, v4);
        bit_transfer_signed(v7, v6);
        if (v1 + v3 + v5 >= 0) {
            ep0[0] = v0; ep0[1] = v2; ep0[2] = v4; ep0[3] = v6;
            ep1[0] = v0 + v1; ep1[1] = v2 + v3; ep1[2] = v4 + v5;
            ep1[3] = v6 + v7;
        } else {
            blue_contract(v0 + v1, v2 + v3, v4 + v5, v6 + v7, ep0);
            blue_contract(v0, v2, v4, v6, ep1);
        }
        for (int i = 0; i < 4; i++) {
            ep0[i] = clamp255(ep0[i]);
            ep1[i] = clamp255(ep1[i]);
        }
        return true;
    }
    default:
        return false;                 // HDR modes: LDR-profile error
    }
}

}  // namespace astc

namespace astc {

static void emit_error(uint8_t *px) {
    px[0] = 0xff; px[1] = 0; px[2] = 0xff; px[3] = 0xff;
}

// Decode one block into dst (bw*bh RGBA8 texels, row stride = bw*4).
static void decode_block(const uint8_t *src, uint8_t *dst, int bw, int bh) {
    Block blk;
    for (int i = 0; i < 16; i++) blk.b[i] = src[i];
    const int n_px = bw * bh;

    BlockInfo bi = decode_block_info(blk);

    if (bi.void_extent) {
        bool hdr = (blk.get(9, 1) != 0);
        bool bad = blk.get(10, 2) != 3;
        int mins = blk.get(12, 13), maxs = blk.get(25, 13);
        int mint = blk.get(38, 13), maxt = blk.get(51, 13);
        bool all1 = mins == 0x1fff && maxs == 0x1fff &&
                    mint == 0x1fff && maxt == 0x1fff;
        if (!all1 && (mins >= maxs || mint >= maxt)) bad = true;
        if (hdr || bad) {
            for (int i = 0; i < n_px; i++) emit_error(dst + 4 * i);
            return;
        }
        uint8_t c[4];
        for (int ch = 0; ch < 4; ch++)
            c[ch] = (uint8_t)(blk.get(64 + 16 * ch, 16) >> 8);
        for (int i = 0; i < n_px; i++)
            for (int ch = 0; ch < 4; ch++) dst[4 * i + ch] = c[ch];
        return;
    }

    const QuantMode &wq = weight_modes[bi.weight_mode];
    int num_weights = bi.grid_w * bi.grid_h << (bi.dual_plane ? 1 : 0);
    int weight_cost = qm_cost_bits(wq, num_weights);
    bool err = bi.error || (wq.bits == 0 && !wq.trits && !wq.quints) ||
               weight_cost < 24 || weight_cost > 96 || num_weights > 64 ||
               bi.grid_w > bw || bi.grid_h > bh;

    int available = 128 - bi.config_bits - weight_cost;
    bool single_cem = (bi.cem & 3) == 0;
    int num_pairs;
    if (bi.num_parts > 1) {
        if (single_cem) {
            num_pairs = (((bi.cem >> 2) >> 2) + 1) * bi.num_parts;
        } else {
            int pc = 0;
            for (int p = 0; p < bi.num_parts; p++)
                pc += (bi.cem >> (2 + p)) & 1;
            num_pairs = (bi.cem & 3) * bi.num_parts + pc;
        }
    } else {
        num_pairs = (bi.cem >> 2) + 1;
    }
    if (num_pairs > 9 || available < 0) err = true;

    const QuantMode *eq = nullptr;
    if (!err) {
        for (const auto &m : color_modes) {
            if (qm_cost_bits(m, num_pairs * 2) <= available) {
                eq = &m;
                break;
            }
        }
        if (!eq) err = true;
    }
    if (err) {
        for (int i = 0; i < n_px; i++) emit_error(dst + 4 * i);
        return;
    }

    // Weight stream: bit-reversed from the top of the block.
    uint8_t rev[16] = {};
    for (int i = 0; i < 128; i++) {
        int p = 127 - i;
        int bit = (blk.b[p >> 3] >> (p & 7)) & 1;
        rev[i >> 3] |= bit << (i & 7);
    }
    BitSource wsrc = {rev, 0, weight_cost};

    int extra_cem_bits = 0;
    if (bi.num_parts > 1 && !single_cem)
        extra_cem_bits = bi.num_parts * 3 - 4;

    int ccs = 0;
    if (bi.dual_plane)
        ccs = blk.get(126 - weight_cost - extra_cem_bits, 2);

    int extra_cem = extra_cem_bits
        ? blk.get(128 - weight_cost - extra_cem_bits, extra_cem_bits) : 0;

    int ep_cost = qm_cost_bits(*eq, num_pairs * 2);
    BitSource esrc = {blk.b, bi.primary_config_bits,
                      bi.primary_config_bits + ep_cost};

    // Per-partition endpoints.
    int ep0[4][4], ep1[4][4];
    bool part_ok[4];
    for (int p = 0; p < bi.num_parts; p++) {
        int cem_p, base;
        if (bi.num_parts > 1) {
            if (single_cem) {
                cem_p = bi.cem >> 2;
                base = ((cem_p >> 2) + 1) * p * 2;
            } else {
                int pc = 0;
                for (int q = 0; q < p; q++) pc += (bi.cem >> (2 + q)) & 1;
                base = ((bi.cem & 3) * p + pc) * 2;
                int base_class = (bi.cem & 3) - 1;
                int full = (extra_cem << 4) | (bi.cem >> 2);
                int class_off = (full >> p) & 1;
                int ep_bits = (full >> (bi.num_parts + 2 * p)) & 3;
                cem_p = 4 * (base_class + class_off) + ep_bits;
            }
        } else {
            cem_p = bi.cem;
            base = 0;
        }
        int nvals = 2 * ((cem_p >> 2) + 1);
        int v[8] = {};
        for (int i = 0; i < nvals && i < 8; i++)
            v[i] = unquant_endpoint(ise_decode(esrc, base + i, *eq), *eq);
        part_ok[p] = decode_endpoints_ldr(cem_p, v, ep0[p], ep1[p]);
    }

    bool small_block = n_px < 31;
    int Dx = (1024 + bw / 2) / (bw - 1);
    int Dy = (1024 + bh / 2) / (bh - 1);

    for (int y = 0; y < bh; y++) {
        for (int x = 0; x < bw; x++) {
            uint8_t *px = dst + 4 * (y * bw + x);
            int part = bi.num_parts > 1
                ? select_partition(bi.seed, x, y, bi.num_parts,
                                   small_block) : 0;
            if (!part_ok[part]) { emit_error(px); continue; }

            int fx = (Dx * x * (bi.grid_w - 1) + 32) >> 6;
            int fy = (Dy * y * (bi.grid_h - 1) + 32) >> 6;
            int wx = fx >> 4, frx = fx & 0xf;
            int wy = fy >> 4, fry = fy & 0xf;
            int stride = bi.dual_plane ? 2 : 1;

            int w[2];
            int n_planes = bi.dual_plane ? 2 : 1;
            for (int plane = 0; plane < n_planes; plane++) {
                int idx = wy * bi.grid_w + wx;
                auto fetch = [&](int i) {
                    return unquant_weight(
                        ise_decode(wsrc, stride * i + plane, wq), wq);
                };
                int p00 = fetch(idx);
                int p10 = frx ? fetch(idx + 1) : p00;
                int p01 = fry ? fetch(idx + bi.grid_w) : p00;
                int p11 = fry ? (frx ? fetch(idx + bi.grid_w + 1) : p01)
                              : p10;
                int w11 = (frx * fry + 8) >> 4;
                int w10 = frx - w11;
                int w01 = fry - w11;
                int w00 = 16 - frx - fry + w11;
                w[plane] =
                    (p00 * w00 + p10 * w10 + p01 * w01 + p11 * w11 + 8)
                    >> 4;
            }

            for (int ch = 0; ch < 4; ch++) {
                int wt = (bi.dual_plane && ch == ccs) ? w[1] : w[0];
                int e0 = ep0[part][ch] * 0x101;
                int e1 = ep1[part][ch] * 0x101;
                int c = (e0 * (64 - wt) + e1 * wt + 32) >> 6;
                px[ch] = (uint8_t)(c >> 8);
            }
        }
    }
}

}  // namespace astc

extern "C" {

// ASTC LDR -> RGBA8.  block_w/block_h: 4..12 (any legal 2D footprint).
void decode_astc(const uint8_t *src, uint8_t *dst, int width, int height,
                 int block_w, int block_h) {
    if (!astc::tables_ready) astc::build_integer_tables();
    int bx = (width + block_w - 1) / block_w;
    int by = (height + block_h - 1) / block_h;
    std::vector<uint8_t> tmp(block_w * block_h * 4);
    for (int j = 0; j < by; j++) {
        for (int i = 0; i < bx; i++) {
            astc::decode_block(src + (j * bx + i) * 16, tmp.data(),
                               block_w, block_h);
            for (int y = 0; y < block_h; y++) {
                int py = j * block_h + y;
                if (py >= height) break;
                for (int x = 0; x < block_w; x++) {
                    int pxx = i * block_w + x;
                    if (pxx >= width) break;
                    const uint8_t *s = tmp.data() + 4 * (y * block_w + x);
                    uint8_t *d = dst + 4 * (py * width + pxx);
                    d[0] = s[0]; d[1] = s[1]; d[2] = s[2]; d[3] = s[3];
                }
            }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BC7 / BC6H encoders (scene-export/texture_compression.cpp dispatches
// these formats to external encoder libraries; here they are fresh
// single-mode encoders against the D3D11.3 spec layouts, decodable by
// the decoders above):
//   * BC7  mode 6 (1 subset, 7.7 color+alpha endpoints + per-endpoint
//     p-bit, 4-bit indices) — every RGBA block is representable;
//   * BC6H mode 3 (10.10 one subset, untransformed, 4-bit indices),
//     unsigned (UF16) — the HDR environment-map path.
// Endpoints come from a principal-axis fit (power iteration on the
// block covariance), indices from projection onto the endpoint segment.
// ---------------------------------------------------------------------------

namespace enc {

struct BitWriter {
    uint8_t *p;
    int bit;
    void put(uint32_t v, int n) {
        for (int i = 0; i < n; i++) {
            if ((v >> i) & 1) p[bit >> 3] |= (uint8_t)(1 << (bit & 7));
            bit++;
        }
    }
};

// Principal axis of 16 k-dim points via 8 power iterations; falls back
// to the per-channel range diagonal for near-constant blocks.
static void principal_axis(const float pts[16][4], int k, float mean[4],
                           float axis[4]) {
    for (int c = 0; c < k; c++) mean[c] = 0.0f;
    for (int i = 0; i < 16; i++)
        for (int c = 0; c < k; c++) mean[c] += pts[i][c];
    for (int c = 0; c < k; c++) mean[c] /= 16.0f;
    float cov[4][4] = {};
    for (int i = 0; i < 16; i++)
        for (int a = 0; a < k; a++)
            for (int b = 0; b < k; b++)
                cov[a][b] += (pts[i][a] - mean[a]) * (pts[i][b] - mean[b]);
    for (int c = 0; c < k; c++) axis[c] = 1.0f;
    for (int it = 0; it < 8; it++) {
        float nxt[4] = {};
        for (int a = 0; a < k; a++)
            for (int b = 0; b < k; b++)
                nxt[a] += cov[a][b] * axis[b];
        float n2 = 0.0f;
        for (int c = 0; c < k; c++) n2 += nxt[c] * nxt[c];
        if (n2 < 1e-12f) break;
        float inv = 1.0f / std::sqrt(n2);
        for (int c = 0; c < k; c++) axis[c] = nxt[c] * inv;
    }
    float n2 = 0.0f;
    for (int c = 0; c < k; c++) n2 += axis[c] * axis[c];
    if (n2 < 0.5f) {           // degenerate (flat block): unit diagonal
        float inv = 1.0f / std::sqrt((float)k);
        for (int c = 0; c < k; c++) axis[c] = inv;
    }
}

// Project points on the axis, return endpoint targets at the extreme
// projections (clamped per channel to [lo, hi]).
static void block_range(const float pts[16][4], int k, float lo[4],
                        float hi[4]) {
    for (int c = 0; c < k; c++) { lo[c] = 1e30f; hi[c] = -1e30f; }
    for (int i = 0; i < 16; i++)
        for (int c = 0; c < k; c++) {
            lo[c] = std::min(lo[c], pts[i][c]);
            hi[c] = std::max(hi[c], pts[i][c]);
        }
}

static void axis_endpoints(const float pts[16][4], int k, const float lo[4],
                           const float hi[4], float e0[4], float e1[4]) {
    float mean[4], axis[4];
    principal_axis(pts, k, mean, axis);
    float tmin = 1e30f, tmax = -1e30f;
    for (int i = 0; i < 16; i++) {
        float t = 0.0f;
        for (int c = 0; c < k; c++) t += (pts[i][c] - mean[c]) * axis[c];
        tmin = std::min(tmin, t);
        tmax = std::max(tmax, t);
    }
    for (int c = 0; c < k; c++) {
        e0[c] = std::min(hi[c], std::max(lo[c], mean[c] + tmin * axis[c]));
        e1[c] = std::min(hi[c], std::max(lo[c], mean[c] + tmax * axis[c]));
    }
}

// 4-bit index per point: nearest bc7_w4 weight to the segment
// projection (exact for the decoder's integer lerp up to rounding).
static void fit_indices4(const float pts[16][4], int k, const float d0[4],
                         const float d1[4], int idx[16]) {
    float axis[4], len2 = 0.0f;
    for (int c = 0; c < k; c++) {
        axis[c] = d1[c] - d0[c];
        len2 += axis[c] * axis[c];
    }
    for (int i = 0; i < 16; i++) {
        if (len2 < 1e-12f) { idx[i] = 0; continue; }
        float t = 0.0f;
        for (int c = 0; c < k; c++) t += (pts[i][c] - d0[c]) * axis[c];
        float w = t / len2 * 64.0f;
        int best = 0;
        float bestd = 1e30f;
        for (int p = 0; p < 16; p++) {
            float d = w - (float)bc7_w4[p];
            d = d < 0 ? -d : d;
            if (d < bestd) { bestd = d; best = p; }
        }
        idx[i] = best;
    }
}

// Least-squares endpoint refinement: given per-pixel weights from the
// current indices, re-solve e0/e1 per channel (2x2 normal equations).
// Keeps endpoints inside [lo, hi]; a near-singular system (all indices
// equal) leaves the previous endpoints in place.
static void ls_refine(const float pts[16][4], int k, const int idx[16],
                      const float lo[4], const float hi[4],
                      float e0[4], float e1[4]) {
    float saa = 0.0f, sab = 0.0f, sbb = 0.0f;
    float sap[4] = {}, sbp[4] = {};
    for (int i = 0; i < 16; i++) {
        float b = (float)bc7_w4[idx[i]] / 64.0f;
        float a = 1.0f - b;
        saa += a * a; sab += a * b; sbb += b * b;
        for (int c = 0; c < k; c++) {
            sap[c] += a * pts[i][c];
            sbp[c] += b * pts[i][c];
        }
    }
    float det = saa * sbb - sab * sab;
    if (det < 1e-3f) return;   // near-uniform indices: keep previous fit
    float inv = 1.0f / det;
    for (int c = 0; c < k; c++) {
        float v0 = (sbb * sap[c] - sab * sbp[c]) * inv;
        float v1 = (saa * sbp[c] - sab * sap[c]) * inv;
        e0[c] = std::min(hi[c], std::max(lo[c], v0));
        e1[c] = std::min(hi[c], std::max(lo[c], v1));
    }
}

// Quantize one BC7 mode-6 endpoint: 7-bit components + shared p-bit
// chosen to minimize squared error (decoded 8-bit value = (q<<1)|p).
static void quant_ep76(const float v[4], int q[4], int *pbit) {
    long err[2] = {0, 0};
    int qq[2][4];
    for (int p = 0; p < 2; p++)
        for (int c = 0; c < 4; c++) {
            int q7 = (int)std::lround((v[c] - (float)p) * 0.5f);
            q7 = std::min(127, std::max(0, q7));
            qq[p][c] = q7;
            long d = (long)std::lround(v[c]) - ((q7 << 1) | p);
            err[p] += d * d;
        }
    int p = err[1] < err[0] ? 1 : 0;
    *pbit = p;
    for (int c = 0; c < 4; c++) q[c] = qq[p][c];
}

static void encode_bc7_block(const float pts[16][4], uint8_t out[16]) {
    float e0[4], e1[4], lo[4], hi[4];
    block_range(pts, 4, lo, hi);
    axis_endpoints(pts, 4, lo, hi, e0, e1);
    int q0[4], q1[4], p0, p1;
    int idx[16];
    float d0[4], d1[4];
    for (int pass = 0; pass < 3; pass++) {
        quant_ep76(e0, q0, &p0);
        quant_ep76(e1, q1, &p1);
        for (int c = 0; c < 4; c++) {
            d0[c] = (float)((q0[c] << 1) | p0);
            d1[c] = (float)((q1[c] << 1) | p1);
        }
        fit_indices4(pts, 4, d0, d1, idx);
        if (pass < 2) ls_refine(pts, 4, idx, lo, hi, e0, e1);
    }
    if (idx[0] >= 8) {          // anchor MSB must be implicit zero
        std::swap(p0, p1);
        for (int c = 0; c < 4; c++) std::swap(q0[c], q1[c]);
        for (int i = 0; i < 16; i++) idx[i] = 15 - idx[i];
    }
    memset(out, 0, 16);
    BitWriter w = {out, 0};
    w.put(0x40, 7);             // six 0s then a 1 -> mode 6
    for (int c = 0; c < 3; c++) {
        w.put((uint32_t)q0[c], 7);
        w.put((uint32_t)q1[c], 7);
    }
    w.put((uint32_t)q0[3], 7);
    w.put((uint32_t)q1[3], 7);
    w.put((uint32_t)p0, 1);
    w.put((uint32_t)p1, 1);
    w.put((uint32_t)idx[0], 3);
    for (int i = 1; i < 16; i++) w.put((uint32_t)idx[i], 4);
}

static uint16_t float_to_half_unsigned(float f) {
    if (!(f > 0.0f)) return 0;              // negatives/NaN -> 0 (UF16)
    if (f > 65504.0f) f = 65504.0f;
    uint32_t bits;
    memcpy(&bits, &f, 4);
    int exp = (int)((bits >> 23) & 0xFF) - 127 + 15;
    uint32_t man = bits & 0x7FFFFF;
    if (exp <= 0) {                          // denormal half
        man |= 0x800000;
        int shift = 14 - exp;
        return shift > 24 ? 0 : (uint16_t)(man >> shift);
    }
    if (exp >= 31) return 0x7BFF;
    return (uint16_t)((exp << 10) | (man >> 13));
}

// Inverse of (b6_unq_unsigned(q, 10) * 31) >> 6 at the endpoints:
// interior unq = q*64 + 32, endpoint half H needs unq U ~= H*64/31.
static int quant_b6_ep(float h_bits) {
    int q = (int)std::lround(h_bits * (64.0 / 31.0 / 64.0));
    return std::min(1023, std::max(0, q));
}

static float dec_b6_ep(int q) {
    return (float)((b6_unq_unsigned(q, 10) * 31) >> 6);
}

static void encode_bc6h_block(const float pts_h[16][4], uint8_t out[16]) {
    float e0[4], e1[4], lo[4], hi[4];
    block_range(pts_h, 3, lo, hi);
    axis_endpoints(pts_h, 3, lo, hi, e0, e1);
    int q0[3], q1[3];
    int idx[16];
    float d0[4] = {}, d1[4] = {};
    for (int pass = 0; pass < 3; pass++) {
        for (int c = 0; c < 3; c++) {
            q0[c] = quant_b6_ep(e0[c]);
            q1[c] = quant_b6_ep(e1[c]);
            d0[c] = dec_b6_ep(q0[c]);
            d1[c] = dec_b6_ep(q1[c]);
        }
        fit_indices4(pts_h, 3, d0, d1, idx);
        if (pass < 2) ls_refine(pts_h, 3, idx, lo, hi, e0, e1);
    }
    if (idx[0] >= 8) {
        for (int c = 0; c < 3; c++) std::swap(q0[c], q1[c]);
        for (int i = 0; i < 16; i++) idx[i] = 15 - idx[i];
    }
    memset(out, 0, 16);
    BitWriter w = {out, 0};
    w.put(0x03, 5);             // mode 0x03: 10.10 one subset
    for (int c = 0; c < 3; c++) w.put((uint32_t)q0[c], 10);
    for (int c = 0; c < 3; c++) w.put((uint32_t)q1[c], 10);
    w.put((uint32_t)idx[0], 3);
    for (int i = 1; i < 16; i++) w.put((uint32_t)idx[i], 4);
}

}  // namespace enc

extern "C" {

void encode_bc7(const uint8_t *src, uint8_t *dst, int width, int height) {
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            float pts[16][4];
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    int px = std::min(bx * 4 + x, width - 1);
                    int py = std::min(by * 4 + y, height - 1);
                    const uint8_t *s = src + (py * width + px) * 4;
                    for (int c = 0; c < 4; c++)
                        pts[y * 4 + x][c] = (float)s[c];
                }
            enc::encode_bc7_block(pts, dst + (by * bw + bx) * 16);
        }
}

// src: (H, W, 3) float32 linear HDR -> BC6H UF16 blocks.
void encode_bc6h(const float *src, uint8_t *dst, int width, int height) {
    int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
            float pts[16][4];
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    int px = std::min(bx * 4 + x, width - 1);
                    int py = std::min(by * 4 + y, height - 1);
                    const float *s = src + (py * width + px) * 3;
                    for (int c = 0; c < 3; c++)
                        pts[y * 4 + x][c] =
                            (float)enc::float_to_half_unsigned(s[c]);
                    pts[y * 4 + x][3] = 0.0f;
                }
            enc::encode_bc6h_block(pts, dst + (by * bw + bx) * 16);
        }
}

}  // extern "C"
