// MLT2 meshlet codec of granite_tpu_torch: full-attribute meshlet
// streams (reference StreamType set, vulkan/mesh/meshlet.hpp:85-93).
// Per meshlet: a header (vertex and triangle counts, position AABB, UV
// AABB), then per vertex 16-bit unorm positions inside the AABB, an
// oct-encoded 2x16-bit normal and 16-bit unorm UVs inside the UV AABB,
// then 8-bit local triangle indices, padded to 4 bytes.  At most 64
// vertices and 126 triangles a meshlet, greedily in index order.
//
// A copy of the MLT2 half of granite_tpu/native/granite_native.cpp (the
// port imports nothing of the JAX package); tests/test_torch_meshlet.py
// holds its blobs byte-equal to the original's.  Built with g++ at first
// use and bound with ctypes (granite_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

struct Meshlet2Header {
    uint32_t vertex_count;
    uint32_t triangle_count;
    float aabb_min[3];
    float aabb_max[3];
    float uv_min[2];
    float uv_max[2];
};

static void oct_encode(const float n[3], uint16_t out[2]) {
    float ax = std::fabs(n[0]), ay = std::fabs(n[1]), az = std::fabs(n[2]);
    float s = ax + ay + az;
    if (s <= 0) s = 1.f;
    float x = n[0] / s, y = n[1] / s;
    if (n[2] < 0) {
        float ox = (1.f - std::fabs(y)) * (x >= 0 ? 1.f : -1.f);
        float oy = (1.f - std::fabs(x)) * (y >= 0 ? 1.f : -1.f);
        x = ox; y = oy;
    }
    out[0] = (uint16_t)((x * 0.5f + 0.5f) * 65535.f + 0.5f);
    out[1] = (uint16_t)((y * 0.5f + 0.5f) * 65535.f + 0.5f);
}

static void oct_decode(const uint16_t in[2], float out[3]) {
    float x = (in[0] / 65535.f) * 2.f - 1.f;
    float y = (in[1] / 65535.f) * 2.f - 1.f;
    float z = 1.f - std::fabs(x) - std::fabs(y);
    if (z < 0) {
        float ox = (1.f - std::fabs(y)) * (x >= 0 ? 1.f : -1.f);
        float oy = (1.f - std::fabs(x)) * (y >= 0 ? 1.f : -1.f);
        x = ox; y = oy;
    }
    float len = std::sqrt(std::max(x * x + y * y + z * z, 1e-20f));
    out[0] = x / len; out[1] = y / len; out[2] = z / len;
}

static void push_u16(std::vector<uint8_t> &buf, uint16_t v) {
    buf.push_back((uint8_t)v);
    buf.push_back((uint8_t)(v >> 8));
}

int meshlet2_encode(const float *positions, const float *normals,
                    const float *uvs, int num_vertices,
                    const int32_t *indices, int num_triangles,
                    uint8_t *out, int out_capacity, int *out_size,
                    int *out_meshlets) {
    std::vector<uint8_t> buf;
    int t = 0, meshlets = 0;
    (void)num_vertices;
    while (t < num_triangles) {
        std::vector<int32_t> local;
        std::vector<uint8_t> ltris;
        auto local_id = [&](int32_t g) -> int {
            for (size_t i = 0; i < local.size(); i++)
                if (local[i] == g) return (int)i;
            local.push_back(g);
            return (int)local.size() - 1;
        };
        int start = t;
        while (t < num_triangles && ltris.size() / 3 < 126) {
            int32_t a = indices[t * 3], b = indices[t * 3 + 1],
                    c = indices[t * 3 + 2];
            size_t before = local.size();
            int la = local_id(a), lb = local_id(b), lc = local_id(c);
            if (local.size() > 64) {
                local.resize(before);
                break;
            }
            ltris.push_back((uint8_t)la);
            ltris.push_back((uint8_t)lb);
            ltris.push_back((uint8_t)lc);
            t++;
        }
        if (t == start) return -2;

        Meshlet2Header h;
        h.vertex_count = (uint32_t)local.size();
        h.triangle_count = (uint32_t)(ltris.size() / 3);
        for (int c = 0; c < 3; c++) { h.aabb_min[c] = 1e30f;
                                      h.aabb_max[c] = -1e30f; }
        for (int c = 0; c < 2; c++) { h.uv_min[c] = 1e30f;
                                      h.uv_max[c] = -1e30f; }
        for (int32_t g : local) {
            for (int c = 0; c < 3; c++) {
                float v = positions[g * 3 + c];
                h.aabb_min[c] = std::min(h.aabb_min[c], v);
                h.aabb_max[c] = std::max(h.aabb_max[c], v);
            }
            for (int c = 0; c < 2; c++) {
                float v = uvs ? uvs[g * 2 + c] : 0.f;
                h.uv_min[c] = std::min(h.uv_min[c], v);
                h.uv_max[c] = std::max(h.uv_max[c], v);
            }
        }
        size_t off = buf.size();
        buf.resize(off + sizeof(h));
        memcpy(buf.data() + off, &h, sizeof(h));
        for (int32_t g : local) {
            for (int c = 0; c < 3; c++) {
                float ext = h.aabb_max[c] - h.aabb_min[c];
                float n = ext > 0 ?
                    (positions[g * 3 + c] - h.aabb_min[c]) / ext : 0.f;
                push_u16(buf, (uint16_t)(n * 65535.f + 0.5f));
            }
            uint16_t oct[2] = {0, 0};
            if (normals) oct_encode(normals + g * 3, oct);
            push_u16(buf, oct[0]);
            push_u16(buf, oct[1]);
            for (int c = 0; c < 2; c++) {
                float ext = h.uv_max[c] - h.uv_min[c];
                float v = uvs ? uvs[g * 2 + c] : 0.f;
                float n = ext > 0 ? (v - h.uv_min[c]) / ext : 0.f;
                push_u16(buf, (uint16_t)(n * 65535.f + 0.5f));
            }
        }
        buf.insert(buf.end(), ltris.begin(), ltris.end());
        if (buf.size() % 4) buf.resize((buf.size() + 3) & ~3u);
        meshlets++;
    }
    *out_size = (int)buf.size();
    *out_meshlets = meshlets;
    if ((int)buf.size() > out_capacity) return -1;
    memcpy(out, buf.data(), buf.size());
    return 0;
}

int meshlet2_decode(const uint8_t *data, int size, int num_meshlets,
                    float *out_positions, float *out_normals,
                    float *out_uvs, int32_t *out_indices,
                    int *out_vertices, int *out_triangles) {
    size_t off = 0;
    int vtotal = 0, ttotal = 0;
    for (int m = 0; m < num_meshlets; m++) {
        if (off + sizeof(Meshlet2Header) > (size_t)size) return -1;
        Meshlet2Header h;
        memcpy(&h, data + off, sizeof(h));
        off += sizeof(h);
        int base = vtotal;
        for (uint32_t v = 0; v < h.vertex_count; v++) {
            for (int c = 0; c < 3; c++) {
                uint16_t q = (uint16_t)(data[off] | (data[off + 1] << 8));
                off += 2;
                float ext = h.aabb_max[c] - h.aabb_min[c];
                out_positions[(base + v) * 3 + c] =
                    h.aabb_min[c] + ext * (q / 65535.f);
            }
            uint16_t oct[2];
            oct[0] = (uint16_t)(data[off] | (data[off + 1] << 8));
            oct[1] = (uint16_t)(data[off + 2] | (data[off + 3] << 8));
            off += 4;
            oct_decode(oct, out_normals + (base + v) * 3);
            for (int c = 0; c < 2; c++) {
                uint16_t q = (uint16_t)(data[off] | (data[off + 1] << 8));
                off += 2;
                float ext = h.uv_max[c] - h.uv_min[c];
                out_uvs[(base + v) * 2 + c] =
                    h.uv_min[c] + ext * (q / 65535.f);
            }
        }
        for (uint32_t tt = 0; tt < h.triangle_count * 3; tt++)
            out_indices[ttotal * 3 + tt] = base + data[off + tt];
        off += h.triangle_count * 3;
        off = (off + 3) & ~3u;
        vtotal += h.vertex_count;
        ttotal += h.triangle_count;
    }
    *out_vertices = vtotal;
    *out_triangles = ttotal;
    return 0;
}

}  // extern "C"
