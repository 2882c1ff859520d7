// MLT1 meshlet codec and 64-bit radix sort of granite_tpu_torch.
//
// MLT1 (vulkan/mesh/meshlet.{hpp,cpp} redesign): meshlets of <= 64
// vertices / <= 126 triangles, filled greedily in index order; positions
// quantized to 16-bit unorm within the meshlet AABB; indices as 8-bit
// local ids, padded to 4 bytes.  Decode reproduces float positions
// within one quantization step.
//
// radix_sort_u64 (util/radix_sorter.hpp analogue): the stable
// permutation ordering 64-bit keys ascending, eight 8-bit LSD passes.
//
// A copy of the MLT1 and radix-sort sections of
// granite_tpu/native/granite_native.cpp (the port imports nothing of the
// JAX package); tests/test_torch_native_mlt1.py holds its blobs
// byte-equal and its orders equal to the original's.  Built with g++ at
// first use and bound with ctypes (granite_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

struct MeshletHeader {
    uint32_t vertex_count;
    uint32_t triangle_count;
    float aabb_min[3];
    float aabb_max[3];
};

int meshlet_encode(const float *positions, int num_vertices,
                   const int32_t *indices, int num_triangles,
                   uint8_t *out, int out_capacity, int *out_size,
                   int *out_meshlets) {
    (void)num_vertices;
    std::vector<uint8_t> buf;
    int t = 0, meshlets = 0;
    while (t < num_triangles) {
        // Greedy fill: accumulate triangles until 64 verts or 126 tris.
        std::vector<int32_t> local;        // global vertex ids
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
                local.resize(before);  // revert; meshlet full
                break;
            }
            ltris.push_back((uint8_t)la);
            ltris.push_back((uint8_t)lb);
            ltris.push_back((uint8_t)lc);
            t++;
        }
        if (t == start) return -2;         // triangle didn't fit

        MeshletHeader h;
        h.vertex_count = (uint32_t)local.size();
        h.triangle_count = (uint32_t)(ltris.size() / 3);
        for (int c = 0; c < 3; c++) {
            h.aabb_min[c] = 1e30f;
            h.aabb_max[c] = -1e30f;
        }
        for (int32_t g : local)
            for (int c = 0; c < 3; c++) {
                float v = positions[g * 3 + c];
                h.aabb_min[c] = std::min(h.aabb_min[c], v);
                h.aabb_max[c] = std::max(h.aabb_max[c], v);
            }
        size_t off = buf.size();
        buf.resize(off + sizeof(h));
        memcpy(buf.data() + off, &h, sizeof(h));
        for (int32_t g : local)
            for (int c = 0; c < 3; c++) {
                float ext = h.aabb_max[c] - h.aabb_min[c];
                float n = ext > 0 ?
                    (positions[g * 3 + c] - h.aabb_min[c]) / ext : 0.f;
                uint16_t q = (uint16_t)(n * 65535.f + 0.5f);
                buf.push_back((uint8_t)q);
                buf.push_back((uint8_t)(q >> 8));
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

int meshlet_decode(const uint8_t *data, int size, int num_meshlets,
                   float *out_positions, int32_t *out_indices,
                   int *out_vertices, int *out_triangles) {
    size_t off = 0;
    int vtotal = 0, ttotal = 0;
    for (int m = 0; m < num_meshlets; m++) {
        if (off + sizeof(MeshletHeader) > (size_t)size) return -1;
        MeshletHeader h;
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

void radix_sort_u64(const uint64_t *keys, uint32_t *order, int n) {
    std::vector<uint32_t> tmp(n), cur(n);
    std::vector<uint64_t> kb(n), ka(keys, keys + n);
    for (int i = 0; i < n; i++) cur[i] = (uint32_t)i;
    for (int shift = 0; shift < 64; shift += 8) {
        uint32_t count[257] = {0};
        for (int i = 0; i < n; i++)
            count[((ka[i] >> shift) & 255) + 1]++;
        for (int i = 0; i < 256; i++) count[i + 1] += count[i];
        for (int i = 0; i < n; i++) {
            uint32_t d = (uint32_t)((ka[i] >> shift) & 255);
            uint32_t pos = count[d]++;
            tmp[pos] = cur[i];
            kb[pos] = ka[i];
        }
        std::swap(cur, tmp);
        std::swap(ka, kb);
    }
    if (n > 0) memcpy(order, cur.data(), n * sizeof(uint32_t));
}

}  // extern "C"
