// Native strip packer for the ray-stab acceleration-structure build.
//
// The reference delegates its AS build to the driver's native BVH builder
// (Voxelizer.cpp:264-326 BuildRaytracingAccelerationStructure); this is the
// engine's equivalent native component: the greedy packing of
// direction-cell ray groups into 128-lane strips with per-strip candidate
// unions (the irregular sequential walk in
// ops/raystab_fast._make_packs_py, which is the behavioral reference —
// outputs must be bit-identical, pinned by tests/test_raystab2.py).
//
// Contract (mirrors the Python exactly):
//  - iterate fine cells in order; skip cells with no candidates or rays;
//  - cells with > 128 rays: flush the pool, emit full 128-lane strips in
//    table order (each cell's rays arrive pre-sorted by origin radius,
//    accelpack_raytab_fill) sharing the cell's bound-sorted unique
//    candidate list, send the tail to the pool;
//  - small cells accumulate in the pool until 128 lanes would overflow;
//  - a flushed pool emits one strip whose candidate list is the
//    bound-sorted unique union of its cells' raw lists;
//  - candidate lists: unique ids ordered by the PACKED key
//    (tri_bounds high 40 IEEE-double bits, id in the low 24) ascending —
//    i.e. by bound truncated to 40 bits, ties by id; plain ascending ids
//    when bounds are absent.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct PackClass {
    int64_t k = 0, vc = 0, vc_pad = 0;
    std::vector<int64_t> packs;  // pack indices, stable size-descending
};

struct AccelPackResult {
    std::vector<int32_t> ray_data;
    std::vector<int64_t> ray_offs;
    std::vector<int64_t> id_data;
    std::vector<int64_t> id_offs;
    std::vector<PackClass> classes;
};

// Direction -> cubemap cell id: THE single C++ implementation of the
// cell-assignment math (bit-identical to ops/raystab_fast._dir_cells_host:
// same f32 expressions, np.argmax first-max tie rule, trunc-toward-zero
// cast). Both accelpack_dir_cells and the raytab builder call this —
// a divergent copy here would silently split the persistent raytab cache
// from the binning path (ADVICE r4).
inline uint32_t dir_cell_one(float x, float y, float z, float half_g,
                             int64_t g, int64_t gg) {
    const float ax = x < 0 ? -x : x;
    const float ay = y < 0 ? -y : y;
    const float az = z < 0 ? -z : z;
    const int a = (ax >= ay) ? (ax >= az ? 0 : 2) : (ay >= az ? 1 : 2);
    const float da = a == 0 ? x : (a == 1 ? y : z);
    const float db = a == 0 ? y : x;  // _OTHERS[a, 0]
    const float dc = a == 2 ? y : z;  // _OTHERS[a, 1]
    const float ada = da < 0 ? -da : da;
    int64_t iu = static_cast<int64_t>((db / ada + 1.0f) * half_g);
    int64_t iv = static_cast<int64_t>((dc / ada + 1.0f) * half_g);
    iu = iu < 0 ? 0 : (iu > g - 1 ? g - 1 : iu);
    iv = iv < 0 ? 0 : (iv > g - 1 ? g - 1 : iv);
    const int64_t f = 2 * a + (da < 0 ? 1 : 0);
    return static_cast<uint32_t>(f * gg + iu * g + iv);
}

}  // namespace

extern "C" {

void* accelpack_run(
    const int64_t* cell_offs, const int64_t* cell_data, int64_t n_cells,
    const int32_t* ray_table, int64_t r_cap,
    const int64_t* rc, const float* s0, const double* tri_bounds) {
    auto* res = new (std::nothrow) AccelPackResult();
    if (!res) return nullptr;
    res->ray_offs.push_back(0);
    res->id_offs.push_back(0);

    // Packed sort key per candidate id: the bound's high 40 IEEE bits with
    // the id in the low 24 (ids < 2^24, asserted at build entry; bounds are
    // non-negative doubles, so their bit patterns order like the values).
    // ONE plain int64 sort + consecutive-unique replaces the historical
    // sort + unique + stable_sort-by-bound triple: same dedupe (equal ids
    // give equal keys), ascending (truncated bound, id) order. The Python
    // reference (_make_packs_py) computes the identical key.
    int64_t max_id = 0;
    for (int64_t c = 0; c < n_cells; ++c) {
        for (int64_t i = cell_offs[c]; i < cell_offs[c + 1]; ++i) {
            max_id = std::max(max_id, cell_data[i]);
        }
    }
    std::vector<uint64_t> key_tab(static_cast<size_t>(max_id + 1));
    for (int64_t t = 0; t <= max_id; ++t) {
        uint64_t hi = 0;
        if (tri_bounds) {
            std::memcpy(&hi, &tri_bounds[t], sizeof(hi));
            hi &= ~uint64_t(0xFFFFFF);
        }
        key_tab[static_cast<size_t>(t)] = hi | static_cast<uint64_t>(t);
    }

    std::vector<int32_t> cur_rays;   // pooled ray lanes
    std::vector<uint64_t> cur_keys;  // pooled candidate keys (with dups)
    std::vector<uint64_t> uniq;      // scratch: sorted unique keys
    std::vector<int32_t> full;       // scratch: big-cell ray order

    auto emit = [&](const int32_t* rays, int64_t nr,
                    const std::vector<uint64_t>& keys) {
        res->ray_data.insert(res->ray_data.end(), rays, rays + nr);
        res->ray_offs.push_back(static_cast<int64_t>(res->ray_data.size()));
        for (uint64_t k : keys) {
            res->id_data.push_back(static_cast<int64_t>(k & 0xFFFFFF));
        }
        res->id_offs.push_back(static_cast<int64_t>(res->id_data.size()));
    };

    auto sort_keys = [&](std::vector<uint64_t>& keys) {
        std::sort(keys.begin(), keys.end());
        keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
    };

    auto push_keys = [&](std::vector<uint64_t>& dst, const int64_t* ids,
                         int64_t m) {
        for (int64_t i = 0; i < m; ++i) {
            dst.push_back(key_tab[static_cast<size_t>(ids[i])]);
        }
    };

    auto close = [&]() {
        if (!cur_rays.empty()) {
            uniq = cur_keys;
            sort_keys(uniq);
            emit(cur_rays.data(), static_cast<int64_t>(cur_rays.size()),
                 uniq);
        }
        cur_rays.clear();
        cur_keys.clear();
    };

    for (int64_t c = 0; c < n_cells; ++c) {
        const int64_t beg = cell_offs[c], end = cell_offs[c + 1];
        const int64_t m = end - beg;
        const int64_t nray = rc[c];
        if (m == 0 || nray == 0) continue;
        const int32_t* row = ray_table + c * r_cap;
        if (nray > 128) {
            close();
            uniq.clear();
            push_keys(uniq, cell_data + beg, m);
            sort_keys(uniq);
            // strips in origin-radius order: the ray table stores each
            // cell's rays pre-sorted by (radius bits, voxel id) — see
            // accelpack_raytab_fill — so strip slicing is direct (the
            // historical per-build stable_sort-by-s0 paid 16.7M random
            // s0 loads at 256^3 for every geometry).
            full.assign(row, row + nray);
            for (int64_t s = 0; s < nray; s += 128) {
                const int64_t len = std::min<int64_t>(128, nray - s);
                if (len == 128) {
                    emit(full.data() + s, 128, uniq);
                } else {  // tail strip joins the packing pool
                    cur_rays.insert(cur_rays.end(), full.begin() + s,
                                    full.begin() + s + len);
                    push_keys(cur_keys, cell_data + beg, m);
                }
            }
            continue;
        }
        if (static_cast<int64_t>(cur_rays.size()) + nray > 128) close();
        cur_rays.insert(cur_rays.end(), row, row + nray);
        push_keys(cur_keys, cell_data + beg, m);
    }
    close();
    return res;
}

int64_t accelpack_n_packs(void* h) {
    return static_cast<int64_t>(
        static_cast<AccelPackResult*>(h)->ray_offs.size()) - 1;
}

int64_t accelpack_ray_total(void* h) {
    return static_cast<int64_t>(
        static_cast<AccelPackResult*>(h)->ray_data.size());
}

int64_t accelpack_id_total(void* h) {
    return static_cast<int64_t>(
        static_cast<AccelPackResult*>(h)->id_data.size());
}

void accelpack_copy(void* h, int32_t* ray_data, int64_t* ray_offs,
                    int64_t* id_data, int64_t* id_offs) {
    auto* r = static_cast<AccelPackResult*>(h);
    std::copy(r->ray_data.begin(), r->ray_data.end(), ray_data);
    std::copy(r->ray_offs.begin(), r->ray_offs.end(), ray_offs);
    std::copy(r->id_data.begin(), r->id_data.end(), id_data);
    std::copy(r->id_offs.begin(), r->id_offs.end(), id_offs);
}

void accelpack_free(void* h) { delete static_cast<AccelPackResult*>(h); }

// ---- class-table emission (ops/raystab_fast._pack_classes2 fast path) ------
//
// Partitions packs into capacity classes ((lo, cap] by ascending caps, empty
// classes skipped, rows stable-ordered by DESCENDING id-list size) and fills
// the padded per-class tables directly — the numpy CSR-regather + boolean-
// mask fills of the same product were ~4 s of the 256^3 build. Semantics
// mirror the Python reference exactly (pinned by tests).

int64_t accelpack_max_ids(void* h) {
    auto* r = static_cast<AccelPackResult*>(h);
    int64_t m = 0;
    for (size_t p = 0; p + 1 < r->id_offs.size(); ++p) {
        m = std::max(m, r->id_offs[p + 1] - r->id_offs[p]);
    }
    return m;
}

int64_t accelpack_classes_begin(void* h, const int64_t* caps,
                                int64_t n_caps,
                                const int64_t* cells_per_step) {
    // cells_per_step: PER-CAP row-padding quantum (the kernel batches
    // cells_per_step_for(k) strips per grid step; the table's vc must be
    // a multiple of it — ops/raystab_pallas.cells_per_step_for).
    auto* r = static_cast<AccelPackResult*>(h);
    r->classes.clear();
    const int64_t n_packs =
        static_cast<int64_t>(r->id_offs.size()) - 1;
    std::vector<int64_t> sizes(static_cast<size_t>(n_packs));
    for (int64_t p = 0; p < n_packs; ++p) {
        sizes[static_cast<size_t>(p)] = r->id_offs[p + 1] - r->id_offs[p];
    }
    int64_t lo = 0;
    for (int64_t ci = 0; ci < n_caps; ++ci) {
        const int64_t k = caps[ci];
        const int64_t cps = cells_per_step[ci];
        PackClass cls;
        cls.k = k;
        for (int64_t p = 0; p < n_packs; ++p) {
            const int64_t s = sizes[static_cast<size_t>(p)];
            if (s > lo && s <= k) cls.packs.push_back(p);
        }
        lo = k;
        if (cls.packs.empty()) continue;
        std::stable_sort(
            cls.packs.begin(), cls.packs.end(),
            [&](int64_t a, int64_t b) {
                return sizes[static_cast<size_t>(a)] >
                       sizes[static_cast<size_t>(b)];
            });
        cls.vc = static_cast<int64_t>(cls.packs.size());
        // bound the row padding to ~25%: cps <= vc/4 (mirrors
        // raystab_pallas.cells_per_step_for's vc rule exactly)
        int64_t cps_eff = cps;
        while (cps_eff > 8 && cps_eff * 4 > cls.vc) cps_eff /= 2;
        cls.vc_pad = cls.vc + (cps_eff - cls.vc % cps_eff) % cps_eff;
        r->classes.push_back(std::move(cls));
    }
    return static_cast<int64_t>(r->classes.size());
}

void accelpack_class_info(void* h, int64_t i, int64_t* out3) {
    auto* r = static_cast<AccelPackResult*>(h);
    const PackClass& c = r->classes[static_cast<size_t>(i)];
    out3[0] = c.k;
    out3[1] = c.vc;
    out3[2] = c.vc_pad;
}

void accelpack_class_fill(void* h, int64_t i, int32_t* rt128,
                          int32_t* tab) {
    auto* r = static_cast<AccelPackResult*>(h);
    const PackClass& c = r->classes[static_cast<size_t>(i)];
    std::fill(rt128, rt128 + c.vc_pad * 128, int32_t(-1));
    std::fill(tab, tab + c.vc_pad * c.k, int32_t(-1));
    for (int64_t row = 0; row < c.vc; ++row) {
        const int64_t p = c.packs[static_cast<size_t>(row)];
        const int64_t rb = r->ray_offs[p], re = r->ray_offs[p + 1];
        std::copy(r->ray_data.begin() + rb, r->ray_data.begin() + re,
                  rt128 + row * 128);
        const int64_t ib = r->id_offs[p], ie = r->id_offs[p + 1];
        int32_t* dst = tab + row * c.k;
        for (int64_t j = ib; j < ie; ++j) {
            *dst++ = static_cast<int32_t>(r->id_data[j]);
        }
    }
}

// Voxel-center -> direction-cubemap cell id for every voxel of an n^3
// grid, fused with the center generation (the numpy path materializes a
// [V,3] meshgrid first). Bit-identical to
// ops/raystab_fast._dir_cells_host over ops/packing.voxel_centers_norm:
// same f32 expressions, same first-max tie rule, same trunc-toward-zero
// cast (pinned by tests/test_raystab_fast.py).
void accelpack_dir_cells(int64_t n, int64_t g, int64_t* out) {
    std::vector<float> t(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        t[static_cast<size_t>(i)] =
            (static_cast<float>(i) + 0.5f) / static_cast<float>(n) * 2.0f -
            1.0f;
    }
    const float half_g = 0.5f * static_cast<float>(g);
    const int64_t gg = g * g;
    int64_t v = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float x = t[static_cast<size_t>(i)];
        for (int64_t j = 0; j < n; ++j) {
            const float y = -t[static_cast<size_t>(j)];
            for (int64_t k = 0; k < n; ++k, ++v) {
                const float z = t[static_cast<size_t>(k)];
                out[v] = static_cast<int64_t>(
                    dir_cell_one(x, y, z, half_g, g, gg));
            }
        }
    }
}

}  // extern "C"

// ---- raytab: voxel -> direction-cell table, counting-sort build -------------
//
// Replaces the host-python pipeline (dir_cells + 16.7M-row stable argsort +
// searchsorted + masked fill: ~10 s at 256^3 on one core) with two linear
// passes: cell compute + histogram, then a stable ascending scatter straight
// into the padded [n_cells, r_cap] table. Voxel ids are enumerated in
// ascending order, so each cell's run ascends — identical to the stable
// argsort the Python reference produces (pinned by tests/test_raystab2.py).

namespace {

struct RaytabState {
    int64_t n, g;
    std::vector<uint32_t> cells;   // per voxel
    std::vector<uint32_t> rbits;   // per voxel: origin-radius f32 bits
    std::vector<int64_t> counts;   // per cell
};

}  // namespace

extern "C" {

void* accelpack_raytab_start(int64_t n, int64_t g) {
    auto* st = new (std::nothrow) RaytabState();
    if (!st) return nullptr;
    st->n = n;
    st->g = g;
    const int64_t v_total = n * n * n;
    const int64_t n_cells = 6 * g * g;
    st->cells.resize(static_cast<size_t>(v_total));
    st->rbits.resize(static_cast<size_t>(v_total));
    st->counts.assign(static_cast<size_t>(n_cells), 0);
    std::vector<float> t(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        t[static_cast<size_t>(i)] =
            (static_cast<float>(i) + 0.5f) / static_cast<float>(n) * 2.0f -
            1.0f;
    }
    const float half_g = 0.5f * static_cast<float>(g);
    const int64_t gg = g * g;
    int64_t v = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float x = t[static_cast<size_t>(i)];
        for (int64_t j = 0; j < n; ++j) {
            const float y = -t[static_cast<size_t>(j)];
            for (int64_t k = 0; k < n; ++k, ++v) {
                const float z = t[static_cast<size_t>(k)];
                const uint32_t c =
                    dir_cell_one(x, y, z, half_g, g, gg);
                st->cells[static_cast<size_t>(v)] = c;
                // origin radius, f32 bits (>= 0, so the bits order like
                // the values): the in-cell ray sort key (see fill)
                const float r = std::sqrt(x * x + y * y + z * z);
                std::memcpy(&st->rbits[static_cast<size_t>(v)], &r,
                            sizeof(float));
                ++st->counts[c];
            }
        }
    }
    return st;
}

int64_t accelpack_raytab_rcap(void* handle) {
    auto* st = static_cast<RaytabState*>(handle);
    int64_t m = 0;
    for (int64_t c : st->counts) m = m > c ? m : c;
    int64_t cap = ((m + 7) / 8) * 8;  // pad to a multiple of 8
    return cap < 8 ? 8 : cap;
}

void accelpack_raytab_counts(void* handle, int64_t* rc) {
    auto* st = static_cast<RaytabState*>(handle);
    std::copy(st->counts.begin(), st->counts.end(), rc);
}

void accelpack_raytab_fill(void* handle, int64_t r_cap, int32_t* rt) {
    auto* st = static_cast<RaytabState*>(handle);
    const int64_t n_cells = 6 * st->g * st->g;
    const int64_t v_total = st->n * st->n * st->n;
    std::fill(rt, rt + n_cells * r_cap, int32_t(-1));
    // scatter packed (radius bits << 32 | voxel id) keys per cell, sort
    // each cell's run, emit the low ids: every cell's rays come out
    // ordered by (origin radius, voxel id) — so the pack walk slices
    // big cells into radius-banded strips with NO per-build sort and no
    // random 67 MB s0 lookups (this table is cached per (n, g)).
    std::vector<int64_t> offs(static_cast<size_t>(n_cells) + 1, 0);
    for (int64_t c = 0; c < n_cells; ++c) {
        offs[static_cast<size_t>(c) + 1] =
            offs[static_cast<size_t>(c)] + st->counts[static_cast<size_t>(c)];
    }
    std::vector<uint64_t> keys(static_cast<size_t>(v_total));
    std::vector<int64_t> pos(offs.begin(), offs.end() - 1);
    for (int64_t v = 0; v < v_total; ++v) {
        const uint32_t c = st->cells[static_cast<size_t>(v)];
        keys[static_cast<size_t>(pos[c]++)] =
            (static_cast<uint64_t>(st->rbits[static_cast<size_t>(v)])
             << 32) |
            static_cast<uint64_t>(static_cast<uint32_t>(v));
    }
    for (int64_t c = 0; c < n_cells; ++c) {
        uint64_t* beg = keys.data() + offs[static_cast<size_t>(c)];
        uint64_t* end = keys.data() + offs[static_cast<size_t>(c) + 1];
        std::sort(beg, end);
        int32_t* dst = rt + c * r_cap;
        for (uint64_t* p = beg; p != end; ++p) {
            *dst++ = static_cast<int32_t>(*p & 0xFFFFFFFF);
        }
    }
}

void accelpack_raytab_free(void* handle) {
    delete static_cast<RaytabState*>(handle);
}

}  // extern "C"

// ---- gen-7 tile unions: per-voxel-tile candidate lists ----------------------
//
// The gen-7 (output-major) accel build's hot host stage: for every 8x4x4
// voxel tile, union the candidate lists of the direction-cubemap cells its
// 128 rays cross, DELETE candidates whose conservative max hit radius lies
// below the tile's min ray-origin radius (behind every lane -> t < 0, an
// arithmetic no-op), and order the survivors by (min-hit-radius bound, id)
// for near-to-far chunk skipping. Behavioral reference: the vectorized
// numpy pipeline in ops/raystab_tiled.build_raystab_compact7 (bit-identical
// output, pinned by tests/test_raystab_tiled.py) — this pass replaces its
// ~50 s of 164M-row expansion + np.unique at 256^3 with one tile-major
// walk.

namespace {

struct TileUnionState {
    int64_t nt = 0;
    std::vector<int64_t> offs;   // [nt + 1]
    std::vector<int32_t> data;   // concatenated per-tile candidate ids
    std::vector<float> s0min;    // [nt] per-tile min ray-origin radius
    std::vector<float> s0max;    // [nt] per-tile max ray-origin radius
};

}  // namespace

extern "C" {

void* accelpack_tileunion_run(
    int64_t n, int64_t g, int64_t tx, int64_t ty, int64_t tz,
    const int64_t* cell_offs, const int32_t* cell_data,
    const float* maxr, const float* bounds,
    const int32_t* ov_ids, int64_t n_ov) {
    auto* st = new (std::nothrow) TileUnionState();
    if (!st) return nullptr;
    const int64_t txn = n / tx, tyn = n / ty, tzn = n / tz;
    st->nt = txn * tyn * tzn;
    st->offs.assign(static_cast<size_t>(st->nt) + 1, 0);
    st->s0min.assign(static_cast<size_t>(st->nt), 0.0f);
    st->s0max.assign(static_cast<size_t>(st->nt), 0.0f);
    std::vector<float> t(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        t[static_cast<size_t>(i)] =
            (static_cast<float>(i) + 0.5f) / static_cast<float>(n) * 2.0f -
            1.0f;
    }
    const float half_g = 0.5f * static_cast<float>(g);
    const int64_t gg = g * g;
    std::vector<uint32_t> cells;
    cells.reserve(128);
    std::vector<uint64_t> keys;
    st->data.reserve(static_cast<size_t>(st->nt) * 64);
    int64_t tid = 0;
    for (int64_t bx = 0; bx < txn; ++bx) {
        for (int64_t by = 0; by < tyn; ++by) {
            for (int64_t bz = 0; bz < tzn; ++bz, ++tid) {
                cells.clear();
                float s0min = 1e30f, s0max = 0.0f;
                for (int64_t lx = 0; lx < tx; ++lx) {
                    const float x = t[static_cast<size_t>(bx * tx + lx)];
                    for (int64_t ly = 0; ly < ty; ++ly) {
                        const float y =
                            -t[static_cast<size_t>(by * ty + ly)];
                        for (int64_t lz = 0; lz < tz; ++lz) {
                            const float z =
                                t[static_cast<size_t>(bz * tz + lz)];
                            cells.push_back(
                                dir_cell_one(x, y, z, half_g, g, gg));
                            const float s0 =
                                std::sqrt((x * x + y * y) + z * z);
                            s0min = s0 < s0min ? s0 : s0min;
                            s0max = s0 > s0max ? s0 : s0max;
                        }
                    }
                }
                std::sort(cells.begin(), cells.end());
                cells.erase(std::unique(cells.begin(), cells.end()),
                            cells.end());
                keys.clear();
                for (uint32_t c : cells) {
                    const int64_t b = cell_offs[c], e = cell_offs[c + 1];
                    for (int64_t j = b; j < e; ++j) {
                        const int32_t tri = cell_data[j];
                        if (maxr[tri] >= s0min) {
                            uint32_t bb;
                            std::memcpy(&bb, &bounds[tri], sizeof(float));
                            keys.push_back(
                                (static_cast<uint64_t>(bb) << 32) |
                                static_cast<uint32_t>(tri));
                        }
                    }
                }
                for (int64_t j = 0; j < n_ov; ++j) {
                    const int32_t tri = ov_ids[j];
                    if (tri >= 0 && maxr[tri] >= s0min) {
                        uint32_t bb;
                        std::memcpy(&bb, &bounds[tri], sizeof(float));
                        keys.push_back(
                            (static_cast<uint64_t>(bb) << 32) |
                            static_cast<uint32_t>(tri));
                    }
                }
                std::sort(keys.begin(), keys.end());
                keys.erase(std::unique(keys.begin(), keys.end()),
                           keys.end());
                for (uint64_t k : keys) {
                    st->data.push_back(
                        static_cast<int32_t>(k & 0xFFFFFFFF));
                }
                st->offs[static_cast<size_t>(tid) + 1] =
                    static_cast<int64_t>(st->data.size());
                st->s0min[static_cast<size_t>(tid)] = s0min;
                st->s0max[static_cast<size_t>(tid)] = s0max;
            }
        }
    }
    return st;
}

int64_t accelpack_tileunion_total(void* handle) {
    return static_cast<int64_t>(
        static_cast<TileUnionState*>(handle)->data.size());
}

void accelpack_tileunion_copy(void* handle, int64_t* tile_offs,
                              int32_t* tile_data, float* s0min,
                              float* s0max) {
    auto* st = static_cast<TileUnionState*>(handle);
    std::memcpy(tile_offs, st->offs.data(),
                st->offs.size() * sizeof(int64_t));
    if (!st->data.empty()) {
        std::memcpy(tile_data, st->data.data(),
                    st->data.size() * sizeof(int32_t));
    }
    std::memcpy(s0min, st->s0min.data(), st->s0min.size() * sizeof(float));
    std::memcpy(s0max, st->s0max.data(), st->s0max.size() * sizeof(float));
}

void accelpack_tileunion_free(void* handle) {
    delete static_cast<TileUnionState*>(handle);
}

}  // extern "C"
