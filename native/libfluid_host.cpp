// Native host runtime for libfluid_tpu.
//
// The reference's runtime around the compute core is native C++: the testbed
// runs a simulation thread, a mesher thread and a render thread joined by
// mutexes and a semaphore (testbed/main.cpp:34-48,200-232,529-532), and the
// Maya plugin serializes frames on the DG thread (grid_node.cpp:228-375).
// This port keeps compute on the device, but the host side still needs the
// same thing those threads provided: getting frames OFF the critical path.
// This library supplies that runtime:
//
//   * an asynchronous export pool — a worker-thread job queue that serializes
//     point clouds (points.txt, point_cloud.h:15-37), triangle meshes
//     (mesh::save_obj, mesh.h:56-99) and PPM images (image::save_ppm,
//     common.h:67-79) while the Python thread returns to dispatching device work;
//   * mesh finalization — vertex welding (replacing the reference mesher's
//     serial rolling edge caches, mesher.cpp:394-407) and area-weighted
//     normal generation (mesh::generate_normals, mesh.h:38-53) at native
//     speed for multi-100k-triangle fluid surfaces.
//
// Plain C ABI; driven from Python via ctypes (no pybind11 in the image).

#include <array>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <deque>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// mesh welding + normals
// ---------------------------------------------------------------------------

struct Vec3 {
    float x, y, z;
};

struct KeyHash {
    std::size_t operator()(const std::array<std::int64_t, 3> &k) const {
        std::size_t h = 1469598103934665603ull;
        for (std::int64_t v : k) {
            h ^= static_cast<std::size_t>(v);
            h *= 1099511628211ull;
        }
        return h;
    }
};

// Weld a triangle soup (n_tris * 9 floats) into unique vertices + indices.
// Quantization: round(coord / eps). Returns the vertex count; out_pos must
// hold 3*n_tris*3 floats, out_idx 3*n_tris ints.
int weld(const float *tris, int n_tris, double eps, float *out_pos,
         std::int32_t *out_idx) {
    std::unordered_map<std::array<std::int64_t, 3>, std::int32_t, KeyHash> map;
    map.reserve(static_cast<std::size_t>(n_tris) * 2);
    const double inv = 1.0 / eps;
    std::int32_t next = 0;
    for (int c = 0; c < n_tris * 3; ++c) {
        const float *p = tris + 3 * c;
        std::array<std::int64_t, 3> key = {
            static_cast<std::int64_t>(std::llround(p[0] * inv)),
            static_cast<std::int64_t>(std::llround(p[1] * inv)),
            static_cast<std::int64_t>(std::llround(p[2] * inv)),
        };
        auto it = map.find(key);
        std::int32_t id;
        if (it == map.end()) {
            id = next++;
            map.emplace(key, id);
            std::memcpy(out_pos + 3 * id, p, 3 * sizeof(float));
        } else {
            id = it->second;
        }
        out_idx[c] = id;
    }
    return next;
}

// Area-weighted vertex normals (mesh::generate_normals, mesh.h:38-53):
// accumulate the unnormalized face cross product (its length is 2*area) on
// each corner vertex, then normalize.
void normals(const float *pos, int n_verts, const std::int32_t *idx,
             int n_tris, float *out_nrm) {
    std::memset(out_nrm, 0, sizeof(float) * 3 * n_verts);
    for (int t = 0; t < n_tris; ++t) {
        const std::int32_t a = idx[3 * t], b = idx[3 * t + 1], c = idx[3 * t + 2];
        const float *pa = pos + 3 * a, *pb = pos + 3 * b, *pc = pos + 3 * c;
        const float e1x = pb[0] - pa[0], e1y = pb[1] - pa[1], e1z = pb[2] - pa[2];
        const float e2x = pc[0] - pa[0], e2y = pc[1] - pa[1], e2z = pc[2] - pa[2];
        const float nx = e1y * e2z - e1z * e2y;
        const float ny = e1z * e2x - e1x * e2z;
        const float nz = e1x * e2y - e1y * e2x;
        for (std::int32_t v : {a, b, c}) {
            out_nrm[3 * v] += nx;
            out_nrm[3 * v + 1] += ny;
            out_nrm[3 * v + 2] += nz;
        }
    }
    for (int v = 0; v < n_verts; ++v) {
        float *n = out_nrm + 3 * v;
        const float len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
        if (len > 1e-30f) {
            n[0] /= len;
            n[1] /= len;
            n[2] /= len;
        }
    }
}

// ---------------------------------------------------------------------------
// async export pool
// ---------------------------------------------------------------------------

class Pool {
  public:
    explicit Pool(int n_threads) : stop_(false), errors_(0) {
        for (int i = 0; i < n_threads; ++i) {
            workers_.emplace_back([this] { run(); });
        }
    }

    ~Pool() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto &t : workers_) {
            t.join();
        }
    }

    void submit(std::function<bool()> job) {
        {
            std::unique_lock<std::mutex> lk(mu_);
            jobs_.push_back(std::move(job));
            ++pending_;
        }
        cv_.notify_one();
    }

    void flush() {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.wait(lk, [this] { return pending_ == 0; });
    }

    int pending() {
        std::unique_lock<std::mutex> lk(mu_);
        return pending_;
    }

    int errors() const { return errors_.load(); }

  private:
    void run() {
        for (;;) {
            std::function<bool()> job;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
                if (jobs_.empty()) {
                    if (stop_) return;
                    continue;
                }
                job = std::move(jobs_.front());
                jobs_.pop_front();
            }
            bool ok = false;
            try {
                ok = job();
            } catch (...) {
                ok = false;
            }
            if (!ok) errors_.fetch_add(1);
            {
                std::unique_lock<std::mutex> lk(mu_);
                --pending_;
                if (pending_ == 0) done_cv_.notify_all();
            }
        }
    }

    std::vector<std::thread> workers_;
    std::deque<std::function<bool()>> jobs_;
    std::mutex mu_;
    std::condition_variable cv_, done_cv_;
    bool stop_;
    int pending_ = 0;
    std::atomic<int> errors_;
};

bool write_points(const std::string &path, const std::vector<float> &pos) {
    std::FILE *f = std::fopen(path.c_str(), "w");
    if (!f) return false;
    std::string buf;
    buf.reserve(pos.size() * 12);
    char line[96];
    for (std::size_t i = 0; i + 2 < pos.size(); i += 3) {
        int n = std::snprintf(line, sizeof(line), "%.9g %.9g %.9g\n", pos[i],
                              pos[i + 1], pos[i + 2]);
        buf.append(line, n);
    }
    bool ok = std::fwrite(buf.data(), 1, buf.size(), f) == buf.size();
    return std::fclose(f) == 0 && ok;
}

bool write_obj(const std::string &path, const std::vector<float> &tris,
               double weld_eps, bool with_normals) {
    const int n_tris = static_cast<int>(tris.size() / 9);
    std::vector<float> pos(static_cast<std::size_t>(n_tris) * 9);
    std::vector<std::int32_t> idx(static_cast<std::size_t>(n_tris) * 3);
    const int n_verts = weld(tris.data(), n_tris, weld_eps, pos.data(), idx.data());
    std::vector<float> nrm;
    if (with_normals) {
        nrm.resize(static_cast<std::size_t>(n_verts) * 3);
        normals(pos.data(), n_verts, idx.data(), n_tris, nrm.data());
    }
    std::FILE *f = std::fopen(path.c_str(), "w");
    if (!f) return false;
    std::string buf;
    buf.reserve(static_cast<std::size_t>(n_verts) * 40 +
                static_cast<std::size_t>(n_tris) * 40);
    char line[160];
    for (int v = 0; v < n_verts; ++v) {
        int n = std::snprintf(line, sizeof(line), "v %.9g %.9g %.9g\n",
                              pos[3 * v], pos[3 * v + 1], pos[3 * v + 2]);
        buf.append(line, n);
    }
    for (int v = 0; with_normals && v < n_verts; ++v) {
        int n = std::snprintf(line, sizeof(line), "vn %.6g %.6g %.6g\n",
                              nrm[3 * v], nrm[3 * v + 1], nrm[3 * v + 2]);
        buf.append(line, n);
    }
    for (int t = 0; t < n_tris; ++t) {
        int n;
        if (with_normals) {
            n = std::snprintf(line, sizeof(line),
                              "f %d//%d %d//%d %d//%d\n", idx[3 * t] + 1,
                              idx[3 * t] + 1, idx[3 * t + 1] + 1,
                              idx[3 * t + 1] + 1, idx[3 * t + 2] + 1,
                              idx[3 * t + 2] + 1);
        } else {
            n = std::snprintf(line, sizeof(line), "f %d %d %d\n",
                              idx[3 * t] + 1, idx[3 * t + 1] + 1,
                              idx[3 * t + 2] + 1);
        }
        buf.append(line, n);
    }
    bool ok = std::fwrite(buf.data(), 1, buf.size(), f) == buf.size();
    return std::fclose(f) == 0 && ok;
}

bool write_ppm(const std::string &path, const std::vector<float> &img, int w,
               int h, double gamma) {
    std::FILE *f = std::fopen(path.c_str(), "wb");
    if (!f) return false;
    char header[64];
    int hn = std::snprintf(header, sizeof(header), "P6\n%d %d\n255\n", w, h);
    std::vector<unsigned char> bytes(static_cast<std::size_t>(w) * h * 3);
    const double inv_g = gamma > 0.0 ? 1.0 / gamma : 1.0;
    for (std::size_t i = 0; i < bytes.size(); ++i) {
        double v = img[i] < 0.0 ? 0.0 : img[i];
        if (gamma > 0.0) v = std::pow(v, inv_g);
        v = v > 1.0 ? 1.0 : v;
        bytes[i] = static_cast<unsigned char>(v * 255.0 + 0.5);
    }
    bool ok = std::fwrite(header, 1, hn, f) == static_cast<std::size_t>(hn);
    ok = ok && std::fwrite(bytes.data(), 1, bytes.size(), f) == bytes.size();
    return std::fclose(f) == 0 && ok;
}

}  // namespace

extern "C" {

void *lf_pool_create(int n_threads) {
    return new Pool(n_threads < 1 ? 1 : n_threads);
}

void lf_pool_destroy(void *pool) { delete static_cast<Pool *>(pool); }

void lf_pool_flush(void *pool) { static_cast<Pool *>(pool)->flush(); }

int lf_pool_pending(void *pool) { return static_cast<Pool *>(pool)->pending(); }

int lf_pool_errors(void *pool) { return static_cast<Pool *>(pool)->errors(); }

// Data is COPIED before returning; callers may free their buffers immediately.

void lf_submit_points(void *pool, const char *path, const float *positions,
                      const std::uint8_t *active, int n) {
    std::vector<float> pos;
    pos.reserve(static_cast<std::size_t>(n) * 3);
    for (int i = 0; i < n; ++i) {
        if (!active || active[i]) {
            pos.insert(pos.end(), positions + 3 * i, positions + 3 * i + 3);
        }
    }
    std::string p(path);
    static_cast<Pool *>(pool)->submit(
        [p, pos = std::move(pos)] { return write_points(p, pos); });
}

void lf_submit_obj(void *pool, const char *path, const float *tris, int n_tris,
                   double weld_eps, int with_normals) {
    std::vector<float> data(tris, tris + static_cast<std::size_t>(n_tris) * 9);
    std::string p(path);
    static_cast<Pool *>(pool)->submit(
        [p, data = std::move(data), weld_eps, with_normals] {
            return write_obj(p, data, weld_eps, with_normals != 0);
        });
}

void lf_submit_ppm(void *pool, const char *path, const float *img, int w,
                   int h, double gamma) {
    std::vector<float> data(img, img + static_cast<std::size_t>(w) * h * 3);
    std::string p(path);
    static_cast<Pool *>(pool)->submit([p, data = std::move(data), w, h, gamma] {
        return write_ppm(p, data, w, h, gamma);
    });
}

// Synchronous mesh finalize: weld + optional normals.
// out_pos: 3*3*n_tris floats, out_idx: 3*n_tris int32, out_nrm: like out_pos
// (may be null). Returns unique-vertex count.
int lf_weld_mesh(const float *tris, int n_tris, double eps, float *out_pos,
                 std::int32_t *out_idx, float *out_nrm) {
    int n_verts = weld(tris, n_tris, eps, out_pos, out_idx);
    if (out_nrm) {
        normals(out_pos, n_verts, out_idx, n_tris, out_nrm);
    }
    return n_verts;
}

}  // extern "C"
