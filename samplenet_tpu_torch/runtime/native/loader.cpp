// Native data-loading runtime of samplenet_tpu_torch: the port's own copy of
// samplenet_tpu/runtime/native/loader.cpp (the port imports nothing of the
// JAX package), with the same C ABI and the same arithmetic.
//
// The reference's input pipelines are host-side hot loops: a python
// multiprocessing pool parsing PLY files (reconstruction/src/in_out.py:220-243)
// and per-batch numpy shuffling/augmentation (classification/
// train_samplenet.py:275-349). This library moves that work into C++: a
// binary/ascii PLY parser and a multi-threaded prefetching batch pipeline
// (shuffle + rotate-about-up + clipped gaussian jitter fused into the copy),
// exposed through a C ABI consumed via ctypes.
//
// Built by samplenet_tpu_torch/runtime/loader.py with g++ at first use.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ----------------------------------------------------------------- PLY load

// Parses the vertex element of a PLY file into out[n*3] (xyz only).
// Returns the number of vertices, 0 on failure. If out == nullptr, only
// returns the count so the caller can size the buffer.
int64_t sn_load_ply(const char* path, float* out, int64_t capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 0;

  char line[4096];
  bool binary = false, ok = false, seen_element = false;
  int64_t count = 0;
  int n_props = 0, xyz_off[3] = {-1, -1, -1};
  std::vector<int> prop_sizes;
  bool in_vertex = false;

  auto prop_size = [](const char* t) -> int {
    if (!std::strcmp(t, "float") || !std::strcmp(t, "float32") ||
        !std::strcmp(t, "int") || !std::strcmp(t, "int32") ||
        !std::strcmp(t, "uint") || !std::strcmp(t, "uint32")) return 4;
    if (!std::strcmp(t, "double") || !std::strcmp(t, "float64")) return 8;
    if (!std::strcmp(t, "short") || !std::strcmp(t, "ushort")) return 2;
    if (!std::strcmp(t, "char") || !std::strcmp(t, "uchar") ||
        !std::strcmp(t, "int8") || !std::strcmp(t, "uint8")) return 1;
    return -1;
  };

  while (std::fgets(line, sizeof line, f)) {
    char a[64], b[64], c[64];
    if (std::sscanf(line, "%63s", a) != 1) continue;
    if (!std::strcmp(a, "format")) {
      std::sscanf(line, "%*s %63s", b);
      binary = !std::strcmp(b, "binary_little_endian");
    } else if (!std::strcmp(a, "element")) {
      long element_count = 0;
      std::sscanf(line, "%*s %63s %ld", b, &element_count);
      in_vertex = !std::strcmp(b, "vertex");
      if (in_vertex) {
        if (seen_element) { std::fclose(f); return 0; }  // data of earlier
        // elements precedes the vertex block; refuse rather than misparse
        count = element_count;  // only the vertex element sets the count
      }
      seen_element = true;
      // keep scanning to end_header either way: breaking early would leave
      // the cursor inside the header and binary reads would parse text
    } else if (!std::strcmp(a, "property") && in_vertex) {
      std::sscanf(line, "%*s %63s %63s", b, c);
      int sz = prop_size(b);
      if (sz < 0) { std::fclose(f); return 0; }  // list property
      if (!std::strcmp(c, "x")) xyz_off[0] = n_props;
      if (!std::strcmp(c, "y")) xyz_off[1] = n_props;
      if (!std::strcmp(c, "z")) xyz_off[2] = n_props;
      prop_sizes.push_back(sz);
      n_props++;
      ok = true;
    } else if (!std::strcmp(a, "end_header")) {
      break;
    }
  }
  if (!count || xyz_off[0] < 0) { std::fclose(f); return 0; }
  if (!out) { std::fclose(f); return count; }
  if (capacity < count * 3) { std::fclose(f); return 0; }

  if (binary) {
    int stride = 0;
    std::vector<int> offsets(n_props, 0);
    for (int i = 0; i < n_props; i++) { offsets[i] = stride; stride += prop_sizes[i]; }
    std::vector<unsigned char> row(stride);
    for (int64_t i = 0; i < count; i++) {
      if (std::fread(row.data(), 1, stride, f) != (size_t)stride) {
        std::fclose(f); return 0;
      }
      for (int d = 0; d < 3; d++) {
        float v;
        std::memcpy(&v, row.data() + offsets[xyz_off[d]], 4);
        out[i * 3 + d] = v;
      }
    }
  } else {
    std::vector<double> vals(n_props);
    for (int64_t i = 0; i < count; i++) {
      for (int p = 0; p < n_props; p++)
        if (std::fscanf(f, "%lf", &vals[p]) != 1) { std::fclose(f); return 0; }
      for (int d = 0; d < 3; d++) out[i * 3 + d] = (float)vals[xyz_off[d]];
    }
  }
  std::fclose(f);
  return count;
}

// ------------------------------------------------------- prefetch pipeline

struct Batch {
  std::vector<float> points;
  std::vector<int32_t> labels;
};

struct Pipeline {
  const float* data = nullptr;   // [M, N, 3] borrowed from caller
  const int32_t* labels = nullptr;
  int64_t num_clouds = 0, num_points = 0;
  int batch_size = 0;
  bool augment = false;
  float jitter_sigma = 0.01f, jitter_clip = 0.05f;
  uint64_t seed = 0;

  std::vector<std::thread> workers;
  std::queue<Batch*> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t max_queue = 4;
  std::atomic<bool> stop{false};

  std::vector<int64_t> order;
  std::atomic<int64_t> cursor{0};
  std::atomic<int64_t> completed{0};  // batches actually pushed to the queue
  int64_t epoch_batches = 0;
};

static void fill_batch(Pipeline* p, Batch* b, int64_t batch_idx,
                       std::mt19937_64& rng) {
  const int64_t n = p->num_points, bs = p->batch_size;
  b->points.resize(bs * n * 3);
  b->labels.resize(bs);
  std::normal_distribution<float> gauss(0.f, 1.f);
  std::uniform_real_distribution<float> uni(0.f, 2.f * (float)M_PI);
  for (int64_t i = 0; i < bs; i++) {
    int64_t src = p->order[(batch_idx * bs + i) % p->num_clouds];
    const float* cloud = p->data + src * n * 3;
    float* dst = b->points.data() + i * n * 3;
    b->labels[i] = p->labels ? p->labels[src] : 0;
    if (p->augment) {
      // fused rotate-about-Y + clipped jitter in the copy loop
      float ang = uni(rng), c = std::cos(ang), s = std::sin(ang);
      for (int64_t j = 0; j < n; j++) {
        float x = cloud[j * 3 + 0], y = cloud[j * 3 + 1], z = cloud[j * 3 + 2];
        float rx = c * x - s * z, rz = s * x + c * z;
        for (int d = 0; d < 3; d++) {
          float nz = p->jitter_sigma * gauss(rng);
          if (nz > p->jitter_clip) nz = p->jitter_clip;
          if (nz < -p->jitter_clip) nz = -p->jitter_clip;
          float base = d == 0 ? rx : (d == 1 ? y : rz);
          dst[j * 3 + d] = base + nz;
        }
      }
    } else {
      std::memcpy(dst, cloud, n * 3 * sizeof(float));
    }
  }
}

static void worker_main(Pipeline* p, int worker_id) {
  std::mt19937_64 rng(p->seed * 0x9E3779B97F4A7C15ull + worker_id);
  while (!p->stop.load()) {
    int64_t idx = p->cursor.fetch_add(1);
    if (idx >= p->epoch_batches) return;  // epoch exhausted
    Batch* b = new Batch();
    fill_batch(p, b, idx, rng);
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_space.wait(lk, [p] { return p->ready.size() < p->max_queue || p->stop; });
    if (p->stop) { delete b; return; }
    p->ready.push(b);
    p->completed.fetch_add(1);
    p->cv_ready.notify_one();
  }
}

void* sn_pipeline_create(const float* data, const int32_t* labels,
                         int64_t num_clouds, int64_t num_points,
                         int batch_size, int augment, uint64_t seed,
                         int num_workers) {
  auto* p = new Pipeline();
  p->data = data;
  p->labels = labels;
  p->num_clouds = num_clouds;
  p->num_points = num_points;
  p->batch_size = batch_size;
  p->augment = augment != 0;
  p->seed = seed;
  p->epoch_batches = num_clouds / batch_size;
  p->order.resize(num_clouds);
  for (int64_t i = 0; i < num_clouds; i++) p->order[i] = i;
  std::mt19937_64 rng(seed);
  for (int64_t i = num_clouds - 1; i > 0; i--) {
    std::swap(p->order[i], p->order[rng() % (i + 1)]);
  }
  int nw = num_workers > 0 ? num_workers : 2;
  for (int w = 0; w < nw; w++) p->workers.emplace_back(worker_main, p, w);
  return p;
}

int64_t sn_pipeline_epoch_batches(void* handle) {
  return static_cast<Pipeline*>(handle)->epoch_batches;
}

// Blocks until a batch is ready; copies into caller buffers. Returns 1 on
// success, 0 when the epoch is exhausted.
int sn_pipeline_next(void* handle, float* points_out, int32_t* labels_out) {
  auto* p = static_cast<Pipeline*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  // A worker bumps `cursor` when it CLAIMS a batch but `completed` only when
  // the batch is in the queue — terminate on completed, not cursor, or
  // in-flight batches get dropped at epoch end.
  p->cv_ready.wait(lk, [p] {
    return !p->ready.empty() || p->completed.load() >= p->epoch_batches;
  });
  if (p->ready.empty()) return 0;
  Batch* b = p->ready.front();
  p->ready.pop();
  p->cv_space.notify_one();
  lk.unlock();
  std::memcpy(points_out, b->points.data(), b->points.size() * sizeof(float));
  std::memcpy(labels_out, b->labels.data(), b->labels.size() * sizeof(int32_t));
  delete b;
  return 1;
}

void sn_pipeline_destroy(void* handle) {
  auto* p = static_cast<Pipeline*>(handle);
  p->stop.store(true);
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  while (!p->ready.empty()) { delete p->ready.front(); p->ready.pop(); }
  delete p;
}

}  // extern "C"
