// Host runtime of the port's video writers (a plain C API for ctypes).
//
// The card owns the model path; this library owns two host-side pieces of
// the frame path, the port's own copy of the JAX package's native runtime
// (native/drba_host.cpp):
//
//   * frame format converters (BGR uint8 <-> RGB float32 in [0, 1], and the
//     BGR -> RGB uint8 flip that feeds ffmpeg's rgb24 pipe), row-parallel over
//     about one thread per MB of frame;
//   * a lock-free single-producer / single-consumer ring of fixed-size frame
//     slots, allocated once (bounded memory).
//
// Unlike the reference, the ring checks sizes: a push larger than a slot and
// a pop into a buffer smaller than the frame are refused (code -2), where the
// reference's memcpy would write past the end of the slot or of the buffer.
//
// Built by drba_tpu_torch/_build.py (HostLibrary) with the host's C++
// compiler: -O3 -std=c++17 -fPIC -pthread -shared, no -march, since a build
// made on one host may be loaded on another.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int clamp_threads(int64_t work, int requested) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 4;
  int t = requested > 0 ? requested : hw;
  // below ~1 MB a thread, starting the thread costs more than it saves
  int64_t max_useful = work / (1 << 20);
  if (max_useful < 1) max_useful = 1;
  if (t > max_useful) t = static_cast<int>(max_useful);
  return t < 1 ? 1 : t;
}

template <typename F>
void parallel_rows(int64_t rows, int threads, F&& fn) {
  if (threads <= 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (rows + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < rows ? lo + chunk : rows;
    if (lo >= hi) break;
    pool.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// BGR uint8 (H, W, 3) -> RGB float32 (H, W, 3) in [0, 1] (times 1/255).
void drba_bgr8_to_rgbf32(const uint8_t* src, float* dst, int64_t h, int64_t w,
                         int threads) {
  const float k = 1.0f / 255.0f;
  threads = clamp_threads(h * w * 3, threads);
  parallel_rows(h, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t y = lo; y < hi; ++y) {
      const uint8_t* s = src + y * w * 3;
      float* d = dst + y * w * 3;
      for (int64_t x = 0; x < w; ++x) {
        d[x * 3 + 0] = s[x * 3 + 2] * k;
        d[x * 3 + 1] = s[x * 3 + 1] * k;
        d[x * 3 + 2] = s[x * 3 + 0] * k;
      }
    }
  });
}

// BGR uint8 (H, W, 3) -> RGB uint8 (H, W, 3) into the caller's buffer: the
// writers' per-frame flip for ffmpeg's rgb24 rawvideo pipe.
void drba_bgr8_to_rgb8(const uint8_t* src, uint8_t* dst, int64_t h, int64_t w,
                       int threads) {
  threads = clamp_threads(h * w * 3, threads);
  parallel_rows(h, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t y = lo; y < hi; ++y) {
      const uint8_t* s = src + y * w * 3;
      uint8_t* d = dst + y * w * 3;
      for (int64_t x = 0; x < w; ++x) {
        d[x * 3 + 0] = s[x * 3 + 2];
        d[x * 3 + 1] = s[x * 3 + 1];
        d[x * 3 + 2] = s[x * 3 + 0];
      }
    }
  });
}

// RGB float32 (H, W, 3) -> BGR uint8 (H, W, 3): clipped to [0, 1], times 255,
// truncated (the reference's (x * 255).astype(uint8)).
void drba_rgbf32_to_bgr8(const float* src, uint8_t* dst, int64_t h, int64_t w,
                         int threads) {
  threads = clamp_threads(h * w * 3, threads);
  parallel_rows(h, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t y = lo; y < hi; ++y) {
      const float* s = src + y * w * 3;
      uint8_t* d = dst + y * w * 3;
      for (int64_t x = 0; x < w; ++x) {
        for (int c = 0; c < 3; ++c) {
          float v = s[x * 3 + c] * 255.0f;
          v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
          d[x * 3 + (2 - c)] = static_cast<uint8_t>(v);
        }
      }
    }
  });
}

// ---------------------------------------------------------------------------
// Lock-free SPSC frame ring with preallocated fixed-size slots.
// ---------------------------------------------------------------------------

struct DrbaRing {
  int64_t slot_bytes;
  int64_t capacity;  // a power of two
  std::vector<uint8_t> storage;
  std::vector<int64_t> sizes;
  std::atomic<int64_t> head{0};  // next write
  std::atomic<int64_t> tail{0};  // next read
  std::atomic<int> closed{0};
};

// capacity rounds up to a power of two; returns null for sizes < 1
void* drba_ring_create(int64_t slot_bytes, int64_t capacity) {
  if (slot_bytes < 1 || capacity < 1) return nullptr;
  int64_t cap = 1;
  while (cap < capacity) cap <<= 1;
  auto* r = new DrbaRing();
  r->slot_bytes = slot_bytes;
  r->capacity = cap;
  r->storage.resize(static_cast<size_t>(slot_bytes * cap));
  r->sizes.resize(static_cast<size_t>(cap));
  return r;
}

void drba_ring_destroy(void* ring) { delete static_cast<DrbaRing*>(ring); }

// returns 1 on success, 0 if full, -1 if closed, -2 if size > slot_bytes
int drba_ring_push(void* ring, const uint8_t* data, int64_t size) {
  auto* r = static_cast<DrbaRing*>(ring);
  if (size < 0 || size > r->slot_bytes) return -2;
  if (r->closed.load(std::memory_order_acquire)) return -1;
  int64_t head = r->head.load(std::memory_order_relaxed);
  int64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity) return 0;
  int64_t slot = head & (r->capacity - 1);
  std::memcpy(r->storage.data() + slot * r->slot_bytes, data,
              static_cast<size_t>(size));
  r->sizes[static_cast<size_t>(slot)] = size;
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// returns the frame's byte count on success, 0 if empty, -1 if closed and
// drained, -2 if the frame is larger than out_bytes (the frame stays queued)
int64_t drba_ring_pop(void* ring, uint8_t* out, int64_t out_bytes) {
  auto* r = static_cast<DrbaRing*>(ring);
  int64_t tail = r->tail.load(std::memory_order_relaxed);
  int64_t head = r->head.load(std::memory_order_acquire);
  if (tail >= head) {
    return r->closed.load(std::memory_order_acquire) ? -1 : 0;
  }
  int64_t slot = tail & (r->capacity - 1);
  int64_t size = r->sizes[static_cast<size_t>(slot)];
  if (size > out_bytes) return -2;
  std::memcpy(out, r->storage.data() + slot * r->slot_bytes,
              static_cast<size_t>(size));
  r->tail.store(tail + 1, std::memory_order_release);
  return size;
}

void drba_ring_close(void* ring) {
  static_cast<DrbaRing*>(ring)->closed.store(1, std::memory_order_release);
}

int64_t drba_ring_size(void* ring) {
  auto* r = static_cast<DrbaRing*>(ring);
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

}  // extern "C"
