// ghost_tpu_torch native host runtime: frame ring buffer + conversion
// kernels. A copy of ghost_tpu/runtime/ghost_rt.cpp (the port imports
// nothing of ghost_tpu and keeps its own copy).
//
// The reference's host runtime is torch DataLoader workers + cv2 +
// per-frame numpy/torch copies (reference utils/inference/
// video_processing.py, utils/training/Dataset.py). The pieces that touch
// every byte of a 1080p frame stream live here:
//
//   * a lock-free single-producer/single-consumer ring buffer of
//     fixed-size frame slots (decode thread -> device feeder thread);
//   * fused uint8->float32 normalize ((x/255 - .5)/.5 and
//     (x-127.5)/128 variants) and BGR<->RGB swizzle kernels, which are
//     memory-bound and vectorize to the full width of the host core;
//   * NHWC crop-resize (bilinear) for host-side thumbnailing.
//
// Exposed as a plain C ABI consumed via ctypes
// (ghost_tpu_torch/data/frames.py), which builds it with g++ at first use
// into build/ghost_tpu_torch/.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------- kernels

void gr_u8_to_f32_affine(const uint8_t* src, float* dst, int64_t n,
                         float scale, float shift) {
  // dst = src * scale + shift  (e.g. scale=1/127.5, shift=-1 for pm1)
  for (int64_t i = 0; i < n; ++i) dst[i] = (float)src[i] * scale + shift;
}

void gr_bgr_to_rgb_u8(const uint8_t* src, uint8_t* dst, int64_t npx) {
  for (int64_t i = 0; i < npx; ++i) {
    dst[3 * i + 0] = src[3 * i + 2];
    dst[3 * i + 1] = src[3 * i + 1];
    dst[3 * i + 2] = src[3 * i + 0];
  }
}

void gr_bgr_to_rgb_f32_affine(const uint8_t* src, float* dst, int64_t npx,
                              float scale, float shift) {
  for (int64_t i = 0; i < npx; ++i) {
    dst[3 * i + 0] = (float)src[3 * i + 2] * scale + shift;
    dst[3 * i + 1] = (float)src[3 * i + 1] * scale + shift;
    dst[3 * i + 2] = (float)src[3 * i + 0] * scale + shift;
  }
}

void gr_f32_to_u8_clamp(const float* src, uint8_t* dst, int64_t n,
                        float scale, float shift) {
  // dst = clamp(src * scale + shift, 0, 255)
  for (int64_t i = 0; i < n; ++i) {
    float v = src[i] * scale + shift;
    v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
    dst[i] = (uint8_t)(v + 0.5f);
  }
}

void gr_resize_bilinear_u8(const uint8_t* src, int sh, int sw, uint8_t* dst,
                           int dh, int dw, int ch) {
  // half-pixel convention (cv2.INTER_LINEAR parity up to rounding)
  for (int y = 0; y < dh; ++y) {
    float fy = ((float)y + 0.5f) * sh / dh - 0.5f;
    int y0 = fy < 0 ? 0 : (int)fy;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - (float)y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = ((float)x + 0.5f) * sw / dw - 0.5f;
      int x0 = fx < 0 ? 0 : (int)fx;
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - (float)x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < ch; ++c) {
        float a = src[(y0 * sw + x0) * ch + c];
        float b = src[(y0 * sw + x1) * ch + c];
        float d = src[(y1 * sw + x0) * ch + c];
        float e = src[(y1 * sw + x1) * ch + c];
        float top = a + (b - a) * wx;
        float bot = d + (e - d) * wx;
        dst[(y * dw + x) * ch + c] = (uint8_t)(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

// --------------------------------------------------- SPSC frame ring buffer

struct GrRing {
  uint8_t* storage;
  int64_t slot_bytes;
  int64_t n_slots;
  std::atomic<int64_t> head;  // next slot to write (producer)
  std::atomic<int64_t> tail;  // next slot to read (consumer)
  std::atomic<int> closed;
};

GrRing* gr_ring_create(int64_t n_slots, int64_t slot_bytes) {
  GrRing* r = new (std::nothrow) GrRing();
  if (!r) return nullptr;
  r->storage = (uint8_t*)std::malloc((size_t)(n_slots * slot_bytes));
  if (!r->storage) {
    delete r;
    return nullptr;
  }
  r->slot_bytes = slot_bytes;
  r->n_slots = n_slots;
  r->head.store(0);
  r->tail.store(0);
  r->closed.store(0);
  return r;
}

void gr_ring_destroy(GrRing* r) {
  if (!r) return;
  std::free(r->storage);
  delete r;
}

// returns 1 on success, 0 if full
int gr_ring_try_push(GrRing* r, const uint8_t* data, int64_t nbytes) {
  int64_t head = r->head.load(std::memory_order_relaxed);
  int64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->n_slots) return 0;  // full
  if (nbytes > r->slot_bytes) return 0;
  std::memcpy(r->storage + (head % r->n_slots) * r->slot_bytes, data,
              (size_t)nbytes);
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// returns 1 on success, 0 if empty
int gr_ring_try_pop(GrRing* r, uint8_t* out, int64_t nbytes) {
  int64_t tail = r->tail.load(std::memory_order_relaxed);
  int64_t head = r->head.load(std::memory_order_acquire);
  if (tail >= head) return 0;  // empty
  if (nbytes > r->slot_bytes) return 0;
  std::memcpy(out, r->storage + (tail % r->n_slots) * r->slot_bytes,
              (size_t)nbytes);
  r->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

int64_t gr_ring_size(GrRing* r) {
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

void gr_ring_close(GrRing* r) { r->closed.store(1, std::memory_order_release); }
int gr_ring_closed(GrRing* r) { return r->closed.load(std::memory_order_acquire); }

}  // extern "C"
