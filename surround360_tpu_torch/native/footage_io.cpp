// Native footage IO + raw conversion hot path of surround360_tpu_torch
// (its own copy of the reference package's native/footage_io.cpp):
// - RawConverter (surround360_render/source/camera_isp/RawConverter.cpp):
//   8/12-bit packed sensor frames -> 16-bit planes (and the 12-bit packer
//   used by the capture simulator);
// - the consumer-thread footage writer of the capture app
//   (surround360_camera_ctl_ui/source/CameraController.cpp:393-467):
//   4096-byte header + per-frame (frameSize, serial) stamping, sequential
//   appends;
// - the capture daemon's single-producer / single-consumer ring buffer
//   (surround360_camera_ctl_ui/source/ProducerConsumer.h), which decouples
//   frame production from disk writes.
//
// A plain C ABI for ctypes, built with g++ at first use (native/__init__.py).

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" {

// ---- raw conversion (RawConverter.cpp:15-58) ----------------------------

void s360_convert8(const uint8_t* in, uint16_t* out, int64_t count) {
  for (int64_t i = 0; i < count; ++i) {
    out[i] = static_cast<uint16_t>(in[i]) * 0x101;
  }
}

void s360_convert12(const uint8_t* in, uint16_t* out, int64_t width,
                    int64_t height) {
  const int64_t row_bytes = width * 3 / 2;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* row = in + y * row_bytes;
    uint16_t* orow = out + y * width;
    for (int64_t x = 0; x < width; x += 2) {
      const uint8_t b0 = row[0], b1 = row[1], b2 = row[2];
      uint16_t even = static_cast<uint16_t>(b0) << 4 | (b1 & 0xF);
      uint16_t odd = static_cast<uint16_t>(b2) << 4 | (b1 >> 4);
      orow[x] = static_cast<uint16_t>(even << 4 | even >> 8);
      orow[x + 1] = static_cast<uint16_t>(odd << 4 | odd >> 8);
      row += 3;
    }
  }
}

void s360_pack12(const uint16_t* in, uint8_t* out, int64_t width,
                 int64_t height) {
  for (int64_t y = 0; y < height; ++y) {
    const uint16_t* row = in + y * width;
    uint8_t* orow = out + y * width * 3 / 2;
    for (int64_t x = 0; x < width; x += 2) {
      const uint16_t even = row[x] & 0xFFF;
      const uint16_t odd = row[x + 1] & 0xFFF;
      orow[0] = static_cast<uint8_t>(even >> 4);
      orow[1] = static_cast<uint8_t>(((odd & 0xF) << 4) | (even & 0xF));
      orow[2] = static_cast<uint8_t>(odd >> 4);
      orow += 3;
    }
  }
}

// ---- footage writer (CameraController.cpp:393-467) ----------------------

struct S360FootageWriter {
  FILE* file;
  uint32_t frame_size;
  std::vector<uint32_t> serials;
};

S360FootageWriter* s360_footage_writer_open(const char* path,
                                            uint32_t timestamp,
                                            uint32_t file_index,
                                            uint32_t file_count,
                                            uint32_t width, uint32_t height,
                                            uint32_t bits_per_pixel,
                                            const uint32_t* serials,
                                            uint32_t num_cameras) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  uint32_t header[8] = {0xfaceb00c, timestamp,      file_index,
                        file_count, width,          height,
                        bits_per_pixel, num_cameras};
  uint8_t page[4096];
  memset(page, 0, sizeof(page));
  memcpy(page, header, sizeof(header));
  if (fwrite(page, 1, sizeof(page), f) != sizeof(page)) {
    fclose(f);
    return nullptr;
  }
  auto* w = new S360FootageWriter();
  w->file = f;
  w->frame_size = width * height * bits_per_pixel / 8;
  w->serials.assign(serials, serials + num_cameras);
  return w;
}

// writes one camera's frame, stamping (frameSize, serial) over the first
// 8 payload bytes like the capture consumer does
int s360_footage_writer_write(S360FootageWriter* w, uint32_t camera,
                              const uint8_t* payload) {
  if (!w || camera >= w->serials.size()) return -1;
  uint32_t stamp[2] = {w->frame_size, w->serials[camera]};
  if (fwrite(stamp, 1, sizeof(stamp), w->file) != sizeof(stamp)) return -1;
  const uint32_t rest = w->frame_size - sizeof(stamp);
  if (fwrite(payload + sizeof(stamp), 1, rest, w->file) != rest) return -1;
  return 0;
}

int s360_footage_writer_close(S360FootageWriter* w) {
  if (!w) return -1;
  int rc = fclose(w->file);
  delete w;
  return rc;
}

// ---- producer/consumer ring buffer (ProducerConsumer.h:35-159) ----------

struct S360Ring {
  std::vector<uint8_t> storage;
  std::vector<size_t> sizes;
  size_t slot_size;
  size_t n_slots;
  size_t head = 0;  // next write
  size_t tail = 0;  // next read
  size_t count = 0;
  bool done = false;
  std::mutex mu;
  std::condition_variable not_full, not_empty;
};

S360Ring* s360_ring_create(int64_t slot_size, int64_t n_slots) {
  if (slot_size <= 0 || n_slots <= 0) return nullptr;
  auto* r = new S360Ring();
  r->slot_size = static_cast<size_t>(slot_size);
  r->n_slots = static_cast<size_t>(n_slots);
  r->storage.resize(r->slot_size * r->n_slots);
  r->sizes.resize(r->n_slots, 0);
  return r;
}

// blocks until a slot is free; returns 0, -1 after s360_ring_done, or -2
// (without blocking) for a payload larger than a slot
int s360_ring_push(S360Ring* r, const uint8_t* data, int64_t size) {
  if (size < 0 || static_cast<size_t>(size) > r->slot_size) return -2;
  std::unique_lock<std::mutex> lk(r->mu);
  r->not_full.wait(lk, [r] { return r->count < r->n_slots || r->done; });
  if (r->done) return -1;
  memcpy(&r->storage[r->head * r->slot_size], data, static_cast<size_t>(size));
  r->sizes[r->head] = static_cast<size_t>(size);
  r->head = (r->head + 1) % r->n_slots;
  ++r->count;
  r->not_empty.notify_one();
  return 0;
}

// blocks until data; returns the popped size, or -1 once the ring is done
// and drained (a payload may have size 0)
int64_t s360_ring_pop(S360Ring* r, uint8_t* out) {
  std::unique_lock<std::mutex> lk(r->mu);
  r->not_empty.wait(lk, [r] { return r->count > 0 || r->done; });
  if (r->count == 0) return -1;
  const size_t size = r->sizes[r->tail];
  memcpy(out, &r->storage[r->tail * r->slot_size], size);
  r->tail = (r->tail + 1) % r->n_slots;
  --r->count;
  r->not_full.notify_one();
  return static_cast<int64_t>(size);
}

// wakes every waiter: pushes fail from now on, pops drain what is left
void s360_ring_done(S360Ring* r) {
  std::lock_guard<std::mutex> lk(r->mu);
  r->done = true;
  r->not_full.notify_all();
  r->not_empty.notify_all();
}

void s360_ring_destroy(S360Ring* r) { delete r; }

}  // extern "C"
