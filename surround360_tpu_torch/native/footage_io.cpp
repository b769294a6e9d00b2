// Native footage IO + raw conversion hot path of surround360_tpu_torch
// (its own copy of the reference package's native/footage_io.cpp, without
// the capture daemon's ring buffer):
// - RawConverter (surround360_render/source/camera_isp/RawConverter.cpp):
//   8/12-bit packed sensor frames -> 16-bit planes (and the 12-bit packer
//   used by the capture simulator);
// - the consumer-thread footage writer of the capture app
//   (surround360_camera_ctl_ui/source/CameraController.cpp:393-467):
//   4096-byte header + per-frame (frameSize, serial) stamping, sequential
//   appends.
//
// A plain C ABI for ctypes, built with g++ at first use (native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
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

}  // extern "C"
