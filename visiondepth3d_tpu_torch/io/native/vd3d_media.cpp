// vd3d_media: native host-side media I/O for the PyTorch port of VisionDepth3D.
//
// The PyTorch port's own copy of visiondepth3d_tpu/native/vd3d_media.cpp
// (same C ABI, same behaviour): a zero-dependency YUV4MPEG2 (y4m)
// demuxer/muxer with YUV420<->RGB conversion and a double-buffered
// background reader, consumed via ctypes. FFmpeg, when present on the host,
// is driven through pipes carrying y4m, so this code is the single raw-video
// path either way.
//
// Build: io/y4m.py compiles it with g++ at first use into io/_build/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <vector>
#include <atomic>

namespace {

struct Y4MInfo {
  int width = 0;
  int height = 0;
  int fps_num = 25;
  int fps_den = 1;
  int interlace = 0;   // 'p' progressive assumed
  int chroma420 = 1;   // only 420 family supported
  long header_end = 0; // byte offset of first FRAME marker
};

// BT.601 limited-range YUV420 <-> RGB, matching FFmpeg/OpenCV defaults for
// yuv420p without explicit colorspace tags.
inline uint8_t clamp_u8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void yuv420_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                   int w, int h, uint8_t* rgb) {
  const int cw = (w + 1) / 2;
  for (int j = 0; j < h; ++j) {
    const uint8_t* yrow = y + (size_t)j * w;
    const uint8_t* urow = u + (size_t)(j / 2) * cw;
    const uint8_t* vrow = v + (size_t)(j / 2) * cw;
    uint8_t* out = rgb + (size_t)j * w * 3;
    for (int i = 0; i < w; ++i) {
      const int c = ((int)yrow[i] - 16) * 298;
      const int d = (int)urow[i / 2] - 128;
      const int e = (int)vrow[i / 2] - 128;
      out[3 * i + 0] = clamp_u8((c + 409 * e + 128) >> 8);
      out[3 * i + 1] = clamp_u8((c - 100 * d - 208 * e + 128) >> 8);
      out[3 * i + 2] = clamp_u8((c + 516 * d + 128) >> 8);
    }
  }
}

void rgb_to_yuv420(const uint8_t* rgb, int w, int h,
                   uint8_t* y, uint8_t* u, uint8_t* v) {
  const int cw = (w + 1) / 2;
  const int ch = (h + 1) / 2;
  // Y plane full res
  for (int j = 0; j < h; ++j) {
    const uint8_t* in = rgb + (size_t)j * w * 3;
    uint8_t* yrow = y + (size_t)j * w;
    for (int i = 0; i < w; ++i) {
      const int r = in[3 * i], g = in[3 * i + 1], b = in[3 * i + 2];
      yrow[i] = clamp_u8((66 * r + 129 * g + 25 * b + 128 + (16 << 8)) >> 8);
    }
  }
  // chroma: average each 2x2 block
  for (int j = 0; j < ch; ++j) {
    uint8_t* urow = u + (size_t)j * cw;
    uint8_t* vrow = v + (size_t)j * cw;
    for (int i = 0; i < cw; ++i) {
      int rs = 0, gs = 0, bs = 0, n = 0;
      for (int dj = 0; dj < 2; ++dj) {
        const int jj = 2 * j + dj;
        if (jj >= h) continue;
        for (int di = 0; di < 2; ++di) {
          const int ii = 2 * i + di;
          if (ii >= w) continue;
          const uint8_t* px = rgb + ((size_t)jj * w + ii) * 3;
          rs += px[0]; gs += px[1]; bs += px[2];
          ++n;
        }
      }
      const int r = rs / n, g = gs / n, b = bs / n;
      urow[i] = clamp_u8(((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128);
      vrow[i] = clamp_u8(((112 * r - 94 * g - 18 * b + 128) >> 8) + 128);
    }
  }
}

bool parse_y4m_header(FILE* f, Y4MInfo* info) {
  char line[512];
  if (!fgets(line, sizeof line, f)) return false;
  if (strncmp(line, "YUV4MPEG2", 9) != 0) return false;
  char* tok = strtok(line + 9, " \n");
  while (tok) {
    switch (tok[0]) {
      case 'W': info->width = atoi(tok + 1); break;
      case 'H': info->height = atoi(tok + 1); break;
      case 'F': sscanf(tok + 1, "%d:%d", &info->fps_num, &info->fps_den); break;
      case 'C':
        info->chroma420 = (strncmp(tok + 1, "420", 3) == 0);
        break;
      default: break;
    }
    tok = strtok(nullptr, " \n");
  }
  info->header_end = ftell(f);
  return info->width > 0 && info->height > 0 && info->chroma420;
}

struct Reader {
  FILE* f = nullptr;
  std::string path;
  Y4MInfo info;
  size_t ysz = 0, csz = 0;
  bool raw_planes = false;  // stage Y/U/V bytes, skip RGB conversion
  std::vector<uint8_t> ybuf, ubuf, vbuf;

  // double-buffer prefetch
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<uint8_t> staged;       // decoded RGB frame ready for pickup
  bool staged_full = false;
  bool eof = false;
  std::atomic<bool> stop{false};

  bool read_frame_raw(uint8_t* dst) {
    char marker[6];
    if (fread(marker, 1, 5, f) != 5) return false;
    if (strncmp(marker, "FRAME", 5) != 0) return false;
    int ch;
    while ((ch = fgetc(f)) != '\n') {
      if (ch == EOF) return false;
    }
    if (raw_planes) {
      // plane passthrough: the device does the colorspace math
      // (ops/convert.py yuv420_to_rgb_u8) — host decode is pure fread
      if (fread(dst, 1, ysz, f) != ysz) return false;
      if (fread(dst + ysz, 1, csz, f) != csz) return false;
      if (fread(dst + ysz + csz, 1, csz, f) != csz) return false;
      return true;
    }
    if (fread(ybuf.data(), 1, ysz, f) != ysz) return false;
    if (fread(ubuf.data(), 1, csz, f) != csz) return false;
    if (fread(vbuf.data(), 1, csz, f) != csz) return false;
    yuv420_to_rgb(ybuf.data(), ubuf.data(), vbuf.data(),
                  info.width, info.height, dst);
    return true;
  }

  // Stop the prefetch thread and wait for it. The flag is set under the
  // mutex: set outside it, the wake-up can land between the thread's check
  // of its wait condition and its sleep, and the thread then sleeps forever
  // (the join never returns).
  void halt() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv.notify_all();
    if (worker.joinable()) worker.join();
  }

  void prefetch_loop() {
    std::vector<uint8_t> local(raw_planes ? (ysz + 2 * csz)
                                          : (size_t)info.width * info.height * 3);
    while (!stop.load()) {
      if (!read_frame_raw(local.data())) {
        std::lock_guard<std::mutex> lk(mu);
        eof = true;
        cv.notify_all();
        return;
      }
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] { return !staged_full || stop.load(); });
      if (stop.load()) return;
      staged.swap(local);
      staged_full = true;
      cv.notify_all();
    }
  }
};

struct Writer {
  FILE* f = nullptr;
  int width = 0, height = 0;
  std::vector<uint8_t> ybuf, ubuf, vbuf;
};

}  // namespace

extern "C" {

static void* y4m_open_impl(const char* path, int raw_planes) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  r->path = path;
  r->raw_planes = raw_planes != 0;
  if (!parse_y4m_header(f, &r->info)) {
    fclose(f);
    delete r;
    return nullptr;
  }
  r->ysz = (size_t)r->info.width * r->info.height;
  const int cw = (r->info.width + 1) / 2, chh = (r->info.height + 1) / 2;
  r->csz = (size_t)cw * chh;
  r->ybuf.resize(r->ysz);
  r->ubuf.resize(r->csz);
  r->vbuf.resize(r->csz);
  r->staged.resize(r->raw_planes ? (r->ysz + 2 * r->csz) : r->ysz * 3);
  r->worker = std::thread([r] { r->prefetch_loop(); });
  return r;
}

void* vd3d_y4m_open(const char* path) { return y4m_open_impl(path, 0); }

// Raw-plane mode: vd3d_y4m_read fills ysz + 2*csz bytes (Y then U then V)
// instead of RGB — the device runs the colorspace conversion.
void* vd3d_y4m_open_raw(const char* path) { return y4m_open_impl(path, 1); }

void vd3d_y4m_info(void* handle, int* w, int* h, int* fps_num, int* fps_den) {
  auto* r = (Reader*)handle;
  *w = r->info.width;
  *h = r->info.height;
  *fps_num = r->info.fps_num;
  *fps_den = r->info.fps_den;
}

// Returns 1 on success, 0 on EOF. rgb must hold w*h*3 bytes.
int vd3d_y4m_read(void* handle, uint8_t* rgb) {
  auto* r = (Reader*)handle;
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv.wait(lk, [&] { return r->staged_full || r->eof; });
  if (!r->staged_full) return 0;
  memcpy(rgb, r->staged.data(), r->staged.size());
  r->staged_full = false;
  r->cv.notify_all();
  return 1;
}

void vd3d_y4m_close(void* handle) {
  auto* r = (Reader*)handle;
  r->halt();
  fclose(r->f);
  delete r;
}

// Frame count from the file size, assuming fixed-size records (plain
// "FRAME\n" markers, which is what this muxer and FFmpeg's y4m muxer
// emit). Returns -1 when the size doesn't divide evenly (per-frame
// parameters present) or the stream isn't a regular file — callers then
// fall back to a sequential scan. Thread-safe: touches only immutable
// header info plus a stat of the path-backed descriptor.
long vd3d_y4m_count(void* handle) {
  auto* r = (Reader*)handle;
  const long rec = 6 + (long)r->ysz + 2 * (long)r->csz;
  long end;
  {
    // use a second descriptor so the prefetch thread's FILE* is untouched
    FILE* f2 = fopen(r->path.c_str(), "rb");
    if (!f2) return -1;
    if (fseek(f2, 0, SEEK_END) != 0) { fclose(f2); return -1; }
    end = ftell(f2);
    fclose(f2);
  }
  const long payload = end - r->info.header_end;
  if (payload < 0 || payload % rec != 0) return -1;
  return payload / rec;
}

// Seek to an absolute frame index. Stops the prefetch thread, repositions,
// and restarts it. Returns 1 on success, 0 when the stream is not
// seekable / records are not fixed-size (the marker is re-verified by the
// next read, which reports EOF on a mis-seek rather than corrupt frames).
int vd3d_y4m_seek(void* handle, long frame_idx) {
  auto* r = (Reader*)handle;
  if (frame_idx < 0) return 0;
  r->halt();
  const long rec = 6 + (long)r->ysz + 2 * (long)r->csz;
  int ok = fseek(r->f, r->info.header_end + frame_idx * rec, SEEK_SET) == 0;
  if (ok) {
    char marker[6] = {0};
    ok = fread(marker, 1, 6, r->f) == 6 && strncmp(marker, "FRAME", 5) == 0;
    fseek(r->f, r->info.header_end + frame_idx * rec, SEEK_SET);
  }
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->staged_full = false;
    r->eof = !ok;
  }
  r->stop.store(false);
  if (ok) r->worker = std::thread([r] { r->prefetch_loop(); });
  return ok;
}

void* vd3d_y4m_writer_open2(const char* path, int w, int h,
                            int fps_num, int fps_den, int append) {
  FILE* f = fopen(path, append ? "ab" : "wb");
  if (!f) return nullptr;
  auto* wr = new Writer();
  wr->f = f;
  wr->width = w;
  wr->height = h;
  const int cw = (w + 1) / 2, ch = (h + 1) / 2;
  wr->ybuf.resize((size_t)w * h);
  wr->ubuf.resize((size_t)cw * ch);
  wr->vbuf.resize((size_t)cw * ch);
  if (!append) {
    fprintf(f, "YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 C420jpeg\n", w, h, fps_num, fps_den);
  }
  return wr;
}

void* vd3d_y4m_writer_open(const char* path, int w, int h,
                           int fps_num, int fps_den) {
  return vd3d_y4m_writer_open2(path, w, h, fps_num, fps_den, 0);
}

int vd3d_y4m_write(void* handle, const uint8_t* rgb) {
  auto* wr = (Writer*)handle;
  rgb_to_yuv420(rgb, wr->width, wr->height,
                wr->ybuf.data(), wr->ubuf.data(), wr->vbuf.data());
  fputs("FRAME\n", wr->f);
  if (fwrite(wr->ybuf.data(), 1, wr->ybuf.size(), wr->f) != wr->ybuf.size()) return 0;
  if (fwrite(wr->ubuf.data(), 1, wr->ubuf.size(), wr->f) != wr->ubuf.size()) return 0;
  if (fwrite(wr->vbuf.data(), 1, wr->vbuf.size(), wr->f) != wr->vbuf.size()) return 0;
  return 1;
}

// Plane passthrough: the device already produced Y/U/V (ops/convert.py
// rgb_u8_to_yuv420 runs the colorspace math on TPU), the host only
// streams bytes — this leg is pure fwrite and sustains well past the
// 60 fps @ 1080p Full-SBS north star on one core.
int vd3d_y4m_write_planes(void* handle, const uint8_t* y, const uint8_t* u,
                          const uint8_t* v) {
  auto* wr = (Writer*)handle;
  const size_t ysz = (size_t)wr->width * wr->height;
  const size_t csz = (size_t)((wr->width + 1) / 2) * ((wr->height + 1) / 2);
  fputs("FRAME\n", wr->f);
  if (fwrite(y, 1, ysz, wr->f) != ysz) return 0;
  if (fwrite(u, 1, csz, wr->f) != csz) return 0;
  if (fwrite(v, 1, csz, wr->f) != csz) return 0;
  return 1;
}

void vd3d_y4m_writer_close(void* handle) {
  auto* wr = (Writer*)handle;
  fclose(wr->f);
  delete wr;
}

// Raw gray16/gray8 helpers for depth export (FFV1 gray16le analog is the
// npy/raw path; see io/depth_io.py).

}  // extern "C"
