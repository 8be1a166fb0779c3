// vulcan_tpu_torch native runtime: dataset decode/prefetch + mesh export.
//
// Host work that overlaps with the device's: frame decode and mesh
// serialization.
//
//   * PNG decode on zlib alone (inflate + the five PNG row filters): TUM
//     16-bit depth -> float32 metres, 8-bit RGB -> float32 [0,1].  The
//     formats decoded are non-interlaced 8-bit gray, RGB and RGBA and
//     16-bit gray; anything else fails with an error code, never with a
//     guess.  libpng is not used: the machines this runs on do not all
//     have it, while every one has zlib.
//   * Prefetching loader: worker threads decode ahead into a bounded ring
//     buffer while the device runs the previous step.
//   * PLY writer with O(n) hash-based vertex welding (the numpy welder in
//     io/ply.py sorts, O(n log n)): the reference's native writer's file,
//     byte for byte, from an open-addressed table.
//
// Pixels convert to float by division (v / scale, v / 255), so a frame
// decoded here is bit-equal to ``uint16_array.astype(float32) / scale``.
//
// C ABI only (ctypes-friendly).

#include <zlib.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Error codes, shared with vulcan_tpu_torch/native/__init__.py (_ERRORS).
enum Status {
  kOk = 0,
  kOpen = 1,         // the file cannot be opened or read
  kSignature = 2,    // not a PNG file
  kCorrupt = 3,      // a chunk is truncated, out of order or fails its CRC
  kUnsupported = 4,  // interlaced, palette, or a depth/colour type not decoded
  kInflate = 5,      // the image data does not inflate to the expected size
  kFilter = 6,       // a row names a filter type outside 0..4
  kShape = 7,        // width/height other than the caller expects
  kChannels = 8,     // the wrong kind of image for the call (e.g. RGB as depth)
};

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

struct Image {
  int width = 0, height = 0, channels = 0, bit_depth = 0;
  // Row-major samples; 16-bit samples in host (little-endian) order, alpha
  // stripped.
  std::vector<uint8_t> data;
};

const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 |
         (uint32_t)p[3];
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  uint8_t buf[65536];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), fp)) > 0) out->insert(out->end(), buf, buf + n);
  bool ok = !ferror(fp);
  fclose(fp);
  return ok;
}

struct Header {
  int width = 0, height = 0, bit_depth = 0, color_type = 0, interlace = 0;
};

// Samples per pixel of the colour types decoded (0 gray, 2 RGB, 6 RGBA);
// 0 for the others (3 palette, 4 gray+alpha, unknown).
int samples_of(int color_type) {
  switch (color_type) {
    case 0: return 1;
    case 2: return 3;
    case 6: return 4;
    default: return 0;
  }
}

// Walks the chunks: fills the header and, when idat != null, the
// concatenated image data.  Stops after IHDR when idat is null.
int parse_chunks(const std::vector<uint8_t>& file, Header* hdr,
                 std::vector<uint8_t>* idat) {
  if (file.size() < 8 || memcmp(file.data(), kSig, 8) != 0) return kSignature;
  size_t pos = 8;
  bool have_header = false, have_end = false;
  while (pos + 12 <= file.size()) {
    uint32_t len = be32(&file[pos]);
    if (len > file.size() - pos - 12) return kCorrupt;
    const uint8_t* type = &file[pos + 4];
    const uint8_t* body = type + 4;
    uint32_t crc = be32(body + len);
    if ((uint32_t)crc32(crc32(0L, Z_NULL, 0), type, len + 4) != crc) return kCorrupt;
    if (!have_header) {
      if (memcmp(type, "IHDR", 4) != 0 || len != 13) return kCorrupt;
      hdr->width = (int)be32(body);
      hdr->height = (int)be32(body + 4);
      hdr->bit_depth = body[8];
      hdr->color_type = body[9];
      hdr->interlace = body[12];
      if (hdr->width <= 0 || hdr->height <= 0 || body[10] != 0 || body[11] != 0)
        return kCorrupt;
      have_header = true;
      if (!idat) return kOk;
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat->insert(idat->end(), body, body + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      have_end = true;
      break;
    } else if (memcmp(type, "PLTE", 4) == 0) {
      return kUnsupported;
    } else if (!(type[0] & 0x20)) {
      return kUnsupported;  // an unknown critical chunk
    }
    pos += 12 + (size_t)len;
  }
  return have_header && have_end ? kOk : kCorrupt;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

int decode_png(const char* path, Image* out) {
  std::vector<uint8_t> file;
  if (!read_file(path, &file)) return kOpen;
  Header hdr;
  std::vector<uint8_t> idat;
  int rc = parse_chunks(file, &hdr, &idat);
  if (rc != kOk) return rc;
  const int spp = samples_of(hdr.color_type);
  const bool depth_ok =
      hdr.bit_depth == 8 || (hdr.bit_depth == 16 && hdr.color_type == 0);
  if (hdr.interlace != 0 || spp == 0 || !depth_ok)
    return kUnsupported;
  const size_t bpp = (size_t)spp * (hdr.bit_depth / 8);  // bytes a pixel
  const size_t row = bpp * (size_t)hdr.width;
  const size_t stride = row + 1;                         // + filter byte
  std::vector<uint8_t> raw(stride * (size_t)hdr.height);

  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return kInflate;
  zs.next_in = idat.data();
  zs.avail_in = (uInt)idat.size();
  zs.next_out = raw.data();
  zs.avail_out = (uInt)raw.size();
  int zrc = inflate(&zs, Z_FINISH);
  size_t got = zs.total_out;
  inflateEnd(&zs);
  if (zrc != Z_STREAM_END || got != raw.size()) return kInflate;

  // Unfilter in place, row by row (each row reads the one above it).
  for (int y = 0; y < hdr.height; y++) {
    uint8_t* cur = &raw[(size_t)y * stride + 1];
    const uint8_t* up = y > 0 ? &raw[(size_t)(y - 1) * stride + 1] : nullptr;
    switch (cur[-1]) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < row; i++) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
        break;
      case 2:
        if (up)
          for (size_t i = 0; i < row; i++) cur[i] = (uint8_t)(cur[i] + up[i]);
        break;
      case 3:
        for (size_t i = 0; i < row; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = up ? up[i] : 0;
          cur[i] = (uint8_t)(cur[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < row; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          cur[i] = (uint8_t)(cur[i] + paeth(a, b, c));
        }
        break;
      default:
        return kFilter;
    }
  }

  out->width = hdr.width;
  out->height = hdr.height;
  out->bit_depth = hdr.bit_depth;
  out->channels = hdr.color_type == 6 ? 3 : spp;  // alpha stripped
  const size_t n = (size_t)hdr.width * hdr.height;
  if (hdr.bit_depth == 16) {
    out->data.resize(n * 2);
    uint16_t* dst = reinterpret_cast<uint16_t*>(out->data.data());
    for (int y = 0; y < hdr.height; y++) {
      const uint8_t* src = &raw[(size_t)y * stride + 1];
      for (int x = 0; x < hdr.width; x++)
        dst[(size_t)y * hdr.width + x] = (uint16_t)(src[2 * x] << 8 | src[2 * x + 1]);
    }
  } else {
    out->data.resize(n * out->channels);
    for (int y = 0; y < hdr.height; y++) {
      const uint8_t* src = &raw[(size_t)y * stride + 1];
      uint8_t* dst = &out->data[(size_t)y * hdr.width * out->channels];
      if (spp == out->channels) {
        memcpy(dst, src, row);
      } else {  // RGBA -> RGB
        for (int x = 0; x < hdr.width; x++) memcpy(dst + 3 * x, src + 4 * x, 3);
      }
    }
  }
  return kOk;
}

// Depth image -> metres: 16-bit or 8-bit gray, divided by depth_scale.
int depth_to_float(const Image& img, float depth_scale, float* out) {
  if (img.channels != 1) return kChannels;
  const size_t n = (size_t)img.width * img.height;
  if (img.bit_depth == 16) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(img.data.data());
    for (size_t i = 0; i < n; i++) out[i] = (float)p[i] / depth_scale;
  } else {
    for (size_t i = 0; i < n; i++) out[i] = (float)img.data[i] / depth_scale;
  }
  return kOk;
}

// Colour image -> [0,1]: 8-bit RGB (or RGBA, alpha dropped), v / 255.
int rgb_to_float(const Image& img, float* out) {
  if (img.channels != 3 || img.bit_depth != 8) return kChannels;
  const size_t n = (size_t)img.width * img.height * 3;
  for (size_t i = 0; i < n; i++) out[i] = (float)img.data[i] / 255.0f;
  return kOk;
}

// ---------------------------------------------------------------------------
// Frame loader with prefetch
// ---------------------------------------------------------------------------

struct Frame {
  std::vector<float> depth;   // H*W metres
  std::vector<float> color;   // H*W*3 in [0,1]
  int index = -1;
  int status = kOk;
};

struct Loader {
  std::vector<std::string> depth_paths;
  std::vector<std::string> rgb_paths;  // may be empty strings
  int height = 0, width = 0;
  float depth_scale = 5000.0f;

  std::vector<Frame> ring;
  size_t capacity = 0;
  std::atomic<int> next_to_decode{0};
  int next_to_serve = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::vector<uint8_t> slot_ready;  // guarded by mu

  int n_frames() const { return (int)depth_paths.size(); }
};

// A frame whose depth or colour fails to decode fails as a whole: colour
// is never silently left black.
int decode_frame(Loader* L, int idx, Frame* f) {
  f->index = idx;
  const size_t n = (size_t)L->width * L->height;
  Image dimg;
  int rc = decode_png(L->depth_paths[idx].c_str(), &dimg);
  if (rc != kOk) return rc;
  if (dimg.width != L->width || dimg.height != L->height) return kShape;
  f->depth.resize(n);
  rc = depth_to_float(dimg, L->depth_scale, f->depth.data());
  if (rc != kOk) return rc;
  f->color.assign(n * 3, 0.0f);
  if (!L->rgb_paths[idx].empty()) {
    Image cimg;
    rc = decode_png(L->rgb_paths[idx].c_str(), &cimg);
    if (rc != kOk) return rc;
    if (cimg.width != L->width || cimg.height != L->height) return kShape;
    rc = rgb_to_float(cimg, f->color.data());
  }
  return rc;
}

void worker_main(Loader* L) {
  while (!L->stop.load()) {
    int idx = L->next_to_decode.fetch_add(1);
    if (idx >= L->n_frames()) return;
    size_t slot = idx % L->capacity;
    {
      // Wait until the slot is free (the consumer has advanced far enough).
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_space.wait(lk, [&] {
        return L->stop.load() || idx - L->next_to_serve < (int)L->capacity;
      });
      if (L->stop.load()) return;
    }
    Frame f;
    f.status = decode_frame(L, idx, &f);
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->ring[slot] = std::move(f);
      L->slot_ready[slot] = 1;
    }
    L->cv_ready.notify_all();
  }
}

// ---------------------------------------------------------------------------
// PLY writer with hash welding
// ---------------------------------------------------------------------------

// One slot of the weld table: a vertex's grid key and its id (-1: empty).
struct Slot {
  int32_t x, y, z, id;
};

// Same prime mix as the voxel hash, then a multiplicative spread into the
// top ``bits`` bits (the table's size is a power of two).
size_t weld_slot(int32_t x, int32_t y, int32_t z, int bits) {
  uint64_t h = ((uint64_t)(uint32_t)x * 73856093u) ^
               ((uint64_t)(uint32_t)y * 19349669u) ^
               ((uint64_t)(uint32_t)z * 83492791u);
  return (size_t)((h * 0x9E3779B97F4A7C15ull) >> (64 - bits));
}

void put_bytes(std::vector<uint8_t>* out, const void* p, size_t n) {
  const uint8_t* b = static_cast<const uint8_t*>(p);
  out->insert(out->end(), b, b + n);
}

}  // namespace

extern "C" {

// --- one-shot decode (the TUM reader's probe and load) ---
// Reads the header only.  Returns 0 and fills width/height, or an error.
int vt_png_probe(const char* path, int* width, int* height) {
  std::vector<uint8_t> file;
  if (!read_file(path, &file)) return kOpen;
  Header hdr;
  int rc = parse_chunks(file, &hdr, nullptr);
  if (rc != kOk) return rc;
  *width = hdr.width;
  *height = hdr.height;
  return kOk;
}

// out: expect_w*expect_h floats (metres).
int vt_decode_depth(const char* path, float depth_scale, float* out,
                    int expect_w, int expect_h) {
  Image img;
  int rc = decode_png(path, &img);
  if (rc != kOk) return rc;
  if (img.width != expect_w || img.height != expect_h) return kShape;
  return depth_to_float(img, depth_scale, out);
}

// out: expect_w*expect_h*3 floats in [0,1].
int vt_decode_rgb(const char* path, float* out, int expect_w, int expect_h) {
  Image img;
  int rc = decode_png(path, &img);
  if (rc != kOk) return rc;
  if (img.width != expect_w || img.height != expect_h) return kShape;
  return rgb_to_float(img, out);
}

// --- prefetching loader ---
void* vt_loader_create(const char** depth_paths, const char** rgb_paths,
                       int n, int width, int height, float depth_scale,
                       int capacity, int n_threads) {
  Loader* L = new Loader();
  L->depth_paths.assign(depth_paths, depth_paths + n);
  L->rgb_paths.resize(n);
  for (int i = 0; i < n; i++)
    L->rgb_paths[i] = rgb_paths && rgb_paths[i] ? rgb_paths[i] : "";
  L->width = width;
  L->height = height;
  L->depth_scale = depth_scale;
  L->capacity = capacity > 0 ? capacity : 4;
  L->ring.resize(L->capacity);
  L->slot_ready.assign(L->capacity, 0);
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; i++) L->workers.emplace_back(worker_main, L);
  return L;
}

// Blocks until frame `next_to_serve` is decoded; returns 0 ok, 1 end,
// 2 decode error (its status in *status).
int vt_loader_next(void* handle, float* out_depth, float* out_color,
                   int* status) {
  Loader* L = static_cast<Loader*>(handle);
  int idx = L->next_to_serve;
  if (idx >= L->n_frames()) return 1;
  size_t slot = idx % L->capacity;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] {
    return L->slot_ready[slot] && L->ring[slot].index == idx;
  });
  Frame& f = L->ring[slot];
  *status = f.status;
  if (f.status == kOk) {
    memcpy(out_depth, f.depth.data(), f.depth.size() * sizeof(float));
    memcpy(out_color, f.color.data(), f.color.size() * sizeof(float));
  }
  L->slot_ready[slot] = 0;
  L->next_to_serve = idx + 1;
  lk.unlock();
  L->cv_space.notify_all();
  return f.status == kOk ? 0 : 2;
}

void vt_loader_destroy(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// --- PLY export ---
// positions/colors: n_tris * 9 floats.  Returns number of welded vertices,
// or -1 on IO error.  Vertices that round to one weld_resolution grid point
// merge; ids go out first seen first, so the file does not depend on the
// table (open addressing, linear probing, at most half full).
long vt_ply_write(const char* path, const float* positions,
                  const float* colors, long n_tris, int weld,
                  float weld_resolution) {
  const long nv_in = n_tris * 3;
  std::vector<int32_t> remap(nv_in);
  std::vector<float> verts;
  std::vector<uint8_t> vcols;
  verts.reserve(nv_in);
  vcols.reserve(nv_in);
  const float inv_res = 1.0f / weld_resolution;

  int bits = 4;
  while (((size_t)1 << bits) < (size_t)(2 * nv_in)) bits++;
  std::vector<Slot> table(weld ? (size_t)1 << bits : 0, Slot{0, 0, 0, -1});
  const size_t mask = ((size_t)1 << bits) - 1;

  long n_out = 0;
  for (long i = 0; i < nv_in; i++) {
    const float* p = positions + i * 3;
    int32_t id = -1;
    if (weld) {
      const int32_t x = (int32_t)lrintf(p[0] * inv_res);
      const int32_t y = (int32_t)lrintf(p[1] * inv_res);
      const int32_t z = (int32_t)lrintf(p[2] * inv_res);
      for (size_t s = weld_slot(x, y, z, bits);; s = (s + 1) & mask) {
        Slot& e = table[s];
        if (e.id < 0) {
          e = Slot{x, y, z, (int32_t)n_out};
          break;
        }
        if (e.x == x && e.y == y && e.z == z) {
          id = e.id;
          break;
        }
      }
    }
    if (id < 0) {
      id = (int32_t)n_out++;
      verts.insert(verts.end(), p, p + 3);
      const float* c = colors + i * 3;
      for (int k = 0; k < 3; k++) {
        float v = c[k] * 255.0f;
        vcols.push_back((uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)));
      }
    }
    remap[i] = id;
  }

  char header[512];
  int len = snprintf(
      header, sizeof(header),
      "ply\nformat binary_little_endian 1.0\ncomment vulcan-tpu mesh "
      "(native)\nelement vertex %ld\nproperty float x\nproperty float "
      "y\nproperty float z\nproperty uchar red\nproperty uchar "
      "green\nproperty uchar blue\nelement face %ld\nproperty list uchar "
      "int vertex_indices\nend_header\n",
      n_out, n_tris);
  std::vector<uint8_t> out;
  out.reserve((size_t)len + 15 * (size_t)n_out + 13 * (size_t)n_tris);
  put_bytes(&out, header, (size_t)len);
  for (long v = 0; v < n_out; v++) {
    put_bytes(&out, verts.data() + v * 3, 3 * sizeof(float));
    put_bytes(&out, vcols.data() + v * 3, 3);
  }
  const uint8_t three = 3;
  for (long t = 0; t < n_tris; t++) {
    put_bytes(&out, &three, 1);
    put_bytes(&out, remap.data() + t * 3, 3 * sizeof(int32_t));
  }
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  bool ok = fwrite(out.data(), 1, out.size(), f) == out.size();
  return (fclose(f) == 0 && ok) ? n_out : -1;
}

}  // extern "C"
