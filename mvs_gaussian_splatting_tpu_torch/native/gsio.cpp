// gsio: native scene-I/O runtime for mvs_gaussian_splatting_tpu_torch (the
// port's own copy of the JAX package's gsio.cpp, same C ABI).
//
// Host file I/O around the device path: replaces the per-record Python
// struct loops for COLMAP binaries (scene/colmap_loader.py:125-241) with
// single-pass parsers over one bulk read, exposed through a plain C ABI
// consumed via ctypes (mvs_gaussian_splatting_tpu_torch/native/__init__.py).
//
// COLMAP binary layouts (little endian, colmap/src/base/reconstruction.cc):
//   points3D.bin: u64 count; per point: u64 id, 3×f64 xyz, 3×u8 rgb,
//                 f64 error, u64 track_len, track_len × (i32, i32)
//   images.bin:   u64 count; per image: i32 id, 4×f64 qvec, 3×f64 tvec,
//                 i32 camera_id, name\0, u64 n2d, n2d × (f64, f64, i64)
//   cameras.bin:  u64 count; per cam: i32 id, i32 model, u64 w, u64 h,
//                 num_params(model) × f64

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Buffer {
  std::vector<unsigned char> data;
  bool ok = false;
};

Buffer read_file(const char* path) {
  Buffer buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.data.resize(static_cast<size_t>(size));
  buf.ok = std::fread(buf.data.data(), 1, buf.data.size(), f) == buf.data.size();
  std::fclose(f);
  return buf;
}

template <typename T>
T rd(const unsigned char*& p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  p += sizeof(T);
  return v;
}

int camera_model_params(int model_id) {
  switch (model_id) {
    case 0: return 3;   // SIMPLE_PINHOLE
    case 1: return 4;   // PINHOLE
    case 2: return 4;   // SIMPLE_RADIAL
    case 3: return 5;   // RADIAL
    case 4: return 8;   // OPENCV
    case 5: return 8;   // OPENCV_FISHEYE
    case 6: return 12;  // FULL_OPENCV
    case 7: return 5;   // FOV
    case 8: return 4;   // SIMPLE_RADIAL_FISHEYE
    case 9: return 5;   // RADIAL_FISHEYE
    case 10: return 12; // THIN_PRISM_FISHEYE
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Returns the number of points, or -1 on error. Call with null outputs to
// query the count, then with caller-allocated arrays (xyz f64[n*3],
// rgb u8[n*3], err f64[n]).
long long gsio_read_points3d(const char* path, double* xyz, unsigned char* rgb,
                             double* err) {
  Buffer buf = read_file(path);
  if (!buf.ok || buf.data.size() < 8) return -1;
  const unsigned char* p = buf.data.data();
  const unsigned char* end = p + buf.data.size();
  const uint64_t n = rd<uint64_t>(p);
  for (uint64_t i = 0; i < n; ++i) {
    if (p + 8 + 24 + 3 + 8 + 8 > end) return -1;
    p += 8;  // id
    if (xyz) std::memcpy(xyz + i * 3, p, 24);
    p += 24;
    if (rgb) std::memcpy(rgb + i * 3, p, 3);
    p += 3;
    if (err) std::memcpy(err + i, p, 8);
    p += 8;
    const uint64_t track = rd<uint64_t>(p);
    p += track * 8;
    if (p > end) return -1;
  }
  return static_cast<long long>(n);
}

// Image metadata. Two-call protocol: first call with null outputs returns
// count and fills name_bytes_total; second call fills ids i32[n],
// qvec f64[n*4], tvec f64[n*3], camera_ids i32[n], names (concatenated
// null-terminated strings, name_bytes_total bytes).
long long gsio_read_images(const char* path, int* ids, double* qvec,
                           double* tvec, int* camera_ids, char* names,
                           long long* name_bytes_total) {
  Buffer buf = read_file(path);
  if (!buf.ok || buf.data.size() < 8) return -1;
  const unsigned char* p = buf.data.data();
  const unsigned char* end = p + buf.data.size();
  const uint64_t n = rd<uint64_t>(p);
  long long name_bytes = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (p + 4 + 32 + 24 + 4 > end) return -1;
    const int id = rd<int32_t>(p);
    if (ids) ids[i] = id;
    if (qvec) std::memcpy(qvec + i * 4, p, 32);
    p += 32;
    if (tvec) std::memcpy(tvec + i * 3, p, 24);
    p += 24;
    const int cam = rd<int32_t>(p);
    if (camera_ids) camera_ids[i] = cam;
    const unsigned char* name_start = p;
    while (p < end && *p != 0) ++p;
    if (p >= end) return -1;
    const long long len = p - name_start + 1;  // include NUL
    if (names) std::memcpy(names + name_bytes, name_start, len);
    name_bytes += len;
    ++p;  // skip NUL
    if (p + 8 > end) return -1;
    const uint64_t n2d = rd<uint64_t>(p);
    p += n2d * 24;
    if (p > end) return -1;
  }
  if (name_bytes_total) *name_bytes_total = name_bytes;
  return static_cast<long long>(n);
}

// Cameras: ids i32[n], model_ids i32[n], widths i64[n], heights i64[n],
// params f64[n*12] (zero-padded to 12 per camera).
long long gsio_read_cameras(const char* path, int* ids, int* model_ids,
                            long long* widths, long long* heights,
                            double* params) {
  Buffer buf = read_file(path);
  if (!buf.ok || buf.data.size() < 8) return -1;
  const unsigned char* p = buf.data.data();
  const unsigned char* end = p + buf.data.size();
  const uint64_t n = rd<uint64_t>(p);
  for (uint64_t i = 0; i < n; ++i) {
    if (p + 4 + 4 + 8 + 8 > end) return -1;
    const int id = rd<int32_t>(p);
    const int model = rd<int32_t>(p);
    const uint64_t w = rd<uint64_t>(p);
    const uint64_t h = rd<uint64_t>(p);
    const int np = camera_model_params(model);
    if (np < 0 || p + np * 8 > end) return -1;
    if (ids) ids[i] = id;
    if (model_ids) model_ids[i] = model;
    if (widths) widths[i] = static_cast<long long>(w);
    if (heights) heights[i] = static_cast<long long>(h);
    if (params) {
      std::memset(params + i * 12, 0, 12 * 8);
      std::memcpy(params + i * 12, p, np * 8);
    }
    p += np * 8;
  }
  return static_cast<long long>(n);
}

}  // extern "C"
