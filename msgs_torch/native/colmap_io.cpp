// Native I/O for the msgs data layer.
//
// Fast binary parsers for COLMAP sparse reconstructions (points3D.bin,
// images.bin) and Gaussian PLY payloads. The reference ships its hot loops
// as native CUDA/C++ submodules; our compute path is Pallas, and this is the
// native runtime piece for the host-side data plane: the pure-Python
// struct-unpack loop over points3D.bin costs seconds-to-minutes at millions
// of SfM points, this reads the same file in tens of milliseconds.
//
// C ABI (ctypes-friendly): every reader fills caller-visible out-pointers
// with malloc'd buffers; msgs_free releases them. All multi-byte values in
// COLMAP binaries are little-endian; this code assumes a little-endian host
// (TPU VM hosts are x86-64/ARM64 LE).
//
// Reference for the file layout: the public COLMAP binary format
// (scene/colmap_loader.py:156-270 parses the same fields in Python).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok;

  template <typename T>
  T get() {
    if (p + sizeof(T) > end) {
      ok = false;
      return T{};
    }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }

  void skip(size_t n) {
    if (p + n > end) {
      ok = false;
      return;
    }
    p += n;
  }

  // NUL-terminated string; returns length consumed (without NUL).
  size_t cstr(std::vector<char>* out) {
    size_t n = 0;
    while (p + n < end && p[n] != '\0') n++;
    if (p + n >= end) {
      ok = false;
      return 0;
    }
    if (out) out->assign(p, p + n);
    p += n + 1;
    return n;
  }
};

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  buf->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(buf->data(), 1, buf->size(), f) : 0;
  std::fclose(f);
  return got == buf->size();
}

}  // namespace

extern "C" {

void msgs_free(void* ptr) { std::free(ptr); }

// points3D.bin → xyz (n,3) float32, rgb (n,3) uint8, err (n) float32.
// Returns 0 on success, negative on error.
int msgs_read_points3d_bin(const char* path, float** xyz_out,
                           uint8_t** rgb_out, float** err_out,
                           int64_t* n_out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  Reader r{buf.data(), buf.data() + buf.size(), true};

  uint64_t n = r.get<uint64_t>();
  if (!r.ok) return -2;
  float* xyz = static_cast<float*>(std::malloc(n * 3 * sizeof(float)));
  uint8_t* rgb = static_cast<uint8_t*>(std::malloc(n * 3));
  float* err = static_cast<float*>(std::malloc(n * sizeof(float)));
  if ((!xyz || !rgb || !err) && n > 0) {
    std::free(xyz);
    std::free(rgb);
    std::free(err);
    return -3;
  }

  for (uint64_t i = 0; i < n; i++) {
    r.get<uint64_t>();  // point id
    xyz[i * 3 + 0] = static_cast<float>(r.get<double>());
    xyz[i * 3 + 1] = static_cast<float>(r.get<double>());
    xyz[i * 3 + 2] = static_cast<float>(r.get<double>());
    rgb[i * 3 + 0] = r.get<uint8_t>();
    rgb[i * 3 + 1] = r.get<uint8_t>();
    rgb[i * 3 + 2] = r.get<uint8_t>();
    err[i] = static_cast<float>(r.get<double>());
    uint64_t track_len = r.get<uint64_t>();
    r.skip(track_len * 8);  // (image_id i32, point2d_idx i32) pairs
    if (!r.ok) {
      std::free(xyz);
      std::free(rgb);
      std::free(err);
      return -4;
    }
  }
  *xyz_out = xyz;
  *rgb_out = rgb;
  *err_out = err;
  *n_out = static_cast<int64_t>(n);
  return 0;
}

// images.bin → per-image qvec (n,4) f64, tvec (n,3) f64, camera_id (n) i32,
// image_id (n) i32, names as a single NUL-joined blob.
int msgs_read_images_bin(const char* path, double** qvec_out,
                         double** tvec_out, int32_t** cam_id_out,
                         int32_t** img_id_out, char** names_out,
                         int64_t* names_len_out, int64_t* n_out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  Reader r{buf.data(), buf.data() + buf.size(), true};

  uint64_t n = r.get<uint64_t>();
  if (!r.ok) return -2;
  double* qvec = static_cast<double*>(std::malloc(n * 4 * sizeof(double)));
  double* tvec = static_cast<double*>(std::malloc(n * 3 * sizeof(double)));
  int32_t* cam_id = static_cast<int32_t*>(std::malloc(n * sizeof(int32_t)));
  int32_t* img_id = static_cast<int32_t*>(std::malloc(n * sizeof(int32_t)));
  std::vector<char> names;

  for (uint64_t i = 0; i < n; i++) {
    img_id[i] = r.get<int32_t>();
    for (int k = 0; k < 4; k++) qvec[i * 4 + k] = r.get<double>();
    for (int k = 0; k < 3; k++) tvec[i * 3 + k] = r.get<double>();
    cam_id[i] = r.get<int32_t>();
    std::vector<char> name;
    r.cstr(&name);
    names.insert(names.end(), name.begin(), name.end());
    names.push_back('\0');
    uint64_t n_pts = r.get<uint64_t>();
    r.skip(n_pts * 24);  // (x f64, y f64, point3d_id i64)
    if (!r.ok) {
      std::free(qvec);
      std::free(tvec);
      std::free(cam_id);
      std::free(img_id);
      return -4;
    }
  }
  char* names_blob = static_cast<char*>(std::malloc(names.size()));
  std::memcpy(names_blob, names.data(), names.size());
  *qvec_out = qvec;
  *tvec_out = tvec;
  *cam_id_out = cam_id;
  *img_id_out = img_id;
  *names_out = names_blob;
  *names_len_out = static_cast<int64_t>(names.size());
  *n_out = static_cast<int64_t>(n);
  return 0;
}

// Binary-LE PLY vertex payload → contiguous float32 matrix (n, n_props).
// Only float/double/uchar properties supported (the Gaussian PLY schema);
// uchar and double are converted to float32. Property names are returned as
// a NUL-joined blob so Python can map columns.
int msgs_read_ply_f32(const char* path, float** data_out, char** names_out,
                      int64_t* names_len_out, int64_t* n_out,
                      int64_t* n_props_out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;

  // Parse ASCII header.
  const char* text = reinterpret_cast<const char*>(buf.data());
  const char* hdr_end = std::strstr(text, "end_header\n");
  if (!hdr_end) return -2;
  size_t body_off = (hdr_end - text) + std::strlen("end_header\n");

  int64_t n_vertex = 0;
  std::vector<int> prop_kind;  // 0=f32, 1=f64, 2=u8
  std::vector<char> names;
  bool in_vertex = false;
  bool binary_le = false;
  {
    const char* line = text;
    while (line < hdr_end) {
      const char* nl = static_cast<const char*>(
          std::memchr(line, '\n', hdr_end + 16 - line));
      if (!nl) break;
      std::string s(line, nl);
      if (s.rfind("format binary_little_endian", 0) == 0) binary_le = true;
      if (s.rfind("element vertex ", 0) == 0) {
        n_vertex = std::atoll(s.c_str() + 15);
        in_vertex = true;
      } else if (s.rfind("element ", 0) == 0) {
        in_vertex = false;
      } else if (in_vertex && s.rfind("property ", 0) == 0) {
        size_t sp1 = s.find(' ', 9);
        std::string type = s.substr(9, sp1 - 9);
        std::string name = s.substr(sp1 + 1);
        int kind;
        if (type == "float" || type == "float32") kind = 0;
        else if (type == "double" || type == "float64") kind = 1;
        else if (type == "uchar" || type == "uint8") kind = 2;
        else return -5;  // unsupported property type for this fast path
        prop_kind.push_back(kind);
        names.insert(names.end(), name.begin(), name.end());
        names.push_back('\0');
      }
      line = nl + 1;
    }
  }
  if (!binary_le) return -6;

  int64_t n_props = static_cast<int64_t>(prop_kind.size());
  size_t row_bytes = 0;
  for (int k : prop_kind) row_bytes += (k == 0 ? 4 : k == 1 ? 8 : 1);
  if (body_off + row_bytes * n_vertex > buf.size()) return -7;

  float* data = static_cast<float*>(
      std::malloc(sizeof(float) * n_vertex * n_props));
  const uint8_t* p = buf.data() + body_off;
  for (int64_t i = 0; i < n_vertex; i++) {
    float* row = data + i * n_props;
    for (int64_t j = 0; j < n_props; j++) {
      switch (prop_kind[j]) {
        case 0: {
          float v;
          std::memcpy(&v, p, 4);
          p += 4;
          row[j] = v;
          break;
        }
        case 1: {
          double v;
          std::memcpy(&v, p, 8);
          p += 8;
          row[j] = static_cast<float>(v);
          break;
        }
        default:
          row[j] = static_cast<float>(*p++);
      }
    }
  }
  char* names_blob = static_cast<char*>(std::malloc(names.size()));
  std::memcpy(names_blob, names.data(), names.size());
  *data_out = data;
  *names_out = names_blob;
  *names_len_out = static_cast<int64_t>(names.size());
  *n_out = n_vertex;
  *n_props_out = n_props;
  return 0;
}

}  // extern "C"
