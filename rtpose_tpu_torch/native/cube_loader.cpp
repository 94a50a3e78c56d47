// Native radar-cube loader: .npy parse + f16/f32 decode + ROI crop +
// normalize + channels-last transpose in ONE pass, plus a threaded batch
// API.
//
// The port's own copy of rtpose_tpu/native/cube_loader.cpp: the same
// header parsing and per-value arithmetic, built with the same flags, so
// both libraries give the same bits; only the reads and the order of the
// writes differ (see rtp_load_cube).  It replaces
// the reference's host path (np.load -> slice -> scale -> clamp,
// det3d/datasets/cruw_pose/cruw_pose.py:167-185): the numpy version
// materializes the full (D,32,128,256) cube, slices (second allocation),
// scales (third pass).  This does a single pass over exactly the cropped
// bytes and writes the model's (Z', Y', X', D) layout directly, called
// from Python via ctypes.  It normalizes as
// (v - norm_start) * (1 / norm_scale), which can land one float32 ulp away
// from numpy's (v - norm_start) / norm_scale.
//
// C ABI:
//   rtp_load_cube(path, z0,z1,y0,y1,x0,x1, norm_start, norm_scale,
//                 out, out_cap, channels_last) -> 0 ok / negative errno
//   rtp_load_cube_batch(paths, n, ... , nthreads)   (parallel files)
//   rtp_probe(path, shape_out[4], ndim_out, dtype_out) -> header info

#include <sys/mman.h>
#include <sys/stat.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyHeader {
  int ndim = 0;
  long shape[4] = {1, 1, 1, 1};
  char dtype = 0;       // '2' = f2 (half), '4' = f4 (float)
  long data_offset = 0;
  bool fortran = false;
};

// minimal .npy v1/v2 header parser (little-endian '<f2'/'<f4' only)
bool parse_npy_header(FILE* f, NpyHeader* h) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    hlen = b[0] | (b[1] << 8);
    h->data_offset = 10 + hlen;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
    h->data_offset = 12 + hlen;
  }
  std::string hdr(hlen, '\0');
  if (fread(&hdr[0], 1, hlen, f) != hlen) return false;

  size_t dp = hdr.find("'descr'");
  if (dp == std::string::npos) return false;
  size_t q1 = hdr.find('\'', dp + 7);
  size_t q2 = hdr.find('\'', q1 + 1);
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f2" || descr == "|f2") h->dtype = '2';
  else if (descr == "<f4" || descr == "|f4") h->dtype = '4';
  else return false;

  h->fortran = hdr.find("'fortran_order': True") != std::string::npos;
  if (h->fortran) return false;  // C-order only

  size_t sp = hdr.find("'shape'");
  if (sp == std::string::npos) return false;
  size_t p1 = hdr.find('(', sp);
  size_t p2 = hdr.find(')', p1);
  std::string shp = hdr.substr(p1 + 1, p2 - p1 - 1);
  h->ndim = 0;
  const char* s = shp.c_str();
  while (*s && h->ndim < 4) {
    while (*s == ' ' || *s == ',') s++;
    if (!*s) break;
    h->shape[h->ndim++] = strtol(s, const_cast<char**>(&s), 10);
  }
  return h->ndim >= 3 && h->ndim <= 4;
}

inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int e = -1;
      do { man <<= 1; e++; } while (!(man & 0x400));
      man &= 0x3ff;
      bits = sign | ((127 - 15 - e) << 23) | (man << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000 | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  memcpy(&out, &bits, 4);
  return out;
}

}  // namespace

extern "C" {

// Probe header: shape_out[4], ndim_out, dtype_out ('2' or '4').
int rtp_probe(const char* path, long* shape_out, int* ndim_out,
              char* dtype_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyHeader h;
  bool ok = parse_npy_header(f, &h);
  fclose(f);
  if (!ok) return -2;
  for (int i = 0; i < 4; i++) shape_out[i] = h.shape[i];
  *ndim_out = h.ndim;
  *dtype_out = h.dtype;
  return 0;
}

// Load one cube, fused crop+normalize+clamp+(optional channels-last).
// Input file layout: (D, Z, Y, X) or (Z, Y, X); crop indices inclusive.
// channels_last=1 -> out (Z', Y', X', D); else (D, Z', Y', X').
// The file is read through a read-only mapping, and a channels-last output
// is written one (z, y) block of X' x D values at a time: the JAX copy's
// fseek + fread of every (d, z, y) row, writing across the whole output
// once per d, took 4.7x the numpy path's time a frame on an H100 host's
// CPU (PERF.md).  Each value goes through the same operations as in the
// JAX copy, so both libraries give the same bits.
int rtp_load_cube(const char* path, long z0, long z1, long y0, long y1,
                  long x0, long x1, float norm_start, float norm_scale,
                  float* out, long out_cap, int channels_last) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyHeader h;
  if (!parse_npy_header(f, &h)) { fclose(f); return -2; }

  long D = 1, Z, Y, X;
  if (h.ndim == 4) { D = h.shape[0]; Z = h.shape[1]; Y = h.shape[2]; X = h.shape[3]; }
  else { Z = h.shape[0]; Y = h.shape[1]; X = h.shape[2]; }
  const long zo = z1 - z0 + 1, yo = y1 - y0 + 1, xo = x1 - x0 + 1;
  if (z0 < 0 || z1 >= Z || y0 < 0 || y1 >= Y || x0 < 0 || x1 >= X) {
    fclose(f); return -3;
  }
  if (out_cap < D * zo * yo * xo) { fclose(f); return -4; }

  const long esize = (h.dtype == '2') ? 2 : 4;
  struct stat st;
  if (fstat(fileno(f), &st) != 0 || st.st_size < h.data_offset + D * Z * Y * X * esize) {
    fclose(f); return -5;
  }
  void* map = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fileno(f), 0);
  fclose(f);  // the mapping outlives the descriptor
  if (map == MAP_FAILED) return -5;
  const unsigned char* data = static_cast<const unsigned char*>(map) + h.data_offset;
  const float inv = 1.0f / norm_scale;
  const bool half = h.dtype == '2';
  auto value = [&](const unsigned char* p) -> float {
    float v;
    if (half) {
      uint16_t bits;
      memcpy(&bits, p, 2);
      v = half_to_float(bits);
    } else {
      memcpy(&v, p, 4);
    }
    v = (v - norm_start) * inv;
    if (v < 0.0f) v = 0.0f;
    return v;
  };
  auto row = [&](long d, long z, long y) {
    return data + (((d * Z + z0 + z) * Y + y0 + y) * X + x0) * esize;
  };

  if (channels_last) {
    for (long z = 0; z < zo; z++) {
      for (long y = 0; y < yo; y++) {
        float* dst = out + (z * yo + y) * xo * D;
        for (long d = 0; d < D; d++) {
          const unsigned char* src = row(d, z, y);
          for (long x = 0; x < xo; x++) dst[x * D + d] = value(src + x * esize);
        }
      }
    }
  } else {
    for (long d = 0; d < D; d++) {
      for (long z = 0; z < zo; z++) {
        for (long y = 0; y < yo; y++) {
          const unsigned char* src = row(d, z, y);
          float* dst = out + ((d * zo + z) * yo + y) * xo;
          for (long x = 0; x < xo; x++) dst[x] = value(src + x * esize);
        }
      }
    }
  }
  munmap(map, (size_t)st.st_size);
  return 0;
}

// Parallel batch load: n files into out (n strided by frame_size floats).
int rtp_load_cube_batch(const char** paths, long n, long z0, long z1,
                        long y0, long y1, long x0, long x1, float norm_start,
                        float norm_scale, float* out, long frame_size,
                        int channels_last, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  std::vector<int> rcs(n, 0);
  std::vector<std::thread> threads;
  std::atomic<long> work_idx(0);
  for (int t = 0; t < nthreads; t++) {
    threads.emplace_back([&]() {
      long i;
      while ((i = work_idx.fetch_add(1)) < n) {
        rcs[i] = rtp_load_cube(paths[i], z0, z1, y0, y1, x0, x1, norm_start,
                               norm_scale, out + i * frame_size, frame_size,
                               channels_last);
      }
    });
  }
  for (auto& th : threads) th.join();
  for (long i = 0; i < n; i++)
    if (rcs[i] != 0) return rcs[i];
  return 0;
}

}  // extern "C"
