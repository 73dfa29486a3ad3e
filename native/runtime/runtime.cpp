// Native runtime: scan-log IO and map-export writers.
//
// Native counterpart of the reference's IO layer: the rosbag+ROS
// transport becomes a compact mmap-friendly binary scan-log format, and
// `NDTFrame::dumpMap`'s CSV/gnuplot/PNG export path
// (/root/reference/lib/ndtpso_slam/ndtframe.cpp:268-422, OpenCV-based)
// becomes lightweight writers (PNG via system zlib, with a stored-deflate
// fallback).  Loaded from Python via ctypes (ndtpso_slam/utils/native.py).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

// ----------------------------------------------------------------- PNG
uint32_t crc_table[256];
bool crc_ready = false;

void crc_init() {
  for (uint32_t n = 0; n < 256; ++n) {
    uint32_t c = n;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[n] = c;
  }
  crc_ready = true;
}

uint32_t crc32_of(const uint8_t* buf, size_t len, uint32_t crc = 0xFFFFFFFFu) {
  if (!crc_ready) crc_init();
  for (size_t i = 0; i < len; ++i)
    crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return crc;
}

uint32_t adler32_of(const uint8_t* buf, size_t len) {
  uint32_t a = 1, b = 0;
  for (size_t i = 0; i < len; ++i) {
    a = (a + buf[i]) % 65521;
    b = (b + a) % 65521;
  }
  return (b << 16) | a;
}

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24);
  v.push_back(x >> 16);
  v.push_back(x >> 8);
  v.push_back(x);
}

void png_chunk(FILE* f, const char* type, const std::vector<uint8_t>& data) {
  std::vector<uint8_t> hdr;
  put_be32(hdr, static_cast<uint32_t>(data.size()));
  fwrite(hdr.data(), 1, 4, f);
  uint8_t tbuf[4];
  std::memcpy(tbuf, type, 4);
  fwrite(tbuf, 1, 4, f);
  if (!data.empty()) fwrite(data.data(), 1, data.size(), f);
  uint32_t crc = crc32_of(tbuf, 4);
  crc = crc32_of(data.data(), data.size(), crc) ^ 0xFFFFFFFFu;
  std::vector<uint8_t> cbuf;
  put_be32(cbuf, crc);
  fwrite(cbuf.data(), 1, 4, f);
}

// Raw (filter-byte-prefixed) scanlines -> zlib stream.  Real deflate via
// system zlib; falls back to stored blocks if compression fails.
std::vector<uint8_t> deflate_raw(const std::vector<uint8_t>& raw) {
  uLongf bound = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> z(bound);
  if (compress2(z.data(), &bound, raw.data(), static_cast<uLong>(raw.size()),
                6) == Z_OK) {
    z.resize(bound);
    return z;
  }
  // Fallback: stored blocks (always valid zlib).
  z.clear();
  z.push_back(0x78);
  z.push_back(0x01);
  size_t off = 0;
  do {
    size_t chunk = std::min<size_t>(65535, raw.size() - off);
    bool last = (off + chunk == raw.size());
    z.push_back(last ? 1 : 0);
    z.push_back(chunk & 0xFF);
    z.push_back((chunk >> 8) & 0xFF);
    z.push_back(~chunk & 0xFF);
    z.push_back((~chunk >> 8) & 0xFF);
    z.insert(z.end(), raw.begin() + off, raw.begin() + off + chunk);
    off += chunk;
  } while (off < raw.size());
  uint32_t ad = adler32_of(raw.data(), raw.size());
  put_be32(z, ad);
  return z;
}

int write_png(const char* path, const uint8_t* pixels, long w, long h,
              int channels) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  fwrite(sig, 1, 8, f);
  std::vector<uint8_t> ihdr;
  put_be32(ihdr, static_cast<uint32_t>(w));
  put_be32(ihdr, static_cast<uint32_t>(h));
  ihdr.push_back(8);                              // bit depth
  ihdr.push_back(channels == 1 ? 0 : 2);          // gray / truecolor
  ihdr.push_back(0);
  ihdr.push_back(0);
  ihdr.push_back(0);
  png_chunk(f, "IHDR", ihdr);
  std::vector<uint8_t> raw;
  raw.reserve(static_cast<size_t>(h) * (w * channels + 1));
  for (long y = 0; y < h; ++y) {
    raw.push_back(0);  // filter: none
    raw.insert(raw.end(), pixels + y * w * channels,
               pixels + (y + 1) * w * channels);
  }
  png_chunk(f, "IDAT", deflate_raw(raw));
  png_chunk(f, "IEND", {});
  fclose(f);
  return 0;
}

// ------------------------------------------------------------- scan log
struct LogHeader {
  char magic[8];  // "NDTLOG1\0"
  int64_t t, b;
  double angle_min, angle_increment, range_max;
};

}  // namespace

extern "C" {

// ------------------------------------------------------------ exporters

// <name>.pose.csv with the reference's 7-column header
// (`ndtframe.cpp:282`); unlike the reference (which declares odom columns
// but never writes them — an upstream IO bug) all 7 columns are written.
int runtime_write_pose_csv(const char* path, const double* timestamps,
                           const double* poses, const double* odoms, long n) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  fprintf(f, "timestamp,xP,yP,thP,xO,yO,thO\n");
  for (long i = 0; i < n; ++i) {
    const double* p = poses + 3 * i;
    const double* o = odoms ? odoms + 3 * i : nullptr;
    fprintf(f, "%.6f,%.5f,%.5f,%.5f", timestamps ? timestamps[i] : 0.0, p[0],
            p[1], p[2]);
    if (o)
      fprintf(f, ",%.5f,%.5f,%.5f\n", o[0], o[1], o[2]);
    else
      fprintf(f, ",,,\n");
  }
  fclose(f);
  return 0;
}

// <name>.map.csv (`ndtframe.cpp:285-327`).
int runtime_write_map_csv(const char* path, const double* points, long n) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  fprintf(f, "x,y\n");
  for (long i = 0; i < n; ++i)
    fprintf(f, "%.5f,%.5f\n", points[2 * i], points[2 * i + 1]);
  fclose(f);
  return 0;
}

// <name>.gnuplot plot script (`ndtframe.cpp:356-388`).
int runtime_write_gnuplot(const char* path, const char* basename,
                          int save_points, int save_poses) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  fprintf(f,
          "set datafile separator ','\n"
          "set key autotitle columnhead\n"
          "set size ratio -1\n"
          "plot ");
  if (save_points)
    fprintf(f,
            "'%s.map.csv' title 'Map' with points pointsize 0.2 "
            "pointtype 5 linecolor rgb '#555555'",
            basename);
  if (save_poses)
    fprintf(f,
            "%s'%s.pose.csv' using 2:3 title 'Pose (LiDAR)' with "
            "linespoints linewidth 0.7 pointtype 6 pointsize 0.7 "
            "linecolor rgb '#ff0000'",
            save_points ? ", \\\n" : "", basename);
  fprintf(f, "\npause 1000\n");
  fclose(f);
  return 0;
}

int runtime_write_png_gray(const char* path, const uint8_t* pixels, long w,
                           long h) {
  return write_png(path, pixels, w, h, 1);
}

int runtime_write_png_rgb(const char* path, const uint8_t* pixels, long w,
                          long h) {
  return write_png(path, pixels, w, h, 3);
}

// ------------------------------------------------------------- scan log

int runtime_scanlog_write(const char* path, const float* ranges,
                          const double* poses, const double* odoms,
                          const double* timestamps, int64_t t, int64_t b,
                          double angle_min, double angle_increment,
                          double range_max) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  LogHeader h;
  std::memcpy(h.magic, "NDTLOG1\0", 8);
  h.t = t;
  h.b = b;
  h.angle_min = angle_min;
  h.angle_increment = angle_increment;
  h.range_max = range_max;
  fwrite(&h, sizeof(h), 1, f);
  fwrite(ranges, sizeof(float), static_cast<size_t>(t * b), f);
  fwrite(poses, sizeof(double), static_cast<size_t>(t * 3), f);
  fwrite(odoms, sizeof(double), static_cast<size_t>(t * 3), f);
  fwrite(timestamps, sizeof(double), static_cast<size_t>(t), f);
  fclose(f);
  return 0;
}

// Returns 0 on success and fills t/b/meta; call with null buffers first to
// size, then with buffers to read the payload.
int runtime_scanlog_read(const char* path, int64_t* t, int64_t* b,
                         double* angle_min, double* angle_increment,
                         double* range_max, float* ranges, double* poses,
                         double* odoms, double* timestamps) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  LogHeader h;
  if (fread(&h, sizeof(h), 1, f) != 1 ||
      std::memcmp(h.magic, "NDTLOG1\0", 8) != 0) {
    fclose(f);
    return -2;
  }
  *t = h.t;
  *b = h.b;
  *angle_min = h.angle_min;
  *angle_increment = h.angle_increment;
  *range_max = h.range_max;
  int rc = 0;
  if (ranges) {
    if (fread(ranges, sizeof(float), static_cast<size_t>(h.t * h.b), f) !=
            static_cast<size_t>(h.t * h.b) ||
        fread(poses, sizeof(double), static_cast<size_t>(h.t * 3), f) !=
            static_cast<size_t>(h.t * 3) ||
        fread(odoms, sizeof(double), static_cast<size_t>(h.t * 3), f) !=
            static_cast<size_t>(h.t * 3) ||
        fread(timestamps, sizeof(double), static_cast<size_t>(h.t), f) !=
            static_cast<size_t>(h.t))
      rc = -3;
  }
  fclose(f);
  return rc;
}

}  // extern "C"
