// Native batch loader for .npz slice files.
//
// The reference feeds training through four Python DataLoader worker
// processes doing np.load + augmentation (reference: train_chaos.py:237,
// chaos_dataset.py:92-105).  In the TPU design augmentation lives on
// device, so the host-side job reduces to: read zip members, inflate,
// parse the .npy payloads, cast to float32 and write into padded static
// canvases.  This library does exactly that with a C ABI (consumed from
// Python via ctypes — no pybind11 dependency) and a std::thread pool, so
// batch assembly runs at native speed with zero GIL involvement.
//
// Supported input: the reference's per-slice .npz files with members
// img.npy / lab.npy / scb.npy (2-D arrays), stored (np.savez) or
// deflate-compressed (np.savez_compressed); dtypes f4/f8/i1/u1/i2/u2/i4/i8.
//
// The PyTorch port's own copy of pacingpseudo_tpu/data/native/npz_loader.cpp,
// with the same C ABI (ppt_load_batch) and error contract.  Built at first
// use by loader.py: g++ -O3 -std=c++17 -fPIC -pthread -shared ... -lz, or
// against libz.so.1 by its full path where no development symlink exists.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#if __has_include(<zlib.h>) && !defined(PPT_DECLARE_ZLIB)
#include <zlib.h>
#else
// No zlib headers on this machine (or PPT_DECLARE_ZLIB, which tests this
// branch): declare the small part of zlib's ABI this file uses (stable
// since zlib 1.2) and link libz.so.1 directly.
extern "C" {
typedef unsigned char Bytef;
typedef unsigned int uInt;
typedef unsigned long uLong;
typedef struct z_stream_s {
  const Bytef* next_in;
  uInt avail_in;
  uLong total_in;
  Bytef* next_out;
  uInt avail_out;
  uLong total_out;
  const char* msg;
  void* state;
  void* (*zalloc)(void*, uInt, uInt);
  void (*zfree)(void*, void*);
  void* opaque;
  int data_type;
  uLong adler;
  uLong reserved;
} z_stream;
int inflateInit2_(z_stream* strm, int window_bits, const char* version,
                  int stream_size);
int inflate(z_stream* strm, int flush);
int inflateEnd(z_stream* strm);
}
#define Z_OK 0
#define Z_STREAM_END 1
#define Z_FINISH 4
#define MAX_WBITS 15
#define inflateInit2(strm, window_bits) \
  inflateInit2_((strm), (window_bits), "1.2.11", (int)sizeof(z_stream))
#endif

namespace {

struct Member {
  size_t offset = 0;        // file offset of payload
  size_t comp_size = 0;
  size_t uncomp_size = 0;
  uint16_t method = 0;      // 0 = stored, 8 = deflate
  bool found = false;
};

uint16_t rd16(const uint8_t* p) { return (uint16_t)(p[0] | (p[1] << 8)); }
uint32_t rd32(const uint8_t* p) {
  return (uint32_t)(p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24));
}

// Minimal zip central-directory walk (no zip64: slice files are tiny).
bool find_members(const std::vector<uint8_t>& buf,
                  Member& img, Member& lab, Member& scb, std::string* err) {
  if (buf.size() < 22) { *err = "file too small"; return false; }
  // End of central directory: scan back for signature 0x06054b50.
  size_t eocd = std::string::npos;
  size_t start = buf.size() >= 22 + 65536 ? buf.size() - 22 - 65536 : 0;
  for (size_t i = buf.size() - 22; i + 1 > start; --i) {
    if (rd32(&buf[i]) == 0x06054b50) { eocd = i; break; }
    if (i == 0) break;
  }
  if (eocd == std::string::npos) { *err = "no EOCD"; return false; }
  uint16_t n_entries = rd16(&buf[eocd + 10]);
  uint32_t cd_offset = rd32(&buf[eocd + 16]);

  size_t p = cd_offset;
  for (uint16_t e = 0; e < n_entries; ++e) {
    if (p + 46 > buf.size() || rd32(&buf[p]) != 0x02014b50) {
      *err = "bad central directory"; return false;
    }
    uint16_t method = rd16(&buf[p + 10]);
    uint32_t comp = rd32(&buf[p + 20]);
    uint32_t uncomp = rd32(&buf[p + 24]);
    uint16_t name_len = rd16(&buf[p + 28]);
    uint16_t extra_len = rd16(&buf[p + 30]);
    uint16_t comment_len = rd16(&buf[p + 32]);
    uint32_t lho = rd32(&buf[p + 42]);
    if (p + 46 + name_len > buf.size()) {
      *err = "central directory name overrun"; return false;
    }
    std::string name((const char*)&buf[p + 46], name_len);

    Member* m = nullptr;
    if (name == "img.npy") m = &img;
    else if (name == "lab.npy") m = &lab;
    else if (name == "scb.npy") m = &scb;
    if (m) {
      // Local header gives the true payload offset.
      if (lho + 30 > buf.size() || rd32(&buf[lho]) != 0x04034b50) {
        *err = "bad local header"; return false;
      }
      uint16_t lnl = rd16(&buf[lho + 26]);
      uint16_t lel = rd16(&buf[lho + 28]);
      m->offset = lho + 30 + lnl + lel;
      if (m->offset + (size_t)comp > buf.size()) {
        *err = "member payload overrun"; return false;
      }
      m->comp_size = comp;
      m->uncomp_size = uncomp;
      m->method = method;
      m->found = true;
    }
    p += 46 + name_len + extra_len + comment_len;
  }
  if (!img.found || !lab.found || !scb.found) {
    *err = "missing img/lab/scb member"; return false;
  }
  return true;
}

bool inflate_member(const std::vector<uint8_t>& buf, const Member& m,
                    std::vector<uint8_t>& out, std::string* err) {
  out.resize(m.uncomp_size);
  if (m.offset + m.comp_size > buf.size()) { *err = "payload overrun"; return false; }
  if (m.method == 0) {
    if (m.comp_size != m.uncomp_size) { *err = "stored size mismatch"; return false; }
    std::memcpy(out.data(), &buf[m.offset], m.comp_size);
    return true;
  }
  if (m.method != 8) { *err = "unsupported compression"; return false; }
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) { *err = "inflateInit"; return false; }
  zs.next_in = const_cast<uint8_t*>(&buf[m.offset]);
  zs.avail_in = (uInt)m.comp_size;
  zs.next_out = out.data();
  zs.avail_out = (uInt)out.size();
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END) { *err = "inflate failed"; return false; }
  return true;
}

// Parse a .npy payload: returns dtype code, shape (h, w), data pointer.
bool parse_npy(const std::vector<uint8_t>& npy, std::string* descr,
               long* h, long* w, size_t* data_off, std::string* err) {
  if (npy.size() < 10 || std::memcmp(npy.data(), "\x93NUMPY", 6) != 0) {
    *err = "bad npy magic"; return false;
  }
  uint8_t major = npy[6];
  size_t hlen, hoff;
  if (major == 1) { hlen = rd16(&npy[8]); hoff = 10; }
  else { hlen = rd32(&npy[8]); hoff = 12; }
  if (hoff + hlen > npy.size()) { *err = "npy header overrun"; return false; }
  std::string hdr((const char*)&npy[hoff], hlen);

  auto get_field = [&](const char* key) -> std::string {
    size_t k = hdr.find(key);
    if (k == std::string::npos) return "";
    size_t c = hdr.find(':', k);
    if (c == std::string::npos) return "";
    size_t e = hdr.find(',', c);
    if (e == std::string::npos) e = hdr.size();
    return hdr.substr(c + 1, e - c - 1);
  };
  std::string d = get_field("'descr'");
  size_t q0 = d.find('\'');
  size_t q1 = q0 == std::string::npos ? std::string::npos : d.find('\'', q0 + 1);
  if (q1 == std::string::npos) { *err = "npy descr parse"; return false; }
  *descr = d.substr(q0 + 1, q1 - q0 - 1);

  size_t sp = hdr.find("'shape'");
  size_t p0 = sp == std::string::npos ? std::string::npos : hdr.find('(', sp);
  size_t p1 = p0 == std::string::npos ? std::string::npos : hdr.find(')', p0);
  if (p1 == std::string::npos) { *err = "npy shape parse"; return false; }
  std::string shape = hdr.substr(p0 + 1, p1 - p0 - 1);
  long dims[2] = {1, 1};
  int nd = 0;
  const char* sptr = shape.c_str();
  char* end = nullptr;
  while (nd < 2) {
    long v = std::strtol(sptr, &end, 10);
    if (end == sptr) break;
    dims[nd++] = v;
    sptr = end;
    while (*sptr == ',' || *sptr == ' ') ++sptr;
  }
  if (nd == 0) { *err = "npy shape parse"; return false; }
  *h = dims[0];
  *w = nd == 2 ? dims[1] : 1;
  *data_off = hoff + hlen;
  return true;
}

// Cast any supported dtype to float32.
bool cast_to_f32(const uint8_t* src, const std::string& descr, long n,
                 float* dst, std::string* err) {
  if (descr == "<f4") {
    std::memcpy(dst, src, n * 4);
  } else if (descr == "<f8") {
    const double* s = (const double*)src;
    for (long i = 0; i < n; ++i) dst[i] = (float)s[i];
  } else if (descr == "|u1") {
    for (long i = 0; i < n; ++i) dst[i] = (float)src[i];
  } else if (descr == "|i1") {
    const int8_t* s = (const int8_t*)src;
    for (long i = 0; i < n; ++i) dst[i] = (float)s[i];
  } else if (descr == "<i2") {
    const int16_t* s = (const int16_t*)src;
    for (long i = 0; i < n; ++i) dst[i] = (float)s[i];
  } else if (descr == "<u2") {
    const uint16_t* s = (const uint16_t*)src;
    for (long i = 0; i < n; ++i) dst[i] = (float)s[i];
  } else if (descr == "<i4") {
    const int32_t* s = (const int32_t*)src;
    for (long i = 0; i < n; ++i) dst[i] = (float)s[i];
  } else if (descr == "<i8") {
    const int64_t* s = (const int64_t*)src;
    for (long i = 0; i < n; ++i) dst[i] = (float)s[i];
  } else {
    *err = "unsupported dtype " + descr;
    return false;
  }
  return true;
}

// Load one slice into the padded canvases at batch index bi.
bool load_one(const char* path, long canvas, float img_pad, float lab_pad,
              float* img_out, float* lab_out, float* scb_out,
              int32_t* size_out, std::string* err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { *err = std::string("open failed: ") + path; return false; }
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (std::fread(buf.data(), 1, fsize, f) != (size_t)fsize) {
    std::fclose(f); *err = "short read"; return false;
  }
  std::fclose(f);

  Member m_img, m_lab, m_scb;
  if (!find_members(buf, m_img, m_lab, m_scb, err)) return false;

  const Member* members[3] = {&m_img, &m_lab, &m_scb};
  float* outs[3] = {img_out, lab_out, scb_out};
  float pads[3] = {img_pad, lab_pad, lab_pad};

  long h0 = -1, w0 = -1;
  for (int t = 0; t < 3; ++t) {
    std::vector<uint8_t> raw;
    if (!inflate_member(buf, *members[t], raw, err)) return false;
    std::string descr;
    long h = 0, w = 0;
    size_t off = 0;
    if (!parse_npy(raw, &descr, &h, &w, &off, err)) return false;
    if (h <= 0 || w <= 0) { *err = "empty npy member"; return false; }
    if (h > canvas || w > canvas) { *err = "slice exceeds canvas"; return false; }
    if (t == 0) { h0 = h; w0 = w; }
    else if (h != h0 || w != w0) { *err = "member shape mismatch"; return false; }

    // fill padding then copy rows (cast via a row buffer)
    float* dst = outs[t];
    for (long i = 0; i < canvas * canvas; ++i) dst[i] = pads[t];
    std::vector<float> row(w);
    size_t esize = raw.size() >= off ? (size_t)(raw.size() - off) / ((size_t)h * w) : 0;
    if (esize == 0 || off + (size_t)h * w * esize > raw.size()) {
      *err = "npy payload truncated"; return false;
    }
    for (long r = 0; r < h; ++r) {
      if (!cast_to_f32(&raw[off + (size_t)r * w * esize], descr, w, row.data(), err))
        return false;
      std::memcpy(dst + r * canvas, row.data(), w * sizeof(float));
    }
  }
  size_out[0] = (int32_t)h0;
  size_out[1] = (int32_t)w0;
  return true;
}

}  // namespace

extern "C" {

// Load ``n`` slices into preallocated (n, canvas, canvas) float32 slabs.
// Returns 0 on success; on failure returns 1 + index of the failing file
// and writes the error into err_buf.
int ppt_load_batch(const char** paths, int n, int canvas,
                   float img_pad, float lab_pad,
                   float* img_out, float* lab_out, float* scb_out,
                   int32_t* size_out, int num_threads,
                   char* err_buf, int err_buf_len) {
  std::vector<std::string> errors(n);
  std::vector<int> status(n, 0);
  long plane = (long)canvas * canvas;

  auto worker = [&](int begin, int end) {
    for (int i = begin; i < end; ++i) {
      std::string err;
      if (!load_one(paths[i], canvas, img_pad, lab_pad,
                    img_out + (long)i * plane, lab_out + (long)i * plane,
                    scb_out + (long)i * plane, size_out + (long)i * 2, &err)) {
        errors[i] = err;
        status[i] = 1;
      }
    }
  };

  int nt = num_threads > 0 ? num_threads : 1;
  if (nt > n) nt = n;
  std::vector<std::thread> threads;
  int per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int b = t * per, e = b + per > n ? n : b + per;
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();

  for (int i = 0; i < n; ++i) {
    if (status[i]) {
      std::snprintf(err_buf, err_buf_len, "%s: %s", paths[i], errors[i].c_str());
      return 1 + i;
    }
  }
  return 0;
}

}  // extern "C"
