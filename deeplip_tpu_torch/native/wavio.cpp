// deeplip_tpu_torch native IO: batched WAV decode for the host data pipeline.
//
// The reference delegates wav decode to libsndfile through soundfile
// (models/audio_models/datasets.py:46-50) and hides its cost behind 32
// DataLoader worker processes. Here decode is a small C++ library driven
// from Python via ctypes: RIFF parsing, PCM 8/16/24/32 and float32 payloads,
// channel-0 extraction, sample-offset reads, and a threaded batch entry
// point so one call fills a whole training batch without the GIL.
//
// Build: at first call, by deeplip_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC ... -lz)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct WavInfo {
  uint16_t format = 0;      // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t rate = 0;
  uint16_t bits = 0;
  long data_offset = 0;     // byte offset of sample data
  long data_bytes = 0;
};

bool parse_header(FILE* f, WavInfo* info) {
  char riff[4], wave[4];
  uint32_t riff_size;
  if (fread(riff, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) != 0) return false;
  if (fread(&riff_size, 4, 1, f) != 1) return false;
  if (fread(wave, 1, 4, f) != 4 || memcmp(wave, "WAVE", 4) != 0) return false;
  // walk chunks
  while (true) {
    char id[4];
    uint32_t size;
    if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) return false;
    if (memcmp(id, "fmt ", 4) == 0) {
      unsigned char buf[40];
      uint32_t n = size < sizeof(buf) ? size : (uint32_t)sizeof(buf);
      if (n < 16) return false;  // canonical fmt chunk is >= 16 bytes
      if (fread(buf, 1, n, f) != n) return false;
      if (size > n) fseek(f, size - n, SEEK_CUR);
      info->format = (uint16_t)(buf[0] | buf[1] << 8);
      info->channels = (uint16_t)(buf[2] | buf[3] << 8);
      info->rate = (uint32_t)(buf[4] | buf[5] << 8 | buf[6] << 16 | (uint32_t)buf[7] << 24);
      info->bits = (uint16_t)(buf[14] | buf[15] << 8);
      if (info->format == 0xFFFE && size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        info->format = (uint16_t)(buf[24] | buf[25] << 8);
      }
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = size;
      // validate the format/width combination HERE: a zero or bogus bits
      // value would otherwise make frame_bytes 0 downstream — an integer
      // division by zero (SIGFPE: process death, not a Python exception)
      bool pcm_ok = info->format == 1 &&
                    (info->bits == 8 || info->bits == 16 ||
                     info->bits == 24 || info->bits == 32);
      bool f32_ok = info->format == 3 && info->bits == 32;
      return (pcm_ok || f32_ok) && info->channels > 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
}

inline float decode_sample(const unsigned char* p, uint16_t bits, uint16_t format) {
  if (format == 3) {  // float32
    float v;
    memcpy(&v, p, 4);
    return v;
  }
  switch (bits) {
    case 8:
      return ((int)p[0] - 128) / 128.0f;
    case 16: {
      int16_t v = (int16_t)(p[0] | p[1] << 8);
      return v / 32768.0f;
    }
    case 24: {
      int32_t v = (int32_t)(p[0] | p[1] << 8 | p[2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      return v / 8388608.0f;
    }
    case 32: {
      int32_t v;
      memcpy(&v, p, 4);
      return v / 2147483648.0f;
    }
    default:
      return 0.0f;
  }
}

long read_one(const char* path, long start, long stop, float* out,
              long capacity, int* rate_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -2;
  }
  const int bytes_per = info.bits / 8;
  const long frame_bytes = (long)bytes_per * info.channels;
  const long total_frames = info.data_bytes / frame_bytes;
  if (stop < 0 || stop > total_frames) stop = total_frames;
  if (start < 0) start = 0;
  if (start > stop) start = stop;
  long n = stop - start;
  if (n > capacity) n = capacity;
  if (rate_out) *rate_out = (int)info.rate;
  if (n <= 0) {
    fclose(f);
    return 0;
  }
  fseek(f, info.data_offset + start * frame_bytes, SEEK_SET);
  std::vector<unsigned char> buf((size_t)n * frame_bytes);
  long got = (long)fread(buf.data(), frame_bytes, (size_t)n, f);
  fclose(f);
  // channel 0 only (reference: y[:, 0])
  for (long i = 0; i < got; ++i) {
    out[i] = decode_sample(buf.data() + (size_t)i * frame_bytes, info.bits, info.format);
  }
  return got;
}

// int16 variant: PCM16 payloads are a straight channel-0 copy (no float
// round-trip), so a batch can ship host->device at half the bytes of f32 —
// the device converts with astype(f32)/32768. Other payload widths are
// scaled into int16.
long read_one_i16(const char* path, long start, long stop, int16_t* out,
                  long capacity, int* rate_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -2;
  }
  const int bytes_per = info.bits / 8;
  const long frame_bytes = (long)bytes_per * info.channels;
  const long total_frames = info.data_bytes / frame_bytes;
  if (stop < 0 || stop > total_frames) stop = total_frames;
  if (start < 0) start = 0;
  if (start > stop) start = stop;
  long n = stop - start;
  if (n > capacity) n = capacity;
  if (rate_out) *rate_out = (int)info.rate;
  if (n <= 0) {
    fclose(f);
    return 0;
  }
  fseek(f, info.data_offset + start * frame_bytes, SEEK_SET);
  std::vector<unsigned char> buf((size_t)n * frame_bytes);
  long got = (long)fread(buf.data(), frame_bytes, (size_t)n, f);
  fclose(f);
  if (info.format == 1 && info.bits == 16) {
    if (info.channels == 1) {
      memcpy(out, buf.data(), (size_t)got * 2);
    } else {
      for (long i = 0; i < got; ++i) {
        memcpy(out + i, buf.data() + (size_t)i * frame_bytes, 2);
      }
    }
  } else {
    for (long i = 0; i < got; ++i) {
      float v = decode_sample(buf.data() + (size_t)i * frame_bytes, info.bits,
                              info.format);
      if (v > 0.999969f) v = 0.999969f;
      if (v < -1.0f) v = -1.0f;
      out[i] = (int16_t)(v * 32768.0f);
    }
  }
  return got;
}

// ---------------------------------------------------------------------------
// npy / npz reading (video mouth-ROI clips and embedding stores).
//
// The reference loads every clip with np.load(path)['data'] inside DataLoader
// workers (models/video_models/dataset.py:80-88). Here the zip walk, inflate
// (np.savez_compressed) and npy header parse run in C++ threads, GIL-free:
// one batch call fills a flat buffer the Python side slices per clip.

struct NpyMeta {
  long shape[8];
  int ndim = 0;
  char descr[8] = {0};   // e.g. "|u1", "<f4"
  long payload = 0;      // bytes of array data
  long header_bytes = 0; // offset of data within the npy stream
};

// Parse an npy header from `buf` (at least the first `n` bytes of the file).
// Returns true and fills meta (payload from total stream size `stream_bytes`,
// or -1 if unknown) on success.
bool parse_npy_header(const unsigned char* buf, long n, long stream_bytes,
                      NpyMeta* meta) {
  if (n < 10 || memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  int major = buf[6];
  long hlen, hoff;
  if (major == 1) {
    hlen = buf[8] | buf[9] << 8;
    hoff = 10;
  } else {
    if (n < 12) return false;
    hlen = buf[8] | buf[9] << 8 | buf[10] << 16 | (long)buf[11] << 24;
    hoff = 12;
  }
  if (hoff + hlen > n) return false;
  std::string h((const char*)buf + hoff, (size_t)hlen);
  size_t d = h.find("'descr'");
  if (d == std::string::npos) return false;
  size_t q1 = h.find('\'', d + 7);
  size_t q2 = (q1 == std::string::npos) ? q1 : h.find('\'', q1 + 1);
  if (q2 == std::string::npos || q2 - q1 - 1 >= sizeof(meta->descr)) return false;
  memcpy(meta->descr, h.data() + q1 + 1, q2 - q1 - 1);
  meta->descr[q2 - q1 - 1] = 0;
  if (h.find("'fortran_order': True") != std::string::npos) return false;
  size_t s = h.find("'shape'");
  if (s == std::string::npos) return false;
  size_t p1 = h.find('(', s);
  size_t p2 = (p1 == std::string::npos) ? p1 : h.find(')', p1);
  if (p2 == std::string::npos) return false;
  meta->ndim = 0;
  long cur = -1;
  for (size_t i = p1 + 1; i <= p2; ++i) {
    char c = h[i];
    if (c >= '0' && c <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
    } else if (cur >= 0) {
      if (meta->ndim >= 8) return false;
      meta->shape[meta->ndim++] = cur;
      cur = -1;
    }
  }
  meta->header_bytes = hoff + hlen;
  meta->payload = stream_bytes >= 0 ? stream_bytes - meta->header_bytes : -1;
  return true;
}

inline uint16_t rd16(const unsigned char* p) { return (uint16_t)(p[0] | p[1] << 8); }
inline uint32_t rd32(const unsigned char* p) {
  return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24;
}

struct ZipEntry {
  uint16_t method = 0;
  long comp_size = 0;
  long uncomp_size = 0;
  long data_offset = 0;  // byte offset of (compressed) payload in the file
};

// Locate `name` via the central directory (local headers alone are not
// reliable: zipfile streams with data descriptors, leaving local sizes 0).
bool zip_find(FILE* f, const char* name, ZipEntry* out) {
  if (fseek(f, 0, SEEK_END) != 0) return false;
  long fsize = ftell(f);
  long tail = fsize < 66000 ? fsize : 66000;
  std::vector<unsigned char> buf((size_t)tail);
  fseek(f, fsize - tail, SEEK_SET);
  if ((long)fread(buf.data(), 1, (size_t)tail, f) != tail) return false;
  long eocd = -1;
  for (long i = tail - 22; i >= 0; --i) {
    if (memcmp(buf.data() + i, "PK\x05\x06", 4) == 0) {
      eocd = i;
      break;
    }
  }
  if (eocd < 0) return false;
  uint32_t cd_off = rd32(buf.data() + eocd + 16);
  uint16_t n_entries = rd16(buf.data() + eocd + 10);
  if (cd_off == 0xFFFFFFFFu) return false;  // zip64: not produced by np.savez at these sizes
  fseek(f, (long)cd_off, SEEK_SET);
  size_t name_len_want = strlen(name);
  for (int e = 0; e < n_entries; ++e) {
    unsigned char ch[46];
    if (fread(ch, 1, 46, f) != 46 || memcmp(ch, "PK\x01\x02", 4) != 0) return false;
    uint16_t nlen = rd16(ch + 28), xlen = rd16(ch + 30), clen = rd16(ch + 32);
    std::string ename((size_t)nlen, 0);
    if (fread(&ename[0], 1, nlen, f) != nlen) return false;
    long next = ftell(f) + xlen + clen;
    if (nlen == name_len_want && memcmp(ename.data(), name, nlen) == 0) {
      out->method = rd16(ch + 10);
      out->comp_size = (long)rd32(ch + 20);
      out->uncomp_size = (long)rd32(ch + 24);
      long lho = (long)rd32(ch + 42);
      unsigned char lh[30];
      fseek(f, lho, SEEK_SET);
      if (fread(lh, 1, 30, f) != 30 || memcmp(lh, "PK\x03\x04", 4) != 0) return false;
      out->data_offset = lho + 30 + rd16(lh + 26) + rd16(lh + 28);
      return true;
    }
    fseek(f, next, SEEK_SET);
  }
  return false;
}

// Inflate `comp` (raw deflate) producing up to `out_cap` bytes; returns bytes
// produced or -1. `finish_all=false` stops once out_cap is filled (header
// probe); true requires the full stream to fit.
long inflate_raw(const unsigned char* comp, long comp_size, unsigned char* out,
                 long out_cap, bool finish_all) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return -1;
  zs.next_in = const_cast<unsigned char*>(comp);
  zs.avail_in = (uInt)comp_size;
  zs.next_out = out;
  zs.avail_out = (uInt)out_cap;
  int rc = inflate(&zs, Z_FINISH);
  long produced = out_cap - (long)zs.avail_out;
  inflateEnd(&zs);
  if (rc == Z_STREAM_END) return produced;
  if (!finish_all && rc == Z_OK && zs.avail_out == 0) return produced;
  if (!finish_all && rc == Z_BUF_ERROR && zs.avail_out == 0) return produced;
  return -1;
}

// Read array `key` from an npz/npy file. Pass capacity 0 (out may be null)
// to probe: fills meta and returns the payload byte count without copying.
// With capacity >= payload, writes the raw array bytes to `out`.
// Returns payload bytes, or <0 on error.
long read_npy_entry(const char* path, const char* key, unsigned char* out,
                    long capacity, NpyMeta* meta) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[4] = {0};
  size_t got_magic = fread(magic, 1, 4, f);
  bool is_zip = got_magic == 4 && memcmp(magic, "PK\x03\x04", 4) == 0;

  long result = -2;
  if (!is_zip) {
    // plain .npy
    fseek(f, 0, SEEK_END);
    long fsize = ftell(f);
    long probe = fsize < 4096 ? fsize : 4096;
    std::vector<unsigned char> head((size_t)probe);
    fseek(f, 0, SEEK_SET);
    if ((long)fread(head.data(), 1, (size_t)probe, f) == probe &&
        parse_npy_header(head.data(), probe, fsize, meta)) {
      result = meta->payload;
      if (capacity >= meta->payload && out != nullptr) {
        fseek(f, meta->header_bytes, SEEK_SET);
        if ((long)fread(out, 1, (size_t)meta->payload, f) != meta->payload)
          result = -3;
      } else if (out != nullptr) {
        // copy pass with a too-small buffer (file grew between the probe
        // and copy passes): error out rather than reporting success over
        // an unwritten buffer
        result = -4;
      }
    }
  } else {
    std::string entry = std::string(key) + ".npy";
    ZipEntry ze;
    if (zip_find(f, entry.c_str(), &ze)) {
      if (ze.method == 0) {
        // stored: the npy stream sits uncompressed at data_offset
        long probe = ze.uncomp_size < 4096 ? ze.uncomp_size : 4096;
        std::vector<unsigned char> head((size_t)probe);
        fseek(f, ze.data_offset, SEEK_SET);
        if ((long)fread(head.data(), 1, (size_t)probe, f) == probe &&
            parse_npy_header(head.data(), probe, ze.uncomp_size, meta)) {
          result = meta->payload;
          if (capacity >= meta->payload && out != nullptr) {
            fseek(f, ze.data_offset + meta->header_bytes, SEEK_SET);
            if ((long)fread(out, 1, (size_t)meta->payload, f) != meta->payload)
              result = -3;
          } else if (out != nullptr) {
            result = -4;  // capacity < payload on the copy pass
          }
        }
      } else if (ze.method == 8) {
        std::vector<unsigned char> comp((size_t)ze.comp_size);
        fseek(f, ze.data_offset, SEEK_SET);
        if ((long)fread(comp.data(), 1, (size_t)ze.comp_size, f) ==
            ze.comp_size) {
          long probe = ze.uncomp_size < 4096 ? ze.uncomp_size : 4096;
          std::vector<unsigned char> head((size_t)probe);
          long got = inflate_raw(comp.data(), ze.comp_size, head.data(), probe,
                                 /*finish_all=*/probe == ze.uncomp_size);
          if (got == probe &&
              parse_npy_header(head.data(), probe, ze.uncomp_size, meta)) {
            result = meta->payload;
            if (out != nullptr && capacity < meta->payload) {
              result = -4;  // capacity < payload on the copy pass
            } else if (capacity >= meta->payload && out != nullptr) {
              std::vector<unsigned char> full((size_t)ze.uncomp_size);
              if (inflate_raw(comp.data(), ze.comp_size, full.data(),
                              ze.uncomp_size, true) == ze.uncomp_size) {
                memcpy(out, full.data() + meta->header_bytes,
                       (size_t)meta->payload);
              } else {
                result = -3;
              }
            }
          }
        }
      }
    }
  }
  fclose(f);
  return result;
}

}  // namespace

extern "C" {

// Single-file read: returns samples written (or <0 on error).
long dl_read_wav(const char* path, long start, long stop, float* out,
                 long capacity, int* rate_out) {
  return read_one(path, start, stop, out, capacity, rate_out);
}

// File info: frames into *n_frames; returns 0 ok / <0 error.
int dl_wav_info(const char* path, int* rate, int* channels, long* n_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -2;
  }
  fclose(f);
  if (rate) *rate = (int)info.rate;
  if (channels) *channels = (int)info.channels;
  if (n_frames) *n_frames = info.data_bytes / ((info.bits / 8) * info.channels);
  return 0;
}

// Threaded batch read: n files into out + offsets[i], each with its own
// start/stop; lengths written into wrote[i]. GIL-free from ctypes.
void dl_read_wav_batch(const char** paths, const long* starts, const long* stops,
                       float* out, const long* offsets, const long* capacities,
                       long* wrote, int* rates, int n, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::vector<int> next(1, 0);
  auto worker = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      wrote[i] = read_one(paths[i], starts[i], stops[i], out + offsets[i],
                          capacities[i], rates ? rates + i : nullptr);
    }
  };
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();
}

// npy/npz array read. capacity 0 probes: fills shape/ndim/descr and returns
// payload bytes. capacity >= payload copies raw array bytes into out.
// shape must hold 8 longs; descr 8 chars. Returns payload bytes or <0.
long dl_read_npy(const char* path, const char* key, unsigned char* out,
                 long capacity, long* shape, int* ndim, char* descr) {
  NpyMeta meta;
  long rc = read_npy_entry(path, key, out, capacity, &meta);
  if (rc >= 0) {
    for (int i = 0; i < meta.ndim; ++i) shape[i] = meta.shape[i];
    *ndim = meta.ndim;
    memcpy(descr, meta.descr, 8);
  }
  return rc;
}

// Threaded batch npy/npz read: file i writes to out + offsets[i] (probe pass:
// all capacities 0, out may be null). wrote[i] = payload bytes or <0;
// shapes[i*8..], ndims[i], descrs[i*8..].
void dl_read_npy_batch(const char** paths, const char* key, unsigned char* out,
                       const long* offsets, const long* capacities, long* wrote,
                       long* shapes, int* ndims, char* descrs, int n,
                       int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  auto worker = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      wrote[i] = dl_read_npy(paths[i], key, out ? out + offsets[i] : nullptr,
                             capacities[i], shapes + (size_t)i * 8, ndims + i,
                             descrs + (size_t)i * 8);
    }
  };
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();
}

// Threaded batch read into int16 (see read_one_i16).
void dl_read_wav_batch_i16(const char** paths, const long* starts,
                           const long* stops, int16_t* out,
                           const long* offsets, const long* capacities,
                           long* wrote, int* rates, int n, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  auto worker = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      wrote[i] = read_one_i16(paths[i], starts[i], stops[i], out + offsets[i],
                              capacities[i], rates ? rates + i : nullptr);
    }
  };
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();
}

}  // extern "C"
