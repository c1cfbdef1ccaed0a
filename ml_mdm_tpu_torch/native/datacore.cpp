// datacore: the port's native host-side data plane.
//
// The port's own copy of ml_mdm_tpu/native/datacore.cpp (the same C
// interface and the same arithmetic): trie tokenizer (shortest path with
// scores), JPEG decode + smallest-side resize + crop with libjpeg, and a
// tar member index (ustar, PAX and GNU long names). Loaded with ctypes by
// ml_mdm_tpu_torch/native/__init__.py, which builds it at first use into
// ml_mdm_tpu_torch/_build/; the calls release the GIL, so the reader's
// worker threads decode and tokenize on several cores at once.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC datacore.cpp -o libdatacore.so -ljpeg
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include <jpeglib.h>
#include <csetjmp>

extern "C" {

// ---------------------------------------------------------------------------
// trie tokenizer
// ---------------------------------------------------------------------------

struct TrieNode {
  // byte -> child index (+1, 0 = absent); id + 1 (0 = not a token end)
  int32_t child[256];
  int32_t id_plus1;
};

struct Tok {
  std::vector<TrieNode> nodes;
  std::vector<double> scores;
};

static int32_t tok_child(Tok* t, int32_t node, uint8_t b) {
  return t->nodes[node].child[b];  // index+1 or 0
}

// tokens: concatenated bytes; offsets: n+1 entries delimiting each token.
void* dc_tok_new(const uint8_t* blob, const int64_t* offsets, int32_t n,
                 const double* scores) {
  Tok* t = new Tok();
  t->nodes.emplace_back();
  std::memset(&t->nodes[0], 0, sizeof(TrieNode));
  t->scores.assign(scores, scores + n);
  for (int32_t i = 0; i < n; ++i) {
    int32_t node = 0;
    for (int64_t p = offsets[i]; p < offsets[i + 1]; ++p) {
      uint8_t b = blob[p];
      int32_t nxt = t->nodes[node].child[b];
      if (nxt == 0) {
        t->nodes.emplace_back();
        std::memset(&t->nodes.back(), 0, sizeof(TrieNode));
        nxt = (int32_t)t->nodes.size() - 1 + 1;
        t->nodes[node].child[b] = nxt;
      }
      node = nxt - 1;
    }
    if (t->nodes[node].id_plus1 == 0) t->nodes[node].id_plus1 = i + 1;
  }
  return t;
}

void dc_tok_free(void* h) { delete (Tok*)h; }

// Min-total-score Viterbi segmentation; the same search as the Python
// tokenize_shortest in language_models/tokenizer.py (same unk handling).
int32_t dc_tok_tokenize(void* h, const uint8_t* text, int32_t n,
                        int32_t use_scores, int32_t* out, int32_t max_out) {
  Tok* t = (Tok*)h;
  const double INF = std::numeric_limits<double>::infinity();
  const double UNK_COST = 1e9;
  std::vector<double> dist(n + 1, INF);
  std::vector<int32_t> back_pos(n + 1, -1);
  std::vector<int32_t> back_tok(n + 1, -1);
  dist[0] = 0.0;

  for (int32_t i = 0; i < n; ++i) {
    double di = dist[i];
    if (di == INF) continue;
    int32_t node = 0;
    bool matched = false;
    for (int32_t j = i; j < n;) {
      int32_t nxt = tok_child(t, node, text[j]);
      if (nxt == 0) break;
      node = nxt - 1;
      ++j;
      int32_t id1 = t->nodes[node].id_plus1;
      if (id1 != 0) {
        matched = true;
        double cost = di + (use_scores ? t->scores[id1 - 1] : 1.0);
        if (cost < dist[j]) {
          dist[j] = cost;
          back_pos[j] = i;
          back_tok[j] = id1 - 1;
        }
      }
    }
    if (!matched || dist[i + 1] == INF) {
      double cost = di + UNK_COST;
      if (cost < dist[i + 1]) {
        dist[i + 1] = cost;
        back_pos[i + 1] = i;
        back_tok[i + 1] = -1;
      }
    }
  }

  // walk back, then reverse into out
  std::vector<int32_t> rev;
  for (int32_t pos = n; pos > 0;) {
    if (back_pos[pos] < 0) return -1;  // unreachable (shouldn't happen)
    if (back_tok[pos] >= 0) rev.push_back(back_tok[pos]);
    pos = back_pos[pos];
  }
  int32_t m = (int32_t)rev.size();
  if (m > max_out) return -m;  // caller retries with a bigger buffer
  for (int32_t i = 0; i < m; ++i) out[i] = rev[m - 1 - i];
  return m;
}

// ---------------------------------------------------------------------------
// JPEG decode + smallest-side resize + crop (uint8 RGB, HWC)
// ---------------------------------------------------------------------------

struct JErr {
  struct jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jerr_exit(j_common_ptr cinfo) {
  JErr* e = (JErr*)cinfo->err;
  longjmp(e->jb, 1);
}

// Separable triangle-filter resampler (PIL BILINEAR semantics: the filter
// support widens by the downscale factor, i.e. antialiased). One axis at a
// time; weights precomputed per output coordinate.
struct ResampleWeights {
  std::vector<int> first;        // first source index per output pixel
  std::vector<int> count;        // number of taps
  std::vector<float> w;          // taps, row-major [out][tap]
  int max_taps;
};

static ResampleWeights triangle_weights(int in_size, int out_size) {
  ResampleWeights rw;
  double scale = (double)in_size / out_size;
  double fscale = std::max(scale, 1.0);
  double support = 1.0 * fscale;  // triangle filter support = 1
  int max_taps = (int)std::ceil(support) * 2 + 1;
  rw.first.resize(out_size);
  rw.count.resize(out_size);
  rw.w.assign((size_t)out_size * max_taps, 0.f);
  rw.max_taps = max_taps;
  for (int x = 0; x < out_size; ++x) {
    double center = (x + 0.5) * scale;
    int xmin = (int)std::max(0.0, std::floor(center - support));
    int xmax = (int)std::min((double)in_size, std::ceil(center + support));
    double total = 0.0;
    int k = 0;
    for (int j = xmin; j < xmax; ++j, ++k) {
      double dist = std::abs((j - center + 0.5) / fscale);
      double wt = dist < 1.0 ? 1.0 - dist : 0.0;
      rw.w[(size_t)x * max_taps + k] = (float)wt;
      total += wt;
    }
    if (total > 0) {
      for (int i = 0; i < k; ++i) rw.w[(size_t)x * max_taps + i] /= (float)total;
    }
    rw.first[x] = xmin;
    rw.count[x] = k;
  }
  return rw;
}

static void resize_bilinear(const uint8_t* src, int sw, int sh,
                            uint8_t* dst, int dw, int dh) {
  ResampleWeights wx = triangle_weights(sw, dw);
  ResampleWeights wy = triangle_weights(sh, dh);
  // pass 1: horizontal, keep float intermediate for precision
  std::vector<float> tmp((size_t)sh * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + (size_t)y * sw * 3;
    float* orow = tmp.data() + (size_t)y * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float acc[3] = {0, 0, 0};
      int f = wx.first[x], n = wx.count[x];
      const float* ww = &wx.w[(size_t)x * wx.max_taps];
      for (int k = 0; k < n; ++k) {
        const uint8_t* p = row + (size_t)(f + k) * 3;
        float wt = ww[k];
        acc[0] += wt * p[0];
        acc[1] += wt * p[1];
        acc[2] += wt * p[2];
      }
      orow[x * 3 + 0] = acc[0];
      orow[x * 3 + 1] = acc[1];
      orow[x * 3 + 2] = acc[2];
    }
  }
  // pass 2: vertical
  for (int y = 0; y < dh; ++y) {
    int f = wy.first[y], n = wy.count[y];
    const float* ww = &wy.w[(size_t)y * wy.max_taps];
    uint8_t* orow = dst + (size_t)y * dw * 3;
    for (int x = 0; x < dw * 3; ++x) {
      float acc = 0;
      for (int k = 0; k < n; ++k)
        acc += ww[k] * tmp[(size_t)(f + k) * dw * 3 + x];
      orow[x] = (uint8_t)std::min(255.f, std::max(0.f, acc + 0.5f));
    }
  }
}

static uint64_t xorshift(uint64_t* s) {
  uint64_t x = *s;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  return *s = x;
}

// Decode JPEG bytes; resize smallest side to `smaller_side` (if > 0);
// crop `crop` x `crop` (center, or random with seed). out must hold
// crop*crop*3 bytes (or, when crop <= 0, call dc_image_probe first).
// Returns 0 ok, <0 error.
int32_t dc_image_decode_resize_crop(const uint8_t* data, int64_t len,
                                    int32_t smaller_side, int32_t crop,
                                    int32_t random_crop, uint64_t seed,
                                    uint8_t* out) {
  struct jpeg_decompress_struct cinfo;
  JErr jerr;
  // buffers declared BEFORE setjmp: a longjmp from mid-decode lands back
  // here and returns normally, so their destructors still run (corrupt
  // web-scraped JPEGs must not leak per-image allocations)
  std::vector<uint8_t> img;
  std::vector<uint8_t> resized;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jerr_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, (unsigned char*)data, (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  // libjpeg can decode at 1/2, 1/4, 1/8 scale: pick the smallest scale
  // that still covers the target (big win for 4k photos -> 64px crops)
  if (smaller_side > 0) {
    int min_dim = std::min((int)cinfo.image_width, (int)cinfo.image_height);
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
    for (int denom = 2; denom <= 8; denom *= 2) {
      if (min_dim / denom >= smaller_side * 2) cinfo.scale_denom = denom;
    }
  }
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  img.resize((size_t)w * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img.data() + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // resize smallest side

  const uint8_t* cur = img.data();
  int cw = w, ch = h;
  if (smaller_side > 0 && std::min(w, h) != smaller_side) {
    int nw, nh;
    if (w <= h) {
      nw = smaller_side;
      nh = std::max(smaller_side, (int)std::lround((double)h * smaller_side / w));
    } else {
      nh = smaller_side;
      nw = std::max(smaller_side, (int)std::lround((double)w * smaller_side / h));
    }
    resized.resize((size_t)nw * nh * 3);
    resize_bilinear(img.data(), w, h, resized.data(), nw, nh);
    cur = resized.data();
    cw = nw;
    ch = nh;
  }

  if (crop <= 0) return -3;
  if (cw < crop || ch < crop) return -4;
  int x0, y0;
  if (random_crop) {
    uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ull;
    x0 = (int)(xorshift(&s) % (uint64_t)(cw - crop + 1));
    y0 = (int)(xorshift(&s) % (uint64_t)(ch - crop + 1));
  } else {
    x0 = (cw - crop) / 2;
    y0 = (ch - crop) / 2;
  }
  for (int y = 0; y < crop; ++y) {
    std::memcpy(out + (size_t)y * crop * 3,
                cur + ((size_t)(y + y0) * cw + x0) * 3, (size_t)crop * 3);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// tar member index (ustar, PAX and GNU long names)
// ---------------------------------------------------------------------------

struct TarIndex {
  FILE* f;
  std::unordered_map<std::string, std::pair<int64_t, int64_t>> members;
  std::mutex mu;
};

static int64_t parse_octal(const char* p, int n) {
  int64_t v = 0;
  for (int i = 0; i < n && p[i]; ++i) {
    if (p[i] >= '0' && p[i] <= '7') v = v * 8 + (p[i] - '0');
  }
  return v;
}

void* dc_tar_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  TarIndex* t = new TarIndex();
  t->f = f;
  char hdr[512];
  std::string longname;   // GNU 'L' override for the next entry
  std::string pax_path;   // PAX 'x' path= override for the next entry
  int64_t off = 0;
  while (std::fread(hdr, 1, 512, f) == 512) {
    off += 512;
    if (hdr[0] == 0) break;  // end-of-archive zero block
    int64_t size = parse_octal(hdr + 124, 12);
    char type = hdr[156];
    std::string name(hdr, strnlen(hdr, 100));
    if (hdr[345]) {  // ustar prefix
      std::string prefix(hdr + 345, strnlen(hdr + 345, 155));
      name = prefix + "/" + name;
    }
    int64_t blocks = (size + 511) / 512;
    if (type == 'L' || type == 'x' || type == 'g') {
      // metadata entry whose payload modifies the next (or all) entries
      std::vector<char> buf(size);
      if (std::fread(buf.data(), 1, size, f) != (size_t)size) break;
      std::fseek(f, blocks * 512 - size, SEEK_CUR);
      off += blocks * 512;
      if (type == 'L') {  // GNU long name: payload is the real name
        longname.assign(buf.data(), strnlen(buf.data(), size));
      } else if (type == 'x') {
        // PAX records: "LEN key=value\n" (python tarfile default format)
        size_t p = 0;
        while (p < (size_t)size) {
          size_t sp = p;
          while (sp < (size_t)size && buf[sp] != ' ') ++sp;
          long rec_len = std::strtol(&buf[p], nullptr, 10);
          if (rec_len <= 0 || p + rec_len > (size_t)size) break;
          std::string rec(&buf[sp + 1], rec_len - (sp + 1 - p) - 1);
          if (rec.rfind("path=", 0) == 0) pax_path = rec.substr(5);
          p += rec_len;
        }
      }
      continue;  // 'g' (global) records carry nothing we need
    }
    if (!pax_path.empty()) {
      name = pax_path;
      pax_path.clear();
    } else if (!longname.empty()) {
      name = longname;
      longname.clear();
    }
    if (type == '0' || type == 0) t->members[name] = {off, size};
    std::fseek(f, blocks * 512, SEEK_CUR);
    off += blocks * 512;
  }
  return t;
}

int64_t dc_tar_member_size(void* h, const char* name) {
  TarIndex* t = (TarIndex*)h;
  auto it = t->members.find(name);
  return it == t->members.end() ? -1 : it->second.second;
}

int64_t dc_tar_read(void* h, const char* name, uint8_t* out, int64_t cap) {
  TarIndex* t = (TarIndex*)h;
  auto it = t->members.find(name);
  if (it == t->members.end()) return -1;
  int64_t off = it->second.first, size = it->second.second;
  if (size > cap) return -size;
  std::lock_guard<std::mutex> lock(t->mu);
  if (std::fseek(t->f, (long)off, SEEK_SET) != 0) return -1;
  if (std::fread(out, 1, (size_t)size, t->f) != (size_t)size) return -1;
  return size;
}

void dc_tar_free(void* h) {
  TarIndex* t = (TarIndex*)h;
  if (t) {
    std::fclose(t->f);
    delete t;
  }
}

}  // extern "C"
