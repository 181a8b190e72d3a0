// mmap'd safetensors reader with a C ABI (ctypes-consumed).
//
// Native-runtime counterpart of the reference's weight loading
// (cake-core/src/utils/mod.rs:85-104: VarBuilder::from_mmaped_safetensors):
// the file is mapped read-only, the JSON header parsed once, and tensor
// data exposed as zero-copy pointers into the mapping. madvise() gives the
// kernel sequential/willneed hints so multi-GB checkpoint reads stream at
// disk bandwidth instead of faulting page-by-page while the Python side
// copies them to the card.
//
// Build: g++ -O2 -shared -fPIC (see cake_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct TensorMeta {
  std::string name;
  std::string dtype;
  std::vector<int64_t> shape;
  int64_t begin = 0;  // relative to data section
  int64_t end = 0;
};

// ---- minimal JSON subset parser (safetensors headers only) ----------------
// Grammar actually used by safetensors: object of
//   name -> {"dtype": str, "shape": [ints], "data_offsets": [int, int]}
// plus optional "__metadata__" -> {str: str}.

struct Parser {
  const char* p;
  const char* end;
  std::string err;

  bool fail(const char* msg) {
    if (err.empty()) err = msg;
    return false;
  }
  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }
  bool expect(char c) {
    ws();
    if (p >= end || *p != c) return fail("unexpected character");
    ++p;
    return true;
  }
  bool peek(char c) {
    ws();
    return p < end && *p == c;
  }
  bool string(std::string* out) {
    ws();
    if (p >= end || *p != '"') return fail("expected string");
    ++p;
    out->clear();
    while (p < end && *p != '"') {
      if (*p == '\\') {
        ++p;
        if (p >= end) return fail("bad escape");
        switch (*p) {
          case '"': out->push_back('"'); break;
          case '\\': out->push_back('\\'); break;
          case '/': out->push_back('/'); break;
          case 'b': out->push_back('\b'); break;
          case 'f': out->push_back('\f'); break;
          case 'n': out->push_back('\n'); break;
          case 'r': out->push_back('\r'); break;
          case 't': out->push_back('\t'); break;
          case 'u': {  // keep the raw sequence; names never need it decoded
            out->push_back('\\');
            out->push_back('u');
            break;
          }
          default: return fail("bad escape");
        }
        ++p;
      } else {
        out->push_back(*p++);
      }
    }
    if (p >= end) return fail("unterminated string");
    ++p;
    return true;
  }
  bool integer(int64_t* out) {
    ws();
    bool neg = false;
    if (p < end && *p == '-') { neg = true; ++p; }
    if (p >= end || *p < '0' || *p > '9') return fail("expected integer");
    int64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    *out = neg ? -v : v;
    return true;
  }
  bool int_array(std::vector<int64_t>* out) {
    out->clear();
    if (!expect('[')) return false;
    if (peek(']')) { ++p; return true; }
    for (;;) {
      int64_t v;
      if (!integer(&v)) return false;
      out->push_back(v);
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      return expect(']');
    }
  }
  // skip a {str: str} object (metadata)
  bool skip_string_object() {
    if (!expect('{')) return false;
    if (peek('}')) { ++p; return true; }
    for (;;) {
      std::string k, v;
      if (!string(&k) || !expect(':') || !string(&v)) return false;
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      return expect('}');
    }
  }
  bool tensor_entry(TensorMeta* t) {
    if (!expect('{')) return false;
    for (;;) {
      std::string key;
      if (!string(&key) || !expect(':')) return false;
      if (key == "dtype") {
        if (!string(&t->dtype)) return false;
      } else if (key == "shape") {
        if (!int_array(&t->shape)) return false;
      } else if (key == "data_offsets") {
        std::vector<int64_t> off;
        if (!int_array(&off) || off.size() != 2) return fail("bad offsets");
        t->begin = off[0];
        t->end = off[1];
      } else {
        return fail("unknown tensor key");
      }
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      return expect('}');
    }
  }
  bool header(std::vector<TensorMeta>* out) {
    if (!expect('{')) return false;
    if (peek('}')) { ++p; return true; }
    for (;;) {
      std::string name;
      if (!string(&name) || !expect(':')) return false;
      if (name == "__metadata__") {
        if (!skip_string_object()) return false;
      } else {
        TensorMeta t;
        t.name = std::move(name);
        if (!tensor_entry(&t)) return false;
        out->push_back(std::move(t));
      }
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      return expect('}');
    }
  }
};

struct StFile {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_len = 0;
  int64_t data_offset = 0;
  std::vector<TensorMeta> tensors;
};

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

void* cake_st_open(const char* path, char* err, int errlen) {
  StFile* f = new StFile();
  f->fd = ::open(path, O_RDONLY);
  if (f->fd < 0) {
    set_err(err, errlen, std::string("open failed: ") + path);
    delete f;
    return nullptr;
  }
  struct stat st;
  if (fstat(f->fd, &st) != 0 || st.st_size < 8) {
    set_err(err, errlen, "stat failed or file too small");
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  f->map_len = static_cast<size_t>(st.st_size);
  void* m = mmap(nullptr, f->map_len, PROT_READ, MAP_PRIVATE, f->fd, 0);
  if (m == MAP_FAILED) {
    set_err(err, errlen, "mmap failed");
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  f->map = static_cast<const uint8_t*>(m);

  uint64_t hlen = 0;
  std::memcpy(&hlen, f->map, 8);  // little-endian host assumed (x86/arm LE)
  if (8 + hlen > f->map_len) {
    set_err(err, errlen, "header length out of bounds");
    munmap(const_cast<uint8_t*>(f->map), f->map_len);
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  f->data_offset = static_cast<int64_t>(8 + hlen);

  Parser parser{reinterpret_cast<const char*>(f->map + 8),
                reinterpret_cast<const char*>(f->map + 8 + hlen)};
  if (!parser.header(&f->tensors)) {
    set_err(err, errlen, "header parse error: " + parser.err);
    munmap(const_cast<uint8_t*>(f->map), f->map_len);
    ::close(f->fd);
    delete f;
    return nullptr;
  }
  // bounds-check every tensor against the data section
  int64_t data_len = static_cast<int64_t>(f->map_len) - f->data_offset;
  for (const TensorMeta& t : f->tensors) {
    if (t.begin < 0 || t.end < t.begin || t.end > data_len) {
      set_err(err, errlen, "tensor offsets out of bounds: " + t.name);
      munmap(const_cast<uint8_t*>(f->map), f->map_len);
      ::close(f->fd);
      delete f;
      return nullptr;
    }
  }
  madvise(const_cast<uint8_t*>(f->map), f->map_len, MADV_SEQUENTIAL);
  return f;
}

int64_t cake_st_num_tensors(void* h) {
  return static_cast<int64_t>(static_cast<StFile*>(h)->tensors.size());
}

const char* cake_st_name(void* h, int64_t i) {
  return static_cast<StFile*>(h)->tensors[i].name.c_str();
}

const char* cake_st_dtype(void* h, int64_t i) {
  return static_cast<StFile*>(h)->tensors[i].dtype.c_str();
}

int32_t cake_st_ndim(void* h, int64_t i) {
  return static_cast<int32_t>(
      static_cast<StFile*>(h)->tensors[i].shape.size());
}

void cake_st_shape(void* h, int64_t i, int64_t* out) {
  const auto& shape = static_cast<StFile*>(h)->tensors[i].shape;
  for (size_t d = 0; d < shape.size(); ++d) out[d] = shape[d];
}

const uint8_t* cake_st_data(void* h, int64_t i, int64_t* nbytes) {
  StFile* f = static_cast<StFile*>(h);
  const TensorMeta& t = f->tensors[i];
  if (nbytes) *nbytes = t.end - t.begin;
  return f->map + f->data_offset + t.begin;
}

void cake_st_prefetch(void* h, int64_t i) {
  StFile* f = static_cast<StFile*>(h);
  const TensorMeta& t = f->tensors[i];
  const uint8_t* base = f->map + f->data_offset + t.begin;
  size_t len = static_cast<size_t>(t.end - t.begin);
  // align down to page for madvise
  uintptr_t addr = reinterpret_cast<uintptr_t>(base);
  uintptr_t page = addr & ~static_cast<uintptr_t>(4095);
  madvise(reinterpret_cast<void*>(page), len + (addr - page), MADV_WILLNEED);
}

void cake_st_close(void* h) {
  StFile* f = static_cast<StFile*>(h);
  if (f->map) munmap(const_cast<uint8_t*>(f->map), f->map_len);
  if (f->fd >= 0) ::close(f->fd);
  delete f;
}

}  // extern "C"
