// GSTF feature-store reader: mmap + O(1) id lookup + <IMG>-token assembly.
//
// The port's copy of gstx/native/feature_store.cc: the native equivalent of
// gstx_torch/data/feature_store.py::FeatureStoreReader (which replaces the
// reference's LMDB/pickle/base64 reader, utils/image_features_reader.py:
// 11-149).  The C++ path exists so data-loading worker threads can read and
// assemble region features without holding the Python GIL; output semantics
// are identical to the Python reader (tests/test_torch_port_data.py).
//
// C ABI (ctypes):
//   void*  gstf_open(const char* path);
//   void   gstf_close(void* handle);
//   long   gstf_num_items(void* handle);
//   int    gstf_feat_dim(void* handle);
//   int    gstf_num_classes(void* handle);
//   long   gstf_keys(void* handle, long long* out, long cap);
//   int    gstf_num_boxes(void* handle, long long image_id);  // -1 missing
//   int    gstf_read(void* handle, long long image_id,
//                    float* feat_out,      // [num_boxes+1, feat_dim]
//                    float* loc_out,       // [num_boxes+1, 5]
//                    float* loc_ori_out,   // [num_boxes+1, 5]
//                    float* cls_out);      // [num_boxes+1, num_classes]

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

#pragma pack(push, 1)
struct Header {
  char magic[4];
  uint32_t version;
  uint32_t feat_dim;
  uint32_t num_classes;
  uint64_t num_items;
  uint64_t index_offset;
};
struct IndexEntry {
  int64_t image_id;
  uint64_t offset;
  uint32_t num_boxes;
  uint32_t image_h;
  uint32_t image_w;
  uint32_t pad;
};
#pragma pack(pop)

struct Entry {
  uint64_t offset;
  uint32_t num_boxes;
  uint32_t image_h;
  uint32_t image_w;
};

struct Store {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  uint32_t feat_dim = 0;
  uint32_t num_classes = 0;
  std::vector<int64_t> keys;
  std::unordered_map<int64_t, Entry> index;
};

}  // namespace

extern "C" {

void* gstf_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->data = static_cast<const uint8_t*>(mem);
  s->size = st.st_size;

  auto reject = [&]() {
    munmap(mem, st.st_size);
    ::close(fd);
    delete s;
    return nullptr;
  };
  // every header/index/record access is validated against the mapping so a
  // truncated or corrupt store returns NULL / -1 (like the Python reader's
  // struct.error) instead of SIGSEGV-ing the dataloader process
  if (s->size < sizeof(Header)) return reject();
  Header h;
  std::memcpy(&h, s->data, sizeof(Header));
  if (std::memcmp(h.magic, "GSTF", 4) != 0 || h.version != 1) {
    return reject();
  }
  if (h.index_offset > s->size ||
      h.num_items > (s->size - h.index_offset) / sizeof(IndexEntry)) {
    return reject();
  }
  s->feat_dim = h.feat_dim;
  s->num_classes = h.num_classes;
  s->keys.reserve(h.num_items);
  s->index.reserve(h.num_items * 2);
  const uint8_t* p = s->data + h.index_offset;
  for (uint64_t i = 0; i < h.num_items; ++i) {
    IndexEntry e;
    std::memcpy(&e, p, sizeof(IndexEntry));
    p += sizeof(IndexEntry);
    // record extent: n*(feat_dim + 4 + num_classes) f32 starting at offset
    // (division form avoids uint64 overflow on hostile num_boxes values)
    const uint64_t row_bytes = (static_cast<uint64_t>(h.feat_dim) + 4 +
                                static_cast<uint64_t>(h.num_classes)) *
                               sizeof(float);
    if (e.offset > s->size || e.num_boxes == 0 ||
        e.num_boxes > (s->size - e.offset) / row_bytes) {
      return reject();
    }
    s->keys.push_back(e.image_id);
    s->index[e.image_id] = Entry{e.offset, e.num_boxes, e.image_h, e.image_w};
  }
  return s;
}

void gstf_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return;
  munmap(const_cast<uint8_t*>(s->data), s->size);
  ::close(s->fd);
  delete s;
}

long gstf_num_items(void* handle) {
  return static_cast<Store*>(handle)->keys.size();
}
int gstf_feat_dim(void* handle) {
  return static_cast<Store*>(handle)->feat_dim;
}
int gstf_num_classes(void* handle) {
  return static_cast<Store*>(handle)->num_classes;
}

long gstf_keys(void* handle, long long* out, long cap) {
  auto* s = static_cast<Store*>(handle);
  long n = 0;
  for (int64_t k : s->keys) {
    if (n >= cap) break;
    out[n++] = k;
  }
  return n;
}

int gstf_num_boxes(void* handle, long long image_id) {
  auto* s = static_cast<Store*>(handle);
  auto it = s->index.find(image_id);
  if (it == s->index.end()) return -1;
  return static_cast<int>(it->second.num_boxes);
}

// Reads one item and assembles the reference reader's output contract
// (image_features_reader.py:118-146): prepend the <IMG> mean-feature row,
// normalize box coordinates + relative area, one-hot background cls row.
int gstf_read(void* handle, long long image_id, float* feat_out,
              float* loc_out, float* loc_ori_out, float* cls_out) {
  auto* s = static_cast<Store*>(handle);
  auto it = s->index.find(image_id);
  if (it == s->index.end()) return -1;
  const Entry& e = it->second;
  const uint32_t n = e.num_boxes;
  const uint32_t fd = s->feat_dim;
  const uint32_t nc = s->num_classes;
  const float w = static_cast<float>(e.image_w);
  const float h = static_cast<float>(e.image_h);

  const float* feats =
      reinterpret_cast<const float*>(s->data + e.offset);
  const float* boxes = feats + static_cast<size_t>(n) * fd;
  const float* cls = boxes + static_cast<size_t>(n) * 4;

  // <IMG> mean feature row
  for (uint32_t j = 0; j < fd; ++j) feat_out[j] = 0.0f;
  for (uint32_t i = 0; i < n; ++i) {
    const float* row = feats + static_cast<size_t>(i) * fd;
    float* dst = feat_out + static_cast<size_t>(i + 1) * fd;
    for (uint32_t j = 0; j < fd; ++j) {
      dst[j] = row[j];
      feat_out[j] += row[j];
    }
  }
  // divide, don't multiply by a reciprocal: numpy computes
  // sum / n (feature_store.py:157) and the double rounding of
  // sum * (1/n) diverges from it by 1 ulp on ~10% of elements —
  // the bit-for-bit native invariant requires the same operation
  const float fn = static_cast<float>(n);
  for (uint32_t j = 0; j < fd; ++j) feat_out[j] /= fn;

  // locations: [x1, y1, x2, y2, rel_area]; row 0 = [0,0,1,1,1]
  loc_out[0] = 0;
  loc_out[1] = 0;
  loc_out[2] = 1;
  loc_out[3] = 1;
  loc_out[4] = 1;
  loc_ori_out[0] = 0;
  loc_ori_out[1] = 0;
  loc_ori_out[2] = w;
  loc_ori_out[3] = h;
  loc_ori_out[4] = w * h;
  for (uint32_t i = 0; i < n; ++i) {
    const float* b = boxes + static_cast<size_t>(i) * 4;
    float* lo = loc_ori_out + static_cast<size_t>(i + 1) * 5;
    float* ln = loc_out + static_cast<size_t>(i + 1) * 5;
    const float area = (b[3] - b[1]) * (b[2] - b[0]) / (w * h);
    lo[0] = b[0];
    lo[1] = b[1];
    lo[2] = b[2];
    lo[3] = b[3];
    lo[4] = area;
    ln[0] = b[0] / w;
    ln[1] = b[1] / h;
    ln[2] = b[2] / w;
    ln[3] = b[3] / h;
    ln[4] = area;
  }

  // cls_prob: one-hot background row then raw rows
  for (uint32_t j = 0; j < nc; ++j) cls_out[j] = 0.0f;
  cls_out[0] = 1.0f;
  std::memcpy(cls_out + nc, cls, static_cast<size_t>(n) * nc * sizeof(float));
  return static_cast<int>(n + 1);
}

}  // extern "C"
