// Read-only LMDB data-file walker: the native backend of
// dmme_tpu_torch.data.lmdb_reader (same format logic as the Python
// implementation; see that module's docstring for the layout notes).
//
// Exposed as a tiny C API consumed via ctypes: open/close, entry count,
// ordered iteration, and point lookup. Values are returned as pointers into
// the mmap — zero-copy; the Python side copies only when it needs to keep
// data past the reader's lifetime.
//
// Built by dmme_tpu_torch/native/__init__.py:
//   g++ -O2 -shared -fPIC -std=c++17 -o build/dmme_tpu_torch/liblmdb_scan-<hash>.so lmdb_scan.cc

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint16_t kBranch = 0x01, kLeaf = 0x02, kOverflow = 0x04;
constexpr uint16_t kLeaf2 = 0x20;
constexpr uint16_t kBigData = 0x01;
constexpr uint64_t kInvalid = ~0ull;
constexpr size_t kPageHdr = 16;

template <typename T>
T rd(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

struct Env {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t size = 0;
  uint64_t psize = 0;
  uint64_t root = kInvalid;
  uint64_t entries = 0;

  const uint8_t* page(uint64_t pgno) const { return map + pgno * psize; }
};

struct Meta {
  uint64_t root, entries, txnid;
  uint32_t psize;
  bool ok;
};

Meta parse_meta(const Env& e, size_t off) {
  Meta m{kInvalid, 0, 0, 0, false};
  if (off + 160 > e.size) return m;
  const uint8_t* p = e.map + off + kPageHdr;
  if (rd<uint32_t>(p) != kMagic) return m;
  const uint8_t* base = p + 8 + 8 + 8;  // magic+ver, mm_address, mm_mapsize
  m.psize = rd<uint32_t>(base);         // FREE_DBI md_pad carries page size
  const uint8_t* main_db = base + 48;
  m.entries = rd<uint64_t>(main_db + 32);
  m.root = rd<uint64_t>(main_db + 40);
  m.txnid = rd<uint64_t>(base + 96 + 8);
  m.ok = true;
  return m;
}

inline uint16_t page_flags(const uint8_t* pg) { return rd<uint16_t>(pg + 10); }
inline int numkeys(const uint8_t* pg) {
  return (rd<uint16_t>(pg + 12) - kPageHdr) >> 1;
}
inline const uint8_t* node(const uint8_t* pg, int i) {
  return pg + rd<uint16_t>(pg + kPageHdr + 2 * i);
}
inline uint64_t branch_child(const uint8_t* n) {
  return (uint64_t)rd<uint16_t>(n) | ((uint64_t)rd<uint16_t>(n + 2) << 16) |
         ((uint64_t)rd<uint16_t>(n + 4) << 32);
}

struct Val {
  const uint8_t* data;
  uint64_t len;
};

Val leaf_value(const Env& e, const uint8_t* n) {
  uint64_t size = (uint64_t)rd<uint16_t>(n) | ((uint64_t)rd<uint16_t>(n + 2) << 16);
  uint16_t flags = rd<uint16_t>(n + 4);
  uint16_t ksize = rd<uint16_t>(n + 6);
  if (flags & kBigData) {
    uint64_t ov = rd<uint64_t>(n + 8 + ksize);
    return {e.page(ov) + kPageHdr, size};
  }
  return {n + 8 + ksize, size};
}

int key_cmp(const uint8_t* a, uint64_t alen, const uint8_t* b, uint64_t blen) {
  size_t n = alen < blen ? alen : blen;
  int c = std::memcmp(a, b, n);
  if (c) return c;
  return alen < blen ? -1 : (alen > blen ? 1 : 0);
}

struct Iter {
  const Env* env;
  // stack of (page_offset, next_index)
  std::vector<std::pair<const uint8_t*, int>> stack;
};

void descend_first(Iter* it, uint64_t pgno) {
  const uint8_t* pg = it->env->page(pgno);
  while (page_flags(pg) & kBranch) {
    it->stack.push_back({pg, 1});  // child 0 taken; resume at 1
    pg = it->env->page(branch_child(node(pg, 0)));
  }
  it->stack.push_back({pg, 0});
}

}  // namespace

extern "C" {

void* lmdb_open(const char* path) {
  std::string p(path);
  struct stat st;
  if (stat(p.c_str(), &st) == 0 && S_ISDIR(st.st_mode)) p += "/data.mdb";
  int fd = open(p.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (m == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Env* e = new Env();
  e->fd = fd;
  e->map = static_cast<const uint8_t*>(m);
  e->size = st.st_size;
  Meta m0 = parse_meta(*e, 0);
  if (!m0.ok) {
    munmap(m, st.st_size);
    close(fd);
    delete e;
    return nullptr;
  }
  e->psize = m0.psize ? m0.psize : 4096;
  Meta m1 = parse_meta(*e, e->psize);
  const Meta& live = (m1.ok && m1.txnid > m0.txnid) ? m1 : m0;
  e->root = live.root;
  e->entries = live.entries;
  return e;
}

void lmdb_close(void* h) {
  Env* e = static_cast<Env*>(h);
  if (!e) return;
  munmap(const_cast<uint8_t*>(e->map), e->size);
  close(e->fd);
  delete e;
}

uint64_t lmdb_entries(void* h) { return static_cast<Env*>(h)->entries; }

void* lmdb_iter_new(void* h) {
  Env* e = static_cast<Env*>(h);
  Iter* it = new Iter();
  it->env = e;
  if (e->root != kInvalid) descend_first(it, e->root);
  return it;
}

// returns 1 and fills outputs, or 0 at end
int lmdb_iter_next(void* hit, const uint8_t** key, uint64_t* klen,
                   const uint8_t** val, uint64_t* vlen) {
  Iter* it = static_cast<Iter*>(hit);
  while (!it->stack.empty()) {
    auto& top = it->stack.back();
    const uint8_t* pg = top.first;
    int n = numkeys(pg);
    if (page_flags(pg) & kLeaf) {
      if (page_flags(pg) & kLeaf2) return 0;  // unsupported
      if (top.second < n) {
        const uint8_t* nd = node(pg, top.second++);
        *klen = rd<uint16_t>(nd + 6);
        *key = nd + 8;
        Val v = leaf_value(*it->env, nd);
        *val = v.data;
        *vlen = v.len;
        return 1;
      }
      it->stack.pop_back();
    } else {  // branch: resume at next child
      if (top.second < n) {
        uint64_t child = branch_child(node(pg, top.second++));
        descend_first(it, child);
      } else {
        it->stack.pop_back();
      }
    }
  }
  return 0;
}

void lmdb_iter_free(void* hit) { delete static_cast<Iter*>(hit); }

int lmdb_get(void* h, const uint8_t* key, uint64_t klen, const uint8_t** val,
             uint64_t* vlen) {
  Env* e = static_cast<Env*>(h);
  if (e->root == kInvalid) return 0;
  const uint8_t* pg = e->page(e->root);
  while (true) {
    int n = numkeys(pg);
    if (page_flags(pg) & kLeaf) {
      int lo = 0, hi = n - 1;
      while (lo <= hi) {
        int mid = (lo + hi) / 2;
        const uint8_t* nd = node(pg, mid);
        int c = key_cmp(nd + 8, rd<uint16_t>(nd + 6), key, klen);
        if (c == 0) {
          Val v = leaf_value(*e, nd);
          *val = v.data;
          *vlen = v.len;
          return 1;
        }
        if (c < 0)
          lo = mid + 1;
        else
          hi = mid - 1;
      }
      return 0;
    }
    // branch: rightmost child whose key <= target (node 0 = -inf)
    int idx = 0;
    for (int i = 1; i < n; ++i) {
      const uint8_t* nd = node(pg, i);
      if (key_cmp(nd + 8, rd<uint16_t>(nd + 6), key, klen) <= 0)
        idx = i;
      else
        break;
    }
    pg = e->page(branch_child(node(pg, idx)));
  }
}

}  // extern "C"
