// Shared-memory arena object store — the native core of the node-local
// object store ("plasma" equivalent).
//
// TPU-native rebuild of the reference's plasma store internals
// (reference: src/ray/object_manager/plasma/store.h:55 PlasmaStore,
// dlmalloc.cc arena allocation, eviction_policy.h LRU,
// obj_lifecycle_mgr.h object table). Design:
//
//   * ONE posix shm arena per node (vs. the Python fallback's
//     segment-per-object): clients mmap the arena once and read objects at
//     (offset, size) — zero-copy, one mmap per process for any object count.
//   * first-fit free-list allocator with neighbour coalescing (the role
//     dlmalloc plays in the reference).
//   * object table with seal state, pin counts, LRU clock, and an eviction
//     sweep (sealed+unpinned, oldest first).
//
// Exposed as a C ABI consumed via ctypes (this environment has no pybind11);
// the raylet holds the store handle, workers attach the arena by name.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kAlign = 64;  // cache-line align objects

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

struct Entry {
  uint64_t offset = 0;
  uint64_t size = 0;        // requested size
  uint64_t alloc_size = 0;  // aligned size actually reserved
  bool sealed = false;
  int pins = 0;
  uint64_t lru_clock = 0;
  bool is_primary = true;
};

class ArenaStore {
 public:
  ArenaStore(const char* shm_name, uint64_t capacity)
      : shm_name_(shm_name), capacity_(capacity) {
    fd_ = shm_open(shm_name, O_CREAT | O_RDWR, 0600);
    if (fd_ < 0) return;
    if (ftruncate(fd_, static_cast<off_t>(capacity)) != 0) {
      close(fd_);
      fd_ = -1;
      return;
    }
    base_ = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd_, 0);
    if (base_ == MAP_FAILED) {
      base_ = nullptr;
      close(fd_);
      fd_ = -1;
      return;
    }
    free_blocks_[0] = capacity;  // one big free block
  }

  ~ArenaStore() {
    if (base_) munmap(base_, capacity_);
    if (fd_ >= 0) {
      close(fd_);
      shm_unlink(shm_name_.c_str());
    }
  }

  bool ok() const { return base_ != nullptr; }

  // returns offset, or UINT64_MAX when no block fits (caller evicts+retries)
  uint64_t Alloc(const std::string& oid, uint64_t size) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = table_.find(oid);
    if (it != table_.end()) {
      return it->second.sealed ? UINT64_MAX - 1 : it->second.offset;
    }
    uint64_t need = align_up(std::max<uint64_t>(size, 1));
    // first fit
    for (auto fit = free_blocks_.begin(); fit != free_blocks_.end(); ++fit) {
      if (fit->second >= need) {
        uint64_t off = fit->first;
        uint64_t remaining = fit->second - need;
        free_blocks_.erase(fit);
        if (remaining > 0) free_blocks_[off + need] = remaining;
        Entry e;
        e.offset = off;
        e.size = size;
        e.alloc_size = need;
        e.lru_clock = ++clock_;
        table_[oid] = e;
        used_ += need;
        return off;
      }
    }
    return UINT64_MAX;
  }

  int Seal(const std::string& oid) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = table_.find(oid);
    if (it == table_.end()) return -1;
    it->second.sealed = true;
    it->second.lru_clock = ++clock_;
    return 0;
  }

  // pins on success
  int Get(const std::string& oid, uint64_t* offset, uint64_t* size) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = table_.find(oid);
    if (it == table_.end() || !it->second.sealed) return -1;
    it->second.pins++;
    it->second.lru_clock = ++clock_;
    *offset = it->second.offset;
    *size = it->second.size;
    return 0;
  }

  int Unpin(const std::string& oid) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = table_.find(oid);
    if (it == table_.end()) return -1;
    if (it->second.pins > 0) it->second.pins--;
    return 0;
  }

  int Contains(const std::string& oid) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = table_.find(oid);
    return (it != table_.end() && it->second.sealed) ? 1 : 0;
  }

  int MarkSecondary(const std::string& oid) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = table_.find(oid);
    if (it == table_.end()) return -1;
    it->second.is_primary = false;
    return 0;
  }

  int Free(const std::string& oid) {
    std::lock_guard<std::mutex> g(mu_);
    return FreeLocked(oid);
  }

  // Evict sealed, unpinned objects (secondaries first, then LRU) until
  // `need` bytes could be allocated. Evicted ids are written as
  // newline-separated hex into out_buf (for the caller to drop metadata /
  // spill bookkeeping). Returns number evicted, or -1 if still not enough.
  int Evict(uint64_t need, int evict_primaries, char* out_buf, uint64_t buf_len) {
    std::lock_guard<std::mutex> g(mu_);
    need = align_up(std::max<uint64_t>(need, 1));
    uint64_t out_pos = 0;
    int evicted = 0;
    while (LargestFree() < need) {
      // pick victim: secondaries first, then oldest LRU primary
      const std::string* victim = nullptr;
      uint64_t best_clock = UINT64_MAX;
      bool best_primary = true;
      for (const auto& kv : table_) {
        const Entry& e = kv.second;
        if (!e.sealed || e.pins > 0) continue;
        if (e.is_primary && !evict_primaries) continue;
        // secondaries sort before primaries; then LRU
        if ((!e.is_primary && best_primary) ||
            ((e.is_primary == best_primary) && e.lru_clock < best_clock)) {
          victim = &kv.first;
          best_clock = e.lru_clock;
          best_primary = e.is_primary;
        }
      }
      if (!victim) return -1;
      std::string vid = *victim;
      if (out_buf && out_pos + vid.size() + 1 < buf_len) {
        memcpy(out_buf + out_pos, vid.data(), vid.size());
        out_pos += vid.size();
        out_buf[out_pos++] = '\n';
      }
      FreeLocked(vid);
      evicted++;
    }
    if (out_buf && out_pos < buf_len) out_buf[out_pos] = '\0';
    return evicted;
  }

  uint64_t Used() {
    std::lock_guard<std::mutex> g(mu_);
    return used_;
  }
  uint64_t Capacity() const { return capacity_; }
  uint64_t NumObjects() {
    std::lock_guard<std::mutex> g(mu_);
    return table_.size();
  }
  void* Base() const { return base_; }

 private:
  uint64_t LargestFree() const {
    uint64_t best = 0;
    for (const auto& kv : free_blocks_) best = std::max(best, kv.second);
    return best;
  }

  int FreeLocked(const std::string& oid) {
    auto it = table_.find(oid);
    if (it == table_.end()) return -1;
    uint64_t off = it->second.offset;
    uint64_t len = it->second.alloc_size;
    used_ -= len;
    table_.erase(it);
    // coalesce with neighbours
    auto next = free_blocks_.lower_bound(off);
    if (next != free_blocks_.begin()) {
      auto prev = std::prev(next);
      if (prev->first + prev->second == off) {
        off = prev->first;
        len += prev->second;
        free_blocks_.erase(prev);
      }
    }
    next = free_blocks_.lower_bound(off + len);
    if (next != free_blocks_.end() && next->first == off + len) {
      len += next->second;
      free_blocks_.erase(next);
    }
    free_blocks_[off] = len;
    return 0;
  }

  std::string shm_name_;
  uint64_t capacity_;
  int fd_ = -1;
  void* base_ = nullptr;
  std::mutex mu_;
  std::map<uint64_t, uint64_t> free_blocks_;  // offset -> size
  std::unordered_map<std::string, Entry> table_;
  uint64_t used_ = 0;
  uint64_t clock_ = 0;
};

}  // namespace

extern "C" {

void* plasma_create(const char* shm_name, uint64_t capacity) {
  auto* s = new ArenaStore(shm_name, capacity);
  if (!s->ok()) {
    delete s;
    return nullptr;
  }
  return s;
}

void plasma_destroy(void* store) { delete static_cast<ArenaStore*>(store); }

uint64_t plasma_alloc(void* store, const char* oid, uint64_t size) {
  return static_cast<ArenaStore*>(store)->Alloc(oid, size);
}

int plasma_seal(void* store, const char* oid) {
  return static_cast<ArenaStore*>(store)->Seal(oid);
}

int plasma_get(void* store, const char* oid, uint64_t* offset, uint64_t* size) {
  return static_cast<ArenaStore*>(store)->Get(oid, offset, size);
}

int plasma_unpin(void* store, const char* oid) {
  return static_cast<ArenaStore*>(store)->Unpin(oid);
}

int plasma_contains(void* store, const char* oid) {
  return static_cast<ArenaStore*>(store)->Contains(oid);
}

int plasma_mark_secondary(void* store, const char* oid) {
  return static_cast<ArenaStore*>(store)->MarkSecondary(oid);
}

int plasma_free(void* store, const char* oid) {
  return static_cast<ArenaStore*>(store)->Free(oid);
}

int plasma_evict(void* store, uint64_t need, int evict_primaries, char* out_buf,
                 uint64_t buf_len) {
  return static_cast<ArenaStore*>(store)->Evict(need, evict_primaries, out_buf,
                                                buf_len);
}

uint64_t plasma_used(void* store) { return static_cast<ArenaStore*>(store)->Used(); }

uint64_t plasma_capacity(void* store) {
  return static_cast<ArenaStore*>(store)->Capacity();
}

uint64_t plasma_num_objects(void* store) {
  return static_cast<ArenaStore*>(store)->NumObjects();
}

// raylet-process direct access (spill/restore IO without re-attaching)
void* plasma_base(void* store) { return static_cast<ArenaStore*>(store)->Base(); }

}  // extern "C"
