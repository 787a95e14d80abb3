// Shared-memory arena object store (plasma-equivalent, TPU build).
//
// Reference parity: src/ray/object_manager/plasma/{store.h,
// plasma_allocator.h, eviction_policy.h, dlmalloc.cc} — a per-machine
// shared-memory arena in which sealed immutable objects live, mapped
// zero-copy by every worker process. This implementation: one POSIX shm
// segment holding [Header | object hash table | heap]; a boundary-walk
// first-fit allocator with adjacent-free coalescing; a robust
// process-shared mutex; per-object refcounts + LRU ticks with an explicit
// eviction entry point (policy stays in the host runtime, as plasma's
// EvictionPolicy is a separate layer).
//
// Build: g++ -O2 -shared -fPIC -pthread (see src/Makefile). Exposed via
// ctypes from ray_tpu/_native/arena.py.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// "RTPUAREB": bumped from ...AREA when the counter fields widened the
// header — an old-layout segment must fail the magic check, not lock
// garbage at the moved mutex offset.
constexpr uint64_t kMagic = 0x52545055'41524542ULL;
constexpr uint32_t kIdLen = 32;                      // hex object id
constexpr uint64_t kAlign = 64;

enum SlotState : uint32_t { kEmpty = 0, kUsed = 1, kTombstone = 2 };

struct Slot {
  char id[kIdLen];
  uint32_t state;
  uint32_t sealed;
  uint32_t pending_delete;  // deleted while readers pinned it
  uint32_t pad_;
  uint64_t offset;   // data offset from segment base
  uint64_t size;
  int64_t refcount;
  uint64_t lru_tick;
};

struct BlockHeader {
  uint64_t size;     // total block size including this header
  uint64_t free;     // 1 = free
};

struct Header {
  uint64_t magic;
  uint64_t total_size;
  uint64_t table_capacity;
  uint64_t table_offset;
  uint64_t heap_offset;
  uint64_t heap_size;
  uint64_t bytes_allocated;
  uint64_t num_objects;
  uint64_t lru_clock;
  // native operation counters (reference parity role: the C++ stats
  // registry, src/ray/stats/metric_defs.h — these flow up through the
  // daemon's gossip into the /metrics node gauges)
  uint64_t n_allocs;
  uint64_t n_alloc_fails;
  uint64_t n_frees;
  uint64_t n_coalesces;
  uint64_t n_sweeps;
  pthread_mutex_t lock;
};

struct Handle {
  void* base;
  uint64_t size;
  Header* header;
  Slot* table;
  char name[256];
};

BlockHeader* block_at(Handle* h, uint64_t off);
void recover_sweep(Handle* h);

class Locker {
 public:
  explicit Locker(Handle* h) : h_(h->header) {
    int rc = pthread_mutex_lock(&h_->lock);
    if (rc == EOWNERDEAD) {
      // A process died holding the lock — it may have died mid-mutation
      // (e.g. between heap_alloc and the slot fill, or between heap_free
      // and the slot-state update). Sweep the table/heap back to a
      // consistent state, then mark the mutex consistent.
      recover_sweep(h);
      pthread_mutex_consistent(&h_->lock);
    }
  }
  ~Locker() { pthread_mutex_unlock(&h_->lock); }

 private:
  Header* h_;
};

uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) / a * a; }

uint64_t hash_id(const char* id) {
  // FNV-1a over the 32-byte id
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdLen; i++) {
    h ^= static_cast<unsigned char>(id[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

Slot* find_slot(Handle* h, const char* id, bool for_insert) {
  uint64_t cap = h->header->table_capacity;
  uint64_t idx = hash_id(id) % cap;
  Slot* first_tomb = nullptr;
  for (uint64_t probe = 0; probe < cap; probe++) {
    Slot* s = &h->table[(idx + probe) % cap];
    if (s->state == kUsed && memcmp(s->id, id, kIdLen) == 0) return s;
    if (s->state == kTombstone && for_insert && !first_tomb) first_tomb = s;
    if (s->state == kEmpty) return for_insert
        ? (first_tomb ? first_tomb : s) : nullptr;
  }
  return for_insert ? first_tomb : nullptr;
}

BlockHeader* block_at(Handle* h, uint64_t off) {
  return reinterpret_cast<BlockHeader*>(
      static_cast<char*>(h->base) + off);
}

// Restore table/heap invariants after a process died holding the lock.
// Three partial-mutation windows are repaired: (1) a kUsed slot whose
// block was already freed (death between heap_free and the slot-state
// write) -> tombstone the slot; (2) an allocated block no kUsed slot
// references (death between heap_alloc and the slot fill) -> free the
// block; (3) recompute bytes_allocated / num_objects from scratch.
void recover_sweep(Handle* h) {
  Header* hd = h->header;
  hd->n_sweeps++;
  uint64_t cap = hd->table_capacity;
  uint64_t heap_end = hd->heap_offset + hd->heap_size;

  for (uint64_t i = 0; i < cap; i++) {
    Slot* s = &h->table[i];
    if (s->state != kUsed) continue;
    if (s->offset < hd->heap_offset + sizeof(BlockHeader) ||
        s->offset >= heap_end) {
      s->state = kTombstone;
      continue;
    }
    if (block_at(h, s->offset - sizeof(BlockHeader))->free)
      s->state = kTombstone;
  }

  uint64_t off = hd->heap_offset;
  uint64_t allocated = 0;
  while (off < heap_end) {
    BlockHeader* b = block_at(h, off);
    if (b->size < sizeof(BlockHeader) || b->size % kAlign != 0 ||
        off + b->size > heap_end)
      break;  // chain corrupted beyond repair; leave the tail alone
    if (!b->free) {
      uint64_t data = off + sizeof(BlockHeader);
      bool referenced = false;
      for (uint64_t i = 0; i < cap && !referenced; i++) {
        Slot* s = &h->table[i];
        if (s->state == kUsed && s->offset == data) referenced = true;
      }
      if (referenced) allocated += b->size;
      else b->free = 1;
    }
    off += b->size;
  }
  hd->bytes_allocated = allocated;

  uint64_t n = 0;
  for (uint64_t i = 0; i < cap; i++)
    if (h->table[i].state == kUsed) n++;
  hd->num_objects = n;
}

// First-fit scan with inline coalescing of adjacent free blocks.
int64_t heap_alloc(Handle* h, uint64_t need) {
  Header* hd = h->header;
  uint64_t total = align_up(need + sizeof(BlockHeader), kAlign);
  uint64_t off = hd->heap_offset;
  uint64_t end = hd->heap_offset + hd->heap_size;
  while (off < end) {
    BlockHeader* b = block_at(h, off);
    if (b->free) {
      // coalesce forward while the next block is free
      while (off + b->size < end) {
        BlockHeader* nxt = block_at(h, off + b->size);
        if (!nxt->free) break;
        b->size += nxt->size;
        hd->n_coalesces++;
      }
      if (b->size >= total) {
        uint64_t remainder = b->size - total;
        if (remainder >= kAlign + sizeof(BlockHeader)) {
          // write the remainder header BEFORE shrinking this block: a
          // death between the two writes must leave a walkable chain
          // (recover_sweep trusts block headers), never an uninitialized
          // header at off+total
          BlockHeader* rest = block_at(h, off + total);
          rest->size = remainder;
          rest->free = 1;
          b->size = total;
        }
        b->free = 0;
        hd->bytes_allocated += b->size;
        hd->n_allocs++;
        return static_cast<int64_t>(off + sizeof(BlockHeader));
      }
    }
    off += b->size;
  }
  hd->n_alloc_fails++;
  return -1;
}

void heap_free(Handle* h, uint64_t data_off) {
  BlockHeader* b = block_at(h, data_off - sizeof(BlockHeader));
  if (!b->free) {
    h->header->bytes_allocated -= b->size;
    h->header->n_frees++;
    b->free = 1;
  }
}

Handle* map_segment(const char* name, uint64_t size, bool create) {
  int flags = create ? (O_CREAT | O_EXCL | O_RDWR) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  if (create && ftruncate(fd, static_cast<off_t>(size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  if (!create) {
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
    size = static_cast<uint64_t>(st.st_size);
  }
  void* base = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED,
                    fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  Handle* h = new Handle();
  h->base = base;
  h->size = size;
  h->header = static_cast<Header*>(base);
  snprintf(h->name, sizeof(h->name), "%s", name);
  return h;
}

}  // namespace

extern "C" {

// Create a new arena of `size` bytes with a table for `capacity` objects.
// Returns an opaque handle or null.
void* arena_create(const char* name, uint64_t size, uint64_t capacity) {
  // reject segments too small to hold header + table + a minimal heap
  uint64_t table_off = align_up(sizeof(Header), kAlign);
  uint64_t table_bytes = align_up(capacity * sizeof(Slot), kAlign);
  if (table_off + table_bytes + 2 * kAlign + sizeof(BlockHeader) > size) {
    return nullptr;
  }
  Handle* h = map_segment(name, size, /*create=*/true);
  if (!h) return nullptr;
  Header* hd = h->header;
  memset(hd, 0, sizeof(Header));
  hd->total_size = size;
  hd->table_capacity = capacity;
  hd->table_offset = table_off;
  hd->heap_offset = hd->table_offset + table_bytes;
  hd->heap_size = size - hd->heap_offset;
  h->table = reinterpret_cast<Slot*>(
      static_cast<char*>(h->base) + hd->table_offset);
  memset(h->table, 0, capacity * sizeof(Slot));
  BlockHeader* first = block_at(h, hd->heap_offset);
  first->size = hd->heap_size;
  first->free = 1;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hd->lock, &attr);
  pthread_mutexattr_destroy(&attr);
  hd->magic = kMagic;   // last: attachers spin on magic
  return h;
}

void* arena_attach(const char* name) {
  Handle* h = map_segment(name, 0, /*create=*/false);
  if (!h) return nullptr;
  if (h->header->magic != kMagic) {
    munmap(h->base, h->size);
    delete h;
    return nullptr;
  }
  h->table = reinterpret_cast<Slot*>(
      static_cast<char*>(h->base) + h->header->table_offset);
  return h;
}

// Allocate space for an object. Returns data offset, or -1 (full /
// duplicate id / table full).
int64_t arena_alloc(void* handle, const char* id, uint64_t size) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* existing = find_slot(h, id, false);
  if (existing) return -1;
  Slot* s = find_slot(h, id, true);
  if (!s) return -1;
  int64_t off = heap_alloc(h, size);
  if (off < 0) return -1;
  memcpy(s->id, id, kIdLen);
  s->sealed = 0;
  s->pending_delete = 0;
  s->offset = static_cast<uint64_t>(off);
  s->size = size;
  s->refcount = 0;
  s->lru_tick = ++h->header->lru_clock;
  s->state = kUsed;  // last: recover_sweep keys referencedness on kUsed
  h->header->num_objects++;
  return off;
}

int arena_seal(void* handle, const char* id) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* s = find_slot(h, id, false);
  if (!s) return -1;
  s->sealed = 1;
  return 0;
}

// Look up a sealed object; bumps refcount + LRU. Returns 0 and fills
// offset/size, or -1.
int arena_get(void* handle, const char* id, uint64_t* offset,
              uint64_t* size) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* s = find_slot(h, id, false);
  if (!s || !s->sealed || s->pending_delete) return -1;
  s->refcount++;
  s->lru_tick = ++h->header->lru_clock;
  *offset = s->offset;
  *size = s->size;
  return 0;
}

int arena_release(void* handle, const char* id) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* s = find_slot(h, id, false);
  if (!s) return -1;
  if (s->refcount > 0) s->refcount--;
  if (s->refcount == 0 && s->pending_delete) {
    // deferred delete: last pinned reader gone, reclaim now
    // (tombstone first so a death mid-sequence leaves an unreferenced
    // allocated block, which recover_sweep reclaims)
    s->state = kTombstone;
    heap_free(h, s->offset);
    h->header->num_objects--;
  }
  return 0;
}

// Delete an object. If readers still pin it (zero-copy numpy views into
// the block), defer the heap free until the last release — freeing under
// a pinned reader would let the next allocation overwrite live data.
int arena_delete(void* handle, const char* id) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* s = find_slot(h, id, false);
  if (!s) return -1;
  if (s->refcount > 0) {
    s->pending_delete = 1;   // invisible to new gets; freed on release
    return 0;
  }
  s->state = kTombstone;
  heap_free(h, s->offset);
  h->header->num_objects--;
  return 0;
}

// Evict up to `needed` bytes of LRU refcount-0 sealed objects. Returns
// bytes reclaimed. Fills out_ids (kIdLen bytes each, up to max_ids) with
// the evicted ids so the caller can invalidate its directory.
uint64_t arena_evict(void* handle, uint64_t needed, char* out_ids,
                     uint64_t max_ids, uint64_t* num_evicted) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  uint64_t reclaimed = 0, count = 0;
  while (reclaimed < needed) {
    Slot* victim = nullptr;
    uint64_t cap = h->header->table_capacity;
    for (uint64_t i = 0; i < cap; i++) {
      Slot* s = &h->table[i];
      if (s->state == kUsed && s->sealed && s->refcount == 0) {
        if (!victim || s->lru_tick < victim->lru_tick) victim = s;
      }
    }
    if (!victim) break;
    if (out_ids && count < max_ids)
      memcpy(out_ids + count * kIdLen, victim->id, kIdLen);
    count++;
    reclaimed += victim->size;
    victim->state = kTombstone;
    heap_free(h, victim->offset);
    h->header->num_objects--;
  }
  if (num_evicted) *num_evicted = count;
  return reclaimed;
}

int arena_contains(void* handle, const char* id) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* s = find_slot(h, id, false);
  return (s && s->sealed) ? 1 : 0;
}

void arena_stats(void* handle, uint64_t* allocated, uint64_t* capacity,
                 uint64_t* num_objects) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  *allocated = h->header->bytes_allocated;
  *capacity = h->header->heap_size;
  *num_objects = h->header->num_objects;
}

// Extended native counters: out must hold 8 uint64s —
// {allocated, capacity, num_objects, allocs, alloc_fails, frees,
//  coalesces, sweeps}.
void arena_stats_ext(void* handle, uint64_t* out) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Header* hd = h->header;
  out[0] = hd->bytes_allocated;
  out[1] = hd->heap_size;
  out[2] = hd->num_objects;
  out[3] = hd->n_allocs;
  out[4] = hd->n_alloc_fails;
  out[5] = hd->n_frees;
  out[6] = hd->n_coalesces;
  out[7] = hd->n_sweeps;
}

void* arena_base(void* handle) {
  return static_cast<Handle*>(handle)->base;
}

void arena_detach(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  munmap(h->base, h->size);
  delete h;
}

int arena_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
