// Shared-memory host object store (the port's copy of
// ray_tpu/native/src/shm_store.cc: the same layout, so a store file made by
// either library is read by the other).
//
// Counterpart of the reference Plasma store (src/ray/object_manager/plasma/:
// ObjectStore object_store.h:74, EvictionPolicy/LRUCache eviction_policy.h:105,
// dlmalloc slabs), re-designed: one mmap'd file (tmpfs) holding a
// boundary-tag free-list allocator, an open-addressing object table and
// an LRU list, ALL inside the mapping, guarded by one process-shared
// mutex, so any process that maps the file gets zero-copy reads of
// sealed objects with no broker daemon in the data path (the reference
// brokers create/seal over a unix socket; in-process C calls here).
//
// Host C++, not a kernel: built with g++ at first use by
// ray_tpu_torch/native/shm.py and exposed as a C ABI for ctypes.

#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <fcntl.h>
#include <unistd.h>

#include <atomic>
#include <new>
#include <errno.h>

namespace {

constexpr uint64_t kMagic = 0x5261795450755354ULL;  // "RayTPuST"
constexpr uint32_t kTableSlots = 1 << 16;           // object table capacity
constexpr uint64_t kAlign = 64;                     // cacheline alignment

struct ObjectEntry {
  uint8_t id[16];       // object id (all-zero = empty slot)
  uint64_t offset;      // data offset from region start
  uint64_t size;        // requested bytes (what the client sees)
  uint64_t alloc_size;  // bytes actually taken from the free list
  int32_t refcount;
  uint8_t sealed;
  uint8_t used;         // slot occupied (distinguishes tombstones)
  uint16_t _pad;
  uint64_t lru_tick;    // last zero-ref touch (for LRU eviction)
};

// free block header, kept inside the data region
struct FreeBlock {
  uint64_t size;        // includes header
  uint64_t next;        // offset of next free block (0 = none)
};

struct Header {
  uint64_t magic;
  uint64_t capacity;       // data region bytes
  uint64_t data_start;     // offset of data region from mapping base
  uint64_t free_head;      // offset of first free block (0 = none)
  uint64_t used_bytes;
  uint64_t num_objects;
  uint64_t lru_clock;
  uint64_t num_evictions;
  uint64_t max_probe;      // longest insert displacement (bounds miss scans)
  uint64_t failed;         // set when post-crash validation finds corruption
  pthread_mutex_t mutex;   // process-shared
  ObjectEntry table[kTableSlots];
};

struct Store {
  Header* hdr;
  uint8_t* base;
  uint64_t map_size;
  int fd;
};

uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

uint32_t slot_hash(const uint8_t* id) {
  uint64_t h = 1469598103934665603ULL;
  for (int i = 0; i < 16; i++) { h ^= id[i]; h *= 1099511628211ULL; }
  return (uint32_t)(h & (kTableSlots - 1));
}

bool id_zero(const uint8_t* id) {
  for (int i = 0; i < 16; i++) if (id[i]) return false;
  return true;
}

ObjectEntry* find_entry(Header* h, const uint8_t* id) {
  uint32_t s = slot_hash(id);
  // probes bounded by the longest displacement any insert ever needed, so
  // delete tombstones cannot degrade misses into full-table scans
  for (uint32_t i = 0; i <= h->max_probe && i < kTableSlots; i++) {
    ObjectEntry* e = &h->table[(s + i) & (kTableSlots - 1)];
    if (!e->used && id_zero(e->id)) return nullptr;  // never-used slot: stop
    if (e->used && memcmp(e->id, id, 16) == 0) return e;
  }
  return nullptr;
}

ObjectEntry* find_free_slot(Header* h, const uint8_t* id) {
  uint32_t s = slot_hash(id);
  for (uint32_t i = 0; i < kTableSlots; i++) {
    ObjectEntry* e = &h->table[(s + i) & (kTableSlots - 1)];
    if (!e->used) {
      if (i > h->max_probe) h->max_probe = i;
      return e;
    }
  }
  return nullptr;  // table full
}

// -- allocator: first-fit free list with coalescing -------------------------

uint64_t alloc_bytes(Header* h, uint8_t* base, uint64_t want, uint64_t* got) {
  want = align_up(want, kAlign);
  uint64_t prev_off = 0;
  uint64_t cur = h->free_head;
  while (cur) {
    FreeBlock* fb = (FreeBlock*)(base + cur);
    if (fb->size >= want) {  // exact fit allowed
      uint64_t remain = fb->size - want;
      if (remain >= sizeof(FreeBlock) + kAlign) {
        // split: allocate from the front, shrink the free block
        uint64_t new_off = cur + want;
        FreeBlock* nb = (FreeBlock*)(base + new_off);
        nb->size = remain;
        nb->next = fb->next;
        if (prev_off) ((FreeBlock*)(base + prev_off))->next = new_off;
        else h->free_head = new_off;
        h->used_bytes += want;
        *got = want;
        return cur;
      }
      // take whole block
      if (prev_off) ((FreeBlock*)(base + prev_off))->next = fb->next;
      else h->free_head = fb->next;
      h->used_bytes += fb->size;
      *got = fb->size;  // whole block: caller must free this many bytes
      return cur;
    }
    prev_off = cur;
    cur = fb->next;
  }
  return 0;  // out of memory (offset 0 is the header, never valid for data)
}

void free_bytes(Header* h, uint8_t* base, uint64_t off, uint64_t size) {
  size = align_up(size, kAlign);
  // insert sorted by offset, coalesce with neighbours
  uint64_t prev = 0, cur = h->free_head;
  while (cur && cur < off) { prev = cur; cur = ((FreeBlock*)(base + cur))->next; }
  FreeBlock* nb = (FreeBlock*)(base + off);
  nb->size = size;
  nb->next = cur;
  if (prev) ((FreeBlock*)(base + prev))->next = off;
  else h->free_head = off;
  h->used_bytes -= size;
  // coalesce forward
  if (cur && off + nb->size == cur) {
    FreeBlock* cb = (FreeBlock*)(base + cur);
    nb->size += cb->size;
    nb->next = cb->next;
  }
  // coalesce backward
  if (prev) {
    FreeBlock* pb = (FreeBlock*)(base + prev);
    if (prev + pb->size == off) {
      pb->size += nb->size;
      pb->next = nb->next;
    }
  }
}

// evict LRU sealed zero-ref objects until at least `need` is allocatable
bool evict_for(Header* h, uint8_t* base, uint64_t need) {
  for (;;) {
    uint64_t got = 0;
    uint64_t probe = alloc_bytes(h, base, need, &got);
    if (probe) {
      // give it back; caller re-allocates (keeps one code path)
      free_bytes(h, base, probe, got);
      return true;
    }
    // find LRU victim
    ObjectEntry* victim = nullptr;
    for (uint32_t i = 0; i < kTableSlots; i++) {
      ObjectEntry* e = &h->table[i];
      if (e->used && e->sealed && e->refcount == 0) {
        if (!victim || e->lru_tick < victim->lru_tick) victim = e;
      }
    }
    if (!victim) return false;
    free_bytes(h, base, victim->offset, victim->alloc_size);
    victim->used = 0;
    memset(victim->id, 0xFF, 16);  // tombstone (non-zero keeps probes alive)
    h->num_objects--;
    h->num_evictions++;
  }
}

}  // namespace

extern "C" {

// returns NULL on failure. capacity = data region bytes.
void* shm_store_create(const char* path, uint64_t capacity) {
  uint64_t data_start = align_up(sizeof(Header), kAlign);
  uint64_t map_size = data_start + align_up(capacity, kAlign);
  int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)map_size) != 0) { close(fd); unlink(path); return nullptr; }
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); unlink(path); return nullptr; }
  Header* h = new (mem) Header();
  memset(h->table, 0, sizeof(h->table));
  h->magic = kMagic;
  h->capacity = align_up(capacity, kAlign);
  h->data_start = data_start;
  h->used_bytes = 0;
  h->num_objects = 0;
  h->lru_clock = 1;
  h->num_evictions = 0;
  h->max_probe = 0;
  h->failed = 0;
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mutex, &attr);
  // one big free block
  FreeBlock* fb = (FreeBlock*)((uint8_t*)mem + data_start);
  fb->size = h->capacity;
  fb->next = 0;
  h->free_head = data_start;

  Store* s = new Store{h, (uint8_t*)mem, map_size, fd};
  return s;
}

void* shm_store_open(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); return nullptr; }
  Header* h = (Header*)mem;
  if (h->magic != kMagic) { munmap(mem, (size_t)st.st_size); close(fd); return nullptr; }
  Store* s = new Store{h, (uint8_t*)mem, (uint64_t)st.st_size, fd};
  return s;
}

void shm_store_close(void* store) {
  Store* s = (Store*)store;
  munmap(s->base, s->map_size);
  close(s->fd);
  delete s;
}

// A process died holding the lock, possibly mid-allocate/free. Before
// trusting the header, bound-check the free list and object table and
// recompute the byte accounting; if the structures don't validate, mark
// the store failed so every subsequent op errors instead of operating on
// crossed free-list links / double-allocated ranges.
static bool validate_after_owner_death(Header* h, uint8_t* base) {
  const uint64_t lo = h->data_start;
  const uint64_t hi = h->data_start + h->capacity;
  // gather every claimed interval (free blocks + live objects); any
  // overlap means a range is double-owned (e.g. death inside shm_delete
  // between free_bytes and clearing the entry) — unrecoverable.
  struct Interval { uint64_t off, end; };
  const uint64_t kMaxIvs = kTableSlots + 1024;  // free list is coalesced: short
  Interval* ivs = new (std::nothrow) Interval[kMaxIvs];
  if (!ivs) return false;
  struct IvGuard { Interval* p; ~IvGuard() { delete[] p; } } guard{ivs};
  uint64_t n_iv = 0;
  // free list: in-bounds, aligned, strictly ascending
  uint64_t free_total = 0, prev_end = 0, cur = h->free_head;
  uint64_t max_iters = h->capacity / kAlign + 2;
  while (cur) {
    if (cur < lo || cur >= hi || (cur & (kAlign - 1)) || !max_iters--) return false;
    FreeBlock* fb = (FreeBlock*)(base + cur);
    if (fb->size < kAlign || (fb->size & (kAlign - 1)) || cur + fb->size > hi)
      return false;
    if (cur < prev_end) return false;  // overlap / out of order
    prev_end = cur + fb->size;
    free_total += fb->size;
    if (n_iv < kMaxIvs)
      ivs[n_iv++] = {cur, cur + fb->size};
    else
      return false;  // absurd free-list length: treat as corrupt
    cur = fb->next;
  }
  // object table: entries in-bounds; recompute totals
  uint64_t used_total = 0, n_obj = 0;
  for (uint32_t i = 0; i < kTableSlots; i++) {
    ObjectEntry* e = &h->table[i];
    if (!e->used) continue;
    if (e->offset < lo || e->offset >= hi || e->alloc_size == 0 ||
        (e->alloc_size & (kAlign - 1)) || e->offset + e->alloc_size > hi ||
        e->refcount < 0)
      return false;
    used_total += e->alloc_size;
    n_obj++;
    if (n_iv < kMaxIvs)
      ivs[n_iv++] = {e->offset, e->offset + e->alloc_size};
    else
      return false;
  }
  if (free_total + used_total > h->capacity) return false;
  // sort intervals by offset (insertion sort: list is near-sorted — free
  // blocks arrive ascending) and reject any adjacent overlap
  for (uint64_t i = 1; i < n_iv; i++) {
    Interval key = ivs[i];
    uint64_t j = i;
    while (j > 0 && ivs[j - 1].off > key.off) { ivs[j] = ivs[j - 1]; j--; }
    ivs[j] = key;
  }
  for (uint64_t i = 1; i < n_iv; i++)
    if (ivs[i].off < ivs[i - 1].end) return false;  // double-owned range
  // repair the counters the dead owner may have half-updated
  h->used_bytes = used_total;
  h->num_objects = n_obj;
  return true;
}

static int lock_hdr(Header* h, uint8_t* base) {
  int rc = pthread_mutex_lock(&h->mutex);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mutex);
    if (!validate_after_owner_death(h, base)) h->failed = 1;
    rc = 0;
  }
  if (rc == 0 && h->failed) {
    pthread_mutex_unlock(&h->mutex);
    return EBADFD;
  }
  return rc;
}

// create an unsealed object; returns data offset from mapping base, 0 on
// failure (exists / no space even after eviction / table full).
uint64_t shm_create(void* store, const uint8_t* id, uint64_t size) {
  Store* s = (Store*)store;
  Header* h = s->hdr;
  if (size == 0) size = kAlign;
  if (lock_hdr(h, s->base)) return 0;
  uint64_t out = 0;
  do {
    if (find_entry(h, id)) break;  // already exists
    uint64_t got = 0;
    uint64_t off = alloc_bytes(h, s->base, size, &got);
    if (!off) {
      if (!evict_for(h, s->base, align_up(size, kAlign))) break;
      off = alloc_bytes(h, s->base, size, &got);
      if (!off) break;
    }
    ObjectEntry* e = find_free_slot(h, id);
    if (!e) { free_bytes(h, s->base, off, got); break; }
    memcpy(e->id, id, 16);
    e->offset = off;
    e->size = size;
    e->alloc_size = got;
    e->refcount = 1;  // creator holds a ref until seal+release
    e->sealed = 0;
    e->used = 1;
    e->lru_tick = 0;
    h->num_objects++;
    out = off;
  } while (0);
  pthread_mutex_unlock(&h->mutex);
  return out;
}

int shm_seal(void* store, const uint8_t* id) {
  Store* s = (Store*)store;
  Header* h = s->hdr;
  if (lock_hdr(h, s->base)) return -1;
  ObjectEntry* e = find_entry(h, id);
  int rc = -1;
  if (e && !e->sealed) { e->sealed = 1; rc = 0; }
  pthread_mutex_unlock(&h->mutex);
  return rc;
}

// get a sealed object: returns offset, fills size; takes a reference.
// 0 if missing or unsealed.
uint64_t shm_get(void* store, const uint8_t* id, uint64_t* size_out) {
  Store* s = (Store*)store;
  Header* h = s->hdr;
  if (lock_hdr(h, s->base)) return 0;
  uint64_t off = 0;
  ObjectEntry* e = find_entry(h, id);
  if (e && e->sealed) {
    e->refcount++;
    if (size_out) *size_out = e->size;
    off = e->offset;
  }
  pthread_mutex_unlock(&h->mutex);
  return off;
}

int shm_release(void* store, const uint8_t* id) {
  Store* s = (Store*)store;
  Header* h = s->hdr;
  if (lock_hdr(h, s->base)) return -1;
  int rc = -1;
  ObjectEntry* e = find_entry(h, id);
  if (e && e->refcount > 0) {
    e->refcount--;
    if (e->refcount == 0) e->lru_tick = h->lru_clock++;
    rc = 0;
  }
  pthread_mutex_unlock(&h->mutex);
  return rc;
}

int shm_delete(void* store, const uint8_t* id) {
  Store* s = (Store*)store;
  Header* h = s->hdr;
  if (lock_hdr(h, s->base)) return -1;
  int rc = -1;
  ObjectEntry* e = find_entry(h, id);
  if (e && e->refcount == 0) {
    free_bytes(h, s->base, e->offset, e->alloc_size);
    e->used = 0;
    memset(e->id, 0xFF, 16);
    h->num_objects--;
    rc = 0;
  }
  pthread_mutex_unlock(&h->mutex);
  return rc;
}

// reclaim regardless of refcount: for objects whose referencing process
// died (the reference reclaims plasma refs on client disconnect; with no
// broker the surviving peer must do it explicitly).
int shm_force_delete(void* store, const uint8_t* id) {
  Store* s = (Store*)store;
  Header* h = s->hdr;
  if (lock_hdr(h, s->base)) return -1;
  int rc = -1;
  ObjectEntry* e = find_entry(h, id);
  if (e) {
    free_bytes(h, s->base, e->offset, e->alloc_size);
    e->used = 0;
    memset(e->id, 0xFF, 16);
    h->num_objects--;
    rc = 0;
  }
  pthread_mutex_unlock(&h->mutex);
  return rc;
}

int shm_contains(void* store, const uint8_t* id) {
  Store* s = (Store*)store;
  Header* h = s->hdr;
  if (lock_hdr(h, s->base)) return 0;
  ObjectEntry* e = find_entry(h, id);
  int rc = (e && e->sealed) ? 1 : 0;
  pthread_mutex_unlock(&h->mutex);
  return rc;
}

uint8_t* shm_base(void* store) { return ((Store*)store)->base; }

void shm_stats(void* store, uint64_t* capacity, uint64_t* used,
               uint64_t* num_objects, uint64_t* num_evictions) {
  Store* s = (Store*)store;
  Header* h = s->hdr;
  if (capacity) *capacity = 0;
  if (used) *used = 0;
  if (num_objects) *num_objects = 0;
  if (num_evictions) *num_evictions = 0;
  if (lock_hdr(h, s->base)) return;  // failed store: zeroed outputs
  if (capacity) *capacity = h->capacity;
  if (used) *used = h->used_bytes;
  if (num_objects) *num_objects = h->num_objects;
  if (num_evictions) *num_evictions = h->num_evictions;
  pthread_mutex_unlock(&h->mutex);
}

}  // extern "C"
