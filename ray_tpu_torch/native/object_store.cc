// Shared-memory arena object store (plasma equivalent).
//
// Design parity: the reference's plasma store (src/ray/object_manager/plasma/,
// store.h:55) — mmap arena + allocator, sealed-object semantics, pinned reads,
// deferred free. Differences by design: instead of a store *server* process
// with a unix-socket protocol and fd-passing (plasma.fbs, fling), the arena
// itself is the shared medium: one mmap'd file in /dev/shm whose header holds
// a process-shared robust mutex and an open-addressing object table. Every
// client (driver or worker) maps the same file; create/seal/get are O(1)
// table operations under the lock; reads are zero-copy slices of the mapping.
//
// Layout:  [Header | Entry[table_size] | data region]
// Allocation: first-fit over a block list threaded through the data region
// (block headers precede payloads), with coalescing on free.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Layout version tag: v2 added Header::prefault_cursor, which moved the
// shared pthread mutex — a v1 build locking a v2 arena (or vice versa)
// would "lock" the wrong bytes and race the allocator, so mixed builds
// must refuse to share an arena instead of silently corrupting it.
constexpr uint64_t kMagic = 0x5241595F54505632ULL;  // "RAY_TPV2"
constexpr uint32_t kIdSize = 28;

enum EntryState : uint32_t {
  kEmpty = 0,
  kCreating = 1,
  kSealed = 2,
  kTombstone = 3,
};

struct Entry {
  uint8_t id[kIdSize];
  uint32_t state;
  uint64_t offset;  // payload offset from arena base
  uint64_t size;    // payload size
  uint32_t pins;    // active reader pins
  uint32_t pending_delete;
  int32_t owner_pid;  // creator while kCreating (orphan reclaim)
  uint32_t pad_;
  uint64_t last_access;  // LRU clock value at last seal/get
};

// free/used block header threaded through the data region
struct Block {
  uint64_t size;      // payload capacity of this block
  uint64_t next_off;  // next free block offset (0 = none); valid when free
  uint32_t free_;
  uint32_t pad_;
};

struct Header {
  uint64_t magic;
  uint64_t capacity;       // total file size
  uint64_t data_off;       // start of data region
  uint64_t table_size;     // number of Entry slots
  uint64_t free_head;      // offset of first free block (0 = none)
  uint64_t used_bytes;     // payload bytes in sealed/creating objects
  uint64_t num_objects;
  uint64_t access_clock;   // monotonically increasing LRU clock
  uint64_t prefault_cursor;  // data-region high-water mark of prefaulted pages
  pthread_mutex_t mutex;
};

struct Store {
  uint8_t* base;
  Header* hdr;
  Entry* table;
  uint64_t mapped_size;
};

inline uint64_t align8(uint64_t v) { return (v + 7) & ~7ULL; }

inline uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 28-byte id
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

class LockGuard {
 public:
  explicit LockGuard(pthread_mutex_t* m) : m_(m) {
    int rc = pthread_mutex_lock(m_);
    if (rc == EOWNERDEAD) {
      // a client died holding the lock; state is still consistent enough for
      // our operations (all mutations are a few stores) — make it usable
      pthread_mutex_consistent(m_);
    }
  }
  ~LockGuard() { pthread_mutex_unlock(m_); }

 private:
  pthread_mutex_t* m_;
};

Entry* find_slot(Store* s, const uint8_t* id, bool for_insert) {
  const uint64_t n = s->hdr->table_size;
  uint64_t idx = hash_id(id) % n;
  Entry* first_tomb = nullptr;
  for (uint64_t probe = 0; probe < n; probe++) {
    Entry* e = &s->table[(idx + probe) % n];
    if (e->state == kEmpty) {
      if (for_insert) return first_tomb ? first_tomb : e;
      return nullptr;
    }
    if (e->state == kTombstone) {
      if (for_insert && !first_tomb) first_tomb = e;
      continue;
    }
    if (memcmp(e->id, id, kIdSize) == 0) return e;
  }
  return for_insert ? first_tomb : nullptr;
}

Block* block_at(Store* s, uint64_t off) {
  return reinterpret_cast<Block*>(s->base + off);
}

// allocate a payload of `size`; returns payload offset or 0
uint64_t alloc_block(Store* s, uint64_t size) {
  size = align8(size ? size : 8);
  uint64_t prev_off = 0;
  uint64_t off = s->hdr->free_head;
  while (off) {
    Block* b = block_at(s, off);
    if (b->size >= size) {
      uint64_t remain = b->size - size;
      if (remain > sizeof(Block) + 64) {
        // split: tail becomes a new free block
        uint64_t tail_off = off + sizeof(Block) + size;
        Block* tail = block_at(s, tail_off);
        tail->size = remain - sizeof(Block);
        tail->free_ = 1;
        tail->next_off = b->next_off;
        b->size = size;
        if (prev_off) {
          block_at(s, prev_off)->next_off = tail_off;
        } else {
          s->hdr->free_head = tail_off;
        }
      } else {
        if (prev_off) {
          block_at(s, prev_off)->next_off = b->next_off;
        } else {
          s->hdr->free_head = b->next_off;
        }
      }
      b->free_ = 0;
      b->next_off = 0;
      return off + sizeof(Block);
    }
    prev_off = off;
    off = b->next_off;
  }
  return 0;
}

void free_block(Store* s, uint64_t payload_off) {
  uint64_t off = payload_off - sizeof(Block);
  Block* b = block_at(s, off);
  b->free_ = 1;
  // address-ordered insert with coalescing of physically-adjacent neighbors
  uint64_t prev = 0;
  uint64_t cur = s->hdr->free_head;
  while (cur && cur < off) {
    prev = cur;
    cur = block_at(s, cur)->next_off;
  }
  // merge with next?
  if (cur && off + sizeof(Block) + b->size == cur) {
    Block* nb = block_at(s, cur);
    b->size += sizeof(Block) + nb->size;
    b->next_off = nb->next_off;
  } else {
    b->next_off = cur;
  }
  // merge with prev?
  if (prev) {
    Block* pb = block_at(s, prev);
    if (prev + sizeof(Block) + pb->size == off) {
      pb->size += sizeof(Block) + b->size;
      pb->next_off = b->next_off;
      return;
    }
    pb->next_off = off;
  } else {
    s->hdr->free_head = off;
  }
}

bool pid_alive(int32_t pid) {
  if (pid <= 0) return false;
  return kill(pid, 0) == 0 || errno == EPERM;
}

void do_delete(Store* s, Entry* e) {
  free_block(s, e->offset);
  s->hdr->used_bytes -= e->size;
  s->hdr->num_objects -= 1;
  e->state = kTombstone;
}

}  // namespace

extern "C" {

// returns an opaque handle (heap pointer) or null
void* rt_store_open(const char* path, uint64_t capacity, uint64_t table_size,
                    int create) {
  int fd = open(path, create ? (O_RDWR | O_CREAT) : O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t header_bytes = align8(sizeof(Header));
  uint64_t table_bytes = align8(sizeof(Entry) * table_size);
  bool init = false;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  if (st.st_size == 0) {
    if (!create) {
      close(fd);
      return nullptr;
    }
    if (ftruncate(fd, capacity) != 0) {
      close(fd);
      return nullptr;
    }
    init = true;
  } else {
    capacity = st.st_size;
  }
  void* mem =
      mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  // allocation-time buffer prep: huge pages shrink TLB pressure on the
  // multi-MiB copies this mapping exists for; WILLNEED primes already-
  // allocated pages. Both are advice — unsupported kernels just say no.
#ifdef MADV_WILLNEED
  madvise(mem, capacity, MADV_WILLNEED);
#endif
  Store* s = new Store();
  s->base = static_cast<uint8_t*>(mem);
  s->hdr = reinterpret_cast<Header*>(s->base);
  s->mapped_size = capacity;
  if (init) {
    memset(s->base, 0, header_bytes + table_bytes);
    s->hdr->capacity = capacity;
    s->hdr->data_off = header_bytes + table_bytes;
    s->hdr->table_size = table_size;
    s->hdr->used_bytes = 0;
    s->hdr->num_objects = 0;
    s->hdr->prefault_cursor = s->hdr->data_off;
    // one big free block spanning the data region
    uint64_t first = s->hdr->data_off;
    Block* b = reinterpret_cast<Block*>(s->base + first);
    b->size = capacity - first - sizeof(Block);
    b->free_ = 1;
    b->next_off = 0;
    s->hdr->free_head = first;
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&s->hdr->mutex, &attr);
    pthread_mutexattr_destroy(&attr);
    __atomic_store_n(&s->hdr->magic, kMagic, __ATOMIC_RELEASE);
  } else {
    // wait for the creator to finish initializing; a foreign NONZERO magic
    // is a different layout version (or not our file) — fail fast instead
    // of spinning out the whole init window
    for (int i = 0; i < 100000; i++) {
      uint64_t m = __atomic_load_n(&s->hdr->magic, __ATOMIC_ACQUIRE);
      if (m == kMagic || m != 0) break;
      usleep(100);
    }
    if (s->hdr->magic != kMagic) {
      munmap(mem, capacity);
      delete s;
      return nullptr;
    }
  }
  s->table = reinterpret_cast<Entry*>(s->base + header_bytes);
  return s;
}

void rt_store_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  if (!s) return;
  munmap(s->base, s->mapped_size);
  delete s;
}

// create an object; returns payload offset (>0) or 0 on failure.
// rc semantics via errno-style out param: 1 = exists, 2 = full
uint64_t rt_store_create(void* handle, const uint8_t* id, uint64_t size,
                         int* err) {
  Store* s = static_cast<Store*>(handle);
  LockGuard g(&s->hdr->mutex);
  Entry* existing = find_slot(s, id, false);
  if (existing && existing->state == kCreating &&
      !pid_alive(existing->owner_pid)) {
    // creator died between create and seal: reclaim the orphan so retries of
    // the same deterministic object id can proceed (plasma does this via
    // per-client disconnect cleanup)
    do_delete(s, existing);
    existing = nullptr;
  }
  if (existing && existing->state != kTombstone) {
    *err = 1;
    return 0;
  }
  uint64_t off = alloc_block(s, size);
  if (!off) {
    *err = 2;
    return 0;
  }
  Entry* e = find_slot(s, id, true);
  if (!e) {  // table full
    free_block(s, off);
    *err = 2;
    return 0;
  }
  memcpy(e->id, id, kIdSize);
  e->state = kCreating;
  e->offset = off;
  e->size = size;
  e->pins = 0;
  e->pending_delete = 0;
  e->owner_pid = static_cast<int32_t>(getpid());
  s->hdr->used_bytes += size;
  s->hdr->num_objects += 1;
  *err = 0;
  return off;
}

int rt_store_seal(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  LockGuard g(&s->hdr->mutex);
  Entry* e = find_slot(s, id, false);
  if (!e || e->state != kCreating) return -1;
  e->state = kSealed;
  e->last_access = ++s->hdr->access_clock;
  return 0;
}

// get+pin: returns payload offset or 0 if not sealed/absent; fills size
uint64_t rt_store_get(void* handle, const uint8_t* id, uint64_t* size) {
  Store* s = static_cast<Store*>(handle);
  LockGuard g(&s->hdr->mutex);
  Entry* e = find_slot(s, id, false);
  if (!e || e->state != kSealed) return 0;
  e->pins += 1;
  e->last_access = ++s->hdr->access_clock;
  *size = e->size;
  return e->offset;
}

int rt_store_contains(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  LockGuard g(&s->hdr->mutex);
  Entry* e = find_slot(s, id, false);
  return (e && e->state == kSealed) ? 1 : 0;
}

// unpin a previously gotten object; performs deferred delete at pin==0
int rt_store_release(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  LockGuard g(&s->hdr->mutex);
  Entry* e = find_slot(s, id, false);
  if (!e || (e->state != kSealed && e->state != kCreating)) return -1;
  if (e->pins > 0) e->pins -= 1;
  if (e->pins == 0 && e->pending_delete) do_delete(s, e);
  return 0;
}

// creator-only abort of an unsealed object (plasma Abort): the one legal way
// to free a kCreating block, because only the creator knows no fill is in
// flight
int rt_store_abort(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  LockGuard g(&s->hdr->mutex);
  Entry* e = find_slot(s, id, false);
  if (!e || e->state != kCreating) return -1;
  if (e->owner_pid != static_cast<int32_t>(getpid())) return -1;
  do_delete(s, e);
  return 0;
}

int rt_store_delete(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  LockGuard g(&s->hdr->mutex);
  Entry* e = find_slot(s, id, false);
  if (!e || e->state == kTombstone || e->state == kEmpty) return -1;
  if (e->state == kCreating && pid_alive(e->owner_pid)) {
    // an unsealed object is deletable only once its creator has died (the
    // orphan-reclaim path); freeing the block while the creator is alive
    // would race its in-progress payload write
    return -1;
  }
  if (e->pins > 0) {
    e->pending_delete = 1;  // deferred until readers release
    return 0;
  }
  do_delete(s, e);
  return 0;
}

uint64_t rt_store_used_bytes(void* handle) {
  Store* s = static_cast<Store*>(handle);
  LockGuard g(&s->hdr->mutex);
  return s->hdr->used_bytes;
}

uint64_t rt_store_num_objects(void* handle) {
  Store* s = static_cast<Store*>(handle);
  LockGuard g(&s->hdr->mutex);
  return s->hdr->num_objects;
}

// base address of the mapping in THIS process (for python-side slicing)
void* rt_store_base(void* handle) {
  return static_cast<Store*>(handle)->base;
}

uint64_t rt_store_capacity(void* handle) {
  return static_cast<Store*>(handle)->hdr->capacity;
}

// Prefault up to max_bytes of not-yet-touched FREE arena space so later
// large-object copies write into resident pages instead of serializing
// first-touch faults inside the copy loop. Only free-block payloads are
// written (zeroed) — always safe under the lock — and a shared high-water
// cursor in the header makes the walk incremental and once-per-arena:
// pages below the cursor were either prefaulted here or touched by a real
// object write, and tmpfs pages stay resident for the file's lifetime once
// allocated. Returns bytes touched; 0 = nothing left to do. Callers hold
// the budget loop (one slab per call keeps lock holds bounded).
uint64_t rt_store_prefault(void* handle, uint64_t max_bytes) {
  Store* s = static_cast<Store*>(handle);
  LockGuard g(&s->hdr->mutex);
  uint64_t cursor = s->hdr->prefault_cursor;
  if (cursor < s->hdr->data_off) cursor = s->hdr->data_off;  // older arena
  uint64_t touched = 0;
  uint64_t off = s->hdr->free_head;
  while (off && touched < max_bytes) {
    Block* b = block_at(s, off);
    uint64_t lo = off + sizeof(Block);
    uint64_t hi = lo + b->size;
    if (hi > cursor) {
      uint64_t from = lo > cursor ? lo : cursor;
      uint64_t n = hi - from;
      if (n > max_bytes - touched) n = max_bytes - touched;
      memset(s->base + from, 0, n);
      touched += n;
      if (from + n > cursor) cursor = from + n;
    }
    off = b->next_off;
  }
  s->hdr->prefault_cursor = cursor;
  return touched;
}

// LRU eviction candidate (parity: plasma EvictionPolicy choosing sealed,
// unpinned objects; eviction_policy.h): fills out_id and returns 1, or
// returns 0 when nothing is evictable. The caller spills the object's bytes
// to secondary storage and then deletes it.
int rt_store_lru_victim(void* handle, uint8_t* out_id) {
  Store* s = static_cast<Store*>(handle);
  LockGuard g(&s->hdr->mutex);
  Entry* victim = nullptr;
  for (uint64_t i = 0; i < s->hdr->table_size; i++) {
    Entry* c = &s->table[i];
    if (c->state == kSealed && c->pins == 0 && !c->pending_delete) {
      if (!victim || c->last_access < victim->last_access) victim = c;
    }
  }
  if (!victim) return 0;
  memcpy(out_id, victim->id, kIdSize);
  return 1;
}

}  // extern "C"
