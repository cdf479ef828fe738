// Sanitizer stress harness for the shared-memory object store (the port's
// copy of ray_tpu/native/src/shm_stress.cc).
//
// Role counterpart: the reference gates its C++ object-store core under
// ASAN/TSAN CI jobs (src/ray/object_manager tests run under sanitizers).
// This binary exercises the store's C ABI from many threads, each with its
// own handle (the cross-process mapping path), so a build under ASan/UBSan
// or TSan (ray_tpu_torch.native.shm.run_stress) proves the allocator and
// the slot table clean under that sanitizer.
//
//   shm_stress [store path]   (default /dev/shm/ray_tpu_torch_shm_stress)
//
// Exit code 0 = no failure and no sanitizer report (sanitizers abort
// non-zero). The store file is removed at the end.

#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* shm_store_create(const char* path, uint64_t capacity);
void* shm_store_open(const char* path);
void shm_store_close(void* store);
uint64_t shm_create(void* store, const uint8_t* id, uint64_t size);
int shm_seal(void* store, const uint8_t* id);
uint64_t shm_get(void* store, const uint8_t* id, uint64_t* size_out);
int shm_release(void* store, const uint8_t* id);
int shm_delete(void* store, const uint8_t* id);
int shm_contains(void* store, const uint8_t* id);
uint8_t* shm_base(void* store);
void shm_stats(void* store, uint64_t* capacity, uint64_t* used,
               uint64_t* num_objects, uint64_t* num_evictions);
}

static void make_id(uint8_t* id, int tid, int k) {
  std::memset(id, 0, 16);
  std::memcpy(id, &tid, sizeof(tid));
  std::memcpy(id + 4, &k, sizeof(k));
}

int main(int argc, char** argv) {
  const char* path = argc > 1 ? argv[1] : "/dev/shm/ray_tpu_torch_shm_stress";
  ::unlink(path);  // stale file from a previous (aborted) run
  void* store = shm_store_create(path, 64ull << 20);
  if (!store) {
    std::fprintf(stderr, "create failed\n");
    return 2;
  }
  std::atomic<int> failures{0};

  const int kThreads = 8, kIters = 400;
  std::vector<std::thread> threads;
  threads.reserve(kThreads);
  for (int t = 0; t < kThreads; ++t) {
    threads.emplace_back([&, t]() {
      // every thread opens its own handle: cross-process mapping path
      void* h = shm_store_open(path);
      if (!h) { failures++; return; }
      uint8_t* b = shm_base(h);
      uint8_t id[16];
      for (int k = 0; k < kIters; ++k) {
        make_id(id, t, k);
        uint64_t size = 128 + (k % 7) * 512;
        // the C ABI returns offset 0 (the header, never data) on failure
        uint64_t off = shm_create(h, id, size);
        if (off == 0) continue;  // store full: fine, LRU is Python-side
        std::memset(b + off, t, size);
        if (shm_seal(h, id) != 0) { failures++; continue; }
        uint64_t got_size = 0;
        uint64_t goff = shm_get(h, id, &got_size);
        if (goff == 0 || got_size != size) { failures++; continue; }
        if ((b + goff)[size - 1] != (uint8_t)t) failures++;
        shm_release(h, id);
        shm_release(h, id);  // the creator's reference
        if (k % 3 == 0) shm_delete(h, id);
        // read a neighbour thread's recent object (shared-slot contention)
        uint8_t other[16];
        make_id(other, (t + 1) % kThreads, k > 10 ? k - 10 : 0);
        uint64_t osz = 0;
        uint64_t ooff = shm_get(h, other, &osz);
        if (ooff != 0) {
          volatile uint8_t x = (b + ooff)[0];
          (void)x;
          shm_release(h, other);
        }
      }
      shm_store_close(h);
    });
  }
  for (auto& th : threads) th.join();

  uint64_t cap = 0, used = 0, objs = 0, evs = 0;
  shm_stats(store, &cap, &used, &objs, &evs);
  std::printf("stress done: failures=%d used=%llu objects=%llu\n",
              failures.load(), (unsigned long long)used,
              (unsigned long long)objs);
  shm_store_close(store);
  ::unlink(path);
  return failures.load() == 0 ? 0 : 1;
}
