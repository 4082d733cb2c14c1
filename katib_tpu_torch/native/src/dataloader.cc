// Native batch loader: mmap'd fixed-size records, per-epoch deterministic
// shuffle, multi-threaded gather with in-order delivery through a bounded
// slot ring.  The TPU-native analog of the reference trial images' native
// input pipelines (torch DataLoader workers / tf.data) — host-side batch
// assembly overlaps with device compute so the step loop never waits on
// Python to gather a shuffled batch.
//
// C API (ctypes-friendly, see native/dataloader.py):
//   ktl_open(path, record_bytes, n_records, batch, seed, threads, queue_cap,
//            start_epoch)
//   ktl_next(h, out)  -> records copied (always == batch; -1 on error).
//                        The stream is epoch-continuous: consume exactly
//                        ktl_batches_per_epoch(h) batches per epoch.
//   ktl_epoch(h)      -> epoch index of the NEXT batch to be delivered
//   ktl_batches_per_epoch(h)
//   ktl_close(h)
//
// Determinism: epoch e uses a Fisher-Yates permutation seeded with
// splitmix64(seed, e); delivery order equals permutation order regardless
// of worker count, so tests can assert exact batch contents.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// splitmix64: tiny, well-mixed; good enough for shuffling
static inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct Slot {
  std::vector<uint8_t> data;
  uint64_t seq = UINT64_MAX;  // which batch occupies the slot
  bool ready = false;
};

struct Loader {
  // immutable after open
  const uint8_t* base = nullptr;
  size_t map_len = 0;
  uint64_t record_bytes = 0, n_records = 0, batch = 0, seed = 0;
  uint64_t batches_per_epoch = 0;
  uint32_t queue_cap = 0;

  // permutation of the CURRENT producing epoch
  std::vector<uint64_t> perm;
  uint64_t perm_epoch = UINT64_MAX;

  std::mutex mu;
  std::condition_variable cv_workers, cv_consumer;
  std::vector<Slot> slots;
  uint64_t next_produce = 0;  // global batch sequence to claim next
  uint64_t next_consume = 0;  // global batch sequence the consumer wants
  bool stopping = false;
  std::vector<std::thread> workers;

  ~Loader() {
    {
      std::lock_guard<std::mutex> g(mu);
      stopping = true;
    }
    cv_workers.notify_all();
    cv_consumer.notify_all();
    for (auto& t : workers) t.join();
    if (base) munmap(const_cast<uint8_t*>(base), map_len);
  }

  void ensure_perm(uint64_t epoch) {  // caller holds mu
    if (perm_epoch == epoch) return;
    if (perm.size() != n_records) {
      perm.resize(n_records);
    }
    for (uint64_t i = 0; i < n_records; ++i) perm[i] = i;
    uint64_t s = mix64(seed ^ mix64(epoch));
    for (uint64_t i = n_records - 1; i > 0; --i) {
      s = mix64(s);
      uint64_t j = s % (i + 1);
      std::swap(perm[i], perm[j]);
    }
    perm_epoch = epoch;
  }

  void worker() {
    std::unique_lock<std::mutex> lk(mu);
    while (true) {
      // claim the next batch seq whose slot is free for writing
      while (!stopping && next_produce >= next_consume + queue_cap)
        cv_workers.wait(lk);
      if (stopping) return;
      uint64_t seq = next_produce++;
      uint64_t epoch = seq / batches_per_epoch;
      uint64_t b = seq % batches_per_epoch;
      ensure_perm(epoch);  // producers run ahead at most queue_cap batches,
                           // within one epoch boundary handled below
      // copy the indices we need while holding the lock (perm mutates at
      // epoch turnover); the record gather itself runs unlocked.  The slot
      // buffer is pre-sized at open and exclusively ours until `ready`
      // (the claim guard proves its previous occupant was consumed), so
      // gathering straight into it avoids per-batch allocation.
      std::vector<uint64_t> idx(perm.begin() + b * batch,
                                perm.begin() + (b + 1) * batch);
      Slot& slot = slots[seq % queue_cap];
      lk.unlock();

      for (uint64_t r = 0; r < batch; ++r)
        memcpy(slot.data.data() + r * record_bytes, base + idx[r] * record_bytes,
               record_bytes);

      lk.lock();
      slot.seq = seq;
      slot.ready = true;
      cv_consumer.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ktl_open(const char* path, uint64_t record_bytes, uint64_t n_records,
               uint64_t batch, uint64_t seed, uint32_t n_threads,
               uint32_t queue_cap, uint64_t start_epoch) {
  if (record_bytes == 0 || n_records == 0 || batch == 0 || batch > n_records)
    return nullptr;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 ||
      static_cast<uint64_t>(st.st_size) < record_bytes * n_records) {
    close(fd);
    return nullptr;
  }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (m == MAP_FAILED) return nullptr;

  auto* L = new Loader();
  L->base = static_cast<const uint8_t*>(m);
  L->map_len = st.st_size;
  L->record_bytes = record_bytes;
  L->n_records = n_records;
  L->batch = batch;
  L->seed = seed;
  L->batches_per_epoch = n_records / batch;  // drop-last semantics
  // Resume support: start the global batch sequence at `start_epoch` so a
  // restarted run consumes epoch k's permutation (seeded (seed, k)), not a
  // positional replay of epoch 0.  Set before workers spawn — no racing
  // producers exist yet, so no slot-reclaim protocol is needed.
  L->next_produce = L->next_consume = start_epoch * L->batches_per_epoch;
  if (n_threads == 0) n_threads = 2;
  if (queue_cap < n_threads) queue_cap = n_threads * 2;
  L->queue_cap = queue_cap;
  L->slots.resize(queue_cap);
  for (auto& s : L->slots) s.data.resize(batch * record_bytes);
  for (uint32_t i = 0; i < n_threads; ++i)
    L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Returns records copied into `out` (always == batch); the stream is
// epoch-continuous (epoch e+1 follows e with a fresh permutation) and the
// caller slices epochs by counting ktl_batches_per_epoch() deliveries.
int64_t ktl_next(void* h, uint8_t* out) {
  auto* L = static_cast<Loader*>(h);
  if (!L || !out) return -1;
  std::unique_lock<std::mutex> lk(L->mu);
  uint64_t seq = L->next_consume;
  Slot& slot = L->slots[seq % L->queue_cap];
  L->cv_consumer.wait(lk, [&] {
    return L->stopping || (slot.ready && slot.seq == seq);
  });
  if (L->stopping) return -1;
  memcpy(out, slot.data.data(), L->batch * L->record_bytes);
  slot.ready = false;
  slot.seq = UINT64_MAX;
  L->next_consume = seq + 1;
  L->cv_workers.notify_all();
  return static_cast<int64_t>(L->batch);
}

uint64_t ktl_epoch(void* h) {
  auto* L = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> g(L->mu);
  return L->next_consume / L->batches_per_epoch;
}

uint64_t ktl_batches_per_epoch(void* h) {
  auto* L = static_cast<Loader*>(h);
  return L->batches_per_epoch;
}

void ktl_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
