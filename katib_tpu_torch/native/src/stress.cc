// Race-detection stress harness for the native runtime, built with
// ThreadSanitizer (`native/build.py`: build(["katib-native-stress"])) and
// with AddressSanitizer (build(["katib-native-stress-asan"])).
//
// The reference ships no race detection at all (its `make test` runs
// without -race — SURVEY §5); here the two concurrent-by-design native
// components get hammered under TSan:
//
//   1. observation store: N writer threads reporting interleaved with
//      reader threads snapshotting queries and a deleter thread — the
//      exact shape of parallel trial runners + UI reads + retention.
//   2. batch loader: gather workers racing the consumer across epoch
//      turnovers (permutation rebuild) and shutdown mid-stream.
//
// Exit 0 = no data race reported (TSan aborts the process otherwise).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "obslog.h"

extern "C" {
void* ktl_open(const char* path, uint64_t record_bytes, uint64_t n_records,
               uint64_t batch, uint64_t seed, uint32_t n_threads,
               uint32_t queue_cap, uint64_t start_epoch);
int64_t ktl_next(void* h, uint8_t* out);
uint64_t ktl_batches_per_epoch(void* h);
void ktl_close(void* h);
}

static void stress_store() {
  kt_store_t s = kt_store_new();
  std::atomic<bool> stop{false};

  std::vector<std::thread> threads;
  for (int w = 0; w < 4; ++w) {
    threads.emplace_back([&, w] {
      char trial[32];
      snprintf(trial, sizeof trial, "trial-%d", w);
      for (int i = 0; i < 2000; ++i)
        kt_store_report(s, trial, i % 2 ? "accuracy" : "loss", i * 0.5,
                        1000.0 + i, i);
    });
  }
  for (int r = 0; r < 2; ++r) {
    threads.emplace_back([&] {
      while (!stop.load()) {
        kt_query_t q = kt_store_get(s, "trial-1", "accuracy");
        int32_t n = kt_query_len(q);
        if (n > 0) {
          std::vector<double> vals(n);
          kt_query_values(q, vals.data());
        }
        kt_query_free(q);
        kt_query_t names = kt_store_trial_names(s);
        kt_query_names_blob(names);
        kt_query_free(names);
      }
    });
  }
  threads.emplace_back([&] {
    for (int i = 0; i < 200; ++i) kt_store_delete(s, "trial-3");
  });

  for (int w = 0; w < 4; ++w) threads[w].join();
  stop.store(true);
  for (size_t i = 4; i < threads.size(); ++i) threads[i].join();
  // sanity: every surviving write landed.  trial-3 raced the deleter (any
  // suffix of its writes may remain), but trials 0-2 must hold exactly
  // their 2000 entries — a lost update means a race even if TSan missed it.
  for (int w = 0; w < 3; ++w) {
    char trial[32];
    snprintf(trial, sizeof trial, "trial-%d", w);
    kt_query_t q = kt_store_get(s, trial, nullptr);
    int32_t got = kt_query_len(q);
    kt_query_free(q);
    if (got != 2000) {
      fprintf(stderr, "store stress: LOST UPDATES, %s has %d/2000\n", trial, got);
      exit(2);
    }
  }
  long long total = (long long)kt_store_total(s);
  if (total < 6000 || total > 8000) {
    fprintf(stderr, "store stress: impossible total=%lld\n", total);
    exit(2);
  }
  kt_store_free(s);
  printf("store stress: total=%lld\n", total);
}

static void stress_loader(const char* tmpdir) {
  const uint64_t record = 64, n = 1000, batch = 32;
  std::string path = std::string(tmpdir) + "/stress.bin";
  {
    FILE* f = fopen(path.c_str(), "wb");
    if (!f) { perror("fopen"); exit(2); }
    std::vector<uint8_t> buf(record * n);
    for (size_t i = 0; i < buf.size(); ++i) buf[i] = (uint8_t)(i * 31);
    fwrite(buf.data(), 1, buf.size(), f);
    fclose(f);
  }
  // normal consumption across several epoch turnovers
  void* h = ktl_open(path.c_str(), record, n, batch, 42, 4, 8, 0);
  if (!h) { fprintf(stderr, "ktl_open failed\n"); exit(2); }
  uint64_t bpe = ktl_batches_per_epoch(h);
  std::vector<uint8_t> out(batch * record);
  for (uint64_t i = 0; i < bpe * 5; ++i)
    if (ktl_next(h, out.data()) != (int64_t)batch) { exit(2); }
  ktl_close(h);

  // shutdown mid-stream while workers are producing
  for (int round = 0; round < 5; ++round) {
    void* h2 = ktl_open(path.c_str(), record, n, batch, round, 4, 4, 0);
    if (!h2) exit(2);
    for (int i = 0; i < round * 3; ++i) ktl_next(h2, out.data());
    ktl_close(h2);  // workers must wind down cleanly mid-epoch
  }
  printf("loader stress: ok (bpe=%llu)\n", (unsigned long long)bpe);
}

int main(int argc, char** argv) {
  const char* tmpdir = argc > 1 ? argv[1] : "/tmp";
  stress_store();
  stress_loader(tmpdir);
  printf("native stress: PASS\n");
  return 0;
}
