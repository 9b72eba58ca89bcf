// Native host-side input pipeline: a threaded batcher over in-memory
// records.
//
// A copy of the reference package's batcher (its native/dataloader.cc;
// the port imports nothing of that package and carries its own copy):
// producer threads assemble shuffled fixed-length float32 batches into a
// bounded buffer pool so host copies and device compute overlap. The
// Python side (kubeflow_tpu_torch/data/loader.py) builds this file with
// g++ at first use and turns ready batches into device tensors through
// pinned memory and a copy stream.
//
// Epoch semantics: one shared permutation over all records per epoch
// (std::mt19937_64 seeded by seed + epoch), drop-remainder batching.
//
// Concurrency: free-list + ready-queue of preallocated batch buffers
// (mutex + condvars), a cursor over the permutation, and an
// epoch-advance critical section.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <numeric>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Batch {
  std::vector<float> data;
  int64_t epoch = 0;
};

struct Loader {
  // immutable after construction. `records` is BORROWED: the caller
  // (kubeflow_tpu_torch/data/loader.py keeps the numpy array alive for
  // the handle's lifetime) owns the memory; copying ImageNet-scale
  // datasets into the loader would double host RAM
  const float* records = nullptr;
  int64_t n_records = 0;
  int64_t record_len = 0;
  int64_t batch = 0;
  uint64_t seed = 0;

  // epoch state (all guarded by epoch_mu)
  std::mutex epoch_mu;
  std::vector<int64_t> perm;
  int64_t cursor = 0;
  int64_t epoch = 0;

  // buffer pool
  std::mutex mu;
  std::condition_variable ready_cv;
  std::condition_variable free_cv;
  std::deque<Batch*> ready;
  std::deque<Batch*> free_list;
  std::vector<Batch> pool;

  std::vector<std::thread> threads;
  std::atomic<bool> stop{false};

  void shuffle_locked() {
    std::mt19937_64 rng(seed + static_cast<uint64_t>(epoch));
    perm.resize(static_cast<size_t>(n_records));
    std::iota(perm.begin(), perm.end(), 0);
    std::shuffle(perm.begin(), perm.end(), rng);
  }

  // claim a batch of record indices: the SNAPSHOT happens inside the
  // critical section, so a reshuffle by another producer can never
  // mutate a claim mid-copy (exactly-once per epoch is exact); only the
  // tiny index copy is serialized — the record memcpy runs unlocked
  int64_t claim(std::vector<int64_t>* idx) {
    std::lock_guard<std::mutex> lock(epoch_mu);
    if (cursor + batch > n_records) {
      // epoch exhausted (drop remainder)
      epoch += 1;
      shuffle_locked();
      cursor = 0;
    }
    idx->assign(perm.begin() + cursor, perm.begin() + cursor + batch);
    cursor += batch;
    return epoch;
  }

  void producer() {
    std::vector<int64_t> idx;
    while (!stop.load()) {
      Batch* buf = nullptr;
      {
        std::unique_lock<std::mutex> lock(mu);
        free_cv.wait(lock, [&] {
          return stop.load() || !free_list.empty();
        });
        if (stop.load()) return;
        buf = free_list.front();
        free_list.pop_front();
      }
      buf->epoch = claim(&idx);
      for (int64_t i = 0; i < batch; ++i) {
        std::memcpy(buf->data.data() + i * record_len,
                    records + idx[static_cast<size_t>(i)] * record_len,
                    static_cast<size_t>(record_len) * sizeof(float));
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        ready.push_back(buf);
      }
      ready_cv.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// Create a loader over `data` (n_records x record_len floats, BORROWED:
// the caller must keep the buffer alive until kftpu_loader_destroy).
// Returns an opaque handle, or null on invalid arguments.
void* kftpu_loader_create(const float* data, int64_t n_records,
                          int64_t record_len, int64_t batch,
                          int32_t n_threads, int32_t pool_size,
                          uint64_t seed) {
  if (!data || n_records <= 0 || record_len <= 0 || batch <= 0 ||
      batch > n_records || n_threads <= 0 || pool_size < 2) {
    return nullptr;
  }
  auto* l = new Loader();
  l->records = data;
  l->n_records = n_records;
  l->record_len = record_len;
  l->batch = batch;
  l->seed = seed;
  {
    std::lock_guard<std::mutex> lock(l->epoch_mu);
    l->shuffle_locked();
  }
  l->pool.resize(static_cast<size_t>(pool_size));
  for (auto& b : l->pool) {
    b.data.resize(static_cast<size_t>(batch * record_len));
    l->free_list.push_back(&b);
  }
  for (int32_t t = 0; t < n_threads; ++t) {
    l->threads.emplace_back([l] { l->producer(); });
  }
  return l;
}

// Copy the next ready batch into `out` (batch x record_len floats).
// Returns the batch's epoch number (>= 0), or -1 on shutdown.
int64_t kftpu_loader_next(void* handle, float* out) {
  auto* l = static_cast<Loader*>(handle);
  Batch* buf = nullptr;
  {
    std::unique_lock<std::mutex> lock(l->mu);
    l->ready_cv.wait(lock, [&] {
      return l->stop.load() || !l->ready.empty();
    });
    if (l->ready.empty()) return -1;
    buf = l->ready.front();
    l->ready.pop_front();
  }
  std::memcpy(out, buf->data.data(),
              static_cast<size_t>(l->batch * l->record_len) * sizeof(float));
  int64_t ep = buf->epoch;
  {
    std::lock_guard<std::mutex> lock(l->mu);
    l->free_list.push_back(buf);
  }
  l->free_cv.notify_one();
  return ep;
}

// Ready-queue depth (observability; approximate by nature).
int32_t kftpu_loader_ready(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lock(l->mu);
  return static_cast<int32_t>(l->ready.size());
}

void kftpu_loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->ready_cv.notify_all();
  l->free_cv.notify_all();
  for (auto& t : l->threads) t.join();
  delete l;
}

}  // extern "C"
