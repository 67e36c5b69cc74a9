// Native host-side batch assembler + prefetcher for packed uint8 datasets.
//
// The port's own copy of moma_tpu/data/native/batcher.cpp (same C ABI),
// plus bt_prefetch_submit_into.  Role: the host half of the input pipeline
// (the part NVIDIA DALI played for the reference, dataset/imagenet_dali.py)
// — random-access gather of sample rows from a memory-mapped pack file into
// contiguous batch buffers, assembled by a worker pool ahead of the
// training loop.  Decode happens once at pack-build time
// (moma_tpu_torch/data/histo.py); augmentation runs on the device; this
// layer's job is to keep a ready batch in host memory so the card never
// waits on the host.
//
// C ABI (ctypes-friendly):
//   bt_open(path, n_rows, row_bytes)            -> handle
//   bt_gather(handle, idx*, n, out*)            multi-threaded gather
//   bt_prefetch_start(handle, batch, depth, threads)
//   bt_prefetch_submit(handle, idx*, n)         enqueue one batch's indices
//   bt_prefetch_submit_into(handle, idx*, n, dst*)
//                                               the same, assembled straight
//                                               into the caller's dst (e.g.
//                                               pinned host memory), which
//                                               must stay valid until the
//                                               batch is dequeued
//   bt_prefetch_get(handle, out*)               blocking dequeue (FIFO, copy)
//   bt_prefetch_get_ref(handle, data**, n*)     zero-copy dequeue -> token;
//                                               caller reads *data directly
//   bt_prefetch_release(handle, token)          recycle a get_ref buffer
//   bt_close(handle)
//
// Buffers are pooled: a released/copied-out batch returns its (warm)
// allocation to a free list instead of freeing it.  At 512^2 x BS128 a
// batch is ~100 MB; re-faulting fresh pages every batch measurably
// dominates the single-copy gather itself.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Batch {
  std::vector<int64_t> idx;
  std::vector<uint8_t> data;  // batch * row_bytes
  uint8_t* ext = nullptr;     // caller's buffer (submit_into), else data
  uint64_t seq = 0;
  bool ready = false;
};

struct Handle {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t map_bytes = 0;
  int64_t n_rows = 0;
  int64_t row_bytes = 0;

  // prefetcher state
  int batch = 0;
  int depth = 0;
  int n_threads = 0;
  uint64_t next_submit_seq = 0;
  uint64_t next_get_seq = 0;
  std::deque<Batch*> pending;   // submitted, not yet assembled
  std::deque<Batch*> done;      // assembled (completion order; get() waits
                                // for the next SUBMISSION-order seq)
  std::deque<Batch*> free_pool; // recycled allocations (warm pages)
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
};

uint8_t* rows(Batch* b) { return b->ext ? b->ext : b->data.data(); }

void gather_range(const Handle* h, const int64_t* idx, int64_t lo, int64_t hi,
                  uint8_t* out) {
  const int64_t rb = h->row_bytes;
  for (int64_t i = lo; i < hi; ++i) {
    std::memcpy(out + i * rb, h->base + idx[i] * rb, rb);
  }
}

void worker_loop(Handle* h) {
  for (;;) {
    Batch* b = nullptr;
    {
      std::unique_lock<std::mutex> lk(h->mu);
      h->cv_work.wait(lk, [&] { return h->stop.load() || !h->pending.empty(); });
      if (h->stop.load()) return;
      b = h->pending.front();
      h->pending.pop_front();
    }
    gather_range(h, b->idx.data(), 0, (int64_t)b->idx.size(), rows(b));
    {
      std::lock_guard<std::mutex> lk(h->mu);
      b->ready = true;
      h->done.push_back(b);
    }
    h->cv_done.notify_all();
  }
}

}  // namespace

extern "C" {

void* bt_open(const char* path, int64_t n_rows, int64_t row_bytes) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  size_t bytes = (size_t)n_rows * (size_t)row_bytes;
  void* base = ::mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  ::madvise(base, bytes, MADV_WILLNEED);
  auto* h = new Handle();
  h->fd = fd;
  h->base = (const uint8_t*)base;
  h->map_bytes = bytes;
  h->n_rows = n_rows;
  h->row_bytes = row_bytes;
  return h;
}

// Parallel gather into caller-provided buffer (out must hold n*row_bytes).
void bt_gather(void* handle, const int64_t* idx, int64_t n, uint8_t* out,
               int n_threads) {
  auto* h = (Handle*)handle;
  if (n_threads <= 1 || n < 4 * n_threads) {
    gather_range(h, idx, 0, n, out);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back(gather_range, h, idx, lo, hi, out);
  }
  for (auto& t : ts) t.join();
}

void bt_prefetch_start(void* handle, int batch, int depth, int n_threads) {
  auto* h = (Handle*)handle;
  h->batch = batch;
  h->depth = depth;
  h->n_threads = n_threads;
  h->stop.store(false);
  for (int i = 0; i < n_threads; ++i) {
    h->workers.emplace_back(worker_loop, h);
  }
}

namespace {

void submit(Handle* h, const int64_t* idx, int64_t n, uint8_t* ext) {
  Batch* b = nullptr;
  {
    std::lock_guard<std::mutex> lk(h->mu);
    if (!h->free_pool.empty()) {
      b = h->free_pool.front();
      h->free_pool.pop_front();
    }
  }
  if (!b) b = new Batch();
  b->idx.assign(idx, idx + n);
  b->ext = ext;
  if (!ext)
    b->data.resize((size_t)n * (size_t)h->row_bytes);  // no-op when recycled
  b->ready = false;
  {
    std::lock_guard<std::mutex> lk(h->mu);
    b->seq = h->next_submit_seq++;
    h->pending.push_back(b);
  }
  h->cv_work.notify_one();
}

}  // namespace

void bt_prefetch_submit(void* handle, const int64_t* idx, int64_t n) {
  submit((Handle*)handle, idx, n, nullptr);
}

void bt_prefetch_submit_into(void* handle, const int64_t* idx, int64_t n,
                             uint8_t* dst) {
  submit((Handle*)handle, idx, n, dst);
}

namespace {

// Dequeue the oldest submitted batch (submission order even when workers
// complete out of order), blocking until it is assembled.
Batch* dequeue_next(Handle* h) {
  Batch* b = nullptr;
  std::unique_lock<std::mutex> lk(h->mu);
  auto find_next = [&]() -> Batch* {
    for (auto it = h->done.begin(); it != h->done.end(); ++it) {
      if ((*it)->seq == h->next_get_seq) {
        Batch* r = *it;
        h->done.erase(it);
        return r;
      }
    }
    return nullptr;
  };
  h->cv_done.wait(lk, [&] { return (b = find_next()) != nullptr; });
  h->next_get_seq++;
  return b;
}

void recycle(Handle* h, Batch* b) {
  std::lock_guard<std::mutex> lk(h->mu);
  h->free_pool.push_back(b);
}

}  // namespace

// Blocks until the oldest submitted batch is assembled; copies it out.
int64_t bt_prefetch_get(void* handle, uint8_t* out) {
  auto* h = (Handle*)handle;
  Batch* b = dequeue_next(h);
  std::memcpy(out, rows(b), b->idx.size() * (size_t)h->row_bytes);
  int64_t n = (int64_t)b->idx.size();
  recycle(h, b);
  return n;
}

// Zero-copy dequeue: *data points at the batch's internal buffer (valid
// until bt_prefetch_release), *n gets the row count; returns the token to
// release.  One memcpy (mmap -> buffer) per row total, vs two for bt_prefetch_get.
void* bt_prefetch_get_ref(void* handle, uint8_t** data, int64_t* n) {
  auto* h = (Handle*)handle;
  Batch* b = dequeue_next(h);
  *data = rows(b);
  *n = (int64_t)b->idx.size();
  return b;
}

void bt_prefetch_release(void* handle, void* token) {
  recycle((Handle*)handle, (Batch*)token);
}

void bt_close(void* handle) {
  auto* h = (Handle*)handle;
  h->stop.store(true);
  h->cv_work.notify_all();
  for (auto& t : h->workers) t.join();
  std::lock_guard<std::mutex> lk(h->mu);
  for (auto* b : h->pending) delete b;
  for (auto* b : h->done) delete b;
  for (auto* b : h->free_pool) delete b;
  if (h->base) ::munmap((void*)h->base, h->map_bytes);
  if (h->fd >= 0) ::close(h->fd);
  delete h;
}

}  // extern "C"
