// Native token-corpus loader: mmap + multi-threaded batch prefetch. An own
// copy of polyaxon_tpu/native/dataloader.cpp (the port builds nothing of the
// JAX package); its batches are the reference loader's for the same seed.
//
// The Python input path (data/files.py) gathers B random windows from a
// memory-mapped corpus per step — a Python-level loop whose page faults and
// dtype conversion sit on the trainer's critical path. This
// loader moves the gather off that path entirely: worker threads fill a
// bounded ring of ready int32 batches ahead of demand, so next() is a
// single memcpy.
//
// Multi-host disjointness mirrors data/files.py:_token_stream — process i
// only draws start offsets congruent to i (mod process_count), so two
// hosts can never sample the same window in the same step.
//
// C ABI (driven from Python via ctypes — no pybind11 in this image):
//   ptl_open(path, dtype, seq_len, batch, seed, pi, pc, threads, depth)
//   ptl_next(handle, out_int32)   // blocks until a batch is ready
//   ptl_corpus_tokens(handle)
//   ptl_last_error()              // thread-local message for NULL/err
//   ptl_close(handle)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

thread_local std::string g_error;

enum Dtype : int { U16 = 0, U32 = 1, I32 = 2 };

struct Loader {
  // corpus
  void* map = nullptr;
  size_t map_bytes = 0;
  const uint8_t* data = nullptr;  // token payload (after any header offset)
  int64_t n_tokens = 0;
  int dtype = U16;
  // sampling
  int64_t seq_len = 0;
  int64_t batch = 0;
  int64_t window = 0;  // seq_len + 1
  int64_t n_mine = 0;  // windows owned by this process
  int process_index = 0;
  int process_count = 1;
  uint64_t seed = 0;
  // prefetch ring
  std::vector<std::thread> workers;
  std::deque<int32_t*> ready;
  std::deque<int32_t*> free_bufs;
  std::vector<int32_t*> all_bufs;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_free;
  std::atomic<bool> stop{false};

  void fill(int32_t* out, std::mt19937_64& rng) const {
    std::uniform_int_distribution<int64_t> dist(0, n_mine - 1);
    for (int64_t b = 0; b < batch; ++b) {
      const int64_t start =
          process_index + process_count * dist(rng);
      int32_t* row = out + b * window;
      switch (dtype) {  // branch once per row, tight copy loop inside
        case U16: {
          const uint16_t* src =
              reinterpret_cast<const uint16_t*>(data) + start;
          for (int64_t t = 0; t < window; ++t) row[t] = src[t];
          break;
        }
        case U32: {
          const uint32_t* src =
              reinterpret_cast<const uint32_t*>(data) + start;
          for (int64_t t = 0; t < window; ++t)
            row[t] = static_cast<int32_t>(src[t]);
          break;
        }
        default:
          std::memcpy(row, reinterpret_cast<const int32_t*>(data) + start,
                      window * sizeof(int32_t));
      }
    }
  }

  void worker(int wid) {
    // per-worker deterministic stream: seed mixed with process_index
    // (hosts share one config seed — without the mix every host would
    // draw the SAME index sequence inside its residue class, collapsing
    // global-batch diversity to token-shifted near-duplicates; mirrors
    // data/files.py:_token_stream's seed recipe) and worker id. Batch
    // ORDER across >1 workers is scheduling-dependent, but the SET of
    // windows any worker can draw is the process's own residue class,
    // so disjointness never depends on timing.
    const uint64_t host_seed =
        seed * 1000003ULL + static_cast<uint64_t>(process_index) + 17ULL;
    std::mt19937_64 rng(host_seed * 0x9E3779B97F4A7C15ULL + wid + 1);
    while (true) {
      int32_t* buf;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop || !free_bufs.empty(); });
        if (stop) return;
        buf = free_bufs.front();
        free_bufs.pop_front();
      }
      fill(buf, rng);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push_back(buf);
      }
      cv_ready.notify_one();
    }
  }
};

size_t dtype_size(int dtype) {
  return dtype == U16 ? 2 : 4;
}

}  // namespace

extern "C" {

const char* ptl_last_error() { return g_error.c_str(); }

void* ptl_open(const char* path, int dtype, int64_t header_offset,
               int64_t seq_len, int64_t batch, uint64_t seed,
               int process_index, int process_count, int n_threads,
               int queue_depth) {
  if (dtype < U16 || dtype > I32) {
    g_error = "dtype must be 0 (u16), 1 (u32) or 2 (i32)";
    return nullptr;
  }
  if (seq_len <= 0 || batch <= 0 || process_count <= 0 ||
      process_index < 0 || process_index >= process_count) {
    g_error = "bad seq_len/batch/process layout";
    return nullptr;
  }
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) {
    g_error = std::string("open failed: ") + path;
    return nullptr;
  }
  struct stat st {};
  if (fstat(fd, &st) != 0 || st.st_size <= header_offset) {
    g_error = "fstat failed or file smaller than header_offset";
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);  // mapping holds its own reference
  if (map == MAP_FAILED) {
    g_error = "mmap failed";
    return nullptr;
  }
  madvise(map, st.st_size, MADV_RANDOM);

  auto* L = new Loader();
  L->map = map;
  L->map_bytes = st.st_size;
  L->data = static_cast<const uint8_t*>(map) + header_offset;
  L->dtype = dtype;
  L->n_tokens = (st.st_size - header_offset) / dtype_size(dtype);
  L->seq_len = seq_len;
  L->window = seq_len + 1;
  L->batch = batch;
  L->seed = seed;
  L->process_index = process_index;
  L->process_count = process_count;

  const int64_t n_starts = L->n_tokens - L->window;
  if (n_starts <= 0) {
    g_error = "corpus smaller than one window (seq_len+1 tokens)";
    munmap(map, st.st_size);
    delete L;
    return nullptr;
  }
  L->n_mine =
      (n_starts - process_index + process_count - 1) / process_count;
  if (L->n_mine <= 0) {
    g_error = "corpus too small for this process_count";
    munmap(map, st.st_size);
    delete L;
    return nullptr;
  }

  const int depth = queue_depth > 0 ? queue_depth : 4;
  const size_t buf_elems = static_cast<size_t>(batch) * L->window;
  for (int i = 0; i < depth; ++i) {
    auto* buf = new int32_t[buf_elems];
    L->all_bufs.push_back(buf);
    L->free_bufs.push_back(buf);
  }
  const int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back([L, i] { L->worker(i); });
  return L;
}

int64_t ptl_corpus_tokens(void* h) {
  return h ? static_cast<Loader*>(h)->n_tokens : -1;
}

int ptl_next(void* h, int32_t* out) {
  if (!h || !out) {
    g_error = "null handle or buffer";
    return 1;
  }
  auto* L = static_cast<Loader*>(h);
  int32_t* buf;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return L->stop || !L->ready.empty(); });
    if (L->stop) {
      g_error = "loader closed";
      return 1;
    }
    buf = L->ready.front();
    L->ready.pop_front();
  }
  std::memcpy(out, buf,
              static_cast<size_t>(L->batch) * L->window * sizeof(int32_t));
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_bufs.push_back(buf);
  }
  L->cv_free.notify_one();
  return 0;
}

void ptl_close(void* h) {
  if (!h) return;
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  for (auto* b : L->all_bufs) delete[] b;
  munmap(L->map, L->map_bytes);
  delete L;
}

}  // extern "C"
