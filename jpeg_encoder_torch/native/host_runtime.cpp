// Native host runtime: BMP ingest, JFIF byte stuffing, bitstream splicing.
//
// The reference implements its entire host path natively (Rust):
//   - BMP reader        src/bmp/bmp_image.rs   (header at offsets 10/18/22,
//                       bottom-up 24-bit BGR rows padded to 4 bytes)
//   - scan byte output  src/jpeg/file.rs:92-103 (0xFF -> 0xFF 0x00 stuffing)
//   - bit accumulation  src/utils/bitvec_utils.rs
// This library is the TPU build's native equivalent of those host-side
// components; the device compute path stays JAX/XLA/Pallas. Exposed as a
// C ABI consumed via ctypes (jpeg_encoder_torch/native/__init__.py), with
// NumPy fallbacks kept for environments without a C++ toolchain.
//
// Error codes: 0 = ok, negative = validation failure (see JT_ERR_*).

#include <fcntl.h>
#include <pthread.h>
#include <sched.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <system_error>
#include <thread>
#include <vector>

#define JT_ERR_MAGIC -1      // missing 'BM' magic / file too short
#define JT_ERR_BPP -2        // not 24-bit
#define JT_ERR_DIMS -3       // non-positive or absurd dimensions
#define JT_ERR_TRUNCATED -4  // pixel data shorter than header promises
#define JT_ERR_CAPACITY -5   // output buffer too small
#define JT_ERR_IO -6         // a system call failed (its errno is returned)
#define JT_ERR_POOL -7       // the read pool's threads could not start

namespace {

constexpr int64_t kHeaderSize = 54;

inline uint32_t read_u32le(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

inline int32_t read_i32le(const uint8_t* p) {
  return static_cast<int32_t>(read_u32le(p));
}

inline void write_u32le(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
  p[2] = static_cast<uint8_t>(v >> 16);
  p[3] = static_cast<uint8_t>(v >> 24);
}

inline int64_t row_stride(int64_t width) { return (width * 3 + 3) / 4 * 4; }

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// BMP (bmp_image.rs parity: offsets 10/18/22, 24bpp, bottom-up BGR)
// ---------------------------------------------------------------------------

int jt_bmp_probe(const uint8_t* buf, int64_t len, int32_t* width,
                 int32_t* height, int64_t* data_offset, int32_t* bpp) {
  if (len < kHeaderSize || buf[0] != 'B' || buf[1] != 'M') return JT_ERR_MAGIC;
  *data_offset = static_cast<int64_t>(read_u32le(buf + 10));
  *width = read_i32le(buf + 18);
  *height = read_i32le(buf + 22);
  *bpp = static_cast<int32_t>(buf[28]) | (static_cast<int32_t>(buf[29]) << 8);
  if (*bpp != 24) return JT_ERR_BPP;
  if (*width <= 0 || *height <= 0 || *width > 1 << 24 || *height > 1 << 24)
    return JT_ERR_DIMS;
  if (*data_offset + row_stride(*width) * *height > len) return JT_ERR_TRUNCATED;
  return 0;
}

// Decode into out (H*W*3 bytes, top-to-bottom RGB). Caller probes first to
// size the buffer; dims are re-validated here.
int jt_bmp_decode_rgb(const uint8_t* buf, int64_t len, uint8_t* out) {
  int32_t w, h, bpp;
  int64_t off;
  int rc = jt_bmp_probe(buf, len, &w, &h, &off, &bpp);
  if (rc != 0) return rc;
  const int64_t stride = row_stride(w);
  for (int64_t y = 0; y < h; ++y) {
    // Bottom-up storage: output row y comes from stored row (h-1-y).
    const uint8_t* src = buf + off + (h - 1 - y) * stride;
    uint8_t* dst = out + y * static_cast<int64_t>(w) * 3;
    for (int64_t x = 0; x < w; ++x) {
      dst[3 * x + 0] = src[3 * x + 2];  // B,G,R -> R,G,B
      dst[3 * x + 1] = src[3 * x + 1];
      dst[3 * x + 2] = src[3 * x + 0];
    }
  }
  return 0;
}

int64_t jt_bmp_encoded_size(int32_t width, int32_t height) {
  return kHeaderSize + row_stride(width) * height;
}

// (H, W, 3) top-to-bottom RGB -> complete 24-bit BMP file bytes.
int jt_bmp_encode_rgb(const uint8_t* rgb, int32_t width, int32_t height,
                      uint8_t* out, int64_t out_len) {
  if (width <= 0 || height <= 0) return JT_ERR_DIMS;
  const int64_t stride = row_stride(width);
  const int64_t file_size = kHeaderSize + stride * height;
  if (out_len < file_size) return JT_ERR_CAPACITY;
  std::memset(out, 0, kHeaderSize);
  out[0] = 'B';
  out[1] = 'M';
  write_u32le(out + 2, static_cast<uint32_t>(file_size));
  write_u32le(out + 10, kHeaderSize);
  write_u32le(out + 14, 40);                              // BITMAPINFOHEADER
  write_u32le(out + 18, static_cast<uint32_t>(width));
  write_u32le(out + 22, static_cast<uint32_t>(height));
  out[26] = 1;                                            // planes
  out[28] = 24;                                           // bpp
  write_u32le(out + 34, static_cast<uint32_t>(stride * height));
  write_u32le(out + 38, 2835);  // 72 dpi, matching the Python writer
  write_u32le(out + 42, 2835);
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = rgb + (height - 1 - y) * static_cast<int64_t>(width) * 3;
    uint8_t* dst = out + kHeaderSize + y * stride;
    for (int64_t x = 0; x < width; ++x) {
      dst[3 * x + 0] = src[3 * x + 2];
      dst[3 * x + 1] = src[3 * x + 1];
      dst[3 * x + 2] = src[3 * x + 0];
    }
    std::memset(dst + width * 3, 0, stride - width * 3);
  }
  return 0;
}

}  // extern "C"

namespace {

// pread until n bytes or the end of the file: the bytes read, or -1.
int64_t pread_full(int fd, uint8_t* out, int64_t n, int64_t offset) {
  int64_t got = 0;
  while (got < n) {
    const ssize_t r = pread(fd, out + got, static_cast<size_t>(n - got),
                            static_cast<off_t>(offset + got));
    if (r < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (r == 0) break;
    got += r;
  }
  return got;
}

constexpr int64_t kFilePage = 4096;
constexpr int32_t kMaxRanges = 64;

// One range of a split read: n bytes of the file at offset into out.
struct Range {
  uint8_t* out;
  int64_t n;
  int64_t offset;
};

// The outcome of one split read: the ranges still being read, and the
// error to report: JT_ERR_IO (with the errno of the failed pread at the
// lowest offset) before JT_ERR_TRUNCATED (a range came up short).
struct Outcome {
  std::mutex mu;
  std::condition_variable done;
  int pending = 0;
  int rc = 0;
  int error = 0;
  int64_t at = INT64_MAX;

  void add(int range_rc, int range_error, int64_t offset) {
    std::lock_guard<std::mutex> hold(mu);
    const bool worse = range_rc == JT_ERR_IO && rc != JT_ERR_IO;
    const bool same_earlier = range_rc == rc && offset < at;
    if (range_rc != 0 && (rc == 0 || worse || same_earlier)) {
      rc = range_rc;
      error = range_error;
      at = offset;
    }
  }

  void finish(int range_rc, int range_error, int64_t offset) {
    add(range_rc, range_error, offset);
    std::lock_guard<std::mutex> hold(mu);
    if (--pending == 0) done.notify_all();
  }

  void wait() {
    std::unique_lock<std::mutex> hold(mu);
    done.wait(hold, [this] { return pending == 0; });
  }
};

void read_range(int fd, const Range& r, Outcome* outcome, bool pooled) {
  const int64_t got = pread_full(fd, r.out, r.n, r.offset);
  const int rc = got < 0 ? JT_ERR_IO : got < r.n ? JT_ERR_TRUNCATED : 0;
  const int error = got < 0 ? errno : 0;
  if (pooled)
    outcome->finish(rc, error, r.offset);
  else
    outcome->add(rc, error, r.offset);
}

// The rows at file offset [offset, offset + nbytes) cut into at most
// `ranges` contiguous ranges whose inner ends lie on 4 KiB file pages (a
// range never shares a page of the page cache with the next); fewer
// where the block spans fewer pages.
int split_ranges(uint8_t* out, int64_t nbytes, int64_t offset,
                 int32_t ranges, Range* cut) {
  if (ranges > kMaxRanges) ranges = kMaxRanges;
  const int64_t end = offset + nbytes;
  int n = 0;
  int64_t lo = offset;
  for (int32_t i = 1; i <= ranges; ++i) {
    int64_t hi = end;
    if (i < ranges) hi = (offset + nbytes * i / ranges) / kFilePage * kFilePage;
    if (hi <= lo || (i < ranges && hi >= end)) continue;
    cut[n++] = Range{out + (lo - offset), hi - lo, lo};
    lo = hi;
  }
  return n;
}

// The read pool: threads started once a process (one for each CPU the
// process may use) that read ranges handed to them by any number of
// calling threads. Never destroyed, so its threads live as long as the
// process; a forked child, which has none of them, starts a pool of its
// own at its first split read (read_pool compares the pid) and leaves the
// parent's copy alone. fork() holds g_pool_mu across the copy
// (pthread_atfork, below), so the child never inherits it locked by a
// thread it does not have.
class ReadPool {
 public:
  struct Job {
    int fd;
    Range range;
    Outcome* outcome;
  };

  // The threads started, or -errno where the first could not start
  // (those that did are stopped again).
  int start(int count) {
    try {
      for (int t = 0; t < count; ++t) threads_.emplace_back([this] { run(); });
    } catch (const std::system_error& e) {
      {
        std::lock_guard<std::mutex> hold(mu_);
        stop_ = true;
      }
      ready_.notify_all();
      for (auto& t : threads_) t.join();
      threads_.clear();
      return -(e.code().value() > 0 ? e.code().value() : EAGAIN);
    }
    return count;
  }

  void submit(const Job* jobs, int n) {
    {
      std::lock_guard<std::mutex> hold(mu_);
      for (int i = 0; i < n; ++i) queue_.push_back(jobs[i]);
    }
    if (n == 1)
      ready_.notify_one();
    else
      ready_.notify_all();
  }

  int threads() const { return static_cast<int>(threads_.size()); }

 private:
  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> hold(mu_);
        ready_.wait(hold, [this] { return stop_ || !queue_.empty(); });
        if (stop_) return;
        job = queue_.front();
        queue_.pop_front();
      }
      read_range(job.fd, job.range, job.outcome, true);
    }
  }

  std::mutex mu_;
  std::condition_variable ready_;
  std::deque<Job> queue_;
  std::vector<std::thread> threads_;
  bool stop_ = false;
};

std::mutex g_pool_mu;
ReadPool* g_pool = nullptr;
pid_t g_pool_pid = 0;

// Taken before fork() and released after it in both processes: a thread
// of the parent holding g_pool_mu at the fork would leave it locked in the
// child forever.
void pool_lock_for_fork() { g_pool_mu.lock(); }
void pool_unlock_after_fork() { g_pool_mu.unlock(); }
const int g_pool_atfork =
    pthread_atfork(pool_lock_for_fork, pool_unlock_after_fork,
                   pool_unlock_after_fork);

int usable_cpus() {
  cpu_set_t set;
  if (sched_getaffinity(0, sizeof(set), &set) == 0) {
    const int n = CPU_COUNT(&set);
    if (n > 0) return n;
  }
  const int n = static_cast<int>(std::thread::hardware_concurrency());
  return n > 0 ? n : 1;
}

// The process's pool, started on first use; nullptr with *error set
// where its threads could not start.
ReadPool* read_pool(int32_t* error) {
  std::lock_guard<std::mutex> hold(g_pool_mu);
  if (g_pool != nullptr && g_pool_pid == getpid()) return g_pool;
  auto* pool = new ReadPool();
  const int started = pool->start(usable_cpus());
  if (started < 0) {
    delete pool;
    *error = -started;
    return nullptr;
  }
  g_pool = pool;
  g_pool_pid = getpid();
  return pool;
}

// A split read: range 0 on the calling thread, the others handed to
// `others` (which must have each call outcome->finish once), then a wait
// for all of them.
template <class Others>
int read_split(int32_t fd, uint8_t* out, int64_t nbytes, int64_t offset,
               int32_t ranges, int32_t* used, int32_t* error,
               Others others) {
  *error = 0;
  *used = 0;
  if (nbytes <= 0) return 0;
  Range cut[kMaxRanges];
  const int n = split_ranges(out, nbytes, offset, ranges < 1 ? 1 : ranges,
                             cut);
  Outcome outcome;
  outcome.pending = n - 1;
  if (n > 1) {
    const int rc = others(cut + 1, n - 1, &outcome);
    if (rc != 0) {
      *error = rc;
      return JT_ERR_POOL;
    }
  }
  read_range(fd, cut[0], &outcome, false);
  if (n > 1) outcome.wait();
  *used = n;
  *error = outcome.error;
  return outcome.rc;
}

}  // namespace

extern "C" {

// A BMP file opened for a read of its pixel rows: the header validated
// as jt_bmp_probe validates a whole file of the file's size, then *fd
// (open; the caller closes it), the geometry and the rows' file offset.
// On an error nothing stays open; on JT_ERR_IO, *error is the failed
// call's errno. No interpreter runs here, so a ctypes caller holds its
// lock for none of the I/O.
int jt_bmp_open_rows(const char* path, int32_t* fd, int32_t* width,
                     int32_t* height, int64_t* offset, int32_t* error) {
  *error = 0;
  *fd = open(path, O_RDONLY | O_CLOEXEC);
  if (*fd < 0) {
    *error = errno;
    return JT_ERR_IO;
  }
  struct stat st;
  uint8_t head[kHeaderSize] = {0};
  int rc = 0;
  if (fstat(*fd, &st) != 0 || pread_full(*fd, head, kHeaderSize, 0) < 0) {
    *error = errno;
    rc = JT_ERR_IO;
  }
  int32_t bpp = 0;
  if (rc == 0)
    rc = jt_bmp_probe(head, static_cast<int64_t>(st.st_size), width, height,
                      offset, &bpp);
  if (rc != 0) {
    close(*fd);
    *fd = -1;
  }
  return rc;
}

// nbytes of fd at offset into out, as min(ranges, the pages it spans)
// contiguous reads whose inner ends lie on 4 KiB file pages: the first on
// the calling thread, the others on the process's read pool (started on
// the first call that splits). *used is the ranges read. Returns 0,
// JT_ERR_TRUNCATED where any range came up short, JT_ERR_IO with *error
// the failed pread's errno, or JT_ERR_POOL with *error the errno of the
// pool's threads that could not start (nothing read).
int jt_read_ranges(int32_t fd, uint8_t* out, int64_t nbytes, int64_t offset,
                   int32_t ranges, int32_t* used, int32_t* error) {
  return read_split(
      fd, out, nbytes, offset, ranges, used, error,
      [fd](const Range* rest, int n, Outcome* outcome) {
        int32_t start_error = 0;
        ReadPool* pool = read_pool(&start_error);
        if (pool == nullptr) return static_cast<int>(start_error);
        ReadPool::Job jobs[kMaxRanges];
        for (int i = 0; i < n; ++i) jobs[i] = {fd, rest[i], outcome};
        pool->submit(jobs, n);
        return 0;
      });
}

// jt_read_ranges with a thread started for each range but the first and
// joined before it returns, as jt_copy_threads does: the start-up cost
// that the pool avoids, timed by bench/host_io.py --split.
int jt_read_ranges_threads(int32_t fd, uint8_t* out, int64_t nbytes,
                           int64_t offset, int32_t ranges, int32_t* used,
                           int32_t* error) {
  std::vector<std::thread> started;
  const int rc = read_split(
      fd, out, nbytes, offset, ranges, used, error,
      [fd, &started](const Range* rest, int n, Outcome* outcome) {
        try {
          for (int i = 0; i < n; ++i)
            started.emplace_back(
                [fd, r = rest[i], outcome] { read_range(fd, r, outcome, true); });
        } catch (const std::system_error& e) {
          // Those started still finish; count the rest as done.
          for (int i = static_cast<int>(started.size()); i < n; ++i)
            outcome->finish(0, 0, 0);
          for (auto& t : started) t.join();
          started.clear();
          return e.code().value() > 0 ? e.code().value() : EAGAIN;
        }
        return 0;
      });
  for (auto& t : started) t.join();
  return rc;
}

// The threads of the process's read pool, starting it if it has not
// started: > 0, or -errno where they could not start.
int32_t jt_read_pool_threads() {
  int32_t error = 0;
  ReadPool* pool = read_pool(&error);
  return pool == nullptr ? -error : pool->threads();
}

// Holds the read pool's lock on the calling thread for ms milliseconds,
// *held set to 1 once it is taken: a thread that starts the pool while
// another forks, made to order for a test of the fork handlers.
void jt_read_pool_hold(int32_t ms, int32_t* held) {
  std::lock_guard<std::mutex> hold(g_pool_mu);
  __atomic_store_n(held, 1, __ATOMIC_SEQ_CST);
  std::this_thread::sleep_for(std::chrono::milliseconds(ms));
}

// Threaded batch ingest (the "data loader"): decode n same-sized BMP
// buffers into one contiguous (n, H, W, 3) array. Returns 0, or the first
// per-file error. The reference reads 3 bytes per read() syscall
// (bmp_image.rs:72); this saturates host memory bandwidth instead.
int jt_bmp_decode_batch(const uint8_t* const* bufs, const int64_t* lens,
                        int32_t n, int32_t width, int32_t height,
                        uint8_t* out, int32_t num_threads) {
  if (n <= 0) return 0;
  const int64_t image_bytes =
      static_cast<int64_t>(width) * height * 3;
  if (num_threads <= 0)
    num_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
  if (num_threads <= 0) num_threads = 1;
  if (num_threads > n) num_threads = n;

  std::atomic<int32_t> next(0);
  std::atomic<int> status(0);
  auto worker = [&]() {
    for (;;) {
      const int32_t i = next.fetch_add(1);
      if (i >= n || status.load() != 0) return;
      int32_t w, h, bpp;
      int64_t off;
      int rc = jt_bmp_probe(bufs[i], lens[i], &w, &h, &off, &bpp);
      if (rc == 0 && (w != width || h != height)) rc = JT_ERR_DIMS;
      if (rc == 0) rc = jt_bmp_decode_rgb(bufs[i], lens[i], out + i * image_bytes);
      if (rc != 0) status.store(rc);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(num_threads);
  for (int32_t t = 0; t < num_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return status.load();
}

// Copy n bytes from src to dst on num_threads threads, each one contiguous
// share (hardware_concurrency where num_threads <= 0): the host's copy of
// an array into a pinned upload piece, timed by bench/host_io.py --upload
// beside torch's own copy.
void jt_copy_threads(uint8_t* dst, const uint8_t* src, int64_t n,
                     int32_t num_threads) {
  if (n <= 0) return;
  if (num_threads <= 0)
    num_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
  if (num_threads <= 1) {
    std::memcpy(dst, src, n);
    return;
  }
  const int64_t share = (n + num_threads - 1) / num_threads;
  std::vector<std::thread> pool;
  pool.reserve(num_threads);
  for (int32_t t = 0; t < num_threads; ++t) {
    const int64_t lo = t * share;
    if (lo >= n) break;
    const int64_t len = lo + share > n ? n - lo : share;
    pool.emplace_back([=]() { std::memcpy(dst + lo, src + lo, len); });
  }
  for (auto& t : pool) t.join();
}

// ---------------------------------------------------------------------------
// Scan payload byte stuffing (file.rs:92-103): 0xFF -> 0xFF 0x00
// ---------------------------------------------------------------------------

// out must hold 2*n bytes; returns the stuffed length.
int64_t jt_stuff_bytes(const uint8_t* in, int64_t n, uint8_t* out) {
  int64_t j = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t b = in[i];
    out[j++] = b;
    if (b == 0xFF) out[j++] = 0x00;
  }
  return j;
}

// ---------------------------------------------------------------------------
// Optimal Huffman table construction (ITU-T T.81 Annex K.2/K.3)
// ---------------------------------------------------------------------------

// Exact port of tables.optimal_spec (the Python/NumPy implementation stays
// the behavioral spec; an A/B test asserts identity over fuzzed
// histograms). The per-image optimized-Huffman mode builds 4 tables per
// image on the host between the device stats and encode passes — the
// Python merge loop costs ~2 ms/table, which at batch rates would dominate
// the mode (tools/bench_cell.py optimize); this runs in ~30 us.
//
// freq: 256 symbol counts. bits_out: 16 code-length counts. symbols_out:
// up to 256 symbols in (code length, value) order. *nsym_out: symbol
// count. Returns 0, or JT_ERR_DIMS when a code size exceeds the working
// array (unreachable for real histograms; the Fibonacci depth bound keeps
// sizes < 50 even for 2^32 total counts).
int jt_optimal_huffman(const int64_t* freq, uint8_t* bits_out,
                       uint8_t* symbols_out, int32_t* nsym_out) {
  int64_t counts[257];
  int32_t codesize[257];
  int32_t others[257];
  for (int v = 0; v < 256; ++v) counts[v] = freq[v];
  counts[256] = 1;  // reserved: claims the all-ones code (F.1.4.5)
  for (int v = 0; v < 257; ++v) {
    codesize[v] = 0;
    others[v] = -1;
  }

  for (;;) {
    // Least count, ties toward the LARGEST value (K.2), twice.
    int v1 = -1, v2 = -1;
    for (int v = 0; v < 257; ++v) {
      if (counts[v] <= 0) continue;
      if (v1 < 0 || counts[v] < counts[v1] ||
          (counts[v] == counts[v1] && v > v1))
        v1 = v;
    }
    for (int v = 0; v < 257; ++v) {
      if (counts[v] <= 0 || v == v1) continue;
      if (v2 < 0 || counts[v] < counts[v2] ||
          (counts[v] == counts[v2] && v > v2))
        v2 = v;
    }
    if (v2 < 0) break;  // fewer than two active values

    counts[v1] += counts[v2];
    counts[v2] = 0;
    codesize[v1] += 1;
    while (others[v1] != -1) {
      v1 = others[v1];
      codesize[v1] += 1;
    }
    others[v1] = v2;
    codesize[v2] += 1;
    while (others[v2] != -1) {
      v2 = others[v2];
      codesize[v2] += 1;
    }
  }

  constexpr int kBits = 60;  // matches the Python working-array bound
  int32_t bits[kBits];
  std::memset(bits, 0, sizeof(bits));
  for (int v = 0; v < 257; ++v) {
    if (codesize[v] <= 0) continue;
    if (codesize[v] > kBits) return JT_ERR_DIMS;
    bits[codesize[v] - 1] += 1;
  }
  // Fold sizes > 16 down (figure K.3 verbatim).
  for (int i = kBits - 1; i >= 16; --i) {
    while (bits[i] > 0) {
      int j = i - 2;
      while (bits[j] == 0) --j;
      bits[i] -= 2;
      bits[i - 1] += 1;
      bits[j + 1] += 2;
      bits[j] -= 1;
    }
  }
  // Remove the reserved symbol's code from the longest used length.
  {
    int i = 15;
    while (i > 0 && bits[i] == 0) --i;
    if (bits[i] > 0) bits[i] -= 1;
  }
  for (int i = 0; i < 16; ++i) bits_out[i] = static_cast<uint8_t>(bits[i]);

  // Symbols in (code length, value) order.
  int32_t n = 0;
  for (int len = 1; len <= kBits; ++len)
    for (int v = 0; v < 256; ++v)
      if (codesize[v] == len) symbols_out[n++] = static_cast<uint8_t>(v);
  *nsym_out = n;
  return 0;
}

// ---------------------------------------------------------------------------
// Bit-level splice of byte-aligned shard bitstreams (utils/bits.py parity)
// ---------------------------------------------------------------------------

// Each stream i holds ceil(bit_lengths[i] / 8) valid bytes, MSB-first, with
// bits past bit_lengths[i] zero. out must hold ceil(sum(bits) / 8) bytes and
// be zero-initialized by the caller. Returns the total bit count.
int64_t jt_splice_bits(const uint8_t* const* streams, const int64_t* bit_lengths,
                       int32_t n, uint8_t* out) {
  int64_t offset = 0;
  for (int32_t s = 0; s < n; ++s) {
    const int64_t nbits = bit_lengths[s];
    if (nbits == 0) continue;
    const uint8_t* src = streams[s];
    const int64_t nbytes = (nbits + 7) / 8;
    const int64_t pos = offset >> 3;
    const int k = static_cast<int>(offset & 7);
    if (k == 0) {
      for (int64_t i = 0; i < nbytes; ++i) out[pos + i] |= src[i];
    } else {
      // Shift the stream right by k bits while OR-ing into the output.
      uint8_t carry = out[pos];
      for (int64_t i = 0; i < nbytes; ++i) {
        const uint8_t b = src[i];
        out[pos + i] = carry | static_cast<uint8_t>(b >> k);
        carry = static_cast<uint8_t>(b << (8 - k));
      }
      // The final carry only lands if the shifted stream spills a byte;
      // otherwise it is all zeros (stream bits past nbits are zero).
      if ((k + nbits + 7) / 8 > nbytes) out[pos + nbytes] = carry;
    }
    offset += nbits;
  }
  return offset;
}

}  // extern "C"
