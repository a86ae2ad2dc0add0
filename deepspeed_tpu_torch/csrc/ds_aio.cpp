// Async file I/O handle: the host side of deepspeed_tpu_torch.ops.aio.
//
// The port's own copy of the JAX package's csrc/aio/ds_aio.cpp (reference
// csrc/aio/: a thread pool issuing reads and writes, with the
// queue_depth / submit / wait surface of its aio_handle). Without libaio
// the asynchrony comes from a std::thread worker pool issuing positional
// pread / pwrite (optionally O_DIRECT). The NVMe optimizer tier
// (runtime/swap/optimizer_swapper.py) overlaps its reads and writes with
// the host update through it.
//
// Built by the host compiler at first use (ops/registry.host_library):
//   g++ -O2 -shared -fPIC -std=c++17 -pthread ds_aio.cpp -o ds_aio-<hash>.so
//
// C ABI (ctypes-friendly): every function returns <0 on error.

#include <atomic>
#include <condition_variable>
#include <cerrno>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <functional>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Task {
  bool write;
  int fd;
  char *buf;
  size_t nbytes;
  off_t offset;
};

struct Handle {
  int queue_depth;
  std::vector<std::thread> workers;
  std::deque<Task> queue;
  std::mutex mu;
  std::condition_variable cv_submit;
  std::condition_variable cv_done;
  std::atomic<long> inflight{0};
  std::atomic<long> completed{0};
  std::atomic<long> errors{0};
  bool stop = false;

  explicit Handle(int queue_depth_, int num_threads)
      : queue_depth(queue_depth_) {
    for (int i = 0; i < num_threads; ++i) {
      workers.emplace_back([this] { run(); });
    }
  }

  ~Handle() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_submit.notify_all();
    for (auto &w : workers) w.join();
  }

  void run() {
    for (;;) {
      Task t;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_submit.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        t = queue.front();
        queue.pop_front();
      }
      bool ok = do_io(t);
      {
        // state changes under the mutex — a decrement outside it can race
        // the wait_all predicate check and lose the wakeup
        std::lock_guard<std::mutex> lk(mu);
        if (!ok) errors.fetch_add(1);
        completed.fetch_add(1);
        inflight.fetch_sub(1);
      }
      cv_done.notify_all();
    }
  }

  static bool do_io(const Task &t) {
    size_t done = 0;
    while (done < t.nbytes) {
      ssize_t n =
          t.write ? pwrite(t.fd, t.buf + done, t.nbytes - done, t.offset + done)
                  : pread(t.fd, t.buf + done, t.nbytes - done, t.offset + done);
      if (n < 0 && errno == EINTR) continue;  // interrupted — retry
      if (n <= 0) return false;               // error, or EOF short read
      done += static_cast<size_t>(n);
    }
    return true;
  }

  int submit(bool write, int fd, char *buf, size_t nbytes, off_t offset) {
    {
      std::unique_lock<std::mutex> lk(mu);
      // bounded queue: respect queue_depth like the reference aio context
      cv_done.wait(lk, [this] {
        return static_cast<int>(queue.size()) < queue_depth;
      });
      queue.push_back(Task{write, fd, buf, nbytes, offset});
      inflight.fetch_add(1);
    }
    cv_submit.notify_one();
    return 0;
  }

  long wait_all() {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [this] { return inflight.load() == 0; });
    long e = errors.exchange(0);
    return e == 0 ? completed.load() : -e;
  }
};

} // namespace

extern "C" {

void *dsaio_create(int queue_depth, int num_threads) {
  if (num_threads <= 0 || queue_depth <= 0) return nullptr;
  return new Handle(queue_depth, num_threads);
}

void dsaio_destroy(void *h) { delete static_cast<Handle *>(h); }

int dsaio_open(const char *path, int for_write, int direct) {
  int flags = for_write ? (O_WRONLY | O_CREAT) : O_RDONLY;
#ifdef O_DIRECT
  if (direct) flags |= O_DIRECT;
#endif
  return open(path, flags, 0644);
}

int dsaio_close(int fd) { return close(fd); }

int dsaio_submit_pread(void *h, int fd, void *buf, long nbytes, long offset) {
  return static_cast<Handle *>(h)->submit(false, fd, static_cast<char *>(buf),
                                          static_cast<size_t>(nbytes),
                                          static_cast<off_t>(offset));
}

int dsaio_submit_pwrite(void *h, int fd, void *buf, long nbytes, long offset) {
  return static_cast<Handle *>(h)->submit(true, fd, static_cast<char *>(buf),
                                          static_cast<size_t>(nbytes),
                                          static_cast<off_t>(offset));
}

// blocks until every submitted op lands; returns total completed (<0: errors)
long dsaio_wait(void *h) { return static_cast<Handle *>(h)->wait_all(); }

}
