// Native memory-accounting + per-thread OOM state machine.
//
// Reference analog: the RmmSpark JNI layer (com.nvidia.spark.rapids.jni.RmmSpark,
// consumed by RmmRapidsRetryIterator.scala:27): a concurrent native state
// machine that (a) tracks a logical HBM budget, (b) lets one task's failed
// reservation BLOCK its thread until another task frees memory or a spill
// completes, (c) injects RetryOOM / SplitAndRetryOOM faults at exact
// reservation counts for the retry test suites, and (d) records per-thread
// retry metrics. The Python MemoryManager binds this via ctypes
// (spark_rapids_tpu_torch/mem/native.py) and keeps a pure-Python twin for
// environments without a compiler; semantics are identical by test.
//
// Thread model: any number of Python task threads; all state guarded by one
// mutex + condvar (reservation paths are not hot: they run once per batch,
// not per element).
//
// Return codes for oom_reserve:
//   0 = reserved
//   1 = RetryOOM   (caller should spill and retry)
//   2 = SplitAndRetryOOM (caller must split its input)
//   3 = timed out waiting for memory (treated as RetryOOM by the binding)

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <chrono>
#include <map>
#include <mutex>
#include <vector>

namespace {

struct Injection {
  int kind;      // 1 = retry, 2 = split
  long skip;     // reservations to let through first
  long count;    // how many faults to raise after the skips
};

struct ThreadState {
  long task_id = -1;
  long retry_count = 0;
  long split_count = 0;
  long blocked_ns = 0;
  bool blocked = false;
  std::vector<Injection> injections;
};

struct Globals {
  std::mutex mu;
  std::condition_variable cv;
  int64_t budget = 0;
  int64_t used = 0;
  int64_t max_used = 0;
  int64_t host_used = 0;
  long blocked_threads = 0;
  std::map<int64_t, ThreadState> threads;
};

Globals g;

ThreadState& state_for(int64_t tid) {
  return g.threads[tid];  // default-constructs on first touch
}

// returns 0 = no injection, 1 = retry, 2 = split
int consume_injection(ThreadState& ts) {
  if (ts.injections.empty()) return 0;
  Injection& inj = ts.injections.front();
  if (inj.skip > 0) {
    inj.skip--;
    return 0;
  }
  int kind = inj.kind;
  if (--inj.count <= 0) {
    ts.injections.erase(ts.injections.begin());
  }
  if (kind == 1) ts.retry_count++;
  else ts.split_count++;
  return kind;
}

}  // namespace

extern "C" {

void oom_init(int64_t budget_bytes) {
  std::lock_guard<std::mutex> lk(g.mu);
  g.budget = budget_bytes;
  g.used = 0;
  g.max_used = 0;
  g.host_used = 0;
  g.threads.clear();
}

void oom_set_budget(int64_t budget_bytes) {
  std::lock_guard<std::mutex> lk(g.mu);
  g.budget = budget_bytes;
  g.cv.notify_all();
}

void oom_register_thread(int64_t tid, long task_id) {
  std::lock_guard<std::mutex> lk(g.mu);
  state_for(tid).task_id = task_id;
}

void oom_unregister_thread(int64_t tid) {
  std::lock_guard<std::mutex> lk(g.mu);
  g.threads.erase(tid);
}

// Reserve nbytes. If it does not fit: wait up to block_ms for another thread
// to release memory (the RmmSpark block/wake behaviour); if still failing,
// report RetryOOM so the caller runs a spill-and-retry cycle.
int oom_reserve(int64_t tid, int64_t nbytes, long block_ms) {
  std::unique_lock<std::mutex> lk(g.mu);
  ThreadState& ts = state_for(tid);
  int inj = consume_injection(ts);
  if (inj != 0) return inj;
  if (nbytes > g.budget) return 2;  // can never fit: split required
  auto fits = [&] { return g.used + nbytes <= g.budget; };
  if (!fits() && block_ms > 0) {
    auto t0 = std::chrono::steady_clock::now();
    ts.blocked = true;
    g.blocked_threads++;
    bool ok = g.cv.wait_for(lk, std::chrono::milliseconds(block_ms), fits);
    g.blocked_threads--;
    ts.blocked = false;
    ts.blocked_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now() - t0).count();
    if (!ok) return 3;
  }
  if (!fits()) return 1;
  g.used += nbytes;
  if (g.used > g.max_used) g.max_used = g.used;
  return 0;
}

void oom_release(int64_t nbytes) {
  std::lock_guard<std::mutex> lk(g.mu);
  g.used -= nbytes;
  if (g.used < 0) g.used = 0;
  g.cv.notify_all();
}

// Restart the high-water mark at the bytes in use now (per-query peaks).
void oom_reset_max_used() {
  std::lock_guard<std::mutex> lk(g.mu);
  g.max_used = g.used;
}

void oom_host_reserve(int64_t nbytes) {
  std::lock_guard<std::mutex> lk(g.mu);
  g.host_used += nbytes;
}

void oom_host_release(int64_t nbytes) {
  std::lock_guard<std::mutex> lk(g.mu);
  g.host_used -= nbytes;
  if (g.host_used < 0) g.host_used = 0;
}

void oom_force_retry_oom(int64_t tid, long num_ooms, long skip) {
  std::lock_guard<std::mutex> lk(g.mu);
  state_for(tid).injections.push_back({1, skip, num_ooms});
}

void oom_force_split_and_retry_oom(int64_t tid, long num_ooms, long skip) {
  std::lock_guard<std::mutex> lk(g.mu);
  state_for(tid).injections.push_back({2, skip, num_ooms});
}

void oom_clear_injections() {
  std::lock_guard<std::mutex> lk(g.mu);
  for (auto& kv : g.threads) kv.second.injections.clear();
}

int64_t oom_get_used() {
  std::lock_guard<std::mutex> lk(g.mu);
  return g.used;
}

int64_t oom_get_max_used() {
  std::lock_guard<std::mutex> lk(g.mu);
  return g.max_used;
}

int64_t oom_get_host_used() {
  std::lock_guard<std::mutex> lk(g.mu);
  return g.host_used;
}

int64_t oom_get_budget() {
  std::lock_guard<std::mutex> lk(g.mu);
  return g.budget;
}

long oom_get_blocked_threads() {
  std::lock_guard<std::mutex> lk(g.mu);
  return g.blocked_threads;
}

long oom_get_retry_count(int64_t tid) {
  std::lock_guard<std::mutex> lk(g.mu);
  auto it = g.threads.find(tid);
  return it == g.threads.end() ? 0 : it->second.retry_count;
}

long oom_get_split_count(int64_t tid) {
  std::lock_guard<std::mutex> lk(g.mu);
  auto it = g.threads.find(tid);
  return it == g.threads.end() ? 0 : it->second.split_count;
}

int64_t oom_get_blocked_ns(int64_t tid) {
  std::lock_guard<std::mutex> lk(g.mu);
  auto it = g.threads.find(tid);
  return it == g.threads.end() ? 0 : it->second.blocked_ns;
}

}  // extern "C"
