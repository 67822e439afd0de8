// Native runtime substrate: thread pool, state store, policy buffer,
// agent plan loop.
//
// TPU-native rebuild of the reference's C++ runtime layer:
//   * ThreadPool  — mjpc/threadpool.{h,cc}: fixed workers, Schedule +
//     counter/cv WaitCount/ResetCount semantics.
//   * StateStore  — mjpc/states/state.{h,cc}: shared_mutex-guarded
//     (qpos, qvel, time) snapshot handed from the physics/robot thread
//     to the planner thread.
//   * PolicyBuffer — the planners' shared_mutex policy swap
//     (mjpc/planners/sampling/planner.cc:227-233,525-534): double-
//     buffered opaque byte blobs, writers publish, readers snapshot.
//   * AgentLoop   — Agent::Plan's busy loop on a background thread
//     (mjpc/agent.cc:318-329), invoking a host callback per iteration
//     (the callback runs the jitted planner step; ctypes re-acquires
//     the GIL for Python callbacks).
//
// The JAX compute path stays in XLA; this file is the asynchronous
// orchestration around it — exactly the split the reference uses
// (planners compute, the runtime moves state/policies between threads).
//
// Built with plain g++ (no external deps); exposed to Python via ctypes
// (see __init__.py).

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <shared_mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// ThreadPool
// ---------------------------------------------------------------------

typedef void (*task_fn)(void* arg);

struct ThreadPool {
  std::vector<std::thread> workers;
  std::deque<std::pair<task_fn, void*>> queue;
  std::mutex mtx;
  std::condition_variable cv;
  std::condition_variable done_cv;
  std::atomic<bool> stop{false};
  std::atomic<long> completed{0};

  explicit ThreadPool(int n) {
    for (int i = 0; i < n; i++) {
      workers.emplace_back([this] {
        while (true) {
          std::pair<task_fn, void*> task;
          {
            std::unique_lock<std::mutex> lk(mtx);
            cv.wait(lk, [this] { return stop || !queue.empty(); });
            if (stop && queue.empty()) return;
            task = queue.front();
            queue.pop_front();
          }
          task.first(task.second);
          completed.fetch_add(1);
          done_cv.notify_all();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mtx);
      stop = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
  }
};

void* threadpool_create(int n_workers) { return new ThreadPool(n_workers); }

void threadpool_destroy(void* p) { delete static_cast<ThreadPool*>(p); }

void threadpool_schedule(void* p, task_fn fn, void* arg) {
  auto* tp = static_cast<ThreadPool*>(p);
  {
    std::lock_guard<std::mutex> lk(tp->mtx);
    tp->queue.emplace_back(fn, arg);
  }
  tp->cv.notify_one();
}

// WaitCount: block until `count` tasks have completed since the last
// ResetCount (threadpool.h:48-60 semantics).
void threadpool_wait_count(void* p, long count) {
  auto* tp = static_cast<ThreadPool*>(p);
  std::unique_lock<std::mutex> lk(tp->mtx);
  tp->done_cv.wait(lk, [tp, count] { return tp->completed.load() >= count; });
}

void threadpool_reset_count(void* p) {
  static_cast<ThreadPool*>(p)->completed.store(0);
}

long threadpool_count(void* p) {
  return static_cast<ThreadPool*>(p)->completed.load();
}

// ---------------------------------------------------------------------
// StateStore
// ---------------------------------------------------------------------

struct StateStore {
  std::vector<double> qpos, qvel;
  double time = 0.0;
  std::shared_mutex mtx;
  std::atomic<long> version{0};

  StateStore(int nq, int nv) : qpos(nq, 0.0), qvel(nv, 0.0) {}
};

void* state_create(int nq, int nv) { return new StateStore(nq, nv); }
void state_destroy(void* p) { delete static_cast<StateStore*>(p); }

void state_set(void* p, const double* qpos, const double* qvel,
               double time) {
  auto* s = static_cast<StateStore*>(p);
  std::unique_lock<std::shared_mutex> lk(s->mtx);
  std::memcpy(s->qpos.data(), qpos, s->qpos.size() * sizeof(double));
  std::memcpy(s->qvel.data(), qvel, s->qvel.size() * sizeof(double));
  s->time = time;
  s->version.fetch_add(1);
}

double state_get(void* p, double* qpos, double* qvel) {
  auto* s = static_cast<StateStore*>(p);
  std::shared_lock<std::shared_mutex> lk(s->mtx);
  std::memcpy(qpos, s->qpos.data(), s->qpos.size() * sizeof(double));
  std::memcpy(qvel, s->qvel.data(), s->qvel.size() * sizeof(double));
  return s->time;
}

long state_version(void* p) {
  return static_cast<StateStore*>(p)->version.load();
}

// ---------------------------------------------------------------------
// PolicyBuffer (double-buffered opaque blobs)
// ---------------------------------------------------------------------

struct PolicyBuffer {
  std::vector<unsigned char> bufs[2];
  std::atomic<int> active{0};
  std::shared_mutex mtx;
  std::atomic<long> version{0};
};

void* policy_create() { return new PolicyBuffer(); }
void policy_destroy(void* p) { delete static_cast<PolicyBuffer*>(p); }

void policy_publish(void* p, const unsigned char* data, long size) {
  auto* pb = static_cast<PolicyBuffer*>(p);
  int next = 1 - pb->active.load();
  pb->bufs[next].assign(data, data + size);
  std::unique_lock<std::shared_mutex> lk(pb->mtx);
  pb->active.store(next);
  pb->version.fetch_add(1);
}

long policy_size(void* p) {
  auto* pb = static_cast<PolicyBuffer*>(p);
  std::shared_lock<std::shared_mutex> lk(pb->mtx);
  return static_cast<long>(pb->bufs[pb->active.load()].size());
}

long policy_read(void* p, unsigned char* out, long capacity) {
  auto* pb = static_cast<PolicyBuffer*>(p);
  std::shared_lock<std::shared_mutex> lk(pb->mtx);
  const auto& b = pb->bufs[pb->active.load()];
  long n = static_cast<long>(b.size());
  if (n > capacity) n = capacity;
  std::memcpy(out, b.data(), n);
  return n;
}

long policy_version(void* p) {
  return static_cast<PolicyBuffer*>(p)->version.load();
}

// ---------------------------------------------------------------------
// AgentLoop: plan busy-loop on a background thread
// ---------------------------------------------------------------------

typedef int (*plan_cb)(void* ctx);  // return 0 to keep looping

struct AgentLoop {
  std::thread th;
  std::atomic<bool> running{false};
  std::atomic<long> iterations{0};
};

void* agentloop_create() { return new AgentLoop(); }

void agentloop_start(void* p, plan_cb cb, void* ctx) {
  auto* a = static_cast<AgentLoop*>(p);
  if (a->running.exchange(true)) return;
  a->th = std::thread([a, cb, ctx] {
    while (a->running.load()) {
      int rc = cb(ctx);  // ctypes callback re-acquires the GIL
      a->iterations.fetch_add(1);
      if (rc != 0) break;
    }
    a->running.store(false);
  });
}

void agentloop_stop(void* p) {
  auto* a = static_cast<AgentLoop*>(p);
  a->running.store(false);
  if (a->th.joinable()) a->th.join();
}

long agentloop_iterations(void* p) {
  return static_cast<AgentLoop*>(p)->iterations.load();
}

void agentloop_destroy(void* p) {
  agentloop_stop(p);
  delete static_cast<AgentLoop*>(p);
}

}  // extern "C"
