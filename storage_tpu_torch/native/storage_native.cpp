// Native host-side runtime for storage_tpu_torch (a copy of the JAX package's
// storage_tpu/native/storage_native.cpp; built by native/__init__.py).
//
// Two subsystems, mirroring where the reference leans on native/runtime code:
//
// 1. Inventory-space reduction (the algorithmic commons of
//    StorageHelper.CalculateInventorySpace, reference StorageHelper.cs:39-107,
//    with the constraint inverse problems of
//    PiecewiseLinearInjectWithdrawConstraint.cs:74-160 /
//    StepInjectWithdrawConstraint.cs:81-166): the per-valuation host precompute.
//    The Python implementation is the readable reference; this path makes
//    hourly-granularity horizons (10k+ steps) cheap.
//
// 2. An asynchronous job engine (thread pool + job states + progress +
//    cooperative cancellation), the native analog of the Excel add-in's async
//    calculation wrapper (ExcelCalcWrapper.cs:33-187: Pending/Running/Success/
//    Error/Cancelled, progress events, cancel).
//
// Exposed as a C ABI for ctypes; no Python.h dependency.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// Inventory-space reduction
// ---------------------------------------------------------------------------

namespace {

struct ConstraintTable {
    const double* inv;   // [width] node inventories (sorted)
    const double* mn;    // [width] min rates
    const double* mx;    // [width] max rates
    int width;
    bool is_step;
};

double interp_rate(const ConstraintTable& t, const double* rates, double inventory) {
    if (inventory <= t.inv[0]) return rates[0];
    if (inventory >= t.inv[t.width - 1]) return rates[t.width - 1];
    int lo = 0, hi = t.width - 1;
    while (hi - lo > 1) {
        int mid = (lo + hi) / 2;
        if (t.inv[mid] <= inventory) lo = mid; else hi = mid;
    }
    if (t.is_step || inventory == t.inv[lo]) return rates[lo];
    // numpy.interp's arithmetic (the slope of the bracket, then one
    // multiply-add from its lower node), which the Python constraints use:
    // the bands keep the Python path's bits.  The JAX package's copy blends
    // rates[lo] and rates[hi] by weight, which parts from it by an ULP.
    double slope = (rates[hi] - rates[lo]) / (t.inv[hi] - t.inv[lo]);
    return slope * (inventory - t.inv[lo]) + rates[lo];
}

double min_rate_at(const ConstraintTable& t, double inventory) {
    return interp_rate(t, t.mn, inventory);
}
double max_rate_at(const ConstraintTable& t, double inventory) {
    return interp_rate(t, t.mx, inventory);
}

double solve_linear(double x1, double y1, double x2, double y2, double y) {
    // StorageHelper.InterpolateLinearAndSolve (StorageHelper.cs:321-330).
    double gradient = (y2 - y1) / (x2 - x1);
    double constant = y1 - gradient * x1;
    return (y - constant) / gradient;
}

// Highest current inventory from which next period's band is reachable
// (inverse problem; PiecewiseLinearInjectWithdrawConstraint.cs:74-116 /
// StepInjectWithdrawConstraint.cs:81-123).
bool space_upper_bound(const ConstraintTable& t, double next_lower, double next_upper,
                       double min_inventory, double max_inventory, double loss,
                       double* out) {
    double keep = 1.0 - loss;
    double from_max_max = max_inventory * keep + max_rate_at(t, max_inventory);
    double from_max_min = max_inventory * keep + min_rate_at(t, max_inventory);
    if (from_max_min <= next_upper && next_lower <= from_max_max) {
        *out = max_inventory;
        return true;
    }
    bool found = false;
    double best = 0.0;
    if (t.is_step) {
        // Keep the maximum solution across brackets (StepInjectWithdrawConstraint.cs:99-122).
        for (int i = 0; i < t.width - 1; i++) {
            double rate = t.mn[i];
            double lo_after = t.inv[i] * keep + rate;
            double hi_after = t.inv[i + 1] * keep + rate;
            if (lo_after <= next_upper && next_upper <= hi_after) {
                best = solve_linear(t.inv[i], lo_after, t.inv[i + 1], hi_after, next_upper);
                found = true;  // keep overwriting: max solution wins
            }
        }
    } else {
        double up_inv = t.inv[t.width - 1];
        double up_after = from_max_min;
        for (int i = t.width - 2; i >= 0; i--) {
            double lo_after = t.inv[i] * keep + t.mn[i];
            if (lo_after <= next_upper && next_upper <= up_after) {
                best = solve_linear(t.inv[i], lo_after, up_inv, up_after, next_upper);
                found = true;
                break;
            }
            up_after = lo_after;
            up_inv = t.inv[i];
        }
    }
    *out = best;
    return found;
}

bool space_lower_bound(const ConstraintTable& t, double next_lower, double next_upper,
                       double min_inventory, double max_inventory, double loss,
                       double* out) {
    double keep = 1.0 - loss;
    double from_min_max = min_inventory * keep + max_rate_at(t, min_inventory);
    double from_min_min = min_inventory * keep + min_rate_at(t, min_inventory);
    if (from_min_min <= next_upper && next_lower <= from_min_max) {
        *out = min_inventory;
        return true;
    }
    bool found = false;
    double best = 0.0;
    if (t.is_step) {
        for (int i = t.width - 2; i >= 0; i--) {
            double rate = t.mx[i];
            double lo_after = t.inv[i] * keep + rate;
            double hi_after = t.inv[i + 1] * keep + rate;
            if (lo_after <= next_lower && next_lower <= hi_after) {
                best = solve_linear(t.inv[i], lo_after, t.inv[i + 1], hi_after, next_lower);
                found = true;  // min solution wins (descending scan keeps overwriting)
            }
        }
    } else {
        double lo_inv = t.inv[0];
        double lo_after = from_min_max;
        for (int i = 1; i < t.width; i++) {
            double hi_after = t.inv[i] * keep + t.mx[i];
            if (lo_after <= next_lower && next_lower <= hi_after) {
                best = solve_linear(lo_inv, lo_after, t.inv[i], hi_after, next_lower);
                found = true;
                break;
            }
            lo_after = hi_after;
            lo_inv = t.inv[i];
        }
    }
    *out = best;
    return found;
}

}  // namespace

extern "C" {

// Feasible-band reduction over num_steps decision periods.
// node_* are [num_steps * width] row-major tables; min_inv/max_inv are
// [num_steps + 1] physical limits (index t = period t); loss is [num_steps].
// Outputs lower/upper [num_steps + 1] (index 0 = starting inventory).
// Returns 0 on success, 1 if the constraints cannot be fulfilled, 2 if an
// inverse problem has no solution.
int stpu_inventory_space_reduce(
    int num_steps, int width, int is_step,
    const double* node_inv, const double* node_min, const double* node_max,
    const double* min_inv, const double* max_inv, const double* loss,
    double starting_inventory, double* lower, double* upper) {
    std::vector<double> fwd_min(num_steps), fwd_max(num_steps);
    double run_min = starting_inventory, run_max = starting_inventory;
    for (int i = 0; i < num_steps; i++) {
        ConstraintTable t{node_inv + (size_t)i * width, node_min + (size_t)i * width,
                          node_max + (size_t)i * width, width, is_step != 0};
        double l = loss[i];
        run_min = std::max(run_min - l * run_min + min_rate_at(t, run_min), min_inv[i + 1]);
        fwd_min[i] = run_min;
        run_max = std::min(run_max - l * run_max + max_rate_at(t, run_max), max_inv[i + 1]);
        fwd_max[i] = run_max;
    }

    std::vector<double> back_min(num_steps), back_max(num_steps);
    back_min[num_steps - 1] = min_inv[num_steps];
    back_max[num_steps - 1] = max_inv[num_steps];
    for (int i = num_steps - 2; i >= 0; i--) {
        int k = i + 1;  // constraint of the period linking band i+1 -> i+2
        ConstraintTable t{node_inv + (size_t)k * width, node_min + (size_t)k * width,
                          node_max + (size_t)k * width, width, is_step != 0};
        if (!space_upper_bound(t, back_min[i + 1], back_max[i + 1], min_inv[k], max_inv[k],
                               loss[k], &back_max[i]))
            return 2;
        if (!space_lower_bound(t, back_min[i + 1], back_max[i + 1], min_inv[k], max_inv[k],
                               loss[k], &back_min[i]))
            return 2;
    }

    lower[0] = upper[0] = starting_inventory;
    for (int i = 0; i < num_steps; i++) {
        double lo = std::max(fwd_min[i], back_min[i]);
        double hi = std::min(fwd_max[i], back_max[i]);
        if (lo > hi) return 1;
        lower[i + 1] = lo;
        upper[i + 1] = hi;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Async job engine
// ---------------------------------------------------------------------------

enum JobStatus : int {
    JOB_PENDING = 0,
    JOB_RUNNING = 1,
    JOB_SUCCESS = 2,
    JOB_ERROR = 3,
    JOB_CANCELLED = 4,
};

typedef void (*job_fn)(int64_t job_id, void* ctx);

struct Job {
    int64_t id;
    job_fn fn;
    void* ctx;
    std::atomic<int> status{JOB_PENDING};
    std::atomic<double> progress{0.0};
    std::atomic<bool> cancel_requested{false};
};

struct JobEngine {
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable done_cv;
    std::deque<Job*> queue;
    std::unordered_map<int64_t, Job*> jobs;
    std::vector<std::thread> workers;
    std::atomic<int64_t> next_id{1};
    bool shutting_down = false;

    explicit JobEngine(int num_threads) {
        for (int i = 0; i < num_threads; i++)
            workers.emplace_back([this] { worker_loop(); });
    }

    void worker_loop() {
        for (;;) {
            Job* job = nullptr;
            {
                std::unique_lock<std::mutex> lock(mu);
                cv.wait(lock, [this] { return shutting_down || !queue.empty(); });
                if (shutting_down && queue.empty()) return;
                job = queue.front();
                queue.pop_front();
            }
            if (job->cancel_requested.load()) {
                job->status.store(JOB_CANCELLED);
            } else {
                job->status.store(JOB_RUNNING);
                job->fn(job->id, job->ctx);  // callback sets SUCCESS/ERROR/CANCELLED
                int st = job->status.load();
                if (st == JOB_RUNNING) job->status.store(JOB_SUCCESS);
            }
            done_cv.notify_all();
        }
    }

    ~JobEngine() {
        {
            std::lock_guard<std::mutex> lock(mu);
            shutting_down = true;
        }
        cv.notify_all();
        for (auto& w : workers) w.join();
        for (auto& kv : jobs) delete kv.second;
    }
};

void* stpu_job_engine_create(int num_threads) {
    return new JobEngine(num_threads > 0 ? num_threads : 1);
}

void stpu_job_engine_destroy(void* engine) { delete static_cast<JobEngine*>(engine); }

int64_t stpu_job_submit(void* engine, job_fn fn, void* ctx) {
    auto* e = static_cast<JobEngine*>(engine);
    auto* job = new Job();
    job->id = e->next_id.fetch_add(1);
    job->fn = fn;
    job->ctx = ctx;
    {
        std::lock_guard<std::mutex> lock(e->mu);
        e->jobs[job->id] = job;
        e->queue.push_back(job);
    }
    e->cv.notify_one();
    return job->id;
}

static Job* find_job(void* engine, int64_t id) {
    auto* e = static_cast<JobEngine*>(engine);
    std::lock_guard<std::mutex> lock(e->mu);
    auto it = e->jobs.find(id);
    return it == e->jobs.end() ? nullptr : it->second;
}

int stpu_job_status(void* engine, int64_t id) {
    Job* job = find_job(engine, id);
    return job ? job->status.load() : -1;
}

double stpu_job_progress(void* engine, int64_t id) {
    Job* job = find_job(engine, id);
    return job ? job->progress.load() : -1.0;
}

void stpu_job_set_progress(void* engine, int64_t id, double progress) {
    Job* job = find_job(engine, id);
    if (job) job->progress.store(progress);
}

void stpu_job_set_status(void* engine, int64_t id, int status) {
    Job* job = find_job(engine, id);
    if (job) job->status.store(status);
}

void stpu_job_request_cancel(void* engine, int64_t id) {
    Job* job = find_job(engine, id);
    if (job) job->cancel_requested.store(true);
}

int stpu_job_cancel_requested(void* engine, int64_t id) {
    Job* job = find_job(engine, id);
    return job ? (job->cancel_requested.load() ? 1 : 0) : -1;
}

// Blocks until the job leaves PENDING/RUNNING.  Returns the final status.
int stpu_job_wait(void* engine, int64_t id) {
    auto* e = static_cast<JobEngine*>(engine);
    Job* job = find_job(engine, id);
    if (!job) return -1;
    std::unique_lock<std::mutex> lock(e->mu);
    e->done_cv.wait(lock, [job] {
        int st = job->status.load();
        return st != JOB_PENDING && st != JOB_RUNNING;
    });
    return job->status.load();
}

int stpu_job_engine_num_running(void* engine) {
    auto* e = static_cast<JobEngine*>(engine);
    std::lock_guard<std::mutex> lock(e->mu);
    int running = 0;
    for (auto& kv : e->jobs)
        if (kv.second->status.load() == JOB_RUNNING) running++;
    return running;
}

}  // extern "C"
