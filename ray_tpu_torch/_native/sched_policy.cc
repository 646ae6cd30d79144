// Hybrid scheduling policy scorer — the hot node-selection inner loop.
//
// reference: src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.h:29-49
// (top-k selection by utilization score, local-first) and
// cluster_resource_scheduler.h:99 GetBestSchedulableNode.  The Python
// ClusterResourceScheduler prepares per-node flags (feasible / can-allocate /
// utilization) and delegates the selection to this scorer; at thousands of
// nodes the sort+select dominates lease latency, which is why the reference
// keeps it native.
//
// Build: handled by ray_tpu_torch._native.load("sched_policy") (g++ -O2 -shared).

#include <algorithm>
#include <cstdint>
#include <random>
#include <vector>

extern "C" {

// Returns the chosen node index in [0, n), or -1 if no candidate.
//   can_alloc[i]  — node i can run the demand right now
//   feasible[i]   — node i could run it when resources free (superset)
//   utilization[i]— node i's max-resource utilization in [0, 1]
//   prefer_idx    — local node (-1 none): taken immediately if can_alloc
//   top_k_abs / top_k_frac — k = max(abs, frac * pool_size), min 1
//   seed          — RNG seed for the top-k pick (deterministic for tests)
long long hybrid_choose(const unsigned char* feasible,
                        const unsigned char* can_alloc,
                        const double* utilization,
                        long long n,
                        long long prefer_idx,
                        long long top_k_abs,
                        double top_k_frac,
                        unsigned long long seed) {
  if (n <= 0) return -1;
  if (prefer_idx >= 0 && prefer_idx < n && can_alloc[prefer_idx] &&
      feasible[prefer_idx]) {
    return prefer_idx;
  }
  std::vector<long long> pool;
  pool.reserve(n);
  for (long long i = 0; i < n; ++i) {
    if (feasible[i] && can_alloc[i]) pool.push_back(i);
  }
  if (pool.empty()) {  // queue on a feasible node if none is free
    for (long long i = 0; i < n; ++i) {
      if (feasible[i]) pool.push_back(i);
    }
  }
  if (pool.empty()) return -1;
  std::sort(pool.begin(), pool.end(), [&](long long a, long long b) {
    if (utilization[a] != utilization[b]) return utilization[a] < utilization[b];
    return a < b;
  });
  long long k = std::max<long long>(
      top_k_abs, static_cast<long long>(pool.size() * top_k_frac));
  k = std::max<long long>(1, std::min<long long>(k, pool.size()));
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<long long> dist(0, k - 1);
  return pool[dist(rng)];
}

}  // extern "C"
