// S2PG edge builder: one event's lineage-graph edges.
//
// The same algorithm as build_event_edges and nearest_recorded_ancestors in
// data/graph.py (the numpy builders, its plain version), through a C ABI
// for ctypes:
//
// - temporal edges chain each particle's steps in time order
// - parent edges connect all of a child's earliest steps to all of each
//   nearest *recorded* ancestor's time-closest steps
// - the BFS memo cache reproduces the reference's side effects (cache
//   consultation for unrecorded ancestors, cache seeding for single-parent
//   children of found ancestors), which can emit duplicate edges: kept
// - all edges are emitted bidirectionally; the in-degree checks return
//   negative codes instead of asserting
//
// Built by native/host.py with g++ -O2 -shared -fPIC -std=c++17.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <deque>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" {

// Returns the number of directed edges written (bidirectional pairs occupy
// 2 slots each in out_src/out_dst), or:
//   -1  capacity exceeded (call again with a larger cap)
//   -2  incident node has parents
//   -3  unconnected non-incident nodes exist
int64_t build_event_edges(
    int64_t n_steps,
    const int64_t* pids,
    const double* times,
    const int64_t* step_keys,
    int64_t n_parent_rows,
    const int64_t* child_ids,
    const int64_t* parent_ids,
    int64_t* out_src,
    int64_t* out_dst,
    int64_t cap,
    int64_t* out_parentless,   // capacity >= number of unique pids
    int64_t* n_parentless) {
  // parent_map with insertion order preserved (Python dict semantics)
  std::unordered_map<int64_t, std::vector<int64_t>> parent_map;
  std::vector<int64_t> parent_map_order;
  parent_map.reserve(n_parent_rows * 2);
  for (int64_t i = 0; i < n_parent_rows; ++i) {
    auto it = parent_map.find(child_ids[i]);
    if (it == parent_map.end()) {
      parent_map_order.push_back(child_ids[i]);
      parent_map[child_ids[i]] = {parent_ids[i]};
    } else {
      it->second.push_back(parent_ids[i]);
    }
  }

  // unique pids ascending (np.unique) + per-pid step indices in array order
  std::vector<int64_t> unique_pids;
  std::unordered_map<int64_t, std::vector<int64_t>> indices_map;
  for (int64_t i = 0; i < n_steps; ++i) {
    auto it = indices_map.find(pids[i]);
    if (it == indices_map.end()) {
      unique_pids.push_back(pids[i]);
      indices_map[pids[i]] = {i};
    } else {
      it->second.push_back(i);
    }
  }
  std::sort(unique_pids.begin(), unique_pids.end());
  std::unordered_set<int64_t> recorded(unique_pids.begin(), unique_pids.end());

  std::unordered_map<int64_t, std::vector<int64_t>> cache;
  std::vector<std::pair<int64_t, int64_t>> edges_time, edges_parent;
  *n_parentless = 0;

  for (int64_t child_pid : unique_pids) {
    const auto& child_idxs = indices_map[child_pid];

    // temporal chain: stable sort by time (matches np.argsort on the short
    // per-particle chains; ties keep array order)
    std::vector<int64_t> order(child_idxs);
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return times[a] < times[b];
    });
    for (size_t k = 0; k + 1 < order.size(); ++k) {
      edges_time.emplace_back(step_keys[order[k]], step_keys[order[k + 1]]);
    }

    // nearest recorded ancestors (BFS with the reference's memo semantics)
    std::vector<int64_t> collected;
    auto cached = cache.find(child_pid);
    if (cached != cache.end()) {
      collected = cached->second;
    } else {
      std::unordered_set<int64_t> visited;
      std::deque<int64_t> queue;
      auto pm = parent_map.find(child_pid);
      if (pm != parent_map.end())
        queue.assign(pm->second.begin(), pm->second.end());

      while (!queue.empty()) {
        int64_t cur = queue.front();
        queue.pop_front();
        if (visited.count(cur)) continue;
        visited.insert(cur);

        if (!recorded.count(cur)) {
          auto c = cache.find(cur);
          if (c != cache.end()) {
            collected.insert(collected.end(), c->second.begin(), c->second.end());
          } else {
            auto p = parent_map.find(cur);
            if (p != parent_map.end())
              queue.insert(queue.end(), p->second.begin(), p->second.end());
          }
        } else {
          collected.push_back(cur);
          // the reference's side effect: seed the cache for every
          // single-parent child of the found ancestor
          for (int64_t child : parent_map_order) {
            const auto& parents = parent_map[child];
            if (parents.size() == 1 && parents[0] == cur && !cache.count(child)) {
              cache[child] = {cur};
            }
          }
        }
      }
      if (!collected.empty()) cache[child_pid] = collected;
    }

    if (collected.empty()) {
      if (child_pid != 0) out_parentless[(*n_parentless)++] = child_pid;
      continue;
    }

    // child's earliest-time steps
    double min_time = times[child_idxs[0]];
    for (int64_t i : child_idxs) min_time = std::min(min_time, times[i]);
    std::vector<int64_t> child_targets;
    for (int64_t i : child_idxs)
      if (times[i] == min_time) child_targets.push_back(step_keys[i]);

    for (int64_t parent_pid : collected) {
      const auto& cand = indices_map[parent_pid];
      double best = -1.0;
      for (int64_t i : cand) {
        double d = std::abs(times[i] - min_time);
        if (best < 0 || d < best) best = d;
      }
      std::vector<int64_t> parent_sources;
      for (int64_t i : cand)
        if (std::abs(times[i] - min_time) == best)
          parent_sources.push_back(step_keys[i]);
      for (int64_t t : child_targets)
        for (int64_t s : parent_sources) edges_parent.emplace_back(s, t);
    }
  }

  const int64_t n_directed =
      (int64_t)(edges_time.size() + edges_parent.size());
  if (2 * n_directed > cap) return -1;

  const int64_t incident_key = step_keys[n_steps - 1];
  std::vector<int64_t> in_degree(incident_key + 1, 0);
  int64_t w = 0;
  for (const auto& bucket : {edges_time, edges_parent}) {
    for (const auto& e : bucket) {
      out_src[w] = e.first;
      out_dst[w] = e.second;
      ++w;
      out_src[w] = e.second;
      out_dst[w] = e.first;
      ++w;
      in_degree[e.second] += 1;
    }
  }
  if (in_degree[incident_key] != 0) return -2;
  for (int64_t k = 0; k < incident_key; ++k)
    if (in_degree[k] == 0) return -3;
  return 2 * n_directed;
}

}  // extern "C"
