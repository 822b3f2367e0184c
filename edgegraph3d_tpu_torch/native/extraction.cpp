// Native PLG extraction: edge image -> simplified polyline chains.
//
// C++ twin of edgegraph3d_tpu/plgs/extraction.py for the host-side
// preprocessing path (the reference's extraction is C++ too:
// src/edgegraph3d/io/input/convert_edge_images_pixel_to_segment.cpp).
// Stage semantics match the Python implementation:
//   1. useless-corner cleanup (sequential row-major scan, which is the
//      reference's exact order, :294-343)
//   2. 8-connectivity adjacency with redundant-diagonal suppression
//   3. chain tracing between non-degree-2 nodes (+ cycles)
//   4. merge across 2-incidence endpoints, Douglas-Peucker simplify
//      (tol 1 px), bridge close extremes (<= 6 px, no crossing),
//      split loops
// Exposed through a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <unordered_map>
#include <vector>

namespace {

struct P2 {
  float x, y;
};

inline int64_t key_of(float x, float y) {
  // endpoint quantization at 0.25 px, matching the Python node dedup
  return (int64_t)(std::llround(x * 4.0f)) * 1000003 +
         (int64_t)(std::llround(y * 4.0f));
}

// ---------------------------------------------------------------- stage 1
// EXACT reference semantics: ONE sequential row-major scan over the
// mutating mask, clearing redundant L-corner pixels in place so later
// pixels see the cleared state — identical to extraction.py::
// remove_useless_corners and to the reference's
// convertEdgeImagesPixelToNodesNoSquaresNoTriangles_remove_useless_hubs
// (convert_edge_images_pixel_to_segment.cpp:294-343), including its
// `i > 1` / `j > 1` bound guards.
void clean_corners(std::vector<uint8_t>& m, int H, int W) {
  auto at = [&](int i, int j) -> bool {
    return i >= 0 && i < H && j >= 0 && j < W && m[(size_t)i * W + j];
  };
  for (int i = 0; i < H; i++)
    for (int j = 0; j < W; j++) {
      if (!m[(size_t)i * W + j]) continue;
      bool N = at(i - 1, j), S = at(i + 1, j), Wn = at(i, j - 1),
           E = at(i, j + 1);
      bool NE = at(i - 1, j + 1), NW = at(i - 1, j - 1),
           SE = at(i + 1, j + 1), SW = at(i + 1, j - 1);
      if ((i > 1 && j > 1 && N && Wn && !SE) ||
          (i > 1 && j < W - 1 && N && E && !SW) ||
          (i < H - 1 && j < W - 1 && S && E && !NW) ||
          (i < H - 1 && j > 1 && S && Wn && !NE))
        m[(size_t)i * W + j] = 0;
    }
}

// ---------------------------------------------------------------- stage 2+3
struct Graph {
  std::vector<P2> xy;
  std::vector<std::vector<int>> adj;
};

// EXACT reference NoCycles semantics (convertEdgeImagePixelToGraph_
// NoCycles, convert_edge_images_pixel_to_segment.cpp:347-426): forward
// neighbors C1=E, C2=S, C3=SE, C4=SW (the SW case only for j > 1; the
// last row/column never act as P), adding an edge only if the pixels
// are not already connected within `loop_check_dist` hops (bounded
// BFS, is_connected(a, b, LOOP_CHECK_DIST=8)).
bool connected_within(const Graph& g, int a, int b, int maxhops,
                      std::vector<int>& stamp, int tick,
                      std::vector<std::pair<int, int>>& queue) {
  if (maxhops <= 0) return a == b;
  queue.clear();
  queue.push_back({a, 0});
  stamp[a] = tick;
  for (size_t qi = 0; qi < queue.size(); qi++) {
    int u = queue[qi].first, d = queue[qi].second;
    if (d >= maxhops) continue;
    for (int v : g.adj[u]) {
      if (v == b) return true;
      if (stamp[v] != tick) {
        stamp[v] = tick;
        queue.push_back({v, d + 1});
      }
    }
  }
  return false;
}

Graph build_graph(const std::vector<uint8_t>& m, int H, int W,
                  int loop_check_dist) {
  Graph g;
  std::vector<int> id((size_t)H * W, -1);
  for (int i = 0; i < H; i++)
    for (int j = 0; j < W; j++)
      if (m[(size_t)i * W + j]) {
        id[(size_t)i * W + j] = (int)g.xy.size();
        g.xy.push_back({j + 0.5f, i + 0.5f});
      }
  g.adj.resize(g.xy.size());
  std::vector<int> stamp(g.xy.size(), -1);
  std::vector<std::pair<int, int>> queue;
  int tick = 0;
  auto try_link = [&](int u, int v) {
    if (u != v && !connected_within(g, u, v, loop_check_dist, stamp,
                                    ++tick, queue)) {
      g.adj[u].push_back(v);
      g.adj[v].push_back(u);
    }
  };
  for (int i = 0; i < H - 1; i++)
    for (int j = 0; j < W - 1; j++) {
      if (!m[(size_t)i * W + j]) continue;
      int u = id[(size_t)i * W + j];
      if (m[(size_t)i * W + j + 1]) try_link(u, id[(size_t)i * W + j + 1]);
      if (m[(size_t)(i + 1) * W + j])
        try_link(u, id[(size_t)(i + 1) * W + j]);
      if (m[(size_t)(i + 1) * W + j + 1])
        try_link(u, id[(size_t)(i + 1) * W + j + 1]);
      if (j > 1 && m[(size_t)(i + 1) * W + j - 1])
        try_link(u, id[(size_t)(i + 1) * W + j - 1]);
    }
  return g;
}

using Chain = std::vector<P2>;

std::vector<Chain> trace_chains(const Graph& g) {
  const size_t n = g.xy.size();
  std::vector<Chain> out;
  // walk from every non-degree-2 node along each incident edge
  std::vector<std::vector<uint8_t>> used(n);
  for (size_t i = 0; i < n; i++) used[i].assign(g.adj[i].size(), 0);

  auto edge_slot = [&](int u, int v) -> int {
    for (size_t k = 0; k < g.adj[u].size(); k++)
      if (g.adj[u][k] == v && !used[u][k]) return (int)k;
    return -1;
  };
  auto walk = [&](int start, int slot) {
    Chain c;
    c.push_back(g.xy[start]);
    int prev = start;
    int cur = g.adj[start][slot];
    used[start][slot] = 1;
    int back = edge_slot(cur, prev);
    if (back >= 0) used[cur][back] = 1;
    while (true) {
      c.push_back(g.xy[cur]);
      if (g.adj[cur].size() != 2) break;
      int nxt = (g.adj[cur][0] == prev) ? g.adj[cur][1] : g.adj[cur][0];
      int s = edge_slot(cur, nxt);
      if (s < 0) break;  // edge already consumed (loop closure)
      used[cur][s] = 1;
      int b = edge_slot(nxt, cur);
      if (b >= 0) used[nxt][b] = 1;
      prev = cur;
      cur = nxt;
    }
    return c;
  };

  for (size_t i = 0; i < n; i++) {
    if (g.adj[i].size() == 2) continue;
    for (size_t k = 0; k < g.adj[i].size(); k++)
      if (!used[i][k]) out.push_back(walk((int)i, (int)k));
  }
  // remaining unused edges belong to pure cycles
  for (size_t i = 0; i < n; i++) {
    for (size_t k = 0; k < g.adj[i].size(); k++)
      if (!used[i][k]) out.push_back(walk((int)i, (int)k));
  }
  return out;
}

// ---------------------------------------------------------------- stage 4
void simplify_dp(const Chain& in, float tol, Chain& out) {
  const int n = (int)in.size();
  if (n <= 2) {
    out = in;
    return;
  }
  std::vector<uint8_t> keep(n, 0);
  keep[0] = keep[n - 1] = 1;
  std::vector<std::pair<int, int>> stack{{0, n - 1}};
  const float tol2 = tol * tol;
  while (!stack.empty()) {
    auto [a, b] = stack.back();
    stack.pop_back();
    if (b - a < 2) continue;
    float sx = in[b].x - in[a].x, sy = in[b].y - in[a].y;
    float L2 = sx * sx + sy * sy;
    float dmax = -1;
    int imax = -1;
    for (int i = a + 1; i < b; i++) {
      float px = in[i].x - in[a].x, py = in[i].y - in[a].y;
      float d2;
      if (L2 < 1e-12f) {
        d2 = px * px + py * py;
      } else {
        float t = (px * sx + py * sy) / L2;
        t = t < 0 ? 0 : (t > 1 ? 1 : t);
        float dx = px - t * sx, dy = py - t * sy;
        d2 = dx * dx + dy * dy;
      }
      if (d2 > dmax) {
        dmax = d2;
        imax = i;
      }
    }
    if (dmax > tol2) {
      keep[imax] = 1;
      stack.push_back({a, imax});
      stack.push_back({imax, b});
    }
  }
  out.clear();
  for (int i = 0; i < n; i++)
    if (keep[i]) out.push_back(in[i]);
}

std::vector<Chain> merge_degree2(std::vector<Chain> chains) {
  // endpoint-key -> incidences (chain, end)
  std::unordered_map<int64_t, std::vector<std::pair<int, int>>> inc;
  for (int i = 0; i < (int)chains.size(); i++) {
    inc[key_of(chains[i].front().x, chains[i].front().y)].push_back({i, 0});
    inc[key_of(chains[i].back().x, chains[i].back().y)].push_back({i, 1});
  }
  // link across pure 2-incidence nodes
  std::unordered_map<int64_t, std::pair<int, int>> link;  // (chain,end) code
  auto code = [](int c, int e) { return (int64_t)c * 2 + e; };
  std::unordered_map<int64_t, int64_t> nxt;
  for (auto& [k, v] : inc)
    if (v.size() == 2 && v[0].first != v[1].first) {
      nxt[code(v[0].first, v[0].second)] = code(v[1].first, v[1].second);
      nxt[code(v[1].first, v[1].second)] = code(v[0].first, v[0].second);
    }
  (void)link;
  std::vector<uint8_t> visited(chains.size(), 0);
  std::vector<Chain> out;
  for (int i = 0; i < (int)chains.size(); i++) {
    if (visited[i]) continue;
    // find a free end
    int start_chain = i, start_out_end = 1;
    for (int e = 0; e < 2; e++)
      if (!nxt.count(code(i, e))) {
        start_out_end = 1 - e;
        break;
      }
    Chain merged;
    int cur = start_chain, out_end = start_out_end;
    while (true) {
      visited[cur] = 1;
      Chain piece = chains[cur];
      if (out_end == 0) std::reverse(piece.begin(), piece.end());
      if (merged.empty())
        merged = piece;
      else
        merged.insert(merged.end(), piece.begin() + 1, piece.end());
      auto it = nxt.find(code(cur, out_end));
      if (it == nxt.end()) break;
      int nc = (int)(it->second / 2), ne = (int)(it->second % 2);
      if (visited[nc]) break;
      cur = nc;
      out_end = 1 - ne;
    }
    out.push_back(std::move(merged));
  }
  return out;
}

inline float cross2(float ax, float ay, float bx, float by) {
  return ax * by - ay * bx;
}

bool segments_cross(P2 p1, P2 p2, P2 q1, P2 q2) {
  float d1 = cross2(p2.x - p1.x, p2.y - p1.y, q1.x - p1.x, q1.y - p1.y);
  float d2 = cross2(p2.x - p1.x, p2.y - p1.y, q2.x - p1.x, q2.y - p1.y);
  float d3 = cross2(q2.x - q1.x, q2.y - q1.y, p1.x - q1.x, p1.y - q1.y);
  float d4 = cross2(q2.x - q1.x, q2.y - q1.y, p2.x - q1.x, p2.y - q1.y);
  return ((d1 > 0) != (d2 > 0)) && ((d3 > 0) != (d4 > 0));
}

void connect_extremes(std::vector<Chain>& chains, float max_dist) {
  // components via endpoint keys
  std::unordered_map<int64_t, std::vector<std::pair<int, int>>> inc;
  for (int i = 0; i < (int)chains.size(); i++) {
    inc[key_of(chains[i].front().x, chains[i].front().y)].push_back({i, 0});
    inc[key_of(chains[i].back().x, chains[i].back().y)].push_back({i, 1});
  }
  std::vector<int> comp(chains.size());
  for (size_t i = 0; i < comp.size(); i++) comp[i] = (int)i;
  std::function<int(int)> find = [&](int x) {
    while (comp[x] != x) x = comp[x] = comp[comp[x]];
    return x;
  };
  for (auto& [k, v] : inc)
    for (size_t j = 1; j < v.size(); j++) {
      int a = find(v[0].first), b = find(v[j].first);
      if (a != b) comp[b] = a;
    }
  // extremes (1-incidence endpoints)
  struct Ext {
    P2 p;
    int chain;
  };
  std::vector<Ext> ex;
  for (auto& [k, v] : inc)
    if (v.size() == 1) {
      auto [c, e] = v[0];
      ex.push_back({e == 0 ? chains[c].front() : chains[c].back(), c});
    }
  // spatial hash of segments for crossing tests
  const float cell = max_dist > 1e-6f ? max_dist : 1.0f;
  std::unordered_map<int64_t, std::vector<std::pair<P2, P2>>> segs;
  auto cellkey = [&](float x, float y) {
    return (int64_t)std::floor(x / cell) * 2000003 +
           (int64_t)std::floor(y / cell);
  };
  for (auto& c : chains)
    for (size_t k = 0; k + 1 < c.size(); k++) {
      int gx0 = (int)std::floor(std::fmin(c[k].x, c[k + 1].x) / cell);
      int gx1 = (int)std::floor(std::fmax(c[k].x, c[k + 1].x) / cell);
      int gy0 = (int)std::floor(std::fmin(c[k].y, c[k + 1].y) / cell);
      int gy1 = (int)std::floor(std::fmax(c[k].y, c[k + 1].y) / cell);
      for (int gx = gx0; gx <= gx1; gx++)
        for (int gy = gy0; gy <= gy1; gy++)
          segs[(int64_t)gx * 2000003 + gy].push_back({c[k], c[k + 1]});
    }
  // candidate extreme pairs via hash buckets; greedy by distance
  struct Cand {
    float d2;
    int a, b;
  };
  std::vector<Cand> cands;
  std::unordered_map<int64_t, std::vector<int>> exbuckets;
  for (int i = 0; i < (int)ex.size(); i++)
    exbuckets[cellkey(ex[i].p.x, ex[i].p.y)].push_back(i);
  for (int i = 0; i < (int)ex.size(); i++) {
    int gx = (int)std::floor(ex[i].p.x / cell);
    int gy = (int)std::floor(ex[i].p.y / cell);
    for (int dx = -1; dx <= 1; dx++)
      for (int dy = -1; dy <= 1; dy++) {
        auto it = exbuckets.find((int64_t)(gx + dx) * 2000003 + (gy + dy));
        if (it == exbuckets.end()) continue;
        for (int j : it->second) {
          if (j <= i) continue;
          if (find(ex[i].chain) == find(ex[j].chain)) continue;
          float ddx = ex[i].p.x - ex[j].p.x, ddy = ex[i].p.y - ex[j].p.y;
          float d2 = ddx * ddx + ddy * ddy;
          if (d2 <= max_dist * max_dist) cands.push_back({d2, i, j});
        }
      }
  }
  std::sort(cands.begin(), cands.end(),
            [](const Cand& a, const Cand& b) { return a.d2 < b.d2; });
  for (auto& c : cands) {
    int ra = find(ex[c.a].chain), rb = find(ex[c.b].chain);
    if (ra == rb) continue;
    P2 p1 = ex[c.a].p, p2 = ex[c.b].p;
    bool crossing = false;
    int gx0 = (int)std::floor(std::fmin(p1.x, p2.x) / cell) - 1;
    int gx1 = (int)std::floor(std::fmax(p1.x, p2.x) / cell) + 1;
    int gy0 = (int)std::floor(std::fmin(p1.y, p2.y) / cell) - 1;
    int gy1 = (int)std::floor(std::fmax(p1.y, p2.y) / cell) + 1;
    for (int gx = gx0; gx <= gx1 && !crossing; gx++)
      for (int gy = gy0; gy <= gy1 && !crossing; gy++) {
        auto it = segs.find((int64_t)gx * 2000003 + gy);
        if (it == segs.end()) continue;
        for (auto& s : it->second)
          if (segments_cross(p1, p2, s.first, s.second)) {
            crossing = true;
            break;
          }
      }
    if (crossing) continue;
    chains.push_back({p1, p2});
    comp.push_back((int)comp.size());
    comp[std::max(ra, rb)] = std::min(ra, rb);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success.  Outputs: packed chain coords + per-chain
// offsets (n_chains+1 entries).
int eg3d_extract_chains(const uint8_t* mask_in, int H, int W,
                        float simplify_tol, float connect_max_dist,
                        int degenerate_loop_min, int split_loop_min,
                        int loop_check_dist,
                        float* out_coords, int64_t max_coords,
                        int64_t* out_offsets, int64_t max_chains,
                        int64_t* n_chains_out, int64_t* n_coords_out) {
  std::vector<uint8_t> m(mask_in, mask_in + (size_t)H * W);
  clean_corners(m, H, W);
  Graph g = build_graph(m, H, W, loop_check_dist);
  std::vector<Chain> chains = trace_chains(g);

  // remove invalid + degenerate loops
  std::vector<Chain> kept;
  for (auto& c : chains) {
    if ((int)c.size() < 2) continue;
    bool loop = std::fabs(c.front().x - c.back().x) < 1e-4f &&
                std::fabs(c.front().y - c.back().y) < 1e-4f;
    if (loop && (int)c.size() < degenerate_loop_min) continue;
    kept.push_back(std::move(c));
  }
  kept = merge_degree2(std::move(kept));
  for (auto& c : kept) {
    Chain s;
    simplify_dp(c, simplify_tol, s);
    c = std::move(s);
  }
  connect_extremes(kept, connect_max_dist);
  // split loops
  std::vector<Chain> final_chains;
  for (auto& c : kept) {
    bool loop = std::fabs(c.front().x - c.back().x) < 1e-4f &&
                std::fabs(c.front().y - c.back().y) < 1e-4f;
    if (loop && (int)c.size() >= split_loop_min) {
      size_t mid = c.size() / 2;
      final_chains.emplace_back(c.begin(), c.begin() + mid + 1);
      final_chains.emplace_back(c.begin() + mid, c.end());
    } else {
      final_chains.push_back(std::move(c));
    }
  }

  int64_t total = 0;
  int64_t nch = 0;
  for (auto& c : final_chains) {
    if ((int)c.size() < 2) continue;
    if (nch >= max_chains || total + (int64_t)c.size() > max_coords) break;
    out_offsets[nch] = total;
    for (auto& p : c) {
      out_coords[2 * total] = p.x;
      out_coords[2 * total + 1] = p.y;
      total++;
    }
    nch++;
  }
  out_offsets[nch] = total;
  *n_chains_out = nch;
  *n_coords_out = total;
  return 0;
}
}
