// Golden CPU reference for the ndtpso_slam engine.
//
// A clean-room, double-precision implementation of the NDT sliding-window map
// statistics, registration cost, synchronous-batch PSO, and scan-synchronous
// SLAM loop, matching the semantics of the reference library
// (/root/reference/lib/ndtpso_slam/{ndtcell.cpp,core.cpp,ndtframe.cpp}) and
// the engine's frozen Threefry draw protocol (ndtpso_slam/ops/rng.py).
//
// Purpose: parity testing (BASELINE gate: pose RMSE <= 1e-3 m / 1e-3 rad at
// identical budgets) with bit-identical random streams, at C++ speed.  This
// is deliberately a *sparse hash-grid* with raw per-slot point buffers — a
// third, independent data layout (engine: dense second moments; oracle:
// per-cell python objects) so layout bugs can't cancel out.
//
// Build: make (shared lib, C ABI, ctypes-loaded).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------- threefry
// Threefry-2x32, 20 rounds (Salmon et al., SC'11), counter mode.
struct U2 {
  uint32_t a, b;
};

inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

U2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1) {
  static const int RA[4] = {13, 15, 26, 6};
  static const int RB[4] = {17, 29, 16, 24};
  uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  for (int block = 0; block < 5; ++block) {
    const int* rot = (block % 2 == 0) ? RA : RB;
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[r]) ^ x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + static_cast<uint32_t>(block + 1);
  }
  return {x0, x1};
}

// uniform [0,1) from the high 24 bits — exactly representable in float32,
// so float32 and float64 consumers see identical reals.
inline double u01(uint32_t bits) {
  return static_cast<double>(bits >> 8) * (1.0 / 16777216.0);
}

// Draw the pair (r1, r2) for a given pair counter.
inline void draw_pair(uint32_t k0, uint32_t k1, uint32_t pair_idx, double* r1,
                      double* r2) {
  U2 v = threefry2x32(k0, k1, pair_idx, 0);
  *r1 = u01(v.a);
  *r2 = u01(v.b);
}

// ------------------------------------------------------------------- map
struct Vec2 {
  double x = 0, y = 0;
};
struct Sym2 {
  double xx = 0, xy = 0, yy = 0;
};

struct Cell {
  // Ring of per-slot partials + raw points of the open slot's window.
  std::vector<Vec2> slot_sum;
  std::vector<long> slot_count;
  std::vector<Sym2> slot_cov;
  std::vector<std::vector<Vec2>> slot_pts;
  Vec2 cur_sum;
  long cur_count = 0;
  int idx = 0;
  Vec2 g_sum;
  long g_count = 0;
  Sym2 g_cov;
  Vec2 mean;
  Sym2 inv_cov;
  bool built = false;

  explicit Cell(int slots)
      : slot_sum(slots), slot_count(slots, 0), slot_cov(slots),
        slot_pts(slots) {}

  void add(double px, double py) {
    if (cur_count == 0) slot_pts[idx].clear();
    ++cur_count;
    cur_sum.x += px;
    cur_sum.y += py;
    slot_pts[idx].push_back({px, py});
    built = false;
  }

  void build(int slots, int capacity) {
    g_sum.x += cur_sum.x - slot_sum[idx].x;
    g_sum.y += cur_sum.y - slot_sum[idx].y;
    slot_sum[idx] = cur_sum;
    g_count += cur_count - slot_count[idx];
    slot_count[idx] = cur_count;
    if (g_count > 2) {
      mean.x = g_sum.x / g_count;
      mean.y = g_sum.y / g_count;
      Sym2 cov;
      for (const Vec2& p : slot_pts[idx]) {
        double dx = p.x - mean.x, dy = p.y - mean.y;
        cov.xx += dx * dx;
        cov.xy += dx * dy;
        cov.yy += dy * dy;
      }
      g_cov.xx += cov.xx - slot_cov[idx].xx;
      g_cov.xy += cov.xy - slot_cov[idx].xy;
      g_cov.yy += cov.yy - slot_cov[idx].yy;
      slot_cov[idx] = cov;
      calc_inverse();
      built = true;
    }
    if (cur_count > capacity) {
      idx = (idx + 1) % slots;
      cur_count = 0;
      cur_sum = {0, 0};
    }
  }

  void calc_inverse() {
    double a = g_cov.xx / g_count, b = g_cov.xy / g_count,
           c = g_cov.yy / g_count;
    double half_tr = 0.5 * (a + c);
    double disc = std::sqrt(0.25 * (a - c) * (a - c) + b * b);
    double large = half_tr + disc, small = half_tr - disc;
    double det =
        (small < 1e-3 * large) ? (1e-3 * large * large) : (a * c - b * b);
    inv_cov = {c / det, -b / det, a / det};
  }

  double score(double px, double py) const {
    if (!built) return 0.0;
    double dx = px - mean.x, dy = py - mean.y;
    double q = inv_cov.xx * dx * dx + 2.0 * inv_cov.xy * dx * dy +
               inv_cov.yy * dy * dy;
    return std::exp(-0.5 * q);
  }
};

struct Map {
  double size, cell_side, half;
  int width, slots, capacity;
  std::unordered_map<long, Cell> cells;

  Map(double size_m, double cell, int s, int cap)
      : size(size_m), cell_side(cell), half(size_m / 2.0),
        width(static_cast<int>(std::ceil(size_m / cell))), slots(s),
        capacity(cap) {}

  long index(double x, double y) const {
    if (x > -half && x < half && y > -half && y < half) {
      return static_cast<long>(std::floor((x + half) / cell_side)) +
             static_cast<long>(width) *
                 static_cast<long>(std::floor((y + half) / cell_side));
    }
    return -1;
  }

  void add_point(double x, double y) {
    long i = index(x, y);
    if (i < 0) return;
    auto it = cells.find(i);
    if (it == cells.end()) it = cells.emplace(i, Cell(slots)).first;
    it->second.add(x, y);
  }

  void update(const double* pose, const double* pts, const uint8_t* valid,
              long n) {
    double c = std::cos(pose[2]), s = std::sin(pose[2]);
    for (long k = 0; k < n; ++k) {
      if (valid && !valid[k]) continue;
      double px = pts[2 * k], py = pts[2 * k + 1];
      add_point(px * c - py * s + pose[0], px * s + py * c + pose[1]);
    }
  }

  void build() {
    for (auto& kv : cells) kv.second.build(slots, capacity);
  }

  double cost(const double* pose, const double* pts, const uint8_t* valid,
              long n) const {
    double c = std::cos(pose[2]), s = std::sin(pose[2]);
    double total = 0.0;
    for (long k = 0; k < n; ++k) {
      if (valid && !valid[k]) continue;
      double px = pts[2 * k], py = pts[2 * k + 1];
      double qx = px * c - py * s + pose[0];
      double qy = px * s + py * c + pose[1];
      long i = index(qx, qy);
      if (i < 0) continue;
      auto it = cells.find(i);
      if (it != cells.end() && it->second.built) total -= it->second.score(qx, qy);
    }
    return total;
  }
};

// ------------------------------------------------------------------- pso
struct PsoCfg {
  int iterations, population;
  double w, c1, c2, w_damping;
};

constexpr double kZeroDev[3] = {1e-4, 1e-4, 1e-5};

// Synchronous-batch PSO, identical draw protocol and update rule to
// ndtpso_slam/models/pso.py (see its module docstring for the documented
// divergence from the reference's mid-iteration racy gbest).
void pso(const Map& map, const double* pts, const uint8_t* valid, long n,
         const double* guess, const double* dev, const PsoCfg& cfg,
         uint32_t k0, uint32_t k1, double* out_pose, double* out_cost) {
  const int p = cfg.population;
  std::vector<double> pos(3 * p), vel(3 * p, 0.0), pbest(3 * p);
  std::vector<double> cost(p), pbest_cost(p);

  double g_pos[3], r1, r2;
  for (int k = 0; k < 3; ++k) {
    draw_pair(k0, k1, static_cast<uint32_t>(k), &r1, &r2);
    g_pos[k] = guess[k] + (2.0 * r1 - 1.0) * kZeroDev[k];
  }
  double gbest_cost = map.cost(g_pos, pts, valid, n);
  double gbest[3] = {g_pos[0], g_pos[1], g_pos[2]};

  for (int j = 0; j < p; ++j) {
    for (int k = 0; k < 3; ++k) {
      draw_pair(k0, k1, static_cast<uint32_t>(3 + j * 3 + k), &r1, &r2);
      pos[3 * j + k] = guess[k] + (2.0 * r1 - 1.0) * dev[k];
    }
    cost[j] = map.cost(&pos[3 * j], pts, valid, n);
    pbest[3 * j] = pos[3 * j];
    pbest[3 * j + 1] = pos[3 * j + 1];
    pbest[3 * j + 2] = pos[3 * j + 2];
    pbest_cost[j] = cost[j];
  }
  // argmin (first index wins ties, like jnp.argmin)
  int bi = 0;
  for (int j = 1; j < p; ++j)
    if (cost[j] < cost[bi]) bi = j;
  if (cost[bi] < gbest_cost) {
    gbest_cost = cost[bi];
    std::memcpy(gbest, &pos[3 * bi], 3 * sizeof(double));
  }

  double w = cfg.w;
  const uint32_t base = 3 + static_cast<uint32_t>(p) * 3;
  for (int i = 0; i < cfg.iterations; ++i) {
    const uint32_t ibase = base + static_cast<uint32_t>(i) * p * 3;
    for (int j = 0; j < p; ++j) {
      for (int k = 0; k < 3; ++k) {
        draw_pair(k0, k1, ibase + static_cast<uint32_t>(j * 3 + k), &r1, &r2);
        vel[3 * j + k] = w * vel[3 * j + k] +
                         cfg.c1 * r1 * (pbest[3 * j + k] - pos[3 * j + k]) +
                         cfg.c2 * r2 * (gbest[k] - pos[3 * j + k]);
        pos[3 * j + k] += vel[3 * j + k];
      }
      cost[j] = map.cost(&pos[3 * j], pts, valid, n);
      if (cost[j] < pbest_cost[j]) {
        pbest_cost[j] = cost[j];
        std::memcpy(&pbest[3 * j], &pos[3 * j], 3 * sizeof(double));
      }
    }
    int bj = 0;
    for (int j = 1; j < p; ++j)
      if (pbest_cost[j] < pbest_cost[bj]) bj = j;
    if (pbest_cost[bj] < gbest_cost) {
      gbest_cost = pbest_cost[bj];
      std::memcpy(gbest, &pbest[3 * bj], 3 * sizeof(double));
    }
    w *= cfg.w_damping;
  }
  std::memcpy(out_pose, gbest, 3 * sizeof(double));
  *out_cost = gbest_cost;
}

}  // namespace

// ------------------------------------------------------------------ C ABI
extern "C" {

void golden_threefry(uint32_t k0, uint32_t k1, const uint32_t* c0,
                     const uint32_t* c1, long n, uint32_t* out0,
                     uint32_t* out1) {
  for (long i = 0; i < n; ++i) {
    U2 v = threefry2x32(k0, k1, c0[i], c1[i]);
    out0[i] = v.a;
    out1[i] = v.b;
  }
}

void* golden_map_new(double size_m, double cell_side, int slots,
                     int capacity) {
  return new Map(size_m, cell_side, slots, capacity);
}

void golden_map_free(void* m) { delete static_cast<Map*>(m); }

void golden_map_update(void* m, const double* pose, const double* pts,
                       const uint8_t* valid, long n) {
  static_cast<Map*>(m)->update(pose, pts, valid, n);
}

void golden_map_build(void* m) { static_cast<Map*>(m)->build(); }

// Fetch one cell's built Gaussian. Returns 1 if the cell exists and is
// built. out = {mean_x, mean_y, icov_xx, icov_xy, icov_yy}.
int golden_map_cell(void* m, long index, double* out) {
  Map* map = static_cast<Map*>(m);
  auto it = map->cells.find(index);
  if (it == map->cells.end() || !it->second.built) return 0;
  const Cell& c = it->second;
  out[0] = c.mean.x;
  out[1] = c.mean.y;
  out[2] = c.inv_cov.xx;
  out[3] = c.inv_cov.xy;
  out[4] = c.inv_cov.yy;
  return 1;
}

double golden_cost(void* m, const double* pose, const double* pts,
                   const uint8_t* valid, long n) {
  return static_cast<Map*>(m)->cost(pose, pts, valid, n);
}

void golden_pso(void* m, const double* pts, const uint8_t* valid, long n,
                const double* guess, const double* dev, int iterations,
                int population, double w, double c1, double c2,
                double w_damping, uint32_t k0, uint32_t k1, double* out_pose,
                double* out_cost) {
  PsoCfg cfg{iterations, population, w, c1, c2, w_damping};
  pso(*static_cast<Map*>(m), pts, valid, n, guess, dev, cfg, k0, k1, out_pose,
      out_cost);
}

// Full scan-synchronous SLAM loop over a recorded log, mirroring
// ndtpso_slam/models/slam.py: first scan keeps the prior pose; adaptive
// deviation = (0.1, 0.1, 3.1415e-3) for the two cold-start aligns, then
// |2 * pose_diff|; per-step key = threefry(base_key, step, 0).
void golden_slam_run(double size_m, double cell_side, int slots, int capacity,
                     const double* pts, const uint8_t* valid, long t, long n,
                     const double* init_pose, int iterations, int population,
                     double w, double c1, double c2, double w_damping,
                     uint32_t k0, uint32_t k1, double* out_poses) {
  Map map(size_m, cell_side, slots, capacity);
  PsoCfg cfg{iterations, population, w, c1, c2, w_damping};
  double pose[3] = {init_pose[0], init_pose[1], init_pose[2]};
  double prev[3] = {pose[0], pose[1], pose[2]};
  double diff[3] = {0, 0, 0};
  long align_iter = 0;
  for (long i = 0; i < t; ++i) {
    const double* spts = pts + i * n * 2;
    const uint8_t* svalid = valid + i * n;
    if (i > 0) {
      double dev[3];
      if (align_iter < 2) {
        dev[0] = 0.1;
        dev[1] = 0.1;
        dev[2] = 3.1415e-3;
      } else {
        dev[0] = std::fabs(2.0 * diff[0]);
        dev[1] = std::fabs(2.0 * diff[1]);
        dev[2] = std::fabs(2.0 * diff[2]);
      }
      U2 step_key = threefry2x32(k0, k1, static_cast<uint32_t>(i), 0);
      double cost_out;
      double result[3];
      pso(map, spts, svalid, n, pose, dev, cfg, step_key.a, step_key.b, result,
          &cost_out);
      diff[0] = result[0] - prev[0];
      diff[1] = result[1] - prev[1];
      diff[2] = result[2] - prev[2];
      prev[0] = result[0];
      prev[1] = result[1];
      prev[2] = result[2];
      ++align_iter;
      pose[0] = result[0];
      pose[1] = result[1];
      pose[2] = result[2];
    }
    map.update(pose, spts, svalid, n);
    map.build();
    std::memcpy(out_poses + i * 3, pose, 3 * sizeof(double));
  }
}

}  // extern "C"
