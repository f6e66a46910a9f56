// Native contact-counting kernel for DockQ.
//
// C++ equivalent of the reference's DockQ/src/fnat.c contact loops
// (fnat.c:105-226): enumerate inter-chain residue pairs whose any-atom
// distance is below a cutoff. Uses a uniform spatial grid (cell list) so the
// scan is O(N) instead of the reference's O(N_a * N_b) double loop — at
// 1000-pose screening scale this kernel dominates DockQ cost.
//
// C ABI (ctypes):
//   int count_contacts(const float* xyz_a, const int32_t* res_a, int n_a,
//                      const float* xyz_b, const int32_t* res_b, int n_b,
//                      float cutoff,
//                      int32_t* out_pairs /* capacity 2*max_pairs */,
//                      int max_pairs);
// Returns the number of unique (res_a, res_b) contact pairs written (may be
// > max_pairs, in which case only max_pairs were written).

#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Cell {
  std::vector<int> atoms;
};

inline int64_t cell_key(int cx, int cy, int cz) {
  return (static_cast<int64_t>(cx) << 42) ^ (static_cast<int64_t>(cy) << 21) ^
         static_cast<int64_t>(cz);
}

}  // namespace

extern "C" {

int count_contacts(const float* xyz_a, const int32_t* res_a, int n_a,
                   const float* xyz_b, const int32_t* res_b, int n_b,
                   float cutoff, int32_t* out_pairs, int max_pairs) {
  const float cut2 = cutoff * cutoff;
  const float inv_cell = 1.0f / cutoff;

  // Bin the B atoms into a uniform grid of cell size == cutoff.
  std::unordered_map<int64_t, Cell> grid;
  grid.reserve(static_cast<size_t>(n_b));
  for (int j = 0; j < n_b; ++j) {
    const int cx = static_cast<int>(std::floor(xyz_b[3 * j + 0] * inv_cell));
    const int cy = static_cast<int>(std::floor(xyz_b[3 * j + 1] * inv_cell));
    const int cz = static_cast<int>(std::floor(xyz_b[3 * j + 2] * inv_cell));
    grid[cell_key(cx, cy, cz)].atoms.push_back(j);
  }

  std::unordered_set<int64_t> seen;
  int written = 0;
  int total = 0;

  for (int i = 0; i < n_a; ++i) {
    const float ax = xyz_a[3 * i + 0];
    const float ay = xyz_a[3 * i + 1];
    const float az = xyz_a[3 * i + 2];
    const int cx = static_cast<int>(std::floor(ax * inv_cell));
    const int cy = static_cast<int>(std::floor(ay * inv_cell));
    const int cz = static_cast<int>(std::floor(az * inv_cell));
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          auto it = grid.find(cell_key(cx + dx, cy + dy, cz + dz));
          if (it == grid.end()) continue;
          for (int j : it->second.atoms) {
            const float bx = xyz_b[3 * j + 0] - ax;
            const float by = xyz_b[3 * j + 1] - ay;
            const float bz = xyz_b[3 * j + 2] - az;
            if (bx * bx + by * by + bz * bz >= cut2) continue;
            const int64_t pair =
                (static_cast<int64_t>(res_a[i]) << 32) |
                static_cast<uint32_t>(res_b[j]);
            if (!seen.insert(pair).second) continue;
            if (written < max_pairs) {
              out_pairs[2 * written + 0] = res_a[i];
              out_pairs[2 * written + 1] = res_b[j];
              ++written;
            }
            ++total;
          }
        }
  }
  return total;
}

}  // extern "C"
