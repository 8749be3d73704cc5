// Native host-side kernels for the PhysDock PyTorch port (a copy of the
// JAX package's library; host code, no device work).
//
// The reference delegates its native-speed work to external C++ (RDKit,
// OpenMM, hmmer binaries).  Here the framework's own host hot loops are
// native: MSA text -> int8 featurization (10-50k rows per chain), pairwise
// pose RMSD matrices (ranking), conformer distance banks, and distance-based
// bond perception.  Exposed via a C ABI consumed with ctypes
// (physdock_tpu_torch/native/__init__.py), which builds it with g++ at first
// use; its NumPy versions there are the plain references for the tests.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 -Wall (no -march=native: the
// library may be loaded on another host than the one that built it)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cctype>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// A3M parsing
// ---------------------------------------------------------------------------
// Restype alphabet: 32 classes; amino-acid index table for 'A'..'Z'
// (order: ALA ARG ASN ASP CYS GLN GLU GLY HIS ILE LEU LYS MET PHE PRO SER
//  THR TRP TYR VAL UNK ... GAP=31), matching
// physdock_tpu_torch/data/constants/restypes.py.
static const int8_t AA_ORDER[26] = {
    /*A*/ 0,  /*B*/ 20, /*C*/ 4,  /*D*/ 3,  /*E*/ 6,  /*F*/ 13, /*G*/ 7,
    /*H*/ 8,  /*I*/ 9,  /*J*/ 20, /*K*/ 11, /*L*/ 10, /*M*/ 12, /*N*/ 2,
    /*O*/ 20, /*P*/ 14, /*Q*/ 5,  /*R*/ 1,  /*S*/ 15, /*T*/ 16, /*U*/ 4,
    /*V*/ 19, /*W*/ 17, /*X*/ 20, /*Y*/ 18, /*Z*/ 20};

static inline int8_t aa_index(char c) {
  if (c >= 'A' && c <= 'Z') return AA_ORDER[c - 'A'];
  return 31;  // gap / unknown
}

// First pass: number of sequences and query length (uppercase+gap columns
// of the first sequence).  Returns 0 on success.
int a3m_dims(const char* text, int64_t* n_rows, int64_t* n_cols) {
  int64_t rows = 0, cols = 0;
  bool in_first_seq = false, counted = false;
  for (const char* p = text; *p; ++p) {
    if (*p == '>') {
      rows++;
      if (rows == 1) in_first_seq = true;
      else { in_first_seq = false; counted = true; }
      while (*p && *p != '\n') ++p;
      if (!*p) break;
    } else if (in_first_seq && !counted) {
      char c = *p;
      if (c == '-' || c == '.' || (c >= 'A' && c <= 'Z')) cols++;
    }
  }
  *n_rows = rows;
  *n_cols = cols;
  return 0;
}

// Second pass: fill msa[rows, cols] and deletions[rows, cols] (int8).
// Lowercase letters count as deletions before the next aligned column.
int a3m_parse(const char* text, int64_t rows, int64_t cols, int8_t* msa,
              int8_t* deletions) {
  memset(msa, 31, rows * cols);
  memset(deletions, 0, rows * cols);
  int64_t row = -1, col = 0;
  int del = 0;
  bool in_header = false;
  for (const char* p = text; *p; ++p) {
    char c = *p;
    if (c == '>') {
      row++;
      col = 0;
      del = 0;
      in_header = true;
      continue;
    }
    if (c == '\n') { in_header = false; continue; }
    if (in_header || row < 0) continue;
    if (c >= 'a' && c <= 'z') { del++; continue; }
    if (c == '-' || c == '.' || (c >= 'A' && c <= 'Z')) {
      if (col < cols && row < rows) {
        msa[row * cols + col] = (c == '-' || c == '.') ? 31 : aa_index(c);
        deletions[row * cols + col] =
            (int8_t)std::min(del, 127);
      }
      del = 0;
      col++;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Pose geometry
// ---------------------------------------------------------------------------

// Pairwise RMSD matrix of S poses with L atoms: out[S*S].
void pairwise_rmsd(const float* poses, int64_t S, int64_t L, float* out) {
  for (int64_t a = 0; a < S; ++a) {
    out[a * S + a] = 0.f;
    for (int64_t b = a + 1; b < S; ++b) {
      const float* pa = poses + a * L * 3;
      const float* pb = poses + b * L * 3;
      double acc = 0.0;
      for (int64_t i = 0; i < L * 3; ++i) {
        double d = (double)pa[i] - (double)pb[i];
        acc += d * d;
      }
      float r = (float)std::sqrt(acc / (double)L);
      out[a * S + b] = r;
      out[b * S + a] = r;
    }
  }
}

// Batched intra-conformer distance matrices: confs[C, L, 3] -> out[C, L, L].
void conformer_dist_bank(const float* confs, int64_t C, int64_t L,
                         float* out) {
  for (int64_t c = 0; c < C; ++c) {
    const float* x = confs + c * L * 3;
    float* o = out + c * L * L;
    for (int64_t i = 0; i < L; ++i) {
      o[i * L + i] = 0.f;
      for (int64_t j = i + 1; j < L; ++j) {
        float dx = x[i * 3] - x[j * 3];
        float dy = x[i * 3 + 1] - x[j * 3 + 1];
        float dz = x[i * 3 + 2] - x[j * 3 + 2];
        float d = std::sqrt(dx * dx + dy * dy + dz * dz);
        o[i * L + j] = d;
        o[j * L + i] = d;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Bond perception (distance-based): bond if d < scale*(rcov_i + rcov_j).
// atomic_numbers[n]; out_bonds has capacity max_bonds pairs; returns count.
// ---------------------------------------------------------------------------
static float cov_radius(int z) {
  switch (z) {
    case 1: return 0.31f; case 5: return 0.84f; case 6: return 0.76f;
    case 7: return 0.71f; case 8: return 0.66f; case 9: return 0.57f;
    case 14: return 1.11f; case 15: return 1.07f; case 16: return 1.05f;
    case 17: return 1.02f; case 35: return 1.20f; case 53: return 1.39f;
    default: return 1.2f;
  }
}

int64_t perceive_bonds(const float* pos, const int32_t* z, int64_t n,
                       float scale, int32_t* out_bonds, int64_t max_bonds) {
  int64_t count = 0;
  for (int64_t i = 0; i < n && count < max_bonds; ++i) {
    for (int64_t j = i + 1; j < n && count < max_bonds; ++j) {
      float dx = pos[i * 3] - pos[j * 3];
      float dy = pos[i * 3 + 1] - pos[j * 3 + 1];
      float dz = pos[i * 3 + 2] - pos[j * 3 + 2];
      float d2 = dx * dx + dy * dy + dz * dz;
      float rmax = scale * (cov_radius(z[i]) + cov_radius(z[j]));
      if (d2 < rmax * rmax && d2 > 0.25f) {
        out_bonds[count * 2] = (int32_t)i;
        out_bonds[count * 2 + 1] = (int32_t)j;
        count++;
      }
    }
  }
  return count;
}

// ---------------------------------------------------------------------------
// Spatial-crop neighbour ordering: argsort of distances to a centre.
// ---------------------------------------------------------------------------
void argsort_dist(const float* points, int64_t n, const float* centre,
                  int32_t* order) {
  std::vector<std::pair<float, int32_t>> d(n);
  for (int64_t i = 0; i < n; ++i) {
    float dx = points[i * 3] - centre[0];
    float dy = points[i * 3 + 1] - centre[1];
    float dz = points[i * 3 + 2] - centre[2];
    d[i] = {dx * dx + dy * dy + dz * dz, (int32_t)i};
  }
  std::sort(d.begin(), d.end());
  for (int64_t i = 0; i < n; ++i) order[i] = d[i].second;
}

}  // extern "C"
