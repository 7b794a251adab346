// Native prioritized-replay sum tree of the PyTorch port (a copy of
// `prob_mbrl_tpu/native/sum_tree.cpp`, host code, built by
// `prob_mbrl_tpu_torch/native/__init__.py`).
//
// C++ runtime counterpart of the Python SumTree
// (`prob_mbrl_tpu_torch/utils/experience.py`, reference:
// `prob_mbrl/utils/experience_dataset.py:271-367`). The tree math — the
// O(log N) per-update bubble-up and the O(B log N) batched stratified
// retrieval — runs natively; sample payloads stay on the Python side keyed by
// leaf index. Exposed through a C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 sum_tree.cpp -o libsumtree.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct SumTree {
  int64_t max_size;
  std::vector<double> tree;    // 2 * max_size - 1 nodes, leaves at the tail
  std::vector<double> counts;  // per-leaf visit counts
  int64_t idx = 0;             // next write position (ring)
  int64_t size = 0;
  double max_p = 1.0;
  double max_count = 0.0;
  double norm_factor = 1.0;
  std::mt19937_64 rng;

  explicit SumTree(int64_t n, uint64_t seed)
      : max_size(n), tree(2 * n - 1, 0.0), counts(n, 0.0), rng(seed) {}

  void update(int64_t tree_idx, double priority) {
    tree[tree_idx] = priority * norm_factor;
    int64_t i = tree_idx;
    while (i != 0) {
      int64_t parent = (i - 1) / 2;
      int64_t left = 2 * parent + 1;
      tree[parent] = tree[left] + tree[left + 1];
      i = parent;
    }
    max_p = std::max(max_p, priority);
  }

  int64_t append(double priority) {
    int64_t at = idx;
    counts[at] = 1.0;
    update(at + max_size - 1, priority);
    idx = (idx + 1) % max_size;
    size = std::min(size + 1, max_size);
    return at;
  }

  void renormalize() {
    double total = tree[0];
    if (total > 0) {
      double nf = 1.0 / total;
      norm_factor *= nf;
      for (auto& v : tree) v *= nf;
    }
  }

  int64_t retrieve(double p) const {
    int64_t n_nodes = static_cast<int64_t>(tree.size());
    int64_t i = 0;
    while (true) {
      int64_t left = 2 * i + 1;
      if (left >= n_nodes) return i;
      if (p <= tree[left]) {
        i = left;
      } else {
        p -= tree[left];
        i = left + 1;
      }
    }
  }
};

}  // namespace

extern "C" {

void* sumtree_new(int64_t max_size, uint64_t seed) {
  return new SumTree(max_size, seed);
}

void sumtree_free(void* h) { delete static_cast<SumTree*>(h); }

int64_t sumtree_append(void* h, double priority) {
  return static_cast<SumTree*>(h)->append(priority);
}

void sumtree_update(void* h, int64_t tree_idx, double priority) {
  static_cast<SumTree*>(h)->update(tree_idx, priority);
}

void sumtree_renormalize(void* h) { static_cast<SumTree*>(h)->renormalize(); }

double sumtree_total(void* h) { return static_cast<SumTree*>(h)->tree[0]; }

double sumtree_max_p(void* h) { return static_cast<SumTree*>(h)->max_p; }

double sumtree_max_count(void* h) {
  return static_cast<SumTree*>(h)->max_count;
}

int64_t sumtree_size(void* h) { return static_cast<SumTree*>(h)->size; }

double sumtree_norm_factor(void* h) {
  return static_cast<SumTree*>(h)->norm_factor;
}

void sumtree_get_counts(void* h, double* out) {
  auto* t = static_cast<SumTree*>(h);
  std::memcpy(out, t->counts.data(), t->max_size * sizeof(double));
}

// Batched retrieval by target priorities: fills tree indices and the leaf
// priorities (un-normalized tree values) for each target.
void sumtree_get_batch(void* h, const double* targets, int64_t n,
                       int64_t* idxs_out, double* priorities_out) {
  auto* t = static_cast<SumTree*>(h);
  for (int64_t k = 0; k < n; ++k) {
    int64_t i = t->retrieve(targets[k]);
    idxs_out[k] = i;
    priorities_out[k] = t->tree[i];
  }
}

// Stratified sampling: one uniform draw per equal segment of the total mass
// (`experience_dataset.py:351-367`). Returns tree indices, probabilities and
// normalized importance weights (N p)^-beta / max.
void sumtree_sample(void* h, int64_t batchsize, double beta,
                    int64_t* idxs_out, double* weights_out) {
  auto* t = static_cast<SumTree*>(h);
  double total = t->tree[0];
  double seg = total / static_cast<double>(batchsize);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  std::vector<double> probs(batchsize);
  for (int64_t k = 0; k < batchsize; ++k) {
    double target = (static_cast<double>(k) + unif(t->rng)) * seg;
    int64_t i = t->retrieve(target);
    idxs_out[k] = i;
    probs[k] = t->tree[i] / total;
    int64_t leaf = i - t->max_size + 1;
    t->counts[leaf] += 1.0;
    t->max_count = std::max(t->max_count, t->counts[leaf]);
  }
  double wmax = 0.0;
  for (int64_t k = 0; k < batchsize; ++k) {
    double p = std::max(probs[k], 1e-12);
    weights_out[k] = std::pow(static_cast<double>(t->size) * p, -beta);
    wmax = std::max(wmax, weights_out[k]);
  }
  if (wmax > 0) {
    for (int64_t k = 0; k < batchsize; ++k) weights_out[k] /= wmax;
  }
}

}  // extern "C"
