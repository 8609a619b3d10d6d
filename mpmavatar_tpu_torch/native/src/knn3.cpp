// 3D KD-tree K-nearest-neighbour queries.
//
// Native replacement for the reference's CUDA `simple-knn` extension
// (distCUDA2, scene/gaussian_model.py:19,190: mean squared
// distance to the 3 nearest neighbours, used for gaussian scale init) and
// for the scipy cKDTree queries in the metrics harness
// (metric.py:18-21).  Single-header implementation,
// exposed via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Node {
    int32_t point;   // index into points array
    int32_t left;
    int32_t right;
    uint8_t axis;
};

struct Tree {
    const float* pts;  // (n, 3)
    std::vector<Node> nodes;
    int32_t root;

    int32_t build(std::vector<int32_t>& idx, int lo, int hi, int depth) {
        if (lo >= hi) return -1;
        int axis = depth % 3;
        int mid = (lo + hi) / 2;
        std::nth_element(idx.begin() + lo, idx.begin() + mid,
                         idx.begin() + hi,
                         [&](int32_t a, int32_t b) {
                             return pts[a * 3 + axis] < pts[b * 3 + axis];
                         });
        int32_t me = (int32_t)nodes.size();
        nodes.push_back(Node{idx[mid], -1, -1, (uint8_t)axis});
        int32_t l = build(idx, lo, mid, depth + 1);
        int32_t r = build(idx, mid + 1, hi, depth + 1);
        nodes[me].left = l;
        nodes[me].right = r;
        return me;
    }
};

struct Heap {  // max-heap of (dist2, idx), fixed capacity k
    float* d;
    int32_t* i;
    int k, n;
    float worst() const { return n < k ? 1e30f : d[0]; }
    void push(float dist, int32_t idx) {
        if (n < k) {
            d[n] = dist; i[n] = idx; n++;
            for (int c = n - 1; c > 0;) {
                int p = (c - 1) / 2;
                if (d[p] < d[c]) { std::swap(d[p], d[c]);
                                   std::swap(i[p], i[c]); c = p; }
                else break;
            }
        } else if (dist < d[0]) {
            d[0] = dist; i[0] = idx;
            for (int p = 0;;) {
                int c1 = 2 * p + 1, c2 = 2 * p + 2, big = p;
                if (c1 < k && d[c1] > d[big]) big = c1;
                if (c2 < k && d[c2] > d[big]) big = c2;
                if (big == p) break;
                std::swap(d[p], d[big]); std::swap(i[p], i[big]); p = big;
            }
        }
    }
};

void query(const Tree& t, int32_t node, const float* q, Heap& h) {
    if (node < 0) return;
    const Node& n = t.nodes[node];
    const float* p = t.pts + n.point * 3;
    float dx = q[0] - p[0], dy = q[1] - p[1], dz = q[2] - p[2];
    h.push(dx * dx + dy * dy + dz * dz, n.point);
    float delta = q[n.axis] - p[n.axis];
    int32_t near = delta < 0 ? n.left : n.right;
    int32_t far = delta < 0 ? n.right : n.left;
    query(t, near, q, h);
    if (delta * delta < h.worst()) query(t, far, q, h);
}

}  // namespace

extern "C" {

// KNN from queries (m,3) into points (n,3): fills dist2 (m,k) and
// idx (m,k) sorted ascending by distance.
int knn3(const float* points, int64_t n, const float* queries, int64_t m,
         int k, float* dist2, int32_t* idx) {
    if (n == 0 || k <= 0) return -1;
    Tree t;
    t.pts = points;
    t.nodes.reserve(n);
    std::vector<int32_t> order(n);
    for (int64_t i = 0; i < n; i++) order[i] = (int32_t)i;
    t.root = t.build(order, 0, (int)n, 0);

#pragma omp parallel for schedule(static)
    for (int64_t qi = 0; qi < m; qi++) {
        std::vector<float> hd(k);
        std::vector<int32_t> hi(k);
        Heap h{hd.data(), hi.data(), k, 0};
        query(t, t.root, queries + qi * 3, h);
        // sort ascending
        std::vector<int> ord(h.n);
        for (int i = 0; i < h.n; i++) ord[i] = i;
        std::sort(ord.begin(), ord.end(),
                  [&](int a, int b) { return hd[a] < hd[b]; });
        for (int i = 0; i < k; i++) {
            int s = i < h.n ? ord[i] : ord[h.n - 1];
            dist2[qi * k + i] = hd[s];
            idx[qi * k + i] = hi[s];
        }
    }
    return 0;
}

// distCUDA2 equivalent: mean squared distance to the 3 nearest
// neighbours of each point within the same cloud (excluding itself).
int mean_dist2_knn3(const float* points, int64_t n, float* out) {
    std::vector<float> d2(n * 4);
    std::vector<int32_t> idx(n * 4);
    int rc = knn3(points, n, points, n, 4, d2.data(), idx.data());
    if (rc) return rc;
    for (int64_t i = 0; i < n; i++) {
        // skip self (distance 0, first entry)
        out[i] = (d2[i * 4 + 1] + d2[i * 4 + 2] + d2[i * 4 + 3]) / 3.0f;
    }
    return 0;
}

}  // extern "C"
