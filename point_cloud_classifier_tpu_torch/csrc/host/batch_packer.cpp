// Host batch packers: the assembly loops of the port's static-shape loaders.
//
// Each function fills a batch of data/batching.py's wires from the loader's
// contiguous stores: the rows of each event or graph copied as byte ranges
// into a padded buffer, with the segment, edge and in-row bookkeeping beside
// them.  The loaders' vectorized numpy assembly is the plain version (and
// the branch PCC_NATIVE=0 selects); every output here equals it byte for
// byte, as it equals the JAX package's loaders.
//
// Contract:
//  - All output buffers are allocated by the caller and initialised to
//    their padding values (zeros, segment b, the padding self-loop node);
//    a packer writes the live rows only.
//  - Feature payloads are copied as raw bytes (itemsize 2 for fp16, 4 for
//    f32): assembly does no float math on features, so the fp16 wire is
//    exact by construction.
//  - Where numpy converts (f32 weights to the fp16 host adjacency, with its
//    accumulate), _Float16 arithmetic reproduces numpy's round-to-nearest-
//    even cast and its f16 += (one rounding after every add).
//
// Built by native/host.py with g++ -O2 -shared -fPIC -std=c++17.

#include <cstdint>
#include <cstring>

namespace {

// Fill an int16 or int32 array slice with a constant.
inline void fill_ids(void* base, int64_t itemsize, int64_t from, int64_t count,
                     int64_t value) {
  if (itemsize == 2) {
    int16_t* p = reinterpret_cast<int16_t*>(base) + from;
    const int16_t v = static_cast<int16_t>(value);
    for (int64_t i = 0; i < count; ++i) p[i] = v;
  } else {
    int32_t* p = reinterpret_cast<int32_t*>(base) + from;
    const int32_t v = static_cast<int32_t>(value);
    for (int64_t i = 0; i < count; ++i) p[i] = v;
  }
}

}  // namespace

extern "C" {

// Point-cloud batch pack, flat wire (PointCloudLoader._flat_batch).
//
// flat      [P_total, feat_dim] row-major feature store (itemsize bytes/elt)
// offsets   [n_events + 1] row offsets into flat
// idx       [k] selected event indices; slot s <- idx[s]
// keep_cols [n_keep] ascending feature columns copied into `points`
// fac_cols  [n_fac]  ascending per-event-constant columns -> `event_feats`
// points      [p_pad, n_keep] pre-zeroed; rows 0..total-1 written
// event_feats [b + 1, n_fac] pre-zeroed (ignored when n_fac == 0)
// seg         [p_pad] int16/int32 pre-filled with b; rows 0..total-1 written
// seg_counts  [b + 1] int32; [0..k) written, [b] = p_pad - total
// Returns total live rows, or -1 if an event exceeds the remaining space.
int64_t pack_pointcloud(const char* flat, int64_t feat_dim, int64_t itemsize,
                        const int64_t* offsets, const int64_t* idx, int64_t k,
                        int64_t b, const int64_t* keep_cols, int64_t n_keep,
                        const int64_t* fac_cols, int64_t n_fac, int64_t p_pad,
                        char* points, char* event_feats, void* seg,
                        int64_t seg_itemsize, int32_t* seg_counts) {
  const int64_t in_row = feat_dim * itemsize;
  const int64_t out_row = n_keep * itemsize;
  const bool full_row = (n_keep == feat_dim);

  int64_t cursor = 0;
  for (int64_t slot = 0; slot < b; ++slot) seg_counts[slot] = 0;
  for (int64_t slot = 0; slot < k; ++slot) {
    const int64_t ev = idx[slot];
    const int64_t lo = offsets[ev], hi = offsets[ev + 1];
    const int64_t rows = hi - lo;
    if (cursor + rows > p_pad) return -1;
    const char* src = flat + lo * in_row;
    char* dst = points + cursor * out_row;
    if (full_row) {
      std::memcpy(dst, src, rows * in_row);
    } else if (itemsize == 2) {
      // column-major strided copy: one tight vectorizable loop per kept
      // column beats a per-row-per-column memcpy by ~5x at feat_dim 6
      const int16_t* s16 = reinterpret_cast<const int16_t*>(src);
      int16_t* d16 = reinterpret_cast<int16_t*>(dst);
      for (int64_t c = 0; c < n_keep; ++c) {
        const int64_t sc = keep_cols[c];
        for (int64_t r = 0; r < rows; ++r)
          d16[r * n_keep + c] = s16[r * feat_dim + sc];
      }
    } else {
      const int32_t* s32 = reinterpret_cast<const int32_t*>(src);
      int32_t* d32 = reinterpret_cast<int32_t*>(dst);
      for (int64_t c = 0; c < n_keep; ++c) {
        const int64_t sc = keep_cols[c];
        for (int64_t r = 0; r < rows; ++r)
          d32[r * n_keep + c] = s32[r * feat_dim + sc];
      }
    }
    if (n_fac > 0 && rows > 0) {
      char* frow = event_feats + slot * n_fac * itemsize;
      for (int64_t c = 0; c < n_fac; ++c)
        std::memcpy(frow + c * itemsize, src + fac_cols[c] * itemsize,
                    itemsize);
    }
    fill_ids(seg, seg_itemsize, cursor, rows, slot);
    seg_counts[slot] = static_cast<int32_t>(rows);
    cursor += rows;
  }
  seg_counts[b] = static_cast<int32_t>(p_pad - cursor);
  return cursor;
}

// Flat graph batch pack (GraphLoader._flat_batch, the edge-list wire).
//
// feats/node_offsets: as pack_pointcloud (full rows always).
// src/dst     flat per-graph LOCAL endpoint ids [E_total] int32
// edge_offsets [n_graphs + 1]
// weights     [E_total] ALREADY in the wire dtype (w_itemsize bytes/elt;
//             the loader converts once at init) — ignored when
//             use_weights == 0 (fill 1.0)
// mask        [E_total] edge_mask values in the wire dtype, or null for 1.0
//             (a merged multigraph's flat wire ships each edge's
//             multiplicity there, beside the mean weight in `weights`)
// Outputs pre-initialised by the caller: nodes zeroed, node_seg filled b,
// src_out/dst_out filled n_pad-1 (padding self-loop), edge_w/mask zeroed.
// w_itemsize selects fp16/f32 wire for edge_w + edge_mask.
// Returns total live nodes, or -1 on overflow.
int64_t pack_graph_flat(const char* feats, int64_t feat_dim, int64_t itemsize,
                        const int64_t* node_offsets, const int32_t* src,
                        const int32_t* dst, const int64_t* edge_offsets,
                        const char* weights, int64_t use_weights,
                        const char* mask, const int64_t* idx, int64_t k,
                        int64_t b, int64_t n_pad, int64_t e_pad, char* nodes,
                        void* node_seg, int64_t seg_itemsize,
                        int32_t* seg_counts, void* src_out, void* dst_out,
                        int64_t idx_itemsize, void* edge_w, void* edge_mask,
                        int64_t w_itemsize) {
  const int64_t row = feat_dim * itemsize;
  int64_t node_cursor = 0, edge_cursor = 0;
  for (int64_t slot = 0; slot < b; ++slot) seg_counts[slot] = 0;
  for (int64_t slot = 0; slot < k; ++slot) {
    const int64_t g = idx[slot];
    const int64_t nlo = node_offsets[g], nhi = node_offsets[g + 1];
    const int64_t elo = edge_offsets[g], ehi = edge_offsets[g + 1];
    const int64_t n_i = nhi - nlo, e_i = ehi - elo;
    if (node_cursor + n_i > n_pad || edge_cursor + e_i > e_pad) return -1;

    std::memcpy(nodes + node_cursor * row, feats + nlo * row, n_i * row);
    fill_ids(node_seg, seg_itemsize, node_cursor, n_i, slot);
    seg_counts[slot] = static_cast<int32_t>(n_i);

    if (idx_itemsize == 2) {
      int16_t* so = reinterpret_cast<int16_t*>(src_out) + edge_cursor;
      int16_t* do_ = reinterpret_cast<int16_t*>(dst_out) + edge_cursor;
      for (int64_t e = 0; e < e_i; ++e) {
        so[e] = static_cast<int16_t>(src[elo + e] + node_cursor);
        do_[e] = static_cast<int16_t>(dst[elo + e] + node_cursor);
      }
    } else {
      int32_t* so = reinterpret_cast<int32_t*>(src_out) + edge_cursor;
      int32_t* do_ = reinterpret_cast<int32_t*>(dst_out) + edge_cursor;
      for (int64_t e = 0; e < e_i; ++e) {
        so[e] = src[elo + e] + static_cast<int32_t>(node_cursor);
        do_[e] = dst[elo + e] + static_cast<int32_t>(node_cursor);
      }
    }
    if (use_weights) {
      std::memcpy(reinterpret_cast<char*>(edge_w) + edge_cursor * w_itemsize,
                  weights + elo * w_itemsize, e_i * w_itemsize);
    }
    if (mask) {
      std::memcpy(reinterpret_cast<char*>(edge_mask) + edge_cursor * w_itemsize,
                  mask + elo * w_itemsize, e_i * w_itemsize);
    }
    if (w_itemsize == 2) {
      const int16_t one = 0x3C00;  // fp16 1.0 bit pattern
      int16_t* m = reinterpret_cast<int16_t*>(edge_mask) + edge_cursor;
      int16_t* w = reinterpret_cast<int16_t*>(edge_w) + edge_cursor;
      if (!mask)
        for (int64_t e = 0; e < e_i; ++e) m[e] = one;
      if (!use_weights)
        for (int64_t e = 0; e < e_i; ++e) w[e] = one;
    } else {
      float* m = reinterpret_cast<float*>(edge_mask) + edge_cursor;
      float* w = reinterpret_cast<float*>(edge_w) + edge_cursor;
      if (!mask)
        for (int64_t e = 0; e < e_i; ++e) m[e] = 1.0f;
      if (!use_weights)
        for (int64_t e = 0; e < e_i; ++e) w[e] = 1.0f;
    }
    node_cursor += n_i;
    edge_cursor += e_i;
  }
  seg_counts[b] = static_cast<int32_t>(n_pad - node_cursor);
  return node_cursor;
}

// In-row device-wire pack (GraphLoader._dense_wire_batch, preferred wire).
// The out-row mirror is two more passes over the (graph, source)-sorted
// copy with fill_nodes == 0: out_dst/out_w, then out_pos.
//
// Fills nodes [b, m_pad, feat_dim] + node_mask [b, m_pad] (pre-zeroed) and
// the per-node incoming-edge arrays in_src [b, m_pad, d_pad] /
// in_w [b, m_pad, d_pad] (pre-zeroed; idx_itemsize 2/4, w_itemsize 2/4).
// weights are ALREADY wire-dtype (w_itemsize bytes/elt); use_weights == 0
// writes 1.0 instead; a null in_w writes no weights (the out_pos pass).
// Relies on each graph's edges being dst-sorted (the loader sorts at
// construction): the slot within a row is a run position.
// Returns 0, or -1 on overflow (d_pad too small / node count > m_pad).
int64_t pack_graph_inrow(const char* feats, int64_t feat_dim,
                         int64_t itemsize, const int64_t* node_offsets,
                         const int32_t* src, const int32_t* dst,
                         const int64_t* edge_offsets, const char* weights,
                         int64_t use_weights, const int64_t* idx, int64_t k,
                         int64_t b, int64_t m_pad, int64_t d_pad,
                         char* nodes, float* node_mask, void* in_src,
                         int64_t idx_itemsize, void* in_w,
                         int64_t w_itemsize, int64_t fill_nodes) {
  const int64_t row_bytes = feat_dim * itemsize;
  const int16_t one_f16 = 0x3C00;
  for (int64_t slot = 0; slot < k; ++slot) {
    const int64_t g = idx[slot];
    const int64_t nlo = node_offsets[g], nhi = node_offsets[g + 1];
    const int64_t elo = edge_offsets[g], ehi = edge_offsets[g + 1];
    const int64_t n_i = nhi - nlo;
    if (n_i > m_pad) return -1;
    if (fill_nodes) {  // the out-row mirror pass reuses already-filled buffers
      std::memcpy(nodes + (slot * m_pad) * row_bytes, feats + nlo * row_bytes,
                  n_i * row_bytes);
      float* mask = node_mask + slot * m_pad;
      for (int64_t r = 0; r < n_i; ++r) mask[r] = 1.0f;
    }

    int64_t pos = 0;
    int32_t prev_dst = -1;
    for (int64_t e = elo; e < ehi; ++e) {
      const int32_t d = dst[e];
      pos = (d == prev_dst) ? pos + 1 : 0;
      prev_dst = d;
      if (pos >= d_pad || d < 0 || d >= m_pad) return -1;
      const int64_t cell = (slot * m_pad + d) * d_pad + pos;
      if (idx_itemsize == 2)
        reinterpret_cast<int16_t*>(in_src)[cell] =
            static_cast<int16_t>(src[e]);
      else
        reinterpret_cast<int32_t*>(in_src)[cell] = src[e];
      if (!in_w) continue;
      if (w_itemsize == 2)
        reinterpret_cast<int16_t*>(in_w)[cell] =
            use_weights ? reinterpret_cast<const int16_t*>(weights)[e]
                        : one_f16;
      else
        reinterpret_cast<float*>(in_w)[cell] =
            use_weights ? reinterpret_cast<const float*>(weights)[e] : 1.0f;
    }
  }
  return 0;
}

// Dense batched-adjacency pack (GraphLoader._host_dense_batch).
//
// adj [b, m_pad, m_pad] (adj_itemsize 2 -> fp16, 4 -> f32), pre-zeroed;
// accumulates adj[slot][dst][src] += w with numpy's f16 += semantics when
// on the fp16 wire (round after every add — matches np.add.at on an f16
// array).  nodes [b, m_pad, feat_dim] and node_mask [b, m_pad] pre-zeroed.
// Returns 0, or -1 if a graph exceeds m_pad / an endpoint is out of range.
int64_t pack_graph_dense(const char* feats, int64_t feat_dim,
                         int64_t itemsize, const int64_t* node_offsets,
                         const int32_t* src, const int32_t* dst,
                         const int64_t* edge_offsets, const float* weights,
                         int64_t use_weights, const int64_t* idx, int64_t k,
                         int64_t b, int64_t m_pad, char* nodes, void* adj,
                         int64_t adj_itemsize, float* node_mask) {
  const int64_t row = feat_dim * itemsize;
  const int64_t plane = m_pad * m_pad;
  for (int64_t slot = 0; slot < k; ++slot) {
    const int64_t g = idx[slot];
    const int64_t nlo = node_offsets[g], nhi = node_offsets[g + 1];
    const int64_t elo = edge_offsets[g], ehi = edge_offsets[g + 1];
    const int64_t n_i = nhi - nlo;
    if (n_i > m_pad) return -1;

    std::memcpy(nodes + (slot * m_pad) * row, feats + nlo * row, n_i * row);
    float* mask = node_mask + slot * m_pad;
    for (int64_t r = 0; r < n_i; ++r) mask[r] = 1.0f;

    if (adj_itemsize == 2) {
      _Float16* a = reinterpret_cast<_Float16*>(adj) + slot * plane;
      for (int64_t e = elo; e < ehi; ++e) {
        const int64_t d = dst[e], s = src[e];
        if (d < 0 || d >= m_pad || s < 0 || s >= m_pad) return -1;
        // numpy parity: w.astype(f16) first, then f16 accumulate
        a[d * m_pad + s] +=
            static_cast<_Float16>(use_weights ? weights[e] : 1.0f);
      }
    } else {
      float* a = reinterpret_cast<float*>(adj) + slot * plane;
      for (int64_t e = elo; e < ehi; ++e) {
        const int64_t d = dst[e], s = src[e];
        if (d < 0 || d >= m_pad || s < 0 || s >= m_pad) return -1;
        a[d * m_pad + s] += use_weights ? weights[e] : 1.0f;
      }
    }
  }
  return 0;
}

// Dense point-cloud batch pack (PointCloudLoader._dense_batch's numpy
// assembly as range-memcpy).  Same row semantics as pack_pointcloud but the
// destination is per-cloud padded rows [b, m, n_keep]: event slot's rows
// land at row slot*m, padding rows stay at the caller's pre-zeroed value.
//
// points      [b * m, n_keep] pre-zeroed; rows written per live event
// event_feats [b + 1, n_fac] pre-zeroed (ignored when n_fac == 0)
// seg_counts  [b + 1] int32; [0..k) written, [b] = b*m - total (in-row
//             padding, kept for observability, as numpy writes it)
// Returns total live rows, or -1 if an event exceeds m rows.
int64_t pack_pointcloud_dense(const char* flat, int64_t feat_dim,
                              int64_t itemsize, const int64_t* offsets,
                              const int64_t* idx, int64_t k, int64_t b,
                              const int64_t* keep_cols, int64_t n_keep,
                              const int64_t* fac_cols, int64_t n_fac,
                              int64_t m, char* points, char* event_feats,
                              int32_t* seg_counts) {
  const int64_t in_row = feat_dim * itemsize;
  const int64_t out_row = n_keep * itemsize;
  const bool full_row = (n_keep == feat_dim);
  int64_t total = 0;
  for (int64_t slot = 0; slot < b; ++slot) seg_counts[slot] = 0;
  for (int64_t slot = 0; slot < k; ++slot) {
    const int64_t ev = idx[slot];
    const int64_t lo = offsets[ev], hi = offsets[ev + 1];
    const int64_t rows = hi - lo;
    if (rows > m) return -1;
    const char* src = flat + lo * in_row;
    char* dst = points + (slot * m) * out_row;
    if (full_row) {
      std::memcpy(dst, src, rows * in_row);
    } else if (itemsize == 2) {
      const int16_t* s16 = reinterpret_cast<const int16_t*>(src);
      int16_t* d16 = reinterpret_cast<int16_t*>(dst);
      for (int64_t c = 0; c < n_keep; ++c) {
        const int64_t sc = keep_cols[c];
        for (int64_t r = 0; r < rows; ++r)
          d16[r * n_keep + c] = s16[r * feat_dim + sc];
      }
    } else {
      const int32_t* s32 = reinterpret_cast<const int32_t*>(src);
      int32_t* d32 = reinterpret_cast<int32_t*>(dst);
      for (int64_t c = 0; c < n_keep; ++c) {
        const int64_t sc = keep_cols[c];
        for (int64_t r = 0; r < rows; ++r)
          d32[r * n_keep + c] = s32[r * feat_dim + sc];
      }
    }
    if (n_fac > 0 && rows > 0) {
      char* frow = event_feats + slot * n_fac * itemsize;
      for (int64_t c = 0; c < n_fac; ++c)
        std::memcpy(frow + c * itemsize, src + fac_cols[c] * itemsize,
                    itemsize);
    }
    seg_counts[slot] = static_cast<int32_t>(rows);
    total += rows;
  }
  seg_counts[b] = static_cast<int32_t>(b * m - total);
  return total;
}

}  // extern "C"
