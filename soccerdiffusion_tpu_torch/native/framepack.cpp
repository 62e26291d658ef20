// framepack: multithreaded training-window assembler.
//
// The port's copy of the JAX package's assembler (the same C interface and
// arithmetic). Given flat, contiguous
// per-modality row arrays (all recordings concatenated) and a batch of
// sample positions, assemble padded training windows directly into
// caller-provided output buffers. This is the native counterpart of the
// reference's 32 DataLoader worker processes doing per-sample SQL + Python
// slicing (reference dataset/pytorch.py:295-384); padding semantics match
// the reference exactly: zero left-pad for joint histories, identity
// quaternion (or the packed 5-D identity) left-pad for IMU windows.
//
// Built at first use by soccerdiffusion_tpu_torch/native/build.py:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread framepack.cpp -o libframepack.so
//
// All functions use a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

struct BatchArgs {
  const float* cmds;        // (total_rows, J)
  const float* states;      // (total_rows, J)
  const float* rots;        // (total_rows, R)
  const int32_t* gs;        // (total_rows,) forward-filled game state per row
  int64_t num_joints;       // J
  int64_t rot_dim;          // R (4 quaternion / 5 five_dim)
  const int64_t* rec_starts;  // (B,) first global row of the sample's recording
  const int64_t* local_idx;   // (B,) command index within the recording
  int64_t batch;
  int64_t future_len;
  int64_t hist_len;        // action-history window
  int64_t state_len;       // joint-state window
  int64_t imu_len;
  const float* rot_pad;     // (R,) padding row for the IMU window
  float* out_future;        // (B, future_len, J)
  float* out_hist;          // (B, hist_len, J) or nullptr
  float* out_state_hist;    // (B, hist_len, J) or nullptr
  float* out_rot;           // (B, imu_len, R) or nullptr
  int32_t* out_gs;          // (B,) or nullptr
};

// Copy a left-padded history window ending (exclusive) at local row `end`.
inline void copy_history(const float* src, int64_t rec_start, int64_t end,
                         int64_t len, int64_t width, const float* pad_row,
                         float* dst) {
  const int64_t start = std::max<int64_t>(0, end - len);
  const int64_t have = end - start;
  const int64_t pad = len - have;
  if (pad_row == nullptr) {
    std::memset(dst, 0, sizeof(float) * pad * width);
  } else {
    for (int64_t i = 0; i < pad; ++i)
      std::memcpy(dst + i * width, pad_row, sizeof(float) * width);
  }
  std::memcpy(dst + pad * width, src + (rec_start + start) * width,
              sizeof(float) * have * width);
}

void assemble_range(const BatchArgs& a, int64_t begin, int64_t end) {
  const int64_t J = a.num_joints;
  const int64_t R = a.rot_dim;
  for (int64_t b = begin; b < end; ++b) {
    const int64_t rec_start = a.rec_starts[b];
    const int64_t idx = a.local_idx[b];

    // Future target chunk: rows [idx, idx + future_len) — always in range by
    // construction of the sample index space.
    std::memcpy(a.out_future + b * a.future_len * J,
                a.cmds + (rec_start + idx) * J,
                sizeof(float) * a.future_len * J);

    if (a.out_hist != nullptr)
      copy_history(a.cmds, rec_start, idx, a.hist_len, J, nullptr,
                   a.out_hist + b * a.hist_len * J);
    if (a.out_state_hist != nullptr)
      copy_history(a.states, rec_start, idx, a.state_len, J, nullptr,
                   a.out_state_hist + b * a.state_len * J);
    if (a.out_rot != nullptr)
      copy_history(a.rots, rec_start, idx, a.imu_len, R, a.rot_pad,
                   a.out_rot + b * a.imu_len * R);
    if (a.out_gs != nullptr)
      a.out_gs[b] = a.gs[rec_start + idx];  // forward-filled at pack time
  }
}

}  // namespace

extern "C" {

void fp_assemble_batch(const float* cmds, const float* states,
                       const float* rots, const int32_t* gs,
                       int64_t num_joints, int64_t rot_dim,
                       const int64_t* rec_starts, const int64_t* local_idx,
                       int64_t batch, int64_t future_len, int64_t hist_len,
                       int64_t state_len, int64_t imu_len, const float* rot_pad,
                       float* out_future, float* out_hist,
                       float* out_state_hist, float* out_rot, int32_t* out_gs,
                       int32_t num_threads) {
  BatchArgs a{cmds,    states,    rots,    gs,         num_joints, rot_dim,
              rec_starts, local_idx, batch, future_len, hist_len, state_len,
              imu_len, rot_pad, out_future, out_hist, out_state_hist, out_rot,
              out_gs};
  if (num_threads <= 1 || batch < 2 * num_threads) {
    assemble_range(a, 0, batch);
    return;
  }
  std::vector<std::thread> workers;
  const int64_t per = (batch + num_threads - 1) / num_threads;
  for (int32_t t = 0; t < num_threads; ++t) {
    const int64_t begin = t * per;
    const int64_t end = std::min<int64_t>(batch, begin + per);
    if (begin >= end) break;
    workers.emplace_back([&a, begin, end] { assemble_range(a, begin, end); });
  }
  for (auto& w : workers) w.join();
}

// Forward-fill helper used at pack time: for each command row timestamp
// (implicit index grid), pick the last game-state value at or before it.
// stamps are in rows of the game-state table; cmd stamps are i / rate.
void fp_forward_fill_gamestate(const float* gs_stamps, const int32_t* gs_values,
                               int64_t n_gs, double rate, int64_t n_rows,
                               int32_t unknown_value, int32_t* out) {
  int64_t j = 0;
  for (int64_t i = 0; i < n_rows; ++i) {
    const double stamp = static_cast<double>(i) / rate;
    while (j < n_gs && gs_stamps[j] <= stamp) ++j;
    out[i] = (j == 0) ? unknown_value : gs_values[j - 1];
  }
}

}  // extern "C"
