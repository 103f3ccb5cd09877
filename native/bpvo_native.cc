// bpvo_tpu native runtime: multi-threaded frame loading/decoding pipeline and
// binary PLY output.
//
// Counterpart of the reference's host runtime pieces:
//   - utils/dataset_loader_thread.{h,cc} + utils/bounded_buffer.h — producer
//     thread + mutex/condvar circular buffer feeding the VO thread.  Here the
//     single producer becomes a decode *pool* (N workers, in-order delivery
//     window) so PNG decode and disk IO never stall the accelerator feed, and
//     the buffer is a sequence-ordered slot table instead of a queue.
//   - bpvo/point_cloud.cc binary PLY writer.
//
// Pure C API for ctypes binding (no pybind11 in this image).  All heavy work
// happens outside the Python GIL.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

namespace {

struct Frame {
  cv::Mat image;      // CV_8UC1
  cv::Mat disparity;  // CV_32FC1
  bool ok = false;
};

class FrameLoader {
 public:
  FrameLoader(std::vector<std::string> image_paths,
              std::vector<std::string> disp_paths, int capacity, int n_workers,
              float disparity_scale)
      : image_paths_(std::move(image_paths)),
        disp_paths_(std::move(disp_paths)),
        capacity_(capacity < 2 ? 2 : capacity),
        disparity_scale_(disparity_scale),
        next_to_fetch_(0),
        next_to_deliver_(0),
        stop_(false) {
    int n = n_workers < 1 ? 1 : n_workers;
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { this->WorkerLoop(); });
  }

  ~FrameLoader() { Stop(); }

  void Stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_slots_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : workers_)
      if (t.joinable()) t.join();
    workers_.clear();
  }

  // Pops the next frame in sequence order into caller-provided buffers.
  // Returns the frame index, -1 on end-of-sequence, -2 on timeout,
  // -3 on buffer-size mismatch.
  int Pop(uint8_t* img_out, float* disp_out, int rows, int cols,
          int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    const size_t want = next_to_deliver_;
    if (want >= image_paths_.size()) return -1;
    bool got = cv_ready_.wait_for(
        lk, std::chrono::milliseconds(timeout_ms),
        [&] { return stop_ || ready_.count(want) > 0; });
    if (!got || (stop_ && ready_.count(want) == 0)) return -2;
    Frame f = std::move(ready_[want]);
    ready_.erase(want);
    ++next_to_deliver_;
    lk.unlock();
    cv_slots_.notify_all();

    if (!f.ok) return -1;  // decode failure acts as end sentinel
    if (f.image.rows != rows || f.image.cols != cols) return -3;
    std::memcpy(img_out, f.image.data, (size_t)rows * cols);
    std::memcpy(disp_out, f.disparity.data, (size_t)rows * cols * sizeof(float));
    return (int)want;
  }

 private:
  void WorkerLoop() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        // bound the readahead window to `capacity_` frames
        cv_slots_.wait(lk, [&] {
          return stop_ || (next_to_fetch_ < image_paths_.size() &&
                           next_to_fetch_ < next_to_deliver_ + capacity_);
        });
        if (stop_ || next_to_fetch_ >= image_paths_.size()) return;
        idx = next_to_fetch_++;
      }

      Frame f = Decode(idx);

      {
        std::lock_guard<std::mutex> lk(mu_);
        ready_[idx] = std::move(f);
      }
      cv_ready_.notify_all();
    }
  }

  Frame Decode(size_t idx) {
    Frame f;
    cv::Mat img = cv::imread(image_paths_[idx], cv::IMREAD_UNCHANGED);
    cv::Mat dsp = cv::imread(disp_paths_[idx], cv::IMREAD_UNCHANGED);
    if (img.empty() || dsp.empty()) return f;
    if (img.channels() == 3)
      cv::cvtColor(img, f.image, cv::COLOR_BGR2GRAY);
    else if (img.channels() == 4)
      cv::cvtColor(img, f.image, cv::COLOR_BGRA2GRAY);
    else
      f.image = img;
    if (dsp.type() != CV_32FC1)
      dsp.convertTo(f.disparity, CV_32FC1, disparity_scale_, 0.0);
    else
      f.disparity = dsp;
    f.ok = true;
    return f;
  }

  std::vector<std::string> image_paths_, disp_paths_;
  const size_t capacity_;
  const float disparity_scale_;

  std::mutex mu_;
  std::condition_variable cv_slots_, cv_ready_;
  std::map<size_t, Frame> ready_;
  size_t next_to_fetch_, next_to_deliver_;
  bool stop_;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* bpvo_loader_create(const char** image_paths, const char** disp_paths,
                         int n_frames, int capacity, int n_workers,
                         float disparity_scale) {
  std::vector<std::string> imgs(image_paths, image_paths + n_frames);
  std::vector<std::string> dsps(disp_paths, disp_paths + n_frames);
  return new FrameLoader(std::move(imgs), std::move(dsps), capacity, n_workers,
                         disparity_scale);
}

int bpvo_loader_pop(void* handle, uint8_t* img_out, float* disp_out, int rows,
                    int cols, int timeout_ms) {
  return static_cast<FrameLoader*>(handle)->Pop(img_out, disp_out, rows, cols,
                                                timeout_ms);
}

void bpvo_loader_destroy(void* handle) {
  delete static_cast<FrameLoader*>(handle);
}

// Binary little-endian PLY with x y z r g b (cf. reference point_cloud.cc:140+).
// Returns 0 on success.
int bpvo_write_ply(const char* path, const float* xyz, const uint8_t* rgb,
                   int n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f,
               "ply\nformat binary_little_endian 1.0\nelement vertex %d\n"
               "property float x\nproperty float y\nproperty float z\n"
               "property uchar red\nproperty uchar green\nproperty uchar blue\n"
               "end_header\n",
               n);
  for (int i = 0; i < n; ++i) {
    std::fwrite(xyz + 3 * i, sizeof(float), 3, f);
    std::fwrite(rgb + 3 * i, 1, 3, f);
  }
  int rc = std::fclose(f);
  return rc == 0 ? 0 : -2;
}

int bpvo_native_version() { return 1; }

}  // extern "C"
