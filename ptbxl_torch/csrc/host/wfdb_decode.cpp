// Native batch WFDB decoder for the input pipeline (the port's copy of
// csrc/wfdb_decode.cpp, built by ptbxl_torch/io/native.py with the host C++
// compiler).
//
// The reference decodes records one at a time through wfdb-python inside
// DataLoader worker processes (reference: src/datasets/ptbxl.py:25-27,
// scripts/03:107-118).  This decoder turns the cache-build pass (the one
// place raw WFDB bytes are touched; see ptbxl_torch/data/cache.py) into a
// multithreaded C++ batch job: read each format-16 .dat file, de-interleave
// the [T, n_sig] samples into the cache's [n_sig, T] layout, no Python in the
// per-record loop.
//
// Build: at first use by ptbxl_torch/io/native.py ($CXX or g++ with
// csrc/Makefile's flags) into build/ptbxl_torch/<hash>/libwfdbdecode.so,
// loaded via ctypes, with the pure-Python reader as fallback.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>
#include <atomic>

namespace {

// Decode one format-16 file: little-endian int16, samples interleaved by
// frame across signals.  Writes [n_sig, n_samples] (transposed) into out.
bool decode_one_fmt16(const char* path, int n_samples, int n_sig,
                      int16_t* out, long byte_offset) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  if (byte_offset > 0 && std::fseek(f, byte_offset, SEEK_SET) != 0) {
    std::fclose(f);
    return false;
  }

  const size_t total = static_cast<size_t>(n_samples) * n_sig;
  std::vector<int16_t> interleaved(total);
  const size_t got = std::fread(interleaved.data(), sizeof(int16_t), total, f);
  std::fclose(f);
  if (got != total) return false;

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
  for (size_t i = 0; i < total; ++i) {
    uint16_t v = static_cast<uint16_t>(interleaved[i]);
    interleaved[i] = static_cast<int16_t>((v >> 8) | (v << 8));
  }
#endif

  // transpose [T, S] -> [S, T], blocked for cache friendliness
  constexpr int BT = 256;
  for (int t0 = 0; t0 < n_samples; t0 += BT) {
    const int t1 = t0 + BT < n_samples ? t0 + BT : n_samples;
    for (int s = 0; s < n_sig; ++s) {
      int16_t* dst = out + static_cast<size_t>(s) * n_samples;
      for (int t = t0; t < t1; ++t) {
        dst[t] = interleaved[static_cast<size_t>(t) * n_sig + s];
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Decode n format-16 records into out [n, n_sig, n_samples] int16.
// status[i] = 0 on success, 1 on failure (record left zeroed).
// Returns the number of successfully decoded records.
int wfdb_decode_batch_fmt16(const char** paths, int n, int n_samples,
                            int n_sig, int16_t* out, uint8_t* status,
                            int n_threads) {
  if (n_threads < 1) n_threads = 1;
  const size_t stride = static_cast<size_t>(n_sig) * n_samples;
  std::atomic<int> next(0);
  std::atomic<int> ok_count(0);

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      int16_t* dst = out + static_cast<size_t>(i) * stride;
      const bool ok = decode_one_fmt16(paths[i], n_samples, n_sig, dst, 0);
      status[i] = ok ? 0 : 1;
      if (ok) {
        ok_count.fetch_add(1);
      } else {
        std::memset(dst, 0, stride * sizeof(int16_t));
      }
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return ok_count.load();
}

// Gather rows of a C-contiguous array (typically the int16 ADC memmap cache,
// ptbxl_torch/data/cache.py) into a contiguous output batch: out[i] =
// base[indices[i]].  Multithreaded memcpy — the warm-cache input pipeline is
// bound by exactly this copy (reference equivalent: per-record __getitem__
// in DataLoader workers, src/datasets/ptbxl.py:122-142).
void wfdb_gather_rows(const uint8_t* base, int64_t row_bytes,
                      const int64_t* indices, int n, uint8_t* out,
                      int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      std::memcpy(out + static_cast<size_t>(i) * row_bytes,
                  base + static_cast<size_t>(indices[i]) * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  };
  if (n_threads == 1 || n < 2) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
}

// Physical conversion: (adc - baseline) / gain with NaN for the missing
// sentinel (-32768).  adc [n_sig, T] int16 -> phys [n_sig, T] float32.
void wfdb_adc_to_physical(const int16_t* adc, int n_sig, int n_samples,
                          const float* gains, const float* baselines,
                          float* phys) {
  for (int s = 0; s < n_sig; ++s) {
    const float inv_gain = 1.0f / gains[s];
    const float baseline = baselines[s];
    const int16_t* src = adc + static_cast<size_t>(s) * n_samples;
    float* dst = phys + static_cast<size_t>(s) * n_samples;
    for (int t = 0; t < n_samples; ++t) {
      if (src[t] == INT16_MIN) {
        dst[t] = __builtin_nanf("");
      } else {
        dst[t] = (static_cast<float>(src[t]) - baseline) * inv_gain;
      }
    }
  }
}

}  // extern "C"
