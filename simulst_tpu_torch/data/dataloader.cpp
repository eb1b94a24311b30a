// Native batched feature loader of simulst_tpu_torch (a copy of the JAX
// package's native/dataloader.cpp): zip-member .npy reads + CMVN + padding.
//
// One threaded C++ call per batch reads every utterance's float32 .npy
// bytes straight from the feature zip (members are ZIP_STORED), applies
// per-utterance or global CMVN, and writes into the caller's preallocated,
// zeroed, padded (B, T, F) buffer.
//
// Exposed through a plain C ABI for the ctypes bridge
// (simulst_tpu_torch/data/native.py), which builds it at first use:
//   g++ -O3 -shared -fPIC -pthread -o libdataloader_<hash>.so dataloader.cpp

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Parse a .npy v1/v2 header starting at buf; returns data offset or -1.
// Only the layout we write/read is supported: '<f4', C-order, 2-D.
long parse_npy_header(const unsigned char* buf, long n, int* rows, int* cols) {
  if (n < 10 || memcmp(buf, "\x93NUMPY", 6) != 0) return -1;
  int major = buf[6];
  long header_len, header_off;
  if (major == 1) {
    header_len = buf[8] | (buf[9] << 8);
    header_off = 10;
  } else {
    header_len = buf[8] | (buf[9] << 8) | ((long)buf[10] << 16) |
                 ((long)buf[11] << 24);
    header_off = 12;
  }
  if (header_off + header_len > n) return -1;
  std::string h((const char*)buf + header_off, header_len);
  if (h.find("'descr': '<f4'") == std::string::npos &&
      h.find("\"descr\": \"<f4\"") == std::string::npos)
    return -1;
  if (h.find("'fortran_order': False") == std::string::npos) return -1;
  size_t sp = h.find("'shape': (");
  if (sp == std::string::npos) return -1;
  sp += 10;
  *rows = atoi(h.c_str() + sp);
  size_t comma = h.find(',', sp);
  if (comma == std::string::npos) return -1;
  *cols = atoi(h.c_str() + comma + 1);
  return header_off + header_len;
}

enum CmvnMode { CMVN_NONE = 0, CMVN_UTTERANCE = 1, CMVN_GLOBAL = 2 };

// Load one utterance into out (max_rows x cols, already zeroed). Returns the
// TRUE row count (caller clips lengths to max_rows) or -1 on error.
int load_one(const char* path, long offset, long length, float* out,
             int max_rows, int cols, int cmvn_mode, const float* gmean,
             const float* gstd) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<unsigned char> buf(length);
  if (fseek(f, offset, SEEK_SET) != 0 ||
      fread(buf.data(), 1, length, f) != (size_t)length) {
    fclose(f);
    return -1;
  }
  fclose(f);
  int rows = 0, fcols = 0;
  long data_off = parse_npy_header(buf.data(), length, &rows, &fcols);
  if (data_off < 0 || fcols != cols) return -1;
  if ((long)rows * cols * 4 + data_off > length) return -1;
  const float* data = (const float*)(buf.data() + data_off);
  int n = rows < max_rows ? rows : max_rows;

  if (cmvn_mode == CMVN_UTTERANCE) {
    // statistics over the FULL utterance (all `rows`), matching
    // data/features.utterance_cmvn even when the copy is truncated
    std::vector<double> mean(cols, 0.0), var(cols, 0.0);
    for (int t = 0; t < rows; t++)
      for (int c = 0; c < cols; c++) mean[c] += data[(long)t * cols + c];
    for (int c = 0; c < cols; c++) mean[c] /= rows;
    for (int t = 0; t < rows; t++)
      for (int c = 0; c < cols; c++) {
        double d = data[(long)t * cols + c] - mean[c];
        var[c] += d * d;
      }
    for (int c = 0; c < cols; c++) {
      var[c] = sqrt(var[c] / rows);          // numpy biased std
      if (var[c] < 1e-10) var[c] = 1e-10;    // features.utterance_cmvn floor
    }
    for (int t = 0; t < n; t++)
      for (int c = 0; c < cols; c++)
        out[(long)t * cols + c] =
            (float)((data[(long)t * cols + c] - mean[c]) / var[c]);
  } else if (cmvn_mode == CMVN_GLOBAL) {
    for (int t = 0; t < n; t++)
      for (int c = 0; c < cols; c++)
        out[(long)t * cols + c] =
            (data[(long)t * cols + c] - gmean[c]) / gstd[c];
  } else {
    memcpy(out, data, (long)n * cols * 4);
  }
  return rows;
}

}  // namespace

extern "C" {

int load_features(const char* path, long offset, long length, float* out,
                  int max_rows, int cols, int cmvn_mode, const float* gmean,
                  const float* gstd) {
  return load_one(path, offset, length, out, max_rows, cols, cmvn_mode,
                  gmean, gstd);
}

// Batched, threaded. paths: n C strings; out: (n, max_rows, cols) zeroed;
// out_rows[i] <- true row count (or -1 on per-item error). Returns 0.
int load_feature_batch(const char** paths, const long* offsets,
                       const long* lengths, int n, float* out, int max_rows,
                       int cols, int cmvn_mode, const float* gmean,
                       const float* gstd, int* out_rows, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  auto worker = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      out_rows[i] =
          load_one(paths[i], offsets[i], lengths[i],
                   out + (long)i * max_rows * cols, max_rows, cols,
                   cmvn_mode, gmean, gstd);
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++) ts.emplace_back(worker, t);
    for (auto& t : ts) t.join();
  }
  return 0;
}
}
