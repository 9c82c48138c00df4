// Parallel row gather: memmap -> contiguous host batch.
//
// The ArrayStore hot loop (mmd_tpu_torch/data/store.py batches()) gathers B rows
// from a large memory-mapped .npy column into a contiguous batch buffer.
// NumPy fancy indexing does this single-threaded, and the store's numpy
// path copies twice (the sorted rows, then the batch order); this reads
// the rows in sorted (file) order and writes each straight to its batch
// position, with N threads of straight memcpy over contiguous runs of the
// sorted rows -- the native equivalent of the data-loader workers the
// reference got from torch DataLoader(num_workers=8) (reference
// train.py:31, dataset.py:181-192).
//
// Built with g++ at first use by mmd_tpu_torch/native/bindings.py (the
// port's copy of mmd_tpu/native/gather.cpp, which has no destination
// positions and strides its threads over the rows).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// src: base pointer of the (N, row_bytes) column; indices: (n,) int64 row
// ids; dest: (n,) int64 output rows, a permutation of 0..n-1; out:
// (n, row_bytes) destination.
void mmdgather_rows(const uint8_t* src, int64_t row_bytes,
                    const int64_t* indices, const int64_t* dest, int64_t n,
                    uint8_t* out, int32_t num_threads) {
  const int64_t nt = std::max<int64_t>(1, std::min<int64_t>(num_threads, n));
  auto run = [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + dest[i] * row_bytes, src + indices[i] * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  };
  if (nt == 1) {
    run(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt - 1);
  for (int64_t t = 1; t < nt; ++t)
    threads.emplace_back(run, t * n / nt, (t + 1) * n / nt);
  run(0, n / nt);  // the calling thread takes the first run
  for (auto& th : threads) th.join();
}

}  // extern "C"
