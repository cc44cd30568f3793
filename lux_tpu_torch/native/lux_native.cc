// Native host runtime pieces for lux_tpu_torch (the port's own copy of
// lux_tpu/native/lux_native.cc: the same entry points and results).
//
// The reference implements these in C++ inside the Legion runtime:
//  - partitioned parallel graph loading with fseeko per CPU point task
//    (core/pull_model.inl:253-320) -> lux_load (mmap + threaded copy)
//  - the edge-list -> .lux converter (tools/converter.cc:72-130), which
//    uses std::sort; here a two-pass counting sort by destination (the
//    output must be *stably* dst-sorted, which counting sort preserves)
//  - per-GPU CSR construction: out-degree histogram + prefix sum +
//    scatter (sssp/sssp_gpu.cu:550-607) -> lux_build_csr, with the
//    reference's serial prefix sum replaced by a blocked parallel one.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

constexpr size_t kHeaderSize = 12;  // u32 nv + u64 ne

unsigned worker_count() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 1 : n;
}

// Copy src -> dst in parallel chunks (memcpy saturates memory bandwidth
// with a few threads; this is the mmap analogue of the reference's
// per-partition fseeko/fread tasks).
void parallel_copy(void* dst, const void* src, size_t bytes) {
  unsigned nw = worker_count();
  if (bytes < (16u << 20) || nw == 1) {
    memcpy(dst, src, bytes);
    return;
  }
  std::vector<std::thread> ts;
  size_t chunk = (bytes + nw - 1) / nw;
  for (unsigned i = 0; i < nw; i++) {
    size_t off = i * chunk;
    if (off >= bytes) break;
    size_t len = std::min(chunk, bytes - off);
    ts.emplace_back([=] {
      memcpy(static_cast<char*>(dst) + off,
             static_cast<const char*>(src) + off, len);
    });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Load a .lux file. Outputs:
//   row_ends: int64[nv]   (the file's u64 end-offsets)
//   col_src:  int32[ne]   (the file's u32 sources; nv < 2^31 so safe)
//   weights:  int32[ne] or nullptr
// Returns 0 on success, negative errno-style codes on failure.
int lux_load(const char* path, uint32_t nv, uint64_t ne, int64_t* row_ends,
             int32_t* col_src, int32_t* weights) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -2;
  }
  size_t need = kHeaderSize + 8ull * nv + 4ull * ne +
                (weights ? 4ull * ne : 0ull);
  if (static_cast<size_t>(st.st_size) < need) {
    close(fd);
    return -3;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return -4;
  const char* base = static_cast<const char*>(map);

  uint32_t file_nv;
  uint64_t file_ne;
  memcpy(&file_nv, base, 4);
  memcpy(&file_ne, base + 4, 8);
  if (file_nv != nv || file_ne != ne) {
    munmap(map, st.st_size);
    return -5;
  }
  // u64 end-offsets reinterpret as int64 (values <= ne < 2^63).
  parallel_copy(row_ends, base + kHeaderSize, 8ull * nv);
  parallel_copy(col_src, base + kHeaderSize + 8ull * nv, 4ull * ne);
  if (weights) {
    parallel_copy(weights, base + kHeaderSize + 8ull * nv + 4ull * ne,
                  4ull * ne);
  }
  munmap(map, st.st_size);
  return 0;
}

// Text edge list ("src dst [w]" per line) -> .lux binary CSC.
// Two-pass counting sort by dst: pass 1 computes in-degree histogram /
// row offsets, pass 2 scatters sources (stable: input order preserved
// within a destination, matching the reference's std::sort by dst-only,
// converter.cc:45-48,98).
int lux_convert_edge_list(const char* input, const char* output,
                          uint32_t nv, uint64_t ne, int weighted) {
  FILE* fin = fopen(input, "r");
  if (!fin) return -1;
  std::vector<uint32_t> srcs(ne), dsts(ne);
  std::vector<int32_t> ws(weighted ? ne : 0);
  std::vector<uint32_t> out_deg(nv, 0);
  for (uint64_t e = 0; e < ne; e++) {
    unsigned s, d;
    int w = 0;
    int got = weighted ? fscanf(fin, "%u %u %d", &s, &d, &w)
                       : fscanf(fin, "%u %u", &s, &d);
    if (got != (weighted ? 3 : 2) || s >= nv || d >= nv) {
      fclose(fin);
      return -2;
    }
    srcs[e] = s;
    dsts[e] = d;
    if (weighted) ws[e] = w;
    out_deg[s]++;
  }
  fclose(fin);

  std::vector<uint64_t> row_end(nv, 0);
  for (uint64_t e = 0; e < ne; e++) row_end[dsts[e]]++;
  uint64_t acc = 0;
  std::vector<uint64_t> cursor(nv);
  for (uint32_t v = 0; v < nv; v++) {
    cursor[v] = acc;
    acc += row_end[v];
    row_end[v] = acc;
  }
  std::vector<uint32_t> cols(ne);
  std::vector<int32_t> wout(weighted ? ne : 0);
  for (uint64_t e = 0; e < ne; e++) {
    uint64_t pos = cursor[dsts[e]]++;
    cols[pos] = srcs[e];
    if (weighted) wout[pos] = ws[e];
  }

  FILE* fout = fopen(output, "wb");
  if (!fout) return -3;
  bool ok = fwrite(&nv, 4, 1, fout) == 1 && fwrite(&ne, 8, 1, fout) == 1 &&
            fwrite(row_end.data(), 8, nv, fout) == nv &&
            fwrite(cols.data(), 4, ne, fout) == ne;
  if (ok && weighted) ok = fwrite(wout.data(), 4, ne, fout) == ne;
  // Trailing out-degree array, like the reference converter
  // (converter.cc:123; never read back by apps).
  if (ok) ok = fwrite(out_deg.data(), 4, nv, fout) == nv;
  fclose(fout);
  return ok ? 0 : -4;
}

// CSC -> CSR: histogram of sources + exclusive prefix + stable scatter.
// Inputs: col_src[ne] (CSC sources), csc_row_ptr[nv+1] (for dst recovery).
// Outputs: csr_row_ptr[nv+1], csr_col_dst[ne], optional weights permuted.
int lux_build_csr(uint32_t nv, uint64_t ne, const int32_t* col_src,
                  const int64_t* csc_row_ptr, int64_t* csr_row_ptr,
                  int32_t* csr_col_dst, const int32_t* w_in, int32_t* w_out) {
  std::vector<int64_t> deg(nv, 0);
  for (uint64_t e = 0; e < ne; e++) {
    uint32_t s = static_cast<uint32_t>(col_src[e]);
    if (col_src[e] < 0 || s >= nv) return -6;
    deg[s]++;
  }
  csr_row_ptr[0] = 0;
  for (uint32_t v = 0; v < nv; v++) csr_row_ptr[v + 1] = csr_row_ptr[v] + deg[v];
  std::vector<int64_t> cursor(csr_row_ptr, csr_row_ptr + nv);
  for (uint32_t v = 0; v < nv; v++) {
    for (int64_t e = csc_row_ptr[v]; e < csc_row_ptr[v + 1]; e++) {
      uint32_t s = static_cast<uint32_t>(col_src[e]);
      int64_t pos = cursor[s]++;
      csr_col_dst[pos] = static_cast<int32_t>(v);
      if (w_in && w_out) w_out[pos] = w_in[e];
    }
  }
  return 0;
}

}  // extern "C"
