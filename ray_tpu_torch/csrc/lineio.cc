// lineio — native line-oriented file scanning for the Data layer (the
// port's copy of ray_tpu/_native/lineio.cc, built by _build.build_host).
//
// Reference parity role: the reference's datasource hot loops run in
// native code (Arrow's C++ CSV/JSON readers behind ray.data.read_*);
// here the line-splitting pass — the bottleneck of read_text/read_json
// on large files — is a single mmap + memchr sweep in C++ producing a
// line-offset index the Python side slices zero-copy.
//
// API (C, ctypes-friendly):
//   lio_open(path, &handle, &size)      mmap the file read-only
//   lio_index(handle, size, offs, cap)  fill offs[] with the byte offset
//                                       of each line START; returns the
//                                       line count (call with cap=0 to
//                                       size the array first)
//   lio_close(handle, size)
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

int lio_open(const char* path, void** out_base, uint64_t* out_size) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return -1; }
  if (st.st_size == 0) { ::close(fd); *out_base = nullptr; *out_size = 0; return 0; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) return -1;
  *out_base = base;
  *out_size = (uint64_t)st.st_size;
  return 0;
}

// Count lines / fill line-start offsets. memchr is the fastest portable
// newline scan (libc uses SIMD internally).
uint64_t lio_index(const void* base, uint64_t size, uint64_t* offs,
                   uint64_t cap) {
  const char* p = (const char*)base;
  const char* end = p + size;
  uint64_t n = 0;
  const char* line = p;
  while (line < end) {
    if (offs && n < cap) offs[n] = (uint64_t)(line - p);
    n++;
    const char* nl = (const char*)memchr(line, '\n', end - line);
    if (!nl) break;
    line = nl + 1;
  }
  return n;
}

void lio_close(void* base, uint64_t size) {
  if (base && size) munmap(base, size);
}

}  // extern "C"
