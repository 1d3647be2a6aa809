// A stand-in for <cuda_pipeline.h> beside cuda_runtime.h of this
// directory: an asynchronous copy is a plain copy, done at once, so a
// commit or a wait has nothing left to do.
#pragma once
#include <cstddef>
#include <cstring>

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
