// Device queries for the wrappers (kernels.py).

#include <cuda_runtime.h>

// The most dynamic shared memory one block may opt in to on `device`
// (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232,448 B on an H100), into
// *bytes; returns the CUDA error.
extern "C" int eg3d_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
