// Shared by every kernel source: the C export macro.  Each exported
// function launches on the stream it is given and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define BP_EXPORT extern "C" __attribute__((visibility("default")))
