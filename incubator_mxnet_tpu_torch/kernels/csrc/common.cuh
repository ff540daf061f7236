// Shared by every kernel source: the error codes of an unsupported head
// dimension, of an unknown update rule and of an unsupported dtype, and
// the C entry point that turns an error code into its message.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

// Returned by an entry point for a head dimension it has no instance for.
#define MX_ERR_UNSUPPORTED_D 10001
// Returned by the whole-tree update for a rule it has no instance for.
#define MX_ERR_UNKNOWN_RULE 10002
// Returned by an entry point for an element type (or a combination of
// them) it has no instance for.
#define MX_ERR_UNSUPPORTED_DTYPE 10003
// Returned by an entry point that could not describe a tensor to TMA
// (cuTensorMapEncodeTiled missing from the driver, or refusing the map).
#define MX_ERR_TENSOR_MAP 10004

extern "C" const char* mx_error_string(int code) {
  if (code == MX_ERR_UNSUPPORTED_D) return "unsupported head dimension";
  if (code == MX_ERR_UNKNOWN_RULE) return "unknown update rule";
  if (code == MX_ERR_UNSUPPORTED_DTYPE)
    return "no instance for these element types";
  if (code == MX_ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled could not describe a tensor to TMA";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
