// chain_attn's f32_3xtf32 kernels (chain_attn_tc.cuh), in a translation
// unit of their own: compiled beside chain.cu in parallel
// (kernels/_build.py) and linked into the same library; chain.cu declares
// the instantiation extern.

#include "chain_attn_tc.cuh"

template cudaError_t bind_chain_tc::launch<float>(
    bind_chain_tc::Problem<float>, int, cudaStream_t);
