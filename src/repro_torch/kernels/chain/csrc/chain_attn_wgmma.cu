// chain_attn's bf16_wgmma and f16_wgmma kernels (chain_attn_tc.cuh), in a
// translation unit of their own: compiled beside chain.cu in parallel
// (kernels/_build.py) and linked into the same library; chain.cu declares
// the instantiations extern.

#include "chain_attn_tc.cuh"

template cudaError_t bind_chain_tc::launch<__nv_bfloat16>(
    bind_chain_tc::Problem<__nv_bfloat16>, int, cudaStream_t);
template cudaError_t bind_chain_tc::launch<__half>(
    bind_chain_tc::Problem<__half>, int, cudaStream_t);
