"""The chunked sparse-conv microbenchmarks, ported with their kernels:
`mb_pallas_fused` (the fused select+GEMM, K7, and the smoke kernel, K8) and
`mb_gather_pallas` (the band row-gathers, K9-K11), with the realistic
inputs they run on (`realistic`)."""
